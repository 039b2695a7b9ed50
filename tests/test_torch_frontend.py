"""The port's network tier in process (repro_torch.serving.frontend's
Router, Replica and FrontendServer) against repro's, on the CPU.

Reduced gemma3-1b at f32 (greedy argmax cannot fork on near-ties), the
engine of tests/test_frontend.py (2 slots, prompts up to 8, 6 new
tokens, chunk 4), weights made by repro's `EngineSpec.init_params` and
crossed over with `bridge.params_from_numpy`.  Tokens over SSE and JSON must equal
repro's `EnsembleEngine.generate` at K = 2 and K = 4; the statuses,
Retry-After, payload keys and metric families must be those repro's
server gives for the same requests.  The rest are twins of
tests/test_frontend.py's and test_fleet.py's in-process network tests
(hot swap under load, backlog, drain hygiene, trie flush, crash latch,
SSE disconnect, 429, graceful shutdown), held against the port's own
engine, plus the one-device-read-a-tick contract under SSE streaming.
"""
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.client import HTTPConnection

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving.frontend import EngineSpec as JaxEngineSpec
from repro.serving.frontend import FrontendServer as JaxFrontendServer
from repro.serving.frontend import Replica as JaxReplica
from repro.serving.frontend import Router as JaxRouter
from repro_torch import bridge
from repro_torch.common.tree import tree_map
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serving import client, obs
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.frontend import (FrontendServer, QueueFull,
                                          Replica, Router)

JCFG = jreg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
TCFG = treg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
# tests/test_frontend.py's engine; the port's paged over 2-token pages
# (repro's references come from its contiguous pool, which it builds in
# a second where its paged pool takes ten)
JKW = dict(n_slots=2, max_prompt=8, max_out=6, prefill_chunk=4)
KW = dict(JKW, paged=True, page_size=2)
PROMPTS = [np.arange(1, 8), np.arange(2, 5), np.arange(3, 9)]
N_NEW = 5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """{K: (repro's params, the port's copy)} for K = 4 (repro's
    EngineSpec.init_params) and K = 2 (its first two members)."""
    jp4 = JaxEngineSpec(arch="gemma3-1b", reduced=True, dtype="float32",
                        members=4).init_params()
    out = {}
    for K, jp in ((4, jp4), (2, jax.tree.map(lambda x: x[:2], jp4))):
        out[K] = (jp, bridge.params_from_numpy(jax.device_get(jp), "cpu"))
    return out


@pytest.fixture(scope="module")
def jax_side(weights):
    """repro's engines (K = 2 and 4) and their tokens for PROMPTS."""
    engines, refs = {}, {}
    for K in (2, 4):
        engines[K] = JaxEngine(JCFG, weights[K][0], **JKW)
        refs[K] = [engines[K].generate([p], max_new=N_NEW)[0].tolist()
                   for p in PROMPTS]
    return engines, refs


def _engine(params, **over):
    """A port engine over its own copy of `params`, so that a rollout,
    which copies into an engine's tensors in place, leaves `params`
    alone."""
    kw = dict(KW)
    kw.update(over)
    return EnsembleEngine(TCFG, tree_map(torch.clone, params), device="cpu",
                          **kw)


def _start(engines, max_queue_depth=None, **rep_kw):
    reps = [Replica(f"r{i}", e, **rep_kw) for i, e in enumerate(engines)]
    router = Router(reps, max_queue_depth=max_queue_depth)
    srv = FrontendServer(router)
    srv.start()
    return srv, router, reps


def _fire_all(url, jobs):
    """Run http_generate for each (tokens, max_new, stream) job on its own
    thread; -> ({index: tokens}, [errors])."""
    results, errors = {}, []

    def fire(i, toks, n, stream):
        try:
            results[i] = client.http_generate(url, toks, n,
                                              stream=stream)["tokens"]
        except Exception as e:  # noqa: BLE001 - a drop is the failure
            errors.append(repr(e))

    threads = [threading.Thread(target=fire, args=(i, *job), daemon=True)
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    return results, errors


# -- against repro ------------------------------------------------------------


@pytest.mark.parametrize("K", [2, 4])
def test_sse_and_json_tokens_equal_repro(weights, jax_side, K):
    srv, _, _ = _start([_engine(weights[K][1])])
    try:
        for p, ref in zip(PROMPTS, jax_side[1][K]):
            sse = client.http_generate(srv.url, p, N_NEW, stream=True)
            plain = client.http_generate(srv.url, p, N_NEW, stream=False)
            assert sse["tokens"] == ref and plain["tokens"] == ref
            assert sse["ttft"] is not None and plain["latency_ms"] >= 0
    finally:
        srv.shutdown()


def _request(url, method, path, body=None, raw=None):
    """-> (status, Retry-After header, decoded JSON body or SSE events)."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60.0) as r:
            status, headers, payload = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, headers, payload = e.code, e.headers, e.read()
    if headers.get("Content-Type") == "text/event-stream":
        events = client.parse_sse(payload)
        return status, None, [(name, sorted(d)) for name, d in events]
    if headers.get("Content-Type", "").startswith("text/plain"):
        return status, None, payload.decode()
    return status, headers.get("Retry-After"), json.loads(payload)


# (method, path, body); "RAW" sends a body that is not JSON
DOOR_CASES = [
    ("POST", "/v1/generate", "RAW"),
    ("POST", "/v1/generate", {"tokens": [], "max_new": 4}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": 0}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": -3}),
    ("POST", "/v1/generate", {"tokens": list(range(99)), "max_new": 4}),
    ("POST", "/v1/generate", {"tokens": "nope", "max_new": 4}),
    ("POST", "/v1/generate", {"max_new": 4}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": 2,
                              "temperature": "hot"}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": 2,
                              "temperature": -1.0}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": 2,
                              "top_k": 1.5}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": 2,
                              "top_k": -2}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": 2,
                              "seed": True}),
    ("POST", "/v1/generate", {"tokens": [1, 2], "max_new": 2,
                              "draft": "yes"}),
    ("GET", "/nope", None),
    ("POST", "/nope", {}),
    ("GET", "/v1/trace/abc", None),
    ("GET", "/v1/trace/99999", None),
    ("POST", "/admin/swap", {"seed": 1}),
    ("POST", "/admin/profile", {"ticks": 0}),
    ("POST", "/admin/profile", {"ticks": 2}),
    ("POST", "/v1/generate", {"tokens": [1, 2, 3], "max_new": 3}),
    ("POST", "/v1/generate", {"tokens": [1, 2, 3], "max_new": 3,
                              "stream": True}),
    ("GET", "/v1/trace/0?replica=r0", None),
    ("GET", "/healthz", None),
]


def _door_answers(srv, router):
    """Every DOOR_CASES answer, then 429 with the only replica drained
    and one request parked in the backlog (depth 1 of 1), then 503 and
    /healthz while the server drains; -> [(status, Retry-After, keys)]."""
    out = []
    for method, path, body in DOOR_CASES:
        status, retry, payload = _request(
            srv.url, method, path, raw=b"{oops" if body == "RAW" else None,
            body=None if body == "RAW" else body)
        keys = (sorted(payload) if isinstance(payload, dict) else payload)
        if isinstance(payload, dict) and "replicas" in payload:
            keys = (keys, [sorted(r) for r in payload["replicas"]])
        out.append((method, path, status, retry, keys))
    router.drain("r0")
    assert router.wait_drained("r0", timeout=60.0)
    parked = threading.Event()
    name, _ = router.submit(np.arange(1, 4), 2,
                            on_done=lambda c: parked.set())
    assert name == "backlog"
    for body in ({"tokens": [1, 2], "max_new": 2},
                 {"tokens": [1, 2], "max_new": 2, "stream": True}):
        status, retry, payload = _request(srv.url, "POST", "/v1/generate",
                                          body=body)
        out.append(("429", status, retry, sorted(payload)))
    router.rejoin("r0")
    assert parked.wait(60.0)
    srv.draining = True
    for method, path in (("POST", "/v1/generate"), ("GET", "/healthz")):
        status, retry, payload = _request(
            srv.url, method, path,
            body={"tokens": [1], "max_new": 1} if method == "POST" else None)
        out.append(("draining", path, status, retry,
                    sorted(payload) if "error" in payload
                    else payload["ok"]))
    srv.draining = False
    return out


def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_statuses_keys_and_metric_names_match_repro(weights, jax_side):
    """The same requests to repro's server and the port's (each one
    contiguous K = 2 replica, max_queue_depth 1) get the same statuses,
    Retry-After headers and payload keys; /metrics declares the same
    families; the door's messages name what repro's tests look for."""
    jsrv = JaxFrontendServer(JaxRouter([JaxReplica("r0", jax_side[0][2])],
                                       max_queue_depth=1))
    tsrv, trouter, _ = _start([_engine(weights[2][1], paged=False)],
                              max_queue_depth=1)
    jsrv.start()
    try:
        want = _door_answers(jsrv, jsrv.router)
        got = _door_answers(tsrv, trouter)
        assert got == want
        assert _families(client.http_get_text(tsrv.url, "/metrics")) == \
            _families(client.http_get_text(jsrv.url, "/metrics"))
        for body, frag in [({"tokens": [], "max_new": 4}, "prompt len"),
                           ({"tokens": [1, 2], "max_new": 0}, "max_new"),
                           ({"tokens": list(range(99)), "max_new": 4},
                            "prompt len"),
                           ({"max_new": 4}, "tokens")]:
            _, _, payload = _request(tsrv.url, "POST", "/v1/generate",
                                     body=body)
            assert frag in payload["error"], body
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_metrics_scrape_round_trips_and_feeds_server_percentiles(weights):
    srv, _, _ = _start([_engine(weights[2][1])])
    try:
        for p in PROMPTS:
            client.http_generate(srv.url, p, 3, stream=True)
        text = client.http_get_text(srv.url, "/metrics")
        _, samples = obs.parse_prometheus(text)
        assert samples and text.endswith("\n")
        pct = client.server_percentiles(text)
        assert set(pct) == {f"{k}_p{p}_ms" for k in ("ttft", "latency")
                            for p in (50, 95, 99)}
        assert 0 < pct["ttft_p50_ms"] <= pct["latency_p99_ms"]
        assert client.server_percentiles("") == {}
    finally:
        srv.shutdown()


def test_run_http_load_reports_server_percentiles(weights):
    srv, router, _ = _start([_engine(weights[2][1]),
                             _engine(weights[2][1])])
    try:
        reqs = client.make_requests(6, TCFG.vocab_size, prompt_len=(2, 8),
                                    max_new=(2, 6), seed=3)
        r = client.run_http_load(srv.url, reqs, concurrency=3)
        assert r["n_requests"] == 6 and r["n_errors"] == 0
        assert r["n_replicas"] == 2 and r["slots"] == 4
        assert r["gen_tokens"] == sum(m for _, m in reqs)
        assert r["latency_source"] == "server"
        assert router.stats()["completed"] == 6
    finally:
        srv.shutdown()


def test_seeded_sampling_over_http_repeats(weights):
    """Per-request temperature / top_k / seed ride the body: a seeded
    sampled request gives the same tokens twice, and they leave the
    greedy stream."""
    srv, _, _ = _start([_engine(weights[2][1])])
    try:
        kw = dict(temperature=1.5, top_k=50, seed=3)
        a = client.http_generate(srv.url, PROMPTS[0], N_NEW, **kw)
        b = client.http_generate(srv.url, PROMPTS[0], N_NEW, stream=True,
                                 **kw)
        greedy = client.http_generate(srv.url, PROMPTS[0], N_NEW)
        assert a["tokens"] == b["tokens"] != greedy["tokens"]
        draft = client.http_generate(srv.url, PROMPTS[0], N_NEW,
                                     draft=False)
        assert draft["tokens"] == greedy["tokens"]
    finally:
        srv.shutdown()


def test_parse_sse_events():
    raw = (b'data: {"index": 0, "token": 5}\n\n'
           b'event: done\ndata: {"tokens": [5]}\n\n')
    assert client.parse_sse(raw) == [("message", {"index": 0, "token": 5}),
                                     ("done", {"tokens": [5]})]


# -- the in-process tier, against the port's own engine ------------------------

# the device reads tests/test_torch_scheduler.py counts
_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


def test_sse_streaming_reads_the_device_once_a_tick(weights, monkeypatch):
    """Per-token SSE events come from the harvest's one read: every tick
    of the replica's loop reads the device once, and the handler threads
    never read a tensor."""
    srv, _, reps = _start([_engine(weights[2][1])])
    sched = reps[0].scheduler
    loop = reps[0]._thread
    per_tick, elsewhere = [], []
    counts = {}

    def counting(name, real):
        def wrapped(self, *a, **k):
            if threading.current_thread() is loop:
                counts[name] = counts.get(name, 0) + 1
            else:
                elsewhere.append(name)
            return real(self, *a, **k)
        return wrapped

    tick = sched.tick

    def counted_tick():
        counts.clear()
        out = tick()
        per_tick.append(dict(counts))
        return out

    try:
        for name in _READS:
            monkeypatch.setattr(torch.Tensor, name,
                                counting(name, getattr(torch.Tensor, name)))
        sched.tick = counted_tick
        jobs = [(p, N_NEW, True) for p in PROMPTS]
        results, errors = _fire_all(srv.url, jobs)
        assert not errors and len(results) == 3
        monkeypatch.undo()
        assert per_tick and all(c == {"cpu": 1, "numpy": 1}
                                for c in per_tick), per_tick
        assert elsewhere == []
    finally:
        monkeypatch.undo()
        del sched.tick
        srv.shutdown()


def test_hot_swap_under_load_token_exact(weights):
    """A rollout mid-traffic over 2 replicas: every request completes
    (zero drops) on the old or the new weights, token-exact against a
    fresh engine of each; afterwards only the new weights serve."""
    old = weights[2][1]
    new = ttf.init(TCFG, seed=11, device="cpu", members=2)
    prompts = [np.arange(1, 7), np.arange(2, 6), np.arange(3, 8)]
    refs_old = [_engine(old).generate([p], max_new=4)[0].tolist()
                for p in prompts]
    refs_new = [_engine(new).generate([p], max_new=4)[0].tolist()
                for p in prompts]
    assert refs_old != refs_new
    engines = [_engine(old), _engine(old)]
    srv, router, _ = _start(engines)
    results, errors = {}, []

    def fire(i):
        try:
            results[i] = client.http_generate(
                srv.url, prompts[i % 3], 4, stream=i % 2 == 0)["tokens"]
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    try:
        ptrs = [e.params["embed"].data_ptr() for e in engines]
        threads = [threading.Thread(target=fire, args=(i,), daemon=True)
                   for i in range(9)]
        for i, t in enumerate(threads):
            t.start()
            if i == 3:
                router.rollout(new)
        for t in threads:
            t.join(120.0)
        assert not errors and len(results) == 9
        n_new = 0
        for i, toks in results.items():
            assert toks in (refs_old[i % 3], refs_new[i % 3]), (i, toks)
            n_new += toks == refs_new[i % 3]
        assert n_new > 0
        assert all(e.swaps_done == 1 for e in engines)
        # copied in place: the live tensors keep their storage
        assert [e.params["embed"].data_ptr() for e in engines] == ptrs
        post = client.http_generate(srv.url, prompts[0], 4, stream=True)
        assert post["tokens"] == refs_new[0]
    finally:
        srv.shutdown()


def test_replicas_sharing_weights_roll_out_as_one_group(weights):
    """Two replicas built over one param tree (one set of tensors) and a
    third over its own copy: the router groups the first two, and a
    canary rollout under load swaps that group first, routing the canary
    share to its first replica while its twin stays drained, then the
    third.  Zero drops, each request on the old or the new weights, and
    afterwards the twins still share one set, now the new weights."""
    old = tree_map(torch.clone, weights[2][1])
    new = ttf.init(TCFG, seed=11, device="cpu", members=2)
    prompts = [np.arange(1, 7), np.arange(2, 6), np.arange(3, 8)]
    refs_old = [_engine(old).generate([p], max_new=4)[0].tolist()
                for p in prompts]
    refs_new = [_engine(new).generate([p], max_new=4)[0].tolist()
                for p in prompts]
    assert refs_old != refs_new
    engines = [EnsembleEngine(TCFG, old, device="cpu", **KW)
               for _ in range(2)] + [_engine(old)]
    srv, router, reps = _start(engines)
    assert [[r.name for r in g] for g in router.weight_groups()] == \
        [["r0", "r1"], ["r2"]]
    done, got, twin_out = threading.Event(), {}, []
    roll = threading.Thread(
        target=lambda: (router.rollout(new, canary=0.5, canary_requests=2),
                        done.set()), daemon=True)
    try:
        i = 0
        while not done.is_set() and i < 100:
            if router.stats()["canary"] == "r0":
                twin_out.append(reps[1].draining)
            if router.queue_depth >= 4:     # a few in flight at a time
                time.sleep(0.002)
                continue
            if i == 3:
                roll.start()
            router.submit(prompts[i % 3], 4,
                          on_done=lambda c, i=i: got.setdefault(i, c))
            i += 1
        roll.join(120.0)
        assert done.is_set() and router.wait_idle(timeout=60.0)
        assert len(got) == i, (len(got), i)
        n_new = 0
        for k, c in got.items():
            toks = c.tokens.tolist()
            assert toks in (refs_old[k % 3], refs_new[k % 3]), (k, toks)
            n_new += toks == refs_new[k % 3]
        assert n_new > 0
        assert twin_out and all(twin_out)
        assert [e.swaps_done for e in engines] == [1, 1, 1]
        ptr = old["embed"].data_ptr()
        assert [e.params["embed"].data_ptr() for e in engines[:2]] == \
            [ptr, ptr]
        assert all(torch.equal(e.params["embed"], new["embed"])
                   for e in engines)
    finally:
        srv.shutdown()


def test_single_replica_rollout_backlogs_without_drops(weights):
    new = ttf.init(TCFG, seed=11, device="cpu", members=2)
    prompt = np.arange(1, 7)
    ref_new = _engine(new).generate([prompt], max_new=4)[0]
    eng = _engine(weights[2][1])
    srv, router, _ = _start([eng])
    try:
        router.drain("r0")
        assert router.wait_drained("r0", timeout=60.0)
        done = threading.Event()
        got = {}
        name, ticket = router.submit(
            prompt, 4, on_done=lambda c: (got.setdefault("c", c),
                                          done.set()))
        assert name == "backlog"
        # a second ticket is cancelled while parked: never served
        _, t2 = router.submit(prompt, 4)
        assert router.cancel("backlog", t2)
        assert not router.cancel("backlog", t2)
        eng.swap_params(new)
        router.rejoin("r0")
        assert done.wait(60.0)
        np.testing.assert_array_equal(got["c"].tokens, ref_new)
        assert router.stats()["cancelled"] == 1
    finally:
        srv.shutdown()


def test_router_drain_leaves_zero_orphaned_pages(weights):
    engines = [_engine(weights[2][1], n_slots=4, n_pages=16)
               for _ in range(2)]
    srv, router, reps = _start(engines)
    try:
        done = threading.Semaphore(0)
        for _ in range(10):
            router.submit(np.arange(1, 7), 4, on_done=lambda c: done.release())
        for _ in range(10):
            assert done.acquire(timeout=60.0)
        for name in ("r0", "r1"):
            router.drain(name)
            assert router.wait_drained(name, timeout=60.0)
        for r, e in zip(reps, engines):
            assert r.scheduler.wait_quiesced(60.0)
            assert e.free_pages == e.allocator.n_pages
            e.assert_pool_whole()
        assert all(r["completed"] > 0 for r in router.stats()["replicas"])
        h = client.http_get_json(srv.url, "/healthz")
        assert all(r["available_pages"] == r["n_pages"]
                   for r in h["replicas"])
    finally:
        srv.shutdown()


def test_rollout_flushes_prefix_trie(weights):
    """A cached prefix of round t never serves round t+1: after the
    drained rollout the trie holds no page (Router.rollout asserts it)
    and the same workload matches a cold engine on the new weights."""
    new = ttf.init(TCFG, seed=11, device="cpu", members=2)
    kw = dict(max_prompt=12, max_out=4, page_size=4, prefix_cache=True)
    shared = list(range(50, 58))
    prompts = [np.array(shared + [7, 8], np.int32),
               np.array(shared + [9], np.int32)]
    refs_new = [_engine(new, **kw).generate([p], max_new=4)[0].tolist()
                for p in prompts]
    eng = _engine(weights[2][1], **kw)
    srv, router, reps = _start([eng])
    try:
        done = threading.Semaphore(0)
        for p in prompts * 2:
            router.submit(p, 4, on_done=lambda c: done.release())
        for _ in range(4):
            assert done.acquire(timeout=60.0)
        assert reps[0].scheduler.wait_quiesced(60.0)
        assert eng.page_stats()["cached_pages"] > 0
        router.rollout(new)
        ps = eng.page_stats()
        assert ps["cached_pages"] == 0 and ps["shared_pages"] == 0
        outs = {}
        for i, p in enumerate(prompts):
            router.submit(p, 4, on_done=lambda c, i=i: (
                outs.__setitem__(i, c.tokens.tolist()), done.release()))
        for _ in prompts:
            assert done.acquire(timeout=60.0)
        assert [outs[i] for i in range(2)] == refs_new
    finally:
        srv.shutdown()


def test_replica_loop_crash_leaves_rotation(weights):
    """An exception out of a replica's tick latches it failed and out of
    rotation; the request it held answers 500 instead of hanging, and
    the other replica goes on serving."""
    srv, router, reps = _start([_engine(weights[2][1]),
                                _engine(weights[2][1])])
    try:
        def boom():
            raise RuntimeError("injected engine failure")

        reps[0].engine.step = boom
        wedged = {}

        def fire():
            try:
                client.http_generate(srv.url, np.arange(1, 5), 3)
                wedged["outcome"] = "completed"
            except RuntimeError as e:
                wedged["outcome"] = str(e)

        t = threading.Thread(target=fire, daemon=True)
        t.start()
        deadline = time.time() + 30.0
        while reps[0].failed is None and time.time() < deadline:
            time.sleep(0.01)
        assert reps[0].failed is not None and not reps[0].routable
        assert router.replica_dead("r0") and not router.replica_dead("r1")
        t.join(30.0)
        assert "HTTP 500" in wedged.get("outcome", "still hanging")
        out = client.http_generate(srv.url, np.arange(1, 5), 3)
        assert out["replica"] == "r1" and len(out["tokens"]) == 3
        h = client.http_get_json(srv.url, "/healthz")
        by_name = {r["name"]: r for r in h["replicas"]}
        assert by_name["r0"]["failed"] and by_name["r1"]["failed"] is None
    finally:
        srv.shutdown(drain=False)


def test_sse_disconnect_cancels_the_request(weights):
    """A client that drops the socket mid-SSE cancels its request: the
    slot and pages free, the loop goes on serving."""
    eng = _engine(weights[2][1], max_out=64, n_pages=80)
    srv, router, reps = _start([eng])
    try:
        body = json.dumps({"tokens": [1, 2, 3, 4], "max_new": 60,
                           "stream": True}).encode()
        conn = HTTPConnection(srv.host, srv.port, timeout=30.0)
        conn.request("POST", "/v1/generate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        got = b""
        while b"\n\n" not in got:
            got += resp.read1(4096)
        # an abortive close (RST): the server's next write raises
        sock = resp.fp.raw._sock
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        resp.close()
        conn.close()
        deadline = time.time() + 60.0
        while reps[0].scheduler.n_cancelled == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert reps[0].scheduler.n_cancelled == 1
        assert reps[0].scheduler.wait_quiesced(60.0)
        eng.assert_pool_whole()
        assert len(client.http_generate(srv.url, np.arange(1, 5),
                                        4)["tokens"]) == 4
        assert client.http_get_json(srv.url, "/healthz")["cancelled"] == 1
    finally:
        srv.shutdown(drain=False)


def test_429_backpressure_over_the_socket(weights):
    router = Router([Replica("r0", _engine(weights[2][1]))],
                    max_queue_depth=1)
    srv = FrontendServer(router)
    srv.start()
    try:
        router.drain("r0")
        assert router.wait_drained("r0", timeout=60.0)
        done = threading.Event()
        router.submit(np.arange(1, 4), 3, on_done=lambda c: done.set())
        with pytest.raises(QueueFull):
            router.submit(np.arange(1, 4), 3)
        with pytest.raises(client.Backpressure) as ei:
            client.http_generate(srv.url, [4, 5, 6], 4)
        assert ei.value.retry_after > 0
        router.rejoin("r0")
        assert done.wait(60.0)
        assert router.stats()["shed"] == 2
        assert len(client.http_generate(srv.url, [4, 5, 6], 4)["tokens"]) \
            == 4
    finally:
        srv.shutdown()


def test_graceful_shutdown_drains_in_flight(weights):
    srv, router, reps = _start([_engine(weights[2][1])])
    comps = []
    for _ in range(4):
        router.submit(np.arange(1, 6), 4, on_done=comps.append)
    srv.draining = True
    with pytest.raises(RuntimeError, match="HTTP 503"):
        client.http_generate(srv.url, np.arange(1, 4), 2)
    srv.shutdown(drain=True)
    assert len(comps) == 4 and all(len(c.tokens) == 4 for c in comps)
    assert reps[0]._thread is None and reps[0].scheduler.completions == {}


def test_router_add_remove_replica(weights):
    router = Router([Replica("r0", _engine(weights[2][1]))])
    router.start()
    try:
        router.add_replica(Replica("r1", _engine(weights[2][1])))
        ev = threading.Event()
        router.submit(np.arange(1, 5), 3, on_done=lambda c: ev.set())
        assert ev.wait(60.0)
        gone = router.remove_replica("r1", timeout=60.0)
        assert gone.name == "r1" and not gone.scheduler.has_work
        with pytest.raises(ValueError, match="last replica"):
            router.remove_replica("r0")
    finally:
        router.stop()


def test_admin_profile_arms_a_trace(weights, tmp_path):
    srv, router, reps = _start([_engine(weights[2][1])])
    try:
        status, _, payload = _request(srv.url, "POST", "/admin/profile",
                                      body={"ticks": 1,
                                            "dir": str(tmp_path)})
        assert status == 200 and payload["replica"] == "r0"
        assert reps[0].scheduler.obs.ticks.profile_pending == 1
        client.http_generate(srv.url, np.arange(1, 4), 2)
        assert reps[0].scheduler.obs.ticks.profile_pending == 0
        assert any(tmp_path.iterdir())
    finally:
        srv.shutdown()
