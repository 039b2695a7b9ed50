"""The port's process fleet (repro_torch.serving.frontend.replica) on the
CPU: replica processes exec'd from one EngineSpec behind a FleetRouter,
requests over real sockets, held against repro.

The module's fleet is 2 CPU children whose spec's `ckpt` points at a
root that repro.checkpoint.store wrote from repro's own
`EngineSpec.init_params` (reduced gemma3-1b, f32, K = 2, paged with the
prefix cache): no JAX runs in any child, and every token crossing the
process boundary must equal repro's `EnsembleEngine.generate` on those
weights, also through a SIGKILL of one child mid-load and its restart
(the soak of tests/test_fleet.py at a smaller load), with whole page
pools at the end read over the wire.  Also: canary rollout over POST
/admin/swap, scale_to / autoscale, graceful SIGTERM, 429 over sockets,
the EngineSpec JSON round trip, a child asked for an absent card, and
the serve CLI's --http --load and --fleet --load with --device cpu.

Children run one intra-op thread (OMP_NUM_THREADS=1 in the environment
they inherit): the suite's workers share the host's cores.
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving.frontend import EngineSpec as JaxEngineSpec
from repro_torch import bridge
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import client, obs
from repro_torch.serving.frontend import EngineSpec, FleetRouter
from repro_torch.serving.frontend.replica import param_digest

# tests/test_frontend.py's engine sizes; every layer pages (8 + 6 tokens
# stay inside reduced gemma3-1b's 16-token window), so the trie is allowed
SIZES = dict(n_slots=2, max_prompt=8, max_out=6, prefill_chunk=4)
SPEC = EngineSpec(arch="gemma3-1b", reduced=True, dtype="float32",
                  members=2, seed=0, paged=True, page_size=2,
                  prefix_cache=True, device="cpu", **SIZES)
N_NEW = 5
SHARED = list(range(50, 56))
PROMPTS = ([tuple(SHARED + [i]) for i in range(3)]
           + [tuple(range(1 + i, 6 + i)) for i in range(3)]
           + [tuple(range(90, 93 + i)) for i in range(2)])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in every child (which inherits the
    environment): the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    """A checkpoint root repro's store wrote from repro's own init, and
    repro's tokens for PROMPTS on those weights.  -> (root, refs, the
    port's copy of the weights)."""
    jspec = JaxEngineSpec(**{f.name: getattr(SPEC, f.name)
                             for f in dataclasses.fields(JaxEngineSpec)})
    jp = jspec.init_params()
    root = str(tmp_path_factory.mktemp("repro_ckpt"))
    jstore.save_checkpoint(root, 3, jp)
    eng = JaxEngine(jspec.config(), jp, **SIZES)
    refs = {p: eng.generate([np.array(p)], max_new=N_NEW)[0].tolist()
            for p in PROMPTS}
    return root, refs, bridge.params_from_numpy(jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def fleet(repro_side):
    f = FleetRouter(dataclasses.replace(SPEC, ckpt=repro_side[0]), n=2)
    f.start(timeout=300.0)
    yield f
    f.stop()


def _wait_drained(proc, timeout=60.0):
    """Poll /healthz until the child reports no live or pending work and
    a whole page pool; -> its replica dict."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        r = proc.healthz()["replicas"][0]
        if (r["live_slots"] == 0 and r["pending"] == 0
                and r["available_pages"] == r["n_pages"]):
            return r
        time.sleep(0.05)
    raise AssertionError(f"replica {proc.name} never drained: "
                         f"{proc.healthz()}")


def test_engine_spec_json_roundtrip():
    assert EngineSpec.from_json(SPEC.to_json()) == SPEC
    assert EngineSpec.from_json(
        dataclasses.replace(SPEC, seed=3).to_json()) != SPEC
    # the port's spec is repro's plus the device it runs and seeds on
    jfields = {f.name for f in dataclasses.fields(JaxEngineSpec)}
    assert {f.name for f in dataclasses.fields(EngineSpec)} == \
        jfields | {"device"}
    assert EngineSpec().device == ""


def test_spec_init_is_seeded_on_its_device():
    a, b = SPEC.init_params(), SPEC.init_params()
    assert param_digest(a) == param_digest(b)
    assert param_digest(SPEC.init_params(seed=1)) != param_digest(a)
    a["embed"][0, 0, 0] += 1.0
    assert param_digest(a) != param_digest(b)
    # a mesh comes with the multi-device slice: the engine refuses it
    with pytest.raises(NotImplementedError, match="mesh"):
        dataclasses.replace(SPEC, mesh="2x1").build_engine()


def test_fleet_serves_repro_tokens_from_a_repro_checkpoint(fleet,
                                                           repro_side):
    """Every child restored repro's weights bit for bit (the ready line's
    digest) and serves repro's tokens, JSON and SSE, directly and
    through the FleetRouter."""
    _, refs, weights = repro_side
    want = param_digest(weights)
    assert [p.digest for p in fleet.procs] == [want, want]
    for p in fleet.procs:
        for prompt in PROMPTS[:3]:
            out = client.http_generate(p.url, list(prompt), N_NEW,
                                       stream=True)
            assert out["tokens"] == refs[prompt]
    for i, prompt in enumerate(PROMPTS):
        out = fleet.generate(list(prompt), N_NEW, stream=i % 2 == 0)
        assert out["tokens"] == refs[prompt]
        assert [e["event"] for e in out["fleet_trace"]["events"]] == \
            ["enqueued", "routed", "done"]


def test_fleet_soak_sigkill_restart_token_exact(fleet, repro_side):
    """Threaded requests against the 2-child fleet while one child is
    SIGKILLed after about 8 completions and restarted: every request
    completes token-exact against repro (lost ones retried on the
    survivor), no worker wedges, and both pools end whole."""
    refs = repro_side[1]
    n_total = 40
    results, errors = [None] * n_total, []
    nxt = {"i": 0, "done": 0}
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = nxt["i"]
                if i >= n_total:
                    return
                nxt["i"] += 1
            p = PROMPTS[i % len(PROMPTS)]
            try:
                out = fleet.generate(list(p), N_NEW, stream=i % 2 == 0,
                                     retries=5)
                results[i] = (p, out["tokens"])
                with lock:
                    nxt["done"] += 1
            except Exception as e:  # noqa: BLE001 - a drop is the bug
                with lock:
                    errors.append((i, repr(e)))

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(6)]
    for t in threads:
        t.start()
    deadline = time.time() + 120.0
    while time.time() < deadline:
        with lock:
            if nxt["done"] >= 8:
                break
        time.sleep(0.005)
    with lock:
        assert nxt["i"] < n_total, "load finished before the kill"
    victim = fleet.procs[1]
    victim.kill()
    assert not victim.alive and victim.proc.returncode == -9
    assert fleet.health_sweep() == ["p1"]
    fleet.restart("p1", timeout=300.0)
    assert fleet.procs[1].alive
    assert fleet.procs[1].digest == fleet.procs[0].digest
    for t in threads:
        t.join(300.0)
    assert not any(t.is_alive() for t in threads), "wedged workers"
    assert errors == []
    for i, item in enumerate(results):
        assert item is not None, f"request {i} vanished"
        assert item[1] == refs[item[0]], f"request {i} not token-exact"
    s = fleet.stats()
    assert s["n_live"] == 2 and s["restarts"] >= 1
    for proc in fleet.procs:
        assert _wait_drained(proc)["failed"] is None
    text = fleet.metrics_text()
    _, samples = obs.parse_prometheus(text)
    fams = {obs.family_of(series) for series, _, _ in samples}
    assert {"repro_serving_fleet_retries_total",
            "repro_serving_fleet_restarts_total",
            "repro_serving_requests_completed"} <= fams
    assert any(labels.get("replica") == "fleet" for _, labels, _ in samples)


def test_fleet_canary_rollout_over_sockets(fleet, repro_side):
    """rollout(seed=7, canary=0.5) under traffic: one child swaps first
    and serves the canary share; then the rest follow.  Afterwards the
    fleet serves a fresh seed-7 engine's tokens; a rollout back to the
    checkpoint restores repro's."""
    root, refs, _ = repro_side
    prompt = list(PROMPTS[0])
    ref7 = dataclasses.replace(SPEC, seed=7).build_engine() \
        .generate([np.array(prompt)], max_new=N_NEW)[0].tolist()
    assert ref7 != refs[PROMPTS[0]]
    stop, errs = threading.Event(), []

    def traffic():
        while not stop.is_set():
            try:
                fleet.generate(prompt, N_NEW, retries=3)
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))
                return

    t = threading.Thread(target=traffic, daemon=True)
    t.start()
    try:
        try:
            fleet.rollout(seed=7, canary=0.5, canary_requests=2,
                          canary_timeout=120.0)
        finally:
            stop.set()
            t.join(60.0)
        assert not errs
        for proc in fleet.procs:
            assert _wait_drained(proc)["swaps_done"] >= 1
            out = client.http_generate(proc.url, prompt, N_NEW)
            assert out["tokens"] == ref7
    finally:
        fleet.rollout(ckpt=root)
    for proc in fleet.procs:
        r = _wait_drained(proc)
        assert r["cached_pages"] == 0 and r["shared_pages"] == 0
        assert client.http_generate(proc.url, prompt,
                                    N_NEW)["tokens"] == refs[PROMPTS[0]]


def test_fleet_scale_to_autoscale_and_graceful_sigterm(fleet, repro_side):
    """scale_to spawns and retires whole processes (a retired child
    drains on SIGTERM and exits 0); autoscale is a pure function of the
    queue depth."""
    refs = repro_side[1]
    fleet.scale_to(3, timeout=300.0)
    assert len(fleet.live()) == 3
    new = fleet.procs[2]
    assert new.digest == fleet.procs[0].digest
    p = PROMPTS[4]
    assert client.http_generate(new.url, list(p), N_NEW)["tokens"] == \
        refs[p]
    before = list(fleet.procs)
    fleet.scale_to(2)
    assert len(fleet.live()) == 2
    [retired] = [q for q in before if q not in fleet.procs]
    assert retired.proc.returncode == 0 and retired.peak_memory == 0
    assert fleet.autoscale(min_n=2, max_n=4) == 2
    with fleet._lock:
        fleet._in_flight[fleet.procs[0].name] += 99
    try:
        assert fleet.autoscale(min_n=2, max_n=4, high_depth=8) == 3
    finally:
        with fleet._lock:
            fleet._in_flight[fleet.procs[0].name] -= 99
    fleet.scale_to(2)
    assert len(fleet.live()) == 2


def test_fleet_429_over_sockets():
    """A child enforces its own max_queue_depth: saturating it answers
    429 over the wire, and FleetRouter backs off per Retry-After and
    still completes every request."""
    spec = dataclasses.replace(SPEC, n_slots=1, max_out=16, paged=False,
                               prefix_cache=False)
    f = FleetRouter(spec, n=1, max_queue_depth=2)
    f.start(timeout=300.0)
    try:
        errs, oks = [], []

        def fire():
            try:
                oks.append(f.generate([1, 2, 3], 12, retries=2))
            except Exception as e:  # noqa: BLE001
                errs.append(repr(e))

        threads = [threading.Thread(target=fire, daemon=True)
                   for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not errs and len(oks) == 6
        assert f.procs[0].healthz()["shed"] >= 1
        assert f.n_backoffs >= 1
    finally:
        f.stop()
    assert f.procs[0].proc.returncode == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_child_asked_for_an_absent_card_fails_with_its_output():
    """device "" is the card: with none present the child raises, and
    the supervisor stops and reports the child's output."""
    f = FleetRouter(dataclasses.replace(SPEC, device=""), n=1)
    with pytest.raises(RuntimeError, match="no CUDA device") as ei:
        f.start(timeout=120.0)
    assert "never became ready" in str(ei.value)
    assert f.procs[0].proc.poll() is not None
    assert not f.live()


ARGS = ["--reduced", "--members", "2", "--dtype", "float32", "--device",
        "cpu", "--batch", "2", "--prompt-len", "8", "--steps", "6",
        "--paged", "--page-size", "2", "--requests", "6", "--port", "0"]


def test_serve_cli_http_load(capsys):
    assert serve_cli.main(ARGS + ["--http", "--replicas", "2",
                                  "--load"]) == 0
    out = capsys.readouterr().out
    assert "(2 replica(s), K=2 members, 2 slots each)" in out
    assert "served 6 requests" in out and "drained; bye" in out


def test_serve_cli_fleet_load(capsys):
    assert serve_cli.main(ARGS + ["--http", "--fleet", "--replicas",
                                  "1", "--load"]) == 0
    out = capsys.readouterr().out
    assert "p0: pid" in out and "p1: pid" not in out
    assert "fleet served 6/6 requests (0 errors)" in out
    assert "retried 0" in out and "fleet down; bye" in out


def test_serve_cli_fleet_refuses_a_draft_checkpoint_root(tmp_path):
    """The spec's ckpt restores the members, so a fleet drafts only with
    member 0; a student's checkpoint root is refused, not served as the
    ensemble."""
    with pytest.raises(SystemExit, match="member0 only"):
        serve_cli.main(ARGS + ["--http", "--fleet", "--draft-ckpt",
                               str(tmp_path)])
