"""The port's continuous-batching Scheduler against repro.serving's, at
reduced deepseek-7b (every layer paged), f32, K=2 members.

`Scheduler.run` completions must equal the JAX package's token for token:
under page pressure with youngest-first preemption, with the prefix
cache on and off, with EOS, with cancels and with a one-chunk prefill
budget.  After each drain the pool is whole.  Also: `engine.score`
against the JAX engine's (per member and for the ensemble, within 1e-4)
and its Jensen bound; a greedy tick reads the device exactly once (the
harvest); serve_forever streams every token and quiesces.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import Scheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.serving import client
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.scheduler import Scheduler

K = 2
# tests/test_serving_paged.py's pressure setup: 6 pages for 4 slots
PRESSURE = dict(n_slots=4, max_prompt=8, max_out=8, prefill_chunk=4,
                paged=True, page_size=4)
PRESSURE_REQS = [(np.arange(1, 8), 8), (np.arange(2, 7), 8),
                 (np.arange(3, 9), 8), (np.arange(1, 5), 8),
                 (np.arange(2, 5), 8), (np.arange(4, 9), 6)]
# tests/test_prefix.py's setup: a shared 16-token prefix cut at random
PREFIX = dict(n_slots=3, max_prompt=24, max_out=6, prefill_chunk=4,
              paged=True, page_size=4, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the torch side runs tiny shapes, and the
    suite's workers share the cores (torch's default, one thread a core
    in every worker, oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    tcfg = treg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def prefix_requests():
    rng = np.random.default_rng(1)
    shared = list(range(200, 216))
    reqs = []
    for i in range(9):
        tail = list(rng.integers(1, 99, 1 + int(rng.integers(6))))
        cut = int(rng.integers(4, len(shared) + 1))
        reqs.append((np.array(shared[:cut] + tail, np.int32), 2 + i % 4))
    return reqs


def serve(eng, reqs, sched_kw=None, drive=None):
    """-> (engine, scheduler, rids, completions) of `reqs` through the
    engine's own package's Scheduler."""
    S = JaxScheduler if isinstance(eng, JaxEngine) else Scheduler
    sched = S(eng, **(sched_kw or {}))
    rids = [sched.submit(t, m) for t, m in reqs]
    if drive is not None:
        drive(sched, rids)
    return eng, sched, rids, sched.run()


def serve_port(models, reqs, kw, **serve_kw):
    return serve(EnsembleEngine(models[1], models[3], device="cpu", **kw),
                 reqs, **serve_kw)


def serve_both(models, reqs, kw, **serve_kw):
    """`reqs` through the JAX and the port scheduler on engines built with
    `kw`; -> [(engine, scheduler, rids, completions)], JAX first."""
    jcfg, _, jp, _ = models
    return [serve(JaxEngine(jcfg, jp, **kw), reqs, **serve_kw),
            serve_port(models, reqs, kw, **serve_kw)]


def assert_same_completions(runs):
    (_, js, jr, jc), (_, ts, tr, tc) = runs
    assert [b in tc for b in tr] == [a in jc for a in jr]
    for a, b in zip(jr, tr):
        if a in jc:
            assert tc[b].tokens.dtype == jc[a].tokens.dtype
            np.testing.assert_array_equal(tc[b].tokens, jc[a].tokens)
            assert tc[b].prompt_len == jc[a].prompt_len
    assert ts.preemptions == js.preemptions
    assert ts.n_cancelled == js.n_cancelled


def test_pressure_preempts_youngest_and_matches_jax(models):
    runs = serve_both(models, PRESSURE_REQS, dict(PRESSURE, n_pages=6))
    assert_same_completions(runs)
    eng, sched, rids, comps = runs[1]
    assert sched.preemptions > 0 and set(comps) == set(rids)
    assert sorted(rids, key=lambda r: comps[r].finish_t) == rids  # FIFO
    eng.assert_pool_whole()
    # the unpressured pool gives the same tokens without preemption
    calm = serve_port(models, PRESSURE_REQS, PRESSURE)
    assert calm[1].preemptions == 0
    for r, c in zip(rids, calm[2]):
        np.testing.assert_array_equal(comps[r].tokens, calm[3][c].tokens)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_prefix_cache_on_and_off_match_jax(models, prefix_cache):
    kw = dict(PREFIX, n_pages=14, prefix_cache=prefix_cache)
    runs = serve_both(models, prefix_requests(), kw)
    assert_same_completions(runs)
    jeng, teng = runs[0][0], runs[1][0]
    assert teng.page_stats() == jeng.page_stats()
    if prefix_cache:
        ps = teng.page_stats()
        assert ps["prefix_hits"] > 0 and ps["cow_pages"] > 0
    teng.assert_pool_whole()
    if prefix_cache:   # and the prefix-on tokens equal the prefix-off ones
        off = serve_port(models, prefix_requests(),
                         dict(kw, prefix_cache=False))
        for a, b in zip(runs[1][2], off[2]):
            np.testing.assert_array_equal(runs[1][3][a].tokens,
                                          off[3][b].tokens)


def _cancel_drive(sched, rids):
    sched.cancel(rids[5])      # still queued: never admits
    sched.tick()
    sched.tick()               # admitted and prefilling
    sched.cancel(rids[0])      # live: slot and pages go next tick


@pytest.mark.parametrize("case", ["eos", "cancel_under_budget"])
def test_eos_cancel_and_budget_match_jax(models, case):
    """EOS ends requests early; cancels (one queued, one live) under a
    one-chunk prefill budget."""
    reqs = prefix_requests()
    kw = dict(PREFIX, n_pages=14, prefix_cache=True)
    sched_kw, drive = None, None
    if case == "eos":
        # the commonest token past the first of a plain run ends requests
        plain = serve_port(models, reqs, kw)
        toks = np.concatenate([c.tokens[1:] for c in plain[3].values()])
        kw["eos_id"] = int(np.bincount(toks).argmax())
    else:
        drive = _cancel_drive
        sched_kw = dict(prefill_budget=PREFIX["prefill_chunk"])
    runs = serve_both(models, reqs, kw, sched_kw=sched_kw, drive=drive)
    assert_same_completions(runs)
    eng, sched, rids, comps = runs[1]
    if case == "eos":
        assert any(len(comps[r].tokens) < m and comps[r].tokens[-1]
                   == kw["eos_id"] for r, (_, m) in zip(rids, reqs))
    else:
        assert sched.n_cancelled == 2 and rids[0] not in comps
    eng.update_slots(release=range(eng.n_slots))
    eng.assert_pool_whole()


@pytest.fixture(scope="module")
def jax_scores(models):
    """The JAX engine's score of one batch, full quorum and [1, 0].  It
    scores on a contiguous engine only (its paged engine routes the
    private contiguous pool through the paged step and raises)."""
    jcfg, _, jp, _ = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jeng = JaxEngine(jcfg, jp, **dict(PREFIX, paged=False))
    out = {}
    for mask in (None, [1, 0]):
        if mask is not None:
            jeng.set_quorum(mask)
        out[mask and tuple(mask)] = jeng.score(toks, labels)
    return toks, labels, out


@pytest.mark.parametrize("paged", [False, True])
def test_score_matches_jax_and_keeps_jensen(models, jax_scores, paged):
    """The port's score runs its private contiguous pool on either
    engine."""
    _, tcfg, _, tp = models
    toks, labels, want = jax_scores
    teng = EnsembleEngine(tcfg, tp, device="cpu", **dict(PREFIX, paged=paged))
    for mask in (None, [1, 0]):
        if mask is not None:
            teng.set_quorum(mask)
        jm, je = want[mask and tuple(mask)]
        tm, te = teng.score(toks, labels)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(te.item(), float(je), atol=1e-4,
                                   rtol=1e-4)
        w = teng.quorum.numpy()
        assert te.item() <= float((w * tm.numpy()).sum()) + 1e-6


_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
          "__float__", "__index__")


def test_greedy_tick_reads_the_device_once(models, monkeypatch):
    """Every tick reads the device in _harvest's one stacked transfer
    and nowhere else: admission, decode, prefill and page growth run on
    host mirrors (greedy rows never reach the sampler's host read)."""
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu",
                         **dict(PREFIX, n_pages=14, prefix_cache=True))
    sched = Scheduler(eng)
    for t, m in prefix_requests():
        sched.submit(t, m)
    counts = {}

    def counting(name, real):
        def wrapped(self, *a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real(self, *a, **k)
        return wrapped

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    ticks = 0
    while sched.has_work:
        counts.clear()
        sched.tick()
        ticks += 1
        # one transfer: .cpu() of the stacked tensor, then its .numpy()
        assert counts == {"cpu": 1, "numpy": 1}, counts
    monkeypatch.undo()
    assert ticks > 5 and eng.steps_run > 0 and eng.prefills_run > 0


def test_serve_forever_streams_every_token(models):
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu",
                         **dict(PRESSURE, n_pages=6))
    ref = Scheduler(EnsembleEngine(tcfg, tp, device="cpu",
                                   **dict(PRESSURE, n_pages=6)))
    ref_rids = [ref.submit(t, m) for t, m in PRESSURE_REQS]
    ref_comps = ref.run()
    sched = Scheduler(eng, retain_completions=False)
    streamed, done = {}, {}
    lock = threading.Lock()

    def on_token(rid, i, tok):
        with lock:
            streamed.setdefault(rid, []).append((i, tok))

    def on_done(comp):
        with lock:
            done[comp.rid] = comp

    loop = threading.Thread(target=sched.serve_forever, daemon=True)
    loop.start()
    rids = [sched.submit(t, m, on_token=on_token, on_done=on_done)
            for t, m in PRESSURE_REQS]
    assert sched.wait_quiesced(timeout=120)
    sched.stop()
    loop.join(timeout=30)
    assert not loop.is_alive()
    assert sched.completions == {} and sched.n_completed == len(rids)
    for r, rr in zip(rids, ref_rids):
        want = ref_comps[rr].tokens
        np.testing.assert_array_equal(done[r].tokens, want)
        # each index exactly once, in order, across preemptions
        assert streamed[r] == [(i, int(t)) for i, t in enumerate(want)]
    eng.assert_pool_whole()


def test_run_load_report(models):
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu",
                         **dict(PREFIX, n_pages=14, prefix_cache=True))
    reqs = client.make_requests(6, tcfg.vocab_size, prompt_len=(4, 20),
                                max_new=(2, 6), seed=0)
    r = client.run_load(eng, reqs)
    assert r["n_requests"] == 6 and r["members"] == K
    assert 0 < r["gen_tokens"] <= sum(m for _, m in reqs)
    assert 0 < r["ttft_p50_ms"] <= r["latency_p99_ms"]
    assert r["page_stats"]["n_pages"] == 14
    assert r["prefix_hit_rate"] is not None
    client.print_report(r)
