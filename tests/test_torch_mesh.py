"""The port's member mesh of the serving engine against repro.serving,
on the CPU.

In process, on a 1x1 mesh (local_mesh clamps to the one rank there is,
as the JAX package clamps to its one device): the CLI's mesh strings,
the clamp, the cross-rank Eqn-6 fusion against the port's own and
against JAX's `ensemble_log_probs_psum` under a 1x1 shard_map (1e-6),
`from_dense_sharded` against JAX's, and a 1x1 engine's tokens against
the unsharded engine's.

Then one world of 2 gloo ranks (common.sharding.spawn, one intra-op
thread each) serving reduced gemma3-1b cut to two layers (one local,
one global: torch_mesh_ranks.small) at f32 and K = 4, 2 members a rank,
from the JAX package's seeded init (handed to the ranks as numpy
arrays; the ranks import the port only, tests/torch_mesh_ranks.py),
while this process computes the JAX engine's references: paged and
contiguous generate against the JAX paged engine (tokens under the
margin rule: equal up to the first fork, and a fork only where the fused
top-2 margin is below 2e-5; fused log-probs within 1e-4 of JAX's
teacher-forced fusion along the path),
Scheduler.run completions, a quorum drop [1, 0, 1, 1], swap_params,
score (1e-4), SpeculativeEngine at gamma 3 (greedy: the JAX engine's
tokens, and the acceptance counts of the port's unsharded speculative
engine, which the first rank runs after the cases), each rank's cache bytes half the unsharded engine's, and the
follower's slot state equal to the leader's after every case, and
call replay's outcome check (a call that raises on one rank only stops
the follower).

Last, the serve CLI's `--mesh 2x1 --http` in its own process group: the
unsharded engine's tokens over HTTP before and after POST /admin/swap
(a rollout on a server thread while the first rank's loop serves), and
Ctrl-C draining every process to exit 0.
"""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro.common import sharding as jshd
from repro.configs import registry as jreg
from repro.core import compression as jcomp
from repro.core import ensemble as jens
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import Scheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.common import sharding as shd
from repro_torch.configs import registry as treg
from repro_torch.core import compression as tcomp
from repro_torch.core import ensemble as tens
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.frontend.replica import _src_pythonpath

K = ranks.K_SERVE
KW = ranks.SERVE_KW
MARGIN = 2e-5          # chip_smoke's phase-21 rule
LP_TOL = 1e-4
QUORUM = [1.0, 0.0, 1.0, 1.0]
N_NEW = 10
WORLD_TIMEOUT = 120.0  # seconds for the whole 2-rank world


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    """The 1x1 mesh local_mesh(2, 1) gives one process (a 1-rank gloo
    group, destroyed after the module)."""
    mesh = shd.local_mesh(2, 1, device="cpu")
    yield mesh
    dist.destroy_process_group()


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 9)]


REQS = [(np.arange(1, 8, dtype=np.int32), 8), (np.arange(2, 7), 6),
        (np.arange(3, 12), 8), (np.arange(1, 5), 5), (np.arange(7, 12), 7),
        (np.arange(4, 9), 6)]


def _score_batch():
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 512, (2, 8)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


# -- in process, on the 1x1 mesh ----------------------------------------------


def test_parse_mesh_arg(mesh1):
    for arg in ("", "1x1", "none", "off", "1X1"):
        assert shd.parse_mesh_arg(arg) is None
    with pytest.raises(ValueError, match="MxD"):
        shd.parse_mesh_arg("two-by-one")
    assert shd.mesh_shape_arg("2x1") == (2, 1)
    m = shd.parse_mesh_arg("2x1")   # one process: clamped to 1x1
    assert m.mesh_dim_names == (shd.MEMBER_AXIS, shd.DATA_AXIS)
    assert tuple(m.mesh.shape) == (1, 1)


def test_local_mesh_clamps(mesh1):
    m = shd.local_mesh(64, 64)
    assert m.mesh_dim_names == ("member", "data")
    assert (shd.axis_size(m, "member"), shd.axis_size(m, "data")) == (1, 1)
    assert shd.is_leader(m) and shd.member_rows(4, m) == slice(0, 4)


def test_fusion_psum_matches_port_and_jax(mesh1):
    """The cross-rank fusion on the 1x1 mesh against the port's
    single-device fusion and JAX's ensemble_log_probs_psum under a 1x1
    shard_map, a zero-weight member included: within 1e-6."""
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((K, 3, 33)) * 4).astype(np.float32)
    w = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    got = tens.ensemble_log_probs_psum(torch.from_numpy(z),
                                       torch.from_numpy(w), mesh1)
    ref = tens.ensemble_log_probs(torch.from_numpy(z),
                                  weights=torch.from_numpy(w))
    P = jax.sharding.PartitionSpec
    jm = jshd.local_mesh(2, 1)
    f = jax.jit(jshd.shard_map(
        lambda lg, ww: jens.ensemble_log_probs_psum(lg, ww, "member"), jm,
        in_specs=(P("member"), P("member")), out_specs=P()))
    want = np.asarray(f(jnp.asarray(z), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert (got.argmax(-1).numpy() == want.argmax(-1)).all()


@pytest.mark.parametrize("shards", [1, 4, 5])
def test_from_dense_sharded_matches_jax(shards):
    """Two-stage top-M (5 does not split V = 48: from_dense's): the same
    values and classes as JAX's; the pruned mass, a sum over V in
    another order, within 1e-6 relative."""
    rng = np.random.default_rng(shards)
    p = rng.random((3, 5, 48)).astype(np.float32)
    got = tcomp.from_dense_sharded(torch.from_numpy(p), 4, shards)
    want = jcomp.from_dense_sharded(jnp.asarray(p), 4, shards)
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.rest.numpy(), np.asarray(want.rest),
                               rtol=1e-6)
    for g, w in zip(got, tcomp.from_dense(torch.from_numpy(p), 4)):
        assert torch.equal(g, w)


def test_one_rank_mesh_engine_matches_unsharded(mesh1):
    """The mesh path (fusion by all-reduce, call replay's broadcast) on
    one rank: the unsharded engine's tokens."""
    cfg = ranks.small(treg.get_config("gemma3-1b", reduced=True))
    from repro_torch.models import transformer as ttf
    tp = ttf.init(cfg, seed=0, device="cpu", members=K)
    a = EnsembleEngine(cfg, tp, device="cpu", paged=True, **KW)
    b = EnsembleEngine(cfg, tp, device="cpu", paged=True, mesh=mesh1, **KW)
    for x, y in zip(a.generate(_prompts(), 6), b.generate(_prompts(), 6)):
        np.testing.assert_array_equal(x, y)
    assert b.cache_bytes() == a.cache_bytes() and b.n_local == K
    b.close()


# -- two ranks against the JAX engine -----------------------------------------


def _jax_fused_lp(jcfg, jp, prompts, paths):
    """JAX's teacher-forced Eqn-6 fusion along generated paths: for each
    (prompt i, tokens) of `paths`, the (n, V) log-probs each token was
    drawn from (one padded batch, one compile: the model is causal)."""
    rows = [(prompts[i], t) for i, t in paths]
    L = max(len(p) + len(t) - 1 for p, t in rows)
    seq = np.zeros((len(rows), L), np.int32)
    for r, (p, t) in enumerate(rows):
        x = np.concatenate([p, t[:-1]])
        seq[r, :len(x)] = x
    logits = jax.jit(jax.vmap(
        lambda pk: jtf.apply(pk, jcfg, jnp.asarray(seq), remat=False)[0]))(
        jp)
    lp = np.asarray(jens.ensemble_log_probs(logits))
    return [lp[r, len(p) - 1:len(p) - 1 + len(t)]
            for r, (p, t) in enumerate(rows)]


@pytest.fixture(scope="module")
def cli():
    """serve --mesh 2x1 --http on the CPU in its own process group (for
    test_serve_cli_mesh), started before `runs` so that its processes
    come up while that fixture's world and references run.  -> (the
    process, a queue of its merged output lines, None at its end)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--members", "4", "--batch", "2", "--prompt-len", "8", "--steps",
         "4", "--paged", "--page-size", "4", "--device", "cpu", "--dtype",
         "float32", "--mesh", "2x1", "--http", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
        env=dict(os.environ, PYTHONPATH=_src_pythonpath(),
                 OMP_NUM_THREADS="1"))
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    yield proc, lines
    _stop(proc)


def _stop(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


@pytest.fixture(scope="module")
def runs(cli):
    """-> (the 2 ranks' results, the JAX references).  The world runs
    while this process computes the references."""
    jcfg = ranks.small(jreg.get_config("gemma3-1b", reduced=True))
    init = jax.jit(jax.vmap(lambda k: jtf.init(k, jcfg)))
    jp = init(jax.random.split(jax.random.PRNGKey(0), K))
    jp2 = init(jax.random.split(jax.random.PRNGKey(1), K))
    params, params2 = jax.device_get(jp), jax.device_get(jp2)
    prompts, score_batch = _prompts(), _score_batch()
    world = shd.spawn(ranks.serve_world, 2,
                      (params, params2, prompts, N_NEW, REQS, score_batch,
                       QUORUM), timeout=WORLD_TIMEOUT, wait=False)
    try:
        ref = {}
        jeng = JaxEngine(jcfg, jp, paged=True, **KW)
        ref["generate_paged"] = jeng.generate(prompts, N_NEW)
        sched = JaxScheduler(jeng)
        rids = [sched.submit(t, m) for t, m in REQS]
        done = sched.run()
        ref["scheduler"] = [done[r].tokens for r in rids]
        jeng.set_quorum(QUORUM)
        ref["dropped"] = jeng.generate(prompts, N_NEW)
        jeng.set_quorum([1.0] * K)
        jeng.swap_params(jp2)
        ref["swapped"] = jeng.generate(prompts, N_NEW)
        # the JAX engine scores from its contiguous programs only (a
        # paged one's score steps its private contiguous pool through
        # the paged program); the port scores from either
        jc = JaxEngine(jcfg, jp2, paged=False, **KW)
        m, e = jc.score(*score_batch)
        ref["score"] = np.asarray(m), float(e)
        ref["lp"] = _jax_fused_lp(jcfg, jp, prompts,
                                  list(enumerate(ref["generate_paged"])))
        tcfg = ranks.small(treg.get_config("gemma3-1b", reduced=True))
        tp = bridge.params_from_numpy(params, "cpu")
        ref["cache_bytes"] = {
            paged: EnsembleEngine(tcfg, tp, device="cpu", paged=paged,
                                  **KW).cache_bytes()
            for paged in (True, False)}
    finally:
        out = world.join()
    return out, ref


def _margin_check(toks, want, lp_want, what):
    """Tokens equal up to the first fork, a fork only below MARGIN.
    -> steps compared."""
    toks, want = np.asarray(toks), np.asarray(want)
    assert len(toks) == len(want), what
    top = np.sort(lp_want, axis=-1)[:, -2:]
    margins = top[:, 1] - top[:, 0]
    diff = np.nonzero(toks != want)[0]
    if diff.size:
        assert margins[diff[0]] < MARGIN, \
            f"{what}: fork at step {diff[0]}, margin {margins[diff[0]]}"
        return int(diff[0]) + 1
    return len(want)


@pytest.mark.parametrize("pool", ["paged", "contig"])
def test_generate_matches_jax_engine(runs, pool):
    """Both pools against the JAX paged engine's tokens and JAX's
    teacher-forced fusion along them (the JAX package holds its paged
    and contiguous engines' tokens equal)."""
    out, ref = runs
    name = f"generate_{pool}"
    toks, lps = out[0][name]
    for i, (t, w, lp_w, lp) in enumerate(zip(toks, ref["generate_paged"],
                                             ref["lp"], lps)):
        n = _margin_check(t, w, lp_w, f"{name} prompt {i}")
        np.testing.assert_allclose(lp[:n], lp_w[:n], atol=LP_TOL)


def test_scheduler_run_matches_jax(runs):
    out, ref = runs
    for got, want in zip(out[0]["scheduler"], ref["scheduler"]):
        np.testing.assert_array_equal(got, want)


def test_quorum_drop_and_swap_match_jax(runs):
    out, ref = runs
    dropped, swapped, _, _ = out[0]["quorum_swap_score"]
    for got, want in zip(dropped, ref["dropped"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(swapped, ref["swapped"]):
        np.testing.assert_array_equal(got, want)


def test_score_matches_jax(runs):
    out, ref = runs
    _, _, m, e = out[0]["quorum_swap_score"]
    m_w, e_w = ref["score"]
    assert m.shape == (K,)
    np.testing.assert_allclose(m, m_w, atol=1e-4)
    assert abs(e - e_w) <= 1e-4
    assert e <= m.mean() + 1e-6                     # Jensen


def test_speculative_matches_jax(runs):
    """Greedy speculative decoding emits the plain fused engine's tokens
    (the JAX package's own guarantee, and the port's against JAX's
    SpeculativeEngine in tests/test_torch_spec_engine.py), so the 2-rank
    speculative tokens are held against the JAX engine's, and the
    acceptance counts against the port's unsharded speculative
    engine's."""
    out, ref = runs
    toks, stats = out[0]["speculative"]
    for got, want in zip(toks, ref["generate_paged"]):
        np.testing.assert_array_equal(got, want)
    assert stats["spec_steps"] > 0
    for key in ("spec_steps", "proposed", "accepted", "pruned_frac",
                "emitted_hist"):
        assert stats[key] == out[0]["speculative_unsharded"][key], key


def test_replay_compares_outcomes(runs):
    """A call that raises on every rank (a quorum mask of the wrong
    length) is kept in the follower's replay_errors and following goes
    on; one that raises on the leader only, or on the follower only,
    makes follow() raise: the ranks' states would differ."""
    out, _ = runs
    lead, follow = out[0]["outcomes"], out[1]["outcomes"]
    assert len(lead["leader"]) == 2
    assert "quorum mask wants 4 entries" in lead["leader"][0]
    assert "the leader's own fault" in lead["leader"][1]
    [err] = follow["replay_errors"]
    assert err.startswith("set_quorum: ValueError('quorum mask wants 4 "
                          "entries")
    assert len(follow["follower"]) == 2
    assert "set_quorum raised on the leader only" in follow["follower"][0]
    assert "the leader's own fault" in follow["follower"][0]
    assert "replayed set_quorum raised on this rank only" in \
        follow["follower"][1]


def test_each_rank_holds_half_the_cache(runs):
    out, ref = runs
    assert [o["rows"] for o in out] == [(0, 2), (2, 4)]
    for name, paged in (("generate_paged", True), ("generate_contig", False)):
        for o in out:
            assert 2 * o[name + "_cache_bytes"] == ref["cache_bytes"][paged]


def test_followers_hold_the_leaders_tokens(runs):
    """After every case the follower's slot state is the leader's, and
    it replayed every call without an error."""
    out, _ = runs
    cases = ("generate_paged", "generate_contig", "quorum_swap_score",
             "scheduler", "speculative")
    for name in cases:
        for key in ("out", "n_gen"):
            np.testing.assert_array_equal(out[1][name + "_held"][key],
                                          out[0][name + "_held"][key])
        assert out[1][name] > 0 and out[1][name + "_errors"] == []


def _cli_line(lines, prefix, seen, timeout=90.0):
    """The CLI's next output line that starts with `prefix` (every line
    taken is kept in `seen`); None: the output ended first."""
    deadline = time.monotonic() + timeout
    while True:
        line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
        if line is None:
            return None
        seen.append(line)
        if line.startswith(prefix):
            return line


def test_serve_cli_mesh(cli):
    """serve --mesh 2x1 --http on the CPU: two gloo processes behind the
    frontend, the placement line, tokens over HTTP equal to the
    unsharded engine's; POST /admin/swap {"seed": 1} sent while a
    request streams (the rollout runs on the server's thread while the
    first rank's loop serves: that request ends on the old weights or,
    parked behind the drain, on the new), the new weights' tokens after
    it; SIGINT to the process group (Ctrl-C) drains, the followers
    ignore it, and every process exits 0."""
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import client
    proc, lines = cli
    seen = []
    try:
        placed = _cli_line(lines, "engine:", seen)
        assert placed, "\n".join(seen)
        url = _cli_line(lines, "frontend:", seen).split()[1]
        cfg = treg.get_config("gemma3-1b", reduced=True).with_(
            dtype="float32")
        kw = dict(n_slots=2, max_prompt=8, max_out=4, paged=True,
                  page_size=4, device="cpu")
        prompts = [p[:8] for p in _prompts()[:2]]   # --prompt-len 8
        want = [EnsembleEngine(cfg, ttf.init(cfg, seed=s, device="cpu",
                                             members=K), **kw)
                .generate(prompts, 4) for s in (0, 1)]
        for p, w in zip(prompts, want[0]):
            assert client.http_generate(url, p, 4)["tokens"] == w.tolist()
        during = {}
        t = threading.Thread(target=lambda: during.update(
            client.http_generate(url, prompts[0], 4, stream=True)))
        t.start()
        status, _, body = _post(url, "/admin/swap", {"seed": 1})
        t.join(60)
        assert not t.is_alive()
        assert status == 200 and body["swaps_done"] == 1, body
        assert during["tokens"] in (want[0][0].tolist(),
                                    want[1][0].tolist())
        for p, w in zip(prompts, want[1]):
            assert client.http_generate(url, p, 4)["tokens"] == w.tolist()
        os.killpg(proc.pid, signal.SIGINT)
        proc.wait(timeout=60)
        while _cli_line(lines, "", seen, timeout=10) is not None:
            pass
    finally:
        _stop(proc)
    out = "\n".join(seen)
    assert proc.returncode == 0, out
    assert "mesh {'member': 2, 'data': 1} over 2 devices, 2 members/" \
        "device" in placed
    assert "drained; bye" in out


def _post(url, path, body):
    """-> (status, headers, decoded JSON) of one POST."""
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 method="POST", headers={
                                     "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120.0) as r:
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def test_shard_pool_takes_the_ranks_rows(mesh1):
    """shard_pool on the 1x1 mesh: every row, as copies; init_pool over
    the mesh allocates the rank's K/M members (all K on one rank)."""
    from repro_torch.serving import kv_cache
    cfg = ranks.small(treg.get_config("gemma3-1b", reduced=True))
    pool = kv_cache.init_pool(cfg, K, 2, 16, page_size=4, n_pages=8,
                              device="cpu")
    mine = kv_cache.shard_pool(pool, mesh1)
    for (_, a), (_, b) in zip(kv_cache._leaves(pool),
                              kv_cache._leaves(mine)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    local = kv_cache.init_pool(cfg, K, 2, 16, page_size=4, n_pages=8,
                               device="cpu", mesh=mesh1)
    assert kv_cache.pool_bytes(local) == kv_cache.pool_bytes(pool)
