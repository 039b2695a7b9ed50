"""The port's speculative decoding against repro's, at reduced gemma3-1b
(f32, 5 ring layers and 2 global ones) and deepseek-v2 (MLA).

The invariant everywhere is repro's: speculation never changes a greedy
token, only its cost.  verify_slots / verify_step_paged give repro's
logits at every valid chunk position (2e-5), rows with n_tok 0 and 1
included; snapshot_positions / restore_positions, the acceptance rules
and prunable_members are repro's given the same inputs; a greedy
SpeculativeEngine gives repro's SpeculativeEngine's tokens and
acceptance counts (contiguous and paged, weights bridged from the JAX
init) and the port's plain engine's tokens: with {"draft": False} rows,
with a shallow draft_cfg, over int8 pages.  The stochastic path is
deterministic under a seed, the gates raise repro's errors, the serve
CLI runs --kv-dtype int8 and --draft-ckpt, and a Scheduler tick over a
speculative engine reads the device once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import ensemble as jens
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import kv_cache as jkv
from repro.serving.spec import SpeculativeEngine as JaxSpec
from repro.serving.spec import verify as jverify
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import store
from repro_torch.common.tree import tree_map
from repro_torch.configs import registry as treg
from repro_torch.core import ensemble as tens
from repro_torch.kernels import ops
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.spec import DraftEngine, SpeculativeEngine
from repro_torch.serving.spec import verify as tverify
from repro_torch.serving.spec.draft import as_member_stack

TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "gemma3-1b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bridge(arch, K, seed):
    jcfg = jreg.get_config(arch, reduced=True).with_(dtype="float32")
    tcfg = treg.get_config(arch, reduced=True).with_(dtype="float32")
    jp = jax.jit(jax.vmap(lambda k: jtf.init(k, jcfg)))(
        jax.random.split(jax.random.PRNGKey(seed), K))
    return jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _bridge(ARCH, 3, 7)


def _prompts(B, plen, seed=1, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen).astype(np.int32)
            for _ in range(B)]


def _student(tp):
    return tree_map(lambda x: x[0], tp)


# -- verify ------------------------------------------------------------------


def _prefill_both(jcfg, tcfg, jp, tp, jc, tc, paged, toks, plen, C=8):
    pre = jtf.prefill_step_paged if paged else jtf.prefill_slots
    jpre = jax.jit(jax.vmap(lambda p, c, t, n: pre(p, jcfg, c, t, n),
                            in_axes=(0, 0, None, None)))
    tpre = ttf.prefill_step_paged if paged else ttf.prefill_slots
    for b, n_all in enumerate(plen):
        for start in range(0, n_all, C):
            n = min(C, n_all - start)
            ch = np.zeros((1, C), np.int32)
            ch[0, :n] = toks[b, start:start + n]
            nj = jnp.int32(n) if paged else jnp.asarray([n], jnp.int32)
            _, jrow = jpre(jp, jkv.slot_row(jc, b), ch, nj)
            jc = jkv.write_slot_row(jc, jrow, b)
            _, trow = tpre(tp, tcfg, tkv.slot_row(tc, b),
                           torch.from_numpy(ch),
                           torch.tensor([n], dtype=torch.int32))
            tkv.write_slot_row(tc, trow, b)
    return jc, tc


@pytest.mark.parametrize("paged", [False, True])
def test_verify_logits_match_repro(paged, models, monkeypatch):
    """Three rows at different positions score a 5-token chunk with
    n_tok 5, 0 and 1: logits at every valid position within 2e-5 of
    repro's, idx advanced by n_tok, and the pools' planes equal (a row
    with n_tok 0 untouched).  max_seq 40 puts gemma3's local layers on
    rings of 16; every attention layer launches flash once."""
    jcfg, tcfg, jp, tp = models
    K = tp["embed"].shape[0]
    B, C, S, page = 3, 5, 40, 4
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (B, 40)).astype(np.int32)
    kw = dict(page_size=page, n_pages=B * S // page) if paged else {}
    jc = jax.vmap(lambda _: jtf.init_slot_cache(jcfg, B, S, **kw))(
        jnp.arange(K))
    tc = ttf.init_slot_cache(tcfg, B, S, members=K, device="cpu", **kw)
    if paged:
        perm = rng.permutation(kw["n_pages"]).reshape(B, -1).astype(np.int32)
        jc["page_table"] = jnp.broadcast_to(perm, (K,) + perm.shape)
        tc["page_table"] = torch.from_numpy(perm).expand(K, *perm.shape) \
            .contiguous()
    jc, tc = _prefill_both(jcfg, tcfg, jp, tp, jc, tc, paged, toks,
                           (19, 11, 30))
    chunk = rng.integers(0, 512, (B, C)).astype(np.int32)
    n_tok = np.array([C, 0, 1], np.int32)
    ver = jtf.verify_step_paged if paged else jtf.verify_slots
    jl, jc = jax.jit(jax.vmap(lambda p, c: ver(p, jcfg, c, chunk, n_tok)))(
        jp, jc)
    flash = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: flash.append(1) or real(*a, **k))
    tver = ttf.verify_step_paged if paged else ttf.verify_slots
    tl, tc = tver(tp, tcfg, tc, torch.from_numpy(chunk),
                  torch.from_numpy(n_tok))
    assert tl.shape == (K, B, C, tcfg.vocab_size)
    for b, n in enumerate(n_tok):
        np.testing.assert_allclose(tl[:, b, :n].numpy(),
                                   np.asarray(jl)[:, b, :n], **TOL)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))
    jleaves = {}

    def visit(path, x):
        name = next((str(e.key) for e in reversed(path)
                     if isinstance(e, jax.tree_util.DictKey)), "")
        jleaves.setdefault(name, []).append(np.asarray(x))

    jax.tree_util.tree_map_with_path(visit, jc["segments"])
    for name, x in tkv._leaves(tc["segments"]):
        np.testing.assert_allclose(x.numpy(), jleaves[name].pop(0), **TOL)
    # ring layers take their chunk prefill, paged ones the verify: flash
    # on every attention layer either way
    assert len(flash) == tcfg.n_layers


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_mla_verify_layer_matches_repro(kv_dtype):
    """One MLA layer of reduced deepseek-v2 over a paged latent pool
    (int8: the latent quantized, the rope keys native): the port's
    mla_prefill_paged, its verify too, gives repro's mla_verify_paged's
    outputs at valid positions and its pages."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    jcfg = jreg.get_config("deepseek-v2-236b", reduced=True).with_(
        dtype="float32")
    tcfg = treg.get_config("deepseek-v2-236b", reduced=True).with_(
        dtype="float32")
    B, C, page, n_pages, P = 3, 5, 4, 30, 10
    rng = np.random.default_rng(3)
    lj = jattn.attn_init(jax.random.PRNGKey(3), jcfg, jcfg.attn,
                         jnp.float32)
    lt = params_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None], lj),
                           "cpu")
    jc = jattn.mla_paged_cache_init(jcfg.attn, n_pages, page, jnp.float32,
                                    kv_dtype)
    tc = tattn.mla_paged_cache_init(tcfg.attn, (1,), n_pages, page,
                                    torch.float32, "cpu", kv_dtype)
    for name, x in tc.items():        # the same random prior content
        v = rng.normal(size=x.shape[1:]).astype(np.float32) * 0.3
        q = (jattn.kv_quantize(jnp.asarray(v), jnp.int8)[0]
             if x.dtype == torch.int8 else jnp.asarray(np.abs(v) * 0.01
                                                       if "scale" in name
                                                       else v))
        jc[name] = q
        x.copy_(torch.from_numpy(np.array(q)))
    table = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    pos = np.array([9, 0, 17], np.int32)
    n_tok = np.array([C, 0, 1], np.int32)
    x = rng.normal(size=(B, C, jcfg.d_model)).astype(np.float32)
    jo, jc2 = jax.jit(lambda c: jattn.mla_verify_paged(
        lj, jnp.asarray(x), c, pos, n_tok, table, jcfg.attn, jcfg,
        jcfg.attn.rope_theta))(jc)
    fold = {k: v.view(-1, *v.shape[2:]) for k, v in tc.items()}
    tt = torch.from_numpy(table)[None]
    to = tattn.mla_prefill_paged(lt, torch.from_numpy(x)[None], fold,
                                torch.from_numpy(pos),
                                torch.from_numpy(n_tok), tt, tt,
                                tcfg.attn, tcfg, tcfg.attn.rope_theta)
    for b, n in enumerate(n_tok):
        np.testing.assert_allclose(to[0, b, :n].numpy(),
                                   np.asarray(jo)[b, :n], **TOL)
    for name, v in tc.items():
        np.testing.assert_allclose(v[0].float().numpy(),
                                   np.asarray(jc2[name]).astype(np.float32),
                                   **TOL)


def test_snapshot_restore_match_repro(models):
    jcfg, tcfg, _, _ = models
    B, C = 3, 4
    start = np.array([2, 5, 14], np.int32)
    keep = np.array([1, 4, 0], np.int32)
    jpool = jkv.init_pool(jcfg, 2, B, 40)
    tpool = tkv.init_pool(tcfg, 2, B, 40, device="cpu")
    rng = np.random.default_rng(4)
    vals = {}
    for name, x in tkv._leaves(tpool["segments"]):
        x.copy_(torch.from_numpy(rng.normal(size=x.shape).astype(
            np.float32)))
        vals.setdefault(name, []).append(x.numpy().copy())
    order = {k: list(v) for k, v in vals.items()}

    def fill(path, x):
        name = next((str(e.key) for e in reversed(path)
                     if isinstance(e, jax.tree_util.DictKey)), "")
        return jnp.asarray(order[name].pop(0))

    jpool["segments"] = jax.tree_util.tree_map_with_path(
        fill, jpool["segments"])
    jsnap = jkv.snapshot_positions(jpool, jnp.asarray(start), C)
    tsnap = tkv.snapshot_positions(tpool, torch.from_numpy(start), C)
    jdirty = jax.tree.map(lambda x: x + 1.0, jpool["segments"])
    jpool["segments"] = jdirty
    for _, x in tkv._leaves(tpool["segments"]):
        x.add_(1.0)
    jback = jkv.restore_positions(jpool, jsnap, jnp.asarray(start),
                                  jnp.asarray(keep))
    tkv.restore_positions(tpool, tsnap, torch.from_numpy(start),
                          torch.from_numpy(keep))
    want = {}

    def visit(path, x):
        name = next((str(e.key) for e in reversed(path)
                     if isinstance(e, jax.tree_util.DictKey)), "")
        want.setdefault(name, []).append(np.asarray(x))

    jax.tree_util.tree_map_with_path(visit, jback["segments"])
    for name, x in tkv._leaves(tpool["segments"]):
        np.testing.assert_array_equal(x.numpy(), want[name].pop(0))


# -- acceptance rules, pruning -----------------------------------------------


def _lp(rng, *shape):
    z = rng.normal(size=shape).astype(np.float32) * 2
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


def test_acceptance_rules_match_repro():
    rng = np.random.default_rng(5)
    B, G, V = 6, 4, 9
    drafts = rng.integers(0, V, (B, G)).astype(np.int32)
    choice = drafts.copy()
    choice[1, 0] = (choice[1, 0] + 1) % V
    choice[2, 2] = (choice[2, 2] + 1) % V
    choice = np.concatenate([choice, rng.integers(0, V, (B, 1))], 1) \
        .astype(np.int32)
    np.testing.assert_array_equal(
        tverify.greedy_accept(torch.from_numpy(drafts),
                              torch.from_numpy(choice)).numpy(),
        np.asarray(jverify.greedy_accept(drafts, choice)))
    u = rng.uniform(size=(B, G)).astype(np.float32)
    tlp, dlp = _lp(rng, B, G + 1, V), _lp(rng, B, G, V)
    dlp[0] = tlp[0, :G]                       # the draft is the target
    np.testing.assert_array_equal(
        tverify.stochastic_accept(*map(torch.from_numpy,
                                       (u, drafts, tlp, dlp))).numpy(),
        np.asarray(jverify.stochastic_accept(u, drafts, tlp, dlp)))
    np.testing.assert_allclose(
        tverify.residual_log_probs(torch.from_numpy(tlp[:, :G]),
                                   torch.from_numpy(dlp)).numpy(),
        np.asarray(jverify.residual_log_probs(tlp[:, :G], dlp)),
        rtol=1e-5, atol=1e-5)


def test_prunable_members_match_repro():
    rng = np.random.default_rng(6)
    K, B, C, V = 4, 3, 5, 40
    lg = (rng.normal(size=(K, B, C, V)) * 3).astype(np.float32)
    w = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    fused = jens.ensemble_log_probs(jnp.asarray(lg), weights=jnp.asarray(w))
    want = np.asarray(jens.prunable_members(jnp.asarray(lg), fused,
                                            jnp.asarray(w)))
    tl = torch.from_numpy(lg)
    tf_ = tens.ensemble_log_probs(tl, weights=torch.from_numpy(w))
    got = tens.prunable_members(tl, tf_, torch.from_numpy(w))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tens.prunable_members(tl, tf_, torch.from_numpy(w),
                              member_lp=tens.member_log_probs(tl)).numpy(),
        want)


# -- engines -----------------------------------------------------------------

B, PLEN, STEPS = 3, 6, 10
ENG = dict(n_slots=B, max_prompt=PLEN, max_out=STEPS, prefill_chunk=4)
PAGED = dict(paged=True, page_size=4, n_pages=64)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_spec_matches_plain(models, paged):
    """Distinct members, member 0 as the student: acceptance is low and
    partial, and the tokens are the port's plain engine's, contiguous
    and paged (tests/test_torch_spec_engine.py holds the paged engine
    against repro's)."""
    _, tcfg, _, tp = models
    kw = dict(ENG, **(PAGED if paged else {}))
    prompts = _prompts(B, PLEN)
    plain = EnsembleEngine(tcfg, tp, device="cpu", **kw).generate(
        prompts, max_new=STEPS)
    spec = SpeculativeEngine(tcfg, tp, _student(tp), gamma=3, device="cpu",
                             **kw)
    for g, p in zip(spec.generate(prompts, max_new=STEPS), plain):
        np.testing.assert_array_equal(g, p)
    ts = spec.spec_stats()
    assert ts["proposed"] > 0 and 0 < ts["accepted"] < ts["proposed"]
    if paged:
        spec.update_slots(release=range(B))
        spec.assert_pool_whole()


def test_draft_off_rows_and_mixed_batch(models):
    """{"draft": False} requests verify one position a step; mixed with
    drafting ones in a Scheduler run, every request gets the plain
    engine's tokens; all draft-off runs the plain step only."""
    _, tcfg, _, tp = models
    prompts = _prompts(B, PLEN, seed=2)
    kw = dict(ENG, **PAGED)
    ref = EnsembleEngine(tcfg, tp, device="cpu", **kw).generate(
        prompts, max_new=STEPS)
    for flags in ([False, False, False], [True, False, True]):
        spec = SpeculativeEngine(tcfg, tp, _student(tp), gamma=3,
                                 device="cpu", **kw)
        sched = Scheduler(spec)
        rids = [sched.submit(p, STEPS, draft=f)
                for p, f in zip(prompts, flags)]
        comps = sched.run()
        for r, want in zip(rids, ref):
            np.testing.assert_array_equal(comps[r].tokens, want)
        assert (spec.spec_steps_run > 0) == any(flags)
        spec.assert_pool_whole()
        spans = [ev["event"] for r, f in zip(rids, flags) if f
                 for ev in comps[r].trace["events"]]
        assert ("spec_step" in spans) == any(flags)
    with pytest.raises(ValueError, match="draft"):
        Scheduler(spec).submit(prompts[0], 2, draft="yes")


def test_shallow_draft_accepts_everything(models):
    """Members whose layers past depth 2 are residual no-ops are the
    2-layer truncation's bit for bit: every draft is accepted and the
    tokens are still the plain engine's."""
    _, tcfg, _, _ = models
    K, gamma = 3, 3
    dcfg = tcfg.with_(n_layers=2)
    full = ttf.init(tcfg, seed=11, device="cpu", members=1)
    student = ttf.init(dcfg, seed=12, device="cpu", members=1)
    student["embed"] = full["embed"]
    student["final_norm"] = full["final_norm"]
    for i in range(2):
        student["segments"][0][f"slot_{i}"] = tree_map(
            lambda x: x[:, :1].clone(), full["segments"][0][f"slot_{i}"])
    member = tree_map(lambda x: x.clone(), full)
    for s, seg in enumerate(member["segments"]):
        for name, layer in seg.items():
            i = int(name.split("_")[1])
            if s == 0 and i < 2:
                layer["attn"]["w_o"][:, 1:] = 0
                layer["mlp"]["w_down"][:, 1:] = 0
            else:
                layer["attn"]["w_o"].zero_()
                layer["mlp"]["w_down"].zero_()
    params = tree_map(lambda x: x.expand(K, *x.shape[1:]).contiguous(),
                      member)
    prompts = _prompts(2, 4, seed=3)
    kw = dict(n_slots=2, max_prompt=4, max_out=9, prefill_chunk=4,
              device="cpu")
    ref = EnsembleEngine(tcfg, params, **kw).generate(prompts, max_new=9)
    spec = SpeculativeEngine(tcfg, params, student, draft_cfg=dcfg,
                             gamma=gamma, **kw)
    for a, b in zip(spec.generate(prompts, max_new=9), ref):
        np.testing.assert_array_equal(a, b)
    assert spec.spec_stats()["acceptance_rate"] == 1.0


def test_spec_over_int8_pages(models):
    """The twin of tests/test_kv_quant.py::test_spec_rollback_int8_bit_
    identical: verify writes C quantized tokens, rejection truncates the
    chain, and the tokens stay the plain int8 engine's."""
    _, tcfg, _, tp = models
    prompts = _prompts(B, PLEN, seed=4)
    kw = dict(ENG, **PAGED, kv_dtype="int8", device="cpu")
    ref = EnsembleEngine(tcfg, tp, **kw).generate(prompts, max_new=STEPS)
    spec = SpeculativeEngine(tcfg, tp, _student(tp), gamma=3, **kw)
    for a, b in zip(spec.generate(prompts, max_new=STEPS), ref):
        np.testing.assert_array_equal(a, b)
    assert spec.spec_stats()["spec_steps"] > 0


def test_draft_engine_is_the_student(models):
    _, tcfg, _, tp = models
    prompts = _prompts(2, 5, seed=6)
    kw = dict(n_slots=2, max_prompt=5, max_out=6, prefill_chunk=4,
              device="cpu")
    want = EnsembleEngine(tcfg, tree_map(lambda x: x[:1], tp),
                          **kw).generate(prompts, max_new=6)
    got = DraftEngine(tcfg, _student(tp), **kw).generate(prompts, max_new=6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    stacked = tree_map(lambda x: x[:1], tp)
    assert as_member_stack(stacked, like=tp) is stacked
    with pytest.raises(ValueError, match="K=2"):
        as_member_stack(tree_map(lambda x: x[:2], tp), like=tp)


def test_stochastic_deterministic_under_seed(models):
    _, tcfg, _, tp = models
    prompts = _prompts(2, 4, seed=7)
    kw = dict(n_slots=2, max_prompt=4, max_out=8, prefill_chunk=4,
              device="cpu")

    def run(seed):
        spec = SpeculativeEngine(tcfg, tp, _student(tp), gamma=3,
                                 spec_sampling=True, **kw)
        sched = Scheduler(spec)
        rids = [sched.submit(p, 8, temperature=0.9, top_k=20, seed=seed)
                for p in prompts]
        comps = sched.run()
        return [comps[r].tokens for r in rids], spec.spec_stats()

    (a, sa), (b, _), (c, _) = run(42), run(42), run(43)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    assert sa["spec_steps"] > 0 and all(len(x) == 8 for x in a)


def test_draft_layout_is_checked(models):
    _, tcfg, _, tp = models
    bad = _student(tp)
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError, match="draft leaf"):
        SpeculativeEngine(tcfg, tp, bad, device="cpu", **ENG)
    with pytest.raises(ValueError, match="tree structure"):
        SpeculativeEngine(tcfg, tp, _student(tp), device="cpu",
                          draft_cfg=tcfg.with_(n_layers=2), **ENG)


def test_tick_reads_the_device_once(models, monkeypatch):
    """A Scheduler tick over a speculative engine reads the device once,
    in the harvest, which carries the stats vector too; the host
    positions resync from it and the lookahead pages come back."""
    _, tcfg, _, tp = models
    spec = SpeculativeEngine(tcfg, tp, _student(tp), gamma=3, device="cpu",
                             **dict(ENG, paged=True, page_size=4,
                                    n_pages=8))
    sched = Scheduler(spec)
    for p in _prompts(5, PLEN, seed=8):
        sched.submit(p, STEPS)
    counts = {}

    def counting(name, real):
        def wrapped(self, *a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real(self, *a, **k)
        return wrapped

    for name in ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    ticks = 0
    while sched.has_work:
        counts.clear()
        sched.tick()
        ticks += 1
        assert counts == {"cpu": 1, "numpy": 1}, counts
    monkeypatch.undo()
    assert spec.spec_steps_run > 3 and sched.preemptions > 0
    sched._flush_release()
    spec.assert_pool_whole()
    assert spec.spec_stats()["spec_steps"] == spec.spec_steps_run


def test_serve_cli_kv_dtype_and_draft_ckpt(tmp_path, capsys):
    from repro_torch.launch import serve
    base = ["--reduced", "--members", "2", "--batch", "2", "--prompt-len",
            "8", "--steps", "5", "--paged", "--page-size", "4", "--device",
            "cpu", "--dtype", "float32"]
    # --gamma alone tunes nothing: only --draft-ckpt turns speculation on
    assert serve.main(base + ["--kv-dtype", "int8", "--continuous",
                              "--requests", "3", "--gamma", "3"]) == 0
    out = capsys.readouterr().out
    assert "int8 pages" in out and "tok/s" in out
    assert "draft model" not in out and "speculative" not in out
    cfg = treg.get_config(ARCH, reduced=True).with_(dtype="float32")
    params = ttf.init(cfg, seed=0, device="cpu", members=2)
    store.save_checkpoint(str(tmp_path), 3, tree_map(lambda x: x[:1],
                                                     params))
    assert serve.main(base + ["--draft-ckpt", str(tmp_path), "--gamma",
                              "3"]) == 0
    out = capsys.readouterr().out
    assert "draft model: step 3" in out and "speculative: gamma 3" in out
