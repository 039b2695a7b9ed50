"""The port's jamba (Mamba and attention layers 7:1, MoE on every odd
layer) against repro at its reduced config, f32, K=4 members, weights
bridged from the JAX init.

Mamba's apply, decode and prefill and the MoE FFN are held against
repro.models.ssm and repro.models.moe one layer at a time; logits of
`apply` (and its MoE aux loss) and of paged and contiguous prefill plus
decode must agree to atol = rtol = 1e-4 (tests/test_torch_model.py's:
the JAX side runs Mamba's associative scan, the port's plain path the
sequential one, and sums its f32 matmuls in another order).  Greedy
`generate` must give the JAX engine's tokens, and so must an
interleaving of prefill and decode calls that leaves a mid-prompt slot
frozen across decode steps: its conv and ssm planes must not move.

The MoE's top-k may order exact ties differently in torch.topk and
lax.top_k; with random f32 weights ties do not occur.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import EnsembleEngine
from test_torch_engine import check_init_has_the_jax_tree
from test_torch_model import _run_both

TOL = dict(atol=1e-4, rtol=1e-4)
K = 4
ARCH = "jamba-v0.1-52b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these shapes it is the fastest even
    alone, and the suite's workers share the cores (torch's default,
    one thread a core in every worker, oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = treg.get_config(ARCH, reduced=True).with_(dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_engines(models):
    """repro's engine for a configuration, built (and compiled) once for
    the module: the generate and frozen-slot tests share the ones they
    both use (JAX's compiles are most of this file's time)."""
    jcfg, _, jp, _ = models
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = JaxEngine(jcfg, jp, **kw)
        return cache[key]

    return get


def prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def block(models, slot: int, part: str):
    """Layer `slot`'s `part` subtree in both packages, (K, ...) leaves."""
    _, _, jp, tp = models
    return (jax.tree.map(lambda a: a[:, 0],
                         jp["segments"][0][f"slot_{slot}"][part]),
            {k: v[:, 0] for k, v in
             tp["segments"][0][f"slot_{slot}"][part].items()})


def test_reduced_config_is_the_architecture(models):
    _, tcfg, _, tp = models
    specs = tcfg.layer_specs()
    assert [s.mixer for s in specs].count("attn") == 1
    assert [s.mixer for s in specs].count("mamba") == 7
    assert [s.ffn for s in specs] == ["dense", "moe"] * 4
    assert [ttf.layer_pages(tcfg, s, 40) for s in specs] == \
        [s.mixer == "attn" for s in specs]
    assert set(tp["segments"][0]["slot_1"]) == {"norm_mix", "mamba",
                                                "norm_ffn", "moe"}
    pool = tkv.init_pool(tcfg, K, 2, 16, page_size=4, n_pages=8,
                         device="cpu")
    seg = pool["segments"][0]
    d_inner, _ = tssm.mamba_dims(tcfg)
    assert set(seg["slot_0"]) == {"conv", "ssm"}
    assert seg["slot_0"]["conv"].shape == (K, 1, 2, 3, d_inner)
    assert seg["slot_0"]["ssm"].dtype == torch.float32
    assert set(seg["slot_3"]) == {"k_pages", "v_pages"}
    # the recurrent planes are per-slot state: reset, snapshot, restore
    assert not tkv._skip_slot_update("conv")
    assert not tkv._skip_slot_update("ssm")


def _state(rng, B, d_inner, cfg):
    return {"conv": rng.standard_normal(
                (K, B, cfg.ssm.conv_width - 1, d_inner)).astype(np.float32),
            "ssm": (rng.standard_normal((K, B, d_inner, cfg.ssm.d_state))
                    * 0.5).astype(np.float32)}


@pytest.mark.parametrize("path", ["apply", "decode"])
def test_mamba_apply_and_decode_match(models, path):
    jcfg, tcfg, _, _ = models
    jb, tb = block(models, 0, "mamba")
    rng = np.random.default_rng(0)
    d_inner, _ = jssm.mamba_dims(jcfg)
    T = 150 if path == "apply" else 1    # apply walks two scan pieces
    x = rng.standard_normal((K, 2, T, jcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x)
    if path == "apply":
        want = jax.vmap(lambda p, a: jssm.mamba_apply(p, a, jcfg))(jb, x)
        close(tssm.mamba_apply(tb, xt, tcfg), want)
        return
    st = _state(rng, 2, d_inner, jcfg)
    want, wc = jax.vmap(lambda p, a, c: jssm.mamba_decode(p, a, c, jcfg))(
        jb, x, st)
    cache = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    close(tssm.mamba_decode(tb, xt, cache, tcfg), want)
    close(cache["conv"], wc["conv"])
    close(cache["ssm"], wc["ssm"])


@pytest.mark.parametrize("n_tok", [(5, 0), (8, 3)])
def test_mamba_prefill_matches(models, n_tok):
    """A chunk of 8 with per-row valid counts (the JAX package prefills
    one row at a time); n_tok == 0 leaves the row's state bit for bit."""
    jcfg, tcfg, _, _ = models
    jb, tb = block(models, 2, "mamba")
    rng = np.random.default_rng(1)
    d_inner, _ = jssm.mamba_dims(jcfg)
    x = rng.standard_normal((K, 2, 8, jcfg.d_model)).astype(np.float32)
    st = _state(rng, 2, d_inner, jcfg)
    n = np.asarray(n_tok, np.int32)

    def one_row(p, a, c, m):
        cr = jax.tree.map(lambda y: y[None], c)
        y, c2 = jssm.mamba_prefill(p, a[None], cr, m, jcfg)
        return y[0], jax.tree.map(lambda y: y[0], c2)

    want, wc = jax.vmap(jax.vmap(one_row, in_axes=(None, 0, 0, 0)),
                        in_axes=(0, 0, 0, None))(jb, x, st, n)
    cache = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got = tssm.mamba_prefill(tb, torch.from_numpy(x), cache,
                             torch.from_numpy(n), tcfg)
    valid = np.arange(8)[None, :] < n[:, None]
    close(got[:, torch.from_numpy(valid)], np.asarray(want)[:, valid])
    close(cache["conv"], wc["conv"])
    close(cache["ssm"], wc["ssm"])
    for b in np.flatnonzero(n == 0):
        for k in st:
            np.testing.assert_array_equal(cache[k][:, b].numpy(), st[k][:, b])


def _moe_params(cfg, ffn, seed):
    """A MoE layer's params for each member from the JAX init, both
    packages."""
    jp = jax.vmap(lambda k: jmoe.moe_init(k, cfg.d_model, ffn, jnp.float32))(
        jax.random.split(jax.random.PRNGKey(seed), K))
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("case", ["jamba", "overflow", "shared_dense_res"])
def test_moe_matches(models, case):
    """Two token pools per member, each routed with its own capacity.
    `overflow` biases the router (a constant input feature that only
    expert 0 reads) so that nearly every token picks expert 0: 100
    tokens, 200 assignments, capacity 64, and expert 0 drops what
    arrives past its 64th slot in each pool.  `shared_dense_res` adds
    deepseek-v2's shared experts and arctic's dense residual FFN."""
    jcfg, _, _, _ = models
    f = jcfg.ffn
    T = 12
    if case == "jamba":
        jp, tp = block(models, 1, "moe")
    else:
        if case == "shared_dense_res":
            f = f.__class__(d_ff=256, mlp_type="swiglu", n_experts=4,
                            top_k=2, moe_d_ff=64, n_shared=2,
                            dense_residual_ff=96)
        else:
            T = 100
        jp, tp = _moe_params(jcfg, f, 5)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((K, 2, T, jcfg.d_model)).astype(np.float32)
    if case == "overflow":
        x[..., 0] = 4.0
        jp["router"] = jp["router"].at[:, 0, 0].set(1.0)
        tp["router"] = torch.from_numpy(np.array(jp["router"]))
    want, waux = jax.vmap(jax.vmap(
        lambda p, a: jmoe.moe_apply(p, a[None], f), in_axes=(None, 0)))(
        jp, x)
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), f)
    close(got, np.asarray(want)[:, :, 0])
    close(aux, waux)
    if case == "overflow":
        _, ids, _ = tmoe._route(tp["router"], torch.from_numpy(x), 2)
        C = max(int(T * 2 * f.capacity_factor / 4), min(T * 2, 64))
        assert C == 64
        assert bool(((ids == 0).sum((2, 3)) > C).all())  # every pool drops


def test_apply_matches(models):
    jcfg, tcfg, jp, tp = models
    tok = np.random.default_rng(1).integers(0, 512, (2, 40)).astype(np.int32)
    want, waux = jax.jit(jax.vmap(
        lambda p: jtf.apply(p, jcfg, tokens=tok, remat=False)))(jp)
    got, aux = ttf.apply(tp, tcfg, torch.from_numpy(tok))
    close(got, want)
    assert aux.shape == (K,)
    close(aux, waux)


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_and_decode_match(models, paged):
    _run_both(models, 40, paged=paged)


@pytest.mark.parametrize("paged,chunk", [(True, 4), (False, 4), (True, 0),
                                         (False, 0)])
def test_generate_matches_jax_engine(models, jax_engines, paged, chunk):
    _, tcfg, _, tp = models
    kw = dict(n_slots=4, max_prompt=16, max_out=12, page_size=4,
              paged=paged, prefill_chunk=chunk)
    jeng = jax_engines(**kw)
    eng = EnsembleEngine(tcfg, tp, device="cpu", **kw)
    # the second batch reuses each engine's recycled pool
    for ps, n in ((prompts(1, (5, 13, 16)), 10), (prompts(5, (16, 3)), 12)):
        for w, g in zip(jeng.generate(ps, n), eng.generate(ps, n)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("paged", [True, False])
def test_frozen_mid_prompt_slot_keeps_its_state(models, jax_engines, paged):
    """Admit two prompts (into slots 0 and 1 of the generate test's
    4-slot engines, every slot released first); prefill slot 0 to
    completion and slot 1 by one chunk; decode twice while slot 1 is
    mid-prompt (frozen); finish slot 1's prefill; decode on.  Slot 1's
    conv and ssm planes must come through the two decode steps
    unchanged, so both slots' tokens equal the JAX engine's."""
    _, tcfg, _, tp = models
    kw = dict(n_slots=4, max_prompt=16, max_out=12, page_size=4,
              paged=paged, prefill_chunk=4)
    ps = prompts(7, (6, 15))
    outs = []
    for eng in (jax_engines(**kw),
                EnsembleEngine(tcfg, tp, device="cpu", **kw)):
        eng.update_slots(release=range(kw["n_slots"]),
                         admits=[(i, p, 9) for i, p in enumerate(ps)])
        for _ in range(2):
            eng.prefill(0)
        eng.prefill(1)
        if isinstance(eng, EnsembleEngine):
            frozen = [(n, x[:, :, 1].clone())
                      for n, x in tkv._leaves(eng.cache["segments"])
                      if n in ("conv", "ssm")]
        for _ in range(2):
            eng.step()
        if isinstance(eng, EnsembleEngine):
            for (n, x0), (_, x) in zip(
                    frozen, [(n, x) for n, x in
                             tkv._leaves(eng.cache["segments"])
                             if n in ("conv", "ssm")]):
                assert torch.equal(x[:, :, 1], x0), n
        for _ in range(3):
            eng.prefill(1)
        for _ in range(8):
            eng.step()
        st = jax.device_get(eng.state) if isinstance(eng, JaxEngine) \
            else eng.state
        outs.append((np.asarray(st.out)[:2], np.asarray(st.n_gen)[:2]))
    np.testing.assert_array_equal(outs[1][1], [9, 9])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][0], outs[0][0])


def test_reset_slots_zeroes_mamba_planes(models):
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu", n_slots=3, max_prompt=16,
                         max_out=8, prefill_chunk=4, paged=True, page_size=4)
    eng.generate(prompts(2, (7, 11, 4)), 4)
    planes = [(n, x) for n, x in tkv._leaves(eng.cache["segments"])
              if n in ("conv", "ssm")]
    assert len(planes) == 14
    before = [x.clone() for _, x in planes]
    assert all(x[:, :, 1].abs().sum() > 0 for x in before)
    tkv.reset_slots(eng.cache, torch.tensor([False, True, False]))
    for (name, x), x0 in zip(planes, before):
        assert not x[:, :, 1].any(), name
        assert torch.equal(x[:, :, [0, 2]], x0[:, :, [0, 2]]), name


def test_bridge_carries_the_jamba_tree():
    """bf16 matrices and (E, d, ff) expert leaves beside the f32 router,
    Mamba's f32 A_log, D and dt bias, name for name, value for value."""
    cfg = jreg.get_config(ARCH, reduced=True)
    assert cfg.dtype == "bfloat16"
    jp = jax.device_get(jax.vmap(lambda k: jtf.init(k, cfg))(
        jax.random.split(jax.random.PRNGKey(3), 2)))
    tp = params_from_numpy(jp, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda a: isinstance(a, torch.Tensor))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    kinds = set()
    for (path, j), (_, t) in zip(jl, tl):
        assert str(j.dtype) == str(t.dtype).split(".")[-1], path
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(j, np.float32), err_msg=str(path))
        kinds.add((jax.tree_util.keystr(path[-1:]), str(j.dtype)))
    moe = tp["segments"][0]["slot_1"]["moe"]
    f = cfg.ffn
    assert moe["experts_gate"].shape == (2, 1, f.n_experts, cfg.d_model,
                                         f.expert_ff)
    assert moe["experts_down"].shape == (2, 1, f.n_experts, f.expert_ff,
                                         cfg.d_model)
    for leaf, dt in (("router", "float32"), ("experts_up", "bfloat16"),
                     ("mamba_A_log", "float32"), ("mamba_D", "float32"),
                     ("mamba_dt_b", "float32"), ("mamba_in", "bfloat16")):
        assert (f"['{leaf}']", dt) in kinds, leaf


def test_torch_init_has_the_jax_tree(models):
    _, tcfg, jp, _ = models
    check_init_has_the_jax_tree(tcfg, jp)
