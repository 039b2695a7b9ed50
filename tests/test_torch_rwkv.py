"""The port's rwkv6-7b (rwkv6 time-mix with data-dependent decay, rwkv
channel-mix, no attention) against repro at its reduced config, f32,
K=4 members, weights bridged from the JAX init.

Logits of `apply` and of paged and contiguous prefill plus decode must
agree to atol 2e-4, rtol 1e-4 (tests/test_serving.py's tolerance for
rwkv: the JAX side runs the chunked wkv form, the port's plain path the
sequential recurrence).  Greedy `generate` must give the JAX engine's
tokens, and so must an interleaving of prefill and decode calls that
leaves a mid-prompt slot frozen across decode steps: its recurrent state
must not move.  `reset_slots` zeroes a recycled slot's recurrent planes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.common.types import AttnConfig, LayerSpec
from repro_torch.configs import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import EnsembleEngine
from test_torch_engine import check_init_has_the_jax_tree
from test_torch_model import _run_both

TOL = dict(atol=2e-4, rtol=1e-4)
K = 4
RECURRENT = ("shift", "wkv", "cmix_shift")


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config("rwkv6-7b", reduced=True).with_(dtype="float32")
    tcfg = treg.get_config("rwkv6-7b", reduced=True).with_(dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def test_reduced_config_is_the_architecture(models):
    _, tcfg, _, tp = models
    assert {s.mixer for s in tcfg.layer_specs()} == {"rwkv"}
    assert {s.ffn for s in tcfg.layer_specs()} == {"rwkv_cmix"}
    assert not any(ttf.layer_pages(tcfg, s, 40) for s in tcfg.layer_specs())
    blk = tp["segments"][0]["slot_0"]
    assert set(blk) == {"norm_mix", "rwkv", "norm_ffn", "cmix"}
    # a paged pool of rwkv pages nothing: only the page table is added
    pool = tkv.init_pool(tcfg, K, 2, 16, page_size=4, n_pages=8,
                         device="cpu")
    assert "page_table" in pool and tkv.page_bytes(pool, 8) == 0
    assert set(pool["segments"][0]["slot_0"]) == set(RECURRENT)


@pytest.mark.parametrize("layer", ["rwkv", "cmix"])
def test_layers_match(models, layer):
    """One layer of each kind on the same (K, B, T, d) input."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((K, 2, 37, jcfg.d_model)).astype(np.float32)
    prev = rng.standard_normal(x.shape).astype(np.float32)
    blk_j = jax.tree.map(lambda a: a[:, 0], jp["segments"][0]["slot_0"])
    blk_t = {k: v[:, 0] for k, v in
             tp["segments"][0]["slot_0"][layer].items()}
    if layer == "rwkv":
        want = jax.vmap(lambda p, a: jssm.rwkv_apply(p, a, jcfg))(
            blk_j["rwkv"], x)
        got = tssm.rwkv_apply(blk_t, torch.from_numpy(x), tcfg)
    else:
        want = jax.vmap(jssm.cmix_apply)(blk_j["cmix"], x, prev)
        got = tssm.cmix_apply(blk_t, torch.from_numpy(x),
                              torch.from_numpy(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_matches(models):
    jcfg, tcfg, jp, tp = models
    tok = np.random.default_rng(1).integers(0, 512, (2, 40)).astype(np.int32)
    want = jax.jit(jax.vmap(
        lambda p: jtf.apply(p, jcfg, tokens=tok, remat=False)[0]))(jp)
    got, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_and_decode_match(models, paged):
    _run_both(models, 40, paged=paged, tol=TOL)


@pytest.mark.parametrize("paged,chunk", [(True, 4), (False, 4), (True, 0),
                                         (False, 0)])
def test_generate_matches_jax_engine(models, paged, chunk):
    jcfg, tcfg, jp, tp = models
    kw = dict(n_slots=4, max_prompt=16, max_out=12, page_size=4,
              paged=paged, prefill_chunk=chunk)
    jeng = JaxEngine(jcfg, jp, **kw)
    eng = EnsembleEngine(tcfg, tp, device="cpu", **kw)
    # the second batch reuses each engine's recycled pool
    for ps, n in ((prompts(1, (5, 13, 16)), 10), (prompts(5, (16, 3)), 12)):
        for w, g in zip(jeng.generate(ps, n), eng.generate(ps, n)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("paged", [True, False])
def test_frozen_mid_prompt_slot_keeps_its_state(models, paged):
    """Admit two prompts; prefill slot 0 to completion and slot 1 by one
    chunk; decode twice while slot 1 is mid-prompt (frozen); finish slot
    1's prefill; decode on.  Slot 1's recurrent state must come through
    the two decode steps unchanged, so both slots' tokens equal the JAX
    engine's."""
    jcfg, tcfg, jp, tp = models
    kw = dict(n_slots=2, max_prompt=16, max_out=12, page_size=4,
              paged=paged, prefill_chunk=4)
    ps = prompts(7, (6, 15))
    outs = []
    for eng in (JaxEngine(jcfg, jp, **kw),
                EnsembleEngine(tcfg, tp, device="cpu", **kw)):
        eng.update_slots(admits=[(i, p, 9) for i, p in enumerate(ps)])
        for _ in range(2):
            eng.prefill(0)
        eng.prefill(1)
        for _ in range(2):
            eng.step()
        for _ in range(3):
            eng.prefill(1)
        for _ in range(8):
            eng.step()
        st = jax.device_get(eng.state) if isinstance(eng, JaxEngine) \
            else eng.state
        outs.append((np.asarray(st.out), np.asarray(st.n_gen)))
    np.testing.assert_array_equal(outs[1][1], [9, 9])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][0], outs[0][0])


def test_reset_slots_zeroes_recurrent_planes(models):
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu", n_slots=3, max_prompt=16,
                         max_out=8, prefill_chunk=4)
    eng.generate(prompts(2, (7, 11, 4)), 4)
    planes = tkv._leaves(eng.cache["segments"])
    before = [(n, x.clone()) for n, x in planes]
    assert {n for n, _ in before} == set(RECURRENT)
    assert all(x[:, :, 1].abs().sum() > 0 for _, x in before)
    tkv.reset_slots(eng.cache, torch.tensor([False, True, False]))
    for (name, x), (_, x0) in zip(tkv._leaves(eng.cache["segments"]),
                                  before):
        assert not x[:, :, 1].any(), name
        assert torch.equal(x[:, :, [0, 2]], x0[:, :, [0, 2]]), name
    np.testing.assert_array_equal(eng.cache["idx"][:, 1].numpy(), 0)


def test_bridge_carries_the_rwkv_tree():
    """bf16 matrices beside f32 leaves ((K, count, 5, d) mixes, (K,
    count, H, dh) bonus), name for name, value for value."""
    cfg = jreg.get_config("rwkv6-7b", reduced=True)
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
    H, dh = jssm.rwkv_dims(cfg)
    rwkv = tp["segments"][0]["slot_0"]["rwkv"]
    assert rwkv["rwkv_mix_base"].shape == (2, cfg.n_layers, 5, cfg.d_model)
    assert rwkv["rwkv_first"].shape == (2, cfg.n_layers, H, dh)
    assert ("['rwkv_first']", "float32") in kinds
    assert ("['rwkv_r']", "bfloat16") in kinds


def test_torch_init_has_the_jax_tree(models):
    _, tcfg, jp, _ = models
    check_init_has_the_jax_tree(tcfg, jp)


@pytest.mark.parametrize("layer", ["mla_attention", "enc_dec"])
def test_jamba_layers_are_still_refused(models, layer):
    """What the port still refuses, at rwkv's reduced widths: MLA
    attention (deepseek-v2-236b's) and an encoder-decoder (whisper-tiny's)."""
    cfg = models[1]
    if layer == "mla_attention":
        cfg = cfg.with_(attn=AttnConfig(kind="mla", n_heads=4, n_kv_heads=4,
                                        head_dim=32),
                        pattern=(LayerSpec("attn", "dense"),))
    else:
        cfg = cfg.with_(enc_dec=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        ttf.init(cfg, device="cpu")
