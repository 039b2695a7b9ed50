"""The port's deepseek-7b (llama-architecture dense MHA: swiglu, untied
head, full attention in every layer) against repro at its reduced
config, f32, K=4 members, weights bridged from the JAX init.

Logits of `apply` and of paged and contiguous prefill plus decode must
agree to atol=rtol=1e-4 (three layers of f32 matmuls summed in another
order, as tests/test_torch_model.py), and greedy `generate` must give
the JAX engine's tokens (paged, chunked prefill).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import EnsembleEngine
from test_torch_engine import check_init_has_the_jax_tree
from test_torch_model import _run_both

TOL = dict(atol=1e-4, rtol=1e-4)
K = 4


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    tcfg = treg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_reduced_config_is_the_architecture(models):
    _, tcfg, _, tp = models
    assert tcfg.ffn.mlp_type == "swiglu" and not tcfg.tie_embeddings
    assert tcfg.attn.n_heads == tcfg.attn.n_kv_heads
    assert "head" in tp and "w_gate" in tp["segments"][0]["slot_0"]["mlp"]
    # every layer is full attention, so under paging every layer pages
    assert all(ttf.layer_pages(tcfg, s, 40) for s in tcfg.layer_specs())


@pytest.mark.parametrize("layer", ["swiglu", "untied_head"])
def test_layers_match(models, layer):
    jcfg, tcfg, jp, tp = models
    x = np.random.default_rng(0).standard_normal(
        (K, 2, 5, jcfg.d_model)).astype(np.float32)
    if layer == "swiglu":
        mlp_j = jax.tree.map(lambda a: a[:, 0],
                             jp["segments"][0]["slot_0"]["mlp"])
        mlp_t = {k: v[:, 0] for k, v in
                 tp["segments"][0]["slot_0"]["mlp"].items()}
        want = jax.vmap(lambda p, a: jlayers.mlp_apply(p, a, "swiglu"))(
            mlp_j, x)
        got = tlayers.mlp_apply(mlp_t, torch.from_numpy(x), "swiglu")
    else:
        sub = ("embed", "head")
        want = jax.vmap(lambda p, a: jlayers.lm_logits(p, a, jcfg))(
            {k: jp[k] for k in sub}, x)
        got = tlayers.lm_logits({k: tp[k] for k in sub},
                                torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_matches(models):
    jcfg, tcfg, jp, tp = models
    tok = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    want = jax.jit(jax.vmap(
        lambda p: jtf.apply(p, jcfg, tokens=tok, remat=False)[0]))(jp)
    got, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_and_decode_match(models, paged):
    _run_both(models, 40, paged=paged)


def test_generate_matches_jax_engine(models):
    jcfg, tcfg, jp, tp = models
    kw = dict(n_slots=4, max_prompt=16, max_out=12, page_size=4, paged=True,
              prefill_chunk=8)
    jeng = JaxEngine(jcfg, jp, **kw)
    eng = EnsembleEngine(tcfg, tp, device="cpu", **kw)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 16)]
    for w, g in zip(jeng.generate(prompts, 10), eng.generate(prompts, 10)):
        np.testing.assert_array_equal(g, w)


def test_torch_init_has_the_jax_tree(models):
    _, tcfg, jp, _ = models
    check_init_has_the_jax_tree(tcfg, jp)
