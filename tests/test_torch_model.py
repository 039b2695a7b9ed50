"""The port's model code against repro.models at reduced gemma3-1b, f32.

The same weights (JAX-initialized, bridged name for name) and the same
numpy tokens go through both packages.  Logits must agree to
atol=rtol=1e-4: seven layers of f32 matmuls summed in another order.
Both cache layouts are covered: ring + paged (max_seq > local_window:
the local layers keep per-slot rings, the global layer pages) and all
paged (local_window >= max_seq).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serving import kv_cache as jkv
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv

TOL = dict(atol=1e-4, rtol=1e-4)
K = 2


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    tcfg = treg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_configs_match_jax_package():
    for arch in ("gemma3-1b", "deepseek-7b", "rwkv6-7b", "jamba-v0.1-52b"):
        for reduced in (False, True):
            j = jreg.get_config(arch, reduced=reduced)
            t = treg.get_config(arch, reduced=reduced)
            assert repr(j) == repr(t)
            assert repr(j.segments()) == repr(t.segments())
    for arch in ("deepseek-v2-236b", "whisper-tiny"):
        with pytest.raises(NotImplementedError, match="not ported"):
            treg.get_config(arch)


@pytest.mark.parametrize("layer", ["rmsnorm", "rope", "mlp", "embed",
                                   "logits"])
def test_layers_match(models, layer):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((K, 2, 5, jcfg.d_model)).astype(np.float32)
    blk_j = jax.tree.map(lambda a: a[:, 0], jp["segments"][0]["slot_0"])
    blk_t = jax.tree.map(lambda a: a[:, 0], tp["segments"][0]["slot_0"],
                         is_leaf=lambda a: isinstance(a, torch.Tensor))
    xt = torch.from_numpy(x)
    if layer == "rmsnorm":
        want = jax.vmap(lambda p, a: jlayers.rmsnorm(p, a))(
            blk_j["norm_mix"], x)
        got = tlayers.rmsnorm(blk_t["norm_mix"], xt)
    elif layer == "rope":
        h = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
        pos = rng.integers(0, 200, (2, 5)).astype(np.int32)
        want = jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e4)
        got = tlayers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                                 1e4)
    elif layer == "mlp":
        want = jax.vmap(lambda p, a: jlayers.mlp_apply(p, a, "geglu"))(
            blk_j["mlp"], x)
        got = tlayers.mlp_apply(blk_t["mlp"], xt, "geglu")
    elif layer == "embed":
        tok = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
        want = jax.vmap(lambda p: jlayers.embed_lookup(p, tok, jcfg))(
            {"embed": jp["embed"]})
        got = tlayers.embed_lookup({"embed": tp["embed"]},
                                   torch.from_numpy(tok), tcfg)
    else:
        want = jax.vmap(lambda p, a: jlayers.lm_logits(p, a, jcfg))(
            {"embed": jp["embed"]}, x)
        got = tlayers.lm_logits({"embed": tp["embed"]}, xt, tcfg)
    close(got, want)


def test_apply_matches(models):
    jcfg, tcfg, jp, tp = models
    tok = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    want = jax.jit(jax.vmap(
        lambda p: jtf.apply(p, jcfg, tokens=tok, remat=False)[0]))(jp)
    got, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok))
    close(got, want)


@pytest.mark.parametrize("window,causal", [(0, True), (5, True),
                                           (0, False)])
def test_attend_chunked_matches(window, causal):
    """The online-softmax chunk loop (what long sequences take) against
    the JAX package's, with chunks small enough to take many steps."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 19, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 19, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 19, 2, 16)).astype(np.float32)
    pos = np.arange(19)
    want = jattn._attend_chunked(q, k, v, pos, pos, window, causal, 0.25,
                                 chunk=4)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = tattn._attend_chunked(*t, torch.from_numpy(pos),
                                torch.from_numpy(pos), window, causal, 0.25,
                                chunk=4)
    close(got, want)
    dense = tattn.attend(*t, torch.from_numpy(pos), torch.from_numpy(pos),
                         window=window, causal=causal, scale=0.25)
    close(got, dense.numpy())


def _run_both(models, max_seq, paged, tol=TOL):
    """Prefill two slots in chunks, then decode past the local window
    (the rings wrap), asserting every call's logits agree to `tol`."""
    jcfg, tcfg, jp, tp = models
    K = tp["embed"].shape[0]
    B, page, C = 2, 4, 8
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (B, 40)).astype(np.int32)
    kw = dict(page_size=page, n_pages=B * -(-max_seq // page)) if paged \
        else {}
    jc = jax.vmap(lambda _: jtf.init_slot_cache(jcfg, B, max_seq, **kw))(
        jnp.arange(K))
    tc = ttf.init_slot_cache(tcfg, B, max_seq, members=K, device="cpu", **kw)
    if paged:
        P = -(-max_seq // page)
        perm = rng.permutation(kw["n_pages"]).reshape(B, P).astype(np.int32)
        if P > 5:
            perm[1, -2:] = kw["n_pages"]  # unallocated tail: writes drop
        jc["page_table"] = jnp.broadcast_to(perm, (K, B, P))
        tc["page_table"] = torch.from_numpy(perm).expand(K, B, P) \
            .contiguous()
    pre = jtf.prefill_step_paged if paged else jtf.prefill_slots
    dec = jtf.decode_step_paged if paged else jtf.decode_step_slots
    jpre = jax.jit(jax.vmap(lambda p, c, t, n: pre(p, jcfg, c, t, n),
                            in_axes=(0, 0, None, None)))
    jdec = jax.jit(jax.vmap(lambda p, c, t: dec(p, jcfg, c, t),
                            in_axes=(0, 0, None)))
    tpre = ttf.prefill_step_paged if paged else ttf.prefill_slots
    tdec = ttf.decode_step_paged if paged else ttf.decode_step_slots
    plen = (11, 6)
    for b in range(B):
        for start in range(0, plen[b], C):
            n = min(C, plen[b] - start)
            ch = np.zeros((1, C), np.int32)
            ch[0, :n] = toks[b, start:start + n]
            nj = jnp.int32(n) if paged else jnp.asarray([n], jnp.int32)
            jl, jrow = jpre(jp, jkv.slot_row(jc, b), ch, nj)
            jc = jkv.write_slot_row(jc, jrow, b)
            tl, trow = tpre(tp, tcfg, tkv.slot_row(tc, b),
                            torch.from_numpy(ch),
                            torch.tensor([n], dtype=torch.int32))
            tkv.write_slot_row(tc, trow, b)
            close(tl, jl.reshape(K, 1, -1), tol)
    # rows sit at different positions from here on
    for step in range(7):
        tk = toks[:, 20 + step:21 + step]
        jl, jc = jdec(jp, jc, tk)
        tl, tc = tdec(tp, tcfg, tc, torch.from_numpy(tk))
        close(tl, jl, tol)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))


@pytest.mark.parametrize("layout,max_seq", [("ring+paged", 40),
                                            ("all-paged", 16)])
def test_paged_prefill_and_decode_match(models, layout, max_seq):
    if layout == "all-paged":
        assert models[1].local_window >= max_seq
    else:
        assert models[1].local_window < max_seq
    _run_both(models, max_seq, paged=True)


def test_contiguous_prefill_and_decode_match(models):
    _run_both(models, 40, paged=False)


def test_decode_without_page_table_is_rejected(models):
    _, tcfg, _, tp = models
    tc = ttf.init_slot_cache(tcfg, 2, 8, members=K, device="cpu")
    with pytest.raises(ValueError, match="paged cache"):
        ttf.decode_step_paged(tp, tcfg, tc, torch.zeros(2, 1, dtype=torch.long))
