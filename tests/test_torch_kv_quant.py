"""The port's quantized KV pages against repro's, at reduced configs, f32.

kv_quantize / kv_dequantize are the JAX package's bit for bit (int8 and
fp8, the all-zero vector and the absmax element, whose v / scale may
land a hair above 448 and must round to 448, not to NaN).  int8 / fp8
pools have repro's layout: one-byte planes with f32 `*_scale_pages`
sidecars per token and kv head (MLA: one latent scale, rope keys in the
model's dtype), rings untouched, page_bytes the quantized bytes; "f32"
gives the default pool.  Greedy tokens of the int8 paged engine equal
repro's int8 engine (weights bridged from the JAX init) on reduced
deepseek-7b, gemma3-1b and deepseek-v2, and the port's int8 / fp8
engines keep tests/test_kv_quant.py's agreement bounds against the
port's f32 contiguous engine.  Copy-on-write over int8 pages moves
planes and scales together: a warm prefix-cache engine gives the cold
one's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import kv_cache as jkv
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import EnsembleEngine

ARCHS = ("deepseek-7b", "gemma3-1b", "deepseek-v2-236b")
KW = dict(n_slots=4, max_prompt=12, max_out=8, prefill_chunk=4)
PAGED = dict(paged=True, page_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jreg.get_config(arch, reduced=True).with_(dtype="float32"),
            treg.get_config(arch, reduced=True).with_(dtype="float32"))


@pytest.fixture(scope="module")
def models():
    """{arch: (jcfg, tcfg, JAX params, the port's copy)}, K = 2."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
            jax.random.split(jax.random.PRNGKey(0), 2))
        out[arch] = (jcfg, tcfg, jp, params_from_numpy(jax.device_get(jp),
                                                       "cpu"))
    return out


def _prompts(vocab):
    return [np.arange(1, 12) % vocab, np.arange(2, 5), np.arange(3, 10),
            np.arange(1, 7)]


# -- kv_quantize: bit for bit ------------------------------------------------


def _vectors():
    rng = np.random.default_rng(0)
    v = (rng.normal(size=(64, 4, 32)) * 3.0).astype(np.float32)
    v[0] = 0.0                                       # all-zero vectors
    v[1, 0, 5] = 1e-20                               # a tiny absmax
    v[2, :, 7] = 1e4                                 # a dominant element
    return v


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_kv_quantize_bit_for_bit(kv_dtype):
    v = _vectors()
    jq, js = jattn.kv_quantize(jnp.asarray(v),
                               jattn.kv_storage_dtype(kv_dtype, jnp.float32))
    tq, ts = tattn.kv_quantize(torch.from_numpy(v),
                               tattn.kv_storage_dtype(kv_dtype,
                                                      torch.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jbytes = np.asarray(jq).view(np.uint8)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), jbytes)
    # all-zero vectors: zeros with scale 0, dequantized exactly
    assert (ts[0] == 0).all() and (tq[0].float() == 0).all()
    np.testing.assert_array_equal(
        tattn.kv_dequantize(tq, ts).numpy(),
        np.asarray(jattn.kv_dequantize(jq, js)))
    np.testing.assert_array_equal(tattn.kv_dequantize(tq, ts)[0].numpy(), 0)


def test_fp8_absmax_element_rounds_to_448():
    """v / (absmax / 448) at the absmax element can exceed 448 by an ulp;
    both packages' fp8 casts must give 448 there, never NaN."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(4096, 16)).astype(np.float32)
    idx = np.abs(v).argmax(-1)
    over = (np.abs(v).max(-1) / (np.abs(v).max(-1) / np.float32(448)))
    assert (over > 448).any()     # the case is in the data
    fp8 = tattn.kv_storage_dtype("fp8", torch.float32)
    tq, _ = tattn.kv_quantize(torch.from_numpy(v), fp8)
    jq, _ = jattn.kv_quantize(jnp.asarray(v), jattn.fp8_dtype())
    top_t = tq.float().numpy()[np.arange(len(v)), idx]
    top_j = np.asarray(jq.astype(jnp.float32))[np.arange(len(v)), idx]
    np.testing.assert_array_equal(np.abs(top_t), 448.0)
    np.testing.assert_array_equal(top_t, top_j)
    assert torch.isfinite(tq.float()).all()


def test_int8_roundtrip_within_half_a_step():
    v = torch.from_numpy(_vectors()[3:])
    q, s = tattn.kv_quantize(v, torch.int8)
    assert q.dtype == torch.int8 and s.shape == v.shape[:-1]
    err = (tattn.kv_dequantize(q, s) - v).abs()
    assert (err <= s[..., None] * 0.5 + 1e-6 * v.abs()).all()


# -- pool layout -------------------------------------------------------------


def _names(pool):
    out = {}
    for name, x in tkv._leaves(pool["segments"]):
        out.setdefault(name, []).append(x)
    return out


@pytest.mark.parametrize("arch,max_seq", [("deepseek-7b", 16),
                                          ("gemma3-1b", 32),
                                          ("deepseek-v2-236b", 16)])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp8"])
def test_pool_layout_matches_repro(arch, max_seq, kv_dtype):
    """Leaf names, shapes and storage dtypes of the port's pool equal
    repro's (gemma3's max_seq above its reduced window 16: the local
    layers keep rings, unquantized; MLA's rope keys stay native)."""
    jcfg, tcfg = _cfgs(arch)
    kw = dict(page_size=4, n_pages=8, kv_dtype=kv_dtype)
    jp = jkv.init_pool(jcfg, 2, 2, max_seq, **kw)
    tp = tkv.init_pool(tcfg, 2, 2, max_seq, device="cpu", **kw)
    want = {}

    def visit(path, x):
        name = next((str(e.key) for e in reversed(path)
                     if isinstance(e, jax.tree_util.DictKey)), "")
        want.setdefault(name, []).append(x)

    jax.tree_util.tree_map_with_path(visit, jp["segments"])
    got = _names(tp)
    assert set(got) == set(want)
    for name in want:
        for j, t in zip(want[name], got[name]):
            assert tuple(t.shape) == j.shape, name
            assert t.element_size() == j.dtype.itemsize, name
            assert str(t.dtype).split(".")[-1] == str(j.dtype), name
    quant = kv_dtype in ("int8", "fp8")
    assert quant == any(n.endswith("_scale_pages") for n in got)
    if arch == "gemma3-1b":
        assert all(x.dtype == torch.float32 for x in got["k"] + got["v"])
    if arch == "deepseek-v2-236b" and quant:
        assert all(x.dtype == torch.float32 for x in got["k_r_pages"])
        assert "k_r_scale_pages" not in got
    assert tkv.page_bytes(tp, 8) == jkv.page_bytes(jp, 8)


def test_f32_pool_is_the_default():
    _, tcfg = _cfgs("gemma3-1b")
    kw = dict(page_size=4, n_pages=8, device="cpu")
    base = tkv.init_pool(tcfg, 2, 2, 32, **kw)
    same = tkv.init_pool(tcfg, 2, 2, 32, kv_dtype="f32", **kw)
    a, b = list(tkv._leaves(base)), list(tkv._leaves(same))
    assert [n for n, _ in a] == [n for n, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype


def test_page_bytes_and_stats():
    """int8 at dh 256 over one kv head would be 256 + 4 bytes a token a
    plane against bf16's 512; here (dh 32): 32 + 4 against 64."""
    _, tcfg = _cfgs("gemma3-1b")
    cfg = tcfg.with_(local_window=512)       # every layer pages
    params = ttf.init(cfg, seed=0, device="cpu", members=2)
    pb = {}
    for d in ("f32", "bf16", "int8", "fp8"):
        eng = EnsembleEngine(cfg, params, device="cpu", kv_dtype=d,
                             **KW, **PAGED)
        ps = eng.page_stats()
        assert ps["kv_dtype"] == d and ps["kv_quantized"] == int(
            d in ("int8", "fp8"))
        assert ps["bytes_per_token"] == ps["page_bytes"] // ps["page_size"]
        pb[d] = ps["bytes_per_token"]
    per_layer_plane = 2 * cfg.n_layers * 2        # K = 2, k and v planes
    assert pb["bf16"] == pb["f32"] // 2 == per_layer_plane * 32 * 2
    assert pb["int8"] == pb["fp8"] == per_layer_plane * (32 + 4)


def test_contiguous_pool_refuses_quantized_pages(models):
    jcfg, tcfg, jp, tp = models["deepseek-7b"]
    with pytest.raises(ValueError) as want:
        JaxEngine(jcfg, jp, kv_dtype="int8", **KW)
    with pytest.raises(ValueError) as got:
        EnsembleEngine(tcfg, tp, device="cpu", kv_dtype="int8", **KW)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="kv_dtype"):
        EnsembleEngine(tcfg, tp, device="cpu", kv_dtype="int4",
                       **dict(KW, **PAGED))


# -- engines -----------------------------------------------------------------


def _count_paged(monkeypatch):
    calls = []
    real = ops.paged_attention

    def shim(q, k_pages, v_pages, table, lens, **kw):
        calls.append((k_pages.dtype, kw.get("k_scale") is not None,
                      kw.get("v_scale") is not None))
        return real(q, k_pages, v_pages, table, lens, **kw)

    monkeypatch.setattr(ops, "paged_attention", shim)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_tokens_match_repro(models, arch, monkeypatch):
    """The port's int8 paged engine gives repro's int8 engine's greedy
    tokens, and decode hands the kernel int8 pages with their scales."""
    jcfg, tcfg, jp, tp = models[arch]
    prompts = _prompts(tcfg.vocab_size)
    want = JaxEngine(jcfg, jp, kv_dtype="int8", **KW, **PAGED).generate(
        prompts, max_new=8)
    calls = _count_paged(monkeypatch)
    got = EnsembleEngine(tcfg, tp, device="cpu", kv_dtype="int8",
                         **KW, **PAGED).generate(prompts, max_new=8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert calls and all(c == (torch.int8, True, True) for c in calls)


@pytest.fixture(scope="module")
def contiguous_f32(models):
    """The port's f32 contiguous tokens per arch: the quality reference."""
    return {arch: EnsembleEngine(m[1], m[3], device="cpu", **KW).generate(
        _prompts(m[1].vocab_size), max_new=8) for arch, m in models.items()}


@pytest.mark.parametrize("arch,kv_dtype,bound", [
    ("deepseek-7b", "int8", 0.75), ("gemma3-1b", "int8", 0.75),
    ("deepseek-v2-236b", "int8", 0.75), ("deepseek-7b", "fp8", 0.5)])
def test_quantized_agreement_bounds(models, contiguous_f32, arch, kv_dtype,
                                    bound):
    """tests/test_kv_quant.py's bounds: random tiny members sit near
    argmax ties, so quantized pages move some tokens."""
    _, tcfg, _, tp = models[arch]
    got = EnsembleEngine(tcfg, tp, device="cpu", kv_dtype=kv_dtype,
                         **KW, **PAGED).generate(_prompts(tcfg.vocab_size),
                                                 max_new=8)
    agree = np.mean([np.mean(a == b)
                     for a, b in zip(got, contiguous_f32[arch])])
    assert agree >= bound, f"{arch} {kv_dtype} agreement {agree:.3f}"


def test_prefix_cow_int8_warm_equals_cold(models):
    """A prefix hit reads int8 pages another request wrote; the partial
    page's copy-on-write moves planes and scales together, so the warm
    engine gives the cold one's tokens, and the source survives."""
    _, tcfg, _, tp = models["deepseek-7b"]
    kw = dict(n_slots=3, max_prompt=24, max_out=6, prefill_chunk=4,
              paged=True, page_size=4, kv_dtype="int8", seed=0,
              device="cpu")
    shared = list(range(100, 118))
    p1 = np.array(shared + [7, 8], np.int32)
    p2 = np.array(shared + [9, 10, 11], np.int32)   # diverges mid-page
    cold = EnsembleEngine(tcfg, tp, **kw).generate([p1, p2], 5)
    warm = EnsembleEngine(tcfg, tp, prefix_cache=True, **kw)
    np.testing.assert_array_equal(cold[0], warm.generate([p1], 5)[0])
    np.testing.assert_array_equal(cold[1], warm.generate([p2], 5)[0])
    ps = warm.page_stats()
    assert ps["prefix_hits"] >= 1 and ps["cow_pages"] >= 1
    np.testing.assert_array_equal(cold[0], warm.generate([p1], 5)[0])


def test_copy_pages_moves_scales_with_planes():
    _, tcfg = _cfgs("deepseek-7b")
    for kv_dtype in ("int8", "fp8"):
        pool = tkv.init_pool(tcfg, 2, 2, 16, page_size=4, n_pages=6,
                             device="cpu", kv_dtype=kv_dtype)
        for _, x in tkv._leaves(pool["segments"]):
            x.view(torch.uint8).copy_(torch.randint(
                0, 120, x.view(torch.uint8).shape, dtype=torch.uint8))
        before = {id(x): x.clone() for _, x in tkv._leaves(pool["segments"])}
        tkv.copy_pages(pool, np.array([1, 6]), np.array([4, 6]), 6)
        for name, x in tkv._leaves(pool["segments"]):
            b = before[id(x)].view(torch.uint8)
            xb = x.view(torch.uint8)
            assert torch.equal(xb[:, :, 4], b[:, :, 1]), name
            keep = [i for i in range(6) if i != 4]
            assert torch.equal(xb[:, :, keep], b[:, :, keep]), name
