"""Tests of the PyTorch port that need the card (marker `cuda`).

The hand-written CUDA kernels (paged attention; flash attention; the
fused distillation loss, forward and backward; the rwkv6 wkv
recurrence, chunked and single-step; Mamba's selective scan, short-T
and long-T) against their plain PyTorch versions in every option, their
input checks, and the engine and the trainer on the card against the
CPU.  Each test skips where there is no CUDA device.
No JAX import, so the file runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels import distill_loss as dl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as ssk
from repro_torch.kernels import wkv6 as wk
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import EnsembleEngine

pytestmark = pytest.mark.cuda

# f32 2e-5, bf16 2e-2: the JAX package's kernel-test tolerances (the
# kernel sums an online softmax page by page, the plain version at once)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

CASES = {  # name: (q dtype, page dtype, Hkv, dk, dv, dr, window)
    "f32": (torch.float32, torch.float32, 1, 32, 32, 0, 0),
    "bf16": (torch.bfloat16, torch.bfloat16, 1, 32, 32, 0, 0),
    "gqa_hkv2": (torch.float32, torch.float32, 2, 32, 32, 0, 0),
    "window": (torch.float32, torch.float32, 1, 32, 32, 0, 5),
    "dk_ne_dv": (torch.float32, torch.float32, 1, 48, 24, 0, 0),
    "int8_scaled": (torch.float32, torch.int8, 1, 32, 32, 0, 0),
    "fp8_scaled": (torch.float32, torch.float8_e4m3fn, 2, 32, 32, 0, 0),
    "k_extra": (torch.float32, torch.float32, 1, 32, 32, 16, 0),
    "int8_odd_rows": (torch.float32, torch.int8, 1, 40, 40, 8, 7),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_case(name, dev, seed=0, B=6, H=4, page=4, P=6):
    qdt, kvdt, Hkv, dk, dv, dr, window = CASES[name]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lens = torch.randint(1, P * page + 1, (B,), generator=g, device=dev)
    lens[0], lens[1] = 1, P * page
    live = ((lens + page - 1) // page).tolist()
    n_pages = sum(live) + 3
    perm = torch.randperm(n_pages, generator=g, device=dev).int()
    table = torch.full((B, P), n_pages, dtype=torch.int32, device=dev)
    table[:, -1] = n_pages + 3
    at = 0
    for b, n in enumerate(live):
        table[b, :n] = perm[at:at + n]
        at += n

    def rnd(*shape, dtype):
        x = torch.randn(*shape, generator=g, device=dev)
        if dtype == torch.int8:
            return (x * 40).round().clamp(-127, 127).to(torch.int8)
        return x.to(dtype)

    c = dict(q=rnd(B, H, dk + dr, dtype=qdt),
             k_pages=rnd(n_pages, page, Hkv, dk, dtype=kvdt),
             v_pages=rnd(n_pages, page, Hkv, dv, dtype=kvdt),
             table=table, lens=lens.int(), window=window)
    if kvdt in (torch.int8, torch.float8_e4m3fn):
        c["k_scale"] = torch.rand(n_pages, page, Hkv, generator=g,
                                  device=dev) * 0.05
        c["v_scale"] = torch.rand(n_pages, page, Hkv, generator=g,
                                  device=dev) * 0.05
    if dr:
        c["k_extra"] = rnd(n_pages, page, Hkv, dr, dtype=qdt)
    return c


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_version(cuda, name):
    c = make_case(name, cuda)
    before = pa.paged_attention.launches
    got = pa.paged_attention(**c)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = ref.paged_attention(**c)
    tol = TOL[c["q"].dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_jamba_attention_shape(cuda, dtype):
    """H 32 over Hkv 8 (g = 4) with dh 128, no rope: jamba's attention
    layer at full width."""
    c = make_case("f32", cuda, seed=3, B=4, H=32, page=16, P=5)
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    n_pages = c["k_pages"].shape[0]
    c["q"] = torch.randn(4, 32, 128, generator=g, device=cuda).to(dtype)
    c["k_pages"], c["v_pages"] = (
        torch.randn(n_pages, 16, 8, 128, generator=g, device=cuda).to(dtype)
        for _ in range(2))
    got = pa.paged_attention(**c)
    torch.cuda.synchronize()
    want = ref.paged_attention(**c)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_kernel_checks_its_inputs(cuda):
    c = make_case("f32", cuda)
    for bad, match in ((dict(table=c["table"].long()), "table dtype"),
                       (dict(lens=c["lens"][:-1]), "lens has shape"),
                       (dict(q=c["q"].transpose(0, 1).contiguous()
                             .transpose(0, 1)), "contiguous"),
                       (dict(q=c["q"][..., :-1].contiguous()), "features")):
        with pytest.raises(ValueError, match=match):
            pa.paged_attention(**dict(c, **bad))


def _n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("splits", ["several", "one"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_kernel_matches_plain_version(cuda, name, splits):
    """Every variant with the rows' pages split over several blocks (6
    rows of 6 pages: one block per page, so the row of length 1 has
    five splits with no page) and with one block per row (enough rows
    to fill two waves of the card, 24 pages of 4: three 32-token tiles
    a row through the double buffer); the combine runs only when
    split."""
    Hkv = CASES[name][2]
    B, P = (6, 6) if splits == "several" else \
        (-(-pa.WAVES * _n_sm(cuda) // Hkv), 24)
    assert (pa.n_splits(B, Hkv, P, _n_sm(cuda)) > 1) == (splits == "several")
    c = make_case(name, cuda, seed=5, B=B, P=P)
    before = (pa.paged_attention.launches, pa.paged_attention.combine_launches)
    got = pa.paged_attention(**c)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before[0] + 1
    assert pa.paged_attention.combine_launches == \
        before[1] + (splits == "several")
    want = ref.paged_attention(**c)
    tol = TOL[c["q"].dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("window", [6, 10, 23])
def test_split_kernel_window_across_split_boundaries(cuda, window):
    """Windows whose first live page falls inside a split's range, rows
    of every length 1 .. P*page (bf16, page 4, P 6)."""
    c = make_case("bf16", cuda, seed=6, B=24)
    c["lens"] = torch.arange(1, 25, dtype=torch.int32, device=cuda)
    c["window"] = window
    got = pa.paged_attention(**c)
    torch.cuda.synchronize()
    want = ref.paged_attention(**c)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_split_kernel_at_decode_shapes(cuda):
    """gemma3-1b's decode (16 rows, Hkv 1, dh 256: many splits) and
    deepseek-7b's (16 rows, Hkv 32, dh 128: one split), bf16, page 16,
    lens up to P * page."""
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    for H, Hkv, d, P in ((4, 1, 256, 36), (32, 32, 128, 34)):
        B, page = 16, 16
        lens = torch.randint(1, P * page + 1, (B,), generator=g, device=cuda)
        lens[0], lens[1] = 1, P * page
        n_pages = B * P
        table = torch.randperm(n_pages, generator=g, device=cuda).int() \
            .reshape(B, P)
        q = torch.randn(B, H, d, generator=g, device=cuda).bfloat16()
        kp, vp = (torch.randn(n_pages, page, Hkv, d, generator=g,
                              device=cuda).bfloat16() for _ in range(2))
        got = pa.paged_attention(q, kp, vp, table, lens.int())
        torch.cuda.synchronize()
        want = ref.paged_attention(q, kp, vp, table, lens.int())
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def test_attention_wrappers_make_no_device_to_host_copy(cuda):
    """The split counts come from shapes alone: under sync debug mode
    "error" a call that synchronised with the host would raise."""
    c = make_case("bf16", cuda, seed=8)
    kw, _ = flash_case("prefill_ring", 64, torch.bfloat16, cuda)
    pa.paged_attention(**c)                 # load the libraries first
    fa.flash_attention(**kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pa.paged_attention(**c)
        fa.flash_attention(**kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# (N, T, S, H, Hkv, causal, window, positions): top-left masks with
# ragged tiles (T, S not multiples of 64), T != S without causality, and
# the prefill's position form (FAR slots, a ragged chunk tail)
FLASH_CASES = {
    "causal": (2, 70, 70, 4, 2, True, 0, False),
    "window": (1, 130, 130, 4, 1, True, 13, False),
    "cross": (2, 33, 150, 4, 4, False, 0, False),
    "prefill_ring": (2, 24, 40, 4, 1, True, 16, True),
    "prefill_paged": (3, 16, 80, 2, 2, True, 0, True),
    "prefill_jamba_gqa": (2, 24, 72, 32, 8, True, 0, True),  # g = 4
}


def flash_case(name, dh, dtype, dev, seed=0):
    """Inputs of a FLASH_CASES entry; -> (kwargs, rows that have at least
    one valid key (the plain version's uniform average elsewhere is not
    part of the contract))."""
    N, T, S, H, Hkv, causal, window, positions = FLASH_CASES[name]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, k, v = (torch.randn(N, n, h, dh, generator=g, device=dev).to(dtype)
               for n, h in ((T, H), (S, Hkv), (S, Hkv)))
    kw = dict(q=q, k=k, v=v, causal=causal, window=window)
    valid = torch.ones(N, T, dtype=torch.bool, device=dev)
    if positions:
        # S - T cache slots then the chunk; a chunk at row-dependent idx,
        # cache slots past idx and the chunk's padded tail are FAR
        idx = torch.tensor([S - T - 5 * i for i in range(N)], device=dev)
        n_tok = torch.tensor([T - 3 * i for i in range(N)], device=dev)
        t = torch.arange(T, device=dev)
        q_pos = idx[:, None] + t
        slots = torch.arange(S - T, device=dev).expand(N, -1)
        c_pos = torch.where(t < n_tok[:, None], q_pos, -10 ** 9)
        k_pos = torch.cat([torch.where(slots < idx[:, None], slots,
                                       -10 ** 9), c_pos], 1)
        kw.update(q_pos=q_pos.int(), k_pos=k_pos.int())
        # the last row of the last chunk has no valid key at all
        kw["k_pos"][-1] = -10 ** 9
        valid[-1] = False
    return kw, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain_version(cuda, name, dh, dtype):
    kw, valid = flash_case(name, dh, dtype, cuda)
    before = fa.flash_attention.launches
    got = fa.flash_attention(**kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    want = ref.attention(**kw)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float()[valid], want.float()[valid],
                               atol=tol, rtol=tol)


def test_flash_kernel_checks_its_inputs(cuda):
    kw, _ = flash_case("prefill_ring", 64, torch.float32, cuda)
    for bad, match in ((dict(k=kw["k"].bfloat16()), "k dtype"),
                       (dict(q_pos=kw["q_pos"].long()), "q_pos dtype"),
                       (dict(k_pos=None), "both"),
                       (dict(v=kw["v"][:, :-1]), "v has shape"),
                       (dict(q=kw["q"][..., :48].contiguous(),
                             k=kw["k"][..., :48].contiguous(),
                             v=kw["v"][..., :48].contiguous()), "head dim"),
                       (dict(q=kw["q"].transpose(1, 2).contiguous()
                             .transpose(1, 2)), "contiguous"),
                       (dict(q=kw["q"].cpu()), "CUDA tensors")):
        with pytest.raises(ValueError, match=match):
            fa.flash_attention(**dict(kw, **bad))


def ring_chunk_case(dh, dtype, dev, seed=0):
    """A 37-token chunk over a 512-slot ring with window 512, as the
    gemma3 local layers' prefill builds it (models/attention
    `_chunk_pos`, `_cache_entry_pos`): rows at wrapped idx (non-monotone
    key positions), a ragged tail, and a last row whose keys are all
    empty (no valid key: only finite).  -> (kwargs, valid rows)."""
    from repro_torch.models import attention as attn
    N, C, S0, H, Hkv, window = 4, 37, 512, 4, 1, 512
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    idx = torch.tensor([0, 300, 700, 1500], device=dev)
    n_tok = torch.tensor([37, 30, 37, 5], device=dev)
    q_pos, c_pos = attn._chunk_pos(idx, n_tok, C)
    k_pos = torch.cat([attn._cache_entry_pos(S0, idx, window), c_pos], 1)
    k_pos[-1] = -10 ** 9
    S = S0 + C
    q, k, v = (torch.randn(N, n, h, dh, generator=g, device=dev).to(dtype)
               for n, h in ((C, H), (S, Hkv), (S, Hkv)))
    kw = dict(q=q, k=k, v=v, causal=True, window=window,
              q_pos=q_pos.int().contiguous(), k_pos=k_pos.int().contiguous())
    valid = ref.attention_mask(N, C, S, True, window, kw["q_pos"],
                               kw["k_pos"]).any(-1)
    assert not valid[-1].any() and valid[:-1].any()
    return kw, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64, 128, 256])
def test_flash_kernel_on_a_wrapped_ring(cuda, dh, dtype):
    kw, valid = ring_chunk_case(dh, dtype, cuda)
    got = fa.flash_attention(**kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = ref.attention(**kw)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float()[valid], want.float()[valid],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_tiles_match_python(cuda, dtype, dh):
    """The wrapper's tile sizes (used by the split rule and the skip
    predicate's twin) are the library's."""
    lib = fa._library()
    assert lib.flash_attention_key_tile(dh, fa._CODES[dtype]) == \
        fa.tiles(dh, dtype)[1]


@pytest.mark.parametrize("T,S,H,Hkv", [(130, 130, 4, 1), (2048, 2048, 4, 1),
                                       (128, 704, 4, 1)])
def test_flash_kernel_split_and_skip_counts(cuda, T, S, H, Hkv):
    """bf16 at dh 256: the combine runs exactly when the rule splits, and
    the result holds on every row with a valid key."""
    g = torch.Generator(device=cuda)
    g.manual_seed(9)
    q, k, v = (torch.randn(1, n, h, 256, generator=g, device=cuda).bfloat16()
               for n, h in ((T, H), (S, Hkv), (S, Hkv)))
    kw = dict(causal=True, window=512 if S > 1000 else 0)
    if T != S:
        kw["q_pos"] = (torch.arange(T, device=cuda) + 300)[None].int()
        kp = torch.arange(S, device=cuda)
        kp = torch.where(kp < 300, kp, -10 ** 9)
        kp[S - T:] = kw["q_pos"][0]
        kw["k_pos"] = kp[None].int().contiguous()
    split = fa.n_splits(1, T, H, Hkv, S, fa.tiles(256, torch.bfloat16)[1],
                        _n_sm(cuda))
    before = fa.flash_attention.combine_launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.combine_launches == before + (split > 1)
    want = ref.attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_engine_on_card_matches_cpu(cuda):
    cfg = registry.get_config("gemma3-1b", reduced=True).with_(
        dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 11, 16)]
    outs = []
    for dev in (cuda, "cpu"):
        eng = EnsembleEngine(cfg, params, n_slots=3, max_prompt=16,
                             max_out=12, paged=True, page_size=4,
                             device=dev)
        outs.append(eng.generate(prompts, 10))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# (N, V, logits dtype, pseudo dtype, padded labels): the NiN main path's
# shape, a multi-tile bf16 vocab, odd widths (element-wise loads), pads
DISTILL_CASES = {
    "nin_f32": (256, 100, torch.float32, torch.float32, False),
    "vocab_bf16": (64, 8192, torch.bfloat16, torch.float32, False),
    "bf16_pseudo": (32, 1000, torch.float32, torch.bfloat16, False),
    "f32_pad": (48, 2048, torch.float32, torch.float32, True),
    "odd_v": (33, 517, torch.float32, torch.float32, True),
    "odd_v_bf16": (17, 301, torch.bfloat16, torch.bfloat16, False),
}
# loss rtol 1e-5 for both logits types (both sides read the same values
# and sum in f32).  dz is held at its own scale, N * dz / g, whose
# entries are O(1): (atol, rtol, relative L1) f32 at the JAX package's
# kernel-test tolerance; bf16 one rounding of the output (2^-7 relative)
LOSS_RTOL = 1e-5
DZ_TOL = {torch.float32: (2e-5, 2e-5, 2e-5),
          torch.bfloat16: (1e-5, 8e-3, 8e-3)}


def distill_case(name, dev, seed=0):
    """Pseudo-labels peaked where the logits are large (a softmax of 2z
    plus noise), so that <p, z> is of the size of the loss."""
    N, V, zdt, pdt, pad = DISTILL_CASES[name]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    z = (torch.randn(N, V, generator=g, device=dev) * 3).to(zdt)
    y = torch.randint(0, V, (N,), generator=g, device=dev,
                      dtype=torch.int32)
    if pad:
        y[::5] = -1
    p = torch.softmax(2 * z.float() + torch.randn(N, V, generator=g,
                                                  device=dev), -1)
    lam = torch.tensor(0.4, device=dev)
    return z, y, p.to(pdt), lam


def assert_dz_close(dz, dz_ref, g):
    """Element by element and in relative L1 (which sees the many small
    softmax entries), at the scale N * dz / g."""
    atol, rtol, l1 = DZ_TOL[dz.dtype]
    a, b = (t.float() * (t.shape[0] / g) for t in (dz, dz_ref))
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
    assert (a - b).abs().sum() <= l1 * b.abs().sum()


@pytest.mark.parametrize("name", sorted(DISTILL_CASES))
def test_distill_kernels_match_plain_version(cuda, name):
    z, y, p, lam = distill_case(name, cuda)
    f0, b0 = dl.distill_loss_fwd.launches, dl.distill_loss_bwd.launches
    zk = z.clone().requires_grad_()
    got = dl.fused_distill_loss(zk, y, p, lam)
    got.backward(torch.tensor(1.7, device=cuda))
    torch.cuda.synchronize()
    assert (dl.distill_loss_fwd.launches, dl.distill_loss_bwd.launches) \
        == (f0 + 1, b0 + 1)
    zr = z.clone().requires_grad_()
    want = ref.distill_loss(zr, y, p, lam)
    want.backward(torch.tensor(1.7, device=cuda))
    torch.testing.assert_close(got, want, rtol=LOSS_RTOL, atol=0)
    assert zk.grad.dtype == z.dtype
    assert_dz_close(zk.grad, zr.grad, 1.7)
    parts = dl.distill_loss_fwd(z, y, p)
    for a, b in zip(parts, ref.distill_loss_parts(z, y, p)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=LOSS_RTOL)


def test_distill_kernels_check_their_inputs(cuda):
    z, y, p, lam = distill_case("nin_f32", cuda)
    for kw, match in ((dict(labels=y.long()), "labels dtype"),
                      (dict(pseudo=p[:-1]), "pseudo has shape"),
                      (dict(logits=z.t().contiguous().t()), "contiguous"),
                      (dict(logits=z.half()), "logits dtype"),
                      (dict(pseudo=p.cpu()), "pseudo is on"),
                      (dict(logits=z[None]), "want logits")):
        args = dict(logits=z, labels=y, pseudo=p)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            dl.distill_loss_fwd(**args)
    lse, _, _ = dl.distill_loss_fwd(z, y, p)
    g = torch.tensor(1.0, device=cuda)
    with pytest.raises(ValueError, match="lam is on"):
        dl.distill_loss_bwd(z, y, p, lse, g, lam.cpu())
    with pytest.raises(ValueError, match="g has shape"):
        dl.distill_loss_bwd(z, y, p, lse, g[None], lam)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dl.distill_loss_fwd(z.cpu(), y.cpu(), p.cpu())
    with pytest.raises(ValueError, match="lam is on"):
        dl.fused_distill_loss(z, y, p, lam.cpu())


# wkv6: atol 5e-4, rtol 1e-3, tests/test_kernels.py's for the Pallas
# kernel against its sequential oracle
WKV_TOL = dict(atol=5e-4, rtol=1e-3)


def wkv_case(dev, K, B, T, H, dh, seed=0, count=3):
    """Strong and weak decays, a distinct u per member, and the state as
    a layer's view of a (K, count, B + 1, H, dh, dh) pool narrowed to B
    slots (strided, updated in place).  -> (r, k, v, log_w, u, pool,
    state view)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    N = K * B
    r, k, v = f(N, T, H, dh), f(N, T, H, dh), f(N, T, H, dh)
    log_w = -torch.exp(f(N, T, H, dh).clamp(-3, 2))
    u = f(K, H, dh) * 0.3
    pool = f(K, count, B + 1, H, dh, dh) * 0.1
    return r, k, v, log_w, u, pool, pool[:, 1].narrow(1, 1, B)


@pytest.mark.parametrize("T", [1, 37, 128])
@pytest.mark.parametrize("dh", [8, 32, 64, 100, 128])
def test_wkv6_kernel_matches_plain_version(cuda, dh, T):
    K, B, H = 4, 2, 3
    r, k, v, log_w, u, pool, state = wkv_case(cuda, K, B, T, H, dh)
    before = pool.clone()
    want_y, want_s = ref.wkv6(r, k, v, log_w, u,
                              state.reshape(K * B, H, dh, dh))
    n0 = wk.wkv6.launches
    y = wk.wkv6(r, k, v, log_w, u, state)
    torch.cuda.synchronize()
    assert wk.wkv6.launches == n0 + 1
    torch.testing.assert_close(y, want_y, **WKV_TOL)
    torch.testing.assert_close(state.reshape(K * B, H, dh, dh), want_s,
                               **WKV_TOL)
    # nothing outside the state view moved
    pool[:, 1, 1:B + 1] = before[:, 1, 1:B + 1]
    assert torch.equal(pool, before)


def strong_decay(log_w, seed=1):
    """log_w as the models clamp it, -exp(clip(x, -20, 4)), x drawn wide
    enough that some tokens decay by e^-54.6."""
    g = torch.Generator(device=log_w.device)
    g.manual_seed(seed)
    x = 3 * torch.randn(log_w.shape, generator=g, device=log_w.device)
    return -torch.exp(x.clamp(-20, 4))


def check_wkv6(cuda, K, B, T, H, dh, seed=0, n_valid=None, strong=True):
    """One kernel call on a strided state view against ref.wkv6; nothing
    outside the view moves.  -> the launch's plan."""
    r, k, v, log_w, u, pool, state = wkv_case(cuda, K, B, T, H, dh, seed)
    if strong:
        log_w = strong_decay(log_w, seed + 1)
    if n_valid is not None:   # masked as rwkv_prefill masks them
        valid = (torch.arange(T, device=cuda) < n_valid)[None, :, None, None]
        k = torch.where(valid, k, 0.0)
        log_w = torch.where(valid, log_w, 0.0)
    before = pool.clone()
    s0 = state.reshape(K * B, H, dh, dh).clone()
    want_y, want_s = ref.wkv6(r, k, v, log_w, u, s0)
    n0 = wk.wkv6.launches
    y = wk.wkv6(r, k, v, log_w, u, state)
    torch.cuda.synchronize()
    assert wk.wkv6.launches == n0 + 1
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, want_y, **WKV_TOL)
    torch.testing.assert_close(state.reshape(K * B, H, dh, dh), want_s,
                               **WKV_TOL)
    if n_valid is not None:
        _, s_valid = ref.wkv6(r[:, :n_valid], k[:, :n_valid],
                              v[:, :n_valid], log_w[:, :n_valid], u, s0)
        torch.testing.assert_close(state.reshape(K * B, H, dh, dh), s_valid,
                                   **WKV_TOL)
    pool[:, 1, 1:B + 1] = before[:, 1, 1:B + 1]
    assert torch.equal(pool, before)
    return wk.plan()


@pytest.mark.parametrize("T", [1, 16, 17, 37, 128, 300])
@pytest.mark.parametrize("dh", [8, 32, 64, 100, 128])
def test_wkv6_kernel_with_strong_decay(cuda, dh, T):
    """Decays down to -e^4 a token, where a separable factorisation of
    the chunk's decays would overflow; the step path at T = 1, the
    chunked path (16-token chunks, a ragged last one) above."""
    p = check_wkv6(cuda, 2, 2, T, 3, dh)
    assert p["path"] == ("step" if T == 1 else "chunked")
    if T > 1:
        assert p["chunk"] == wk.CHUNK
        assert p["blocks"] == 2 * 2 * 3 * -(-dh // p["col_tile"])


def test_wkv6_kernel_masked_tail(cuda):
    """A prefill chunk's ragged tail: y at every position, and s_T the
    state after the valid tokens alone."""
    check_wkv6(cuda, 4, 1, 128, 4, 64, n_valid=44)


@pytest.mark.parametrize("T", [1, 37])
@pytest.mark.parametrize("dh", [7, 30, 101])
def test_wkv6_kernel_four_byte_path(cuda, dh, T):
    """dh not a multiple of 4: both paths' 4-byte variants, in each dh
    bucket."""
    p = check_wkv6(cuda, 2, 2, T, 3, dh)
    assert not p["vec16"]


@pytest.mark.parametrize("T", [1, 37])
def test_wkv6_kernel_state_in_place_or_not(cuda, T):
    """s0 aliasing s_T (the wrapper's in-place update) and separate s0
    and s_T buffers give the same y and s_T, and s0 is left as it was in
    the second."""
    K, B, H, dh = 2, 2, 3, 64
    r, k, v, log_w, u, pool, state = wkv_case(cuda, K, B, T, H, dh)
    log_w = strong_decay(log_w)
    s0 = state.clone()
    y_in = wk.wkv6(r, k, v, log_w, u, state)
    s_out = torch.full_like(s0, float("nan"))
    s0_copy = s0.clone()
    y = torch.empty_like(r)
    lib = wk._library()
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), s0.data_ptr(), s_out.data_ptr(), y.data_ptr(), K, B,
        T, H, dh, *s0.stride()[:2], *s_out.stride()[:2], None,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(y, y_in)
    assert torch.equal(s_out, state)
    assert torch.equal(s0, s0_copy)


def test_wkv6_kernel_checks_its_inputs(cuda):
    r, k, v, log_w, u, pool, state = wkv_case(cuda, 2, 2, 5, 2, 16)
    args = dict(r=r, k=k, v=v, log_w=log_w, u=u, state=state)
    for bad, match in ((dict(k=k.double()), "k dtype"),
                       (dict(u=u[:1]), "state folds|u has shape"),
                       (dict(v=v[:, :-1]), "v has shape"),
                       (dict(r=r.transpose(2, 3).contiguous()
                             .transpose(2, 3)), "contiguous"),
                       (dict(state=state.transpose(3, 4)), "contiguous"),
                       (dict(state=pool[:, 0, :1].expand(2, 2, 2, 16, 16)),
                        "overlap"),
                       (dict(r=r.cpu()), "CUDA tensors"),
                       (dict(log_w=log_w.cpu()), "log_w is on")):
        with pytest.raises(ValueError, match=match):
            wk.wkv6(**dict(args, **bad))
    wide = torch.zeros(2, 1, 2, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wk.wkv6(wide, wide, wide, wide, torch.zeros(2, 2, 160, device=cuda),
                torch.zeros(2, 1, 2, 160, 160, device=cuda))


def test_rwkv_engine_on_card_matches_cpu(cuda):
    cfg = registry.get_config("rwkv6-7b", reduced=True).with_(
        dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 11, 16)]
    outs = []
    for dev in (cuda, "cpu"):
        eng = EnsembleEngine(cfg, params, n_slots=3, max_prompt=16,
                             max_out=12, paged=True, page_size=4,
                             prefill_chunk=4, device=dev)
        outs.append(eng.generate(prompts, 10))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ssm_scan: atol = rtol = 1e-5, tests/test_kernels.py's for the Pallas
# kernel against its sequential oracle
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)


def scan_case(dev, K, B, T, D, Ns, seed=0, count=3):
    """a = exp(-|x|), small b, and the state as a layer's view of a (K,
    count, B + 1, D, Ns) pool narrowed to B slots (strided, updated in
    place).  -> (a, b, pool, state view)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    N = K * B
    a = torch.exp(-f(N, T, D, Ns).abs())
    b = f(N, T, D, Ns) * 0.2
    pool = f(K, count, B + 1, D, Ns) * 0.1
    return a, b, pool, pool[:, 1].narrow(1, 1, B)


@pytest.mark.parametrize("T", [1, 37, 128])
@pytest.mark.parametrize("D,Ns", [(64, 16), (100, 16), (37, 3)])
def test_ssm_scan_kernel_matches_plain_version(cuda, D, Ns, T):
    """(64, 16): whole 256-thread blocks of 16-byte vectors; (100, 16):
    a ragged last block; (37, 3): the scalar variant (D * Ns is odd)."""
    K, B = 2, 3
    a, b, pool, state = scan_case(cuda, K, B, T, D, Ns)
    before = pool.clone()
    want_hs, want_h = ref.ssm_scan(a, b, state.reshape(K * B, D, Ns))
    n0 = ssk.ssm_scan.launches
    hs = ssk.ssm_scan(a, b, state)
    torch.cuda.synchronize()
    assert ssk.ssm_scan.launches == n0 + 1
    torch.testing.assert_close(hs, want_hs, **SCAN_TOL)
    torch.testing.assert_close(state.reshape(K * B, D, Ns), want_h,
                               **SCAN_TOL)
    # nothing outside the state view moved
    pool[:, 1, 1:B + 1] = before[:, 1, 1:B + 1]
    assert torch.equal(pool, before)


@pytest.mark.parametrize("T", [1, 2, 7, 8, 15, 16])
@pytest.mark.parametrize("D,Ns", [(64, 16), (37, 3)])
def test_ssm_scan_small_t_variant_beside_the_long_one(cuda, D, Ns, T):
    """T below 8 takes the small-T variant, T from 8 the long-T kernel;
    either matches the plain version, and T one-step launches (the
    small-T variant) give bit for bit the hs and h_T of one launch over
    the T steps."""
    K, B = 2, 3
    a, b, pool, state = scan_case(cuda, K, B, T, D, Ns, seed=T)
    before = pool.clone()
    h0 = state.clone()
    want_hs, want_h = ref.ssm_scan(a, b, state.reshape(K * B, D, Ns))
    hs = ssk.ssm_scan(a, b, state)
    torch.cuda.synchronize()
    assert ssk.plan()["small_t"] == (T < 8)
    torch.testing.assert_close(hs, want_hs, **SCAN_TOL)
    torch.testing.assert_close(state.reshape(K * B, D, Ns), want_h,
                               **SCAN_TOL)
    h_T = state.clone()
    pool[:, 1, 1:B + 1] = before[:, 1, 1:B + 1]
    assert torch.equal(pool, before)
    steps = []
    for t in range(T):
        steps.append(ssk.ssm_scan(a[:, t:t + 1].contiguous(),
                                  b[:, t:t + 1].contiguous(), h0))
        assert ssk.plan()["small_t"]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(steps, 1), hs)
    assert torch.equal(h0, h_T)


def test_ssm_scan_kernel_checks_its_inputs(cuda):
    a, b, pool, state = scan_case(cuda, 2, 2, 5, 8, 8)
    args = dict(a=a, b=b, state=state)
    for bad, match in ((dict(b=b.double()), "b dtype"),
                       (dict(b=b[:, :-1]), "b has shape"),
                       (dict(state=pool[:, 1, :1]), "state folds"),
                       (dict(a=a.transpose(2, 3).contiguous()
                             .transpose(2, 3)), "contiguous"),
                       (dict(state=state.transpose(2, 3)), "contiguous"),
                       (dict(state=pool[:, 0, :1].expand(2, 2, 8, 8)),
                        "overlap"),
                       (dict(a=a.cpu()), "CUDA tensors"),
                       (dict(b=b.cpu()), "b is on")):
        with pytest.raises(ValueError, match=match):
            ssk.ssm_scan(**dict(args, **bad))


def test_jamba_engine_on_card_matches_cpu(cuda):
    cfg = registry.get_config("jamba-v0.1-52b", reduced=True).with_(
        dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (3, 11, 16)]
    outs = []
    for dev in (cuda, "cpu"):
        eng = EnsembleEngine(cfg, params, n_slots=3, max_prompt=16,
                             max_out=12, paged=True, page_size=4,
                             prefill_chunk=4, device=dev)
        outs.append(eng.generate(prompts, 10))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
