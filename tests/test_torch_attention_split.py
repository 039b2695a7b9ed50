"""The logic of the split paged-attention kernel and of the flash
kernel's tile skipping, held on the CPU through their plain twins.

- The split rule (`paged_attention.n_splits`, `flash_attention.n_splits`)
  reads only shapes, and the blocks an SM holds (`blocks_per_sm`); the
  head-group rule (`paged_attention.plan`, over `smem_bytes`, the twin
  of the kernel's shared-memory layout) keeps one group at every shape
  the kernel ran before and takes several at deepseek-v2's absorbed MLA
  decode, small enough for two blocks an SM; the page division
  (`ref.paged_split_pages`) puts every live page of every row in
  exactly one split, for windows and for lens of 1 and of P * page.
- The two-pass twin of the split kernel (`ref.paged_attention_split`:
  partials per split, then the combine) equals JAX
  `repro.kernels.paged_attention` (the Pallas kernel in interpret mode)
  at f32 within 2e-5, for split counts from 1 to P and past it (splits
  with no live page), with int8 scales, `k_extra` and dk != dv.
- The skip predicate's twin (`ref.flash_tile_live`) never drops a valid
  (query, key) pair, on positions built by the port's own prefill
  helpers and on random ones; `ref.attention_tiles` (skipped tiles
  masked out) equals `ref.attention` on every row with a valid key.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jax_kernel
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.models import attention as attn

# ---------------------------------------------------------------------------
# paged attention: the split rule, the page division, the two-pass twin
# ---------------------------------------------------------------------------

PAGE, P = 4, 6


@pytest.mark.parametrize("rows,Hkv,P_,n_sm", [
    (16, 1, 36, 132), (16, 32, 34, 132), (8, 8, 34, 132), (1, 1, 1, 132),
    (6, 2, 6, 8), (300, 1, 40, 132), (0, 4, 6, 132)])
def test_split_rule_reads_only_shapes(rows, Hkv, P_, n_sm):
    ns = pa.n_splits(rows, Hkv, P_, n_sm)
    assert 1 <= ns <= max(P_, 1)
    pairs = max(rows * Hkv, 1)
    if ns < P_:       # not capped by the table: about WAVES blocks an SM
        assert pairs * ns >= pa.WAVES * n_sm
        assert ns == 1 or pairs * (ns - 1) < pa.WAVES * n_sm


# the head-group rule: a block holds gh of a kv head's g query heads,
# all g where they fit, else the largest divisor of g at which WAVES
# blocks share an SM

# phase 1's shapes before the MLA cases: (H, Hkv, dk, dv, dr, page, P,
# page bytes, q bytes): gemma3-1b's decode in bf16, f32, window, dk 192
# / dv 128, int8, fp8, k_extra and 40-byte rows; deepseek-7b's; jamba's
PHASE1 = [(4, 1, 256, 256, 0, 16, 36, 2, 2), (4, 1, 256, 256, 0, 16, 36, 4, 4),
          (4, 1, 192, 128, 0, 16, 36, 4, 4), (4, 1, 256, 256, 0, 16, 36, 1, 4),
          (4, 1, 256, 256, 64, 16, 36, 4, 4), (4, 1, 40, 40, 0, 16, 36, 1, 4),
          (32, 32, 128, 128, 0, 16, 34, 2, 2),
          (32, 8, 128, 128, 0, 16, 34, 2, 2)]
# deepseek-v2's absorbed decode: 128 heads over the latent, r 512 + rope
# 64, P 34 (544 tokens at page 16)
MLA = (128, 1, 512, 512, 64, 16, 34)


# layout() of csrc/paged_attention.cu at the MLA shape, region by region
# (16-byte aligned): page ids 144; q 4 gh x 576; acc 4 gh x 512; p 4 gh x
# tokens a stage; m, l and the rescale; then two stages of K, V (none when
# shared), rope keys and two scales.  The card test against the
# library's paged_attention_smem is tests/test_torch_cuda.py's.
MLA_LAYOUT = {
    # 16 heads in bf16: q 36.9 KB + acc 32.8 KB + p 2 KB + two stages of
    # 32 tokens x (512 + 512 + 64) x 2 B, about 212 KB
    (16, 2, 2, False): 144 + 36_864 + 32_768 + 2_048 + 3 * 64
    + 2 * (32_768 + 32_768 + 4_096 + 2 * 128),
    (32, 2, 2, True): 144 + 73_728 + 65_536 + 4_096 + 3 * 128
    + 2 * (32_768 + 4_096 + 2 * 128),
    (32, 1, 4, True): 144 + 73_728 + 65_536 + 2_048 + 3 * 128
    + 2 * (32_768 + 4_096 + 2 * 64),
    (4, 2, 1, False): 144 + 9_216 + 8_192 + 512 + 3 * 16
    + 2 * (16_384 + 16_384 + 2_048 + 2 * 128),
    (3, 1, 4, False): 144 + 6_912 + 6_144 + 192 + 3 * 16
    + 2 * (32_768 + 32_768 + 4_096 + 2 * 64)}


@pytest.mark.parametrize("gh,ppt,kv,share", list(MLA_LAYOUT))
def test_smem_twin_is_the_kernel_layout(gh, ppt, kv, share):
    H, Hkv, dk, dv, dr, page, P_ = MLA
    assert pa.smem_bytes(gh, dk, dv, dr, page, P_, ppt, kv, kv,
                         share) == MLA_LAYOUT[gh, ppt, kv, share]


@pytest.mark.parametrize("shape", PHASE1)
def test_every_earlier_shape_keeps_one_group(shape):
    """Every shape the kernel ran before keeps all g heads in one block
    and the pages a stage the old rule took (TILE_TOKENS / page, halved
    while the layout overflows)."""
    H, Hkv, dk, dv, dr, page, P_, kv, qs = shape
    gh, ppt = pa.plan(H, Hkv, dk, dv, dr, page, P_, kv, qs)
    assert gh == H // Hkv
    old = pa.TILE_TOKENS // page
    while old > 1 and pa.smem_bytes(gh, dk, dv, dr, page, P_, old, kv,
                                    qs) > pa.SMEM_MAX:
        old //= 2
    assert ppt == old


# qwen2-vl-2b's decode: 12 query heads over 2 kv heads at dh 128, P 34
# (544 tokens at page 16), bf16 and f32
QWEN2_VL = [(12, 2, 128, 128, 0, 16, 34, 2, 2),
            (12, 2, 128, 128, 0, 16, 34, 4, 4)]


@pytest.mark.parametrize("shape", QWEN2_VL)
def test_qwen2_vl_shape_keeps_one_group(shape):
    """A group of g = 6 (no power of two) fits one block whole: gh = 6,
    at the most pages a stage, two blocks or more an SM; the split rule
    then fills the SMs from 16 rows x 2 kv heads."""
    H, Hkv, dk, dv, dr, page, P_, kv, qs = shape
    gh, ppt, ns = pa.launch_plan(16, H, Hkv, dk, dv, dr, page, P_, kv, qs,
                                 False, 132)
    assert gh == H // Hkv == 6 and ppt == pa.TILE_TOKENS // page
    smem = pa.smem_bytes(gh, dk, dv, dr, page, P_, ppt, kv, qs)
    assert smem <= pa.SMEM_MAX and pa.blocks_per_sm(smem) >= pa.WAVES
    assert ns == pa.n_splits(16, Hkv, P_, 132) and 16 * Hkv * ns >= 132


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("share", [True, False])
def test_mla_shape_takes_several_groups(size, share):
    """deepseek-v2's absorbed decode cannot hold 128 heads in a block:
    at least two groups, each layout under SMEM_MAX, and the largest gh
    at the most pages a stage that lets WAVES blocks share an SM, where
    one does (bf16; f32 with the plane staged once); else the largest
    gh that fits at the most pages a stage."""
    H, Hkv, dk, dv, dr, page, P_ = MLA
    size_of = lambda gh, ppt: pa.smem_bytes(  # noqa: E731
        gh, dk, dv, dr, page, P_, ppt, size, size, share)
    gh, ppt = pa.plan(H, Hkv, dk, dv, dr, page, P_, size, size, share)
    assert (H // Hkv) % gh == 0 and H // Hkv // gh >= 2
    assert size_of(gh, ppt) <= pa.SMEM_MAX
    shares = pa.blocks_per_sm(size_of(gh, ppt)) >= pa.WAVES
    assert shares == (size == 2 or share)
    if shares:      # twice gh, or twice the pages, leaves a block alone
        assert pa.blocks_per_sm(size_of(2 * gh, ppt)) < pa.WAVES
        if ppt < pa.TILE_TOKENS // page:
            assert all(pa.blocks_per_sm(size_of(d, 2 * ppt)) < pa.WAVES
                       for d in range(1, H // Hkv + 1) if H % d == 0)
    else:
        assert size_of(2 * gh, ppt) > pa.SMEM_MAX
    assert (gh, ppt) == {(2, True): (8, 2), (2, False): (8, 1),
                         (4, True): (8, 1), (4, False): (16, 1)}[size, share]


@pytest.mark.parametrize("smem,per_sm", [
    (1, 227), (34_624, 6), (74_944, 3), (110_320, 2), (115_712, 2),
    (115_713, 1), (218_128, 1), (pa.SMEM_MAX, 1)])
def test_blocks_an_sm_holds(smem, per_sm):
    """An SM's 228 KB of shared memory, less 1 KB the runtime keeps for
    each block, over the block's own."""
    assert pa.blocks_per_sm(smem) == per_sm


@pytest.mark.parametrize("rows,Hkv,P_,n_group,per_sm", [
    (16, 1, 36, 1, 1), (16, 1, 36, 1, 3), (16, 1, 34, 16, 2),
    (16, 1, 34, 4, 1), (300, 1, 40, 1, 1)])
def test_split_rule_counts_blocks_an_sm_holds(rows, Hkv, P_, n_group,
                                              per_sm):
    """Where fewer than WAVES blocks share an SM, n_splits aims at as
    many blocks as do: one wave of them, not WAVES."""
    ns = pa.n_splits(rows, Hkv, P_, 132, n_group, per_sm)
    assert ns == pa.n_splits(rows, Hkv, P_, 132 * min(per_sm, pa.WAVES)
                             // pa.WAVES, n_group)
    pairs = rows * Hkv * n_group
    if 1 < ns < P_:
        assert pairs * (ns - 1) < min(per_sm, pa.WAVES) * 132 <= pairs * ns


@pytest.mark.parametrize("shape", PHASE1)
def test_launch_plan_at_earlier_shapes(shape):
    """launch_plan is plan, then n_splits with the blocks an SM holds at
    that layout: at every bf16 shape phase 1 ran before that is the
    split count it took then (two blocks or more share an SM)."""
    H, Hkv, dk, dv, dr, page, P_, kv, qs = shape
    gh, ppt, ns = pa.launch_plan(16, H, Hkv, dk, dv, dr, page, P_, kv, qs,
                                 False, 132)
    assert (gh, ppt) == pa.plan(H, Hkv, dk, dv, dr, page, P_, kv, qs)
    per_sm = pa.blocks_per_sm(pa.smem_bytes(gh, dk, dv, dr, page, P_, ppt,
                                            kv, qs))
    assert ns == pa.n_splits(16, Hkv, P_, 132, H // Hkv // gh, per_sm)
    if kv == qs == 2:
        assert per_sm >= pa.WAVES and ns == pa.n_splits(16, Hkv, P_, 132)


@pytest.mark.parametrize("rows,Hkv,P_,n_group", [
    (16, 1, 34, 4), (16, 1, 34, 8), (4, 2, 40, 3), (1, 1, 8, 128)])
def test_split_rule_counts_head_groups(rows, Hkv, P_, n_group):
    """n_splits aims at about WAVES blocks an SM over the (row, kv head,
    head group) triples: a group counts as a row would."""
    ns = pa.n_splits(rows, Hkv, P_, 132, n_group)
    assert ns == pa.n_splits(rows * n_group, Hkv, P_, 132)
    assert ns <= pa.n_splits(rows, Hkv, P_, 132)


@pytest.mark.parametrize("window", [0, 1, 5, 13, 64])
@pytest.mark.parametrize("n_split", [1, 2, 3, P, P + 3])
def test_every_live_page_lands_in_exactly_one_split(window, n_split):
    lens = torch.arange(1, P * PAGE + 1)          # 1 .. P*page
    rng = ref.paged_split_pages(lens, PAGE, window, n_split)
    for b, ln in enumerate(lens.tolist()):
        live = -(-ln // PAGE)
        first = (ln - window) // PAGE if window and ln - window > 0 else 0
        pages = [p for lo, hi in rng[b].tolist() for p in range(lo, hi)]
        assert pages == list(range(first, live))
        # contiguous, ordered ranges; sizes differ by at most one
        edges = rng[b].flatten().tolist()
        assert edges == sorted(edges)
        sizes = (rng[b, :, 1] - rng[b, :, 0]).tolist()
        assert max(sizes) - min(sizes) <= 1
        # the oldest position the window keeps lies in the first page
        if window:
            assert first * PAGE <= max(ln - window, 0) < (first + 1) * PAGE


CASES = {  # name: (kv storage, Hkv, dk, dv, dr, window)
    "f32": ("f32", 1, 32, 32, 0, 0),
    "gqa_window": ("f32", 2, 32, 32, 0, 5),
    "dk_ne_dv": ("f32", 1, 48, 24, 0, 0),
    "int8_scaled": ("int8", 1, 32, 32, 0, 0),
    "k_extra": ("f32", 1, 32, 32, 16, 0),
    "int8_k_extra_window": ("int8", 1, 40, 40, 8, 7),
}


def paged_inputs(name, seed=0, B=6, H=4):
    """numpy inputs as tests/test_torch_paged_attention.py makes them:
    lens 1 and P*page among ragged ones, live pages scattered over the
    pool, sentinel ids past them."""
    kv, Hkv, dk, dv, dr, window = CASES[name]
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, P * PAGE + 1, B)
    lens[0], lens[1] = 1, P * PAGE
    live = -(-lens // PAGE)
    n_pages = int(live.sum()) + 3
    perm = rng.permutation(n_pages)
    table = np.full((B, P), n_pages, np.int32)
    table[:, -1] = n_pages + 3
    at = 0
    for b, n in enumerate(live):
        table[b, :n] = perm[at:at + n]
        at += n
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    c = dict(q=f(B, H, dk + dr), k_pages=f(n_pages, PAGE, Hkv, dk),
             v_pages=f(n_pages, PAGE, Hkv, dv), table=table,
             lens=lens.astype(np.int32), window=window)
    if kv == "int8":
        for k in ("k_pages", "v_pages"):
            c[k] = np.clip(np.round(c[k] * 40), -127, 127).astype(np.int8)
        c["k_scale"] = rng.uniform(0, 0.05, (n_pages, PAGE, Hkv)
                                   ).astype(np.float32)
        c["v_scale"] = rng.uniform(0, 0.05, (n_pages, PAGE, Hkv)
                                   ).astype(np.float32)
    if dr:
        c["k_extra"] = f(n_pages, PAGE, Hkv, dr)
    return c


_jax_out = {}


def jax_interpret(name):
    """JAX's Pallas paged kernel in interpret mode, once per case."""
    if name not in _jax_out:
        c = paged_inputs(name)
        jc = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in c.items()}
        _jax_out[name] = np.asarray(
            jax_kernel.paged_attention(**jc, interpret=True), np.float32)
    return _jax_out[name]


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 6, 9])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_twin_matches_jax_kernel(name, n_split):
    """1 .. P splits, and 9 > P: rows of one live page then have splits
    with no page, whose empty partials the combine must ignore."""
    c = paged_inputs(name)
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    got = ref.paged_attention_split(**t, n_split=n_split).numpy()
    np.testing.assert_allclose(got, jax_interpret(name), atol=2e-5,
                               rtol=2e-5)


def test_split_twin_with_more_splits_than_live_pages():
    """A row of length 1 has one live page: every other split is empty,
    yet the combine gives the one page's attention exactly."""
    c = paged_inputs("f32")
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    rng = ref.paged_split_pages(t["lens"], PAGE, 0, P)
    assert int((rng[0, :, 1] > rng[0, :, 0]).sum()) == 1
    one = ref.paged_attention_split(**t, n_split=P)
    np.testing.assert_allclose(one.numpy(),
                               ref.paged_attention(**t).numpy(),
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# flash attention: the split rule and the tile-skip predicate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,T,H,Hkv,S", [
    (4, 128, 4, 1, 640), (4, 128, 32, 32, 704), (4, 2048, 4, 1, 2048),
    (2, 70, 4, 2, 70), (1, 1, 1, 1, 1)])
def test_flash_split_rule(N, T, H, Hkv, S):
    n_sm = 132
    bk = fa.tiles(256, torch.bfloat16)[1]
    ns = fa.n_splits(N, T, H, Hkv, S, bk, n_sm)
    blocks = N * Hkv * -(-(H // Hkv) * T // fa.BQ)
    assert 1 <= ns <= -(-S // bk)
    if blocks >= n_sm:
        assert ns == 1
    elif ns < -(-S // bk):
        assert blocks * ns >= n_sm


def test_flash_tiles():
    assert fa.tiles(256, torch.bfloat16) == (64, 32)
    for dh in (32, 64, 128):
        assert fa.tiles(dh, torch.bfloat16) == (64, 64)
    for dh in (32, 64, 128, 256):
        assert fa.tiles(dh, torch.float32) == (64, 64)


def ring_positions(N=4, C=37, S=512, window=512):
    """A chunk over a ring of S slots, as the local layers' prefill
    builds it: wrapped idx, a ragged tail, a slot with no valid key."""
    idx = torch.tensor([0, 300, 700, 1500])[:N]
    n_tok = torch.tensor([C, C - 7, C, 5])[:N]
    q_pos, c_pos = attn._chunk_pos(idx, n_tok, C)
    k_pos = torch.cat([attn._cache_entry_pos(S, idx, window), c_pos], 1)
    k_pos[-1] = attn.FAR
    return q_pos, k_pos, window


def paged_positions(N=3, C=40, S=96):
    """A chunk after gathered pages: slots at or past idx (unallocated or
    not yet written) are FAR, the chunk's padded tail too."""
    idx = torch.tensor([0, 33, 56])[:N]
    q_pos, c_pos = attn._chunk_pos(idx, torch.tensor([40, 40, 11])[:N], C)
    slots = torch.arange(S)
    cache = torch.where(slots < idx[:, None], slots, attn.FAR)
    return q_pos, torch.cat([cache, c_pos], 1), 0


SCENARIOS = {  # name: (N, T, S, q_pos, k_pos, causal, window)
    "ring_w512": lambda: (4, 37, 549) + ring_positions(),
    "paged_gather": lambda: (3, 40, 136) + paged_positions(),
    "ragged_tail_empty_cache": lambda: (2, 24, 48) + (
        attn._chunk_pos(torch.tensor([0, 0]), torch.tensor([9, 0]), 24)[0],
        torch.cat([torch.full((2, 24), attn.FAR), attn._chunk_pos(
            torch.tensor([0, 0]), torch.tensor([9, 0]), 24)[1]], 1), 0),
    "top_left_causal": lambda: (2, 150, 150, None, None, 0),
    "top_left_window": lambda: (2, 150, 150, None, None, 40),
    "apply_2048": lambda: (1, 2048, 2048, None, None, 0),
}


def scenario(name):
    N, T, S, q_pos, k_pos, window = SCENARIOS[name]()
    return N, T, S, q_pos, k_pos, window


def assert_keeps_valid_pairs(N, T, S, g, bq, bk, q_pos, k_pos, window,
                             causal=True):
    live = ref.flash_tile_live(N, T, S, g, bq, bk, causal, window, q_pos,
                               k_pos)
    ok = ref.attention_mask(N, T, S, causal, window, q_pos, k_pos)
    rows = torch.arange(g * T)
    pairs = ok[:, rows % T]                           # (N, g*T, S)
    seen = live[:, rows // bq][:, :, torch.arange(S) // bk]
    assert not (pairs & ~seen).any(), "a valid pair lies in a skipped tile"
    return live


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tile_skip_never_drops_a_valid_pair(name, bk, g):
    N, T, S, q_pos, k_pos, window = scenario(name)
    live = assert_keeps_valid_pairs(N, T, S, g, 64, bk, q_pos, k_pos, window)
    if name == "apply_2048" and g == 1:
        # top-left causal at T = S: the tiles past the diagonal, ~half
        assert abs(1 - live.float().mean().item() - 0.5) < 0.05


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_attention_with_skipped_tiles_masked_is_unchanged(name):
    N, T, S, q_pos, k_pos, window = scenario(name)
    if T > 1000:                       # keep the plain product small
        T = S = 256
    rng = np.random.default_rng(0)
    H, Hkv, dh = 4, 1, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((N, T, H, dh), (N, S, Hkv, dh), (N, S, Hkv, dh)))
    kw = dict(causal=True, window=window, q_pos=q_pos, k_pos=k_pos)
    for bk in (32, 64):
        got = ref.attention_tiles(q, k, v, 64, bk, **kw)
        want = ref.attention(q, k, v, **kw)
        valid = ref.attention_mask(N, T, S, True, window, q_pos,
                                   k_pos).any(-1)
        assert valid.any()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got[valid], want[valid], atol=1e-6,
                                   rtol=1e-6)


def test_tile_skip_on_random_positions():
    """Hypothesis sweep: random key positions (negatives included, not
    monotone), random query positions, windows, tile sizes and g."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(st.integers(1, 2), st.integers(1, 40), st.integers(1, 90),
               st.sampled_from([1, 2, 4]), st.sampled_from([16, 64]),
               st.sampled_from([8, 32, 64]), st.integers(0, 20),
               st.integers(0, 2 ** 31 - 1))
    def check(N, T, S, g, bq, bk, window, seed):
        gen = torch.Generator().manual_seed(seed)
        q_pos = torch.randint(0, 120, (N, T), generator=gen)
        k_pos = torch.randint(-30, 120, (N, S), generator=gen)
        assert_keeps_valid_pairs(N, T, S, g, bq, bk, q_pos, k_pos, window)

    check()


@pytest.mark.parametrize("g", [1, 6])
@pytest.mark.parametrize("bk", [32, 64])
@pytest.mark.parametrize("T,S", [(1500, 1500), (128, 1500), (1, 1500),
                                 (37, 70)])
def test_non_causal_reads_every_tile(T, S, bk, g):
    """Whisper's encoder (T = S = 1500: no multiple of the 64-row query
    tile nor of a key tile) and its cross-attention (T decoder tokens
    over S frames): with no mask, no tile is skipped, the ragged last
    key tile included, and every pair stays valid."""
    live = assert_keeps_valid_pairs(1, T, S, g, 64, bk, None, None, 0,
                                    causal=False)
    assert live.shape == (1, -(-g * T // 64), -(-S // bk)) and live.all()


@pytest.mark.parametrize("T,S", [(150, 150), (37, 130)])
def test_non_causal_attention_with_tiles_is_unchanged(T, S):
    """ref.attention_tiles at causal=False (T != S, ragged tiles) equals
    ref.attention: every query sees every key."""
    rng = np.random.default_rng(1)
    H, Hkv, dh = 6, 1, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, T, H, dh), (2, S, Hkv, dh), (2, S, Hkv, dh)))
    want = ref.attention(q, k, v, causal=False)
    assert ref.attention_mask(2, T, S, False).all()
    for bk in (32, 64):
        got = ref.attention_tiles(q, k, v, 64, bk, causal=False)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
