"""The logic of the split paged-attention kernel and of the flash
kernel's tile skipping, held on the CPU through their plain twins.

- The split rule (`paged_attention.n_splits`, `flash_attention.n_splits`)
  reads only shapes, and the page division (`ref.paged_split_pages`)
  puts every live page of every row in exactly one split, for windows
  and for lens of 1 and of P * page.
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


def assert_keeps_valid_pairs(N, T, S, g, bq, bk, q_pos, k_pos, window):
    live = ref.flash_tile_live(N, T, S, g, bq, bk, True, window, q_pos,
                               k_pos)
    ok = ref.attention_mask(N, T, S, True, window, q_pos, k_pos)
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
