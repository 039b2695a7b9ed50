"""The port's flash attention (plain version and dispatch) against the
JAX package, and the prefill's route through it.

- `ref.attention` against JAX `flash_attention` (the Pallas kernel in
  interpret mode, as tests/test_kernels.py runs it) and JAX
  `ref.attention` on that file's sweep: 2e-5 at f32, 2e-2 at bf16 (the
  kernel sums an online softmax tile by tile, the references at once).
- The position form against JAX `attend` at f32 on inputs the prefill
  itself builds: a wrapped ring with empty slots, a paged gather with
  unallocated entries, a ragged chunk tail.
- Reduced gemma3-1b: `apply`, `prefill_step_paged` and `prefill_slots`
  call `ops.flash_attention` once per attention layer per call, and
  their logits still match JAX at f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.serving import kv_cache as jkv
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv

TOL = {"f32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
SHAPES = [  # (N, T, S, H, Hkv, dh), tests/test_kernels.py's sweep
    (1, 17, 17, 4, 4, 32),     # MHA, odd seq
    (2, 64, 64, 8, 2, 64),     # GQA
    (1, 130, 130, 4, 1, 128),  # kv=1 (gemma-like), unaligned seq
    (2, 32, 96, 4, 4, 32),     # kv longer than q
]
MASKS = [(True, 0), (True, 13), (False, 0)]
# causal with T != S has no top-left meaning: that harness leaves it out
SWEEP = [(s, dt, c, w) for s in SHAPES for dt in ("f32", "bf16")
         for c, w in MASKS if not (c and s[1] != s[2])]


def inputs(shape, dt, seed=0):
    """The same numpy draws for both packages, rounded to bf16 alike."""
    N, T, S, H, Hkv, dh = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((N, T, H, dh), (N, S, Hkv, dh), (N, S, Hkv, dh))]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dt == "bf16"
                else (jnp.float32, torch.float32))
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("shape,dt,causal,window", SWEEP)
def test_plain_version_matches_jax_kernel_and_reference(shape, dt, causal,
                                                        window):
    j, t = inputs(shape, dt)
    got = ref.attention(*t, causal=causal, window=window).float().numpy()
    want_kernel = jflash(*j, causal=causal, window=window, bq=32, bk=32)
    want_ref = jref.attention(*j, causal=causal, window=window)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **TOL[dt])


def _attend_rows(q, k, v, q_pos, k_pos, window):
    """JAX attend row by row (the JAX prefill runs one slot at a time,
    with 1-D positions)."""
    return np.concatenate([np.asarray(jattn.attend(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], jnp.asarray(q_pos[i]),
        jnp.asarray(k_pos[i]), window=window, causal=True, scale=0.25))
        for i in range(len(q))])


def _check_position_form(q, k, v, q_pos, k_pos, window):
    want = _attend_rows(q, k, v, q_pos, k_pos, window)
    got = ref.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=window, scale=0.25,
                        q_pos=torch.from_numpy(q_pos),
                        k_pos=torch.from_numpy(k_pos)).numpy()
    assert np.isfinite(got).all()
    # rows with at least one valid key (the rest are discarded by callers)
    kp, qp = k_pos[:, None, :], q_pos[:, :, None]
    ok = (kp >= 0) & (kp <= qp)
    if window:
        ok &= kp > qp - window
    valid = ok.any(-1)
    assert valid.any()
    np.testing.assert_allclose(got[valid], want[valid], **TOL["f32"])


def _qkv(rng, N, C, S, H=4, Hkv=2, dh=16):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((N, C, H, dh), (N, S + C, Hkv, dh),
                      (N, S + C, Hkv, dh))]


def test_position_form_matches_attend_on_a_wrapped_ring():
    """Ring of 16 slots (window 16) at chunk starts before, at and past a
    wrap; positions from the port's helpers equal the JAX package's."""
    rng = np.random.default_rng(1)
    S, C, window = 16, 8, 16
    idx = torch.tensor([0, 5, 16, 37])
    n_tok = torch.tensor([8, 8, 3, 8])
    q_pos, c_pos = tattn._chunk_pos(idx, n_tok, C)
    cache_pos = tattn._cache_entry_pos(S, idx, window)
    for i in range(len(idx)):
        np.testing.assert_array_equal(
            cache_pos[i].numpy(),
            np.asarray(jattn._cache_entry_pos(S, int(idx[i]), window)))
    k_pos = torch.cat([cache_pos, c_pos], 1)
    q, k, v = _qkv(rng, len(idx), C, S)
    _check_position_form(q, k, v, q_pos.numpy(), k_pos.numpy(), window)


def test_position_form_matches_attend_on_a_paged_gather():
    """Pages gathered through a table with unallocated (sentinel) entries
    past each slot's live pages, plus the chunk at its offset."""
    rng = np.random.default_rng(2)
    n_pages, page, P, Hkv, dh, C = 12, 4, 5, 2, 16, 8
    pages = torch.from_numpy(rng.standard_normal(
        (n_pages, page, Hkv, dh)).astype(np.float32))
    idx = torch.tensor([0, 6, 12])
    table = torch.full((1, 3, P), n_pages, dtype=torch.int32)
    table[0, 1, :2] = torch.tensor([3, 7])
    table[0, 2, :4] = torch.tensor([1, 9, 2, 5])
    k_cache = tattn._gather_pages(pages, table)        # (3, P*page, ...)
    S = k_cache.shape[1]
    q_pos, c_pos = tattn._chunk_pos(idx, torch.tensor([8, 8, 5]), C)
    slot_ids = torch.arange(S)
    cache_pos = torch.where(slot_ids < idx[:, None], slot_ids, tattn.FAR)
    k_pos = torch.cat([cache_pos, c_pos], 1)
    q, kc, vc = _qkv(rng, 3, C, S, Hkv=Hkv, dh=dh)
    k = np.concatenate([k_cache.numpy(), kc[:, S:]], 1)
    v = np.concatenate([tattn._gather_pages(pages.flip(0), table).numpy(),
                        vc[:, S:]], 1)
    _check_position_form(q, k, v, q_pos.numpy(), k_pos.numpy(), 0)


def test_position_form_matches_attend_on_a_ragged_tail():
    """A chunk of 8 with 3 valid tokens over an empty cache: the padded
    rows still see the valid ones; a slot with n_tok = 0 has no valid
    key at all and is only required to be finite."""
    rng = np.random.default_rng(3)
    S, C = 8, 8
    idx = torch.tensor([0, 0])
    q_pos, c_pos = tattn._chunk_pos(idx, torch.tensor([3, 0]), C)
    cache_pos = tattn._cache_entry_pos(S, idx, 0)
    k_pos = torch.cat([cache_pos, c_pos], 1)
    q, k, v = _qkv(rng, 2, C, S)
    _check_position_form(q, k, v, q_pos.numpy(), k_pos.numpy(), 0)


def test_ops_dispatches_cpu_tensors_to_plain_version():
    _, t = inputs(SHAPES[1], "f32")
    pos = torch.arange(64).expand(2, 64).int()
    for kw in (dict(causal=True, window=5), dict(causal=True, q_pos=pos,
                                                 k_pos=pos)):
        assert torch.equal(ops.flash_attention(*t, **kw),
                           ref.attention(*t, **kw))


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never quietly runs the plain version."""
    _, t = inputs(SHAPES[0], "f32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*t)


# ---------------------------------------------------------------------------
# the route: reduced gemma3-1b, f32
# ---------------------------------------------------------------------------

K = 2


@pytest.fixture(scope="module")
def gemma():
    jcfg = jreg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    tcfg = treg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture
def calls(monkeypatch):
    """Counts ops.flash_attention calls (the plain version still runs)."""
    seen = []
    real = ops.flash_attention

    def counted(q, k, v, **kw):
        seen.append(q.shape[0])
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    return seen


def test_apply_routes_through_flash_attention(gemma, calls):
    jcfg, tcfg, jp, tp = gemma
    tok = np.random.default_rng(4).integers(0, 512, (2, 20)).astype(np.int32)
    got, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok))
    assert calls == [K * 2] * tcfg.n_layers   # members folded into rows
    want = jax.vmap(lambda p: jtf.apply(p, jcfg, tokens=tok,
                                        remat=False)[0])(jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_routes_through_flash_attention(gemma, calls, paged):
    """Two chunks of one slot (the second over the first's cache), as the
    engine calls prefill; each call launches once per layer."""
    jcfg, tcfg, jp, tp = gemma
    B, C, max_seq, page = 2, 8, 40, 4
    kw = dict(page_size=page, n_pages=B * max_seq // page) if paged else {}
    jc = jax.vmap(lambda _: jtf.init_slot_cache(jcfg, B, max_seq, **kw))(
        jnp.arange(K))
    tc = ttf.init_slot_cache(tcfg, B, max_seq, members=K, device="cpu", **kw)
    if paged:
        perm = np.random.default_rng(5).permutation(kw["n_pages"]) \
            .reshape(B, -1).astype(np.int32)
        jc["page_table"] = jnp.broadcast_to(perm, (K,) + perm.shape)
        tc["page_table"] = torch.from_numpy(perm).expand(K, *perm.shape) \
            .contiguous()
    jpre = jax.vmap(lambda p, c, t, n: (jtf.prefill_step_paged if paged
                                        else jtf.prefill_slots)(
        p, jcfg, c, t, n), in_axes=(0, 0, None, None))
    tpre = ttf.prefill_step_paged if paged else ttf.prefill_slots
    toks = np.random.default_rng(6).integers(0, 512, (2, C)).astype(np.int32)
    for n in (8, 5):
        ch = toks[:1].copy()
        nj = jnp.int32(n) if paged else jnp.asarray([n], jnp.int32)
        jl, jrow = jpre(jp, jkv.slot_row(jc, 1), ch, nj)
        jc = jkv.write_slot_row(jc, jrow, 1)
        tl, trow = tpre(tp, tcfg, tkv.slot_row(tc, 1), torch.from_numpy(ch),
                        torch.tensor([n], dtype=torch.int32))
        tkv.write_slot_row(tc, trow, 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl).reshape(K, 1, -1),
                                   atol=1e-4, rtol=1e-4)
    assert calls == [K] * (2 * tcfg.n_layers)
