"""The chunked wkv6's CPU twin (kernels/ref.wkv6_chunked: the chunk and
sub-block factorisation csrc/wkv6.cu computes) against the port's
sequential oracle (kernels/ref.wkv6), the JAX package's oracle and its
Pallas kernel (interpret mode), on the same numpy inputs.

The decays cover the models' whole clamp, log_w = -exp(clip(x, -20,
4)), down to -e^4 a token: there the separable split exp(la_p[t]) *
exp(-la[j]) overflows f32 within two tokens, and the twin's exponents,
all <= 0, cannot.  Tolerance atol 5e-4, rtol 1e-3: tests/test_kernels.py's
for the Pallas kernel against its oracle (the chunked form sums in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wkv6 as wk

TOL = dict(atol=5e-4, rtol=1e-3)
K, B, H = 2, 1, 2


def inputs(T, dh, n_valid=None, seed=0):
    """r, k, v, log_w (K*B, T, H, dh) with log_w = -exp(clip(3 x, -20,
    4)) (some tokens at -e^4), tokens from n_valid on masked as
    rwkv_prefill masks them (k = 0, log_w = 0), u (K, H, dh) one per
    member, s0 (K*B, H, dh, dh) nonzero; all f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    N = K * B
    r, k, v = f(N, T, H, dh), f(N, T, H, dh), f(N, T, H, dh)
    lw = -np.exp(np.clip(3 * f(N, T, H, dh), -20, 4)).astype(np.float32)
    if n_valid is not None:
        k[:, n_valid:] = 0
        lw[:, n_valid:] = 0
    u = f(K, H, dh) * np.float32(0.3)
    s0 = f(N, H, dh, dh) * np.float32(0.1)
    return r, k, v, lw, u, s0


def twin(r, k, v, lw, u, s0, **kw):
    y, s = tref.wkv6_chunked(*(torch.from_numpy(x)
                               for x in (r, k, v, lw, u, s0)), **kw)
    return y.numpy(), s.numpy()


def test_twin_defaults_are_the_kernels():
    assert (wk.CHUNK, wk.SUB) == (16, 8)
    import inspect
    sig = inspect.signature(tref.wkv6_chunked).parameters
    assert (sig["chunk"].default, sig["sub"].default) == (wk.CHUNK, wk.SUB)


CASES = [(1, None), (15, None), (16, None), (17, None), (33, None),
         (128, 44)]                                # (T, valid tokens)


@pytest.mark.parametrize("dh", [8, 32, 64])
@pytest.mark.parametrize("T,n_valid", CASES)
def test_twin_matches_the_sequential_oracle(T, n_valid, dh):
    a = inputs(T, dh, n_valid, seed=T * 7 + dh)
    r, k, v, lw, u, s0 = a
    assert lw.min() == np.float32(-np.exp(4))      # the clamp's floor
    y, s = twin(*a)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    want_y, want_s = tref.wkv6(*(torch.from_numpy(x) for x in a))
    np.testing.assert_allclose(y, want_y.numpy(), **TOL)
    np.testing.assert_allclose(s, want_s.numpy(), **TOL)
    if n_valid is not None:
        # masked tokens are state no-ops: s_T is the state after the
        # valid tokens alone
        _, s_valid = tref.wkv6(*(torch.from_numpy(x[:, :n_valid])
                                 for x in (r, k, v, lw)),
                               torch.from_numpy(u), torch.from_numpy(s0))
        np.testing.assert_allclose(s, s_valid.numpy(), **TOL)


# every T and every dh of the sweep above, each shape one JAX compile
@pytest.mark.parametrize("T,n_valid,dh", [
    (1, None, 8), (15, None, 32), (16, None, 64), (17, None, 8),
    (33, None, 64), (128, 44, 32), (128, 44, 64)])
def test_twin_matches_the_jax_oracle_and_the_pallas_kernel(T, n_valid, dh):
    """The Pallas kernel runs at the CUDA kernel's chunk: at its default
    32 and decays of -e^4 its own pairwise exps, of la summed over 32
    tokens, drift from a float64 oracle by more than the tolerance on a
    few elements."""
    a = inputs(T, dh, n_valid, seed=T * 7 + dh)
    r, k, v, lw, u, s0 = a
    y, s = twin(*a)
    for m in range(K):                 # each member with its own u
        rows = slice(m * B, (m + 1) * B)
        j = [jnp.asarray(x[rows]) for x in (r, k, v, lw)]
        ju, js0 = jnp.asarray(u[m]), jnp.asarray(s0[rows])
        for jy, js in (jref.wkv6(*j, ju, js0),
                       jwkv6(*j, ju, js0, chunk=wk.CHUNK, interpret=True)):
            np.testing.assert_allclose(y[rows], np.asarray(jy), **TOL)
            np.testing.assert_allclose(s[rows], np.asarray(js), **TOL)


@pytest.mark.parametrize("chunk,sub", [(16, 8), (32, 8), (16, 4), (8, 8),
                                       (32, 16)])
def test_twin_at_other_chunk_and_sub_block_sizes(chunk, sub):
    a = inputs(70, 16, seed=chunk + sub)
    y, s = twin(*a, chunk=chunk, sub=sub)
    want_y, want_s = tref.wkv6(*(torch.from_numpy(x) for x in a))
    np.testing.assert_allclose(y, want_y.numpy(), **TOL)
    np.testing.assert_allclose(s, want_s.numpy(), **TOL)


def test_separable_split_overflows_where_the_twin_stays_finite():
    """Two tokens at -e^4 in one chunk: exp(-la[j]) = e^109 overflows
    f32, so the separable form's intra-chunk scores are not finite; the
    twin's are, and match the oracle."""
    T, dh = 16, 8
    r, k, v, lw, u, s0 = inputs(T, dh, seed=5)
    lw[:] = np.float32(-np.exp(4))
    la = np.cumsum(lw, 1, dtype=np.float32)
    la_p = la - lw
    with np.errstate(over="ignore", invalid="ignore"):
        q = r * np.exp(la_p)                         # <= 1: fine
        kk = k * np.exp(-la)                         # e^(54.6 t): inf
        scores = np.einsum("nthd,njhd->nhtj", q, kk)
    assert not np.isfinite(kk).all()
    assert not np.isfinite(scores).all()
    y, s = twin(r, k, v, lw, u, s0)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    want_y, want_s = tref.wkv6(*(torch.from_numpy(x)
                                 for x in (r, k, v, lw, u, s0)))
    np.testing.assert_allclose(y, want_y.numpy(), **TOL)
    np.testing.assert_allclose(s, want_s.numpy(), **TOL)
