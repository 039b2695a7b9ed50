"""The port's plain wkv6 (kernels/ref.wkv6, the CUDA kernel's oracle on
the card) and its CPU dispatch (kernels/ops.wkv6) against the JAX
package's Pallas kernel (interpret mode) and its sequential oracle.

Same numpy inputs, made from a seed, go to both packages.  Tolerance
atol 5e-4, rtol 1e-3: tests/test_kernels.py's for the Pallas kernel
against the oracle (the chunked form sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wkv6 import wkv6 as jwkv6
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = dict(atol=5e-4, rtol=1e-3)


def inputs(N, T, H, dh, seed=0, K=None):
    """r, k, v, log_w (N, T, H, dh) with strong and weak decays
    (-exp(clip(x, -3, 2)), as tests/test_kernels.py), u (H, dh) or (K,
    H, dh), s0 (N, H, dh, dh), all f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = f(N, T, H, dh), f(N, T, H, dh), f(N, T, H, dh)
    lw = -np.exp(np.clip(f(N, T, H, dh), -3, 2)).astype(np.float32)
    u = f(*((H, dh) if K is None else (K, H, dh))) * np.float32(0.3)
    s0 = f(N, H, dh, dh) * np.float32(0.1)
    return r, k, v, lw, u, s0


def torch_ref(*a):
    y, s = tref.wkv6(*(torch.from_numpy(x) for x in a))
    return y.numpy(), s.numpy()


@pytest.mark.parametrize("shape", [(1, 16, 2, 8), (2, 50, 3, 16),
                                   (1, 100, 1, 64)])  # (N, T, H, dh)
def test_wkv6_sweep(shape):
    a = inputs(*shape)
    y, s = torch_ref(*a)
    j = [jnp.asarray(x) for x in a]
    for want_y, want_s in (jwkv6(*j, chunk=32, interpret=True),
                           jref.wkv6(*j)):
        np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s, np.asarray(want_s), **TOL)


def test_wkv6_decode_step_from_a_nonzero_state():
    """T = 1 from a nonzero s0: the decode step's contract,
    y = r (S + u kᵀv) and S' = S exp(log_w) + kᵀv."""
    r, k, v, lw, u, s0 = inputs(6, 1, 4, 32, seed=1)
    y, s = torch_ref(r, k, v, lw, u, s0)
    want_y, want_s = jref.wkv6(*(jnp.asarray(x)
                                 for x in (r, k, v, lw, u, s0)))
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
    np.testing.assert_allclose(s, np.asarray(want_s), **TOL)
    kv = np.einsum("nhk,nhv->nhkv", k[:, 0], v[:, 0])
    np.testing.assert_allclose(
        y[:, 0], np.einsum("nhk,nhkv->nhv", r[:, 0],
                           s0 + u[None, :, :, None] * kv), **TOL)
    np.testing.assert_allclose(s, s0 * np.exp(lw[:, 0])[..., None] + kv,
                               **TOL)


def test_wkv6_rows_fold_members_with_their_own_u():
    """N = K * B rows with u (K, H, dh): row n runs member n // B's u,
    as the JAX engine's per-member vmap does."""
    K, B = 4, 2
    a = inputs(K * B, 9, 2, 16, seed=2, K=K)
    y, s = torch_ref(*a)
    r, k, v, lw, u, s0 = a
    for m in range(K):
        rows = slice(m * B, (m + 1) * B)
        want_y, want_s = jref.wkv6(*(jnp.asarray(x[rows])
                                     for x in (r, k, v, lw)),
                                   jnp.asarray(u[m]), jnp.asarray(s0[rows]))
        np.testing.assert_allclose(y[rows], np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s[rows], np.asarray(want_s), **TOL)
    # members differ only in u here, so a shared u would fail
    assert np.abs(u[0] - u[1]).max() > 0.1


def test_ops_wkv6_updates_a_strided_state_in_place():
    """ops.wkv6 on the CPU: the state is one layer's view of a cache
    pool narrowed to one slot, (K, count, B, H, dh, dh)[:, c, b:b+1];
    s_T lands there, and nothing else in the pool moves."""
    K, count, B, H, dh, T = 2, 3, 4, 2, 8, 5
    r, k, v, lw, u, s0 = inputs(K, T, H, dh, seed=3, K=K)
    pool = torch.randn(K, count, B, H, dh, dh)
    c, b = 1, 2
    pool[:, c, b] = torch.from_numpy(s0)
    before = pool.clone()
    state = pool[:, c].narrow(1, b, 1)
    y = ops.wkv6(*(torch.from_numpy(x) for x in (r, k, v, lw, u)), state)
    want_y, want_s = torch_ref(r, k, v, lw, u, s0)
    np.testing.assert_array_equal(y.numpy(), want_y)
    np.testing.assert_array_equal(pool[:, c, b].numpy(), want_s)
    pool[:, c, b] = before[:, c, b]
    assert torch.equal(pool, before)
