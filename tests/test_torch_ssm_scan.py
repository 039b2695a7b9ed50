"""The port's plain ssm_scan (kernels/ref.ssm_scan, the CUDA kernel's
oracle on the card) and its CPU dispatch (kernels/ops.ssm_scan) against
the JAX package's Pallas kernel (interpret mode) and its sequential
oracle.

Same numpy inputs, made from a seed, go to both packages, at
tests/test_kernels.py's shapes.  Tolerance atol = rtol = 1e-5:
tests/test_kernels.py's for the Pallas kernel against the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssm_scan as jscan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)


def inputs(N, T, D, Ns, seed=0):
    """a = exp(-|x|) in (0, 1], b and h0 small, all f32 numpy, as
    tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = np.exp(-np.abs(f(N, T, D, Ns))).astype(np.float32)
    b = f(N, T, D, Ns) * np.float32(0.2)
    h0 = f(N, D, Ns) * np.float32(0.1)
    return a, b, h0


def torch_ref(*arrays):
    hs, h_t = tref.ssm_scan(*(torch.from_numpy(x) for x in arrays))
    return hs.numpy(), h_t.numpy()


@pytest.mark.parametrize("shape", [(1, 16, 8, 4), (2, 37, 24, 8),
                                   (1, 128, 64, 16)])  # (N, T, D, Ns)
def test_ssm_scan_sweep(shape):
    a, b, h0 = inputs(*shape)
    hs, h_t = torch_ref(a, b, h0)
    assert hs.dtype == np.float32 and hs.shape == a.shape
    j = [jnp.asarray(x) for x in (a, b, h0)]
    for want_hs, want_h in (jscan(*j), jref.ssm_scan(*j)):
        np.testing.assert_allclose(hs, np.asarray(want_hs), **TOL)
        np.testing.assert_allclose(h_t, np.asarray(want_h), **TOL)


def test_ssm_scan_identity_steps_pass_the_state_through():
    """a = 1, b = 0 (what Mamba's valid mask makes of a padded prefill
    position) leaves the state bit for bit as it was."""
    a, b, h0 = inputs(2, 9, 8, 4, seed=1)
    a[:, 5:], b[:, 5:] = 1.0, 0.0
    hs, h_t = torch_ref(a, b, h0)
    np.testing.assert_array_equal(h_t, hs[:, 4])
    _, h5 = torch_ref(a[:, :5], b[:, :5], h0)
    np.testing.assert_array_equal(h_t, h5)


def test_ops_ssm_scan_updates_a_strided_state_in_place():
    """ops.ssm_scan on the CPU: rows fold K members, and the state is one
    layer's view of a cache pool narrowed to one slot, (K, count, B, D,
    Ns)[:, c, b:b+1]; h_T lands there, and nothing else in the pool
    moves."""
    K, count, B, D, Ns, T = 2, 3, 4, 8, 4, 7
    a, b, h0 = inputs(K, T, D, Ns, seed=2)
    pool = torch.randn(K, count, B, D, Ns)
    c, s = 1, 2
    pool[:, c, s] = torch.from_numpy(h0)
    before = pool.clone()
    state = pool[:, c].narrow(1, s, 1)
    hs = ops.ssm_scan(torch.from_numpy(a), torch.from_numpy(b), state)
    want_hs, want_h = torch_ref(a, b, h0)
    np.testing.assert_array_equal(hs.numpy(), want_hs)
    np.testing.assert_array_equal(pool[:, c, s].numpy(), want_h)
    pool[:, c, s] = before[:, c, s]
    assert torch.equal(pool, before)
