"""The port's Eqn-9 loss, NiN and ensemble maths against the JAX package.

The same numpy inputs go through both packages on the CPU.  The port's
plain distill_loss (what ops.fused_distill_loss runs on a CPU tensor) is
held against JAX's plain ref.distill_loss and against JAX's Pallas
kernel in interpret mode, value and gradient; NiN logits against
repro.models.cnn.nin_apply on bridged params; the Eqn-6 ensemble maths
against repro.core.ensemble, and the Jensen gap >= 0 property.
Tolerances: f32 loss rtol 1e-5 and gradient atol 1e-6 (the JAX kernel
tests'); NiN logits atol 1e-5 (convs summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distill as jdistill
from repro.core import ensemble as jens
from repro.kernels import distill_loss as jkernel
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro_torch.bridge import params_from_numpy
from repro_torch.core import distill as tdistill
from repro_torch.core import ensemble as tens
from repro_torch.kernels import ops, ref
from repro_torch.models import cnn as tcnn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the torch side runs tiny shapes, and the
    suite's workers share the cores (torch's default, one thread a core
    in every worker, oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, v, seed=0, pad=False):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    if pad:
        y[::4] = -1
    # peaked where the logits are large, as an ensemble's labels are,
    # so that the lambda terms weigh as much as the true-label term
    e = 2 * z + rng.standard_normal((n, v))
    e = np.exp(e - e.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return z, y, p


def _port_value_and_grad(fn, z, y, p, lam):
    zt = torch.from_numpy(z).requires_grad_()
    loss = fn(zt, torch.from_numpy(y), torch.from_numpy(p),
              torch.tensor(lam))
    loss.backward()
    return float(loss.detach()), zt.grad.numpy()


@pytest.mark.parametrize("n,v", [(8, 100), (33, 517), (24, 300)])
def test_plain_distill_loss_matches_jax_ref(n, v):
    z, y, p = _inputs(n, v, seed=n)
    lam = np.float32(0.4)
    want, gwant = jax.value_and_grad(
        lambda a: jref.distill_loss(a, y, p, lam))(z)
    got, ggot = _port_value_and_grad(ref.distill_loss, z, y, p, 0.4)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(ggot, np.asarray(gwant), atol=1e-6)
    parts = ref.distill_loss_parts(*map(torch.from_numpy, (z, y, p)))
    for a, b in zip(parts, jref.distill_loss_parts(z, y, p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("pad", [False, True])
def test_plain_distill_loss_matches_jax_kernel(pad):
    """JAX's Pallas kernel in interpret mode, as tests/test_kernels.py
    runs it; labels -1 hit no column in both."""
    z, y, p = _inputs(40, 600, seed=3, pad=pad)
    lam = jnp.float32(0.8)
    want, gwant = jax.value_and_grad(
        lambda a: jkernel.fused_distill_loss(a, y, p, lam, 16, 128))(z)
    got, ggot = _port_value_and_grad(ops.fused_distill_loss, z, y, p, 0.8)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(ggot, np.asarray(gwant), atol=1e-6)


def test_mixed_ce_and_schedule_match_jax():
    z, y, p = _inputs(16, 50, seed=5)
    zt, yt, pt = map(torch.from_numpy, (z, y, p))
    for t in range(6):
        np.testing.assert_array_equal(
            tdistill.lam_schedule(t, 0.5, 4).numpy(),
            np.asarray(jdistill.lam_schedule(t, 0.5, 4)))
    assert float(tdistill.lam_schedule(3, 0.5, 0)) == 0.0
    lam = tdistill.lam_schedule(1, 0.5, 4)
    np.testing.assert_allclose(
        float(tdistill.mixed_ce(zt, yt, pt, lam)),
        float(jdistill.mixed_ce(z, y, p, np.float32(lam), impl="jnp")),
        rtol=1e-5)
    np.testing.assert_allclose(float(tdistill.mixed_ce(zt, yt, None, lam)),
                               float(jdistill.true_ce(z, y)), rtol=1e-6)
    np.testing.assert_allclose(float(tdistill.pseudo_ce_dense(zt, pt)),
                               float(jdistill.pseudo_ce_dense(z, p)),
                               rtol=1e-6)
    mask = (np.arange(16) % 3 != 0).astype(np.float32)
    np.testing.assert_allclose(
        float(tdistill.true_ce(zt, yt, torch.from_numpy(mask))),
        float(jdistill.true_ce(z, y, mask)), rtol=1e-6)
    with pytest.raises(TypeError, match="compression.TopM"):
        tdistill.mixed_ce(zt, yt, (pt, yt), lam)


@pytest.mark.parametrize("img", [8, 16, 32])
def test_nin_apply_matches_jax(img):
    """The SAME padding of the 3x3 stride-2 pools (0 before, 1 after)
    decides every pooled pixel: any other padding fails this."""
    K, B = 2, 3
    jp = jax.vmap(lambda k: jcnn.nin_init(k, n_classes=10,
                                          width_mult=0.25))(
        jax.random.split(jax.random.PRNGKey(img), K))
    for k in jp:  # nonzero biases, so a misplaced bias shows
        if k.startswith("bias"):
            jp[k] = jax.random.normal(jax.random.PRNGKey(1), jp[k].shape)
    x = np.random.default_rng(img).standard_normal(
        (K, B, img, img, 3)).astype(np.float32)
    want = jax.vmap(jcnn.nin_apply)(jp, x)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    got = tcnn.nin_apply(tp, torch.from_numpy(x))
    assert got.shape == (K, B, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    labels = np.random.default_rng(0).integers(0, 10, (K, B))
    jl = jax.vmap(lambda q, a, b: jcnn.nin_loss(
        q, {"images": a, "labels": b})[0])(jp, x, labels)
    tl, _ = tcnn.nin_loss(tp, {"images": torch.from_numpy(x),
                               "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_nin_init_shapes_and_scales_match_jax():
    jp = jcnn.nin_init(jax.random.PRNGKey(0), n_classes=100)
    tp = tcnn.nin_init(n_classes=100, seed=0, device="cpu", members=3)
    assert list(tp) == list(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3, *v.shape)
        np.testing.assert_allclose(float(tp[k].std()), float(jnp.std(v)),
                                   rtol=0.1, atol=1e-6)


def test_ensemble_maths_match_jax():
    rng = np.random.default_rng(7)
    lg = (rng.standard_normal((4, 6, 5, 11)) * 2).astype(np.float32)
    y = rng.integers(0, 11, (6, 5))
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    t = torch.from_numpy(lg)
    for weights in (None, w):
        tw = None if weights is None else torch.from_numpy(weights)
        for avg in (True, False):
            np.testing.assert_allclose(
                tens.ensemble_probs(t, tw, avg).numpy(),
                np.asarray(jens.ensemble_probs(lg, weights, avg)),
                rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            float(tens.ensemble_nll(t, torch.from_numpy(y), tw)),
            float(jens.ensemble_nll(lg, y, weights)), rtol=1e-6)
        params = {"a": rng.standard_normal((4, 3, 2)).astype(np.float32),
                  "b": [rng.standard_normal((4, 5)).astype(np.float32)]}
        got = tens.ma_average(params_from_numpy(params, "cpu"), tw)
        want = jens.ma_average(params, weights)
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["b"][0].numpy(),
                                   np.asarray(want["b"][0]), rtol=1e-6)
    np.testing.assert_allclose(
        float(tens.mean_member_nll(t, torch.from_numpy(y))),
        float(jens.mean_member_nll(lg, y)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tens.jensen_gap(t, torch.from_numpy(y))),
        float(jens.jensen_gap(lg, y)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", range(8))
def test_jensen_gap_is_never_negative(seed):
    """Paper Eqns 4-5: the ensemble's NLL never exceeds the members'
    mean (tests/test_guarantee.py checks the JAX side)."""
    rng = np.random.default_rng(seed)
    K = int(rng.integers(1, 6))
    scale = float(rng.choice([0.1, 1.0, 10.0]))
    lg = torch.from_numpy(
        (rng.standard_normal((K, 9, 13)) * scale).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 13, 9))
    assert float(tens.jensen_gap(lg, y)) >= -1e-6
