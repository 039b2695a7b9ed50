"""The port's top-M accumulators, top-M distillation loss, AdamW,
schedules and gradient compression against the JAX package, on the CPU.

The same numpy inputs go through both packages.  Tolerances: integer
outputs exact; f32 within 1e-6 (TopM, the schedules, the gradient
tools; 2e-5 for the losses, the JAX kernel tests' f32 tolerance); AdamW
within 1e-6 over four steps with f32 moments (the same f32 operations
in another order) and 2e-6 with bf16 moments (where one step's f32
rounding can flip a moment's bf16 rounding, a 2^-9 relative change in
one moment).  Inputs are drawn from continuous distributions, so no two
values tie: torch.topk promises no order among ties, jax.lax.top_k
takes the lower index first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.core import compression as jcomp
from repro.core import distill as jdistill
from repro.optim import compression as jgc
from repro_torch import optim as toptim
from repro_torch.core import compression as tcomp
from repro_torch.core import distill as tdistill
from repro_torch.optim import compression as tgc
from repro_torch.optim import optimizers as topt_mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these shapes it is the fastest even
    alone, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=1e-6, atol=1e-6)


def _probs(rng, shape, vocab, scale=3.0):
    z = rng.standard_normal(shape + (vocab,)) * scale
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _both(fn_j, fn_t, *args):
    return fn_j(*args), fn_t(*(_t(a) for a in args))


def _same_topm(got, want, **tol):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **(tol or F32))
    np.testing.assert_allclose(got.rest.numpy(), np.asarray(want.rest),
                               **(tol or F32))


def _topm_t(t):
    return tcomp.TopM(*(_t(x) for x in t))


# ---------------------------------------------------------------------------
# core/compression: TopM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 5, 16])
def test_from_dense_matches_jax(m):
    p = _probs(np.random.default_rng(m), (3, 4), 16)
    want = jcomp.from_dense(jnp.asarray(p), m)
    got = tcomp.from_dense(_t(p), m)
    assert got.vals.dtype == torch.float32 and got.idx.dtype == torch.int32
    _same_topm(got, want)
    np.testing.assert_allclose(
        tcomp.to_dense(got, 16).numpy(),
        np.asarray(jcomp.to_dense(want, 16)), **F32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_matches_jax(seed):
    """Overlapping classes (duplicates combined), padding entries from
    zeros() and rows where fewer than M candidates are positive."""
    rng = np.random.default_rng(seed)
    V, m = 12, 5
    a = jcomp.from_dense(jnp.asarray(_probs(rng, (4,), V)), m)
    b = jcomp.from_dense(jnp.asarray(_probs(rng, (4,), V, 1.0)), m)
    pad = jcomp.zeros((4,), m)
    for x, y in ((a, b), (b, a), (a, pad), (pad, pad)):
        want = jcomp.merge(x, y)
        got = tcomp.merge(_topm_t(x), _topm_t(y))
        _same_topm(got, want)
    empty = tcomp.zeros((4,), m)
    _same_topm(empty, pad)


def test_merge_chain_conserves_mass_and_keeps_its_bound():
    """A K-way chain against JAX's, its kept + rest equal to the total
    mass, and its L1 error against the dense sum within l1_error_bound."""
    rng = np.random.default_rng(7)
    V, m, K = 40, 6, 4
    dense = [_probs(rng, (3,), V) for _ in range(K)]
    jacc = jcomp.from_dense(jnp.asarray(dense[0]), m)
    tacc = tcomp.from_dense(_t(dense[0]), m)
    for d in dense[1:]:
        jacc = jcomp.merge(jacc, jcomp.from_dense(jnp.asarray(d), m))
        tacc = tcomp.merge(tacc, tcomp.from_dense(_t(d), m))
    _same_topm(tacc, jacc)
    total = (tacc.vals.sum(-1) + tacc.rest).numpy()
    np.testing.assert_allclose(total, float(K), atol=1e-5)
    l1 = (tcomp.to_dense(tacc, V) - _t(sum(dense))).abs().sum(-1)
    assert (l1 <= tcomp.l1_error_bound(tacc) + 1e-5).all()


def test_scale_normalize_and_sizes_match_jax():
    """Rows of mass 7: `rest` is a difference of two sums of that size,
    so its f32 rounding is 1e-6 of the mass (atol 7e-6)."""
    p = _probs(np.random.default_rng(3), (5,), 32) * 7.0
    tol = dict(rtol=1e-6, atol=7e-6)
    jt = jcomp.from_dense(jnp.asarray(p), 8)
    tt = tcomp.from_dense(_t(p), 8)
    _same_topm(tt, jt, **tol)
    _same_topm(tcomp.normalize(tt), jcomp.normalize(jt))
    _same_topm(tcomp.scale(tt, 0.25), jcomp.scale(jt, 0.25), **tol)
    n = tcomp.normalize(tt)
    np.testing.assert_allclose((n.vals.sum(-1) + n.rest).numpy(), 1.0,
                               atol=1e-6)
    np.testing.assert_allclose(
        tcomp.to_dense(tt, 32, spread_rest=True).numpy(),
        np.asarray(jcomp.to_dense(jt, 32, spread_rest=True)), **tol)
    np.testing.assert_allclose(tcomp.l1_error_bound(tt).numpy(),
                               np.asarray(jcomp.l1_error_bound(jt)), **tol)
    assert tcomp.bytes_per_token(64) == jcomp.bytes_per_token(64)


# ---------------------------------------------------------------------------
# core/distill: the top-M CE and both branches of mixed_ce
# ---------------------------------------------------------------------------

LOSS = dict(rtol=2e-5, atol=2e-5)


def _loss_inputs(n=24, v=300, m=7, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    y = rng.integers(0, v, n).astype(np.int32)
    p = _probs(rng, (n,), v)
    t = jcomp.merge(jcomp.from_dense(jnp.asarray(p), m),
                    jcomp.zeros((n,), m))
    return z, y, p, t


def test_pseudo_ce_topm_matches_jax():
    z, _, _, t = _loss_inputs()
    want, gwant = jax.value_and_grad(
        lambda a: jdistill.pseudo_ce_topm(a, t))(jnp.asarray(z))
    zt = _t(z).requires_grad_()
    got = tdistill.pseudo_ce_topm(zt, _topm_t(t))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gwant), **LOSS)


@pytest.mark.parametrize("branch", ["none", "dense", "topk"])
def test_mixed_ce_matches_jax(branch):
    z, y, p, t = _loss_inputs(seed=1)
    pseudo = {"none": (None, None), "dense": (jnp.asarray(p), _t(p)),
              "topk": (t, _topm_t(t))}[branch]
    want, gwant = jax.value_and_grad(
        lambda a: jdistill.mixed_ce(a, jnp.asarray(y), pseudo[0],
                                    jnp.float32(0.375)))(jnp.asarray(z))
    zt = _t(z).requires_grad_()
    got = tdistill.mixed_ce(zt, _t(y), pseudo[1], torch.tensor(0.375))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gwant), **LOSS)


# ---------------------------------------------------------------------------
# optim: schedules, AdamW, gradient compression
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant": lambda m: m.constant(3e-3),
    "cosine_decay": lambda m: m.cosine_decay(1e-2, 20, final_frac=0.1),
    "linear_warmup_cosine": lambda m: m.linear_warmup_cosine(
        1e-2, warmup=5, total_steps=30, final_frac=0.05),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    jfn, tfn = SCHEDULES[name](joptim), SCHEDULES[name](toptim)
    steps = np.arange(0, 40, dtype=np.int32)
    want = np.stack([np.asarray(jfn(jnp.asarray(s))) for s in steps])
    got = tfn(torch.from_numpy(steps).reshape(4, 10))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, **F32)


def _adam_tree(rng, K):
    return {"w": rng.standard_normal((K, 6, 5)).astype(np.float32),
            "seg": [{"b": rng.standard_normal((K, 3, 7)).astype(np.float32)}]}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("one_pass", ["whole_leaf", "member_by_member",
                                      "in_pieces"])
def test_adamw_matches_jax_in_place(monkeypatch, moments, one_pass):
    """Four steps under a warm-up schedule, member 0's gradients above
    the clip norm and member 1's below it; the params and moments the
    update writes are the tensors it was given.  `in_pieces` cuts each
    member's slice into pieces of 4 elements (the clip's norms too)."""
    if one_pass != "whole_leaf":
        monkeypatch.setattr(topt_mod, "_ONE_PASS", 0)
    if one_pass == "in_pieces":
        monkeypatch.setattr(topt_mod, "_PIECE", 4)
    rng = np.random.default_rng(0)
    K = 2
    params = _adam_tree(rng, K)
    lr = SCHEDULES["linear_warmup_cosine"]
    jopt = joptim.adamw(lr(joptim), clip_norm=2.0,
                        moment_dtype=getattr(jnp, moments))
    topt = toptim.adamw(lr(toptim), clip_norm=2.0,
                        moment_dtype=getattr(torch, moments))
    jp, js = params, jax.vmap(jopt.init)(params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = topt.init(tp)
    ptrs = [x.data_ptr() for x in jax.tree.leaves((tp, ts["m"], ts["v"]))]
    tol = F32 if moments == "float32" else dict(rtol=2e-6, atol=2e-6)
    for i in range(4):
        g = _adam_tree(rng, K)
        g = jax.tree.map(lambda a: a * np.float32([3.0, 0.1]).reshape(
            (2,) + (1,) * (a.ndim - 1)), g)
        jp, js = jax.vmap(jopt.update)(g, js, jp)
        tp2, ts2 = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        assert tp2 is tp and ts2 is ts
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    assert ts["m"]["w"].dtype == getattr(torch, moments)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(ts[key]), jax.tree.leaves(js[key])):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)
    np.testing.assert_array_equal(ts["step"].numpy(), np.asarray(js["step"]))
    assert [x.data_ptr() for x in jax.tree.leaves(
        (tp, ts["m"], ts["v"]))] == ptrs


def test_adamw_clip_and_decay_alone_match_jax():
    """No gradient: pure weight decay at a float lr, per member."""
    p = {"w": np.ones((3, 4), np.float32)}
    g = {"w": np.zeros((3, 4), np.float32)}
    jopt, topt = joptim.adamw(1e-2), toptim.adamw(1e-2)
    want, _ = jax.vmap(jopt.update)(g, jax.vmap(jopt.init)(p), p)
    tp = {"w": torch.ones(3, 4)}
    topt.update({"w": torch.zeros(3, 4)}, topt.init(tp), tp)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(want["w"]),
                               **F32)
    assert float(tp["w"].max()) < 1.0


def test_gradient_compression_matches_jax():
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((40,)).astype(np.float32),
             "b": [rng.standard_normal((8, 9)).astype(np.float32)]}
    res = {"a": rng.standard_normal((40,)).astype(np.float32) * 0.1,
           "b": [rng.standard_normal((8, 9)).astype(np.float32) * 0.1]}
    tg, tr = (jax.tree.map(torch.from_numpy, x) for x in (grads, res))
    (js, jr), (ts, tres) = (jgc.topk_compress_with_feedback(grads, res, 0.1),
                            tgc.topk_compress_with_feedback(tg, tr, 0.1))
    for a, b in zip(jax.tree.leaves((ts, tres)), jax.tree.leaves((js, jr))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    for s, r, g, r0 in zip(*(jax.tree.leaves(x) for x in (ts, tres, tg, tr))):
        torch.testing.assert_close(s + r, g + r0)      # nothing lost
    x = grads["b"][0] * 3
    (jq, jsc), (tq, tsc) = _both(jgc.int8_quantize, tgc.int8_quantize, x)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), **F32)
    np.testing.assert_allclose(
        tgc.int8_dequantize(tq, tsc).numpy(),
        np.asarray(jgc.int8_dequantize(jq, jsc)), **F32)
    zeros = tgc.init_residuals(tg)
    assert all(z.dtype == torch.float32 and not z.any()
               for z in jax.tree.leaves(zeros))
    assert jax.tree.structure(jax.tree.map(np.asarray, jgc.init_residuals(
        grads))) == jax.tree.structure(jax.tree.map(
            lambda z: z.numpy(), zeros))
