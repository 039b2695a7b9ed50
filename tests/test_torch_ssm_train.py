"""The port's EC-DNN training of the recurrent families against the JAX
package's, on the CPU: rwkv6-7b (`ssm`) and jamba (`hybrid`).

Reduced rwkv6-7b (3 layers) and reduced jamba cut to its first 4 layers
(Mamba-dense, Mamba-MoE, Mamba-dense, attention-MoE: all three mixers
and the MoE layer train), f32, K = 2, in tests/test_torch_lm_train.py's
setup: 32 sequences of 16 tokens a member, batch 4, tau 3, p 2, relabel
50%, AdamW 1e-3, the JAX init and the same numpy shards and sampling
seed on both sides.  Tolerances as there: losses and evaluate() rtol
1e-4 over two rounds, gradients rtol 1e-4 / atol 1e-6 (f32 sums in
another order; the JAX package scans Mamba associatively, the port
step by step).  Weights are not compared after AdamW steps
(test_torch_lm_train.py's docstring says why).

Reduced rwkv6-7b at the JAX init is ill-conditioned in f32: some heads'
group-norm variance is ~3e-6, below its eps 1e-5, so (y - mean) keeps
few of y's bits.  The port's own two f32 routes (the chunked recurrence,
and ref.wkv6's step loop in its place) disagree by up to 2e-4 of a
leaf's largest gradient and 5e-4 in a loss after two rounds.  So each
comparison here widens its tolerance to twice that measured
disagreement where it is larger than the fixed one (`_self_gap`): the
port must agree with the JAX package as closely as it agrees with
itself.  The disagreement itself is held below a fixed ceiling
(GAP_CEILING, about twice or more the largest measured: 5.8e-5 of a
leaf's largest gradient, 5.2e-4 of a loss or metric, 1.4e-3 in a
pseudo-label), so no tolerance here passes twice the ceiling.

The port trains through the recurrences' chunked plain forms
(models/ssm._wkv_chunked, _mamba_chunked), never through ops.wkv6 or
ops.ssm_scan, whose CUDA kernels are forward-only: here the plain
versions behind ops would differentiate, so the tests patch ops to fail
inside training and count its calls in the relabel and evaluate().
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import ECConfig as JEC
from repro.configs import registry as jregistry
from repro.core import aggregation as jagg
from repro.data import lm_member_datasets as jdata
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.common.types import ECConfig as TEC
from repro_torch.configs import registry as tregistry
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.trainer import Trainer as TTrainer

K = 2
TOL = dict(rtol=1e-4, atol=1e-6)
PSEUDO = dict(rtol=1e-4, atol=1e-5)
# the most the port's two f32 routes may disagree (module docstring):
# of a leaf's largest gradient, relative in a loss or metric, absolute
# in a pseudo-label
GAP_CEILING = dict(grad=2e-4, loss=1e-3, pseudo=3e-3)
RWKV, JAMBA = "rwkv6-7b", "jamba-v0.1-52b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these shapes it is the fastest even
    alone, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """f32 reduced configs; jamba cut to its first 4 layers."""
    cut = dict(n_layers=4) if arch == JAMBA else {}
    return tuple(reg.get_config(arch, reduced=True).with_(dtype="float32",
                                                          **cut)
                 for reg in (jregistry, tregistry))


def _torch(tree):
    return params_from_numpy(tree, "cpu")


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **{**TOL, **kw})


def _ec(mod, aggr="ec", mode="dense"):
    return mod(tau=3, lam=0.5, p_steps=2, relabel_fraction=0.5,
               label_mode=mode, aggregator=aggr, top_m=8)


@pytest.fixture(scope="module")
def shards():
    train, test = jdata(jax.random.PRNGKey(0), K, per_member=32, seq_len=16,
                        vocab=512)
    return jax.device_get(train), jax.device_get(test)


@pytest.fixture(scope="module")
def jax_trainers(shards):
    """arch -> (a JAX Trainer (its steps compiled once for the module),
    its initial state fetched to numpy): each test resets the trainer to
    that state, as the JAX steps donate it."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, _ = _cfgs(arch)
            jtr = JTrainer(jcfg, _ec(JEC), jadamw(1e-3), K,
                           jax.random.PRNGKey(0), *shards, batch_size=4,
                           seed=2)
            cache[arch] = jtr, jax.device_get(jtr.state)
        return cache[arch]
    return get


def _init(jax_trainers, arch):
    """The JAX init of `arch`'s reduced config (K members), numpy."""
    return jax_trainers(arch)[1]["params"]


def _count_ops(monkeypatch):
    """ops.wkv6 and ops.ssm_scan counted, and failing where grad mode is
    on (a training step), as the card's kernels refuse inputs that
    require grad.  -> the counts."""
    calls = {"wkv6": 0, "ssm_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def shim(*a, _name=name, _real=real):
            if torch.is_grad_enabled():
                raise AssertionError(f"ops.{_name} on the training route")
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(ops, name, shim)
    return calls


# ---------------------------------------------------------------------------
# the two recurrences' training routes
# ---------------------------------------------------------------------------

def _grads_both(jfn, tfn, args):
    """Value and gradients of jfn (JAX) and tfn (port) at numpy args."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(*args)
    tt = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    tv = tfn(*tt)
    return (float(jv), jg), (float(tv.detach()),
                             torch.autograd.grad(tv, tt))


@pytest.mark.parametrize("T", [45, 64])
def test_wkv_chunked_matches_jax(T):
    """Values and gradients of the port's _wkv_chunked against JAX's at T
    not a multiple of the 32-token chunk (45) and a multiple, from a
    nonzero state, decays from -e^-3 to -e^2 a token."""
    rng = np.random.default_rng(T)
    B, H, dh = 2, 2, 8
    r, k, v = (rng.standard_normal((B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.standard_normal((B, T, H, dh)).clip(-3, 2))
    u = rng.standard_normal((H, dh)) * 0.5
    s0 = rng.standard_normal((B, H, dh, dh)) * 0.1
    args = [a.astype(np.float32) for a in (r, k, v, lw, u, s0)]
    w = rng.standard_normal((B, T, H, dh)).astype(np.float32)

    def loss(mod, lib):
        def f(*a):
            y, s = mod._wkv_chunked(*a)
            return (y * lib(w)).sum() + (s * s).sum()
        return f
    (jv, jg), (tv, tg) = _grads_both(loss(jssm, jnp.asarray),
                                     loss(tssm, torch.from_numpy), args)
    _close(tv, jv)
    for a, b in zip(tg, jg):
        _close(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def _wkv_steps64(r, k, v, log_w, u, s0):
    """The recurrence token by token in float64 (ref.wkv6's, which
    computes in f32): y_t = r_t (S + u k_t^T v_t), S <- w_t S + k_t^T v_t.
    """
    S, ys = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("nhk,nhkv->nhv", r[:, t],
                               S + u[..., None] * kv))
        S = S * torch.exp(log_w[:, t])[..., None] + kv
    return torch.stack(ys, 1), S


@pytest.mark.parametrize("log_w", [-3.0, -float(np.exp(4.0))])
def test_wkv_chunked_gradient_at_strong_decays(log_w):
    """A constant log w a token of -3 and of -e^4 (the models' clamp):
    within a 32-token chunk the masked pairs' exponent passes 88.  The
    port masks before the exponential: its gradient is finite and equals
    the float64 step loop's.  The JAX package's _wkv_chunked gives the
    right values but a NaN grad of log w there (ROADMAP queue 3, the
    reference's NaN gradient at strong decays); it is left in the
    reference."""
    rng = np.random.default_rng(7)
    B, T, H, dh = 1, 32, 2, 8
    r, k, v = (rng.standard_normal((B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    lw = np.full((B, T, H, dh), log_w, np.float32)
    u = (rng.standard_normal((H, dh)) * 0.5).astype(np.float32)
    s0 = np.zeros((B, H, dh, dh), np.float32)
    args = (r, k, v, lw, u, s0)

    def jloss(*a):
        y, s = jssm._wkv_chunked(*a)
        return (y * y).sum() + s.sum()
    jg = jax.grad(jloss, argnums=(0, 3))(*args)
    assert np.isfinite(np.asarray(jg[0])).all()          # grad r
    assert np.isnan(np.asarray(jg[1])).any()             # grad log w

    def grads(fn, dtype):
        tt = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
        y, s = fn(*tt)
        return torch.autograd.grad((y * y).sum() + s.sum(), tt)
    want = grads(_wkv_steps64, torch.float64)
    scale = max(float(w.abs().max()) for w in want)
    # in float64 the chunked form is the step loop's to rounding (at
    # -e^4 a chunk's log w sums to -1747: unmasked, exp overflows even
    # there); in f32 it is finite, and within f32 rounding of the loss's
    # gradients: the cumsum's backward adds terms of their size that
    # cancel (grad log w is ~1e-22 at -e^4 in exact arithmetic)
    for dtype, tol in ((torch.float64, dict(rtol=1e-10, atol=1e-12 * scale)),
                       (torch.float32, dict(rtol=1e-4, atol=1e-5 * scale))):
        for g, w in zip(grads(tssm._wkv_chunked, dtype), want):
            assert torch.isfinite(g).all()
            _close(g.double().numpy(), w.numpy(), **tol)


@pytest.mark.parametrize("chunk", [128, 16])
def test_mamba_chunked_matches_jax(monkeypatch, jax_trainers, chunk):
    """The port's _mamba_chunked against JAX's _mamba_inner (vmapped
    over members), values and gradients of every input and scan param,
    T = 45 from a nonzero state: one chunk, and three of 16 (both sides'
    MAMBA_CHUNK patched) with a short last one."""
    for mod in (jssm, tssm):
        monkeypatch.setattr(mod, "MAMBA_CHUNK", chunk)
    jcfg, tcfg = _cfgs(JAMBA)
    blk = jax.tree.map(lambda a: a[:, 0], _init(jax_trainers, JAMBA)[
        "segments"][0]["slot_0"]["mamba"])
    names = ["mamba_A_log", "mamba_D", "mamba_dt_b", "mamba_dt_w",
             "mamba_dt_x"]
    rng = np.random.default_rng(chunk)
    d_inner, _ = jssm.mamba_dims(jcfg)
    xz = rng.standard_normal((K, 2, 45, d_inner)).astype(np.float32)
    h0 = (rng.standard_normal((K, 2, d_inner, jcfg.ssm.d_state)) * 0.3
          ).astype(np.float32)
    w = rng.standard_normal(xz.shape).astype(np.float32)

    def jloss(*a):
        p = dict(zip(names, a[:-2]))
        y, h = jax.vmap(lambda p, x, c: jssm._mamba_inner(p, x, jcfg, c))(
            p, a[-2], a[-1])
        return (y * w).sum() + (h * h).sum()

    def tloss(*a):
        y, h = tssm._mamba_chunked(dict(zip(names, a[:-2])), a[-2], tcfg,
                                   a[-1])
        return (y * torch.from_numpy(w)).sum() + (h * h).sum()
    (jv, jg), (tv, tg) = _grads_both(
        jloss, tloss, [np.asarray(blk[n]) for n in names] + [xz, h0])
    _close(tv, jv)
    for name, a, b in zip(names + ["xz", "h0"], tg, jg):
        _close(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max(),
               err_msg=name)


@pytest.mark.parametrize("case", ["jamba", "overflow"])
def test_moe_aux_and_gradients_match(jax_trainers, case):
    """Jamba's MoE layer (reduced: 4 experts, top-2, capacity factor
    1.25, aux coefficient 0.01) on one pool of T tokens a member: its
    output, its aux loss and the gradients of both (router, experts and
    input) against jax.grad of the JAX moe_apply.  `overflow` biases the
    router toward expert 0 (tests/test_torch_jamba.py's case): 100
    tokens, capacity max(int(100*2*1.25/4), min(200, 64)) = 64 on both
    sides, and expert 0 drops every assignment past its 64th."""
    jcfg, tcfg = _cfgs(JAMBA)
    blk = jax.tree.map(lambda a: np.array(a[:, 0]), _init(
        jax_trainers, JAMBA)["segments"][0]["slot_1"]["moe"])
    T = 100 if case == "overflow" else 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((K, T, jcfg.d_model)).astype(np.float32)
    if case == "overflow":
        x[..., 0] = 4.0
        blk["router"][:, 0, 0] = 1.0
    w = rng.standard_normal(x.shape).astype(np.float32)
    names = sorted(blk)
    f = jcfg.ffn

    def jloss(*a):
        p = dict(zip(names, a[:-1]))
        y, aux = jax.vmap(lambda p, xx: jmoe.moe_apply(p, xx[None], f))(
            p, a[-1])
        return (y[:, 0] * w).sum() + 100.0 * aux.sum()

    def tloss(*a):
        y, aux = tmoe.moe_apply(dict(zip(names, a[:-1])), a[-1][:, None],
                                tcfg.ffn)
        return (y[:, 0] * torch.from_numpy(w)).sum() + 100.0 * aux.sum()
    (jv, jg), (tv, tg) = _grads_both(
        jloss, tloss, [np.asarray(blk[n]) for n in names] + [x])
    _close(tv, jv)
    # f32 sums over the pool's tokens of O(1) terms in another order:
    # atol 1e-6 of each gradient's largest entry
    for name, a, b in zip(names + ["x"], tg, jg):
        _close(a.numpy(), b, atol=1e-6 * np.abs(b).max(), err_msg=name)
    tp = {n: torch.from_numpy(np.asarray(blk[n])) for n in names}
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    top = probs.topk(3, -1).values
    assert float((top[..., 1] - top[..., 2]).min()) > 1e-6  # no tie
    _, ids, aux = tmoe._route(tp["router"], torch.from_numpy(x)[:, None],
                              f.top_k)
    if case == "overflow":
        assert bool(((ids == 0).sum((2, 3)) > 64).all())    # both drop


# ---------------------------------------------------------------------------
# one step's gradients, and the bf16-moment AdamW
# ---------------------------------------------------------------------------

def _step_inputs(jax_trainers, arch, seed):
    jcfg, _ = _cfgs(arch)
    params = _init(jax_trainers, arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (K, 4, 17)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    e = np.exp(rng.standard_normal((K, 4, 16, jcfg.vocab_size)) * 2)
    pseudo = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return params, batch, pseudo


def _plain_route(monkeypatch):
    """The port's second f32 route: the training route with rwkv's
    chunked recurrence replaced by ref.wkv6's step loop (the wkv6
    kernel's plain version), which autograd differentiates.  Jamba's
    Mamba route is left as it is: reduced jamba is well conditioned."""
    monkeypatch.setattr(tssm, "_wkv_chunked", ref.wkv6)


def _self_gap(got, alt, fixed, ceiling):
    """max(fixed, twice the largest |got - alt|): a tolerance no tighter
    than the port's two f32 routes' own disagreement allows.  That
    disagreement must not pass `ceiling`."""
    gap = float(np.max(np.abs(np.asarray(got) - np.asarray(alt))))
    assert gap <= ceiling, f"the two f32 routes differ by {gap} > {ceiling}"
    return max(fixed, 2 * gap)


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_member_grads_match_jax(monkeypatch, jax_trainers, arch):
    """make_member_grads (dense pseudo-labels, lambda 0.375) against
    jax.value_and_grad of the JAX member loss, vmapped over members; the
    jamba loss holds its MoE aux loss.  ops.wkv6 / ops.ssm_scan fail if
    the step reaches them.  atol per leaf: 1e-6 or 1e-5 of its largest
    gradient (f32 sums over the step's tokens in another order), or
    twice the gap to the port's step-loop route (reduced rwkv6-7b's:
    module docstring)."""
    jcfg, tcfg = _cfgs(arch)
    params, batch, pseudo = _step_inputs(jax_trainers, arch, 3)
    lam = np.float32(0.375)
    jloss, jgrads = jax.jit(jax.vmap(
        lambda p, b, ps: jsteps.make_member_grads(jcfg)(p, b, ps, lam)))(
        params, batch, pseudo)

    def port_grads():
        tparams = jax.tree.map(lambda a: a.requires_grad_(), _torch(params))
        loss, grads = tsteps.make_member_grads(tcfg)(
            tparams, _torch(batch), torch.from_numpy(pseudo),
            torch.tensor(0.375))
        return float(loss), jax.tree.leaves(grads)
    with monkeypatch.context() as m:
        _plain_route(m)
        _, alt = port_grads()
    calls = _count_ops(monkeypatch)
    tloss, tgrads = port_grads()
    assert calls == {"wkv6": 0, "ssm_scan": 0}
    _close(tloss, float(np.sum(jloss)))
    jl = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jl) == len(tgrads)
    for (path, b), a, c in zip(jl, tgrads, alt):
        top = np.abs(b).max()
        _close(a.numpy(), b, atol=_self_gap(
            a, c, max(1e-6, 1e-5 * top),
            max(1e-6, GAP_CEILING["grad"] * top)),
            err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

CASES = {  # name: (arch, aggregator, label_mode)
    "rwkv_ec_dense": (RWKV, "ec", "dense"),
    "jamba_ec_dense": (JAMBA, "ec", "dense"),
    "rwkv_ec_topk": (RWKV, "ec", "topk"),
    "jamba_ma": (JAMBA, "ma", "dense"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rounds_match_jax_trainer(monkeypatch, shards, jax_trainers, name):
    """Two rounds: round 0 trains plainly and aggregates; round 1 opens
    (ec) with two distill steps on its pseudo-labels.  Losses and
    evaluate() within rtol 1e-4, or twice their gap to the same port
    trainer run through its step-loop route (module docstring).  The
    pseudo-labels too: jamba's tell whether each member's relabel batch
    is its own MoE pool, as in the JAX package."""
    arch, aggr, mode = CASES[name]
    jcfg, tcfg = _cfgs(arch)
    train, test = shards
    jtr, init = jax_trainers(arch)
    jtr.ec, jtr.state = _ec(JEC, aggr, mode), jax.tree.map(jnp.array, init)
    jtr.rng, jtr.pseudo_buffer, jtr.round = np.random.default_rng(2), None, 0
    p0 = init["params"]

    def port():
        tr = TTrainer(tcfg, _ec(TEC, aggr, mode), tadamw(1e-3), K, 0,
                      _torch(train), _torch(test), batch_size=4, seed=2,
                      params=p0, device="cpu")
        vals = []
        for _ in range(2):
            vals.append(tr.run_round())
            ev = tr.evaluate()
            vals += [ev[k] for k in sorted(ev)]
            if aggr == "ec":                               # Jensen
                assert ev["global_loss"] <= ev["local_loss"] + 1e-6
        return np.array(vals), tr
    got, ttr = port()
    alt, alt_tr = got, ttr
    if arch == RWKV:
        with monkeypatch.context() as m:
            _plain_route(m)
            alt, alt_tr = port()
    want = []
    for _ in range(2):
        want.append(jtr.run_round())
        ev = jtr.evaluate()
        want += [ev[k] for k in sorted(ev)]
    rel = _self_gap(np.abs(got - alt) / np.abs(alt).clip(1e-30), 0, 1e-4,
                    GAP_CEILING["loss"])
    _close(got, want, rtol=rel)
    if aggr != "ec":
        return
    jps, tps, aps = (t.pseudo_buffer[1] for t in (jtr, ttr, alt_tr))
    if mode == "topk":
        assert isinstance(tps, tcomp.TopM)
        for f in ("vals", "rest"):
            a = getattr(tps, f).numpy()
            _close(a, getattr(jps, f), rtol=1e-4,
                   atol=_self_gap(a, getattr(aps, f).numpy(), 1e-5,
                                  GAP_CEILING["pseudo"]))
    else:
        got, want = tps.numpy(), np.asarray(jps)
        atol = _self_gap(got, aps.numpy(), 1e-5, GAP_CEILING["pseudo"])
        if arch == JAMBA:
            # the relabel itself is exact: at the JAX trainer's params the
            # port's pseudo-labels are the JAX package's (each member's
            # batch its own MoE pool)
            subset = jax.device_get(jtr.pseudo_buffer[0])
            at_jax = tagg.allgather_relabel(
                _torch(jax.device_get(jtr.state["params"])),
                _torch(subset), tsteps.make_logits_fn(tcfg), _ec(TEC),
                n_out=tcfg.vocab_size, pooled=True)
            _close(at_jax.numpy(), want, **PSEUDO)
            # the trained ones: AdamW's first step moves a weight whose
            # gradient is within rounding of 0 by +-lr either way (here an
            # embedding entry ends 2.8e-3 apart), and the recurrence
            # carries that token's change to the later positions of its
            # sequence: all but a few token rows hold
            ok = np.isclose(got, want, rtol=1e-4, atol=atol).all(-1)
            assert ok.mean() >= 0.95, (ok.size - ok.sum(), ok.size)
            got, want = got[ok], want[ok]
        _close(got, want, rtol=1e-4, atol=atol)


def _layers(cfg, mixer):
    return sum(count * sum(s.mixer == mixer for s in specs)
               for count, specs in cfg.segments())


@pytest.mark.parametrize("arch", [RWKV, JAMBA])
def test_training_route_skips_the_recurrence_kernels(shards, arch,
                                                     monkeypatch):
    """A plain and a distill step never call ops.wkv6 / ops.ssm_scan
    (they would fail); a relabel calls them once per layer, member,
    chunk of rows and (ssm_scan) MAMBA_CHUNK piece, evaluate() once per
    layer and piece (K members folded into one call)."""
    _, tcfg = _cfgs(arch)
    counted = _count_ops(monkeypatch)
    monkeypatch.setattr(tagg, "CHUNK_BYTES", 4 * 16 * 512 * 10)  # 10 rows
    train, test = shards
    tr = TTrainer(tcfg, _ec(TEC), tadamw(1e-3), K, 0, _torch(train),
                  _torch(test), batch_size=4, seed=1, device="cpu")
    tr.run_round()              # tau plain steps, then a relabel
    counted.update(wkv6=0, ssm_scan=0)
    tr.run_round()              # two distill steps and a plain one
    name, mixer = ("wkv6", "rwkv") if arch == RWKV else ("ssm_scan",
                                                         "mamba")
    per_call = _layers(tcfg, mixer)            # one 16-token piece
    # the relabel scores the K batches of 16 sequences concatenated,
    # member by member: rwkv in 4 chunks of 10 rows; jamba's MoE pools
    # each batch, whose 16 rows do not fit a chunk: pieces of 10 and 6
    # rows carrying the arrival counts, 4 chunks too
    assert counted[name] == per_call * K * 4
    counted.update(wkv6=0, ssm_scan=0)
    tr.evaluate()
    # the 32 test sequences: K members' 64 rows do not fit, 4 chunks
    assert counted[name] == per_call * K * 4
    # chunks of 64 rows: the relabel's 32 in one chunk, member by member,
    # and the eval's K members in one call
    monkeypatch.setattr(tagg, "CHUNK_BYTES", 4 * 16 * 512 * K * 32)
    counted.update(wkv6=0, ssm_scan=0)
    tr._relabel()
    assert counted[name] == per_call * K
    counted.update(wkv6=0, ssm_scan=0)
    tr.evaluate()
    assert counted[name] == per_call
    assert counted["wkv6" if name == "ssm_scan" else "ssm_scan"] == 0


@pytest.fixture(scope="module")
def jamba_relabel(shards, jax_trainers):
    """(params, a relabel subset of 16 sequences a member, the JAX
    package's dense pseudo-labels for it) at reduced jamba's init."""
    jcfg, _ = _cfgs(JAMBA)
    params = _init(jax_trainers, JAMBA)
    subset = {k: v[:, :16] for k, v in shards[0].items()}
    return params, subset, np.asarray(jagg.allgather_relabel(
        params, subset, jsteps.make_logits_fn(jcfg), _ec(JEC)))


@pytest.mark.parametrize("rows", [6, 10, 40, 64])
def test_jamba_relabel_pools_each_batch_in_chunks(monkeypatch, jamba_relabel,
                                                  rows):
    """allgather_relabel of reduced jamba against the JAX package's: each
    member's batch of 16 sequences is one MoE pool, whether a chunk holds
    less than a batch (6 and 10 rows: the batch in pieces of 6, 6 and 4
    or 10 and 6, carrying the MoE layers' arrival counts), more (40:
    both batches) or all.  Scored as one pool of both batches, the same
    relabel drops other tokens (the fault this guards against)."""
    _, tcfg = _cfgs(JAMBA)
    monkeypatch.setattr(tagg, "CHUNK_BYTES", 4 * 16 * 512 * rows)
    params, subset, want = jamba_relabel
    relabel = lambda pooled: tagg.allgather_relabel(  # noqa: E731
        _torch(params), _torch(subset), tsteps.make_logits_fn(tcfg),
        _ec(TEC), n_out=tcfg.vocab_size, pooled=pooled).numpy()
    _close(relabel(True), want, **PSEUDO)
    if rows == 64:
        gap = np.abs(relabel(False) - want).max()
        assert gap > 100 * PSEUDO["atol"], gap


@pytest.fixture(scope="module")
def jamba_after_a_round(jax_trainers):
    """(the JAX trainer's params after one EC round from reduced
    jamba's init, numpy; its evaluate() there, the JAX package's one
    MoE pool of the 32 test rows a member)."""
    jtr, init = jax_trainers(JAMBA)
    jtr.ec, jtr.state = _ec(JEC), jax.tree.map(jnp.array, init)
    jtr.rng, jtr.pseudo_buffer, jtr.round = np.random.default_rng(2), None, 0
    jtr.run_round()
    return jax.device_get(jtr.state["params"]), jtr.evaluate(record=False)


@pytest.mark.parametrize("rows", [16, 8])
def test_jamba_evaluate_in_chunks_is_one_pool(monkeypatch, shards,
                                              jamba_after_a_round, rows):
    """evaluate() of reduced jamba after a round, with CHUNK_BYTES cut to
    16 / 8 test rows, against the JAX package's, which routes a member's
    32 test rows as one MoE pool: the port scores them in pieces of one
    pool, each carrying the MoE layers' arrival counts (rtol 1e-4).
    Each piece routed as its own pool (the fault of an earlier port,
    ROADMAP queue 3) moves the losses by more than that."""
    _, tcfg = _cfgs(JAMBA)
    train, test = shards
    params, want = jamba_after_a_round
    monkeypatch.setattr(tagg, "CHUNK_BYTES", 4 * 16 * 512 * rows)

    def port():
        tr = TTrainer(tcfg, _ec(TEC), tadamw(1e-3), K, 0,
                      _torch(train), _torch(test), batch_size=4, seed=2,
                      params=params, device="cpu")
        return tr.evaluate(record=False)
    got = port()
    for k in want:
        _close(got[k], want[k])
    monkeypatch.setattr(tsteps, "routes_by_pool", lambda cfg: False)
    split = port()
    gap = max(abs(split[k] - want[k]) / abs(want[k])
              for k in ("local_loss", "global_loss"))
    assert gap > 1e-4, gap
