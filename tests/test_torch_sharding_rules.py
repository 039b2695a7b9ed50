"""The dry-run's layouts and policy against the JAX package's, exactly.

For every arch of the JAX registry and both production meshes (16x16
("data", "model") and 2x16x16 ("pod", "data", "model"), as stand-ins
holding only their axis sizes, which is all the rules read): the
parallel policy, filter_par, ensemble_k, _grad_accum, skip_reason and
MODEL_FLOPS of every (arch x shape) cell; the spec of every parameter
leaf (jax.eval_shape params against the port's meta params, leaf for
leaf); the spec of every decode cache leaf; and the bytes a device holds
of params and optimizer state, computed from the specs on both sides.

The port's leaves carry a leading member dim where the JAX serving
params and cache have none: that dim is checked replicated and dropped
before the comparison.  Its cache is the slot cache (init_slot_cache),
whose "idx" holds a position a row; the JAX cache's is a scalar.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.common import sharding as jshd
from repro.common.types import SHAPES as JSHAPES
from repro.configs import registry as jreg
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import models as tmodels
from repro_torch.common import sharding as tshd
from repro_torch.common.tree import tree_map_with_path
from repro_torch.common.types import SHAPES
from repro_torch.configs import registry as treg
from repro_torch.launch import specs as tspecs
from repro_torch.models import transformer as ttf

ARCHS = jreg.ARCH_IDS


class StandIn:
    """A mesh as the rules read it: axis names and sizes."""

    def __init__(self, multi_pod: bool):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


MESHES = {False: StandIn(False), True: StandIn(True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(entry):
    """A spec entry in one form: None, an axis name, or a tuple of >= 2."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) == 0:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


def _jkey(path) -> tuple:
    out = []
    for e in path:
        if isinstance(e, jax.tree_util.DictKey):
            out.append(str(e.key))
        elif isinstance(e, jax.tree_util.SequenceKey):
            out.append(e.idx)
    return tuple(out)


def _jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_jkey(p): tuple(_norm(a) for a in s) for p, s in leaves}


def _tflat(tree) -> dict:
    out = {}
    tree_map_with_path(lambda p, s: out.__setitem__(
        p, tuple(_norm(a) for a in s)), tree,
        is_leaf=lambda x: isinstance(x, tuple))
    return out


def _jlocal_bytes(shapes, specs, mesh) -> int:
    total = 0
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))):
        n = 1
        for dim, a in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            div = 1
            for ax in (() if a is None else (a if isinstance(a, tuple)
                                             else (a,))):
                div *= mesh.shape.get(ax, 1)
            n *= -(-dim // div)
        total += n * leaf.dtype.itemsize
    return total


_SHAPES_OF = {}


@pytest.fixture(autouse=True, scope="module")
def _eval_shape_once():
    """jax.eval_shape of a config's init, once a module per (config,
    members): the big archs' take seconds, and flops_model, which the
    cells call, takes one a call.  The memo keys on what the traced
    function calls (init or init_cache) and the ModelConfig it closes
    over."""
    from repro.common.types import ModelConfig
    real = jax.eval_shape

    def once(fn, *args, **kw):
        cfgs = [c.cell_contents for c in (fn.__closure__ or ())
                if isinstance(c.cell_contents, (ModelConfig, int))]
        which = tuple(sorted({"init", "init_cache"}
                             & set(fn.__code__.co_names)))
        if not any(isinstance(c, ModelConfig) for c in cfgs) or kw \
                or not which:
            return real(fn, *args, **kw)
        # flops_model's init and this module's are one trace
        key = (which, tuple(cfgs))
        if key not in _SHAPES_OF:
            _SHAPES_OF[key] = real(fn, *args)
        return _SHAPES_OF[key]

    jax.eval_shape = once
    yield
    jax.eval_shape = real


def _jflops_model():
    """The JAX dry-run's flops_model; its module sets XLA_FLAGS at import
    (for its own process), which must not leak into this one's children."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdry.flops_model


def test_registry_matches():
    assert treg.LM_ARCH_IDS == jreg.ARCH_IDS
    assert treg.all_cells() == jreg.all_cells()
    assert treg.runnable_cells() == jreg.runnable_cells()
    assert len(treg.all_cells()) == 40


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_policy_and_arithmetic(arch):
    """Every shape of the arch on both meshes: policy, filter_par,
    ensemble_k, _grad_accum, skip_reason, size_class, MODEL_FLOPS."""
    jflops = _jflops_model()
    assert treg.size_class(arch) == jreg.size_class(arch)
    for shape_name in SHAPES:
        assert treg.skip_reason(arch, shape_name) == \
            jreg.skip_reason(arch, shape_name)
        assert tspecs.SHAPES[shape_name] == SHAPES[shape_name]
        jshape = JSHAPES[shape_name]
        assert (jshape.seq_len, jshape.global_batch, jshape.kind) == (
            SHAPES[shape_name].seq_len, SHAPES[shape_name].global_batch,
            SHAPES[shape_name].kind)
        for mp, mesh in MESHES.items():
            tpar = treg.parallel_policy(arch, SHAPES[shape_name], mp)
            jpar = jreg.parallel_policy(arch, jshape, mp)
            assert vars(tpar) == vars(jpar)
            tpar = tspecs.filter_par(tpar, mesh)
            jpar = jspecs.filter_par(jpar, mesh)
            assert vars(tpar) == vars(jpar)
            k = tspecs.ensemble_k(arch, mesh, tpar)
            assert k == jspecs.ensemble_k(arch, mesh, jpar)
            if jshape.kind == "train":
                assert tspecs._grad_accum(arch, SHAPES[shape_name], mesh, k,
                                          tpar) == \
                    jspecs._grad_accum(arch, jshape, mesh, k, jpar)
        assert tspecs.SHAPES is SHAPES
        from repro_torch.launch.dryrun import flops_model
        assert flops_model(arch, shape_name) == jflops(arch, shape_name)


def _jparams(cfg, k):
    """jax.eval_shape of init; k > 0: of its vmap over k keys, which is
    every leaf with a leading k (built so: the vmap's trace of a 126-layer
    init takes seconds)."""
    one = jax.eval_shape(lambda key: jtf.init(key, cfg),
                         jax.random.PRNGKey(0))
    if not k:
        return one
    return jax.tree.map(
        lambda x: jax.ShapeDtypeStruct((k,) + x.shape, x.dtype), one)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs(arch):
    """make_param_pspecs leaf for leaf (serving: one model; training: the
    member stack), then the optimizer state's specs and the bytes a
    device holds of params and state, on both meshes."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for mp, mesh in MESHES.items():
        # serving
        par = tspecs.filter_par(
            treg.parallel_policy(arch, SHAPES["decode_32k"], mp), mesh)
        jpar = jspecs.filter_par(
            jreg.parallel_policy(arch, JSHAPES["decode_32k"], mp), mesh)
        jp = _jparams(jcfg, 0)
        tp = tmodels.init(tcfg, device="meta")
        want = _jflat(jshd.make_param_pspecs(jp, jpar, ensemble=False,
                                             mesh=mesh))
        got = _tflat(tshd.make_param_pspecs(tp, par, ensemble=False,
                                            mesh=mesh, lead=1))
        assert set(got) == set(want)
        for path, spec in got.items():
            assert spec[0] is None, (path, spec)
            assert spec[1:] == want[path], (path, spec, want[path])
        # training: the member stack, its AdamW state
        jshape = JSHAPES["train_4k"]
        par = tspecs.filter_par(
            treg.parallel_policy(arch, SHAPES["train_4k"], mp), mesh)
        jpar = jspecs.filter_par(jreg.parallel_policy(arch, jshape, mp),
                                 mesh)
        k = tspecs.ensemble_k(arch, mesh, par)
        jp = _jparams(jcfg, k)
        j_pspec = jshd.make_param_pspecs(jp, jpar,
                                         ensemble=bool(jpar.ensemble_axis),
                                         mesh=mesh)
        moment = jnp.bfloat16 if jreg.size_class(arch) == "big" \
            else jnp.float32
        j_opt = jax.eval_shape(
            lambda p: jax.vmap(jadamw(1e-4, moment_dtype=moment).init)(p),
            jp)
        j_ospec = jspecs.abstract_pspecs_like(j_opt, j_pspec)
        metas, t_specs, _ = tspecs.train_state_meta(tcfg, arch, k, par,
                                                    mesh)
        want = _jflat(j_pspec)
        got = _tflat(t_specs["params"])
        assert got == want
        assert _tflat(t_specs["opt"]) == _jflat(j_ospec)
        assert tspecs.local_bytes(metas["params"], t_specs["params"],
                                  mesh) == _jlocal_bytes(jp, j_pspec, mesh)
        assert tspecs.local_bytes(metas["opt"], t_specs["opt"], mesh) == \
            _jlocal_bytes(j_opt, j_ospec, mesh)


def _jserve_par(arch, shape, mesh, multi_pod):
    """The layout the JAX package's build_serve_cell computes inline."""
    import dataclasses
    par = jspecs.filter_par(jreg.parallel_policy(arch, shape, multi_pod),
                            mesh)
    B = shape.global_batch
    if B % jspecs._axsize(mesh, tuple(par.batch_axes)) != 0:
        keep = []
        for a in par.batch_axes:
            if B % jspecs._axsize(mesh, tuple(keep + [a])) == 0:
                keep.append(a)
        par = dataclasses.replace(par, batch_axes=tuple(keep))
    return par


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs(arch):
    """cache_pspecs leaf for leaf over every decode shape the arch runs:
    the port's (K, count) / (K,) leading dims replicated, the rest the
    JAX rule's over its init_cache."""
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        if treg.skip_reason(arch, shape_name):
            continue
        shape = SHAPES[shape_name]
        B = shape.global_batch
        for mp, mesh in MESHES.items():
            par = tspecs.serve_par(arch, shape, mesh, mp)
            jpar = _jserve_par(arch, JSHAPES[shape_name], mesh, mp)
            assert vars(par) == vars(jpar)
            jc = jax.eval_shape(lambda: jtf.init_cache(jcfg, B,
                                                       max_seq=shape.seq_len))
            tc = ttf.init_slot_cache(tcfg, B, shape.seq_len, device="meta")
            want = _jflat(jspecs.cache_pspecs(jcfg, jc, jpar, mesh))
            got = _tflat(tspecs.cache_pspecs(tcfg, tc, par, mesh))
            assert got.pop(("idx",)) == (None, None)
            assert want.pop(("idx",)) == ()
            assert set(got) == set(want)
            for path, spec in got.items():
                assert spec[0] is None, (path, spec)
                assert spec[1:] == want[path], (shape_name, path, spec,
                                                want[path])
