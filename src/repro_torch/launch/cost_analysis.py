"""Per-rank costs of a step, read from the ops it runs: the counterpart
of the JAX package's launch/hlo_analysis.py.

The JAX dry-run compiles a step and parses the per-device HLO; here the
step runs once, eagerly, on fake tensors (or DTensors of fake local
shards), under a dispatch mode that sees every op a rank runs on its
local tensors:
  - flops: each op's flop formula (torch.utils.flop_counter's registry,
    which counts matmuls, convolutions and attention, and the kernels'
    formulas, kernels/library.py), the reference's convention of dot
    products only; `flops_executed` takes the kernels' own counts where
    they do less (the flash kernel skips masked tiles): the roofline's;
  - hbm_bytes: the bytes each op reads and writes, as eager execution
    moves them: every tensor an op reads once, every output once; a view
    moves nothing; a gather reads what it gathers; an indexed write
    writes (and reads) only its values; an in-place update reads and
    writes its target.  This is NOT the reference's count, which XLA's
    fusion makes smaller (it counts bytes at fusion boundaries only);
  - collectives: the functional collectives DTensor's redistributions
    issue, by kind, with hlo_analysis's convention that an all-reduce
    counts twice its bytes (a ring moves each byte out and back);
    all-gather, reduce-scatter and all-to-all count their output; each
    also by the link its process group takes (launch/mesh.py); an
    all_to_all_single with one peer each way is the ring's
    collective-permute (common/sharding.ppermute), counted by its
    output as the reference counts one;
  - peak_bytes: the most bytes of tensor storage alive at once, the
    step's inputs included (the reference's memory_analysis: arguments
    + temporaries + outputs - aliases);
  - the top ops by flops, by bytes and by collective bytes.

DTensor's sharding propagation runs each op once more on global-shape
fake tensors to learn the output's metadata; those calls are not the
rank's work and are not counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.common.sharding import is_dtensor

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the functional collectives DTensor's redistributions issue -> (kind,
# counts its output? else its input)
_COLL = {
    "all_reduce": ("all-reduce", False),
    "all_gather_into_tensor": ("all-gather", True),
    "reduce_scatter_tensor": ("reduce-scatter", True),
    "all_to_all_single": ("all-to-all", True),
}
_NO_BYTES = {"wait_tensor", "detach", "empty", "empty_like", "empty_strided",
             "lift_fresh", "alias", "set_", "resize_", "_local_scalar_dense"}
_WRITE_ONLY = {"fill_", "zero_", "zeros", "ones", "full", "zeros_like",
               "ones_like", "full_like", "arange", "new_zeros", "new_ones",
               "new_full", "new_empty", "scalar_tensor", "rand", "randn",
               "normal_", "uniform_", "copy_"}
# gathers: read what they gather (the output's size), not their source
_GATHER = {"embedding", "index_select", "gather", "index",
           "take_along_dim"}
# indexed writes into their first argument: move only the values written
_SCATTER = {"index_put_", "index_copy_", "scatter_", "scatter_add_",
            "index_add_", "masked_scatter_", "_index_put_impl_",
            "scatter_reduce_"}


_METADATA = {torch.ops.prim.device.default, torch.ops.aten.sym_size.int,
             torch.ops.aten.sym_stride.int, torch.ops.aten.sym_numel.default,
             torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.dim.default,
             torch.ops.aten.is_contiguous.default}


def _bytes(t: torch.Tensor) -> int:
    """The distinct elements' bytes: a broadcast (stride 0) dim reads its
    row once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


_TIMES = [1]   # how many times each op now traced counts (repeated)


@contextlib.contextmanager
def repeated(n: int):
    """Count every op run inside the block n times (FLOPs, bytes,
    collectives, ops, kernel calls; not the peak): a loop whose steps
    are alike, traced one step for all (models/ssm's Mamba step loop in
    the dry-run), as the reference's HLO runs one scan body."""
    old = _TIMES[0]
    _TIMES[0] = old * n
    try:
        yield
    finally:
        _TIMES[0] = old


def _one_peer(splits) -> bool:
    """Does an all_to_all_single's split list send to (or receive from)
    one rank only, as a permute does?"""
    return sum(1 for x in splits if x) == 1


def _executed() -> dict:
    from repro_torch.kernels.library import EXECUTED_FLOPS
    return EXECUTED_FLOPS


@dataclasses.dataclass
class Costs:
    """Per-rank costs, the fields of hlo_analysis.HloCosts and more."""
    flops: float = 0.0
    flops_executed: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    collective_count: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})
    link_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"nvlink": 0.0, "ib": 0.0})
    peak_bytes: int = 0
    n_ops: int = 0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    top_flops: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    top_bytes: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    top_coll: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class CostMode(TorchDispatchMode):
    """Accounts every op that reaches it on plain (fake or real) tensors;
    an op on DTensors passes to DTensor (NotImplemented), whose local ops
    come back here.  links: {process group name: link}."""

    def __init__(self, links: Dict[str, str] = None):
        super().__init__()
        self.links = links or {}
        self.c = Costs()
        self.shadow = 0
        self._dt_op = ""      # the DTensor op whose redistribution runs
        self._live = 0
        self._seen = WeakIdKeyDictionary()
        self._flops = defaultdict(float)
        self._bytes = defaultdict(float)
        self._coll = defaultdict(float)

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        import weakref
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self._live += n
        self.c.peak_bytes = max(self.c.peak_bytes, self._live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n

    def track_inputs(self, tree) -> None:
        for x in tree_flatten(tree)[0]:
            if is_dtensor(x):
                x = x._local_tensor
            if isinstance(x, torch.Tensor):
                self._track(x)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:   # a tensor's device, size, stride: no work
            return func(*args, **kwargs)
        flat = tree_flatten((args, kwargs))[0]
        if any(is_dtensor(a) for a in flat):
            self._dt_op = func._schema.name.split("::")[-1]
            return NotImplemented
        out = func(*args, **kwargs)
        if not self.shadow:
            self._account(func, args, kwargs, flat, out)
        return out

    def _account(self, func, args, kwargs, flat, out) -> None:
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        n = _TIMES[0]
        self.c.n_ops += n
        for t in outs:
            if t._base is None:
                self._track(t)
        if ns == "repro_torch":
            self.c.kernel_calls[name] = self.c.kernel_calls.get(name, 0) + n
        packet = func._overloadpacket
        if packet in flop_registry:
            fl = n * float(flop_registry[packet](*args, **kwargs,
                                                 out_val=out))
            ex = _executed().get(func)
            self.c.flops += fl
            self.c.flops_executed += n * float(ex(*args, **kwargs)) if ex \
                else fl
            self._flops[self._desc(name, flat)] += fl
        if name in _COLL and ns == "_c10d_functional":
            self._collective(name, args, flat, outs, n)
            return
        b = n * self._moved(func, name, args, flat, outs)
        if b:
            self.c.hbm_bytes += b
            self._bytes[self._desc(name, flat)] += b

    def _moved(self, func, name, args, flat, outs) -> int:
        if name in _NO_BYTES or getattr(func, "is_view", False):
            return 0
        ins = []
        seen = set()
        for a in flat:
            if isinstance(a, torch.Tensor) and id(a) not in seen:
                seen.add(id(a))
                ins.append(a)
        if name in _SCATTER and ins:
            vals = sum(_bytes(t) for t in ins[1:])
            return 2 * vals
        written = sum(_bytes(t) for t in outs)
        if name in _WRITE_ONLY:
            if name == "copy_":  # reads its source, writes its target
                return sum(_bytes(t) for t in ins[1:]) + written
            return written
        if name in _GATHER and outs:
            idx = sum(_bytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            return 2 * written + idx
        return sum(_bytes(t) for t in ins) + written

    def _collective(self, name, args, flat, outs, n: int = 1) -> None:
        kind, by_out = _COLL[name]
        if name == "all_to_all_single" and _one_peer(args[1]) \
                and _one_peer(args[2]):
            kind = "collective-permute"     # sharding.ppermute's
        ts = outs if by_out else [a for a in flat
                                  if isinstance(a, torch.Tensor)]
        b = n * float(sum(_bytes(t) for t in ts))
        if kind == "all-reduce":
            b *= 2.0
        self.c.collective_bytes[kind] += b
        self.c.collective_count[kind] += n
        # a functional collective's group name is its last str argument;
        # a group of no mesh dim counts as crossing nodes
        group = next((a for a in reversed(flat) if isinstance(a, str)),
                     None)
        link = self.links.get(group, "ib")
        self.c.link_bytes[link] += b
        shape = tuple(ts[0].shape) if ts else ()
        self._coll[f"{kind} {shape} {link} for {self._dt_op}"] += b

    @staticmethod
    def _desc(name: str, flat) -> str:
        shapes = [tuple(a.shape) for a in flat
                  if isinstance(a, torch.Tensor)][:3]
        return f"{name} {shapes}"

    def finish(self, collect_top: int = 6) -> Costs:
        def top(d):
            return sorted(d.items(), key=lambda kv: -kv[1])[:collect_top]
        self.c.top_flops = top(self._flops)
        self.c.top_bytes = top(self._bytes)
        self.c.top_coll = top(self._coll)
        return self.c


@contextlib.contextmanager
def _uncounted_shadow(mode: CostMode):
    """DTensor's sharding propagation and shard placement are metadata
    work: they run ops on global-shape fake tensors to learn an output's
    shape, and small real tensor arithmetic to place uneven shards and
    offset gathered indices.  Mark those calls so the mode skips them,
    and run them outside the step's FakeTensorMode (a fake scalar could
    not be read)."""
    if "torch.distributed.tensor" not in sys.modules:  # no DTensor made
        yield
        return
    try:
        from torch.distributed.tensor import _utils
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard
    except ImportError:
        yield
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    sites = [(owner, n) for owner, names in (
        (ShardingPropagator, ("propagate_op_sharding_non_cached",
                              "_propagate_tensor_meta_non_cached")),
        (_utils, ("_compute_local_shape_and_global_offset",)),
        (_StridedShard, ("local_shard_size_and_offset",)))
        for n in names if hasattr(owner, n)]
    real = [getattr(owner, n) for owner, n in sites]

    def shadowed(fn):
        def call(*a, **kw):
            mode.shadow += 1
            try:
                with unset_fake_temporarily():
                    return fn(*a, **kw)
            finally:
                mode.shadow -= 1
        return call

    for (owner, n), fn in zip(sites, real):
        setattr(owner, n, shadowed(fn))
    try:
        yield
    finally:
        for (owner, n), fn in zip(sites, real):
            setattr(owner, n, fn)


def analyze(fn: Callable, *args, links: Dict[str, str] = None,
            collect_top: int = 6, **kwargs):
    """Run fn(*args, **kwargs) once under the accounting -> (its result,
    Costs).  The arguments count as alive from the start."""
    mode = CostMode(links)
    mode.track_inputs((args, kwargs))
    with _uncounted_shadow(mode), mode:
        out = fn(*args, **kwargs)
    return out, mode.finish(collect_top)


def combine(parts, collect_top: int = 6) -> Costs:
    """The costs of a step traced in parts, [(Costs, times it runs)]:
    FLOPs, bytes, collectives, ops and kernel calls summed (each part
    times its count), the peak the largest part's (each part's trace
    holds what is alive beside it: its inputs).  The top lists merge
    the parts' own tops, scaled."""
    out = Costs()
    tops = {"top_flops": defaultdict(float), "top_bytes": defaultdict(float),
            "top_coll": defaultdict(float)}
    for c, n in parts:
        out.flops += n * c.flops
        out.flops_executed += n * c.flops_executed
        out.hbm_bytes += n * c.hbm_bytes
        out.n_ops += n * c.n_ops
        out.peak_bytes = max(out.peak_bytes, c.peak_bytes)
        for kind in COLLECTIVES:
            out.collective_bytes[kind] += n * c.collective_bytes[kind]
            out.collective_count[kind] += n * c.collective_count[kind]
        for link, b in c.link_bytes.items():
            out.link_bytes[link] = out.link_bytes.get(link, 0.0) + n * b
        for name, k in c.kernel_calls.items():
            out.kernel_calls[name] = out.kernel_calls.get(name, 0) + n * k
        for key, acc in tops.items():
            for desc, v in getattr(c, key):
                acc[desc] += n * v
    for key, acc in tops.items():
        setattr(out, key, sorted(acc.items(),
                                 key=lambda kv: -kv[1])[:collect_top])
    return out
