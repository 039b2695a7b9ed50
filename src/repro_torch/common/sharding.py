"""The member axis over torch.distributed: one process a rank.

The JAX package places the ensemble's leading (K,) member axis over the
"member" dim of a ("member", "data") device mesh and runs its programs
under shard_map, one controller for every device.  The port runs one
process a rank instead (the decode path is host-bound: one thread
dispatching every rank's members would multiply the host's time a step),
and the mesh is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of the process group.  A rank holds the members of its "member"
coordinate; the "data" dim replicates.

The collectives below stand for the JAX package's psum / pmax / pmean /
ppermute over one mesh dim.  NCCL runs them on the card.  Under gloo (two
ranks sharing one card, or CPU processes in the tests) a CUDA tensor is
staged through pinned host memory, since gloo moves host buffers: the
tensor is copied to the host, the collective runs there, and the result
is copied back.  The kernels run on the card all the same.

`spawn` starts a world of ranks (torch.multiprocessing, file:// rendezvous
in a temporary directory, so that concurrent worlds cannot collide on a
port) and returns each rank's result; a rank that fails makes it raise
with that rank's traceback.

The second half of the module holds the JAX module's tensor- and
FSDP-parallel rules, the dry-run's layouts (launch/specs.py): a spec is
what the JAX package's PartitionSpec holds, a tuple with one entry per
tensor dim (None, a mesh axis name or a tuple of names), `placements`
turns it into DTensor placements over a DeviceMesh, and `constrain` is
with_sharding_constraint over a DTensor (a no-op on a plain tensor, so
the serving and training paths never pay for it).
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MEMBER_AXIS = "member"
DATA_AXIS = "data"

PG_TIMEOUT_S = 60.0   # a collective that waits longer than this fails
# a follower waits on the control group for the leader's next call,
# however long the leader idles (an HTTP server between requests)
CONTROL_TIMEOUT_S = 30 * 24 * 3600.0


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _init_single(device: str) -> None:
    """A 1-rank process group: NCCL on the card, gloo on the CPU."""
    backend = "nccl" if device == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    # the group's store lives in this file (new groups meet there too)
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'init')}",
        rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def local_mesh(member: int = 1, data: int = 1,
               device: Optional[str] = None):
    """A (member, data) DeviceMesh over the first member*data ranks of
    the process group, each dim clamped to the ranks there are (member
    first), as the JAX package clamps to the devices there are: one
    process asking for local_mesh(2, 1) gets a 1x1 mesh, which runs the
    same code path as two ranks, collectives included.  With no process
    group yet, a 1-rank one is started (NCCL on the card, gloo on the
    CPU; `device` "cuda" / "cpu", the card when there is one).  Every
    rank of the group must call this with the same arguments.  A gloo
    group for the engines' control messages (call replay) comes with the
    mesh, as `mesh.control_group`."""
    from torch.distributed.device_mesh import DeviceMesh
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        _init_single(device)
    world = dist.get_world_size()
    member = max(1, min(int(member), world))
    data = max(1, min(int(data), world // member))
    ranks = torch.arange(member * data).reshape(member, data)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(kind, ranks, mesh_dim_names=(MEMBER_AXIS, DATA_AXIS))
    mesh.control_group = dist.new_group(
        ranks=list(range(member * data)), backend="gloo",
        timeout=datetime.timedelta(seconds=CONTROL_TIMEOUT_S))
    return mesh


def parse_mesh_arg(arg: str):
    """'MxD' CLI string -> local_mesh(M, D); '' / '1x1' / 'none' / 'off'
    -> None (the unsharded single-process path)."""
    shape = mesh_shape_arg(arg)
    return None if shape is None else local_mesh(*shape)


def mesh_shape_arg(arg: str) -> Optional[Tuple[int, int]]:
    """'MxD' -> (M, D), None where parse_mesh_arg gives no mesh."""
    if not arg or arg.lower() in ("1x1", "none", "off"):
        return None
    try:
        m, d = (int(x) for x in arg.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants 'MxD' (e.g. 2x1), got {arg!r}")
    if m * d <= 1:
        return None
    return m, d


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def member_rows(n_members: int, mesh, axis: str = MEMBER_AXIS) -> slice:
    """The rows of a (K, ...) member stack this rank holds: the JAX
    stack's rows [r K/M, (r+1) K/M).  Raises when M does not divide K."""
    M = axis_size(mesh, axis)
    if n_members % M:
        raise ValueError(f"mesh {axis} axis {M} does not divide "
                         f"K={n_members} members")
    per = n_members // M
    r = axis_index(mesh, axis)
    return slice(r * per, (r + 1) * per)


def is_leader(mesh) -> bool:
    """Is this rank the mesh's first, the one that owns the host API?"""
    return mesh.get_coordinate() is not None and \
        not any(mesh.get_coordinate())


# ---------------------------------------------------------------------------
# collectives over one mesh dim
# ---------------------------------------------------------------------------

def _staged(x: torch.Tensor, group) -> Tuple[torch.Tensor, bool]:
    """The buffer the collective runs on: a pinned host copy of a CUDA
    tensor under gloo, else the tensor itself (contiguous)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h, True
    return x.contiguous(), False


def _home(buf: torch.Tensor, like: torch.Tensor, staged: bool):
    return buf.to(like.device, non_blocking=True) if staged else buf


def _all_reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    group = mesh.get_group(axis)
    buf, staged = _staged(x, group)
    if not staged:
        buf = buf.clone()   # all_reduce works in place
    dist.all_reduce(buf, op=op, group=group)
    return _home(buf, x, staged)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of x over the ranks of `axis` (a new tensor on x's device)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def _global(mesh, axis: str, i: int) -> int:
    return dist.get_global_rank(mesh.get_group(axis), i)


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1
             ) -> torch.Tensor:
    """x sent to the rank `shift` places on along `axis` (cyclically),
    and the one `shift` places back received: the JAX package's ppermute
    with perm [(i, (i + shift) % n)].  On a world of ranks a pair of
    point-to-point calls; on the dry-run's fake world (a fake tensor, or
    a DTensor of fake shards over a member's own mesh) a functional
    collective (an all_to_all_single with one peer each way), which the
    accounting reads as a collective-permute.  `ppermute.bytes` counts
    the bytes sent."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x.clone()
    ppermute.bytes += x.numel() * x.element_size()
    if is_dtensor(x) or _is_fake(x):
        return _permute_functional(x, mesh, axis, shift)
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    buf, staged = _staged(x, group)
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, _global(mesh, axis, (me + shift) % n),
                      group),
           dist.P2POp(dist.irecv, recv, _global(mesh, axis, (me - shift) % n),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _home(recv, x, staged)


ppermute.bytes = 0


def _is_fake(x: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def _permute_functional(x: torch.Tensor, mesh, axis: str, shift: int):
    """ppermute by torch's functional permute over `axis`'s group, on x
    or, for a DTensor, on its local shard (same layout after)."""
    from torch.distributed import _functional_collectives as funcol
    n = axis_size(mesh, axis)
    local = x.to_local() if is_dtensor(x) else x
    # flat: permute_tensor's splits count elements, all_to_all_single's
    # rows of dim 0
    out = funcol.permute_tensor(local.reshape(-1),
                                [(i + shift) % n for i in range(n)],
                                mesh.get_group(axis))
    out = funcol.wait_tensor(out).view(local.shape)
    if not is_dtensor(x):
        return out
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(n, *x.shape): every rank's x along `axis`, in rank order."""
    group = mesh.get_group(axis)
    buf, staged = _staged(x, group)
    parts = [torch.empty_like(buf) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, buf, group=group)
    return _home(torch.stack(parts), x, staged)


def gather_all_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's (K/M, ...) rows along `axis` as the global (K, ...)
    stack, on every rank: on the host under gloo (nothing K-sized lands
    on the card), on x's device under NCCL."""
    group = mesh.get_group(axis)
    if dist.get_backend(group) == "gloo":
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def reduce_scatter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x (n * m, ...) summed over the ranks of `axis`, of which this rank
    receives only its own rows [r m, (r+1) m)."""
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    buf, staged = _staged(x, group)
    parts = list(buf.chunk(n))
    out = torch.empty_like(parts[0])
    if n == 1:
        out.copy_(parts[0])
    else:
        dist.reduce_scatter(out, [p.contiguous() for p in parts],
                            group=group)
    return _home(out, x, staged)


def broadcast_object(obj: Any, mesh) -> Any:
    """The mesh's first rank's obj, on every rank of the mesh (pickled
    over its gloo control group)."""
    group = mesh.control_group
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def send_rows(x: Optional[torch.Tensor], out: torch.Tensor, mesh,
              axis: str = MEMBER_AXIS) -> None:
    """Copy into `out` (this rank's (K/M, ...) rows) its rows of the
    global (K, ...) x that the mesh's first rank holds (x is read there
    only): a scatter of member rows over `axis`, each data replica
    served by its own coordinate.  Point to point from the first rank."""
    first = int(mesh.mesh.flatten()[0])
    me = dist.get_rank()
    per = out.shape[0]
    backend = dist.get_backend()
    if me == first:
        for coord_rank in mesh.mesh.flatten().tolist():
            r = _coord(mesh, coord_rank, axis)
            rows = x[r * per:(r + 1) * per]
            if coord_rank == first:
                out.copy_(rows)
                continue
            dist.send(rows.to("cpu" if backend == "gloo" else out.device)
                      .contiguous(), coord_rank)
        return
    buf = torch.empty(out.shape, dtype=out.dtype,
                      device="cpu" if backend == "gloo" else out.device)
    dist.recv(buf, first)
    out.copy_(buf)


def gather_rows(x: torch.Tensor, mesh, axis: str = MEMBER_AXIS
                ) -> Optional[torch.Tensor]:
    """The global (K, ...) stack of every rank's (K/M, ...) rows along
    `axis`, on the mesh's first rank (None elsewhere).  Only the data
    coordinate 0 sends."""
    first = int(mesh.mesh.flatten()[0])
    me = dist.get_rank()
    staged = dist.get_backend() == "gloo" and x.is_cuda
    line = _axis_line(mesh, axis)
    if me != first:
        if me in line:
            dist.send(x.contiguous().cpu() if staged else x.contiguous(),
                      first)
        return None
    parts = []
    for rank in line:
        if rank == first:
            parts.append(x)
            continue
        buf = torch.empty(x.shape, dtype=x.dtype,
                          device="cpu" if staged else x.device)
        dist.recv(buf, rank)
        parts.append(buf.to(x.device))
    return torch.cat(parts)


def _axis_line(mesh, axis: str) -> List[int]:
    """The global ranks along `axis` through the mesh's first rank."""
    dim = mesh.mesh_dim_names.index(axis)
    idx = [0] * mesh.mesh.dim()
    out = []
    for i in range(mesh.mesh.shape[dim]):
        idx[dim] = i
        out.append(int(mesh.mesh[tuple(idx)]))
    return out


def _coord(mesh, rank: int, axis: str) -> int:
    """The coordinate of global `rank` along `axis`."""
    dim = mesh.mesh_dim_names.index(axis)
    where = (mesh.mesh == rank).nonzero()[0]
    return int(where[dim])


# ---------------------------------------------------------------------------
# a world of ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, init: str, backend: str,
               device: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{init}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """A running world of ranks (see spawn)."""

    def __init__(self, procs, out_dir: str, timeout: float):
        self.procs, self.out_dir = procs, out_dir
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def _stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()

    def _first_failure(self, bad: List[int]) -> int:
        """The rank whose traceback was written first: the others that
        failed then did so on a collective it left (their peer gone)."""
        def when(r):
            path = os.path.join(self.out_dir, f"rank{r}.err")
            return os.path.getmtime(path) if os.path.exists(path) \
                else float("inf")
        errs = [r for r in range(len(self.procs)) if when(r) < float("inf")]
        return min(errs or bad, key=when)

    def _error(self, rank: int) -> str:
        path = os.path.join(self.out_dir, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
        return "(no traceback: the process died)"

    def join(self) -> List[Any]:
        """Wait for every rank; -> each rank's result, in rank order.
        Raises RuntimeError with a failed rank's traceback (the others
        are stopped), TimeoutError past the world's timeout."""
        try:
            while True:
                codes = [p.exitcode for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    time.sleep(0.5)   # let a cascade's tracebacks land
                    r = self._first_failure(bad)
                    raise RuntimeError(f"rank {r} of {len(self.procs)} "
                                       f"exited {self.procs[r].exitcode} "
                                       f"first:\n{self._error(r)}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{self.timeout} s (exit codes "
                                       f"{codes})")
                self.procs[codes.index(None)].join(0.05)
            out = []
            for r in range(len(self.procs)):
                with open(os.path.join(self.out_dir, f"rank{r}.pkl"),
                          "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            self._stop()
            shutil.rmtree(self.out_dir, ignore_errors=True)


def spawn(fn: Callable, nprocs: int, args: Sequence = (), *,
          device: str = "cpu", backend: Optional[str] = None,
          timeout: float = 120.0, wait: bool = True):
    """Run fn(rank, *args) in `nprocs` fresh processes joined in one
    process group; -> their return values in rank order (picklable), or,
    with wait=False, the running World (its join() returns them).

    device "cuda": rank r takes cuda:(r % device_count); backend None
    picks NCCL when every rank has a card of its own, else gloo (NCCL
    refuses two ranks on one device).  The children run one intra-op
    thread (OMP_NUM_THREADS=1).  `timeout` bounds the whole world,
    PG_TIMEOUT_S each collective.  fn must be importable by name."""
    if backend is None:
        backend = ("nccl" if device == "cuda"
                   and torch.cuda.device_count() >= nprocs else "gloo")
    out_dir = tempfile.mkdtemp(prefix="repro_torch_world_")
    init = os.path.join(out_dir, "init")
    # the call goes by file: a start() writes its process's pickle into
    # a pipe that the child drains only as it imports what unpickling
    # needs, so large arguments there would start the ranks one by one
    with open(os.path.join(out_dir, "call.pkl"), "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, init, backend, device, out_dir),
                         daemon=True)
             for r in range(nprocs)]
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    world = World(procs, out_dir, timeout)
    return world.join() if wait else world


# ---------------------------------------------------------------------------
# tensor- and FSDP-parallel layout rules (the dry-run's)
# ---------------------------------------------------------------------------
# Every parameter has a standardized leaf name (models/*.py); pspec_for
# maps (leaf name, rank) -> spec under a ParallelConfig (TP = the "model"
# axis, FSDP = the optional fsdp axis):
#   - column-parallel weights (d_model, X): (fsdp, "model")  [output dim]
#   - row-parallel weights    (X, d_model): ("model", fsdp)  [input dim]
#   - embeddings (V, d): vocab over "model", d over fsdp
#   - per-expert weights (E, ...): experts over "model" (EP)
#   - norms / small lora mats: replicated
# Stacked segment leaves get a leading None; the ensemble adds a leading
# ensemble-axis dim on top of that.

_COLUMN = {
    "w_q", "w_k", "w_v", "w_gate", "w_up", "mamba_in", "rwkv_r", "rwkv_k",
    "rwkv_v", "rwkv_g", "cmix_k", "q_up", "kv_up", "w_cross_q",
}
_ROW = {"w_o", "w_down", "mamba_out", "rwkv_o", "cmix_v"}
_EXPERT_COLUMN = {"experts_gate", "experts_up"}
_EXPERT_ROW = {"experts_down"}
_EMBED = {"embed", "head", "enc_embed"}
_REPLICATED_PREFIXES = (
    "norm", "bias", "router", "rwkv_mix", "rwkv_decay", "rwkv_first",
    "mamba_dt", "mamba_A", "mamba_D", "mamba_conv", "q_down", "kv_down",
    "k_rope", "qk_scale", "alibi", "pos",
)

BATCH = "batch"        # role name usable in constrain() specs
REP = "__replicate__"  # force replication of a dim (None means "free")


def pspec_for(name: str, ndim: int, par) -> tuple:
    m, f = par.model_axis, (par.fsdp_axis or None)

    def pad(tail):
        # left-pad with None for stacked-segment leading dims
        return (None,) * (ndim - len(tail)) + tuple(tail)

    if any(name.startswith(p) for p in _REPLICATED_PREFIXES):
        return (None,) * ndim
    if name in _EMBED:
        return pad((m, f))
    if name in _EXPERT_COLUMN:
        return pad((m, f, None))
    if name in _EXPERT_ROW:
        return pad((m, None, f))
    if name in _COLUMN:
        return pad((f, m))
    if name in _ROW:
        return pad((m, f))
    return (None,) * ndim  # conservative default: replicate


def leaf_name(path) -> str:
    """The last dict key of a tree path (tree.tree_map_with_path)."""
    for e in reversed(path):
        if isinstance(e, str):
            return e
    return ""


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (or of anything whose `shape` is
    that dict already, as the JAX package's tests' stand-in meshes)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axsize(sizes: dict, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
        n *= sizes.get(a, 1)
    return n


def make_param_pspecs(params: Any, par, ensemble: bool = False,
                      mesh=None, lead: int = 0) -> Any:
    """Tree of specs matching `params`.  ensemble=True: leaves carry a
    leading member dim over par.ensemble_axis.  `lead` more leading dims
    stay replicated (the port's member dim of a single-model cell, K = 1).
    With `mesh`, an axis whose size does not divide its dim is dropped
    (whisper's 51865 vocab cannot split 16 ways, so it replicates)."""
    from repro_torch.common.tree import tree_map_with_path
    sizes = None if mesh is None else mesh_sizes(mesh)

    def sanitize(spec, shape):
        if sizes is None:
            return spec
        return tuple(a if (a is None or dim % _axsize(sizes, a) == 0)
                     else None for dim, a in zip(shape, spec))

    def rule(path, leaf):
        extra = lead + (1 if ensemble else 0)
        spec = pspec_for(leaf_name(path), leaf.dim() - extra, par)
        if ensemble:
            spec = (par.ensemble_axis or None,) + spec
        return sanitize((None,) * lead + spec, leaf.shape)

    return tree_map_with_path(rule, params)


def placements(spec: tuple, mesh) -> list:
    """A spec -> one DTensor placement per mesh dim: Shard(d) on every mesh
    dim that tensor dim d names, Replicate elsewhere.  A tuple of axes on
    one dim shards it over each of them, the major one first, which is
    DTensor's own order when the tuple follows the mesh's."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, a in enumerate(spec):
        axes = () if a is None else (tuple(a) if isinstance(a, (tuple, list))
                                     else (a,))
        idx = [names.index(x) for x in axes if x in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {a!r} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def make_shardings(mesh, pspecs: Any) -> Any:
    """Tree of placement lists matching a tree of specs."""
    from repro_torch.common.tree import tree_map_with_path
    return tree_map_with_path(lambda _, s: placements(s, mesh), pspecs,
                              is_leaf=lambda x: isinstance(x, tuple))


# layout context: symbolic roles resolved at trace time.  Model code names
# *roles* ("batch"); the step function decides what mesh axes that role
# maps to.  EC ensemble training maps "batch" to the member batch's axes
# (the member axis is carried by the stacked leading dim), while
# single-model serving maps it to ("pod", "data").

_layout = threading.local()


def _layout_map() -> dict:
    return getattr(_layout, "map", {"batch": ("pod", "data"),
                                    "seq": None, "train": False})


def layout_flag(name: str) -> bool:
    return bool(_layout_map().get(name))


@contextlib.contextmanager
def layout_ctx(**roles):
    """layout_ctx(batch=("data",)) remaps symbolic axes inside the block."""
    old = _layout_map()
    _layout.map = {**old, **roles}
    try:
        yield
    finally:
        _layout.map = old


def _resolve(axis):
    if isinstance(axis, str) and axis in _layout_map():
        v = _layout_map()[axis]
        return tuple(v) if isinstance(v, (tuple, list)) else v
    return axis


def _axis_ok(axis, names) -> bool:
    if isinstance(axis, (tuple, list)):
        return all(a in names for a in axis)
    return axis in names


def is_dtensor(x) -> bool:
    """Is x a DTensor?  Answered without importing DTensor (a second on
    first import): where it was never imported, nothing is one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def mesh_axis_size(axis: str, x) -> int:
    """Size of a mesh axis of the mesh x lies on (1 for a plain tensor or
    an axis the mesh lacks)."""
    if not is_dtensor(x):
        return 1
    return mesh_sizes(x.device_mesh).get(axis, 1)


def constrain(x, *spec):
    """with_sharding_constraint over a DTensor; a plain tensor is returned
    as it is.

    Axes absent from x's mesh are dropped (model code names its ideal
    layout and still runs off-mesh), and roles (BATCH, "seq") resolve
    through layout_ctx.  A named dim is pinned to its axes; REP forces a
    dim replicated; an unnamed dim keeps its current placement, which is
    JAX's P.UNCONSTRAINED and NOT replication: forcing every unnamed dim
    replicated would silently undo the propagated batch sharding (the
    JAX package measured 30 GiB a device of attention scores on arctic
    prefill before making that distinction).  A mesh dim that no entry
    names keeps sharding an unnamed dim; one that shards a pinned dim,
    or holds a pending sum, is replicated (all-reduced), as the
    constrained value of JAX's program is a materialized array."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    clean = []
    for a in spec[:x.dim()]:  # decode paths reuse prefill constraints
        a = _resolve(a)
        if a == REP:
            clean.append(REP)
        elif a is not None and a != () and _axis_ok(a, names):
            clean.append(a)
        else:
            clean.append(None)
    clean += [None] * (x.dim() - len(clean))
    if all(c is None for c in clean):
        return x
    named = {}
    for d, a in enumerate(clean):
        if a is not None and a != REP:
            for ax in (a if isinstance(a, (tuple, list)) else (a,)):
                named[names.index(ax)] = d
    new = []
    for m, p in enumerate(x.placements):
        if m in named:
            new.append(Shard(named[m]))
        elif isinstance(p, Partial) or (isinstance(p, Shard)
                                        and clean[p.dim] is not None):
            new.append(Replicate())
        else:
            new.append(p)
    if tuple(new) == tuple(x.placements) and not x.requires_grad:
        return x
    return _Pin.apply(x, tuple(new))


class _Pin(torch.autograd.Function):
    """x laid out as `placements`, and its gradient too: the transpose of
    JAX's sharding constraint constrains the cotangent alike (DTensor's
    own redistribute sends a gradient back to the input's layout, and
    none at all where the layout did not change)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None
