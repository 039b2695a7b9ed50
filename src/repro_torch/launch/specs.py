"""Dry-run cell construction: (arch x shape x mesh) -> a step and its
abstract inputs (the counterpart of the JAX package's launch/specs.py).

For every cell this module builds
  - the step function (the builders the Trainer and the serving engine
    use: runtime/steps.py),
  - its inputs as fake tensors (FakeTensorMode: shapes, dtypes and the
    claimed device, no storage anywhere) laid out by the specs below:
    over a mesh of more than one device each input is a DTensor whose
    local shard is fake, on one device a plain fake tensor.

Step per shape kind:
  train_4k     the EC local-training step over member-stacked state
               (plain CE; the distill variant takes top-64 TopM
               pseudo-labels).  A step of accum > 1 microbatches is
               traced in pieces (its first microbatch, a later one
               counted accum - 1 times, the optimizer's update), as the
               reference compiles one scan body.  The relabel variant is
               the JAX package's ring relabel step: one member a rank of
               the ensemble axis scores m = int(b x relabel_fraction)
               visiting rows over its own mesh (the "model" axis; the
               whole mesh where K = 1) through the forward-only route
               and the flash op, merges the top-64 candidates and passes
               rows and accumulator on (a collective-permute), traced a
               piece each (aggregation.ring_score / ring_merge /
               ring_hop, the Trainer's own) and counted as the ring runs
               them: K scores, K - 1 merges and batch hops, K
               accumulator hops (the last one home);
  prefill_32k  transformer.prefill: single-model forward, last-token
               logits;
  decode_*     one token against a seq_len cache: the port's contiguous
               slot path (init_slot_cache / decode_step_slots) at K = 1,
               the member dim replicated.  The JAX package's decode cell
               runs init_cache / decode_step, one shared position; the
               slot path keeps one a row, the same work.

Specs are tuples with one entry per dim (launch/../common/sharding.py);
the port's leaves carry a leading member dim (K, and K = 1 in a
single-model cell, replicated), which the JAX package's serving params
do not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.common.sharding import (leaf_name, make_param_pspecs,
                                         mesh_sizes, placements)
from repro_torch.common.tree import tree_map, tree_map_with_path
from repro_torch.common.types import (ECConfig, ModelConfig, ParallelConfig,
                                      SHAPES, ShapeConfig)
from repro_torch.configs import registry


def filter_par(par: ParallelConfig, mesh) -> ParallelConfig:
    """Drop axes the active mesh doesn't have (e.g. 'pod' single-pod)."""
    names = set(mesh.axis_names)
    return dataclasses.replace(
        par,
        batch_axes=tuple(a for a in par.batch_axes if a in names),
        ensemble_axis=par.ensemble_axis if par.ensemble_axis in names
        else ("" if par.ensemble_axis else par.ensemble_axis),
        fsdp_axis=par.fsdp_axis if par.fsdp_axis in names else "",
        seq_axis=par.seq_axis if par.seq_axis in names else "")


# ---------------------------------------------------------------------------
# per-arch member counts / batch splits
# ---------------------------------------------------------------------------

def ensemble_k(arch: str, mesh, par: ParallelConfig) -> int:
    if not par.ensemble_axis:
        return max(par.ensemble_size, 1)
    if par.ensemble_size:
        return par.ensemble_size
    return mesh.shape[par.ensemble_axis]


def _grad_accum(arch: str, shape: ShapeConfig, mesh, k: int,
                par: ParallelConfig, cfg: Optional[ModelConfig] = None
                ) -> int:
    """Microbatch so each device step holds ~1-2 sequences of activations."""
    per_member = shape.global_batch // k
    if registry.size_class(arch) == "big":
        data = mesh.shape.get("data", 1)
        return max(1, per_member // data)  # -> microbatch 1/device
    pod = mesh.shape.get("pod", 1)
    # recurrent paths carry fatter per-token state: halve the microbatch
    # for the ssm family
    cfg = cfg or registry.get_config(arch)
    target = 2 if cfg.family == "ssm" else 4
    return max(1, per_member // (target * pod))


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def _lm_batch(cfg: ModelConfig, k: int, b: int, t: int) -> Dict:
    """{name: (shape, dtype)} of an LM batch; k = 0 for a single model
    (its rows shared by the K = 1 member)."""
    lead = (k, b, t) if k else (b, t)
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        # frontend stub: precomputed patch/text embeddings (M-RoPE)
        batch["embeds"] = (lead + (cfg.d_model,), torch.bfloat16)
    else:
        batch["tokens"] = (lead, torch.int32)
    if cfg.enc_dec:
        enc_lead = (k, b) if k else (b,)
        batch["enc_embeds"] = (enc_lead + (cfg.enc_max_frames, cfg.d_model),
                               torch.bfloat16)
    batch["labels"] = (lead, torch.int32)
    return batch


def _batch_pspec(cfg: ModelConfig, par: ParallelConfig, k: int) -> Dict:
    ens = par.ensemble_axis or None
    ba = tuple(par.batch_axes) or None
    lead = (ens, ba) if k else (ba,)
    out: Dict[str, tuple] = {}
    if cfg.family == "vlm":
        out["embeds"] = (*lead, None, None)
    else:
        out["tokens"] = (*lead, None)
    if cfg.enc_dec:
        out["enc_embeds"] = (*lead, None, None)
    out["labels"] = (*lead, None)
    return out


# ---------------------------------------------------------------------------
# cache specs (decode)
# ---------------------------------------------------------------------------

def cache_pspecs(cfg: ModelConfig, cache: Any, par: ParallelConfig,
                 mesh) -> Any:
    """Name+shape-driven layout of an init_slot_cache cache (the JAX
    package's rule over its init_cache leaves): full-attention K/V (B, S,
    kv, dh) shard kv heads over "model" when divisible, else the sequence
    (seq-sharded KV decode); MLA latents and recurrent states shard their
    channel dim; the batch always over the batch role's axes.  The port's
    leaves carry (K, count) before those dims ("enc" and "idx" (K, ...)),
    replicated; "idx" holds a position a row, replicated."""
    sizes = mesh_sizes(mesh)
    ba = tuple(par.batch_axes) or None
    if ba is not None and len(ba) == 1:
        ba = ba[0]
    msize = sizes[par.model_axis]

    def axsize(axes) -> int:
        n = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            n *= sizes.get(a, 1)
        return n

    def rule(name, shape):
        nd = len(shape)
        bspec = ba if (ba is None or shape[0] % axsize(ba) == 0) else None
        m = par.model_axis
        if name in ("k", "v"):  # (B, S, kv, dh)
            if shape[2] % msize == 0:
                return (bspec, None, m, None)
            if shape[1] % msize == 0:
                return (bspec, m, None, None)
            return (bspec, None, None, None)
        if name in ("c_kv", "k_r"):  # (B, S, r)
            return (bspec, m if shape[1] % msize == 0 else None, None)
        if name == "ssm":  # (B, d_inner, N)
            return (bspec, m, None)
        if name == "conv":  # (B, W-1, d_inner)
            return (bspec, None, m)
        if name == "wkv":  # (B, H, dh, dh)
            return (bspec, m if shape[1] % msize == 0 else None, None, None)
        if name in ("shift", "cmix_shift", "enc"):  # (B, 1|S, d)
            return (bspec, None, None)
        return (None,) * nd

    def leaf(path, x):
        name = leaf_name(path)
        if name == "idx":
            return (None,) * x.dim()
        lead = 2 if path[0] == "segments" else 1   # (K, count) / (K,)
        return (None,) * lead + rule(name, tuple(x.shape[lead:]))

    return tree_map_with_path(leaf, cache)


def abstract_pspecs_like(opt_state: Any, p_pspec: Any) -> Any:
    """Optimizer-state specs: moments mirror their parameter, scalars (the
    (K,) step) replicate."""
    out = {}
    for key, sub in opt_state.items():
        if key in ("m", "v", "mu"):
            out[key] = p_pspec
        else:
            out[key] = tree_map(lambda x: (None,) * x.dim(), sub)
    return out


# ---------------------------------------------------------------------------
# abstract tensors
# ---------------------------------------------------------------------------

def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A rank's shard of `shape` under `spec` (rank 0's: the largest)."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, a in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for x in (() if a is None else (a if isinstance(a, (tuple, list))
                                        else (a,))):
            n *= sizes.get(x, 1)
        out.append(-(-dim // n))
    return tuple(out)


def local_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes a rank holds of a tree of tensors (any device, meta
    included) laid out by `specs`."""
    total = 0

    def add(_, x, spec):
        nonlocal total
        n = 1
        for d in local_shape(tuple(x.shape), spec, mesh):
            n *= d
        total += n * x.element_size()

    tree_map_with_path(lambda p, x: add(p, x, _at(specs, p)), tree)
    return total


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def abstract(shape, dtype, spec, mesh, device: str):
    """A fake tensor of `shape` (call under the FakeTensorMode): a DTensor
    of fake local shards laid out by `spec` over a multi-device mesh, a
    plain one on one device."""
    if mesh.device_mesh is None:
        return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    loc = torch.empty(_local_exact(shape, spec, mesh), dtype=dtype,
                      device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(loc, mesh.device_mesh,
                              placements(spec, mesh.device_mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _local_exact(shape, spec, mesh):
    """DTensor's own local shape of rank 0 (torch.chunk's split)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        return tuple(compute_local_shape_and_global_offset(
            torch.Size(shape), mesh.device_mesh,
            placements(spec, mesh.device_mesh))[0])


def abstract_tree(tree: Any, specs: Any, mesh, device: str,
                  dtype: Optional[torch.dtype] = None) -> Any:
    """abstract() of every leaf of a tree of tensors (meta ones) or of
    (shape, dtype) pairs."""
    def one(path, x):
        spec = _at(specs, path)
        if isinstance(x, torch.Tensor):
            return abstract(tuple(x.shape), dtype or x.dtype, spec, mesh,
                            device)
        return abstract(x[0], x[1], spec, mesh, device)
    return tree_map_with_path(
        one, tree, is_leaf=lambda x: isinstance(x, tuple)
        and len(x) == 2 and isinstance(x[1], torch.dtype))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """fn(*args) is the step.  parts, where given, is the step traced
    in pieces, [(name, times it runs, fn, args)]: fn(*args), or, where
    args is None, fn(the previous piece's output); the accounting sums
    them (cost_analysis.combine)."""
    arch: str
    shape: ShapeConfig
    step_name: str
    fn: Optional[Callable]
    args: Optional[Tuple]
    meta: Dict[str, Any]
    parts: Optional[List[Tuple[str, int, Callable, Optional[Tuple]]]] = None


def train_state_meta(cfg: ModelConfig, arch: str, k: int,
                     par: ParallelConfig, mesh):
    """Member-stacked params and AdamW state as meta tensors, with their
    specs -> (state, state specs, optimizer)."""
    from repro_torch import models
    from repro_torch.optim import adamw
    params = models.init(cfg, device="meta", members=k)
    # bf16 Adam moments for the big archs: optimizer state for a 405B
    # member must fit its 256-device pod alongside params + activations
    moment = torch.bfloat16 if registry.size_class(arch) == "big" \
        else torch.float32
    opt = adamw(1e-4, moment_dtype=moment)
    p_spec = make_param_pspecs(params, par, ensemble=bool(par.ensemble_axis),
                               mesh=mesh, lead=0 if par.ensemble_axis else 1)
    moments = tree_map(lambda p: torch.empty(p.shape, dtype=moment,
                                             device="meta"), params)
    opt_meta = {"m": moments, "v": moments,
                "step": torch.empty((k,), dtype=torch.int32, device="meta")}
    state = {"params": params, "opt": opt_meta}
    specs = {"params": p_spec, "opt": abstract_pspecs_like(opt_meta, p_spec)}
    return state, specs, opt


def build_train_cell(arch: str, mesh, multi_pod: bool,
                     variant: str = "plain", ec: Optional[ECConfig] = None,
                     device: str = "cuda", cfg: Optional[ModelConfig] = None,
                     shape: Optional[ShapeConfig] = None) -> Cell:
    """variant: plain | distill (the local step) | relabel (the ring's
    step, build_relabel_cell).  Call under the FakeTensorMode the step
    will run in.  cfg / shape replace the registry's (a test's reduced
    cell)."""
    from repro_torch.runtime import steps
    shape = shape or SHAPES["train_4k"]
    cfg = cfg or registry.get_config(arch)
    ec = ec or ECConfig(label_mode="topk", top_m=64)
    if variant == "relabel":
        return build_relabel_cell(arch, mesh, multi_pod, ec, device, cfg,
                                  shape)
    par = filter_par(registry.parallel_policy(arch, shape, multi_pod), mesh)
    k = ensemble_k(arch, mesh, par)
    b = shape.global_batch // k
    accum = _grad_accum(arch, shape, mesh, k, par, cfg)
    metas, s_spec, opt = train_state_meta(cfg, arch, k, par, mesh)
    state = abstract_tree(metas, s_spec, mesh, device)
    b_pspec = _batch_pspec(cfg, par, k)
    meta = {"k": k, "per_member": b, "accum": accum, "par": par,
            "state_specs": s_spec, "state_meta": metas}

    batch = abstract_tree(_lm_batch(cfg, k, b, shape.seq_len), b_pspec, mesh,
                          device)
    step = steps.make_local_step(cfg, opt, par=par, grad_accum=accum)
    if variant == "plain":
        return Cell(arch, shape, "train_step[plain]",
                    lambda s, bb: step(s, bb, None, 0.0), (state, batch),
                    meta, train_parts(step, (state, batch), 0.0, accum))
    from repro_torch.core.compression import TopM
    ens = par.ensemble_axis or None
    ba = tuple(par.batch_axes) or None
    lead = (k, b, shape.seq_len)
    pseudo = TopM(abstract(lead + (ec.top_m,), torch.float32,
                           (ens, ba, None, None), mesh, device),
                  abstract(lead + (ec.top_m,), torch.int32,
                           (ens, ba, None, None), mesh, device),
                  abstract(lead, torch.float32, (ens, ba, None), mesh,
                           device))
    return Cell(arch, shape, "train_step[distill]",
                lambda s, bb, ps: step(s, bb, ps, 0.25),
                (state, batch, pseudo), meta,
                train_parts(step, (state, batch, pseudo), 0.25, accum))


def train_parts(step, args: Tuple, lam: float, accum: int):
    """A local step of accum > 1 microbatches (steps.make_local_step) as
    pieces: the loop's first body (it makes the f32 accumulators), a
    later body (run accum - 1 times) and the mean with the optimizer's
    update, each fed the previous one's output.  None where accum is 1
    (one trace of the whole step)."""
    if accum <= 1:
        return None
    grads = step.member_grads

    def body(i):
        def fn(prev):
            state, batch, pseudo, acc, loss = (tuple(prev) + (None,) * 3)[:5]
            params = tree_map(lambda p: p.detach().requires_grad_(),
                              state["params"])
            with step.layout():
                acc, loss = grads.micro(params, batch, pseudo, lam, i, acc,
                                        0.0 if loss is None else loss)
            return state, batch, pseudo, acc, loss
        return fn

    def update(prev):
        state, _, _, acc, loss = prev
        loss, flat = grads.finish(acc, loss)
        it = iter(flat)
        return step.apply(state, loss,
                          tree_map(lambda _: next(it), state["params"]))

    return [("microbatch 0", 1, body(0), (args,)),
            ("microbatch", accum - 1, body(1), None),
            ("update", 1, update, None)]


def member_mesh(mesh, axis: Optional[str]):
    """The mesh one member spans: every dim of `mesh` but its members'
    `axis` (None: the whole mesh), as a launch.mesh.Mesh."""
    from repro_torch.launch.mesh import Mesh
    names = tuple(a for a in mesh.axis_names if a != axis)
    sizes = tuple(mesh.shape[a] for a in names)
    n = 1
    for x in sizes:
        n *= x
    sub = None
    if mesh.device_mesh is not None and n > 1:
        sub = mesh.device_mesh[names if len(names) > 1 else names[0]]
    return Mesh(names, sizes, sub)


def _visiting(cfg: ModelConfig, n: int, t: int) -> Dict:
    """The rows a ring hop moves: a batch's inputs, not its labels."""
    rows = _lm_batch(cfg, 0, n, t)
    rows.pop("labels")
    return rows


def build_relabel_cell(arch: str, mesh, multi_pod: bool, ec: ECConfig,
                       device: str, cfg: ModelConfig,
                       shape: ShapeConfig) -> Cell:
    """The ring relabel step of one rank (the JAX package's relabel_step
    cell: m = max(1, int(b x relabel_fraction)) rows a member, top-M
    labels, the members on par.ensemble_axis or "data").  Its member's
    params (a leading 1) lie over the member's own mesh by the training
    policy's rules; the visiting rows and the accumulator are
    replicated there (the ring moves whole rows, as the reference's
    shard_map over the members' axis does): DTensors where the score
    reads them, plain tensors (each rank's copy) where the merge and
    the hops do.  Pieces, each traced once
    and counted as ring_relabel runs it: the score of a chunk of rows
    (aggregation.chunk_rows; every chunk of the K scores), the top-M
    merge, a hop of rows and accumulator, the home hop.  Where K = 1 the
    ring is the member's score of its own rows."""
    from repro_torch import models
    from repro_torch.common.sharding import REP, layout_ctx
    from repro_torch.core import aggregation as agg
    from repro_torch.core.compression import TopM
    from repro_torch.runtime import steps
    par = filter_par(registry.parallel_policy(arch, shape, multi_pod), mesh)
    k = ensemble_k(arch, mesh, par)
    b = shape.global_batch // k
    m = max(1, int(b * ec.relabel_fraction))
    axis = par.ensemble_axis or "data"
    if k > 1 and mesh.shape.get(axis) != k:
        raise ValueError(f"the ring holds one member a rank: {k} members "
                         f"on {mesh.shape.get(axis)} ranks along {axis!r}")
    own = member_mesh(mesh, axis if k > 1 else None)
    mpar = dataclasses.replace(par, ensemble_axis="", batch_axes=())
    params = models.init(cfg, device="meta", members=1)
    p_spec = make_param_pspecs(params, mpar, ensemble=False, mesh=own,
                               lead=1)
    T, V = shape.seq_len, cfg.vocab_size
    rows_meta = _visiting(cfg, m, T)
    rep = {name: (None,) * len(x[0]) for name, x in rows_meta.items()}
    chunk = min(m, agg.chunk_rows(
        {n: torch.empty(x[0], device="meta") for n, x in rows_meta.items()},
        V))
    logits_fn = steps.make_logits_fn(cfg)
    pooled = steps.routes_by_pool(cfg)

    def rows(n):
        return abstract_tree(_visiting(cfg, n, T), rep, own, device)

    def topm():
        # replicated over the member's mesh: every rank merges and sends
        # its own copy, as plain tensors
        return TopM(torch.empty((m, T, ec.top_m), dtype=torch.float32,
                                device=device),
                    torch.empty((m, T, ec.top_m), dtype=torch.int32,
                                device=device),
                    torch.empty((m, T), dtype=torch.float32, device=device))

    def score(p, visiting):
        with layout_ctx(batch=REP):   # the rows stay whole on every rank
            return agg.ring_score(p, visiting, logits_fn, ec, n_out=V,
                                  pooled=pooled)

    p_args = abstract_tree(params, p_spec, own, device)
    parts = [("score", k * (m // chunk), score, (p_args, rows(chunk)))]
    if m % chunk:
        parts.append(("score (last chunk)", k, score,
                      (p_args, rows(m % chunk))))
    if k > 1:
        dm = mesh.device_mesh
        parts += [
            ("merge", k - 1, lambda a, c: agg.ring_merge(a, c, ec),
             (topm(), topm())),
            ("hop", k - 1, lambda bt, a: agg.ring_hop((bt, a), dm, axis),
             ({n: torch.empty(x[0], dtype=x[1], device=device)
               for n, x in rows_meta.items()}, topm())),
            ("home", 1, lambda a: agg.ring_hop(a, dm, axis), (topm(),))]
    meta = {"k": k, "per_member": m, "accum": 1, "par": par,
            "ring_axis": axis if k > 1 else "", "hops": k - 1,
            "chunk_rows": chunk, "member_mesh": own.shape,
            # every member scores every member's m rows
            "scored_tokens": k * k * m * T,
            "state_specs": {"params": p_spec},
            "state_meta": {"params": params}}
    return Cell(arch, shape, "relabel_step", None, None, meta, parts)


def serve_par(arch: str, shape: ShapeConfig, mesh,
              multi_pod: bool) -> ParallelConfig:
    """A serving cell's layout: the policy on this mesh, less the batch
    axes that don't divide the shape's batch (long_500k's B = 1)."""
    par = filter_par(registry.parallel_policy(arch, shape, multi_pod), mesh)
    sizes = mesh_sizes(mesh)

    def axsize(axes):
        n = 1
        for a in axes:
            n *= sizes.get(a, 1)
        return n

    B = shape.global_batch
    if B % axsize(par.batch_axes) != 0:
        keep = []
        for a in par.batch_axes:
            if B % axsize(keep + [a]) == 0:
                keep.append(a)
        par = dataclasses.replace(par, batch_axes=tuple(keep))
    return par


def build_serve_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
                     device: str = "cuda", cfg: Optional[ModelConfig] = None,
                     shape: Optional[ShapeConfig] = None) -> Cell:
    from repro_torch import models
    from repro_torch.models import transformer
    from repro_torch.runtime import steps
    shape = shape or SHAPES[shape_name]
    cfg = cfg or registry.get_config(arch)
    par = serve_par(arch, shape, mesh, multi_pod)
    B = shape.global_batch

    params = models.init(cfg, device="meta")
    p_pspec = make_param_pspecs(params, par, ensemble=False, mesh=mesh,
                                lead=1)
    prefill_fn, decode_fn = steps.make_serve_fns(cfg, par)
    ba = tuple(par.batch_axes) or None
    meta = {"k": 1, "per_member": B, "accum": 1, "par": par,
            "state_specs": {"params": p_pspec},
            "state_meta": {"params": params}}
    args_params = abstract_tree(params, p_pspec, mesh, device)

    if shape.kind == "prefill":
        batch = _lm_batch(cfg, 0, B, shape.seq_len)
        batch.pop("labels")
        b_pspec = _batch_pspec(cfg, par, 0)
        b_pspec.pop("labels")
        return Cell(arch, shape, "prefill_step", prefill_fn,
                    (args_params, abstract_tree(batch, b_pspec, mesh,
                                                device)), meta)

    cache = transformer.init_slot_cache(cfg, B, shape.seq_len,
                                        device="meta")
    c_pspec = cache_pspecs(cfg, cache, par, mesh)
    tok = abstract((B, 1), torch.int32, (ba, None), mesh, device)
    meta["state_specs"]["cache"] = c_pspec
    meta["state_meta"]["cache"] = cache
    return Cell(arch, shape, "serve_step", decode_fn,
                (args_params, abstract_tree(cache, c_pspec, mesh, device),
                 tok), meta)


def build_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
               variant: str = "plain", device: str = "cuda",
               cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None) -> Cell:
    if (shape or SHAPES[shape_name]).kind == "train":
        return build_train_cell(arch, mesh, multi_pod, variant=variant,
                                device=device, cfg=cfg, shape=shape)
    return build_serve_cell(arch, shape_name, mesh, multi_pod,
                            device=device, cfg=cfg, shape=shape)


def state_bytes(cell: Cell, mesh) -> Dict[str, int]:
    """Bytes a rank holds of each piece of the cell's state (params,
    optimizer state, cache), from the specs."""
    return {k: local_bytes(cell.meta["state_meta"][k],
                           cell.meta["state_specs"][k], mesh)
            for k in cell.meta["state_meta"]}

