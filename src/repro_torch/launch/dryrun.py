"""Multi-node dry-run: trace every (arch x shape) cell on the production
mesh of H100s and extract the roofline terms, with no allocation
anywhere (the counterpart of the JAX package's launch/dryrun.py).

MUST be the process entry point (python -m repro_torch.launch.dryrun
...): the fake world of 256 / 512 ranks (launch/mesh.py) becomes this
process's default process group.

Per cell it builds the step on the mesh (launch/specs.py: DTensor
placements over the fake world, fake local shards), runs it once under
FakeTensorMode and the accounting (launch/cost_analysis.py), and
records:
  - bytes per device: the peak of live tensor storage, inputs included,
    against the card's HBM;
  - flops per device (the reference's convention: every dot product,
    attention's full T x S) and the flops the kernels execute (the
    flash kernel skips masked tiles), HBM bytes as eager execution
    moves them, collective bytes by kind and by link;
  - the three roofline terms on the H100's datasheet rates: compute
    (executed flops over the dense bf16 peak), memory, and collective
    (NVLink inside a node, InfiniBand across), and MODEL_FLOPS / flops.

--device cuda (the default where torch is built with CUDA) traces fake
CUDA tensors, which dispatch as on the card.  --device cpu traces fake
CPU tensors, for a CPU-only build of torch, whose fake CUDA tensors
abort in the device guard.  Either way a fake tensor takes the attention
and recurrence kernels' custom ops (kernels/library.py, kernels/ops.py):
the card's program.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out results.json
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \\
      --variant distill
  python -m repro_torch.launch.dryrun --variant relabel   # every train_4k

--variant relabel accounts the EC round's ring relabel step of each
train_4k cell (launch/specs.build_relabel_cell): K scores of m visiting
rows a member, K - 1 top-M merges, the hops' collective-permutes.  A
train cell of accum > 1 microbatches is traced a microbatch and the
update apart (specs.train_parts) and summed.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Optional

import torch

from repro_torch.common.types import SHAPES, ModelConfig, ShapeConfig


def flops_model(arch: str, shape_name: str,
                cfg: Optional[ModelConfig] = None,
                shape: Optional[ShapeConfig] = None,
                scored_tokens: int = 0) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), D = tokens
    processed per step; decode steps process one token per sequence.
    scored_tokens: a relabel step's forward passes, 2*N_active for each
    token every member scores (all the mesh's members together)."""
    from repro_torch.configs import registry
    cfg = cfg or registry.get_config(arch)
    shape = shape or SHAPES[shape_name]
    if scored_tokens:
        return 2.0 * active_params(cfg) * scored_tokens
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 3.0 if shape.kind == "train" else 1.0  # fwd+bwd vs fwd
    return 2.0 * active_params(cfg) * tokens * mult


def active_params(cfg: ModelConfig) -> float:
    """Parameters a token's forward multiplies: the experts' share of
    them by top_k / n_experts, the untied embedding (a lookup) not."""
    from repro_torch import models
    from repro_torch.common.sharding import leaf_name
    from repro_torch.common.tree import tree_map_with_path
    params = models.init(cfg, device="meta")
    active = 0.0

    def add(path, leaf):
        nonlocal active
        n = leaf.numel()
        name = leaf_name(path)
        if name.startswith("experts"):
            active += n * (cfg.ffn.top_k / max(cfg.ffn.n_experts, 1))
        elif name == "embed" and not cfg.tie_embeddings:
            pass  # lookup is a gather, not a matmul
        else:
            active += n

    tree_map_with_path(add, params)
    return active


def roofline(costs, chips: int, model_flops: float) -> dict:
    """The roofline terms of a Costs on the H100's rates."""
    from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
    t_comp = costs.flops_executed / PEAK_FLOPS_BF16
    t_mem = costs.hbm_bytes / HBM_BW
    by_link = {k: b / LINK_BW[k] for k, b in costs.link_bytes.items()}
    t_coll = sum(by_link.values())
    top = max(t_comp, t_mem, t_coll)
    model_fl = model_flops / chips
    return {
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "t_collective_by_link_s": by_link,
        "dominant": max((t_comp, "compute"), (t_mem, "memory"),
                        (t_coll, "collective"))[1],
        "model_flops_per_dev": model_fl,
        "useful_flops_ratio": model_fl / costs.flops if costs.flops else 0.0,
        "roofline_fraction": t_comp / top if top > 0 else 0.0}


def trace_cell(cell, mesh):
    """Run a cell's step once on its fake inputs under the accounting ->
    (its output, Costs).  Call under the FakeTensorMode that made them.
    A cell given in parts (specs.Cell.parts) traces each part once and
    sums their costs, each times its count (cost_analysis.combine)."""
    import contextlib

    from repro_torch.launch import cost_analysis
    with contextlib.ExitStack() as ctx:
        if mesh.device_mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            ctx.enter_context(implicit_replication())
        if cell.parts is None:
            return cost_analysis.analyze(cell.fn, *cell.args,
                                         links=mesh.links())
        out, costs = None, []
        for _, count, fn, args in cell.parts:
            out, c = cost_analysis.analyze(
                fn, *(args if args is not None else (out,)),
                links=mesh.links())
            costs.append((c, count))
        return out, cost_analysis.combine(costs)


_MESHES: dict = {}


def production_mesh(multi_pod: bool, device: str, world: int = 0):
    """The production mesh, made once a process (over a fake world of
    `world` ranks: 512 serves both meshes)."""
    from repro_torch.launch.mesh import make_production_mesh
    key = (multi_pod, device)
    if key not in _MESHES:
        _MESHES[key] = make_production_mesh(multi_pod=multi_pod,
                                            device=device, world=world)
    return _MESHES[key]


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "plain", device: str = "cuda", mesh=None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None, world: int = 0) -> dict:
    """One cell's record (the reference's keys where the meaning is the
    same).  mesh: the production mesh unless given; cfg / shape replace
    the registry's (a reduced cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import registry
    from repro_torch.kernels import library
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.launch.specs import build_cell, state_bytes

    skip = registry.skip_reason(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skip", "reason": skip}
    mesh = mesh or production_mesh(multi_pod, device, world)
    if mesh.device_mesh is not None:
        library.register_sharding_rules()
    name = "x".join(str(s) for s in mesh.sizes)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           "mesh": name, "variant": variant, "chips": mesh.size,
           "device": device}
    t0 = time.time()
    try:
        with FakeTensorMode():
            cell = build_cell(arch, shape_name, mesh, multi_pod,
                              variant=variant, device=device, cfg=cfg,
                              shape=shape)
            t_build = time.time() - t0
            _, costs = trace_cell(cell, mesh)
        t_trace = time.time() - t0 - t_build
        held = state_bytes(cell, mesh)
        terms = roofline(costs, mesh.size, flops_model(
            arch, shape_name, cfg, cell.shape,
            cell.meta.get("scored_tokens", 0)))
        rec.update({
            "status": "ok", "step": cell.step_name,
            "meta": {k: str(v) for k, v in cell.meta.items()
                     if k not in ("state_specs", "state_meta")},
            "parts": [[name, count] for name, count, _, _ in
                      cell.parts or ()],
            "build_s": round(t_build, 1), "trace_s": round(t_trace, 1),
            "bytes_per_device": int(costs.peak_bytes),
            "state_bytes_per_device": held,
            "fits_hbm": bool(costs.peak_bytes < HBM_BYTES),
            "flops_per_dev": costs.flops,
            "flops_executed_per_dev": costs.flops_executed,
            "hbm_bytes_per_dev": costs.hbm_bytes,
            "collective_bytes": {k: v for k, v in
                                 costs.collective_bytes.items() if v},
            "collective_count": {k: v for k, v in
                                 costs.collective_count.items() if v},
            "collective_bytes_by_link": costs.link_bytes,
            "kernel_calls": costs.kernel_calls, "ops": costs.n_ops,
            **terms,
            "top_flops": costs.top_flops, "top_bytes": costs.top_bytes,
            "top_coll": costs.top_coll})
        print(f"[{arch} x {shape_name} x {name} {variant}] OK "
              f"{rec['trace_s']}s trace | "
              f"{costs.peak_bytes / 2 ** 30:.2f} GiB/dev "
              f"(fits={rec['fits_hbm']}) | flops/dev {costs.flops:.3e} "
              f"(executed {costs.flops_executed:.3e}) | t_comp "
              f"{terms['t_compute_s'] * 1e3:.2f}ms t_mem "
              f"{terms['t_memory_s'] * 1e3:.2f}ms t_coll "
              f"{terms['t_collective_s'] * 1e3:.2f}ms -> "
              f"{terms['dominant']}-bound", flush=True)
        print(f"    collectives: {rec['collective_count']}", flush=True)
    except Exception as e:  # noqa: BLE001  (a cell's failure is its record)
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        print(f"[{arch} x {shape_name}] FAIL {type(e).__name__}: "
              f"{str(e)[:300]}", flush=True)
    return rec


def _in_children(cells, meshes, args) -> list:
    """Every (cell, mesh) in a child process of its own (its own fake
    world), args.jobs at once -> their records in the cells' order; each
    child's output is printed as it ends."""
    import os
    import subprocess
    import sys
    import tempfile
    flags = ["--variant", args.variant, "--device", args.device]
    flags += ["--reduced"] if args.reduced else []
    flags += ["--mesh", args.mesh] if args.mesh else []
    todo = [(a, s, mp) for a, s in cells for mp in meshes]
    out, running = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        while todo or running:
            while todo and len(running) < args.jobs:
                key = todo.pop(0)
                stem = os.path.join(tmp, ".".join(map(str, key)))
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", key[0], "--shape", key[1], "--out",
                       stem + ".json", *flags] + \
                    (["--multi-pod"] if key[2] else [])
                log = open(stem + ".log", "w")
                running.append((key, stem, log, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
            done = [r for r in running if r[3].poll() is not None]
            if not done:
                time.sleep(0.5)
            for r in done:
                running.remove(r)
                key, stem, log, proc = r
                log.close()
                with open(stem + ".log") as f:
                    text = f.read()
                print(text, end="", flush=True)
                try:
                    with open(stem + ".json") as f:
                        out[key] = json.load(f)[0]
                except (OSError, ValueError, IndexError):
                    out[key] = {"arch": key[0], "shape": key[1],
                                "multi_pod": key[2], "status": "fail",
                                "error": f"child exited {proc.returncode}",
                                "traceback": text[-2000:]}
    return [out[(a, s, mp)] for a, s in cells for mp in meshes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", default="plain",
                    choices=["plain", "distill", "relabel"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="the registry's reduced configs (a quick check)")
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) mesh in place of the "
                         "production one")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (its own fake world)")
    ap.add_argument("--device", choices=["cuda", "cpu"],
                    default="cuda" if torch.backends.cuda.is_built()
                    else "cpu",
                    help="the device the fake tensors claim (default: "
                         "cuda where torch is built with CUDA, else cpu)")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    if args.all:
        cells = list(registry.all_cells())
    else:
        shapes = [args.shape] if args.shape else list(SHAPES)
        archs = [args.arch] if args.arch else list(registry.LM_ARCH_IDS)
        cells = [(a, s) for a in archs for s in shapes]
    if args.variant == "relabel":   # a training cell's aggregation step
        cells = [(a, s) for a, s in cells if SHAPES[s].kind == "train"]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    world = 512 if True in meshes else 256
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(tuple(int(x) for x in args.mesh.split("x")),
                         ("data", "model"), args.device)
    results = []
    if args.jobs > 1:
        results = _in_children(cells, meshes, args)
    for arch, shape in cells if args.jobs <= 1 else ():
        for mp in meshes:
            cfg = registry.get_config(arch, reduced=True) \
                if args.reduced else None
            results.append(run_cell(arch, shape, mp, variant=args.variant,
                                    device=args.device, world=world,
                                    mesh=mesh, cfg=cfg))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"== {n_ok} ok / {n_skip} skip / {n_fail} fail ==")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
