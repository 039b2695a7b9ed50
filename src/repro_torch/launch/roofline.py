"""Render the dry-run's roofline table from its JSON records (the
counterpart of the JAX package's benchmarks/roofline.py).

  python -m repro_torch.launch.roofline --in results/dryrun_single.json

The terms are the H100's datasheet rates (launch/mesh.py); t_coll is
NVLink inside a node plus InfiniBand across nodes.
"""
from __future__ import annotations

import argparse
import json


def fmt_row(r) -> str:
    if r["status"] == "skip":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | skip |"
                f" {r['reason']} | — |")
    if r["status"] == "fail":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | FAIL |"
                f" {r['error'][:60]} | — |")
    tc, tm, tl = r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]
    shape = r["shape"] + ("[relabel]" if r.get("variant") == "relabel"
                          else "")
    return ("| {arch} | {shape} | {gib:.1f}{fit} | {tc:.3g} | {tm:.3g} | "
            "{tl:.3g} | {dom} | {ratio:.2f} | {s:.0f} |").format(
        arch=r["arch"], shape=shape,
        gib=r["bytes_per_device"] / 2 ** 30,
        fit="" if r["fits_hbm"] else "!",
        tc=tc, tm=tm, tl=tl, dom=r["dominant"],
        ratio=r.get("useful_flops_ratio", 0.0),
        s=r["build_s"] + r["trace_s"])


def main(argv=None) -> int:
    from repro_torch.launch.mesh import HBM_BYTES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--in", dest="inp", default="results/dryrun_single.json")
    args = ap.parse_args(argv)
    try:
        with open(args.inp) as f:
            recs = json.load(f)
    except FileNotFoundError:
        print(f"(no dry-run results at {args.inp}; run "
              f"python -m repro_torch.launch.dryrun --all --out {args.inp})")
        return 0
    print("| arch | shape | GiB/dev | t_comp(s) | t_mem(s) | t_coll(s) "
          "| dominant | 6ND/flops | trace s |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        print(fmt_row(r))
    ok = [r for r in recs if r["status"] == "ok"]
    if ok:
        fits = sum(r["fits_hbm"] for r in ok)
        print(f"\n{len(ok)} traced, {fits} fit {HBM_BYTES / 2 ** 30:.1f} "
              f"GiB HBM; {sum(r['status'] == 'skip' for r in recs)} "
              f"documented skips; "
              f"{sum(r['status'] == 'fail' for r in recs)} failures")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
