#!/usr/bin/env python3
"""Runs some phases of a given checkout's chip_smoke.py on the card, with
that checkout's port, and prints their rows and each phase's seconds.

    python3 scripts/phase_ab.py --root /path/to/checkout --phases 5,14

Run it once per checkout, alternating (A, B, B, A) in one command on one
card, to compare two versions of the port end to end: each run builds
the checkout's kernels into its own build/ and imports its chip_smoke.py
and src/, so a phase's code and its asserts are that checkout's.  A
phase takes (torch, np, card) or, for the kernel phases, (torch, flush,
card).  The serving phases (2, 8, 9, 12, 16) run the checkout's
`serve_phase` with the arguments its `main` gives them.  The last line
is one JSON object: the checkout, the card and each phase's wall
seconds.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import time

# serving phase -> serve_phase's (arch, keyword arguments), as in main()
SERVE = {2: ("gemma3-1b", {}),
         8: ("deepseek-7b", dict(init_limit=60e9)),
         9: ("rwkv6-7b", dict(init_limit=60e9)),
         12: ("jamba-v0.1-52b", dict(members=2, n_layers=8,
                                     init_limit=60e9)),
         16: ("deepseek-v2-236b", dict(n_layers=2, init_limit=60e9))}

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="a checkout holding chip_smoke.py and src/")
    ap.add_argument("--phases", required=True,
                    help="comma-separated phase numbers, run in order")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)   # ranks a phase spawns import chip_smoke
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("phase_ab: no CUDA device is available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs   # its functions pickle by name
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build
    if not build.__file__.startswith(root):
        raise AssertionError(f"{build.__file__} is not under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    t0 = time.perf_counter()
    build.build_all()
    seconds = {"build": time.perf_counter() - t0}
    for n in args.phases.split(","):
        t0 = time.perf_counter()
        if int(n) in SERVE:
            arch, kw = SERVE[int(n)]
            cs.serve_phase(torch, np, card, arch, int(n), **kw)
            torch.cuda.synchronize()
            seconds[f"phase{n}"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            continue
        fn = getattr(cs, f"phase{n}")
        names = list(inspect.signature(fn).parameters)
        if names[:2] == ["torch", "flush"]:
            flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8,
                                device="cuda")
            fn(torch, flush, card)
            del flush
        elif names[:2] == ["torch", "np"]:
            fn(torch, np, card)
        else:
            fn(torch)
        torch.cuda.synchronize()
        seconds[f"phase{n}"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "seconds": seconds}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
