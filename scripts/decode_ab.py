#!/usr/bin/env python3
"""Times full-width gemma3-1b decode steps of a given checkout's port on
the card and prints one JSON line: the contiguous slot path
(transformer.decode_step_slots, which the speculative draft and the
dry-run's decode cell take) at K = 1 and the paged path
(decode_step_paged, the engines') at K = 4, both f32 at a batch of 4,
where the host's dispatch sets a step's time.

    python3 scripts/decode_ab.py --root /path/to/checkout

For each path: `sync_ms`, the median wall ms of a step with the card
synchronized after each one (the host's enqueue plus what the card waits
for), and `piped_ms`, the wall ms a step of a run of steps enqueued back
to back, synchronized once at its end.  Run it once per checkout,
alternating (A, B, B, A) in one command on one card, to compare two
versions of the port's host cost a decode step.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

B, START, STEPS, PAGE = 4, 64, 40, 16


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_steps(torch, step, params, cfg, cache, tokens) -> dict:
    """Warm up, then STEPS synchronized steps and STEPS piped ones, each
    run from position START."""
    def run(n, sync_each):
        cache["idx"].fill_(START)
        torch.cuda.synchronize()
        walls = []
        t_all = time.perf_counter()
        for _ in range(n):
            t0 = time.perf_counter()
            step(params, cfg, cache, tokens)
            if sync_each:
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return walls, (time.perf_counter() - t_all) * 1e3 / n
    run(5, True)
    walls, _ = run(STEPS, True)
    _, piped = run(STEPS, False)
    return {"sync_ms": statistics.median(walls), "piped_ms": piped,
            "sync_ms_min": min(walls)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="a checkout holding src/repro_torch")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    if not build.__file__.startswith(root):
        raise AssertionError(f"{build.__file__} is not under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    cfg = registry.get_config("gemma3-1b").with_(dtype="float32")
    max_seq = 256
    tokens = torch.arange(1, B + 1, device="cuda").view(B, 1)
    out = {"root": root, "card": card_line(), "batch": B}
    with torch.no_grad():
        params = tf.init(cfg, seed=0, device="cuda", members=1)
        cache = tf.init_slot_cache(cfg, B, max_seq, device="cuda")
        out["slots_k1"] = time_steps(torch, tf.decode_step_slots, params,
                                     cfg, cache, tokens)
        del params, cache
        K, per_row = 4, max_seq // PAGE
        params = tf.init(cfg, seed=0, device="cuda", members=K)
        cache = tf.init_slot_cache(cfg, B, max_seq, page_size=PAGE,
                                   n_pages=B * per_row, members=K,
                                   device="cuda")
        cache["page_table"].copy_(torch.arange(
            B * per_row, device="cuda").view(1, B, per_row).expand(
                K, B, per_row))
        out["paged_k4"] = time_steps(torch, tf.decode_step_paged, params,
                                     cfg, cache, tokens)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
