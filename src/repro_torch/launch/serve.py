"""Serving launcher for the PyTorch/CUDA port: the EC-DNN_G ensemble
engine behind a CLI, static batch.

All K members score each step together and their output distributions
are averaged (paper Eqn 6) before sampling; --members 1 serves a single
model through the identical path.  Runs on the card unless --device cpu.

  python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
      --members 4 --batch 4 --prompt-len 16 --steps 16 --paged

Prints tokens per second (host clock around a generate call that ends
in a device synchronise, after a warm-up call) and a sample.  A speed
printed here is only meaningful beside the card's name and power limit
(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--members", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16,
                    help="max new tokens per request")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per prefill call (0: per-token "
                         "reference path; default: from --prompt-len and "
                         "--page-size)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool behind a per-slot page table")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--quorum", default="",
                    help="comma 0/1 per member, e.g. 1,1,0,1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="override the config's param/activation dtype")
    args = ap.parse_args(argv)

    from repro_torch.common.device import resolve_device
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    if args.dtype:
        cfg = cfg.with_(dtype=args.dtype)
    K = args.members
    quorum = ([float(x) for x in args.quorum.split(",")]
              if args.quorum else None)
    if quorum is not None and len(quorum) != K:
        raise SystemExit(f"--quorum needs {K} entries, got {len(quorum)}")
    params = tf.init(cfg, seed=args.seed, device=device, members=K)
    engine = EnsembleEngine(
        cfg, params, n_slots=args.batch, max_prompt=args.prompt_len,
        max_out=args.steps, prefill_chunk=args.prefill_chunk,
        temperature=args.temperature, top_k=args.top_k, eos_id=args.eos_id,
        quorum=quorum, seed=args.seed, paged=args.paged,
        page_size=args.page_size, n_pages=args.n_pages, device=device)
    print(f"engine: K={K} members, {args.batch} slots, prefill chunk "
          f"{engine.prefill_chunk}, {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'}), "
          f"cache pool {engine.cache_bytes() / 2**20:.1f} MiB")
    if args.paged:
        print(f"paged pool: {engine.n_pages} pages x {args.page_size} tok "
              f"({engine.pages_per_slot} pages/slot max)")

    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    engine.generate(list(prompt), max_new=args.steps)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = engine.generate(list(prompt), max_new=args.steps)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"served batch={args.batch} members={K} steps={args.steps}: "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print("sample:", outs[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
