"""Serving launcher for the PyTorch/CUDA port: the EC-DNN_G ensemble
engine behind a CLI, a static batch or continuous batching.

All K members score each step together and their output distributions
are averaged (paper Eqn 6) before sampling; --members 1 serves a single
model through the identical path.  Runs on the card unless --device cpu.

  python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
      --members 4 --batch 4 --prompt-len 16 --steps 16 --paged
  python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
      --members 4 --batch 4 --prompt-len 16 --steps 16 --paged \
      --continuous --requests 12 --prefix-cache

--kv-dtype int8 / fp8 stores the paged pool quantized (per-token scales
the paged kernel applies as it reads; bf16 halves f32 pages).
--draft-ckpt ROOT serves speculative decoding with the student restored
from a checkpoint root (the newest committed step, checkpoint/store.py)
as the draft; --draft-ckpt member0 drafts with member 0's weights.
--gamma sets the drafted tokens an iteration, --spec-sampling
rejection-samples temperature > 0 requests (both with --draft-ckpt).

  python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
      --members 4 --paged --kv-dtype int8 --draft-ckpt member0 --gamma 4

The static batch prints tokens per second (host clock around a generate
call that ends in a device synchronise, after a warm-up call) and a
sample; --continuous serves --requests synthetic requests through the
Scheduler and prints client.print_report's tok/s, TTFT and latency
percentiles.  A speed printed here is only meaningful beside the card's
name and power limit (nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader).
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
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prompt tokens prefilled per scheduler "
                         "iteration (--continuous; default: 2 chunks)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool behind a per-slot page table")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=None,
                    help="physical pages in the pool (--paged; default: "
                         "every slot at full length; fewer oversubscribes "
                         "and relies on preemption)")
    ap.add_argument("--kv-dtype", default="f32",
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="paged KV page storage (--paged): f32 keeps the "
                         "model's dtype; int8 / fp8 quantize each token "
                         "with an absmax scale the kernel applies")
    ap.add_argument("--draft-ckpt", default="",
                    help="speculative decoding: the compressed student at "
                         "this checkpoint root drafts for the ensemble; "
                         "'member0' drafts with member 0's weights")
    ap.add_argument("--gamma", type=int, default=4,
                    help="drafted tokens per speculative iteration "
                         "(--draft-ckpt)")
    ap.add_argument("--spec-sampling", action="store_true",
                    help="rejection-sample temperature > 0 requests "
                         "against the fused distribution instead of "
                         "greedy exact-match acceptance")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV pages across requests with a common "
                         "prompt prefix (--paged, and every layer paged)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--quorum", default="",
                    help="comma 0/1 per member, e.g. 1,1,0,1")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching under synthetic load")
    ap.add_argument("--requests", type=int, default=32,
                    help="synthetic requests (--continuous)")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the observability layer (request "
                         "traces, latency histograms, tick phases)")
    ap.add_argument("--trace-log", default="",
                    help="append one JSON line per finished request "
                         "trace to this file (obs must be on)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="override the config's param/activation dtype")
    args = ap.parse_args(argv)

    from repro_torch.common.device import resolve_device
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving import client
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
    kw = dict(n_slots=args.batch, max_prompt=args.prompt_len,
              max_out=args.steps, prefill_chunk=args.prefill_chunk,
              temperature=args.temperature, top_k=args.top_k,
              eos_id=args.eos_id, quorum=quorum, seed=args.seed,
              paged=args.paged, page_size=args.page_size,
              n_pages=args.n_pages, prefix_cache=args.prefix_cache,
              kv_dtype=args.kv_dtype, device=device)
    if args.draft_ckpt:
        from repro_torch.serving.spec import SpeculativeEngine
        from repro_torch.serving.spec.draft import load_draft
        if args.draft_ckpt != "member0":
            draft, step = load_draft(args.draft_ckpt, params)
            print(f"draft model: step {step} from {args.draft_ckpt}")
        else:
            draft = tree_map(lambda x: x[:1], params)
            print("draft model: member 0")
        engine = SpeculativeEngine(cfg, params, draft, gamma=args.gamma,
                                   spec_sampling=args.spec_sampling, **kw)
    else:
        engine = EnsembleEngine(cfg, params, **kw)
    print(f"engine: K={K} members, {args.batch} slots, prefill chunk "
          f"{engine.prefill_chunk}, {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'}), "
          f"cache pool {engine.cache_bytes() / 2**20:.1f} MiB")
    if args.paged:
        ps = engine.page_stats()
        print(f"paged pool: {ps['n_pages']} pages x {ps['page_size']} tok "
              f"({ps['pages_per_slot']} pages/slot max), free list "
              f"{ps['free_pages']}/{ps['n_pages']}, {ps['kv_dtype']} "
              f"pages, {ps['page_bytes']} B/page, "
              f"{ps['bytes_per_token']} B/token")

    if args.continuous:
        reqs = client.make_requests(
            args.requests, cfg.vocab_size,
            prompt_len=(max(2, args.prompt_len // 4), args.prompt_len),
            max_new=(max(1, args.steps // 2), args.steps), seed=args.seed)
        # warm-up outside the timed run (max_new=2: prefill and decode)
        engine.generate([reqs[0][0]], max_new=2)
        client.print_report(client.run_load(
            engine, reqs, prefill_budget=args.prefill_budget,
            obs=not args.no_obs, trace_log=args.trace_log or None))
        _print_spec(engine)
        return 0

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
    _print_spec(engine)
    return 0


def _print_spec(engine) -> None:
    if hasattr(engine, "spec_stats"):
        st = engine.spec_stats()
        print(f"speculative: gamma {st['gamma']}, {st['spec_steps']} "
              f"iterations, acceptance {st['acceptance_rate']:.3f}, "
              f"{st['mean_accepted_len']:.2f} tokens an iteration")


if __name__ == "__main__":
    raise SystemExit(main())
