"""Synthetic load generator + latency reporting for the serving engine.

Generates a stream of token-id requests with mixed prompt/output
lengths, pushes them through a Scheduler in process, and reports the
numbers a serving SLO cares about: aggregate tok/s, time-to-first-token,
per-request latency percentiles, and scheduler health (preemptions, peak
live slots, paged free-list low-water mark, prefix-cache hits).  The
port's copy of the JAX package's in-process half; the HTTP half comes
with the network tier.  On the card a report's times are host clocks
around work that ends in a device read (every tick's harvest).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.scheduler import Completion, Scheduler


def make_requests(n: int, vocab: int, prompt_len=(4, 24), max_new=(8, 32),
                  seed: int = 0):
    """-> list of (tokens, max_new) with lengths uniform in the ranges."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        gen = int(rng.integers(max_new[0], max_new[1] + 1))
        reqs.append((rng.integers(0, vocab, size=plen, dtype=np.int32), gen))
    return reqs


def percentile(xs: Sequence[float], p: float) -> float:
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else 0.0


def run_load(engine: EnsembleEngine, requests, prefill_budget=None,
             obs: bool = True, trace_log=None) -> dict:
    """Serve `requests` through a fresh Scheduler; -> stats report dict.
    obs=False runs the kill-switch scheduler (no traces/histograms)."""
    sched = Scheduler(engine, prefill_budget=prefill_budget, obs=obs,
                      trace_log=trace_log)
    for tokens, max_new in requests:
        sched.submit(tokens, max_new)
    t0 = time.time()
    completions = sched.run()
    wall = time.time() - t0
    if sched.obs is not None and trace_log:
        sched.obs.close()
    return build_report(completions, wall, engine, sched=sched)


def build_report(completions: Dict[int, Completion], wall: float,
                 engine: EnsembleEngine,
                 sched: Optional[Scheduler] = None) -> dict:
    gen_tokens = sum(len(c.tokens) for c in completions.values())
    ttft = [c.ttft for c in completions.values()]
    lat = [c.latency for c in completions.values()]
    page_stats = engine.page_stats()
    return {
        "n_requests": len(completions),
        "members": engine.n_members,
        "slots": engine.n_slots,
        "gen_tokens": gen_tokens,
        "wall_s": wall,
        "tok_s": gen_tokens / max(wall, 1e-9),
        "ttft_p50_ms": percentile(ttft, 50) * 1e3,
        "ttft_p95_ms": percentile(ttft, 95) * 1e3,
        "ttft_p99_ms": percentile(ttft, 99) * 1e3,
        "latency_p50_ms": percentile(lat, 50) * 1e3,
        "latency_p95_ms": percentile(lat, 95) * 1e3,
        "latency_p99_ms": percentile(lat, 99) * 1e3,
        "cache_mb": engine.cache_bytes() / 2**20,
        "page_stats": page_stats,                  # {} when contiguous
        # scheduler health — tracked per run, surfaced here instead of
        # dropped on the floor (preemptions cost re-generation; the
        # low-water mark says how close the pool came to thrashing)
        "preemptions": sched.preemptions if sched else None,
        "peak_in_flight": sched.peak_in_flight if sched else None,
        "low_water_pages": page_stats.get("low_water_pages"),
        # prefix-cache telemetry (None unless the engine runs one):
        # hit rate is FRACTION OF PROMPT TOKENS served from cache
        "prefix_hit_rate": page_stats.get("prefix_hit_rate"),
    }


def print_report(r: dict):
    ps = r.get("page_stats") or {}
    paged = (f", paged {ps['n_pages']}x{ps['page_size']}-tok pages "
             f"({ps['free_pages']} free)" if ps else "")
    print(f"served {r['n_requests']} requests | K={r['members']} members, "
          f"{r['slots']} slots, cache pool {r['cache_mb']:.1f} MiB"
          f"{paged}")
    print(f"  {r['gen_tokens']} tokens in {r['wall_s']:.2f}s "
          f"= {r['tok_s']:.1f} tok/s")
    print(f"  ttft    p50 {r['ttft_p50_ms']:.1f} ms   "
          f"p95 {r['ttft_p95_ms']:.1f} ms   "
          f"p99 {r['ttft_p99_ms']:.1f} ms")
    print(f"  latency p50 {r['latency_p50_ms']:.1f} ms   "
          f"p95 {r['latency_p95_ms']:.1f} ms   "
          f"p99 {r['latency_p99_ms']:.1f} ms")
    if ps.get("page_bytes") is not None:
        print(f"  cache   {ps['kv_dtype']} pages, {ps['page_bytes']} "
              f"B/page, {ps['bytes_per_token']} B/token")
    if r.get("peak_in_flight") is not None:
        low = (f", free-list low water {r['low_water_pages']}"
               f"/{ps['n_pages']} pages"
               if r.get("low_water_pages") is not None else "")
        print(f"  health  peak {r['peak_in_flight']} in flight, "
              f"{r['preemptions']} preemptions{low}")
    if r.get("prefix_hit_rate") is not None:
        print(f"  prefix  {100 * r['prefix_hit_rate']:.1f}% of prompt "
              f"tokens from cache | {ps['cached_pages']} cached pages, "
              f"{ps['shared_attaches']} attaches, {ps['cow_pages']} COW "
              f"copies, {ps['evicted_pages']} evicted")
    if r.get("n_errors"):
        print(f"  ERRORS  {r['n_errors']} failed requests "
              f"(first: {r['errors'][0]})")
