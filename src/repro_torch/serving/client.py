"""Synthetic load generator + latency reporting for the serving engine.

Generates a stream of token-id requests with mixed prompt/output
lengths, pushes them through a Scheduler in process (`run_load`) or over
the HTTP frontend (`run_http_load`), and reports the numbers a serving
SLO cares about: aggregate tok/s, time-to-first-token, per-request
latency percentiles, and scheduler health (preemptions, peak live slots,
paged free-list low-water mark, prefix-cache hits).  The HTTP half is
stdlib only (`http.client`, `urllib`).  On the card a report's times are
host clocks around work that ends in a device read (every tick's
harvest).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.client import HTTPConnection
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

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


# -- HTTP load mode ----------------------------------------------------------
#
# The same reporting over the frontend: requests go through
# POST /v1/generate (optionally SSE-streamed) against a live
# FrontendServer, concurrency comes from client threads, and TTFT is
# stamped at the first streamed token: the number a network client sees.


class Backpressure(RuntimeError):
    """The frontend answered 429 (router queue depth at its limit).
    .retry_after carries the server's Retry-After hint in seconds;
    callers back off that long and retry (FleetRouter.generate does)."""

    def __init__(self, retry_after: float, detail: str):
        super().__init__(f"HTTP 429: {detail} (retry after "
                         f"{retry_after:.2f}s)")
        self.retry_after = retry_after


def parse_sse(raw: bytes) -> List[Tuple[str, dict]]:
    """Parse a Server-Sent-Events body -> [(event, data), ...]
    ("message" for bare data events)."""
    events = []
    for block in raw.decode().split("\n\n"):
        name, data = "message", []
        for line in block.strip().splitlines():
            if line.startswith("event:"):
                name = line[6:].strip()
            elif line.startswith("data:"):
                data.append(line[5:].strip())
        if data:
            events.append((name, json.loads("\n".join(data))))
    return events


def http_generate(url: str, tokens, max_new: int,
                  stream: bool = False, timeout: float = 120.0,
                  temperature: Optional[float] = None,
                  top_k: Optional[int] = None, seed: Optional[int] = None,
                  draft: Optional[bool] = None) -> dict:
    """One POST /v1/generate; -> {"tokens": [...], "ttft": s|None,
    "latency": s, ...completion fields}.

    temperature/top_k/seed/draft ride in the JSON body as per-request
    overrides (omitted when None: the engine defaults apply).

    stream=True reads the SSE feed incrementally and stamps ttft at the
    first token event, and raises unless the streamed ids equal the
    terminal done event's sequence.
    """
    u = urlsplit(url)
    payload = {"tokens": [int(t) for t in np.reshape(tokens, -1)],
               "max_new": int(max_new), "stream": bool(stream)}
    for key, val in (("temperature", temperature), ("top_k", top_k),
                     ("seed", seed), ("draft", draft)):
        if val is not None:
            payload[key] = val
    body = json.dumps(payload).encode()
    conn = HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        t0 = time.time()
        conn.request("POST", "/v1/generate", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status == 429:
            # backpressure is typed: the caller can honour the hint
            try:
                detail = json.loads(resp.read())
                retry_after = float(detail.get("retry_after", 1.0))
                msg = detail.get("error", "queue full")
            except ValueError:
                retry_after, msg = 1.0, "queue full"
            raise Backpressure(retry_after, msg)
        if resp.status != 200:
            err = resp.read().decode()
            raise RuntimeError(f"HTTP {resp.status}: {err}")
        if not stream:
            out = json.loads(resp.read())
            out["ttft"] = None
            out["latency"] = time.time() - t0
            return out
        # SSE: read incrementally so the first-token stamp is real
        buf, ttft, streamed = b"", None, []
        final = None
        while True:
            chunk = resp.read1(65536)
            if chunk:
                buf += chunk
            while b"\n\n" in buf:
                block, buf = buf.split(b"\n\n", 1)
                for name, data in parse_sse(block + b"\n\n"):
                    if name == "error":
                        raise RuntimeError(f"SSE error: {data['error']}")
                    if name == "done":
                        final = data
                    else:
                        if ttft is None:
                            ttft = time.time() - t0
                        streamed.append(int(data["token"]))
            if final is not None:
                break
            if not chunk:
                raise RuntimeError("SSE stream closed before done event")
        if streamed != final["tokens"]:
            raise RuntimeError(
                f"streamed tokens {streamed} != final {final['tokens']}")
        final["ttft"] = ttft
        final["latency"] = time.time() - t0
        return final
    finally:
        conn.close()


def http_get_json(url: str, path: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return json.loads(r.read())


def http_get_text(url: str, path: str, timeout: float = 10.0) -> str:
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return r.read().decode()


def server_percentiles(metrics_text: str) -> dict:
    """The serving histograms' percentiles out of a /metrics scrape ->
    {"ttft_p50_ms": ..., "ttft_p99_ms": ..., ...} (empty when the scrape
    has no samples, e.g. obs disabled)."""
    from repro_torch.serving import obs as obs_mod
    out = {}
    fams = {"ttft": "repro_serving_ttft_seconds",
            "latency": "repro_serving_e2e_latency_seconds"}
    for key, fam in fams.items():
        for p in (50, 95, 99):
            try:
                q = obs_mod.histogram_quantile_from_scrape(
                    metrics_text, fam, p / 100.0)
            except ValueError:
                return {}
            if q is None:
                return {}
            out[f"{key}_p{p}_ms"] = q * 1e3
    return out


def run_http_load(url: str, requests, concurrency: int = 8,
                  stream: bool = True) -> dict:
    """Drive `requests` against a live frontend from `concurrency` client
    threads; -> the report dict build_report makes (fleet shape read from
    /healthz).

    When the server exports latency histograms on /metrics, the report's
    ttft/latency percentiles come from those server-side histograms
    (queue wait included, no client network skew) and the client's own
    values move to client_ttft_* / client_latency_* keys; a >20% p50/p99
    TTFT divergence between the two views sets ttft_divergence_warn."""
    results: List[Optional[dict]] = [None] * len(requests)
    errors: List[Tuple[int, str]] = []
    nxt = {"i": 0}
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = nxt["i"]
                if i >= len(requests):
                    return
                nxt["i"] += 1
            toks, max_new = requests[i]
            try:
                results[i] = http_generate(url, toks, max_new,
                                           stream=stream)
            except Exception as e:  # noqa: BLE001 - a failed request is
                # a reported error, not a dead worker halving concurrency
                with lock:
                    errors.append((i, repr(e)))

    t0 = time.time()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0

    health = http_get_json(url, "/healthz")
    reps = health.get("replicas", [])
    done = [r for r in results if r is not None]
    gen_tokens = sum(r["n_gen"] for r in done)
    ttft = [r["ttft"] for r in done if r["ttft"] is not None]
    lat = [r["latency"] for r in done]
    report = {
        "n_requests": len(done),
        "n_errors": len(errors),
        "errors": errors[:8],
        "members": reps[0]["members"] if reps else 0,
        "slots": sum(r["n_slots"] for r in reps),
        "n_replicas": len(reps),
        "gen_tokens": gen_tokens,
        "wall_s": wall,
        "tok_s": gen_tokens / max(wall, 1e-9),
        "ttft_p50_ms": percentile(ttft, 50) * 1e3,
        "ttft_p95_ms": percentile(ttft, 95) * 1e3,
        "ttft_p99_ms": percentile(ttft, 99) * 1e3,
        "latency_p50_ms": percentile(lat, 50) * 1e3,
        "latency_p95_ms": percentile(lat, 95) * 1e3,
        "latency_p99_ms": percentile(lat, 99) * 1e3,
        "cache_mb": 0.0,  # engine-side; see /metrics
        "page_stats": {},
    }
    try:
        srv = server_percentiles(http_get_text(url, "/metrics"))
    except OSError:   # a frontend that is draining answers no scrape
        srv = {}
    if srv and ttft:
        divs = []
        for p in (50, 99):
            c, s = report[f"ttft_p{p}_ms"], srv[f"ttft_p{p}_ms"]
            if max(c, s) > 0:
                divs.append(abs(c - s) / max(c, s))
        report["ttft_p99_divergence"] = (
            abs(report["ttft_p99_ms"] - srv["ttft_p99_ms"])
            / max(report["ttft_p99_ms"], srv["ttft_p99_ms"], 1e-9))
        if any(d > 0.20 for d in divs):
            report["ttft_divergence_warn"] = True
            print(f"WARNING: client/server TTFT percentiles diverge "
                  f">20%: client p50 {report['ttft_p50_ms']:.1f} ms / "
                  f"p99 {report['ttft_p99_ms']:.1f} ms vs server "
                  f"p50 {srv['ttft_p50_ms']:.1f} ms / "
                  f"p99 {srv['ttft_p99_ms']:.1f} ms")
        # the server-side histograms give the headline numbers; the
        # client clock's view stays for cross-checking
        for p in (50, 95, 99):
            report[f"client_ttft_p{p}_ms"] = report[f"ttft_p{p}_ms"]
            report[f"ttft_p{p}_ms"] = srv[f"ttft_p{p}_ms"]
            report[f"client_latency_p{p}_ms"] = report[f"latency_p{p}_ms"]
            report[f"latency_p{p}_ms"] = srv[f"latency_p{p}_ms"]
        report["latency_source"] = "server"
    return report
