"""Serving observability: request traces, latency histograms, a
tick-phase profiler, and Prometheus text-format plumbing.

The port's copy of the JAX package's module (pure Python, no JAX; only
the profiler window differs).  On by default; `Scheduler(obs=False)` is
the kill-switch.

  1. TRACES — `Trace` is a per-request span recorder: monotonic-clock
     events (`enqueued`, `admitted`, `prefix_hit`, `prefill_chunk`,
     `first_token`, `preempted`/`resumed`, `done`/`cancelled`) appended
     O(1) by the scheduler's loop thread.  `TraceRing` keeps LIVE
     traces pinned in a dict and FINISHED ones in a bounded FIFO, so
     churn can never corrupt an in-flight span chain.  Traces surface in
     the `Completion` and an optional JSONL log (--trace-log).
  2. HISTOGRAMS — fixed log-spaced buckets (`Histogram`) for TTFT,
     queue wait, per-token inter-arrival, and end-to-end latency,
     rendered as Prometheus histogram families
     (`_bucket`/`_sum`/`_count`); `Histogram.quantile` interpolates
     inside a bucket.
  3. TICK PROFILER — `TickProfiler` (the tick phases) accumulates
     per-phase wall time (admit/decode/prefill/harvest/release) with
     totals + EMA; `arm_profile` opens an opt-in `torch.profiler` window
     over the next N ticks, written as a TensorBoard trace.  On the card
     these are HOST times: admit, decode and prefill measure the time
     to enqueue their work, and only harvest, whose single transfer
     waits for the device, absorbs the device's time.
  4. PROMETHEUS PLUMBING — `FamilySet` renders conformant text
     exposition (exactly one `# HELP`/`# TYPE` per family, escaped
     label values, trailing newline); `parse_prometheus` parses a full
     scrape back; `merge_scrapes` aggregates several replicas' scrapes:
     per-replica labels preserved, plus a synthesized `replica="fleet"`
     row per family (sums for counters/histograms, max for gauges).

Threading: observe()/add() run on the scheduler loop thread; renders
and quantile reads may run on other threads.  Every mutation is a
single list/int update under the GIL and every read tolerates a
point-in-time snapshot, so the hot path takes NO lock — only TraceRing
retire/eviction does (it restructures two dicts).
"""
from __future__ import annotations

import bisect
import json
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

MONO = time.monotonic

# canonical span names
SPAN_EVENTS = ("enqueued", "admitted", "prefix_hit", "prefill_chunk",
               "first_token", "preempted", "resumed", "spec_step",
               "done", "cancelled")
_TERMINAL = ("done", "cancelled")

# log-spaced default bounds: 100us .. ~105s, ratio 2^0.25 (worst-case
# in-bucket quantile interpolation error ~9% — half the 20% divergence
# gate the client report cross-checks against)
DEFAULT_BOUNDS = tuple(1e-4 * 2.0 ** (i / 4.0) for i in range(81))


# -- request-lifecycle tracing ----------------------------------------------

class Trace:
    """One request's span chain: (event, t, value) triples stamped
    with the monotonic clock, relative to the trace's birth (t0).
    Appends are O(1); a runaway stream cannot grow one unboundedly —
    past max_events new spans are counted in .dropped instead."""

    __slots__ = ("rid", "t0", "events", "dropped", "max_events")

    def __init__(self, rid: int, max_events: int = 512):
        self.rid = int(rid)
        self.t0 = MONO()
        self.events: List[tuple] = []   # (name, dt_seconds, value|None)
        self.dropped = 0
        self.max_events = int(max_events)

    def add(self, name: str, value=None):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append((name, MONO() - self.t0, value))

    def has(self, name: str) -> bool:
        return any(e[0] == name for e in self.events)

    def first_t(self, name: str) -> Optional[float]:
        for n, t, _ in self.events:
            if n == name:
                return t
        return None

    def span(self, start: str, end: str) -> Optional[float]:
        """Seconds between the FIRST `start` and FIRST `end` event."""
        a, b = self.first_t(start), self.first_t(end)
        return None if a is None or b is None else b - a

    def to_dict(self) -> dict:
        evs = [{"event": n, "t": round(t, 6)}
               if v is None else {"event": n, "t": round(t, 6), "v": v}
               for n, t, v in self.events]
        d = {"rid": self.rid, "events": evs}
        if self.dropped:
            d["dropped"] = self.dropped
        return d


class TraceRing:
    """Bounded trace store.  Live traces (request not yet terminal)
    are PINNED — only finished traces age out, FIFO past `keep` — so
    eviction under churn can never corrupt an in-flight span chain."""

    def __init__(self, keep: int = 512):
        self.keep = int(keep)
        self._live: Dict[int, Trace] = {}
        self._done: "OrderedDict[int, Trace]" = OrderedDict()
        self._lock = threading.Lock()
        self.evicted = 0

    def start(self, rid: int) -> Trace:
        tr = Trace(rid)
        self._live[int(rid)] = tr
        return tr

    def live(self, rid: int) -> Optional[Trace]:
        return self._live.get(int(rid))

    def get(self, rid: int) -> Optional[Trace]:
        tr = self._live.get(int(rid))
        return tr if tr is not None else self._done.get(int(rid))

    def finish(self, rid: int) -> Optional[Trace]:
        """Move a live trace to the bounded finished side."""
        with self._lock:
            tr = self._live.pop(int(rid), None)
            if tr is None:
                return None
            self._done[int(rid)] = tr
            while len(self._done) > self.keep:
                self._done.popitem(last=False)
                self.evicted += 1
            return tr

    @property
    def n_live(self) -> int:
        return len(self._live)

    @property
    def n_finished(self) -> int:
        return len(self._done)


# -- histograms --------------------------------------------------------------

class Histogram:
    """Fixed-bucket histogram with log-spaced defaults, rendered in
    Prometheus exposition format (`_bucket{le=...}`/`_sum`/`_count`).
    observe() is two list writes — no lock (GIL-atomic; readers take a
    point-in-time snapshot)."""

    __slots__ = ("name", "help", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, help: str,
                 bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be sorted, unique")
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0..1) by linear interpolation
        inside the containing bucket — same math Prometheus'
        histogram_quantile() applies to the exported buckets."""
        return quantile_from_buckets(
            list(self.bounds), self.cumulative(), q)

    def merge_from(self, counts: Sequence[int], sum_: float, count: int):
        """Fold another histogram's NON-cumulative counts in (fleet
        aggregation); bucket layouts must match."""
        if len(counts) != len(self.counts):
            raise ValueError("bucket layout mismatch")
        for i, c in enumerate(counts):
            self.counts[i] += int(c)
        self.sum += float(sum_)
        self.count += int(count)


def quantile_from_buckets(bounds: List[float], cumulative: List[int],
                          q: float) -> float:
    """histogram_quantile over (le-bounds, cumulative counts); the
    final bucket is +Inf and clamps to the last finite bound."""
    total = cumulative[-1] if cumulative else 0
    if total <= 0:
        return 0.0
    rank = q * total
    for i, cum in enumerate(cumulative):
        if cum >= rank:
            if i >= len(bounds):        # +Inf bucket
                return bounds[-1] if bounds else 0.0
            lo = bounds[i - 1] if i > 0 else 0.0
            prev = cumulative[i - 1] if i > 0 else 0
            width = cum - prev
            frac = (rank - prev) / width if width > 0 else 1.0
            return lo + (bounds[i] - lo) * frac
    return bounds[-1] if bounds else 0.0


# -- tick-phase profiler -----------------------------------------------------

class TickProfiler:
    """Per-phase wall time accumulated inside Scheduler.tick():
    totals + counts + an EMA per phase, and an opt-in torch.profiler
    window over the next N ticks (arm_profile).  Host times: on the card
    a phase that only enqueues device work is timed to its enqueue, and
    harvest (the tick's one device read) absorbs the wait."""

    PHASES = ("admit", "decode", "prefill", "harvest", "release")

    def __init__(self, ema_alpha: float = 0.05):
        self.ema_alpha = float(ema_alpha)
        self.total = {p: 0.0 for p in self.PHASES}
        self.count = {p: 0 for p in self.PHASES}
        self.ema = {p: 0.0 for p in self.PHASES}
        self.ticks = 0
        # torch.profiler window state (loop thread only)
        self._prof_left = 0
        self._prof_dir: Optional[str] = None
        self._prof = None

    def add(self, phase: str, dt: float):
        self.total[phase] += dt
        n = self.count[phase] = self.count[phase] + 1
        a = self.ema_alpha
        self.ema[phase] = dt if n == 1 else \
            (1.0 - a) * self.ema[phase] + a * dt

    def snapshot(self) -> dict:
        return {p: {"total_s": self.total[p], "count": self.count[p],
                    "ema_s": self.ema[p]} for p in self.PHASES}

    # -- torch.profiler window ----------------------------------------------

    def arm_profile(self, ticks: int, out_dir: str):
        """Capture a trace of the next `ticks` tick() calls into out_dir
        (TensorBoard-loadable; the card's kernels too when there is
        one).  Thread-safe to ARM; the loop thread opens/closes the
        actual window at tick boundaries."""
        if ticks < 1:
            raise ValueError(f"ticks must be >= 1, got {ticks}")
        if not out_dir:
            raise ValueError("profiling needs an output dir")
        self._prof_dir = str(out_dir)
        self._prof_left = int(ticks)

    @property
    def profile_pending(self) -> int:
        return self._prof_left

    def tick_begin(self):
        if self._prof_left > 0 and self._prof is None:
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(
                activities=acts,
                on_trace_ready=tensorboard_trace_handler(self._prof_dir))
            self._prof.start()

    def tick_end(self):
        if self._prof is None:
            return
        self._prof_left -= 1
        if self._prof_left <= 0:
            self._prof.stop()       # writes the trace file
            self._prof = None


# -- the per-scheduler bundle ------------------------------------------------

class ServingObs:
    """Everything one Scheduler records: the trace ring, the four
    latency histograms, the tick profiler, and an optional JSONL trace
    log.  Built by Scheduler(obs=True) — the default; obs=False skips
    construction entirely."""

    def __init__(self, *, trace_keep: int = 512,
                 trace_log: Optional[str] = None):
        self.traces = TraceRing(keep=trace_keep)
        self.ttft = Histogram(
            "repro_serving_ttft_seconds",
            "Submit to first generated token (queue wait + prefill).")
        self.queue_wait = Histogram(
            "repro_serving_queue_wait_seconds",
            "Submit to slot admission (first admission only).")
        self.inter_token = Histogram(
            "repro_serving_inter_token_seconds",
            "Per-token inter-arrival time during decode.")
        self.latency = Histogram(
            "repro_serving_e2e_latency_seconds",
            "Submit to completion (end-to-end request latency).")
        self.ticks = TickProfiler()
        self.trace_log = trace_log
        self._log_f = open(trace_log, "a") if trace_log else None
        self._log_lock = threading.Lock()

    def histograms(self) -> Tuple[Histogram, ...]:
        return (self.ttft, self.queue_wait, self.inter_token,
                self.latency)

    def retire(self, trace: Optional[Trace]):
        """Move a terminal trace to the finished ring and append it to
        the JSONL log (one line per request, loop thread only)."""
        if trace is None:
            return
        self.traces.finish(trace.rid)
        if self._log_f is not None:
            with self._log_lock:
                self._log_f.write(json.dumps(trace.to_dict(),
                                             separators=(",", ":"))
                                  + "\n")
                self._log_f.flush()

    def close(self):
        if self._log_f is not None:
            with self._log_lock:
                self._log_f.close()
                self._log_f = None


# -- Prometheus text exposition ----------------------------------------------

def escape_label_value(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def fmt_value(v) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class FamilySet:
    """Assembles conformant Prometheus text exposition: families are
    declared once (`# HELP` + `# TYPE` exactly once each, no matter how
    many labeled samples — e.g. one line per replica — follow), label
    values are escaped, and render() ends with a trailing newline."""

    def __init__(self):
        self._fam: "OrderedDict[str, dict]" = OrderedDict()

    def declare(self, name: str, mtype: str, help: str):
        if mtype not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric type {mtype!r}")
        f = self._fam.get(name)
        if f is None:
            self._fam[name] = {"type": mtype, "help": help,
                               "samples": []}
        elif f["type"] != mtype:
            raise ValueError(f"family {name} redeclared as {mtype}, "
                             f"was {f['type']}")

    def sample(self, name: str, labels: Optional[dict], value,
               suffix: str = ""):
        if name not in self._fam:
            raise ValueError(f"family {name} not declared")
        self._fam[name]["samples"].append((suffix, dict(labels or {}),
                                           value))

    def add_histogram(self, hist: Histogram, labels: Optional[dict],
                      name: Optional[str] = None):
        """Declare + emit one histogram's `_bucket`/`_sum`/`_count`
        series under `labels` (cumulative le counts, +Inf last)."""
        n = name or hist.name
        self.declare(n, "histogram", hist.help)
        cum = hist.cumulative()
        for i, b in enumerate(hist.bounds):
            lb = dict(labels or {})
            lb["le"] = fmt_value(b)
            self.sample(n, lb, cum[i], suffix="_bucket")
        lb = dict(labels or {})
        lb["le"] = "+Inf"
        self.sample(n, lb, cum[-1], suffix="_bucket")
        self.sample(n, labels, hist.sum, suffix="_sum")
        self.sample(n, labels, hist.count, suffix="_count")

    def render(self) -> str:
        lines = []
        for name, f in self._fam.items():
            lines.append(f"# HELP {name} {escape_help(f['help'])}")
            lines.append(f"# TYPE {name} {f['type']}")
            for suffix, labels, value in f["samples"]:
                lines.append(f"{name}{suffix}{fmt_labels(labels)} "
                             f"{fmt_value(value)}")
        return "\n".join(lines) + "\n"


def _parse_labels(s: str) -> dict:
    """Parse `k="v",k2="v2"` with \\", \\\\ and \\n escapes."""
    out: dict = {}
    i, n = 0, len(s)
    while i < n:
        j = s.index("=", i)
        key = s[i:j].strip().lstrip(",").strip()
        if s[j + 1] != '"':
            raise ValueError(f"unquoted label value in {s!r}")
        i = j + 2
        buf = []
        while i < n:
            c = s[i]
            if c == "\\":
                nxt = s[i + 1]
                buf.append({"n": "\n", '"': '"', "\\": "\\"}
                           .get(nxt, nxt))
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                buf.append(c)
                i += 1
        out[key] = "".join(buf)
        while i < n and s[i] in ", ":
            i += 1
    return out


def parse_prometheus(text: str):
    """Parse a text-format scrape -> (meta, samples) where meta maps
    family name -> {"type", "help"} and samples is a list of
    (series_name, labels_dict, value).  Raises on malformed lines —
    the conformance test runs every scrape through this."""
    meta: "OrderedDict[str, dict]" = OrderedDict()
    samples: List[Tuple[str, dict, float]] = []
    if text and not text.endswith("\n"):
        raise ValueError("scrape must end with a trailing newline")
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            name, h = line[len("# HELP "):].split(" ", 1)
            meta.setdefault(name, {})["help"] = h
            continue
        if line.startswith("# TYPE "):
            name, t = line[len("# TYPE "):].split(" ", 1)
            if "type" in meta.get(name, {}):
                raise ValueError(f"duplicate # TYPE for {name}")
            meta.setdefault(name, {})["type"] = t.strip()
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{"):]
            depth_end = _find_label_end(rest)
            labels = _parse_labels(rest[1:depth_end])
            value_s = rest[depth_end + 1:].strip().split()[0]
        else:
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(f"malformed sample line {line!r}")
            name, value_s = parts[0], parts[1]
            labels = {}
        v = float("inf") if value_s == "+Inf" else float(value_s)
        samples.append((name, labels, v))
    return meta, samples


def _find_label_end(s: str) -> int:
    """Index of the closing `}` of the label block s starts with,
    honoring escapes inside quoted values."""
    in_q = False
    i = 1
    while i < len(s):
        c = s[i]
        if in_q:
            if c == "\\":
                i += 1
            elif c == '"':
                in_q = False
        elif c == '"':
            in_q = True
        elif c == "}":
            return i
        i += 1
    raise ValueError(f"unterminated label block in {s!r}")


def family_of(series: str) -> str:
    """Histogram series name -> its family name."""
    for suf in ("_bucket", "_sum", "_count"):
        if series.endswith(suf):
            return series[: -len(suf)]
    return series


def merge_scrapes(scrapes: Sequence[Tuple[str, str]]) -> str:
    """Fleet aggregation: merge N children's scrape texts into one.

    Every child sample is re-labeled replica=<child name> (overriding
    the child's own in-process replica label), per-family `# HELP` /
    `# TYPE` emitted exactly once, and a synthesized replica="fleet"
    row added per family: SUM for counters and histogram series
    (buckets with equal `le` add), MAX for gauges.
    """
    out = FamilySet()
    # family -> {"type", "help"}; series agg keyed (series, frozen extra
    # labels minus replica)
    sums: "OrderedDict[tuple, float]" = OrderedDict()
    maxes: "OrderedDict[tuple, float]" = OrderedDict()
    types: Dict[str, str] = {}
    for child, text in scrapes:
        meta, samples = parse_prometheus(text)
        for fam, m in meta.items():
            t = m.get("type", "gauge")
            if fam not in types:
                types[fam] = t
                out.declare(fam, t if t in ("counter", "gauge",
                                            "histogram") else "gauge",
                            m.get("help", fam))
        for series, labels, value in samples:
            fam = family_of(series)
            if fam not in types:      # sample without # TYPE: gauge
                types[fam] = "gauge"
                out.declare(fam, "gauge", fam)
            suffix = series[len(fam):]
            lb = dict(labels)
            lb["replica"] = child
            out.sample(fam, lb, value, suffix=suffix)
            extra = tuple(sorted((k, v) for k, v in labels.items()
                                 if k != "replica"))
            key = (fam, suffix, extra)
            if types[fam] == "gauge" and suffix == "":
                maxes[key] = max(maxes.get(key, float("-inf")), value)
            else:                     # counters + histogram series sum
                sums[key] = sums.get(key, 0.0) + value
    for (fam, suffix, extra), v in sums.items():
        lb = dict(extra)
        lb["replica"] = "fleet"
        out.sample(fam, lb, v, suffix=suffix)
    for (fam, suffix, extra), v in maxes.items():
        lb = dict(extra)
        lb["replica"] = "fleet"
        out.sample(fam, lb, v, suffix=suffix)
    return out.render()


def histogram_quantile_from_scrape(text: str, family: str, q: float,
                                   match: Optional[dict] = None) -> \
        Optional[float]:
    """Compute a quantile for one histogram family out of a raw scrape.
    `match`
    filters on label equality (ignoring `le`); buckets from multiple
    matching series (e.g. several replicas) are summed first."""
    _, samples = parse_prometheus(text)
    buckets: Dict[float, float] = {}
    for series, labels, value in samples:
        if series != family + "_bucket":
            continue
        if match and any(labels.get(k) != str(v)
                         for k, v in match.items()):
            continue
        le = labels.get("le")
        b = float("inf") if le == "+Inf" else float(le)
        buckets[b] = buckets.get(b, 0.0) + value
    if not buckets:
        return None
    bounds = sorted(b for b in buckets if b != float("inf"))
    cum = [int(buckets[b]) for b in bounds]
    if float("inf") in buckets:
        cum.append(int(buckets[float("inf")]))
    else:
        cum.append(cum[-1] if cum else 0)
    return quantile_from_buckets(bounds, cum, q)
