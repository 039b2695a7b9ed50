"""repro_torch.serving — the EC-DNN_G ensemble served on the card.

EnsembleEngine runs all K members in one batched step over a pool of
slot-addressable caches (paged, optionally with the shared-prefix trie
of prefix.py); Scheduler keeps its slots full with continuous batching
(batch `run()` or online `serve_forever()`); client drives synthetic
load in process or over HTTP and reports tok/s, TTFT and latency
percentiles; obs holds request traces, latency histograms, the
tick-phase profiler and the Prometheus text plumbing; spec/ serves a
compressed student as the draft of speculative decoding
(SpeculativeEngine, DraftEngine);
frontend/ puts engine replicas behind a router and an HTTP/SSE server,
in process or as replica processes (client.py holds the HTTP client).
"""
from repro_torch.serving.engine import EnsembleEngine, SlotState
from repro_torch.serving.obs import Histogram, ServingObs, Trace, TraceRing
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.scheduler import Completion, Request, Scheduler
from repro_torch.serving.spec import DraftEngine, SpeculativeEngine

__all__ = ["EnsembleEngine", "SlotState", "Scheduler", "Request",
           "Completion", "PrefixCache", "ServingObs", "Trace", "TraceRing",
           "Histogram", "SpeculativeEngine", "DraftEngine"]
