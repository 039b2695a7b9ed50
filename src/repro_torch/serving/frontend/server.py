"""Streaming HTTP frontend over the replica router — stdlib only.

Endpoints (token-id API; tokenizers are out of scope repo-wide):

  POST /v1/generate     body {"tokens": [1,2,3], "max_new": 8,
                              "stream": false}
      stream=false -> one JSON document when the request completes:
          {"tokens": [...], "n_gen": n, "prompt_len": p,
           "replica": name, "rid": i, "ttft_ms": t, "latency_ms": l}
      stream=true  -> Server-Sent Events, one event per generated
          token AS IT IS SAMPLED (the scheduler's harvest phase fires
          the per-token callback straight into the handler's queue):
              data: {"index": 0, "token": 1234}
          then a terminal event carrying the full completion:
              event: done
              data: {"tokens": [...], "n_gen": ..., ...}
  GET /healthz          liveness + per-replica drain state (200, or
                        503 once shutdown begins); paged replicas also
                        report page accounting (n_pages/free/available)
                        so a supervisor can check for leaks remotely
  GET /metrics          Prometheus-style text: requests, tokens,
                        live slots, free pages, preemptions, ...
  POST /admin/swap      (servers built with an admin_swap hook —
                        replica processes wire one in)
                        roll a new round into this process's fleet:
                        body {"seed": s} rebuilds the K-member stack
                        from that init seed, {"ckpt": root, "step": n}
                        restores a CheckpointManager round; the swap
                        runs the router's drain -> swap -> rejoin
  POST /admin/profile   body {"ticks": n[, "dir": path]} arms a
                        torch.profiler window over the next n ticks

A client that disconnects mid-SSE-stream CANCELS its request: the
write failure surfaces as BrokenPipeError in the handler, which
forwards Router.cancel -> Scheduler.cancel, releasing the slot, its
pages, and any prefix-trie refs mid-decode instead of finishing a
stream nobody is reading.  Backpressure composes at the same door:
when the router's queue depth crosses its threshold, POST /v1/generate
answers 429 with a Retry-After header instead of parking another
handler thread on a saturated fleet.

Built on http.server.ThreadingHTTPServer: one handler thread per
connection parks on a queue.Queue that the scheduler loop feeds via
on_token/on_done: the decode path never blocks on a slow client beyond
queue puts, and handler threads never touch the engine's tensors (only
the replica's loop thread does).  The per-token events come from the
harvest's one device read a tick, so streaming adds no read.  SSE responses are close-delimited (Connection:
close) so any HTTP/1.x client can read them without chunked-decoding
support.

Shutdown (`FrontendServer.shutdown`) is a graceful drain by default:
stop accepting new connections, serve out every queued and in-flight
request (handler threads unblock as their completions fire), then stop
the replica loops.  `/healthz` flips to 503 the moment the drain
starts so external load balancers stop sending traffic.
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from repro_torch.serving import obs as obs_mod
from repro_torch.serving.frontend.router import QueueFull, Router

_DONE = object()  # queue sentinel: completion follows no more tokens


def _completion_payload(comp, replica: str, rid: int) -> dict:
    p = {
        "tokens": [int(t) for t in comp.tokens],
        "n_gen": int(len(comp.tokens)),
        "prompt_len": int(comp.prompt_len),
        "replica": replica,
        "rid": int(rid),
        "ttft_ms": round(comp.ttft * 1e3, 3),
        "latency_ms": round(comp.latency * 1e3, 3),
    }
    if comp.trace is not None:
        # the request's span chain rides the terminal payload (SSE
        # `event: done` / the non-streamed JSON document) so clients
        # get their trace without a second round trip
        p["trace"] = comp.trace
    return p


class _Handler(BaseHTTPRequestHandler):
    """One instance per request; the server wires .router in."""

    protocol_version = "HTTP/1.1"
    server_version = "repro-serving"

    # the ThreadingHTTPServer subclass below carries these
    router: Router
    frontend: "FrontendServer"

    def log_message(self, fmt, *args):  # quiet by default
        if self.frontend.verbose:
            super().log_message(fmt, *args)

    # -- plumbing -----------------------------------------------------------

    def _send_json(self, code: int, payload: dict,
                   headers: Optional[dict] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            return None

    # -- routes -------------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            stats = self.router.stats()
            alive = not self.frontend.draining
            reps = []
            for r in stats["replicas"]:
                rep = {"name": r["name"], "draining": r["draining"],
                       "failed": r["failed"],
                       "live_slots": r["live_slots"], "pending": r["pending"],
                       "completed": r["completed"],
                       "cancelled": r["cancelled"],
                       "members": r["members"], "n_slots": r["n_slots"],
                       "swaps_done": r["swaps_done"]}
                ps = r["page_stats"]
                if ps:
                    # page accounting over the wire: a fleet supervisor
                    # asserts available_pages == n_pages on a drained
                    # replica process without reaching into it
                    rep["n_pages"] = ps["n_pages"]
                    rep["free_pages"] = ps["free_pages"]
                    rep["available_pages"] = ps["available_pages"]
                    rep["shared_pages"] = ps["shared_pages"]
                    rep["cached_pages"] = ps.get("cached_pages", 0)
                reps.append(rep)
            payload = {
                "ok": alive,
                "draining": self.frontend.draining,
                "queue_depth": stats["queue_depth"],
                "cancelled": stats["cancelled"],
                "shed": stats["shed"],
                "completed": stats["completed"],
                "replicas": reps,
            }
            self._send_json(200 if alive else 503, payload)
        elif self.path == "/metrics":
            body = self.frontend.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path.startswith("/v1/trace/"):
            url = urlsplit(self.path)
            rid_s = url.path[len("/v1/trace/"):]
            if not rid_s.isdigit():
                self._send_json(400, {"error": "trace id must be an "
                                               "integer rid"})
                return
            qs = parse_qs(url.query)
            rep = (qs.get("replica") or [None])[0]
            found = self.router.trace(int(rid_s), replica=rep)
            if found is None:
                self._send_json(404, {"error": f"no trace for rid "
                                               f"{rid_s} (evicted, "
                                               f"unknown, or obs off)"})
                return
            name, trace = found
            self._send_json(200, {"replica": name, **trace})
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path == "/admin/swap":
            self._do_admin_swap()
            return
        if self.path == "/admin/profile":
            self._do_admin_profile()
            return
        if self.path != "/v1/generate":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        if self.frontend.draining:
            self._send_json(503, {"error": "server is draining"})
            return
        body = self._read_body()
        if body is None:
            self._send_json(400, {"error": "body must be JSON"})
            return
        tokens = body.get("tokens")
        max_new = body.get("max_new")
        if not isinstance(tokens, list) or not isinstance(max_new, int):
            self._send_json(400, {"error": "need tokens: [int] and "
                                           "max_new: int"})
            return
        stream = bool(body.get("stream", False))
        # per-request sampling / speculation overrides (absent = engine
        # default); types are checked here, RANGES by validate_request
        # at the router door so the error quotes the named limits
        sample_kw = {}
        for key, types in (("temperature", (int, float)),
                           ("top_k", (int,)), ("seed", (int,))):
            if key in body and body[key] is not None:
                if not isinstance(body[key], types) \
                        or isinstance(body[key], bool):
                    self._send_json(
                        400, {"error": f"{key} must be a number"})
                    return
                sample_kw[key] = body[key]
        if "draft" in body and body["draft"] is not None:
            if not isinstance(body["draft"], bool):
                self._send_json(400, {"error": "draft must be a bool"})
                return
            sample_kw["draft"] = body["draft"]
        q: "queue.Queue" = queue.Queue()
        try:
            replica, rid = self.router.submit(
                tokens, max_new,
                on_token=(lambda _rid, i, tok: q.put((i, tok)))
                if stream else None,
                on_done=lambda comp: q.put((_DONE, comp)),
                **sample_kw)
        except QueueFull as e:  # backpressure: shed, don't park
            self._send_json(
                429, {"error": str(e), "retry_after": e.retry_after},
                headers={"Retry-After": str(max(1, round(e.retry_after)))})
            return
        except ValueError as e:  # validate_request rejected at the door
            self.router.count_rejected()
            self._send_json(400, {"error": str(e)})
            return

        def next_event():
            """q.get with a liveness poll: if the replica's loop thread
            dies (crash latch) this request's callbacks will never
            fire — answer an error instead of parking forever."""
            while True:
                try:
                    return q.get(timeout=1.0)
                except queue.Empty:
                    if self.router.replica_dead(replica):
                        raise RuntimeError(
                            f"replica {replica} failed mid-request")

        if not stream:
            try:
                item = next_event()
                while item[0] is not _DONE:  # only done without stream
                    item = next_event()
            except RuntimeError as e:
                self._send_json(500, {"error": str(e)})
                return
            self._send_json(200, _completion_payload(item[1], replica, rid))
            return

        # SSE: close-delimited so plain HTTP/1.x clients can read it
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            while True:
                try:
                    kind, val = next_event()
                except RuntimeError as e:
                    self.wfile.write(
                        b"event: error\ndata: "
                        + json.dumps({"error": str(e)}).encode() + b"\n\n")
                    self.wfile.flush()
                    return
                if kind is _DONE:
                    payload = _completion_payload(val, replica, rid)
                    self.wfile.write(
                        b"event: done\ndata: "
                        + json.dumps(payload).encode() + b"\n\n")
                    self.wfile.flush()
                    return
                self.wfile.write(
                    b"data: " + json.dumps(
                        {"index": int(kind), "token": int(val)}).encode()
                    + b"\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # client went away mid-stream: cancel instead of finishing
            # a stream nobody reads — the replica's next tick releases
            # the slot, its pages, and any prefix-trie refs
            self.router.cancel(replica, rid)
            return

    def _do_admin_swap(self):
        """POST /admin/swap — replica-process model rollout over the
        wire.  Only servers constructed with an admin_swap hook expose
        it (frontend/replica.py wires one in); the hook owns building
        the new round's params and calling Router.rollout."""
        if self.frontend.admin_swap is None:
            self._send_json(404, {"error": "no admin endpoints here"})
            return
        body = self._read_body()
        if body is None:
            self._send_json(400, {"error": "body must be JSON"})
            return
        try:
            result = self.frontend.admin_swap(body)
        except ValueError as e:
            self._send_json(400, {"error": str(e)})
            return
        except Exception as e:  # swap failed mid-flight: report, don't die
            self._send_json(500, {"error": repr(e)})
            return
        self._send_json(200, {"ok": True, **(result or {})})

    def _do_admin_profile(self):
        """POST /admin/profile {"ticks": N[, "dir": path]}: capture a
        torch.profiler trace of the next N scheduler ticks into
        the server's --profile-dir (or the body's override dir).  The
        window opens at the next tick boundary on the first routable
        replica and closes N ticks later; load the output directory in
        TensorBoard's profile plugin (the card's kernels ride along)."""
        body = self._read_body()
        if body is None:
            self._send_json(400, {"error": "body must be JSON"})
            return
        ticks = body.get("ticks")
        if not isinstance(ticks, int) or isinstance(ticks, bool) \
                or ticks < 1:
            self._send_json(400, {"error": "need ticks: int >= 1"})
            return
        out_dir = body.get("dir") or self.frontend.profile_dir
        if not out_dir:
            self._send_json(400, {"error": "no profile dir: start the "
                                           "server with --profile-dir "
                                           "or pass \"dir\" in the "
                                           "body"})
            return
        try:
            name = self.router.profile(ticks, out_dir)
        except RuntimeError as e:  # obs=False kill-switch
            self._send_json(409, {"error": str(e)})
            return
        self._send_json(200, {"ok": True, "replica": name,
                              "ticks": ticks, "dir": str(out_dir)})


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class FrontendServer:
    """HTTP frontend lifecycle: bind -> start -> (serve) -> shutdown.

    port=0 binds an ephemeral port (tests/benchmarks); .port reports
    the bound one.  start() returns immediately (the accept loop and
    every replica loop run on daemon threads); shutdown(drain=True)
    performs the graceful drain described in the module docstring.
    """

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False,
                 admin_swap=None, profile_dir: Optional[str] = None):
        self.router = router
        self.verbose = verbose
        # default output dir for POST /admin/profile device traces
        # (serve.py --profile-dir); a body "dir" still overrides
        self.profile_dir = profile_dir
        # optional POST /admin/swap hook: callable(body_dict) -> dict,
        # raising ValueError for bad bodies.  Replica processes wire
        # one in (frontend/replica.py); plain frontends leave it off
        # and the route 404s.
        self.admin_swap = admin_swap
        self.draining = False
        handler = type("BoundHandler", (_Handler,),
                       {"router": router, "frontend": self})
        self.httpd = _Server((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        self.router.start()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="frontend-http",
            kwargs={"poll_interval": 0.05}, daemon=True)
        self._thread.start()

    def shutdown(self, drain: bool = True, timeout: float = 120.0):
        """Graceful by default: flip /healthz to 503 and refuse new
        generate() calls, serve out everything in flight, then stop
        the accept loop and the replica loops."""
        self.draining = True
        if drain:
            self.router.wait_idle(timeout=timeout)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.router.stop(drain=drain, timeout=timeout)

    # fleet-level families (unlabeled singletons)
    _FLEET_FAMS = (
        ("repro_serving_requests_submitted", "counter", "submitted",
         "Requests accepted at the router door."),
        ("repro_serving_requests_completed", "counter", "completed",
         "Requests completed across the fleet."),
        ("repro_serving_requests_rejected", "counter", "rejected",
         "Requests rejected by door validation (HTTP 400)."),
        ("repro_serving_requests_shed", "counter", "shed",
         "Requests shed by backpressure (HTTP 429)."),
        ("repro_serving_requests_cancelled", "counter", "cancelled",
         "Requests cancelled before completion."),
        ("repro_serving_backlog", "gauge", "backlog",
         "Requests parked in the router backlog."),
        ("repro_serving_queue_depth", "gauge", "queue_depth",
         "Fleet-wide queued + in-flight requests."),
        ("repro_serving_streamed_tokens", "counter", "streamed_tokens",
         "Tokens delivered through streaming callbacks."),
    )
    # per-replica families: (family, type, stats key, help)
    _REPLICA_FAMS = (
        ("repro_serving_live_slots", "gauge", "live_slots",
         "Slots holding an admitted request."),
        ("repro_serving_pending", "gauge", "pending",
         "Requests queued on the replica."),
        ("repro_serving_peak_in_flight", "gauge", "peak_in_flight",
         "High-water mark of concurrently admitted requests."),
        ("repro_serving_preemptions", "counter", "preemptions",
         "Paged decode-time evictions back to the queue."),
        ("repro_serving_cancelled", "counter", "cancelled",
         "Requests cancelled on the replica."),
        ("repro_serving_steps_run", "counter", "steps_run",
         "Engine decode programs dispatched."),
        ("repro_serving_swaps_done", "counter", "swaps_done",
         "Parameter hot-swaps performed."),
        ("repro_serving_cache_bytes_per_device", "gauge",
         "cache_bytes_per_device", "KV cache bytes per device."),
    )
    _PAGE_FAMS = (
        ("repro_serving_total_pages", "gauge", "n_pages",
         "KV pages in the pool."),
        ("repro_serving_free_pages", "gauge", "free_pages",
         "KV pages on the free list."),
        ("repro_serving_available_pages", "gauge", "available_pages",
         "Free + evictable KV pages."),
        ("repro_serving_low_water_pages", "gauge", "low_water_pages",
         "Minimum free pages observed."),
        ("repro_serving_shared_pages", "gauge", "shared_pages",
         "Pages referenced by more than one slot (COW)."),
        ("repro_serving_kv_page_bytes", "gauge", "page_bytes",
         "Bytes per KV page."),
        ("repro_serving_kv_bytes_per_token", "gauge", "bytes_per_token",
         "KV bytes per cached token."),
        ("repro_serving_kv_quantized", "gauge", "kv_quantized",
         "1 when paged KV planes are stored quantized."),
    )
    _PREFIX_FAMS = (
        ("repro_serving_prefix_hit_rate", "gauge", "prefix_hit_rate",
         "Fraction of prompt tokens served from the prefix cache."),
        ("repro_serving_prefix_cached_pages", "gauge", "cached_pages",
         "Pages held by the prefix trie."),
        ("repro_serving_prefix_cow_pages", "counter", "cow_pages",
         "Copy-on-write page copies performed."),
        ("repro_serving_prefix_evicted_pages", "counter",
         "evicted_pages", "Prefix pages evicted (LRU)."),
    )
    _SPEC_FAMS = (
        ("repro_serving_spec_steps", "counter", "spec_steps",
         "Speculative iterations run."),
        ("repro_serving_spec_proposed", "counter", "proposed",
         "Draft tokens proposed."),
        ("repro_serving_spec_accepted", "counter", "accepted",
         "Draft tokens accepted."),
        ("repro_serving_spec_acceptance_rate", "gauge",
         "acceptance_rate", "Accepted / proposed draft tokens."),
        ("repro_serving_spec_mean_accepted_len", "gauge",
         "mean_accepted_len", "Mean tokens emitted per iteration."),
        ("repro_serving_spec_accepted_len_p50", "gauge",
         "accepted_len_p50", "Median tokens emitted per iteration."),
        ("repro_serving_spec_pruned_frac", "gauge", "pruned_frac",
         "Fraction of member votes provably prunable at verify."),
    )

    def metrics_text(self) -> str:
        """Prometheus text exposition of fleet + per-replica health:
        exactly one `# HELP`/`# TYPE` per family (no matter how many
        replica-labeled samples follow), escaped label values, a
        trailing newline — obs.parse_prometheus round-trips the whole
        scrape, and the conformance test holds it to that.  Latency
        histograms (TTFT, queue wait, inter-token, e2e) and the tick-
        phase profiler ride along from each replica's ServingObs."""
        s = self.router.stats()
        fs = obs_mod.FamilySet()
        for fam, mtype, key, help in self._FLEET_FAMS:
            fs.declare(fam, mtype, help)
            fs.sample(fam, None, s[key])
        groups = [(self._REPLICA_FAMS, lambda r: r),
                  (self._PAGE_FAMS, lambda r: r["page_stats"]),
                  (self._PREFIX_FAMS, lambda r: r["page_stats"]),
                  (self._SPEC_FAMS, lambda r: r.get("spec_stats"))]
        for fams, _ in groups:
            for fam, mtype, _, help in fams:
                fs.declare(fam, mtype, help)
        fs.declare("repro_serving_draining", "gauge",
                   "1 while the replica refuses new routes.")
        for r in s["replicas"]:
            lab = {"replica": r["name"]}
            for fams, pick in groups:
                src = pick(r)
                if not src:
                    continue
                for fam, _, key, _ in fams:
                    if key in src:
                        fs.sample(fam, lab, src[key])
            fs.sample("repro_serving_draining", lab, int(r["draining"]))
        # per-replica observability: histograms + tick phases
        fs.declare("repro_serving_tick_phase_seconds_total", "counter",
                   "Wall seconds spent per tick phase.")
        fs.declare("repro_serving_tick_phase_count_total", "counter",
                   "Times each tick phase ran.")
        fs.declare("repro_serving_tick_phase_ema_seconds", "gauge",
                   "EMA of per-tick phase wall seconds.")
        for rep in self.router.replicas:
            obs = rep.scheduler.obs
            if obs is None:
                continue
            lab = {"replica": rep.name}
            for h in obs.histograms():
                fs.add_histogram(h, lab)
            snap = obs.ticks.snapshot()
            for phase, d in snap.items():
                pl = {"replica": rep.name, "phase": phase}
                fs.sample("repro_serving_tick_phase_seconds_total", pl,
                          d["total_s"])
                fs.sample("repro_serving_tick_phase_count_total", pl,
                          d["count"])
                fs.sample("repro_serving_tick_phase_ema_seconds", pl,
                          d["ema_s"])
        return fs.render()


def serve_frontend(router: Router, host: str = "127.0.0.1",
                   port: int = 8000, verbose: bool = True,
                   profile_dir: Optional[str] = None) -> FrontendServer:
    """Convenience: build + start a FrontendServer; caller owns
    shutdown()."""
    srv = FrontendServer(router, host=host, port=port, verbose=verbose,
                         profile_dir=profile_dir)
    srv.start()
    return srv
