"""Process-backed replicas: the Router/Replica boundary over sockets.

frontend/router.py scales past one engine by running N replicas on N
threads in one process, but they still share one interpreter, one heap
and one fault domain: a failed launch or a crash in a kernel takes every
replica with it.  This module promotes the same boundary to OS
processes:

    ReplicaProcess  -- supervisor handle: execs
                       `python -m repro_torch.serving.frontend.replica`
                       with an EngineSpec, waits for the REPLICA_READY
                       handshake, health-checks over /healthz,
                       terminates gracefully (SIGTERM -> drain) or not
                       (SIGKILL, for fault injection)
    replica process -- builds its engine from the spec on its own device
                       (its own CUDA context, weights and page pool on
                       the card), mounts ONE Replica behind the Router +
                       FrontendServer stack, prints "REPLICA_READY <port>"
                       once a warm generate has loaded the kernels and
                       made the first launches, serves until SIGTERM
    FleetRouter     -- the parent-side router: least-loaded routing over
                       live replica ports via HTTP/SSE
                       (client.http_generate), crash latching +
                       retry-on-crash, 429 backoff, elastic
                       scale_to/autoscale from queue depth, and canary
                       rollout driven over POST /admin/swap

Children are exec'd (subprocess.Popen), never forked from a process that
holds a CUDA context.  Kernel libraries are shared through the build
directory; kernels/build.py writes each into a per-pid temporary file
and renames it, so children loading at once are safe.

Determinism is what makes the fleet testable: an EngineSpec carries init
SEEDS, not weights.  Every process built from one spec draws the same
K-member stack from `transformer.init(cfg, seed, device, members)` on
the spec's device's generator (torch's Philox generator on the card, its
CPU generator with device "cpu": the two give different numbers, so the
device is part of the spec), and the ready line carries a digest of the
weights' bits (`param_digest`) so a supervisor can hold the processes
equal instead of assuming it.  A request retried on a different replica
after a SIGKILL then returns token-exact output.

Failure contract (the soak in tests/test_torch_fleet.py enforces it): a
killed replica loses ONLY the requests it was serving at the moment of
death; FleetRouter.generate latches it out of rotation and retries each
lost request on a survivor, so the caller sees every request completed
exactly once, and a restarted process rejoins with a whole page pool
(read over the wire from /healthz page accounting).
"""
from __future__ import annotations

import hashlib
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
import weakref
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from repro_torch.serving import client as sclient
from repro_torch.serving import obs as obs_mod

_READY = "REPLICA_READY"
_EXIT = "REPLICA_EXIT"


# -- the spec: everything a process needs to rebuild the engine ---------------


@dataclass
class EngineSpec:
    """JSON-serializable engine recipe, seed-derived params included.

    Weights never cross the process boundary: `seed` (plus arch, members
    and device) pins the init, `ckpt`/`ckpt_step` optionally point at a
    checkpoint root (checkpoint/store.py, the JAX package's layout) to
    restore on top.  Two EngineSpecs that compare equal build engines
    that sample identical tokens.

    `device`: "" runs on the card (and raises where there is none),
    "cpu" on the CPU.  The init draws on that device's generator, so a
    spec's weights are the same in every process on the same kind of
    device; a checkpoint restored on top is the same on any.
    """

    arch: str = "gemma3-1b"
    reduced: bool = True
    dtype: str = ""  # "" = the arch's default; tests pin "float32" so
    # greedy argmax cannot fork on near-ties across processes
    members: int = 2
    seed: int = 0
    n_slots: int = 2
    max_prompt: int = 16
    max_out: int = 8
    prefill_chunk: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1
    quorum: Optional[List[float]] = None
    mesh: str = ""
    paged: bool = False
    page_size: int = 4
    n_pages: Optional[int] = None
    prefix_cache: bool = False
    kv_dtype: str = "f32"  # paged page storage: f32|bf16|int8|fp8
    draft_member0: bool = False  # speculative: member 0 drafts
    gamma: int = 4
    spec_sampling: bool = False
    ckpt: str = ""
    ckpt_step: Optional[int] = None
    prefill_budget: Optional[int] = None
    # observability: on by default (obs=False is the kill-switch);
    # trace_log appends one JSONL line per finished request (children of
    # one fleet may share a path: O_APPEND keeps lines whole);
    # profile_dir arms POST /admin/profile on the child's frontend
    obs: bool = True
    trace_log: str = ""
    profile_dir: str = ""
    extra: Dict[str, float] = field(default_factory=dict)
    device: str = ""

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "EngineSpec":
        return cls(**json.loads(raw))

    def config(self):
        from repro_torch.configs import registry
        cfg = registry.get_config(self.arch, reduced=self.reduced)
        return cfg.with_(dtype=self.dtype) if self.dtype else cfg

    def torch_device(self):
        from repro_torch.common.device import resolve_device
        return resolve_device(self.device or None)

    def init_params(self, seed: Optional[int] = None):
        """The K-member stack this spec pins: transformer.init on the
        spec's device, seeded from `seed` (default: the spec's)."""
        from repro_torch.models import transformer as tf
        return tf.init(self.config(), seed=self.seed if seed is None
                       else seed, device=self.torch_device(),
                       members=self.members)

    def restore(self, root: str, step: Optional[int], template):
        """The round `step` (default: the newest committed) of the
        checkpoint root, restored into `template`'s structure."""
        from repro_torch.checkpoint.store import (latest_step,
                                                  restore_checkpoint)
        if step is None:
            step = latest_step(root)
        if step is None:
            raise ValueError(f"ckpt {root}: no committed round")
        return restore_checkpoint(root, step, template)

    def build_engine(self):
        from repro_torch.common.tree import tree_map
        from repro_torch.serving.engine import EnsembleEngine
        if self.mesh:
            # a replica over a member mesh would be a world of processes
            # of its own, its followers outside the fleet's supervision
            raise NotImplementedError(
                f"mesh {self.mesh!r}: a fleet replica serves from one "
                f"process; the member mesh (serve --mesh) runs without "
                f"--fleet")
        cfg = self.config()
        dev = self.torch_device()
        if dev.type == "cuda":
            # f32 products as the CPU computes them: greedy tokens of one
            # spec must not depend on which process serves them
            import torch
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        params = self.init_params()
        if self.ckpt:
            params = self.restore(self.ckpt, self.ckpt_step, params)
        kw = dict(n_slots=self.n_slots, max_prompt=self.max_prompt,
                  max_out=self.max_out, prefill_chunk=self.prefill_chunk,
                  temperature=self.temperature, top_k=self.top_k,
                  eos_id=self.eos_id, quorum=self.quorum, seed=self.seed,
                  paged=self.paged,
                  page_size=self.page_size, n_pages=self.n_pages,
                  prefix_cache=self.prefix_cache, kv_dtype=self.kv_dtype,
                  device=dev)
        if self.draft_member0:
            from repro_torch.serving.spec import SpeculativeEngine
            draft = tree_map(lambda x: x[:1], params)
            return SpeculativeEngine(cfg, params, draft, gamma=self.gamma,
                                     spec_sampling=self.spec_sampling,
                                     **kw)
        return EnsembleEngine(cfg, params, **kw)


def param_digest(params) -> str:
    """A digest of a param tree's bits, computed where the tensors live
    (one small read a leaf): each leaf's words, as integers, weighted by
    their position and summed with wraparound, then hashed with the
    leaf's path, shape and dtype.  Equal trees give equal digests; a
    changed bit anywhere changes its leaf's sum."""
    import torch
    from repro_torch.serving.engine import _flatten
    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}
    h = hashlib.sha256()
    chunk = 1 << 24
    with torch.no_grad():
        for path, x in _flatten(params):
            flat = x.detach().contiguous().reshape(-1)
            ints = flat.view(words[flat.element_size()])
            acc = torch.zeros((), dtype=torch.int64, device=x.device)
            w = None
            for k in range(0, ints.numel(), chunk):
                c = ints[k:k + chunk].to(torch.int64)
                if w is None or w.numel() < c.numel():
                    w = torch.arange(1, c.numel() + 1, dtype=torch.int64,
                                     device=x.device)
                acc = acc * 1000003 + (c * w[:c.numel()]).sum()
            h.update(f"{path}:{tuple(x.shape)}:{x.dtype}:"
                     f"{int(acc)};".encode())
    return h.hexdigest()[:16]


# -- the child process entrypoint ---------------------------------------------


def _make_admin_swap(spec: EngineSpec, router):
    """POST /admin/swap hook for a replica process: build the new
    round's params IN the process (seed or checkpoint: weights never
    ride the request body) and run the in-process drain-swap rollout."""

    def admin_swap(body: dict) -> dict:
        eng = router.replicas[0].engine
        if "seed" in body and body["seed"] is not None:
            s = body["seed"]
            if not isinstance(s, int) or isinstance(s, bool):
                raise ValueError(f"seed must be an int, got {s!r}")
            new_params = spec.init_params(seed=s)
        elif "ckpt" in body:
            new_params = spec.restore(body["ckpt"], body.get("step"),
                                      eng.params)
        else:
            raise ValueError('swap body needs "seed" or "ckpt"')
        router.rollout(new_params)
        return {"swaps_done": eng.swaps_done}

    return admin_swap


def main(argv: Optional[List[str]] = None) -> int:
    """Run ONE replica process: engine + scheduler loop + HTTP surface.

    Prints "REPLICA_READY <port> params=<digest>" on stdout once a warm
    generate has loaded the kernels and run the first launches and the
    port is bound: the supervisor's spawn handshake.  SIGTERM drains
    gracefully (in-flight requests finish, pages return to the pool),
    prints "REPLICA_EXIT peak_bytes=<n>" (the card's peak allocation, 0
    on the CPU) and exits 0; SIGKILL is the fault the soak injects.
    """
    import argparse
    ap = argparse.ArgumentParser(
        prog="repro_torch.serving.frontend.replica")
    ap.add_argument("--spec", required=True,
                    help="EngineSpec JSON, or @path to a file of it")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port; the bound one is "
                         "reported in the ready line")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="shed with 429 past this queue depth")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    raw = args.spec
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    spec = EngineSpec.from_json(raw)

    import torch

    from repro_torch.serving.frontend.router import Replica, Router
    from repro_torch.serving.frontend.server import FrontendServer

    engine = spec.build_engine()
    # load the kernels and make their first launches (prefill and decode)
    # before declaring ready: the handshake means "this port serves at
    # decode speed", not "the first request pays the loading"
    warm = list(range(1, min(4, spec.max_prompt) + 1))
    engine.generate([warm], max_new=2)
    # static generate defers releasing its chains to the NEXT call; free
    # them now so an idle replica reports a whole page pool from tick one
    engine.update_slots(release=range(engine.n_slots))
    digest = param_digest(engine.params)

    rep = Replica("r0", engine, prefill_budget=spec.prefill_budget,
                  obs=spec.obs, trace_log=spec.trace_log or None,
                  profile_dir=spec.profile_dir or None)
    router = Router([rep], max_queue_depth=args.max_queue_depth)
    srv = FrontendServer(router, host=args.host, port=args.port,
                         verbose=args.verbose,
                         admin_swap=_make_admin_swap(spec, router),
                         profile_dir=spec.profile_dir or None)
    srv.start()

    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    print(f"{_READY} {srv.port} params={digest}", flush=True)
    while not done.wait(0.2):
        pass
    srv.shutdown(drain=True)
    dev = engine.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    print(f"{_EXIT} peak_bytes={peak}", flush=True)
    return 0


# -- the supervisor handle ----------------------------------------------------


def _src_pythonpath() -> str:
    """PYTHONPATH for a child: the src root this package was imported
    from first (sys.path does not inherit across exec), then whatever
    the parent already had."""
    import repro_torch
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    prior = os.environ.get("PYTHONPATH", "")
    return src + (os.pathsep + prior if prior else "")


def _reap(proc: subprocess.Popen):
    """Finaliser of a ReplicaProcess handle: a child still running when
    its handle goes away (or the interpreter exits) is killed and
    reaped, so no child outlives its supervisor."""
    if proc.poll() is None:
        proc.kill()
        try:
            proc.wait(10.0)
        except subprocess.TimeoutExpired:
            pass


class ReplicaProcess:
    """Supervisor handle for one replica process.

    start() execs the interpreter, a reader thread watches stdout for
    the ready line (and keeps draining it after: a full pipe would wedge
    the child); terminate() is the graceful path (SIGTERM -> drain ->
    exit 0), kill() the fault-injection one (SIGKILL, reaped).  `tail`
    keeps the child's last output lines for crash diagnostics; `digest`
    is the ready line's param digest and `peak_memory` the exit line's
    peak bytes.  The child inherits this process's environment.
    """

    def __init__(self, name: str, spec: EngineSpec,
                 host: str = "127.0.0.1",
                 max_queue_depth: Optional[int] = None,
                 verbose: bool = False):
        self.name = name
        self.spec = spec
        self.host = host
        self.max_queue_depth = max_queue_depth
        self.verbose = verbose
        self.port: Optional[int] = None
        self.digest: Optional[str] = None
        self.peak_memory: Optional[int] = None
        self.proc: Optional[subprocess.Popen] = None
        self.tail: deque = deque(maxlen=80)
        self._ready = threading.Event()
        self._reader: Optional[threading.Thread] = None
        self._finalizer = None

    def start(self):
        if self.proc is not None and self.proc.poll() is None:
            return
        cmd = [sys.executable, "-m", "repro_torch.serving.frontend.replica",
               "--spec", self.spec.to_json(),
               "--host", self.host, "--port", "0"]
        if self.max_queue_depth is not None:
            cmd += ["--max-queue-depth", str(self.max_queue_depth)]
        if self.verbose:
            cmd += ["--verbose"]
        env = dict(os.environ, PYTHONPATH=_src_pythonpath())
        self.port = self.digest = self.peak_memory = None
        self._ready.clear()
        self.proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._finalizer = weakref.finalize(self, _reap, self.proc)
        self._reader = threading.Thread(
            target=self._read_stdout, name=f"replica-io-{self.name}",
            daemon=True)
        self._reader.start()

    def _read_stdout(self):
        proc = self.proc
        for line in proc.stdout:
            line = line.rstrip("\n")
            self.tail.append(line)
            if line.startswith(_READY):
                words = line.split()
                self.port = int(words[1])
                self.digest = words[2].split("=", 1)[1]
                self._ready.set()
            elif line.startswith(_EXIT):
                self.peak_memory = int(line.split("=", 1)[1])
        proc.stdout.close()

    def wait_ready(self, timeout: float = 300.0) -> bool:
        """Block until the ready handshake (kernels loaded, port bound)
        or child death; False on timeout/death."""
        deadline = time.time() + timeout
        while time.time() <= deadline:
            if self._ready.wait(0.1):
                return True
            if self.proc is None or self.proc.poll() is not None:
                return False
        return False

    @property
    def url(self) -> str:
        if self.port is None:
            raise RuntimeError(f"replica {self.name} not ready")
        return f"http://{self.host}:{self.port}"

    @property
    def alive(self) -> bool:
        return (self.proc is not None and self.proc.poll() is None
                and self._ready.is_set())

    def healthz(self, timeout: float = 10.0) -> dict:
        return sclient.http_get_json(self.url, "/healthz", timeout=timeout)

    def terminate(self, timeout: float = 60.0) -> Optional[int]:
        """Graceful retirement: SIGTERM -> drain -> exit; escalates to
        SIGKILL only past `timeout`.  -> exit code (None if never
        started).  Waits for the reader thread, so the exit line is in
        by the time this returns."""
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10.0)
        if self._reader is not None:
            self._reader.join(10.0)
        return self.proc.poll()

    def kill(self):
        """Fault injection: SIGKILL, mid-anything, then reap.  No drain,
        no flush: exactly the failure the soak needs to inject."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10.0)


# -- the parent-side fleet router ---------------------------------------------


class FleetRouter:
    """Route over a fleet of replica processes; survive their deaths.

    The socket-tier analogue of Router: least-loaded routing (local
    in-flight counters: the parent's own view, no health check on the
    hot path), crash latching (a dead process leaves rotation at the
    next failed request or health_sweep), bounded retry-on-crash (a
    request lost to a SIGKILL reruns on a survivor: same spec, same
    seeds, token-exact), 429-aware backoff, and elastic membership
    (scale_to / autoscale from queue depth).

    rollout(seed=..., canary=0.25) swaps one process first over
    POST /admin/swap, routes ~25% of generate() calls at it until
    `canary_requests` complete, then swaps the rest: the in-process
    canary semantics, spoken over sockets.
    """

    def __init__(self, spec: EngineSpec, n: int = 2,
                 host: str = "127.0.0.1",
                 max_queue_depth: Optional[int] = None,
                 verbose: bool = False):
        if n < 1:
            raise ValueError(f"fleet needs n >= 1 replicas, got {n}")
        self.spec = spec
        self.host = host
        self.max_queue_depth = max_queue_depth
        self.verbose = verbose
        self.procs: List[ReplicaProcess] = [
            self._new_proc(f"p{i}") for i in range(n)]
        self._lock = threading.Lock()
        self._in_flight: Dict[str, int] = {p.name: 0 for p in self.procs}
        self._next_id = n
        self.n_retried = 0      # requests rerun after a replica death
        self.n_backoffs = 0     # 429s honoured with a sleep-and-retry
        self.n_latched = 0      # replicas latched out after crashing
        self.n_restarts = 0     # replacement processes spawned
        self.last_sweep_s = 0.0  # wall time of the last health_sweep
        self._canary: Optional[str] = None
        self._canary_frac = 0.0
        self._canary_credit = 0.0
        # fleet-side request traces: which replica served each request,
        # every failover hop (replica_failed -> retried), backpressure
        # waits: the parent's view beside the child-side span chain that
        # rides each completion payload
        self.traces = obs_mod.TraceRing(keep=256)
        self._next_trace = 0

    def _new_proc(self, name: str) -> ReplicaProcess:
        return ReplicaProcess(name, self.spec, host=self.host,
                              max_queue_depth=self.max_queue_depth,
                              verbose=self.verbose)

    # -- lifecycle ----------------------------------------------------------

    def start(self, timeout: float = 600.0):
        """Spawn every replica concurrently and wait for all ready
        handshakes (their start-ups overlap).  A child that dies or
        never becomes ready stops the fleet and raises with its output."""
        for p in self.procs:
            p.start()
        deadline = time.time() + timeout
        for p in self.procs:
            if not p.wait_ready(max(0.0, deadline - time.time())):
                self.stop()
                tail = "\n".join(p.tail)
                raise RuntimeError(
                    f"replica {p.name} never became ready; output:\n{tail}")

    def stop(self):
        for p in self.procs:
            p.terminate(timeout=30.0)

    # -- routing + retry ----------------------------------------------------

    def _pick(self, avoid: Optional[str] = None) -> ReplicaProcess:
        with self._lock:
            live = [p for p in self.procs if p.alive]
            if not live:
                raise RuntimeError("no live replicas in the fleet")
            if avoid is not None:
                # crash retry: a just-killed process can read as alive
                # until poll() observes the death; prefer any other
                live = [p for p in live if p.name != avoid] or live
            if self._canary is not None:
                canary = next((p for p in live
                               if p.name == self._canary), None)
                if canary is not None:
                    self._canary_credit += self._canary_frac
                    if self._canary_credit >= 1.0:
                        self._canary_credit -= 1.0
                        self._in_flight[canary.name] += 1
                        return canary
                    rest = [p for p in live if p.name != canary.name]
                    live = rest or live
            p = min(live, key=lambda p: self._in_flight[p.name])
            self._in_flight[p.name] += 1
            return p

    def _done(self, p: ReplicaProcess):
        with self._lock:
            if p.name in self._in_flight:
                self._in_flight[p.name] -= 1

    def _latch(self, p: ReplicaProcess):
        """A request against `p` failed: if its process is gone, latch
        it out of rotation (alive already False) and count it."""
        if not p.alive:
            with self._lock:
                self.n_latched += 1

    def generate(self, tokens, max_new: int, stream: bool = False,
                 retries: int = 3, timeout: float = 120.0,
                 **sample_kw) -> dict:
        """One request against the fleet; crash-retried, 429-backed-off.

        A replica dying mid-request surfaces as a connection error or a
        mid-SSE close: the request reruns on a survivor (preferring any
        replica other than the one that just failed, after a brief
        pause), up to `retries` times; identical specs make the rerun
        token-exact.  429 answers honour Retry-After and do not consume
        a retry (shed load is delay, not failure).  Raises after
        `retries` crash-retries.

        The returned dict carries a "fleet_trace": the parent-side span
        chain (routed -> [replica_failed -> retried ->] done).
        """
        with self._lock:
            tid = self._next_trace
            self._next_trace += 1
        tr = self.traces.start(tid)
        tr.add("enqueued")
        crash_left = retries
        avoid = None
        while True:
            p = self._pick(avoid=avoid)
            tr.add("routed", p.name)
            try:
                result = sclient.http_generate(
                    p.url, tokens, max_new, stream=stream,
                    timeout=timeout, **sample_kw)
                tr.add("done")
                self.traces.finish(tid)
                result["fleet_trace"] = tr.to_dict()
                return result
            except sclient.Backpressure as e:
                with self._lock:
                    self.n_backoffs += 1
                tr.add("backpressure", round(e.retry_after, 3))
                time.sleep(min(e.retry_after, 1.0))
            except (OSError, RuntimeError, http.client.HTTPException) as e:
                # a SIGKILL surfaces as whatever the socket was doing:
                # reset (OSError), a mid-SSE close (RuntimeError from
                # http_generate), or a truncated body (IncompleteRead)
                self._latch(p)
                tr.add("replica_failed", p.name)
                crash_left -= 1
                if crash_left < 0:
                    tr.add("failed")
                    self.traces.finish(tid)
                    raise RuntimeError(
                        f"request failed on {p.name} with no retries "
                        f"left: {e!r}") from e
                avoid = p.name
                with self._lock:
                    self.n_retried += 1
                tr.add("retried")
                # a dead port refuses connections at once: without a
                # pause the whole retry budget can burn inside the
                # kill -> poll() observation window
                time.sleep(0.1)
            finally:
                self._done(p)

    # -- health + elasticity ------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return sum(self._in_flight.values())

    def live(self) -> List[ReplicaProcess]:
        return [p for p in self.procs if p.alive]

    def health_sweep(self) -> List[str]:
        """Latch every dead process out of rotation; -> their names.
        Routing already skips dead processes (alive is a poll(), not a
        cache); the sweep lets supervision logic (restart, autoscale)
        see deaths it has not tripped over yet.  Its wall time lands in
        last_sweep_s (repro_serving_fleet_health_sweep_seconds)."""
        t0 = time.monotonic()
        dead = [p.name for p in self.procs
                if p.proc is not None and not p.alive]
        self.last_sweep_s = time.monotonic() - t0
        return dead

    def restart(self, name: str, timeout: float = 600.0) -> ReplicaProcess:
        """Replace a (dead or live) replica with a fresh process under
        the same name: the recovery half of fault injection.  Blocks
        until the replacement's ready handshake."""
        idx = next(i for i, p in enumerate(self.procs) if p.name == name)
        old = self.procs[idx]
        old.terminate(timeout=10.0)
        fresh = self._new_proc(name)
        fresh.start()
        if not fresh.wait_ready(timeout):
            fresh.terminate(timeout=10.0)
            tail = "\n".join(fresh.tail)
            raise RuntimeError(
                f"restarted replica {name} never became ready; "
                f"output:\n{tail}")
        with self._lock:
            self.procs[idx] = fresh
            self._in_flight[name] = 0
            self.n_restarts += 1
        return fresh

    def scale_to(self, n: int, timeout: float = 600.0):
        """Grow or shrink the fleet to n live replicas: spawn fresh
        processes (concurrently) or retire the least-loaded ones
        (gracefully: SIGTERM drains in-flight work first)."""
        if n < 1:
            raise ValueError(f"fleet needs n >= 1 replicas, got {n}")
        live = self.live()
        if n > len(live):
            fresh = []
            with self._lock:
                for _ in range(n - len(live)):
                    p = self._new_proc(f"p{self._next_id}")
                    self._next_id += 1
                    fresh.append(p)
            for p in fresh:
                p.start()
            deadline = time.time() + timeout
            for p in fresh:
                if not p.wait_ready(max(0.0, deadline - time.time())):
                    for q in fresh:
                        q.terminate(timeout=10.0)
                    raise RuntimeError(
                        f"scale-out replica {p.name} never became "
                        f"ready; output:\n" + "\n".join(p.tail))
            with self._lock:
                for p in fresh:
                    self.procs.append(p)
                    self._in_flight[p.name] = 0
        elif n < len(live):
            with self._lock:
                victims = sorted(
                    live, key=lambda p: self._in_flight[p.name])[:len(live) - n]
                names = {p.name for p in victims}
                self.procs = [p for p in self.procs
                              if p.name not in names]
                for name in names:
                    self._in_flight.pop(name, None)
            for p in victims:
                p.terminate()

    def autoscale(self, min_n: int = 1, max_n: int = 4,
                  high_depth: int = 8, low_depth: int = 1) -> int:
        """One elastic step from queue depth: grow by one past
        high_depth, shrink by one under low_depth, clamp to
        [min_n, max_n]; -> the fleet size after the step.  Policy is a
        pure function of the current depth, no hysteresis state."""
        depth = self.queue_depth
        n = len(self.live())
        want = n
        if depth >= high_depth:
            want = min(n + 1, max_n)
        elif depth <= low_depth:
            want = max(n - 1, min_n)
        if want != n:
            self.scale_to(want)
        return len(self.live())

    # -- rollout over the wire ----------------------------------------------

    def _swap_proc(self, p: ReplicaProcess, body: dict) -> dict:
        req = urllib.request.Request(
            p.url + "/admin/swap", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600.0) as r:
            return json.loads(r.read())

    def rollout(self, seed: Optional[int] = None, ckpt: str = "",
                step: Optional[int] = None, canary: float = 0.0,
                canary_requests: int = 4, canary_timeout: float = 120.0):
        """Fleet-wide model rollout over POST /admin/swap, one process at
        a time (each process runs its own drain -> swap -> rejoin).
        canary > 0: swap the first live replica, route that traffic
        fraction at it until `canary_requests` of its completions land
        on the new round, then swap the rest; a canary that dies aborts
        the rollout with the remaining fleet untouched on the old round.
        """
        body = ({"seed": seed} if seed is not None
                else {"ckpt": ckpt, "step": step})
        if seed is None and not ckpt:
            raise ValueError("rollout needs seed or ckpt")
        remaining = self.live()
        if not remaining:
            raise RuntimeError("no live replicas to roll out to")
        if canary > 0 and len(remaining) > 1:
            first = remaining[0]
            base = first.healthz()["completed"]
            self._swap_proc(first, body)
            with self._lock:
                self._canary = first.name
                self._canary_frac = float(min(canary, 1.0))
                self._canary_credit = 0.0
            try:
                deadline = time.time() + canary_timeout
                while True:
                    if not first.alive:
                        raise RuntimeError(
                            f"canary {first.name} died on the new round; "
                            f"rollout aborted, rest of fleet on the old "
                            f"round")
                    if first.healthz()["completed"] - base \
                            >= canary_requests:
                        break
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"canary saw too little traffic in "
                            f"{canary_timeout}s; rollout aborted")
                    time.sleep(0.05)
            finally:
                with self._lock:
                    self._canary = None
            remaining = remaining[1:]
        for p in remaining:
            self._swap_proc(p, body)

    # -- telemetry ----------------------------------------------------------

    def metrics_text(self, timeout: float = 10.0) -> str:
        """ONE scrape for the whole process tree: GET /metrics from every
        live child, merged (obs.merge_scrapes) with each sample
        re-labelled replica=<child name> and a replica="fleet" row per
        family, then the fleet's own gauges: retries, restarts,
        backoffs, latched replicas, canary state, health-sweep time.  A
        child that dies mid-scrape is skipped, not fatal."""
        scrapes = []
        for p in self.procs:
            if not p.alive:
                continue
            try:
                scrapes.append(
                    (p.name,
                     sclient.http_get_text(p.url, "/metrics",
                                           timeout=timeout)))
            except (OSError, http.client.HTTPException):
                continue
        merged = obs_mod.merge_scrapes(scrapes)
        fs = obs_mod.FamilySet()
        for fam, mtype, val, help in (
            ("repro_serving_fleet_procs", "gauge", len(self.procs),
             "Replica processes the fleet tracks (live + dead)."),
            ("repro_serving_fleet_live_replicas", "gauge",
             len(self.live()), "Replica processes serving traffic."),
            ("repro_serving_fleet_queue_depth", "gauge",
             self.queue_depth, "Parent-side in-flight requests."),
            ("repro_serving_fleet_retries_total", "counter",
             self.n_retried, "Requests rerun after a replica death."),
            ("repro_serving_fleet_restarts_total", "counter",
             self.n_restarts, "Replacement replica processes spawned."),
            ("repro_serving_fleet_backoffs_total", "counter",
             self.n_backoffs, "429 answers honoured with a backoff."),
            ("repro_serving_fleet_latched_total", "counter",
             self.n_latched, "Replicas latched out after crashing."),
            ("repro_serving_fleet_health_sweep_seconds", "gauge",
             self.last_sweep_s, "Wall time of the last health_sweep."),
        ):
            fs.declare(fam, mtype, help)
            fs.sample(fam, None, val)
        fs.declare("repro_serving_fleet_canary", "gauge",
                   "1 while the labelled replica serves as canary.")
        if self._canary is not None:
            fs.sample("repro_serving_fleet_canary",
                      {"replica": self._canary}, 1)
        return merged + fs.render()

    def stats(self) -> dict:
        reps = []
        for p in self.procs:
            entry = {"name": p.name, "alive": p.alive, "port": p.port,
                     "digest": p.digest}
            if p.alive:
                try:
                    entry["healthz"] = p.healthz()
                except OSError:
                    entry["alive"] = False
            reps.append(entry)
        return {
            "n_procs": len(self.procs),
            "n_live": len(self.live()),
            "queue_depth": self.queue_depth,
            "retried": self.n_retried,
            "backoffs": self.n_backoffs,
            "latched": self.n_latched,
            "restarts": self.n_restarts,
            "last_sweep_s": self.last_sweep_s,
            "canary": self._canary,
            "replicas": reps,
        }


if __name__ == "__main__":
    raise SystemExit(main())
