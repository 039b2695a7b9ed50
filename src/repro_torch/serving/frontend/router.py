"""Multi-replica router: N engine replicas behind one submit() door.

One EnsembleEngine is bounded by its slot pool (and, paged, its page
pool).  The router scales past one engine by running N independent
replicas, each with its own cache pool and online scheduler loop on its
own thread (the weights may be one set shared by all), and routing every request to the least-loaded
live replica.  Replicas never talk to each other: an EC-DNN global model
is K independent members (paper Eqn 6), so a replica is a complete
serving unit and capacity scales by adding more.

Routing policy (`Router.submit`): among non-draining replicas, pick the
one with the fewest in-flight requests (live slots + its own queue),
breaking ties toward the most free pages (`EnsembleEngine.free_pages`;
contiguous engines tie on free slots).  All policy is host-side and O(N)
per request.

Threads and the card: only a replica's loop thread runs its engine's
steps.  HTTP handler threads only submit, cancel and read counters; the
callbacks a request carries fire on the loop thread from the harvest's
one device read, so streaming adds no read of its own.

Draining (`Router.drain`): a draining replica accepts no new routes but
keeps ticking until its queue and slots empty: in-flight requests finish
normally.  That is the unit step of the zero-downtime rollout:

    rollout(new_stacked_params):
        for each group of replicas over one set of weights, in turn:
            drain -> wait quiesced -> engine.swap_params -> rejoin

`swap_params` copies the new weights into the live tensors in place.  It
runs on the rollout's thread while the replica's loop is parked with no
queued, live or unreleased work (`Scheduler.wait_quiesced`), so no tick
reads the weights it writes; on the card the copies go to the same
default stream the loop's next tick enqueues on, so they land first.
Replicas may share one set of weight tensors (engines built over one
param tree do): such a group drains and swaps together, since a copy
into one engine's weights is a copy into all of theirs.  At most one
group is out of rotation at any moment, every request is served end to
end by one model version, and nothing is dropped.  When the group is
the whole fleet (one replica, or replicas that all share their weights)
the router parks incoming requests in a backlog while it drains and
flushes them to the swapped replicas on rejoin: still zero drops, at the
cost of queueing delay.

`rollout(..., canary=0.25)` swaps ONE group first and routes that
fraction of traffic to the group's first replica (the rest of the group
stays out of rotation meanwhile); only once the canary has served
`canary_requests` completions without its loop failing does the
drain-swap proceed fleet-wide.

Overload is shed, not queued without bound: with `max_queue_depth` set,
submit() raises QueueFull once fleet-wide queue depth (in-flight +
backlog) reaches the threshold; the HTTP layer answers 429 with
Retry-After.  Cancellation propagates the other way: `cancel(name, rid)`
forwards a client disconnect to the owning replica's Scheduler.cancel
(or unparks a backlog ticket), releasing the slot and its pages.

The same boundary also runs over sockets: frontend/replica.py promotes
each replica to its own OS process behind a FleetRouter that speaks
HTTP/SSE to replica ports.  This module is the in-process tier both
build on.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

from repro_torch.common.tree import tree_leaves
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.scheduler import (Completion, DoneCallback, Scheduler,
                                     TokenCallback)


class QueueFull(RuntimeError):
    """Backpressure: Router.submit refused because fleet queue depth
    crossed max_queue_depth.  .retry_after (seconds) is the router's
    drain estimate — the HTTP layer forwards it as a 429 Retry-After
    header so well-behaved clients back off instead of retry-storming
    a saturated fleet."""

    def __init__(self, depth: int, limit: int, retry_after: float):
        super().__init__(
            f"queue depth {depth} >= max_queue_depth {limit}; "
            f"retry after {retry_after:.2f}s")
        self.depth = depth
        self.limit = limit
        self.retry_after = retry_after


class Replica:
    """One engine + its online scheduler loop, on its own thread."""

    def __init__(self, name: str, engine: EnsembleEngine,
                 prefill_budget: Optional[int] = None,
                 obs=True, trace_log: Optional[str] = None,
                 profile_dir: Optional[str] = None):
        self.name = name
        self.engine = engine
        # never retain completions: a replica loop lives for the
        # process lifetime and delivers results via on_done — keeping
        # every token array in .completions would leak without bound.
        # obs/trace_log/profile_dir ride through to the scheduler's
        # observability layer (on by default; obs=False kill-switch).
        self.scheduler = Scheduler(engine, prefill_budget=prefill_budget,
                                   retain_completions=False, obs=obs,
                                   trace_log=trace_log,
                                   profile_dir=profile_dir)
        self.draining = False
        self.failed: Optional[str] = None  # loop-thread crash, if any
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def _loop(self):
        """serve_forever with a crash latch: an exception out of tick()
        (engine bug, a failed launch) must take this replica OUT
        of rotation — a silently dead loop would keep receiving routes
        and hang every handler parked on its callbacks."""
        try:
            self.scheduler.serve_forever()
        except BaseException as e:  # noqa: BLE001 — latch, then re-raise
            self.failed = repr(e)
            self.draining = True
            raise

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self.scheduler.clear_stop()  # re-arm BEFORE the thread exists:
        # a stop() from here on must win the race, not be erased
        self._thread = threading.Thread(
            target=self._loop, name=f"replica-{self.name}", daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0):
        self.scheduler.stop()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- load telemetry -----------------------------------------------------

    @property
    def in_flight(self) -> int:
        s = self.scheduler
        return s.live_slots + len(s.pending)

    @property
    def idle(self) -> bool:
        return not self.scheduler.has_work

    @property
    def routable(self) -> bool:
        """Eligible for new requests: not draining, not crashed, and
        its loop thread is actually running."""
        return (not self.draining and self.failed is None
                and self._thread is not None and self._thread.is_alive())

    def load_key(self) -> Tuple[int, int, int]:
        """Least-loaded sort key: routable replicas first (a draining
        or crashed replica sorts as infinitely loaded — `_route`
        filters them, but drain() can race the filter, and the key must
        hold on its own), then fewest in-flight, then the scarcer
        capacity signal — free pages on a paged engine, free slots
        otherwise (both negated: more free sorts first)."""
        e = self.engine
        free = (e.free_pages if e.paged
                else e.n_slots - self.scheduler.live_slots)
        return (int(self.draining or self.failed is not None),
                self.in_flight, -free)

    def stats(self) -> dict:
        s, e = self.scheduler, self.engine
        return {
            "name": self.name,
            "draining": self.draining,
            "failed": self.failed,
            "live_slots": s.live_slots,
            "pending": len(s.pending),
            "completed": s.n_completed,
            "cancelled": s.n_cancelled,
            "preemptions": s.preemptions,
            "peak_in_flight": s.peak_in_flight,
            "streamed_tokens": s.n_streamed,
            "steps_run": e.steps_run,
            "prefills_run": e.prefills_run,
            "swaps_done": e.swaps_done,
            "members": e.n_members,
            "n_slots": e.n_slots,
            "cache_bytes_per_device": e.cache_bytes(),
            "page_stats": e.page_stats(),
            # duck-typed: only a SpeculativeEngine carries acceptance
            # telemetry; plain engines report an empty dict
            "spec_stats": (e.spec_stats()
                           if hasattr(e, "spec_stats") else {}),
        }


class Router:
    """Fan N replicas behind one thread-safe submit()/stream door."""

    def __init__(self, replicas: Sequence[Replica],
                 max_queue_depth: Optional[int] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        self.replicas: List[Replica] = list(replicas)
        self._by_name = {r.name: r for r in self.replicas}
        self._lock = threading.Lock()
        # requests that arrived while every replica was draining park
        # here and flush on the next rejoin — drained, never dropped.
        # Entries carry their router-level ticket so cancel("backlog",
        # ticket) can unpark one before a replica picks it up.
        self._backlog: deque = deque()
        # backpressure: past this fleet-wide depth (in-flight across
        # replicas + backlog) submit() sheds with QueueFull instead of
        # queueing without bound; None = never shed
        self.max_queue_depth = max_queue_depth
        self.n_submitted = 0
        self.n_completed = 0
        self.n_rejected = 0   # door validation failures (HTTP 400)
        self.n_shed = 0       # backpressure rejections (HTTP 429)
        self.n_cancelled_backlog = 0  # tickets cancelled while parked
        # canary rollout state: while set, _route sends ~frac of
        # submissions to the named (already-swapped) replica
        self._canary: Optional[str] = None
        self._canary_frac = 0.0
        self._canary_credit = 0.0
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        for r in self.replicas:
            r.start()
        self._started = True

    def stop(self, drain: bool = True, timeout: float = 60.0):
        """Stop the fleet; drain=True serves out every queued and
        in-flight request first (graceful shutdown), drain=False stops
        after the current tick (in-flight state is abandoned)."""
        if drain:
            self.wait_idle(timeout=timeout)
        for r in self.replicas:
            r.stop()
        self._started = False

    # -- routing ------------------------------------------------------------

    def _route(self) -> Optional[Replica]:
        live = [r for r in self.replicas if r.routable]
        if not live:
            return None
        if self._canary is not None:
            canary = self._by_name.get(self._canary)
            if canary is not None and canary.routable:
                # deterministic fractional routing: accumulate credit
                # per submission, send one to the canary each time it
                # crosses 1.0 — no RNG, exact fraction over any window
                self._canary_credit += self._canary_frac
                if self._canary_credit >= 1.0:
                    self._canary_credit -= 1.0
                    return canary
                rest = [r for r in live if r.name != canary.name]
                if rest:
                    return min(rest, key=Replica.load_key)
        return min(live, key=Replica.load_key)

    @property
    def queue_depth(self) -> int:
        """Fleet-wide demand: queued + live requests across replicas,
        plus the backlog — the number max_queue_depth sheds against."""
        return sum(r.in_flight for r in self.replicas) + len(self._backlog)

    def submit(self, tokens, max_new: int,
               on_token: Optional[TokenCallback] = None,
               on_done: Optional[DoneCallback] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None,
               draft: Optional[bool] = None) -> Tuple[str, int]:
        """Route one request to the least-loaded live replica;
        -> (replica name, rid on that replica).  Thread-safe.
        temperature/top_k/seed/draft are per-request overrides handed
        through to Scheduler.submit (None = engine default).

        When every replica is draining (single-replica rollout) the
        request parks in the router backlog and is assigned on the next
        rejoin — the returned name is then "backlog" and the rid is a
        router-level ticket (on_done/on_token still fire normally once
        a replica picks it up).

        With max_queue_depth set, raises QueueFull (not ValueError)
        once fleet-wide queue depth reaches the threshold — the caller
        answers 429 + Retry-After instead of parking another handler
        on a saturated fleet.
        """
        sample_kw = dict(temperature=temperature, top_k=top_k,
                         seed=seed, draft=draft)
        with self._lock:
            if self.max_queue_depth is not None:
                depth = self.queue_depth
                if depth >= self.max_queue_depth:
                    self.n_shed += 1
                    # drain estimate: current depth at ~20 req/s/fleet
                    # is deliberately coarse — the header's job is to
                    # spread the retry herd, not to be a promise
                    raise QueueFull(depth, self.max_queue_depth,
                                    max(0.1, 0.05 * depth))
            rep = self._route()
            if rep is None:
                # validate at the door even while parked, so a bad
                # request is rejected now, not after the rollout
                self.replicas[0].engine.validate_request(
                    tokens, max_new, temperature=temperature,
                    top_k=top_k, seed=seed)
                ticket = self.n_submitted
                self.n_submitted += 1
                done = self._count_done(on_done)
                self._backlog.append(
                    (ticket, tokens, max_new, on_token, done, sample_kw))
                return ("backlog", ticket)
            # count only after validation inside submit() passes —
            # door-rejected requests must not inflate the counter (the
            # backlog branch above validates before ticketing too)
            rid = rep.scheduler.submit(tokens, max_new, on_token=on_token,
                                       on_done=self._count_done(on_done),
                                       **sample_kw)
            self.n_submitted += 1
            return (rep.name, rid)

    def count_rejected(self):
        """Door-rejection counter bump, under the router lock (handler
        threads race on it)."""
        with self._lock:
            self.n_rejected += 1

    def replica_dead(self, name: str) -> bool:
        """Can `name` still deliver callbacks?  True once its loop
        thread has crashed or exited — waiters must give up instead of
        parking forever.  "backlog" tickets are router-owned (False)."""
        rep = self._by_name.get(name)
        if rep is None:
            return False
        t = rep._thread
        return rep.failed is not None or (t is not None and not t.is_alive())

    def _count_done(self, on_done: Optional[DoneCallback]) -> DoneCallback:
        def counting(comp: Completion):
            with self._lock:  # loop threads race on the counter
                self.n_completed += 1
            if on_done is not None:
                on_done(comp)
        return counting

    def cancel(self, name: str, rid: int) -> bool:
        """Propagate a client disconnect: forward to the owning
        replica's Scheduler.cancel (which releases the slot, pages,
        and prefix refs at its next tick), or unpark a "backlog"
        ticket before any replica picks it up.  -> False when the
        request already finished (benign race) or the name is gone."""
        if name == "backlog":
            with self._lock:
                for entry in self._backlog:
                    if entry[0] == rid:
                        self._backlog.remove(entry)
                        self.n_cancelled_backlog += 1
                        return True
            return False
        rep = self._by_name.get(name)
        return rep.scheduler.cancel(rid) if rep is not None else False

    def _flush_backlog_locked(self):
        while self._backlog:
            rep = self._route()
            if rep is None:
                return
            (_, tokens, max_new, on_token, done,
             sample_kw) = self._backlog.popleft()
            rep.scheduler.submit(tokens, max_new, on_token=on_token,
                                 on_done=done, **sample_kw)

    # -- elastic membership -------------------------------------------------

    def add_replica(self, rep: Replica):
        """Grow the fleet under traffic: register (and start, if the
        router is running) a new replica and hand it any backlog.  The
        elastic scale-out step — FleetRouter drives the process-backed
        equivalent from queue depth."""
        with self._lock:
            if rep.name in self._by_name:
                raise ValueError(f"replica name {rep.name!r} already "
                                 f"in the fleet")
            self.replicas.append(rep)
            self._by_name[rep.name] = rep
            if self._started:
                rep.start()
            self._flush_backlog_locked()

    def remove_replica(self, name: str, timeout: float = 120.0) -> Replica:
        """Retire one replica gracefully: drain -> wait -> stop -> drop
        from rotation; -> the detached Replica (its engine can be
        reused or discarded).  Refuses to empty the fleet."""
        rep = self._by_name[name]
        with self._lock:
            if len(self.replicas) <= 1:
                raise ValueError("cannot retire the last replica")
        self.drain(name)
        if not self.wait_drained(name, timeout=timeout):
            raise TimeoutError(
                f"replica {name} did not drain within {timeout}s "
                f"({rep.in_flight} in flight); still in rotation "
                f"(draining)")
        rep.stop()
        with self._lock:
            self.replicas.remove(rep)
            self._by_name.pop(name)
        return rep

    # -- draining + rollout -------------------------------------------------

    def drain(self, name: str):
        """Take one replica out of rotation; its in-flight and queued
        requests keep running to completion.  Taken under the router
        lock so a submit that already routed here finishes enqueueing
        first — wait_drained then cannot observe a falsely-idle
        replica."""
        with self._lock:
            self._by_name[name].draining = True

    def rejoin(self, name: str):
        """Put a drained replica back in rotation and hand it any
        backlogged requests."""
        with self._lock:
            self._by_name[name].draining = False
            self._flush_backlog_locked()

    def wait_drained(self, name: str, timeout: float = 120.0) -> bool:
        """Block until a draining replica has no queued or live work
        AND its loop has flushed every pending page release — event-
        based (Scheduler.wait_quiesced): the loop signals its own park,
        so this waits on the state transition itself, not on a
        wall-clock sleep happening to land after it."""
        return self._by_name[name].scheduler.wait_quiesced(timeout)

    def wait_idle(self, timeout: float = 120.0) -> bool:
        """Block until every replica is quiesced (idle, releases
        flushed) and the backlog is empty."""
        deadline = time.time() + timeout
        while time.time() <= deadline:
            if not all(r.scheduler.wait_quiesced(
                    max(0.0, deadline - time.time()))
                    for r in self.replicas):
                return False
            with self._lock:
                # a backlog flush re-fills replicas; re-check quiesce
                # on the next pass if anything moved
                if not self._backlog:
                    if all(not r.scheduler.has_work for r in self.replicas):
                        return True
        return False

    def weight_groups(self) -> List[List[Replica]]:
        """The replicas, in fleet order, grouped by the weight tensors
        their engines hold: replicas whose trees share any storage fall
        in one group, which a rollout drains and swaps as one."""
        groups: List[Tuple[set, List[Replica]]] = []
        for rep in self.replicas:
            ptrs = {x.untyped_storage().data_ptr()
                    for x in tree_leaves(rep.engine.params)} - {0}
            members = [rep]
            for g in [g for g in groups if g[0] & ptrs]:
                groups.remove(g)
                ptrs |= g[0]
                members = g[1] + members
            groups.append((ptrs, members))
        order = {r.name: i for i, r in enumerate(self.replicas)}
        return sorted((sorted(m, key=lambda r: order[r.name])
                       for _, m in groups), key=lambda m: order[m[0].name])

    def _swap_group(self, group: List[Replica], new_stacked_params,
                    timeout: float, keep_out: Sequence[Replica] = ()):
        """The rollout unit step for one group: drain all -> wait -> swap
        each engine (after the first, the copies write the same bits;
        each engine flushes its own trie and recomputes its own encoder
        frames) -> assert zero stale pages -> rejoin all but
        `keep_out`."""
        for rep in group:
            self.drain(rep.name)
        try:
            for rep in group:
                if not self.wait_drained(rep.name, timeout=timeout):
                    raise TimeoutError(
                        f"replica {rep.name} did not drain within "
                        f"{timeout}s ({rep.in_flight} in flight)")
            for rep in group:
                rep.engine.swap_params(new_stacked_params)
                ps = rep.engine.page_stats()
                if ps.get("cached_pages", 0) or ps.get("shared_pages", 0):
                    raise RuntimeError(
                        f"replica {rep.name}: {ps.get('cached_pages', 0)} "
                        f"cached / {ps.get('shared_pages', 0)} shared "
                        f"pages survived a drained rollout — stale "
                        f"round-t KV would serve round t+1")
        finally:
            for rep in group:
                if rep not in keep_out:
                    self.rejoin(rep.name)

    def rollout(self, new_stacked_params, timeout: float = 120.0,
                canary: float = 0.0, canary_requests: int = 8,
                canary_timeout: float = 120.0):
        """Zero-downtime model rollout: drain -> swap -> rejoin, one
        group of replicas over one set of weights at a time (one
        replica, where each holds its own), under live traffic.

        Every request is served end-to-end by exactly one model
        version (the drain barrier guarantees no slot is live at swap
        time) and none are dropped (the rest of the fleet — or the
        backlog, when one group is the whole fleet — absorbs
        arrivals).  The swap itself copies into the live tensors in
        place: the same storage, the same kernels, nothing rebuilt.

        canary > 0 (fleets of several groups): swap ONE group first and
        route that fraction of incoming traffic to its first replica
        (the group's others stay drained) until it has served
        `canary_requests` completions on the new round; only then does
        the group rejoin and the fleet-wide drain-swap proceed.  A
        canary whose loop fails aborts the rollout with the REST of the
        fleet still on the old round (the canary stays latched out of
        rotation, its group drained) — the blast radius of a bad round
        is the traffic fraction, not the fleet.  The canary window
        needs live traffic to observe; without any it times out
        (canary_timeout) and aborts the same way.  canary on a fleet of
        one group degrades to the plain rollout (there is no old-round
        fleet to protect).

        Prefix-cache replicas additionally flush their trie inside
        swap_params — cached pages hold the OLD model's KV — and
        because the replica is fully drained here, the flush must
        leave ZERO shared or cached pages behind; a survivor would be
        a stale round-t prefix able to serve a round-t+1 request, so
        it is asserted, not assumed.
        """
        groups = self.weight_groups()
        if canary > 0 and len(groups) > 1:
            first, rest = groups[0][0], groups[0][1:]
            self._swap_group(groups[0], new_stacked_params, timeout,
                             keep_out=rest)
            base = first.scheduler.n_completed
            with self._lock:
                self._canary = first.name
                self._canary_frac = float(min(canary, 1.0))
                self._canary_credit = 0.0
            try:
                deadline = time.time() + canary_timeout
                while first.scheduler.n_completed - base < canary_requests:
                    if first.failed is not None:
                        raise RuntimeError(
                            f"canary replica {first.name} failed on the "
                            f"new round ({first.failed}); rollout "
                            f"aborted with the rest of the fleet on the "
                            f"old round")
                    if time.time() > deadline:
                        raise TimeoutError(
                            f"canary window saw only "
                            f"{first.scheduler.n_completed - base}/"
                            f"{canary_requests} completions in "
                            f"{canary_timeout}s (a canary needs live "
                            f"traffic); rollout aborted")
                    time.sleep(0.005)
            finally:
                with self._lock:
                    self._canary = None
            for rep in rest:
                self.rejoin(rep.name)
            groups = groups[1:]
        for group in groups:
            self._swap_group(group, new_stacked_params, timeout)

    # -- telemetry ----------------------------------------------------------

    def trace(self, rid: int,
              replica: Optional[str] = None) -> Optional[Tuple[str, dict]]:
        """Look up one request's span chain (GET /v1/trace/<rid>).
        rids are per-replica, so pass `replica` to disambiguate (the
        completion payload carries both); without it the first replica
        holding the rid wins.  -> (replica name, trace dict) or None
        when unknown / already evicted / observability off."""
        reps = ([self._by_name[replica]]
                if replica is not None and replica in self._by_name
                else self.replicas)
        if replica is not None and replica not in self._by_name:
            return None
        for rep in reps:
            obs = rep.scheduler.obs
            if obs is None:
                continue
            tr = obs.traces.get(rid)
            if tr is not None:
                return rep.name, tr.to_dict()
        return None

    def profile(self, ticks: int, out_dir: Optional[str] = None) -> str:
        """Arm a torch.profiler window over the next `ticks` tick() calls
        of the FIRST routable replica (device traces are process-wide:
        arming several schedulers would start the profiler twice).
        -> the armed replica's name (POST /admin/profile)."""
        live = [r for r in self.replicas if r.routable] or self.replicas
        rep = live[0]
        rep.scheduler.profile_next_ticks(ticks, out_dir)
        return rep.name

    def stats(self) -> dict:
        reps = [r.stats() for r in self.replicas]
        return {
            "replicas": reps,
            "n_replicas": len(reps),
            "submitted": self.n_submitted,
            "completed": self.n_completed,
            "rejected": self.n_rejected,
            "shed": self.n_shed,
            "cancelled": (sum(r["cancelled"] for r in reps)
                          + self.n_cancelled_backlog),
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "canary": self._canary,
            "backlog": len(self._backlog),
            "live_slots": sum(r["live_slots"] for r in reps),
            "pending": sum(r["pending"] for r in reps),
            "streamed_tokens": sum(r["streamed_tokens"] for r in reps),
        }
