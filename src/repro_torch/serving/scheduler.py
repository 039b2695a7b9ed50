"""Continuous batching: a request queue over the engine's slot pool.

The port's Scheduler, the JAX package's policy line for line.  The
engine decodes a fixed batch of B slots every step; the scheduler keeps
those slots full.  Each `tick()` (1) admits queued requests into free
slots, (2) runs one engine decode step for the slots already past their
prompt, (3) prefills admitted prompts in chunks, one engine.prefill call
per selected slot, under a per-iteration prompt-token budget so one long
prompt cannot starve decode for in-flight slots, and (4) harvests slots
whose request hit EOS or its generation budget, freeing them for the
next admission.

Two loops share that iteration: `run()`, the batch API (tick until
the queue drains and every slot is idle -> {rid: Completion}), and
`serve_forever()`, a long-lived loop for a server: submit() is
thread-safe, each request may carry an `on_token` callback that streams
tokens out of the harvest, and an idle loop parks on an event.

Over a PAGED engine admission bounds by FREE PAGES rather than free
slots, strictly FIFO (a request that does not fit blocks the ones behind
it, so short requests cannot starve a long one), and when the free list
runs dry mid-decode the YOUNGEST in-flight request is preempted back to
the front of the queue (_ensure_decode_pages): the oldest never loses
its pages, completion order stays FIFO, and a preempted request
regenerates on re-admission (identical under greedy sampling; its
recurrent state, if any, restarts from zero with the slot's reset).  A
preempted streaming request does not re-emit: the per-request streamed
counter survives preemption.

`cancel(rid)` (thread-safe) drops a queued request, or releases a live
one's slot, pages and prefix-trie references at the next tick boundary
through the path preemption uses.

Device reads: a tick reads the device once, in `_harvest`, which stacks
done, n_gen and out (and the engine's harvest_extra, a speculative
engine's stats vector) into one tensor and copies it to the host in one
transfer.  Admission, page growth and preemption run on host mirrors,
so on the card the phases before harvest only enqueue work; a
speculative engine resyncs its host positions from that same read
(note_harvest).

Threading contract: ONE thread drives tick()/run()/serve_forever(); any
number of threads may call submit()/cancel()/stop().  Callbacks
(on_token/on_done) fire on the driving thread, so they must be quick.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.serving import obs as obs_mod
from repro_torch.serving.engine import EnsembleEngine

# on_token(rid, index, token_id) — fired per generated token, in order
TokenCallback = Callable[[int, int, int], None]
# on_done(completion) — fired once, after the last on_token
DoneCallback = Callable[["Completion"], None]


@dataclass
class Request:
    rid: int
    tokens: np.ndarray
    max_new: int
    submit_t: float
    on_token: Optional[TokenCallback] = field(default=None, repr=False)
    on_done: Optional[DoneCallback] = field(default=None, repr=False)
    # per-request sampling / speculation overrides; None = engine
    # default.  Validated at the submit() door against the named limits
    # in serving/sampling.py (and the model's vocab for top_k).
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None
    draft: Optional[bool] = None


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray          # generated ids (prompt not included)
    prompt_len: int
    submit_t: float
    admit_t: float
    first_token_t: Optional[float]
    finish_t: float
    # the request's span chain (obs.Trace.to_dict()) when the
    # scheduler's observability layer is on; None under obs=False
    trace: Optional[dict] = None

    @property
    def ttft(self) -> float:
        """Submit -> first generated token (queue wait + prefill)."""
        first = (self.first_token_t if self.first_token_t is not None
                 else self.finish_t)  # `or` would drop a valid 0.0 stamp
        return first - self.submit_t

    @property
    def latency(self) -> float:
        return self.finish_t - self.submit_t


@dataclass
class _SlotMeta:
    req: Request
    admit_t: float
    first_token_t: Optional[float] = None
    prefill_left: int = 0       # prompt tokens not yet prefilled
    prefill_chunks: int = 0     # chunk programs run (trace span index)
    n_seen: int = 0             # tokens observed by harvest so far
    last_token_m: Optional[float] = None  # monotonic last-token stamp


class Scheduler:
    """FIFO continuous-batching scheduler over one EnsembleEngine.

    submit() queues a request (validated against the engine's budgets
    at the door; thread-safe); one tick() runs a single
    admit -> decode -> prefill -> harvest iteration.  run() drives
    tick() until the queue drains, returning {rid: Completion} — the
    batch API.  serve_forever() drives tick() until stop(), idling on
    an event while no work is live — the online API a server mounts.
    Both work with any prefill_chunk, including the 0 reference
    baseline.

    prefill_budget caps how many prompt tokens may enter prefill
    programs per loop iteration (default: 2 chunks).  One chunk is
    always allowed, so a single over-budget prompt still progresses.

    retain_completions=False drops each Completion after its on_done
    fires instead of keeping it in .completions — REQUIRED for a
    long-lived serve_forever loop, where retaining every token array
    forever is an unbounded leak.  The batch run() contract (read
    results out of .completions) needs the default True.
    """

    def __init__(self, engine: EnsembleEngine,
                 prefill_budget: Optional[int] = None,
                 retain_completions: bool = True,
                 obs=True, trace_keep: int = 512,
                 trace_log: Optional[str] = None,
                 profile_dir: Optional[str] = None):
        self.engine = engine
        # observability is ON by default; obs=False is the kill-switch.
        # Pass a prebuilt ServingObs to share or customize one.
        if obs is True:
            self.obs: Optional[obs_mod.ServingObs] = obs_mod.ServingObs(
                trace_keep=trace_keep, trace_log=trace_log)
        elif obs:
            self.obs = obs
        else:
            self.obs = None
        self.profile_dir = profile_dir
        # a SpeculativeEngine's live host mirror of which slots draft:
        # harvest stamps spec_step(accepted) spans off it
        self._spec_draft = (getattr(engine, "_host_draft", None)
                            if hasattr(engine, "spec_stats") else None)
        self.prefill_budget = (2 * engine.prefill_chunk
                               if prefill_budget is None else prefill_budget)
        self.retain_completions = retain_completions
        self.pending: deque = deque()
        self.slots: list = [None] * engine.n_slots  # Optional[_SlotMeta]
        self.completions: Dict[int, Completion] = {}
        self.n_completed = 0  # lifetime count (survives non-retention)
        self._next_rid = 0
        self._to_release: list = []
        self.preemptions = 0     # paged: decode-time evictions to queue
        self.peak_in_flight = 0  # max concurrently admitted requests
        self.n_streamed = 0      # tokens delivered through on_token
        self.n_cancelled = 0     # requests cancelled before completion
        # per-rid stream high-water mark: survives preemption so a
        # re-generated (greedy-identical) prefix is never re-emitted
        self._streamed: Dict[int, int] = {}
        # rids cancel() has marked; the loop thread applies them at the
        # next tick boundary (queue removal or slot+page release)
        self._cancel_req: set = set()
        # submit() may be called from any thread while ONE loop thread
        # drives tick(); the lock guards rid allocation + enqueue, the
        # event wakes an idle serve_forever out of its park
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # set by serve_forever when it parks with nothing queued, live,
        # or pending release — the observable "quiesced" state
        # wait_quiesced blocks on (event-based drain/idle checks
        # instead of wall-clock sleeps)
        self._idle = threading.Event()

    # -- submission ---------------------------------------------------------

    def submit(self, tokens, max_new: int,
               on_token: Optional[TokenCallback] = None,
               on_done: Optional[DoneCallback] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               seed: Optional[int] = None,
               draft: Optional[bool] = None) -> int:
        """Queue a request; returns its id (keyed in .completions).

        Validates against the engine's budgets HERE so one oversized
        request is rejected at the door instead of crashing the loop
        and taking every in-flight request down with it.  Thread-safe:
        HTTP handler threads submit while serve_forever decodes.

        temperature/top_k/seed override the engine-wide sampling
        defaults for THIS request (None keeps the default; out-of-range
        values are rejected here against the named limits in
        serving/sampling.py).  draft turns speculative decoding off
        (False) or on for this request on a SpeculativeEngine (a plain
        engine ignores it); anything but None or a bool is rejected.

        on_token(rid, index, token_id) streams each generated token
        from the harvest that first observes it; on_done(completion)
        fires once after the last token.  Both run on the loop thread —
        keep them non-blocking.
        """
        t = self.engine.validate_request(tokens, max_new,
                                         temperature=temperature,
                                         top_k=top_k, seed=seed)
        if draft is not None and not isinstance(draft, (bool, np.bool_)):
            raise ValueError(f"draft must be a bool or None, got {draft!r}")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            if self.obs is not None:
                # start the trace BEFORE the request is visible to the
                # loop thread, so the admit path always finds it
                self.obs.traces.start(rid).add("enqueued")
            self.pending.append(Request(
                rid, t, int(max_new), time.time(),
                on_token=on_token, on_done=on_done,
                temperature=temperature, top_k=top_k, seed=seed,
                draft=draft))
        self._idle.clear()
        self._wake.set()
        return rid

    def cancel(self, rid: int) -> bool:
        """Abandon a request mid-flight (client disconnect, shed load).
        Thread-safe; the loop thread applies it at the next tick
        boundary: a queued request is removed before it can admit, a
        live one releases its slot, its pages, and any prefix-trie
        references mid-decode (or mid-prefill-chunk) through the same
        release path preemption uses — so cancellation composes with
        preemption and COW sharing.  No Completion is delivered and no
        callback fires.

        -> False when the rid is already finished (or unknown): the
        race where the last token beat the disconnect is benign — the
        completed slot was already harvested — so callers need not
        distinguish.  Cancelling an already-cancelled rid is a no-op.
        """
        with self._lock:
            found = any(r.rid == rid for r in self.pending) or any(
                m is not None and m.req.rid == rid for m in self.slots)
            if found:
                self._cancel_req.add(int(rid))
        self._wake.set()
        return found

    def _apply_cancels(self):
        """Loop-thread half of cancel(): drop marked rids from the
        queue, release marked live slots.  Runs at the top of tick()
        (a cancelled queued request must never admit) and again from
        the harvest path (a cancel that lands mid-tick frees its pages
        this iteration, not the next).  Unknown rids — completed or
        cancelled while the request raced to done — dissolve here."""
        with self._lock:
            if not self._cancel_req:
                return
            wanted, self._cancel_req = self._cancel_req, set()
        survivors = [r for r in self.pending if r.rid not in wanted]
        if len(survivors) != len(self.pending):
            self.n_cancelled += len(self.pending) - len(survivors)
            for r in self.pending:
                if r.rid in wanted:
                    self._trace_cancelled(r.rid)
            self.pending = deque(survivors)
        for b, meta in enumerate(self.slots):
            if meta is not None and meta.req.rid in wanted:
                self.slots[b] = None
                self._to_release.append(b)
                self._streamed.pop(meta.req.rid, None)
                self.n_cancelled += 1
                self._trace_cancelled(meta.req.rid)

    def _trace_cancelled(self, rid: int):
        if self.obs is None:
            return
        tr = self.obs.traces.live(rid)
        if tr is not None:
            tr.add("cancelled")
            self.obs.retire(tr)

    # -- scheduling loop ----------------------------------------------------

    def _fill_slots(self):
        admits = []
        now = time.time()
        chunked = self.engine.prefill_chunk > 0
        avail = 0
        if self.engine.paged:
            # pages the combined release+admit dispatch below can hand
            # out: free list + evictable prefix pages + what the slots
            # being released in the same call certainly return
            # (update_slots recycles before it admits)
            avail = self.engine.admission_headroom(self._to_release)
        for b in range(self.engine.n_slots):
            if self.slots[b] is None and self.pending:
                nxt = self.pending[0]
                if self.engine.paged:
                    # admit by free pages, not free slots — and strictly
                    # FIFO (no skip-ahead past a request that does not
                    # fit: that is how short requests would starve a
                    # long one forever).  admit_cost charges only the
                    # non-shared suffix when the prefix cache holds
                    # pages a live slot already references.
                    need = self.engine.admit_cost(nxt.tokens)
                    if need > avail:
                        break
                    avail -= need
                req = self.pending.popleft()
                # only explicitly-set options ride along, so an unset
                # draft flag takes the engine's default (plain: off,
                # speculative: on)
                opts = {k: v for k, v in (
                    ("temperature", req.temperature),
                    ("top_k", req.top_k), ("seed", req.seed),
                    ("draft", req.draft)) if v is not None}
                admits.append((b, req.tokens, req.max_new, opts))
                self.slots[b] = _SlotMeta(
                    req, now,
                    prefill_left=len(req.tokens) if chunked else 0)
                if self.obs is not None:
                    tr = self.obs.traces.live(req.rid)
                    if tr is not None:
                        if tr.has("preempted"):
                            tr.add("resumed")
                        else:
                            tr.add("admitted")
                            self.obs.queue_wait.observe(
                                obs_mod.MONO() - tr.t0)
        if admits or self._to_release:
            hits = self.engine.update_slots(
                release=self._to_release, admits=admits)
            self._to_release = []
            if chunked:
                # prefix-cache hits skip prefill for the shared prefix:
                # the slot starts its chunk walk at the hit boundary,
                # so it owes only the non-shared suffix
                for b, hit in hits.items():
                    if self.slots[b] is not None and hit > 0:
                        self.slots[b].prefill_left = max(
                            self.slots[b].prefill_left - int(hit), 1)
                        if self.obs is not None:
                            tr = self.obs.traces.live(
                                self.slots[b].req.rid)
                            if tr is not None:
                                tr.add("prefix_hit", int(hit))
        self.peak_in_flight = max(self.peak_in_flight, self.live_slots)

    def _ensure_decode_pages(self):
        """Grow decoding slots' page chains before the step; when the
        free list runs dry, PREEMPT the youngest in-flight request
        (highest rid) back to the front of the queue and retry.

        Preempting youngest-first keeps completion order FIFO and
        starvation-free: the oldest request never loses its pages to a
        newer one, so it always progresses (alone, it always fits —
        submit() rejects requests larger than the whole pool).  A
        preempted request restarts from scratch on re-admission; with
        greedy sampling its tokens are bit-identical, it just pays the
        queue again (counted in .preemptions and its ttft/latency).
        """
        if not self.engine.paged:
            return
        while True:
            starved = self.engine.reserve_decode_pages()
            if not starved:
                return
            live = [b for b, m in enumerate(self.slots) if m is not None]
            victim = max(live, key=lambda b: self.slots[b].req.rid)
            meta = self.slots[victim]
            self.engine.update_slots(release=[victim])
            self.slots[victim] = None
            # every queued rid is younger than every in-flight rid, so
            # appendleft re-sorts the queue into submission order
            self.pending.appendleft(meta.req)
            self.preemptions += 1
            if self.obs is not None:
                tr = self.obs.traces.live(meta.req.rid)
                if tr is not None:
                    tr.add("preempted")

    def _run_prefill(self) -> int:
        """Spend the iteration's prefill budget in admission (FIFO)
        order — one chunk program per selected slot.  -> programs run."""
        chunk = self.engine.prefill_chunk
        if chunk <= 0:
            return 0
        spent = ran = 0
        waiting = sorted(
            (b for b, m in enumerate(self.slots)
             if m is not None and m.prefill_left > 0),
            key=lambda b: self.slots[b].req.rid)
        for b in waiting:
            meta = self.slots[b]
            take = min(meta.prefill_left, chunk)
            if spent and spent + take > self.prefill_budget:
                break  # over budget; first selection always proceeds
            self.engine.prefill(b)
            spent += take
            ran += 1
            meta.prefill_left -= take
            if self.obs is not None:
                tr = self.obs.traces.live(meta.req.rid)
                if tr is not None:
                    tr.add("prefill_chunk", meta.prefill_chunks)
            meta.prefill_chunks += 1
        return ran

    def _decode_ready(self) -> bool:
        return any(m is not None and m.prefill_left == 0
                   for m in self.slots)

    def _stream(self, meta: _SlotMeta, n_gen: int, out_row: np.ndarray):
        """Emit tokens [high-water, n_gen) of one live slot through the
        request's on_token, in order.  The per-rid counter survives
        preemption, so a re-generated prefix is skipped, not re-sent."""
        req = meta.req
        seen = self._streamed.get(req.rid, 0)
        for i in range(seen, int(n_gen)):
            req.on_token(req.rid, i, int(out_row[i]))
        if n_gen > seen:
            self._streamed[req.rid] = int(n_gen)
            self.n_streamed += int(n_gen) - seen

    def _harvest(self):
        self._apply_cancels()  # free cancelled slots this iteration
        st = self.engine.state
        # ONE device transfer per iteration, the tick's only device read:
        # done, n_gen and every slot's outputs stacked into one tensor
        # first (the engine's extra vector appended), instead of a fetch
        # per field or per slot
        rows = torch.cat([st.done.long()[:, None], st.n_gen[:, None],
                          st.out], 1)
        flat = torch.cat([rows.reshape(-1),
                          self.engine.harvest_extra()]).cpu().numpy()
        host = flat[:rows.numel()].reshape(rows.shape)
        done, n_gen, out = host[:, 0] != 0, host[:, 1], host[:, 2:]
        self.engine.note_harvest(n_gen, flat[rows.numel():])
        now = time.time()
        obs = self.obs
        now_m = obs_mod.MONO() if obs is not None else 0.0
        for b, meta in enumerate(self.slots):
            if meta is None:
                continue
            first = meta.first_token_t is None and n_gen[b] > 0
            if first:
                meta.first_token_t = now
            if meta.req.on_token is not None and n_gen[b] > 0:
                self._stream(meta, n_gen[b], out[b])
            if obs is not None:
                n_new = int(n_gen[b]) - meta.n_seen
                if n_new > 0:
                    tr = obs.traces.live(meta.req.rid)
                    if first:
                        if tr is not None:
                            tr.add("first_token")
                            obs.ttft.observe(now_m - tr.t0)
                    elif (tr is not None and self._spec_draft is not None
                          and self._spec_draft[b]):
                        # one speculative iteration emitted n_new
                        # tokens: n_new-1 accepted drafts + the
                        # verifier's own token
                        tr.add("spec_step", n_new - 1)
                    if meta.last_token_m is not None:
                        dt = (now_m - meta.last_token_m) / n_new
                        for _ in range(n_new):
                            obs.inter_token.observe(dt)
                    meta.last_token_m = now_m
                    meta.n_seen = int(n_gen[b])
            if done[b]:
                req = meta.req
                comp = Completion(
                    rid=req.rid,
                    tokens=out[b, :n_gen[b]].astype(np.int32),
                    prompt_len=len(req.tokens),
                    submit_t=req.submit_t, admit_t=meta.admit_t,
                    first_token_t=meta.first_token_t, finish_t=now)
                if obs is not None:
                    tr = obs.traces.live(req.rid)
                    if tr is not None:
                        tr.add("done")
                        obs.latency.observe(now_m - tr.t0)
                        comp.trace = tr.to_dict()
                        obs.retire(tr)
                if self.retain_completions:
                    self.completions[req.rid] = comp
                self.n_completed += 1
                self.slots[b] = None
                self._to_release.append(b)
                self._streamed.pop(req.rid, None)
                if req.on_done is not None:
                    req.on_done(comp)

    # -- loops --------------------------------------------------------------

    @property
    def live_slots(self) -> int:
        """Slots currently holding an admitted request."""
        return sum(m is not None for m in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or self.live_slots > 0

    def _flush_release(self):
        """Return harvested slots' pages/slots without waiting for the
        next admission to batch the dispatch — an idle or draining
        server must not sit on freed capacity."""
        if self._to_release:
            t0 = obs_mod.MONO() if self.obs is not None else 0.0
            self.engine.update_slots(release=self._to_release)
            self._to_release = []
            if self.obs is not None:
                self.obs.ticks.add("release", obs_mod.MONO() - t0)

    def profile_next_ticks(self, ticks: int,
                           out_dir: Optional[str] = None):
        """Arm a torch.profiler window over the next `ticks` tick()
        calls.  out_dir defaults to the profile_dir the scheduler was
        built with."""
        if self.obs is None:
            raise RuntimeError("observability disabled (obs=False)")
        self.obs.ticks.arm_profile(ticks, out_dir or self.profile_dir)

    def tick(self) -> bool:
        """One admit -> decode -> prefill -> harvest iteration — the
        body run() always looped over, now reentrant so a long-lived
        server loop can interleave it with submits from other threads.
        Returns whether any engine program was dispatched (False means
        the caller may idle).

        With observability on, each phase's host time lands in
        obs.ticks (on the card: enqueue time, except harvest, which
        waits for the device); the obs=False path below is the untimed
        kill-switch.
        """
        if self.obs is None:
            self._apply_cancels()  # cancelled queued request never admits
            self._fill_slots()
            stepped = False
            if self._decode_ready():  # skip decode while all mid-prompt
                self._ensure_decode_pages()  # paged: grow or preempt
                if self._decode_ready():     # preemption may empty set
                    self.engine.step()
                    stepped = True
            prefilled = self._run_prefill()
            self._harvest()
            return stepped or prefilled > 0
        tp = self.obs.ticks
        tp.tick_begin()              # opens an armed profiler window
        t0 = obs_mod.MONO()
        self._apply_cancels()
        self._fill_slots()
        t1 = obs_mod.MONO()
        tp.add("admit", t1 - t0)
        stepped = False
        if self._decode_ready():
            self._ensure_decode_pages()
            if self._decode_ready():
                self.engine.step()
                stepped = True
            t2 = obs_mod.MONO()
            tp.add("decode", t2 - t1)
            t1 = t2
        prefilled = self._run_prefill()
        t2 = obs_mod.MONO()
        tp.add("prefill", t2 - t1)
        self._harvest()
        tp.add("harvest", obs_mod.MONO() - t2)
        tp.ticks += 1
        tp.tick_end()
        return stepped or prefilled > 0

    def run(self) -> Dict[int, Completion]:
        """Drive until the queue drains and every slot is idle — the
        batch API, a thin wrapper over tick().

        Within a tick, decode runs BEFORE prefill: the harvest stamp
        then directly follows any first token a prefill program just
        produced, so reported TTFT is not inflated by an unrelated
        decode step dispatched after it.
        """
        while self.has_work:
            self.tick()
        self._flush_release()
        return self.completions

    def serve_forever(self, idle_wait: float = 0.05):
        """Drive tick() until stop(): the online loop a server frontend
        runs on its own thread.  While no request is queued or live the
        loop flushes releases and parks on an event — submit() wakes it
        — so an idle server dispatches nothing and burns no CPU
        (idle_wait bounds the park so stop() is always honored).

        The stop latch is NOT cleared here: a stop() that races thread
        startup must win, not be erased by the loop's first line.  To
        restart a stopped scheduler, clear the latch first
        (`clear_stop`).
        """
        while not self._stop.is_set():
            if self.has_work:
                self._idle.clear()
                self.tick()
            else:
                self._flush_release()
                self._apply_cancels()  # queue-only cancels while parked
                if not self.has_work:  # a cancel can't create work, but
                    self._idle.set()   # a racing submit can
                self._wake.wait(idle_wait)
                self._wake.clear()
        self._flush_release()
        self._idle.set()

    def wait_quiesced(self, timeout: float = 120.0) -> bool:
        """Block until the serve_forever loop has parked with nothing
        queued, live, or awaiting release — i.e. every admitted page is
        back in the pool, not merely every request delivered.  Event-
        based: the loop signals its own park, so tests and drains wait
        on the actual state transition instead of sleeping fixed
        wall-clock intervals and hoping the loop got there.  Returns
        False on timeout (and when no loop is running to signal)."""
        deadline = time.time() + timeout
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                return False
            if not self._idle.wait(min(remaining, 0.05)):
                continue
            # the flag can be stale for one race window: a submit that
            # landed after the park clears it and re-wakes the loop
            if not self.has_work and not self._to_release:
                return True

    def stop(self):
        """Ask serve_forever to exit after its current iteration.
        In-flight slot state is left intact (drain first to finish it:
        wait for has_work to clear while the loop still runs).  The
        latch persists: a serve_forever entered AFTER stop() exits
        immediately, so stopping can never lose the race with a
        starting loop thread."""
        self._stop.set()
        self._wake.set()

    def clear_stop(self):
        """Re-arm a stopped scheduler so serve_forever runs again.
        Call strictly BEFORE spawning the new loop thread."""
        self._stop.clear()
