"""EC-DNN_G ensemble serving engine: one device, or a member mesh.

All K members score every decode step together: the params and the
cache pool carry a leading member axis and every layer runs the members
as one batched op.  The members' distributions fuse on the device
(core.ensemble.ensemble_log_probs, Eqn 6 in log space) under a (K,)
quorum vector, so dropping a member changes a weight, not the program.
Each batch row is an independent slot at its own position; prompts go
through chunked prefill (one slot per call, the chunk written straight
into that slot's rows of the pool) and the first generated token comes
out of prefill itself.  prefill_chunk=0 keeps the per-token
teacher-forcing path as the reference.

paged=True swaps the full-attention layers' per-slot rows for a shared
pool of fixed-size pages behind a per-slot page table (host policy,
kv_cache.PageAllocator); decode reads those pages through the
hand-written CUDA paged-attention kernel on the card.  kv_dtype stores
the pages as "bf16", or quantized as "int8" / "fp8" with per-token
scales the kernel applies as it reads (paged pools only; "f32" keeps
the model's dtype).  prefix_cache=True
(paged engines whose every layer pages) adds the shared-prefix trie of
serving/prefix.py: an admission attaches the cached pages of its
prompt's longest cached prefix, copies a partially matched page on
write (kv_cache.copy_pages, dispatched before any kernel can write it),
and starts its prefill at the hit.  serving/scheduler.py drives the
engine through update_slots / prefill / step and the page accounting
below.

An encoder-decoder (whisper) serves from the contiguous pool only, as
in the JAX package: each member's encoder runs once per params install
over stub frame embeddings, and every prefill and decode cross-attends
the frames it left in the pool.

Over a member mesh (mesh=common.sharding.local_mesh(M, D): one process
a rank, torch.distributed between them) a rank holds the members of its
"member" coordinate, the JAX stack's rows [r K/M, (r+1) K/M), their
params and their cache pool; the "data" dim replicates.  Members never
communicate in the forward pass: the only cross-rank traffic a step is
the Eqn-6 fusion's (core.ensemble.ensemble_log_probs_psum: an all-reduce
of the weight mass, one MAX and one SUM of fused (B, V) partials).  The
all-reduces hand every rank the same sums, so every rank computes the
same fused log-probs, bit for bit, and samples the same tokens; the slot
state is replicated.

The host API is the single-device engine's, and it is the mesh's first
rank's (the leader's): a Scheduler, the HTTP frontend or the CLI drives
that rank's engine as it would drive any other.  The other ranks call
follow(), which replays the leader's calls in its order and with its
arguments until the leader calls close(): every method that touches
device state (update_slots, prefill, step, reserve_decode_pages,
note_harvest, swap_params' install, set_quorum, score) first broadcasts
its name and arguments over the mesh's gloo control group, and after it
has run, how it ended (returned, or the exception it raised).  A
follower that ends a call otherwise than the leader did raises out of
follow(): the ranks' states have come apart, and the world stops rather
than fuse from them.  The leader takes a lock around broadcast, run and
outcome, so that calls made from two threads (a Scheduler's loop and a
rollout's swap_params) reach the followers whole and in one order; the
nesting that keeps an inner replayed call from being broadcast again is
counted per thread.  Replay, not a scheduler on every rank: the
Scheduler reads the wall clock, so ranks scheduling on their own could
admit differently and then wait forever in a collective.  swap_params
takes the global stack on the leader and sends each rank its rows;
set_quorum takes the global (K,) mask.

The pool and the slot state are updated in place where the JAX package
donates buffers to its jitted programs.  The greedy decode loop never
waits for the device: sampling, output bookkeeping and the EOS/length
flags stay on the device, and the host mirrors what it needs for page
growth.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.common import sharding as shd
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.types import ModelConfig
from repro_torch.core import ensemble as ens
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.serving import kv_cache, sampling
from repro_torch.serving import prefix as prefix_mod


class SlotState(NamedTuple):
    """Device-resident per-slot serving state (one row per batch slot)."""

    tok: torch.Tensor         # (B,)   next input token
    pos: torch.Tensor         # (B,)   tokens consumed so far (== cache idx)
    prompt: torch.Tensor      # (B,P)  padded prompt buffer
    prompt_len: torch.Tensor  # (B,)
    max_new: torch.Tensor     # (B,)   per-request generation budget
    n_gen: torch.Tensor       # (B,)   tokens emitted so far
    active: torch.Tensor      # (B,)   slot occupied by a request
    done: torch.Tensor        # (B,)   finished, awaiting host harvest
    out: torch.Tensor         # (B,G)  emitted tokens


def _flatten(tree, path=()):
    """(path, leaf) pairs of a nested dict/list tree, dict keys sorted
    (the JAX package's flatten order)."""
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _flatten(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def _rows_to(tree, rows: slice, device):
    """Copies of rows `rows` of every (K, ...) leaf, on `device` (copies,
    so that the global stack can be freed)."""
    if isinstance(tree, dict):
        return {k: _rows_to(v, rows, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rows_to(v, rows, device) for v in tree)
    return tree[rows].to(device, copy=True)


def _host_arg(x):
    """A call's argument as it crosses to the follower ranks: tensors go
    as host copies."""
    return x.cpu() if torch.is_tensor(x) else x


def replayed(fn):
    """Mark an engine method that touches device state.  On a mesh the
    leader runs it under the engine's replay lock: it broadcasts the
    call (name and arguments), runs it, then broadcasts how the run
    ended (None, or the exception's repr), and the followers (follow())
    replay it and compare.  A call made from inside another replayed
    call on the same thread is not broadcast: the outer one replays
    it."""
    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        depth = getattr(self._nest, "depth", 0)
        lead = self.mesh is not None and self._leader and not depth
        if not lead:
            self._nest.depth = depth + 1
            try:
                return fn(self, *args, **kwargs)
            finally:
                self._nest.depth = depth
        with self._replay_lock:
            shd.broadcast_object(
                (fn.__name__, [_host_arg(a) for a in args],
                 {k: _host_arg(v) for k, v in kwargs.items()}), self.mesh)
            self._nest.depth = 1
            try:
                out = fn(self, *args, **kwargs)
            except BaseException as e:
                shd.broadcast_object(repr(e), self.mesh)
                raise
            finally:
                self._nest.depth = 0
            shd.broadcast_object(None, self.mesh)
            return out
    return call


class EnsembleEngine:
    """Member-batched decode engine over a fixed pool of batch slots.

    stacked_params: member params with a leading (K,) axis (the layout
    transformer.init(members=K) and bridge.params_from_numpy produce).
    K = 1 serves a single model through the identical path.  The engine
    runs on `device` (the card unless given); params are moved there.

    mesh: a ("member", "data") DeviceMesh (common.sharding.local_mesh).
    stacked_params is still the global (K,) stack, on any device; the
    engine copies this rank's rows to `device` (M must divide K).  The
    leader rank's engine is driven as usual and the others follow()
    (see the module docstring).  n_members stays the global K;
    n_local is this rank's share.
    """

    def __init__(self, cfg: ModelConfig, stacked_params, *,
                 n_slots: int = 8, max_prompt: int = 64, max_out: int = 64,
                 prefill_chunk: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, eos_id: int = -1,
                 quorum: Optional[Sequence[float]] = None, seed: int = 0,
                 mesh=None, paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, prefix_cache: bool = False,
                 kv_dtype: str = "f32", device: DeviceLike = None):
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a DeviceMesh "
                            f"(common.sharding.local_mesh), got "
                            f"{type(mesh).__name__}")
        if kv_dtype not in attn.KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {attn.KV_DTYPES}, "
                             f"got {kv_dtype!r}")
        if kv_dtype != "f32" and not paged:
            raise ValueError(
                "kv_dtype != f32 requires paged=True (only paged planes "
                "are stored quantized; the contiguous pool is the "
                "bit-exact reference)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self._nest = threading.local()   # .depth: nesting of replayed calls
        self._replay_lock = threading.Lock()  # one replayed call at a time
        self._closed = False
        self.replay_errors: list = []  # calls that raised on every rank
        # swap_params holds incoming trees to this structure (global K)
        self._param_spec = [(path, tuple(x.shape), x.dtype)
                            for path, x in _flatten(stacked_params)]
        self.n_members = stacked_params["embed"].shape[0]
        if mesh is None:
            self._leader = True
            self.member_shards = 1
            self._rows = slice(0, self.n_members)
            self.params = _to(stacked_params, self.device)
        else:
            self._leader = shd.is_leader(mesh)
            self.member_shards = shd.axis_size(mesh, shd.MEMBER_AXIS)
            self._rows = shd.member_rows(self.n_members, mesh)
            self.params = _rows_to(stacked_params, self._rows, self.device)
        self.n_local = self._rows.stop - self._rows.start
        self.kv_dtype = kv_dtype
        self.n_slots = n_slots
        self.max_prompt = max_prompt
        self.max_out = max_out
        self.max_seq = max_prompt + max_out
        # None picks a quarter of max_prompt (floor 32), rounded up to a
        # whole page on paged engines, as the JAX engine does
        if prefill_chunk is None:
            prefill_chunk = max(32, -(-max_prompt // 4))
            if paged and page_size > 0:
                prefill_chunk = -(-prefill_chunk // int(page_size)) \
                    * int(page_size)
        self.prefill_chunk = min(max(prefill_chunk, 0), max_prompt)
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        q = (torch.ones(self.n_members) if quorum is None
             else torch.as_tensor(quorum, dtype=torch.float32))
        self.quorum = q[self._rows].to(self.device)  # this rank's slice
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.prefix: Optional[prefix_mod.PrefixCache] = None
        if self.paged:
            if cfg.enc_dec:
                raise ValueError(
                    "paged serving does not support enc-dec archs (the "
                    "stub encoder context is slot-contiguous)")
            if self.page_size <= 0:
                raise ValueError(f"page_size must be > 0, got {page_size}")
            self.pages_per_slot = -(-self.max_seq // self.page_size)
            self.n_pages = (n_slots * self.pages_per_slot
                            if n_pages is None else int(n_pages))
            self.allocator = kv_cache.PageAllocator(
                self.n_pages, self.page_size, n_slots, self.pages_per_slot)
            # host mirror of each slot's request shape: pages grow BEFORE
            # a step is dispatched, with no device sync
            self._host_pos = np.zeros(n_slots, np.int64)
            self._host_plen = np.zeros(n_slots, np.int64)
            self._host_new = np.zeros(n_slots, np.int64)
            self._host_active = np.zeros(n_slots, bool)
            self._table_stale = True
            if prefix_cache:
                bad = self._prefix_ineligible()
                if bad:
                    raise ValueError(
                        f"prefix_cache needs every layer's positional "
                        f"state in shared pages, but {bad} keeps per-slot"
                        f" state a hit could not skip rebuilding")
                if self.prefill_chunk <= 0:
                    raise ValueError(
                        "prefix_cache needs chunked prefill "
                        "(prefill_chunk > 0): admission starts the "
                        "chunk walk at the hit boundary")
                # each slot's prompt on the host: the trie is keyed on
                # token ids and takes a chain's prefix at release
                self._host_prompt = np.zeros((n_slots, max_prompt),
                                             np.int32)
                self.prefix = prefix_mod.PrefixCache(self.page_size)
                self.allocator.cache = self.prefix
        elif prefix_cache:
            raise ValueError("prefix_cache requires paged=True (the "
                             "contiguous pool has no shareable pages)")
        self.cache = kv_cache.init_pool(
            cfg, self.n_members, n_slots, self.max_seq,
            page_size=self.page_size if self.paged else 0,
            n_pages=self.n_pages if self.paged else 0, device=self.device,
            kv_dtype=kv_dtype, mesh=mesh)
        if cfg.enc_dec:
            self.cache["enc"] = self._encode_stub(n_slots)
        self.state = self._blank_state()
        # per-slot sampling params, mirrored on the host: greedy rows
        # never make the step wait for the device
        self._host_temp = np.zeros(n_slots, np.float32)
        self._host_topk = np.zeros(n_slots, np.int64)
        self._host_seed = np.zeros(n_slots, np.int64)
        self._seed = int(seed)
        self._admitted = 0
        self.steps_run = 0
        self.prefills_run = 0
        self.swaps_done = 0

    def _blank_state(self) -> SlotState:
        B, P, G = self.n_slots, self.max_prompt, self.max_out
        zi = lambda *s: torch.zeros(s, dtype=torch.long, device=self.device)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=self.device)
        return SlotState(tok=zi(B), pos=zi(B), prompt=zi(B, P),
                         prompt_len=zi(B), max_new=zi(B), n_gen=zi(B),
                         active=zb(B), done=zb(B), out=zi(B, G))

    # -- device work ---------------------------------------------------------

    def _encode_stub(self, batch: int) -> torch.Tensor:
        """Every member's encoder over zero frame embeddings (batch,
        enc_max_frames, d_model), the stub of the audio frontend, as the
        JAX engine's: -> (K, batch, S, d).  Computed once per params
        install; decode and prefill only read it."""
        enc_in = torch.zeros(batch, self.cfg.enc_max_frames,
                             self.cfg.d_model,
                             dtype=self.params["embed"].dtype,
                             device=self.device)
        with torch.no_grad():
            return tf.encode(self.params, self.cfg, enc_in)

    def _member_logits(self, tok: torch.Tensor):
        """All K members score the step in one pass -> ((K, B, V), cache)."""
        step = tf.decode_step_paged if self.paged else tf.decode_step_slots
        logits, cache = step(self.params, self.cfg, self.cache, tok[:, None])
        return logits[:, :, 0], cache

    def _fuse(self, member_logits: torch.Tensor,
              member_lp: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Eqn 6 in log space under the quorum: over this rank's members
        and then, on a mesh, across ranks (all-reduces over "member")."""
        if self.mesh is None:
            return ens.ensemble_log_probs(member_logits, weights=self.quorum,
                                          member_lp=member_lp)
        return ens.ensemble_log_probs_psum(member_logits, self.quorum,
                                           self.mesh, shd.MEMBER_AXIS,
                                           member_lp=member_lp)

    def _quorum_normalized(self) -> torch.Tensor:
        """This rank's slice of the quorum normalized over all K."""
        total = self.quorum.sum()
        if self.mesh is not None:
            total = shd.psum(total, self.mesh, shd.MEMBER_AXIS)
        return self.quorum / total.clamp_min(1e-9)

    def _sample(self, logp: torch.Tensor, rows) -> torch.Tensor:
        return sampling.sample_slots(
            logp, self._host_temp[rows], self._host_topk[rows],
            self._host_seed[rows], self.state.n_gen[rows])

    # -- host API ------------------------------------------------------------

    def validate_request(self, tokens, max_new: int,
                         temperature: Optional[float] = None,
                         top_k: Optional[int] = None,
                         seed: Optional[int] = None) -> np.ndarray:
        """Check a request against the engine's budgets; -> 1-D int32
        prompt.  Out-of-range sampling params raise against the NAMED
        limits in serving/sampling.py and the model's vocab_size."""
        t = np.asarray(tokens, np.int32).reshape(-1)
        if not 0 < t.size <= self.max_prompt:
            raise ValueError(f"prompt len {t.size} not in "
                             f"[1, {self.max_prompt}]")
        if not 0 < max_new <= self.max_out:
            raise ValueError(f"max_new {max_new} not in "
                             f"[1, {self.max_out}]")
        if temperature is not None and not (
                sampling.MIN_TEMPERATURE <= float(temperature)
                <= sampling.MAX_TEMPERATURE):
            raise ValueError(
                f"temperature {temperature} not in [MIN_TEMPERATURE="
                f"{sampling.MIN_TEMPERATURE}, MAX_TEMPERATURE="
                f"{sampling.MAX_TEMPERATURE}]")
        if top_k is not None and not (
                0 <= int(top_k) <= self.cfg.vocab_size):
            raise ValueError(
                f"top_k {top_k} not in [0, vocab_size="
                f"{self.cfg.vocab_size}]")
        if seed is not None and not (
                sampling.MIN_SEED <= int(seed) <= sampling.MAX_SEED):
            raise ValueError(
                f"seed {seed} not in [MIN_SEED={sampling.MIN_SEED}, "
                f"MAX_SEED={sampling.MAX_SEED}]")
        if self.paged:
            need = self.allocator.pages_for(t.size + max_new)
            if need > self.n_pages:
                raise ValueError(
                    f"request needs {need} pages ({t.size}+{max_new} "
                    f"tokens at page_size={self.page_size}) but the pool "
                    f"holds {self.n_pages}")
        return t

    # -- paged-pool host accounting ------------------------------------------

    def _prefix_ineligible(self) -> Optional[str]:
        """Why this config cannot reuse cached prefix pages (None = it
        can).  A hit skips prefill for positions [0, hit), so every
        layer's positional state for them must live in the shared pages:
        ring-cached local layers below max_seq, recurrent mixers and
        rwkv_cmix's per-slot shift would come up blank."""
        for _, specs in self.cfg.segments():
            for spec in specs:
                if not tf.layer_pages(self.cfg, spec, self.max_seq):
                    return (f"mixer {spec.mixer!r} keeps per-slot "
                            f"(non-paged) cache planes")
                if spec.ffn == "rwkv_cmix":
                    return "ffn 'rwkv_cmix' carries per-slot cmix_shift"
        return None

    def _sync_table(self):
        """Push the allocator's page table to the pool (every member
        carries a replica)."""
        tbl = torch.as_tensor(self.allocator.table(), device=self.device)
        self.cache["page_table"] = tbl.expand(
            self.n_local, *tbl.shape).contiguous()
        self._table_stale = False

    def _host_decoding(self) -> np.ndarray:
        """(B,) host's view of slots whose NEXT step writes the cache at
        _host_pos (EOS-early finishes are invisible here; they over-hold
        <= one page until release)."""
        live = self._host_active & (
            self._host_pos < self._host_plen + self._host_new)
        if self.prefill_chunk > 0:
            live &= self._host_pos >= self._host_plen  # prefill owns prompt
        return live

    def _lookahead(self, b: int) -> int:
        """Positions slot b's next step may write, from its own (a plain
        step: one)."""
        return 1

    @replayed
    def reserve_decode_pages(self) -> list:
        """Grow each decoding slot's chain to cover this step's write
        positions; -> slots the free list left starved.  [] when not
        paged."""
        if not self.paged:
            return []
        starved = []
        for b in np.nonzero(self._host_decoding())[0]:
            last = int(self._host_pos[b]) + self._lookahead(b) - 1
            if self.allocator.holds(b, last):
                continue
            if self.allocator.alloc(b, last // self.page_size + 1):
                self._table_stale = True
            else:
                starved.append(int(b))
        if self._table_stale:
            self._sync_table()
        return starved

    def _release_slot(self, b: int):
        """Recycle slot b's chain and host mirrors.  With the prefix
        cache on, the chain's valid prompt prefix (min(pos, plen)
        tokens: a preempted slot has written only that far, and decode
        tokens are the request's own) goes to the trie first: claimed
        pages stay cached, evictable once unreferenced; the rest returns
        to the free list."""
        if self.prefix is not None and self._host_plen[b] > 0:
            valid = int(min(self._host_pos[b], self._host_plen[b]))
            n = self.allocator.pages_for(valid)
            chain = self.allocator.chain(b)
            if valid > 0 and len(chain) >= n:
                self.prefix.insert(self._host_prompt[b, :valid],
                                   chain[:n])
            self._host_prompt[b, :] = 0
        self.allocator.release(b)
        self._host_active[b] = False
        self._host_pos[b] = 0
        self._host_plen[b] = self._host_new[b] = 0

    def admit_cost(self, tokens) -> int:
        """Pages admitting this prompt would take now: ceil(plen/page)
        less the matched full pages some live slot already references
        (attaching them is a refcount bump).  Ref-0 trie pages are not
        discounted (available_pages counts them once already), nor is a
        partial tail (its copy takes a fresh page).  Probes with the
        trie's side-effect-free peek."""
        t = np.asarray(tokens, np.int32).reshape(-1)
        cost = self.allocator.pages_for(t.size)
        if self.prefix is None or t.size <= 1:
            return cost
        _, full, _ = self.prefix.peek(t.tolist(), t.size - 1)
        return cost - sum(1 for p in full if self.allocator.ref(p) > 0)

    def admission_headroom(self, releasing: Sequence[int] = ()) -> int:
        """Pages an admission batch can draw on: free plus evictable
        trie pages, plus what releasing `releasing` certainly returns
        (their refcount-1 pages the trie does not keep).  -1 when not
        paged."""
        if not self.paged:
            return -1
        return self.allocator.available_pages + sum(
            self.allocator.reclaimable_pages(int(b)) for b in releasing)

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages if self.paged else -1

    def assert_pool_whole(self) -> None:
        """Drained-state check: no slot holds pages, the allocator's
        accounting holds (check_invariants) and every page is free or
        trie-evictable.  Raises AssertionError naming the leak; no-op
        on contiguous engines."""
        if not self.paged:
            return
        a = self.allocator
        held = {b: a.held_pages(b) for b in range(self.n_slots)
                if a.held_pages(b)}
        assert not held, f"drained engine still holds pages: {held}"
        a.check_invariants()
        assert a.available_pages == a.n_pages, \
            (f"{a.n_pages - a.available_pages} pages neither free nor "
             f"evictable after drain ({a.free_pages} free, "
             f"{a.available_pages} available of {a.n_pages})")

    def page_stats(self) -> dict:
        """Page-pool occupancy and prefix-cache telemetry; {} when not
        paged."""
        if not self.paged:
            return {}
        a = self.allocator
        pb = kv_cache.page_bytes(self.cache, a.n_pages)
        stats = {"n_pages": a.n_pages, "page_size": a.page_size,
                 "free_pages": a.free_pages, "used_pages": a.used_pages,
                 "available_pages": a.available_pages,
                 "shared_pages": a.shared_pages,
                 "pages_per_slot": a.pages_per_slot,
                 "low_water_pages": a.low_water,
                 "kv_dtype": self.kv_dtype,
                 "kv_quantized": int(self.kv_dtype in ("int8", "fp8")),
                 "page_bytes": pb,
                 "bytes_per_token": pb // max(a.page_size, 1)}
        if self.prefix is not None:
            stats.update(self.prefix.stats())
            stats["cow_pages"] = a.cow_count
            stats["shared_attaches"] = a.shared_attach_count
        return stats

    @replayed
    def step(self) -> SlotState:
        """Advance every slot one token: all K members score the step,
        fuse, sample, and the slot state advances in place.  Rows that
        do not advance keep their position and recurrent state
        (kv_cache.snapshot / keep_frozen)."""
        if self.paged:
            starved = self.reserve_decode_pages()
            if starved:
                raise RuntimeError(
                    f"paged pool out of pages for decoding slots "
                    f"{starved} ({self.allocator.free_pages} free of "
                    f"{self.n_pages}); release finished slots before "
                    f"stepping")
        st = self.state
        B = self.n_slots
        # only live slots advance; mid-prompt slots hold still while the
        # prefill path owns the prompt
        adv = st.active & ~st.done
        if self.prefill_chunk > 0:
            adv &= st.pos >= st.prompt_len
        old = kv_cache.snapshot(self.cache)
        logits, cache = self._member_logits(st.tok)
        self.cache = kv_cache.keep_frozen(cache, old, adv)
        sampled = self._sample(self._fuse(logits), slice(None))
        pos1 = st.pos + adv.long()
        in_prompt = pos1 < st.prompt_len  # next input is teacher-forced
        P = st.prompt.shape[1]
        nxt_prompt = st.prompt.gather(1, pos1.clamp(max=P - 1)[:, None])[:, 0]
        emit = adv & ~in_prompt
        rows = torch.arange(B, device=self.device)
        col = st.n_gen.clamp(max=st.out.shape[1] - 1)
        st.out[rows, col] = torch.where(emit, sampled, st.out[rows, col])
        n_gen = st.n_gen + emit.long()
        finished = emit & (n_gen >= st.max_new)
        if self.eos_id >= 0:
            finished |= emit & (sampled == self.eos_id)
        tok = torch.where(adv, torch.where(in_prompt, nxt_prompt, sampled),
                          st.tok)
        self.state = st._replace(tok=tok, pos=pos1, n_gen=n_gen,
                                 done=st.done | finished)
        self.steps_run += 1
        if self.paged:
            self._host_pos[self._host_decoding()] += 1
        return self.state

    @replayed
    def prefill(self, slot: int) -> SlotState:
        """Advance one mid-prompt slot by up to prefill_chunk prompt
        tokens; a slot whose prompt completes emits its first generated
        token from the chunk's last-token logits.  Only this slot's rows
        of the pool are touched."""
        if self.prefill_chunk <= 0:
            raise ValueError("engine built with prefill_chunk=0 "
                             "(per-token reference path)")
        b = int(slot)
        if not 0 <= b < self.n_slots:
            raise ValueError(f"slot {slot} out of range "
                             f"[0, {self.n_slots})")
        if self.paged and self._table_stale:
            self._sync_table()
        st = self.state
        C = self.prefill_chunk
        pos, plen = st.pos[b].clone(), st.prompt_len[b].clone()
        need = st.active[b] & ~st.done[b] & (pos < plen)
        n_tok = torch.where(need, torch.clamp(plen - pos, max=C), 0)
        P = st.prompt.shape[1]
        cols = (pos + torch.arange(C, device=self.device)).clamp(0, P - 1)
        chunk = st.prompt[b][cols][None]                       # (1, C)
        row = kv_cache.slot_row(self.cache, b)
        step = tf.prefill_step_paged if self.paged else tf.prefill_slots
        logits, row = step(self.params, self.cfg, row, chunk,
                           n_tok[None].int())                  # (K, 1, V)
        kv_cache.write_slot_row(self.cache, row, b)
        sampled = self._sample(self._fuse(logits), slice(b, b + 1))[0]
        pos1 = pos + n_tok
        completed = need & (pos1 >= plen)
        n_old = st.n_gen[b].clone()
        col = n_old.clamp(max=st.out.shape[1] - 1)
        st.out[b, col] = torch.where(completed, sampled, st.out[b, col])
        st.n_gen[b] = n_old + completed.long()
        finished = completed & (n_old + 1 >= st.max_new[b])
        if self.eos_id >= 0:
            finished |= completed & (sampled == self.eos_id)
        st.done[b] = st.done[b] | finished
        st.tok[b] = torch.where(completed, sampled, st.tok[b])
        st.pos[b] = pos1
        self.prefills_run += 1
        if self.paged:
            left = self._host_plen[b] - self._host_pos[b]
            if self._host_active[b] and left > 0:
                self._host_pos[b] += min(C, int(left))
        return self.state

    @replayed
    def update_slots(self, release: Sequence[int] = (),
                     admits: Sequence[tuple] = ()) -> dict:
        """Evict slots and admit new requests.

        admits: (slot, prompt_tokens, max_new) triples, or 4-tuples whose
        last element is an options dict with any of {"temperature",
        "top_k", "seed"} (None/missing = engine default).  A request with
        no seed gets one derived from the engine seed and its admission
        order.

        Returns {slot: hit_tokens} for admissions the prefix cache
        served: such a slot starts at position `hit` (its first input is
        prompt[hit]) and owes ceil((plen - hit) / prefill_chunk) prefill
        calls.  Empty whenever the prefix cache is off, and every slot
        then starts at 0 as before."""
        B, P = self.n_slots, self.max_prompt

        def check_slot(b) -> int:
            b = int(b)
            if not 0 <= b < B:
                raise ValueError(f"slot {b} out of range [0, {B})")
            return b

        rel = np.zeros((B,), bool)
        adm = np.zeros((B,), bool)
        prompt = np.zeros((B, P), np.int64)
        plen = np.zeros((B,), np.int64)
        mnew = np.zeros((B,), np.int64)
        temp = self._host_temp.copy()
        topk = self._host_topk.copy()
        seeds = self._host_seed.copy()
        for b in release:
            rel[check_slot(b)] = True
        for entry in admits:
            b, toks, max_new = entry[0], entry[1], entry[2]
            opts = dict(entry[3]) if len(entry) > 3 and entry[3] else {}
            b = check_slot(b)
            t = self.validate_request(
                toks, max_new, temperature=opts.get("temperature"),
                top_k=opts.get("top_k"), seed=opts.get("seed"))
            adm[b] = True
            prompt[b, :t.size] = t
            plen[b] = t.size
            mnew[b] = max_new
            temp[b] = (self.temperature if opts.get("temperature") is None
                       else float(opts["temperature"]))
            topk[b] = (self.top_k if opts.get("top_k") is None
                       else int(opts["top_k"]))
            seeds[b] = (int(opts["seed"]) if opts.get("seed") is not None
                        else (self._seed * 1_000_003 + self._admitted)
                        % (sampling.MAX_SEED + 1))
            self._admitted += 1
        hits: dict = {}
        pos0 = np.zeros((B,), np.int64)
        if self.paged:
            # all-or-nothing page accounting BEFORE any state mutates.
            # Two tiers: the worst case first; if that fails with the
            # prefix cache on, admit_cost (full pages a live slot already
            # references attach for free), the Scheduler's own charge
            recycled = [b for b in range(B) if rel[b] or adm[b]]
            avail = self.allocator.available_pages + sum(
                self.allocator.reclaimable_pages(b) for b in recycled)
            need = sum(self.allocator.pages_for(int(plen[b]))
                       for b in range(B) if adm[b])
            if need > avail and self.prefix is not None:
                need = sum(self.admit_cost(prompt[b, :plen[b]])
                           for b in range(B) if adm[b])
            if need > avail:
                raise RuntimeError(
                    f"admission needs {need} pages, only {avail} "
                    f"available (pool {self.n_pages}); queue instead")
            for b in recycled:
                self._release_slot(b)
            cow_src = np.full((B,), self.n_pages, np.int64)
            cow_dst = np.full((B,), self.n_pages, np.int64)
            for b in np.nonzero(adm)[0]:
                p = int(plen[b])
                if self.prefix is not None:
                    toks = prompt[b, :p]
                    # at most plen - 1: the first sampled token needs the
                    # last prompt token's logits, so one position prefills
                    hit, full, tail = self.prefix.match(toks, p - 1)
                    if full or tail:
                        self.allocator.share(
                            b, full + ([tail[0]] if tail else []))
                    if tail is not None:
                        # the hit ends mid-page: the slot's first write
                        # lands inside the matched page, so it gets a
                        # private copy before any kernel writes it
                        cow_src[b], cow_dst[b] = self.allocator.cow(
                            b, len(full))
                    pos0[b] = hits[int(b)] = hit
                    self._host_prompt[b, :p] = toks
                if not self.allocator.alloc(b, self.allocator.pages_for(p)):
                    raise RuntimeError("page accounting violated its "
                                       "feasibility check")  # unreachable
                self._host_active[b] = True
                self._host_pos[b] = pos0[b]
                self._host_plen[b] = p
                self._host_new[b] = mnew[b]
            self._sync_table()
            # the page copy goes before the slot reset and before any
            # prefill: on one stream, enqueue order puts the read of src
            # ahead of every later write, even when src is evicted and
            # handed to another admission of this same batch
            kv_cache.copy_pages(self.cache, cow_src, cow_dst, self.n_pages)
        self._host_temp, self._host_topk, self._host_seed = temp, topk, seeds
        dev = self.device
        rel_t = torch.as_tensor(rel, device=dev)
        adm_t = torch.as_tensor(adm, device=dev)
        prompt_t = torch.as_tensor(prompt, device=dev)
        pos0_t = torch.as_tensor(pos0, device=dev)
        kv_cache.reset_slots(self.cache, adm_t, pos0_t)
        st = self.state
        a2 = adm_t[:, None]
        tok0 = prompt_t.gather(1, pos0_t[:, None])[:, 0]
        self.state = SlotState(
            tok=torch.where(adm_t, tok0, st.tok),
            pos=torch.where(adm_t, pos0_t, st.pos),
            prompt=torch.where(a2, prompt_t, st.prompt),
            prompt_len=torch.where(adm_t, torch.as_tensor(plen, device=dev),
                                   st.prompt_len),
            max_new=torch.where(adm_t, torch.as_tensor(mnew, device=dev),
                                st.max_new),
            n_gen=torch.where(adm_t, 0, st.n_gen),
            active=(st.active & ~rel_t) | adm_t,
            done=st.done & ~rel_t & ~adm_t,
            out=torch.where(a2, 0, st.out))
        return hits

    # -- hooks of the speculative subclass -----------------------------------

    def _sync_each_step(self) -> bool:
        """generate(): read the slot flags after every step and stop once
        no row is live.  False here: a step emits one token a live row,
        so the step count is already exact."""
        return False

    def harvest_extra(self) -> torch.Tensor:
        """A 1-D int64 tensor the Scheduler's harvest reads in its one
        device transfer and hands back through note_harvest (here
        empty)."""
        return self.state.n_gen.new_zeros(0)

    @replayed
    def note_harvest(self, n_gen: np.ndarray,
                     extra: Optional[np.ndarray] = None) -> None:
        """The host copy of every slot's n_gen (and of harvest_extra) from
        the Scheduler's harvest read (None: a read without it)."""

    def generate(self, prompts: Sequence[np.ndarray], max_new: int) -> list:
        """Static-batch decode: admit up to n_slots prompts, run to done.
        The loop waits for the device only at the end (and, on an
        oversubscribed paged pool with EOS on, for the done flags each
        step).  -> one int32 array of generated tokens per prompt."""
        if len(prompts) == 0:
            return []
        if len(prompts) > self.n_slots:
            raise ValueError(f"{len(prompts)} prompts > {self.n_slots} slots")
        hits = self.update_slots(
            release=range(self.n_slots),
            admits=[(i, p, max_new) for i, p in enumerate(prompts)])
        plens = [len(np.reshape(p, -1)) for p in prompts]
        if self.prefill_chunk > 0:
            # chunked prefill emits each slot's first token; decode does
            # the remaining max_new - 1.  A prefix hit starts the walk at
            # the hit (at most plen - 1, so one chunk always runs)
            for i, plen in enumerate(plens):
                left = plen - hits.get(i, 0)
                for _ in range(-(-left // self.prefill_chunk)):
                    self.prefill(i)
            steps = max_new - 1
        else:
            steps = max(plens) + max_new - 1
        sync_done = (self.paged and self.eos_id >= 0
                     and self.n_pages < self.n_slots * self.pages_per_slot)
        early = self._sync_each_step()
        for _ in range(steps):
            self.step()
            if sync_done or early:
                st = self.state
                host = torch.stack([st.active.long(), st.done.long(),
                                    st.n_gen]).cpu().numpy()
                done = host[1] != 0
                if sync_done:
                    self._retire(done)
                if early:
                    self.note_harvest(host[2])
                    if not (host[0].astype(bool) & ~done).any():
                        break
        out = self.state.out.cpu().numpy().astype(np.int32)
        n_gen = self.state.n_gen.cpu().numpy()
        return [out[i, :n_gen[i]] for i in range(len(prompts))]

    @replayed
    def _retire(self, done: np.ndarray) -> None:
        """generate()'s host read of the done flags: finished slots stop
        holding decode pages."""
        self._host_active &= ~np.asarray(done, bool)

    @replayed
    def score(self, tokens, labels):
        """Teacher-forced NLL of a (B, T) batch -> (per-member (K,),
        ensemble ()) tensors on the engine's device.  The ensemble NLL
        is at most the mean member NLL for any members (Jensen), also
        under a quorum.  Runs through a private contiguous pool; the
        serving pool and slot state are untouched.  On a mesh the
        per-member vector is the global (K,), gathered from the ranks,
        and the ensemble NLL fuses across them."""
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device)
        labels = torch.as_tensor(np.asarray(labels), device=self.device)
        B, T = tokens.shape
        K = self.n_local
        cache = kv_cache.init_pool(self.cfg, self.n_members, B, T,
                                   device=self.device, mesh=self.mesh)
        if self.cfg.enc_dec:
            cache["enc"] = self._encode_stub(B)
        m_tot = torch.zeros(K, device=self.device)
        e_tot = torch.zeros((), device=self.device)
        for t in range(T):
            logits, cache = tf.decode_step_slots(self.params, self.cfg,
                                                 cache, tokens[:, t:t + 1])
            logits = logits[:, :, 0].float()               # (K, B, V)
            gold = labels[:, t].long()
            lp = ens.member_log_probs(logits)
            m_tot -= lp.gather(2, gold.expand(K, B)[..., None]
                               )[..., 0].mean(1)
            e_tot -= self._fuse(logits).gather(1, gold[:, None]).mean()
        if self.mesh is not None:
            m_tot = shd.all_gather(m_tot, self.mesh,
                                   shd.MEMBER_AXIS).reshape(-1)
        return m_tot / T, e_tot / T

    def swap_params(self, new_stacked_params) -> None:
        """Install a new member stack between steps (the serving end of
        train -> compress -> serve).  The new tree must match the live
        one: structure, leaf shapes and dtypes.  Its values are copied
        into the live tensors in place, so every tensor a step reads
        keeps its identity and storage (what a captured step needs).
        The pool and slot state are not touched: in-flight requests go
        on with the new weights (drain first where a request must see
        one model).  An encoder-decoder's frames are recomputed from the
        new weights, into the pool's "enc" in place.  With the prefix
        cache on, the trie is flushed: cached pages hold the old model's
        KV.  On a mesh the leader is given the global stack and sends
        each rank its rows."""
        new = list(_flatten(new_stacked_params))
        want = [path for path, _, _ in self._param_spec]
        if [path for path, _ in new] != want:
            raise ValueError(
                f"swap_params: the new param tree's leaves "
                f"{[path for path, _ in new]} do not match the live "
                f"engine's {want}")
        for (path, shape, dtype), (_, x) in zip(self._param_spec, new):
            if tuple(x.shape) != shape or x.dtype != dtype:
                raise ValueError(
                    f"swap_params: leaf {path} is {tuple(x.shape)}/"
                    f"{x.dtype}, the live engine's is {shape}/{dtype}")
        self._incoming = [x for _, x in new]
        try:
            self._install_params()
        finally:
            self._incoming = None

    @replayed
    def _install_params(self) -> None:
        """swap_params' device half, once the tree is checked: copy the
        new leaves into the live ones (on a mesh the leader sends each
        rank its rows; a follower replays this with nothing in hand)."""
        leaves = getattr(self, "_incoming", None) or \
            [None] * len(self._param_spec)
        with torch.no_grad():
            for (_, live), x in zip(_flatten(self.params), leaves):
                if self.mesh is None:
                    live.copy_(x)
                else:
                    shd.send_rows(x, live, self.mesh)
            if self.cfg.enc_dec:
                self.cache["enc"].copy_(self._encode_stub(self.n_slots))
        if self.prefix is not None:
            self.allocator.flush_cache()
        self.swaps_done += 1

    @replayed
    def set_quorum(self, mask: Sequence[float]):
        """0/1 liveness per member (the global (K,) vector, on a mesh
        too), renormalized; the next step fuses over the survivors
        only."""
        q = ens.quorum_weights(torch.as_tensor(mask, dtype=torch.float32))
        if q.shape != (self.n_members,):
            raise ValueError(f"quorum mask wants {self.n_members} entries, "
                             f"got {tuple(q.shape)}")
        self.quorum = q[self._rows].to(self.device)

    def cache_bytes(self) -> int:
        """Bytes of the cache pool on this device (capacity telemetry):
        on a mesh, this rank's K/M members' planes, the figure a card
        budgets."""
        return kv_cache.pool_bytes(self.cache)

    # -- the mesh's ranks ----------------------------------------------------

    def follow(self, max_calls: Optional[int] = None) -> int:
        """On a follower rank: replay the leader's calls until it calls
        close(), or for max_calls calls (a caller that measures a known
        stretch of the leader's calls).  After each call the leader says
        how its own run ended.  A call that raised on both is kept in
        replay_errors and the loop goes on (the leader's caller saw the
        error: arguments it refused, say); one that raised on one side
        only leaves the ranks' states apart, and follow() raises (a
        world of common.sharding.spawn then stops every rank).
        -> the calls replayed."""
        if self.mesh is None or self._leader:
            raise RuntimeError("follow() runs on a follower rank of a mesh")
        n = 0
        while max_calls is None or n < max_calls:
            name, args, kwargs = shd.broadcast_object(None, self.mesh)
            if name == "close":
                self._closed = True
                return n
            mine = None
            try:
                getattr(self, name)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - compared below
                mine = e
            theirs = shd.broadcast_object(None, self.mesh)
            if mine is not None and theirs is None:
                raise RuntimeError(f"replayed {name} raised on this rank "
                                   f"only") from mine
            if mine is None and theirs is not None:
                raise RuntimeError(f"{name} raised on the leader only "
                                   f"({theirs}): the ranks' states differ")
            if mine is not None:
                self.replay_errors.append(f"{name}: {mine!r}")
            n += 1
        return n

    def close(self) -> None:
        """On the leader of a mesh: release the followers from follow()
        (once).  A no-op without a mesh."""
        if self.mesh is not None and self._leader and not self._closed:
            with self._replay_lock:
                shd.broadcast_object(("close", [], {}), self.mesh)
        self._closed = True
