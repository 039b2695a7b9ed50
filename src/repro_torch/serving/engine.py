"""EC-DNN_G ensemble serving engine on one device.

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
hand-written CUDA paged-attention kernel on the card.

The pool and the slot state are updated in place where the JAX package
donates buffers to its jitted programs.  The greedy decode loop never
waits for the device: sampling, output bookkeeping and the EOS/length
flags stay on the device, and the host mirrors what it needs for page
growth.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.types import ModelConfig
from repro_torch.core import ensemble as ens
from repro_torch.models import transformer as tf
from repro_torch.serving import kv_cache, sampling

KV_DTYPES = ("f32", "bf16", "int8", "fp8")


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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


class EnsembleEngine:
    """Member-batched decode engine over a fixed pool of batch slots.

    stacked_params: member params with a leading (K,) axis (the layout
    transformer.init(members=K) and bridge.params_from_numpy produce).
    K = 1 serves a single model through the identical path.  The engine
    runs on `device` (the card unless given); params are moved there.
    """

    def __init__(self, cfg: ModelConfig, stacked_params, *,
                 n_slots: int = 8, max_prompt: int = 64, max_out: int = 64,
                 prefill_chunk: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, eos_id: int = -1,
                 quorum: Optional[Sequence[float]] = None, seed: int = 0,
                 mesh=None, paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, prefix_cache: bool = False,
                 kv_dtype: str = "f32", device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: sharding the member axis over several cards comes "
                "with the multi-device slice")
        if prefix_cache:
            raise NotImplementedError(
                "prefix_cache comes with the scheduler/prefix-cache slice")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                             f"got {kv_dtype!r}")
        if kv_dtype != "f32":
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r}: quantized KV pages come with the "
                f"quantized-KV slice (the kernel already takes them)")
        if cfg.enc_dec:
            raise NotImplementedError(
                "enc-dec serving comes with the whisper slice")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to(stacked_params, self.device)
        self.n_members = self.params["embed"].shape[0]
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
        self.quorum = (torch.ones(self.n_members, device=self.device)
                       if quorum is None
                       else torch.as_tensor(quorum, dtype=torch.float32,
                                            device=self.device))
        self.paged = bool(paged)
        self.page_size = int(page_size)
        if self.paged:
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
        self.cache = kv_cache.init_pool(
            cfg, self.n_members, n_slots, self.max_seq,
            page_size=self.page_size if self.paged else 0,
            n_pages=self.n_pages if self.paged else 0, device=self.device)
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

    def _blank_state(self) -> SlotState:
        B, P, G = self.n_slots, self.max_prompt, self.max_out
        zi = lambda *s: torch.zeros(s, dtype=torch.long, device=self.device)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=self.device)
        return SlotState(tok=zi(B), pos=zi(B), prompt=zi(B, P),
                         prompt_len=zi(B), max_new=zi(B), n_gen=zi(B),
                         active=zb(B), done=zb(B), out=zi(B, G))

    # -- device work ---------------------------------------------------------

    def _member_logits(self, tok: torch.Tensor):
        """All K members score the step in one pass -> ((K, B, V), cache)."""
        step = tf.decode_step_paged if self.paged else tf.decode_step_slots
        logits, cache = step(self.params, self.cfg, self.cache, tok[:, None])
        return logits[:, :, 0], cache

    def _fuse(self, member_logits: torch.Tensor) -> torch.Tensor:
        return ens.ensemble_log_probs(member_logits, weights=self.quorum)

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

    def _sync_table(self):
        """Push the allocator's page table to the pool (every member
        carries a replica)."""
        tbl = torch.as_tensor(self.allocator.table(), device=self.device)
        self.cache["page_table"] = tbl.expand(
            self.n_members, *tbl.shape).contiguous()
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

    def reserve_decode_pages(self) -> list:
        """Grow each decoding slot's chain to cover this step's write
        position; -> slots the free list left starved.  [] when not
        paged."""
        if not self.paged:
            return []
        starved = []
        for b in np.nonzero(self._host_decoding())[0]:
            pos = int(self._host_pos[b])
            if self.allocator.holds(b, pos):
                continue
            if self.allocator.alloc(b, pos // self.page_size + 1):
                self._table_stale = True
            else:
                starved.append(int(b))
        if self._table_stale:
            self._sync_table()
        return starved

    def _release_slot(self, b: int):
        self.allocator.release(b)
        self._host_active[b] = False
        self._host_pos[b] = 0
        self._host_plen[b] = self._host_new[b] = 0

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

    def update_slots(self, release: Sequence[int] = (),
                     admits: Sequence[tuple] = ()) -> dict:
        """Evict slots and admit new requests.

        admits: (slot, prompt_tokens, max_new) triples, or 4-tuples whose
        last element is an options dict with any of {"temperature",
        "top_k", "seed"} (None/missing = engine default).  A request with
        no seed gets one derived from the engine seed and its admission
        order.  Returns {} (no prefix cache in this slice: every admitted
        slot prefills from position 0)."""
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
        if self.paged:
            # all-or-nothing page accounting BEFORE any state mutates
            recycled = [b for b in range(B) if rel[b] or adm[b]]
            avail = self.allocator.available_pages + sum(
                self.allocator.reclaimable_pages(b) for b in recycled)
            need = sum(self.allocator.pages_for(int(plen[b]))
                       for b in range(B) if adm[b])
            if need > avail:
                raise RuntimeError(
                    f"admission needs {need} pages, only {avail} "
                    f"available (pool {self.n_pages}); queue instead")
            for b in recycled:
                self._release_slot(b)
            for b in np.nonzero(adm)[0]:
                self.allocator.alloc(b, self.allocator.pages_for(plen[b]))
                self._host_active[b] = True
                self._host_pos[b] = 0
                self._host_plen[b] = plen[b]
                self._host_new[b] = mnew[b]
            self._sync_table()
        self._host_temp, self._host_topk, self._host_seed = temp, topk, seeds
        dev = self.device
        rel_t = torch.as_tensor(rel, device=dev)
        adm_t = torch.as_tensor(adm, device=dev)
        prompt_t = torch.as_tensor(prompt, device=dev)
        kv_cache.reset_slots(self.cache, adm_t)
        st = self.state
        a2 = adm_t[:, None]
        self.state = SlotState(
            tok=torch.where(adm_t, prompt_t[:, 0], st.tok),
            pos=torch.where(adm_t, 0, st.pos),
            prompt=torch.where(a2, prompt_t, st.prompt),
            prompt_len=torch.where(adm_t, torch.as_tensor(plen, device=dev),
                                   st.prompt_len),
            max_new=torch.where(adm_t, torch.as_tensor(mnew, device=dev),
                                st.max_new),
            n_gen=torch.where(adm_t, 0, st.n_gen),
            active=(st.active & ~rel_t) | adm_t,
            done=st.done & ~rel_t & ~adm_t,
            out=torch.where(a2, 0, st.out))
        return {}

    def generate(self, prompts: Sequence[np.ndarray], max_new: int) -> list:
        """Static-batch decode: admit up to n_slots prompts, run to done.
        The loop waits for the device only at the end (and, on an
        oversubscribed paged pool with EOS on, for the done flags each
        step).  -> one int32 array of generated tokens per prompt."""
        if len(prompts) == 0:
            return []
        if len(prompts) > self.n_slots:
            raise ValueError(f"{len(prompts)} prompts > {self.n_slots} slots")
        self.update_slots(
            release=range(self.n_slots),
            admits=[(i, p, max_new) for i, p in enumerate(prompts)])
        plens = [len(np.reshape(p, -1)) for p in prompts]
        if self.prefill_chunk > 0:
            # chunked prefill emits each slot's first token; decode does
            # the remaining max_new - 1
            for i, plen in enumerate(plens):
                for _ in range(-(-plen // self.prefill_chunk)):
                    self.prefill(i)
            steps = max_new - 1
        else:
            steps = max(plens) + max_new - 1
        sync_done = (self.paged and self.eos_id >= 0
                     and self.n_pages < self.n_slots * self.pages_per_slot)
        for _ in range(steps):
            self.step()
            if sync_done:
                self._host_active &= ~self.state.done.cpu().numpy()
        out = self.state.out.cpu().numpy().astype(np.int32)
        n_gen = self.state.n_gen.cpu().numpy()
        return [out[i, :n_gen[i]] for i in range(len(prompts))]

    def set_quorum(self, mask: Sequence[float]):
        """0/1 liveness per member, renormalized; the next step fuses
        over the survivors only."""
        q = ens.quorum_weights(torch.as_tensor(mask, dtype=torch.float32))
        if q.shape != (self.n_members,):
            raise ValueError(f"quorum mask wants {self.n_members} entries, "
                             f"got {tuple(q.shape)}")
        self.quorum = q.to(self.device)

    def cache_bytes(self) -> int:
        """Bytes of the cache pool on the device (capacity telemetry)."""
        return kv_cache.pool_bytes(self.cache)
