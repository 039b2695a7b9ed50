"""Slot-indexed decode-cache pool for the ensemble serving engine.

One pool holds the caches of all K members for all B batch slots:

  idx            (K, B)                per-member, per-slot position
  ring leaves    (K, count, B, S, ...) per-slot K/V planes
  recurrent      (K, count, B, ...)    per-slot state (Mamba's conv and
  leaves                               ssm, rwkv's shift and wkv, the
                                       channel-mix's cmix_shift)
  paged leaves   (K, count, n_pages, page_size, ...), with f32
                 "*_scale_pages" sidecars (the same leading axes) when
                 the pool stores int8 / fp8 pages
  page_table     (K, B, ceil(max_seq/page_size))  logical -> physical
  enc            (K, B, S, d)          an encoder-decoder's frames, set
                                       by the engine, never reset

The pool is allocated once and recycled: finishing a request frees
nothing, `reset_slots` rewinds the slot's position and zeroes its
recurrent state, and the next request overwrites the K/V entries as it
decodes (stale entries are masked by position bookkeeping).  The model
code updates the planes IN PLACE, where the JAX package returns new
planes into a donated buffer; the helpers below say where that changes
their contract.  The page table is host policy (PageAllocator, sentinel
id n_pages = unallocated).  With the prefix trie wired in
(serving/prefix.py) chains share physical prefix pages: a write into a
shared page goes through copy-on-write (PageAllocator.cow, then
copy_pages on the device), and pages at refcount zero that the trie
owns stay evictable with their content instead of going free.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import sharding as shd
from repro_torch.common.device import DeviceLike
from repro_torch.common.tree import tree_map
from repro_torch.common.types import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf

# positional cache planes: stale entries are masked by position
# bookkeeping, so recycling a slot never needs to touch them.  Paged
# planes ("*_pages") have no slot axis at all.
_POSITIONAL = frozenset({"k", "v", "c_kv", "k_r"})


def _skip_slot_update(name: str) -> bool:
    return name in _POSITIONAL or name.endswith("_pages")


def _leaves(tree, name: str = ""):
    """(leaf name, tensor) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, name)
    else:
        yield name, tree


def _map(tree, fn, name: str = ""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, name) for v in tree]
    return fn(name, tree)


def init_pool(cfg: ModelConfig, n_members: int, n_slots: int, max_seq: int,
              page_size: int = 0, n_pages: int = 0,
              device: DeviceLike = None, kv_dtype: str = "f32",
              mesh=None) -> dict:
    """Allocate the (K members) x (B slots) cache pool on `device` (the
    card unless given).  page_size > 0 allocates the paged layout with an
    all-sentinel page table.  kv_dtype picks the paged planes' storage
    ("f32" the model's dtype; "bf16"; "int8" / "fp8" quantized with
    per-token scale sidecars, which end in "_pages" and so are copied,
    folded and counted with their planes); rings and recurrent state
    are never quantized.  With a mesh (common/sharding.local_mesh) the
    pool holds this rank's K/M members only (M must divide K)."""
    if mesh is not None:
        rows = shd.member_rows(n_members, mesh)
        n_members = rows.stop - rows.start
    return tf.init_slot_cache(cfg, n_slots, max_seq, page_size=page_size,
                              n_pages=n_pages, members=n_members,
                              device=device, kv_dtype=kv_dtype)


def shard_pool(pool: dict, mesh) -> dict:
    """This rank's rows of a pool (or any tree of leading-(K,) leaves)
    over a member mesh, as copies (the global pool can be freed)."""
    rows = None

    def take(x):
        nonlocal rows
        if rows is None:
            rows = shd.member_rows(x.shape[0], mesh)
        return x[rows].clone()

    return tree_map(take, pool)


def reset_slots(pool: dict, mask: torch.Tensor,
                start: Optional[torch.Tensor] = None) -> dict:
    """Recycle slots where mask (B,) is True, across all members: idx
    rewinds to `start` (default 0).  Positional and paged planes are left
    as they are (stale entries stay masked); any other per-slot plane is
    zeroed in place for the masked rows.  Other rows are untouched, and
    "enc" (the encoder's frames: not decode state) survives."""
    tgt = torch.zeros_like(pool["idx"]) if start is None \
        else torch.broadcast_to(start.to(pool["idx"].dtype), pool["idx"].shape)
    pool["idx"] = torch.where(mask[None, :], tgt, pool["idx"])

    def z(name, x):  # leaves are (K, count, B, ...)
        if not _skip_slot_update(name):
            m = mask.reshape((1, 1, -1) + (1,) * (x.dim() - 3))
            x.copy_(torch.where(m, torch.zeros_like(x), x))
        return x

    _map(pool["segments"], z)
    return pool


def slot_row(pool: dict, b: int) -> dict:
    """Views of one slot's caches (all members): the B axis narrows to
    length 1 at slot b.  Paged planes have no slot axis and pass through
    whole; the slot's page-table row and encoder frames ride along.
    Because these are views, a prefill on the row writes straight into
    the pool."""
    def pick(name, x):
        return x if name.endswith("_pages") else x.narrow(2, b, 1)

    out = {"idx": pool["idx"].narrow(1, b, 1),
           "segments": _map(pool["segments"], pick)}
    if "page_table" in pool:
        out["page_table"] = pool["page_table"].narrow(1, b, 1)
    if "enc" in pool:
        out["enc"] = pool["enc"].narrow(1, b, 1)
    return out


def write_slot_row(pool: dict, row: dict, b: int) -> dict:
    """Insert an advanced slot row (from slot_row) back at slot b.  The
    planes were written through slot_row's views already, so only the
    row's position is copied ("enc" is computed once and never
    advanced)."""
    pool["idx"][:, b:b + 1] = row["idx"]
    return pool


def _map2(a, b, fn, name: str = ""):
    if isinstance(a, dict):
        return {k: _map2(a[k], b[k], fn, k) for k in a}
    if isinstance(a, list):
        return [_map2(x, y, fn, name) for x, y in zip(a, b)]
    return fn(name, a, b)


def snapshot(pool: dict) -> dict:
    """What keep_frozen restores, taken before a decode step: the
    pool's idx and a copy of every recurrent plane (those
    _skip_slot_update does not skip: Mamba's conv and ssm, rwkv's shift
    and wkv, the channel-mix's cmix_shift).  The step updates the planes in place
    and replaces idx, so positional and paged planes are not copied; a
    model with no recurrent plane copies nothing."""
    def keep(name, x):
        return None if _skip_slot_update(name) else x.clone()

    return {"idx": pool["idx"], "segments": _map(pool["segments"], keep)}


def keep_frozen(new: dict, old: dict, advance: torch.Tensor) -> dict:
    """Undo a decode step's cache mutation for rows where advance (B,) is
    False (inactive, finished, or mid-prompt while prefill owns the
    prompt path): a frozen slot must neither walk its position forward
    (an idle slot would march past max_seq) nor move its recurrent
    state (a mid-prompt slot's next prefill chunk continues from it).

    `old` is snapshot(pool) from before the step.  idx and every
    recurrent plane are restored bit for bit in frozen rows, in place,
    as in the JAX package.  The positional and paged planes keep the
    step's write: it lands at the frozen position, stays invisible
    under the position bookkeeping and is overwritten before a later
    occupant can see it."""
    out = dict(new)
    out["idx"] = torch.where(advance[None, :], new["idx"], old["idx"])

    def sel(name, n, o):  # leaves are (K, count, B, ...)
        if o is not None:
            m = advance.reshape((1, 1, -1) + (1,) * (n.dim() - 3))
            n.copy_(torch.where(m, n, o))
        return n

    _map2(new["segments"], old["segments"], sel)
    return out


# ---------------------------------------------------------------------------
# speculative rollback: snapshot / restore a window of positions
# ---------------------------------------------------------------------------
# A speculative step writes a (gamma+1)-token chunk at positions
# pos..pos+C-1 and keeps only the accepted prefix.  On full planes the
# rejected tail is stale and masked once idx rewinds, but a ring plane
# reuses slot p % S: the tail's writes land on live history (position
# p - S).  So the step snapshots the C entries a chunk will overwrite,
# for every positional plane ("k", "v", "c_kv", "k_r"), and puts the
# rejected tail's back after acceptance.  Paged planes and their scale
# sidecars are skipped, as in the JAX package: rejected writes there are
# stale, and the host hands the pages past the accepted length back
# (PageAllocator.truncate).


def snapshot_positions(pool: dict, start: torch.Tensor, length: int) -> dict:
    """Copy the `length` entries at positions start[b] + t (ring slot
    (start[b] + t) % S) of every positional plane (K, count, B, S, ...)
    -> {"segments": same tree, (K, count, B, length, ...) copies, None
    for every other leaf}."""
    t = torch.arange(length, device=start.device)

    def grab(name, x):
        if name not in _POSITIONAL:
            return None
        S = x.shape[3]
        bb = torch.arange(x.shape[2], device=x.device)[:, None]
        tt = (start.long()[:, None] + t[None, :]) % S          # (B, C)
        return x[:, :, bb, tt]

    return {"segments": _map(pool["segments"], grab)}


def restore_positions(pool: dict, snap: dict, start: torch.Tensor,
                      keep: torch.Tensor) -> dict:
    """Put a snapshot's rejected tail back, in place: entries t in
    [keep[b], C) of row b return to their content before the step; the
    first keep[b] (accepted tokens) stay as the verify pass wrote them.
    keep == C leaves the row as it is, keep == 0 rewinds all C.  idx is
    not touched (the caller sets it)."""
    def put(name, x, s):
        if s is None:
            return x
        K, count, B, S = x.shape[:4]
        C = s.shape[3]
        t = torch.arange(C, device=x.device)[None, :]
        tgt = (start.long()[:, None] + t) % S                  # (B, C)
        tgt = tgt + torch.arange(B, device=x.device)[:, None] * S
        flat = x.view(K * count, B * S, -1)
        attn._put_rows(flat, tgt.reshape(-1),
                       s.reshape(K * count, B * C, -1),
                       (t >= keep.long()[:, None]).reshape(-1))
        return x

    _map2(pool["segments"], snap["segments"], put)
    return pool


# ---------------------------------------------------------------------------
# paged-pool page accounting (host side)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounting free-list allocator behind the paged pool's table.

    Pure host policy, a copy of the JAX package's.  Physical pages are ids
    in [0, n_pages); the sentinel id `n_pages` marks an unallocated
    page-table entry (paged kernels clamp + mask reads through it and
    drop writes).  Each slot holds a chain of pages, one per logical
    page, grown strictly in order (sequence positions only ever
    advance).  Pages are REFCOUNTED, not owned: a chain page fresh from
    `alloc` carries refcount 1 (the old exclusive-ownership behavior,
    bit-identical for chains that never share), while `share` attaches
    pages of an existing prefix — the same physical page then appears
    in several chains and in the prefix trie, and `release`/`truncate`
    become refcount decrements that only free a page at zero.  `cow`
    is the copy-on-write step: a slot about to write into a shared page
    swaps a fresh page into its chain first (the engine dispatches the
    device copy).  No zeroing anywhere: the next owner overwrites every
    entry before the position bookkeeping makes it visible, the same
    invariant the contiguous pool recycles slots with.

    With a PrefixCache wired in (`self.cache`, engine-owned), pages
    whose refcount drops to zero while the trie owns them become
    EVICTABLE instead of free — their KV content is kept for future
    sharers and reclaimed LRU leaf-first only when the free list runs
    dry (`alloc` calls `cache.reclaim`).  `available_pages` is
    therefore free + evictable: the admission headroom.

    The same id space addresses every paged layer's plane (each layer
    has its own (n_pages, page_size, ...) physical pool, all indexed by
    the one table), so allocating a page buys position capacity in ALL
    layers at once — vLLM's block-table layout.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 pages_per_slot: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(f"need n_pages > 0 and page_size > 0, got "
                             f"{n_pages}, {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.n_slots = int(n_slots)
        self.pages_per_slot = int(pages_per_slot)
        # pop() takes the lowest id first — keeps tables human-readable
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._chain: List[List[int]] = [[] for _ in range(self.n_slots)]
        self._ref: List[int] = [0] * self.n_pages
        # prefix trie (serving/prefix.PrefixCache), wired by the engine
        # when prefix caching is on; None keeps pure free-list behavior
        self.cache = None
        self._dirty = True
        self._table: Optional[np.ndarray] = None
        # fewest free pages ever observed after an alloc — how close
        # the pool came to preemption over its lifetime (capacity
        # telemetry; client.print_report surfaces it)
        self.low_water = self.n_pages
        self.shared_attach_count = 0  # pages attached via share()
        self.cow_count = 0            # pages copied via cow()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def available_pages(self) -> int:
        """Free-list pages plus trie-cached pages no slot references —
        everything an alloc can hand out (admission headroom)."""
        return len(self._free) + (self.cache.evictable
                                  if self.cache is not None else 0)

    @property
    def shared_pages(self) -> int:
        """Pages currently referenced by more than one chain."""
        return sum(1 for r in self._ref if r > 1)

    def ref(self, page: int) -> int:
        return self._ref[page]

    def pages_for(self, n_tokens: int) -> int:
        """Pages covering n_tokens positions from 0."""
        return -(-int(n_tokens) // self.page_size)

    def holds(self, slot: int, position: int) -> bool:
        """Is `position`'s page already allocated to `slot`?"""
        return position // self.page_size < len(self._chain[slot])

    def held_pages(self, slot: int) -> int:
        return len(self._chain[slot])

    def chain(self, slot: int) -> Tuple[int, ...]:
        """`slot`'s physical page chain in logical order (a copy)."""
        return tuple(self._chain[slot])

    def alloc(self, slot: int, n_logical: int) -> bool:
        """Grow `slot` to cover >= n_logical logical pages (fresh pages,
        refcount 1).

        All-or-nothing: returns False (state untouched) when free +
        evictable pages cannot cover the growth or n_logical exceeds
        the per-slot table width — the caller (engine/scheduler) then
        preempts or queues instead of partially admitting.  When the
        free list alone is short, trie-cached unreferenced pages are
        evicted (LRU leaf-first) to cover the difference — the prefix
        cache yields to live requests, never the other way around.
        """
        need = int(n_logical) - len(self._chain[slot])
        if need <= 0:
            return True
        if n_logical > self.pages_per_slot or need > self.available_pages:
            return False
        if need > len(self._free):
            self._free.extend(
                reversed(self.cache.reclaim(need - len(self._free))))
        for _ in range(need):
            p = self._free.pop()
            self._ref[p] = 1
            self._chain[slot].append(p)
        self._dirty = True
        self.low_water = min(self.low_water, len(self._free))
        return True

    def share(self, slot: int, pages: Sequence[int]) -> None:
        """Attach an existing prefix's pages to `slot`'s chain (in
        logical order, extending the tail) and take a reference on
        each.  The pages' KV content is someone else's work — the slot
        may READ through them but must never write below its admission
        hit (engine admission guarantees writes start at the hit; the
        partial tail page goes through `cow` first).
        """
        chain = self._chain[slot]
        if len(chain) + len(pages) > self.pages_per_slot:
            raise ValueError(
                f"share would grow slot {slot} past pages_per_slot="
                f"{self.pages_per_slot}")
        for p in pages:
            p = int(p)
            self._ref[p] += 1
            if self._ref[p] == 1 and self.cache is not None \
                    and self.cache.owns(p):
                self.cache.page_referenced(p)
            chain.append(p)
        self.shared_attach_count += len(pages)
        self._dirty = True

    def cow(self, slot: int, logical: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: give `slot` an exclusive copy of its logical
        page `logical` before its first divergent write lands there.

        If the current page is shared (refcount > 1, or cached in the
        trie where future sharers could pick it up), a fresh page is
        swapped into the chain and (src, dst) returned — the CALLER
        copies the device content (copy_pages) before dispatching any
        write.  An already-exclusive page returns None (write in
        place).  Raises when no page is available: admission accounting
        charges the COW destination as part of the non-shared suffix,
        so a caller that checked available_pages never trips this.
        """
        src = self._chain[slot][logical]
        shared = self._ref[src] > 1 or (self.cache is not None
                                        and self.cache.owns(src))
        if not shared:
            return None
        if not self._free and self.cache is not None:
            self._free.extend(reversed(self.cache.reclaim(1)))
        if not self._free:
            raise RuntimeError(
                f"cow: no page available for slot {slot} (pool "
                f"{self.n_pages}, all referenced)")
        dst = self._free.pop()
        self._ref[dst] = 1
        self._chain[slot][logical] = dst
        self._unref(src)
        self.cow_count += 1
        self.low_water = min(self.low_water, len(self._free))
        self._dirty = True
        return src, dst

    def _unref(self, page: int) -> bool:
        """Drop one reference; at zero the page goes to the free list —
        or to the trie's evictable pool when the trie owns it (content
        kept for future sharers).  -> True when the page left the
        chain's accounting (always; return is for symmetry/clarity)."""
        self._ref[page] -= 1
        if self._ref[page] < 0:
            raise AssertionError(f"page {page} refcount underflow")
        if self._ref[page] == 0:
            if self.cache is not None and self.cache.owns(page):
                self.cache.page_unreferenced(page)
            else:
                self._free.append(page)
        return True

    def truncate(self, slot: int, n_logical: int) -> int:
        """Shrink `slot` back to n_logical pages; -> pages dropped from
        the chain (freed immediately unless still shared/cached).

        The speculative engine (serving/spec/engine.py) hands its
        gamma-token lookahead pages back through this once it knows
        each row's accepted length.  Chains only ever shrink from the
        tail (positions are append-only); decode-tail pages are
        refcount-1 and never trie-cached (a chain's shared prefix sits
        strictly below the prompt).  Already-short chains are a no-op.
        """
        n = len(self._chain[slot]) - max(int(n_logical), 0)
        if n <= 0:
            return 0
        tail = self._chain[slot][-n:]
        self._chain[slot] = self._chain[slot][:-n]
        freed = [p for p in reversed(tail)
                 if self._ref[p] == 1 and not (
                     self.cache is not None and self.cache.owns(p))]
        for p in tail:
            if p in freed:
                self._ref[p] = 0
            else:
                self._unref(p)
        self._free.extend(freed)
        self._dirty = True
        return n

    def release(self, slot: int) -> int:
        """Drop `slot`'s references to its whole chain; -> chain length.
        Pages nobody else references return to the free list (reversed,
        so the lowest id pops first, as before refcounting) — unless
        the trie owns them, in which case they become evictable with
        their content intact (that is how a released request's prefix
        stays warm for the next sharer)."""
        chain = self._chain[slot]
        n = len(chain)
        if n:
            freed = [p for p in reversed(chain)
                     if self._ref[p] == 1 and not (
                         self.cache is not None and self.cache.owns(p))]
            for p in chain:
                if self._ref[p] == 1 and p in freed:
                    self._ref[p] = 0
                else:
                    self._unref(p)
            self._free.extend(freed)
            self._chain[slot] = []
            self._dirty = True
        return n

    def reclaimable_pages(self, slot: int) -> int:
        """Chain pages a release would push onto the FREE list right
        now: refcount exactly 1 and not trie-owned.  (Trie-owned pages
        go evictable instead — still admission headroom, but counted by
        `available_pages` once they get there, so counting them here
        would double-book.)  Scheduler admission adds this for slots in
        its release batch."""
        return sum(1 for p in self._chain[slot]
                   if self._ref[p] == 1 and not (
                       self.cache is not None and self.cache.owns(p)))

    def flush_cache(self) -> int:
        """Drop the prefix trie (engine.swap_params: cached pages hold
        the old model's KV) and return its unreferenced pages to the
        free list; -> pages freed.  No-op without a trie."""
        if self.cache is None:
            return 0
        pages = self.cache.flush()
        self._free.extend(sorted(pages, reverse=True))
        return len(pages)

    def check_invariants(self) -> None:
        """Assert the pool's global accounting is consistent; raises
        AssertionError naming the first violation.

        The conservation law every admit/share/cow/cancel/preempt/
        release interleaving must preserve (the cancellation path and
        the fleet soak gate on this, and the hypothesis property test
        drives random op sequences through it):

          - every page's refcount equals the number of chains holding
            it (the trie owns content, never references);
          - the free list is disjoint from every chain and from the
            trie, and holds no duplicates;
          - refcount 0 <=> free or trie-evictable: every page is
            exactly one of free / chain-referenced / cached-unref;
          - the trie's evictable count matches its ref-0 owned pages.
        """
        chain_refs = [0] * self.n_pages
        for b, chain in enumerate(self._chain):
            for p in chain:
                assert 0 <= p < self.n_pages, \
                    f"slot {b} chain holds invalid page id {p}"
                chain_refs[p] += 1
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        owned = (self.cache.owned_pages() if self.cache is not None
                 else set())
        evictable = 0
        for p in range(self.n_pages):
            assert self._ref[p] == chain_refs[p], \
                (f"page {p}: refcount {self._ref[p]} != "
                 f"{chain_refs[p]} chain references")
            if p in free:
                assert chain_refs[p] == 0, \
                    f"page {p} is free but referenced by a chain"
                assert p not in owned, \
                    f"page {p} is free but the trie still owns it"
            elif chain_refs[p] == 0:
                assert p in owned, \
                    f"page {p} leaked: not free, not referenced, not cached"
                evictable += 1
        if self.cache is not None:
            assert evictable == self.cache.evictable, \
                (f"trie evictable counter {self.cache.evictable} != "
                 f"{evictable} ref-0 owned pages")

    def table(self) -> np.ndarray:
        """(n_slots, pages_per_slot) int32 logical->physical map,
        sentinel-filled (n_pages) where unallocated.  Cached; rebuilt
        only after an alloc/release."""
        if self._dirty or self._table is None:
            t = np.full((self.n_slots, self.pages_per_slot), self.n_pages,
                        np.int32)
            for b, chain in enumerate(self._chain):
                if chain:
                    t[b, : len(chain)] = chain
            self._table = t
            self._dirty = False
        return self._table


def copy_pages(pool: dict, src: np.ndarray, dst: np.ndarray,
               n_pages: int) -> dict:
    """Copy whole physical pages src[i] -> dst[i] in every paged plane of
    every member and layer, in place: the device half of copy-on-write
    (PageAllocator.cow swaps a fresh dst page into a chain; the engine
    calls this before any kernel writes the page).

    src, dst: (B,) host id arrays; rows whose dst is the sentinel
    (n_pages) are dropped here on the host, where the JAX package's
    scatter drops them on the device.  Every source page is gathered
    before any destination is written, so a src that is also another
    row's dst (evicted and handed out again in the same admission
    batch) is read first.  Enqueue order on the pool's stream puts the
    copy after every earlier write of src and before every later write
    of dst, as the donated buffer does in the JAX package."""
    src, dst = np.asarray(src).reshape(-1), np.asarray(dst).reshape(-1)
    keep = (dst >= 0) & (dst < n_pages)
    if not keep.any():
        return pool

    def cp(name, x):  # paged leaves are (K, count, n_pages, page, ...)
        if name.endswith("_pages"):
            x = attn._raw(x)   # fp8 pages move as their bytes
            s = torch.as_tensor(np.clip(src[keep], 0, n_pages - 1),
                                device=x.device)
            d = torch.as_tensor(dst[keep], device=x.device)
            x[:, :, d] = x[:, :, s]    # the right side is a gathered copy
        return x

    _map(pool["segments"], cp)
    return pool


def pool_bytes(pool: dict) -> int:
    """Bytes held by the pool (capacity telemetry)."""
    return sum(x.numel() * x.element_size() for _, x in _leaves(pool))


def page_bytes(pool: dict, n_pages: int) -> int:
    """Bytes ONE physical page costs across all paged planes."""
    total = sum(x.numel() * x.element_size()
                for name, x in _leaves(pool["segments"])
                if name.endswith("_pages"))
    return total // max(n_pages, 1)
