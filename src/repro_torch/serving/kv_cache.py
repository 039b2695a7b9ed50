"""Slot-indexed decode-cache pool for the ensemble serving engine.

One pool holds the caches of all K members for all B batch slots:

  idx            (K, B)                per-member, per-slot position
  ring leaves    (K, count, B, S, ...) per-slot K/V planes
  recurrent      (K, count, B, ...)    per-slot state (Mamba's conv and
  leaves                               ssm, rwkv's shift and wkv, the
                                       channel-mix's cmix_shift)
  paged leaves   (K, count, n_pages, page_size, ...)
  page_table     (K, B, ceil(max_seq/page_size))  logical -> physical

The pool is allocated once and recycled: finishing a request frees
nothing, `reset_slots` rewinds the slot's position and zeroes its
recurrent state, and the next request overwrites the K/V entries as it
decodes (stale entries are masked by position bookkeeping).  The model
code updates the planes IN PLACE, where the JAX package returns new
planes into a donated buffer; the helpers below say where that changes
their contract.  The page table is host policy (PageAllocator, sentinel
id n_pages = unallocated).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike
from repro_torch.common.types import ModelConfig
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
              device: DeviceLike = None) -> dict:
    """Allocate the (K members) x (B slots) cache pool on `device` (the
    card unless given).  page_size > 0 allocates the paged layout with an
    all-sentinel page table."""
    return tf.init_slot_cache(cfg, n_slots, max_seq, page_size=page_size,
                              n_pages=n_pages, members=n_members,
                              device=device)


def reset_slots(pool: dict, mask: torch.Tensor,
                start: Optional[torch.Tensor] = None) -> dict:
    """Recycle slots where mask (B,) is True, across all members: idx
    rewinds to `start` (default 0).  Positional and paged planes are left
    as they are (stale entries stay masked); any other per-slot plane is
    zeroed in place for the masked rows.  Other rows are untouched."""
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
    whole; the slot's page-table row rides along.  Because these are
    views, a prefill on the row writes straight into the pool."""
    def pick(name, x):
        return x if name.endswith("_pages") else x.narrow(2, b, 1)

    out = {"idx": pool["idx"].narrow(1, b, 1),
           "segments": _map(pool["segments"], pick)}
    if "page_table" in pool:
        out["page_table"] = pool["page_table"].narrow(1, b, 1)
    return out


def write_slot_row(pool: dict, row: dict, b: int) -> dict:
    """Insert an advanced slot row (from slot_row) back at slot b.  The
    planes were written through slot_row's views already, so only the
    row's position is copied."""
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
# paged-pool page accounting (host side)
# ---------------------------------------------------------------------------


class PageAllocator:
    """Refcounting free-list allocator behind the paged pool's table.

    Pure host policy.  Physical pages are ids in [0, n_pages); the
    sentinel id `n_pages` marks an unallocated page-table entry (reads
    clamp and are masked, writes drop).  Each slot holds a chain of
    pages, one per logical page, grown strictly in order.  Pages carry a
    refcount of 1 while a chain holds them.  No zeroing anywhere: the
    next owner overwrites every entry before the position bookkeeping
    makes it visible.  The same id space addresses every paged layer's
    plane, so one page buys position capacity in all layers at once.
    (The JAX package's prefix-cache hooks, share/cow and the trie, come
    with a later slice.)
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
        self._dirty = True
        self._table: Optional[np.ndarray] = None
        # fewest free pages ever observed after an alloc
        self.low_water = self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def available_pages(self) -> int:
        return len(self._free)

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
        return tuple(self._chain[slot])

    def alloc(self, slot: int, n_logical: int) -> bool:
        """Grow `slot` to cover >= n_logical logical pages.  All-or-
        nothing: returns False (state untouched) when the free list
        cannot cover the growth or n_logical exceeds the table width."""
        need = int(n_logical) - len(self._chain[slot])
        if need <= 0:
            return True
        if n_logical > self.pages_per_slot or need > len(self._free):
            return False
        for _ in range(need):
            p = self._free.pop()
            self._ref[p] = 1
            self._chain[slot].append(p)
        self._dirty = True
        self.low_water = min(self.low_water, len(self._free))
        return True

    def _drop(self, pages) -> None:
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] < 0:
                raise AssertionError(f"page {p} refcount underflow")
        self._free.extend(p for p in reversed(pages) if self._ref[p] == 0)
        self._dirty = True

    def truncate(self, slot: int, n_logical: int) -> int:
        """Shrink `slot` back to n_logical pages; -> pages dropped."""
        n = len(self._chain[slot]) - max(int(n_logical), 0)
        if n <= 0:
            return 0
        tail = self._chain[slot][-n:]
        self._chain[slot] = self._chain[slot][:-n]
        self._drop(tail)
        return n

    def release(self, slot: int) -> int:
        """Return `slot`'s whole chain to the free list; -> its length."""
        chain = self._chain[slot]
        if chain:
            self._chain[slot] = []
            self._drop(chain)
        return len(chain)

    def reclaimable_pages(self, slot: int) -> int:
        """Chain pages a release would push onto the free list now."""
        return sum(1 for p in self._chain[slot] if self._ref[p] == 1)

    def check_invariants(self) -> None:
        """Assert the global accounting: every page's refcount equals the
        chains holding it, the free list has no duplicates and holds
        exactly the unreferenced pages."""
        chain_refs = [0] * self.n_pages
        for b, chain in enumerate(self._chain):
            for p in chain:
                assert 0 <= p < self.n_pages, \
                    f"slot {b} chain holds invalid page id {p}"
                chain_refs[p] += 1
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for p in range(self.n_pages):
            assert self._ref[p] == chain_refs[p], \
                (f"page {p}: refcount {self._ref[p]} != "
                 f"{chain_refs[p]} chain references")
            assert (p in free) == (chain_refs[p] == 0), \
                f"page {p} is {'free' if p in free else 'leaked'} " \
                f"with {chain_refs[p]} chain references"

    def table(self) -> np.ndarray:
        """(n_slots, pages_per_slot) int32 logical->physical map,
        sentinel-filled (n_pages) where unallocated."""
        if self._dirty or self._table is None:
            t = np.full((self.n_slots, self.pages_per_slot), self.n_pages,
                        np.int32)
            for b, chain in enumerate(self._chain):
                if chain:
                    t[b, : len(chain)] = chain
            self._table = t
            self._dirty = False
        return self._table


def pool_bytes(pool: dict) -> int:
    """Bytes held by the pool (capacity telemetry)."""
    return sum(x.numel() * x.element_size() for _, x in _leaves(pool))


def page_bytes(pool: dict, n_pages: int) -> int:
    """Bytes ONE physical page costs across all paged planes."""
    total = sum(x.numel() * x.element_size()
                for name, x in _leaves(pool["segments"])
                if name.endswith("_pages"))
    return total // max(n_pages, 1)
