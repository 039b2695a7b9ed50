"""SpeculativeEngine: the distilled student drafts for its teachers.

One speculative iteration per step, for every slot at once:

  1. DRAFT    the K = 1 student runs gamma+1 per-slot decode steps
              (spec/draft.propose), building the verify chunk [tok, d_1
              .. d_gamma] and writing its own K/V;
  2. VERIFY   all K members score all gamma+1 chunk positions in one
              batched pass (transformer.verify_slots, or
              verify_step_paged over the paged pool, where the chunk
              goes through the flash kernel) and fuse each position by
              Eqn 6 under the quorum vector;
  3. ACCEPT   greedy: the longest prefix on which every draft equals the
              fused argmax, so the emitted tokens are the plain engine's;
              stochastic (spec_sampling=True): rejection sampling against
              the tempered fused target;
  4. ROLLBACK the cache entries past the accepted prefix return to their
              content before the step (kv_cache.snapshot_positions /
              restore_positions) and both pools' idx rewind to pos + e;
              on the paged pool the host hands the pages past the
              accepted length back (PageAllocator.truncate).

Member pruning rides the verify pass as telemetry
(core.ensemble.prunable_members): members whose whole vote cannot flip
the fused argmax at a position are counted, never skipped.

Over a member mesh (as EnsembleEngine's) the K = 1 draft is replicated
on every rank, each rank verifies with its own members, the verify
pass's fusion is the cross-rank one, and the pruning test stays local
(its counts are summed over the ranks).

The host contract is the plain engine's: a greedy step reads nothing
back from the device.  The rows' accepted lengths reach the host in the
Scheduler's one read a tick (n_gen, with the stats vector appended:
harvest_extra / note_harvest), where the host mirrors of the positions
resync and the lookahead pages past each row's accepted length go back
to the pool.  A caller that steps without a harvest in between pays one
read of n_gen at the next step instead.

Stochastic draws cannot match the JAX package's (jax.random keys against
torch generators): each stochastic row draws from torch generators
seeded, as serving/sampling.py seeds them, from the request seed, a salt
per stream (draft, accept, resample) and the row's emission count, so a
request redraws identically under its seed.  A draft-off stochastic row
draws with the plain path's own generator and matches the plain engine.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common.types import ModelConfig
from repro_torch.core import ensemble as ens
from repro_torch.models import transformer as tf
from repro_torch.serving import kv_cache, sampling
from repro_torch.common import sharding as shd
from repro_torch.serving.engine import (EnsembleEngine, _flatten, _to,
                                        replayed)
from repro_torch.serving.spec import draft as draft_mod
from repro_torch.serving.spec import verify as verify_mod

# salts separating the speculative draw streams from the plain path's
# (sampling.draw_seed(seed, n_gen)) and from each other
_SALT_DRAFT, _SALT_ACCEPT, _SALT_RESAMPLE = 0x5D1, 0x5D2, 0x5D3

# stats vector: [proposed, accepted, spec_steps, prunable_count,
# prunable_total, hist(e = 0..gamma+1)]
_N_HEAD = 5


def _row_generator(seed: int, salt: Optional[int], n_gen: int,
                   device) -> torch.Generator:
    """The generator of one row's draw stream at emission n_gen (salt
    None: the plain path's, serving/sampling.sample_slots')."""
    s = int(seed) if salt is None else sampling.draw_seed(seed, salt)
    g = torch.Generator(device=device)
    g.manual_seed(sampling.draw_seed(s, n_gen))
    return g


def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u))


class SpeculativeEngine(EnsembleEngine):
    """EnsembleEngine plus a student draft model, with the same host API.

    draft_params: the compressed student, unstacked or a K = 1 stack.
    It shares the members' architecture unless draft_cfg names a smaller
    one (fewer layers: the classic cheap draft) of the same vocab and
    dtype.  gamma: drafted tokens an iteration.  spec_sampling=False is
    greedy speculative decoding, its tokens the plain fused engine's;
    True turns on rejection sampling for temperature > 0 requests.

    Per-request opt-out: admit with {"draft": False} (Scheduler's
    Request.draft); such rows verify one position through the same
    pass, as the plain step would.  A step with no live drafting slot
    runs the inherited plain step.  Gated to attention-only stacks (a
    recurrent state has no position axis to roll back), chunked prefill
    (the verify pass is chunked scoring) and no prefix cache (the draft
    pool is per slot: a hit would leave its positions blank there)."""

    def __init__(self, cfg: ModelConfig, stacked_params, draft_params, *,
                 draft_cfg: Optional[ModelConfig] = None, gamma: int = 4,
                 spec_sampling: bool = False, **kw):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if kw.get("prefix_cache"):
            raise ValueError("speculative serving does not support "
                             "prefix_cache (the draft cache is "
                             "slot-contiguous; hit-skipped positions "
                             "would leave it blank)")
        self.gamma = int(gamma)
        self.spec_sampling = bool(spec_sampling)
        super().__init__(cfg, stacked_params, **kw)
        self.draft_cfg = cfg if draft_cfg is None else draft_cfg
        if self.prefill_chunk <= 0:
            raise ValueError(
                "speculative serving needs chunked prefill "
                "(prefill_chunk > 0): the verify pass reuses it")
        if self.draft_cfg.vocab_size != cfg.vocab_size \
                or self.draft_cfg.dtype != cfg.dtype:
            raise ValueError(
                f"draft_cfg vocab/dtype "
                f"({self.draft_cfg.vocab_size}/{self.draft_cfg.dtype}) "
                f"must match the ensemble's "
                f"({cfg.vocab_size}/{cfg.dtype})")
        for c in (cfg, self.draft_cfg):
            if c.enc_dec:
                raise ValueError("speculative serving does not support "
                                 "enc-dec archs")
            for _, specs in c.segments():
                for spec in specs:
                    if spec.mixer not in ("attn", "attn_local") \
                            or spec.ffn == "rwkv_cmix":
                        raise ValueError(
                            f"speculative serving needs attention-only, "
                            f"rollback-able layers; got mixer="
                            f"{spec.mixer!r} ffn={spec.ffn!r}")
        self.draft_params = _to(draft_mod.as_member_stack(
            draft_params, like=self.params), self.device)
        self._check_draft_layout()
        self.draft_cache = draft_mod.init_draft_pool(
            self.draft_cfg, self.n_slots, self.max_seq, self.gamma,
            device=self.device)
        self.stats_vec = torch.zeros(_N_HEAD + self.gamma + 2,
                                     dtype=torch.long, device=self.device)
        # which slots hold live requests and which of them draft, on the
        # host (the step's dispatch test) and on the device (its rows)
        self._host_draft = np.zeros(self.n_slots, bool)
        self._host_live = np.zeros(self.n_slots, bool)
        self._draft_rows = torch.zeros(self.n_slots, dtype=torch.bool,
                                       device=self.device)
        self._unsynced = False   # host positions lag a speculative step
        self._host_stats = None  # stats_vec as the last harvest read it
        self.spec_steps_run = 0

    def _check_draft_layout(self) -> None:
        """The draft's tree, leaf shapes and dtypes must be the draft
        architecture's, as transformer.init lays it out at K = 1 (built
        as fake tensors: no memory is allocated)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            tpl = tf.init(self.draft_cfg, device="cpu", members=1)
        want = [(p, tuple(x.shape), x.dtype) for p, x in _flatten(tpl)]
        got = [(p, tuple(x.shape), x.dtype)
               for p, x in _flatten(self.draft_params)]
        if [p for p, _, _ in want] != [p for p, _, _ in got]:
            raise ValueError(
                "draft params do not have the draft architecture's tree "
                "structure — pass draft_cfg matching the student")
        for (_, ws, wd), (_, gs, gd) in zip(want, got):
            if ws != gs or wd != gd:
                raise ValueError(
                    f"draft leaf {gs}/{gd} does not match the draft "
                    f"architecture's layout {ws}/{wd}")

    def _sync_each_step(self) -> bool:
        return True

    # -- host mirrors of the positions -------------------------------------

    def _resync(self, n_gen: np.ndarray) -> None:
        """After a speculative step every decoding row stands at plen +
        n_gen - 1: set the host positions so and hand back the pages past
        them (the verify pass's lookahead)."""
        self._unsynced = False
        if not self.paged:
            return
        for b in np.nonzero(self._host_active)[0]:
            if self._host_pos[b] < self._host_plen[b]:
                continue  # prefill owns this slot
            newpos = int(self._host_plen[b] + max(int(n_gen[b]), 1) - 1)
            self._host_pos[b] = newpos
            if self.allocator.truncate(int(b), newpos // self.page_size + 1):
                self._table_stale = True

    def _sync_host(self) -> None:
        if self._unsynced:
            self._resync(self.state.n_gen.cpu().numpy())

    def harvest_extra(self) -> torch.Tensor:
        return self.stats_vec

    @replayed
    def note_harvest(self, n_gen: np.ndarray,
                     extra: Optional[np.ndarray] = None) -> None:
        self._host_stats = extra
        if self._unsynced:
            self._resync(n_gen)

    # -- device work ---------------------------------------------------------

    def _tempered(self, fused, stoch, temp, topk) -> torch.Tensor:
        """Per-row tempered, top-k-masked target log-probs (B, C, V);
        rows with temperature <= 0 ride through raw."""
        B, C, V = fused.shape
        kk = torch.where(stoch, topk, 0).repeat_interleave(C)
        tt = temp.clamp_min(1e-6).repeat_interleave(C)
        m = sampling.top_k_mask_rows(fused.reshape(B * C, V), kk) \
            / tt[:, None]
        out = torch.log_softmax(m, dim=-1).reshape(B, C, V)
        return torch.where(stoch[:, None, None], out, fused)

    def _noise(self, st, stoch_h: np.ndarray):
        """Per-row draw noise for this iteration: Gumbel noise for the
        gamma draft draws (B, G, V), the acceptance uniforms (B, G) and
        the resample's Gumbel noise (B, V), from each stochastic row's
        own generators (one read of n_gen)."""
        B, G, V = self.n_slots, self.gamma, self.cfg.vocab_size
        dev = self.device
        gumbel = torch.zeros(B, G, V, device=dev)
        u = torch.zeros(B, G, device=dev)
        res = torch.zeros(B, V, device=dev)
        n_gen = st.n_gen.tolist()
        for b in np.nonzero(stoch_h)[0]:
            seed, n = self._host_seed[b], n_gen[b]
            gumbel[b] = _gumbel(_row_generator(seed, _SALT_DRAFT, n, dev),
                                (G, V), dev)
            u[b] = torch.rand(G, generator=_row_generator(
                seed, _SALT_ACCEPT, n, dev), device=dev)
            salt = _SALT_RESAMPLE if self._host_draft[b] else None
            res[b] = _gumbel(_row_generator(seed, salt, n, dev), (V,), dev)
        return gumbel, u, res

    def _spec_step(self) -> None:
        """One speculative iteration for every slot.  Rows mix freely:
        spec rows (live, decoding, drafting) draft and verify gamma+1
        positions; draft-off decoding rows verify one (the plain step);
        frozen rows (idle, mid-prompt, done) write nothing to the
        ensemble's pool (n_tok 0), and their draft-pool entries go back
        from the snapshot."""
        st = self.state
        B, G, C, K = self.n_slots, self.gamma, self.gamma + 1, \
            self.n_local
        dev = self.device
        adv = st.active & ~st.done & (st.pos >= st.prompt_len)
        spec_row = adv & self._draft_rows
        # snapshots before any write: the pool's next C entries a row,
        # and the draft pool's C entries at each row's OWN draft position
        # (frozen rows draft too, and a ring's wrapped write would land
        # on live history)
        snap = kv_cache.snapshot_positions(self.cache, st.pos, C)
        d_idx0 = self.draft_cache["idx"]
        d_start = d_idx0[0]
        dsnap = kv_cache.snapshot_positions(self.draft_cache, d_start, C)

        stoch_h = (self._host_temp > 0) if self.spec_sampling \
            else np.zeros(B, bool)
        sample = None
        if stoch_h.any():
            stoch = torch.as_tensor(stoch_h, device=dev)
            temp = torch.as_tensor(self._host_temp, device=dev)
            topk = torch.as_tensor(self._host_topk, device=dev)
            gumbel, u, res = self._noise(st, stoch_h)
            sample = (temp, topk, gumbel)

        # -- 1. draft
        chunk, draft_lp, self.draft_cache = draft_mod.propose(
            self.draft_params, self.draft_cfg, self.draft_cache, st.tok, G,
            sample=sample)

        # -- 2. verify: every member scores all C positions at once
        n_val = torch.where(spec_row, C, torch.where(adv, 1, 0)).int()
        verify = tf.verify_step_paged if self.paged else tf.verify_slots
        lg, _ = verify(self.params, self.cfg, self.cache, chunk, n_val)
        mlp = ens.member_log_probs(lg)                      # (K, B, C, V)
        fused = self._fuse(lg, member_lp=mlp)               # (B, C, V)
        choice = fused.argmax(dim=-1)
        prunable = ens.prunable_members(lg, fused, self._quorum_normalized(),
                                        member_lp=mlp)
        validp = spec_row[:, None] & (
            torch.arange(C, device=dev)[None, :] < n_val[:, None])
        pc = (prunable & validp[None]).sum()
        if self.mesh is not None:
            pc = shd.psum(pc, self.mesh, shd.MEMBER_AXIS)
        pt = self.n_members * validp.sum()

        # -- 3. accept
        a = verify_mod.greedy_accept(chunk[:, 1:], choice)
        emit_tok = choice
        if sample is not None:
            f_t = self._tempered(fused, stoch, temp, topk)
            a_s = verify_mod.stochastic_accept(u, chunk[:, 1:], f_t,
                                               draft_lp)
            a = torch.where(spec_row, torch.where(stoch, a_s, a), 0)
            # the first rejection resamples from the residual; a == G (all
            # drafts survived) draws the bonus token from the full target.
            # A draft-off row draws from its tempered fused position 0
            # with the plain path's noise, as the plain engine does
            V = fused.shape[-1]
            aa = a.clamp(0, G)
            p_a = f_t.gather(1, aa[:, None, None].expand(B, 1, V))[:, 0]
            q_a = draft_lp.gather(1, aa.clamp(max=G - 1)[:, None, None]
                                  .expand(B, 1, V))[:, 0]
            rep_lp = torch.where((a >= G)[:, None], p_a,
                                 verify_mod.residual_log_probs(p_a, q_a))
            plain = sampling.top_k_mask_rows(
                fused[:, 0], torch.where(stoch, topk, 0)) \
                / temp.clamp_min(1e-6)[:, None]
            repl = (torch.where(spec_row[:, None], rep_lp, plain)
                    + res).argmax(dim=-1)
            drafts = torch.cat([chunk[:, 1:], chunk.new_zeros(B, 1)], 1)
            ar = torch.arange(C, device=dev)[None, :]
            s_emit = torch.where(ar < a[:, None], drafts, repl[:, None])
            emit_tok = torch.where(stoch[:, None], s_emit, emit_tok)
        a = torch.where(spec_row, a, 0)

        # -- e: tokens consumed and emitted this iteration
        e = torch.minimum(a + 1, n_val.long().clamp_min(1))
        e = torch.minimum(e, (st.max_new - st.n_gen).clamp_min(1))
        if self.eos_id >= 0:
            is_eos = emit_tok == self.eos_id
            eos_pos = torch.where(is_eos.any(dim=1),
                                  is_eos.int().argmax(dim=1), C)
            e = torch.minimum(e, eos_pos + 1)     # stop at the first EOS
        e = torch.where(adv, e, 0)

        # -- bookkeeping: the plain step's, e tokens wide
        relp = torch.arange(st.out.shape[1], device=dev)[None, :] \
            - st.n_gen[:, None]
        take = (relp >= 0) & (relp < e[:, None])
        vals = emit_tok.gather(1, relp.clamp(0, C - 1))
        out = torch.where(take, vals, st.out)
        n_gen = st.n_gen + e
        last = emit_tok.gather(1, (e - 1).clamp(0, C - 1)[:, None])[:, 0]
        tok = torch.where(adv, last, st.tok)
        finished = adv & (n_gen >= st.max_new)
        if self.eos_id >= 0:
            finished |= adv & (last == self.eos_id)
        pos1 = st.pos + e

        # -- 4. rollback past the accepted prefix
        kv_cache.restore_positions(self.cache, snap, st.pos,
                                   torch.where(adv, e, 0))
        self.cache["idx"] = torch.where(adv, pos1, st.pos).to(
            self.cache["idx"].dtype)[None].expand(K, B).contiguous()
        kv_cache.restore_positions(self.draft_cache, dsnap, d_start,
                                   torch.where(spec_row, e, 0))
        self.draft_cache["idx"] = torch.where(
            spec_row[None], pos1.to(d_idx0.dtype)[None], d_idx0)

        # -- stats
        sp = spec_row.long()
        head = torch.stack([sp.sum() * G, ((e - 1) * sp).sum(),
                            torch.ones((), dtype=torch.long, device=dev),
                            pc, pt])
        hist = (torch.nn.functional.one_hot(e.clamp(0, G + 1), G + 2)
                * sp[:, None]).sum(dim=0)
        self.stats_vec += torch.cat([head, hist])
        self.state = st._replace(tok=tok, pos=pos1, n_gen=n_gen,
                                 done=st.done | finished, out=out)

    def _draft_prefill(self, b: int) -> None:
        """The main prefill's mirror over the K = 1 draft pool: up to
        prefill_chunk prompt tokens of slot b.  Runs before the main
        prefill (it reads the position before it advances); its logits
        are unused: the first generated token is the verifier's, and the
        draft consumes it at the next speculative step."""
        st = self.state
        C = self.prefill_chunk
        pos, plen = st.pos[b], st.prompt_len[b]
        need = st.active[b] & ~st.done[b] & (pos < plen)
        n_tok = torch.where(need, torch.clamp(plen - pos, max=C), 0)
        P = st.prompt.shape[1]
        cols = (pos + torch.arange(C, device=self.device)).clamp(0, P - 1)
        row = kv_cache.slot_row(self.draft_cache, b)
        _, row = tf.prefill_slots(self.draft_params, self.draft_cfg, row,
                                  st.prompt[b][cols][None],
                                  n_tok[None].int())
        kv_cache.write_slot_row(self.draft_cache, row, b)

    # -- host API ------------------------------------------------------------

    def _lookahead(self, b: int) -> int:
        """A drafting slot's step writes the whole gamma+1 chunk before
        acceptance is known (within its remaining budget); the pages past
        the accepted length go back once it is (_resync)."""
        if not self._host_draft[b]:
            return 1
        end = int(self._host_plen[b] + self._host_new[b]) - 1
        return max(min(self.gamma + 1, end - int(self._host_pos[b])), 1)

    @replayed
    def reserve_decode_pages(self) -> list:
        self._sync_host()
        return super().reserve_decode_pages()

    @replayed
    def step(self):
        """One speculative iteration when any live slot drafts; otherwise
        the inherited plain step, so an all-draft-off server runs the
        plain engine's steps."""
        self._sync_host()
        if not (self._host_draft & self._host_live).any():
            return super().step()
        if self.paged:
            starved = self.reserve_decode_pages()
            if starved:
                raise RuntimeError(
                    f"paged pool out of pages for decoding slots "
                    f"{starved} ({self.allocator.free_pages} free of "
                    f"{self.n_pages}); release finished slots or "
                    f"preempt (Scheduler.run does) before stepping")
        self._spec_step()
        self.steps_run += 1
        self.spec_steps_run += 1
        self._unsynced = self.paged
        self._host_stats = None
        return self.state

    @replayed
    def prefill(self, slot: int):
        b = int(slot)
        if 0 <= b < self.n_slots and self._host_draft[b]:
            if self.paged and self._table_stale:
                self._sync_table()
            self._draft_prefill(b)
        return super().prefill(slot)

    @replayed
    def update_slots(self, release: Sequence[int] = (),
                     admits: Sequence[tuple] = ()) -> dict:
        """The base engine's; an admission drafts unless its options say
        {"draft": False}."""
        norm = []
        for entry in admits:
            opts = dict(entry[3]) if len(entry) > 3 and entry[3] else {}
            opts.setdefault("draft", True)
            if not isinstance(opts["draft"], (bool, np.bool_)):
                raise ValueError(f"draft must be a bool, got "
                                 f"{opts['draft']!r}")
            norm.append((entry[0], entry[1], entry[2], opts))
        hits = super().update_slots(release=release, admits=norm)
        adm = np.zeros(self.n_slots, bool)
        for b in release:
            self._host_draft[int(b)] = self._host_live[int(b)] = False
        for b, _, _, opts in norm:
            self._host_draft[int(b)] = bool(opts["draft"])
            self._host_live[int(b)] = adm[int(b)] = True
        self._draft_rows = torch.as_tensor(self._host_draft,
                                           device=self.device)
        if adm.any():
            kv_cache.reset_slots(self.draft_cache,
                                 torch.as_tensor(adm, device=self.device))
        return hits

    def spec_stats(self) -> dict:
        """Acceptance and pruning telemetry: from the Scheduler's last
        harvest read where no step has run since, else one device read.
        accepted_len counts the tokens a speculative iteration emits
        (accepted drafts plus the verifier's own), e in [1, gamma+1];
        acceptance_rate is accepted / proposed drafts; pruned_frac the
        share of (member, position) votes that could not flip the fused
        argmax."""
        v = (self._host_stats if self._host_stats is not None
             else self.stats_vec.cpu().numpy()).astype(np.float64)
        proposed, accepted, steps, pc, pt = v[:_N_HEAD]
        hist = v[_N_HEAD:]
        tot = hist.sum()
        lens = np.arange(self.gamma + 2, dtype=np.float64)
        p50 = (float(np.argmax(np.cumsum(hist) >= (tot + 1) / 2.0))
               if tot > 0 else 0.0)
        return {
            "gamma": self.gamma,
            "spec_steps": int(steps),
            "proposed": int(proposed),
            "accepted": int(accepted),
            "acceptance_rate": float(accepted / proposed)
            if proposed > 0 else 0.0,
            "mean_accepted_len": float((hist * lens).sum() / tot)
            if tot > 0 else 0.0,
            "accepted_len_p50": p50,
            "pruned_frac": float(pc / pt) if pt > 0 else 0.0,
            "emitted_hist": [int(x) for x in hist],
        }
