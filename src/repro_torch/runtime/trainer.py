"""The EC-DNN trainer: rounds of (local SGD -> aggregate -> distill).

Algorithm 1 of the paper, generalized over aggregator:

  aggregator="ec"   tau local steps; relabel a fraction of D_k with the
                    ensemble (ring or allgather protocol); the next round's
                    first p steps minimize Eqn 9 with lambda annealing
                    to 0 (the fused distillation kernel on the card).
  aggregator="ma"   tau local steps; params <- mean_k params (MA-DNN).
  aggregator="sync" every step means the gradients over the member axis
                    (sync-SGD reference).

The members are the paper's NiN (images) or a transformer (tokens:
attention, rwkv6's recurrence, jamba's hybrid of Mamba and MoE); pseudo-labels are dense probs or, at LM vocabularies, top-M
accumulators (ECConfig.label_mode "topk").  State is member-stacked
(leading K) under the JAX package's layout, {"params": ..., "opt": ...},
on one device: the card unless `device` says otherwise.  The host draws
every index with the same numpy calls as the JAX Trainer, so the two,
seeded alike and started from the same params (`params=`), train on the
same batches.  A round waits for the card once, for its last loss.
The relabel, `evaluate` and `best_member` score member by member and
chunk by chunk (core/aggregation.stream_logits): at gemma3's vocabulary
K members' logits over the test set would not fit beside the state.

Over a mesh (common/sharding.local_mesh, one process a rank) the K
members lie along the dim `ec_axis()` names ("data", as in the JAX
package): a rank holds its K/M members, their shards, their optimizer
state and its slice of the quorum.  The ranks along the mesh's other dim
(data parallelism within a member) hold the same members, and each takes
an equal share of every member's batch rows, of the relabel's rows and
of evaluate()'s test rows; gradients are averaged over that dim before
the optimizer's clip and step (aggregation.psum_gradients), so the
replicas of a member stay bit for bit equal, and the relabel's targets
are gathered back over it.  Every rank draws the host's indices for all
K members and every row and takes its own, so the batches are the
single-process trainer's.  The relabel takes the ring
(aggregation.ring_relabel, one member a rank) when ECConfig.protocol is
"ring" and K > 1, else the all-gather; MA and sync all-reduce;
evaluate() fuses the ensemble across ranks chunk by chunk; save()
gathers the state to the first rank, which writes the single-process
layout, and resume() sends each rank its rows back.  A model that
routes tokens by pool (a MoE) pools each rank's share of the rows.

Fault tolerance: with ckpt_dir, every round ends with an async save of
the state (checkpoint/store.py: the JAX package's layout, keep 3), and
`resume()` restores the newest committed round; `reshard(k_new)` changes
K between rounds, over a mesh too.

Straggler policy: members listed as lagging at aggregation time are
excluded from the ensemble (and from the MA mean) via a (K,) quorum mask.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import models
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager, reshard_members
from repro_torch.common import sharding as shd
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.common.types import ECConfig, ModelConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import distill
from repro_torch.core import ensemble as ens
from repro_torch.data import sample_batch, sample_relabel_subset, take_rows
from repro_torch.optim import Optimizer
from repro_torch.runtime import steps

EVAL_ROWS = 256  # test rows evaluate() scores, as in the JAX package


@dataclasses.dataclass
class TrainerMetrics:
    round_idx: List[int] = dataclasses.field(default_factory=list)
    local_loss: List[float] = dataclasses.field(default_factory=list)
    global_loss: List[float] = dataclasses.field(default_factory=list)
    compressed_loss: List[float] = dataclasses.field(default_factory=list)
    local_err: List[float] = dataclasses.field(default_factory=list)
    global_err: List[float] = dataclasses.field(default_factory=list)
    compressed_err: List[float] = dataclasses.field(default_factory=list)


class Trainer:
    """K-member EC-DNN / MA-DNN / sync-SGD trainer on one device.

    train_shards {images (K, n, H, W, C) | tokens (K, n, T), labels (K,
    n[, T]) int32} and test_set {images (n_test, H, W, C) | tokens
    (n_test, T), labels (n_test[, T])} are tensors, moved to the
    trainer's device.  `params`: a numpy tree of member-stacked params
    (e.g. the JAX package's init, fetched with jax.device_get) to start
    from; else torch-seeded from init_seed.  grad_accum splits each
    step's batch into that many microbatches.

    mesh: a DeviceMesh whose ec_axis() dim holds the members and whose
    other dim, where it has more than one rank, splits every member's
    rows (local_mesh(D, M): M member ranks, D data ranks each).  Every
    rank is given the global shards and params and keeps its rows; K
    stays the global count and K_local is this rank's.  Raises where a
    member's batch, relabel rows or test rows do not split evenly over
    the data ranks, and where data ranks would split a MoE model's
    token pool (steps.routes_by_pool: its capacity, and so the tokens
    it drops, depends on the rows of a call)."""

    def __init__(self, cfg: ModelConfig, ec: ECConfig, opt: Optimizer,
                 n_members: int, init_seed: int, train_shards: dict,
                 test_set: dict, batch_size: int, mesh=None,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 params=None, device: DeviceLike = None,
                 grad_accum: int = 1):
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a DeviceMesh "
                            f"(common.sharding.local_mesh), got "
                            f"{type(mesh).__name__}")
        if ec.label_mode not in ("dense", "topk"):
            raise ValueError(f"unknown label_mode {ec.label_mode!r}")
        if ec.aggregator not in ("ec", "ma", "sync"):
            raise ValueError(f"unknown aggregator {ec.aggregator!r}")
        self.cfg, self.ec, self.opt = cfg, ec, opt
        self.K = n_members
        self.mesh = mesh
        self._rows = slice(0, n_members)
        self._dp = None        # the mesh dim of data ranks within a member
        if mesh is not None:
            axis = self.ec_axis()
            rest = [n for n in mesh.mesh_dim_names if n != axis
                    and shd.axis_size(mesh, n) > 1]
            self._dp = rest[0] if rest else None
            if self._dp and steps.routes_by_pool(cfg):
                raise ValueError(
                    f"{cfg.name} routes each call's tokens as one MoE pool, "
                    f"which the {shd.axis_size(mesh, self._dp)} data ranks "
                    f"along {self._dp!r} would split: give each member "
                    f"one rank")
            self._rows = shd.member_rows(n_members, mesh, axis)
            self._check_ring(n_members)
        self.K_local = self._rows.stop - self._rows.start
        self._leader = mesh is None or shd.is_leader(mesh)
        self.device = resolve_device(device)
        self.shards = tree_map(lambda a: a[self._rows].to(self.device),
                               train_shards)
        self.test = tree_map(lambda a: a.to(self.device), test_set)
        self.batch = batch_size
        self._share = self._split(batch_size, "batch rows")
        if ec.aggregator == "ec":
            n = tree_leaves(train_shards)[0].shape[1]
            self._split(max(1, int(n * ec.relabel_fraction)),
                        "relabel rows")
        self._eval_share = self._split(
            min(EVAL_ROWS, tree_leaves(test_set)[0].shape[0]), "test rows")
        self.rng = np.random.default_rng(seed)
        self.metrics = TrainerMetrics()
        self.ckpt = CheckpointManager(ckpt_dir, keep=3) \
            if ckpt_dir and self._leader else None
        self._saves = bool(ckpt_dir)
        self.pseudo_buffer = None  # (subset_batch, pseudo_targets)
        self.round = 0

        if params is None:
            params = models.init(cfg, seed=init_seed, device=self.device,
                                 members=n_members)
            if mesh is not None:
                params = tree_map(lambda x: x[self._rows].clone(), params)
        else:
            if mesh is not None:
                params = _np_rows(params, self._rows)
            params = params_from_numpy(params, self.device)
        if tree_leaves(params)[0].shape[0] != self.K_local:
            raise ValueError(f"params are stacked over "
                             f"{tree_leaves(params)[0].shape[0]} members, "
                             f"want {n_members}")
        self.state = {"params": params, "opt": opt.init(params)}

        self._logits = steps.make_logits_fn(cfg)
        self._pooled = steps.routes_by_pool(cfg)
        self._row_floats = models.activation_floats(cfg, params,
                                                    self.shards)
        self._member_loss = steps.make_member_loss(cfg)
        self._plain_step = steps.make_local_step(
            cfg, opt, grad_accum, mesh=mesh, data_axis=self._dp)
        self._sync_step = steps.make_local_step(
            cfg, opt, grad_accum, sync=True, mesh=mesh, axis=self.ec_axis(),
            data_axis=self._dp)

    def ec_axis(self) -> str:
        """The mesh dim the members (and the ring) lie along."""
        return "data"

    def _check_ring(self, k: int) -> None:
        """The ring holds one member a rank: its axis must have k ranks."""
        axis = self.ec_axis()
        if self.ec.aggregator == "ec" and self.ec.protocol == "ring" \
                and k > 1 and shd.axis_size(self.mesh, axis) != k:
            raise ValueError(
                f"the ring holds one member a rank, but {k} members lie on "
                f"{shd.axis_size(self.mesh, axis)} ranks along {axis!r}: "
                f"use protocol='allgather'")

    def _split(self, n: int, what: str) -> slice:
        """This rank's share of n rows over the data ranks (all of them
        without).  Raises unless they split evenly."""
        if self._dp is None:
            return slice(0, n)
        D = shd.axis_size(self.mesh, self._dp)
        if n % D:
            raise ValueError(f"{n} {what} a member do not split over the "
                             f"{D} data ranks along {self._dp!r}")
        d = shd.axis_index(self.mesh, self._dp)
        return slice(d * (n // D), (d + 1) * (n // D))

    def _gather_rows(self, tree):
        """The data ranks' shares (K_local, n / D, ...) of every leaf ->
        (K_local, n, ...) on each of them, in rank order."""
        if self._dp is None:
            return tree

        def one(x):
            parts = shd.all_gather(x, self.mesh, self._dp)
            return parts.movedim(0, 1).flatten(1, 2)
        return tree_map(one, tree)

    @property
    def _of(self):
        """(K, this rank's rows): the host draws for all K members."""
        return (self.K, self._rows)

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------

    def _relabel(self, quorum: Optional[torch.Tensor] = None) -> None:
        """Relabel relabel_fraction of each member's shard -> pseudo
        buffer.  quorum: the global (K,) mask."""
        subset, _ = sample_relabel_subset(self.rng, self.shards,
                                          self.ec.relabel_fraction,
                                          of=self._of)
        share = self._split(tree_leaves(subset)[0].shape[1], "relabel rows")
        mine = tree_map(lambda x: x[:, share], subset)
        kw = dict(quorum=quorum, n_out=self.cfg.vocab_size,
                  pooled=self._pooled, row_floats=self._row_floats)
        if self.mesh is not None and self.ec.protocol == "ring" \
                and self.K > 1:
            pseudo = agg.ring_relabel(self.mesh, self.state["params"],
                                      mine, self._logits, self.ec,
                                      axis=self.ec_axis(), **kw)
        else:
            pseudo = agg.allgather_relabel(self.state["params"], mine,
                                           self._logits, self.ec,
                                           mesh=self.mesh,
                                           axis=self.ec_axis(), **kw)
        self.pseudo_buffer = (subset, self._gather_rows(pseudo))

    # ------------------------------------------------------------------
    # round loop
    # ------------------------------------------------------------------

    def run_round(self, straggler_mask: Optional[np.ndarray] = None
                  ) -> float:
        """One full round: tau local steps (the first p mixed if a pseudo
        buffer exists), then aggregation per the configured method.
        -> the last step's mean loss over members."""
        ec = self.ec
        lams = None
        for t in range(ec.tau):
            if ec.aggregator == "ec" and self.pseudo_buffer is not None \
                    and t < ec.p_steps:
                if lams is None:  # the whole schedule, on the device
                    lams = distill.lam_schedule(
                        torch.arange(ec.p_steps, device=self.device),
                        ec.lam, ec.p_steps)
                batch, pseudo = self._mine(self._sample_pseudo_batch())
                self.state, loss = self._plain_step(self.state, batch,
                                                    pseudo, lams[t])
            else:
                batch = self._mine(sample_batch(self.rng, self.shards,
                                                self.batch, of=self._of))
                step = self._sync_step if ec.aggregator == "sync" \
                    else self._plain_step
                self.state, loss = step(self.state, batch, None, 0.0)
        if self.mesh is not None:  # the mean over all K members and rows
            for axis in (self.ec_axis(), self._dp):
                if axis is not None:
                    loss = shd.pmean(loss, self.mesh, axis)

        quorum = None
        if straggler_mask is not None:
            quorum = torch.as_tensor(np.asarray(straggler_mask),
                                     dtype=torch.float32, device=self.device)
        if ec.aggregator == "ec":
            self._relabel(quorum)
        elif ec.aggregator == "ma":
            self.state = {"params": agg.ma_aggregate(
                self.state["params"],
                None if quorum is None else quorum[self._rows],
                mesh=self.mesh, axis=self.ec_axis()),
                "opt": self.state["opt"]}
        self.round += 1
        if self._saves:
            self._save_state(wait=False)
        return float(loss)

    def _mine(self, tree):
        """This rank's share of every member's batch rows."""
        if self._dp is None:
            return tree
        return tree_map(lambda x: x[:, self._share], tree)

    def _sample_pseudo_batch(self):
        """A batch of the relabelled subset and its pseudo-labels (dense
        or TopM), by the JAX Trainer's one numpy draw."""
        subset, pseudo = self.pseudo_buffer
        n = tree_leaves(subset)[0].shape[1]
        idx = self.rng.integers(0, n, size=(self.K, self.batch))
        return take_rows((subset, pseudo), idx[self._rows])

    # ------------------------------------------------------------------
    # evaluation / reporting (paper Figures 1-3, Table 1)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _eval_members(self, params, test_b: dict, mesh=None):
        """-> (mean member NLL, ensemble NLL, mean member error, ensemble
        error) on test_b, shared by the members; as the JAX package's
        eval, scored a chunk and a member at a time.  A MoE model routes
        a member's test rows as one token pool, as the JAX package does:
        where their logits pass CHUNK_BYTES (full-width jamba: 64 of the
        256 rows a chunk), its chunks are pieces of that pool.  With a
        mesh, params are this rank's members: each chunk's ensemble sum
        is all-reduced over the members' axis before it is read, and the
        data ranks score their shares of the rows, summed after."""
        Kl = tree_leaves(params)[0].shape[0]
        K, lo = Kl, 0
        dp = self._dp if mesh is not None else None
        if mesh is not None:
            K = Kl * shd.axis_size(mesh, self.ec_axis())
            lo = shd.axis_index(mesh, self.ec_axis()) * Kl
        if dp is not None:
            test_b = {k: v[self._eval_share] for k, v in test_b.items()}
        labels = test_b["labels"]
        m_nll = m_err = e_nll = e_err = 0.0
        pool = labels.shape[0] if self._pooled else None
        for sl, k, logits in agg.stream_logits(
                params, test_b, self._logits, self.cfg.vocab_size,
                fold=True, pool_rows=pool, row_floats=self._row_floats):
            y = labels[sl]
            m_nll = m_nll + ens.member_nll(logits, y).sum()
            m_err = m_err + (logits.argmax(-1) != y).sum()
            if k == 0:
                fused = ens.StreamingEnsemble(K, device=self.device)
            fused.add(lo + k, logits)
            if k == Kl - 1:
                p = fused.probs() if mesh is None else \
                    shd.psum(fused.acc, mesh, self.ec_axis())
                e_nll = e_nll + ens.gold_nll(p, y).sum()
                e_err = e_err + (p.argmax(-1) != y).sum()
        n = labels.numel()
        if mesh is not None:
            sums = torch.stack([torch.as_tensor(x, device=self.device)
                                .float() for x in (m_nll, m_err)])
            sums = shd.psum(sums, mesh, self.ec_axis())
            if dp is not None:
                sums = shd.psum(torch.cat([sums, torch.stack([
                    torch.as_tensor(x, device=self.device).float()
                    for x in (e_nll, e_err)])]), mesh, dp)
                e_nll, e_err = sums[2], sums[3]
                n *= shd.axis_size(mesh, dp)
            m_nll, m_err = sums[0], sums[1]
        return m_nll / (K * n), e_nll / n, m_err / (K * n), e_err / n

    def _test_batch(self) -> dict:
        return {k: v[:EVAL_ROWS] for k, v in self.test.items()}

    def evaluate(self, record: bool = True) -> Dict[str, float]:
        test_b = self._test_batch()
        m_nll, e_nll, m_err, e_err = self._eval_members(
            self.state["params"], test_b, self.mesh)
        out = {"local_loss": float(m_nll), "global_loss": float(e_nll),
               "local_err": float(m_err), "global_err": float(e_err)}
        if self.ec.aggregator == "ma":
            one = tree_map(lambda x: x[:1], agg.ma_aggregate(
                self.state["params"], mesh=self.mesh, axis=self.ec_axis()))
            out["global_loss"], out["global_err"] = self.evaluate_model(one)
        if record:
            self.metrics.round_idx.append(self.round)
            self.metrics.local_loss.append(out["local_loss"])
            self.metrics.global_loss.append(out["global_loss"])
            self.metrics.local_err.append(out["local_err"])
            self.metrics.global_err.append(out["global_err"])
        return out

    def evaluate_model(self, params) -> Tuple[float, float]:
        """-> (NLL, error) of one model on evaluate()'s test rows:
        `params` stacked over one member, e.g. row 0 of the members'
        parameter average (the JAX Trainer's _single_eval)."""
        nll, _, err, _ = self._eval_members(params, self._test_batch())
        return float(nll), float(err)

    def evaluate_compressed(self) -> Dict[str, float]:
        """After distill steps, members ARE the compressed models."""
        m_nll, _, m_err, _ = self._eval_members(self.state["params"],
                                                self._test_batch(), self.mesh)
        out = {"compressed_loss": float(m_nll),
               "compressed_err": float(m_err)}
        self.metrics.compressed_loss.append(out["compressed_loss"])
        self.metrics.compressed_err.append(out["compressed_err"])
        return out

    @torch.no_grad()
    def best_member(self):
        """EC-DNN_L: the member with smallest training loss, of all K.
        -> (its params without the member axis, its index); over a mesh
        the params are on the rank that holds the member (None
        elsewhere)."""
        batch = sample_batch(self.rng, self.shards, min(self.batch, 64),
                             of=self._of)
        params = self.state["params"]
        losses = torch.stack([
            self._member_loss(tree_map(lambda x: x[k:k + 1], params),
                              tree_map(lambda x: x[k:k + 1], batch),
                              None, 0.0)
            for k in range(self.K_local)])
        if self.mesh is not None:
            losses = shd.all_gather(losses, self.mesh,
                                    self.ec_axis()).reshape(-1)
        k = int(torch.argmin(losses))
        if not self._rows.start <= k < self._rows.stop:
            return None, k
        return tree_map(lambda x: x[k - self._rows.start], params), k

    # ------------------------------------------------------------------
    # fault tolerance / elasticity
    # ------------------------------------------------------------------

    def _save_state(self, wait: bool) -> None:
        """Write the state at this round (over a mesh, gathered to the
        first rank, which writes the single-process layout)."""
        state = self.state
        if self.mesh is not None:
            state = tree_map(
                lambda x: shd.gather_rows(x, self.mesh, self.ec_axis()),
                state)
        if self.ckpt is not None:
            self.ckpt.save(self.round, state)
            if wait:
                self.ckpt.wait()

    def save(self) -> None:
        if self._saves:
            self._save_state(wait=True)

    def resume(self) -> bool:
        """Restore the newest committed round, if any: the state, and
        `round`; the pseudo buffer is dropped (the next round boundary
        relabels).  The host's index generator is not checkpointed, as in
        the JAX package.  Over a mesh the first rank reads the state and
        sends each rank its rows."""
        if not self._saves:
            return False
        latest = self.ckpt.latest() if self.ckpt is not None else None
        if self.mesh is not None:
            latest = shd.broadcast_object(latest, self.mesh)
        if latest is None:
            return False
        if self.mesh is None:
            self.state = self.ckpt.restore(self.state, latest)
        else:
            full = None
            if self.ckpt is not None:
                template = tree_map(lambda x: torch.empty(
                    (self.K, *x.shape[1:]), dtype=x.dtype), self.state)
                full = self.ckpt.restore(template, latest)
            live = tree_leaves(self.state)
            got = tree_leaves(full) if full is not None \
                else [None] * len(live)
            for x, out in zip(got, live):
                shd.send_rows(x, out, self.mesh, self.ec_axis())
        self.round = latest
        self.pseudo_buffer = None
        return True

    def reshard(self, k_new: int,
                generator: Optional[torch.Generator] = None) -> None:
        """K -> k_new members (store.reshard_members): grown members copy
        the first ones, their params perturbed by 1e-3 * N(0, 1) when a
        generator is given (the JAX Trainer perturbs with a key, and then
        its AdamW moments too, where noise makes v negative); the
        shards follow.  The steps read K from the state: nothing to
        rebuild.  Over a mesh every rank gathers each leaf's K rows (on
        the host under gloo), reshards them with its generator, which
        must be seeded alike on every rank (the grown members' noise is
        then the same everywhere, and a single process's), and keeps its
        rows of k_new; raises unless the members' axis divides k_new, and
        for a ring past one member a rank."""
        if self.mesh is None:
            self.state = {"params": reshard_members(
                self.state["params"], k_new, perturb=1e-3,
                generator=generator),
                "opt": reshard_members(self.state["opt"], k_new)}
            self.shards = reshard_members(self.shards, k_new)
            rows = slice(0, k_new)
        else:
            self._check_ring(k_new)
            axis = self.ec_axis()
            rows = shd.member_rows(k_new, self.mesh, axis)

            def one(x, perturb=0.0):
                full = shd.gather_all_rows(x, self.mesh, axis)
                out = reshard_members(full, k_new, perturb=perturb,
                                      generator=generator)
                return out[rows].to(x.device, copy=True)
            # leaf by leaf in place, each old leaf freed as its new one
            # lands: the old and the new state are never both whole
            _replace_leaves(self.state["params"], lambda x: one(x, 1e-3))
            _replace_leaves(self.state["opt"], one)
            _replace_leaves(self.shards, one)
        self.K = k_new
        self._rows = rows
        self.K_local = rows.stop - rows.start
        self.pseudo_buffer = None


def _replace_leaves(tree, fn) -> None:
    """Every leaf x of a tree of dicts and lists replaced by fn(x), in
    place, in tree_map's order."""
    for k in (tree.keys() if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list)):
            _replace_leaves(tree[k], fn)
        else:
            tree[k] = fn(tree[k])


def _np_rows(tree, rows: slice):
    """Rows `rows` of every leaf of a numpy tree."""
    if isinstance(tree, dict):
        return {k: _np_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_rows(v, rows) for v in tree)
    return np.asarray(tree)[rows]
