"""The EC-DNN trainer: rounds of (local SGD -> aggregate -> distill).

Algorithm 1 of the paper, generalized over aggregator:

  aggregator="ec"   tau local steps; relabel a fraction of D_k with the
                    ensemble (allgather protocol); the next round's
                    first p steps minimize Eqn 9 with lambda annealing
                    to 0 (the fused distillation kernel on the card).
  aggregator="ma"   tau local steps; params <- mean_k params (MA-DNN).
  aggregator="sync" every step means the gradients over the member axis
                    (sync-SGD reference).

State is member-stacked (leading K) under the JAX package's layout,
{"params": ..., "opt": {"mu", "step"}}, on one device: the card unless
`device` says otherwise.  The host draws every index with the same numpy
calls as the JAX Trainer, so the two, seeded alike and started from the
same params (`params=`), train on the same batches.  A round waits for
the card once, for its last loss.

Straggler policy: members listed as lagging at aggregation time are
excluded from the ensemble (and from the MA mean) via a (K,) quorum mask.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import models
from repro_torch.bridge import params_from_numpy
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

    train_shards {images (K, n, H, W, C), labels (K, n) int32} and
    test_set {images (n_test, H, W, C), labels (n_test,)} are tensors,
    moved to the trainer's device.  `params`: a numpy tree of
    member-stacked params (e.g. the JAX package's init, fetched with
    jax.device_get) to start from; else torch-seeded from init_seed."""

    def __init__(self, cfg: ModelConfig, ec: ECConfig, opt: Optimizer,
                 n_members: int, init_seed: int, train_shards: dict,
                 test_set: dict, batch_size: int, mesh=None,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 params=None, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device training is not ported yet (ROADMAP queue 1 "
                "item 12)")
        if ckpt_dir is not None:
            raise NotImplementedError(
                "checkpoints are not ported yet (ROADMAP queue 1 item 7)")
        if ec.label_mode != "dense":
            raise NotImplementedError(
                f"label_mode={ec.label_mode!r} needs core/compression.py, "
                f"not ported yet (ROADMAP queue 1 item 6)")
        if ec.aggregator not in ("ec", "ma", "sync"):
            raise ValueError(f"unknown aggregator {ec.aggregator!r}")
        self.cfg, self.ec, self.opt = cfg, ec, opt
        self.K = n_members
        self.device = resolve_device(device)
        self.shards = tree_map(lambda a: a.to(self.device), train_shards)
        self.test = tree_map(lambda a: a.to(self.device), test_set)
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        self.metrics = TrainerMetrics()
        self.pseudo_buffer = None  # (subset_batch, pseudo_targets)
        self.round = 0

        if params is None:
            params = models.init(cfg, seed=init_seed, device=self.device,
                                 members=n_members)
        else:
            params = params_from_numpy(params, self.device)
        if tree_leaves(params)[0].shape[0] != n_members:
            raise ValueError(f"params are stacked over "
                             f"{tree_leaves(params)[0].shape[0]} members, "
                             f"want {n_members}")
        self.state = {"params": params, "opt": opt.init(params)}

        self._logits = steps.make_logits_fn(cfg)
        self._member_loss = steps.make_member_loss(cfg)
        self._plain_step = steps.make_local_step(cfg, opt)
        self._sync_step = steps.make_local_step(cfg, opt, sync=True)

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------

    def _relabel(self, quorum: Optional[torch.Tensor] = None) -> None:
        """Relabel relabel_fraction of each member's shard -> pseudo
        buffer."""
        subset, _ = sample_relabel_subset(self.rng, self.shards,
                                          self.ec.relabel_fraction)
        pseudo = agg.allgather_relabel(self.state["params"], subset,
                                       self._logits, self.ec, quorum=quorum)
        self.pseudo_buffer = (subset, pseudo)

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
                batch, pseudo = self._sample_pseudo_batch()
                self.state, loss = self._plain_step(self.state, batch,
                                                    pseudo, lams[t])
            else:
                batch = sample_batch(self.rng, self.shards, self.batch)
                step = self._sync_step if ec.aggregator == "sync" \
                    else self._plain_step
                self.state, loss = step(self.state, batch, None, 0.0)

        quorum = None
        if straggler_mask is not None:
            quorum = torch.as_tensor(np.asarray(straggler_mask),
                                     dtype=torch.float32, device=self.device)
        if ec.aggregator == "ec":
            self._relabel(quorum)
        elif ec.aggregator == "ma":
            self.state = {"params": agg.ma_aggregate(self.state["params"],
                                                     quorum),
                          "opt": self.state["opt"]}
        self.round += 1
        return float(loss)

    def _sample_pseudo_batch(self):
        subset, pseudo = self.pseudo_buffer
        n = tree_leaves(subset)[0].shape[1]
        idx = self.rng.integers(0, n, size=(self.K, self.batch))
        return take_rows((subset, pseudo), idx)

    # ------------------------------------------------------------------
    # evaluation / reporting (paper Figures 1-3, Table 1)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _eval_members(self, params, test_b: dict):
        K = tree_leaves(params)[0].shape[0]
        images = test_b["images"][None].expand(K, *test_b["images"].shape)
        logits = self._logits(params, {"images": images})
        labels = test_b["labels"]
        member_nll = ens.mean_member_nll(logits, labels)
        ens_nll = ens.ensemble_nll(logits, labels)
        member_err = (logits.argmax(-1) != labels[None]).float().mean()
        ens_err = (ens.ensemble_probs(logits).argmax(-1) != labels) \
            .float().mean()
        return member_nll, ens_nll, member_err, ens_err

    def _test_batch(self) -> dict:
        return {k: v[:EVAL_ROWS] for k, v in self.test.items()}

    def evaluate(self, record: bool = True) -> Dict[str, float]:
        test_b = self._test_batch()
        m_nll, e_nll, m_err, e_err = self._eval_members(
            self.state["params"], test_b)
        out = {"local_loss": float(m_nll), "global_loss": float(e_nll),
               "local_err": float(m_err), "global_err": float(e_err)}
        if self.ec.aggregator == "ma":
            avg = agg.ma_aggregate(self.state["params"])
            one = tree_map(lambda x: x[:1], avg)
            with torch.no_grad():
                logits = self._logits(one, {"images": test_b["images"][None]})
            nll = distill.true_ce(logits[0], test_b["labels"])
            err = (logits[0].argmax(-1) != test_b["labels"]).float().mean()
            out["global_loss"], out["global_err"] = float(nll), float(err)
        if record:
            self.metrics.round_idx.append(self.round)
            self.metrics.local_loss.append(out["local_loss"])
            self.metrics.global_loss.append(out["global_loss"])
            self.metrics.local_err.append(out["local_err"])
            self.metrics.global_err.append(out["global_err"])
        return out

    def evaluate_compressed(self) -> Dict[str, float]:
        """After distill steps, members ARE the compressed models."""
        m_nll, _, m_err, _ = self._eval_members(self.state["params"],
                                                self._test_batch())
        out = {"compressed_loss": float(m_nll),
               "compressed_err": float(m_err)}
        self.metrics.compressed_loss.append(out["compressed_loss"])
        self.metrics.compressed_err.append(out["compressed_err"])
        return out

    @torch.no_grad()
    def best_member(self):
        """EC-DNN_L: the member with smallest training loss.
        -> (its params without the member axis, its index)."""
        batch = sample_batch(self.rng, self.shards, min(self.batch, 64))
        params = self.state["params"]
        losses = torch.stack([
            self._member_loss(tree_map(lambda x: x[k:k + 1], params),
                              tree_map(lambda x: x[k:k + 1], batch),
                              None, 0.0)
            for k in range(self.K)])
        k = int(torch.argmin(losses))
        return tree_map(lambda x: x[k], params), k

    def reshard(self, k_new: int):
        raise NotImplementedError(
            "elastic K needs checkpoint.reshard_members, not ported yet "
            "(ROADMAP queue 1 item 7)")
