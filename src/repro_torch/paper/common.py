"""Shared harness of the paper's experiments on the port: the twin of
the JAX package's benchmarks/common.py.

`make_data` draws the synthetic CIFAR-100 stand-in from a torch
generator (data/synthetic.py), so its numbers differ from the JAX
package's jax.random draws; `make_trainer` also takes numpy data and a
numpy tree of member-stacked params, so that a test can hand both
packages the same arrays.  Everything runs on the card unless `device`
says otherwise (`--device cpu` on the command line).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.device import DeviceLike
from repro_torch.common.tree import tree_map
from repro_torch.common.types import ECConfig, ModelConfig
from repro_torch.data import image_member_datasets
from repro_torch.optim import sgd_momentum
from repro_torch.runtime.trainer import Trainer


def cnn_cfg() -> ModelConfig:
    return ModelConfig(name="nin-bench", family="cnn", n_layers=9,
                       d_model=96, vocab_size=20)


def as_tensors(tree):
    """A tree's numpy leaves as tensors of their own (tensors pass
    through); the Trainer moves them to its device."""
    return tree_map(lambda a: a if torch.is_tensor(a)
                    else torch.tensor(np.asarray(a)), tree)


def make_trainer(aggr: str, K: int, tau: int, init_seed: int, train, test,
                 label_mode: str = "dense", lr: float = 0.05,
                 seed: int = 0, params=None,
                 device: DeviceLike = None) -> Trainer:
    """train / test: tensors or numpy arrays; params: None (torch-seeded
    from init_seed) or a numpy tree of K members' params."""
    cfg = cnn_cfg()
    ec = ECConfig(tau=tau, lam=0.5, p_steps=max(tau // 2, 1),
                  relabel_fraction=0.7, label_mode=label_mode,
                  aggregator=aggr)
    return Trainer(cfg, ec, sgd_momentum(lr, momentum=0.9), K, init_seed,
                   as_tensors(train), as_tensors(test),
                   batch_size=32, seed=seed, params=params, device=device)


def make_data(seed: int, K: int, per_member: int = 512,
              n_classes: int = 20, img: int = 16,
              device: DeviceLike = None):
    return image_member_datasets(K, per_member, n_classes=n_classes,
                                 img=img, noise=0.6, seed=seed,
                                 device=device)


def std_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--fast", action="store_true",
                    help="CI-sized run (fewer rounds/steps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    return ap


class Timer:
    """Seconds since construction, on the host's clock; on the card it
    first waits for the device, so the time covers the work queued."""

    def __init__(self, device: DeviceLike = "cpu"):
        self.device = torch.device(device)
        self.t0 = time.time()

    def __call__(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time() - self.t0
