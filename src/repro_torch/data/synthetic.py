"""Deterministic synthetic image data with learnable structure.

The faithful CIFAR-100 experiment runs on a synthetic stand-in with the
same shape contract (32x32x3, 100 classes) and genuine class structure:
class prototypes + Gaussian noise + random horizontal flips (the paper's
only augmentation).  Each ensemble member holds a disjoint shard, like
the paper's random partition of the training set.  The draws come from a
torch.Generator on the target device, so the numbers differ from the
JAX package's jax.random draws; tests hand both packages the same numpy
arrays instead.

`sample_batch` and `sample_relabel_subset` keep the JAX package's numpy
logic, with the same rng calls in the same order, so a port Trainer and
a JAX Trainer seeded alike draw the same indices.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_leaves, tree_map


def image_member_datasets(n_members: int, per_member: int,
                          n_classes: int = 100, img: int = 32,
                          noise: float = 0.35, seed: int = 0,
                          device: DeviceLike = None) -> Tuple[dict, dict]:
    """-> (train shards {images (K, n, h, w, 3) f32, labels (K, n) int32},
    test set {images (n_test, h, w, 3), labels (n_test,)}), on the card
    unless `device` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    protos = torch.randn((n_classes, img, img, 3), generator=gen,
                         device=dev) * 0.8

    def make_split(total):
        labels = torch.randint(0, n_classes, (total,), generator=gen,
                               device=dev)
        x = protos[labels] + noise * torch.randn(
            (total, img, img, 3), generator=gen, device=dev)
        flip = torch.rand((total,), generator=gen, device=dev) < 0.5
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        return x.float(), labels.int()

    xtr, ytr = make_split(n_members * per_member)
    xte, yte = make_split(max(per_member, 512))
    train = {"images": xtr.reshape(n_members, per_member, img, img, 3),
             "labels": ytr.reshape(n_members, per_member)}
    test = {"images": xte, "labels": yte}
    return train, test


def take_rows(tree, idx: np.ndarray):
    """Row idx[k, j] of member k's shard, for every (K, n, ...) leaf ->
    (K, m, ...).  The indices reach the card by an asynchronous copy from
    pinned memory: the host does not wait for the card."""
    dev = tree_leaves(tree)[0].device
    i = torch.from_numpy(np.asarray(idx, np.int64))
    if dev.type == "cuda":
        i = i.pin_memory().to(dev, non_blocking=True)
    rows = torch.arange(i.shape[0], device=dev)[:, None]
    return tree_map(lambda a: a[rows, i], tree)


def sample_batch(rng: np.random.Generator, shards: dict, batch: int) -> dict:
    """Per-member minibatch: same batch size, independent indices."""
    K, n = tree_leaves(shards)[0].shape[:2]
    idx = rng.integers(0, n, size=(K, batch))
    return take_rows(shards, idx)


def sample_relabel_subset(rng: np.random.Generator, shards: dict,
                          fraction: float) -> Tuple[dict, np.ndarray]:
    """The paper relabels a fraction of D_k (70% default).  Returns the
    subset and the indices (so the distill phase can pair pseudo-labels
    with true labels)."""
    K, n = tree_leaves(shards)[0].shape[:2]
    m = max(1, int(n * fraction))
    idx = np.stack([rng.permutation(n)[:m] for _ in range(K)])
    return take_rows(shards, idx), idx
