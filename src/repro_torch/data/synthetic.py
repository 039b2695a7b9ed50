"""Deterministic synthetic datasets with learnable structure.

Images: the faithful CIFAR-100 experiment runs on a synthetic stand-in with the
same shape contract (32x32x3, 100 classes) and genuine class structure:
class prototypes + Gaussian noise + random horizontal flips (the paper's
only augmentation).  Each ensemble member holds a disjoint shard, like
the paper's random partition of the training set.

LM streams: affine-recurrent token sequences x_{t+1} = (a*x_t + b) mod V
with per-sequence (a, b) drawn from a small pool, plus noise tokens: a
next-token task a small transformer provably reduces below uniform CE.

The draws come from a torch.Generator on the target device, so the numbers differ from the
JAX package's jax.random draws; tests hand both packages the same numpy
arrays instead.

`sample_batch` and `sample_relabel_subset` keep the JAX package's numpy
logic, with the same rng calls in the same order, so a port Trainer and
a JAX Trainer seeded alike draw the same indices.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _affine_stream(gen: torch.Generator, n_seq: int, seq_len: int,
                   vocab: int, n_rules: int = 0, noise_p: float = 0.05):
    """n_rules=0 scales the pool with the vocab (vocab//4, clamped to
    [2, 16]), as the JAX package does, so a small vocab keeps its bigram
    structure.  The recurrence is taken in int64 (a*x stays exact at a
    262k vocab)."""
    if n_rules <= 0:
        n_rules = min(16, max(2, vocab // 4))
    dev = gen.device
    draw = lambda lo, hi, shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev)
    rule_a = draw(1, max(vocab - 1, 2), (n_rules,))
    rule_b = draw(0, vocab, (n_rules,))
    rid = draw(0, n_rules, (n_seq,))
    a, b, x = rule_a[rid], rule_b[rid], draw(0, vocab, (n_seq,))
    toks = torch.empty((n_seq, seq_len), dtype=torch.int64, device=dev)
    for t in range(seq_len):
        x = (x * a + b) % vocab
        toks[:, t] = x
    noise = torch.rand(toks.shape, generator=gen, device=dev) < noise_p
    return torch.where(noise, draw(0, vocab, toks.shape), toks).int()


def lm_member_datasets(n_members: int, per_member: int, seq_len: int,
                       vocab: int, seed: int = 0,
                       device: DeviceLike = None) -> Tuple[dict, dict]:
    """-> (train shards {tokens, labels (K, n, T) int32}, test set
    {tokens, labels (n_test, T)}); labels are the tokens shifted by one.
    On the card unless `device` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    tr = _affine_stream(gen, n_members * per_member, seq_len + 1, vocab)
    te = _affine_stream(gen, max(per_member // 2, 32), seq_len + 1, vocab)
    train = {"tokens": tr[:, :-1].reshape(n_members, per_member, seq_len),
             "labels": tr[:, 1:].reshape(n_members, per_member, seq_len)}
    test = {"tokens": te[:, :-1], "labels": te[:, 1:]}
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


def _rows_of(shards: dict, of):
    """(members the draw is for, the rows of them `shards` holds)."""
    K = tree_leaves(shards)[0].shape[0]
    return (K, slice(0, K)) if of is None else of


def sample_batch(rng: np.random.Generator, shards: dict, batch: int,
                 of: Optional[Tuple[int, slice]] = None) -> dict:
    """Per-member minibatch: same batch size, independent indices.
    of=(K, rows): shards hold rows `rows` of K members' shards (one rank
    of a member mesh); the draw is the K members', so it is the same
    whatever the rows, and the rows' part of it is taken."""
    K, rows = _rows_of(shards, of)
    n = tree_leaves(shards)[0].shape[1]
    idx = rng.integers(0, n, size=(K, batch))
    return take_rows(shards, idx[rows])


def sample_relabel_subset(rng: np.random.Generator, shards: dict,
                          fraction: float,
                          of: Optional[Tuple[int, slice]] = None
                          ) -> Tuple[dict, np.ndarray]:
    """The paper relabels a fraction of D_k (70% default).  Returns the
    subset and the indices (so the distill phase can pair pseudo-labels
    with true labels); `of` as in sample_batch."""
    K, rows = _rows_of(shards, of)
    n = tree_leaves(shards)[0].shape[1]
    m = max(1, int(n * fraction))
    idx = np.stack([rng.permutation(n)[:m] for _ in range(K)])[rows]
    return take_rows(shards, idx), idx
