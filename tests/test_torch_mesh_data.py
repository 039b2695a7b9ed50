"""Trainer(mesh=...) with data ranks within a member, on the CPU, against
the JAX package's Trainer.

One world of 4 gloo ranks, local_mesh(2, 2): K = 2 members along the
trainer's ec_axis() ("data"), each held by 2 data ranks (along the
mesh's other dim) that split every member's batch rows, relabel rows
and test rows, average gradients before AdamW's clip and step, and
gather the relabel's targets back.  Reduced gemma3-1b cut to two layers
(torch_mesh_ranks.small) at f32, from the JAX package's init, on the
port's synthetic token shards: ec over the ring for two rounds (the
second opens with two distill steps) and ma for one, losses and
evaluate() within rtol 1e-4 of the JAX Trainer without a mesh (its
all-gather relabel, which tests/test_aggregation.py holds equal to its
ring); a member's two replicas hold bitwise-equal params after every
round; save() and a fresh trainer's resume() give every rank its rows
back bit for bit; reshard 2 -> 4 over the mesh (all-gather protocol)
equals a single-process port reshard with the same generator, state
and shards, and the next round's loss and evaluate() agree within rtol
1e-4; a batch of 3 rows or 19 relabel rows over 2 data ranks, a MoE
model's token pool split over them, and a ring grown past one member a
rank, are refused.  The world starts before the JAX reference
computes; the ranks import the port only (tests/torch_mesh_ranks.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.common.types import ECConfig as JEC
from repro.configs import registry as jreg
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.common import sharding as shd
from repro_torch.common.tree import tree_map
from repro_torch.common.types import ECConfig as TEC
from repro_torch.configs import registry as treg
from repro_torch.data import lm_member_datasets as tdata
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.trainer import Trainer as TTrainer

K = ranks.TRAIN_K
TOL = dict(rtol=1e-4, atol=1e-6)   # tests/test_torch_lm_train.py's
WORLD_TIMEOUT = 120.0
RESHARD_SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4 ranks' results (started first), the JAX Trainer's per
    aggregator, the shards and the init."""
    train, test = (tree_map(lambda x: x.numpy(), t) for t in tdata(
        K, per_member=32, seq_len=16, vocab=512, device="cpu"))
    cfg = ranks.small(jreg.get_config("gemma3-1b", reduced=True))
    jtr = JTrainer(cfg, ranks.train_ec(JEC, "ec"), jadamw(1e-3), K,
                   jax.random.PRNGKey(0), train, test, batch_size=4, seed=2)
    init = jax.device_get(jtr.state)
    root = str(tmp_path_factory.mktemp("data_ckpt"))
    running = shd.spawn(ranks.data_world, 4,
                        (init["params"], train, test, root, RESHARD_SEED),
                        timeout=WORLD_TIMEOUT, wait=False)
    try:
        ref = {}
        for name, (aggr, _, rounds) in ranks.DATA_CASES.items():
            jtr.ec = ranks.train_ec(JEC, aggr)
            jtr.state = jax.tree.map(jnp.array, init)
            jtr.rng = np.random.default_rng(2)
            jtr.pseudo_buffer, jtr.round = None, 0
            losses, evals = [], []
            for _ in range(rounds):
                losses.append(jtr.run_round())
                evals.append(jtr.evaluate(record=False))
            ref[name] = {"losses": losses, "evals": evals}
    finally:
        out = running.join()
    return out, ref, (train, test), init


@pytest.mark.parametrize("name", sorted(ranks.DATA_CASES))
def test_data_ranks_match_jax_trainer(world, name):
    out, ref, _, _ = world
    want = ref[name]
    for o in out:                       # every rank reports the global figures
        got = o[name]
        _close(got["losses"], want["losses"])
        for ev, jev in zip(got["evals"], want["evals"]):
            assert set(ev) == set(jev)
            for k in jev:
                _close(ev[k], jev[k])
            if name.startswith("ec"):
                assert ev["global_loss"] <= ev["local_loss"] + 1e-6


@pytest.mark.parametrize("name", sorted(ranks.DATA_CASES))
def test_member_replicas_bitwise_equal(world, name):
    """The two data ranks of each member hold the same params, bit for
    bit, after every round; under ec the two members differ (ma's
    round ends in their mean)."""
    out = world[0]
    by_member = {}
    for o in out:
        by_member.setdefault(o["member"], []).append(o[name]["params"])
    assert sorted(by_member) == [0, 1]
    for reps in by_member.values():
        assert len(reps) == 2
        for a, b in zip(*reps):
            for x, y in zip(_leaves(a), _leaves(b)):
                np.testing.assert_array_equal(x, y)
    a = _leaves(by_member[0][0][-1])[0]
    b = _leaves(by_member[1][0][-1])[0]
    assert np.array_equal(a, b) == (name == "ma")


def test_save_resume_over_data_ranks(world):
    """save() writes from the first rank; a fresh trainer's resume()
    hands every rank, data replicas included, its rows back."""
    for o in world[0]:
        ok, rnd, back, saved = o["resumed"]
        assert ok and rnd == 2
        for x, y in zip(_leaves(back), _leaves(saved)):
            np.testing.assert_array_equal(x, y)


def test_reshard_over_mesh_matches_single_process(world):
    """2 -> 4 members over the 2 x 2 mesh: each rank's rows of the
    state and shards equal a single-process port reshard's (same
    generator seed); the round after it agrees within rtol 1e-4."""
    out, _, (train, test), init = world
    cfg = ranks.small(treg.get_config("gemma3-1b", reduced=True))
    one = TTrainer(cfg, ranks.train_ec(TEC, "ec", "allgather"),
                   tadamw(1e-3), K, 0, params_from_numpy(train, "cpu"),
                   params_from_numpy(test, "cpu"), batch_size=4, seed=2,
                   params=init["params"], device="cpu")
    one.reshard(4, generator=torch.Generator().manual_seed(RESHARD_SEED))
    full = tree_map(lambda x: x.numpy().copy(), one.state)
    shards = tree_map(lambda x: x.numpy().copy(), one.shards)
    loss, ev = one.run_round(), one.evaluate()
    for o in out:
        r = o["reshard"]
        assert r["K"] == 4
        lo, hi = r["rows"]
        assert (lo, hi) == (2 * o["member"], 2 * o["member"] + 2)
        for x, y in zip(_leaves(r["state"]), _leaves(full)):
            np.testing.assert_array_equal(x, y[lo:hi])
        for x, y in zip(_leaves(r["shards"]), _leaves(shards)):
            np.testing.assert_array_equal(x, y[lo:hi])
        _close(r["loss"], loss)
        for k in ev:
            _close(r["eval"][k], ev[k])


@pytest.mark.parametrize("case,words", [
    ("uneven", "3 batch rows a member do not split"),
    ("relabel", "19 relabel rows a member do not split"),
    ("moe", "MoE pool"),
    ("ring", "allgather")])
def test_data_rank_refusals(world, case, words):
    """A member's batch of 3 rows, or its 19 relabel rows, cannot split
    over 2 data ranks, and a MoE model's token pool is not split over
    them (each refused at construction, before any round runs); a ring
    trainer grown to 4 members on 2 ranks is refused, naming the
    all-gather."""
    for o in world[0]:
        assert words in o["refused"][case]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]
