"""The port's EC round across ranks against the JAX package's, on the
CPU: the ring relabel, the mesh all-gather and Trainer(mesh=...).

One world of 4 gloo ranks runs the JAX package's own ring toy
(tests/test_aggregation.py's RING_SCRIPT: K 4, m 3, d 6, V 12, linear
logits), one member a rank: the ring equals JAX's allgather_relabel
within 1e-5, dense and under the quorum [1, 0, 1, 1], as does the
port's all-gather over the mesh; top-M at M = V is lossless (1e-5) and
at M = 4 within its own L1 bound.  One world of 2 ranks trains reduced
gemma3-1b cut to two layers (one local, one global:
torch_mesh_ranks.small) at f32, K = 2 (a member a rank), from the JAX
package's init, on the port's synthetic token shards (the JAX package's
affine streams, drawn by torch; both sides train on the same arrays):
ec over the ring and ec over the all-gather for two rounds (the second
opens with two distill steps), ma and sync for one, losses and
evaluate() within rtol 1e-4 of the JAX Trainer without a mesh (its all-gather relabel, which the JAX package's ring
test holds equal to its ring within 1e-5), the EC-DNN_L pick equal;
the ring trainer's save() (gathered to the first rank) restores bit
for bit in a single-process port Trainer, through the JAX package's
restore_checkpoint, and in a 2-rank trainer's resume().  A world whose
rank raises makes joining it raise with that rank's traceback.  The
module's worlds start together and run while this process computes the
JAX references.  The ranks import the port only
(tests/torch_mesh_ranks.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro.checkpoint.store import restore_checkpoint as jrestore
from repro.common.types import ECConfig as JEC
from repro.configs import registry as jreg
from repro.core import aggregation as jagg
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.common import sharding as shd
from repro_torch.common.tree import tree_map
from repro_torch.common.types import ECConfig as TEC
from repro_torch.configs import registry as treg
from repro_torch.data import lm_member_datasets as tdata
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.trainer import Trainer as TTrainer

K = ranks.TRAIN_K
TOL = dict(rtol=1e-4, atol=1e-6)   # tests/test_torch_lm_train.py's
RING_TOL = 1e-5                    # tests/test_aggregation.py's
WORLD_TIMEOUT = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# -- the ring toy over 4 ranks ------------------------------------------------


def _jcfg():
    return ranks.small(jreg.get_config("gemma3-1b", reduced=True))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of the module, started together while this process
    computes the JAX package's references: the ring toy's 4 ranks, the
    2 trainer ranks and the 2 of the world whose rank 1 raises.  One JAX
    Trainer, reset per aggregator, compiles once.  -> {"ring": (the 4
    ranks' results stacked along K, JAX's oracles), "trained": (the 2
    ranks' results, the JAX Trainer's per aggregator, the shards, the
    init, the checkpoint root), "failed": what joining the failing
    world raised}."""
    W = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 6, 12)))
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 3, 6)))
    started = {
        "failing": shd.spawn(ranks.failing_world, 2, timeout=60.0,
                             wait=False),
        "ring": shd.spawn(ranks.ring_world, 4, (W, X),
                          timeout=WORLD_TIMEOUT, wait=False)}
    try:
        train, test = (tree_map(lambda x: x.numpy(), t) for t in tdata(
            K, per_member=32, seq_len=16, vocab=512, device="cpu"))
        jtr = JTrainer(_jcfg(), ranks.train_ec(JEC, "ec"), jadamw(1e-3), K,
                       jax.random.PRNGKey(0), train, test, batch_size=4,
                       seed=2)
        init = jax.device_get(jtr.state)
        root = str(tmp_path_factory.mktemp("mesh_ckpt"))
        started["train"] = shd.spawn(ranks.train_world, 2,
                                     (init["params"], train, test, root),
                                     timeout=WORLD_TIMEOUT, wait=False)
        fn = lambda p, b: b["x"] @ p["W"]  # noqa: E731
        ec = JEC(label_mode="dense")
        args = ({"W": jnp.asarray(W)}, {"x": jnp.asarray(X)}, fn, ec)
        oracle = {"dense": np.asarray(jagg.allgather_relabel(*args)),
                  "quorum": np.asarray(jagg.allgather_relabel(
                      *args, quorum=jnp.asarray([1.0, 0.0, 1.0, 1.0])))}
        ref = {}
        for aggr, rounds in (("ec", 2), ("ma", 1), ("sync", 1)):
            jtr.ec = ranks.train_ec(JEC, aggr)
            jtr.state = jax.tree.map(jnp.array, init)
            jtr.rng = np.random.default_rng(2)
            jtr.pseudo_buffer, jtr.round = None, 0
            losses, evals = [], []
            for _ in range(rounds):
                losses.append(jtr.run_round())
                evals.append(jtr.evaluate(record=False))
            ref[aggr] = {"losses": losses, "evals": evals,
                         "best": jtr.best_member()[1]}
    finally:
        out = {}
        for name, world in started.items():
            try:
                out[name] = world.join()
            except RuntimeError as e:
                if name != "failing":
                    raise
                out[name] = e
    got = {k: np.concatenate([o[k] for o in out["ring"]])
           for k in out["ring"][0]}
    return {"ring": (got, oracle),
            "trained": (out["train"], ref, (train, test), init, root),
            "failed": out["failing"]}


@pytest.fixture(scope="module")
def ring(worlds):
    return worlds["ring"]


@pytest.fixture(scope="module")
def trained(worlds):
    return worlds["trained"]


@pytest.mark.parametrize("case", ["dense", "quorum"])
def test_ring_equals_jax_allgather(ring, case):
    got, oracle = ring
    assert np.abs(got[case] - oracle[case]).max() < RING_TOL
    mesh_ag = got["allgather" if case == "dense" else "allgather_quorum"]
    assert np.abs(mesh_ag - oracle[case]).max() < RING_TOL


def test_ring_top_m(ring):
    """M = V keeps every class: the dense oracle; M = 4 stays within the
    accumulator's own L1 bound of it."""
    got, oracle = ring
    assert np.abs(got["topm_full"] - oracle["dense"]).max() < RING_TOL
    l1 = np.abs(got["topm_4"] - oracle["dense"]).sum(-1)
    assert (l1 <= got["topm_4_bound"] + 1e-4).all()
    assert got["topm_4_bound"].max() > 0      # something was pruned


def test_failing_rank_raises_with_its_traceback(worlds):
    """Joining a world whose rank 1 raised raises, with that rank's
    traceback, while rank 0 waits in a collective (no hang)."""
    failed = worlds["failed"]
    assert isinstance(failed, RuntimeError), failed
    assert "rank 1 fails on purpose" in str(failed)


# -- Trainer(mesh=...) over 2 ranks -------------------------------------------


@pytest.mark.parametrize("name", sorted(ranks.TRAIN_CASES))
def test_mesh_trainer_matches_jax_trainer(trained, name):
    out, ref, _, _, _ = trained
    want = ref[ranks.TRAIN_CASES[name][0]]
    for o in out:                    # both ranks report the global figures
        got = o[name]
        _close(got["losses"], want["losses"])
        for ev, jev in zip(got["evals"], want["evals"]):
            assert set(ev) == set(jev)
            for k in jev:
                _close(ev[k], jev[k])
            if name.startswith("ec"):
                assert ev["global_loss"] <= ev["local_loss"] + 1e-6
        assert got["best"] == want["best"]


def test_mesh_save_restores_bit_for_bit(trained):
    """The first rank wrote the state both ranks held: a single-process
    port Trainer resumes it, the JAX package's restore reads it, and a
    2-rank trainer's resume() hands each rank its rows back."""
    out, _, (train, test), init, root = trained
    step = out[0]["saved"][0]
    rows = [_by_path(o["saved"][1]) for o in out]
    full = {p: np.concatenate([rows[0][p], rows[1][p]]) for p in rows[0]}
    cfg = ranks.small(treg.get_config("gemma3-1b", reduced=True))
    one = TTrainer(cfg, ranks.train_ec(TEC, "ec"), tadamw(1e-3), K, 0,
                   params_from_numpy(train, "cpu"),
                   params_from_numpy(test, "cpu"), batch_size=4,
                   device="cpu", ckpt_dir=root)
    assert one.resume() and one.round == step == 2
    port = _by_path(one.state)
    assert port.keys() == full.keys()
    for path, x in port.items():
        np.testing.assert_array_equal(x.numpy(), full[path])
    jstate = _by_path(jrestore(root, step, init))
    assert jstate.keys() == full.keys()
    for path, x in jstate.items():
        np.testing.assert_array_equal(np.asarray(x), full[path])
    for o, mine in zip(out, rows):
        ok, rnd, state = o["resumed"]
        assert ok and rnd == step
        back = _by_path(state)
        assert back.keys() == mine.keys()
        for path, x in back.items():
            np.testing.assert_array_equal(x, mine[path])


def _by_path(tree, path=()):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {p: x for k in tree for p, x in _by_path(tree[k],
                                                        path + (k,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _by_path(v, path + (i,)).items()}
    return {path: tree}


# -- refusals and the CLI, in process -----------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    mesh = shd.local_mesh(1, 2, device="cpu")   # one process: 1x1
    yield mesh
    dist.destroy_process_group()


def test_mesh_trainer_refusals(mesh1, trained):
    """The ring needs K ranks along its axis (one member a rank): a
    1-rank mesh at K = 2 is refused, not silently mislabelled, and so is
    a 1-member ring trainer resharded past it; the all-gather trainer
    reshards over the mesh (tests/test_torch_mesh_data.py holds it
    against a single process)."""
    cfg = ranks.small(treg.get_config("gemma3-1b", reduced=True))
    train, test = (params_from_numpy(x, "cpu") for x in trained[2])
    args = (cfg, ranks.train_ec(TEC, "ec"), tadamw(1e-3), K, 0, train,
            test, 4)
    with pytest.raises(ValueError, match="allgather"):
        TTrainer(*args, device="cpu", mesh=mesh1)
    one = tree_map(lambda x: x[:1], train)
    ring = TTrainer(*args[:3], 1, 0, one, test, 4, device="cpu", mesh=mesh1)
    with pytest.raises(ValueError, match="allgather"):
        ring.reshard(2)
    tr = TTrainer(*args[:1], ranks.train_ec(TEC, "ec", "allgather"),
                  *args[2:], device="cpu", mesh=mesh1)
    tr.reshard(4)
    assert tr.K == tr.K_local == 4
    assert tree_map(lambda x: x.shape[0], tr.shards) == {"tokens": 4,
                                                         "labels": 4}


@pytest.mark.parametrize("protocol", ["ring", "allgather"])
def test_train_cli_protocol(monkeypatch, protocol):
    seen = []

    class Spy(TTrainer):
        def __init__(self, cfg, ec, *a, **kw):
            seen.append(ec.protocol)
            super().__init__(cfg, ec, *a, **kw)

    monkeypatch.setattr(trainer_mod, "Trainer", Spy)
    assert train_cli.main(["--arch", "gemma3-1b", "--reduced", "--device",
                           "cpu", "--members", "2", "--rounds", "1",
                           "--tau", "1", "--p-steps", "1", "--batch", "2",
                           "--per-member", "4", "--seq-len", "8",
                           "--protocol", protocol]) == 0
    assert seen == [protocol]
