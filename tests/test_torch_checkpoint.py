"""The port's checkpoint store (repro_torch.checkpoint) against the JAX
package's: the twins of tests/test_checkpoint.py, the on-disk layout
read and written across the two packages bit for bit, and the Trainer's
save / resume / reshard and the train CLI's --ckpt / --resume."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.common.types import ECConfig as JEC
from repro.configs import registry as jregistry
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    reshard_members, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.store import gc_keep_last
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.common.types import ECConfig
from repro_torch.configs import registry
from repro_torch.data import lm_member_datasets
from repro_torch.launch import train as train_cli
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these shapes it is the fastest even
    alone, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(k=0):
    return {"params": {"w": torch.arange(12.0).reshape(3, 4) + k,
                       "b": torch.ones(4) * k},
            "step": torch.tensor(k, dtype=torch.int32)}


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits (bf16 as int16), for bit-for-bit checks."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_save_restore_roundtrip(tmp_path, dtype):
    """f32, and bf16 leaves (raw V2 records on disk, named "bfloat16"
    in the index) beside an f32 one and the int32 step."""
    root = str(tmp_path)
    t = _tree(3)
    t["params"]["w"] = (t["params"]["w"] / 3).to(dtype)
    save_checkpoint(root, 3, t)
    assert latest_step(root) == 3
    got = restore_checkpoint(root, 3, _zeros(t))
    assert got["params"]["w"].dtype == dtype
    for a, b in zip(tree_leaves(got), tree_leaves(t)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    with open(os.path.join(root, "step_00000003", "index.json")) as f:
        index = json.load(f)
    assert index["dtypes"] == ["float32", str(dtype).split(".")[-1],
                               "int32"]     # JAX order: b, w, step
    with np.load(os.path.join(root, "step_00000003", "shard_000.npz")) as z:
        kind = z["leaf_00001"].dtype
    assert kind == (np.dtype("V2") if dtype == torch.bfloat16
                    else np.float32)


@pytest.mark.parametrize("into", [torch.float16, torch.int16,
                                  torch.float8_e4m3fn])
def test_raw_records_restore_only_into_their_dtype(tmp_path, into):
    """A bf16 leaf's raw records are refused by a template of another
    dtype, of the same size (fp16, int16) or not (fp8): read through it
    they would be other numbers."""
    root = str(tmp_path)
    t = _tree(3)
    t["params"]["w"] = t["params"]["w"].to(torch.bfloat16)
    save_checkpoint(root, 3, t)
    template = _zeros(t)
    template["params"]["w"] = template["params"]["w"].to(into)
    with pytest.raises(ValueError, match="bfloat16 records"):
        restore_checkpoint(root, 3, template)


def test_crash_before_commit_is_invisible(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree(1))
    # a crash mid-save of step 2: data written, the commit rename never
    # happens, so a restart sees step 1
    save_checkpoint(root, 2, _tree(2), fail_before_commit=True)
    assert latest_step(root) == 1
    got = restore_checkpoint(root, 1, _tree(0))
    assert int(got["step"]) == 1
    gc_keep_last(root, keep=5)  # the stale staging dir is garbage
    assert not any(n.endswith(".tmp") for n in os.listdir(root))


def test_keep_n_gc(tmp_path):
    root = str(tmp_path)
    for s in range(6):
        save_checkpoint(root, s, _tree(s))
    gc_keep_last(root, keep=2)
    kept = sorted(int(n.split("_")[1]) for n in os.listdir(root)
                  if n.startswith("step_"))
    assert kept == [4, 5]


def test_async_manager_roundtrip(tmp_path):
    """save() copies the tree to host memory: changing it in place
    afterwards (as AdamW does) does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in range(1, 4):
        t = _tree(s)
        mgr.save(s, t)
        t["params"]["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest() == 3
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000002",
                                                 "step_00000003"]
    got = mgr.restore(_tree(0))
    assert int(got["step"]) == 3
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  _tree(3)["params"]["w"].numpy())
    mgr.close()
    assert not mgr._worker.is_alive()


def test_manager_restore_without_checkpoint_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(0))


def test_reshard_members_shrink_grow():
    state = {"w": torch.arange(8.0).reshape(4, 2),
             "step": torch.arange(4, dtype=torch.int32)}
    small = reshard_members(state, 2)
    assert small["w"].shape == (2, 2)
    assert torch.equal(small["w"], state["w"][:2])
    gen = torch.Generator().manual_seed(0)
    big = reshard_members(state, 6, perturb=0.01, generator=gen)
    assert big["w"].shape == (6, 2)
    # the first K members bit for bit, the grown ones perturbed copies
    assert torch.equal(big["w"][:4], state["w"])
    assert float((big["w"][4:] - state["w"][:2]).abs().max()) > 0
    assert float((big["w"][4:] - state["w"][:2]).abs().max()) < 0.1
    assert torch.equal(big["step"], torch.tensor([0, 1, 2, 3, 0, 1],
                                                 dtype=torch.int32))
    assert torch.equal(reshard_members(state, 6)["w"][4:], state["w"][:2])


def test_leaves_are_numbered_in_jax_flatten_order(tmp_path):
    """A tree whose dicts were built out of key order, with a list and a
    None: leaf_%05d follow jax.tree_util's flatten order, which the
    port's tree_leaves (insertion order) does not."""
    def tree(f):
        return {"z": [f(1.0), None, f(2.0)], "a": {"y": f(3.0), "b": f(4.0)}}
    save_checkpoint(str(tmp_path), 0, tree(lambda x: torch.tensor([x])))
    with np.load(os.path.join(str(tmp_path), "step_00000000",
                              "shard_000.npz")) as z:
        got = [float(z[f"leaf_{i:05d}"][0]) for i in range(4)]
    want = jax.tree.leaves(tree(lambda x: np.array([x])))
    assert got == [float(w[0]) for w in want] == [4.0, 3.0, 1.0, 2.0]
    back = restore_checkpoint(str(tmp_path), 0,
                              tree(lambda x: torch.zeros(1)))
    assert list(back) == ["z", "a"] and back["z"][1] is None
    assert [float(t) for t in (back["z"][0], back["z"][2], back["a"]["y"],
                               back["a"]["b"])] == [1.0, 2.0, 3.0, 4.0]


# ---------------------------------------------------------------------------
# across the two packages: a Trainer's state, bf16 params, AdamW
# ---------------------------------------------------------------------------

K = 2


@pytest.fixture(scope="module")
def trainer_states():
    """A JAX Trainer's state on reduced rwkv6-7b (bf16 params, AdamW,
    jax.vmap-stacked over K members), its moments filled with noise so
    that no leaf is all zeros; and a port Trainer over the same params,
    the template to restore into."""
    jcfg = jregistry.get_config("rwkv6-7b", reduced=True)
    assert jcfg.dtype == "bfloat16"
    data = {"tokens": np.zeros((K, 8, 16), np.int32),
            "labels": np.zeros((K, 8, 16), np.int32)}
    test = {k: v[0] for k, v in data.items()}
    jtr = JTrainer(jcfg, JEC(), jadamw(1e-3), K, jax.random.PRNGKey(1),
                   data, test, batch_size=2)
    rng = np.random.default_rng(0)
    state = jax.device_get(jtr.state)
    state["opt"]["m"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        state["opt"]["m"])
    state["opt"]["step"] = np.arange(K, dtype=np.int32) + 3
    tr = Trainer(registry.get_config("rwkv6-7b", reduced=True), ECConfig(),
                 adamw(1e-3), K, 0, params_from_numpy(data, "cpu"),
                 params_from_numpy(test, "cpu"), batch_size=2,
                 params=state["params"], device="cpu")
    return state, tr


def _same_state(torch_state, numpy_state):
    tl = jax.tree_util.tree_flatten_with_path(
        torch_state, is_leaf=lambda a: isinstance(a, torch.Tensor))[0]
    nl = jax.tree_util.tree_flatten_with_path(numpy_state)[0]
    assert [p for p, _ in tl] == [p for p, _ in nl]
    kinds = set()
    for (path, t), (_, a) in zip(tl, nl):
        a = np.asarray(a)
        assert str(t.dtype).split(".")[-1] == str(a.dtype), path
        want = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(_bits(t), want,
                                      err_msg=jax.tree_util.keystr(path))
        kinds.add(str(a.dtype))
    assert kinds == {"bfloat16", "float32", "int32"}


def test_jax_written_trainer_state_restores_into_the_port(tmp_path,
                                                          trainer_states):
    state, tr = trainer_states
    jsave(str(tmp_path), 5, state)
    got = restore_checkpoint(str(tmp_path), 5, tr.state)
    _same_state(got, state)


def test_port_written_trainer_state_restores_into_jax(tmp_path,
                                                      trainer_states):
    state, tr = trainer_states
    ported = params_from_numpy(state, "cpu")
    save_checkpoint(str(tmp_path), 5, ported)
    template = jax.tree.map(jnp.zeros_like, state)
    got = jax.device_get(jrestore(str(tmp_path), 5, template))
    _same_state(ported, got)


# ---------------------------------------------------------------------------
# the Trainer and the CLI
# ---------------------------------------------------------------------------

def _trainer(ckpt_dir=None, aggr="ma"):
    cfg = registry.get_config("rwkv6-7b", reduced=True).with_(
        dtype="float32")
    train, test = lm_member_datasets(K, 16, 16, cfg.vocab_size, seed=0,
                                     device="cpu")
    ec = ECConfig(tau=2, p_steps=1, lam=0.5, relabel_fraction=0.5,
                  aggregator=aggr)
    return Trainer(cfg, ec, adamw(1e-3), K, 0, train, test, batch_size=2,
                   seed=1, ckpt_dir=ckpt_dir, device="cpu")


def test_resume_continues_with_the_uninterrupted_loss(tmp_path):
    """Three rounds straight, against two rounds saved (every round, keep
    3), then a fresh trainer that resumes from them and runs the third.
    The host's index generator is not checkpointed (nor is it in the JAX
    package), so the resumed trainer is handed the generator's state;
    MA rounds keep no pseudo buffer across the boundary."""
    straight = _trainer()
    losses = [straight.run_round() for _ in range(3)]
    first = _trainer(str(tmp_path))
    assert [first.run_round() for _ in range(2)] == losses[:2]
    first.ckpt.wait()
    assert latest_step(str(tmp_path)) == 2
    again = _trainer(str(tmp_path))
    assert again.resume() and again.round == 2
    again.rng.bit_generator.state = first.rng.bit_generator.state
    assert again.run_round() == losses[2]
    for a, b in zip(tree_leaves(again.state), tree_leaves(straight.state)):
        assert torch.equal(a, b)
    for tr in (first, again):
        tr.ckpt.close()
    assert not _trainer().resume()


def test_reshard_keeps_old_members_and_perturbs_new_ones():
    tr = _trainer(aggr="ec")
    tr.run_round()
    before = tree_map(torch.clone, tr.state)
    tr.reshard(3, generator=torch.Generator().manual_seed(0))
    assert tr.K == 3 and tr.pseudo_buffer is None
    assert tr.shards["tokens"].shape[0] == 3
    for new, old in zip(tree_leaves(tr.state["params"]),
                        tree_leaves(before["params"])):
        assert new.shape[0] == 3
        assert torch.equal(new[:2], old)
        assert not torch.equal(new[2], old[0])
        assert float((new[2] - old[0]).abs().max()) < 1e-2
    for new, old in zip(tree_leaves(tr.state["opt"]),
                        tree_leaves(before["opt"])):
        assert torch.equal(new, torch.cat([old, old[:1]]))
    loss = tr.run_round()          # the steps read K from the state
    assert np.isfinite(loss)
    tr.reshard(1)
    assert tree_leaves(tr.state)[0].shape[0] == 1


def test_train_cli_saves_and_resumes_rwkv(tmp_path, capsys):
    argv = ["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
            "--members", "2", "--tau", "2", "--p-steps", "1", "--batch",
            "2", "--per-member", "8", "--seq-len", "16", "--ckpt",
            str(tmp_path)]
    assert train_cli.main(argv + ["--rounds", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("round   0 | train ")
    assert latest_step(str(tmp_path)) == 1
    assert train_cli.main(argv + ["--rounds", "2", "--resume"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from round 1"
    assert out[1].startswith("round   1 | train ")
    assert latest_step(str(tmp_path)) == 2
