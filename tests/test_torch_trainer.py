"""The port's EC-DNN training round against the JAX package's, on the CPU.

Reduced NiN (d_model=48, 8x8 images, 10 classes), K=4, f32.  Both
packages start from the same params (JAX's init, fetched before the
first round since JAX donates the state), the same numpy data shards and
the same sampling seed, so they train on the same batches.  The JAX side
runs its Eqn-9 loss through the Pallas kernel in interpret mode
(REPRO_USE_PALLAS=1), the port through its plain version.  Tolerance
rtol 1e-4 (eight steps of f32 convs summed in another order).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.common.types import ECConfig as JEC
from repro.common.types import ModelConfig as JMC
from repro.core import aggregation as jagg
from repro.data import image_member_datasets as jdata
from repro.data import sample_batch as jsample_batch
from repro.data import sample_relabel_subset as jsample_subset
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd_momentum as jsgd
from repro.runtime import steps as jsteps
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.common.types import ECConfig as TEC
from repro_torch.common.types import ModelConfig as TMC
from repro_torch.configs import registry
from repro_torch.core import aggregation as tagg
from repro_torch.data import image_member_datasets as tdata
from repro_torch.data import sample_batch as tsample_batch
from repro_torch.data import sample_relabel_subset as tsample_subset
from repro_torch.optim import clip_by_global_norm as tclip
from repro_torch.optim import sgd_momentum as tsgd
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.trainer import Trainer as TTrainer

ROOT = Path(__file__).resolve().parents[1]
K = 4
TOL = dict(rtol=1e-4, atol=1e-6)
CFG = dict(name="nin-t", family="cnn", n_layers=9, d_model=48,
           vocab_size=10)


@pytest.fixture(scope="module")
def data():
    """Numpy shards and JAX-initialized member-stacked params."""
    key = jax.random.PRNGKey(0)
    train, test = jdata(key, K, per_member=64, n_classes=10, img=8)
    from repro import models as jmodels
    params = jax.vmap(lambda k: jmodels.init(k, JMC(**CFG)))(
        jax.random.split(key, K))
    return (jax.device_get(train), jax.device_get(test),
            jax.device_get(params))


def _torch(tree):
    return params_from_numpy(tree, "cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _ec(mod, aggr="ec", tau=4):
    return mod(tau=tau, lam=0.5, p_steps=tau // 2, relabel_fraction=0.5,
               label_mode="dense", aggregator=aggr)


@pytest.mark.parametrize("kind", ["plain", "distill", "sync"])
def test_local_step_matches_jax(data, monkeypatch, kind):
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    train, _, params = data
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 64, (K, 16))
    batch = {k: v[np.arange(K)[:, None], idx] for k, v in train.items()}
    pseudo = None
    if kind == "distill":
        e = np.exp(rng.standard_normal((K, 16, 10)))
        pseudo = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    jopt, topt = jsgd(0.02), tsgd(0.02)
    jstep = jsteps.make_local_step(JMC(**CFG), jopt, sync=kind == "sync")
    tstep = tsteps.make_local_step(TMC(**CFG), topt, sync=kind == "sync")
    jstate = {"params": params, "opt": jax.vmap(jopt.init)(params)}
    tparams = _torch(params)
    tstate = {"params": tparams, "opt": topt.init(tparams)}
    for _ in range(2):  # the second step runs on momentum
        jstate, jloss = jstep(jstate, batch, pseudo, np.float32(0.375))
        tstate, tloss = tstep(tstate, _torch(batch),
                              None if pseudo is None else _torch(pseudo),
                              torch.tensor(0.375))
        _close(float(tloss), float(jloss))
    for k, v in jstate["params"].items():
        _close(tstate["params"][k].numpy(), v)
        _close(tstate["opt"]["mu"][k].numpy(), jstate["opt"]["mu"][k])
    np.testing.assert_array_equal(tstate["opt"]["step"].numpy(),
                                  np.asarray(jstate["opt"]["step"]))


def test_clip_by_global_norm_matches_jax(data):
    _, _, params = data
    jg, jn = jax.vmap(lambda p: jclip(p, 0.5))(params)
    tg, tn = tclip(_torch(params), 0.5)
    _close(tn.numpy(), jn)
    for k in params:
        _close(tg[k].numpy(), jg[k])


def test_sampling_draws_the_same_indices(data):
    train, _, _ = data
    tt = _torch(train)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        jb, tb = jsample_batch(jr, train, 7), tsample_batch(tr, tt, 7)
        np.testing.assert_array_equal(tb["labels"].numpy(),
                                      np.asarray(jb["labels"]))
    (js, jidx), (ts, tidx) = (jsample_subset(jr, train, 0.7),
                              tsample_subset(tr, tt, 0.7))
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(ts["images"].numpy(),
                                  np.asarray(js["images"]))


@pytest.mark.parametrize("quorum", [None, (1.0, 0.0, 1.0, 1.0)])
def test_allgather_relabel_matches_jax(data, quorum):
    train, _, params = data
    subset = {k: v[:, :20] for k, v in train.items()}
    q = None if quorum is None else np.asarray(quorum, np.float32)
    want = jagg.allgather_relabel(params, subset,
                                  jsteps.make_logits_fn(JMC(**CFG)),
                                  _ec(JEC), quorum=q)
    got = tagg.allgather_relabel(
        _torch(params), _torch(subset), tsteps.make_logits_fn(TMC(**CFG)),
        _ec(TEC), quorum=None if q is None else torch.from_numpy(q))
    assert got.shape == (K, 20, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def _both_trainers(data, aggr):
    train, test, params = data
    key = jax.random.PRNGKey(0)
    jtr = JTrainer(JMC(**CFG), _ec(JEC, aggr), jsgd(0.02), K, key, train,
                   test, batch_size=16, seed=1)  # inits `params` again
    ttr = TTrainer(TMC(**CFG), _ec(TEC, aggr), tsgd(0.02), K, 0,
                   _torch(train), _torch(test), batch_size=16, seed=1,
                   params=params, device="cpu")
    return jtr, ttr


def test_ec_rounds_match_jax_trainer(data, monkeypatch):
    """Round 0 trains plainly and relabels; round 1 opens with two
    distill steps through the Eqn-9 loss (the Pallas kernel on the JAX
    side) and ends with a second relabel."""
    monkeypatch.setenv("REPRO_USE_PALLAS", "1")
    jtr, ttr = _both_trainers(data, "ec")
    for r in range(2):
        _close(ttr.run_round(), jtr.run_round())
        jev, tev = jtr.evaluate(), ttr.evaluate()
        assert set(tev) == set(jev)
        for k in jev:
            _close(tev[k], jev[k])
        assert tev["global_loss"] <= tev["local_loss"] + 1e-6  # Jensen
    _close(ttr.pseudo_buffer[1].numpy(), jtr.pseudo_buffer[1])
    jc, tc = jtr.evaluate_compressed(), ttr.evaluate_compressed()
    for k in jc:
        _close(tc[k], jc[k])
    assert ttr.metrics.local_loss == pytest.approx(jtr.metrics.local_loss,
                                                   rel=1e-4)
    (jbest, jk), (tbest, tk) = jtr.best_member(), ttr.best_member()
    assert tk == jk
    _close(tbest["bias_out"].numpy(), jbest["bias_out"])


@pytest.mark.parametrize("aggr", ["ma", "sync"])
def test_baseline_round_matches_jax_trainer(data, aggr):
    jtr, ttr = _both_trainers(data, aggr)
    mask = np.array([1.0, 1.0, 0.0, 1.0])
    _close(ttr.run_round(mask), jtr.run_round(mask))
    jev, tev = jtr.evaluate(), ttr.evaluate()
    for k in jev:
        _close(tev[k], jev[k])
    for k, v in jtr.state["params"].items():
        _close(ttr.state["params"][k].numpy(), v)


def test_trainer_rejects_what_is_not_ported(data):
    train, test, _ = data
    args = (TMC(**CFG), _ec(TEC), tsgd(0.02), K, 0, _torch(train),
            _torch(test), 16)
    for kw, match in ((dict(ckpt_dir="/nonexistent"), "item 7"),
                      (dict(mesh=object()), "item 12")):
        with pytest.raises(NotImplementedError, match=match):
            TTrainer(*args, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="compression"):
        TTrainer(*args[:1], TEC(label_mode="topk"), *args[2:],
                 device="cpu")
    tr = TTrainer(*args, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        tr.reshard(2)
    with pytest.raises(NotImplementedError, match="not ported"):
        tsteps.make_member_loss(registry.get_config("gemma3-1b"))


def test_synthetic_images_keep_the_contract():
    train, test = tdata(3, 20, n_classes=7, img=8, seed=4, device="cpu")
    assert train["images"].shape == (3, 20, 8, 8, 3)
    assert train["images"].dtype == torch.float32
    assert train["labels"].shape == (3, 20)
    assert train["labels"].dtype == torch.int32
    assert test["images"].shape == (512, 8, 8, 3)
    assert int(train["labels"].min()) >= 0
    assert int(train["labels"].max()) < 7
    again, _ = tdata(3, 20, n_classes=7, img=8, seed=4, device="cpu")
    assert torch.equal(again["images"], train["images"])
    if not torch.cuda.is_available():  # no card: entry points raise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdata(3, 20)


def test_train_cli_runs_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--members", "2", "--rounds", "2", "--tau", "2", "--p-steps", "1",
         "--batch", "4", "--per-member", "16"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("round   0 | train ")
    assert "ens nll" in lines[1]
    assert lines[-1].startswith("final model: member ")
