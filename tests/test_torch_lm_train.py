"""The port's EC-DNN training of LM members against the JAX package's,
on the CPU.

Reduced deepseek-7b and gemma3-1b at f32, K = 2 (the config of
tests/test_trainer.py's LM trainer: 32 sequences of 16 tokens a member,
batch 4, tau 3, p 2, relabel 50%, top-M 8, AdamW 1e-3).  Both packages
start from the JAX package's init (fetched before the first round, since
JAX donates the state), the same numpy token shards and the same
sampling seed, so they train on the same batches.  The port trains
through its plain route (transformer.apply(remat=True): attend under
torch.utils.checkpoint, never the flash kernel), as the JAX package
trains through jnp attend.  Tolerances: losses and evaluate() rtol 1e-4
over two rounds (AdamW steps of f32 models summed in another order, as
tests/test_torch_trainer.py holds the NiN); gradients rtol 1e-4 / atol
1e-6.  Params are not compared element by element after AdamW steps:
its first step moves every weight by +-lr times the sign of its
gradient, so a gradient within rounding of 0 moves its weight by lr
either way, and such weights move the trained members' probabilities of
size 1/V by up to 1e-3 of their size.  So trained pseudo-labels, rows of
unit mass, are held within 1e-5 absolute (PSEUDO), a class at the top-M
boundary free to swap with a neighbour of equal mass (`_same_topm`).
"""

import jax
import numpy as np
import pytest
import torch

from repro.common.types import ECConfig as JEC
from repro.configs import registry as jregistry
from repro.core import aggregation as jagg
from repro.core import compression as jcomp
from repro.data import lm_member_datasets as jdata
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro.runtime.trainer import Trainer as JTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.common.types import ECConfig as TEC
from repro_torch.configs import registry as tregistry
from repro_torch.core import aggregation as tagg
from repro_torch.core import compression as tcomp
from repro_torch.data import lm_member_datasets as tdata
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.trainer import Trainer as TTrainer

K = 2
TOL = dict(rtol=1e-4, atol=1e-6)
PSEUDO = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these shapes it is the fastest even
    alone, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jregistry.get_config(arch, reduced=True).with_(dtype="float32"),
            tregistry.get_config(arch, reduced=True).with_(dtype="float32"))


def _torch(tree):
    return params_from_numpy(tree, "cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _ec(mod, aggr="ec", mode="topk"):
    return mod(tau=3, lam=0.5, p_steps=2, relabel_fraction=0.5,
               label_mode=mode, aggregator=aggr, top_m=8)


@pytest.fixture(scope="module")
def shards():
    """Numpy token shards per arch's vocab (both reduced configs: 512)."""
    train, test = jdata(jax.random.PRNGKey(0), K, per_member=32, seq_len=16,
                        vocab=512)
    return jax.device_get(train), jax.device_get(test)


def _same_topm(got, want, vocab=512):
    """Trained pseudo-labels against JAX's: masses and pruned mass within
    PSEUDO, and the same classes kept, except that a class whose mass is
    within PSEUDO of its row's M-th mass may be kept on one side and its
    near-equal neighbour on the other (a swap at the boundary)."""
    want = tcomp.TopM(*(torch.from_numpy(np.array(x)) for x in want))
    _close(got.vals.numpy(), want.vals, **PSEUDO)
    _close(got.rest.numpy(), want.rest, **PSEUDO)
    gd, wd = (tcomp.to_dense(t, vocab).numpy() for t in (got, want))
    edge = want.vals[..., -1:].numpy()
    ok = np.isclose(gd, wd, **PSEUDO) | np.isclose(np.maximum(gd, wd), edge,
                                                   **PSEUDO)
    assert ok.all(), np.argwhere(~ok)[:5]


CASES = {  # name: (arch, aggregator, label_mode, grad_accum)
    "ec_topk": ("deepseek-7b", "ec", "topk", 1),
    "ec_dense": ("deepseek-7b", "ec", "dense", 1),
    "ma": ("deepseek-7b", "ma", "dense", 1),
    # gemma3's ec steps with grad_accum 2 (top-M labels) are held below,
    # step by step (test_training_route_takes_attend_not_flash)
    "gemma3_sync_accum2": ("gemma3-1b", "sync", "dense", 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lm_rounds_match_jax_trainer(shards, name):
    """Two rounds: round 0 trains plainly and aggregates; round 1 opens
    (ec) with two distill steps on its pseudo-labels."""
    arch, aggr, mode, accum = CASES[name]
    jcfg, tcfg = _cfgs(arch)
    train, test = shards
    key = jax.random.PRNGKey(0)
    jtr = JTrainer(jcfg, _ec(JEC, aggr, mode), jadamw(1e-3), K, key, train,
                   test, batch_size=4, seed=2, grad_accum=accum)
    ttr = TTrainer(tcfg, _ec(TEC, aggr, mode), tadamw(1e-3), K, 0,
                   _torch(train), _torch(test), batch_size=4, seed=2,
                   params=jax.device_get(jtr.state["params"]),
                   device="cpu", grad_accum=accum)
    for _ in range(2):
        _close(ttr.run_round(), jtr.run_round())
        jev, tev = jtr.evaluate(), ttr.evaluate()
        assert set(tev) == set(jev)
        for k in jev:
            _close(tev[k], jev[k])
        if aggr == "ec":
            assert tev["global_loss"] <= tev["local_loss"] + 1e-6  # Jensen
    if aggr != "ec":
        return
    jps, tps = jtr.pseudo_buffer[1], ttr.pseudo_buffer[1]
    if mode == "topk":
        assert isinstance(tps, tcomp.TopM)
        assert tps.vals.shape == (K, 16, 16, 8)
        _same_topm(tps, jps)
    else:
        _close(tps.numpy(), jps, **PSEUDO)
    jc, tc = jtr.evaluate_compressed(), ttr.evaluate_compressed()
    for k in jc:
        _close(tc[k], jc[k])
    (jbest, jk), (tbest, tk) = jtr.best_member(), ttr.best_member()
    assert tk == jk
    _close(tbest["final_norm"]["norm_scale"].numpy(),
           jbest["final_norm"]["norm_scale"])


def _batch(rng, cfg, B=4, T=16):
    toks = rng.integers(0, cfg.vocab_size, (K, B, T + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def test_training_route_takes_attend_not_flash(monkeypatch):
    """make_member_grads with grad_accum 2 and a TopM target: the port's
    loss and gradients equal the JAX package's (vmapped over members),
    with ops.flash_attention patched to fail: apply(remat=True) never
    calls it, apply() does."""
    jcfg, tcfg = _cfgs("gemma3-1b")
    from repro import models as jmodels
    params = jax.device_get(jax.vmap(lambda k: jmodels.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(3), K)))
    rng = np.random.default_rng(0)
    batch = _batch(rng, jcfg)
    e = np.exp(rng.standard_normal((K, 4, 16, jcfg.vocab_size)) * 2)
    pseudo = jcomp.from_dense(jax.numpy.asarray(
        (e / e.sum(-1, keepdims=True)).astype(np.float32)), 8)
    lam = np.float32(0.375)
    jloss, jgrads = jax.vmap(
        lambda p, b, ps: jsteps.make_member_grads(jcfg, 2)(p, b, ps, lam))(
        params, batch, pseudo)

    def boom(*a, **kw):
        raise AssertionError("flash_attention on the training route")
    monkeypatch.setattr(ops, "flash_attention", boom)
    tparams = jax.tree.map(lambda a: a.requires_grad_(),
                           _torch(params))
    tps = tcomp.TopM(*(torch.from_numpy(np.array(x)) for x in pseudo))
    tloss, tgrads = tsteps.make_member_grads(tcfg, 2)(
        tparams, _torch(batch), tps, torch.tensor(0.375))
    _close(float(tloss), float(np.sum(jloss)))
    for a, b in zip(jax.tree.leaves(tgrads), jax.tree.leaves(jgrads)):
        assert a.dtype == torch.float32       # the f32 accumulators
        _close(a.numpy(), b)
    with pytest.raises(AssertionError, match="training route"):
        ttf.apply(tparams, tcfg, _torch(batch)["tokens"])


@pytest.mark.parametrize("quorum", [None, (0.0, 1.0)])
def test_topk_relabel_matches_jax_in_chunks(monkeypatch, shards, quorum):
    """allgather_relabel in top-M mode against the JAX oracle, scored a
    sequence at a time (CHUNK_BYTES = one 16-token sequence's logits)."""
    jcfg, tcfg = _cfgs("deepseek-7b")
    monkeypatch.setattr(tagg, "CHUNK_BYTES", 4 * 16 * tcfg.vocab_size)
    from repro import models as jmodels
    params = jax.device_get(jax.vmap(lambda k: jmodels.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(1), K)))
    subset = {k: v[:, :5] for k, v in shards[0].items()}
    q = None if quorum is None else np.asarray(quorum, np.float32)
    want = jagg.allgather_relabel(params, subset,
                                  jsteps.make_logits_fn(jcfg),
                                  _ec(JEC), quorum=q)
    got = tagg.allgather_relabel(
        _torch(params), _torch(subset), tsteps.make_logits_fn(tcfg),
        _ec(TEC), quorum=None if q is None else torch.from_numpy(q),
        n_out=tcfg.vocab_size)
    assert got.idx.shape == (K, 5, 16, 8) and got.idx.dtype == torch.int32
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    _close(got.vals.numpy(), want.vals, rtol=1e-5, atol=1e-7)
    _close(got.rest.numpy(), want.rest, atol=1e-6)


def test_synthetic_tokens_keep_the_contract():
    train, test = tdata(3, 10, 12, vocab=64, seed=4, device="cpu")
    assert train["tokens"].shape == train["labels"].shape == (3, 10, 12)
    assert train["tokens"].dtype == torch.int32
    assert test["tokens"].shape == (32, 12)
    assert torch.equal(train["tokens"][..., 1:], train["labels"][..., :-1])
    assert int(train["tokens"].min()) >= 0
    assert int(train["tokens"].max()) < 64
    again, _ = tdata(3, 10, 12, vocab=64, seed=4, device="cpu")
    assert torch.equal(again["tokens"], train["tokens"])
    # the affine rules: most next tokens follow from the current one
    flat = torch.cat([train["tokens"].reshape(-1, 12),
                      train["labels"][..., -1:].reshape(-1, 1)], 1)
    pairs = {}
    for row in flat.tolist():
        for a, b in zip(row, row[1:]):
            pairs.setdefault(a, []).append(b)
    top = sum(max(np.bincount(v)) for v in pairs.values())
    assert top / sum(map(len, pairs.values())) > 0.3
    if not torch.cuda.is_available():  # no card: entry points raise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdata(3, 10, 12, vocab=64)


def test_train_cli_trains_gemma3_on_the_cpu(capsys):
    """Both label modes in process (the CLI's main), and without
    --device the entry point wants a card."""
    argv = ["--arch", "gemma3-1b", "--reduced", "--device", "cpu",
            "--members", "2", "--rounds", "2", "--tau", "2", "--p-steps",
            "1", "--batch", "2", "--per-member", "8", "--seq-len", "16"]
    for mode in ("topk", "dense"):
        assert train_cli.main(argv + ["--label-mode", mode]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("round   0 | train ")
        assert "ens nll" in lines[1]
        assert lines[-1].startswith("final model: member ")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(argv[:3])
