"""The port's paper experiments (repro_torch/paper) against the JAX
package's benchmark scripts and faithful example, on the CPU.

Both sides train from the same numpy data and the same params, the JAX
package's seeded init.  The scripts look their configs and data up by
name, so the tests narrow them where they are looked up, on both sides
alike: `benchmarks.common.cnn_cfg` and the twin's to a tiny NiN (width
16, 8x8 images, 10 classes), `make_data` in each table / figure module
to one shared numpy draw (K 2, 32 images a member).  The port's
`make_trainer` is wrapped to start each trainer from the JAX trainer's
params for its K.  The JAX trainers are compiled once for the module
(tests/torch_jax_once.py).  Nothing under benchmarks/ or examples/ changes.

Every NLL matches within 1e-4 (f32 convs summed in another order, a few
rounds of SGD); every error rate is equal, but for rows whose top-2
margin is within the tolerance (the ROADMAP's near-tie rule: such rows
may flip), counted on the final params.  `param_bytes` is equal for
every arch of the JAX registry, counted on the meta device without
allocating; a real-device init draws what it drew before the meta
device was added (digests of the init as it was before).
"""
import hashlib
import resource

import jax
import numpy as np
import pytest
import torch

import benchmarks.aggregation_cost as jcost
import benchmarks.common as jcommon
import benchmarks.fig12 as jfig12
import benchmarks.table1 as jtable1
from repro.common.types import SHAPES as JSHAPES
from repro.common.types import ModelConfig as JMC
from repro.configs import registry as jregistry
from repro_torch import models as tmodels
from repro_torch.common.tree import tree_leaves
from repro_torch.common.types import SHAPES as TSHAPES
from repro_torch.common.types import ModelConfig as TMC
from repro_torch.configs import registry as tregistry
from repro_torch.paper import aggregation_cost as tcost
from repro_torch.paper import common as tcommon
from repro_torch.paper import faithful as tfaithful
from repro_torch.paper import fig12 as tfig12
from repro_torch.paper import table1 as ttable1
from torch_jax_once import compiled_once
from torch_jax_once import jax_params as _jax_params

K = 2
CFG = dict(name="nin-tiny", family="cnn", n_layers=9, d_model=16,
           vocab_size=10)
NLL_TOL = 1e-4
MARGIN = 1e-4   # a top-2 margin below this may flip between packages
EVAL_ROWS = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the torch side runs tiny shapes, and the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image_data(seed: int, n_classes: int):
    """K shards of 32 8x8 images and a 512-image test set, numpy: class
    prototypes plus noise, as the synthetic CIFAR-100 stand-in."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((n_classes, 8, 8, 3)) * 0.8

    def split(n):
        y = rng.integers(0, n_classes, n).astype(np.int32)
        x = protos[y] + 0.6 * rng.standard_normal((n, 8, 8, 3))
        return x.astype(np.float32), y

    x, y = split(K * 32)
    xt, yt = split(512)
    return ({"images": x.reshape(K, 32, 8, 8, 3), "labels": y.reshape(K, 32)},
            {"images": xt, "labels": yt})


@pytest.fixture(scope="module")
def data():
    return _image_data(0, 10)


@pytest.fixture(autouse=True, scope="module")
def _jax_compiled_once():
    """The JAX scripts' trainers compiled once for the module
    (tests/torch_jax_once.py: the same functions, shared)."""
    from examples import ec_vs_ma_faithful as jfaithful
    with pytest.MonkeyPatch.context() as mp:
        compiled_once(mp, jcommon, jfaithful)
        yield


@pytest.fixture
def narrowed(monkeypatch, data):
    """Both packages' scripts on the tiny NiN and the shared data; ->
    (the JAX trainers made, the port's), in order of making."""
    made = ([], [])
    monkeypatch.setattr(jcommon, "cnn_cfg", lambda: JMC(**CFG))
    monkeypatch.setattr(tcommon, "cnn_cfg", lambda: TMC(**CFG))
    for jmod, tmod in ((jtable1, ttable1), (jfig12, tfig12)):
        monkeypatch.setattr(jmod, "make_data", lambda key, k: data)
        monkeypatch.setattr(tmod, "make_data",
                            lambda seed, k, device=None: data)
        jreal, treal = jmod.make_trainer, tmod.make_trainer

        def jmake(*a, _real=jreal, **kw):
            made[0].append(_real(*a, **kw))
            return made[0][-1]

        def tmake(aggr, k, tau, init_seed, train, test, _real=treal, **kw):
            params = _jax_params(JMC(**CFG), k, init_seed)
            made[1].append(_real(aggr, k, tau, init_seed, train, test,
                                 params=params, **kw))
            return made[1][-1]

        monkeypatch.setattr(jmod, "make_trainer", jmake)
        monkeypatch.setattr(tmod, "make_trainer", tmake)
    return made


def _near_ties(tr) -> int:
    """Test rows (of evaluate()'s) where a member's logits, the
    ensemble's probabilities or the members' parameter average's logits
    have a top-2 margin below MARGIN, on the port trainer's params."""
    x = tr.test["images"][:EVAL_ROWS]
    params = tr.state["params"]
    Kt = tree_leaves(params)[0].shape[0]
    with torch.no_grad():
        z = tmodels.predict_logits(params, tr.cfg,
                                   {"images": x.expand(Kt, *x.shape)})
        avg = {k: v.mean(0, keepdim=True) for k, v in params.items()}
        za = tmodels.predict_logits(avg, tr.cfg, {"images": x[None]})
    scores = [*z, z.softmax(-1).mean(0), za[0]]
    tied = torch.zeros(x.shape[0], dtype=torch.bool)
    for s in scores:
        top2 = s.topk(2, dim=-1).values
        tied |= (top2[:, 0] - top2[:, 1]) < MARGIN
    return int(tied.sum())


def _match(got: dict, want: dict, slack: float):
    assert set(got) == set(want)
    for k in want:
        if "loss" in k or "nll" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=NLL_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=slack + 1e-7, err_msg=k)


def _slack(tr) -> float:
    return _near_ties(tr) / EVAL_ROWS


def _trainers_match(made):
    jtrs, ttrs = made
    assert len(jtrs) == len(ttrs) > 0
    for jtr, ttr in zip(jtrs, ttrs):
        assert ttr.K == jtr.K and ttr.ec.aggregator == jtr.ec.aggregator
        slack = _slack(ttr)
        _match(ttr.evaluate(record=False), jtr.evaluate(record=False),
               slack)
        jm, tm = jtr.metrics, ttr.metrics
        for field in ("local_loss", "global_loss", "compressed_loss",
                      "local_err", "global_err", "compressed_err"):
            got, want = getattr(tm, field), getattr(jm, field)
            assert len(got) == len(want), field
            np.testing.assert_allclose(
                got, want, rtol=0, atol=NLL_TOL if "loss" in field
                else slack + 1e-7, err_msg=field)


def test_table1_run_matches_jax(narrowed):
    """EC and MA at K 2 and S-DNN over the flattened shards, 2 rounds
    of tau 2 (round 1 opens with the Eqn-9 step)."""
    want = jtable1.run(2, 2, K, seed=0)
    got = ttable1.run(2, 2, K, seed=0, device="cpu")
    assert list(got) == list(want) == ["EC-DNN_L", "EC-DNN_G", "MA-DNN_L",
                                       "MA-DNN_G", "S-DNN"]
    jtrs, ttrs = narrowed
    assert [t.K for t in ttrs] == [K, K, 1]
    assert ttrs[-1].ec.aggregator == "ma"
    slack = max(_slack(t) for t in ttrs)
    _match(got, want, slack)
    _trainers_match(narrowed)


def test_fig12_matches_jax(narrowed, capsys):
    """The script's loop at --fast (3 MA rounds; 3 iterations of two EC
    rounds, the compressed eval after the second; tau 4): every recorded
    metric."""
    argv = ["--fast", "--members", str(K)]
    want = jfig12.main(argv)
    got = tfig12.main(argv + ["--device", "cpu"])
    for k in ("ma_bad_fraction", "jensen_ok"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["ec_nll_gaps"], want["ec_nll_gaps"],
                               rtol=0, atol=2 * NLL_TOL)
    assert got["jensen_ok"]
    _trainers_match(narrowed)
    assert narrowed[1][1].round == 6
    out = capsys.readouterr().out
    assert "Jensen (EC ensemble nll <= mean local nll) every round: OK" \
        in out


@pytest.mark.parametrize("aggr", ["ec", "ma"])
def test_faithful_run_setting_matches_jax(monkeypatch, data, aggr):
    """run_setting, its batch of 64, K 2, 2 rounds of tau 2.  The script
    fixes the paper's NiN (9 layers, 192 channels, 100 classes): the
    test checks that it asks for it, and narrows it to the tiny NiN where
    each script looks ModelConfig up (CPU time)."""
    from examples import ec_vs_ma_faithful as jfaithful
    asked = []

    def narrow(mc):
        def make(**kw):
            asked.append(kw)
            return mc(**CFG)
        return make

    monkeypatch.setattr(jfaithful, "ModelConfig", narrow(JMC))
    monkeypatch.setattr(tfaithful, "ModelConfig", narrow(TMC))
    train, test = data
    want = jfaithful.run_setting(aggr, K, 2, 2, train, test,
                                 jax.random.PRNGKey(0))
    got = tfaithful.run_setting(aggr, K, 2, 2, train, test,
                                params=_jax_params(JMC(**CFG), K),
                                device="cpu")
    paper = dict(name="paper_nin", family="cnn", n_layers=9, d_model=192,
                 vocab_size=100)
    assert asked == [paper, paper]
    assert set(got) == set(want)
    for k in ("L_nll", "G_nll", "nll_gaps"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=NLL_TOL,
                                   err_msg=k)
    for k in ("L_err", "G_err", "err_gaps"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    if aggr == "ec":
        assert all(g >= -1e-6 for g in got["nll_gaps"])


def test_shapes_match_jax():
    assert {k: v.__dict__ for k, v in TSHAPES.items()} == \
        {k: v.__dict__ for k, v in JSHAPES.items()}


def test_param_bytes_match_jax_on_the_meta_device():
    """Every arch of the JAX registry, full size: llama3-405b's 812 GB
    and arctic-480b's 954 GB are counted, not allocated."""
    assert tcost.ARCH_IDS == jregistry.ARCH_IDS
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    got = {a: tcost.param_bytes(a) for a in tcost.ARCH_IDS}
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    want = {a: jcost.param_bytes(a) for a in jregistry.ARCH_IDS}
    assert got == want
    assert got["llama3-405b"] == 811_715_067_904
    assert got["arctic-480b"] == 953_765_793_792
    assert (rss1 - rss0) * 1024 < 256 << 20   # ru_maxrss is in KiB


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b", "rwkv6-7b",
                                  "whisper-tiny", "paper_nin"])
def test_meta_init_is_shapes_only(arch):
    """Shapes and dtypes of a real init, every leaf on the meta device
    (no storage), K stacked."""
    cfg = tregistry.get_config(arch, reduced=True)
    meta = tmodels.init(cfg, seed=0, device="meta", members=3)
    real = tmodels.init(cfg, seed=0, device="cpu", members=3)
    m, r = tree_leaves(meta), tree_leaves(real)
    assert len(m) == len(r)
    for a, b in zip(m, r):
        assert a.is_meta and not b.is_meta
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


# sha256 of every leaf's shape, dtype and bytes of
# models.init(reduced cfg, seed=3, device="cpu", members=2), taken on
# the init as it was before the meta device; paper_nin at d_model
# 24 and 10 classes
INIT_DIGESTS = {
    "gemma3-1b": "90f5f2f326aec33d", "deepseek-7b": "3c6c35b801e7f1da",
    "paper_nin": "914bac3c87f61c99", "rwkv6-7b": "0e9e49df84d8084b",
    "jamba-v0.1-52b": "ef54b5eb99152331",
    "deepseek-v2-236b": "0392cf56bbf9e2fc",
    "starcoder2-7b": "150f28ca82b962fd", "llama3-405b": "f04158e921ae704a",
    "arctic-480b": "a5a4ae60dc1b5d50", "qwen2-vl-2b": "e3691a002e15f19a",
    "whisper-tiny": "37667d4a8ead8ceb"}


def test_real_init_draws_what_it_drew_before():
    assert set(INIT_DIGESTS) == set(tregistry.ARCH_IDS)
    for arch, want in INIT_DIGESTS.items():
        cfg = tregistry.get_config(arch, reduced=True)
        if arch == "paper_nin":
            cfg = cfg.with_(d_model=24, vocab_size=10)
        h = hashlib.sha256()
        for x in tree_leaves(tmodels.init(cfg, seed=3, device="cpu",
                                          members=2)):
            h.update(str((tuple(x.shape), str(x.dtype))).encode())
            h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest()[:16] == want, arch


def test_aggregation_cost_main_prints_every_arch(capsys):
    rows = tcost.main([])
    assert list(rows) == list(jregistry.ARCH_IDS)
    g = rows["gemma3-1b"]
    shape = TSHAPES["train_4k"]
    relabel = int(shape.global_batch // 16 * shape.seq_len * 0.7)
    assert g["topm"] == 16 * relabel * (64 * 8 + 4 + 4)
    assert g["dense"] == 16 * relabel * 262_144 * 4
    assert capsys.readouterr().out.count("Gi") >= 4 * 10


def test_image_relabel_scores_in_chunks_of_one_layers_activations(
        monkeypatch, data):
    """A CNN relabel set is scored a chunk of images at a time, so that
    the model's widest layer output (models.activation_floats, read from
    the params at the images' resolution) stays within CHUNK_BYTES (the
    faithful run's K = 8 set of 35,000 32x32 images had taken 21.4 GiB a
    layer in one call); chunks change no target."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.common.types import ECConfig as TEC
    from repro_torch.core import aggregation as tagg
    from repro_torch.runtime import steps as tsteps
    nin = tregistry.get_config("paper_nin")
    big = {"images": torch.empty(35_000, 32, 32, 3, device="meta")}
    for width in (192, 96):    # the paper's, and --fast's
        meta = tmodels.init(nin.with_(d_model=width), device="meta",
                            members=8)
        floats = tmodels.activation_floats(nin, meta, big)
        assert floats == 32 * 32 * width
        assert tagg.chunk_rows(big, 100, floats) == \
            (1 << 30) // (4 * 32 * 32 * width)
    assert tagg.chunk_rows({"tokens": torch.empty(4, 64)}, 262_144) == 16
    train, _ = data
    params = params_from_numpy(_jax_params(JMC(**CFG), K), "cpu")
    subset = {k: torch.as_tensor(v[:, :20]) for k, v in train.items()}
    floats = tmodels.activation_floats(TMC(**CFG), params, subset)
    assert floats == 8 * 8 * 16     # the tiny NiN's widest layer
    ec = TEC(tau=2, lam=0.5, p_steps=1, relabel_fraction=0.7,
             label_mode="dense", aggregator="ec")
    fn = tsteps.make_logits_fn(TMC(**CFG))
    whole = tagg.allgather_relabel(params, subset, fn, ec, n_out=10,
                                   row_floats=floats)
    calls = []
    monkeypatch.setattr(tagg, "CHUNK_BYTES", 4 * floats * 7)

    def counted(p, b):
        calls.append(b["images"].shape[1])
        return fn(p, b)

    chunked = tagg.allgather_relabel(params, subset, counted, ec, n_out=10,
                                     row_floats=floats)
    # 40 rows (2 batches of 20), 7 a chunk, each chunk member by member
    assert calls == [7] * 10 + [5] * 2
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    # the Trainer passes its model's floats: 22 rows a member, 44 in all
    from repro_torch.optim import sgd_momentum
    from repro_torch.runtime.trainer import Trainer
    tr = Trainer(TMC(**CFG), ec, sgd_momentum(0.05, momentum=0.9), K, 0,
                 tcommon.as_tensors(train), tcommon.as_tensors(data[1]),
                 batch_size=4, params=_jax_params(JMC(**CFG), K),
                 device="cpu")
    calls.clear()
    tr._logits = counted
    tr._relabel()
    assert calls == [7] * 12 + [2] * 2
