"""The port's examples (repro_torch/examples) against the JAX package's
examples, on the CPU, at reduced size.

quickstart and train_ec_dnn run on both sides from the same numpy data
and the same params (the JAX package's init), each example narrowed
where it looks its model config and data up, on both sides alike
(nothing under examples/ changes), the JAX trainers compiled once
(tests/torch_jax_once.py).  quickstart: the NiN at width 16 (the example
asks for width 96 and 10 classes), 32 images of 8x8 a member, its five
EC rounds as they are: every round's nlls and Jensen gap, the MA
contrast's nll and the EC-DNN_L pick.  train_ec_dnn: reduced gemma3-1b
cut to two layers (its last local and its global one) at f32, K 2, 32
sequences of 16 tokens a member, tau 2, top-8 labels, AdamW under the
warm-up cosine: two rounds (the second opens with the top-M distill
step), every round's train loss and nlls; then the port's resume() from
the checkpoint for a third.  NLLs within 1e-4 (rtol 1e-4 after AdamW
steps, as tests/test_torch_lm_train.py holds them).  serve_ensemble on
reduced gemma3-1b at f32, K 2,
in one world of two gloo ranks (`--mesh 2x1`, as the example runs by
default): its member and ensemble scores over the ranks equal the
single-device engine's (members to the bit, the ensemble, fused across
the ranks' all-reduce, within 1e-6), and both equal the JAX package's
EnsembleEngine.score on the same weights within 1e-4 (the engine-score
tolerance of the port's other engine tests); the paged demo decodes and
holds pages; the frontend demo streams 8 tokens over SSE and rolls both
replicas to new weights.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro.common.types import ModelConfig as JMC
from repro.configs import registry as jregistry
from repro.core import aggregation as jagg
from repro.serving import EnsembleEngine as JEngine
from repro_torch.common.types import ModelConfig as TMC
from repro_torch.configs import registry as tregistry
from repro_torch.examples import quickstart as qs
from repro_torch.examples import serve_ensemble as se
from repro_torch.examples import train_ec_dnn as ted
from repro_torch.paper.common import as_tensors
from repro_torch.runtime.trainer import Trainer as TTrainer
from torch_jax_once import CompiledOnce, compiled_once, jax_params
from torch_mesh_ranks import small

NLL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the torch side runs small shapes, and the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrowed_cfg(monkeypatch, asked, jmod, tmod, **narrow):
    """Each example's ModelConfig, where it looks it up, made with
    `narrow` over what it asks for; the asks are kept."""
    for mod, mc in ((jmod, JMC), (tmod, TMC)):
        def make(_mc=mc, **kw):
            asked.append(kw)
            return _mc(**{**kw, **narrow})
        monkeypatch.setattr(mod, "ModelConfig", make)


def _port_trainer(monkeypatch, tmod, made, jcfg):
    """The port example's Trainer, started from the JAX init of jcfg
    (the JAX side's config) for its K; each one made is kept."""
    class FromJax(TTrainer):
        def __init__(self, cfg, ec, opt, K, *a, **kw):
            self.evals = []
            super().__init__(cfg, ec, opt, K, *a,
                             params=jax_params(jcfg, K), **kw)
            made.append(self)

        def evaluate(self, record=True):
            out = super().evaluate(record)
            self.evals.append(out)
            return out

    monkeypatch.setattr(tmod, "Trainer", FromJax)


def _jax_trainers(monkeypatch, jmod, made):
    """The JAX example's Trainer compiled once (tests/torch_jax_once.py);
    each one made is kept."""
    compiled_once(monkeypatch, jmod)

    class Kept(CompiledOnce):
        """Kept, with the member its best_member() picked (the pick
        draws a batch: it is read once)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def best_member(self):
            out = super().best_member()
            self.best = out[1]
            return out

    monkeypatch.setattr(jmod, "Trainer", Kept)


def _evals_match(jtr, ttr, tol):
    assert len(ttr.evals) == len(jtr.evals) > 0
    for got, want in zip(ttr.evals, jtr.evals):
        for k in ("local_loss", "global_loss"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_quickstart_runs(monkeypatch, capsys):
    from examples import quickstart as jqs
    train, test = jax.device_get(jdata.image_member_datasets(
        jax.random.PRNGKey(0), 4, 32, n_classes=10, img=8, noise=0.5))
    monkeypatch.setattr(jqs, "image_member_datasets",
                        lambda key, K, **kw: (train, test))
    monkeypatch.setattr(qs, "image_member_datasets",
                        lambda K, **kw: (as_tensors(train),
                                         as_tensors(test)))
    asked, jtrs, ttrs = [], [], []
    _narrowed_cfg(monkeypatch, asked, jqs, qs, d_model=16)
    _jax_trainers(monkeypatch, jqs, jtrs)
    quick = dict(name="quickstart", family="cnn", n_layers=9, d_model=96,
                 vocab_size=10)
    _port_trainer(monkeypatch, qs, ttrs, JMC(**{**quick, "d_model": 16}))
    jqs.main()
    out = qs.main(["--device", "cpu"])
    (jtr,), (ttr,) = jtrs, ttrs
    assert asked == [quick, quick]
    _evals_match(jtr, ttr, dict(rtol=0, atol=NLL_TOL))
    gaps = [e["local_loss"] - e["global_loss"] for e in jtr.evals]
    assert len(out["jensen_gaps"]) == 5
    np.testing.assert_allclose(out["jensen_gaps"], gaps, rtol=0,
                               atol=2 * NLL_TOL)
    assert all(g >= -1e-6 for g in out["jensen_gaps"])
    # the MA contrast as the JAX example makes it, on its final members
    ma = jagg.ma_aggregate(jtr.state["params"])
    want_ma = float(jtr._single_eval(
        jax.tree.map(lambda x: x[0], ma),
        jax.tree.map(lambda a: a[:256], test))[0])
    np.testing.assert_allclose(out["ma_nll"], want_ma, rtol=0,
                               atol=NLL_TOL)
    assert out["best_member"] == jtr.best
    text = capsys.readouterr().out
    assert text.count("Jensen gap=") == 10
    assert text.count("MA of the same members") == 2
    assert f"EC-DNN_L final model: member {out['best_member']}" in text


def test_train_ec_dnn_checkpoints_and_resumes(monkeypatch, tmp_path,
                                              capsys):
    from examples import train_ec_dnn as jted
    train, test = jax.device_get(jdata.lm_member_datasets(
        jax.random.PRNGKey(0), 2, per_member=32, seq_len=16, vocab=512))
    monkeypatch.setattr(jted, "lm_member_datasets",
                        lambda key, K, **kw: (train, test))
    monkeypatch.setattr(ted, "lm_member_datasets",
                        lambda K, **kw: (as_tensors(train),
                                         as_tensors(test)))
    asked, jtrs, ttrs = [], [], []
    _port_trainer(monkeypatch, ted, ttrs, small(
        jregistry.get_config("gemma3-1b", reduced=True)))
    for reg in (jregistry, tregistry):
        def get(arch, reduced=False, _real=reg.get_config):
            asked.append((arch, reduced))
            return small(_real(arch, reduced))
        monkeypatch.setattr(reg, "get_config", get)
    _jax_trainers(monkeypatch, jted, jtrs)
    argv = ["--members", "2", "--tau", "2", "--seq-len", "16", "--batch",
            "2", "--rounds", "2"]
    monkeypatch.setattr(sys, "argv", ["train_ec_dnn"] + argv + [
        "--ckpt", str(tmp_path / "jax")])
    jted.main()
    argv += ["--ckpt", str(tmp_path / "port")]
    first = ted.main(argv + ["--device", "cpu"])
    assert asked == [("gemma3-1b", True)] * 2
    (jtr,), (ttr,) = jtrs, ttrs
    assert ttr.ec.label_mode == "topk" and ttr.ec.top_m == 8
    _evals_match(jtr, ttr, dict(rtol=1e-4, atol=1e-6))
    assert first["best_member"] == jtr.best
    assert first["start_round"] == 0 and len(first["jensen_gaps"]) == 2
    assert (tmp_path / "port" / "step_00000002").is_dir()
    # the port alone: resume() from round 2 for a third
    argv[argv.index("--rounds") + 1] = "3"
    second = ted.main(argv + ["--device", "cpu"])
    assert second["start_round"] == 2 and len(second["jensen_gaps"]) == 1
    assert (tmp_path / "port" / "step_00000003").is_dir()
    for g in first["jensen_gaps"] + second["jensen_gaps"]:
        assert np.isfinite(g) and g >= -1e-6
    assert "resumed from round 2" in capsys.readouterr().out


def test_serve_ensemble_two_ranks_equal_one_device_and_jax():
    argv = ["--device", "cpu", "--arch", "gemma3-1b", "--members", "2",
            "--batch", "2", "--steps", "6", "--dtype", "float32", "--mesh",
            "2x1", "--paged", "--frontend"]
    out = se.main(argv)
    assert out["member_nll"] == out["single_member_nll"]
    np.testing.assert_allclose(out["ens_nll"], out["single_ens_nll"],
                               rtol=0, atol=1e-6)
    assert out["ens_nll"] <= np.mean(out["member_nll"]) + 1e-6  # Jensen
    assert [len(t) for t in out["paged_tokens"]] == [8, 8]
    assert out["used_pages"] > 0
    assert len(out["frontend"]["sse_tokens"]) == 8
    assert out["frontend"]["swaps"] == [1, 1]

    # the same weights and batch through the JAX package's engine
    args = se._parser().parse_args(argv)
    cfg = se.make_cfg(args)
    params = se.make_params(cfg, 2, "cpu")
    toks, labels = se.make_batch(cfg, 2, 6, "cpu")
    jcfg = jregistry.get_config("gemma3-1b", reduced=True).with_(
        dtype="float32")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jeng = JEngine(jcfg, jparams, n_slots=1, max_prompt=1, max_out=1)
    m_ref, e_ref = jeng.score(toks, labels)
    np.testing.assert_allclose(out["member_nll"], np.asarray(m_ref),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["ens_nll"], float(e_ref), rtol=0,
                               atol=1e-4)
