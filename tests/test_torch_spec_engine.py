"""The port's SpeculativeEngine against repro's at reduced gemma3-1b
(f32, K = 3, weights bridged from the JAX init): greedy tokens and
acceptance counts over the paged pool, and the constructor's gates,
which raise repro's errors.  tests/test_torch_spec.py holds the rest of
speculative decoding (verify, rollback, acceptance rules, the port-side
engines, the CLI, the one device read a tick).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving.spec import SpeculativeEngine as JaxSpec
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.spec import SpeculativeEngine
from test_torch_spec import (B, ENG, PAGED, PLEN, STEPS, _bridge, _prompts,
                             _student)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return _bridge("gemma3-1b", 3, 7)


def test_greedy_spec_matches_repro(models):
    """Distinct members, member 0 as the student: acceptance is low and
    partial; the tokens are the port's plain engine's and, on the paged
    pool (the serving path), repro's speculative engine's, with repro's
    acceptance counts."""
    jcfg, tcfg, jp, tp = models
    kw = dict(ENG, **PAGED)
    prompts = _prompts(B, PLEN)
    plain = EnsembleEngine(tcfg, tp, device="cpu", **kw).generate(
        prompts, max_new=STEPS)
    spec = SpeculativeEngine(tcfg, tp, _student(tp), gamma=3, device="cpu",
                             **kw)
    got = spec.generate(prompts, max_new=STEPS)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)
    ts = spec.spec_stats()
    assert ts["proposed"] > 0 and 0 < ts["accepted"] < ts["proposed"]
    spec.update_slots(release=range(B))
    spec.assert_pool_whole()
    jspec = JaxSpec(jcfg, jp, jax.tree.map(lambda x: x[0], jp), gamma=3,
                    **kw)
    for g, w in zip(got, jspec.generate(prompts, max_new=STEPS)):
        np.testing.assert_array_equal(g, np.asarray(w))
    js = jspec.spec_stats()
    for key in ("spec_steps", "proposed", "accepted", "emitted_hist",
                "mean_accepted_len"):
        assert ts[key] == js[key], key
    assert abs(ts["pruned_frac"] - js["pruned_frac"]) < 1e-6


@pytest.mark.parametrize("case", ["gamma", "prefix_cache", "chunk",
                                  "vocab", "recurrent"])
def test_gates_raise_as_repro(case, models):
    jcfg, tcfg, jp, tp = models
    jd, td = jax.tree.map(lambda x: x[0], jp), _student(tp)
    kw, jargs, targs = dict(ENG), {}, {}
    if case == "gamma":
        kw["gamma"] = 0
    elif case == "prefix_cache":
        kw.update(PAGED, prefix_cache=True)
    elif case == "chunk":
        kw["prefill_chunk"] = 0
    elif case == "vocab":
        jargs["draft_cfg"] = jcfg.with_(vocab_size=256)
        targs["draft_cfg"] = tcfg.with_(vocab_size=256)
    elif case == "recurrent":
        jcfg = jreg.get_config("rwkv6-7b", reduced=True)
        tcfg = treg.get_config("rwkv6-7b", reduced=True)
        jp = jax.jit(jax.vmap(lambda k: jtf.init(k, jcfg)))(
            jax.random.split(jax.random.PRNGKey(0), 1))
        tp = ttf.init(tcfg, seed=0, device="cpu", members=1)
        jd, td = jax.tree.map(lambda x: x[0], jp), _student(tp)
    with pytest.raises(ValueError) as want:
        JaxSpec(jcfg, jp, jd, **kw, **jargs)
    with pytest.raises(ValueError) as got:
        SpeculativeEngine(tcfg, tp, td, device="cpu", **kw, **targs)
    assert str(got.value) == str(want.value)
