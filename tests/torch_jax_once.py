"""The JAX package's Trainer, compiled once per test module, for the tests
that hold the port's paper scripts and examples against the JAX ones
(test_torch_paper.py, test_torch_examples.py).

The JAX Trainer jits its steps anew for every trainer and its relabel
anew every round (a new lambda each time), and its init runs eagerly, so
that a script making several trainers of one model compiles the same
programs again and again.  `CompiledOnce` computes what the JAX Trainer
computes, by the same functions: it takes its jitted steps from the
first trainer of the same model config, optimizer and grad_accum, and
jits its relabel once per model config and ECConfig.  `sgd_momentum`
hands out one optimizer per (lr, momentum), so that trainers with the
same hyperparameters share one.  `JIT_INIT` is the JAX package's init
under one jit.
"""
from __future__ import annotations

import functools

import jax

from repro import models as jmodels
from repro.core import aggregation as jagg
from repro.data import sample_relabel_subset
from repro.optim import sgd_momentum as _sgd_momentum
from repro.runtime.trainer import Trainer as JTrainer

# eager, each op of the vmapped init compiles alone (~15 s an init
# shape here, more than all else)
JIT_INIT = jax.jit(jmodels.init, static_argnums=1)

STEPS = ("_plain_step", "_sync_step", "_distill_step", "_ma_step", "_eval",
         "_single_eval")


@functools.lru_cache(maxsize=None)
def sgd_momentum(lr: float, momentum: float = 0.9):
    return _sgd_momentum(lr, momentum=momentum)


def jax_params(cfg, k: int, seed: int = 0):
    """The JAX Trainer's init for k members (its key, split k ways), as
    numpy."""
    keys = jax.random.split(jax.random.PRNGKey(seed), k)
    return jax.device_get(jax.vmap(lambda kk: JIT_INIT(kk, cfg))(keys))


class CompiledOnce(JTrainer):
    """The JAX Trainer, its programs compiled once a module (see the
    module's docstring); `evals` records every evaluate()'s result."""

    steps: dict = {}
    relabels: dict = {}

    def __init__(self, *a, **kw):
        self.evals = []
        super().__init__(*a, **kw)

    def _build_steps(self):
        key = (self.cfg, id(self.opt), self.grad_accum)
        if key not in self.steps:
            super()._build_steps()
            self.steps[key] = (self.opt, {n: getattr(self, n)
                                          for n in STEPS})
        for name, fn in self.steps[key][1].items():
            setattr(self, name, fn)

    def _relabel(self, quorum=None):
        if quorum is not None or self.mesh is not None:
            return super()._relabel(quorum)
        subset, _ = sample_relabel_subset(self.rng, self.shards,
                                          self.ec.relabel_fraction)
        key = (self.cfg, self.ec)
        if key not in self.relabels:
            logits = self._logits
            ec = self.ec
            self.relabels[key] = jax.jit(
                lambda p, b: jagg.allgather_relabel(p, b, logits, ec))
        self.pseudo_buffer = (subset, self.relabels[key](
            self.state["params"], subset))

    def evaluate(self, record: bool = True):
        out = super().evaluate(record)
        self.evals.append(out)
        return out


def compiled_once(monkeypatch, *modules):
    """The JAX init jitted, and CompiledOnce and the shared optimizers
    where each module looks its Trainer and sgd_momentum up."""
    monkeypatch.setattr(jmodels, "init", JIT_INIT)
    for mod in modules:
        if hasattr(mod, "Trainer"):
            monkeypatch.setattr(mod, "Trainer", CompiledOnce)
        if hasattr(mod, "sgd_momentum"):
            monkeypatch.setattr(mod, "sgd_momentum", sgd_momentum)
