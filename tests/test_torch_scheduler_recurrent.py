"""The port's Scheduler over the recurrent archs against repro.serving's,
and the serve CLI's continuous mode on every ported arch.

Reduced rwkv6-7b and jamba-v0.1-52b at f32, K=2, prefix cache off (both
refuse it), with a pool too small for the queue: completions must equal
the JAX scheduler's token for token, with the same preemptions.  A
preempted slot's recurrent state restarts from zero on re-admission, and
frozen rows keep theirs while others decode (kv_cache.snapshot /
keep_frozen), or the tokens would fork.

`python -m repro_torch.launch.serve --continuous` runs on the CPU at
reduced width for all four ported archs, with --prefix-cache where the
config allows it.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import Scheduler as JaxScheduler
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.launch import serve
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.scheduler import Scheduler

KW = dict(n_slots=3, max_prompt=24, max_out=6, prefill_chunk=4,
          paged=True, page_size=4, seed=0, n_pages=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the torch side runs tiny shapes, and the
    suite's workers share the cores (torch's default, one thread a core
    in every worker, oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def requests():
    rng = np.random.default_rng(1)
    shared = list(range(200, 216))
    reqs = []
    for i in range(9):
        tail = list(rng.integers(1, 99, 1 + int(rng.integers(6))))
        cut = int(rng.integers(4, len(shared) + 1))
        reqs.append((np.array(shared[:cut] + tail, np.int32), 2 + i % 4))
    return reqs


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_recurrent_scheduler_under_pressure_matches_jax(arch):
    jcfg = jreg.get_config(arch, reduced=True).with_(dtype="float32")
    tcfg = treg.get_config(arch, reduced=True).with_(dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    runs = []
    for eng in (JaxEngine(jcfg, jp, **KW),
                EnsembleEngine(tcfg, tp, device="cpu", **KW)):
        S = JaxScheduler if isinstance(eng, JaxEngine) else Scheduler
        sched = S(eng)
        rids = [sched.submit(t, m) for t, m in requests()]
        runs.append((eng, sched, rids, sched.run()))
    (_, js, jr, jc), (eng, ts, tr, tc) = runs
    assert ts.preemptions == js.preemptions > 0
    assert set(tc) == set(tr)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(tc[b].tokens, jc[a].tokens)
    assert sorted(tr, key=lambda r: tc[r].finish_t) == tr   # FIFO
    eng.assert_pool_whole()


@pytest.mark.parametrize("arch,extra", [
    # max_prompt 12 + max_out 4 = 16 = gemma3's reduced local window:
    # every layer pages, so the prefix cache is allowed
    ("gemma3-1b", ["--steps", "4", "--prefix-cache"]),
    ("deepseek-7b", ["--steps", "6", "--prefix-cache", "--n-pages", "12"]),
    ("rwkv6-7b", ["--steps", "6", "--n-pages", "8", "--no-obs"]),
    ("jamba-v0.1-52b", ["--steps", "6", "--n-pages", "8",
                        "--prefill-budget", "4"])])
def test_serve_cli_continuous(arch, extra, capsys, tmp_path):
    log = tmp_path / "traces.jsonl"
    argv = ["--arch", arch, "--reduced", "--members", "2", "--batch", "3",
            "--prompt-len", "12", "--paged", "--page-size", "4",
            "--device", "cpu", "--dtype", "float32", "--continuous",
            "--requests", "6", "--prefill-chunk", "4"] + extra
    if "--no-obs" not in extra:
        argv += ["--trace-log", str(log)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "served 6 requests | K=2 members, 3 slots" in out
    assert "paged pool:" in out and "health  peak" in out
    if "--prefix-cache" in extra:
        assert "prefix " in out and "COW copies" in out
    if "--no-obs" in extra:
        assert not log.exists()
    else:
        assert len(log.read_text().splitlines()) == 6
