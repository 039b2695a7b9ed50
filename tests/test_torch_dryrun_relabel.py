"""The dry-run's relabel step and its split train cells, against the JAX
package, on the CPU.

A fake world is the default process group of the process that makes it,
so the port's cells trace in a child process (4 ranks, a (2, 2) mesh
of ("data", "model")), and the JAX package's in another (its own
run_cell path: specs.build_cell, jit, hlo_analysis), both started
together.

- Reduced gemma3-1b's relabel cell (train_4k cut to T 32, B 8: K = 2
  members along "data", m = int(4 x 0.7) = 2 rows a member, top-64)
  against the reference's relabel_step: the dot FLOPs a device equal
  (ratio 1, no tolerance: both score the same rows through the same
  dots, the port's flash op counted by its formula), and so do the
  collective-permutes, 7 of them and their bytes: a hop moves the
  visiting tokens and the accumulator's three planes (vals, idx, rest),
  the home hop the accumulator; neither ring moves the labels (XLA drops
  the reference's label permute as dead, the port never sends it).  The
  other collectives (DTensor's all-gathers and all-reduces against
  XLA's) are printed, not gated.
- At T 32, B 20 (m = 7 rows, so that int(b x 0.7) x T = int(b x T x
  0.7)), a hop's permute bytes are paper.aggregation_cost's top-M hop
  for the same tokens (each token's accumulator entry and the token);
  the home hop carries the accumulator alone.
- A reduced train cell with accum = 2 (T 32, B 16 on the (2, 2) mesh),
  plain and distill, traced whole and split (a microbatch apart, the
  update apart) gives equal FLOPs, HBM bytes, collectives (count, bytes,
  links) and peak; its FLOPs are the reference's less exactly the named
  remat term.
- A softmax over vocabulary-sharded logits: torch's gathers them, the
  ring score's moves row statistics.
- Reduced jamba's train cell: Mamba's step loop traced a step for all
  and counted gives the loop's FLOPs, bytes and collectives.
- The CLI's --variant relabel on a (1, 1) mesh (K = 1: the member's
  score of its own rows, no permute).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.core.compression import bytes_per_token
from repro_torch.paper import aggregation_cost as cost

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PORT_CELLS = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.common.types import ShapeConfig
    from repro_torch.configs import registry
    from repro_torch.kernels import library
    from repro_torch.launch import cost_analysis, dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import build_cell
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = registry.get_config("gemma3-1b", reduced=True)
    out = {{}}
    for name, b in (("relabel", 8), ("relabel_b20", 20)):
        rec = dryrun.run_cell("gemma3-1b", "train_4k", False,
                              variant="relabel", device="cpu", mesh=mesh,
                              cfg=cfg, shape=ShapeConfig("train_4k", 32, b,
                                                         "train"))
        out[name] = {{k: rec.get(k) for k in (
            "status", "error", "traceback", "flops_per_dev",
            "collective_count", "collective_bytes", "kernel_calls",
            "parts", "meta")}}
    from repro_torch.core import aggregation as agg
    from repro_torch.launch.specs import abstract
    out["softmax"] = {{}}
    with FakeTensorMode():   # logits (4, 32, 256) over "model" by vocab
        x = abstract((4, 32, 256), torch.float32, (None, None, "model"),
                     mesh, "cpu")
        for name, fn in (("torch", lambda t: torch.softmax(t, dim=-1)),
                         ("port", agg._softmax)):
            _, c = cost_analysis.analyze(fn, x, links=mesh.links())
            out["softmax"][name] = {{k: c.collective_bytes[k] for k in
                                     ("all-gather", "all-reduce")}}
    library.register_sharding_rules()
    for variant in ("plain", "distill"):
        got = {{}}
        for whole in (True, False):
            with FakeTensorMode():
                cell = build_cell("gemma3-1b", "train_4k", mesh, False,
                                  variant=variant, device="cpu", cfg=cfg,
                                  shape=ShapeConfig("train_4k", 32, 16,
                                                    "train"))
                if whole:         # the step of accum microbatches at once
                    with implicit_replication():
                        _, c = cost_analysis.analyze(cell.fn, *cell.args,
                                                     links=mesh.links())
                else:
                    _, c = dryrun.trace_cell(cell, mesh)
            got["whole" if whole else "split"] = dict(
                flops=c.flops, flops_executed=c.flops_executed,
                hbm=c.hbm_bytes, peak=c.peak_bytes,
                count=c.collective_count, bytes=c.collective_bytes,
                links=c.link_bytes, kernels=c.kernel_calls,
                accum=cell.meta["accum"],
                parts=[[p[0], p[1]] for p in cell.parts or ()])
        out["split_" + variant] = got
    print("PORT_CELLS " + json.dumps(out))
""")

MAMBA_COUNTED = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.common.types import ShapeConfig
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import ssm
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = registry.get_config("jamba-v0.1-52b", reduced=True)
    ssm.MAMBA_CHUNK = 8          # T 20: chunks of 8, 8 and 4 steps
    counted = ssm._fake
    out = {{}}
    for name, fake in (("loop", lambda x: False), ("counted", counted)):
        ssm._fake = fake
        with FakeTensorMode():
            cell = build_cell("jamba-v0.1-52b", "train_4k", mesh, False,
                              device="cpu", cfg=cfg,
                              shape=ShapeConfig("train_4k", 20, 4, "train"))
            _, c = dryrun.trace_cell(cell, mesh)
        out[name] = dict(flops=c.flops, flops_executed=c.flops_executed,
                         hbm=c.hbm_bytes, peak=c.peak_bytes,
                         count=c.collective_count, bytes=c.collective_bytes,
                         links=c.link_bytes, ops=c.n_ops,
                         parts=[[p[0], p[1]] for p in cell.parts or ()])
    print("MAMBA_COUNTED " + json.dumps(out))
""")

JAX_RELABEL = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import json, sys
    sys.path.insert(0, {src!r})
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.common import types
    from repro.common.sharding import set_mesh
    from repro.common.types import ShapeConfig
    from repro.configs import registry
    from repro.launch import hlo_analysis, specs

    red = registry.get_config("gemma3-1b", reduced=True)
    registry.get_config = lambda arch, reduced=False: red
    types.SHAPES["train_4k"] = ShapeConfig("train_4k", 32, 8, "train")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    cell = specs.build_cell("gemma3-1b", "train_4k", mesh, False,
                            variant="relabel")
    with set_mesh(mesh):
        c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                    out_shardings=cell.out_shardings,
                    donate_argnums=cell.donate).lower(*cell.args).compile()
    hc = hlo_analysis.analyze(c.as_text())
    types.SHAPES["train_4k"] = ShapeConfig("train_4k", 32, 16, "train")
    train = specs.build_cell("gemma3-1b", "train_4k", mesh, False)
    with set_mesh(mesh):
        ct = jax.jit(train.fn, in_shardings=train.in_shardings,
                     out_shardings=train.out_shardings,
                     donate_argnums=train.donate).lower(
            *train.args).compile()
    print("JAX_RELABEL " + json.dumps(dict(
        flops=hc.flops, count=hc.collective_count,
        bytes=hc.collective_bytes, m=cell.meta["per_member"],
        k=cell.meta["k"],
        train_flops=hlo_analysis.analyze(ct.as_text()).flops,
        train_accum=train.meta["accum"])))
""")


def _child(script: str):
    return subprocess.Popen(
        [sys.executable, "-c", script.format(src=SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def _result(proc, tag: str) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


@pytest.fixture(scope="module")
def children():
    """The fake-world children and the JAX child, started together."""
    return {"port": _child(PORT_CELLS), "jax": _child(JAX_RELABEL),
            "mamba": _child(MAMBA_COUNTED)}


@pytest.fixture(scope="module")
def port(children):
    return _result(children["port"], "PORT_CELLS")


@pytest.fixture(scope="module")
def jax_relabel(children):
    return _result(children["jax"], "JAX_RELABEL")


def test_mamba_steps_counted_as_the_loop(children):
    """Reduced jamba's train cell on the (2, 2) mesh (T 20 in Mamba
    chunks of 8, 8 and 4 steps, accum 2): a chunk's steps traced one for
    all and counted (models/ssm._CountedChunk) give the step loop's
    FLOPs, HBM bytes and collectives exactly, in fewer ops."""
    got = _result(children["mamba"], "MAMBA_COUNTED")
    loop, counted = got["loop"], got["counted"]
    assert loop["parts"] == counted["parts"] == [
        ["microbatch 0", 1], ["microbatch", 1], ["update", 1]]
    for key in ("flops", "flops_executed", "hbm", "count", "bytes",
                "links"):
        assert loop[key] == counted[key], key
    print(f"peak loop {loop['peak']} counted {counted['peak']}; ops "
          f"{loop['ops']} -> {counted['ops']}")
    assert counted["ops"] < loop["ops"]


def test_relabel_cell_matches_jax(port, jax_relabel):
    got = port["relabel"]
    assert got["status"] == "ok", got["traceback"]
    want = jax_relabel
    meta = got["meta"]
    assert (int(meta["k"]), int(meta["per_member"])) == (want["k"],
                                                         want["m"]) == (2, 2)
    ratio = got["flops_per_dev"] / want["flops"]
    print(f"relabel_step reduced gemma3-1b 2x2: port/JAX dot FLOPs a "
          f"device {ratio:.6f} (port {got['flops_per_dev']:.6g}); "
          f"collectives port {got['collective_count']}, JAX "
          f"{ {k: v for k, v in want['count'].items() if v} }")
    assert got["flops_per_dev"] == want["flops"]
    assert got["collective_count"]["collective-permute"] == \
        want["count"]["collective-permute"] == 7
    assert got["collective_bytes"]["collective-permute"] == \
        want["bytes"]["collective-permute"]
    # one hop and the home hop; the K scores through the flash op
    layers = 7   # the reduced config's
    assert got["parts"] == [["score", 2], ["merge", 1], ["hop", 1],
                            ["home", 1]]
    assert got["kernel_calls"] == {"flash_attention": 2 * layers}


def test_permute_bytes_equal_aggregation_cost(port):
    """A hop moves each relabel token's accumulator entry and the token
    (int32): aggregation_cost's hop, M * 8 + 4 + 4 bytes a token.  The
    home hop moves the accumulator alone."""
    got = port["relabel_b20"]
    assert got["status"] == "ok", got["traceback"]
    K, m, T, M = 2, int(got["meta"]["per_member"]), 32, 64
    assert m == 7
    tokens = cost.relabel_tokens(20 // K * T, 0.7)
    assert tokens == m * T
    home = tokens * bytes_per_token(M)
    hop = (got["collective_bytes"]["collective-permute"] - home) / (K - 1)
    assert hop == cost.ring_topm_bytes(1, tokens, M)
    assert hop - home == tokens * 4


@pytest.mark.parametrize("variant", ["plain", "distill"])
def test_train_cell_split_equals_whole(port, variant):
    got = port["split_" + variant]
    whole, split = got["whole"], got["split"]
    assert whole["accum"] == 2
    assert split["parts"] == [["microbatch 0", 1], ["microbatch", 1],
                              ["update", 1]]
    for key in ("flops", "flops_executed", "hbm", "peak", "count", "bytes",
                "links", "kernels"):
        assert whole[key] == split[key], key


def test_train_cell_2x2_matches_jax(port, jax_relabel):
    """The (2, 2) train cell's FLOPs a device are the reference's less
    exactly the remat term of the (1, 1) cell (tests/test_torch_dryrun.py),
    shared over the "model" axis: attention's work is not replicated
    over the heads' ranks (it was, by 1.065x the reference's, before
    attention ran shard by shard)."""
    from repro_torch.configs import registry as treg
    cfg = treg.get_config("gemma3-1b", reduced=True)
    got = port["split_plain"]["split"]["flops"]
    want = jax_relabel["train_flops"]
    accum = jax_relabel["train_accum"]
    assert accum == port["split_plain"]["split"]["accum"] == 2
    K, B, T, model = 2, 16, 32, 2
    tokens = B // K // accum * T // model      # a microbatch's, a device's
    down = 2 * tokens * cfg.d_model * cfg.ffn.d_ff
    assert want - got == (cfg.n_layers - len(cfg.segments())) * accum * down


def test_sharded_softmax_moves_no_logits(port):
    """torch.softmax over logits whose vocabulary is split over "model"
    gathers them whole (DTensor replicates the softmax dim: 4 x 32 x 256
    f32, 131,072 bytes); the ring's score takes it from the row's max
    and sum, two all-reduces of 4 x 32 f32 each, as distill's
    log-softmax does."""
    got = port["softmax"]
    assert got["torch"] == {"all-gather": 4 * 32 * 256 * 4,
                            "all-reduce": 0.0}
    assert got["port"] == {"all-gather": 0.0, "all-reduce": 2 * 4 * 32 * 4}


def test_cli_relabel_one_device(tmp_path):
    """--variant relabel takes the train shapes only; on a (1, 1) mesh
    K = 1: the member scores its own rows, nothing is permuted."""
    out = tmp_path / "relabel.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--variant", "relabel", "--reduced", "--mesh", "1x1",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "== 1 ok / 0 skip / 0 fail ==" in proc.stdout
    rec = json.loads(out.read_text())[0]
    assert rec["step"] == "relabel_step" and rec["shape"] == "train_4k"
    assert rec["collective_count"] == {}
    assert [p[0] for p in rec["parts"]][0] == "score"
    assert rec["flops_per_dev"] > 0 and rec["useful_flops_ratio"] > 0
