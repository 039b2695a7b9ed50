"""The port's dry-run (launch/dryrun.py, specs.py, cost_analysis.py,
mesh.py, roofline.py) and the kernels' custom ops (kernels/library.py).

A fake world is the default process group of the process that makes it,
so every test that needs one runs in a child process: the known module
of tests/test_hlo_analysis.py (a 7-step loop of TP matmuls on 4 ranks:
its FLOPs, its 7 all-reduces and their bytes), `constrain`'s semantics on
DTensors, the custom ops' sharding rules, AdamW on a member-sharded
DTensor, a decode token's write into a sharded cache plane, and reduced
gemma3-1b's prefill cell on a (2, 2) mesh.

Reduced gemma3-1b's train_4k[plain] and prefill_32k cells (cut to T 32 /
B 8 and T 64 / B 4) on a (1, 1) mesh are held against the JAX package's
hlo_analysis of the same cells (a JAX child, the registry patched to the
reduced config there, as test_hlo_analysis.py runs it): prefill agrees
exactly; train differs by one named term.  Both recompute the forward in
the backward (JAX's remat, torch.utils.checkpoint), and both skip
recomputing the last matmul of each checkpointed unit, whose output only
the next unit reads: JAX checkpoints a repetition of the layer pattern
(two units at 7 layers: 6 + 1), the port every block (seven), so the
port recomputes 5 fewer down-projections a microbatch.  The (2, 2)
comparison is recorded (printed), not gated.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.common.types import ShapeConfig
from repro_torch.configs import registry as treg

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TRAIN = ShapeConfig("train_4k", 32, 8, "train")
PREFILL = ShapeConfig("prefill_32k", 64, 4, "prefill")

PORT_WORLD = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.common import sharding as shd
    from repro_torch.common.types import ShapeConfig
    from repro_torch.configs import registry
    from repro_torch.kernels import library
    from repro_torch.launch import cost_analysis, dryrun
    from repro_torch.launch.mesh import make_mesh
    out = {{}}

    # --- the known module: x (64, 128) replicated, w_i column-sharded
    mesh = make_mesh((4,), ("model",), "cpu")
    dm = mesh.device_mesh
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 128), dm, [Replicate()])
        ws = distribute_tensor(torch.empty(7, 128, 128), dm, [Shard(2)])

        def f(x, ws):
            for i in range(7):
                h = x @ ws[i]                          # (64, 128/4)
                h = shd.constrain(h, None, "model")
                y = h @ ws[i].t()                      # partial sums
                x = shd.constrain(y, None, shd.REP)    # the carry
            return x.sum()
        _, c = cost_analysis.analyze(f, x, ws, links=mesh.links())
    out["known"] = dict(flops=c.flops, count=c.collective_count,
                        bytes=c.collective_bytes, hbm=c.hbm_bytes,
                        links=c.link_bytes)

    # --- constrain: pinned, unconstrained, REP, pending sums
    mesh2 = make_mesh((2, 2), ("data", "model"), "cpu")
    d2 = mesh2.device_mesh
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(8, 16), d2, [Shard(0), Shard(1)])
        pl = lambda t: [str(p) for p in t.placements]  # noqa: E731
        out["keep"] = pl(shd.constrain(a, None, None))
        out["rep"] = pl(shd.constrain(a, None, shd.REP))
        out["pin"] = pl(shd.constrain(a, "model", None))
        with shd.layout_ctx(batch=("data",)):
            out["role"] = pl(shd.constrain(a, "batch", None))
        p = DTensor.from_local(torch.empty(8, 16), d2,
                               [Replicate(), Partial()], run_check=False)
        out["partial"] = pl(shd.constrain(p, "data", None))
        out["plain_is_noop"] = shd.constrain(torch.empty(3), "model") \\
            is not None
        out["tuple"] = [str(q) for q in shd.placements(
            (("data", "model"), None), d2)]
        out["shardings"] = {{k: [str(q) for q in v] for k, v in
                            shd.make_shardings(d2, {{"w": ("model", None),
                                                    "b": (None,)}}).items()}}

        # the flash op's rules: rows and heads run shard by shard
        library.register_sharding_rules()
        rules = {{}}
        for name, dim in (("rows", 0), ("heads", 2)):
            q = distribute_tensor(torch.empty(4, 8, 4, 32, device="cpu"),
                                  d2, [Shard(dim), Replicate()])
            k = distribute_tensor(torch.empty(4, 8, 2, 32), d2,
                                  [Shard(dim), Replicate()])
            o, cc = cost_analysis.analyze(
                lambda q, k: torch.ops.repro_torch.flash_attention(
                    q, k, k, None, None, True, 0, None), q, k)
            rules[name] = dict(out=pl(o),
                               colls=sum(cc.collective_count.values()),
                               flops=cc.flops, calls=cc.kernel_calls)
        out["flash_rules"] = rules

    # --- AdamW over a member-sharded DTensor (members over "data"),
    # large leaves in pieces: rank 0's shard against the plain update
    from repro_torch.optim import optimizers as opt_mod
    opt_mod._ONE_PASS = opt_mod._PIECE = 96
    torch.manual_seed(0)
    K = 4
    p = torch.randn(K, 8, 40)
    g = torch.randn(K, 8, 40) * 3
    opt = opt_mod.adamw(1e-2, clip_norm=1.0)
    plain = {{"w": p.clone()}}
    st = opt.init(plain)
    opt.update({{"w": g.clone()}}, st, plain)
    opt.update({{"w": g.clone() * 0.5}}, st, plain)
    lay = [Shard(0), Replicate()]
    dp = {{"w": distribute_tensor(p.clone(), d2, lay)}}
    dst = {{"m": {{"w": distribute_tensor(torch.zeros(K, 8, 40), d2, lay)}},
           "v": {{"w": distribute_tensor(torch.zeros(K, 8, 40), d2, lay)}},
           "step": distribute_tensor(torch.zeros(K, dtype=torch.int32), d2,
                                     [Replicate(), Replicate()])}}
    with implicit_replication():
        for s in (1.0, 0.5):
            opt.update({{"w": distribute_tensor(g.clone() * s, d2, lay)}},
                       dst, dp)
    out["adamw_err"] = float((dp["w"].to_local()
                              - plain["w"][:K // 2]).abs().max())
    out["adamw_local"] = list(dp["w"].to_local().shape)

    # --- a decode token written into a sharded cache plane (a layer's
    # view of a stacked leaf): rank 0's shard against the plain write.
    # Rows over "data"; the sequence or the kv heads over "model".
    from repro_torch.models import attention as attn_mod
    torch.manual_seed(1)
    full = torch.randn(1, 3, 4, 8, 2, 3)
    vals = torch.randn(1, 4, 2, 3)
    slot = torch.tensor([1, 5, 3, 7])      # rank 0: rows 0-1, slots 0-3
    want = full.clone()
    want[:, 1][:, torch.arange(4), slot] = vals
    errs = {{}}
    for name, dim, sl in (("seq", 3, (slice(0, 2), slice(0, 4))),
                          ("heads", 4, (slice(0, 2), slice(None),
                                        slice(0, 1)))):
        lay = [Shard(2), Shard(dim)]
        ix = (slice(None), slice(None)) + sl
        dfull = DTensor.from_local(full[ix].clone(), d2, lay,
                                   run_check=False, shape=full.shape,
                                   stride=full.stride())
        dv = DTensor.from_local(vals, d2, [Replicate(), Replicate()],
                                run_check=False)
        attn_mod._write_token(dfull[:, 1], dv, torch.arange(4), slot)
        errs[name] = float((dfull.to_local() - want[ix]).abs().max())
    out["write_token_err"] = errs

    # --- reduced gemma3-1b prefill on the (2, 2) mesh
    cfg = registry.get_config("gemma3-1b", reduced=True)
    rec = dryrun.run_cell("gemma3-1b", "prefill_32k", False, device="cpu",
                          mesh=mesh2, cfg=cfg,
                          shape=ShapeConfig("prefill_32k", 64, 4, "prefill"))
    out["prefill_2x2"] = {{k: rec.get(k) for k in (
        "status", "error", "flops_per_dev", "bytes_per_device",
        "collective_count", "collective_bytes_by_link", "kernel_calls")}}
    print("PORT_WORLD " + json.dumps(out))
""")

JAX_CELLS = textwrap.dedent("""
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
    types.SHAPES["prefill_32k"] = ShapeConfig("prefill_32k", 64, 4,
                                              "prefill")
    out = {{}}
    for name, shape, n in (("train_1x1", "train_4k", 1),
                           ("prefill_1x1", "prefill_32k", 1),
                           ("prefill_2x2", "prefill_32k", 2)):
        devs = np.array(jax.devices()[: n * n]).reshape(n, n)
        mesh = Mesh(devs, ("data", "model"))
        cell = specs.build_cell("gemma3-1b", shape, mesh, False)
        with set_mesh(mesh):
            c = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                        out_shardings=cell.out_shardings,
                        donate_argnums=cell.donate).lower(
                *cell.args).compile()
        hc = hlo_analysis.analyze(c.as_text())
        out[name] = dict(flops=hc.flops, accum=cell.meta["accum"],
                         collective_count=hc.collective_count)
    print("JAX_CELLS " + json.dumps(out))
""")


def _child(script: str, tag: str):
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
    """The fake-world child and the JAX child, started together."""
    port = _child(PORT_WORLD, "PORT_WORLD")
    jax_ = _child(JAX_CELLS, "JAX_CELLS")
    return {"port": port, "jax": jax_}


@pytest.fixture(scope="module")
def port_world(children):
    return _result(children["port"], "PORT_WORLD")


@pytest.fixture(scope="module")
def jax_cells(children):
    return _result(children["jax"], "JAX_CELLS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cell(shape: ShapeConfig) -> dict:
    """Reduced gemma3-1b on the (1, 1) mesh, in this process (one device
    needs no process group)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    rec = dryrun.run_cell("gemma3-1b", shape.name, False, device="cpu",
                          mesh=make_test_mesh(),
                          cfg=treg.get_config("gemma3-1b", reduced=True),
                          shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


def test_known_module(port_world):
    k = port_world["known"]
    expect = 2 * 7 * 2 * 64 * 128 * 128 / 4
    assert 0.99 < k["flops"] / expect < 1.01, k["flops"] / expect
    assert k["count"]["all-reduce"] == 7, k["count"]
    assert sum(k["count"].values()) == 7, k["count"]
    assert abs(k["bytes"]["all-reduce"] - 7 * 64 * 128 * 4 * 2) < 1
    assert k["hbm"] > 0
    # 4 consecutive ranks lie in one node of 8: NVLink
    assert k["links"]["nvlink"] == k["bytes"]["all-reduce"]
    assert k["links"]["ib"] == 0


def test_constrain_semantics(port_world):
    w = port_world
    assert w["keep"] == ["S(0)", "S(1)"]        # unnamed dims keep theirs
    assert w["rep"] == ["S(0)", "R"]            # REP gathers dim 1
    assert w["pin"] == ["R", "S(0)"]            # "model" pins dim 0
    assert w["role"] == ["S(0)", "S(1)"]        # batch -> ("data",)
    assert w["partial"] == ["S(0)", "R"]        # pending sums reduce
    assert w["plain_is_noop"]
    assert w["tuple"] == ["S(0)", "S(0)"]
    assert w["shardings"] == {"w": ["R", "S(0)"], "b": ["R", "R"]}


def test_flash_sharding_rules(port_world):
    """Rows or heads sharded: the op runs shard by shard, no collective,
    half the pairs a rank (one mesh dim of 2)."""
    r = port_world["flash_rules"]
    full = 2 * 4 * 8 * 8 * 4 * (32 + 32)
    for name, dim in (("rows", 0), ("heads", 2)):
        assert r[name]["out"] == [f"S({dim})", "R"], r[name]
        assert r[name]["colls"] == 0, r[name]
        assert r[name]["flops"] == full // 2
        assert r[name]["calls"] == {"flash_attention": 1}


def test_adamw_member_sharded_dtensor(port_world):
    """Members over "data": rank 0 updates its two members in place, in
    pieces, with their own clip scales and steps, as the plain update
    does."""
    assert port_world["adamw_local"] == [2, 8, 40]
    assert port_world["adamw_err"] < 1e-6


def test_write_token_sharded_plane(port_world):
    """A decode token lands in this rank's shard of a DTensor cache plane
    by an indexed write, the row whose slot lies on another shard left
    alone, sequence- or head-sharded."""
    assert port_world["write_token_err"] == {"seq": 0.0, "heads": 0.0}


def test_reduced_prefill_matches_jax(jax_cells):
    """The flash kernel's custom op (its formula counts every pair, as
    the reference's einsums do), one call a layer; the kernel's own count
    skips the masked tiles."""
    want = jax_cells["prefill_1x1"]["flops"]
    kern = _port_cell(PREFILL)
    assert kern["flops_per_dev"] == want
    layers = treg.get_config("gemma3-1b", reduced=True).n_layers
    assert kern["kernel_calls"] == {"flash_attention": layers}
    assert kern["flops_executed_per_dev"] == want


def test_reduced_train_matches_jax(jax_cells):
    """Within 5%, and exactly the named remat difference."""
    got = _port_cell(TRAIN)
    want = jax_cells["train_1x1"]["flops"]
    assert abs(got["flops_per_dev"] / want - 1) < 0.05
    cfg = treg.get_config("gemma3-1b", reduced=True)
    accum = jax_cells["train_1x1"]["accum"]
    assert eval(got["meta"]["accum"]) == accum
    tokens = TRAIN.global_batch * TRAIN.seq_len // accum
    jax_units = len(cfg.segments())
    down = 2 * tokens * cfg.d_model * cfg.ffn.d_ff
    assert want - got["flops_per_dev"] == \
        (cfg.n_layers - jax_units) * accum * down


def test_prefill_2x2_recorded(port_world, jax_cells):
    """The (2, 2) comparison: recorded, not gated."""
    port = port_world["prefill_2x2"]
    assert port["status"] == "ok", port
    ratio = port["flops_per_dev"] / jax_cells["prefill_2x2"]["flops"]
    print(f"prefill_32k reduced gemma3-1b 2x2: port/JAX flops per device "
          f"{ratio:.4f} (port {port['flops_per_dev']:.6g}, JAX "
          f"{jax_cells['prefill_2x2']['flops']:.6g}); port collectives "
          f"{port['collective_count']}, JAX "
          f"{jax_cells['prefill_2x2']['collective_count']}")
    assert ratio > 0


def test_flop_formulas_and_live_tiles():
    """The custom ops' fake implementations and flop formulas under
    FakeTensorMode (CPU fake tensors: the op's fake kernel serves any
    device), and the flash kernel's executed count against the tile-skip
    predicate's twin."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import library, ref
    from repro_torch.launch import cost_analysis
    with FakeTensorMode():
        q = torch.empty(3, 96, 8, 64)
        k = torch.empty(3, 160, 2, 64)
        o, c = cost_analysis.analyze(
            lambda: torch.ops.repro_torch.flash_attention(
                q, k, k, None, None, True, 32, None))
        assert tuple(o.shape) == (3, 96, 8, 64)
        assert c.flops == 2 * 3 * 96 * 160 * 8 * (64 + 64)
        bq, bk = fa.tiles(64, torch.float32)
        live = library.flash_live_tiles(96, 160, 4, bq, bk, True, 32)
        assert c.flops_executed == 2 * 3 * 2 * live * bq * bk * 128
        assert c.flops_executed < c.flops
        a = torch.empty(2, 5, 6, 4)
        st = torch.empty(1, 2, 6, 4)
        hs, c2 = cost_analysis.analyze(
            lambda: torch.ops.repro_torch.ssm_scan(a, a, st))
        assert tuple(hs.shape) == (2, 5, 6, 4) and c2.flops == 0
        r = torch.empty(2, 5, 3, 16)
        y, c3 = cost_analysis.analyze(lambda: torch.ops.repro_torch.wkv6(
            r, r, r, r, torch.empty(1, 3, 16), torch.empty(1, 2, 3, 16, 16)))
        assert c3.flops == 4 * 2 * 5 * 3 * 16 * 16
        lse, gold, dot = torch.ops.repro_torch.distill_loss_fwd(
            torch.empty(7, 50), torch.empty(7, dtype=torch.int32),
            torch.empty(7, 50))
        assert tuple(lse.shape) == (7,)
    for T, S, g, bq, bk, causal, window in (
            (96, 160, 4, 64, 32, True, 32), (128, 128, 1, 64, 64, True, 0),
            (100, 100, 3, 64, 64, False, 0), (1500, 1500, 1, 64, 64,
                                              False, 0)):
        twin = ref.flash_tile_live(1, T, S, g, bq, bk, causal, window)
        assert library.flash_live_tiles(T, S, g, bq, bk, causal, window) \
            == int(twin.sum())


def test_cli_and_roofline(tmp_path):
    """The CLI in a child on one reduced cell (a (1, 1) mesh: the
    (2, 2) one is the fake-world child's), then the table rendered from
    its record and from a skip and a failure."""
    out = tmp_path / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "decode_32k", "--reduced", "--mesh", "1x1",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "== 1 ok / 0 skip / 0 fail ==" in proc.stdout
    recs = json.loads(out.read_text())
    rec = recs[0]
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["step"] == "serve_step"
    assert rec["state_bytes_per_device"]["cache"] > 0
    recs += [{"arch": "llama3-405b", "shape": "long_500k", "status": "skip",
              "reason": "pure full-attention arch"},
             {"arch": "x", "shape": "y", "status": "fail",
              "error": "RuntimeError: no rule"}]
    out.write_text(json.dumps(recs))
    from repro_torch.launch import roofline
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert roofline.main(["--in", str(out)]) == 0
    text = buf.getvalue()
    assert "| gemma3-1b | decode_32k |" in text
    assert "| skip | pure full-attention arch |" in text
    assert "| FAIL | RuntimeError: no rule |" in text
    assert "1 traced, 1 fit" in text
