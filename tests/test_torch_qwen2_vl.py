"""The port's qwen2-vl-2b (M-RoPE: the rotary half-dim split in sections
over three position streams; GQA of 4 over 2 heads reduced, 12 over 2
at full width; tied embeddings) against repro at its reduced config,
f32, K = 2 members, weights bridged from the JAX init.

`apply_rope(sections=)` equals the JAX package's with distinct streams
and with coinciding ones (which is plain RoPE).  Logits of `apply` from
tokens and from `embeds` (the vision stub's input), and of paged and
contiguous prefill and decode, agree within atol = rtol = 2e-5.  Greedy
tokens equal the JAX engines', paged (one ops.paged_attention call per
layer a step) and contiguous, and the Scheduler's completions with the
prefix cache on and off equal repro's.  Gradients of apply + CE on the
training route match jax.grad within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jreg
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import EnsembleEngine
from test_torch_engine import check_init_has_the_jax_tree
from test_torch_model import _run_both
from test_torch_scheduler import (PREFIX, assert_same_completions,
                                  prefix_requests, serve_both)

TOL = dict(atol=2e-5, rtol=2e-5)
K = 2
ARCH = "qwen2-vl-2b"
ENGINE = dict(n_slots=3, max_prompt=16, max_out=8, page_size=4,
              prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these shapes it is the fastest even
    alone, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = treg.get_config(ARCH, reduced=True).with_(dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 16)]


def test_config_and_tree(models):
    _, tcfg, jp, tp = models
    a = tcfg.attn
    assert sum(a.mrope_sections) == a.head_dim // 2
    full = treg.get_config(ARCH).attn
    assert sum(full.mrope_sections) == full.head_dim // 2 == 64
    assert full.n_heads // full.n_kv_heads == 6
    assert "head" not in tp                 # tied embeddings
    check_init_has_the_jax_tree(tcfg, jp)


@pytest.mark.parametrize("streams", ["distinct", "coinciding"])
@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_apply_rope_sections(streams, sections):
    """x (B, T, H, dh) rotated by (3, B, T) positions: frequency j of
    section s by stream s.  Coinciding streams are plain RoPE."""
    rng = np.random.default_rng(0)
    dh = 2 * sum(sections)
    x = rng.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 7)).astype(np.int32)
    if streams == "coinciding":
        pos[1:] = pos[0]
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                             sections)
    # angles up to 4000 rad: the libraries' cos / sin round differently
    close(got, want, dict(atol=1e-4, rtol=0))
    if streams == "coinciding":
        plain = tlayers.apply_rope(torch.from_numpy(x),
                                   torch.from_numpy(pos[0]), 1e6)
        assert torch.equal(got, plain)
    else:   # each stream moves only its own section's features
        moved = torch.from_numpy(pos.copy())
        moved[2] += 1
        diff = (tlayers.apply_rope(torch.from_numpy(x), moved, 1e6, sections)
                != got).any(0).any(0).any(0)
        half = dh // 2
        lo = half - sections[2]
        want_cols = torch.zeros(dh, dtype=torch.bool)
        want_cols[lo:half] = want_cols[half + lo:] = True
        assert torch.equal(diff, want_cols)


@pytest.mark.parametrize("inp", ["tokens", "embeds"])
def test_apply_matches(models, inp):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(1)
    if inp == "tokens":
        tok = rng.integers(0, 512, (2, 24)).astype(np.int32)
        kw = {"tokens": tok}
        got, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok))
    else:
        emb = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
        kw = {"embeds": emb}
        got, _ = ttf.apply(tp, tcfg, embeds=torch.from_numpy(emb))
    want = jax.jit(jax.vmap(
        lambda p: jtf.apply(p, jcfg, remat=False, **kw)[0]))(jp)
    close(got, want)


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_and_decode_match(models, paged):
    _run_both(models, 40, paged=paged, tol=TOL)


@pytest.mark.parametrize("paged", [True, False])
def test_generate_matches_jax_engine(models, monkeypatch, paged):
    """Greedy tokens equal the JAX engine's.  Paged, every decode step
    makes one paged_attention call per layer over the K members' rows at
    the full head count (the kernel's group of H / Hkv query heads a kv
    head)."""
    jcfg, tcfg, jp, tp = models
    kw = dict(ENGINE, paged=paged)
    calls = []
    real = ops.paged_attention

    def shim(q, k_pages, *a, **k):
        calls.append((tuple(q.shape), k_pages.shape[2]))
        return real(q, k_pages, *a, **k)

    monkeypatch.setattr(ops, "paged_attention", shim)
    eng = EnsembleEngine(tcfg, tp, device="cpu", **kw)
    got = eng.generate(_prompts(), 8)
    for w, g in zip(JaxEngine(jcfg, jp, **kw).generate(_prompts(), 8), got):
        np.testing.assert_array_equal(g, w)
    a = tcfg.attn
    if not paged:
        assert calls == []
        return
    assert len(calls) == tcfg.n_layers * eng.steps_run
    assert set(calls) == {((K * ENGINE["n_slots"], a.n_heads, a.head_dim),
                           a.n_kv_heads)}


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_scheduler_prefix_cache_matches_jax(models, prefix_cache):
    """Scheduler.run over paged engines (prefix cache off, then on: hits
    and copy-on-write pages) gives repro's completions."""
    kw = dict(PREFIX, n_pages=14, prefix_cache=prefix_cache)
    runs = serve_both(models, prefix_requests(), kw)
    assert_same_completions(runs)
    teng = runs[1][0]
    assert teng.page_stats() == runs[0][0].page_stats()
    if prefix_cache:
        ps = teng.page_stats()
        assert ps["prefix_hits"] > 0 and ps["cow_pages"] > 0
    teng.assert_pool_whole()


def test_training_grads_match_jax(models):
    """d(CE of apply(remat=True)) / d params for every leaf against
    jax.grad of the JAX package's remat apply."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(6)
    tok = rng.integers(0, 512, (K, 2, 12)).astype(np.int32)
    labels = rng.integers(0, 512, (K, 2, 12)).astype(np.int32)

    def jloss(p, t, y):
        logits, _ = jtf.apply(p, jcfg, tokens=t, remat=True)
        return jtf.ce_loss(logits, y)

    want = jax.jit(jax.vmap(jax.grad(jloss)))(jp, tok, labels)
    leaves = jax.tree_util.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    try:
        logits, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok), remat=True)
        ce = F.cross_entropy(logits.flatten(1, 2).transpose(1, 2),
                             torch.from_numpy(labels).long().flatten(1),
                             reduction="none").mean(1)
        grads = torch.autograd.grad(ce.sum(), leaves)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    wl = jax.tree_util.tree_leaves(want)
    assert len(wl) == len(grads)
    for w, g in zip(wl, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_serve_cli_paged_prefix_cache(capsys):
    """--arch qwen2-vl-2b under continuous batching, paged, prefix cache
    on: every reduced layer pages."""
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--members", "2",
                       "--batch", "2", "--prompt-len", "8", "--steps", "4",
                       "--paged", "--page-size", "4", "--continuous",
                       "--prefix-cache", "--requests", "4", "--device",
                       "cpu", "--dtype", "float32"]) == 0
    assert "tok/s" in capsys.readouterr().out
