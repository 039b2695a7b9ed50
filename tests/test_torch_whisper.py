"""The port's whisper-tiny (encoder-decoder: sinusoidal positions, a
full-attention encoder over frame embeddings, cross-attention in every
decoder block) against repro at its reduced config, f32, K = 2 members,
weights bridged from the JAX init.

Logits of `encode`, `apply`, contiguous prefill and decode (rows at
different positions, a chunk tail, a chunk start clamped as the JAX
package's sinusoid slice clamps it) agree with repro's within atol =
rtol = 2e-5; so does `cross_attn_apply` on both its routes (the flash
kernel's plain version and `attend`).  The engine gives the JAX
engine's greedy tokens (slots recycled, and after `swap_params`, which
recomputes the encoder frames) and its `score`; a paged engine is
refused as the JAX engine refuses it.  Gradients of apply + CE on the
training route match jax.grad within rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import kv_cache as jkv
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import EnsembleEngine
from test_torch_engine import check_init_has_the_jax_tree

TOL = dict(atol=2e-5, rtol=2e-5)
K = 2
ARCH = "whisper-tiny"
ENGINE = dict(n_slots=3, max_prompt=16, max_out=8, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these shapes it is the fastest even
    alone, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(cfg, seed):
    return jax.vmap(lambda k: jtf.init(k, cfg))(
        jax.random.split(jax.random.PRNGKey(seed), K))


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = treg.get_config(ARCH, reduced=True).with_(dtype="float32")
    jp = _init(jcfg, 0)
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _frames(cfg, B, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_max_frames, cfg.d_model)).astype(np.float32)


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 16)]


def test_config_and_tree(models):
    _, tcfg, jp, tp = models
    assert tcfg.enc_dec and not tcfg.attn.use_rope
    assert set(tp) == {"embed", "head", "final_norm", "segments",
                       "enc_segments", "enc_norm"}
    assert {"norm_cross", "cross"} <= set(tp["segments"][0]["slot_0"])
    assert set(tp["segments"][0]["slot_0"]["cross"]) == {
        "w_cross_q", "w_k", "w_v", "w_o"}
    assert "cross" not in tp["enc_segments"][0]["slot_0"]
    check_init_has_the_jax_tree(tcfg, jp)


@pytest.mark.parametrize("n,d,start", [(64, 64, None), (1500, 384, None),
                                       (8, 64, (0, 5, 120))])
def test_sinusoidal_positions(n, d, start):
    if start is None:
        want = jlayers.sinusoidal_positions(n, d)
        got = tlayers.sinusoidal_positions(n, d)
    else:
        table = np.asarray(jlayers.sinusoidal_positions(128, d))
        want = np.stack([table[s:s + n] for s in start])
        got = tlayers.sinusoidal_positions(n, d, start=torch.tensor(start))
    # the two libraries' exp differ by an ulp in some rates w_i, and the
    # angle p * w_i rounds to half an ulp of p: angles (and so sin, cos)
    # may differ by about two ulps of the largest position
    top = n + (max(start) if start else 0)
    close(got, want, dict(atol=4 * top * 2.0 ** -24, rtol=0))


@pytest.mark.parametrize("flash", [True, False])
def test_cross_attn_apply(models, flash):
    """T = 5 decoder tokens over S = 64 frames: the flash route (on the
    CPU the kernel's plain version, non-causal) and `attend`."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((K, 3, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((K, 3, 64, jcfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: a[:, 0], jp["segments"][0]["slot_0"]["cross"])
    pt = {k: v[:, 0] for k, v in tp["segments"][0]["slot_0"]["cross"].items()}
    want = jax.vmap(lambda p, a, e: jattn.cross_attn_apply(
        p, a, e, jcfg.attn))(pj, x, enc)
    got = tattn.cross_attn_apply(pt, torch.from_numpy(x),
                                 torch.from_numpy(enc), tcfg.attn, flash)
    close(got, want)


def test_encode_and_apply_match(models):
    jcfg, tcfg, jp, tp = models
    enc_in = _frames(jcfg, 2)
    tok = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    want_enc = jax.jit(jax.vmap(lambda p: jtf.encode(p, jcfg, enc_in)))(jp)
    close(ttf.encode(tp, tcfg, torch.from_numpy(enc_in)), want_enc)
    want = jax.jit(jax.vmap(lambda p: jtf.apply(
        p, jcfg, tokens=tok, enc_embeds=enc_in, remat=False)[0]))(jp)
    got, aux = ttf.apply(tp, tcfg, torch.from_numpy(tok),
                         enc_embeds=torch.from_numpy(enc_in))
    close(got, want)
    assert aux == 0.0


def _caches(models, B, max_seq):
    """JAX and port slot caches of B rows whose "enc" holds the encoder's
    frames of random embeddings."""
    jcfg, tcfg, jp, tp = models
    enc_in = _frames(jcfg, B)
    jc = jax.vmap(lambda _: jtf.init_slot_cache(jcfg, B, max_seq))(
        jnp.arange(K))
    jc["enc"] = jax.vmap(lambda p: jtf.encode(p, jcfg, enc_in))(jp)
    tc = ttf.init_slot_cache(tcfg, B, max_seq, members=K, device="cpu")
    assert tc["enc"].shape == (K, B, jcfg.enc_max_frames, jcfg.d_model)
    tc["enc"] = ttf.encode(tp, tcfg, torch.from_numpy(enc_in))
    return jc, tc


def _steps(jcfg):
    pre = jax.jit(jax.vmap(lambda p, c, t, n: jtf.prefill_slots(
        p, jcfg, c, t, n), in_axes=(0, 0, None, None)))
    dec = jax.jit(jax.vmap(lambda p, c, t: jtf.decode_step_slots(
        p, jcfg, c, t), in_axes=(0, 0, None)))
    return pre, dec


def _prefill_row(models, steps, jc, tc, b, chunk, n):
    jcfg, tcfg, jp, tp = models
    jl, jrow = steps[0](jp, jkv.slot_row(jc, b), chunk,
                        jnp.asarray([n], jnp.int32))
    jc = jkv.write_slot_row(jc, jrow, b)
    tl, trow = ttf.prefill_slots(tp, tcfg, tkv.slot_row(tc, b),
                                 torch.from_numpy(chunk),
                                 torch.tensor([n], dtype=torch.int32))
    tkv.write_slot_row(tc, trow, b)
    close(tl, jl.reshape(K, 1, -1))
    return jc


def test_prefill_and_decode_match(models):
    """Two slots prefill in chunks of 8 (11 and 6 prompt tokens: a chunk
    tail each), then decode with the rows at different positions; the
    pool's encoder frames ride through every call unchanged."""
    jcfg, tcfg, jp, tp = models
    B, C = 2, 8
    steps = _steps(jcfg)
    jc, tc = _caches(models, B, 40)
    enc0 = tc["enc"].clone()
    toks = np.random.default_rng(2).integers(0, 512, (B, 40)).astype(
        np.int32)
    for b, plen in enumerate((11, 6)):
        for start in range(0, plen, C):
            n = min(C, plen - start)
            ch = np.zeros((1, C), np.int32)
            ch[0, :n] = toks[b, start:start + n]
            jc = _prefill_row(models, steps, jc, tc, b, ch, n)
    for step in range(7):
        tk = toks[:, 20 + step:21 + step]
        jl, jc = steps[1](jp, jc, tk)
        tl, tc = ttf.decode_step_slots(tp, tcfg, tc, torch.from_numpy(tk))
        close(tl, jl)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))
    assert torch.equal(tc["enc"], enc0)


def test_sinusoid_start_clamps_like_jax(models):
    """A chunk whose positions run past cfg.max_seq (128 reduced) takes
    the sinusoid from max_seq - C on, and a decode step past it from
    max_seq - 1, as the JAX package's dynamic_slice of its table clamps
    the start: logits agree there too."""
    jcfg, tcfg, jp, tp = models
    C = 8
    steps = _steps(jcfg)
    jc, tc = _caches(models, 1, 140)
    jc["idx"] = jnp.full((K, 1), 124, jnp.int32)
    tc["idx"].fill_(124)
    ch = np.arange(1, C + 1, dtype=np.int32)[None]
    jc = _prefill_row(models, steps, jc, tc, 0, ch, C)
    for t in range(2):                      # positions 132, 133
        jl, jc = steps[1](jp, jc, ch[:, t:t + 1])
        tl, tc = ttf.decode_step_slots(tp, tcfg, tc,
                                       torch.from_numpy(ch[:, t:t + 1]))
        close(tl, jl)


@pytest.fixture(scope="module")
def jax_runs(models):
    """One JAX engine, compiled once for the module: generate twice
    (slots recycled), score a batch, then swap in other weights and
    generate again."""
    jcfg, _, jp, _ = models
    eng = JaxEngine(jcfg, jp, **ENGINE)
    out = {"first": eng.generate(_prompts(1), 8),
           "second": eng.generate(_prompts(2), 6)}
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 7)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    out["score"] = (toks, labels, eng.score(toks, labels))
    eng.swap_params(_init(jcfg, 7))
    out["swapped"] = eng.generate(_prompts(1), 8)
    out["swapped_enc"] = np.asarray(eng.cache["enc"])
    return out


def test_generate_matches_jax_engine(models, jax_runs, monkeypatch):
    """Greedy tokens equal the JAX engine's, twice over recycled slots;
    each prefill call launches the flash path twice a layer (self- and
    cross-attention), decode never."""
    _, tcfg, _, tp = models
    calls = []
    real = ops.flash_attention

    def shim(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return real(q, k, v, **kw)

    eng = EnsembleEngine(tcfg, tp, device="cpu", **ENGINE)
    monkeypatch.setattr(ops, "flash_attention", shim)
    for name, prompts, n in (("first", _prompts(1), 8),
                             ("second", _prompts(2), 6)):
        for w, g in zip(jax_runs[name], eng.generate(prompts, n)):
            np.testing.assert_array_equal(g, w)
    # self-attention over the slot's whole row plus the chunk, then
    # cross-attention over the frames
    C, S = ENGINE["prefill_chunk"], tcfg.enc_max_frames
    assert len(calls) == 2 * tcfg.n_layers * eng.prefills_run
    assert set(calls) == {(C, eng.max_seq + C, True), (C, S, False)}


def test_swap_params_recomputes_the_encoder_frames(models, jax_runs):
    jcfg, tcfg, jp, _ = models
    # an own copy: the engine holds the tensors it is given and the swap
    # writes into them
    tp = params_from_numpy(jax.device_get(jp), "cpu")
    eng = EnsembleEngine(tcfg, tp, device="cpu", **ENGINE)
    eng.generate(_prompts(1), 8)
    enc = eng.cache["enc"]
    new = params_from_numpy(jax.device_get(_init(jcfg, 7)), "cpu")
    eng.swap_params(new)
    assert eng.cache["enc"] is enc          # refilled in place
    close(enc, jax_runs["swapped_enc"])
    for w, g in zip(jax_runs["swapped"], eng.generate(_prompts(1), 8)):
        np.testing.assert_array_equal(g, w)


def test_score_matches_jax(models, jax_runs):
    """score builds its own pool with the encoder's frames of its batch."""
    _, tcfg, _, tp = models
    toks, labels, (jm, je) = jax_runs["score"]
    eng = EnsembleEngine(tcfg, tp, device="cpu", **ENGINE)
    tm, te = eng.score(toks, labels)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(te.item(), float(je), atol=1e-4, rtol=1e-4)


def test_paged_and_prefix_cache_are_refused(models):
    _, tcfg, _, tp = models
    with pytest.raises(ValueError, match="enc-dec"):
        EnsembleEngine(tcfg, tp, device="cpu", paged=True, **ENGINE)
    with pytest.raises(ValueError, match="paged=True"):
        EnsembleEngine(tcfg, tp, device="cpu", prefix_cache=True, **ENGINE)


def test_training_grads_match_jax(models):
    """d(CE of apply(remat=True)) / d params for every leaf, encoder
    included, against jax.grad of the JAX package's remat apply."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(6)
    tok = rng.integers(0, 512, (K, 2, 12)).astype(np.int32)
    labels = rng.integers(0, 512, (K, 2, 12)).astype(np.int32)
    enc_in = rng.standard_normal((K, 2, jcfg.enc_max_frames,
                                  jcfg.d_model)).astype(np.float32)

    def jloss(p, t, e, y):
        logits, _ = jtf.apply(p, jcfg, tokens=t, enc_embeds=e, remat=True)
        return jtf.ce_loss(logits, y)

    want = jax.jit(jax.vmap(jax.grad(jloss)))(jp, tok, enc_in, labels)
    leaves = jax.tree_util.tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    try:
        logits, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok), remat=True,
                              enc_embeds=torch.from_numpy(enc_in))
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


def test_serve_cli(capsys):
    """--arch whisper-tiny serves from the contiguous pool; --paged is
    refused with the engine's error."""
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--reduced", "--members", "2", "--batch", "2",
            "--prompt-len", "6", "--steps", "4", "--device", "cpu",
            "--dtype", "float32"]
    assert serve.main(argv) == 0
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="enc-dec"):
        serve.main(argv + ["--paged"])
