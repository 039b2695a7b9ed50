"""The port's deepseek-v2 (multi-head latent attention, a dense first
layer, then MoE layers with a shared expert) against repro at its
reduced config, f32, K = 4 members, weights bridged from the JAX init.

Logits of `apply`, of contiguous prefill and decode (the latent
expanded over the whole plane) and of paged prefill and decode (the
absorbed form through ops.paged_attention, the rope keys as `k_extra`)
agree with repro's within atol = rtol = 2e-5.  Greedy `generate` gives
the JAX engine's tokens, paged and contiguous, and the absorbed paged
decode gives the expanded contiguous one's tokens (the reassociated
contractions do not move an argmax at f32).  Two EC rounds (one plain,
one opening with distill steps) match the JAX Trainer within rtol 1e-4,
as tests/test_torch_lm_train.py holds deepseek-7b.  The Scheduler gives
the same tokens with the prefix cache on and off, where copy-on-write
copies the rope-key pages with the latent pages.
"""
import jax
import numpy as np
import pytest
import torch

from repro.common.types import ECConfig as JEC
from repro.configs import registry as jreg
from repro.data import lm_member_datasets as jdata
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer
from repro.serving import EnsembleEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.common.types import ECConfig as TEC
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.trainer import Trainer as TTrainer
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.scheduler import Scheduler
from test_torch_engine import check_init_has_the_jax_tree
from test_torch_model import _run_both

TOL = dict(atol=2e-5, rtol=2e-5)
K = 4
ARCH = "deepseek-v2-236b"
ENGINE = dict(n_slots=4, max_prompt=16, max_out=10, page_size=4,
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


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (5, 13, 16)]


def test_reduced_config_is_the_architecture(models):
    _, tcfg, _, tp = models
    assert tcfg.attn.kind == "mla" and tcfg.first_dense_layers == 1
    specs = tcfg.layer_specs()
    assert specs[0].ffn == "dense" and all(s.ffn == "moe"
                                           for s in specs[1:])
    seg0, seg1 = tp["segments"]
    assert {"kv_down", "k_rope", "kv_up", "w_o", "q_down",
            "q_up"} == set(seg1["slot_0"]["attn"])
    assert "shared" in seg1["slot_0"]["moe"] and "mlp" in seg0["slot_0"]
    # MLA attends over the whole sequence: it pages at any max_seq
    assert all(ttf.layer_pages(tcfg, s, 10 ** 6) for s in specs)
    cache = ttf.init_slot_cache(tcfg, 2, 16, page_size=4, n_pages=8,
                                members=K, device="cpu")
    assert set(cache["segments"][1]["slot_0"]) == {"c_kv_pages",
                                                   "k_r_pages"}
    assert cache["segments"][1]["slot_0"]["c_kv_pages"].shape == (
        K, 2, 8, 4, tcfg.attn.kv_lora_rank)


def test_torch_init_has_the_jax_tree(models):
    _, tcfg, jp, _ = models
    check_init_has_the_jax_tree(tcfg, jp)


def test_apply_matches(models):
    jcfg, tcfg, jp, tp = models
    tok = np.random.default_rng(1).integers(0, 512, (2, 24)).astype(np.int32)
    want = jax.jit(jax.vmap(
        lambda p: jtf.apply(p, jcfg, tokens=tok, remat=False)[0]))(jp)
    got, _ = ttf.apply(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("paged", [True, False])
def test_prefill_and_decode_match(models, paged):
    _run_both(models, 40, paged=paged, tol=TOL)


def test_absorb_mla_params_matches_jax(models):
    """The absorbed projections of every MLA layer equal the JAX
    package's, and are views of kv_up: no copy, no new storage."""
    jcfg, tcfg, jp, tp = models
    want = jtf.absorb_mla_params(jcfg, jp)
    got = ttf.absorb_mla_params(tcfg, tp)
    for seg_w, seg_g, seg_t in zip(want["segments"], got["segments"],
                                   tp["segments"]):
        w, g = seg_w["slot_0"]["attn"], seg_g["slot_0"]["attn"]
        for name in ("kv_uk", "kv_uv"):
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[name]))
            kv_up = seg_t["slot_0"]["attn"]["kv_up"]
            assert (g[name].untyped_storage().data_ptr()
                    == kv_up.untyped_storage().data_ptr())
        assert set(seg_t["slot_0"]["attn"]).isdisjoint({"kv_uk", "kv_uv"})
    assert ttf.absorb_mla_params(tcfg.with_(
        attn=tcfg.attn.__class__()), {"segments": []}) == {"segments": []}


def _count_paged(monkeypatch):
    calls = []
    real = ops.paged_attention

    def shim(q, k_pages, v_pages, *a, **kw):
        calls.append((tuple(q.shape), k_pages is v_pages,
                      kw.get("k_extra") is not None))
        return real(q, k_pages, v_pages, *a, **kw)
    monkeypatch.setattr(ops, "paged_attention", shim)
    return calls


@pytest.mark.parametrize("paged", [True, False])
def test_generate_matches_jax_engine(models, monkeypatch, paged):
    """Greedy tokens of the port's engine equal the JAX engine's.  Paged,
    every decode step makes one paged_attention call per MLA layer over
    the K members' rows at the absorbed width (r + rope features, the
    latent plane as keys and values, the rope keys as k_extra)."""
    jcfg, tcfg, jp, tp = models
    kw = dict(ENGINE, paged=paged)
    calls = _count_paged(monkeypatch)
    eng = EnsembleEngine(tcfg, tp, device="cpu", **kw)
    got = eng.generate(_prompts(), 10)
    for w, g in zip(JaxEngine(jcfg, jp, **kw).generate(_prompts(), 10), got):
        np.testing.assert_array_equal(g, w)
    a = tcfg.attn
    if not paged:
        assert calls == []
        return
    assert len(calls) == tcfg.n_layers * eng.steps_run
    assert set(calls) == {((K * ENGINE["n_slots"], a.n_heads,
                            a.kv_lora_rank + a.qk_rope_dim), True, True)}


def test_absorbed_decode_is_token_exact_against_expanded(models):
    """The absorbed paged decode (latent keys and values, W_UK folded
    into the queries, W_UV into the output) against the expanded
    contiguous one: the same greedy tokens at f32, and step logits
    within TOL."""
    _, tcfg, _, tp = models
    paged = EnsembleEngine(tcfg, tp, device="cpu", paged=True, **ENGINE)
    contig = EnsembleEngine(tcfg, tp, device="cpu", **ENGINE)
    for a, b in zip(paged.generate(_prompts(), 10),
                    contig.generate(_prompts(), 10)):
        np.testing.assert_array_equal(a, b)
    B = 2
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (B, 12)).astype(np.int32)
    logits = []
    for kw in ({"page_size": 4, "n_pages": 8}, {}):
        c = ttf.init_slot_cache(tcfg, B, 16, members=K, device="cpu", **kw)
        if kw:
            c["page_table"] = torch.arange(8, dtype=torch.int32).reshape(
                1, B, 4).expand(K, B, 4).contiguous()
        pre = ttf.prefill_step_paged if kw else ttf.prefill_slots
        for b in range(B):
            _, row = pre(tp, tcfg, tkv.slot_row(c, b),
                         torch.from_numpy(toks[b:b + 1, :8]),
                         torch.tensor([8], dtype=torch.int32))
            tkv.write_slot_row(c, row, b)
        dec = ttf.decode_step_paged if kw else ttf.decode_step_slots
        out = []
        for t in range(8, 12):
            lg, c = dec(tp, tcfg, c, torch.from_numpy(toks[:, t:t + 1]))
            out.append(lg)
        logits.append(torch.stack(out))
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(), **TOL)


def test_copy_pages_copies_latent_and_rope_pages(models):
    """Copy-on-write (kv_cache.copy_pages) copies both of an MLA layer's
    page planes, the latents and the rope keys."""
    _, tcfg, _, _ = models
    pool = tkv.init_pool(tcfg, K, 2, 16, page_size=4, n_pages=6,
                         device="cpu")
    for seg in pool["segments"]:
        for name, plane in seg["slot_0"].items():
            plane.copy_(torch.randn(plane.shape))
    before = {(i, n): p.clone() for i, seg in enumerate(pool["segments"])
              for n, p in seg["slot_0"].items()}
    tkv.copy_pages(pool, np.array([1, 4]), np.array([3, 0]), 6)
    for (i, n), old in before.items():
        new = pool["segments"][i]["slot_0"][n]
        assert n in ("c_kv_pages", "k_r_pages")
        torch.testing.assert_close(new[:, :, [3, 0]], old[:, :, [1, 4]])
        torch.testing.assert_close(new[:, :, [1, 2, 4, 5]],
                                   old[:, :, [1, 2, 4, 5]])


def test_scheduler_prefix_cache_keeps_the_tokens(models):
    """Scheduler.run with the prefix cache on (hits and copy-on-write
    pages) gives the tokens it gives with the cache off."""
    _, tcfg, _, tp = models
    rng = np.random.default_rng(1)
    shared = list(range(200, 216))
    reqs = []
    for i in range(7):
        tail = list(rng.integers(1, 99, 1 + int(rng.integers(6))))
        cut = int(rng.integers(4, len(shared) + 1))
        reqs.append((np.array(shared[:cut] + tail, np.int32), 2 + i % 3))
    runs = []
    for on in (False, True):
        eng = EnsembleEngine(tcfg, tp, device="cpu", n_slots=3,
                             max_prompt=24, max_out=4, prefill_chunk=4,
                             paged=True, page_size=4, n_pages=14,
                             prefix_cache=on)
        sched = Scheduler(eng)
        rids = [sched.submit(t, m) for t, m in reqs]
        comps = sched.run()
        runs.append([comps[r].tokens for r in rids])
        eng.assert_pool_whole()
    ps = eng.page_stats()
    assert ps["prefix_hits"] > 0 and ps["cow_pages"] > 0
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_mla_training_rounds_match_jax_trainer():
    """Two EC rounds of reduced deepseek-v2 (K = 2, dense labels): round
    0 trains plainly and relabels (each member's batch its own MoE
    pool), round 1 opens with two distill steps.  Losses, evaluate()
    and evaluate_compressed() within rtol 1e-4 of the JAX Trainer's."""
    jcfg = jreg.get_config(ARCH, reduced=True).with_(dtype="float32")
    tcfg = treg.get_config(ARCH, reduced=True).with_(dtype="float32")
    Kt = 2
    train, test = (jax.device_get(x) for x in jdata(
        jax.random.PRNGKey(0), Kt, per_member=32, seq_len=16, vocab=512))
    ec = dict(tau=3, lam=0.5, p_steps=2, relabel_fraction=0.5,
              label_mode="dense", aggregator="ec", top_m=8)
    jtr = JTrainer(jcfg, JEC(**ec), jadamw(1e-3), Kt,
                   jax.random.PRNGKey(0), train, test, batch_size=4, seed=2)
    ttr = TTrainer(tcfg, TEC(**ec), tadamw(1e-3), Kt, 0,
                   params_from_numpy(train, "cpu"),
                   params_from_numpy(test, "cpu"), batch_size=4, seed=2,
                   params=jax.device_get(jtr.state["params"]), device="cpu")
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a, b, rtol=1e-4, atol=1e-6)
    for _ in range(2):
        close(ttr.run_round(), jtr.run_round())
        jev, tev = jtr.evaluate(), ttr.evaluate()
        assert set(tev) == set(jev)
        for k in jev:
            close(tev[k], jev[k])
        assert tev["global_loss"] <= tev["local_loss"] + 1e-6    # Jensen
    jc, tc = jtr.evaluate_compressed(), ttr.evaluate_compressed()
    for k in jc:
        close(tc[k], jc[k])


def test_absorbed_call_is_attention_over_latent_and_rope_keys(models):
    """The absorbed decode's kernel call at reduced widths: q of r + rope
    features, the latent plane as keys and values (dk = dv = r), the
    rope keys as k_extra, the scale 1/sqrt(nope + rope) and not the
    wrapper's default 1/sqrt(r + rope); the plain version equals
    attention written out over the gathered keys."""
    _, tcfg, _, tp = models
    a = tcfg.attn
    rng = np.random.default_rng(0)
    N, page, B = 6, 4, 2
    lat = torch.from_numpy(rng.standard_normal(
        (N, page, 1, a.kv_lora_rank)).astype(np.float32))
    rope = torch.from_numpy(rng.standard_normal(
        (N, page, 1, a.qk_rope_dim)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(
        (B, a.n_heads, a.kv_lora_rank + a.qk_rope_dim)).astype(np.float32))
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lens = torch.tensor([9, 12], dtype=torch.int32)
    scale = 1.0 / np.sqrt(a.qk_nope_dim + a.qk_rope_dim)
    got = ops.paged_attention(q, lat, lat, table, lens, scale=scale,
                              k_extra=rope)
    dk = a.kv_lora_rank + a.qk_rope_dim
    k = torch.cat([lat, rope], -1)[table.long()].reshape(B, -1, dk)
    v = lat[table.long()].reshape(B, -1, a.kv_lora_rank)
    s = torch.einsum("bhd,bsd->bhs", q, k) * scale
    s = s.masked_fill(torch.arange(s.shape[-1])[None, None]
                      >= lens[:, None, None], float("-inf"))
    want = torch.einsum("bhs,bsd->bhd", s.softmax(-1), v)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert tattn.mla_absorbed(
        {k: v[:, 0] for k, v in tp["segments"][1]["slot_0"]["attn"].items()},
        a)[0].shape == (K, a.kv_lora_rank, a.n_heads, a.qk_nope_dim)
