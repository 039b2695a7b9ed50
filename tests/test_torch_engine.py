"""The port's serving engine against repro.serving at reduced gemma3-1b.

Greedy generate() must give the JAX engine's tokens at K=4 members in
f32 (paged and contiguous pools, chunked and per-token prefill, and a
quorum drop in mid-stream); f32 is pinned for the reason the JAX engine
pins it: greedy argmax must not fork on near-ties, and at f32 the two
packages' logits agree to 1e-4 (test_torch_model.py).  Also: Eqn-6
fusion, the page allocator on a random op sequence, the sampler's
determinism, and entry points that refuse to run without a device.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import ensemble as jens
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import kv_cache as jkv
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core import ensemble as tens
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import sampling
from repro_torch.serving.engine import EnsembleEngine

K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the torch side runs tiny shapes, and the
    suite's workers share the cores (torch's default, one thread a core
    in every worker, oversubscribes them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    tcfg = treg.get_config("gemma3-1b", reduced=True).with_(dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def prompts(seed=1, lens=(5, 13, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


# max_prompt + max_out = 28 > local_window 16: ring and paged layers mix
KW = dict(n_slots=4, max_prompt=16, max_out=12, page_size=4)


@pytest.mark.parametrize("paged,chunk", [(True, 8), (False, 8), (True, 0),
                                         (False, 0)])
def test_generate_matches_jax_engine(models, paged, chunk):
    jcfg, tcfg, jp, tp = models
    kw = dict(KW, paged=paged, prefill_chunk=chunk)
    jeng = JaxEngine(jcfg, jp, **kw)
    eng = EnsembleEngine(tcfg, tp, device="cpu", **kw)
    # the second batch reuses each engine's recycled pool
    for ps, n in ((prompts(), 10), (prompts(seed=5, lens=(16, 3)), 12)):
        want, got = jeng.generate(ps, n), eng.generate(ps, n)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_quorum_drop_mid_stream_matches_jax_engine(models):
    jcfg, tcfg, jp, tp = models
    kw = dict(KW, paged=True, prefill_chunk=8)
    engines = [JaxEngine(jcfg, jp, **kw),
               EnsembleEngine(tcfg, tp, device="cpu", **kw)]
    outs = []
    for eng in engines:
        ps = prompts()
        eng.update_slots(admits=[(i, p, 10) for i, p in enumerate(ps)])
        for i, p in enumerate(ps):
            for _ in range(-(-len(p) // eng.prefill_chunk)):
                eng.prefill(i)
        for s in range(9):
            if s == 4:
                eng.set_quorum([1, 1, 0, 1])
            eng.step()
        st = jax.device_get(eng.state) if isinstance(eng, JaxEngine) \
            else eng.state
        outs.append((np.asarray(st.out), np.asarray(st.n_gen)))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    np.testing.assert_array_equal(outs[1][0], outs[0][0])


def test_ensemble_fusion_matches_jax():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((K, 3, 50)) * 3).astype(np.float32)
    for mask in (None, [1, 1, 0, 1], [0, 0, 0, 0]):
        w_j = None if mask is None else jens.quorum_weights(jnp.asarray(
            mask, jnp.float32))
        w_t = None if mask is None else tens.quorum_weights(
            torch.tensor(mask, dtype=torch.float32))
        if mask is not None:
            np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j))
        want = jens.ensemble_log_probs(jnp.asarray(z), weights=w_j)
        got = tens.ensemble_log_probs(torch.from_numpy(z), weights=w_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        tens.member_log_probs(torch.from_numpy(z)).numpy(),
        np.asarray(jens.member_log_probs(jnp.asarray(z))), atol=1e-5)


def test_page_allocator_matches_jax_package():
    n_pages, page, slots, per_slot = 23, 4, 5, 8
    a = jkv.PageAllocator(n_pages, page, slots, per_slot)
    b = tkv.PageAllocator(n_pages, page, slots, per_slot)
    rng = np.random.default_rng(0)
    for _ in range(400):
        op, s = rng.integers(0, 3), int(rng.integers(0, slots))
        n = int(rng.integers(0, per_slot + 2))
        if op == 0:
            assert a.alloc(s, n) == b.alloc(s, n)
        elif op == 1:
            assert a.release(s) == b.release(s)
        else:
            assert a.truncate(s, n) == b.truncate(s, n)
        np.testing.assert_array_equal(a.table(), b.table())
        assert (a.free_pages, a.low_water) == (b.free_pages, b.low_water)
        assert a.holds(s, 5) == b.holds(s, 5)
        assert a.reclaimable_pages(s) == b.reclaimable_pages(s)
        b.check_invariants()
    a.check_invariants()


def test_sampler_is_deterministic_per_seed():
    rng = np.random.default_rng(0)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((3, 64)).astype(np.float32)), -1)
    temp = np.array([0.0, 1.0, 0.7], np.float32)
    topk = np.array([0, 0, 5])
    n_gen = torch.tensor([0, 3, 3])
    draw = lambda seeds: sampling.sample_slots(  # noqa: E731
        lp, temp, topk, np.asarray(seeds), n_gen)
    a, b = draw([1, 2, 3]), draw([1, 2, 3])
    assert torch.equal(a, b)
    assert a[0] == lp[0].argmax()                   # greedy row
    assert a[2] in lp[2].topk(5).indices            # top-k bucket
    draws = {tuple(draw([1, s, s]).tolist()) for s in range(20)}
    assert len(draws) > 1                           # the seed matters


def test_top_k_mask_rows_matches_jax():
    from repro.serving import sampling as jsampling
    rng = np.random.default_rng(4)
    lp = rng.standard_normal((4, 30)).astype(np.float32)
    lp[1, :3] = lp[1, 3]  # ties at the threshold survive on both sides
    k = np.array([0, 4, 1, 30], np.int32)
    want = jsampling.top_k_mask_rows(jnp.asarray(lp), jnp.asarray(k))
    got = sampling.top_k_mask_rows(torch.from_numpy(lp), torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_is_reproducible(models):
    _, tcfg, _, tp = models
    kw = dict(KW, paged=True, temperature=1.0, top_k=20, seed=7)
    outs = [EnsembleEngine(tcfg, tp, device="cpu", **kw).generate(
        prompts(), 8) for _ in range(2)]
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def test_validate_request_names_its_limits(models):
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu", **KW)
    for bad, match in ((dict(tokens=[]), "prompt len"),
                       (dict(max_new=13), "max_new"),
                       (dict(temperature=101.0), "MAX_TEMPERATURE"),
                       (dict(top_k=513), "vocab_size"),
                       (dict(seed=-1), "MIN_SEED")):
        req = dict(tokens=[1, 2], max_new=4)
        req.update(bad)
        with pytest.raises(ValueError, match=match):
            eng.validate_request(**req)


@pytest.mark.parametrize("option", ["mesh", "prefix_cache", "kv_dtype"])
def test_options_of_later_slices_raise(models, option):
    """mesh is ported (tests/test_torch_mesh.py): what is not a
    DeviceMesh is refused.  The prefix cache is ported: rwkv6-7b
    refuses it with the JAX package's reason (its recurrent state is per
    slot, so a hit could not skip it).  Quantized KV pages are ported: a
    contiguous pool refuses them with the JAX package's reason."""
    jcfg, tcfg, jp, tp = models
    if option == "kv_dtype":
        with pytest.raises(ValueError) as want:
            JaxEngine(jcfg, jp, kv_dtype="int8", **KW)
        with pytest.raises(ValueError, match="paged=True") as got:
            EnsembleEngine(tcfg, tp, device="cpu", kv_dtype="int8", **KW)
        assert str(got.value) == str(want.value)
        return
    if option == "prefix_cache":
        kw = dict(KW, prefix_cache=True, paged=True)
        rcfg = treg.get_config("rwkv6-7b", reduced=True)
        # the JAX engine refuses before it reads more than the member count
        with pytest.raises(ValueError) as want:
            JaxEngine(jreg.get_config("rwkv6-7b", reduced=True),
                      {"embed": np.zeros((2, 1), np.float32)}, **kw)
        with pytest.raises(ValueError, match="mixer 'rwkv'") as got:
            EnsembleEngine(rcfg, ttf.init(rcfg, members=2, device="cpu"),
                           device="cpu", **kw)
        assert str(got.value) == str(want.value)
        return
    with pytest.raises(TypeError, match="DeviceMesh"):
        EnsembleEngine(tcfg, tp, device="cpu", **dict(KW, mesh=object()))


@pytest.mark.parametrize("entry", ["init", "engine", "bridge", "pool"])
def test_entry_points_without_device_raise_here(models, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, tcfg, jp, tp = models
    call = {"init": lambda: ttf.init(tcfg, members=2),
            "engine": lambda: EnsembleEngine(tcfg, tp, **KW),
            "bridge": lambda: bridge.params_from_numpy(
                jax.device_get(jp["final_norm"])),
            "pool": lambda: tkv.init_pool(tcfg, 2, 2, 8)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_torch_init_has_the_jax_tree(models):
    _, tcfg, jp, _ = models
    check_init_has_the_jax_tree(tcfg, jp)


def check_init_has_the_jax_tree(tcfg, jp):
    """The port's torch-seeded init against a JAX-initialized member
    stack: the same tree, shapes and dtypes, and init scales within
    10%."""
    tp = ttf.init(tcfg, seed=0, device="cpu", members=jp["embed"].shape[0])
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda a: isinstance(a, torch.Tensor))[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape), path
        assert str(j.dtype) == str(t.dtype).split(".")[-1], path
        # same init scale: std within 10% (norm scales are exactly 1)
        js, ts = float(np.std(np.asarray(j))), float(t.float().std())
        assert abs(js - ts) <= 0.1 * js + 1e-6, path
