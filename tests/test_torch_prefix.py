"""The port's prefix cache against repro.serving's: the trie, the
refcounting page allocator with its share / copy-on-write hooks,
`kv_cache.copy_pages`, and the engine's warm path.

- One seeded random sequence of alloc / share / cow / grow / release /
  rollback / reclaim / flush drives the JAX package's PageAllocator +
  PrefixCache and the port's side by side: tables, refcounts, free
  lists and stats must be equal after every op, with check_invariants
  on both (the twin of test_prefix.py's property test).
- copy_pages on the same pool, with a sentinel row and a source page
  that is also another row's destination.
- The prefix-cache engine at reduced deepseek-7b, f32, K=2: warm tokens
  equal cold tokens and the JAX warm engine's, across full-page and
  mid-page (copy-on-write) hits; configs that cannot share pages are
  refused with the JAX package's reason; swap_params copies new weights
  in place and empties the trie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import kv_cache as jkv
from repro.serving import prefix as jprefix
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import prefix as tprefix
from repro_torch.serving.engine import EnsembleEngine, _flatten

K = 2
KW = dict(n_slots=3, max_prompt=24, max_out=6, prefill_chunk=4,
          paged=True, page_size=4, seed=0)


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
    jcfg = jreg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    tcfg = treg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), K))
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


# -- the trie and the allocator, op for op ------------------------------------


def _wired(mod_kv, mod_prefix, n_pages, page, n_slots, pps):
    a = mod_kv.PageAllocator(n_pages, page, n_slots, pps)
    a.cache = mod_prefix.PrefixCache(page)
    return a


def _state(a):
    return (a.table().tolist(), list(a._ref), list(a._free),
            [list(a.chain(b)) for b in range(a.n_slots)],
            a.free_pages, a.available_pages, a.shared_pages, a.low_water,
            a.shared_attach_count, a.cow_count, a.cache.stats(),
            sorted(a.cache.owned_pages()))


@pytest.mark.parametrize("seed", range(6))
def test_allocator_and_trie_equal_jax_after_every_op(seed):
    page, n_slots, pps = 4, 4, 6
    jax_a = _wired(jkv, jprefix, 16, page, n_slots, pps)
    port_a = _wired(tkv, tprefix, 16, page, n_slots, pps)
    rng = np.random.default_rng(seed)
    prefixes = [list(range(1000, 1000 + n)) for n in (5, 9, 14)]
    live = {}   # slot -> (tokens, written, prompt pages)

    def admit(a, b, toks):
        """Engine-style admission; -> (hit, cow pair) or None when the
        request would queue (nothing mutated)."""
        plen = len(toks)
        want = -(-plen // page)
        hit, full, t = a.cache.peek(toks, plen - 1)
        cost = want - sum(1 for p in full if a.ref(p) > 0)
        if want > pps or cost > a.available_pages:
            return None
        hit, full, t = a.cache.match(toks, plen - 1)
        if full or t:
            a.share(b, full + ([t[0]] if t else []))
        pair = a.cow(b, len(full)) if t is not None else None
        assert a.alloc(b, want)
        return hit, pair

    for _ in range(150):
        kind = rng.choice(["touch", "touch", "grow", "rollback", "reclaim",
                           "flush"])
        b = int(rng.integers(n_slots))
        if kind == "touch" and b in live:      # complete / preempt / cancel
            toks, written, _ = live.pop(b)
            for a in (jax_a, port_a):
                n = -(-written // page)
                if written > 0 and len(a.chain(b)) >= n:
                    a.cache.insert(toks[:written], a.chain(b)[:n])
                assert a.release(b) >= 0
        elif kind == "touch":
            toks = prefixes[int(rng.integers(3))] + list(
                rng.integers(1, 999, int(rng.integers(1, 6))))
            got = [admit(a, b, toks) for a in (jax_a, port_a)]
            assert got[0] == got[1]
            if got[0] is not None:
                hit = got[0][0]
                wpct = int(rng.integers(0, 101))
                live[b] = (toks, hit + (len(toks) - hit) * wpct // 100,
                           -(-len(toks) // page))
        elif kind == "grow" and b in live:     # decode page growth
            for a in (jax_a, port_a):
                want = len(a.chain(b)) + 1
                if want <= pps and a.available_pages >= 1:
                    assert a.alloc(b, want)
        elif kind == "rollback" and b in live:
            assert jax_a.truncate(b, live[b][2]) == \
                port_a.truncate(b, live[b][2])
        elif kind == "reclaim":
            # evict as alloc does when its free list runs short
            n = int(rng.integers(0, 3))
            freed = [a.cache.reclaim(n) for a in (jax_a, port_a)]
            assert freed[0] == freed[1]
            for a, f in zip((jax_a, port_a), freed):
                a._free.extend(reversed(f))
        elif kind == "flush":
            assert jax_a.flush_cache() == port_a.flush_cache()
        jax_a.check_invariants()
        port_a.check_invariants()
        assert _state(port_a) == _state(jax_a)
    for b in list(live):
        assert jax_a.release(b) == port_a.release(b)
    for a in (jax_a, port_a):
        a.check_invariants()
        a.flush_cache()
        assert sorted(a._free) == list(range(a.n_pages))
    assert _state(port_a) == _state(jax_a)
    # the sequence reached every hook
    assert port_a.cow_count > 0 and port_a.shared_attach_count > 0
    assert port_a.cache.evicted_pages > 0 and port_a.cache.deduped_pages > 0


def test_trie_calls_equal_jax():
    """match / peek / insert / reclaim / flush on one input sequence."""
    j, t = jprefix.PrefixCache(4), tprefix.PrefixCache(4)
    calls = [("insert", list(range(10)), [7, 3, 9]),
             ("match", list(range(8)) + [99], 8),
             ("match", list(range(9)) + [99, 98], 10),
             ("peek", list(range(10)), 6),
             ("insert", list(range(8)), [5, 6]),
             ("insert", list(range(4)) + [9, 9, 9, 9], [7, 8]),
             ("match", list(range(4)) + [9, 9, 9, 9], 8),
             ("match", [55, 56, 57], 3)]
    for name, *args in calls:
        assert getattr(t, name)(*args) == getattr(j, name)(*args)
        assert t.stats() == j.stats()
    for p in (3, 9, 8, 7):
        j.page_unreferenced(p)
        t.page_unreferenced(p)
    assert t.reclaim(2) == j.reclaim(2)
    assert t.stats() == j.stats()
    assert sorted(t.flush()) == sorted(j.flush())
    assert t.stats() == j.stats()


# -- copy_pages ---------------------------------------------------------------


def test_copy_pages_matches_jax(models):
    jcfg, tcfg, _, _ = models
    n_pages, page = 10, 4
    pool = tkv.init_pool(tcfg, K, 3, 16, page_size=page, n_pages=n_pages,
                         device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _, x in tkv._leaves(pool["segments"]):
        x.copy_(torch.randn(x.shape, generator=gen))
    jpool = jax.tree.map(lambda x: jnp.asarray(x.numpy()), pool)
    # row 0: 2 -> 5; row 1 a sentinel (no copy); row 2: 5 -> 7, where 5
    # is row 0's destination, so it must be read before row 0 writes it
    src = np.array([2, n_pages, 5], np.int32)
    dst = np.array([5, n_pages, 7], np.int32)
    want = jkv.copy_pages(jpool, jnp.asarray(src), jnp.asarray(dst), n_pages)
    before = {id(x): x.clone() for _, x in tkv._leaves(pool)}
    got = tkv.copy_pages(pool, src, dst, n_pages)
    for g, w in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    n_paged = 0
    for name, g in tkv._leaves(got):
        if name.endswith("_pages"):
            n_paged += 1
            old = before[id(g)]
            # every member's every layer: page 5 now holds old page 2,
            # page 7 the OLD page 5, the rest untouched
            torch.testing.assert_close(g[:, :, 5], old[:, :, 2], rtol=0,
                                       atol=0)
            torch.testing.assert_close(g[:, :, 7], old[:, :, 5], rtol=0,
                                       atol=0)
    assert n_paged > 0


# -- the engine's warm path ---------------------------------------------------


def test_warm_engine_equals_cold_and_the_jax_warm_engine(models):
    """Full-page hits, a mid-page hit (copy-on-write) and two divergent
    sharers admitted together: the warm port engine returns the cold
    engine's tokens and the JAX warm engine's, with the same page
    telemetry, and the cached original replays intact."""
    jcfg, tcfg, jp, tp = models
    shared = list(range(100, 118))                    # 18-token prefix
    p1 = np.array(shared + [7, 8], np.int32)
    p2 = np.array(shared + [9, 10, 11], np.int32)     # diverges mid-page
    p3 = np.array(shared[:10] + [3, 4], np.int32)     # splits page 2
    cold = EnsembleEngine(tcfg, tp, device="cpu", **KW)
    ref = cold.generate([p1, p2, p3], 5)
    jwarm = JaxEngine(jcfg, jp, prefix_cache=True, **KW)
    warm = EnsembleEngine(tcfg, tp, device="cpu", prefix_cache=True, **KW)
    for batch in ([p1], [p2, p3], [p1]):
        want = jwarm.generate(batch, 5)
        got = warm.generate(batch, 5)
        for p, g, w in zip(batch, got, want):
            np.testing.assert_array_equal(g, w)
            i = next(i for i, q in enumerate((p1, p2, p3)) if q is p)
            np.testing.assert_array_equal(g, ref[i])
        assert warm.page_stats() == jwarm.page_stats()
    ps = warm.page_stats()
    assert ps["prefix_hits"] >= 3 and ps["cow_pages"] >= 1
    warm.update_slots(release=range(warm.n_slots))
    warm.assert_pool_whole()


def test_prefix_hit_is_token_granular(models):
    """A hit that ends mid-page starts the slot at the hit: its first
    input is prompt[hit], its cache index is the hit, and it owes
    ceil((plen - hit) / chunk) prefill calls."""
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu", prefix_cache=True, **KW)
    p = np.arange(30, 50, dtype=np.int32)             # 20 tokens
    eng.generate([p], 3)
    q = np.concatenate([p[:13], [7, 7, 7]]).astype(np.int32)
    hits = eng.update_slots(release=range(3), admits=[(1, q, 3)])
    assert hits == {1: 13}
    assert int(eng.state.pos[1]) == int(eng.cache["idx"][0, 1]) == 13
    assert int(eng.state.tok[1]) == q[13]
    assert eng.allocator.cow_count == 1
    n0 = eng.prefills_run
    while int(eng.state.pos[1]) < len(q):
        eng.prefill(1)
    assert eng.prefills_run - n0 == -(-(len(q) - 13) // eng.prefill_chunk)


@pytest.mark.parametrize("arch,kw,reason", [
    ("gemma3-1b", dict(max_prompt=16, max_out=8), "per-slot"),
    ("rwkv6-7b", dict(max_prompt=8, max_out=4), "per-slot"),
    ("jamba-v0.1-52b", dict(max_prompt=8, max_out=4), "per-slot"),
    ("deepseek-7b", dict(max_prompt=8, max_out=4, paged=False),
     "paged=True")])
def test_ineligible_configs_refuse_with_the_jax_reason(arch, kw, reason):
    jcfg = jreg.get_config(arch, reduced=True)
    tcfg = treg.get_config(arch, reduced=True)
    tp = ttf.init(tcfg, seed=0, device="cpu", members=2)
    args = dict(dict(n_slots=2, paged=True, page_size=4,
                     prefix_cache=True), **kw)
    # the JAX engine refuses before it reads anything but the member count
    with pytest.raises(ValueError, match=reason) as want:
        JaxEngine(jcfg, {"embed": np.zeros((2, 1), np.float32)}, **args)
    with pytest.raises(ValueError, match=reason) as got:
        EnsembleEngine(tcfg, tp, device="cpu", **args)
    assert str(got.value) == str(want.value)


def test_swap_params_in_place_flushes_the_trie(models):
    _, tcfg, _, tp = models
    eng = EnsembleEngine(tcfg, tp, device="cpu", prefix_cache=True, **KW)
    p = np.arange(40, 58, dtype=np.int32)
    eng.generate([p], 4)
    eng.update_slots(release=range(3))
    assert eng.page_stats()["cached_pages"] > 0
    new = ttf.init(tcfg, seed=5, device="cpu", members=K)
    live = dict(_flatten(eng.params))
    ptrs = {path: x.data_ptr() for path, x in live.items()}
    eng.swap_params(new)
    # every live tensor kept its identity and storage, now holds the new
    # weights, and the trie holds nothing of the old model
    for path, x in _flatten(eng.params):
        assert x is live[path] and x.data_ptr() == ptrs[path]
    assert eng.page_stats()["cached_pages"] == 0
    assert eng.swaps_done == 1
    eng.assert_pool_whole()
    fresh = EnsembleEngine(tcfg, new, device="cpu", prefix_cache=True, **KW)
    np.testing.assert_array_equal(eng.generate([p], 4)[0],
                                  fresh.generate([p], 4)[0])
    # a tree of another shape or dtype is refused before anything moves
    bad = ttf.init(tcfg.with_(d_model=tcfg.d_model * 2), seed=1,
                   device="cpu", members=K)
    with pytest.raises(ValueError, match="swap_params"):
        eng.swap_params(bad)
    bad = {k: v for k, v in new.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="swap_params"):
        eng.swap_params(bad)
