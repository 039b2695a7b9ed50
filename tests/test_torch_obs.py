"""The port's serving observability against repro.serving.obs.

The histograms, their quantiles, the Prometheus render, parse_prometheus
and merge_scrapes are pure Python: the same inputs must give the same
output in both packages (the same text, bucket for bucket).  The
scheduler's span chains must carry the JAX scheduler's events in the
same order (times differ), also under preemption and cancels, and the
tick-phase profiler's window writes a torch.profiler trace.
"""
import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EnsembleEngine as JaxEngine
from repro.serving import Scheduler as JaxScheduler
from repro.serving import obs as jobs
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.serving import obs as tobs
from repro_torch.serving.engine import EnsembleEngine
from repro_torch.serving.scheduler import Scheduler

KW = dict(n_slots=4, max_prompt=8, max_out=8, prefill_chunk=4,
          paged=True, page_size=4)
REQS = [(np.arange(1, 8), 8), (np.arange(2, 7), 8), (np.arange(3, 9), 8),
        (np.arange(1, 5), 8), (np.arange(2, 5), 8), (np.arange(4, 9), 6)]


@pytest.fixture(scope="module")
def models():
    jcfg = jreg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    tcfg = treg.get_config("deepseek-7b", reduced=True).with_(
        dtype="float32")
    jp = jax.vmap(lambda k: jtf.init(k, jcfg))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jp, tp


def _values(seed, n):
    rng = np.random.default_rng(seed)
    return list(np.exp(rng.normal(-3.0, 2.0, n)))  # 1e-5 .. ~10 s


@pytest.mark.parametrize("bounds", [None, (0.01, 0.1, 1.0)])
def test_histogram_and_quantiles_equal_jax(bounds):
    kw = {} if bounds is None else dict(bounds=bounds)
    hs = [m.Histogram("x_seconds", "t", **kw) for m in (jobs, tobs)]
    for v in _values(0, 500):
        for h in hs:
            h.observe(v)
    j, t = hs
    assert (t.counts, t.sum, t.count, t.cumulative()) == \
        (j.counts, j.sum, j.count, j.cumulative())
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q)
    other = [m.Histogram("x_seconds", "t", **kw) for m in (jobs, tobs)]
    for v in _values(1, 50):
        for h in other:
            h.observe(v)
    j.merge_from(other[0].counts, other[0].sum, other[0].count)
    t.merge_from(other[1].counts, other[1].sum, other[1].count)
    assert t.cumulative() == j.cumulative() and t.sum == j.sum
    cum = [0, 3, 3, 9]
    for q in (0.0, 0.3, 0.5, 1.0):
        assert tobs.quantile_from_buckets([0.1, 0.2, 0.4], cum, q) == \
            jobs.quantile_from_buckets([0.1, 0.2, 0.4], cum, q)


def _scrape(mod, reqs, depth, latencies, evil):
    fs = mod.FamilySet()
    fs.declare("reqs_total", "counter", "requests served\nwith \\ slash")
    fs.sample("reqs_total", {"k": evil}, reqs)
    fs.declare("depth", "gauge", "queue depth")
    fs.sample("depth", None, depth)
    h = mod.Histogram("lat_seconds", "latency", bounds=(0.1, 1.0))
    for v in latencies:
        h.observe(v)
    fs.add_histogram(h, {"replica": "r0"})
    return fs.render()


def test_render_parse_and_merge_equal_jax():
    evil = 'a"b\\c\nd'
    kids = [("p0", 3, 5, [0.05, 0.5]), ("p1", 4, 2, [0.05, 2.0, 0.2])]
    texts = {m: [(n, _scrape(m, r, d, lat, evil)) for n, r, d, lat in kids]
             for m in (jobs, tobs)}
    assert texts[tobs] == texts[jobs]
    for _, text in texts[tobs]:
        assert tobs.parse_prometheus(text) == jobs.parse_prometheus(text)
    merged = tobs.merge_scrapes(texts[tobs])
    assert merged == jobs.merge_scrapes(texts[jobs])
    for q in (0.5, 0.99):
        assert tobs.histogram_quantile_from_scrape(
            merged, "lat_seconds", q, match={"replica": "fleet"}) == \
            jobs.histogram_quantile_from_scrape(
                merged, "lat_seconds", q, match={"replica": "fleet"})
    for bad in ("a_total 1", "lonely\n",
                "# TYPE a counter\n# TYPE a counter\na 1\n"):
        with pytest.raises(ValueError):
            tobs.parse_prometheus(bad)
        with pytest.raises(ValueError):
            jobs.parse_prometheus(bad)


def test_trace_ring_and_event_cap_equal_jax():
    for mod in (jobs, tobs):
        ring = mod.TraceRing(keep=4)
        live = ring.start(999)
        live.add("enqueued")
        for rid in range(20):
            t = ring.start(rid)
            t.add("enqueued")
            t.add("done")
            ring.finish(rid)
        assert (ring.n_finished, ring.evicted, ring.n_live) == (4, 16, 1)
        assert ring.get(0) is None and ring.get(999) is live
        t = mod.Trace(0, max_events=3)
        for i in range(5):
            t.add("prefill_chunk", i)
        d = t.to_dict()
        assert d["dropped"] == 2 and [e["v"] for e in d["events"]] == \
            [0, 1, 2]


def _events(trace):
    return [(e["event"], e.get("v")) for e in trace["events"]]


def test_span_chains_equal_jax_under_pressure_and_cancels(models):
    """The same requests through both schedulers on a 6-page pool, one
    cancelled while queued and one while live: every completion's span
    chain (event and value) equals the JAX one; histograms count the
    same observations."""
    jcfg, tcfg, jp, tp = models
    out = []
    for eng in (JaxEngine(jcfg, jp, n_pages=6, **KW),
                EnsembleEngine(tcfg, tp, device="cpu", n_pages=6, **KW)):
        S = JaxScheduler if isinstance(eng, JaxEngine) else Scheduler
        sched = S(eng)
        rids = [sched.submit(t, m) for t, m in REQS]
        sched.cancel(rids[5])
        sched.tick()
        sched.cancel(rids[1])
        comps = sched.run()
        cancelled = [_events(sched.obs.traces.get(r).to_dict())
                     for r in (rids[1], rids[5])]
        o = sched.obs
        out.append(({r: _events(c.trace) for r, c in comps.items()},
                    cancelled, sched.preemptions,
                    [h.count for h in o.histograms()], o.traces.n_live))
    assert out[1] == out[0]
    chains, cancelled, preemptions, _, n_live = out[1]
    assert preemptions > 0 and n_live == 0
    assert any(("preempted", None) in c for c in chains.values())
    assert cancelled[0][-1] == ("cancelled", None)


def test_tick_phases_and_profile_window(models, tmp_path):
    _, tcfg, _, tp = models
    sched = Scheduler(EnsembleEngine(tcfg, tp, device="cpu", **KW))
    sched.profile_next_ticks(2, str(tmp_path))
    assert sched.obs.ticks.profile_pending == 2
    for t, m in REQS[:2]:
        sched.submit(t, m)
    sched.run()
    tp_ = sched.obs.ticks
    assert tp_.ticks > 0 and tp_.profile_pending == 0   # window closed
    assert list(tmp_path.iterdir())                     # a trace file
    snap = tp_.snapshot()
    for phase in ("admit", "decode", "prefill", "harvest"):
        assert snap[phase]["count"] > 0 and snap[phase]["total_s"] >= 0
    with pytest.raises(ValueError, match=">= 1"):
        tp_.arm_profile(0, str(tmp_path))
    with pytest.raises(ValueError, match="output dir"):
        tp_.arm_profile(1, "")
    off = Scheduler(EnsembleEngine(tcfg, tp, device="cpu", **KW), obs=False)
    with pytest.raises(RuntimeError, match="disabled"):
        off.profile_next_ticks(1, str(tmp_path))
