"""Rank programs of the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_ring.py), run by common.sharding.spawn in fresh
processes.  They import the port only: the tests compute the JAX
package's references in their own process and hand the ranks numpy
arrays.  Each returns numpy results for its test to check."""
import numpy as np
import torch

K_SERVE = 4
# max_prompt + max_out = 28 > local_window 16: ring and paged layers mix
SERVE_KW = dict(n_slots=4, max_prompt=16, max_out=12, page_size=4,
                prefill_chunk=8)


def small(cfg):
    """Reduced gemma3-1b (either package's config) at f32, cut to two
    layers, its last local (sliding-window) layer and its global one:
    both kinds of attention layer, in two of the reduced config's
    seven."""
    return cfg.with_(dtype="float32", n_layers=2, pattern=cfg.pattern[-2:])


def _serve_cfg():
    from repro_torch.configs import registry
    return small(registry.get_config("gemma3-1b", reduced=True))


def _recording(eng):
    """Wrap the engine's fusion so that every fused (rows, V) output is
    kept, in call order."""
    rec = []
    fuse = eng._fuse

    def fused(logits, member_lp=None):
        out = fuse(logits, member_lp=member_lp)
        rec.append(out.detach().clone())
        return out

    eng._fuse = fused
    return rec


def generate_lp(rec, plens, chunk, n_new):
    """Per prompt, the (n_new, V) fused log-probs its tokens were drawn
    from, out of a generate()'s recorded fusions: each slot's last
    prefill call gives its first token, decode step s every slot's token
    s + 1."""
    calls = [-(-p // chunk) for p in plens]
    ends = np.cumsum(calls) - 1
    steps = rec[sum(calls):]
    return [np.stack([rec[ends[i]][0].numpy()]
                     + [steps[s][i].numpy() for s in range(n_new - 1)])
            for i in range(len(plens))]


def _held(eng) -> dict:
    """What the slot state holds: every slot's emitted tokens."""
    st = eng.state
    return {"out": st.out.numpy().copy(), "n_gen": st.n_gen.numpy().copy()}


def serve_world(rank, params, params2, prompts, n_new, reqs, score_batch,
                quorum):
    """The 2-rank serving cases on the two-layer gemma3-1b, K = 4 (2
    members a rank).  The leader drives; the follower follows and reports what its
    slot state holds after each case."""
    from repro_torch import bridge
    from repro_torch.common import sharding as shd
    from repro_torch.common.tree import tree_map
    from repro_torch.serving.engine import EnsembleEngine
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.serving.spec import SpeculativeEngine
    cfg = _serve_cfg()
    tp = bridge.params_from_numpy(params, "cpu")
    mesh = shd.local_mesh(2, 1, device="cpu")
    drive = shd.is_leader(mesh)
    out = {"rank": rank, "rows": (shd.member_rows(K_SERVE, mesh).start,
                                  shd.member_rows(K_SERVE, mesh).stop)}

    def case(name, build, run):
        eng = build()
        if drive:
            out[name] = run(eng)
            eng.close()
        else:
            out[name] = eng.follow()
        out[name + "_held"] = _held(eng)
        out[name + "_cache_bytes"] = eng.cache_bytes()
        if not drive:
            out[name + "_errors"] = eng.replay_errors

    plens = [len(p) for p in prompts]

    def gen(eng):
        rec = _recording(eng)
        toks = eng.generate(prompts, n_new)
        return toks, generate_lp(rec, plens, eng.prefill_chunk, n_new)

    for paged in (True, False):
        case(f"generate_{'paged' if paged else 'contig'}",
             lambda: EnsembleEngine(cfg, tp, mesh=mesh, device="cpu",
                                    paged=paged, **SERVE_KW), gen)

    def quorum_swap(eng):
        eng.set_quorum(quorum)
        dropped = eng.generate(prompts, n_new)
        eng.set_quorum([1.0] * K_SERVE)
        eng.swap_params(bridge.params_from_numpy(params2, "cpu"))
        swapped = eng.generate(prompts, n_new)
        m, e = eng.score(*score_batch)
        return dropped, swapped, m.numpy(), float(e)

    case("quorum_swap_score",
         lambda: EnsembleEngine(cfg, tp, mesh=mesh, device="cpu",
                                paged=True, **SERVE_KW), quorum_swap)

    def sched(eng):
        s = Scheduler(eng)
        rids = [s.submit(t, m) for t, m in reqs]
        done = s.run()
        return [done[r].tokens for r in rids]

    case("scheduler",
         lambda: EnsembleEngine(cfg, tp, mesh=mesh, device="cpu",
                                paged=True, **SERVE_KW), sched)
    draft = tree_map(lambda x: x[:1], tp)
    case("speculative",
         lambda: SpeculativeEngine(cfg, tp, draft, gamma=3, mesh=mesh,
                                   device="cpu", paged=True, **SERVE_KW),
         lambda eng: (eng.generate(prompts, n_new), eng.spec_stats()))
    if drive:   # the unsharded speculative engine's counts, for reference
        one = SpeculativeEngine(cfg, tp, draft, gamma=3, device="cpu",
                                paged=True, **SERVE_KW)
        one.generate(prompts, n_new)
        out["speculative_unsharded"] = one.spec_stats()
    out["outcomes"] = replay_outcomes(
        EnsembleEngine(cfg, tp, mesh=mesh, device="cpu", **SERVE_KW), drive)
    return out


def replay_outcomes(eng, drive):
    """Three set_quorum calls: one that raises on every rank (a mask of
    the wrong length), one that raises on the leader only, one that
    raises on the follower only.  -> the leader's errors, or the
    follower's: what follow() raised, and its replay_errors."""
    from repro_torch.core import ensemble as ens
    if drive:
        errs = []
        for patch in (False, True, False):
            weights = ens.quorum_weights
            if patch:
                def broken(mask):
                    raise RuntimeError("the leader's own fault")
                ens.quorum_weights = broken
            try:
                eng.set_quorum([1.0] * (3 if len(errs) == 0 else K_SERVE))
            except Exception as e:  # noqa: BLE001 - reported to the test
                errs.append(repr(e))
            finally:
                ens.quorum_weights = weights
        eng.close()
        return {"leader": errs}
    raised = []
    try:
        eng.follow()
    except RuntimeError as e:
        raised.append(str(e))

    def broken(mask):
        raise RuntimeError("the follower's own fault")

    eng.set_quorum = broken
    try:
        eng.follow()
    except RuntimeError as e:
        raised.append(str(e))
    eng.follow()                      # the leader's close()
    return {"follower": raised, "replay_errors": eng.replay_errors}


def ring_world(rank, W, X):
    """The JAX package's ring toy (K 4, m 3, d 6, V 12, linear logits)
    over 4 ranks, one member a rank: the ring dense, with a quorum and
    top-M at M = V and M = 4, and the mesh all-gather."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.types import ECConfig
    from repro_torch.core import aggregation as agg
    from repro_torch.core import compression as comp
    mesh = shd.local_mesh(1, 4, device="cpu")
    rows = shd.member_rows(4, mesh, "data")
    p = {"W": torch.from_numpy(W[rows])}
    b = {"x": torch.from_numpy(X[rows])}
    V = W.shape[-1]

    def fn(params, batch, **_):
        return batch["x"] @ params["W"]

    def ring(ec, quorum=None):
        return agg.ring_relabel(mesh, p, b, fn, ec, axis="data",
                                quorum=quorum, n_out=V)

    dense = ECConfig(label_mode="dense")
    q = torch.tensor([1.0, 0.0, 1.0, 1.0])
    full = comp.normalize(ring(ECConfig(label_mode="topk", top_m=V)))
    four = comp.normalize(ring(ECConfig(label_mode="topk", top_m=4)))
    return {"dense": ring(dense).numpy(),
            "quorum": ring(dense, q).numpy(),
            "topm_full": comp.to_dense(full, V).numpy(),
            "topm_4": comp.to_dense(four, V).numpy(),
            "topm_4_bound": comp.l1_error_bound(four).numpy(),
            "allgather": agg.allgather_relabel(
                p, b, fn, dense, n_out=V, mesh=mesh).numpy(),
            "allgather_quorum": agg.allgather_relabel(
                p, b, fn, dense, quorum=q, n_out=V, mesh=mesh).numpy()}


TRAIN_K = 2
TRAIN_CASES = {  # name: (aggregator, protocol, rounds)
    "ec_ring": ("ec", "ring", 2),         # the second opens with distill
    "ec_allgather": ("ec", "allgather", 2),
    "ma": ("ma", "ring", 1),
    "sync": ("sync", "ring", 1),
}


def train_ec(mod, aggr, protocol="ring"):
    return mod(tau=3, lam=0.5, p_steps=2, relabel_fraction=0.5,
               label_mode="dense", aggregator=aggr, protocol=protocol)


def train_world(rank, params, train, test, ckpt_dir):
    """2-rank Trainer(mesh=...) on the two-layer gemma3-1b, K = 2 (a
    member a rank): each case's rounds (under ec the second opens with
    distill steps), evaluate() after each, and the EC-DNN_L pick; the
    ec_ring trainer then saves (the first rank writes).  -> losses,
    evals, picks, and this rank's rows of the saved state."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.common import sharding as shd
    from repro_torch.common.tree import tree_map
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer
    cfg = small(registry.get_config("gemma3-1b", reduced=True))
    mesh = shd.local_mesh(1, 2, device="cpu")
    tr_t, te_t = (params_from_numpy(x, "cpu") for x in (train, test))
    out = {}
    for name, (aggr, protocol, rounds) in TRAIN_CASES.items():
        tr = Trainer(cfg, train_ec(ECConfig, aggr, protocol), adamw(1e-3),
                     TRAIN_K, 0, tr_t, te_t, batch_size=4, seed=2,
                     params=params, device="cpu", mesh=mesh,
                     ckpt_dir=ckpt_dir if name == "ec_ring" else None)
        losses, evals = [], []
        for _ in range(rounds):
            losses.append(tr.run_round())
            evals.append(tr.evaluate())
        out[name] = {"losses": losses, "evals": evals,
                     "best": tr.best_member()[1]}
        if name == "ec_ring":
            tr.save()
            out["saved"] = (tr.round, tree_map(lambda x: x.numpy(),
                                               tr.state))
            back = Trainer(cfg, train_ec(ECConfig, aggr, protocol),
                           adamw(1e-3), TRAIN_K, 1, tr_t, te_t,
                           batch_size=4, device="cpu", mesh=mesh,
                           ckpt_dir=ckpt_dir)
            out["resumed"] = (back.resume(), back.round,
                              tree_map(lambda x: x.numpy(), back.state))
    return out


def failing_world(rank):
    """Rank 1 raises; rank 0 waits in a collective it never completes
    (until the process group's timeout, or until it is stopped)."""
    from repro_torch.common import sharding as shd
    mesh = shd.local_mesh(1, 2, device="cpu")
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    shd.psum(torch.ones(1), mesh, "data")
    return rank


DATA_CASES = {  # name: (aggregator, protocol, rounds)
    "ec_ring": ("ec", "ring", 2),         # the second opens with distill
    "ma": ("ma", "ring", 1),
}


def _np_tree(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda x: x.numpy().copy(), tree)


def data_world(rank, params, train, test, ckpt_dir, reshard_seed):
    """4 ranks as local_mesh(2, 2): K = 2 members along "data" (the
    trainer's ec_axis), each held by 2 data ranks along "member" that
    split its rows.  Each case's rounds with evaluate() after each and
    this rank's params after every round; the ec_ring trainer then saves
    and a fresh one resumes; an all-gather trainer reshards 2 -> 4 with
    a generator seeded `reshard_seed`; the refusals (a batch of 3 rows
    over 2 data ranks, 19 relabel rows (0.6 of 32) over 2, a MoE model's
    pool split over data ranks, a ring grown past one member a rank),
    each at construction but the ring's."""
    import dataclasses
    from repro_torch.bridge import params_from_numpy
    from repro_torch.common import sharding as shd
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer
    cfg = small(registry.get_config("gemma3-1b", reduced=True))
    mesh = shd.local_mesh(2, 2, device="cpu")
    tr_t, te_t = (params_from_numpy(x, "cpu") for x in (train, test))

    def trainer(aggr, protocol, **kw):
        return Trainer(cfg, train_ec(ECConfig, aggr, protocol), adamw(1e-3),
                       TRAIN_K, 0, tr_t, te_t, batch_size=4, seed=2,
                       params=params, device="cpu", mesh=mesh, **kw)

    out = {"rank": rank, "member": shd.axis_index(mesh, "data"),
           "share": shd.axis_index(mesh, "member")}
    for name, (aggr, protocol, rounds) in DATA_CASES.items():
        tr = trainer(aggr, protocol,
                     ckpt_dir=ckpt_dir if name == "ec_ring" else None)
        losses, evals, states = [], [], []
        for _ in range(rounds):
            losses.append(tr.run_round())
            evals.append(tr.evaluate())
            states.append(_np_tree(tr.state["params"]))
        out[name] = {"losses": losses, "evals": evals, "params": states}
        if name == "ec_ring":
            tr.save()
            back = trainer(aggr, protocol, ckpt_dir=ckpt_dir)
            out["resumed"] = (back.resume(), back.round,
                              _np_tree(back.state),
                              _np_tree(tr.state))
    ag = trainer("ec", "allgather")
    gen = torch.Generator().manual_seed(reshard_seed)
    ag.reshard(4, generator=gen)
    out["reshard"] = {"rows": (ag._rows.start, ag._rows.stop),
                      "K": ag.K, "state": _np_tree(ag.state),
                      "shards": _np_tree(ag.shards),
                      "loss": ag.run_round(), "eval": ag.evaluate()}
    refused = {}
    try:
        Trainer(cfg, train_ec(ECConfig, "ec"), adamw(1e-3), TRAIN_K, 0,
                tr_t, te_t, batch_size=3, params=params, device="cpu",
                mesh=mesh)
    except ValueError as e:
        refused["uneven"] = str(e)
    try:
        Trainer(cfg, dataclasses.replace(train_ec(ECConfig, "ec"),
                                         relabel_fraction=0.6),
                adamw(1e-3), TRAIN_K, 0, tr_t, te_t, batch_size=4,
                params=params, device="cpu", mesh=mesh)
    except ValueError as e:
        refused["relabel"] = str(e)
    try:
        Trainer(registry.get_config("deepseek-v2-236b", reduced=True),
                train_ec(ECConfig, "ec"), adamw(1e-3), TRAIN_K, 0, tr_t,
                te_t, batch_size=4, device="cpu", mesh=mesh)
    except ValueError as e:
        refused["moe"] = str(e)
    try:
        trainer("ec", "ring").reshard(4)
    except ValueError as e:
        refused["ring"] = str(e)
    out["refused"] = refused
    return out
