"""Batched serving with an EC ensemble (EC-DNN_G), member-sharded, on the
port.  The twin of the JAX package's examples/serve_ensemble.py.

The paper's Section 4: "take the global model as the final model if
there are enough resources at test time".  This example serves the
ensemble two ways through repro_torch.serving.EnsembleEngine — on one
device, and member-sharded over a ("member", "data") mesh of ranks —
and shows that the placement changes WHERE the members live (each
rank's cache bytes drop K/M-fold), not WHAT the engine computes (scores
match; the Jensen log-likelihood gain is identical).

`--mesh 2x1` starts two ranks (common/sharding.spawn, as the serve
CLI's --mesh does): NCCL where each rank has a card of its own, else
gloo (two ranks share one card, or run on the CPU).  The first rank
drives the engines and prints; the other replays its calls (follow()).
The single-device engine, the paged demo's page counts and the frontend
demo run on the first rank.  The frontend's two replicas each serve
from the first rank's device: a replica over a mesh would be a world of
ranks of its own, which the port does not run behind a router.

  python -m repro_torch.examples.serve_ensemble                 # the card
  python -m repro_torch.examples.serve_ensemble --device cpu --arch \\
      gemma3-1b --members 2 --steps 8 --paged --frontend
"""
import argparse

import numpy as np
import torch

from repro_torch.common import sharding as shd
from repro_torch.common.device import entry_device
from repro_torch.configs import registry
from repro_torch.data import lm_member_datasets
from repro_torch.models import transformer as tf
from repro_torch.serving import EnsembleEngine


def placement_summary(engine, per_rank_bytes=None) -> str:
    """Which members, cache bytes — and for a paged engine, how many
    pages — each rank holds, plus the free-list occupancy.
    per_rank_bytes: each rank's cache bytes, in rank order along the
    member axis (a mesh engine's; gathered by the caller)."""
    ps = engine.page_stats()
    paged = (f", {ps['n_pages']} pages x {ps['page_size']} tok"
             if ps else "")
    if engine.mesh is None:
        lines = [f"  single device {engine.device}: "
                 f"members 0..{engine.n_members - 1}, "
                 f"{engine.cache_bytes() / 2**20:.2f} MiB cache{paged}"]
    else:
        per = engine.n_members // engine.member_shards
        lines = [f"  rank {i} ({engine.device.type}): members "
                 f"{i * per}..{(i + 1) * per - 1}, {nb / 2**20:.2f} MiB "
                 f"cache{paged}" for i, nb in enumerate(per_rank_bytes)]
    if ps:
        lines.append(f"  free list: {ps['free_pages']}/{ps['n_pages']} "
                     f"pages free "
                     f"({ps['used_pages'] / max(ps['n_pages'], 1):.0%} "
                     f"in use)")
    return "\n".join(lines)


def rank_bytes(engine) -> list:
    """Every rank's cache bytes along the member axis (a collective: every
    rank of the mesh calls it)."""
    mine = torch.tensor([engine.cache_bytes()], dtype=torch.int64,
                        device=engine.device)
    return shd.all_gather(mine, engine.mesh, shd.MEMBER_AXIS) \
        .reshape(-1).tolist()


def make_cfg(args):
    cfg = registry.get_config(args.arch, reduced=True)
    return cfg.with_(dtype=args.dtype) if args.dtype else cfg


def make_params(cfg, K: int, device, seed: int = 0):
    """The members' stack, seeded: every rank makes the same one."""
    return tf.init(cfg, seed=seed, device=device, members=K)


def make_batch(cfg, batch: int, steps: int, device):
    """(tokens, labels) of `batch` test rows of `steps` tokens, drawn on
    `device`, as host arrays (what the engine's score takes)."""
    _, test = lm_member_datasets(1, 8, seq_len=steps, vocab=cfg.vocab_size,
                                 device=device)
    return (test["tokens"][:batch].cpu().numpy(),
            test["labels"][:batch].cpu().numpy())


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--mesh", default="2x1",
                    help="'MxD' member x data grid ('' = single device)")
    ap.add_argument("--paged", action="store_true",
                    help="also demo the paged KV pool (pages a rank + "
                         "free-list occupancy after a decode)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (--paged)")
    ap.add_argument("--frontend", action="store_true",
                    help="also demo the HTTP frontend: 2 replicas on an "
                         "ephemeral port, one SSE-streamed request, then "
                         "a zero-downtime hot-swap rollout")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="override the config's param/activation dtype")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    return ap


def main(argv=None):
    """-> the first rank's results: the mesh's member and ensemble NLL,
    the single-device engine's, and what the demos served."""
    args = _parser().parse_args(argv)
    dev = entry_device(args.device)
    shape = shd.mesh_shape_arg(args.mesh)
    if shape is None:
        return run(args, None)
    return shd.spawn(_rank, shape[0] * shape[1], (argv, shape),
                     device=dev.type, timeout=600.0)[0]


def _rank(rank: int, argv, shape):
    args = _parser().parse_args(argv)
    return run(args, shd.local_mesh(*shape,
                                    device=entry_device(args.device).type))


def run(args, mesh):
    """The demo on this rank; the first rank drives, the others follow.
    -> a dict on the first rank, None on the others."""
    dev = entry_device(args.device)
    cfg = make_cfg(args)
    K = args.members
    params = make_params(cfg, K, dev)
    toks, labels = make_batch(cfg, args.batch, args.steps, dev)
    lead = mesh is None or shd.is_leader(mesh)

    sharded = EnsembleEngine(cfg, params, n_slots=1, max_prompt=1,
                             max_out=1, mesh=mesh, device=dev)
    per_rank = rank_bytes(sharded) if mesh is not None else None
    out = None
    if not lead:
        sharded.follow()
    else:
        single = EnsembleEngine(cfg, params, n_slots=1, max_prompt=1,
                                max_out=1, device=dev)
        print(f"single-device placement:\n{placement_summary(single)}")
        print(f"mesh placement ({args.mesh or 'none'}):\n"
            f"{placement_summary(sharded, per_rank)}")
        member_nll, ens_nll = sharded.score(toks, labels)
        sharded.close()
        m_ref, e_ref = single.score(toks, labels)
        B, T = toks.shape
        print(f"\nserved {B}x{T} tokens with K={K} members ({args.arch} "
            f"reduced), member axis over {sharded.member_shards} rank(s)")
        for m in range(K):
            print(f"  member {m}: nll/token = {float(member_nll[m]):.4f}")
        print(f"  EC-DNN_G ensemble: nll/token = {float(ens_nll):.4f} "
            f"(<= mean member {float(member_nll.mean()):.4f} by Jensen)")
        print(f"  single-device check: ensemble nll {float(e_ref):.4f}, "
            f"max member delta "
            f"{float((member_nll - m_ref).abs().max()):.2e} — same math, "
            f"1/{sharded.member_shards} the cache per rank")
        out = {"member_nll": member_nll.cpu().tolist(),
               "ens_nll": float(ens_nll),
               "single_member_nll": m_ref.cpu().tolist(),
               "single_ens_nll": float(e_ref)}

    if args.paged:
        paged = EnsembleEngine(cfg, params, n_slots=4, max_prompt=16,
                               max_out=8, mesh=mesh, paged=True,
                               page_size=args.page_size, device=dev)
        per_rank = rank_bytes(paged) if mesh is not None else None
        if not lead:
            paged.follow()
        else:
            prompts = [np.arange(1, 9) % cfg.vocab_size, np.arange(2, 6)]
            gen = paged.generate(prompts, max_new=8)
            # mid-flight occupancy: admit without harvesting
            paged.update_slots(release=range(4),
                               admits=[(i, p, 8) for i, p in
                                       enumerate(prompts)])
            print(f"\npaged placement ({args.mesh or 'none'}, page_size="
                f"{args.page_size}):\n{placement_summary(paged, per_rank)}")
            out["paged_tokens"] = [g.tolist() for g in gen]
            out["used_pages"] = paged.page_stats()["used_pages"]
            paged.close()

    if args.frontend and lead:
        out["frontend"] = demo_frontend(cfg, params, dev)
    return out


def demo_frontend(cfg, params, device):
    """2 replicas behind the HTTP frontend: stream one request over
    SSE, then roll a fresh member stack through the fleet with zero
    downtime (drain -> swap_params -> rejoin)."""
    from repro_torch.serving import client
    from repro_torch.serving.frontend import FrontendServer, Replica, Router

    kw = dict(n_slots=2, max_prompt=16, max_out=8, prefill_chunk=8,
              device=device)
    replicas = [Replica(f"r{i}", EnsembleEngine(cfg, params, **kw))
                for i in range(2)]
    router = Router(replicas)
    srv = FrontendServer(router)
    srv.start()
    try:
        print(f"\nfrontend: {srv.url} (2 replicas, least-loaded routing)")
        prompt = np.arange(1, 9) % cfg.vocab_size
        out = client.http_generate(srv.url, prompt, 8, stream=True)
        print(f"  SSE streamed {out['n_gen']} tokens from replica "
              f"{out['replica']}: {out['tokens']} "
              f"(ttft {out['ttft_ms']:.1f} ms)")
        new_params = make_params(cfg, replicas[0].engine.n_members, device,
                                 seed=42)
        router.rollout(new_params)
        out2 = client.http_generate(srv.url, prompt, 8, stream=False)
        swaps = [r.engine.swaps_done for r in replicas]
        print(f"  rolled out a new member stack with zero downtime "
              f"(swaps: {swaps}); post-swap tokens: {out2['tokens']}")
    finally:
        srv.shutdown()
        print("  drained and shut down")
    return {"sse_tokens": list(out["tokens"]),
            "post_swap_tokens": list(out2["tokens"]), "swaps": swaps}


if __name__ == "__main__":
    main()
