"""Serving launcher for the PyTorch/CUDA port: the EC-DNN_G ensemble
engine behind a CLI, a static batch or continuous batching.

All K members score each step together and their output distributions
are averaged (paper Eqn 6) before sampling; --members 1 serves a single
model through the identical path.  Runs on the card unless --device cpu.

  python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
      --members 4 --batch 4 --prompt-len 16 --steps 16 --paged
  python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
      --members 4 --batch 4 --prompt-len 16 --steps 16 --paged \
      --continuous --requests 12 --prefix-cache

--kv-dtype int8 / fp8 stores the paged pool quantized (per-token scales
the paged kernel applies as it reads; bf16 halves f32 pages).
--draft-ckpt ROOT serves speculative decoding with the student restored
from a checkpoint root (the newest committed step, checkpoint/store.py)
as the draft; --draft-ckpt member0 drafts with member 0's weights.
--gamma sets the drafted tokens an iteration, --spec-sampling
rejection-samples temperature > 0 requests (both with --draft-ckpt).

  python -m repro_torch.launch.serve --arch gemma3-1b --reduced \
      --members 4 --paged --kv-dtype int8 --draft-ckpt member0 --gamma 4

HTTP frontend (SSE streaming, /metrics, /healthz; N replicas behind a
least-loaded router, each with its own copy of the weights; Ctrl-C
drains gracefully):

  python -m repro_torch.launch.serve --arch gemma3-1b --members 4 \
      --paged --http --port 8000 --replicas 2
  curl -s localhost:8000/v1/generate -d '{"tokens":[1,2,3],"max_new":8}'
  curl -s localhost:8000/admin/swap -d '{"seed": 1}'   # drain-swap

POST /admin/swap rolls out the stack transformer.init makes from a seed.

--mesh MxD shards the member axis over M ranks (x D data ranks, which
replicate): one process a rank on the cards there are, each dim clamped
to them (member first), so one card runs --mesh 2x1 as a 1x1 mesh (a
1-rank NCCL group: the mesh path with its collectives); --device cpu
runs M x D CPU processes over gloo.  The first rank serves (the batch,
--continuous or --http, one replica); the others replay its engine
calls.  Each rank holds K/M members' params and cache.  Ctrl-C reaches
every rank: the first drains and releases the others, which ignore it.

  python -m repro_torch.launch.serve --reduced --members 4 --mesh 2x1 \
      --paged --device cpu --dtype float32

--fleet runs each replica as its own OS process (repro_torch.serving.
frontend.replica, on the device --device names) behind a crash-latching
FleetRouter; --load drives --requests synthetic requests through either
and prints the report instead of serving until Ctrl-C.  --watch-ckpt DIR
polls a checkpoint root (checkpoint/store.py) and rolls each newly
committed round into the fleet with the drain -> swap -> rejoin rollout
(--canary stages it on one replica first).

  python -m repro_torch.launch.serve --reduced --members 2 --http \
      --replicas 2 --load --requests 8 --device cpu --dtype float32

The static batch prints tokens per second (host clock around a generate
call that ends in a device synchronise, after a warm-up call) and a
sample; --continuous serves --requests synthetic requests through the
Scheduler and prints client.print_report's tok/s, TTFT and latency
percentiles.  A speed printed here is only meaningful beside the card's
name and power limit (nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader).
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

import numpy as np
import torch


def _load_requests(args, cfg):
    from repro_torch.serving import client
    return client.make_requests(
        args.requests, cfg.vocab_size,
        prompt_len=(max(2, args.prompt_len // 4), args.prompt_len),
        max_new=(max(1, args.steps // 2), args.steps), seed=args.seed)


def serve_http(args, cfg, build_engine) -> int:
    """Mount --replicas engines behind the router + HTTP frontend."""
    from repro_torch.serving import client
    from repro_torch.serving.frontend import FrontendServer, Replica, Router

    replicas = [Replica(f"r{i}", build_engine(),
                        prefill_budget=args.prefill_budget,
                        obs=not args.no_obs,
                        trace_log=args.trace_log or None,
                        profile_dir=args.profile_dir or None)
                for i in range(max(1, args.replicas))]
    for r in replicas:   # warm-up: load the kernels, first launches
        r.engine.generate([np.arange(1, min(4, args.prompt_len) + 1)],
                          max_new=2)
        r.engine.update_slots(release=range(r.engine.n_slots))
    router = Router(replicas, max_queue_depth=args.max_queue_depth)
    srv = FrontendServer(router, host=args.host, port=args.port,
                         verbose=not args.load,
                         admin_swap=_admin_swap(args, cfg, router),
                         profile_dir=args.profile_dir or None)
    srv.start()
    print(f"frontend: {srv.url}  ({len(replicas)} replica(s), "
          f"K={replicas[0].engine.n_members} members, "
          f"{replicas[0].engine.n_slots} slots each)")
    print(f"  POST {srv.url}/v1/generate  "
          '{"tokens": [...], "max_new": N, "stream": true|false}')
    print(f"  GET  {srv.url}/healthz   GET  {srv.url}/metrics")
    print(f"  POST {srv.url}/admin/swap  " '{"seed": s}')
    rc = 0
    try:
        if args.load:
            report = client.run_http_load(
                srv.url, _load_requests(args, cfg),
                concurrency=2 * len(replicas))
            client.print_report(report)
            rc = 1 if report["n_errors"] else 0
        elif args.watch_ckpt:
            watch_checkpoints(args.watch_ckpt, router, canary=args.canary)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        print("\ndraining ...")
    finally:
        srv.shutdown(drain=True)
    print("drained; bye")
    return rc


def _admin_swap(args, cfg, router):
    """POST /admin/swap for the in-process replicas: {"seed": s} rolls
    out the K-member stack transformer.init makes from that seed (drain
    -> swap -> rejoin; --watch-ckpt rolls checkpoint rounds)."""
    from repro_torch.models import transformer as tf

    def admin_swap(body: dict) -> dict:
        s = body.get("seed")
        if not isinstance(s, int) or isinstance(s, bool):
            raise ValueError(f'swap body needs an int "seed", got {s!r}')
        eng = router.replicas[0].engine
        router.rollout(tf.init(cfg, seed=s, device=eng.device,
                               members=args.members))
        return {"swaps_done": eng.swaps_done}

    return admin_swap


def _swap_template(engine):
    """A tree of the global (K, ...) member stack to restore a round
    into: the engine's live params, or over a mesh, where a rank holds
    K/M rows, host tensors of the global shapes."""
    from repro_torch.common.tree import tree_map
    if engine.mesh is None:
        return engine.params
    return tree_map(lambda x: torch.empty((engine.n_members, *x.shape[1:]),
                                          dtype=x.dtype), engine.params)


def serve_fleet(args, cfg) -> int:
    """--fleet: each replica its own OS process behind a FleetRouter.

    The processes rebuild bit-identical engines from one EngineSpec
    (seed-pinned init on the spec's device), so a request retried after
    a crash is token-exact.  --load drives the synthetic requests through
    the fleet with crash-retry and 429 backoff; --watch-ckpt rolls new
    rounds out over POST /admin/swap (with --canary staging)."""
    from repro_torch.serving.frontend import EngineSpec, FleetRouter

    if args.draft_ckpt not in ("", "member0"):
        raise SystemExit("--fleet drafts with --draft-ckpt member0 only "
                         "(the spec's ckpt restores the members)")
    spec = EngineSpec(
        arch=args.arch, reduced=args.reduced, dtype=args.dtype or "",
        members=args.members, seed=args.seed,
        n_slots=args.batch, max_prompt=args.prompt_len,
        max_out=args.steps, prefill_chunk=args.prefill_chunk,
        temperature=args.temperature, top_k=args.top_k,
        eos_id=args.eos_id,
        quorum=([float(x) for x in args.quorum.split(",")]
                if args.quorum else None),
        paged=args.paged, page_size=args.page_size,
        n_pages=args.n_pages, prefix_cache=args.prefix_cache,
        kv_dtype=args.kv_dtype, draft_member0=bool(args.draft_ckpt),
        gamma=args.gamma, spec_sampling=args.spec_sampling,
        prefill_budget=args.prefill_budget,
        obs=not args.no_obs, trace_log=args.trace_log,
        profile_dir=args.profile_dir, device=args.device or "")
    fleet = FleetRouter(spec, n=max(1, args.replicas), host=args.host,
                        max_queue_depth=args.max_queue_depth)
    print(f"spawning {max(1, args.replicas)} replica process(es) "
          f"(K={spec.members} members each, device "
          f"{spec.device or 'cuda'}) ...")
    fleet.start()
    for p in fleet.procs:
        print(f"  {p.name}: pid {p.proc.pid}  {p.url}  params {p.digest}")
    rc = 0
    try:
        if args.load:
            reqs = _load_requests(args, cfg)
            done, errs = [], []
            lock = threading.Lock()
            nxt = {"i": 0}

            def worker():
                while True:
                    with lock:
                        i = nxt["i"]
                        if i >= len(reqs):
                            return
                        nxt["i"] += 1
                    try:
                        out = fleet.generate(*reqs[i])
                        with lock:
                            done.append(out)
                    except Exception as e:  # noqa: BLE001 - counted
                        with lock:
                            errs.append(repr(e))

            t0 = time.time()
            threads = [threading.Thread(target=worker, daemon=True)
                       for _ in range(2 * len(fleet.procs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.time() - t0
            n_tok = sum(r["n_gen"] for r in done)
            s = fleet.stats()
            print(f"fleet served {len(done)}/{len(reqs)} requests "
                  f"({len(errs)} errors) | {n_tok} tokens in "
                  f"{wall:.2f}s = {n_tok / max(wall, 1e-9):.1f} tok/s")
            print(f"  retried {s['retried']}, 429 backoffs "
                  f"{s['backoffs']}, latched {s['latched']}")
            rc = 1 if errs else 0
        elif args.watch_ckpt:
            from repro_torch.checkpoint.store import latest_step
            served = None
            while True:
                latest = latest_step(args.watch_ckpt)
                if latest is not None and latest != served:
                    fleet.rollout(ckpt=args.watch_ckpt, step=latest,
                                  canary=args.canary)
                    served = latest
                    print(f"rolled out round {served} fleet-wide")
                time.sleep(5.0)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        print("\nterminating fleet ...")
    finally:
        fleet.stop()
    print("fleet down; bye")
    return rc


def watch_checkpoints(root: str, router, poll_s: float = 5.0,
                      canary: float = 0.0):
    """Poll a checkpoint root; hot-swap each newly committed round into
    the fleet (drain -> swap -> rejoin, zero drops).  canary > 0 routes
    that traffic fraction at one swapped replica first and aborts the
    rollout if it fails.  The round already on disk at start-up is
    rolled in FIRST: a restarted server must serve the trained weights,
    not the random init its engines were built with."""
    from repro_torch.checkpoint.store import latest_step, restore_checkpoint

    served = None
    print(f"watching {root} (round on disk: {latest_step(root)})")
    while True:
        latest = latest_step(root)
        if latest is not None and latest != served:
            template = _swap_template(router.replicas[0].engine)
            router.rollout(restore_checkpoint(root, latest, template),
                           canary=canary)
            served = latest
            print(f"rolled out round {served} (swaps: "
                  f"{[r.engine.swaps_done for r in router.replicas]})")
        time.sleep(poll_s)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--members", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (concurrent requests)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16,
                    help="max new tokens per request")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per prefill call (0: per-token "
                         "reference path; default: from --prompt-len and "
                         "--page-size)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="prompt tokens prefilled per scheduler "
                         "iteration (--continuous; default: 2 chunks)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool behind a per-slot page table")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=None,
                    help="physical pages in the pool (--paged; default: "
                         "every slot at full length; fewer oversubscribes "
                         "and relies on preemption)")
    ap.add_argument("--kv-dtype", default="f32",
                    choices=["f32", "bf16", "int8", "fp8"],
                    help="paged KV page storage (--paged): f32 keeps the "
                         "model's dtype; int8 / fp8 quantize each token "
                         "with an absmax scale the kernel applies")
    ap.add_argument("--draft-ckpt", default="",
                    help="speculative decoding: the compressed student at "
                         "this checkpoint root drafts for the ensemble; "
                         "'member0' drafts with member 0's weights")
    ap.add_argument("--gamma", type=int, default=4,
                    help="drafted tokens per speculative iteration "
                         "(--draft-ckpt)")
    ap.add_argument("--spec-sampling", action="store_true",
                    help="rejection-sample temperature > 0 requests "
                         "against the fused distribution instead of "
                         "greedy exact-match acceptance")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV pages across requests with a common "
                         "prompt prefix (--paged, and every layer paged)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--quorum", default="",
                    help="comma 0/1 per member, e.g. 1,1,0,1")
    ap.add_argument("--mesh", default="",
                    help="'MxD' member x data device grid (e.g. 2x1): "
                         "shard the member axis over M devices; empty "
                         "or 1x1 keeps the single-device path")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching under synthetic load")
    ap.add_argument("--requests", type=int, default=32,
                    help="synthetic requests (--continuous / --load)")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP: POST /v1/generate (SSE "
                         "streaming), GET /metrics, GET /healthz; "
                         "Ctrl-C drains gracefully")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="HTTP port (--http; 0 picks an ephemeral one)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the frontend router "
                         "(--http), in this process: each its own cache "
                         "pool and loop thread over one shared set of "
                         "weights (--fleet runs a process per replica)")
    ap.add_argument("--fleet", action="store_true",
                    help="with --http: run each replica as its own OS "
                         "process (engine + scheduler + HTTP surface) "
                         "behind a crash-latching FleetRouter")
    ap.add_argument("--load", action="store_true",
                    help="with --http: drive the synthetic requests "
                         "through the HTTP path and print the report "
                         "instead of serving until Ctrl-C")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="backpressure: past this fleet-wide queue "
                         "depth, POST /v1/generate answers 429 with "
                         "Retry-After instead of queueing")
    ap.add_argument("--canary", type=float, default=0.0,
                    help="rollout canary fraction: swap one replica "
                         "first and route this share of traffic at it "
                         "(--watch-ckpt)")
    ap.add_argument("--watch-ckpt", default="",
                    help="with --http: poll this checkpoint root and "
                         "hot-swap each newly committed round into the "
                         "fleet (drain -> swap -> rejoin)")
    ap.add_argument("--profile-dir", default="",
                    help="torch.profiler output dir; arms POST "
                         "/admin/profile {\"ticks\": N} to trace N "
                         "scheduler ticks")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the observability layer (request "
                         "traces, latency histograms, tick phases)")
    ap.add_argument("--trace-log", default="",
                    help="append one JSON line per finished request "
                         "trace to this file (obs must be on)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="override the config's param/activation dtype")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    from repro_torch.common import sharding as shd
    from repro_torch.configs import registry

    cfg = registry.get_config(args.arch, reduced=args.reduced)
    if args.dtype:
        cfg = cfg.with_(dtype=args.dtype)
    shape = shd.mesh_shape_arg(args.mesh)
    if shape is not None:
        if args.fleet or args.replicas > 1:
            raise SystemExit("--mesh serves one engine: --fleet and "
                             "--replicas > 1 over a mesh are not ported")
        return serve_mesh(argv, shape, args.device)
    if args.http and args.fleet:
        # the replica processes build the engines (on --device, which
        # each resolves itself); the parent never makes params
        return serve_fleet(args, cfg)
    return serve(args, cfg)


def serve_mesh(argv, shape, device_arg) -> int:
    """--mesh MxD: one rank a device, M x D clamped to the cards there
    are (the CPU: as many processes as asked); a 1-rank mesh runs in
    this process.  -> the ranks' largest exit code."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.device import resolve_device
    kind = resolve_device(device_arg).type
    m, d = shape
    if kind == "cuda":
        count = torch.cuda.device_count()
        m = max(1, min(m, count))
        d = max(1, min(d, count // m))
    if m * d == 1:
        return _mesh_rank(0, argv, shape)
    world = shd.spawn(_mesh_rank, m * d, (argv, shape), device=kind,
                      timeout=float("inf"), wait=False)
    # Ctrl-C reaches every process of the terminal's group: the leader
    # drains and releases the followers, which ignore it, as this one does
    on_main = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGINT, signal.SIG_IGN) if on_main else None
    try:
        return max(world.join())
    finally:
        if on_main:
            signal.signal(signal.SIGINT, old)


def _mesh_rank(rank: int, argv, shape) -> int:
    """One rank of --mesh: its engine over local_mesh(M, D); the first
    rank serves, the others follow."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.device import resolve_device
    from repro_torch.configs import registry
    args = _parser().parse_args(argv)
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    if args.dtype:
        cfg = cfg.with_(dtype=args.dtype)
    mesh = shd.local_mesh(*shape, device=resolve_device(args.device).type)
    return serve(args, cfg, mesh)


def serve(args, cfg, mesh=None) -> int:
    """Build the engine (on a mesh, this rank's) and serve --http,
    --continuous or the static batch."""
    from repro_torch.common import sharding as shd
    from repro_torch.common.device import entry_device
    from repro_torch.common.tree import tree_map
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine

    device = entry_device(args.device)
    K = args.members
    quorum = ([float(x) for x in args.quorum.split(",")]
              if args.quorum else None)
    if quorum is not None and len(quorum) != K:
        raise SystemExit(f"--quorum needs {K} entries, got {len(quorum)}")
    params = tf.init(cfg, seed=args.seed, device=device, members=K)
    kw = dict(n_slots=args.batch, max_prompt=args.prompt_len,
              max_out=args.steps, prefill_chunk=args.prefill_chunk,
              temperature=args.temperature, top_k=args.top_k,
              eos_id=args.eos_id, quorum=quorum, seed=args.seed,
              paged=args.paged, page_size=args.page_size,
              n_pages=args.n_pages, prefix_cache=args.prefix_cache,
              kv_dtype=args.kv_dtype, device=device, mesh=mesh)
    draft = None
    if args.draft_ckpt:
        from repro_torch.serving.spec.draft import load_draft
        if args.draft_ckpt != "member0":
            draft, step = load_draft(args.draft_ckpt, params)
            print(f"draft model: step {step} from {args.draft_ckpt}")
        else:
            draft = tree_map(lambda x: x[:1].clone(), params)
            print("draft model: member 0")

    def build_engine():
        """One replica's engine, over the weights every replica shares
        (a rollout drains and swaps them together)."""
        if draft is None:
            return EnsembleEngine(cfg, params, **kw)
        from repro_torch.serving.spec import SpeculativeEngine
        return SpeculativeEngine(cfg, params, draft, gamma=args.gamma,
                                 spec_sampling=args.spec_sampling, **kw)

    if mesh is not None:
        engine = build_engine()
        del params                 # the engine holds this rank's rows
        if not shd.is_leader(mesh):
            signal.signal(signal.SIGINT, signal.SIG_IGN)  # the leader's
            engine.follow()
            if engine.replay_errors:
                print(f"calls that raised on every rank: "
                      f"{engine.replay_errors}", file=sys.stderr)
                return 1
            return 0
        try:
            return _drive(args, cfg, device, engine, K, lambda: engine)
        finally:
            engine.close()
    if args.http:
        return serve_http(args, cfg, build_engine)
    return _drive(args, cfg, device, build_engine(), K, build_engine)


def _drive(args, cfg, device, engine, K, build_engine) -> int:
    """Serve from `engine` (a mesh's leader, or the one device's)."""
    from repro_torch.serving import client
    where = (f"{device} ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else f"{device} (host)")
    if engine.mesh is not None:
        mesh = engine.mesh
        grid = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        where = (f"mesh {grid} over {mesh.mesh.numel()} devices, "
                 f"{K // engine.member_shards} members/device, {where}")
    print(f"engine: K={K} members, {args.batch} slots, prefill chunk "
          f"{engine.prefill_chunk}, {where}, cache pool "
          f"{engine.cache_bytes() / 2**20:.1f} MiB/device")
    if args.paged:
        ps = engine.page_stats()
        print(f"paged pool: {ps['n_pages']} pages x {ps['page_size']} tok "
              f"({ps['pages_per_slot']} pages/slot max), free list "
              f"{ps['free_pages']}/{ps['n_pages']}, {ps['kv_dtype']} "
              f"pages, {ps['page_bytes']} B/page, "
              f"{ps['bytes_per_token']} B/token")
    if args.http:
        return serve_http(args, cfg, build_engine)

    if args.continuous:
        reqs = client.make_requests(
            args.requests, cfg.vocab_size,
            prompt_len=(max(2, args.prompt_len // 4), args.prompt_len),
            max_new=(max(1, args.steps // 2), args.steps), seed=args.seed)
        # warm-up outside the timed run (max_new=2: prefill and decode)
        engine.generate([reqs[0][0]], max_new=2)
        client.print_report(client.run_load(
            engine, reqs, prefill_budget=args.prefill_budget,
            obs=not args.no_obs, trace_log=args.trace_log or None))
        _print_spec(engine)
        return 0

    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    engine.generate(list(prompt), max_new=args.steps)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = engine.generate(list(prompt), max_new=args.steps)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"served batch={args.batch} members={K} steps={args.steps}: "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print("sample:", outs[0][:16].tolist())
    _print_spec(engine)
    return 0


def _print_spec(engine) -> None:
    if hasattr(engine, "spec_stats"):
        st = engine.spec_stats()
        print(f"speculative: gamma {st['gamma']}, {st['spec_steps']} "
              f"iterations, acceptance {st['acceptance_rate']:.3f}, "
              f"{st['mean_accepted_len']:.2f} tokens an iteration")


if __name__ == "__main__":
    raise SystemExit(main())
