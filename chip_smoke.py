#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each, in the order 0, 1, 7, 10, 11, 2, 8, 9, 12,
16, 17, 18, 13, 19, 20, 21, 3, 4, 5, 6, 14, 15, 22, 23, 24:
  0  the card's name and power limit; build every CUDA kernel from
     src/repro_torch/kernels/csrc (one nvcc per source, all at once);
     every kernel function's registers and spills (ptxas) and each
     library's count of tensor-core instructions (cuobjdump);
  1  the paged-attention kernel against its plain PyTorch version on the
     card, at the decode path's shapes (gemma3-1b's in every variant it
     takes, deepseek-7b's, jamba's and qwen2-vl-2b's (12 heads over 2 kv
     heads, g = 6) in bf16, deepseek-v2's absorbed
     MLA decode in bf16 and f32: 128 heads over one latent "kv head", r
     512 + rope 64 as k_extra, the latent plane as keys and values), bf16
     queries over int8 and fp8 pages with their scales at gemma3-1b's and
     deepseek-7b's shapes and over an int8 latent at the MLA shape (their
     library call: SDPA over K/V gathered and dequantized beforehand;
     every quantized row's pages are attention.kv_quantize's of O(1)
     values, and the row fails where zeros, or the plain version without
     k_scale or without v_scale, would pass its tolerance), with
     its time (cold L2), the plain version's, one library call's, the
     bound, the query heads a block holds and the number of blocks each
     row's pages are split over;
  7  the flash-attention kernel likewise, f32 and bf16, at the prefill's
     shapes (gemma3-1b over a 512 ring and over 576 gathered positions,
     deepseek-7b over 576, each plus a 128-token chunk, mid-prompt and
     ragged tail), the full forward's (top-left causal, T = S = 2048)
     and phase 14's relabel and eval chunk (16 sequences, T = S = 64,
     gemma3-1b's heads, window 0 and 512), phase 24's relabel score
     (one sequence, T = S = 4096, window 0 and 512), whisper-tiny's
     encoder (no
     mask, 16 rows, T = S = 1500: ragged tiles), its prefill chunk's
     cross-attention (no mask, 128 queries over 1500 frames) and
     self-attention, qwen2-vl-2b's prefill chunk (g = 6), and speculative
     verify's pass (16 rows of 5 queries at per-row positions 300-512
     over 576 keys, f32 and bf16), beside one
     scaled_dot_product_attention call with the same boolean mask, and
     the share of key tiles the kernel skips (its predicate's twin,
     kernels/ref.flash_tile_live);
 10  the wkv6 kernel (the rwkv6 recurrence) likewise, f32, at rwkv6-7b's
     shapes: the decode step (16 rows, one token, a strided state view),
     a mid-prompt prefill chunk (4 rows, 128 tokens, a nonzero state and
     a masked ragged tail), apply (4 rows, 2048 tokens) and a prefill
     chunk with decays down to the models' clamp (-e^4 a token) and
     phase 15's relabel call (one member on 64 sequences of 64 tokens);
     each with its launch's path, blocks, chunk and column tile; no single
     PyTorch call computes the recurrence, so it has no library time;
 11  the ssm_scan kernel (Mamba's selective scan) likewise, f32, at
     jamba's shapes (d_inner 8192, d_state 16, K = 2): the decode step (8
     rows, one token, a strided state view), a mid-prompt prefill chunk
     (2 rows, 128 tokens, a nonzero state), apply (2 rows, 2048 tokens)
     and phase 15's relabel call (44 rows, 64 tokens), each with its
     launch's variant (short or long T) and blocks; no single PyTorch
     call computes a first-order recurrence with per-step coefficients,
     so it has no library time either;
  2  the serving path at full width: gemma3-1b (bf16, 26 layers), K=4
     members, paged KV over bf16 pages, 4 requests of 300-512 prompt
     tokens served
     through EnsembleEngine.generate for 32 new tokens; both kernels'
     launch counts must equal the formulas printed (paged attention per
     decode step, flash attention per prefill call); prefill's device
     time by the profiler beside its host seconds;
  8  the same for deepseek-7b at full width (bf16, 30 layers, every one
     paged), after an init that must peak below 60 GB;
  9  the same for rwkv6-7b at full width (bf16, 32 rwkv layers, none
     paged): wkv6 once per layer per decode step and per prefill call,
     the attention kernels never; init below 60 GB;
 12  the same for jamba-v0.1-52b at full width, cut to one published
     period (8 layers: 7 Mamba, 1 attention, 4 MoE) and K = 2 members
     (the 32-layer model does not fit one card): ssm_scan once per Mamba
     layer per decode step and per 128-token piece of a prefill call,
     paged attention on the attention layer per decode step, flash
     attention per prefill call, wkv6 never; init below 60 GB;
 16  the same for deepseek-v2-236b at full width (bf16, MLA of 128 heads
     over a 512 latent, 160 experts top-6 with 2 shared), K = 4, cut to
     2 of 60 layers (the dense first layer and one MoE layer; 42.9 GB of
     weights, three layers would be 74.6): the absorbed paged decode
     launches paged attention once per MLA layer per decode step; MLA
     prefill takes the plain attend, as the JAX package does, so flash
     attention never; init below 60 GB;
 17  the same for whisper-tiny at full width and depth (bf16, 4 encoder
     and 4 decoder layers, d 384, 1500 frames), K = 4, from the
     contiguous pool (an enc-dec engine refuses pages, as the JAX one
     does), prompts of 16-128 tokens (one chunk each) and 64 new tokens:
     flash attention twice per decoder layer per prefill call (self and
     cross), decode on the plain attend (no kernel), as the JAX package
     decodes; the engine's encoder stub over 4 slots timed and counted
     apart (flash once per encoder layer, no mask);
 18  the same for qwen2-vl-2b at full width and depth (bf16, 28 layers,
     M-RoPE, 12 heads over 2 kv heads), K = 4, paged as phase 2; init
     below 60 GB.
     Phases 2, 8, 9, 12, 16, 17 and 18 give each kernel's device time per
     launch in situ (profiler sum over launches, decode and prefill apart);
 13  continuous batching at full width: gemma3-1b in f32 (greedy
     decisive), K=4, paged (page 16, every layer: max_prompt 448 +
     max_out 64 = the local window), 4 slots over a pool cut to 3 slots
     at full length (96 pages), 16 requests submitted at once in four
     groups sharing a system prompt (256 tokens, page-aligned, or 200,
     mid-page), served by Scheduler.run with the prefix cache off and
     then on: every request completes, admission is FIFO, both runs
     preempt, the prefix-on run hits and copies pages on write, the
     pool is whole after each drain, the tokens are identical on and
     off on every step whose top-2 fused log-prob margin clears 2e-5,
     paged attention launches 26 times per decode step and flash
     attention 26 times per prefill call; tok/s, TTFT and latency
     percentiles, tick phases, and decode over shared pages (ms per
     step, idle share, both kernels' time per launch in situ);
 19  quantized KV pages at full width: gemma3-1b as phase 2 over int8
     and fp8 pages (phase 2 itself serves over bf16 pages, the baseline):
     paged launches as phase 2's formula, no NaN among the fused
     log-probs (phase 2 holds both checks too); decode ms a
     step, busy ms, idle share, the paged kernel's in-situ ms a launch,
     page bytes and bytes a token, and the int8 / fp8 tokens' agreement
     with the bf16 pages' (printed only);
 20  speculative decoding at full width: gemma3-1b in f32, K = 4,
     paged, phase 2's requests, gamma 4, with three drafts: member 0 as
     a K = 1 stack saved and restored through checkpoint/store.py, member
     0 with seeded noise on its weights (it must reject drafts and accept
     some chunks in part: rollback runs) and member 0's first 2 layers;
     each run's tokens equal the plain engine's on every step whose fused
     top-2 margin clears 2e-5; flash launches once per attention layer a
     speculative iteration (and per layer of each prefill call, the
     draft's and the members'), the paged kernel never; acceptance,
     emitted lengths, tokens an iteration, generate's seconds in prefill
     calls and the rest for each run and the plain engine, and for member
     0's run host and busy ms an iteration, idle share, peak memory;
 21  the network tier at full width: gemma3-1b in f32, K = 4, paged,
     phase 2's prompts and 32 new tokens.  21a: two in-process replicas
     behind Router and FrontendServer (127.0.0.1, an ephemeral port), 8
     requests through one engine's Scheduler.run alone (the baseline
     the two replicas' loop threads are held against), then from client
     threads through the router alone and then over HTTP (half JSON,
     half SSE): tokens equal the engines' in-process
     generate on every step whose fused margin clears 2e-5, /healthz shows
     whole pools after the drain, paged attention launches once per paged
     layer per decode step and flash attention once per attention layer
     per prefill call (the HTTP run's counts are the kernels line's
     "gemma3-1b http"); then the requests again, 0.5 s apart, while
     Router.rollout swaps both replicas to seed 1: none dropped, each on
     the old or the new weights, and afterwards a fresh seed-1 engine's
     tokens; tok/s, client TTFT p50 / p99 and the server's percentiles
     from /metrics.  21b: a FleetRouter of two replica processes on the
     card from one EngineSpec (each child's weight digest equal to the
     parent's), 32 threaded requests, one child SIGKILLed after 8
     completions and restarted: every request completes, token-exact
     against 21a's references under the margin rule, both pools whole,
     SIGTERM exits 0; spawn-to-ready and restart seconds, tok/s, retried
     and latched counts, each child's peak memory;
  3  the card against the CPU end to end on reduced gemma3-1b,
     deepseek-7b, rwkv6-7b, jamba-v0.1-52b, deepseek-v2-236b, whisper-tiny
     (contiguous) and qwen2-vl-2b at f32: identical greedy tokens and
     allclose fused log-probs; Scheduler.run gives identical completions
     and preemptions on both (prefix cache on for gemma3-1b, deepseek-7b,
     deepseek-v2-236b and qwen2-vl-2b, off with a pool that preempts for
     rwkv6-7b, jamba and qwen2-vl-2b, the contiguous pool for
     whisper-tiny), and engine.score agrees within 1e-4 and keeps the
     Jensen bound; reduced gemma3-1b over int8 pages and with speculative
     decoding (gamma 3) gives identical tokens and fused log-probs
     within 1e-4;
  4  the fused distillation-loss kernels (forward and backward) against
     their plain version on the card: the NiN training path's shape, a
     262k bf16 vocab (gemma3-1b's distill step), rwkv6-7b's in phase 15
     (N 2048 x V 65536 bf16), and f32 with padded labels; times as in
     phase 1,
     beside one F.cross_entropy call with probability targets;
  5  the training path at full width: paper NiN, K=4 members, batch 64
     each, 2 EC rounds through Trainer.run_round (round 1 opens with 8
     Eqn-9 distill steps); the kernels' launch counts must equal the
     formula printed, every loss be finite and the Jensen gap >= 0;
     device ms per step by CUDA events (no profiler) against host ms;
  6  the card against the CPU on reduced NiN (K=4, momentum SGD),
     reduced gemma3-1b (K=2, AdamW, dense and then top-8 labels),
     reduced rwkv6-7b and reduced jamba cut to 4 layers (K=2, AdamW,
     dense labels) at f32: one plain and one distill round each, losses
     and evaluate() metrics within 1e-4 (rwkv6-7b: or twice the gap
     between its two f32 routes on the CPU, a gap held below 1e-3);
     the rwkv6-7b trainers' states written from the card restore on the
     CPU bit for bit and the reverse, and a trainer resumed from its
     round-2 checkpoint runs round 3 as an uninterrupted one does;
 14  EC training at full width: gemma3-1b (bf16, 26 layers, d_model
     1152, vocab 262144), K=4, AdamW, batch 8 of 64 tokens a member, 32
     sequences a member, relabel 70% (22), tau 4, p 2: two rounds with
     dense labels (round 1's two distill steps launch the fused kernels
     at N 2048 x V 262144, once each way a step), then two with top-64
     labels on a fresh trainer (no fused launch); every loss finite, the
     Jensen gap >= 0, no flash launch inside a training step, the
     formula's count in a relabel and at least the relabels' count over
     the rounds (their evals add more), peak memory below 80 GB; host ms a
     step beside the profiler's device busy ms (the idle share), relabel
     seconds; the flash, wkv6 and ssm_scan wrappers refuse an input that
     requires grad;
 15  EC training of the recurrent families at full width, as phase 14
     with dense labels: rwkv6-7b (bf16, d_model 4096, vocab 65536) cut
     to 3 of 32 layers, K=4, AdamW with f32 moments; then jamba (bf16,
     Mamba d_inner 8192, 16 experts top-2) cut to its first 2 layers
     (Mamba-dense, Mamba-MoE), K=2, AdamW with bf16 moments; two rounds
     each (round 1's distill steps launch the fused kernels at N 2048 /
     1024 x V 65536); no wkv6 / ssm_scan launch inside a training step,
     the formula's count in a relabel, peak below 80 GB; host ms, busy
     ms, AdamW's device ms, relabel and round seconds, tokens/s;
 22  the member axis across ranks (common/sharding.py, one process a
     rank), gemma3-1b at full width cut to 13 of 26 layers.  22a: f32,
     K = 4, paged,
     phase 2's prompts and 32 new tokens: the single-process engine
     (mesh=None) as the reference, then the mesh path at world size 1
     under NCCL in this process, then two ranks on the card under gloo
     (2 members a rank; and two ranks under NCCL, a card each, where
     there are two cards), whose leader also serves phase 21a's 8
     requests through Scheduler.run: tokens equal the reference's on
     every step whose fused top-2 margin clears 2e-5, fused log-probs
     within 1e-4, every rank's slot state equal to rank 0's, paged
     launches per rank as phase 2's formula, flash per prefill call,
     each rank's cache bytes half the reference's; decode ms a step,
     each rank's busy ms and idle share, the fusion's all-reduce ms a
     step (profiler), peak memory a rank.  22b: phase 14's training
     (bf16, AdamW) at K = 2 over four ranks on the card under gloo, a
     2 x 2 mesh: a member a rank along the ring's axis, each member's
     rows split over 2 data ranks (gradients averaged over them before
     AdamW), protocol ring: two dense EC rounds and one top-64,
     evaluate() after each mode (finite, Jensen gap >= 0), a member's
     two replicas' params bit for bit equal after every round (a digest
     of their bits); distill launches once each way a distill step; on
     each rank's share of one relabel subset the ring's dense targets
     equal the mesh all-gather's within 1e-4, each relabel's flash
     launches as its formula (over the share's rows), the bytes each
     ring sent equal to K - 1 hops of tokens and K of its accumulator;
     relabel seconds (ring, all-gather, ring top-64), host and busy ms a
     step; then reshard 2 -> 4 members over the mesh and one all-gather
     round (finite, Jensen gap >= 0, replicas equal); peak memory a
     rank, before the reshard and in all;
 23  the paper's experiments and the examples through their entry points
     (repro_torch/paper, repro_torch/examples): Table 1 and Figures 1-2
     at --fast (NiN width 96, K = 4), the faithful run at --fast (the
     paper's NiN, K = 4, 32x32), the quickstart, the LM example on
     reduced gemma3-1b (top-8 labels, 2 rounds, then resumed from its
     checkpoint for a third) and the serving example on reduced
     deepseek-7b on one device with its paged and frontend demos; every
     kernel count set to 0 before each and read after: each trainer's
     distill launches equal (rounds - 1) x p_steps each way for an EC
     run with dense labels and 0 otherwise, every EC evaluate()'s
     Jensen gap >= -1e-6, every number finite, the LM example's flash
     and the serving example's paged and flash launches above 0; the
     paper's orderings printed, not asserted;
 24  the dry-run (launch/dryrun.py) held against the card: gemma3-1b's
     prefill_32k (batch cut 32 -> 1), decode_32k (128 rows over a 32k
     cache, depth 26 -> 13 layers) and train_4k[plain] (K = 1 of 16
     members, batch 256 -> 1, depth 26 -> 6 layers; both depth cuts for
     the phase's time: a fake op costs ~0.3 ms of host) on a (1, 1) mesh:
     each traced on fake CUDA tensors (the kernels through their custom
     ops' fake implementations), then run for real from seeded weights,
     once under the accounting and a few times timed (CUDA events).
     The fake and the real FLOPs must be equal, max(t_comp, t_mem) of
     the roofline at most 1.05x the measured median (a bound the card
     beats is a wrong count), and the prefill's flash launches equal
     layers x calls; the predicted peak bytes are printed beside
     max_memory_allocated.  Also the host microseconds a call of the
     flash kernel takes through its custom op, the routing ops.py and the
     wrapper alone.  The relabel step (launch/specs.build_relabel_cell)
     likewise on the (1, 1) mesh, in the same loop, by its first part:
     the score of one chunk (one sequence of 4096 tokens, 26 layers,
     the shape phase 7 holds the kernel at) fake against real FLOPs,
     bound against the measured median, flash launches layers x calls;
     and, in a child process over a fake world of 2 ranks, the cell at
     22b's shape (its rows a rank, K = 2, 22b's layers, top-64), whose
     collective-permute bytes must equal what 22b's top-64 ring sent.
Then the kernels line, the card line, and last the result line.  Any
failure exits non-zero before the result line.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12}    # bf16 tensor cores, dense
MAIN = dict(rows=16, H=4, Hkv=1, d=256, page=16, max_len=576)
# the other decode shapes: deepseek-7b (K = 4 x 4 slots, every head its
# own kv head) and jamba (K = 2 x 4 slots, g = 4), prompts of 300-512
# plus 32 new tokens
DEEPSEEK = dict(rows=16, H=32, Hkv=32, d=128, page=16, min_len=300,
                max_len=544)
JAMBA = dict(rows=8, H=32, Hkv=8, d=128, page=16, min_len=300, max_len=544)
# deepseek-v2's absorbed MLA decode (K = 4 x 4 slots): 128 heads over one
# latent "kv head" of 512 features, 64 rope features as k_extra, the
# softmax scale 1/sqrt(qk_nope 128 + rope 64)
DEEPSEEK_V2 = dict(rows=16, H=128, Hkv=1, page=16, min_len=300,
                   max_len=544, scale=192 ** -0.5)
# qwen2-vl-2b's decode (K = 4 x 4 slots): 12 query heads over 2 kv heads
# (g = 6) at dh 128, prompts of 300-512 plus 32 new tokens
QWEN2_VL = dict(rows=16, H=12, Hkv=2, d=128, page=16, min_len=300,
                max_len=544)
FLUSH_BYTES = 64 << 20             # > the 50 MB L2: each timed call starts cold
SLEEP_CYCLES = 5_000_000           # ~2.5 ms of GPU clock: outlasts any enqueue


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's seconds so far
    (t_s), which say where the run's time goes."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def ptxas_report(build) -> dict:
    """Registers and spill bytes of every kernel function, from the
    ptxas report beside each built library, and the count of tensor-core
    instructions (HMMA / HGMMA) in each library's SASS."""
    import re
    pat = re.compile(r"Function properties for (\S+)\n\s*(\d+) bytes stack "
                     r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                     r"loads\n.*?Used (\d+) registers")
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = {}
    for name in build.KERNELS:
        lib = build.lib_path(name)
        log = lib.with_name(lib.name + ".log").read_text()
        found = pat.findall(log)
        names = [fn for fn, *_ in found]
        if shutil.which("c++filt"):     # readable names where it exists
            names = subprocess.run(["c++filt"], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
        fns = {}
        for fn, (_, _, st, ld, regs) in zip(names, found):
            fn = fn.replace("(anonymous namespace)::", "").split("(")[0] \
                .removeprefix("void ")
            fns[fn] = {"registers": int(regs), "spill_stores": int(st),
                       "spill_loads": int(ld)}
        out[name] = {"functions": fns, "hmma": None, "hgmma": None}
        if os.path.exists(tool):
            sass = subprocess.run([tool, "-sass", str(lib)],
                                  capture_output=True, text=True,
                                  timeout=300, check=True).stdout.splitlines()
            out[name]["hmma"] = sum("HMMA" in ln for ln in sass)
            out[name]["hgmma"] = sum("HGMMA" in ln for ln in sass)
    return out


def time_ms(fn, torch, flush, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one call by CUDA events around the call
    alone.  The L2 is flushed before each call, and the stream is held
    busy (torch.cuda._sleep) while the host enqueues the call, so the
    events bracket device work, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 1: paged_attention against its plain version
# ---------------------------------------------------------------------------

def paged_case(torch, gen, *, qdt, kvdt, dk, dv, dr=0, window=0, shape=None,
               shared=False):
    """Main-path-shaped inputs: ragged lens in 1..576 (or the shape's
    range), each row's live pages scattered over the pool, sentinel (>=
    n_pages) entries past them; shared: the value pages are the key
    pages (absorbed MLA's latent plane)."""
    m = shape or MAIN
    B, H, Hkv, page = m["rows"], m["H"], m["Hkv"], m["page"]
    P = -(-m["max_len"] // page)
    dev = "cuda"
    lens = torch.randint(m.get("min_len", 1), m["max_len"] + 1, (B,),
                         generator=gen, device=dev)
    if shape is None:
        lens[0], lens[1] = 1, m["max_len"]
    live = (lens + page - 1) // page
    n_pages = int(live.sum()) + 8
    perm = torch.randperm(n_pages, generator=gen, device=dev).int()
    table = torch.full((B, P), n_pages, dtype=torch.int32, device=dev)
    table[:, -1] = n_pages + 7          # any id >= n_pages is unallocated
    at = 0
    for b, n in enumerate(live.tolist()):
        table[b, :n] = perm[at:at + n]
        at += n

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    case = dict(q=rnd(B, H, dk + dr, dtype=qdt), table=table,
                lens=lens.int(), window=window)
    if kvdt in (torch.int8, torch.float8_e4m3fn):
        # quantized as the served path writes them (attention.kv_quantize
        # of O(1) keys and values): the values span +-127 / +-448, the
        # dequantized ones are O(1)
        from repro_torch.models.attention import kv_quantize
        for name, d in (("k", dk), ("v", dv)):
            case[f"{name}_pages"], case[f"{name}_scale"] = kv_quantize(
                rnd(n_pages, page, Hkv, d, dtype=torch.float32), kvdt)
    else:
        case["k_pages"] = rnd(n_pages, page, Hkv, dk, dtype=kvdt)
        case["v_pages"] = rnd(n_pages, page, Hkv, dv, dtype=kvdt)
    if dr:
        case["k_extra"] = rnd(n_pages, page, Hkv, dr, dtype=qdt)
    if shared:
        case["v_pages"] = case["k_pages"]
        if "k_scale" in case:        # one latent, one scale plane
            case["v_scale"] = case["k_scale"]
    if "scale" in m:
        case["scale"] = m["scale"]
    return case


def paged_bound(case, torch):
    """(bound_ms, bound_by): bytes of q, out, table, lens and the LIVE
    pages (what this run's lens need) over the memory rate, against the
    score and value flops over the peak rate of q's type."""
    q, kp, vp = case["q"], case["k_pages"], case["v_pages"]
    page = kp.shape[1]
    Hkv, dk, dv = kp.shape[2], kp.shape[3], vp.shape[3]
    lens = case["lens"].long()
    live_tok = int(((lens + page - 1) // page).sum()) * page
    # a plane passed as both keys and values is read once
    per_tok = Hkv * (dk + (0 if vp is kp else dv)) * kp.element_size()
    for name in ("k_scale", "v_scale"):
        if case.get(name) is not None and not (
                name == "v_scale" and case["v_scale"] is case["k_scale"]):
            per_tok += Hkv * 4
    if case.get("k_extra") is not None:
        ke = case["k_extra"]
        per_tok += Hkv * ke.shape[-1] * ke.element_size()
    nbytes = (live_tok * per_tok + 2 * q.numel() * q.element_size()
              + case["table"].numel() * 4 + lens.numel() * 4)
    ops = 2 * q.shape[1] * int(lens.sum()) * (q.shape[2] + dv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(q.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_call(case, torch):
    """One PyTorch call computing the same attention over K/V gathered
    into contiguous per-row tensors beforehand (the yardstick).  With
    k_extra (absorbed MLA) the keys are the gathered latent and rope
    keys, one kv head that the call shares over the query heads
    (enable_gqa).  Quantized pages are gathered and dequantized into q's
    dtype beforehand too: no single PyTorch call reads scaled int8 or
    fp8 pages."""
    import torch.nn.functional as F
    q, kp, vp, table = (case["q"], case["k_pages"], case["v_pages"],
                        case["table"])
    n_pages, page, Hkv, dk = kp.shape
    B, H, _ = q.shape
    g = H // Hkv
    t = table.long().clamp(0, n_pages - 1)
    S = t.shape[1] * page

    def gather(pages, scale):
        x = pages[t].reshape(B, S, Hkv, -1)
        if scale is not None:
            x = x.float() * scale[t].reshape(B, S, Hkv)[..., None]
        return x.to(q.dtype)

    k = gather(kp, case.get("k_scale"))
    v = gather(vp, case.get("v_scale")).transpose(1, 2)
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] < case["lens"].long()[:, None])[:, None, None]
    qq = q[:, :, None]
    if case.get("k_extra") is not None:
        ke = case["k_extra"][t].reshape(B, S, Hkv, -1)
        k = torch.cat([k, ke], -1).transpose(1, 2).contiguous()
        v = v.contiguous()
        return lambda: F.scaled_dot_product_attention(
            qq, k, v, attn_mask=mask, scale=case.get("scale"),
            enable_gqa=True)
    k = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    v = v.repeat_interleave(g, dim=1).contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def phase1(torch, flush, card):
    """-> {case: row}; "bf16" is the main path's (gemma3-1b's decode)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    d = MAIN["d"]
    n_sm = pa.sm_count(torch.device("cuda"))
    cases = [  # name, case kwargs, tolerance (atol = rtol)
        ("bf16", dict(qdt=bf16, kvdt=bf16, dk=d, dv=d), 2e-2),
        ("bf16_deepseek_7b", dict(qdt=bf16, kvdt=bf16, dk=128, dv=128,
                                  shape=DEEPSEEK), 2e-2),
        ("bf16_jamba", dict(qdt=bf16, kvdt=bf16, dk=128, dv=128,
                            shape=JAMBA), 2e-2),
        ("f32", dict(qdt=f32, kvdt=f32, dk=d, dv=d), 2e-5),
        ("f32_window512", dict(qdt=f32, kvdt=f32, dk=d, dv=d, window=512),
         2e-5),
        ("f32_dk192_dv128", dict(qdt=f32, kvdt=f32, dk=192, dv=128), 2e-5),
        ("int8_scaled", dict(qdt=f32, kvdt=torch.int8, dk=d, dv=d), 2e-5),
        ("fp8_scaled", dict(qdt=f32, kvdt=torch.float8_e4m3fn, dk=d, dv=d),
         2e-5),
        ("f32_k_extra", dict(qdt=f32, kvdt=f32, dk=d, dv=d, dr=64), 2e-5),
        # 40-byte rows: the kernel's element-wise staging path
        ("int8_dk40_rows_unvectorized",
         dict(qdt=f32, kvdt=torch.int8, dk=40, dv=40), 2e-5),
        # deepseek-v2's absorbed decode: several head groups a kv head,
        # the latent staged once; f32 stages one page a step
        ("bf16_deepseek_v2_mla", dict(qdt=bf16, kvdt=bf16, dk=512, dv=512,
                                      dr=64, shape=DEEPSEEK_V2,
                                      shared=True), 2e-2),
        ("f32_mla", dict(qdt=f32, kvdt=f32, dk=512, dv=512, dr=64,
                         shape=DEEPSEEK_V2, shared=True), 2e-5),
        # qwen2-vl-2b's decode: one head group of six a kv head
        ("bf16_qwen2_vl", dict(qdt=bf16, kvdt=bf16, dk=128, dv=128,
                               shape=QWEN2_VL), 2e-2),
        # the served quantized decode (phase 19): bf16 queries over int8
        # and fp8 pages with their scales, gemma3-1b's and deepseek-7b's
        # shapes, and the absorbed MLA decode over an int8 latent (one
        # scale plane as keys' and values') with bf16 rope keys
        ("bf16_int8", dict(qdt=bf16, kvdt=torch.int8, dk=d, dv=d), 2e-2),
        ("bf16_fp8", dict(qdt=bf16, kvdt=torch.float8_e4m3fn, dk=d, dv=d),
         2e-2),
        ("bf16_int8_deepseek_7b", dict(qdt=bf16, kvdt=torch.int8, dk=128,
                                       dv=128, shape=DEEPSEEK), 2e-2),
        ("bf16_fp8_deepseek_7b", dict(qdt=bf16, kvdt=torch.float8_e4m3fn,
                                      dk=128, dv=128, shape=DEEPSEEK), 2e-2),
        ("bf16_int8_deepseek_v2_mla", dict(qdt=bf16, kvdt=torch.int8,
                                           dk=512, dv=512, dr=64,
                                           shape=DEEPSEEK_V2, shared=True),
         2e-2),
    ]
    # tolerances are those of the JAX package's kernel tests: the kernel
    # sums an online softmax page by page, the plain version all at once
    rows = {}
    for name, kw, tol in cases:
        case = paged_case(torch, gen, **kw)
        args = {k: v for k, v in case.items()}
        B, P = case["table"].shape
        n_pages, page, Hkv, dk = case["k_pages"].shape
        H, dkq = case["q"].shape[1:]
        dims = (dk, case["v_pages"].shape[-1], dkq - dk, page, P)
        sizes = (case["k_pages"].element_size(), case["q"].element_size(),
                 case["v_pages"] is case["k_pages"])
        gh, ppt, splits = pa.launch_plan(B, H, Hkv, *dims, *sizes, n_sm)
        groups = H // Hkv // gh
        per_sm = pa.blocks_per_sm(pa.smem_bytes(gh, *dims, ppt, *sizes))
        got = pa.paged_attention(**args)
        want = ref.paged_attention(**args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")
        quant = "k_scale" in case
        wrong_fails = None
        if quant:
            # the row's power: a kernel that returned zeros, or dropped
            # either scale plane, must fail its tolerance
            ones = torch.ones_like(case["k_scale"])
            wrong = {"zeros": torch.zeros_like(want),
                     "no_k_scale": ref.paged_attention(**dict(args,
                                                              k_scale=ones)),
                     "no_v_scale": ref.paged_attention(**dict(args,
                                                              v_scale=ones))}
            wrong_fails = {k: not torch.allclose(w.float(), want.float(),
                                                 atol=tol, rtol=tol)
                           for k, w in wrong.items()}
            if not all(wrong_fails.values()):
                raise AssertionError(f"{name}: outputs that are wrong pass "
                                     f"its tolerance {tol}: {wrong_fails}")
        ms = time_ms(lambda: pa.paged_attention(**args), torch, flush)
        plain_ms = time_ms(lambda: ref.paged_attention(**args), torch, flush,
                           iters=10)
        lib_ms, lib_call = None, None
        mla = "scale" in case     # the absorbed MLA shape: k_extra too
        if mla or (quant and case["q"].dtype == torch.bfloat16) or (
                not quant and "k_extra" not in case
                and dk == case["v_pages"].shape[-1]
                and not case["window"]):
            lib_ms = time_ms(sdpa_call(case, torch), torch, flush)
            lib_call = ("scaled_dot_product_attention over pre-gathered"
                        + (", pre-dequantized" if quant else "") + " K/V")
        bound_ms, bound_by = paged_bound(case, torch)
        row = {"phase": 1, "card": card, "kernel": "paged_attention",
               "case": name, "rows": B, "H": case["q"].shape[1],
               "Hkv": Hkv, "P": P, "head_group": gh, "groups": groups,
               "pages_a_stage": ppt, "blocks_per_sm": per_sm,
               "splits": splits,
               "lens_sum": int(case["lens"].sum()),
               "max_abs_err": err, "tol": tol,
               "max_abs_out": want.float().abs().max().item(),
               "wrong_outputs_fail": wrong_fails, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_call": lib_call,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        rows[name] = row
    emit({"phase": 1, "paged_attention_splits": {
        name: row["splits"] for name, row in rows.items()},
        "head_groups": {name: row["groups"] for name, row in rows.items()},
        "sms": n_sm})
    return rows


# ---------------------------------------------------------------------------
# phase 7: flash_attention against its plain version
# ---------------------------------------------------------------------------

FAR = -(10 ** 9)    # the models' empty-slot position


def flash_positions(torch, N, S, C, idx, n_tok, ring_window):
    """Positions of one prefill chunk at idx with n_tok valid tokens over
    S cache entries, as models/attention.py builds them: a ring of S
    slots (ring_window > 0) or S gathered positions, then the chunk."""
    from repro_torch.models import attention as attn
    idx_t = torch.full((N,), idx, device="cuda")
    q_pos, c_pos = attn._chunk_pos(idx_t, torch.full((N,), n_tok,
                                                     device="cuda"), C)
    if ring_window:
        cache_pos = attn._cache_entry_pos(S, idx_t, ring_window)
    else:
        slot = torch.arange(S, device="cuda")
        cache_pos = torch.where(slot < idx, slot, FAR).expand(N, S)
    return q_pos.int().contiguous(), \
        torch.cat([cache_pos, c_pos], 1).int().contiguous()


# name: (N, T, cache S (0: top-left T = S), H, Hkv, dh, window, idx, n_tok
# [, causal: False is no mask at all, top-left, over S keys (0: S = T)])
# gemma3-1b: ring of 512 (local layers, window 512) and 576 gathered
# positions (global layer) plus a 128 chunk; deepseek-7b: 576 gathered
# plus the chunk; apply at T = S = 2048, top-left causal; phase 14's
# relabel and eval: one member's chunk of 16 sequences at T = S = 64;
# phase 24's relabel score: one sequence of 4096 (global and window 512);
# whisper-tiny's encoder stub (K 4 x 4 slots over 1500 frames), a
# 128-token prefill chunk's cross-attention over the frames and its
# self-attention over the slot's 192 positions (one chunk a prompt);
# qwen2-vl-2b's chunk over 576 gathered positions (g = 6); phase 23's
# examples at their reduced configs (head_dim 32): train_ec_dnn's relabel
# and eval (gemma3-1b, K 4 x 64 sequences of 64, window 16 or none) and
# serve_ensemble's first paged prefill chunk (deepseek-7b, 16 tokens over
# 3 pages of 8)
FLASH_CASES = {
    "gemma3_ring_mid": (4, 128, 512, 4, 1, 256, 512, 256, 128),
    "gemma3_ring_tail": (4, 128, 512, 4, 1, 256, 512, 256, 44),
    "gemma3_paged_mid": (4, 128, 576, 4, 1, 256, 0, 256, 128),
    "gemma3_paged_tail": (4, 128, 576, 4, 1, 256, 0, 256, 44),
    "deepseek_paged_mid": (4, 128, 576, 32, 32, 128, 0, 256, 128),
    "deepseek_paged_tail": (4, 128, 576, 32, 32, 128, 0, 256, 44),
    "gemma3_apply_2048": (4, 2048, 0, 4, 1, 256, 0, 0, 0),
    "gemma3_apply_2048_w512": (4, 2048, 0, 4, 1, 256, 512, 0, 0),
    "deepseek_apply_2048": (4, 2048, 0, 32, 32, 128, 0, 0, 0),
    "gemma3_relabel_64": (16, 64, 0, 4, 1, 256, 0, 0, 0),
    "gemma3_relabel_64_w512": (16, 64, 0, 4, 1, 256, 512, 0, 0),
    "gemma3_relabel_4096": (1, 4096, 0, 4, 1, 256, 0, 0, 0),
    "gemma3_relabel_4096_w512": (1, 4096, 0, 4, 1, 256, 512, 0, 0),
    "whisper_encoder": (16, 1500, 0, 6, 6, 64, 0, 0, 0, False),
    "whisper_cross_chunk": (4, 128, 1500, 6, 6, 64, 0, 0, 0, False),
    "whisper_self_chunk": (4, 128, 192, 6, 6, 64, 0, 0, 96),
    "qwen2_vl_chunk": (4, 128, 576, 12, 2, 128, 0, 256, 128),
    "gemma3_reduced_relabel_64": (256, 64, 0, 4, 1, 32, 0, 0, 0),
    "gemma3_reduced_relabel_64_w16": (256, 64, 0, 4, 1, 32, 16, 0, 0),
    "deepseek_reduced_prefill": (4, 16, 24, 4, 4, 32, 0, 0, 16),
}
# speculative verify (phase 20's pass): K 4 x 4 slots of gamma+1 = 5
# queries at per-row positions 300-512 over S = 576 gathered keys at
# positions 0..575 (the chunk already scattered into the pages)
VERIFY_CASES = {"gemma3_verify": (16, 5, 576, 4, 1, 256)}


def verify_positions(torch, gen, N, T, S):
    pos = torch.randint(300, 513, (N,), generator=gen, device="cuda")
    q_pos = (pos[:, None] + torch.arange(T, device="cuda")).int()
    k_pos = torch.arange(S, device="cuda").expand(N, S).int().contiguous()
    return q_pos.contiguous(), k_pos


def flash_valid(torch, q_pos, k_pos, T, S, window, dev="cuda",
                causal=True):
    """(N or 1, T, S) mask of the (query, key) pairs that count."""
    if q_pos is None:
        q_pos = torch.arange(T, device=dev)[None]
        k_pos = torch.arange(S, device=dev)[None]
    qp, kp = q_pos.long()[:, :, None], k_pos.long()[:, None, :]
    ok = (kp >= 0).expand(max(qp.shape[0], kp.shape[0]), T, S)
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok &= kp > qp - window
    return ok


def flash_bound(q, k, v, q_pos, k_pos, ok):
    """(bound_ms, bound_by): q, k, v and the positions read once and the
    output written once, over the memory rate, against 4 * dh flops (the
    score and the value products) for every (query head, key) pair the
    mask keeps, over the peak rate of the inputs' type."""
    N, T, H, dh = q.shape
    nbytes = 2 * q.numel() * q.element_size() + \
        (k.numel() + v.numel()) * k.element_size()
    if q_pos is not None:
        nbytes += (q_pos.numel() + k_pos.numel()) * 4
    pairs = int(ok.sum()) * (N // ok.shape[0]) * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * dh * pairs / PEAK_OPS[str(q.dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase7(torch, flush, card):
    """-> {(case, dtype): row}; deepseek_paged_mid at bf16 is the main
    path's row."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    n_sm = pa.sm_count(torch.device("cuda"))
    out = {}
    cases = dict(FLASH_CASES)
    cases.update({name: (N, T, S, H, Hkv, dh, 0, None, None)
                  for name, (N, T, S, H, Hkv, dh) in VERIFY_CASES.items()})
    for name, (N, T, S0, H, Hkv, dh, window, idx, n_tok, *rest) in \
            cases.items():
        causal = rest[0] if rest else True
        verify = name in VERIFY_CASES
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            S = S0 if verify else (S0 + T if causal else S0) if S0 else T
            q, k, v = (torch.randn(N, n, h, dh, generator=gen,
                                   device="cuda").to(dt)
                       for n, h in ((T, H), (S, Hkv), (S, Hkv)))
            kw = dict(causal=causal, window=window)
            if verify:
                kw["q_pos"], kw["k_pos"] = verify_positions(torch, gen, N,
                                                            T, S)
            elif S0 and causal:
                kw["q_pos"], kw["k_pos"] = flash_positions(
                    torch, N, S0, T, idx, n_tok, window)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ok = flash_valid(torch, kw.get("q_pos"), kw.get("k_pos"), T, S,
                             window, causal=causal)
            rows = ok.any(-1).expand(N, T)      # rows with a valid key
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"flash {name}: non-finite output")
            err = (got.float() - want.float())[rows].abs().max().item()
            torch.testing.assert_close(
                got.float()[rows], want.float()[rows], atol=tol, rtol=tol,
                msg=lambda m: f"flash {name} {dt}: {m}")
            ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), torch,
                         flush)
            plain_ms = time_ms(lambda: ref.attention(q, k, v, **kw), torch,
                               flush, iters=10)
            # the yardstick: SDPA on (N, H, T, dh) views made beforehand,
            # with the same mask as a boolean (N, 1, T, S) tensor
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            mask = ok[:, None].expand(N, 1, T, S).contiguous()
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=dh ** -0.5,
                enable_gqa=H != Hkv), torch, flush, iters=10)
            bound_ms, bound_by = flash_bound(q, k, v, kw.get("q_pos"),
                                             kw.get("k_pos"), ok)
            # the key tiles the kernel reads, by its predicate's twin
            bq, bk = fa.tiles(dh, dt)
            live = ref.flash_tile_live(N, T, S, H // Hkv, bq, bk, causal,
                                       window, kw.get("q_pos"),
                                       kw.get("k_pos"))
            row = {"phase": 7, "card": card, "kernel": "flash_attention",
                   "case": name, "dtype": str(dt).split(".")[-1],
                   "N": N, "T": T, "S": S, "H": H, "Hkv": Hkv, "dh": dh,
                   "causal": causal, "window": window, "idx": idx,
                   "n_tok": n_tok,
                   "splits": fa.n_splits(N, T, H, Hkv, S, bk, n_sm),
                   "key_tiles": [int(live.sum()), live.numel()],
                   "tiles_skipped_share": 1.0 - live.float().mean().item(),
                   "max_abs_err": err, "tol": tol, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   # the rate over every (query head, key) pair, masked
                   # and skipped ones included
                   "full_tflop_per_s": 4 * N * H * T * S * dh / ms / 1e9}
            emit(row)
            out[name, row["dtype"]] = row
            del q, k, v, got, want, qt, kt, vt, mask
        torch.cuda.empty_cache()
    emit({"phase": 7, "key_tiles_skipped_share": {
        f"{name} {dt}": round(row["tiles_skipped_share"], 4)
        for (name, dt), row in out.items()}})
    return out


# ---------------------------------------------------------------------------
# phase 10: wkv6 against its plain version
# ---------------------------------------------------------------------------

# name: (members K, rows per member B, tokens T, valid tokens (the rest
# masked as rwkv_prefill masks them), nonzero s0, decays down to the
# models' clamp); H = 64, dh = 64
WKV_CASES = {
    "decode": (4, 4, 1, 1, True, False),           # a decode step, N = 16
    "prefill_tail": (4, 1, 128, 44, True, False),  # last chunk of a 300 prompt
    "apply_2048": (4, 1, 2048, 2048, False, False),
    # log_w = -exp(clip(x, -20, 4)) as the models clamp it, some tokens
    # at -e^4: a separable factorisation of the decays would overflow
    "prefill_strong_decay": (4, 1, 128, 128, True, True),
    # phase 15's relabel: one member scores a chunk of 64 of the 88
    # relabelled sequences (4 members' 22) of 64 tokens in a call
    "relabel_64x64": (1, 64, 64, 64, False, False),
}
WKV_TOL = dict(atol=5e-4, rtol=1e-3)   # tests/test_kernels.py's
WKV_HEADS = dict(H=64, dh=64)          # rwkv6-7b


def wkv_inputs(torch, gen, K, B, T, n_tok, warm, strong, H=64, dh=64,
               count=2):
    """Phase 10's inputs for one case: r, k, v, log_w (K*B, T, H, dh), u
    (K, H, dh), the pool (K, count, max(B, 4), H, dh, dh) and the state,
    one layer's view of it, (K, count, ...)[:, 1], narrowed to the B
    slots of the rows."""
    N = K * B
    f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                               device="cuda")
    r, k, v = f(N, T, H, dh), f(N, T, H, dh), f(N, T, H, dh)
    if strong:
        log_w = -torch.exp((3 * f(N, T, H, dh)).clamp(-20, 4))
    else:
        log_w = -torch.exp(f(N, T, H, dh).clamp(-3, 2))  # strong + weak
    valid = (torch.arange(T, device="cuda") < n_tok)[None, :, None, None]
    k = torch.where(valid, k, 0.0)
    log_w = torch.where(valid, log_w, 0.0)
    u = f(K, H, dh) * 0.3                     # a u per member
    pool = f(K, count, max(B, 4), H, dh, dh) * (0.1 if warm else 0.0)
    return r, k, v, log_w, u, pool, pool[:, 1].narrow(1, 0, B)


def wkv_bound(N, T, H, dh, K):
    """(bound_ms, bound_by): r, k, v, log_w, u and s0 read once, y and
    s_T written once, over the memory rate, against 4 f32 operations per
    state entry per token (r.S, the decay, k v and the add) over the f32
    rate outside the tensor cores."""
    nbytes = 4 * (5 * N * T * H * dh + K * H * dh + 2 * N * H * dh * dh)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * N * T * H * dh * dh / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase10(torch, flush, card):
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    H, dh = WKV_HEADS["H"], WKV_HEADS["dh"]
    rows = {}
    for name, (K, B, T, n_tok, warm, strong) in WKV_CASES.items():
        N = K * B
        r, k, v, log_w, u, pool, state = wkv_inputs(
            torch, gen, K, B, T, n_tok, warm, strong, H, dh)
        s0 = state.reshape(N, H, dh, dh).clone()
        want_y, want_s = ref.wkv6(r, k, v, log_w, u, s0)
        n0 = wk.wkv6.launches
        y = wk.wkv6(r, k, v, log_w, u, state)
        torch.cuda.synchronize()
        per_call, plan = wk.wkv6.launches - n0, wk.plan()
        got_s = state.reshape(N, H, dh, dh)
        for a, b in ((y, want_y), (got_s, want_s)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"wkv6 {name}: non-finite output")
            torch.testing.assert_close(a, b, **WKV_TOL,
                                       msg=lambda m: f"wkv6 {name}: {m}")
        err = max((y - want_y).abs().max().item(),
                  (got_s - want_s).abs().max().item())
        ms = time_ms(lambda: wk.wkv6(r, k, v, log_w, u, state), torch,
                     flush)
        plain_ms = time_ms(lambda: ref.wkv6(r, k, v, log_w, u, s0), torch,
                           flush, iters=5 if T > 128 else 10, warmup=1)
        bound_ms, bound_by = wkv_bound(N, T, H, dh, K)
        row = {"phase": 10, "card": card, "kernel": "wkv6", "case": name,
               "N": N, "K": K, "T": T, "n_tok": n_tok, "H": H, "dh": dh,
               "nonzero_s0": warm, "min_log_w": log_w.min().item(),
               "max_abs_err": err, "tol": WKV_TOL,
               "ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "path": plan["path"], "blocks": plan["blocks"],
               "threads": plan["threads"], "chunk": plan["chunk"],
               "col_tile": plan["col_tile"], "launches_per_call": per_call}
        emit(row)
        rows[name] = row
        del r, k, v, log_w, u, pool, state, s0, y, want_y, want_s
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 11: ssm_scan against its plain version
# ---------------------------------------------------------------------------

# name: (members K, rows per member B, tokens T, nonzero h0); jamba's
# d_inner 8192 and d_state 16
SCAN_CASES = {
    "decode": (2, 4, 1, True),           # a decode step, N = 8
    "prefill_chunk": (2, 1, 128, True),  # a mid-prompt chunk, one slot
    "apply_2048": (2, 1, 2048, False),
    # phase 15's relabel: one member scores both members' batches of 22
    # sequences of 64 tokens (two MoE pools) in a call
    "relabel_44x64": (1, 44, 64, False),
}
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_kernels.py's
SCAN_DIMS = dict(D=8192, Ns=16)         # jamba


def scan_inputs(torch, gen, K, B, T, warm, D=8192, Ns=16, count=2):
    """Phase 11's inputs for one case: a = exp(-|x|), small b (K*B, T, D,
    Ns), the pool (K, count, max(B, 4), D, Ns) and the state, one Mamba
    layer's view of it, (K, count, ...)[:, 1], narrowed to the B slots
    of the rows."""
    N = K * B
    f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                               device="cuda")
    a = torch.exp(-f(N, T, D, Ns).abs())
    b = f(N, T, D, Ns) * 0.2
    pool = f(K, count, max(B, 4), D, Ns) * (0.1 if warm else 0.0)
    return a, b, pool, pool[:, 1].narrow(1, 0, B)


def scan_bound(N, T, D, Ns):
    """(bound_ms, bound_by): a and b read once, hs written once, h0 read
    and h_T written once, over the memory rate, against one FMA (2
    operations) per state element per step at the f32 rate outside the
    tensor cores."""
    nbytes = 4 * (3 * N * T * D * Ns + 2 * N * D * Ns)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * N * T * D * Ns / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase11(torch, flush, card):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    D, Ns = SCAN_DIMS["D"], SCAN_DIMS["Ns"]
    rows = {}
    for name, (K, B, T, warm) in SCAN_CASES.items():
        N = K * B
        a, b, pool, state = scan_inputs(torch, gen, K, B, T, warm, D, Ns)
        h0 = state.reshape(N, D, Ns).clone()
        want_hs, want_h = ref.ssm_scan(a, b, h0)
        n0 = ssk.ssm_scan.launches
        hs = ssk.ssm_scan(a, b, state)
        torch.cuda.synchronize()
        per_call, plan = ssk.ssm_scan.launches - n0, ssk.plan()
        got_h = state.reshape(N, D, Ns)
        for x, y in ((hs, want_hs), (got_h, want_h)):
            if not torch.isfinite(x).all():
                raise AssertionError(f"ssm_scan {name}: non-finite output")
            torch.testing.assert_close(x, y, **SCAN_TOL,
                                       msg=lambda m: f"ssm_scan {name}: {m}")
        err = max((hs - want_hs).abs().max().item(),
                  (got_h - want_h).abs().max().item())
        del want_hs, hs
        ms = time_ms(lambda: ssk.ssm_scan(a, b, state), torch, flush)
        plain_ms = time_ms(lambda: ref.ssm_scan(a, b, h0), torch, flush,
                           iters=5 if T > 128 else 10, warmup=1)
        bound_ms, bound_by = scan_bound(N, T, D, Ns)
        row = {"phase": 11, "card": card, "kernel": "ssm_scan", "case": name,
               "N": N, "K": K, "T": T, "D": D, "Ns": Ns, "nonzero_h0": warm,
               "max_abs_err": err, "tol": SCAN_TOL, "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gb_per_s": 4 * (3 * N * T + 2 * N) * D * Ns / ms / 1e6,
               "small_t_path": plan["small_t"], "blocks": plan["blocks"],
               "threads": plan["threads"], "ahead": plan["ahead"],
               "launches_per_call": per_call}
        emit(row)
        rows[name] = row
        del a, b, pool, state, h0, want_h
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 2, 8, 9 and 12: the serving path at full width
# ---------------------------------------------------------------------------

def n_paged_layers(cfg, max_seq, tf) -> int:
    return sum(count for count, specs in cfg.segments() for s in specs
               if tf.layer_pages(cfg, s, max_seq))


def profile_steps(torch, run, n: int, names=()) -> dict:
    """Device time per step by kernel, from torch.profiler around run(),
    which takes n steps; `name_ms` sums, for each of `names`, the kernels
    whose name holds it, `wall_ms` is the host clock of the profiled
    window per step.
    The profiler slows the host, so for a host-bound step the idle share
    is taken against the unprofiled step time instead.  It records the
    card's activity only: nothing here reads the host's op events, and
    recording them made each profiled window cost the host several times
    its own length (the busy ms are the same either way)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    ms = lambda e: e.self_device_time_total / n / 1e3  # noqa: E731
    top = sorted(kern, key=ms, reverse=True)[:6]
    return {"busy_ms": sum(ms(e) for e in kern), "wall_ms": wall_ms,
            "name_ms": {name: sum(ms(e) for e in kern if name in e.key)
                        for name in names},
            "top": [[e.key[:60], ms(e)] for e in top]}


SERVE = dict(slots=4, max_prompt=512, max_out=64, page=16,
             prompt_lens=[300, 377, 451, 512], new_tokens=32)
# whisper-tiny: contiguous (the JAX engine refuses enc-dec paged), prompts
# of one 128-token chunk each plus 64 new tokens, within the 448 tokens
# it was trained on
WHISPER_SERVE = dict(slots=4, max_prompt=128, max_out=64, page=0,
                     prompt_lens=[16, 48, 96, 128], new_tokens=64,
                     chunk=128)
# kernel wrapper -> the symbol of its kernel in a profile
SYMBOL = {"paged_attention": "paged_kernel",
          "flash_attention": "flash_kernel", "wkv6": "wkv6_",
          "ssm_scan": "ssm_scan_"}


def serve_phase(torch, np, card, arch: str, phase: int, members: int = 4,
                n_layers: int = None, init_limit: float = None,
                serve: dict = SERVE, kv_dtype: str = "f32", params=None,
                record: dict = None, profile_prefill: bool = True) -> dict:
    """`arch` at full width, bf16, `members` members, paged KV (page 16),
    its depth cut to `n_layers` where given: 4 requests of 300-512 prompt
    tokens through EnsembleEngine.generate for 32 new tokens, greedy
    (or `serve`'s; page 0 is the contiguous pool).
    Every kernel's launch count must equal its formula: paged_attention
    once per paged layer per decode step after the first token (which
    prefill emits); flash_attention once per attention layer per prefill
    call, and once more per cross-attention layer of an encoder-decoder;
    wkv6 once per rwkv layer, and ssm_scan once per Mamba layer
    and 128-token piece, per decode step and per prefill call.  An
    encoder-decoder's encoder stub (the engine's frames for every slot)
    is timed and counted on its own: flash_attention once per encoder
    layer.  kv_dtype stores the paged pool so (phase 19); `params` are
    the members' weights where the caller made them (no init then);
    `record` (a dict) receives the greedy outputs, the page stats and
    the decode timings; profile_prefill=False skips the prefill's
    profile (its kernels in situ).  -> the kernels' launch counts (and
    the stub's flash launches)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    cfg = full = registry.get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    K, n_new, plens = members, serve["new_tokens"], serve["prompt_lens"]
    paged = serve["page"] > 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    own = params is None
    if own:
        params = tf.init(cfg, seed=0, device="cuda", members=K)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    if init_limit is not None and init_peak >= init_limit:
        raise AssertionError(f"{arch} init peaked at {init_peak} B, limit "
                             f"{init_limit}")
    eng = EnsembleEngine(cfg, params, n_slots=serve["slots"],
                         max_prompt=serve["max_prompt"],
                         max_out=serve["max_out"], paged=paged,
                         page_size=serve["page"] or 16,
                         prefill_chunk=serve.get("chunk"),
                         kv_dtype=kv_dtype, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in plens]
    eng.generate(prompts, max_new=2)            # warm-up (cuBLAS, kernel load)
    n_paged = n_paged_layers(cfg, eng.max_seq, tf) if paged else 0
    n_layers = lambda mixers: sum(  # noqa: E731
        count for count, specs in cfg.segments() for sp in specs
        if sp.mixer in mixers)
    # MLA layers prefill through the plain attend, as the JAX package does;
    # an encoder-decoder's blocks cross-attend the frames, each a launch
    n_attn = n_layers(("attn_local",)) + (
        0 if cfg.attn.kind == "mla" else n_layers(("attn",))) + (
        cfg.n_layers if cfg.enc_dec else 0)
    n_rwkv, n_mamba = n_layers(("rwkv",)), n_layers(("mamba",))
    calls = sum(-(-n // eng.prefill_chunk) for n in plens)
    pieces = -(-eng.prefill_chunk // ssm.MAMBA_CHUNK)
    expected = {"paged_attention": n_paged * (n_new - 1),
                "flash_attention": n_attn * calls,
                "wkv6": n_rwkv * (n_new - 1 + calls),
                "ssm_scan": n_mamba * (n_new - 1 + pieces * calls)}
    formulas = {
        "paged_attention": f"{n_paged} paged layers x ({n_new} - 1) decode "
                           f"steps = {expected['paged_attention']}",
        "flash_attention": (f"{n_attn - cfg.n_layers} self- + "
                            f"{cfg.n_layers} cross-attention layers"
                            if cfg.enc_dec else
                            f"{n_attn} GQA attention layers")
                           + f" x {calls} prefill calls = "
                           f"{expected['flash_attention']}",
        "wkv6": f"{n_rwkv} rwkv layers x (({n_new} - 1) decode steps + "
                f"{calls} prefill calls) = {expected['wkv6']}",
        "ssm_scan": f"{n_mamba} mamba layers x (({n_new} - 1) decode steps "
                    f"+ {pieces} piece(s) x {calls} prefill calls) = "
                    f"{expected['ssm_scan']}"}
    kernels = {"paged_attention": pa.paged_attention,
               "flash_attention": fa.flash_attention, "wkv6": wk.wkv6,
               "ssm_scan": ssk.ssm_scan}
    torch.cuda.reset_peak_memory_stats()
    # any NaN among the fused log-probs of the measured run, kept on the
    # card (read once after the run)
    nan_seen = torch.zeros((), dtype=torch.bool, device="cuda")
    fuse = eng._fuse

    def fuse_watch(logits):
        lp = fuse(logits)
        nan_seen.logical_or_(torch.isnan(lp).any())
        return lp

    eng._fuse = fuse_watch
    for fn in kernels.values():
        fn.launches = 0
    prefills0 = eng.prefills_run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del eng._fuse        # back to the method (no engine <-> method cycle)
    if bool(nan_seen):
        raise AssertionError(f"{arch} ({kv_dtype} pages): NaN in a fused "
                             f"log-prob")
    launches = {name: fn.launches for name, fn in kernels.items()}
    prefill_calls = eng.prefills_run - prefills0
    serve_peak = torch.cuda.max_memory_allocated()
    if prefill_calls != calls:
        raise AssertionError(f"the engine ran {prefill_calls} prefill calls,"
                             f" expected {calls}")
    for name, n in launches.items():
        if n != expected[name]:
            raise AssertionError(f"{arch}: {name} launched {n} times, "
                                 f"expected {formulas[name]}")
    for o in outs:
        if len(o) != n_new or o.min() < 0 or o.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output {o}")
    stub = {}
    if cfg.enc_dec:
        # the encoder over every slot's stub frames, as the engine runs
        # it at construction and on every swap_params
        fa.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = eng._encode_stub(eng.n_slots)
        torch.cuda.synchronize()
        stub_s = time.perf_counter() - t0
        stub_launches = fa.flash_attention.launches
        if stub_launches != cfg.n_enc_layers:
            raise AssertionError(f"{arch}: the encoder stub launched flash "
                                 f"{stub_launches} times, expected "
                                 f"{cfg.n_enc_layers} encoder layers x 1")
        want = (K, eng.n_slots, cfg.enc_max_frames, cfg.d_model)
        if tuple(enc.shape) != want or not torch.isfinite(enc).all():
            raise AssertionError(f"{arch}: bad encoder frames "
                                 f"{tuple(enc.shape)}, want {want}")
        del enc
        sp = profile_steps(torch, lambda: eng._encode_stub(eng.n_slots), 1,
                           ["flash_kernel"])
        stub = {"encoder_stub_s": stub_s,
                "encoder_stub_device_busy_ms": sp["busy_ms"],
                "encoder_stub_flash_ms": sp["name_ms"]["flash_kernel"],
                "encoder_stub_top_kernels_ms": sp["top"],
                "encoder_stub_launches": stub_launches}

    def admit():
        eng.update_slots(release=range(eng.n_slots),
                         admits=[(i, p, n_new) for i, p in enumerate(prompts)])

    def prefill_all():
        for i, n in enumerate(plens):
            for _ in range(-(-n // eng.prefill_chunk)):
                eng.prefill(i)

    # the same requests again through the engine's own calls, timed by part
    admit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_all()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_new - 1):
        eng.step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    # the path's kernels, read by name in the decode and prefill profiles
    used = [SYMBOL[k] for k, n in expected.items() if n]
    prof = profile_steps(torch, lambda: [eng.step() for _ in range(3)], 3,
                         used)
    pre = {"busy_ms": None, "name_ms": {}, "top": None}
    if profile_prefill:
        admit()
        pre = profile_steps(torch, prefill_all, 1, used)
    # each kernel's device time per launch in situ (inputs just written,
    # in L2): a decode step launches it once per layer that runs it, the
    # prefill once per layer and call (ssm_scan: and 128-token piece)
    per_step = {"paged_attention": n_paged, "flash_attention": 0,
                "wkv6": n_rwkv, "ssm_scan": n_mamba}
    per_prefill = {"paged_attention": 0, "flash_attention": n_attn * calls,
                   "wkv6": n_rwkv * calls,
                   "ssm_scan": n_mamba * pieces * calls}
    per_launch = {k: {"decode": prof["name_ms"][SYMBOL[k]] / per_step[k]
                      if per_step[k] else None,
                      "prefill": pre["name_ms"][SYMBOL[k]] / per_prefill[k]
                      if per_prefill[k] and profile_prefill else None}
                  for k, n in expected.items() if n}
    pstats = eng.page_stats()
    emit({"phase": phase, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
          "members": K, "n_layers": cfg.n_layers,
          "published_layers": full.n_layers, "slots": serve["slots"],
          "paged": paged, "kv_dtype": kv_dtype,
          "page_bytes": pstats.get("page_bytes"),
          "bytes_per_token": pstats.get("bytes_per_token"),
          "prompt_lens": plens,
          "new_tokens": n_new, "prefill_chunk": eng.prefill_chunk,
          "paged_layers": n_paged, "attention_layers": n_attn,
          "rwkv_layers": n_rwkv, "mamba_layers": n_mamba,
          "prefill_calls": prefill_calls, "launch_formula": formulas,
          "launches": launches, "generate_s": gen_s,
          "tok_per_s": sum(len(o) for o in outs) / gen_s,
          "prefill_s": prefill_s,
          "prefill_device_busy_ms": pre["busy_ms"],
          "kernel_ms_in_prefill": pre["name_ms"],
          "prefill_top_kernels_ms": pre["top"],
          "decode_ms_per_step": decode_s / (n_new - 1) * 1e3,
          "init_s": init_s, "init_peak_memory": init_peak,
          "max_memory_allocated": serve_peak,
          "device_busy_ms_per_step": prof["busy_ms"],
          "device_idle_share": 1.0 - prof["busy_ms"] * (n_new - 1)
                               / (decode_s * 1e3),
          "kernel_ms_per_step": prof["name_ms"],
          "kernel_ms_per_launch": per_launch,
          "top_kernels_ms_per_step": prof["top"],
          **stub, "sample": outs[0][:8].tolist()})
    if record is not None:
        record.update(outs=outs, page_stats=pstats,
                      decode_ms_per_step=decode_s / (n_new - 1) * 1e3,
                      busy_ms=prof["busy_ms"],
                      paged_ms_per_launch=per_launch.get(
                          "paged_attention", {}).get("decode"))
    del eng
    if own:
        del params
    torch.cuda.empty_cache()
    if stub:
        launches["flash_attention_encoder_stub"] = \
            stub["encoder_stub_launches"]
    return launches


# ---------------------------------------------------------------------------
# phase 13: continuous batching at full width (gemma3-1b, f32)
# ---------------------------------------------------------------------------

# 4 slots, prompts up to 448 + 64 new = 512 = gemma3's local window, so
# every layer pages and the prefix cache is allowed; the pool holds 3
# slots at full length, so decode runs dry and the scheduler preempts
CONT = dict(slots=4, max_prompt=448, max_out=64, page=16, chunk=128,
            n_pages=96, margin=2e-5)


def continuous_requests(np, vocab: int) -> list:
    """16 greedy requests, submitted at once, in four groups of four that
    share a system prompt: 256 tokens (page-aligned) in groups 0 and 2,
    200 (mid-page: a hit copies the page on write) in groups 1 and 3;
    then a distinct suffix of 32-192 tokens each, and max_new 16-64.
    Round robin over the groups, so a request's group has been served
    (and its prefix cached at release) by the time it is admitted."""
    rng = np.random.default_rng(13)
    sys_prompts = [rng.integers(0, vocab, n) for n in (256, 200, 256, 200)]
    reqs = []
    for _ in range(4):
        for sp in sys_prompts:
            suffix = rng.integers(0, vocab, int(rng.integers(32, 193)))
            reqs.append((np.concatenate([sp, suffix]),
                         int(rng.integers(16, 65))))
    return reqs


def fused_margins(torch, np, params, cfg, prompt, toks) -> "np.ndarray":
    """Top-2 margin of the fused log-probs at each generated step, by a
    full forward (transformer.apply) over prompt + tokens."""
    from repro_torch.core import ensemble as ens
    from repro_torch.models import transformer as tf
    seq = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                          device="cuda")[None]
    with torch.no_grad():
        logits, _ = tf.apply(params, cfg, seq)
        lp = ens.ensemble_log_probs(logits[:, 0, len(prompt) - 1:].float())
        top = lp.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def phase13(torch, np, card) -> dict:
    """Scheduler.run over a paged K = 4 EnsembleEngine of full-width
    gemma3-1b in f32 (greedy decisive), prefix cache off and then on,
    the same 16 requests each time.  Both runs complete every request,
    admit in submission order and preempt; the prefix-on run hits and
    copies on write; the pool is whole after each drain; the tokens are
    identical on and off on every step whose top-2 fused log-prob margin
    clears 2e-5 (the first fork, if any, must be below it); paged
    attention launches 26 times per decode step and flash attention 26
    times per prefill call.  -> the two kernels' launches over both
    runs."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as tf
    from repro_torch.serving import client
    from repro_torch.serving.engine import EnsembleEngine
    from repro_torch.serving.scheduler import Scheduler
    t_phase = time.perf_counter()
    cfg = registry.get_config("gemma3-1b").with_(dtype="float32")
    K = 4
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0, device="cuda", members=K)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = continuous_requests(np, cfg.vocab_size)
    kw = dict(n_slots=CONT["slots"], max_prompt=CONT["max_prompt"],
              max_out=CONT["max_out"], prefill_chunk=CONT["chunk"],
              paged=True, page_size=CONT["page"], n_pages=CONT["n_pages"],
              device="cuda")
    n_paged = n_paged_layers(cfg, kw["max_prompt"] + kw["max_out"], tf)
    n_attn = sum(count for count, specs in cfg.segments() for sp in specs
                 if sp.mixer in ("attn", "attn_local"))
    if n_paged != cfg.n_layers or n_attn != cfg.n_layers:
        raise AssertionError(f"{n_paged} paged / {n_attn} attention layers"
                             f" of {cfg.n_layers}")
    kernels = {"paged_attention": pa.paged_attention,
               "flash_attention": fa.flash_attention}
    runs, totals = {}, {k: 0 for k in kernels}
    for on in (False, True):
        eng = EnsembleEngine(cfg, params, prefix_cache=on, **kw)
        if not on:      # warm-up (cuBLAS, kernels); the trie stays empty
            eng.generate([reqs[0][0]], max_new=2)
            eng.update_slots(release=range(eng.n_slots))
        sched = Scheduler(eng)
        rids = [sched.submit(t, m) for t, m in reqs]
        steps0, prefills0 = eng.steps_run, eng.prefills_run
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = sched.run()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        steps = eng.steps_run - steps0
        prefills = eng.prefills_run - prefills0
        want = {"paged_attention": n_paged * steps,
                "flash_attention": n_attn * prefills}
        if launches != want:
            raise AssertionError(f"prefix_cache={on}: launches {launches}, "
                                 f"expected {n_paged} x {steps} decode steps"
                                 f" and {n_attn} x {prefills} prefill calls")
        for k in kernels:
            totals[k] += launches[k]
        if set(comps) != set(rids):
            raise AssertionError(f"prefix_cache={on}: {len(comps)} of "
                                 f"{len(rids)} requests completed")
        for r, (_, m) in zip(rids, reqs):
            t = comps[r].tokens
            if len(t) != m or t.min() < 0 or t.max() >= cfg.vocab_size:
                raise AssertionError(f"bad completion {r}: {t}")
        # admission is FIFO: first admissions in submission order
        first = [sched.obs.traces.get(r) for r in rids]
        first = [tr.t0 + tr.first_t("admitted") for tr in first]
        if first != sorted(first):
            raise AssertionError(f"prefix_cache={on}: admissions out of "
                                 f"submission order")
        eng.assert_pool_whole()
        report = client.build_report(comps, wall, eng, sched=sched)
        runs[on] = dict(eng=eng, sched=sched, rids=rids, comps=comps,
                        report=report, steps=steps, prefills=prefills,
                        launches=launches)
    off, on = runs[False], runs[True]
    ps = on["report"]["page_stats"]
    if off["sched"].preemptions == 0 or on["sched"].preemptions == 0:
        raise AssertionError(f"no preemption: off "
                             f"{off['sched'].preemptions}, on "
                             f"{on['sched'].preemptions}")
    if ps["prefix_hits"] == 0 or ps["cow_pages"] == 0:
        raise AssertionError(f"prefix cache unused: {ps}")
    # tokens on against off under the margin rule
    below, compared, forks = 0, 0, []
    for (prompt, _), a, b in zip(reqs, off["rids"], on["rids"]):
        t_off, t_on = off["comps"][a].tokens, on["comps"][b].tokens
        margins = fused_margins(torch, np, params, cfg, prompt, t_off)
        below += int((margins < CONT["margin"]).sum())
        diff = np.nonzero(t_off != t_on)[0]
        n = int(diff[0]) if diff.size else len(t_off)
        compared += n
        if diff.size:
            forks.append({"rid": int(a), "step": n,
                          "margin": float(margins[n])})
            if margins[n] >= CONT["margin"]:
                raise AssertionError(
                    f"request {a}: on/off tokens fork at step {n} where "
                    f"the fused margin is {margins[n]:.3g} >= "
                    f"{CONT['margin']}")
    # decode over shared pages and a mid-page prefill, timed and profiled:
    # group 1's system prompt (200 tokens) is cached; four requests of it
    eng = on["eng"]
    group1 = [reqs[i][0] for i in (1, 5, 9, 13)]
    hits = eng.update_slots(admits=[(i, p, 32) for i, p in enumerate(group1)])
    shared_pages = eng.allocator.shared_pages
    n_calls = sum(-(-(len(p) - hits[i]) // eng.prefill_chunk)
                  for i, p in enumerate(group1))

    def prefill_all():
        for i, p in enumerate(group1):
            for _ in range(-(-(len(p) - hits[i]) // eng.prefill_chunk)):
                eng.prefill(i)

    pre = profile_steps(torch, prefill_all, 1, ["flash_kernel"])
    n_dec = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_dec):
        eng.step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    # keys of the first profiled step: the prompt, its first token (from
    # prefill) and n_dec decoded
    lens0 = [len(p) + n_dec + 1 for p in group1]
    prof = profile_steps(torch, lambda: [eng.step() for _ in range(3)], 3,
                         ["paged_kernel"])
    eng.update_slots(release=range(eng.n_slots))
    eng.assert_pool_whole()
    bounds = situ_bounds(cfg, K, eng, group1, hits, lens0, 3)

    def summary(run):
        r, sc = run["report"], run["sched"]
        return {"tok_per_s": r["tok_s"], "wall_s": r["wall_s"],
                "gen_tokens": r["gen_tokens"],
                "ttft_p50_ms": r["ttft_p50_ms"],
                "ttft_p99_ms": r["ttft_p99_ms"],
                "latency_p50_ms": r["latency_p50_ms"],
                "latency_p99_ms": r["latency_p99_ms"],
                "preemptions": sc.preemptions,
                "peak_in_flight": sc.peak_in_flight,
                "low_water_pages": r["low_water_pages"],
                "decode_steps": run["steps"], "prefill_calls": run["prefills"],
                "launches": run["launches"],
                "tick_phase_s": {k: v["total_s"] for k, v in
                                 sc.obs.ticks.snapshot().items()},
                "ticks": sc.obs.ticks.ticks}

    emit({"phase": 13, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
          "members": K, "n_layers": cfg.n_layers, "slots": CONT["slots"],
          "n_pages": CONT["n_pages"], "page": CONT["page"],
          "prefill_chunk": eng.prefill_chunk, "requests": len(reqs),
          "prompt_lens": [len(p) for p, _ in reqs],
          "max_new": [m for _, m in reqs], "init_s": init_s,
          "launch_formula": f"paged_attention {n_paged} x decode steps, "
                            f"flash_attention {n_attn} x prefill calls",
          "prefix_off": summary(off), "prefix_on": summary(on),
          "prefill_tokens_skipped": on["eng"].prefix.hit_tokens,
          "prompt_tokens_looked_up": on["eng"].prefix.lookup_tokens,
          "prefix_hit_rate": ps["prefix_hit_rate"],
          "prefix_hits": ps["prefix_hits"], "cow_pages": ps["cow_pages"],
          "shared_attaches": ps["shared_attaches"],
          "evicted_pages": ps["evicted_pages"],
          "margin": CONT["margin"], "steps_compared": compared,
          "steps_below_margin": below, "forks": forks,
          "shared_pages_at_decode": shared_pages,
          "decode_ms_per_step": decode_s / n_dec * 1e3,
          "device_busy_ms_per_step": prof["busy_ms"],
          "device_idle_share": 1.0 - prof["busy_ms"] / (decode_s / n_dec
                                                        * 1e3),
          "kernel_ms_per_launch": {
              "paged_attention": prof["name_ms"]["paged_kernel"] / n_paged,
              "flash_attention": pre["name_ms"]["flash_kernel"]
              / (n_attn * n_calls)},
          "bound_ms_per_launch": bounds,
          "prefill_calls_profiled": n_calls,
          "prefill_device_busy_ms": pre["busy_ms"],
          "top_kernels_ms_per_step": prof["top"],
          "phase_s": time.perf_counter() - t_phase})
    del runs, off, on, eng, params
    torch.cuda.empty_cache()
    return totals


def bound_of(nbytes: float, ops: float, dtype: str) -> float:
    """The least time (ms) of a call moving nbytes and doing ops."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]) * 1e3


def situ_bounds(cfg, K, eng, prompts, hits, lens0, n_steps) -> dict:
    """Bounds of phase 13's in-situ launches (f32, one kv head): the paged
    kernel's over the decode steps profiled (K x B rows at lens0 + s,
    each row's live pages read once) and flash's over the prefill calls
    profiled (K rows of one slot: the chunk over the gathered P * page
    positions plus the chunk, the pairs the mask keeps), each a mean per
    launch."""
    a, f = cfg.attn, 4
    H, dh, page = a.n_heads, a.head_dim, eng.page_size
    P, C = eng.pages_per_slot, eng.prefill_chunk
    paged = []
    for step in range(n_steps):
        lens = [n + step for n in lens0]
        live = sum(-(-n // page) * page for n in lens) * K
        nbytes = (live * 2 * dh * f + 2 * K * len(lens) * H * dh * f
                  + K * len(lens) * (P + 1) * 4)
        paged.append(bound_of(nbytes, 2 * H * K * sum(lens) * 2 * dh,
                              "float32"))
    flash = []
    for i, p in enumerate(prompts):
        for idx in range(hits[i], len(p), C):
            n_tok = min(C, len(p) - idx)
            S = P * page + C
            nbytes = (2 * K * C * H * dh * f + 2 * K * S * dh * f
                      + K * (C + S) * 4)
            pairs = K * sum(idx + t + 1 for t in range(n_tok))
            flash.append(bound_of(nbytes, 4 * dh * H * pairs, "float32"))
    return {"paged_attention": sum(paged) / len(paged),
            "flash_attention": sum(flash) / len(flash)}


# ---------------------------------------------------------------------------
# phase 19: quantized KV pages at full width (gemma3-1b, bf16)
# ---------------------------------------------------------------------------

KV_SERVE = ("bf16", "int8", "fp8")


def phase19(torch, np, card, bf16_run: dict) -> dict:
    """gemma3-1b at full width and depth, bf16, K = 4, paged (page 16),
    phase 2's requests over int8 and fp8 pages, by serve_phase (each
    run's paged launches must be phase 2's formula, no fused log-prob
    NaN); the bf16-page run is phase 2's own (`bf16_run`, its record:
    the same weights from the same seed).  Then one line with each run's
    page bytes, decode ms a step, busy ms, idle share, the paged
    kernel's in-situ ms a launch, and the int8 / fp8 tokens' agreement
    with the bf16 pages' (printed only: random members at a 262k vocab
    sit near ties; the CPU tests hold the agreement bound).
    -> {kv_dtype: launches} of the quantized runs."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    cfg = registry.get_config("gemma3-1b")
    params = tf.init(cfg, seed=0, device="cuda", members=4)
    recs, launches = {"bf16": bf16_run}, {}
    for kv in KV_SERVE[1:]:
        recs[kv] = {}
        launches[kv] = serve_phase(torch, np, card, "gemma3-1b", 19,
                                   kv_dtype=kv, params=params,
                                   record=recs[kv], profile_prefill=False)
    ref = recs["bf16"]["outs"]
    runs = {}
    for kv, r in recs.items():
        ps = r["page_stats"]
        runs[kv] = {"page_bytes": ps["page_bytes"],
                    "bytes_per_token": ps["bytes_per_token"],
                    "decode_ms_per_step": r["decode_ms_per_step"],
                    "device_busy_ms_per_step": r["busy_ms"],
                    "device_idle_share": 1.0 - r["busy_ms"]
                    / r["decode_ms_per_step"],
                    "paged_ms_per_launch": r["paged_ms_per_launch"],
                    "agreement_with_bf16_pages": float(np.mean(
                        [np.mean(a == b) for a, b in zip(r["outs"], ref)]))}
    emit({"phase": 19, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
          "members": 4, "runs": runs})
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 20: speculative decoding at full width (gemma3-1b, f32)
# ---------------------------------------------------------------------------

# draft_noise: the disagreeing draft is member 0 plus seeded Gaussian
# noise of this many standard deviations of each leaf; draft_layers: the
# cheap draft is member 0's first 2 (ring) layers
SPEC = dict(gamma=4, margin=2e-5, draft_noise=1.0, draft_layers=2)


def attention_layers(cfg) -> int:
    return sum(count for count, specs in cfg.segments() for sp in specs
               if sp.mixer in ("attn", "attn_local"))


def timed_generate(torch, eng, prompts, n_new):
    """eng.generate with each prefill call synchronised and timed.
    -> (outputs, generate s, prefill s); the rest of generate (admission,
    the decode steps or speculative iterations, the final read) is the
    difference."""
    spent = [0.0]
    inner = eng.prefill

    def prefill(slot):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(slot)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        return out

    eng.prefill = prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=n_new)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    del eng.prefill          # back to the method (no engine <-> it cycle)
    return outs, total, spent[0]


def shallow_draft(params, cfg, n_layers):
    """Member 0's first n_layers layers, its embedding and final norm, as
    a K = 1 stack of the n_layers-deep config: the usual cheap draft.
    -> (draft params, draft config)."""
    from repro_torch.common.tree import tree_map
    dcfg = cfg.with_(n_layers=n_layers)
    src = params["segments"][0]
    segs, start = [], 0
    for count, specs in dcfg.segments():
        segs.append({f"slot_{i}": tree_map(
            lambda x: x[:1, start:start + count].contiguous(),
            src[f"slot_{i}"]) for i in range(len(specs))})
        start += count
    draft = {k: tree_map(lambda x: x[:1], params[k])
             for k in ("embed", "final_norm")}
    draft["segments"] = segs
    return draft, dcfg


def noisy(torch, params, sigma: float, seed: int = 1):
    """params plus N(0, (sigma * the leaf's std)^2) noise on every leaf,
    drawn from a seeded generator."""
    from repro_torch.common.tree import tree_map
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return tree_map(lambda x: x + sigma * x.float().std()
                    * torch.randn(x.shape, generator=gen, device="cuda"),
                    params)


def noisy_draft(torch, params, sigma: float, seed: int = 1):
    """Member 0 plus noisy()'s noise, as a K = 1 stack."""
    from repro_torch.common.tree import tree_map
    return noisy(torch, tree_map(lambda x: x[:1], params), sigma, seed)


def spec_run(torch, np, cfg, params, draft, prompts, ref, margins, kw,
             draft_cfg=None):
    """A SpeculativeEngine drafting with `draft` serves phase 20's
    requests after a warm-up.  Its tokens must equal the plain engine's
    (`ref`) on every step whose fused top-2 margin (`margins`) clears
    SPEC's, and the measured run's launches their formula.  -> (engine,
    row, launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.spec import SpeculativeEngine
    G, n_new = SPEC["gamma"], SERVE["new_tokens"]
    dcfg = cfg if draft_cfg is None else draft_cfg
    spec = SpeculativeEngine(cfg, params, draft, draft_cfg=draft_cfg,
                             gamma=G, **kw)
    spec.generate(prompts, max_new=2)                   # warm-up
    stats0 = spec.spec_stats()
    iters0 = spec.spec_steps_run
    pa.paged_attention.launches = fa.flash_attention.launches = 0
    outs, gen_s, prefill_s = timed_generate(torch, spec, prompts, n_new)
    iters = spec.spec_steps_run - iters0
    n_attn, d_attn = attention_layers(cfg), attention_layers(dcfg)
    calls = sum(-(-n // spec.prefill_chunk) for n in SERVE["prompt_lens"])
    # each prefill call runs the draft's prefill (K = 1) and the members'
    launches = {"paged_attention": pa.paged_attention.launches,
                "flash_attention": fa.flash_attention.launches}
    want = {"paged_attention": 0,
            "flash_attention": n_attn * (calls + iters) + d_attn * calls}
    formula = (f"flash_attention {n_attn} attention layers x ({calls} "
               f"prefill calls + {iters} speculative iterations) + the "
               f"draft's {d_attn} x {calls} prefill calls = "
               f"{want['flash_attention']}; paged_attention 0 (the verify "
               f"pass reads the pages through flash)")
    if launches != want:
        raise AssertionError(f"phase 20 launches {launches}, expected "
                             f"{formula}")
    stats1 = spec.spec_stats()
    proposed = stats1["proposed"] - stats0["proposed"]
    accepted = stats1["accepted"] - stats0["accepted"]
    hist = [b - a for a, b in zip(stats0["emitted_hist"],
                                  stats1["emitted_hist"])]
    emitted = sum(len(o) for o in outs)
    # tokens against the plain engine under the margin rule
    compared, forks = 0, []
    for a, b, m in zip(ref, outs, margins):
        if len(a) != n_new or len(b) != n_new:
            raise AssertionError(f"phase 20: {len(a)} / {len(b)} tokens")
        diff = np.nonzero(a != b)[0]
        n = int(diff[0]) if diff.size else len(a)
        compared += n
        if diff.size:
            forks.append({"step": n, "margin": float(m[n])})
            if m[n] >= SPEC["margin"]:
                raise AssertionError(
                    f"speculative tokens fork from the plain engine's at "
                    f"step {n}, fused margin {m[n]:.3g} >= {SPEC['margin']}")
    # prefill emits each row's first token; were every draft accepted, a
    # row's other n_new - 1 would take ceil((n_new - 1) / (G + 1))
    # iterations, so more iterations mean drafts were rejected and rolled
    # back
    row = {"iterations": iters,
           "iterations_if_all_accepted": -(-(n_new - 1) // (G + 1)),
           "proposed": proposed, "accepted": accepted,
           "acceptance_rate": accepted / max(proposed, 1),
           "tokens_per_iteration": emitted / (iters * len(prompts)),
           # emitted_hist[e]: row-iterations that emitted e tokens (e <
           # G + 1: a draft rejected, or the row's last tokens)
           "emitted_hist": hist,
           "generate_s": gen_s, "prefill_s": prefill_s,
           "decode_s": gen_s - prefill_s, "tok_per_s": emitted / gen_s,
           "decode_ms_per_iteration": (gen_s - prefill_s) / iters * 1e3,
           "launch_formula": formula, "launches": launches,
           "margin": SPEC["margin"], "steps_compared": compared,
           "forks": forks, "spec_stats": stats1}
    return spec, row, launches


def phase20(torch, np, card) -> dict:
    """gemma3-1b at full width and depth in f32 (greedy decisive), K = 4,
    paged (page 16), 4 slots, phase 2's requests, 32 new tokens, gamma 4,
    with three drafts.  Member 0 as a K = 1 stack, saved and restored
    through checkpoint/store.py (the serve CLI's --draft-ckpt route),
    agrees with the random ensemble's near-constant stream; member 0
    with noise on its weights disagrees with it, so its run rejects
    drafts and rolls back (it must take more iterations than an
    all-accepting draft would, and accept some chunks in part); member
    0's first 2 layers (the cheap draft) cost a fraction of a full-depth
    draft's host time a step.  Every run's tokens must equal the plain
    engine's on every step whose top-2 fused log-prob margin clears
    2e-5; a speculative iteration launches flash once per attention
    layer (the verify pass: ring layers through their chunk prefill,
    paged ones through the verify), each prefill call once per layer of
    the draft and of the members, and the paged kernel never.  Prints,
    for the plain engine and each draft, generate's seconds split into
    prefill calls and the rest, and acceptance, emitted lengths and
    tokens an iteration; for member 0's run host and busy ms an
    iteration, the idle share and peak memory.  -> {path: launches}."""
    from repro_torch.checkpoint import store
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    from repro_torch.serving.spec.draft import load_draft
    t_phase = time.perf_counter()
    cfg = registry.get_config("gemma3-1b").with_(dtype="float32")
    K, G, n_new = 4, SPEC["gamma"], SERVE["new_tokens"]
    params = tf.init(cfg, seed=0, device="cuda", members=K)
    root = os.path.join(ROOT, "build", "phase20_draft")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    store.save_checkpoint(root, 1, tree_map(lambda x: x[:1], params))
    draft, step = load_draft(root, params)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    if not all(torch.equal(a, b[:1]) for a, b in zip(
            tree_leaves(draft), tree_leaves(params))):
        raise AssertionError("the restored draft is not member 0")
    kw = dict(n_slots=SERVE["slots"], max_prompt=SERVE["max_prompt"],
              max_out=SERVE["max_out"], paged=True, page_size=SERVE["page"],
              device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in SERVE["prompt_lens"]]
    plain = EnsembleEngine(cfg, params, **kw)
    plain.generate(prompts, max_new=2)                  # warm-up
    ref, plain_s, plain_prefill_s = timed_generate(torch, plain, prompts,
                                                   n_new)
    del plain
    torch.cuda.empty_cache()
    margins = [fused_margins(torch, np, params, cfg, p, a)
               for p, a in zip(prompts, ref)]
    below = sum(int((m < SPEC["margin"]).sum()) for m in margins)
    plain_row = {"generate_s": plain_s, "prefill_s": plain_prefill_s,
                 "decode_s": plain_s - plain_prefill_s,
                 "tok_per_s": sum(len(o) for o in ref) / plain_s,
                 "decode_ms_per_step": (plain_s - plain_prefill_s)
                 / (n_new - 1) * 1e3}
    torch.cuda.reset_peak_memory_stats()
    spec, row, launches = spec_run(torch, np, cfg, params, draft, prompts,
                                   ref, margins, kw)
    iters, n_attn = row["iterations"], attention_layers(cfg)

    def admit_and_prefill():
        spec.update_slots(release=range(spec.n_slots),
                          admits=[(i, p, n_new)
                                  for i, p in enumerate(prompts)])
        for i, p in enumerate(prompts):
            for _ in range(-(-len(p) // spec.prefill_chunk)):
                spec.prefill(i)

    # host ms an iteration: the same requests' speculative steps, timed
    # (each starts with the one read that resyncs the host's positions)
    admit_and_prefill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        spec.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / iters * 1e3
    admit_and_prefill()
    fa.flash_attention.launches = 0
    prof = profile_steps(torch, lambda: [spec.step() for _ in range(3)], 3,
                         ["flash_kernel", "paged_kernel"])
    if fa.flash_attention.launches != 3 * n_attn:
        raise AssertionError(f"3 speculative iterations launched flash "
                             f"{fa.flash_attention.launches} times, "
                             f"expected {3 * n_attn}")
    emit({"phase": 20, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
          "members": K, "n_layers": cfg.n_layers, "gamma": G,
          "slots": SERVE["slots"], "prompt_lens": SERVE["prompt_lens"],
          "new_tokens": n_new, "draft": "member 0, K = 1, checkpoint "
          f"step {step} restored", "draft_checkpoint_s": ckpt_s, **row,
          "plain": plain_row,
          "host_ms_per_iteration": host_ms,
          "device_busy_ms_per_iteration": prof["busy_ms"],
          "device_idle_share": 1.0 - prof["busy_ms"] / host_ms,
          "flash_ms_per_launch_in_situ": prof["name_ms"]["flash_kernel"]
          / n_attn,
          "flash_launches_per_iteration": n_attn,
          "paged_launches_per_iteration": 0,
          "steps_below_margin": below,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "top_kernels_ms_per_iteration": prof["top"],
          "phase_s": time.perf_counter() - t_phase})
    del spec, draft
    torch.cuda.empty_cache()
    out = {"speculative": launches}
    sigma, n_draft = SPEC["draft_noise"], SPEC["draft_layers"]
    for name, (d, dcfg) in (
            (f"member 0 + noise of {sigma} std a leaf (K = 1)",
             (noisy_draft(torch, params, sigma), None)),
            (f"member 0's first {n_draft} layers (K = 1)",
             shallow_draft(params, cfg, n_draft))):
        spec, row, launches = spec_run(torch, np, cfg, params, d, prompts,
                                       ref, margins, kw, draft_cfg=dcfg)
        if dcfg is None:
            # the noisy draft must reject: more iterations than an
            # all-accepting draft, and some partly accepted (2..G tokens
            # emitted: the chunk's tail restored and its pages truncated)
            if row["iterations"] <= row["iterations_if_all_accepted"] \
                    or not any(row["emitted_hist"][2:G + 1]):
                raise AssertionError(
                    f"the noisy draft took {row['iterations']} iterations, "
                    f"emitted {row['emitted_hist']}: rejection and partial "
                    f"rollback did not both run")
            out["speculative, noisy draft"] = launches
        else:
            out[f"speculative, {n_draft}-layer draft"] = launches
        emit({"phase": 20, "card": card, "arch": cfg.name,
              "dtype": cfg.dtype, "members": K, "gamma": G, "draft": name,
              "draft_layers": (dcfg or cfg).n_layers, **row,
              "phase_s": time.perf_counter() - t_phase})
        del spec, d
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 21: the network tier at full width (gemma3-1b, f32)
# ---------------------------------------------------------------------------

# 21a: 8 requests (phase 2's four prompts, twice; half JSON, half SSE)
# over two in-process replicas, then again, 0.5 s apart, while a rollout
# runs to the same weights plus noise of `rollout_noise` std a leaf (the
# random members repeat each prompt's last token at any seed; this noise
# makes every prompt's greedy tokens differ from the first token on);
# 21b: `fleet_requests` over two replica processes, one SIGKILLed after
# `kill_after` completions and restarted
NET = dict(requests=8, fleet_requests=32, kill_after=8, rollout_noise=2.0,
           margin=2e-5, timeout=600.0)


def net_spec():
    """The EngineSpec both halves serve: gemma3-1b at full width and
    depth, f32, K = 4, paged (page 16), 4 slots, phase 2's sizes, on the
    card."""
    from repro_torch.serving.frontend import EngineSpec
    return EngineSpec(arch="gemma3-1b", reduced=False, dtype="float32",
                      members=4, seed=0, n_slots=SERVE["slots"],
                      max_prompt=SERVE["max_prompt"],
                      max_out=SERVE["max_out"], paged=True,
                      page_size=SERVE["page"])


def margin_check(np, toks, ref, margins, what: str) -> int:
    """Tokens against a reference under the margin rule: equal up to the
    first fork, and the fused top-2 margin at a fork below NET's.  ->
    the steps compared."""
    toks, ref = np.asarray(toks), np.asarray(ref)
    if len(toks) != len(ref):
        raise AssertionError(f"{what}: {len(toks)} tokens, reference "
                             f"{len(ref)}")
    diff = np.nonzero(toks != ref)[0]
    if diff.size and margins[diff[0]] >= NET["margin"]:
        raise AssertionError(f"{what}: tokens fork from the reference at "
                             f"step {diff[0]}, fused margin "
                             f"{margins[diff[0]]:.3g} >= {NET['margin']}")
    return int(diff[0]) if diff.size else len(ref)


def fire(jobs, call, stagger: float = 0.0) -> tuple:
    """call(*job) for each job on its own thread, job i after i x
    `stagger` seconds.  -> ({index: result}, [errors], wall seconds)."""
    import threading

    results, errors = {}, []

    def run(i, job):
        time.sleep(i * stagger)
        try:
            results[i] = call(*job)
        except Exception as e:  # noqa: BLE001 - a dropped request fails
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i, job), daemon=True)
               for i, job in enumerate(jobs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(NET["timeout"])
    return results, errors, time.perf_counter() - t0


def fire_async(jobs, call, stagger: float = 0.0) -> tuple:
    """fire() on a thread of its own.  -> (the thread, a dict that gets
    "results", "errors" and "wall" when it ends)."""
    import threading
    box = {}
    t = threading.Thread(target=lambda: box.update(zip(
        ("results", "errors", "wall"), fire(jobs, call, stagger))),
        daemon=True)
    t.start()
    return t, box


def pct(np, xs, q):
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else None


def phase21(torch, np, card) -> dict:
    """21a: two Replicas of full-width gemma3-1b (f32, K = 4, paged)
    behind Router and FrontendServer on 127.0.0.1; 8 requests through
    one engine's Scheduler.run alone, then from client threads through
    the router alone and then over HTTP (half
    JSON, half SSE): tokens equal the same engines' in-process generate
    wherever the fused margin clears 2e-5, the page pools are whole in
    /healthz after the drain, paged attention launches once per paged
    layer per decode step and flash attention once per attention layer
    per prefill call; then the same requests while Router.rollout swaps
    the weights both replicas share to noisy ones: none dropped, each on
    the old or the new weights (whose tokens differ for every prompt, and
    differ between prompts), those sent after the drain began on the new,
    and afterwards only a fresh engine's tokens on the new.  21b: a
    FleetRouter of two replica processes on the card from one
    EngineSpec (their weights' digests equal the parent's), 32 threaded
    requests, one child SIGKILLed after 8 completions and restarted:
    every request completes, token-exact against 21a's references under
    the margin rule, both pools end whole, SIGTERM exits 0.  -> the HTTP
    run's launches of both kernels."""
    import gc
    import threading

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as tf
    from repro_torch.serving import client
    from repro_torch.serving.engine import EnsembleEngine
    from repro_torch.serving.frontend import (FleetRouter, FrontendServer,
                                              Replica, Router)
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.serving.frontend.replica import param_digest
    t_phase = time.perf_counter()
    spec = net_spec()
    cfg = spec.config()
    K, n_new = spec.members, SERVE["new_tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = spec.init_params()
    digest = param_digest(params)
    kw = dict(n_slots=spec.n_slots, max_prompt=spec.max_prompt,
              max_out=spec.max_out, paged=True, page_size=spec.page_size,
              device="cuda")
    # two replicas over one set of weights: a rollout drains and swaps
    # them together
    engines = [EnsembleEngine(cfg, params, **kw) for _ in range(2)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in SERVE["prompt_lens"]]
    # the in-process references (each engine's first run also loads the
    # kernels and makes their first launches)
    refs = [e.generate(prompts, max_new=n_new) for e in engines]
    for e in engines:
        e.update_slots(release=range(e.n_slots))
    for a, b in zip(*refs):
        if not np.array_equal(a, b):
            raise AssertionError("the two replicas' engines disagree")
    ref = refs[0]
    if len({tuple(r) for r in ref}) != len(ref):
        raise AssertionError("two prompts' references are the same: a "
                             "response sent to the wrong client would pass")
    margins = [fused_margins(torch, np, params, cfg, p, r)
               for p, r in zip(prompts, ref)]
    n_paged = n_paged_layers(cfg, engines[0].max_seq, tf)
    n_attn = attention_layers(cfg)
    jobs = [(prompts[i % 4], n_new, i % 2 == 0)
            for i in range(NET["requests"])]
    # the same requests through one engine's Scheduler.run on this
    # thread alone: what the two replicas' loop threads are held against
    sched = Scheduler(engines[0])
    for toks, m, _ in jobs:
        sched.submit(toks, m)
    t0 = time.perf_counter()
    comps = sched.run()
    one_s = time.perf_counter() - t0
    for i, c in comps.items():
        margin_check(np, c.tokens, ref[i % 4], margins[i % 4],
                     f"one-engine request {i}")
    one = {"wall_s": one_s,
           "tok_per_s": sum(len(c.tokens) for c in comps.values()) / one_s,
           "ttft_p50_ms": pct(np, [c.ttft for c in comps.values()], 50)
           * 1e3,
           "ttft_p99_ms": pct(np, [c.ttft for c in comps.values()], 99)
           * 1e3}
    engines[0].assert_pool_whole()
    del sched, comps
    reps = [Replica(f"r{i}", e) for i, e in enumerate(engines)]
    router = Router(reps)
    srv = FrontendServer(router)
    srv.start()
    kernels = {"paged_attention": pa.paged_attention,
               "flash_attention": fa.flash_attention}

    def counted(run):
        """run() with both kernels' counts from 0, then the formula:
        -> (run's value, launches, decode steps, prefill calls)."""
        steps0 = sum(e.steps_run for e in engines)
        pre0 = sum(e.prefills_run for e in engines)
        for fn in kernels.values():
            fn.launches = 0
        out = run()
        if not router.wait_idle(timeout=NET["timeout"]):
            raise AssertionError("the replicas did not quiesce")
        launches = {k: fn.launches for k, fn in kernels.items()}
        steps = sum(e.steps_run for e in engines) - steps0
        prefills = sum(e.prefills_run for e in engines) - pre0
        want = {"paged_attention": n_paged * steps,
                "flash_attention": n_attn * prefills}
        if launches != want:
            raise AssertionError(
                f"phase 21 launches {launches}, expected {n_paged} paged "
                f"layers x {steps} decode steps and {n_attn} attention "
                f"layers x {prefills} prefill calls")
        return out, launches, steps, prefills

    def in_process(toks, max_new, _stream):
        """One request through the router alone (no socket)."""
        done, got = threading.Event(), {}
        t0 = time.perf_counter()

        def first(_rid, _i, _tok):
            got.setdefault("ttft", time.perf_counter() - t0)

        router.submit(toks, max_new, on_token=first,
                      on_done=lambda c: (got.setdefault("c", c),
                                         done.set()))
        if not done.wait(NET["timeout"]):
            raise AssertionError("an in-process request never completed")
        return {"tokens": got["c"].tokens.tolist(), "ttft": got["ttft"],
                "latency": time.perf_counter() - t0}

    def over_http(toks, max_new, stream):
        return client.http_generate(srv.url, toks, max_new, stream=stream)

    def run_of(call):
        results, errors, wall = fire(jobs, call)
        if errors or len(results) != len(jobs):
            raise AssertionError(f"phase 21: {len(errors)} requests "
                                 f"failed: {errors[:2]}")
        compared = sum(margin_check(np, results[i]["tokens"], ref[i % 4],
                                    margins[i % 4], f"request {i}")
                       for i in range(len(jobs)))
        ttft = [r["ttft"] for r in results.values()
                if r["ttft"] is not None]
        n_tok = sum(len(r["tokens"]) for r in results.values())
        return {"wall_s": wall, "tok_per_s": n_tok / wall,
                "ttft_p50_ms": pct(np, ttft, 50) * 1e3,
                "ttft_p99_ms": pct(np, ttft, 99) * 1e3,
                "latency_p50_ms": pct(np, [r["latency"] for r in
                                           results.values()], 50) * 1e3,
                "steps_compared": compared, "results": results}

    try:
        try:
            local, local_launch, _, _ = counted(lambda: run_of(in_process))
            http, launches, steps, prefills = counted(
                lambda: run_of(over_http))
            health = client.http_get_json(srv.url, "/healthz")
            for r in health["replicas"]:
                if r["available_pages"] != r["n_pages"] or r["live_slots"]:
                    raise AssertionError(f"{r['name']}: pool not whole "
                                         f"after the drain: {r}")
            served = [r["completed"] for r in health["replicas"]]
            if min(served) == 0:
                raise AssertionError(f"one replica served nothing: {served}")
            server = client.server_percentiles(
                client.http_get_text(srv.url, "/metrics"))
            emit({"phase": 21, "part": "a", "card": card, "arch": cfg.name,
                  "dtype": cfg.dtype, "members": K,
                  "replicas": len(engines), "slots": spec.n_slots,
                  "prompt_lens": SERVE["prompt_lens"], "new_tokens": n_new,
                  "requests": len(jobs),
                  "launch_formula": f"paged_attention {n_paged} paged "
                                    f"layers x decode steps, "
                                    f"flash_attention {n_attn} attention "
                                    f"layers x prefill calls",
                  "launches": launches, "decode_steps": steps,
                  "prefill_calls": prefills, "local_launches": local_launch,
                  "margin": NET["margin"],
                  **{f"one_engine_{k}": v for k, v in one.items()},
                  **{f"in_process_{k}": v for k, v in local.items()
                     if k != "results"},
                  **{f"http_{k}": v for k, v in http.items()
                     if k != "results"},
                  "server_percentiles": server, "served_by_replica": served,
                  "params_digest": digest,
                  "phase_s": time.perf_counter() - t_phase})
            # the rollout: new weights, a fresh engine's references,
            # which must differ from the old for every prompt (from the
            # first token on) and between prompts
            new = noisy(torch, params, NET["rollout_noise"])
            fresh = EnsembleEngine(cfg, new, **kw)
            ref_new = fresh.generate(prompts, max_new=n_new)
            del fresh
            if any(a[0] == b[0] for a, b in zip(ref, ref_new)) or \
                    len({tuple(r) for r in ref_new}) != len(ref_new):
                raise AssertionError(
                    f"the rollout's weights do not tell their tokens "
                    f"apart: first tokens {[int(r[0]) for r in ref]} -> "
                    f"{[int(r[0]) for r in ref_new]}")
            new_digest = param_digest(new)
            if [param_digest(e.params) for e in engines] != [digest] * 2:
                raise AssertionError("a replica's weights changed before "
                                     "the rollout")
            margins_new = [fused_margins(torch, np, new, cfg, p, r)
                           for p, r in zip(prompts, ref_new)]
            # requests are sent 0.5 s apart; the rollout starts after the
            # third is submitted, so later ones meet the drained replicas

            def sent_over_http(toks, max_new, stream):
                sent = time.perf_counter()
                return dict(over_http(toks, max_new, stream), sent=sent)

            submitted = router.n_submitted
            loader, box = fire_async(jobs, sent_over_http, stagger=0.5)
            while router.n_submitted < submitted + 3:
                time.sleep(0.01)
            t0 = time.perf_counter()
            router.rollout(new)
            roll_s = time.perf_counter() - t0
            loader.join(NET["timeout"])
            if box.get("errors") or len(box.get("results", {})) != len(jobs):
                raise AssertionError(f"rollout under load dropped "
                                     f"requests: {box.get('errors')}")
            on_new, late = 0, 0
            for i, r in box["results"].items():
                # the first token tells the weights apart (checked above)
                is_new = bool(r["tokens"][0] == ref_new[i % 4][0])
                margin_check(np, r["tokens"], (ref_new if is_new else ref)
                             [i % 4], (margins_new if is_new else margins)
                             [i % 4], f"request {i}")
                on_new += is_new
                # the replicas share their weights, so they drain as one
                # the moment the rollout begins: what is sent later
                # (with half a stagger for the handler) waits in the
                # backlog and is served on the new weights
                if r["sent"] > t0 + 0.25:
                    late += 1
                    if not is_new:
                        raise AssertionError(
                            f"request {i}, sent {r['sent'] - t0:.2f} s "
                            f"after the rollout began, was served on the "
                            f"old weights")
            if not late or len(jobs) - on_new < 3:
                raise AssertionError(
                    f"{on_new} of {len(jobs)} requests on the new weights, "
                    f"{late} sent after the rollout began: expected the "
                    f"first 3 on the old and some on the new")
            post = client.http_generate(srv.url, prompts[0], n_new,
                                        stream=True)
            margin_check(np, post["tokens"], ref_new[0], margins_new[0],
                         "after the rollout")
            if [e.swaps_done for e in engines] != [1, 1] or \
                    [param_digest(e.params) for e in engines] != \
                    [new_digest] * 2:
                raise AssertionError("the rollout did not swap both")
            peak_a = torch.cuda.max_memory_allocated()
        finally:
            srv.shutdown(drain=True)
        emit({"phase": 21, "part": "a rollout", "card": card,
              "requests": len(jobs), "stagger_s": 0.5,
              "rollout_s": roll_s, "requests_on_new_tokens": on_new,
              "requests_sent_after_rollout_began": late,
              "rollout_noise": NET["rollout_noise"],
              "first_tokens": [int(r[0]) for r in ref],
              "first_tokens_new": [int(r[0]) for r in ref_new],
              "min_margin": float(min(m.min() for m in margins)),
              "min_margin_new": float(min(m.min() for m in margins_new)),
              "params_digest_new": new_digest,
              "max_memory_allocated": peak_a,
              "phase_s": time.perf_counter() - t_phase})
        del reps, router, srv, engines, new, params
        gc.collect()
        torch.cuda.empty_cache()

        # 21b: the same spec in two processes on the card
        fleet = FleetRouter(spec, n=2)
        t0 = time.perf_counter()
        try:
            fleet.start(timeout=NET["timeout"])
            spawn_s = time.perf_counter() - t0
            digests = [p.digest for p in fleet.procs]
            if digests != [digest, digest]:
                raise AssertionError(f"children's weights {digests} != the "
                                     f"parent's {digest}")
            lock = threading.Lock()
            count = {"done": 0}

            def fleet_call(toks, max_new, st):
                out = fleet.generate(toks, max_new, stream=st, retries=5,
                                     timeout=NET["timeout"])
                with lock:
                    count["done"] += 1
                return out

            fjobs = [(prompts[i % 4], n_new, i % 2 == 0)
                     for i in range(NET["fleet_requests"])]
            loader, box = fire_async(fjobs, fleet_call)
            deadline = time.time() + NET["timeout"]
            while count["done"] < NET["kill_after"] and \
                    time.time() < deadline:
                time.sleep(0.01)
            done_at_kill = count["done"]
            fleet.procs[1].kill()
            dead = fleet.health_sweep()
            t0 = time.perf_counter()
            fleet.restart("p1", timeout=NET["timeout"])
            restart_s = time.perf_counter() - t0
            loader.join(NET["timeout"])
            if box.get("errors") or len(box.get("results", {})) != \
                    len(fjobs):
                raise AssertionError(f"the fleet dropped requests: "
                                     f"{box.get('errors')}")
            compared = sum(margin_check(np, box["results"][i]["tokens"],
                                        ref[i % 4], margins[i % 4],
                                        f"fleet request {i}")
                           for i in range(len(fjobs)))
            if fleet.procs[1].digest != digest:
                raise AssertionError("the restarted child's weights differ")
            pools = []
            for p in fleet.procs:
                deadline = time.time() + 60.0
                while True:
                    r = p.healthz()["replicas"][0]
                    if (r["live_slots"] == 0 and r["pending"] == 0
                            and r["available_pages"] == r["n_pages"]):
                        break
                    if time.time() > deadline:
                        raise AssertionError(f"{p.name}: pool not whole: "
                                             f"{r}")
                    time.sleep(0.05)
                pools.append([r["available_pages"], r["n_pages"]])
            stats = fleet.stats()
            n_tok = sum(len(r["tokens"]) for r in box["results"].values())
        finally:
            codes = [p.terminate(timeout=120.0) for p in fleet.procs]
        if codes != [0, 0]:
            raise AssertionError(f"children exited {codes} on SIGTERM")
        emit({"phase": 21, "part": "b", "card": card, "arch": cfg.name,
              "dtype": cfg.dtype, "members": K, "processes": 2,
              "requests": len(fjobs), "spawn_to_ready_s": spawn_s,
              "restart_s": restart_s, "completed_at_kill": done_at_kill,
              "swept_dead": dead, "wall_s": box["wall"],
              "tok_per_s": n_tok / box["wall"], "steps_compared": compared,
              "retried": stats["retried"], "latched": stats["latched"],
              "backoffs": stats["backoffs"], "restarts": stats["restarts"],
              "pools_whole": pools, "exit_codes": codes,
              "peak_memory_per_child": [p.peak_memory
                                        for p in fleet.procs],
              "phase_s": time.perf_counter() - t_phase})
    finally:
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3: card against CPU
# ---------------------------------------------------------------------------

def phase3(torch, np, arch: str):
    """Reduced `arch`, f32, K = 4, paged (an encoder-decoder contiguous,
    as the engine serves it): greedy tokens identical on the card and the
    CPU, fused log-probs within 1e-4."""
    from repro_torch.configs import registry
    from repro_torch.core import ensemble as ens
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    cfg = registry.get_config(arch, reduced=True).with_(dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (7, 19, 25, 32)]
    paged = not cfg.enc_dec
    kw = dict(n_slots=4, max_prompt=32, max_out=16, paged=paged,
              page_size=8)
    toks, lps = {}, {}
    for dev in ("cuda", "cpu"):
        eng = EnsembleEngine(cfg, params, device=dev, **kw)
        toks[dev] = eng.generate(prompts, max_new=12)
        # the fused log-probs of the first decode step after prefill
        eng.update_slots(release=range(4),
                         admits=[(i, p, 12) for i, p in enumerate(prompts)])
        for i, p in enumerate(prompts):
            for _ in range(-(-len(p) // eng.prefill_chunk)):
                eng.prefill(i)
        eng.reserve_decode_pages()
        step = tf.decode_step_paged if paged else tf.decode_step_slots
        logits, _ = step(eng.params, cfg, eng.cache, eng.state.tok[:, None])
        lps[dev] = ens.ensemble_log_probs(logits[:, :, 0],
                                          eng.quorum).cpu()
    same = all(np.array_equal(a, b) for a, b in zip(toks["cuda"],
                                                     toks["cpu"]))
    err = (lps["cuda"] - lps["cpu"]).abs().max().item()
    emit({"phase": 3, "arch": cfg.name, "dtype": cfg.dtype, "members": 4,
          "paged": paged, "tokens_identical": same, "logp_max_abs_err": err,
          "tol": 1e-4})
    if not same:
        raise AssertionError(f"{arch}: greedy tokens differ: {toks}")
    # tolerance: the same f32 math summed in another order on each device
    torch.testing.assert_close(lps["cuda"], lps["cpu"], atol=1e-4,
                               rtol=1e-4)


def phase3_quant_spec(torch, np):
    """Reduced gemma3-1b, f32, K = 4, paged (page 8): an int8-page engine
    and a speculative one (member 0 drafting, gamma 3) give identical
    greedy tokens on the card and the CPU, and fused log-probs within
    1e-4: the first decode step's (int8), a verify pass's at all four
    chunk positions (speculative)."""
    from repro_torch.common.tree import tree_map
    from repro_torch.configs import registry
    from repro_torch.core import ensemble as ens
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    from repro_torch.serving.spec import SpeculativeEngine
    cfg = registry.get_config("gemma3-1b", reduced=True).with_(
        dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (7, 19, 25, 32)]
    chunk = rng.integers(0, cfg.vocab_size, (4, 3))
    kw = dict(n_slots=4, max_prompt=32, max_out=16, paged=True, page_size=8)
    makers = {
        "int8_pages": lambda dev: EnsembleEngine(
            cfg, params, kv_dtype="int8", device=dev, **kw),
        "speculative_gamma3": lambda dev: SpeculativeEngine(
            cfg, params, tree_map(lambda x: x[0], params), gamma=3,
            device=dev, **kw)}
    for name, make in makers.items():
        toks, lps = {}, {}
        for dev in ("cuda", "cpu"):
            eng = make(dev)
            toks[dev] = eng.generate(prompts, max_new=12)
            eng.update_slots(release=range(4), admits=[
                (i, p, 12) for i, p in enumerate(prompts)])
            for i, p in enumerate(prompts):
                for _ in range(-(-len(p) // eng.prefill_chunk)):
                    eng.prefill(i)
            eng.reserve_decode_pages()
            if name == "int8_pages":
                logits, _ = tf.decode_step_paged(eng.params, cfg, eng.cache,
                                                 eng.state.tok[:, None])
            else:
                c = torch.cat([eng.state.tok[:, None],
                               torch.as_tensor(chunk, device=dev)], 1)
                logits, _ = tf.verify_step_paged(
                    eng.params, cfg, eng.cache, c,
                    torch.full((4,), 4, dtype=torch.int32, device=dev))
            lps[dev] = ens.ensemble_log_probs(logits, eng.quorum).cpu()
        same = all(np.array_equal(a, b) for a, b in zip(toks["cuda"],
                                                         toks["cpu"]))
        err = (lps["cuda"] - lps["cpu"]).abs().max().item()
        emit({"phase": 3, "arch": cfg.name, "path": name,
              "dtype": cfg.dtype, "members": 4, "tokens_identical": same,
              "logp_max_abs_err": err, "tol": 1e-4})
        if not same:
            raise AssertionError(f"{name}: greedy tokens differ card/CPU")
        torch.testing.assert_close(lps["cuda"], lps["cpu"], atol=1e-4,
                                   rtol=1e-4)


# phase 3's continuous-batching half: reduced configs, f32, K = 4.
# gemma3-1b's reduced local window is 16, so max_prompt + max_out stays
# at 16 for every layer to page (the prefix cache needs it); rwkv6-7b and
# jamba refuse the prefix cache and run a pool small enough to preempt;
# qwen2-vl-2b runs both ways; whisper-tiny serves from the contiguous
# pool (no pages: nothing to preempt)
PHASE3_CONT = [
    ("gemma3-1b", dict(n_slots=3, max_prompt=12, max_out=4, n_pages=9,
                       prefix_cache=True)),
    ("deepseek-7b", dict(n_slots=3, max_prompt=24, max_out=6, n_pages=14,
                         prefix_cache=True)),
    ("rwkv6-7b", dict(n_slots=3, max_prompt=24, max_out=6, n_pages=6)),
    ("jamba-v0.1-52b", dict(n_slots=3, max_prompt=24, max_out=6,
                            n_pages=6)),
    ("deepseek-v2-236b", dict(n_slots=3, max_prompt=24, max_out=6,
                              n_pages=14, prefix_cache=True)),
    ("qwen2-vl-2b", dict(n_slots=3, max_prompt=24, max_out=6, n_pages=14,
                         prefix_cache=True)),
    ("qwen2-vl-2b", dict(n_slots=3, max_prompt=24, max_out=6, n_pages=6)),
    ("whisper-tiny", dict(n_slots=3, max_prompt=24, max_out=6,
                          paged=False))]


def phase3_continuous(torch, np, arch: str, run: dict):
    """Reduced `arch`, f32, K = 4, paged (page 4, chunk 4) unless `run`
    says paged=False: the same requests (a shared prefix cut at random
    plus a short tail) through Scheduler.run on the card and on the CPU
    give identical completions and preemptions, and the pool is whole
    after the drain; engine.score agrees within 1e-4 and keeps the
    Jensen bound."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    from repro_torch.serving.scheduler import Scheduler
    cfg = registry.get_config(arch, reduced=True).with_(dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=4)
    kw = dict(dict(paged=True, page_size=4, prefill_chunk=4), **run)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 16)
    reqs = []
    for i in range(9):
        cut = int(rng.integers(4, 17))
        tail = rng.integers(0, cfg.vocab_size, 1 + int(rng.integers(6)))
        max_new = kw["max_out"] - i % 2
        # the whole request fits the pool, so it can always complete
        plen = min(cut + len(tail), kw["max_prompt"],
                   kw.get("n_pages", kw["max_prompt"]) * 4 - max_new)
        reqs.append((np.concatenate([shared[:cut], tail])[:plen], max_new))
    toks = rng.integers(0, cfg.vocab_size, (3, 9))
    labels = np.roll(toks, -1, axis=1)
    got = {}
    for dev in ("cuda", "cpu"):
        eng = EnsembleEngine(cfg, params, device=dev, **kw)
        sched = Scheduler(eng)
        rids = [sched.submit(t, m) for t, m in reqs]
        comps = sched.run()
        eng.assert_pool_whole()
        m, e = eng.score(toks, labels)
        got[dev] = ([comps[r].tokens for r in rids], sched.preemptions,
                    eng.page_stats().get("prefix_hits"), m.cpu(), e.cpu())
    same = all(np.array_equal(a, b)
               for a, b in zip(got["cuda"][0], got["cpu"][0]))
    m_err = (got["cuda"][3] - got["cpu"][3]).abs().max().item()
    e_err = abs(got["cuda"][4].item() - got["cpu"][4].item())
    emit({"phase": 3, "arch": cfg.name, "path": "continuous",
          "paged": kw["paged"], "prefix_cache": kw.get("prefix_cache", False),
          "completions_identical": same,
          "preemptions": got["cuda"][1], "prefix_hits": got["cuda"][2],
          "score_member_max_abs_err": m_err, "score_ensemble_abs_err": e_err,
          "tol": 1e-4})
    if not same or got["cuda"][1:3] != got["cpu"][1:3]:
        raise AssertionError(f"{arch}: continuous runs differ card/CPU: "
                             f"{got['cuda'][:3]} vs {got['cpu'][:3]}")
    if kw.get("prefix_cache") and not got["cuda"][2]:
        raise AssertionError(f"{arch}: the prefix cache never hit")
    if kw["paged"] and not kw.get("prefix_cache") and got["cuda"][1] == 0:
        raise AssertionError(f"{arch}: the small pool never preempted")
    torch.testing.assert_close(got["cuda"][3], got["cpu"][3], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(got["cuda"][4], got["cpu"][4], atol=1e-4,
                               rtol=1e-4)
    if got["cuda"][4].item() > got["cuda"][3].mean().item() + 1e-6:
        raise AssertionError(f"{arch}: ensemble NLL above the mean member "
                             f"NLL (Jensen)")


# ---------------------------------------------------------------------------
# phase 4: the fused distillation loss against its plain version
# ---------------------------------------------------------------------------

# operations per element, for the bound: forward max, subtract, exp,
# add, the pseudo product and its sum, the label compare (7, rounded up);
# backward subtract, exp, the (1+lam) product, the one-hot compare and
# subtract, the lam product and subtract, the g/N product (8)
DISTILL_OPS = {"fwd": 8, "bwd": 8}


def distill_inputs(torch, gen, N, V, zdt, pdt, pad):
    """Pseudo-labels peaked where the logits are large (a softmax of 2z
    plus noise, as an ensemble's are), so that <p, z> is of the size of
    the loss and a kernel that dropped the lambda terms would fail."""
    z = (torch.randn(N, V, generator=gen, device="cuda") * 3).to(zdt)
    y = torch.randint(0, V, (N,), generator=gen, device="cuda",
                      dtype=torch.int32)
    if pad:
        y[::7] = -1
    p = torch.softmax(2 * z.float() + torch.randn(N, V, generator=gen,
                                                  device="cuda"), -1)
    return z, y, p.to(pdt), torch.tensor(0.4, device="cuda")


# (atol, rtol, relative L1) on N * dz / g, whose entries are O(1): f32
# at the JAX package's kernel-test tolerance; bf16 one rounding of the
# output (2^-7 relative), atol for the f32 cancellation before it
DZ_TOL = {"float32": (2e-5, 2e-5, 2e-5), "bfloat16": (1e-5, 8e-3, 8e-3)}


def check_dz(torch, dz, dz_ref, g: float, name: str) -> tuple:
    """Hold dz = g/N * ((1+lam) softmax - onehot - lam p) against its
    plain version at the gradient's own scale, N * dz / g, element by
    element and in relative L1 (the L1 sees the many small softmax
    entries that no elementwise atol can).  -> (max abs error of dz,
    of N * dz / g, relative L1)."""
    scale = dz.shape[0] / g
    a, b = dz.float() * scale, dz_ref.float() * scale
    atol, rtol, l1 = DZ_TOL[str(dz.dtype).split(".")[-1]]
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol,
                               msg=lambda m: f"{name} bwd: {m}")
    rel_l1 = ((a - b).abs().sum() / b.abs().sum()).item()
    if not rel_l1 <= l1:
        raise AssertionError(f"{name} bwd: relative L1 error {rel_l1} > {l1}")
    err = (dz.float() - dz_ref.float()).abs().max().item()
    return err, (a - b).abs().max().item(), rel_l1


def distill_bound(z, p, which):
    """(bound_ms, bound_by): each input read once, each output written
    once (forward: logits, pseudo, labels in; lse, gold, dot out;
    backward: logits, pseudo, labels, lse in; dz out), against the
    elementwise operations at the f32 rate outside the tensor cores."""
    N, V = z.shape
    nbytes = z.numel() * z.element_size() + p.numel() * p.element_size()
    if which == "fwd":
        nbytes += N * 4 + 3 * N * 4
    else:
        nbytes += N * 4 + N * 4 + z.numel() * z.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = DISTILL_OPS[which] * N * V / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase4(torch, flush, card):
    import torch.nn.functional as F
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, N, V, logits dtype, pseudo dtype, padded labels
        ("nin_f32", 256, 100, f32, f32, False),      # the main path's shape
        # phase 23's NiN steps at --fast (K 4 x B 32): the quickstart's
        # 10 classes and table1 / fig12's 20, V % 4 != 0 taking the
        # kernels' scalar loads
        ("nin_v10_f32", 128, 10, f32, f32, False),
        ("nin_v20_f32", 128, 20, f32, f32, False),
        ("vocab_bf16", 2048, 262144, bf16, f32, False),
        # rwkv6-7b's distill step in phase 15 (K 4 x B 8 x T 64 rows)
        ("vocab65k_bf16", 2048, 65536, bf16, f32, False),
        ("vocab_f32_pad", 512, 32768, f32, f32, True),
    ]
    # loss rtol 1e-5 for both logits types: both sides read the same
    # values and sum in f32; dz: DZ_TOL
    loss_tol = 1e-5
    main, by_case = {}, {"fwd": {}, "bwd": {}}
    for name, N, V, zdt, pdt, pad in cases:
        z, y, p, lam = distill_inputs(torch, gen, N, V, zdt, pdt, pad)
        g = torch.tensor(1.0, device="cuda")
        # forward: the kernel's loss against the plain loss
        zk = z.clone().requires_grad_()
        got = dl.fused_distill_loss(zk, y, p, lam)
        zr = z.clone().requires_grad_()
        want = ref.distill_loss(zr, y, p, lam)
        torch.cuda.synchronize()
        err_f = abs(got.item() - want.item())
        torch.testing.assert_close(got.detach(), want.detach(),
                                   rtol=loss_tol, atol=0,
                                   msg=lambda m: f"{name} fwd: {m}")
        # backward: the kernel's dz against autograd of the plain version
        (dz,) = torch.autograd.grad(got, zk)
        (dz_ref,) = torch.autograd.grad(want, zr, retain_graph=True)
        torch.cuda.synchronize()
        err_b, err_scaled, rel_l1 = check_dz(torch, dz, dz_ref, 1.0, name)
        # the library yardstick: one cross_entropy with probability
        # targets onehot(y) + lam * pseudo, built beforehand
        target = lam * p.to(zdt)
        ok = y >= 0
        target[ok.nonzero()[:, 0], y[ok].long()] += 1.0
        zl = z.clone().requires_grad_()
        lib_loss = F.cross_entropy(zl, target)
        lse, _, _ = dl.distill_loss_fwd(z, y, p)
        fns = {
            "fwd": (lambda: dl.distill_loss_fwd(z, y, p),
                    lambda: ref.distill_loss_parts(z, y, p),
                    lambda: F.cross_entropy(z, target)),
            "bwd": (lambda: dl.distill_loss_bwd(z, y, p, lse, g, lam),
                    lambda: torch.autograd.grad(want, zr, retain_graph=True),
                    lambda: torch.autograd.grad(lib_loss, zl,
                                                retain_graph=True)),
        }
        for which, (kern, plain, lib) in fns.items():
            ms = time_ms(kern, torch, flush)
            plain_ms = time_ms(plain, torch, flush, iters=10)
            lib_ms = time_ms(lib, torch, flush, iters=10)
            bound_ms, bound_by = distill_bound(z, p, which)
            row = {"phase": 4, "card": card,
                   "kernel": f"distill_loss_{which}", "case": name,
                   "N": N, "V": V, "logits": str(zdt).split(".")[-1],
                   "pseudo": str(pdt).split(".")[-1], "padded_labels": pad,
                   "max_abs_err": err_f if which == "fwd" else err_b,
                   "tol": ({"loss_rtol": loss_tol} if which == "fwd" else
                           dict(zip(("atol", "rtol", "rel_l1"),
                                    DZ_TOL[str(zdt).split(".")[-1]]),
                                of="N*dz/g")),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if which == "bwd":
                row.update(max_abs_err_scaled=err_scaled, rel_l1_err=rel_l1)
            emit(row)
            by_case[which][name] = row
            if name == "nin_f32":
                main[which] = row
        del z, p, zk, zr, got, want, dz, dz_ref, target, zl, lib_loss, fns
        torch.cuda.empty_cache()
    return main, by_case


# ---------------------------------------------------------------------------
# phase 5: the training path at full width
# ---------------------------------------------------------------------------

def step_inputs(tr, n: int, distill: bool) -> list:
    """n steps' (batch, pseudo) drawn as run_round draws them."""
    from repro_torch.data import sample_batch
    if distill:
        return [tr._sample_pseudo_batch() for _ in range(n)]
    return [(sample_batch(tr.rng, tr.shards, tr.batch), None)
            for _ in range(n)]


def run_on(tr, inputs: list, lam) -> None:
    """The steps on these inputs, from a copy of the trainer's state."""
    state = tr.state
    for batch, pseudo in inputs:
        state, _ = tr._plain_step(state, batch, pseudo,
                                  0.0 if pseudo is None else lam)


def host_ms(torch, tr, n: int, distill: bool, lam) -> float:
    """Host ms per step over n steps, sampling included, ending in a
    synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_on(tr, step_inputs(tr, n, distill), lam)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def device_ms(torch, tr, distill: bool, lam) -> dict:
    """Device ms per step with no host gap between the steps, and host
    ms to enqueue one, without the profiler.  The batches are drawn
    first; the host then enqueues n steps while the stream is held by a
    torch.cuda._sleep, and CUDA events bracket the steps.  The reading
    counts only if the device was still asleep when the host had
    enqueued the last step; else one step is tried (on the H100 two
    NiN steps fit ahead of the device and four did not)."""
    for n in (2, 1):
        inputs = step_inputs(tr, n, distill)
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(n * 400_000_000)   # ~0.2 s a step, 20x its enqueue
        s.record()
        t0 = time.perf_counter()
        run_on(tr, inputs, lam)
        enqueue_s = time.perf_counter() - t0
        e.record()
        ahead = not s.query()
        e.synchronize()
        if ahead:
            return {"steps": n, "device_ms": s.elapsed_time(e) / n,
                    "enqueue_ms": enqueue_s / n * 1e3}
    return {"steps": 0, "device_ms": None, "enqueue_ms": None}


def phase5(torch, np, card):
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.data import image_member_datasets, sample_batch
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.optim import sgd_momentum
    from repro_torch.runtime.trainer import Trainer
    cfg = registry.get_config("paper_nin")
    K, B, per_member, rounds = 4, 64, 1024, 2
    ec = ECConfig(tau=16, p_steps=8, lam=0.5, relabel_fraction=0.7,
                  label_mode="dense", aggregator="ec")
    train, test = image_member_datasets(K, per_member,
                                        n_classes=cfg.vocab_size, img=32,
                                        seed=0, device="cuda")
    tr = Trainer(cfg, ec, sgd_momentum(0.05, 0.9), K, 0, train, test,
                 batch_size=B, seed=0, device="cuda")
    # warm-up (cuDNN, the kernels' first load) on a copy of the state,
    # with its own indices: run_round below starts from the untouched state
    warm = sample_batch(np.random.default_rng(99), tr.shards, B)
    fake = torch.softmax(torch.randn(K, B, cfg.vocab_size, device="cuda"),
                         -1)
    tr._plain_step(tr._plain_step(tr.state, warm, None, 0.0)[0], warm,
                   fake, torch.tensor(0.5, device="cuda"))
    expected = (rounds - 1) * ec.p_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dl.distill_loss_fwd.launches = 0
    dl.distill_loss_bwd.launches = 0
    losses, evals, round_s = [], [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        losses.append(tr.run_round())
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        evals.append(tr.evaluate())
    launches = {"fwd": dl.distill_loss_fwd.launches,
                "bwd": dl.distill_loss_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    for which, n in launches.items():
        if n != expected:
            raise AssertionError(f"distill_loss_{which} launched {n} times, "
                                 f"expected {expected}")
    for r, (loss, ev) in enumerate(zip(losses, evals)):
        vals = [loss] + list(ev.values())
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"round {r}: non-finite {loss}, {ev}")
        gap = ev["local_loss"] - ev["global_loss"]
        if gap < -1e-6:
            raise AssertionError(f"round {r}: Jensen gap {gap} < 0")
    # the parts of a round, timed on copies of the state: host ms per
    # step (median of 3 interleaved runs of 10), device ms per step with
    # the host's gaps taken out, and their ratio, the idle share
    lam = torch.tensor(0.25, device="cuda")
    times = {False: [], True: []}
    for _ in range(3):
        for distill in (False, True):
            times[distill].append(host_ms(torch, tr, 10, distill, lam))
    step = {}
    for distill, name in ((False, "plain"), (True, "distill")):
        ms = sorted(times[distill])[1]
        dev = device_ms(torch, tr, distill, lam)
        step[name] = dict(dev, host_ms=ms, host_ms_runs=times[distill],
                          idle_share=None if dev["device_ms"] is None
                          else 1.0 - dev["device_ms"] / ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr._relabel()
    torch.cuda.synchronize()
    relabel_s = time.perf_counter() - t0
    # device time by kernel under the profiler, over 3 plain and 3
    # distill steps: for the kernels' names and shares (the profiler
    # adds to the kernels' sum, which is read against step["device_ms"])
    prof = profile_steps(torch, lambda: (
        run_on(tr, step_inputs(tr, 3, False), lam),
        run_on(tr, step_inputs(tr, 3, True), lam)), 6, ["distill_"])
    emit({"phase": 5, "card": card, "arch": cfg.name, "dtype": "float32",
          "tf32": False, "members": K, "batch_per_member": B,
          "per_member": per_member, "img": 32, "tau": ec.tau,
          "p_steps": ec.p_steps, "rounds": rounds,
          "launch_formula": f"({rounds} rounds - 1) x {ec.p_steps} distill "
                            f"steps x 1 launch = {expected} each way",
          "launches": launches, "round_loss": losses,
          "evaluate": evals,
          "jensen_gap": [e["local_loss"] - e["global_loss"] for e in evals],
          "round_s": round_s,
          "images_per_s": K * B * ec.tau / round_s[-1],
          "plain_step_ms": step["plain"]["host_ms"],
          "distill_step_ms": step["distill"]["host_ms"], "steps": step,
          "relabel_s": relabel_s, "max_memory_allocated": peak,
          "profiler_kernel_ms_per_step": prof["busy_ms"],
          "profiled_step_ms": prof["wall_ms"],
          "distill_kernels_ms_per_distill_step":
              prof["name_ms"]["distill_"] * 2,
          "top_kernels_ms_per_step": prof["top"]})
    del tr, train, test
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: training on the card against the CPU
# ---------------------------------------------------------------------------

def trainer_on(dev, cfg, ec, opt, K, params, train, test, batch,
               trainer=False):
    """Two rounds of a Trainer on `dev`, from the given numpy params:
    -> [round loss, evaluate() values...] per round, then
    evaluate_compressed() (and the trainer, with trainer=True)."""
    from repro_torch.runtime.trainer import Trainer
    tr = Trainer(cfg, ec, opt, K, 0, train, test, batch_size=batch, seed=1,
                 params=params, device=dev)
    rows = []
    for _ in range(2):   # a plain round, then a distill round
        rows.append(tr.run_round())
        rows.extend(tr.evaluate().values())
    rows.extend(tr.evaluate_compressed().values())
    return (rows, tr) if trainer else rows


# the most reduced rwkv6-7b's two f32 routes may differ in a loss or
# metric, relative (tests/test_torch_ssm_train.py's GAP_CEILING["loss"])
RWKV_GAP_CEILING = 1e-3


@contextlib.contextmanager
def step_loop_route():
    """rwkv's training route through ref.wkv6's step loop (the wkv6
    kernel's plain version, which autograd differentiates) in place of
    models/ssm._wkv_chunked: the port's second f32 route."""
    from repro_torch.kernels import ref
    from repro_torch.models import ssm
    real = ssm._wkv_chunked
    ssm._wkv_chunked = ref.wkv6
    try:
        yield
    finally:
        ssm._wkv_chunked = real


def phase6(torch):
    from repro_torch import models
    from repro_torch.common.tree import tree_map
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.data import image_member_datasets, lm_member_datasets
    from repro_torch.optim import adamw, sgd_momentum
    nin = registry.get_config("paper_nin").with_(d_model=48, vocab_size=10)
    gemma = registry.get_config("gemma3-1b", reduced=True).with_(
        dtype="float32")
    rwkv = registry.get_config("rwkv6-7b", reduced=True).with_(
        dtype="float32")
    # jamba's first 4 layers: Mamba-dense, Mamba-MoE, Mamba-dense,
    # attention-MoE (all three mixers and the MoE train)
    jamba = registry.get_config("jamba-v0.1-52b", reduced=True).with_(
        dtype="float32", n_layers=4)
    nin_data = image_member_datasets(4, 64, n_classes=10, img=16, seed=0,
                                     device="cpu")
    lm_data = lm_member_datasets(2, 32, 16, gemma.vocab_size, seed=0,
                                 device="cpu")
    cases = {  # name: (config, K, optimizer, label mode, data, batch)
        "paper_nin reduced (d_model 48, img 16, 10 classes)":
            (nin, 4, lambda: sgd_momentum(0.02), "dense", nin_data, 16),
        "gemma3-1b reduced, dense labels":
            (gemma, 2, lambda: adamw(1e-3), "dense", lm_data, 4),
        "gemma3-1b reduced, top-8 labels":
            (gemma, 2, lambda: adamw(1e-3), "topk", lm_data, 4),
        "rwkv6-7b reduced, dense labels":
            (rwkv, 2, lambda: adamw(1e-3), "dense", lm_data, 4),
        "jamba-v0.1-52b reduced, 4 layers, dense labels":
            (jamba, 2, lambda: adamw(1e-3), "dense", lm_data, 4)}
    trainers = {}
    for name, (cfg, K, opt, mode, (train, test), batch) in cases.items():
        params = tree_map(lambda v: v.numpy(), models.init(
            cfg, seed=0, device="cpu", members=K))
        ec = ECConfig(tau=4 if K == 4 else 3, p_steps=2, lam=0.5,
                      relabel_fraction=0.5, label_mode=mode, top_m=8,
                      aggregator="ec")
        out = {}
        for dev in ("cuda", "cpu"):
            out[dev], trainers[name, dev] = trainer_on(
                dev, cfg, ec, opt(), K, params, train, test, batch, True)
        got, want = (torch.tensor(out[d], dtype=torch.float64)
                     for d in ("cuda", "cpu"))
        # tolerance: the same f32 math, summed in another order on each
        # device: rtol 1e-4, or for rwkv6-7b twice the gap between its
        # two f32 routes on the CPU, if larger (reduced rwkv6-7b is
        # ill-conditioned in f32: tests/test_torch_ssm_train.py), a gap
        # that must stay below RWKV_GAP_CEILING
        rtol = 1e-4
        if cfg.family == "ssm":
            with step_loop_route():
                alt = torch.tensor(trainer_on("cpu", cfg, ec, opt(), K,
                                              params, train, test, batch),
                                   dtype=torch.float64)
            gap = ((alt - want).abs()
                   / want.abs().clamp_min(1e-30)).max().item()
            if gap > RWKV_GAP_CEILING:
                raise AssertionError(f"{name}: the two f32 routes differ "
                                     f"by {gap} > {RWKV_GAP_CEILING}")
            rtol = max(rtol, 2 * gap)
        err = (got - want).abs().max().item()
        emit({"phase": 6, "arch": name, "dtype": "float32", "members": K,
              "label_mode": mode, "values_compared": len(out["cpu"]),
              "max_abs_err": err, "rtol": rtol})
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")
    phase6_checkpoints(torch, trainers["rwkv6-7b reduced, dense labels",
                                       "cuda"],
                       trainers["rwkv6-7b reduced, dense labels", "cpu"],
                       rwkv, lm_data)


def phase6_checkpoints(torch, tr_card, tr_cpu, cfg, data):
    """checkpoint/store.py across devices: the reduced rwkv6-7b trainers'
    states (the same structure, trained apart), written from the card
    and restored on the CPU, and the reverse, bit for bit; then an MA
    trainer on the card run three rounds straight against two rounds
    saved and a fresh trainer that resumes them for the third (handed
    the host's index generator, which no checkpoint holds): the same
    loss within 1e-4 (and whether the states are equal bit for bit)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.common.types import ECConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        n_leaves = 0
        for step, src, dst in ((1, tr_card, tr_cpu), (2, tr_cpu, tr_card)):
            save_checkpoint(root, step, src.state)
            got = restore_checkpoint(root, step, dst.state)
            for a, b in zip(tree_leaves(got), tree_leaves(src.state)):
                if a.device.type != dst.device.type \
                        or not torch.equal(a.cpu(), b.cpu()):
                    raise AssertionError(f"checkpoint {src.device} -> "
                                         f"{dst.device}: a leaf differs")
            n_leaves = len(tree_leaves(got))
        train, test = (tree_map(lambda t: t.to("cuda"), t) for t in data)
        ec = ECConfig(tau=2, p_steps=1, lam=0.5, relabel_fraction=0.5,
                      aggregator="ma")

        def trainer(ckpt=None):
            return Trainer(cfg, ec, adamw(1e-3), 2, 0, train, test,
                           batch_size=4, seed=1, ckpt_dir=ckpt,
                           device="cuda")
        straight = trainer()
        losses = [straight.run_round() for _ in range(3)]
        ckpt = os.path.join(root, "resume")
        first = trainer(ckpt)
        for _ in range(2):
            first.run_round()
        first.ckpt.wait()
        again = trainer(ckpt)
        if not again.resume() or again.round != 2:
            raise AssertionError("resume found no round 2")
        again.rng.bit_generator.state = first.rng.bit_generator.state
        resumed = again.run_round()
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(again.state), tree_leaves(straight.state)))
        for tr in (first, again):
            tr.ckpt.close()
        emit({"phase": 6, "checkpoints": "rwkv6-7b reduced, f32, AdamW",
              "leaves": n_leaves, "card_to_cpu": "bit for bit",
              "cpu_to_card": "bit for bit", "straight_round3_loss":
              losses[2], "resumed_round3_loss": resumed,
              "state_bit_for_bit": same, "rtol": 1e-4})
        # within the phase's rtol: the card's atomic adds (an embedding's
        # backward) may sum in another order from run to run
        if not math.isclose(resumed, losses[2], rel_tol=1e-4):
            raise AssertionError(f"resumed round 3: {resumed} against "
                                 f"{losses[2]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: EC training of gemma3-1b at full width
# ---------------------------------------------------------------------------

LM_TRAIN = dict(members=4, batch=8, seq_len=64, per_member=32, relabel=0.7,
                tau=4, p_steps=2, rounds=2, top_m=64, lr=1e-4)


def lm_steps(torch, tr, n: int, distill: bool) -> list:
    """n steps drawn as run_round draws them, each timed on the host from
    its draw to a synchronise after it.  -> host ms of each.  The state
    is updated in place (AdamW), so these steps come after the rounds
    whose losses are reported."""
    from repro_torch.data import sample_batch
    lam = torch.tensor(0.25, device="cuda")
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if distill:
            batch, pseudo = tr._sample_pseudo_batch()
        else:
            batch, pseudo = sample_batch(tr.rng, tr.shards, tr.batch), None
        tr.state, _ = tr._plain_step(tr.state, batch, pseudo,
                                     lam if distill else 0.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def relabel_calls(K: int, per_batch: int, rows: int,
                  pooled: bool = False) -> int:
    """Scoring calls of a relabel (core/aggregation.allgather_relabel):
    the K batches concatenated, member by member and chunk by chunk, a
    chunk `rows` sequences; a model that routes by pool (MoE) rounds a
    chunk to whole batches, at least one."""
    if pooled:
        rows = max(1, rows // per_batch) * per_batch
    return K * -(-K * per_batch // rows)


def lm_train_run(torch, np, card, mode: str) -> dict:
    """Full-width gemma3-1b (bf16, 26 layers), K members, AdamW: two EC
    rounds with `mode` pseudo-labels through Trainer.run_round, then the
    parts of a round timed.  -> the phase's row."""
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.data import lm_member_datasets
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer
    c = LM_TRAIN
    cfg = registry.get_config("gemma3-1b")
    K, B, T = c["members"], c["batch"], c["seq_len"]
    ec = ECConfig(tau=c["tau"], p_steps=c["p_steps"], lam=0.5,
                  relabel_fraction=c["relabel"], label_mode=mode,
                  top_m=c["top_m"], aggregator="ec")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train, test = lm_member_datasets(K, c["per_member"], T, cfg.vocab_size,
                                     seed=0, device="cuda")
    tr = Trainer(cfg, ec, adamw(c["lr"]), K, 0, train, test, batch_size=B,
                 seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dl.distill_loss_fwd.launches = dl.distill_loss_bwd.launches = 0
    fa.flash_attention.launches = 0
    losses, evals, round_s = [], [], []
    for _ in range(c["rounds"]):
        t0 = time.perf_counter()
        losses.append(tr.run_round())
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        evals.append(tr.evaluate())
    launches = {"fwd": dl.distill_loss_fwd.launches,
                "bwd": dl.distill_loss_bwd.launches}
    # the relabels and evals of the rounds
    flash_in_rounds = fa.flash_attention.launches
    expected = (c["rounds"] - 1) * ec.p_steps if mode == "dense" else 0
    for which, n in launches.items():
        if n != expected:
            raise AssertionError(f"gemma3-1b {mode}: distill_loss_{which} "
                                 f"launched {n} times, expected {expected}")
    for r, (loss, ev) in enumerate(zip(losses, evals)):
        if not all(math.isfinite(v) for v in [loss, *ev.values()]):
            raise AssertionError(f"round {r}: non-finite {loss}, {ev}")
        gap = ev["local_loss"] - ev["global_loss"]
        if gap < -1e-6:
            raise AssertionError(f"round {r}: Jensen gap {gap} < 0")
    # the parts of a round: training steps (no flash launch in them), a
    # relabel (the flash kernel once per layer, member and chunk)
    fa.flash_attention.launches = 0
    plain = lm_steps(torch, tr, 3, False)
    distill = lm_steps(torch, tr, 3, True)
    flash_in_steps = fa.flash_attention.launches
    if flash_in_steps:
        raise AssertionError(f"the flash kernel launched {flash_in_steps} "
                             f"times inside training steps")
    per_batch = int(c["per_member"] * c["relabel"])
    n_seq = K * per_batch
    from repro_torch.core import aggregation as agg
    rows = agg.chunk_rows({"tokens": tr.shards["tokens"][0]},
                          cfg.vocab_size)
    if rows != 16:  # the flash cases gemma3_relabel_64*'s N
        raise AssertionError(f"a relabel chunk holds {rows} sequences")
    flash_expected = cfg.n_layers * relabel_calls(K, per_batch, rows)
    if flash_in_rounds < c["rounds"] * flash_expected:  # + the evals'
        raise AssertionError(f"{c['rounds']} rounds launched the flash "
                             f"kernel {flash_in_rounds} times, fewer than "
                             f"their relabels' {flash_expected} each")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr._relabel()
    torch.cuda.synchronize()
    relabel_s = time.perf_counter() - t0
    if fa.flash_attention.launches != flash_expected:
        raise AssertionError(f"relabel launched the flash kernel "
                             f"{fa.flash_attention.launches} times, expected "
                             f"{flash_expected}")
    prof = {name: profile_steps(torch, lambda d=d: lm_steps(torch, tr, 2, d),
                                2, ["distill_", "gemm", "nvjet",
                                    "elementwise_kernel", "reduce_kernel",
                                    "flash_kernel"])
            for name, d in (("plain", False), ("distill", True))}
    peak = torch.cuda.max_memory_allocated()
    if peak >= 80e9:
        raise AssertionError(f"gemma3-1b {mode}: peak {peak} B >= 80 GB")
    # AdamW's share of a step: one update (on zero gradients: the same
    # work) timed alone by CUDA events, median of 3
    from repro_torch.common.tree import tree_map
    grads = tree_map(torch.zeros_like, tr.state["params"])
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    adamw_ms = time_ms(lambda: tr.opt.update(grads, tr.state["opt"],
                                             tr.state["params"]),
                       torch, flush, iters=3, warmup=1)
    del grads, flush
    step = {}
    for name, times in (("plain", plain), ("distill", distill)):
        ms = sorted(times)[1]
        step[name] = {"host_ms": ms, "host_ms_runs": times,
                      "device_busy_ms": prof[name]["busy_ms"],
                      "idle_share": 1.0 - prof[name]["busy_ms"] / ms,
                      "profiled_step_ms": prof[name]["wall_ms"],
                      "kernel_ms": prof[name]["name_ms"],
                      "top_kernels_ms": prof[name]["top"]}
    row = {"phase": 14, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "members": K, "batch_per_member": B,
           "seq_len": T, "per_member": c["per_member"],
           "relabel_sequences": n_seq, "tau": ec.tau,
           "p_steps": ec.p_steps, "rounds": c["rounds"], "label_mode": mode,
           "top_m": ec.top_m if mode == "topk" else None,
           "optimizer": f"adamw({c['lr']})",
           "distill_rows": K * B * T if mode == "dense" else None,
           "launch_formula": f"({c['rounds']} rounds - 1) x {ec.p_steps} "
                             f"distill steps = {expected} each way"
                             if mode == "dense" else "0: top-M labels",
           "launches": launches, "flash_launches_in_steps": flash_in_steps,
           "flash_launches_per_relabel": flash_expected,
           "flash_launches_in_rounds": flash_in_rounds,
           "round_loss": losses, "evaluate": evals,
           "jensen_gap": [e["local_loss"] - e["global_loss"] for e in evals],
           "init_s": init_s, "round_s": round_s,
           "tokens_per_s": K * B * T * ec.tau / round_s[-1],
           "plain_step_ms": step["plain"]["host_ms"],
           "distill_step_ms": step["distill"]["host_ms"], "steps": step,
           "adamw_update_device_ms": adamw_ms,
           "relabel_s": relabel_s, "max_memory_allocated": peak}
    emit(row)
    return {**launches, "flash_attention": flash_in_rounds}


def phase14(torch, np, card) -> dict:
    """Dense labels, then top-M labels on a fresh trainer once the first
    is freed; and the forward-only guards of kernels/ops.  -> the dense
    run's distillation-kernel and flash-kernel launches."""
    import gc
    forward_only_guards(torch)
    launches = lm_train_run(torch, np, card, "dense")
    gc.collect()
    torch.cuda.empty_cache()
    lm_train_run(torch, np, card, "topk")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 15: EC training of rwkv6-7b and jamba at full width
# ---------------------------------------------------------------------------

# arch: (layers kept, members, AdamW moment dtype); the rest as phase 14
SSM_TRAIN = {"rwkv6-7b": (3, 4, "float32"),
             "jamba-v0.1-52b": (2, 2, "bfloat16")}


def recurrence_launches():
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    return {"wkv6": wk.wkv6.launches, "ssm_scan": ssk.ssm_scan.launches}


def zero_recurrence_launches():
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    wk.wkv6.launches = ssk.ssm_scan.launches = 0


def ssm_train_run(torch, np, card, arch: str) -> dict:
    """One full-width recurrent model, depth cut, K members, AdamW: two
    EC rounds with dense labels through Trainer.run_round, then the
    parts of a round timed.  -> the phase's row."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.core import aggregation as agg
    from repro_torch.data import lm_member_datasets
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.models import ssm
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    from repro_torch.runtime.trainer import Trainer
    c = LM_TRAIN
    n_layers, K, moments = SSM_TRAIN[arch]
    cfg = registry.get_config(arch).with_(n_layers=n_layers)
    B, T = c["batch"], c["seq_len"]
    ec = ECConfig(tau=c["tau"], p_steps=c["p_steps"], lam=0.5,
                  relabel_fraction=c["relabel"], label_mode="dense",
                  aggregator="ec")
    kernel, mixer = ("wkv6", "rwkv") if cfg.family == "ssm" \
        else ("ssm_scan", "mamba")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train, test = lm_member_datasets(K, c["per_member"], T, cfg.vocab_size,
                                     seed=0, device="cuda")
    opt = adamw(c["lr"], moment_dtype=getattr(torch, moments))
    tr = Trainer(cfg, ec, opt, K, 0, train, test, batch_size=B, seed=0,
                 device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p[0].numel() for p in tree_leaves(tr.state["params"]))
    dl.distill_loss_fwd.launches = dl.distill_loss_bwd.launches = 0
    zero_recurrence_launches()
    losses, evals, round_s = [], [], []
    for _ in range(c["rounds"]):
        t0 = time.perf_counter()
        losses.append(tr.run_round())
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        evals.append(tr.evaluate())
    launches = {"fwd": dl.distill_loss_fwd.launches,
                "bwd": dl.distill_loss_bwd.launches}
    in_rounds = recurrence_launches()
    expected = (c["rounds"] - 1) * ec.p_steps
    for which, n in launches.items():
        if n != expected:
            raise AssertionError(f"{arch}: distill_loss_{which} launched "
                                 f"{n} times, expected {expected}")
    for r, (loss, ev) in enumerate(zip(losses, evals)):
        if not all(math.isfinite(v) for v in [loss, *ev.values()]):
            raise AssertionError(f"{arch} round {r}: non-finite {loss}, {ev}")
        gap = ev["local_loss"] - ev["global_loss"]
        if gap < -1e-6:
            raise AssertionError(f"{arch} round {r}: Jensen gap {gap} < 0")
    # training steps launch no recurrence kernel
    zero_recurrence_launches()
    plain = lm_steps(torch, tr, 3, False)
    distill = lm_steps(torch, tr, 3, True)
    in_steps = recurrence_launches()
    if any(in_steps.values()):
        raise AssertionError(f"{arch}: recurrence kernels launched inside "
                             f"training steps: {in_steps}")
    # a relabel: the kernel once per layer of its mixer, scoring call
    # and MAMBA_CHUNK piece
    per_batch = int(c["per_member"] * c["relabel"])
    rows = agg.chunk_rows({"tokens": tr.shards["tokens"][0]},
                          cfg.vocab_size)
    layers = sum(count * sum(sp.mixer == mixer for sp in specs)
                 for count, specs in cfg.segments())
    pieces = -(-T // ssm.MAMBA_CHUNK) if mixer == "mamba" else 1
    calls = relabel_calls(K, per_batch, rows, steps.routes_by_pool(cfg))
    relabel_expected = layers * calls * pieces
    if in_rounds[kernel] < c["rounds"] * relabel_expected:  # + the evals'
        raise AssertionError(f"{arch}: {c['rounds']} rounds launched "
                             f"{kernel} {in_rounds[kernel]} times, fewer "
                             f"than their relabels' {relabel_expected} each")
    zero_recurrence_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr._relabel()
    torch.cuda.synchronize()
    relabel_s = time.perf_counter() - t0
    in_relabel = recurrence_launches()
    if in_relabel[kernel] != relabel_expected:
        raise AssertionError(f"{arch}: a relabel launched {kernel} "
                             f"{in_relabel[kernel]} times, expected "
                             f"{relabel_expected}")
    prof = {name: profile_steps(torch, lambda d=d: lm_steps(torch, tr, 2, d),
                                2, ["distill_", "gemm", "nvjet",
                                    "elementwise_kernel", "reduce_kernel"])
            for name, d in (("plain", False), ("distill", True))}
    peak = torch.cuda.max_memory_allocated()
    if peak >= 80e9:
        raise AssertionError(f"{arch}: peak {peak} B >= 80 GB")
    # AdamW's share of a step: one update timed alone by CUDA events,
    # median of 3, with the params as their own gradients (the same work
    # as any gradients, and no second copy of them beside the state)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    p = tr.state["params"]
    adamw_ms = time_ms(lambda: tr.opt.update(p, tr.state["opt"], p),
                       torch, flush, iters=3, warmup=1)
    del flush
    step = {}
    for name, times in (("plain", plain), ("distill", distill)):
        ms = sorted(times)[1]
        step[name] = {"host_ms": ms, "host_ms_runs": times,
                      "device_busy_ms": prof[name]["busy_ms"],
                      "idle_share": 1.0 - prof[name]["busy_ms"] / ms,
                      "profiled_step_ms": prof[name]["wall_ms"],
                      "kernel_ms": prof[name]["name_ms"],
                      "top_kernels_ms": prof[name]["top"]}
    row = {"phase": 15, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params_per_member": n_params,
           "members": K, "batch_per_member": B, "seq_len": T,
           "per_member": c["per_member"], "relabel_sequences": K * per_batch,
           "tau": ec.tau, "p_steps": ec.p_steps, "rounds": c["rounds"],
           "label_mode": "dense",
           "optimizer": f"adamw({c['lr']}, moments {moments})",
           "distill_rows": K * B * T,
           "launch_formula": f"({c['rounds']} rounds - 1) x {ec.p_steps} "
                             f"distill steps = {expected} each way",
           "launches": launches, "recurrence_launches_in_steps": in_steps,
           "recurrence_kernel": kernel,
           "relabel_formula": f"{layers} {mixer} layers x {calls} calls "
                              f"({K} members on {K} batches of "
                              f"{per_batch} sequences, at most {rows} a "
                              f"chunk) x {pieces} pieces = "
                              f"{relabel_expected}",
           "launches_per_relabel": in_relabel[kernel],
           "launches_in_rounds": in_rounds[kernel],
           "round_loss": losses, "evaluate": evals,
           "jensen_gap": [e["local_loss"] - e["global_loss"] for e in evals],
           "init_s": init_s, "round_s": round_s,
           "tokens_per_s": K * B * T * ec.tau / round_s[-1],
           "plain_step_ms": step["plain"]["host_ms"],
           "distill_step_ms": step["distill"]["host_ms"], "steps": step,
           "adamw_update_device_ms": adamw_ms,
           "relabel_s": relabel_s, "max_memory_allocated": peak}
    emit(row)
    return {**launches, kernel: in_rounds[kernel]}


def forward_only_guards(torch):
    """kernels/ops refuses, on the card, an input that requires grad for
    each forward-only kernel: flash attention, wkv6, ssm_scan."""
    from repro_torch.kernels import ops
    q = torch.randn(2, 8, 2, 32, device="cuda", requires_grad=True)
    r = torch.randn(2, 4, 2, 8, device="cuda", requires_grad=True)
    a = torch.rand(2, 4, 8, 4, device="cuda", requires_grad=True)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, q.detach(),
                                                       q.detach()),
        "wkv6": lambda: ops.wkv6(r, r.detach(), r.detach(), -r.detach().abs(),
                                 torch.zeros(1, 2, 8, device="cuda"),
                                 torch.zeros(1, 2, 2, 8, 8, device="cuda")),
        "ssm_scan": lambda: ops.ssm_scan(a, a.detach(),
                                         torch.zeros(1, 2, 8, 4,
                                                     device="cuda"))}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took an input that requires grad")


def phase15(torch, np, card) -> dict:
    """rwkv6-7b, then jamba once the first is freed.  -> each model's
    distillation-kernel and recurrence-kernel launches."""
    import gc
    out = {}
    for arch in SSM_TRAIN:
        out[arch] = ssm_train_run(torch, np, card, arch)
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 22: the member axis across ranks
# ---------------------------------------------------------------------------

# 22a: gemma3-1b in f32, K = 4, paged, phase 2's prompts; two ranks hold
# 2 members each.  22b: phase 14's training at K = 2, a member a rank
# along the ring's axis, 2 data ranks a member.  22a runs gemma3-1b cut
# to 13 of its 26 layers (two 5:1 periods and one local layer): its runs
# are host-bound, and the cut keeps the whole script inside the call's
# time with phase 23.  22b's four processes share the card and double
# their members at the reshard: at 13 layers the grown state did not fit
# (out of memory, 79 GB in use), so 22b runs 7 layers (one 5:1 period and
# one local layer)
MESH = dict(members=4, ranks=2, lp_tol=1e-4, profile=3, timeout=900.0,
            n_layers=13)
RING = dict(LM_TRAIN, members=2, rounds=3, dense_rounds=2, timeout=900.0,
            n_layers=7, data_ranks=2, grown=4)
RING_TOPK_SENT = None   # 22b's top-64 ring's bytes sent (phase 24 reads)


def mesh_cfg():
    from repro_torch.configs import registry
    return registry.get_config("gemma3-1b").with_(
        dtype="float32", n_layers=MESH["n_layers"])


def mesh_prompts(np, vocab: int) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in SERVE["prompt_lens"]]


def mesh_engine(cfg, params, mesh):
    from repro_torch.serving.engine import EnsembleEngine
    return EnsembleEngine(cfg, params, n_slots=SERVE["slots"],
                          max_prompt=SERVE["max_prompt"],
                          max_out=SERVE["max_out"], paged=True,
                          page_size=SERVE["page"], device="cuda", mesh=mesh)


def mesh_calls(eng) -> int:
    """Prefill calls of a generate over phase 2's prompts."""
    return sum(-(-n // eng.prefill_chunk) for n in SERVE["prompt_lens"])


def collective_ms(prof, n: int) -> float:
    """Host ms a step in the process group's all-reduces (the Eqn-6
    fusion's), from their spans: the c10d op's, or, where a build names
    it so, the backend's (the larger sum, not both: they nest)."""
    ops = [e for e in prof.key_averages() if "allreduce" in e.key.lower()
           or "all_reduce" in e.key.lower()]
    c10d = sum(e.cpu_time_total for e in ops if e.key.startswith("c10d"))
    backend = sum(e.cpu_time_total for e in ops
                  if e.key.startswith(("gloo", "nccl")))
    return max(c10d, backend) / n / 1e3


def mesh_profile(torch, run, n: int) -> dict:
    """Device busy ms a step (the card's activity) and host ms a step in
    collectives (the host's ops), over run(), which takes n steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3
    return {"busy_ms": busy, "collective_ms": collective_ms(prof, n)}


def mesh_drive(torch, np, eng, prompts, n_new: int,
               scheduler: bool = True) -> dict:
    """The leader's run: a warm-up generate, the measured generate (both
    kernels' launches from 0, every fused log-prob kept), the same
    requests again with the decode steps timed and 3 of them profiled,
    then (scheduler) phase 21a's 8 requests through Scheduler.run.  A
    follower replays each call (mesh_follow counts them)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.scheduler import Scheduler
    eng.generate(prompts, max_new=2)
    pa.paged_attention.launches = fa.flash_attention.launches = 0
    rec = []
    fuse = eng._fuse

    def watch(logits, member_lp=None):
        lp = fuse(logits, member_lp=member_lp)
        rec.append(lp)
        return lp

    eng._fuse = watch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del eng._fuse
    launches = {"paged_attention": pa.paged_attention.launches,
                "flash_attention": fa.flash_attention.launches}
    calls = [-(-len(p) // eng.prefill_chunk) for p in prompts]
    ends = np.cumsum(calls) - 1
    steps = rec[sum(calls):]
    lps = [torch.stack([rec[ends[i]][0]] + [steps[s][i]
                                            for s in range(n_new - 1)])
           .cpu().numpy() for i in range(len(prompts))]
    del rec, steps
    eng.update_slots(release=range(eng.n_slots),
                     admits=[(i, p, n_new) for i, p in enumerate(prompts)])
    for i, n in enumerate(calls):
        for _ in range(n):
            eng.prefill(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_new - 1):
        eng.step()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / (n_new - 1) * 1e3
    prof = mesh_profile(torch, lambda: [eng.step()
                                        for _ in range(MESH["profile"])],
                        MESH["profile"])
    out = {"outs": outs, "lps": lps, "launches": launches,
           "generate_s": gen_s, "decode_ms_per_step": decode_ms, **prof}
    if not scheduler:
        return out
    jobs = [(prompts[i % 4], n_new) for i in range(NET["requests"])]
    sched = Scheduler(eng)
    rids = [sched.submit(t, m) for t, m in jobs]
    t0 = time.perf_counter()
    comps = sched.run()
    sched_s = time.perf_counter() - t0
    eng.assert_pool_whole()
    return {**out, "scheduler": [comps[r].tokens for r in rids],
            "scheduler_s": sched_s}


def mesh_follow(torch, eng, n_new: int) -> dict:
    """A follower's side of mesh_drive: replays the same calls, counts
    its own launches over the measured generate, times its own decode
    steps and profiles the same 3, then follows until close()."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    calls = mesh_calls(eng)
    eng.follow(calls + 2)                       # the warm-up generate
    pa.paged_attention.launches = fa.flash_attention.launches = 0
    eng.follow(1 + calls + n_new - 1)           # the measured generate
    launches = {"paged_attention": pa.paged_attention.launches,
                "flash_attention": fa.flash_attention.launches}
    eng.follow(1 + calls)                       # admit and prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.follow(n_new - 1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / (n_new - 1) * 1e3
    prof = mesh_profile(torch, lambda: eng.follow(MESH["profile"]),
                        MESH["profile"])
    eng.follow()                                # the Scheduler, close
    return {"launches": launches, "decode_ms_per_step": decode_ms, **prof}


def mesh_serve_rank(rank: int, n_new: int) -> dict:
    """One rank of 22a's 2-rank world: full-width gemma3-1b at K = 4,
    this rank's 2 members (the full stack is made on the card from the
    seed and dropped once the engine holds its rows)."""
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.common import sharding as shd
    from repro_torch.models import transformer as tf
    cfg = mesh_cfg()
    mesh = shd.local_mesh(MESH["ranks"], 1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = tf.init(cfg, seed=0, device="cuda", members=MESH["members"])
    eng = mesh_engine(cfg, params, mesh)
    del params
    torch.cuda.empty_cache()
    prompts = mesh_prompts(np, cfg.vocab_size)
    if shd.is_leader(mesh):
        out = mesh_drive(torch, np, eng, prompts, n_new)
        eng.close()
    else:
        out = mesh_follow(torch, eng, n_new)
    st = eng.state
    out.update(rank=rank, backend=torch.distributed.get_backend(),
               device=torch.cuda.current_device(),
               rows=[eng._rows.start, eng._rows.stop],
               held={"out": st.out.cpu().numpy(),
                     "n_gen": st.n_gen.cpu().numpy()},
               cache_bytes=eng.cache_bytes(),
               replay_errors=eng.replay_errors,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return out


def phase22_serve(torch, np, card) -> dict:
    """22a: the reference run (mesh=None), then the mesh path at world
    size 1 under NCCL in this process, then 2 ranks on the card under
    gloo (and under NCCL on two cards where there are two), each held
    to the reference.  -> the 2-rank leader's launches."""
    import gc

    import torch.distributed as dist
    from repro_torch.common import sharding as shd
    from repro_torch.models import transformer as tf
    cfg, n_new = mesh_cfg(), SERVE["new_tokens"]
    prompts = mesh_prompts(np, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init(cfg, seed=0, device="cuda", members=MESH["members"])
    eng = mesh_engine(cfg, params, None)
    ref = mesh_drive(torch, np, eng, prompts, n_new)
    ref["cache_bytes"] = eng.cache_bytes()
    ref["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    n_paged = n_paged_layers(cfg, eng.max_seq, tf)
    n_attn = attention_layers(cfg)
    calls = mesh_calls(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    margins = []
    for lp in ref["lps"]:
        top = np.sort(lp, axis=-1)[:, -2:]
        margins.append(top[:, 1] - top[:, 0])
    want = {"paged_attention": n_paged * (n_new - 1),
            "flash_attention": n_attn * calls}
    formula = {"paged_attention": f"{n_paged} paged layers x ({n_new} - 1) "
                                  f"decode steps = {want['paged_attention']}"
                                  f" a rank",
               "flash_attention": f"{n_attn} attention layers x {calls} "
                                  f"prefill calls = "
                                  f"{want['flash_attention']} a rank"}

    def held_to_ref(run, what: str) -> dict:
        """The run's tokens and fused log-probs against the reference's;
        its launches against the formula.  -> steps compared, the
        largest log-prob gap."""
        if run["launches"] != want:
            raise AssertionError(f"{what}: launches {run['launches']}, "
                                 f"expected {formula}")
        compared, gap = [], 0.0
        for i, (toks, lp) in enumerate(zip(run["outs"], run["lps"])):
            n = margin_check(np, toks, ref["outs"][i], margins[i],
                             f"{what} prompt {i}")
            compared.append(n)
            d = float(np.abs(lp[:n + 1] - ref["lps"][i][:n + 1]).max())
            if d > MESH["lp_tol"]:
                raise AssertionError(f"{what} prompt {i}: fused log-probs "
                                     f"{d} from the reference's")
            gap = max(gap, d)
        for i, (toks, r) in enumerate(zip(run.get("scheduler", ()),
                                          ref["scheduler"])):
            margin_check(np, toks, r, margins[i % 4],
                         f"{what} Scheduler request {i}")
        return {"steps_compared": compared, "max_lp_gap": gap}

    # the mesh path at world size 1: a 1-rank NCCL group, a 1x1 mesh
    mesh = shd.local_mesh(MESH["ranks"], 1, device="cuda")
    eng = mesh_engine(cfg, params, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    one = mesh_drive(torch, np, eng, prompts, n_new, scheduler=False)
    one_check = held_to_ref(one, "world 1 (NCCL)")
    if eng.cache_bytes() != ref["cache_bytes"]:
        raise AssertionError("a 1x1 mesh's pool is not the whole pool")
    eng.close()
    del eng
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"gloo_1_card": dict(backend="gloo")}
    if torch.cuda.device_count() >= 2:
        runs["nccl_2_cards"] = dict(backend="nccl")
    rows = {}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        ranks = shd.spawn(mesh_serve_rank, MESH["ranks"], (n_new,),
                          device="cuda", timeout=MESH["timeout"], **kw)
        world_s = time.perf_counter() - t0
        lead = ranks[0]
        check = held_to_ref(lead, f"{name} leader")
        for r in ranks:
            if r["launches"] != want:
                raise AssertionError(f"{name} rank {r['rank']}: launches "
                                     f"{r['launches']}, expected {formula}")
            for key in ("out", "n_gen"):
                if not np.array_equal(r["held"][key], lead["held"][key]):
                    raise AssertionError(f"{name} rank {r['rank']}'s "
                                         f"tokens differ from rank 0's")
            if 2 * r["cache_bytes"] != ref["cache_bytes"]:
                raise AssertionError(f"{name} rank {r['rank']}: cache "
                                     f"{r['cache_bytes']} B, not half of "
                                     f"{ref['cache_bytes']}")
            if r["replay_errors"]:
                raise AssertionError(f"{name} rank {r['rank']} replay "
                                     f"errors {r['replay_errors']}")
        rows[name] = {
            "backend": lead["backend"], "world_s": world_s,
            "devices": [r["device"] for r in ranks],
            "member_rows": [r["rows"] for r in ranks], **check,
            "generate_s": lead["generate_s"],
            "decode_ms_per_step": [r["decode_ms_per_step"] for r in ranks],
            "device_busy_ms_per_step": [r["busy_ms"] for r in ranks],
            "device_idle_share": [1.0 - r["busy_ms"]
                                  / r["decode_ms_per_step"] for r in ranks],
            "collective_ms_per_step": [r["collective_ms"] for r in ranks],
            "scheduler_s": lead["scheduler_s"],
            "cache_bytes_per_rank": [r["cache_bytes"] for r in ranks],
            "max_memory_allocated": [r["max_memory_allocated"]
                                     for r in ranks],
            "launches_per_rank": [r["launches"] for r in ranks]}
        del ranks
    emit({"phase": 22, "part": "a", "card": card, "arch": cfg.name,
          "dtype": cfg.dtype, "n_layers": cfg.n_layers,
          "members": MESH["members"], "slots": SERVE["slots"],
          "prompt_lens": SERVE["prompt_lens"], "new_tokens": n_new,
          "requests": NET["requests"], "launch_formula": formula,
          "runs": ["reference (mesh=None)", "world 1 (NCCL)", *runs],
          "reference": {"decode_ms_per_step": ref["decode_ms_per_step"],
                        "device_busy_ms_per_step": ref["busy_ms"],
                        "device_idle_share": 1.0 - ref["busy_ms"]
                        / ref["decode_ms_per_step"],
                        "generate_s": ref["generate_s"],
                        "scheduler_s": ref["scheduler_s"],
                        "cache_bytes": ref["cache_bytes"],
                        "max_memory_allocated":
                            ref["max_memory_allocated"]},
          "world_1_nccl": {**one_check,
                           "decode_ms_per_step": one["decode_ms_per_step"],
                           "device_busy_ms_per_step": one["busy_ms"],
                           "collective_ms_per_step": one["collective_ms"]},
          **rows, "sample": [int(x) for x in ref["outs"][0][:8]]})
    return rows["gloo_1_card"]["launches_per_rank"][0]


def ring_trainer(mesh):
    """Phase 14's gemma3-1b trainer at K = 2 over `mesh` (a member a
    rank), dense labels, the ring protocol."""
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.data import lm_member_datasets
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer
    c = RING
    cfg = registry.get_config("gemma3-1b").with_(n_layers=c["n_layers"])
    ec = ECConfig(tau=c["tau"], p_steps=c["p_steps"], lam=0.5,
                  relabel_fraction=c["relabel"], label_mode="dense",
                  top_m=c["top_m"], aggregator="ec", protocol="ring")
    train, test = lm_member_datasets(c["members"], c["per_member"],
                                     c["seq_len"], cfg.vocab_size, seed=0,
                                     device="cuda")
    return Trainer(cfg, ec, adamw(c["lr"]), c["members"], 0, train, test,
                   batch_size=c["batch"], seed=0, device="cuda", mesh=mesh)


def ring_train_rank(rank: int) -> dict:
    """One rank of 22b (local_mesh(2, 2): a member a rank along the ring's
    axis, each member's rows split over 2 data ranks): two dense EC
    rounds over the ring, then one with top-64 labels, evaluate() after
    the dense rounds and after the last, the params' digest after every
    round; then, on this rank's share of one relabel subset, the ring
    against the mesh all-gather (dense), both timed, and the ring at
    top-64, the bytes each ring sent; then 3 plain steps timed on the
    host and profiled; then reshard 2 -> 4 over the mesh and one
    all-gather round, evaluate() after it."""
    import dataclasses

    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.common import sharding as shd
    from repro_torch.core import aggregation as agg
    from repro_torch.data import sample_batch, sample_relabel_subset
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.frontend.replica import param_digest
    c = RING
    mesh = shd.local_mesh(c["data_ranks"], c["members"], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    tr = ring_trainer(mesh)
    cfg = tr.cfg
    dl.distill_loss_fwd.launches = dl.distill_loss_bwd.launches = 0
    fa.flash_attention.launches = 0
    losses, evals, round_s, digests = [], [], [], []
    for r in range(c["rounds"]):
        if r == c["dense_rounds"]:
            tr.ec = dataclasses.replace(tr.ec, label_mode="topk")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.run_round())
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        digests.append(param_digest(tr.state["params"]))
        if r in (c["dense_rounds"] - 1, c["rounds"] - 1):
            t0 = time.perf_counter()
            evals.append(tr.evaluate())
            evals[-1]["eval_s"] = time.perf_counter() - t0
    launches = {"fwd": dl.distill_loss_fwd.launches,
                "bwd": dl.distill_loss_bwd.launches,
                "flash_attention": fa.flash_attention.launches}
    subset, _ = sample_relabel_subset(np.random.default_rng(7), tr.shards,
                                      c["relabel"], of=tr._of)
    share = tr._split(subset["tokens"].shape[1], "relabel rows")
    subset = {k: v[:, share] for k, v in subset.items()}
    params = tr.state["params"]
    V = cfg.vocab_size
    relabel = {}
    for name, mode in (("ring", "dense"), ("allgather", "dense"),
                       ("ring_topk", "topk")):
        ec = dataclasses.replace(tr.ec, label_mode=mode)
        fa.flash_attention.launches = 0
        shd.ppermute.bytes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "allgather":
            out = agg.allgather_relabel(params, subset, tr._logits, ec,
                                        n_out=V, mesh=mesh, axis="data")
        else:
            out = agg.ring_relabel(mesh, params, subset, tr._logits, ec,
                                   axis="data", n_out=V)
        torch.cuda.synchronize()
        relabel[name] = {"s": time.perf_counter() - t0,
                         "flash_launches": fa.flash_attention.launches,
                         "permute_bytes": shd.ppermute.bytes}
        if name != "ring_topk":
            relabel[name]["targets"] = out
        del out
    gap = float((relabel["ring"].pop("targets")
                 - relabel["allgather"].pop("targets")).abs().max())
    n, T = subset["tokens"].shape[1:]
    chunk = agg.chunk_rows({"tokens": subset["tokens"][0]}, V)
    tok_bytes = n * T * subset["tokens"].element_size()
    hop = {"tokens_bytes": tok_bytes,
           "dense_accumulator_bytes": n * T * V * 4,
           "topk_accumulator_bytes": n * T * (c["top_m"] * 8 + 4),
           "ring_dense_sent": relabel["ring"]["permute_bytes"],
           "ring_topk_sent": relabel["ring_topk"]["permute_bytes"]}
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = tr._mine(sample_batch(tr.rng, tr.shards, tr.batch,
                                      of=tr._of))
        tr.state, _ = tr._plain_step(tr.state, batch, None, 0.0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profile_steps(torch, lambda: [tr._plain_step(
        tr.state, tr._mine(sample_batch(tr.rng, tr.shards, tr.batch,
                                        of=tr._of)),
        None, 0.0) for _ in range(2)], 2)
    peak = torch.cuda.max_memory_allocated()
    # four processes share the card: hand the cached blocks back before
    # the state doubles
    del subset, params, batch
    torch.cuda.empty_cache()
    # reshard past one member a rank: the ring would refuse, so the round
    # after it takes the all-gather
    tr.ec = dataclasses.replace(tr.ec, protocol="allgather")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.reshard(c["grown"], torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    grown = {"reshard_s": reshard_s, "k_local": tr.K_local,
             "loss": tr.run_round(), "eval": tr.evaluate(),
             "digest": param_digest(tr.state["params"])}
    return {"rank": rank, "backend": torch.distributed.get_backend(),
            "member": shd.axis_index(mesh, "data"),
            "data_rank": shd.axis_index(mesh, "member"),
            "losses": losses, "evals": evals, "round_s": round_s,
            "digests": digests, "grown": grown,
            "launches": launches, "relabel": relabel,
            "ring_vs_allgather_max_abs": gap, "hop": hop,
            "relabel_rows": n, "seq_len": T,
            "chunk_rows": chunk, "n_layers": cfg.n_layers,
            "step_host_ms": times,
            "step_busy_ms": prof["busy_ms"],
            "max_memory_allocated_before_reshard": peak,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def phase22_train(torch, np, card) -> dict:
    """22b: the EC round on the card under gloo over a 2 x 2 mesh, a
    member a rank along the ring's axis, 2 data ranks a member.  -> the
    first rank's launches and the topk ring's bytes sent."""
    from repro_torch.common import sharding as shd
    c = RING
    K, D = c["members"], c["data_ranks"]
    t0 = time.perf_counter()
    ranks = shd.spawn(ring_train_rank, K * D, device="cuda",
                      backend="gloo", timeout=c["timeout"])
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    n, rows, L = r0["relabel_rows"], r0["chunk_rows"], r0["n_layers"]
    ring_want = L * K * -(-n // rows)
    ag_want = L * -(-K * n // rows)
    distill_want = (c["rounds"] - 1) * c["p_steps"]
    by_member = {}
    for r in ranks:
        by_member.setdefault(r["member"], []).append(r)
    for reps in by_member.values():
        if len(reps) != D or any(x["digests"] != reps[0]["digests"]
                                 or x["grown"]["digest"]
                                 != reps[0]["grown"]["digest"]
                                 for x in reps):
            raise AssertionError(
                f"22b: a member's data replicas differ: "
                f"{[(x['rank'], x['digests'], x['grown']['digest']) for x in reps]}")
    for r in ranks:
        what = f"22b rank {r['rank']}"
        g = r["grown"]
        vals = [*r["losses"], *(v for e in r["evals"] for v in e.values()),
                g["loss"], *g["eval"].values()]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{what}: non-finite {r['losses']}, "
                                 f"{r['evals']}, {g}")
        for e in (*r["evals"], g["eval"]):
            if e["local_loss"] - e["global_loss"] < -1e-6:
                raise AssertionError(f"{what}: Jensen gap < 0: {e}")
        if g["k_local"] != c["grown"] // K:
            raise AssertionError(f"{what}: {g['k_local']} members after "
                                 f"the reshard to {c['grown']}")
        if r["ring_vs_allgather_max_abs"] > 1e-4:
            raise AssertionError(f"{what}: ring targets "
                                 f"{r['ring_vs_allgather_max_abs']} from "
                                 f"the all-gather's")
        for which in ("fwd", "bwd"):
            if r["launches"][which] != distill_want:
                raise AssertionError(
                    f"{what}: distill_loss_{which} launched "
                    f"{r['launches'][which]} times, expected "
                    f"({c['rounds']} rounds - 1) x {c['p_steps']}")
        got = {k: r["relabel"][k]["flash_launches"]
               for k in ("ring", "allgather", "ring_topk")}
        if got != {"ring": ring_want, "allgather": ag_want,
                   "ring_topk": ring_want}:
            raise AssertionError(f"{what}: flash launches {got}, expected "
                                 f"ring {ring_want}, all-gather {ag_want}")
        if r["launches"]["flash_attention"] < c["rounds"] * ring_want:
            raise AssertionError(f"{what}: the rounds launched flash "
                                 f"{r['launches']['flash_attention']} "
                                 f"times, fewer than their relabels'")
        h = r["hop"]
        for mode in ("dense", "topk"):
            # K - 1 hops of rows and accumulator, then the home hop
            want = (K - 1) * h["tokens_bytes"] \
                + K * h[f"{mode}_accumulator_bytes"]
            if h[f"ring_{mode}_sent"] != want:
                raise AssertionError(f"{what}: the {mode} ring sent "
                                     f"{h[f'ring_{mode}_sent']} bytes, "
                                     f"want {want}")
    emit({"phase": 22, "part": "b", "card": card, "arch": "gemma3-1b",
          "dtype": "bfloat16", "n_layers": c["n_layers"], "members": K,
          "data_ranks": D, "ranks": len(ranks),
          "backend": r0["backend"], "protocol": "ring",
          "batch_per_member": c["batch"], "seq_len": c["seq_len"],
          "per_member": c["per_member"], "relabel_sequences_a_rank": n,
          "tau": c["tau"], "p_steps": c["p_steps"], "rounds": c["rounds"],
          "label_modes": ["dense"] * c["dense_rounds"]
          + ["topk"] * (c["rounds"] - c["dense_rounds"]),
          "top_m": c["top_m"], "world_s": world_s,
          "flash_formula": {
              "ring": f"{L} layers x {K} batches x ceil({n} / {rows}) "
                      f"chunks = {ring_want} a rank ({n} rows: its share "
                      f"of a member's relabel rows over {D} data ranks)",
              "allgather": f"{L} layers x ceil({K} x {n} / {rows}) "
                           f"chunks = {ag_want} a rank"},
          "distill_formula": f"({c['rounds']} rounds - 1) x "
                             f"{c['p_steps']} = {distill_want} each way "
                             f"a rank",
          "round_loss": r0["losses"], "evaluate": r0["evals"],
          "jensen_gap": [e["local_loss"] - e["global_loss"]
                         for e in r0["evals"]],
          "replicas_bitwise_equal": True,
          "ring_vs_allgather_max_abs": [r["ring_vs_allgather_max_abs"]
                                        for r in ranks],
          "relabel_s": {k: [r["relabel"][k]["s"] for r in ranks]
                        for k in ("ring", "allgather", "ring_topk")},
          "hop_bytes": r0["hop"],
          "round_s": [r["round_s"] for r in ranks],
          "step_host_ms": [r["step_host_ms"] for r in ranks],
          "step_busy_ms": [r["step_busy_ms"] for r in ranks],
          "step_idle_share": [1.0 - r["step_busy_ms"]
                              / sorted(r["step_host_ms"])[1]
                              for r in ranks],
          "grown": {"members": c["grown"], "protocol": "allgather",
                    "reshard_s": [r["grown"]["reshard_s"] for r in ranks],
                    "round_loss": r0["grown"]["loss"],
                    "evaluate": r0["grown"]["eval"],
                    "jensen_gap": r0["grown"]["eval"]["local_loss"]
                    - r0["grown"]["eval"]["global_loss"]},
          "launches_per_rank": [r["launches"] for r in ranks],
          "max_memory_allocated_before_reshard": [
              r["max_memory_allocated_before_reshard"] for r in ranks],
          "max_memory_allocated": [r["max_memory_allocated"]
                                   for r in ranks]})
    global RING_TOPK_SENT
    RING_TOPK_SENT = {"bytes": r0["hop"]["ring_topk_sent"], "rows": n,
                      "seq_len": r0["seq_len"], "members": K}
    return r0["launches"]


def phase22(torch, np, card) -> dict:
    """The member axis across ranks: 22a serving, 22b training.  -> each
    part's launches on its first rank."""
    return {"serve": phase22_serve(torch, np, card),
            "train": phase22_train(torch, np, card)}


# ---------------------------------------------------------------------------
# phase 23: the paper's experiments and the examples
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def trainer_tap():
    """Every Trainer made while open, as a record: its K and p_steps, each
    round's aggregator (read at the round: table1's S-DNN switches it
    after construction), loss and distill launches each way, and each
    evaluate()'s result."""
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.runtime.trainer import Trainer
    runs = []
    real = {name: getattr(Trainer, name)
            for name in ("__init__", "run_round", "evaluate")}

    def init(self, *a, **kw):
        real["__init__"](self, *a, **kw)
        self._tap = {"K": self.K, "p_steps": self.ec.p_steps,
                     "labels": self.ec.label_mode, "rounds": [],
                     "evals": []}
        runs.append(self._tap)

    def run_round(self, *a, **kw):
        f0 = dl.distill_loss_fwd.launches
        b0 = dl.distill_loss_bwd.launches
        loss = real["run_round"](self, *a, **kw)
        self._tap["rounds"].append({
            "aggregator": self.ec.aggregator, "loss": loss,
            "fwd": dl.distill_loss_fwd.launches - f0,
            "bwd": dl.distill_loss_bwd.launches - b0})
        return loss

    def evaluate(self, *a, **kw):
        out = real["evaluate"](self, *a, **kw)
        self._tap["evals"].append(dict(out, aggregator=self.ec.aggregator))
        return out

    Trainer.__init__, Trainer.run_round, Trainer.evaluate = \
        init, run_round, evaluate
    try:
        yield runs
    finally:
        for name, fn in real.items():
            setattr(Trainer, name, fn)


def finite_numbers(obj) -> list:
    """Every float in a nest of dicts, lists and tuples."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in finite_numbers(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in finite_numbers(v)]
    return [obj] if isinstance(obj, float) else []


def twin_path(torch, name: str, fn) -> dict:
    """Drive one twin on the card with every kernel's count set to 0
    just before and read just after; its stdout is kept.  Per trainer it
    made: the distill launches each way must equal (rounds - 1) x p_steps
    for an EC run with dense labels and 0 for an MA one or top-M labels
    (their Eqn-9 loss is not the fused kernel's), every EC evaluate()
    keep the Jensen gap >= -1e-6, and every number be finite."""
    import io
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    kernels = {"fwd": dl.distill_loss_fwd, "bwd": dl.distill_loss_bwd,
               "flash_attention": fa.flash_attention,
               "paged_attention": pa.paged_attention}
    buf = io.StringIO()
    with trainer_tap() as runs:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
    formulas, gaps = [], []
    for i, run in enumerate(runs):
        aggs = {r["aggregator"] for r in run["rounds"]}
        n = len(run["rounds"])
        dense = run["labels"] == "dense"
        want = (n - 1) * run["p_steps"] if aggs == {"ec"} and n and dense \
            else 0
        formulas.append(f"{'/'.join(sorted(aggs))} K={run['K']} "
                        f"{run['labels']}: "
                        + (f"({n} rounds - 1) x {run['p_steps']} = {want}"
                           if want else "0"))
        for way in ("fwd", "bwd"):
            got = sum(r[way] for r in run["rounds"])
            if got != want:
                raise AssertionError(f"{name} trainer {i}: distill_loss_"
                                     f"{way} launched {got} times, "
                                     f"expected {formulas[-1]}")
        for ev in run["evals"]:
            if ev["aggregator"] == "ec":
                gap = ev["local_loss"] - ev["global_loss"]
                gaps.append(gap)
                if gap < -1e-6:
                    raise AssertionError(f"{name} trainer {i}: Jensen gap "
                                         f"{gap} < 0")
    total = {way: sum(r[way] for run in runs for r in run["rounds"])
             for way in ("fwd", "bwd")}
    if total != {way: launches[way] for way in total}:
        raise AssertionError(f"{name}: distill launches {launches} outside "
                             f"its trainers' rounds {total}")
    numbers = finite_numbers([result, runs])
    if not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"{name}: a number is not finite: {result}")
    return {"seconds": seconds, "launches": launches,
            "launch_formula": formulas, "jensen_gaps": gaps,
            "trainers": len(runs), "numbers_checked": len(numbers),
            "result": result, "printed": buf.getvalue().splitlines()}


def phase23(torch, np, card) -> dict:
    """The paper's experiments (repro_torch/paper) and the examples
    (repro_torch/examples) through their entry points on the card: Table
    1 and Figures 1-2 at --fast, the faithful run at --fast (K = 4, the
    paper's NiN at 32x32), the quickstart, and at its reduced size the
    LM example (top-8 labels, a checkpoint and resume) and the serving
    example on one device with the paged demo and the frontend.  The
    paper's orderings are printed, not asserted: on synthetic data they
    are findings.  -> each path's launches."""
    import tempfile

    from repro_torch.examples import quickstart, serve_ensemble, train_ec_dnn
    from repro_torch.paper import faithful, fig12, table1
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        paths = {
            "paper_nin table1": lambda: table1.main(["--fast"]),
            "paper_nin fig12": lambda: fig12.main(["--fast"]),
            "paper_nin faithful": lambda: {
                f"{a}-K{k}": r for (a, k), r in
                faithful.main(["--fast"]).items()},
            "nin quickstart": lambda: quickstart.main([]),
            "gemma3-1b reduced train_ec_dnn": lambda: [
                train_ec_dnn.main(["--rounds", str(r), "--ckpt", ckpt])
                for r in (2, 3)],
            "deepseek-7b reduced serve_ensemble": lambda:
                serve_ensemble.main(["--mesh", "", "--paged",
                                     "--frontend"])}
        out = {name: twin_path(torch, name, fn) for name, fn in paths.items()}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    lm = out["gemma3-1b reduced train_ec_dnn"]
    if [r["start_round"] for r in lm["result"]] != [0, 2]:
        raise AssertionError(f"train_ec_dnn did not resume from round 2: "
                             f"{lm['result']}")
    if not lm["launches"]["flash_attention"]:
        raise AssertionError("train_ec_dnn's relabel and eval launched no "
                             "flash attention")
    serve = out["deepseek-7b reduced serve_ensemble"]
    if not (serve["launches"]["paged_attention"]
            and serve["launches"]["flash_attention"]):
        raise AssertionError(f"serve_ensemble's paged demo launched "
                             f"{serve['launches']}")
    t1 = out["paper_nin table1"]["result"]
    f12 = out["paper_nin fig12"]["result"]
    claims = {
        "table1 EC_G <= EC_L": t1["EC-DNN_G"] <= t1["EC-DNN_L"],
        "table1 EC_L <= S-DNN": t1["EC-DNN_L"] <= t1["S-DNN"],
        "table1 EC <= MA (+0.02)": t1["EC-DNN_L"] <= t1["MA-DNN_L"] + 0.02
        and t1["EC-DNN_G"] <= t1["MA-DNN_G"] + 0.02,
        "fig12 MA worse in some rounds": f12["ma_bad_fraction"] > 0}
    emit({"phase": 23, "card": card, "paths": out,
          "claims_printed_not_asserted": {
              k: "OK" if v else "VIOLATED" for k, v in claims.items()}})
    torch.cuda.empty_cache()
    return {name: path["launches"] for name, path in out.items()}


# ---------------------------------------------------------------------------
# phase 24: the dry-run against the card
# ---------------------------------------------------------------------------

# gemma3-1b's cells on a (1, 1) mesh, cut to fit one card and the phase's
# time: (shape, variant, seq_len, batch, layers or None for all 26); the
# relabel step is held by its first part, the score of one chunk (1 row
# of 4096 tokens: at 262k classes a chunk is one sequence)
DRYRUN_CELLS = {"prefill_32k": ("prefill_32k", "plain", 32768, 1, None),
                "decode_32k": ("decode_32k", "plain", 32768, 128, 13),
                "train_4k": ("train_4k", "plain", 4096, 1, 6),
                "relabel": ("train_4k", "relabel", 4096, 2, None)}
DRYRUN_RUNS = 3            # timed runs a cell (the median is reported)
DRYRUN_SLACK = 1.05        # a bound may exceed the measured time by 5%
OP_CALLS = 200             # calls a way in the custom op's host timing


def dryrun_real_args(torch, cell, cfg, seed: int = 0):
    """The cell's inputs for real on the card: seeded weights, zero
    optimizer state and cache, random tokens."""
    from repro_torch import models
    from repro_torch.models import transformer
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = cell.shape

    def tokens(*lead):
        return torch.randint(0, cfg.vocab_size, lead, generator=g,
                             device="cuda", dtype=torch.int32)

    k = cell.meta["k"]
    if cell.step_name == "relabel_step":    # its first part's rows
        rows = cell.parts[0][3][1]["tokens"].shape[0]
        return (models.init(cfg, seed=seed, device="cuda", members=1),
                {"tokens": tokens(rows, shape.seq_len)})
    if shape.kind == "train":
        params = models.init(cfg, seed=seed, device="cuda", members=k)
        moment = cell.args[0]["opt"]["m"]["embed"].dtype
        z = lambda p: torch.zeros(p.shape, dtype=moment,  # noqa: E731
                                  device="cuda")
        from repro_torch.common.tree import tree_map
        opt = {"m": tree_map(z, params), "v": tree_map(z, params),
               "step": torch.zeros((k,), dtype=torch.int32, device="cuda")}
        b = shape.global_batch // k
        batch = {"tokens": tokens(k, b, shape.seq_len),
                 "labels": tokens(k, b, shape.seq_len)}
        return ({"params": params, "opt": opt}, batch)
    params = models.init(cfg, seed=seed, device="cuda")
    if shape.kind == "prefill":
        return (params, {"tokens": tokens(shape.global_batch,
                                          shape.seq_len)})
    cache = transformer.init_slot_cache(cfg, shape.global_batch,
                                        shape.seq_len, device="cuda")
    return (params, cache, tokens(shape.global_batch, 1))


def op_host_us(torch) -> dict:
    """Host microseconds a flash call takes (a decode-sized call: 16
    rows, one query, 576 keys, gemma3-1b's heads, bf16) through the
    custom op, through ops.py's routing (a plain tensor: the wrapper)
    and through the wrapper alone, OP_CALLS calls a way, interleaved
    twice."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import library  # noqa: F401  (registers)
    from repro_torch.kernels import ops
    q = torch.randn(16, 1, 4, 256, device="cuda", dtype=torch.bfloat16)
    kv = torch.randn(16, 576, 1, 256, device="cuda", dtype=torch.bfloat16)
    ways = {
        "custom_op": lambda: torch.ops.repro_torch.flash_attention(
            q, kv, kv, None, None, False, 0, None),
        "ops_routing": lambda: ops.flash_attention(q, kv, kv, causal=False),
        "wrapper": lambda: fa.flash_attention(q, kv, kv, causal=False)}
    got = {name: [] for name in ways}
    for _ in range(2):
        for name, fn in ways.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OP_CALLS):
                fn()
            got[name].append((time.perf_counter() - t0) / OP_CALLS * 1e6)
            torch.cuda.synchronize()
    return {name: min(v) for name, v in got.items()}


RELABEL_PERMUTE = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.common.types import ShapeConfig
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh(({k}, 1), ("data", "model"), "cuda")
cfg = registry.get_config("gemma3-1b").with_(n_layers={layers})
rec = dryrun.run_cell("gemma3-1b", "train_4k", False, variant="relabel",
                      device="cuda", mesh=mesh, cfg=cfg,
                      shape=ShapeConfig("train_4k", {seq}, {batch}, "train"))
print("RELABEL_CELL " + json.dumps({{k: rec.get(k) for k in (
    "status", "error", "traceback", "collective_bytes", "collective_count",
    "meta", "parts", "trace_s")}}))
"""


def relabel_permute_cell(want: dict) -> dict:
    """The dry-run's relabel cell at 22b's configuration (K members a rank
    each along "data", `rows` visiting rows of seq_len tokens, top-64,
    22b's layers) on a (K, 1) fake world, traced in a child process (a fake
    world is its process's default group) -> its record."""
    import json as _json
    K, n, T = want["members"], want["rows"], want["seq_len"]
    # m = int(b x 0.7) rows a member: the smallest b giving n
    b = next(b for b in range(n, 2 * n + 2) if int(b * 0.7) == n)
    script = RELABEL_PERMUTE.format(src=os.path.join(ROOT, "src"), k=K,
                                    layers=RING["n_layers"], seq=T,
                                    batch=K * b)
    proc = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"phase 24 relabel cell (22b's shape): "
                             f"{proc.stderr[-3000:]}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RELABEL_CELL "))
    rec = _json.loads(line[len("RELABEL_CELL "):])
    if rec["status"] != "ok":
        raise AssertionError(f"phase 24 relabel cell (22b's shape): "
                             f"{rec['error']}\n{rec['traceback']}")
    return rec


def phase24(torch, np, card) -> dict:
    """The dry-run against the card (see the module note).  -> the
    prefill cell's flash launches."""
    from repro_torch.common.types import ShapeConfig
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import cost_analysis, dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.specs import build_cell
    kinds = {"prefill_32k": "prefill", "decode_32k": "decode",
             "train_4k": "train"}
    t0 = time.perf_counter()
    with FakeTensorMode():   # its first use imports DTensor and more
        torch.empty(1, device="cuda")
    setup_s = time.perf_counter() - t0
    mesh = make_test_mesh()
    rows, launches = {}, {}
    for name, (shape_name, variant, seq, batch, layers) in \
            DRYRUN_CELLS.items():
        cfg = registry.get_config("gemma3-1b")
        if layers:
            cfg = cfg.with_(n_layers=layers)
        shape = ShapeConfig(shape_name, seq, batch, kinds[shape_name])
        t0 = time.perf_counter()
        rec = dryrun.run_cell("gemma3-1b", shape_name, False, device="cuda",
                              mesh=mesh, cfg=cfg, shape=shape,
                              variant=variant)
        fake_s = time.perf_counter() - t0
        if rec["status"] != "ok":
            raise AssertionError(f"phase 24 {name}: the trace failed: "
                                 f"{rec['error']}\n{rec['traceback']}")
        with FakeTensorMode():   # the cell's step and specs, not its inputs
            cell = build_cell("gemma3-1b", shape_name, mesh, False,
                              device="cuda", cfg=cfg, shape=shape,
                              variant=variant)
            fn, want = cell.fn, rec
            if variant == "relabel":     # its first part, traced alone
                part, count, fn, fake_args = cell.parts[0]
                _, fake = cost_analysis.analyze(fn, *fake_args)
                terms = dryrun.roofline(fake, 1, 0.0)
                want = {"flops_per_dev": fake.flops,
                        "flops_executed_per_dev": fake.flops_executed,
                        "hbm_bytes_per_dev": fake.hbm_bytes,
                        "bytes_per_device": fake.peak_bytes,
                        "dominant": terms["dominant"],
                        "kernel_calls": fake.kernel_calls, **terms}
        args = dryrun_real_args(torch, cell, cfg)
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        # once under the accounting (its ops run for real), then timed
        _, real = cost_analysis.analyze(fn, *args)
        times = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(DRYRUN_RUNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        real_s = time.perf_counter() - t0 - fake_s
        calls = 1 + DRYRUN_RUNS
        launches[name] = fa.flash_attention.launches
        ms = float(np.median(times))
        bound_ms = max(want["t_compute_s"], want["t_memory_s"]) * 1e3
        row = {"fake_flops": want["flops_per_dev"], "real_flops": real.flops,
               "fake_flops_executed": want["flops_executed_per_dev"],
               "real_flops_executed": real.flops_executed,
               "fake_hbm_bytes": want["hbm_bytes_per_dev"],
               "real_hbm_bytes": real.hbm_bytes,
               "predicted_peak_bytes": want["bytes_per_device"],
               "real_trace_peak_bytes": real.peak_bytes,
               "max_memory_allocated": peak,
               "t_compute_ms": want["t_compute_s"] * 1e3,
               "t_memory_ms": want["t_memory_s"] * 1e3,
               "bound_ms": bound_ms, "measured_ms": ms, "runs_ms": times,
               "bound_over_measured": bound_ms / ms,
               "dominant": want["dominant"], "fake_s": fake_s,
               "real_s": real_s,
               "kernel_calls": want["kernel_calls"],
               "flash_launches": launches[name], "calls": calls,
               "cuts": {"seq_len": seq, "batch": batch,
                        "layers": cfg.n_layers}}
        if variant == "relabel":
            row.update(part=part, count=count,
                       chunk_rows=args[1]["tokens"].shape[0],
                       cell_flops_per_dev=rec["flops_per_dev"],
                       cell_parts=rec["parts"],
                       cell_kernel_calls=rec["kernel_calls"])
        rows[name] = row
        del args, cell, real
        torch.cuda.empty_cache()
        if row["fake_flops"] != row["real_flops"] or \
                row["fake_flops_executed"] != row["real_flops_executed"]:
            raise AssertionError(f"phase 24 {name}: fake and real FLOPs "
                                 f"differ: {row}")
        if bound_ms > DRYRUN_SLACK * ms:
            raise AssertionError(f"phase 24 {name}: the roofline bound "
                                 f"{bound_ms:.3f} ms exceeds the measured "
                                 f"{ms:.3f} ms by more than 5%: {row}")
        if (kinds[shape_name] == "prefill" or variant == "relabel") and \
                launches[name] != cfg.n_layers * calls:
            raise AssertionError(f"phase 24 {name}: {launches[name]} flash "
                                 f"launches, want {cfg.n_layers} layers x "
                                 f"{calls} calls")
    # the ring's permute bytes at 22b's configuration against 22b's own
    # (its rows a rank, its members, top-64); where phase 22 did not run
    # in this process, against the bytes its ring sends by construction
    sent = RING_TOPK_SENT
    source = "22b measured"
    if sent is None:
        T, K = RING["seq_len"], RING["members"]
        n = int(RING["per_member"] * RING["relabel"]) // RING["data_ranks"]
        sent = {"rows": n, "seq_len": T, "members": K,
                "bytes": (K - 1) * n * T * 4
                + K * n * T * (RING["top_m"] * 8 + 4)}
        source = "22b's formula (phase 22 not run)"
    t0 = time.perf_counter()
    cell = relabel_permute_cell(sent)
    permute = {"dryrun_bytes": cell["collective_bytes"].get(
                   "collective-permute", 0.0),
               "dryrun_count": cell["collective_count"].get(
                   "collective-permute", 0),
               "ring_bytes": sent["bytes"], "against": source,
               "rows": sent["rows"], "seq_len": sent["seq_len"],
               "members": sent["members"], "parts": cell["parts"],
               "trace_s": cell["trace_s"],
               "child_s": time.perf_counter() - t0}
    if permute["dryrun_bytes"] != sent["bytes"]:
        raise AssertionError(f"phase 24: the dry-run's permute bytes "
                             f"{permute['dryrun_bytes']} differ from the "
                             f"ring's {sent['bytes']} ({source})")
    host_us = op_host_us(torch)
    emit({"phase": 24, "card": card, "setup_s": setup_s, "cells": rows,
          "relabel_permute": permute,
          "flash_host_us_per_call": host_us})
    return {"prefill": launches["prefill_32k"],
            "relabel": launches["relabel"]}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    t0 = time.perf_counter()
    built = build.build_all()
    emit({"phase": 0, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": time.perf_counter() - t0,
          "built": built})
    emit({"phase": 0, "ptxas": ptxas_report(build)})
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    paged_rows = phase1(torch, flush, card)
    flash_rows = phase7(torch, flush, card)
    wkv_rows = phase10(torch, flush, card)
    scan_rows = phase11(torch, flush, card)
    del flush
    bf16_pages = {}     # phase 2 serves over bf16 pages: phase 19's baseline
    launches = {"gemma3-1b": serve_phase(torch, np, card, "gemma3-1b", 2,
                                         kv_dtype="bf16",
                                         record=bf16_pages),
                "deepseek-7b": serve_phase(torch, np, card, "deepseek-7b", 8,
                                           init_limit=60e9),
                "rwkv6-7b": serve_phase(torch, np, card, "rwkv6-7b", 9,
                                        init_limit=60e9),
                # one published period (8 of 32 layers) at K = 2: the whole
                # model's 103 GB of bf16 weights a member do not fit
                "jamba-v0.1-52b": serve_phase(torch, np, card,
                                              "jamba-v0.1-52b", 12,
                                              members=2, n_layers=8,
                                              init_limit=60e9),
                # the dense first layer and one MoE layer of 60 at K = 4
                # (42.9 GB of bf16 weights; a third layer makes 74.6 GB)
                "deepseek-v2-236b": serve_phase(torch, np, card,
                                                "deepseek-v2-236b", 16,
                                                n_layers=2,
                                                init_limit=60e9),
                # every layer and width: 4 + 4 layers, d 384, 1500 frames
                "whisper-tiny": serve_phase(torch, np, card, "whisper-tiny",
                                            17, serve=WHISPER_SERVE),
                # every layer and width: 28 layers, d 1536, 3.1 GB a member
                "qwen2-vl-2b": serve_phase(torch, np, card, "qwen2-vl-2b",
                                           18, init_limit=60e9)}
    launches_cont = phase13(torch, np, card)
    launches_quant = phase19(torch, np, card, bf16_pages)
    launches_spec = phase20(torch, np, card)
    launches_http = phase21(torch, np, card)
    for arch in launches:
        phase3(torch, np, arch)
    phase3_quant_spec(torch, np)
    for arch, run in PHASE3_CONT:
        phase3_continuous(torch, np, arch, run)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    distill_rows, distill_cases = phase4(torch, flush, card)
    del flush
    distill_launches = phase5(torch, np, card)
    phase6(torch)
    lm_launches = phase14(torch, np, card)
    ssm_launches = phase15(torch, np, card)
    mesh_launches = phase22(torch, np, card)
    paper_launches = phase23(torch, np, card)
    dryrun_launches = phase24(torch, np, card)

    def entry(name, source, replaces, n, row, by_path=None):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n,
               "max_abs_err": row["max_abs_err"], "ms": row["ms"],
               "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
               "bound_by": row["bound_by"],
               "library_ms": row["library_ms"]}
        if by_path:
            out["launches_by_path"] = by_path
        return out

    def serving(kernel):
        out = {f"{arch} serve": n[kernel] for arch, n in launches.items()}
        for arch, n in launches.items():
            if f"{kernel}_encoder_stub" in n:
                out[f"{arch} encoder stub"] = n[f"{kernel}_encoder_stub"]
        if kernel in launches_cont:
            out["gemma3-1b continuous"] = launches_cont[kernel]
        for kv, n in launches_quant.items():
            if n.get(kernel):
                out[f"gemma3-1b serve {kv} pages"] = n[kernel]
        for path, n in launches_spec.items():
            if kernel in n:
                out[f"gemma3-1b {path}"] = n[kernel]
        if kernel in launches_http:
            out["gemma3-1b http"] = launches_http[kernel]
        if kernel in lm_launches:
            out["gemma3-1b train"] = lm_launches[kernel]
        for arch, n in ssm_launches.items():
            if kernel in n:
                out[f"{arch} train"] = n[kernel]
        if kernel in mesh_launches["serve"]:
            out["gemma3-1b mesh"] = mesh_launches["serve"][kernel]
        if kernel in mesh_launches["train"]:
            out["gemma3-1b ring train"] = mesh_launches["train"][kernel]
        for path, n in paper_launches.items():
            if n.get(kernel):
                out[path] = n[kernel]
        if kernel == "flash_attention":
            out["gemma3-1b dryrun prefill"] = dryrun_launches["prefill"]
            out["gemma3-1b dryrun relabel"] = dryrun_launches["relabel"]
        return out

    def by_shape(rows):
        return {name: {key: row[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")}
            for name, row in rows.items()}

    dsrc = "src/repro_torch/kernels/csrc/distill_loss.cu"
    emit({"kernels": [
        # gemma3-1b's decode row; the deepseek-7b, jamba, deepseek-v2
        # (absorbed MLA) and qwen2-vl-2b shapes too
        dict(entry("paged_attention",
                   "src/repro_torch/kernels/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention.py:117",
                   launches["gemma3-1b"]["paged_attention"],
                   paged_rows["bf16"], serving("paged_attention")),
             by_shape=by_shape({k: paged_rows[k] for k in (
                 "bf16", "bf16_deepseek_7b", "bf16_jamba",
                 "bf16_deepseek_v2_mla", "f32_mla", "bf16_qwen2_vl",
                 "bf16_int8", "bf16_fp8", "bf16_int8_deepseek_7b",
                 "bf16_fp8_deepseek_7b", "bf16_int8_deepseek_v2_mla")})),
        # deepseek-7b's bf16 chunk; every bf16 case too
        dict(entry("flash_attention",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:93",
                   launches["deepseek-7b"]["flash_attention"],
                   flash_rows["deepseek_paged_mid", "bfloat16"],
                   serving("flash_attention")),
             by_shape=by_shape({name if dt == "bfloat16" else
                                f"{name} {dt}": row
                                for (name, dt), row in flash_rows.items()
                                if dt == "bfloat16"
                                or name in VERIFY_CASES})),
        # the NiN row; the 262k-vocab rows too, the shape of gemma3-1b's
        # distill step (N 2048 x V 262144, bf16)
        *(dict(entry(f"distill_loss_{which}", dsrc,
                     f"src/repro/kernels/distill_loss.py:{line}",
                     distill_launches[which], distill_rows[which],
                     {"paper_nin train": distill_launches[which],
                      "gemma3-1b train": lm_launches[which],
                      **{f"{arch} train": n[which]
                         for arch, n in ssm_launches.items()},
                      "gemma3-1b ring train":
                          mesh_launches["train"][which],
                      **{path: n[which]
                         for path, n in paper_launches.items()
                         if n[which]}}),
               by_shape=by_shape(distill_cases[which]))
          for which, line in (("fwd", 35), ("bwd", 71))),
        # the decode step's row; launches over decode and prefill both
        dict(entry("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
                   "src/repro/kernels/wkv6.py:79",
                   launches["rwkv6-7b"]["wkv6"], wkv_rows["decode"],
                   serving("wkv6")),
             by_shape=by_shape(wkv_rows)),
        dict(entry("ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                   "src/repro/kernels/ssm_scan.py:52",
                   launches["jamba-v0.1-52b"]["ssm_scan"],
                   scan_rows["decode"], serving("ssm_scan")),
             by_shape=by_shape(scan_rows))]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
