#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each, in the order 0, 1, 7, 10, 11, 2, 8, 9, 12,
3, 4, 5, 6:
  0  the card's name and power limit; build every CUDA kernel from
     src/repro_torch/kernels/csrc (one nvcc per source, all at once);
     every kernel function's registers and spills (ptxas) and each
     library's count of tensor-core instructions (cuobjdump);
  1  the paged-attention kernel against its plain PyTorch version on the
     card, at the decode path's shapes (gemma3-1b's in every variant it
     takes, deepseek-7b's and jamba's in bf16), with its time (cold L2),
     the plain version's, one library call's, the bound and the number
     of blocks each row's pages are split over;
  7  the flash-attention kernel likewise, f32 and bf16, at the prefill's
     shapes (gemma3-1b over a 512 ring and over 576 gathered positions,
     deepseek-7b over 576, each plus a 128-token chunk, mid-prompt and
     ragged tail) and the full forward's (top-left causal, T = S =
     2048), beside one scaled_dot_product_attention call with the same
     boolean mask, and the share of key tiles the kernel skips (its
     predicate's twin, kernels/ref.flash_tile_live);
 10  the wkv6 kernel (the rwkv6 recurrence) likewise, f32, at rwkv6-7b's
     shapes: the decode step (16 rows, one token, a strided state view),
     a mid-prompt prefill chunk (4 rows, 128 tokens, a nonzero state and
     a masked ragged tail), apply (4 rows, 2048 tokens) and a prefill
     chunk with decays down to the models' clamp (-e^4 a token); each
     with its launch's path, blocks, chunk and column tile; no single
     PyTorch call computes the recurrence, so it has no library time;
 11  the ssm_scan kernel (Mamba's selective scan) likewise, f32, at
     jamba's shapes (d_inner 8192, d_state 16, K = 2): the decode step (8
     rows, one token, a strided state view), a mid-prompt prefill chunk
     (2 rows, 128 tokens, a nonzero state) and apply (2 rows, 2048
     tokens), each with its launch's variant (short or long T) and
     blocks; no single PyTorch call computes a first-order recurrence
     with per-step coefficients, so it has no library time either;
  2  the serving path at full width: gemma3-1b (bf16, 26 layers), K=4
     members, paged KV, 4 requests of 300-512 prompt tokens served
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
     attention per prefill call, wkv6 never; init below 60 GB.
     Phases 2, 8, 9 and 12 give each kernel's device time per launch in
     situ (profiler sum over launches, decode and prefill apart);
  3  the card against the CPU end to end on reduced gemma3-1b,
     deepseek-7b, rwkv6-7b and jamba-v0.1-52b at f32: identical greedy
     tokens and allclose fused log-probs;
  4  the fused distillation-loss kernels (forward and backward) against
     their plain version on the card: the NiN training path's shape, a
     262k bf16 vocab, and f32 with padded labels; times as in phase 1,
     beside one F.cross_entropy call with probability targets;
  5  the training path at full width: paper NiN, K=4 members, batch 64
     each, 2 EC rounds through Trainer.run_round (round 1 opens with 8
     Eqn-9 distill steps); the kernels' launch counts must equal the
     formula printed, every loss be finite and the Jensen gap >= 0;
     device ms per step by CUDA events (no profiler) against host ms;
  6  the card against the CPU on reduced NiN at f32: one plain and one
     distill round, losses and evaluate() metrics within 1e-4.
Then the kernels line, the card line, and last the result line.  Any
failure exits non-zero before the result line.  Imports nothing of JAX.
"""
from __future__ import annotations

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
FLUSH_BYTES = 64 << 20             # > the 50 MB L2: each timed call starts cold
SLEEP_CYCLES = 5_000_000           # ~2.5 ms of GPU clock: outlasts any enqueue


def emit(obj) -> None:
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

def paged_case(torch, gen, *, qdt, kvdt, dk, dv, dr=0, window=0, shape=None):
    """Main-path-shaped inputs: ragged lens in 1..576 (or the shape's
    range), each row's live pages scattered over the pool, sentinel (>=
    n_pages) entries past them."""
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
        x = torch.randn(*shape, generator=gen, device=dev)
        if dtype == torch.int8:
            return (x * 40).round().clamp(-127, 127).to(torch.int8)
        return x.to(dtype)

    case = dict(q=rnd(B, H, dk + dr, dtype=qdt),
                k_pages=rnd(n_pages, page, Hkv, dk, dtype=kvdt),
                v_pages=rnd(n_pages, page, Hkv, dv, dtype=kvdt),
                table=table, lens=lens.int(), window=window)
    if kvdt in (torch.int8, torch.float8_e4m3fn):
        case["k_scale"] = torch.rand(n_pages, page, Hkv, generator=gen,
                                     device=dev) * 0.05
        case["v_scale"] = torch.rand(n_pages, page, Hkv, generator=gen,
                                     device=dev) * 0.05
    if dr:
        case["k_extra"] = rnd(n_pages, page, Hkv, dr, dtype=qdt)
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
    per_tok = Hkv * (dk + dv) * kp.element_size()
    for name in ("k_scale", "v_scale"):
        if case.get(name) is not None:
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
    into contiguous per-row tensors beforehand (the yardstick)."""
    import torch.nn.functional as F
    q, kp, vp, table = (case["q"], case["k_pages"], case["v_pages"],
                        case["table"])
    n_pages, page, Hkv, dk = kp.shape
    B, H, _ = q.shape
    g = H // Hkv
    t = table.long().clamp(0, n_pages - 1)
    S = t.shape[1] * page
    k = kp[t].reshape(B, S, Hkv, dk).transpose(1, 2)
    v = vp[t].reshape(B, S, Hkv, -1).transpose(1, 2)
    k = k.repeat_interleave(g, dim=1).contiguous()
    v = v.repeat_interleave(g, dim=1).contiguous()
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] < case["lens"].long()[:, None])[:, None, None]
    qq = q[:, :, None]
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
    ]
    # tolerances are those of the JAX package's kernel tests: the kernel
    # sums an online softmax page by page, the plain version all at once
    rows = {}
    for name, kw, tol in cases:
        case = paged_case(torch, gen, **kw)
        args = {k: v for k, v in case.items()}
        B, P = case["table"].shape
        splits = pa.n_splits(B, case["k_pages"].shape[2], P, n_sm)
        got = pa.paged_attention(**args)
        want = ref.paged_attention(**args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{name}: {m}")
        ms = time_ms(lambda: pa.paged_attention(**args), torch, flush)
        plain_ms = time_ms(lambda: ref.paged_attention(**args), torch, flush,
                           iters=10)
        lib_ms = None
        if "k_scale" not in case and "k_extra" not in case \
                and case["k_pages"].shape[-1] == case["v_pages"].shape[-1] \
                and not case["window"]:
            lib_ms = time_ms(sdpa_call(case, torch), torch, flush)
        bound_ms, bound_by = paged_bound(case, torch)
        row = {"phase": 1, "card": card, "kernel": "paged_attention",
               "case": name, "rows": B, "H": case["q"].shape[1],
               "Hkv": case["k_pages"].shape[2], "P": P, "splits": splits,
               "lens_sum": int(case["lens"].sum()),
               "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        rows[name] = row
    emit({"phase": 1, "paged_attention_splits": {
        name: row["splits"] for name, row in rows.items()}, "sms": n_sm})
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


# name: (N, T, cache S (0: top-left T = S), H, Hkv, dh, window, idx, n_tok)
# gemma3-1b: ring of 512 (local layers, window 512) and 576 gathered
# positions (global layer) plus a 128 chunk; deepseek-7b: 576 gathered
# plus the chunk; apply at T = S = 2048, top-left causal
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
}


def flash_valid(torch, q_pos, k_pos, T, S, window, dev="cuda"):
    """(N or 1, T, S) mask of the (query, key) pairs that count."""
    if q_pos is None:
        q_pos = torch.arange(T, device=dev)[None]
        k_pos = torch.arange(S, device=dev)[None]
    qp, kp = q_pos.long()[:, :, None], k_pos.long()[:, None, :]
    ok = (kp >= 0) & (kp <= qp)
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
    for name, (N, T, S0, H, Hkv, dh, window, idx, n_tok) in \
            FLASH_CASES.items():
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
            S = S0 + T if S0 else T
            q, k, v = (torch.randn(N, n, h, dh, generator=gen,
                                   device="cuda").to(dt)
                       for n, h in ((T, H), (S, Hkv), (S, Hkv)))
            kw = dict(causal=True, window=window)
            if S0:
                kw["q_pos"], kw["k_pos"] = flash_positions(
                    torch, N, S0, T, idx, n_tok, window)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ok = flash_valid(torch, kw.get("q_pos"), kw.get("k_pos"), T, S,
                             window)
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
            live = ref.flash_tile_live(N, T, S, H // Hkv, bq, bk, True,
                                       window, kw.get("q_pos"),
                                       kw.get("k_pos"))
            row = {"phase": 7, "card": card, "kernel": "flash_attention",
                   "case": name, "dtype": str(dt).split(".")[-1],
                   "N": N, "T": T, "S": S, "H": H, "Hkv": Hkv, "dh": dh,
                   "window": window, "idx": idx, "n_tok": n_tok,
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
}
WKV_TOL = dict(atol=5e-4, rtol=1e-3)   # tests/test_kernels.py's
WKV_HEADS = dict(H=64, dh=64)          # rwkv6-7b


def wkv_inputs(torch, gen, K, B, T, n_tok, warm, strong, H=64, dh=64,
               count=2):
    """Phase 10's inputs for one case: r, k, v, log_w (K*B, T, H, dh), u
    (K, H, dh), the pool (K, count, 4, H, dh, dh) and the state, one
    layer's view of it, (K, count, ...)[:, 1], narrowed to the slot for
    one-slot rows."""
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
    pool = f(K, count, 4, H, dh, dh) * (0.1 if warm else 0.0)
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
}
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)   # tests/test_kernels.py's
SCAN_DIMS = dict(D=8192, Ns=16)         # jamba


def scan_inputs(torch, gen, K, B, T, warm, D=8192, Ns=16, count=2):
    """Phase 11's inputs for one case: a = exp(-|x|), small b (K*B, T, D,
    Ns), the pool (K, count, 4, D, Ns) and the state, one Mamba layer's
    view of it, (K, count, ...)[:, 1], narrowed to the slot for one-slot
    rows."""
    N = K * B
    f = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                               device="cuda")
    a = torch.exp(-f(N, T, D, Ns).abs())
    b = f(N, T, D, Ns) * 0.2
    pool = f(K, count, 4, D, Ns) * (0.1 if warm else 0.0)
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
    is taken against the unprofiled step time instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
# kernel wrapper -> the symbol of its kernel in a profile
SYMBOL = {"paged_attention": "paged_kernel",
          "flash_attention": "flash_kernel", "wkv6": "wkv6_",
          "ssm_scan": "ssm_scan_"}


def serve_phase(torch, np, card, arch: str, phase: int, members: int = 4,
                n_layers: int = None, init_limit: float = None) -> dict:
    """`arch` at full width, bf16, `members` members, paged KV (page 16),
    its depth cut to `n_layers` where given: 4 requests of 300-512 prompt
    tokens through EnsembleEngine.generate for 32 new tokens, greedy.
    Every kernel's launch count must equal its formula: paged_attention
    once per paged layer per decode step after the first token (which
    prefill emits); flash_attention once per attention layer per prefill
    call; wkv6 once per rwkv layer, and ssm_scan once per Mamba layer
    and 128-token piece, per decode step and per prefill call.  -> the
    kernels' launch counts."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    cfg = registry.get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    K, n_new, plens = members, SERVE["new_tokens"], SERVE["prompt_lens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0, device="cuda", members=K)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    if init_limit is not None and init_peak >= init_limit:
        raise AssertionError(f"{arch} init peaked at {init_peak} B, limit "
                             f"{init_limit}")
    eng = EnsembleEngine(cfg, params, n_slots=SERVE["slots"],
                         max_prompt=SERVE["max_prompt"],
                         max_out=SERVE["max_out"], paged=True,
                         page_size=SERVE["page"], device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in plens]
    eng.generate(prompts, max_new=2)            # warm-up (cuBLAS, kernel load)
    n_paged = n_paged_layers(cfg, eng.max_seq, tf)
    n_layers = lambda mixers: sum(  # noqa: E731
        count for count, specs in cfg.segments() for sp in specs
        if sp.mixer in mixers)
    n_attn, n_rwkv = n_layers(("attn", "attn_local")), n_layers(("rwkv",))
    n_mamba = n_layers(("mamba",))
    calls = sum(-(-n // eng.prefill_chunk) for n in plens)
    pieces = -(-eng.prefill_chunk // ssm.MAMBA_CHUNK)
    expected = {"paged_attention": n_paged * (n_new - 1),
                "flash_attention": n_attn * calls,
                "wkv6": n_rwkv * (n_new - 1 + calls),
                "ssm_scan": n_mamba * (n_new - 1 + pieces * calls)}
    formulas = {
        "paged_attention": f"{n_paged} paged layers x ({n_new} - 1) decode "
                           f"steps = {expected['paged_attention']}",
        "flash_attention": f"{n_attn} attention layers x {calls} prefill "
                           f"calls = {expected['flash_attention']}",
        "wkv6": f"{n_rwkv} rwkv layers x (({n_new} - 1) decode steps + "
                f"{calls} prefill calls) = {expected['wkv6']}",
        "ssm_scan": f"{n_mamba} mamba layers x (({n_new} - 1) decode steps "
                    f"+ {pieces} piece(s) x {calls} prefill calls) = "
                    f"{expected['ssm_scan']}"}
    kernels = {"paged_attention": pa.paged_attention,
               "flash_attention": fa.flash_attention, "wkv6": wk.wkv6,
               "ssm_scan": ssk.ssm_scan}
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    prefills0 = eng.prefills_run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
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
                      if per_prefill[k] else None}
                  for k, n in expected.items() if n}
    emit({"phase": phase, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
          "members": K, "n_layers": cfg.n_layers, "slots": SERVE["slots"],
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
          "sample": outs[0][:8].tolist()})
    del eng, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3: card against CPU
# ---------------------------------------------------------------------------

def phase3(torch, np, arch: str):
    """Reduced `arch`, f32, K = 4, paged: greedy tokens identical on the
    card and the CPU, fused log-probs within 1e-4."""
    from repro_torch.configs import registry
    from repro_torch.core import ensemble as ens
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    cfg = registry.get_config(arch, reduced=True).with_(dtype="float32")
    params = tf.init(cfg, seed=0, device="cpu", members=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (7, 19, 25, 32)]
    kw = dict(n_slots=4, max_prompt=32, max_out=16, paged=True, page_size=8)
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
        logits, _ = tf.decode_step_paged(eng.params, cfg, eng.cache,
                                         eng.state.tok[:, None])
        lps[dev] = ens.ensemble_log_probs(logits[:, :, 0],
                                          eng.quorum).cpu()
    same = all(np.array_equal(a, b) for a, b in zip(toks["cuda"],
                                                     toks["cpu"]))
    err = (lps["cuda"] - lps["cpu"]).abs().max().item()
    emit({"phase": 3, "arch": cfg.name, "dtype": cfg.dtype, "members": 4,
          "tokens_identical": same, "logp_max_abs_err": err, "tol": 1e-4})
    if not same:
        raise AssertionError(f"{arch}: greedy tokens differ: {toks}")
    # tolerance: the same f32 math summed in another order on each device
    torch.testing.assert_close(lps["cuda"], lps["cpu"], atol=1e-4,
                               rtol=1e-4)


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
        ("vocab_bf16", 2048, 262144, bf16, f32, False),
        ("vocab_f32_pad", 512, 32768, f32, f32, True),
    ]
    # loss rtol 1e-5 for both logits types: both sides read the same
    # values and sum in f32; dz: DZ_TOL
    loss_tol = 1e-5
    main = {}
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
            if name == "nin_f32":
                main[which] = row
        del z, p, zk, zr, got, want, dz, dz_ref, target, zl, lib_loss, fns
        torch.cuda.empty_cache()
    return main


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

def phase6(torch):
    from repro_torch import models
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.data import image_member_datasets
    from repro_torch.optim import sgd_momentum
    from repro_torch.runtime.trainer import Trainer
    cfg = registry.get_config("paper_nin").with_(d_model=48, vocab_size=10)
    K = 4
    params = models.init(cfg, seed=0, device="cpu", members=K)
    params = {k: v.numpy() for k, v in params.items()}
    train, test = image_member_datasets(K, 64, n_classes=10, img=16,
                                        seed=0, device="cpu")
    ec = ECConfig(tau=4, p_steps=2, lam=0.5, relabel_fraction=0.5,
                  label_mode="dense", aggregator="ec")
    out = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, ec, sgd_momentum(0.02), K, 0, train, test,
                     batch_size=16, seed=1, params=params, device=dev)
        rows = []
        for _ in range(2):   # a plain round, then a distill round
            rows.append(tr.run_round())
            rows.extend(tr.evaluate().values())
        rows.extend(tr.evaluate_compressed().values())
        out[dev] = rows
    got, want = (torch.tensor(out[d], dtype=torch.float64)
                 for d in ("cuda", "cpu"))
    err = (got - want).abs().max().item()
    emit({"phase": 6, "arch": "paper_nin reduced (d_model 48, img 16, "
                              "10 classes)", "dtype": "float32",
          "members": K, "values_compared": len(out["cpu"]),
          "max_abs_err": err, "rtol": 1e-4})
    # tolerance: the same f32 math, summed in another order on each device
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


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
    launches = {"gemma3-1b": serve_phase(torch, np, card, "gemma3-1b", 2),
                "deepseek-7b": serve_phase(torch, np, card, "deepseek-7b", 8,
                                           init_limit=60e9),
                "rwkv6-7b": serve_phase(torch, np, card, "rwkv6-7b", 9,
                                        init_limit=60e9),
                # one published period (8 of 32 layers) at K = 2: the whole
                # model's 103 GB of bf16 weights a member do not fit
                "jamba-v0.1-52b": serve_phase(torch, np, card,
                                              "jamba-v0.1-52b", 12,
                                              members=2, n_layers=8,
                                              init_limit=60e9)}
    for arch in launches:
        phase3(torch, np, arch)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    distill_rows = phase4(torch, flush, card)
    del flush
    distill_launches = phase5(torch, np, card)
    phase6(torch)

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
        return {f"{arch} serve": n[kernel] for arch, n in launches.items()}

    def by_shape(rows):
        return {name: {key: row[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")}
            for name, row in rows.items()}

    dsrc = "src/repro_torch/kernels/csrc/distill_loss.cu"
    emit({"kernels": [
        # gemma3-1b's decode row; the deepseek-7b and jamba shapes too
        dict(entry("paged_attention",
                   "src/repro_torch/kernels/csrc/paged_attention.cu",
                   "src/repro/kernels/paged_attention.py:117",
                   launches["gemma3-1b"]["paged_attention"],
                   paged_rows["bf16"], serving("paged_attention")),
             by_shape=by_shape({k: paged_rows[k] for k in (
                 "bf16", "bf16_deepseek_7b", "bf16_jamba")})),
        # deepseek-7b's bf16 chunk; every bf16 case too
        dict(entry("flash_attention",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:93",
                   launches["deepseek-7b"]["flash_attention"],
                   flash_rows["deepseek_paged_mid", "bfloat16"],
                   serving("flash_attention")),
             by_shape=by_shape({name: row for (name, dt), row in
                                flash_rows.items() if dt == "bfloat16"})),
        entry("distill_loss_fwd", dsrc,
              "src/repro/kernels/distill_loss.py:35",
              distill_launches["fwd"], distill_rows["fwd"]),
        entry("distill_loss_bwd", dsrc,
              "src/repro/kernels/distill_loss.py:71",
              distill_launches["bwd"], distill_rows["bwd"]),
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
