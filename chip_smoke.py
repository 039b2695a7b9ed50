#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each:
  0  the card's name and power limit; build every CUDA kernel from
     src/repro_torch/kernels/csrc (one nvcc per source, all at once);
  1  each kernel against its plain PyTorch version on the card, at the
     main path's shapes and in every variant it takes, with its time
     (cold L2), the plain version's, one library call's and the bound;
  2  the main path at full width: gemma3-1b (bf16, 26 layers), K=4
     members, paged KV, 4 requests of 300-512 prompt tokens served
     through EnsembleEngine.generate for 32 new tokens; the kernel's
     launch count must equal the formula printed;
  3  the card against the CPU end to end on reduced gemma3-1b at f32:
     identical greedy tokens and allclose fused log-probs.
Then the kernels line, the card line, and last the result line.  Any
failure exits non-zero before the result line.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12}    # bf16 tensor cores, dense
MAIN = dict(rows=16, H=4, Hkv=1, d=256, page=16, max_len=576)
FLUSH_BYTES = 64 << 20             # > the 50 MB L2: each timed call starts cold
SLEEP_CYCLES = 5_000_000           # ~2.5 ms of GPU clock: outlasts any enqueue


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


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

def paged_case(torch, gen, *, qdt, kvdt, dk, dv, dr=0, window=0):
    """Main-path-shaped inputs: ragged lens in 1..576, each row's live
    pages scattered over the pool, sentinel (>= n_pages) entries past
    them."""
    m = MAIN
    B, H, Hkv, page = m["rows"], m["H"], m["Hkv"], m["page"]
    P = -(-m["max_len"] // page)
    dev = "cuda"
    lens = torch.randint(1, m["max_len"] + 1, (B,), generator=gen,
                         device=dev)
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
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    d = MAIN["d"]
    cases = [  # name, case kwargs, tolerance (atol = rtol)
        ("bf16", dict(qdt=bf16, kvdt=bf16, dk=d, dv=d), 2e-2),
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
    main = None
    for name, kw, tol in cases:
        case = paged_case(torch, gen, **kw)
        args = {k: v for k, v in case.items()}
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
               "case": name,
               "rows": MAIN["rows"], "lens_sum": int(case["lens"].sum()),
               "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        if name == "bf16":  # the main path's type
            main = row
    return main


# ---------------------------------------------------------------------------
# phase 2: the main path at full width
# ---------------------------------------------------------------------------

def n_paged_layers(cfg, max_seq, tf) -> int:
    return sum(count for count, specs in cfg.segments() for s in specs
               if tf.layer_pages(cfg, s, max_seq))


def profile_steps(torch, eng, n: int) -> dict:
    """Device time per decode step by kernel, from torch.profiler over n
    steps (the profiler slows the host, so the idle share is taken
    against the unprofiled step time instead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    ms = lambda e: e.self_device_time_total / n / 1e3  # noqa: E731
    top = sorted(kern, key=ms, reverse=True)[:6]
    return {"busy_ms": sum(ms(e) for e in kern),
            "paged_ms": sum(ms(e) for e in kern if "paged_kernel" in e.key),
            "top": [[e.key[:60], ms(e)] for e in top]}


def phase2(torch, np, card):
    from repro_torch.configs import registry
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    cfg = registry.get_config("gemma3-1b")
    K, n_new = 4, 32
    t0 = time.perf_counter()
    params = tf.init(cfg, seed=0, device="cuda", members=K)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = EnsembleEngine(cfg, params, n_slots=4, max_prompt=512, max_out=64,
                         paged=True, page_size=16, device="cuda")
    rng = np.random.default_rng(0)
    plens = [300, 377, 451, 512]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in plens]
    eng.generate(prompts, max_new=2)            # warm-up (cuBLAS, kernel load)
    n_paged = n_paged_layers(cfg, eng.max_seq, tf)
    expected = n_paged * (n_new - 1)            # chunked prefill: no kernel
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    if launches != expected:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected {expected}")
    for o in outs:
        if len(o) != n_new or o.min() < 0 or o.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output {o}")
    # the same requests again through the engine's own calls, timed by part
    eng.update_slots(release=range(eng.n_slots),
                     admits=[(i, p, n_new) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, n in enumerate(plens):
        for _ in range(-(-n // eng.prefill_chunk)):
            eng.prefill(i)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n_new - 1):
        eng.step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    prof = profile_steps(torch, eng, n=3)
    emit({"phase": 2, "card": card, "arch": cfg.name, "dtype": cfg.dtype,
          "members": K,
          "slots": 4, "prompt_lens": plens, "new_tokens": n_new,
          "prefill_chunk": eng.prefill_chunk, "paged_layers": n_paged,
          "launch_formula": f"{n_paged} paged layers x ({n_new} - 1) "
                            f"decode steps = {expected}",
          "launches": launches, "generate_s": gen_s,
          "tok_per_s": sum(len(o) for o in outs) / gen_s,
          "prefill_s": prefill_s,
          "decode_ms_per_step": decode_s / (n_new - 1) * 1e3,
          "init_s": init_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "device_busy_ms_per_step": prof["busy_ms"],
          "device_idle_share": 1.0 - prof["busy_ms"] * (n_new - 1)
                               / (decode_s * 1e3),
          "paged_attention_ms_per_step": prof["paged_ms"],
          "top_kernels_ms_per_step": prof["top"],
          "sample": outs[0][:8].tolist()})
    del eng, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 3: card against CPU
# ---------------------------------------------------------------------------

def phase3(torch, np):
    from repro_torch.configs import registry
    from repro_torch.core import ensemble as ens
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import EnsembleEngine
    cfg = registry.get_config("gemma3-1b", reduced=True).with_(
        dtype="float32")
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
        raise AssertionError(f"greedy tokens differ: {toks}")
    # tolerance: the same f32 math summed in another order on each device
    torch.testing.assert_close(lps["cuda"], lps["cpu"], atol=1e-4,
                               rtol=1e-4)


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
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    main_row = phase1(torch, flush, card)
    del flush
    launches = phase2(torch, np, card)
    phase3(torch, np)
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:117",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
