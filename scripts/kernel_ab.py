#!/usr/bin/env python3
"""Times the port's hand-written kernels from a given checkout's `src/`
at chip_smoke.py's shapes, one JSON line per case.

    python3 scripts/kernel_ab.py --src /path/to/checkout/src \
        [--kernels paged_attention,flash_attention,wkv6,ssm_scan]

Run it once per checkout, alternating (A, B, B, A) in one command on
one card, to compare two versions of the kernels: the cases and the
timing (CUDA events, L2 flushed, enqueue hidden) are this repository's
chip_smoke.py, the kernels are those under --src, built there.  The
paged cases are gemma3-1b's, deepseek-7b's and jamba's decode shapes;
the flash cases are phase 7's, the wkv6 cases phase 10's and the
ssm_scan cases phase 11's.  The first line times a kernel that does
nothing the same way: the floor under every time here.  The wkv6 and
ssm_scan lines also give `b2b_ms`, a launch's share of 32 launches
queued back to back, which that floor does not hold (each launch on
its own copy of the inputs, copies enough to exceed the L2 twice), and
the launch's `plan()` where the checkout's wrapper has one.  ssm_scan
is also timed at its decode shape with T 1-16, across its short-T
threshold.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("paged_attention", "flash_attention", "wkv6", "ssm_scan")
B2B_LAUNCHES = 32
B2B_BYTES = 100 << 20     # input copies of at least twice the 50 MB L2
SCAN_SWEEP_T = (1, 2, 4, 8, 16)


def back_to_back_ms(calls, torch, flush, cs) -> float:
    """Median over 5 runs of the device time of B2B_LAUNCHES calls, cycling
    through `calls`, queued behind a sleep that outlasts their enqueue,
    by the count: a launch's time without the floor of timing it alone."""
    times = []
    for _ in range(5):
        flush.zero_()
        torch.cuda._sleep(4 * cs.SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(B2B_LAUNCHES):
            calls[i % len(calls)]()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / B2B_LAUNCHES)
    times.sort()
    return times[len(times) // 2]


def copies(make, nbytes: int) -> list:
    """`make()` called often enough that the copies exceed B2B_BYTES."""
    return [make() for _ in range(max(1, -(-B2B_BYTES // nbytes)))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the src/ directory whose kernels are timed")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args()
    names = args.kernels.split(",")
    if set(names) - set(KERNELS):
        ap.error(f"--kernels takes {','.join(KERNELS)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.src))   # ahead of ROOT/src
    from repro_torch.kernels import build
    assert os.path.dirname(build.__file__).startswith(
        os.path.abspath(args.src))
    build.build_all(names)
    card = cs.card_line()
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")

    def emit(kernel, case, ms, **extra):
        cs.emit({"src": args.src, "card": card, "kernel": kernel,
                 "case": case, "ms": ms, **extra})

    # the timing's floor: a kernel that does nothing, timed the same way
    emit("floor", "empty_kernel",
         cs.time_ms(lambda: torch.cuda._sleep(0), torch, flush))

    if "paged_attention" in names:
        from repro_torch.kernels import paged_attention as pa
        bf16 = torch.bfloat16
        for name, shape, d in (("gemma3_decode", None, cs.MAIN["d"]),
                               ("deepseek_decode", cs.DEEPSEEK, 128),
                               ("jamba_decode", cs.JAMBA, 128)):
            gen.manual_seed(0)
            case = cs.paged_case(torch, gen, qdt=bf16, kvdt=bf16, dk=d, dv=d,
                                 shape=shape)
            emit("paged_attention", name, cs.time_ms(
                lambda: pa.paged_attention(**case), torch, flush),
                dtype="bfloat16")
    if "flash_attention" in names:
        from repro_torch.kernels import flash_attention as fa
        gen.manual_seed(2)
        for name, (N, T, S0, H, Hkv, dh, window, idx, n_tok) in \
                cs.FLASH_CASES.items():
            for dt in (torch.bfloat16, torch.float32):
                S = S0 + T if S0 else T
                q, k, v = (torch.randn(N, n, h, dh, generator=gen,
                                       device="cuda").to(dt)
                           for n, h in ((T, H), (S, Hkv), (S, Hkv)))
                kw = dict(causal=True, window=window)
                if S0:
                    kw["q_pos"], kw["k_pos"] = cs.flash_positions(
                        torch, N, S0, T, idx, n_tok, window)
                emit("flash_attention", name, cs.time_ms(
                    lambda: fa.flash_attention(q, k, v, **kw), torch, flush),
                    dtype=str(dt).split(".")[-1])
                del q, k, v
    if "wkv6" in names:
        from repro_torch.kernels import wkv6 as wk
        gen.manual_seed(4)
        for name, case in cs.WKV_CASES.items():
            K, B, T = case[:3]
            H, dh = cs.WKV_HEADS["H"], cs.WKV_HEADS["dh"]
            nbytes = 4 * (5 * K * B * T * H * dh + 2 * K * B * H * dh * dh)
            sets = copies(lambda: cs.wkv_inputs(torch, gen, *case,
                                                **cs.WKV_HEADS), nbytes)
            calls = [lambda x=x: wk.wkv6(*x[:5], x[6]) for x in sets]
            emit("wkv6", name, cs.time_ms(calls[0], torch, flush),
                 b2b_ms=back_to_back_ms(calls, torch, flush, cs),
                 plan=getattr(wk, "plan", dict)())
            del sets, calls
    if "ssm_scan" in names:
        from repro_torch.kernels import ssm_scan as ssk
        gen.manual_seed(5)
        for name, case in cs.SCAN_CASES.items():
            K, B, T = case[:3]
            D, Ns = cs.SCAN_DIMS["D"], cs.SCAN_DIMS["Ns"]
            nbytes = 4 * (3 * K * B * T * D * Ns + 2 * K * B * D * Ns)
            sets = copies(lambda: cs.scan_inputs(torch, gen, *case,
                                                 **cs.SCAN_DIMS), nbytes)
            calls = [lambda x=x: ssk.ssm_scan(x[0], x[1], x[3]) for x in sets]
            emit("ssm_scan", name, cs.time_ms(calls[0], torch, flush),
                 b2b_ms=back_to_back_ms(calls, torch, flush, cs),
                 plan=getattr(ssk, "plan", dict)())
            del sets, calls
        K, B, _, warm = cs.SCAN_CASES["decode"]
        for T in SCAN_SWEEP_T:
            a, b, pool, state = cs.scan_inputs(torch, gen, K, B, T, warm,
                                               **cs.SCAN_DIMS)
            emit("ssm_scan", f"decode_shape_T{T}", cs.time_ms(
                lambda: ssk.ssm_scan(a, b, state), torch, flush),
                plan=getattr(ssk, "plan", dict)())
            del a, b, pool, state
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
