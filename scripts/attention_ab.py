#!/usr/bin/env python3
"""Times the port's two attention kernels from a given checkout's
`src/` at chip_smoke.py's bf16 and f32 shapes, one JSON line per case.

    python3 scripts/attention_ab.py --src /path/to/checkout/src

Run it once per checkout, alternating (A, B, B, A) in one command on
one card, to compare two versions of the kernels: the cases and the
timing (CUDA events, L2 flushed, enqueue hidden) are this repository's
chip_smoke.py, the kernels are those under --src, built there.  The
paged cases are gemma3-1b's, deepseek-7b's and jamba's decode shapes;
the flash cases are phase 7's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the src/ directory whose kernels are timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.src))   # ahead of ROOT/src
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    assert os.path.dirname(build.__file__).startswith(
        os.path.abspath(args.src))
    build.build_all(["paged_attention", "flash_attention"])
    card = cs.card_line()
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    bf16 = torch.bfloat16
    for name, shape, d in (("gemma3_decode", None, cs.MAIN["d"]),
                           ("deepseek_decode", cs.DEEPSEEK, 128),
                           ("jamba_decode", cs.JAMBA, 128)):
        gen.manual_seed(0)
        case = cs.paged_case(torch, gen, qdt=bf16, kvdt=bf16, dk=d, dv=d,
                             shape=shape)
        ms = cs.time_ms(lambda: pa.paged_attention(**case), torch, flush)
        cs.emit({"src": args.src, "card": card, "kernel": "paged_attention",
                 "case": name, "dtype": "bfloat16", "ms": ms})
    gen.manual_seed(2)
    for name, (N, T, S0, H, Hkv, dh, window, idx, n_tok) in \
            cs.FLASH_CASES.items():
        for dt in (bf16, torch.float32):
            S = S0 + T if S0 else T
            q, k, v = (torch.randn(N, n, h, dh, generator=gen,
                                   device="cuda").to(dt)
                       for n, h in ((T, H), (S, Hkv), (S, Hkv)))
            kw = dict(causal=True, window=window)
            if S0:
                kw["q_pos"], kw["k_pos"] = cs.flash_positions(
                    torch, N, S0, T, idx, n_tok, window)
            ms = cs.time_ms(lambda: fa.flash_attention(q, k, v, **kw), torch,
                            flush)
            cs.emit({"src": args.src, "card": card,
                     "kernel": "flash_attention", "case": name,
                     "dtype": str(dt).split(".")[-1], "ms": ms})
            del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
