#!/usr/bin/env python3
"""Times the paged-attention kernel over every launch layout (head
group gh, pages a stage, splits) at deepseek-v2's absorbed MLA decode
shape and at gemma3-1b's decode shape.

    python3 scripts/paged_group_sweep.py [--dtypes bfloat16,float32]
        [--shapes mla,gemma3]

One JSON line per (shape, dtype, gh, pages a stage, splits): device ms (CUDA
events, L2 flushed, enqueue hidden: chip_smoke.time_ms), the grid's
blocks, the block's shared memory and how many such blocks share an SM
by shared memory alone (`paged_attention.blocks_per_sm`), the waves of
the grid over the card's SMs, and the error against the plain version.
The last line names the fastest layout of each (shape, dtype) and the
one the wrapper's `launch_plan` picks, with both times.  Shapes
and inputs are chip_smoke.py's phase-1 cases: "mla" is 16 rows of 128
heads over one latent head of 512, rope 64, lens 300-544, v is k;
"gemma3" is 16 rows of 4 heads over one kv head of 256, lens 1-576.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (1, 2, 3, 4, 5, 6, 8, 9, 12, 17, 34)
# name -> (chip_smoke shape name or None for MAIN, dk = dv, dr, v is k)
SHAPES = {"mla": ("DEEPSEEK_V2", 512, 64, True),
          "gemma3": (None, 256, 0, False)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("paged_group_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    card = cs.card_line()
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    lib = pa._library()
    n_sm = pa.sm_count(torch.device("cuda"))
    best = {}
    for shape_name, dt_name in ((s, d) for s in args.shapes.split(",")
                                for d in args.dtypes.split(",")):
        shape, d, dr, shared = SHAPES[shape_name]
        dt = getattr(torch, dt_name)
        gen.manual_seed(0)
        case = cs.paged_case(torch, gen, qdt=dt, kvdt=dt, dk=d, dv=d, dr=dr,
                             shape=shape and getattr(cs, shape),
                             shared=shared)
        q, kp, vp = case["q"], case["k_pages"], case["v_pages"]
        ke = case.get("k_extra")
        table, lens = case["table"], case["lens"]
        B, H, _ = q.shape
        n_pages, page, Hkv, dk = kp.shape
        P = table.shape[1]
        want = ref.paged_attention(**case).float()
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        code = pa._Q_CODES[dt]
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((B, H, dk), dtype=dt, device="cuda")

        def launcher(gh, ppt, split):
            part = (torch.empty((B * H, split, dk + 2), dtype=torch.float32,
                                device="cuda") if split > 1 else None)

            def call():
                err = lib.paged_attention_launch(
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    table.data_ptr(), lens.data_ptr(), None, None,
                    None if ke is None else ke.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(), B, H, Hkv,
                    dk, dk, dr, n_pages, page, P, 0, ppt, split, gh,
                    int(shared), case.get("scale", (dk + dr) ** -0.5),
                    code, code, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return call

        rows = []
        for gh in (d for d in range(1, H // Hkv + 1) if H // Hkv % d == 0):
            for ppt in (1, 2):
                smem = pa.smem_bytes(gh, dk, dk, dr, page, P, ppt,
                                     kp.element_size(), q.element_size(),
                                     shared)
                if smem > pa.SMEM_MAX:
                    continue
                for split in (x for x in SPLITS if x <= P):
                    call = launcher(gh, ppt, split)
                    call()
                    torch.cuda.synchronize()
                    err = (out.float() - want).abs().max().item()
                    if not err <= tol:
                        raise AssertionError(f"gh {gh} ppt {ppt} split "
                                             f"{split}: error {err}")
                    blocks = B * Hkv * (H // Hkv // gh) * split
                    per_sm = pa.blocks_per_sm(smem)
                    row = {"card": card, "shape": shape_name,
                           "dtype": dt_name, "gh": gh,
                           "pages_a_stage": ppt, "splits": split,
                           "blocks": blocks, "smem": smem,
                           "blocks_per_sm": per_sm,
                           "waves": blocks / (per_sm * n_sm),
                           "max_abs_err": err,
                           "ms": cs.time_ms(call, torch, flush,
                                            iters=args.iters)}
                    cs.emit(row)
                    rows.append(row)
        gh, ppt, split = pa.launch_plan(B, H, Hkv, dk, dk, dr, page, P,
                                        kp.element_size(), q.element_size(),
                                        shared, n_sm)
        picked = [r for r in rows if (r["gh"], r["pages_a_stage"],
                                      r["splits"]) == (gh, ppt, split)]
        fastest = min(rows, key=lambda r: r["ms"])
        best[f"{shape_name} {dt_name}"] = {
            "fastest": {k: fastest[k] for k in
                        ("gh", "pages_a_stage", "splits", "ms")},
            "plan": {"gh": gh, "pages_a_stage": ppt, "splits": split,
                     "ms": picked[0]["ms"] if picked else cs.time_ms(
                         launcher(gh, ppt, split), torch, flush,
                         iters=args.iters)}}
        del case, q, kp, vp, ke, want, out
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "sms": n_sm, "best": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
