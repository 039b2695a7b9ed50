"""Aggregation-protocol communication cost: MA vs EC variants, per arch.
The twin of the JAX package's benchmarks/aggregation_cost.py.

The paper's Section 4.3 argues EC's extra cost over MA is only the
relabeling pass.  Over a member axis the picture sharpens into
bytes-on-wire per aggregation round (per ensemble-axis link):

  MA              |params| bytes all-reduced (x2 for ring all-reduce)
  EC naive        K x |params| broadcast (the paper's GPU realization)
  EC ring dense   K x relabel_tokens x V x 4  (output distributions)
  EC ring top-M   K x relabel_tokens x (M*8+4) (this framework's default)

Numbers are analytic from the arch configs.  |params| is counted on the
meta device (models.init(device="meta"): shapes and dtypes, no storage),
so llama3-405b's 812 GB and arctic-480b's 954 GB are counted, not
allocated.  Nothing runs on a card.

  python -m repro_torch.paper.aggregation_cost [--fast]
"""
from __future__ import annotations

from repro_torch import models
from repro_torch.common.tree import tree_leaves
from repro_torch.common.types import SHAPES
from repro_torch.configs import registry
from repro_torch.core.compression import bytes_per_token

ARCH_IDS = registry.LM_ARCH_IDS


def relabel_tokens(per_member_tokens: int, fraction: float) -> int:
    """Tokens a member's relabel subset holds."""
    return int(per_member_tokens * fraction)


def ring_topm_bytes(members: int, tokens: int, top_m: int) -> int:
    """A ring round's top-M accumulator traffic on one link: K hops (the
    last one home) of `tokens` accumulator entries."""
    return members * tokens * (bytes_per_token(top_m) + 4)


def param_bytes(arch: str) -> int:
    cfg = registry.get_config(arch)
    params = models.init(cfg, device="meta")
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(params))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--top-m", type=int, default=64)
    ap.add_argument("--relabel-fraction", type=float, default=0.7)
    ap.add_argument("--fast", action="store_true")
    args = ap.parse_args(argv)

    K = args.members
    shape = SHAPES["train_4k"]
    per_member_tokens = shape.global_batch // K * shape.seq_len
    tokens = relabel_tokens(per_member_tokens, args.relabel_fraction)

    archs = ("gemma3-1b", "llama3-405b") if args.fast else ARCH_IDS
    print(f"# aggregation bytes per round, K={K}, "
          f"relabel {tokens:,} tokens/member, top-M={args.top_m}")
    print(f"{'arch':20s} {'MA (x2 AR)':>12s} {'EC naive':>12s} "
          f"{'EC dense':>12s} {'EC top-M':>12s} {'vs naive':>9s}")
    rows = {}
    for arch in archs:
        cfg = registry.get_config(arch)
        pb = param_bytes(arch)
        ma = 2 * pb
        naive = K * pb
        dense = K * tokens * cfg.vocab_size * 4
        topm = ring_topm_bytes(K, tokens, args.top_m)
        rows[arch] = {"param_bytes": pb, "ma": ma, "naive": naive,
                      "dense": dense, "topm": topm}
        print(f"{arch:20s} {ma/2**30:10.2f}Gi {naive/2**30:10.2f}Gi "
              f"{dense/2**30:10.2f}Gi {topm/2**30:10.2f}Gi "
              f"{naive/topm:8.0f}x")
    print("\nEC's local phase moves ZERO bytes between aggregations — "
          "sync-SGD moves 2x|params| per STEP; with tau=40 that is "
          "~40x MA's round traffic.")
    return rows


if __name__ == "__main__":
    main()
