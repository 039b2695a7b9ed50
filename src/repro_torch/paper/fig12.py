"""Paper Figures 1-2 on the port: per-round global-vs-local gap, MA vs
EC.  The twin of the JAX package's benchmarks/fig12.py.

Figure 1 (MA): the parameter-averaged global model is frequently WORSE
than the mean local model (paper: >40% of rounds, up to +40pp error).
Figure 2 (EC): the ensemble global model is better in EVERY round
(Jensen), and the compressed model retains most of the gain.

This experiment trains both and reports:
  - %% rounds where MA global is worse than the local mean,
  - EC's per-round (local - global) gap (must be >= 0 for nll),
  - EC's compressed-model gap after the distill phase.

  python -m repro_torch.paper.fig12                  # the card
  python -m repro_torch.paper.fig12 --device cpu --fast
"""
from __future__ import annotations

import numpy as np

from repro_torch.common.device import entry_device
from repro_torch.paper.common import (Timer, make_data, make_trainer,
                                      std_parser)


def main(argv=None):
    ap = std_parser(__doc__)
    args = ap.parse_args(argv)
    rounds = 3 if args.fast else max(args.rounds, 4)
    tau = 4 if args.fast else args.tau
    dev = entry_device(args.device)
    K = args.members
    train, test = make_data(args.seed, K, device=dev)
    t = Timer(dev)

    ma = make_trainer("ma", K, tau, args.seed, train, test, seed=args.seed,
                      device=dev)
    ma_gaps = []
    for _ in range(rounds):
        ma.run_round()
        ev = ma.evaluate()
        ma_gaps.append(ev["local_err"] - ev["global_err"])
    ma_bad = float(np.mean([g < 0 for g in ma_gaps]))

    ec = make_trainer("ec", K, tau, args.seed, train, test, seed=args.seed,
                      device=dev)
    ec_gaps, ec_nll_gaps, comp_gaps = [], [], []
    for _ in range(rounds):
        ec.run_round()
        ev = ec.evaluate()
        ec_gaps.append(ev["local_err"] - ev["global_err"])
        ec_nll_gaps.append(ev["local_loss"] - ev["global_loss"])
        before = ev["local_err"]
        ec.run_round()  # distill phase happens at the head of this round
        comp = ec.evaluate_compressed()
        comp_gaps.append(before - comp["compressed_err"])

    print(f"# Fig 1/2 stand-in  K={K} tau={tau} rounds={rounds} on {dev}")
    print(f"  MA: global worse than local mean in {ma_bad:.0%} of rounds "
          f"(gaps: {[f'{g:+.3f}' for g in ma_gaps]})")
    print(f"  EC: nll gap (local - ensemble) per round: "
          f"{[f'{g:+.3f}' for g in ec_nll_gaps]}")
    print(f"  EC: err gap per round: {[f'{g:+.3f}' for g in ec_gaps]}")
    print(f"  EC: compressed-model err gain vs pre-distill local: "
          f"{[f'{g:+.3f}' for g in comp_gaps]}")
    jensen_ok = all(g >= -1e-6 for g in ec_nll_gaps)
    print(f"  Jensen (EC ensemble nll <= mean local nll) every round: "
          f"{'OK' if jensen_ok else 'VIOLATED'}  ({t():.1f}s)")
    return {"ma_bad_fraction": ma_bad, "ec_nll_gaps": ec_nll_gaps,
            "jensen_ok": jensen_ok}


if __name__ == "__main__":
    main()
