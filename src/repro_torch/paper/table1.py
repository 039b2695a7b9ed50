"""Paper Table 1 on the port: final test error of EC-DNN vs MA-DNN (vs
S-DNN).  The twin of the JAX package's benchmarks/table1.py.

Trains EC / MA / sequential (K=1) under identical budgets on the
synthetic CIFAR-100 stand-in and reports EC_L, EC_G, MA_L, MA_G, S-DNN
test errors.  The claim validated is the ORDERING (EC_G < EC_L <= S and
EC_* < MA_*), not the absolute numbers (synthetic data).  Every EC
distill step goes through the fused distillation kernel on the card.

  python -m repro_torch.paper.table1                 # the card
  python -m repro_torch.paper.table1 --device cpu --fast
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.device import entry_device
from repro_torch.common.tree import tree_map
from repro_torch.paper.common import (Timer, make_data, make_trainer,
                                      std_parser)


def run(rounds: int, tau: int, K: int, seed: int = 0,
        device=None) -> dict:
    train, test = make_data(seed, K, device=device)
    out = {}
    for aggr in ("ec", "ma"):
        tr = make_trainer(aggr, K, tau, seed, train, test, seed=seed,
                          device=device)
        for _ in range(rounds):
            tr.run_round()
        ev = tr.evaluate(record=False)
        out[f"{aggr.upper()}-DNN_L"] = ev["local_err"]
        out[f"{aggr.upper()}-DNN_G"] = ev["global_err"]
    # S-DNN: one worker, same total budget (rounds*tau steps, all data)
    flat_train = tree_map(lambda a: a.reshape((1, -1) + a.shape[2:]), train)
    tr = make_trainer("ec", 1, tau, seed, flat_train, test, seed=seed,
                      device=device)
    tr.ec = dataclasses.replace(tr.ec, aggregator="ma")
    for _ in range(rounds):
        tr.run_round()
    out["S-DNN"] = tr.evaluate(record=False)["local_err"]
    return out


def main(argv=None):
    ap = std_parser(__doc__)
    args = ap.parse_args(argv)
    rounds = 3 if args.fast else args.rounds
    tau = 6 if args.fast else args.tau
    dev = entry_device(args.device)
    t = Timer(dev)
    print(f"# Table 1 (synthetic stand-in) K={args.members} tau={tau} "
          f"rounds={rounds} on {dev}")
    res = run(rounds, tau, args.members, args.seed, device=dev)
    for k, v in res.items():
        print(f"  {k:10s} test error = {v:.4f}")
    if args.fast:
        print(f"  (fast mode: {rounds * tau} steps is mechanics-checking "
              f"only; ordering claims need the full run)  ({t():.1f}s)")
    else:
        ec_beats_ma = (res["EC-DNN_L"] <= res["MA-DNN_L"] + 0.02
                       and res["EC-DNN_G"] <= res["MA-DNN_G"] + 0.02)
        print(f"  ordering EC<=MA: {'OK' if ec_beats_ma else 'VIOLATED'} "
              f"({t():.1f}s)")
    return res


if __name__ == "__main__":
    main()
