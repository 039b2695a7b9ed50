"""Quickstart: EC-DNN in ~40 lines, on the port.  The twin of the JAX
package's examples/quickstart.py.

Trains a 4-member ensemble on a synthetic image task, aggregates by
ensemble-compression each round, and prints the paper's Section-3
guarantee live: the ensemble's nll is never worse than the mean member
nll, while the parameter-average (MA) of the same members has no such
bound.

  python -m repro_torch.examples.quickstart               # the card
  python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

from repro_torch.common.device import entry_device
from repro_torch.common.tree import tree_map
from repro_torch.common.types import ECConfig, ModelConfig
from repro_torch.core import aggregation as agg
from repro_torch.data import image_member_datasets
from repro_torch.optim import sgd_momentum
from repro_torch.runtime.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    dev = entry_device(ap.parse_args(argv).device)
    K = 4
    cfg = ModelConfig(name="quickstart", family="cnn", n_layers=9,
                      d_model=96, vocab_size=10)
    train, test = image_member_datasets(K, per_member=256, n_classes=10,
                                        img=16, noise=0.5, device=dev)
    ec = ECConfig(tau=8, lam=0.5, p_steps=4, relabel_fraction=0.7,
                  label_mode="dense", aggregator="ec")
    trainer = Trainer(cfg, ec, sgd_momentum(0.05, momentum=0.9), K, 0,
                      train, test, batch_size=32, device=dev)

    print(f"EC-DNN: K={K} members, tau={ec.tau}, lambda0={ec.lam}, "
          f"p={ec.p_steps}, on {dev}")
    gaps = []
    for r in range(5):
        loss = trainer.run_round()
        ev = trainer.evaluate()
        gap = ev["local_loss"] - ev["global_loss"]
        gaps.append(gap)
        print(f"round {r}: train={loss:.3f}  member nll="
              f"{ev['local_loss']:.3f}  ensemble nll="
              f"{ev['global_loss']:.3f}  Jensen gap={gap:+.4f} (>= 0 "
              f"guaranteed)")

    # contrast: parameter-averaging the same members (MA) has no bound
    ma_params = agg.ma_aggregate(trainer.state["params"])
    nll, _ = trainer.evaluate_model(tree_map(lambda x: x[:1], ma_params))
    print(f"\nMA of the same members: nll={nll:.3f} "
          f"(vs ensemble {ev['global_loss']:.3f}) — no guarantee, and "
          f"usually worse.")
    _, k = trainer.best_member()
    print(f"EC-DNN_L final model: member {k} (lowest training loss)")
    return {"jensen_gaps": gaps, "ensemble_nll": ev["global_loss"],
            "ma_nll": nll, "best_member": k}


if __name__ == "__main__":
    main()
