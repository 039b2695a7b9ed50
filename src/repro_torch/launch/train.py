"""Training launcher for the PyTorch/CUDA port: EC-DNN / MA-DNN /
sync-SGD rounds of K members on one device.

Runs on the card unless --device cpu.  The default is the paper's own
setup: NiN (paper_nin) on 32x32x3 synthetic CIFAR-100 stand-in data
with momentum SGD and dense pseudo-labels, whose compression steps go
through the fused distillation kernel.  The LMs (gemma3-1b,
deepseek-7b, rwkv6-7b, jamba-v0.1-52b) train with AdamW on synthetic
affine token streams, with dense or top-M (--label-mode topk)
pseudo-labels.  --ckpt DIR saves the state after every round (the JAX
package's layout, keep 3); --resume first restores the newest committed
round there and runs the rounds left up to --rounds.

  python -m repro_torch.launch.train --arch paper_nin --members 4 \
      --rounds 4 --tau 16 --p-steps 8 --batch 64 --per-member 1024
  python -m repro_torch.launch.train --device cpu --members 2 \
      --rounds 2 --tau 2 --p-steps 1 --batch 4 --per-member 16
  python -m repro_torch.launch.train --arch gemma3-1b --reduced \
      --label-mode topk --device cpu --members 2 --rounds 2 --tau 2 \
      --p-steps 1 --batch 2 --per-member 8 --seq-len 16
  python -m repro_torch.launch.train --arch rwkv6-7b --reduced \
      --device cpu --members 2 --rounds 2 --tau 2 --p-steps 1 --batch 2 \
      --per-member 8 --seq-len 16 --ckpt /tmp/ec_ckpt --resume

Prints one line per round (the last step's training loss, then the
members' and the ensemble's test NLL and error) and the EC-DNN_L pick.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper_nin")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--aggregator", default="ec",
                    choices=["ec", "ma", "sync"])
    ap.add_argument("--protocol", default="ring",
                    choices=["ring", "allgather"],
                    help="the relabel's protocol over a member mesh "
                         "(Trainer(mesh=...)); this CLI trains on one "
                         "device, where the relabel is the all-gather")
    ap.add_argument("--label-mode", default="dense",
                    choices=["dense", "topk"])
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--tau", type=int, default=16)
    ap.add_argument("--p-steps", type=int, default=8)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--relabel-fraction", type=float, default=0.7)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--per-member", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-drop", type=int, default=0,
                    help="simulate N lagging members dropped per round")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.common.device import entry_device
    from repro_torch.common.types import ECConfig
    from repro_torch.configs import registry
    from repro_torch.data import image_member_datasets, lm_member_datasets
    from repro_torch.optim import adamw, sgd_momentum
    from repro_torch.runtime.trainer import Trainer

    device = entry_device(args.device)
    cfg = registry.get_config(args.arch, reduced=args.reduced)
    rng = np.random.default_rng(args.seed)
    if cfg.family == "cnn":
        train, test = image_member_datasets(
            args.members, args.per_member, n_classes=cfg.vocab_size,
            seed=args.seed, device=device)
        opt = sgd_momentum(args.lr, momentum=0.9)
    else:
        train, test = lm_member_datasets(
            args.members, args.per_member, args.seq_len, cfg.vocab_size,
            seed=args.seed, device=device)
        opt = adamw(args.lr)
    ec = ECConfig(tau=args.tau, lam=args.lam, p_steps=args.p_steps,
                  relabel_fraction=args.relabel_fraction,
                  label_mode=args.label_mode, aggregator=args.aggregator,
                  protocol=args.protocol)
    tr = Trainer(cfg, ec, opt, args.members, args.seed, train, test,
                 batch_size=args.batch, ckpt_dir=args.ckpt, seed=args.seed,
                 device=device)
    if args.resume and tr.resume():
        print(f"resumed from round {tr.round}")

    for r in range(tr.round, args.rounds):
        mask = None
        if args.straggler_drop:
            mask = np.ones(args.members)
            drop = rng.choice(args.members, args.straggler_drop,
                              replace=False)
            mask[drop] = 0.0
            print(f"round {r}: dropping stragglers {sorted(drop)}")
        loss = tr.run_round(straggler_mask=mask)
        ev = tr.evaluate()
        print(f"round {r:3d} | train {loss:.4f} | local nll "
              f"{ev['local_loss']:.4f} err {ev['local_err']:.4f} | "
              f"{'ens' if args.aggregator == 'ec' else 'global'} nll "
              f"{ev['global_loss']:.4f} err {ev['global_err']:.4f}")
    tr.save()
    if tr.ckpt:
        tr.ckpt.close()
    _, k = tr.best_member()
    print(f"final model: member {k} (EC-DNN_L rule)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
