"""End-to-end LM training on the port: EC-DNN on a transformer
with top-M pseudo-label compression.  The twin of the JAX package's
examples/train_ec_dnn.py.

Uses the gemma3-1b REDUCED config (same family: 5:1 SWA pattern, GQA,
geglu, tied embeddings) with 4 members, the all-gather relabel, top-M
labels, AdamW + cosine, checkpointing and resume.  The same command
with a full-width config is what launch/train.py runs on the card.

  python -m repro_torch.examples.train_ec_dnn --rounds 3      # the card
  python -m repro_torch.examples.train_ec_dnn --device cpu --rounds 3
"""
import argparse
import tempfile

from repro_torch.common.device import entry_device
from repro_torch.common.types import ECConfig
from repro_torch.configs import registry
from repro_torch.data import lm_member_datasets
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.runtime.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tau", type=int, default=12)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--top-m", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)

    cfg = registry.get_config(args.arch, reduced=True)
    train, test = lm_member_datasets(args.members, per_member=128,
                                     seq_len=args.seq_len,
                                     vocab=cfg.vocab_size, device=dev)
    ec = ECConfig(tau=args.tau, lam=0.5, p_steps=args.tau // 2,
                  relabel_fraction=0.5, label_mode="topk",
                  top_m=args.top_m, aggregator="ec")
    opt = adamw(linear_warmup_cosine(3e-3, warmup=8,
                                     total_steps=args.rounds * args.tau))
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="ec_ckpt_")
    tr = Trainer(cfg, ec, opt, args.members, 0, train, test,
                 batch_size=args.batch, ckpt_dir=ckpt, device=dev)
    if tr.resume():
        print(f"resumed from round {tr.round}")
    start = tr.round

    print(f"EC-DNN LM: {args.arch}(reduced) K={args.members} "
          f"top-M={args.top_m} tau={args.tau} on {dev}")
    gaps = []
    for r in range(start, args.rounds):
        loss = tr.run_round()
        ev = tr.evaluate()
        gaps.append(ev["local_loss"] - ev["global_loss"])
        print(f"round {r}: train ce={loss:.4f} | member nll="
              f"{ev['local_loss']:.4f} ensemble nll={ev['global_loss']:.4f}"
              f" (gap {gaps[-1]:+.4f})")
    tr.save()
    tr.ckpt.close()
    _, k = tr.best_member()
    print(f"EC-DNN_L: member {k}; checkpoints in {ckpt}")
    return {"start_round": start, "jensen_gaps": gaps, "best_member": k,
            "ckpt": ckpt}


if __name__ == "__main__":
    main()
