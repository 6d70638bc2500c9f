"""Training launcher (port of `repro.launch.train`, with the same flags and
a `--device`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
      --smoke --steps 30 --ckpt-dir /tmp/ckpt

--smoke trains the reduced same-family config; without it the full
config is trained at --seq-len x --batch, in one microbatch as in the
reference. The model runs on `--device` (default: the card; it raises
without one). `--device cpu` runs on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_model, reduced_model
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.loop import TrainConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    args = ap.parse_args()

    model = get_model(args.arch)
    if args.smoke:
        model = reduced_model(model)
    shape = ShapeConfig("local", seq_len=args.seq_len,
                        global_batch=args.batch, kind="train")
    run = RunConfig(model=model, shape=shape, remat=True, microbatches=1,
                    attn_block_q=min(64, args.seq_len),
                    attn_block_k=min(64, args.seq_len))
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       opt=opt_mod.OptConfig(lr=args.lr, warmup_steps=20))
    out = train(model, run, tcfg, device=args.device)
    hist = out["history"]
    if hist:
        print(f"first loss {hist[0]['loss']:.4f} -> last "
              f"{hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
