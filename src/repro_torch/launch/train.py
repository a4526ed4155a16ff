"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--reduced | --full]`` with auto-resume from ``--ckpt-dir`` — counterpart
of ``repro/launch/train.py``, plus ``--device`` (default ``cuda``; ``cpu``
trains on the host).  A CUDA device that is not there is an error, not a
fall back to the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt2-small")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", dest="resume", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device is available (pass "
              "--device cpu to train on the host)", file=sys.stderr)
        return 2
    try:
        cfg = get_config(args.arch, reduced=args.reduced)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    trainer = Trainer(
        cfg,
        TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, resume=args.resume),
        PipelineConfig(seq_len=args.seq_len, global_batch=args.batch),
        AdamWConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=min(20, args.steps // 5)),
        device=device)
    out = trainer.run(on_step=lambda s, m: print(
        f"step {s:5d} loss {m['loss']:.4f} lr {m['lr']:.2e}", flush=True))
    print(f"done: {out['steps']} steps, final loss {out['final_loss']:.4f}, "
          f"{out['wall_s']:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
