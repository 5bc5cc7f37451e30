"""Train the AD-NeRF baseline head (counterpart of
idealnerf_tpu/cli/train_baseline.py): audio-only conditioning, random
frame order, the precrop warm-up.

    python -m idealnerf_tpu_torch.cli.train_baseline --synthetic 4 \\
        --synthetic_hw 450 --dim_aud 64 --epochs 5 --device cuda

Runs on the kernels on ``--device cuda`` (the default), as train_head
does. ``main(argv)`` returns {"step", "ckpt_dir", "history"}.
"""

from __future__ import annotations

import logging
import os

import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, make_summary, resolve_config, resolve_dataset,
)
from idealnerf_tpu_torch.train.baseline import BaselineTrainer

logger = logging.getLogger("idealnerf.cli")


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    args = parser.parse_args(argv)
    cfg = resolve_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    dataset = resolve_dataset(args, cfg, mode="train")
    run_dir = os.path.join(cfg.basedir, cfg.expname)
    cfg.write(os.path.join(run_dir, "args.txt"))
    ckpt_dir = args.ckpt_dir or os.path.join(run_dir, "ckpt")
    trainer = BaselineTrainer(cfg, dataset, seed=args.seed,
                              ckpt_dir=ckpt_dir, device=device)
    summary = make_summary(cfg, run_dir)
    history = []

    def on_metrics(step, m):
        history.append((step, m))
        summary.scalars(step, m)
        logger.info("[BASELINE] step %d loss %.5f psnr %.2f", step,
                    m["loss"], m["psnr"])

    with summary:
        trainer.run(n_epochs=args.epochs, on_metrics=on_metrics)
    trainer.save()
    return {"step": trainer.global_step, "ckpt_dir": ckpt_dir,
            "history": history}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
