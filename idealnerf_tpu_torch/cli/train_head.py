"""Train the head model (counterpart of idealnerf_tpu/cli/train_head.py).

    python -m idealnerf_tpu_torch.cli.train_head --synthetic 4 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32 \\
        --epochs 5 --device cuda

On ``--device cuda`` (the default) every field call of a step runs the
fused point-MLP kernel and its gradient kernel (``--train_fused`` 1 or 2);
on cpu their plain versions. Checkpoints go to ``--ckpt_dir`` (default
``<basedir>/<expname>/ckpt``) every ``--i_weights`` steps and at the end.
``main(argv)`` returns {"step", "ckpt_dir", "history"}: the final step,
the checkpoint directory and the (step, metrics) of every log point.
"""

from __future__ import annotations

import logging
import os

import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, make_summary, resolve_config, resolve_dataset,
)
from idealnerf_tpu_torch.train.head import HeadTrainer

logger = logging.getLogger("idealnerf.cli")


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--data_devices", type=int, default=0,
                        help="frames per step over several devices "
                             "(not ported)")
    parser.add_argument("--ray_devices", type=int, default=0,
                        help="shard each frame's rays over devices "
                             "(not ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    args = parser.parse_args(argv)
    for flag in ("data_devices", "ray_devices"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP.md A13 (multi-device))")
    cfg = resolve_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    dataset = resolve_dataset(args, cfg, mode="train")
    run_dir = os.path.join(cfg.basedir, cfg.expname)
    cfg.write(os.path.join(run_dir, "args.txt"))
    ckpt_dir = args.ckpt_dir or os.path.join(run_dir, "ckpt")
    trainer = HeadTrainer(cfg, dataset, seed=args.seed, ckpt_dir=ckpt_dir,
                          device=device)
    summary = make_summary(cfg, run_dir)
    logger.info("train_head: %d frames, variant=%s, N_rand=%d, device %s",
                dataset.size, cfg.model_variant, cfg.N_rand, device)
    history = []

    def on_metrics(step, m):
        history.append((step, m))
        summary.scalars(step, m)
        logger.info("[TRAIN] step %d loss %.5f psnr %.2f lr %.2e "
                    "(%.2f steps/s)", step, m["loss"], m["psnr"], m["lr"],
                    m["steps_per_sec_rolling"])

    with summary:
        trainer.run(n_epochs=args.epochs, on_metrics=on_metrics)
    trainer.save()
    logger.info("done at step %d; checkpoints in %s", trainer.global_step,
                ckpt_dir)
    return {"step": trainer.global_step, "ckpt_dir": ckpt_dir,
            "history": history}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
