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

``--data_devices D`` / ``--ray_devices R`` train on a ('data', 'ray')
mesh of ranks, one process each (parallel/launch.py): D frames a step,
each frame's N_rand rays over R ranks (parallel/trainers.py). An axis
left at 0 takes the devices the other leaves (at least 1). Rank 0 writes
the checkpoints and metrics, in the single-device layout.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, make_summary, resolve_config, resolve_dataset,
    resolve_device,
)
from idealnerf_tpu_torch.parallel.launch import launch, mesh_shape
from idealnerf_tpu_torch.train.head import HeadTrainer

logger = logging.getLogger("idealnerf.cli")


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--data_devices", type=int, default=0,
                        help="frames per step, one a 'data' rank of the "
                             "mesh; 0 = the single-device trainer")
    parser.add_argument("--ray_devices", type=int, default=0,
                        help="ranks each frame's rays split over (the "
                             "'ray' axis of the mesh)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    shape = mesh_shape(args.data_devices, args.ray_devices, device)
    if shape is not None:
        return launch(_train, *shape, device=device, args=(args,))[0]
    return _train(None, args)


def _train(mesh, args):
    """The run on one device (``mesh`` None) or on this rank of a mesh."""
    cfg = resolve_config(args)
    main_rank = mesh is None or mesh.is_main
    device = torch.device(args.device) if mesh is None else mesh.device
    dataset = resolve_dataset(args, cfg, mode="train")
    run_dir = os.path.join(cfg.basedir, cfg.expname)
    if main_rank:
        cfg.write(os.path.join(run_dir, "args.txt"))
    ckpt_dir = args.ckpt_dir or os.path.join(run_dir, "ckpt")
    if mesh is None:
        trainer = HeadTrainer(cfg, dataset, seed=args.seed,
                              ckpt_dir=ckpt_dir, device=device)
    else:
        from idealnerf_tpu_torch.parallel import ShardedHeadTrainer

        trainer = ShardedHeadTrainer(cfg, dataset, mesh, seed=args.seed,
                                     ckpt_dir=ckpt_dir)
        logger.info("mesh %s, %s, %s", mesh.shape, mesh.backend, device)
    summary = (make_summary(cfg, run_dir) if main_rank
               else contextlib.nullcontext())
    logger.info("train_head: %d frames, variant=%s, N_rand=%d, device %s",
                dataset.size, cfg.model_variant, cfg.N_rand, device)
    history = []

    def on_metrics(step, m):
        history.append((step, m))
        if main_rank:
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
