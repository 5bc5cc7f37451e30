"""Train the torso against a frozen head checkpoint on com images
(counterpart of idealnerf_tpu/cli/train_torso.py).

    python -m idealnerf_tpu_torch.cli.train_torso --synthetic 4 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32 \\
        --head_ckpt logs/exp/ckpt --steps 2000

The head (params, latent table) is restored from ``--head_ckpt``, a
train_head checkpoint directory, or drawn fresh with a warning. On
``--device cuda`` (the default) both fields of a step run the fused point
MLP kernel, and the torso's backward the gradient kernel (``--train_fused``
1 or 2); on cpu their plain versions. Without ``--synthetic`` the subject
is the ``com_imgs`` of the reference-format directory ``--datadir``.
``--steps`` defaults to N_iters times the frame count. The metrics of
every ``--i_print``-th step go to ``<vis_path or basedir/expname_torso>/
metrics.jsonl`` as ``torso/<name>``. The checkpoint is written at the end
to ``--ckpt_dir`` (default ``<basedir>/<expname>_torso/ckpt``).
``main(argv)`` returns {"step", "ckpt_dir", "history", "head_params"}: the
final step, the checkpoint directory, the (step, metrics) of every log
point (every ``--i_print`` steps) and the frozen head as it stands after
training. ``--data_devices`` / ``--ray_devices`` train on a mesh of
ranks as ``train_head``'s do (parallel/trainers.py: ShardedTorsoTrainer).
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, load_head, make_summary, resolve_config, resolve_dataset,
    resolve_device,
)
from idealnerf_tpu_torch.parallel.launch import launch, mesh_shape
from idealnerf_tpu_torch.train.torso import TorsoTrainer

logger = logging.getLogger("idealnerf.cli")


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--head_ckpt", type=str, required=False,
                        help="checkpoint directory written by train_head")
    parser.add_argument("--steps", type=int, default=None,
                        help="torso optimisation steps")
    parser.add_argument("--smooth_audio", dest="cli_smooth_audio", type=int,
                        default=1)
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
    dataset = resolve_dataset(args, cfg, mode="train", gt_dirs="com_imgs")

    # the frozen head; its optimizer state is not needed
    state = load_head(args, cfg, dataset.size)

    run_dir = os.path.join(cfg.basedir, cfg.expname + "_torso")
    if main_rank:
        cfg.write(os.path.join(run_dir, "args.txt"))
    ckpt_dir = args.ckpt_dir or os.path.join(run_dir, "ckpt")
    kw = dict(latent_codes=state.latent_codes, seed=args.seed,
              smooth_audio=bool(args.cli_smooth_audio), ckpt_dir=ckpt_dir)
    if mesh is None:
        trainer = TorsoTrainer(cfg, dataset, state.params, device=device,
                               **kw)
    else:
        from idealnerf_tpu_torch.parallel import ShardedTorsoTrainer

        trainer = ShardedTorsoTrainer(cfg, dataset, state.params, mesh, **kw)
        logger.info("mesh %s, %s, %s", mesh.shape, mesh.backend, device)
    summary = (make_summary(cfg, run_dir) if main_rank
               else contextlib.nullcontext())
    n_steps = args.steps or cfg.N_iters * dataset.size
    logger.info("train_torso: %d steps on %d frames, N_rand=%d, device %s",
                n_steps, dataset.size, cfg.N_rand, device)
    history = []

    def on_metrics(step, m):
        history.append((step, m))
        if main_rank:
            summary.scalars(step, m, prefix="torso")
        logger.info("[TORSO] step %d loss %.5f psnr %.2f (%.2f steps/s)",
                    step, m["loss"], m["psnr"], m["steps_per_sec_rolling"])

    with summary:
        trainer.run(n_steps=n_steps, log_every=cfg.i_print,
                    on_metrics=on_metrics)
    trainer.save()
    logger.info("done at step %d; checkpoints in %s", trainer.step, ckpt_dir)
    return {"step": trainer.step, "ckpt_dir": ckpt_dir, "history": history,
            "head_params": trainer.head_params}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
