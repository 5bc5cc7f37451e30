"""Cross-subject reenactment, full fidelity, one frame at a time
(counterpart of idealnerf_tpu/cli/eval_reenact.py); with ``--torso_ckpt``
each frame is the head + torso composite.

    python -m idealnerf_tpu_torch.cli.eval_reenact --synthetic 3 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32 \\
        --head_ckpt logs/exp/ckpt --torso_ckpt logs/exp_torso/ckpt

The identity (poses, plate, latent) comes from the dataset, the driving
expressions from ``--evalExpr_path`` (another subject's transforms json;
default the identity's own), the driving audio from ``--aud_file`` (with
``--synthetic``, the identity's own windows). Frames render on
``--device`` (default cuda; on cpu the kernels' plain versions run) and
are written as ``<save_path>/<expname>_reenact_*.png``. ``main(argv)``
returns {"frames", "frame_ms", "psnr"}: the frame count, the mean wall ms
per frame after the first (each frame's time ends when its pixels reach
the host) and the mean PSNR against the identity's frames (its com images
with ``--torso_ckpt``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.cli.common import (
    build_parser, load_head, resolve_config, resolve_dataset,
)
from idealnerf_tpu_torch.eval.metrics import psnr
from idealnerf_tpu_torch.eval.reenact import load_driving_exprs, reenact
from idealnerf_tpu_torch.train.torso import init_torso_params

logger = logging.getLogger("idealnerf.cli")

# modes of the JAX CLI that the port does not have yet
_NOT_PORTED = {
    "temporal": "A7b (temporal composite video)",
    "cycle": "A7b (temporal composite video)",
    "auto_temporal": "A9 (eval/operating_points.gated_video_config)",
    "fast": "A9 (per-frame fast modes)",
    "prior": "A9 (per-frame fast modes)",
    "tighten_bounds": "A9 (per-frame fast modes)",
    "ray_devices": "A13 (multi-device)",
    "data_devices": "A13 (multi-device)",
}


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--head_ckpt", type=str, required=False,
                        help="checkpoint directory written by train_head")
    parser.add_argument("--torso_ckpt", type=str, default=None,
                        help="checkpoint directory written by train_torso: "
                             "render the head + torso composite")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on")
    for flag in ("temporal", "cycle", "fast", "prior", "tighten_bounds",
                 "ray_devices", "data_devices"):
        parser.add_argument(f"--{flag}", type=int, default=0,
                            help="not ported")
    parser.add_argument("--auto_temporal", type=str, default=None,
                        metavar="EVIDENCE_DIR", help="not ported")
    args = parser.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP.md {item})")
    cfg = resolve_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")

    identity = resolve_dataset(
        args, cfg, mode="val",
        gt_dirs="com_imgs" if args.torso_ckpt else None)
    state = load_head(args, cfg, identity.size)  # reenact uses latent 0
    torso = None
    if args.torso_ckpt:
        torso = init_torso_params(cfg)
        torso.load_state_dict(
            CheckpointManager(args.torso_ckpt).restore()["torso_params"])
        torso = torso.to(device)

    exprs = (load_driving_exprs(cfg.evalExpr_path) if cfg.evalExpr_path
             else identity.exprs)  # self-reenactment
    if args.synthetic:
        auds = identity.auds
    else:
        auds = np.load(os.path.join(cfg.datadir, cfg.aud_file)).astype(
            np.float32)

    save_path = cfg.save_path or "output/render"
    times = []
    frames = reenact(
        cfg, state.params.to(device), identity, driving_auds=auds,
        driving_exprs=exprs, latent_codes=state.latent_codes,
        torso_params=torso,
        out_path=os.path.join(save_path, f"{cfg.expname}_reenact"),
        max_frames=args.max_frames,
        smooth_audio=cfg.nosmo_iters <= state.step, frame_times=times)
    n = frames.shape[0]
    gt = identity.images[np.arange(n) % identity.size].astype(
        np.float32) / 255.0
    res = {"frames": n,
           "frame_ms": 1e3 * float(np.mean(times[1:] if n > 1 else times)),
           "psnr": float(np.mean([float(psnr(torch.from_numpy(f),
                                             torch.from_numpy(g)))
                                  for f, g in zip(frames, gt)]))}
    logger.info("reenact: %d frames, %.1f ms/frame, PSNR %.2f against the "
                "identity's frames -> %s", n, res["frame_ms"], res["psnr"],
                save_path)
    return res


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
