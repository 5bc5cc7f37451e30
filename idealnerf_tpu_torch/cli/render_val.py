"""Render the val split through the head model to a video + metrics
(counterpart of idealnerf_tpu/cli/render_val.py, full-fidelity mode).

    python -m idealnerf_tpu_torch.cli.render_val --synthetic 3 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32

Each frame is the fused coarse + fine kernel pair on ``--device``
(default cuda; on cpu the kernels' plain PyTorch versions run). The frames
go to ``<save_path>/<expname>_val.avi`` (25 fps MJPG), every 10th also as
``<expname>_val_<i:05d>.jpg``.
``main(argv)`` returns {"psnr", "ssim", "frame_ms", "frames"}: mean
PSNR/SSIM over the frames, the mean wall time per frame after the first,
taken around work that ends in a device synchronize, and the frames
clamped to [0, 1] as one (n, H, W, 3) f32 array.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, load_head, resolve_config, resolve_dataset,
)
from idealnerf_tpu_torch.eval.metrics import psnr, ssim
from idealnerf_tpu_torch.eval.renderer import make_frame_renderer
from idealnerf_tpu_torch.eval.video import VideoWriter
from idealnerf_tpu_torch.models.variants import (
    variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.train.head import compute_aud_feature

logger = logging.getLogger("idealnerf.cli")

# render modes of the JAX CLI that the port does not have yet
_NOT_PORTED = {
    "pruned": "A9 (per-frame fast modes)",
    "prior_masked": "A9 (per-frame fast modes)",
    "tighten_bounds": "A9 (per-frame fast modes)",
    "ray_devices": "A13 (multi-device)",
}


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--head_ckpt", type=str, required=False,
                        help="checkpoint directory written by train_head")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--pruned", type=int, default=0,
                        help="foreground-pruned fast eval path (not ported)")
    parser.add_argument("--prior_masked", type=int, default=0,
                        help="with --pruned: subject-prior mask (not ported)")
    parser.add_argument("--ray_devices", type=int, default=0,
                        help="shard each frame's rays over devices "
                             "(not ported)")
    parser.add_argument("--head_parse", type=int, default=0,
                        help="with --prior_masked (not ported)")
    parser.add_argument("--occ_prior", type=int, default=0,
                        help="with --prior_masked (not ported)")
    parser.add_argument("--keep_basis", choices=("frame", "mask"),
                        default="frame", help="with --pruned (not ported)")
    parser.add_argument("--tighten_bounds", type=int, default=0,
                        help="tighten [near,far] to the model's depth band "
                             "(not ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on")
    args = parser.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP.md {item})")
    cfg = resolve_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")

    ds = resolve_dataset(args, cfg, mode="val")
    state = load_head(args, cfg, ds.size)
    params = state.params.to(device)
    latent_codes = state.latent_codes.to(device)

    H, W = ds.hw
    render = make_frame_renderer(
        variant_nerf_config(cfg), H, W, ds.focal, ds.near, ds.far,
        cfg.render_config(), cx=ds.cx, cy=ds.cy)
    data = ds.to_device(device)
    bc = data["bc_img"].float() / 255.0
    smooth = cfg.dim_aud > 29 and state.step >= cfg.nosmo_iters

    save_path = cfg.save_path or "output/render"
    out = os.path.join(save_path, f"{cfg.expname}_val.avi")
    n = ds.size if args.max_frames is None else min(args.max_frames, ds.size)
    psnrs, ssims, times, frames = [], [], [], []
    with torch.no_grad(), VideoWriter(out) as writer:
        for i in range(n):
            t0 = time.perf_counter()
            aud = compute_aud_feature(params, data["auds"], data["aud_ids"],
                                      i, cfg, smooth)
            expr = data["exprs"][i] if cfg.dim_expr > 0 else None
            aud_arg, expr_arg = variant_conditioning(params, cfg, aud, expr)
            # eval uses latent_codes[0], as the reference does
            latent = latent_codes[0] if cfg.dim_latent > 0 else None
            frame = render(params, data["poses"][i], bc, aud=aud_arg,
                           expr=expr_arg, latent=latent)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append(1e3 * (time.perf_counter() - t0))
            gt = data["images"][i].float() / 255.0
            psnrs.append(float(psnr(frame, gt)))
            ssims.append(ssim(frame, gt))
            frames.append(frame.clamp(0, 1).cpu().numpy())
            writer.add(frames[-1])
            logger.info("val frame %d/%d psnr %.2f ssim %.3f (%.1f ms)",
                        i + 1, n, psnrs[-1], ssims[-1], times[-1])
    frame_ms = float(np.mean(times[1:] if n > 1 else times))
    logger.info("val set: mean PSNR %.2f, mean SSIM %.3f, %.1f ms/frame -> %s",
                float(np.mean(psnrs)), float(np.mean(ssims)), frame_ms,
                out)
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "frame_ms": frame_ms, "frames": np.stack(frames)}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
