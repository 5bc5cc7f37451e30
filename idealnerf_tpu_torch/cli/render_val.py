"""Render the val split through the head model to a video + metrics
(counterpart of idealnerf_tpu/cli/render_val.py).

    python -m idealnerf_tpu_torch.cli.render_val --synthetic 3 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32 \\
        [--pruned 40 [--prior_masked 1 [--occ_prior 1]]] [--tighten_bounds 1]

Each frame is the fused coarse + fine kernel pair on ``--device``
(default cuda; on cpu the kernels' plain PyTorch versions run), or with
``--pruned`` the foreground-pruned fast frame (two K1 launches:
eval/renderer.make_pruned_frame_renderer), on the subject's foreground
prior with ``--prior_masked`` and cut to the trained field's occupancy
with ``--occ_prior`` (cached beside the checkpoint). ``--tighten_bounds``
samples within the trained head's own depth band (subject_depth_range,
cached in the checkpoint's depth_bands.json). The frames go to
``<save_path>/<expname>_val.avi`` (25 fps MJPG), every 10th also as
``<expname>_val_<i:05d>.jpg``. ``--ray_devices R`` renders each frame
with its rays split over R ranks, one process each
(parallel/sharded.make_sharded_frame_renderer; refused with ``--pruned``,
whose ray selection is per frame, as the JAX CLI refuses it); rank 0
writes the video.
``main(argv)`` returns {"psnr", "ssim", "frame_ms", "frames"}: mean
PSNR/SSIM over the frames, the mean wall time per frame after the first,
taken around work that ends in a device synchronize, and the frames
clamped to [0, 1] as one (n, H, W, 3) f32 array; with
``--tighten_bounds`` also "tightened_bounds", the (near, far) used.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, load_head, resolve_config, resolve_dataset,
    resolve_device,
)
from idealnerf_tpu_torch.eval.metrics import psnr, ssim
from idealnerf_tpu_torch.eval.renderer import (
    cached_depth_band, cached_occupancy_prior, field_occupancy_prior,
    foreground_prior, make_frame_renderer, make_pruned_frame_renderer,
    subject_depth_range,
)
from idealnerf_tpu_torch.eval.video import VideoWriter
from idealnerf_tpu_torch.models.variants import (
    variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.parallel.launch import launch, main_first
from idealnerf_tpu_torch.train.head import compute_aud_feature

logger = logging.getLogger("idealnerf.cli")

def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--head_ckpt", type=str, required=False,
                        help="checkpoint directory written by train_head")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--pruned", type=int, default=0,
                        help="foreground-pruned fast eval path; a value "
                             ">1 is the keep percentage (e.g. 40)")
    parser.add_argument("--prior_masked", type=int, default=0,
                        help="with --pruned: restrict all network work "
                             "to the subject's foreground prior (union "
                             "of train-split face rects + torso parse "
                             "masks, eval/renderer.foreground_prior)")
    parser.add_argument("--ray_devices", type=int, default=0,
                        help="split each frame's rays over this many "
                             "ranks (full-fidelity frames only)")
    parser.add_argument("--head_parse", type=int, default=0,
                        help="with --prior_masked: tighten the prior "
                             "from face-rect boxes to parse silhouettes")
    parser.add_argument("--occ_prior", type=int, default=0,
                        help="with --prior_masked: also cut rays where "
                             "the trained coarse field carries ~zero "
                             "foreground mass on probe train frames "
                             "(field_occupancy_prior); cached beside the "
                             "checkpoint")
    parser.add_argument("--keep_basis", choices=("frame", "mask"),
                        default="frame",
                        help="what --pruned's keep %% is a fraction of "
                             "under --prior_masked: 'frame' (the unmasked "
                             "pruned budget) or 'mask'")
    parser.add_argument("--tighten_bounds", type=int, default=0,
                        help="tighten [near,far] to the trained model's "
                             "own depth band (subject_depth_range)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on")
    args = parser.parse_args(argv)
    if args.prior_masked and not args.pruned:
        parser.error("--prior_masked requires --pruned (the prior mask "
                     "only applies to the pruned fast path)")
    if args.ray_devices and args.pruned:
        parser.error("--ray_devices applies to full-fidelity renders "
                     "only (not with --pruned: its ray selection is "
                     "host-side)")
    device = resolve_device(args.device)
    if args.ray_devices:
        return launch(_render, 1, args.ray_devices, device=device,
                      args=(args,))[0]
    return _render(None, args)


def _render(mesh, args):
    """The val render on one device (``mesh`` None) or on this rank of a
    ray-sharded mesh."""
    cfg = resolve_config(args)
    device = torch.device(args.device) if mesh is None else mesh.device
    ds = resolve_dataset(args, cfg, mode="val")
    state = load_head(args, cfg, ds.size)
    params = state.params.to(device)
    latent_codes = state.latent_codes.to(device)

    H, W = ds.hw
    head_cfg = variant_nerf_config(cfg)
    near, far = ds.near, ds.far
    ds_train = None
    if args.tighten_bounds:
        ds_train = resolve_dataset(args, cfg, mode="train")
        near, far = main_first(mesh, lambda: cached_depth_band(
            args.head_ckpt, "head", state.step,
            lambda: subject_depth_range(cfg, params, latent_codes,
                                        ds_train)))
        logger.info("tightened bounds: [%.4f, %.4f] (config: [%.4f, %.4f])",
                    near, far, ds.near, ds.far)
    if args.pruned:
        prior_mask = k_coarse = None
        if args.prior_masked:
            # the prior is a train-time subject statistic
            if ds_train is None:
                ds_train = resolve_dataset(args, cfg, mode="train")
            prior_mask, k_coarse = foreground_prior(
                ds_train, head_parse=bool(args.head_parse))
            if args.occ_prior:
                prior_mask, k_coarse = _occupancy_prior(
                    args, cfg, state, params, latent_codes, ds_train, ds,
                    head_cfg, prior_mask, near, far)
            logger.info("subject prior: %.1f%% coverage, k_coarse %d",
                        100.0 * float(prior_mask.mean()), k_coarse)
        render = make_pruned_frame_renderer(
            head_cfg, H, W, ds.focal, near, far, cfg.render_config(),
            cx=ds.cx, cy=ds.cy,
            keep_fraction=args.pruned / 100.0 if args.pruned > 1 else 0.4,
            prior_mask=prior_mask, k_coarse=k_coarse,
            keep_basis=args.keep_basis)
    elif mesh is not None:
        from idealnerf_tpu_torch.parallel import make_sharded_frame_renderer

        tile = min(8192, H * W)
        tile -= tile % mesh.n_ray
        logger.info("ray-sharded eval over %d ranks (%s)", mesh.n_ray,
                    mesh.backend)
        render = make_sharded_frame_renderer(
            head_cfg, mesh, H, W, ds.focal, near, far, cfg.render_config(),
            cx=ds.cx, cy=ds.cy, tile=tile)
    else:
        render = make_frame_renderer(head_cfg, H, W, ds.focal, near, far,
                                     cfg.render_config(), cx=ds.cx,
                                     cy=ds.cy)
    data = ds.to_device(device)
    bc = data["bc_img"].float() / 255.0
    smooth = cfg.dim_aud > 29 and state.step >= cfg.nosmo_iters

    save_path = cfg.save_path or "output/render"
    out = os.path.join(save_path, f"{cfg.expname}_val.avi")
    n = ds.size if args.max_frames is None else min(args.max_frames, ds.size)
    psnrs, ssims, times, frames = [], [], [], []
    with torch.no_grad(), (VideoWriter(out) if mesh is None or mesh.is_main
                           else contextlib.nullcontext()) as writer:
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
            if writer is not None:
                writer.add(frames[-1])
            logger.info("val frame %d/%d psnr %.2f ssim %.3f (%.1f ms)",
                        i + 1, n, psnrs[-1], ssims[-1], times[-1])
    frame_ms = float(np.mean(times[1:] if n > 1 else times))
    logger.info("val set: mean PSNR %.2f, mean SSIM %.3f, %.1f ms/frame -> %s",
                float(np.mean(psnrs)), float(np.mean(ssims)), frame_ms,
                out)
    res = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
           "frame_ms": frame_ms, "frames": np.stack(frames)}
    if args.tighten_bounds:
        res["tightened_bounds"] = (near, far)
    return res


def _occupancy_prior(args, cfg, state, params, latent_codes, ds_train, ds,
                     head_cfg, base, near, far):
    """``--occ_prior``: the base prior cut to where the trained coarse
    field carries foreground mass on up to 8 evenly spaced train frames,
    cached beside the checkpoint -> (mask, k_coarse)."""
    smooth = cfg.dim_aud > 29 and state.step >= cfg.nosmo_iters
    dev = latent_codes.device
    auds, aud_ids, exprs = (torch.from_numpy(np.asarray(getattr(
        ds_train, k))).to(dev) for k in ("auds", "aud_ids", "exprs"))
    latent = latent_codes[0] if cfg.dim_latent > 0 else None
    probe_ids = list(range(0, ds_train.size,
                           max(1, ds_train.size // 8)))[:8]
    conds, poses = [], []
    with torch.no_grad():
        for i in probe_ids:
            aud = compute_aud_feature(params, auds, aud_ids.long(), i, cfg,
                                      smooth)
            expr = exprs[i] if cfg.dim_expr > 0 else None
            conds.append(variant_conditioning(params, cfg, aud, expr))
            poses.append(ds_train.poses[i])
    H, W = ds.hw
    key = dict(base_mask=base, poses=poses, conds=conds, near=near, far=far)
    mask, k = cached_occupancy_prior(
        args.head_ckpt, state.step,
        lambda: field_occupancy_prior(
            head_cfg, params, H, W, ds.focal, poses, conds, near, far,
            cfg.render_config(), base, cx=ds.cx, cy=ds.cy, latent=latent),
        latent=latent, **key)
    logger.info("occupancy cut: %.1f%% -> %.1f%% coverage",
                100.0 * float(base.mean()), 100.0 * float(mask.mean()))
    return mask, k


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
