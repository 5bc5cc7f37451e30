"""Cross-subject reenactment (counterpart of
idealnerf_tpu/cli/eval_reenact.py): full fidelity one frame at a time,
the per-frame fast mode with ``--fast K`` (the fine pass on K % of the
rays by coarse opacity; ``--prior 1`` restricts it to the identity's
foreground prior), or with ``--temporal R`` the temporal depth-cache
renderers (a keyframe every R frames); with ``--torso_ckpt`` each frame
is the head + torso composite. ``--tighten_bounds 1`` (head-only) samples
within the trained head's own depth band (subject_depth_range, cached in
the checkpoint's depth_bands.json).

    python -m idealnerf_tpu_torch.cli.eval_reenact --synthetic 3 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32 \\
        --head_ckpt logs/exp/ckpt --torso_ckpt logs/exp_torso/ckpt \\
        [--fast 40 --prior 1 | --temporal 25 --prior 1 [--cycle 0] \\
         [--freeze_z_torso 1] [--roll_k_torso 4]]

The identity (poses, plate, latent) comes from the dataset, the driving
expressions from ``--evalExpr_path`` (another subject's transforms json;
default the identity's own), the driving audio from ``--aud_file`` (with
``--synthetic``, the identity's own windows). Frames render on
``--device`` (default cuda; on cpu the kernels' plain versions run) and
are written as ``<save_path>/<expname>.avi`` (25 fps MJPG, every 10th
frame also as a .jpg). ``main(argv)``
returns {"frames", "frame_ms", "psnr", "video"}: the frame count, the mean
wall ms per frame after the first (each frame's time ends when its pixels
reach the host), the mean PSNR against the identity's frames (its com
images with ``--torso_ckpt``) and the frames (N, H, W, 3). ``--cycle``
(default 1, off under ``--roll_k_torso``) is checked as the JAX CLI checks
it, but changes nothing here: the JAX package scans a cycle's delta frames
in one dispatch, and on the card every frame runs through the per-frame
loop, which gives the same frames.

``--auto_temporal DIR`` applies the quality-gated temporal video
configuration measured in DIR (the ``temporal_delta*.json`` evidence of
``python -m idealnerf_tpu_torch.scripts.temporal_delta``;
eval/operating_points.gated_video_config), the composite's with
``--torso_ckpt``, else the head's: it sets ``--temporal``, the delta-frame
flags, ``--prior 1`` and the keyframe sample rung as the JAX CLI does
(``apply_operating_point``). Where no measured point holds the gate the
CLI refuses (exit code 2).

``--ray_devices R`` / ``--data_devices D`` render on a (D, R) mesh of
ranks, one process each (an axis left at 0 is 1, as in the JAX CLI):
each full-fidelity frame's rays split over R ranks, D frames a batch
(eval/reenact.py ``mesh``); refused with ``--fast`` and ``--temporal``
as the JAX reenact refuses them. Rank 0 writes the video.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, load_head, load_torso, resolve_config, resolve_dataset,
    resolve_device,
)
from idealnerf_tpu_torch.eval.metrics import psnr
from idealnerf_tpu_torch.eval.operating_points import gated_video_config
from idealnerf_tpu_torch.eval.renderer import (
    cached_depth_band, subject_depth_range,
)
from idealnerf_tpu_torch.eval.reenact import (
    check_mesh_modes, load_driving_exprs, reenact,
)
from idealnerf_tpu_torch.eval.temporal import check_roll_k
from idealnerf_tpu_torch.parallel.launch import launch, main_first, mesh_shape

logger = logging.getLogger("idealnerf.cli")


def apply_operating_point(args, conf: dict) -> None:
    """Set the temporal flags of ``args`` from a gated_video_config dict,
    as the JAX CLI maps it: the keyframe interval, the delta-frame knobs
    of both fields, the prior and the keyframe sample rung."""
    args.temporal = conf["refresh"]
    args.s_delta = conf["s_delta"]
    args.s_delta_torso = conf["s_delta_torso"]
    args.delta_keep = conf["delta_keep"]
    args.delta_keep_torso = conf.get("delta_keep_torso")
    args.freeze_z_torso = int(conf.get("freeze_z_torso", False))
    args.uni_frac = conf.get("uni_frac", 0.25)
    args.kf_blend = conf.get("kf_blend", 0.0)
    args.dilate_every = conf.get("dilate_every", 1)
    args.roll_k_torso = conf.get("roll_k_torso", 0) or 0
    args.head_parse = int(conf.get("head_parse", False))
    args.prior = 1
    if conf["keyframe_rung"]:
        s_kf, imp_kf = map(int, conf["keyframe_rung"].split("+"))
        args.N_samples, args.N_importance = s_kf, imp_kf


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
    parser.add_argument("--fast", type=int, default=0,
                        help="pruned fast eval: keep percentage for the "
                             "fine pass (e.g. 40); 0 = full fidelity")
    parser.add_argument("--tighten_bounds", type=int, default=0,
                        help="tighten [near,far] to the trained head's "
                             "own depth band (subject_depth_range); "
                             "head-only renders")
    parser.add_argument("--ray_devices", type=int, default=0,
                        help="split each frame's rays over this many ranks "
                             "(full-fidelity frames)")
    parser.add_argument("--data_devices", type=int, default=0,
                        help="frames a batch, one a 'data' rank")
    parser.add_argument("--auto_temporal", type=str, default=None,
                        metavar="EVIDENCE_DIR",
                        help="apply the quality-gated temporal video "
                             "configuration measured in this dir "
                             "(scripts/temporal_delta.py output); refuses "
                             "if no measured point holds the gate")
    parser.add_argument("--prior", type=int, default=0,
                        help="with --fast or --temporal: restrict network "
                             "work to the identity's foreground prior (per "
                             "field with --torso_ckpt)")
    parser.add_argument("--temporal", type=int, default=0,
                        help="temporal depth-cache video: keyframe interval "
                             "in frames; the frames in between resample "
                             "each ray's cached depth band")
    parser.add_argument("--s_delta", type=int, default=32,
                        help="with --temporal: samples per ray on delta "
                             "frames")
    parser.add_argument("--s_delta_torso", type=int, default=None,
                        help="torso delta samples (default --s_delta)")
    parser.add_argument("--delta_keep", type=float, default=1.0,
                        help="with --temporal: fraction of prior rays "
                             "re-rendered on delta frames")
    parser.add_argument("--delta_keep_torso", type=float, default=None,
                        help="torso delta keep (default --delta_keep)")
    parser.add_argument("--freeze_z_torso", type=int, default=0,
                        help="torso delta frames re-render the keyframe's "
                             "depth grid")
    parser.add_argument("--uni_frac", type=float, default=0.25,
                        help="with --temporal: fraction of delta in-band "
                             "samples placed uniformly across the band")
    parser.add_argument("--kf_blend", type=float, default=0.0,
                        help="with --temporal: fraction of delta importance "
                             "samples drawn from the keyframe's CDF")
    parser.add_argument("--dilate_every", type=int, default=1,
                        help="with --temporal: dilate the bands on every "
                             "k-th delta frame only")
    parser.add_argument("--head_parse", type=int, default=0,
                        help="tighten the head prior from face rects to "
                             "parse silhouettes")
    parser.add_argument("--roll_k_torso", type=int, default=0,
                        help="with --temporal + --torso_ckpt: torso "
                             "refresh-only roll, 1/K of the torso rays at "
                             "the keyframe schedule every frame (forces "
                             "--cycle 0)")
    parser.add_argument("--cycle", type=int, default=1,
                        help="with --temporal: the JAX CLI's scanned delta "
                             "cycle; accepted for parity, the frames run "
                             "through the per-frame loop either way")
    args = parser.parse_args(argv)
    if args.auto_temporal:
        mode = "comp" if args.torso_ckpt else "head"
        conf = gated_video_config(args.auto_temporal, mode)
        if conf is None:
            parser.error(
                f"--auto_temporal: no measured {mode} operating point in "
                f"{args.auto_temporal} holds the quality gate - run python "
                "-m idealnerf_tpu_torch.scripts.temporal_delta on this "
                "subject's trained checkpoints first")
        apply_operating_point(args, conf)
        logger.info("auto temporal (%s, quality-gated): refresh %d, "
                    "s_delta %s/%s, delta_keep %.2f, keyframe rung %s",
                    mode, args.temporal, args.s_delta, args.s_delta_torso,
                    args.delta_keep, conf["keyframe_rung"])
    check_roll_k("--roll_k_torso", args.roll_k_torso)
    if args.tighten_bounds and args.torso_ckpt:
        parser.error("--tighten_bounds is head-only from the CLI; "
                     "composite tightening runs through "
                     "scripts/composite_delta.py --tighten "
                     "(per-field bands)")
    device = resolve_device(args.device)
    shape = mesh_shape(args.data_devices, args.ray_devices, device,
                       fill=False)
    if shape is not None:
        check_mesh_modes(shape, args.fast / 100.0 if args.fast else None,
                         args.temporal or None)
        return launch(_reenact, *shape, device=device, args=(args,))[0]
    return _reenact(None, args)


def _reenact(mesh, args):
    """The reenactment on one device (``mesh`` None) or on this rank of a
    mesh."""
    cfg = resolve_config(args)
    device = torch.device(args.device) if mesh is None else mesh.device
    identity = resolve_dataset(
        args, cfg, mode="val",
        gt_dirs="com_imgs" if args.torso_ckpt else None)
    state = load_head(args, cfg, identity.size)  # reenact uses latent 0
    torso = load_torso(args.torso_ckpt, cfg, device)

    exprs = (load_driving_exprs(cfg.evalExpr_path) if cfg.evalExpr_path
             else identity.exprs)  # self-reenactment
    if args.synthetic:
        auds = identity.auds
    else:
        auds = np.load(os.path.join(cfg.datadir, cfg.aud_file)).astype(
            np.float32)

    params = state.params.to(device)
    bounds = None
    if args.tighten_bounds:
        bounds = main_first(mesh, lambda: cached_depth_band(
            args.head_ckpt, "head", state.step,
            lambda: subject_depth_range(
                cfg, params, state.latent_codes.to(device),
                resolve_dataset(args, cfg, mode="train"))))
        logger.info("tightened bounds: [%.4f, %.4f]", *bounds)

    save_path = cfg.save_path or "output/render"
    times = []
    frames = reenact(
        cfg, params, identity, driving_auds=auds,
        driving_exprs=exprs, latent_codes=state.latent_codes,
        torso_params=torso,
        out_path=os.path.join(save_path, f"{cfg.expname}.avi"),
        max_frames=args.max_frames,
        smooth_audio=cfg.nosmo_iters <= state.step, frame_times=times,
        fast_keep=args.fast / 100.0 if args.fast else None, bounds=bounds,
        use_prior=bool(args.prior), temporal=args.temporal or None,
        s_delta=args.s_delta, s_delta_torso=args.s_delta_torso,
        delta_keep=args.delta_keep, delta_keep_torso=args.delta_keep_torso,
        freeze_z_torso=bool(args.freeze_z_torso), uni_frac=args.uni_frac,
        kf_blend=args.kf_blend, dilate_every=args.dilate_every,
        roll_k_torso=args.roll_k_torso, head_parse=bool(args.head_parse),
        cycle=bool(args.cycle) and not args.roll_k_torso, mesh=mesh)
    n = frames.shape[0]
    gt = identity.images[np.arange(n) % identity.size].astype(
        np.float32) / 255.0
    res = {"frames": n,
           "frame_ms": 1e3 * float(np.mean(times[1:] if n > 1 else times)),
           "psnr": float(np.mean([float(psnr(torch.from_numpy(f),
                                             torch.from_numpy(g)))
                                  for f, g in zip(frames, gt)])),
           "video": frames}
    logger.info("reenact: %d frames, %.1f ms/frame, PSNR %.2f against the "
                "identity's frames -> %s", n, res["frame_ms"], res["psnr"],
                save_path)
    return res


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
