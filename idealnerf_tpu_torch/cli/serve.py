"""Real-time serving CLI (counterpart of idealnerf_tpu/cli/serve.py):
stream a driving audio track through eval.stream.TemporalStream frame by
frame, as a live caller would, and report the latency a live session
sees. With ``--torso_ckpt`` every frame is the head + torso composite.

    python -m idealnerf_tpu_torch.cli.serve --synthetic 30 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32 \\
        [--head_ckpt <dir>] [--torso_ckpt <dir>] [--roll_k 4] \\
        [--save_path output/serve]

Frames render on ``--device`` (default cuda; on cpu the kernels' plain
PyTorch versions run); with ``--save_path`` they go to
``<save_path>/<expname or 'serve'>_stream.avi`` (25 fps MJPG, every 10th
frame also as a .jpg). ``main(argv)`` returns the JAX CLI's stats — frames,
roll_k, warmup_s, p50/p95/p99_ms and the 25 fps deadline hit rate over the
steady frames (those after the first refresh interval), steady_fps — plus
the split by frame kind: keyframes and keyframe_ms (their mean), delta
frames and delta_p50_ms / delta_p95_ms. Each frame's time ends when its
pixels reach the host, which waits for the device.

``--auto_temporal DIR`` serves at the quality-gated operating point
measured in DIR (the ``temporal_delta*.json`` evidence of
``python -m idealnerf_tpu_torch.scripts.temporal_delta``;
eval/operating_points.gated_video_config): the composite's with
``--torso_ckpt``, else the head's. The point sets the keyframe interval,
the delta-frame knobs and the keyframe sample rung; ``--roll_k K`` needs
evidence measured at that rolling cadence. Where no measured point holds
the gate the CLI refuses (exit code 2) and serves nothing.
``--roll_k_torso K`` gives the torso a refresh-only roll by hand (the JAX
CLI has no such flag and takes it from the operating point only).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os

import numpy as np
import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, load_head, load_torso, resolve_config, resolve_dataset,
)
from idealnerf_tpu_torch.eval.operating_points import gated_video_config
from idealnerf_tpu_torch.eval.stream import TemporalStream
from idealnerf_tpu_torch.eval.temporal import check_roll_k
from idealnerf_tpu_torch.eval.video import VideoWriter

logger = logging.getLogger("idealnerf.cli")


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--head_ckpt", type=str, required=False,
                        help="checkpoint directory written by train_head")
    parser.add_argument("--torso_ckpt", type=str, default=None,
                        help="checkpoint directory written by train_torso: "
                             "serve the head + torso composite")
    parser.add_argument("--auto_temporal", type=str, default=None,
                        metavar="EVIDENCE_DIR",
                        help="serve at the quality-gated temporal "
                             "operating point measured in this dir "
                             "(scripts/temporal_delta.py output)")
    parser.add_argument("--refresh", type=int, default=25,
                        help="keyframe interval")
    parser.add_argument("--s_delta", type=int, default=16)
    parser.add_argument("--delta_keep", type=float, default=1.0)
    parser.add_argument("--roll_k", type=int, default=0,
                        help="rolling keyframe refresh: no keyframe "
                             "spikes, every frame pays a delta frame + 1/K "
                             "of a keyframe")
    parser.add_argument("--roll_k_torso", type=int, default=0,
                        help="torso refresh-only roll: every frame "
                             "re-renders 1/K of the torso rays at the "
                             "keyframe schedule, with no torso delta pass")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--no_smooth", action="store_true",
                        help="skip AudioAttNet smoothing: zero lookahead")
    parser.add_argument("--prior", type=int, default=1,
                        help="restrict network work to the subject's "
                             "foreground prior (per field with "
                             "--torso_ckpt)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on")
    args = parser.parse_args(argv)
    check_roll_k("--roll_k", args.roll_k)
    check_roll_k("--roll_k_torso", args.roll_k_torso)
    if args.roll_k and args.roll_k_torso:
        raise ValueError("--roll_k and --roll_k_torso are exclusive")
    op = None
    if args.auto_temporal:
        mode = "comp" if args.torso_ckpt else "head"
        # a rolling cadence gates on evidence measured at that cadence: a
        # keyframed gate says nothing about unbounded-horizon drift
        op = gated_video_config(args.auto_temporal, mode,
                                roll_k=args.roll_k)
        if op is None:
            what = (f"roll_k={args.roll_k} rolling" if args.roll_k
                    else "keyframed")
            parser.error(
                f"--auto_temporal: no gated {mode} {what} operating point "
                f"in {args.auto_temporal} - run python -m "
                f"idealnerf_tpu_torch.scripts.temporal_delta"
                + (f" --roll_k {args.roll_k}" if args.roll_k else "")
                + " on this subject's trained checkpoints first")
        logger.info("auto temporal (%s, quality-gated): %s", mode, op)
    cfg = resolve_config(args)
    if op and op.get("keyframe_rung"):
        s_kf, imp_kf = map(int, op["keyframe_rung"].split("+"))
        cfg = dataclasses.replace(cfg, N_samples=s_kf, N_importance=imp_kf)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    identity = resolve_dataset(args, cfg, mode="val")

    state = load_head(args, cfg, identity.size)
    params, latents = state.params.to(device), state.latent_codes
    torso = load_torso(args.torso_ckpt, cfg, device)

    auds = identity.auds
    n = auds.shape[0] if args.max_frames is None else min(
        args.max_frames, auds.shape[0])
    stream = TemporalStream(
        cfg, params, identity, torso_params=torso, latent_codes=latents,
        operating_point=op, refresh=args.refresh, s_delta=args.s_delta,
        delta_keep=args.delta_keep, roll_k=args.roll_k,
        roll_k_torso=args.roll_k_torso, use_prior=bool(args.prior),
        smooth_audio=not args.no_smooth)
    warmup_s = stream.warmup()
    logger.info("warmup %.1fs; refresh %d, lookahead %d frames",
                warmup_s, stream.refresh, stream.algorithmic_latency_frames)

    save = (VideoWriter(os.path.join(
        cfg.save_path, f"{cfg.expname or 'serve'}_stream.avi"))
        if cfg.save_path else contextlib.nullcontext())

    def frames():
        for i in range(n):
            f = stream.push(auds[i], expr=identity.exprs[i % identity.size])
            if f is not None:
                yield f
        yield from stream.flush()

    emitted, finite = 0, True
    with save as writer:
        for f in frames():
            emitted += 1
            finite = finite and bool(np.isfinite(f).all())
            if writer is not None:
                writer.add(f)
    if emitted != n:
        raise RuntimeError(f"stream emitted {emitted} of {n} frames")

    times = np.asarray(stream.frame_times) * 1000.0
    kinds = np.asarray(stream.frame_kinds)
    skip = stream.roll_k if stream.roll_k else stream.refresh
    steady = times[skip:] if len(times) > skip else times
    key, delta = times[kinds == "keyframe"], times[kinds == "delta"]
    stats = {
        "frames": int(n),
        "roll_k": stream.roll_k,
        "warmup_s": warmup_s,
        "p50_ms": float(np.percentile(steady, 50)),
        "p95_ms": float(np.percentile(steady, 95)),
        "p99_ms": float(np.percentile(steady, 99)),
        "deadline_40ms_hit_rate": float((steady <= 40.0).mean()),
        "steady_fps": 1000.0 / float(steady.mean()),
        "keyframes": int(key.size),
        "keyframe_ms": float(key.mean()) if key.size else None,
        "delta_frames": int(delta.size),
        "delta_p50_ms": float(np.percentile(delta, 50)) if delta.size else None,
        "delta_p95_ms": float(np.percentile(delta, 95)) if delta.size else None,
        "finite": finite,
    }
    logger.info("serve stats: %s", json.dumps(stats))
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
