"""The composite fast mode's quality cost on a trained head and torso
(counterpart of scripts/composite_delta.py).

Renders the first ``--frames`` frames of a subject's val clip as the
head + torso composite twice through ``eval.reenact.reenact``: at full
fidelity (``make_composite_frame_renderer``, the config's schedule and
bounds) and as the fast composite (``make_composite_fast_renderer``: the
per-field priors, the fine pass on ``--keep`` of the rays, ``--samples``
/ ``--importance`` in place of the config's schedule, and with
``--tighten`` each field's own depth band, the ``depth_bands.json`` the
checkpoints cache). It gives PSNR(fast vs full), the PSNR of each
against the ground-truth ``com_imgs`` and the time per frame: the
quality evidence that ``eval_reenact --tighten_bounds`` names for the
composite. The clip is driven by its own frames' audio windows (the JAX
script takes the track's first windows, which on a val split are not
the frames' own), unsmoothed as there.

The JAX script's keys are kept: ``s_per_frame_*_incl_compile`` is the
mean over all frames, the first included (the port compiles nothing at
run time), and ``fps_*_warm`` the rate over the frames after the first.

    python -m idealnerf_tpu_torch.scripts.composite_delta \\
        --subject_dir runs/rehearsal [--frames 6] [--keep 0.4] \\
        [--samples 16 --importance 32] [--tighten] \\
        [--head_ckpt DIR --torso_ckpt DIR] [--out PATH]

The checkpoints default to ``<basedir>/<expname>[_torso]/ckpt`` of the
subject's config, ``--out`` to ``<subject_dir>/composite_delta.json``.
``main`` also returns both clips under ``frames_rendered`` (not
written).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from idealnerf_tpu_torch.cli.common import load_head, load_torso
from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
from idealnerf_tpu_torch.eval.reenact import reenact
from idealnerf_tpu_torch.eval.renderer import (
    cached_depth_band, subject_depth_range, torso_depth_range,
)
from idealnerf_tpu_torch.scripts import device_of, timing
from idealnerf_tpu_torch.scripts.temporal_delta import psnr


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--subject_dir", required=True,
                   help="holds HeadNeRF_config.txt and the with-torso data")
    p.add_argument("--head_ckpt", default=None)
    p.add_argument("--torso_ckpt", default=None)
    p.add_argument("--frames", type=int, default=6)
    p.add_argument("--keep", type=float, default=0.4)
    p.add_argument("--samples", type=int, default=None,
                   help="N_samples of the fast mode (the full render keeps "
                        "the config's schedule)")
    p.add_argument("--importance", type=int, default=None,
                   help="N_importance of the fast mode")
    p.add_argument("--tighten", action="store_true",
                   help="the fast mode samples each field's own depth "
                        "band; the full render stays at the config's "
                        "bounds, so the delta includes the tightening")
    timing.add_common(p, "output json path (default "
                         "<subject_dir>/composite_delta.json)")
    args = p.parse_args(argv)
    if args.smoke:
        args.frames = min(args.frames, 2)
    dev = device_of(args.device)
    cfg = ExperimentConfig.from_file(
        os.path.join(args.subject_dir, "HeadNeRF_config.txt"))
    head_ckpt = args.head_ckpt or os.path.join(cfg.basedir, cfg.expname,
                                               "ckpt")
    torso_ckpt = args.torso_ckpt or os.path.join(
        cfg.basedir, cfg.expname + "_torso", "ckpt")
    identity = load_transforms_dataset(cfg.datadir, mode="val",
                                       near=cfg.near, far=cfg.far,
                                       gt_dirs="com_imgs")
    state = load_head(argparse.Namespace(seed=0, head_ckpt=head_ckpt), cfg,
                      identity.size)
    head_params = state.params.to(dev)
    latents = state.latent_codes.to(dev)
    torso_params = load_torso(torso_ckpt, cfg, dev)
    n = min(args.frames, identity.size)
    common = dict(driving_auds=identity.auds[identity.aud_ids[:n]],
                  driving_exprs=identity.exprs[:n] if cfg.dim_expr else None,
                  latent_codes=latents, torso_params=torso_params,
                  max_frames=n, smooth_audio=False)
    before = timing.launch_snapshot()
    times_full: list = []
    full = reenact(cfg, head_params, identity, frame_times=times_full,
                   **common)

    bounds = None
    if args.tighten:
        ds_train = load_transforms_dataset(cfg.datadir, mode="train",
                                           near=cfg.near, far=cfg.far)
        bh = cached_depth_band(
            head_ckpt, "head", state.step,
            lambda: subject_depth_range(cfg, head_params, latents, ds_train))
        bt = cached_depth_band(
            torso_ckpt, "torso", CheckpointManager(torso_ckpt).latest_step(),
            lambda: torso_depth_range(cfg, torso_params, head_params,
                                      ds_train))
        bounds = {"head": [float(b) for b in bh],
                  "torso": [float(b) for b in bt]}
    cfg_fast = dataclasses.replace(
        cfg, N_samples=args.samples or cfg.N_samples,
        N_importance=args.importance or cfg.N_importance)
    times_fast: list = []
    fast = reenact(cfg_fast, head_params, identity, fast_keep=args.keep,
                   use_prior=True, bounds=bounds, frame_times=times_fast,
                   **common)

    def warm(ts):
        return sum(ts[1:]) / (len(ts) - 1) if len(ts) > 1 else ts[0]

    gt = identity.images[:n].astype(np.float32) / 255.0
    out = {
        "frames": n,
        "keep": args.keep,
        "tightened_bounds": bounds,
        "fast_schedule": f"{cfg_fast.N_samples}+{cfg_fast.N_importance}",
        "psnr_fast_vs_full": psnr(fast, full),
        "psnr_full_vs_gt": psnr(full, gt),
        "psnr_fast_vs_gt": psnr(fast, gt),
        "delta_psnr_vs_gt": psnr(full, gt) - psnr(fast, gt),
        "s_per_frame_full_incl_compile": sum(times_full) / n,
        "s_per_frame_fast_incl_compile": sum(times_fast) / n,
        "fps_full_warm": 1.0 / warm(times_full),
        "fps_fast_warm": 1.0 / warm(times_fast),
        "ms_per_frame_full_warm": 1e3 * warm(times_full),
        "ms_per_frame_fast_warm": 1e3 * warm(times_fast),
        "head_step": int(state.step),
        "launches": timing.launches_since(before),
        **timing.device_fields(dev),
    }
    timing.write_json(args.out or os.path.join(args.subject_dir,
                                               "composite_delta.json"), out)
    print(json.dumps(out))
    return dict(out, frames_rendered={"full": full, "fast": fast})


if __name__ == "__main__":
    main()
