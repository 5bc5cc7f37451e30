"""The temporal gate harness (counterpart of scripts/temporal_delta.py):
the quality cost of keyframe + delta rendering on a trained subject.

Renders a clip of the subject's ``--split`` (sequential frames, as the
video eval does) as the head + torso composite at full fidelity and in
the temporal mode at each ``--s_delta`` operating point, then the same
head-only, through ``eval.reenact.reenact``; it writes PSNR(temporal vs
full), PSNR of each vs ground truth (com_imgs, and head_imgs for the
head-only rows) and warm fps to ``--out`` after every mode. That file is
the evidence ``eval/operating_points`` gates ``--auto_temporal`` on.

    python -m idealnerf_tpu_torch.scripts.temporal_delta \\
        --subject_dir runs/rehearsal --refresh 25 --s_delta 32 16 \\
        --tighten --auto_rung [--head_ckpt DIR --torso_ckpt DIR] \\
        [--split train --subject_dir runs/rehearsal_drive \\
         --out runs/rehearsal/temporal_delta_drive.json]

``--subject_dir`` holds HeadNeRF_config.txt and the with-torso data; the
checkpoints default to the ones train_head / train_torso write for it
(``<basedir>/<expname>[_torso]/ckpt``), ``--out`` to
``<subject_dir>/temporal_delta.json`` and ``--auto_rung``'s sweep to
``<subject_dir>/sample_sweep.json``. The mode keys and fields are the
JAX script's; the clip is driven by its own frames' audio windows (the
JAX script takes the track's first windows, which on a val split are
not the frames' own). Beyond the JAX fields the file holds the device it
ran on and ``delta_cost_fit``: per kind ("comp", "head") the fit of the
delta frame's ms to the cost model over the run's s_delta values
(``operating_points.fit_delta_cost``, with the ms of one field's band
dilation timed here), which the picker uses in place of its card
defaults. Frames render on ``--device`` (default cuda; on cpu the
kernels' plain versions run and the times are the host's).

Under ``--tighten`` the temporal modes render in each field's tightened
band while the full clips stay at the config's bounds, so
``psnr_temporal_vs_full`` measures the change of bounds as well as the
temporal error. The harness then also renders the full clips within the
tightened bands (the composite as the fast composite at keep 1.0 with no
prior, which renders every ray's full coarse + fine schedule: the full
composite within each field's band) and writes each mode's agreement
with them as
``psnr_temporal_vs_full_same_bounds``, and their PSNR against ground
truth as ``psnr_full_same_bounds_vs_gt`` and
``psnr_head_full_same_bounds_vs_gt``; the head gate reads that agreement
(``operating_points.head_agreement``). The JAX picker ignores the new
fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from idealnerf_tpu_torch.cli.common import load_head, load_torso
from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
from idealnerf_tpu_torch.eval.operating_points import (
    fit_delta_cost, pick_quality_matched_rung,
)
from idealnerf_tpu_torch.eval.reenact import reenact
from idealnerf_tpu_torch.eval.renderer import (
    cached_depth_band, foreground_prior, subject_depth_range,
    torso_depth_range,
)
from idealnerf_tpu_torch.eval.temporal import _prior_sel, dilate_bands


def psnr(a, b) -> float:
    """PSNR in dB of two [0, 1] clips, over all their pixels."""
    return float(-10.0 * np.log10(np.mean((a - b) ** 2) + 1e-12))


def temporal_fps(ft, refresh):
    """(amortized fps, delta-frame fps, whether a keyframe was measured)
    of a temporal clip's per-frame wall seconds: delta cost from the
    frames after the first that are not keyframes, keyframe cost from a
    keyframe after frame 0 (i % refresh == 0, i > 0). A clip with no such
    keyframe (frames <= refresh) reports the amortized fps as None rather
    than a guess."""
    deltas = [t for i, t in enumerate(ft) if i % refresh and i > 0]
    keys = [t for i, t in enumerate(ft) if i % refresh == 0 and i > 0]
    t_delta = sum(deltas) / max(len(deltas), 1)
    if keys:
        t_key = sum(keys) / len(keys)
        amortized = (t_key + (refresh - 1) * t_delta) / refresh
        fps_am = round(1.0 / amortized, 3)
    else:
        fps_am = None
    return fps_am, round(1.0 / t_delta, 3), bool(keys)


def mode_suffixes(args):
    """(head-only suffix, composite suffix, torso-count tag) of the mode
    keys: "<s>[t<st>][_k<pct>][_kt<pct>][_u<pct>][_b<pct>][_d<k>]
    [_roll<K>][_rt<K>][_fz][_hp]"; the torso tags (t, kt, rt, fz) are
    composite-only."""
    k_tag = ("" if args.delta_keep >= 1.0
             else f"_k{round(args.delta_keep * 100)}")
    kt_tag = ("" if args.delta_keep_torso is None
              else f"_kt{round(args.delta_keep_torso * 100)}")
    u_tag = ("" if args.uni_frac == 0.25
             else f"_u{round(args.uni_frac * 100)}")
    b_tag = ("" if args.kf_blend <= 0
             else f"_b{round(args.kf_blend * 100)}")
    fz_tag = "_fz" if args.freeze_z_torso else ""
    d_tag = f"_d{args.dilate_every}" if args.dilate_every > 1 else ""
    rt_tag = f"_rt{args.roll_k_torso}" if args.roll_k_torso > 1 else ""
    roll_tag = f"_roll{args.roll_k}" if args.roll_k > 1 else ""
    hp_tag = "_hp" if args.head_parse else ""
    ksuf = k_tag + u_tag + b_tag + d_tag + roll_tag + hp_tag
    ksuf_comp = (k_tag + kt_tag + u_tag + b_tag + d_tag + roll_tag + rt_tag
                 + fz_tag + hp_tag)
    tsuf = f"t{args.s_delta_torso}" if args.s_delta_torso else ""
    return ksuf, ksuf_comp, tsuf


def dilation_ms(identity, device, radius: int = 4, iters: int = 20) -> float:
    """ms of one field's band dilation (``dilate_bands`` over the frame
    grid on the head prior's rays), CUDA events on a card, the host clock
    on the CPU."""
    H, W = identity.hw
    sel = torch.from_numpy(_prior_sel(foreground_prior(identity)[0],
                                      H * W)).long().to(device)
    g = torch.Generator().manual_seed(0)
    lo = torch.rand(sel.numel(), generator=g).to(device)
    hi = lo + 0.1
    valid = lo > 0.2

    def run():
        dilate_bands(lo, hi, valid, sel, H, W, radius, 0.0, 2.0)

    run()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    return 1e3 * (time.perf_counter() - t0) / iters


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--refresh", type=int, default=25)
    p.add_argument("--s_delta", type=int, nargs="+", default=[32, 16])
    p.add_argument("--out", default=None,
                   help="output json path (default: "
                        "<subject_dir>/temporal_delta.json); side studies "
                        "go to other temporal_delta*.json names, which "
                        "the picker reads too")
    p.add_argument("--samples", type=int, default=None,
                   help="keyframe N_samples override (temporal modes "
                        "only; the full render stays at the config "
                        "schedule)")
    p.add_argument("--importance", type=int, default=None,
                   help="keyframe N_importance override")
    p.add_argument("--s_delta_torso", type=int, default=None,
                   help="torso-field delta samples (composite modes only; "
                        "default: each --s_delta). Mode key tag "
                        "'t<val>'")
    p.add_argument("--delta_keep", type=float, default=1.0,
                   help="fraction of prior rays re-rendered on delta "
                        "frames; < 1 tags the keys 'k<pct>'")
    p.add_argument("--delta_keep_torso", type=float, default=None,
                   help="torso-field delta keep (composite modes only; "
                        "default --delta_keep); tag 'kt<pct>'")
    p.add_argument("--freeze_z_torso", action="store_true",
                   help="torso delta frames re-render the keyframe's "
                        "depth grid; tag 'fz'")
    p.add_argument("--roll_k", type=int, default=0,
                   help="both-field rolling keyframe refresh (the serve "
                        "cadence): every frame pays a delta frame + 1/K "
                        "of a keyframe per field; tag 'roll<K>'")
    p.add_argument("--roll_k_torso", type=int, default=0,
                   help="torso refresh-only roll (composite modes only): "
                        "1/K of the torso rays at the keyframe schedule "
                        "every frame, no torso delta pass; tag 'rt<K>'")
    p.add_argument("--dilate_every", type=int, default=1,
                   help="band dilation on every k-th delta frame only; "
                        "> 1 tags the keys 'd<k>'")
    p.add_argument("--uni_frac", type=float, default=0.25,
                   help="fraction of delta in-band samples placed "
                        "uniformly across the cached band; non-default "
                        "tags 'u<pct>'")
    p.add_argument("--kf_blend", type=float, default=0.0,
                   help="fraction of delta importance samples drawn from "
                        "the keyframe's CDF; > 0 tags 'b<pct>'")
    p.add_argument("--head_parse", action="store_true",
                   help="per-field priors from parse silhouettes instead "
                        "of face-rect boxes; tag 'hp'")
    p.add_argument("--auto_rung", action="store_true",
                   help="keyframe rung from --sweep: the cheapest rung "
                        "within 0.05 dB of the paper schedule "
                        "(operating_points.pick_quality_matched_rung)")
    p.add_argument("--sweep", default=None,
                   help="sample_sweep.json for --auto_rung (default "
                        "<subject_dir>/sample_sweep.json)")
    p.add_argument("--tighten", action="store_true",
                   help="temporal modes start from each field's own depth "
                        "band (subject_depth_range + torso_depth_range, "
                        "cached in the checkpoints' depth_bands.json)")
    p.add_argument("--split", default="val", choices=("val", "train"),
                   help="GT split to render and compare against; --frames "
                        "is clamped to its size, so a refresh longer than "
                        "the split never measures a second keyframe")
    p.add_argument("--head_ckpt", default=None,
                   help="head checkpoint dir (default: the subject "
                        "config's <basedir>/<expname>/ckpt)")
    p.add_argument("--torso_ckpt", default=None,
                   help="torso checkpoint dir (default: "
                        "<basedir>/<expname>_torso/ckpt)")
    p.add_argument("--smooth_audio", type=int, default=0,
                   help="drive with AudioAttNet-smoothed audio features "
                        "(1 once the head trained past nosmo_iters)")
    p.add_argument("--subject_dir", required=True,
                   help="subject directory holding HeadNeRF_config.txt "
                        "and the with-torso data (com_imgs; head_imgs for "
                        "the head-only rows)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    cfg = ExperimentConfig.from_file(
        os.path.join(args.subject_dir, "HeadNeRF_config.txt"))
    head_ckpt = args.head_ckpt or os.path.join(cfg.basedir, cfg.expname,
                                               "ckpt")
    torso_ckpt = args.torso_ckpt or os.path.join(
        cfg.basedir, cfg.expname + "_torso", "ckpt")
    identity = load_transforms_dataset(cfg.datadir, mode=args.split,
                                       near=cfg.near, far=cfg.far,
                                       gt_dirs="com_imgs")
    if args.frames > identity.size:
        print(f"NOTE: --frames {args.frames} clamped to the {args.split} "
              f"split's {identity.size} frames", flush=True)

    kf_s, kf_imp = cfg.N_samples, cfg.N_importance
    if args.auto_rung:
        sweep_path = args.sweep or os.path.join(args.subject_dir,
                                                "sample_sweep.json")
        if os.path.exists(sweep_path):
            with open(sweep_path) as fh:
                best = pick_quality_matched_rung(json.load(fh))
            if best:
                kf_s, kf_imp = best[0], best[1]
                print(f"auto keyframe rung {best[2]} (sweep delta "
                      f"{best[3]} dB)", flush=True)
        else:
            print(f"NOTE: no {sweep_path}; keyframes at the config's "
                  f"{kf_s}+{kf_imp}", flush=True)
    if args.samples:
        kf_s = args.samples
    if args.importance is not None:
        kf_imp = args.importance
    # keyframes (and band estimation) at the reduced rung; the full render
    # stays at the config schedule
    cfg_kf = dataclasses.replace(cfg, N_samples=kf_s, N_importance=kf_imp)

    state = load_head(argparse.Namespace(seed=0, head_ckpt=head_ckpt), cfg,
                      identity.size)
    head_params = state.params.to(device)
    latents = state.latent_codes.to(device)
    torso_params = load_torso(torso_ckpt, cfg, device)
    torso_step = CheckpointManager(torso_ckpt).latest_step()
    print(f"head step {state.step}, torso step {torso_step}", flush=True)

    n = min(args.frames, identity.size)
    common = dict(
        driving_auds=identity.auds[identity.aud_ids[:n]],
        driving_exprs=identity.exprs[:n] if cfg.dim_expr else None,
        latent_codes=latents, torso_params=torso_params, max_frames=n,
        smooth_audio=bool(args.smooth_audio))

    bounds = None
    if args.tighten:
        ds_train = load_transforms_dataset(cfg.datadir, mode="train",
                                           near=cfg.near, far=cfg.far)
        bh = cached_depth_band(
            head_ckpt, "head", state.step,
            lambda: subject_depth_range(cfg, head_params, latents, ds_train))
        bt = cached_depth_band(
            torso_ckpt, "torso", torso_step,
            lambda: torso_depth_range(cfg, torso_params, head_params,
                                      ds_train))
        bounds = dict(head=bh, torso=bt)
        print(f"tightened: head [{bh[0]:.4f},{bh[1]:.4f}] torso "
              f"[{bt[0]:.4f},{bt[1]:.4f}]", flush=True)

    # steady-state fps from per-frame wall times within one call
    def timed(render_cfg, **kw):
        ft: list = []
        frames_out = reenact(render_cfg, head_params, identity,
                             frame_times=ft, **kw)
        warm = (sum(ft[1:]) / (len(ft) - 1)) if len(ft) > 1 else ft[0]
        return frames_out, warm, ft

    dest = args.out or os.path.join(args.subject_dir, "temporal_delta.json")

    def _write(out):
        # after every measured mode: a run cut short keeps its rows
        tmp = dest + ".tmp"
        with open(tmp, "w") as f:
            json.dump(out, f, indent=2)
        os.replace(tmp, dest)

    full, t_full_warm, _ = timed(cfg, **common)
    gt = identity.images[:n].astype(np.float32) / 255.0
    # the full clip within the temporal modes' own bounds: keep 1.0 with
    # no prior is the full composite in per-field bands
    full_same = (timed(cfg, bounds=bounds, fast_keep=1.0, **common)[0]
                 if bounds else None)
    dil_ms = dilation_ms(identity, device)
    kf_width = kf_s + kf_imp
    out = {
        "frames": n,
        "split": args.split,
        "subject_dir": args.subject_dir,
        "refresh": args.refresh,
        "keyframe_rung": f"{kf_s}+{kf_imp}",
        "head_ckpt": head_ckpt,
        "head_step": int(state.step),
        "torso_ckpt": torso_ckpt,
        "tightened_bounds": (
            {k: [float(v[0]), float(v[1])] for k, v in bounds.items()}
            if bounds else None),
        "psnr_full_vs_gt": psnr(full, gt),
        "fps_full_warm": round(1.0 / t_full_warm, 3),
        **({"psnr_full_same_bounds_vs_gt": psnr(full_same, gt)}
           if bounds else {}),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "dilation_ms": dil_ms,
        "delta_cost_fit": {},
        "modes": {},
    }
    ksuf, ksuf_comp, tsuf = mode_suffixes(args)
    place = dict(uni_frac=args.uni_frac, kf_blend=args.kf_blend,
                 dilate_every=args.dilate_every,
                 head_parse=args.head_parse)
    for s_delta in args.s_delta:
        kw = dict(temporal=args.refresh, s_delta=s_delta, use_prior=True,
                  bounds=bounds, delta_keep=args.delta_keep,
                  delta_keep_torso=args.delta_keep_torso,
                  freeze_z_torso=args.freeze_z_torso,
                  s_delta_torso=args.s_delta_torso, roll_k=args.roll_k,
                  roll_k_torso=args.roll_k_torso, **place, **common)
        tm, _, ft = timed(cfg_kf, **kw)
        fps_am, fps_delta, measured_key = temporal_fps(ft, args.refresh)
        m = {
            "psnr_temporal_vs_full": psnr(tm, full),
            "psnr_temporal_vs_gt": psnr(tm, gt),
            "delta_psnr_vs_gt": round(
                out["psnr_full_vs_gt"] - psnr(tm, gt), 3),
            "fps_temporal_warm": fps_am,
            "fps_delta_frames": fps_delta,
            "keyframe_cost_measured": measured_key,
        }
        if bounds:
            m["psnr_temporal_vs_full_same_bounds"] = psnr(tm, full_same)
        del tm
        out["modes"][f"s_delta_{s_delta}{tsuf}{ksuf_comp}"] = m
        print(f"s_delta={s_delta}{tsuf}{ksuf_comp}: {json.dumps(m)}",
              flush=True)
        out["delta_cost_fit"]["comp"] = fit_delta_cost(
            out["modes"], "s_delta_", kf_width, dil_ms)
        _write(out)
    del full, full_same

    # head-only temporal vs the full head-only render and vs head_imgs GT
    gt_h = None
    try:
        identity_h = load_transforms_dataset(cfg.datadir, mode=args.split,
                                             near=cfg.near, far=cfg.far,
                                             gt_dirs="head_imgs")
        gt_h = identity_h.images[:n].astype(np.float32) / 255.0
    except (OSError, ValueError) as e:
        print(f"NOTE: no head_imgs GT ({e}); head gate stays "
              "agreement-only", flush=True)
    common_h = {k: v for k, v in common.items() if k != "torso_params"}
    full_h, t_full_warm, _ = timed(cfg, **common_h)
    out["fps_head_full_warm"] = round(1.0 / t_full_warm, 3)
    full_h_same = (timed(cfg, bounds=bounds["head"], **common_h)[0]
                   if bounds else None)
    if gt_h is not None:
        out["psnr_head_full_vs_gt"] = psnr(full_h, gt_h)
        if bounds:
            out["psnr_head_full_same_bounds_vs_gt"] = psnr(full_h_same, gt_h)
    for s_delta in args.s_delta:
        kw = dict(temporal=args.refresh, s_delta=s_delta, use_prior=True,
                  bounds=bounds["head"] if bounds else None,
                  delta_keep=args.delta_keep, roll_k=args.roll_k,
                  **place, **common_h)
        tm, _, ft = timed(cfg_kf, **kw)
        fps_am, fps_delta, measured_key = temporal_fps(ft, args.refresh)
        m = {
            "psnr_temporal_vs_full": psnr(tm, full_h),
            "fps_temporal_warm": fps_am,
            "fps_delta_frames": fps_delta,
            "keyframe_cost_measured": measured_key,
        }
        if bounds:
            m["psnr_temporal_vs_full_same_bounds"] = psnr(tm, full_h_same)
        if gt_h is not None:
            m["psnr_temporal_vs_gt"] = psnr(tm, gt_h)
            m["delta_psnr_vs_gt"] = round(
                out["psnr_head_full_vs_gt"] - m["psnr_temporal_vs_gt"], 3)
        del tm
        out["modes"][f"head_only_s_delta_{s_delta}{ksuf}"] = m
        print(f"head-only s_delta={s_delta}{ksuf}: {json.dumps(m)}",
              flush=True)
        out["delta_cost_fit"]["head"] = fit_delta_cost(
            out["modes"], "head_only_s_delta_", kf_width, dil_ms)
        _write(out)

    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
