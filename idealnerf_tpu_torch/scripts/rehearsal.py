"""Convergence rehearsal on a synthetic subject (counterpart of
scripts/rehearsal.py): make a reference-format subject, train the head
and the torso through the port's CLIs at the paper config, and render
the val split at full fidelity and in the per-frame fast modes.

    python -m idealnerf_tpu_torch.scripts.rehearsal --out runs/rehearsal \\
        --with_torso [--hw 450] [--frames 110] [--epochs 140] \\
        [--torso_steps 14000] [--phase all|make|train|eval] \\
        [--eval_modes full,pruned_40,...]
    # a held-out driving clip of the same subject geometry: every frame
    # in the train split, a fresh seed (unseen audio and expressions)
    python -m idealnerf_tpu_torch.scripts.rehearsal --phase make \\
        --with_torso --out runs/rehearsal_drive --train_fraction 1.0 \\
        --seed 11

``make`` writes the subject through ``data.synthetic`` and
``data.export.write_reference_format``; with ``--with_torso`` com_imgs
and ori_imgs hold the composite frames and head_imgs the same subject
rendered without its torso (the reference's convention; the JAX
rehearsal wrote the composite frame into head_imgs too, so a head-only
render was scored against a frame with a torso).
Its HeadNeRF_config.txt also records ``PAPER``, so every later phase and
tool (``sample_sweep``, ``temporal_delta``, the CLIs) reads the model the
subject is trained at. ``train`` runs ``cli.train_head`` for ``--epochs``
epochs, then, with ``--with_torso``, ``cli.train_torso`` for
``--torso_steps`` steps on the com_imgs against the head's checkpoint.
``eval`` runs ``cli.render_val`` in each ``--eval_modes`` mode and
writes ``<out>/results.json`` (PSNR/SSIM, wall seconds and frame ms per
mode, and each fast mode's PSNR loss against the full render), the rows
``operating_points.pick_masked_point`` reads. ``--smoke`` is a tiny CPU
wiring check (16x16, 8 frames, a narrow net). Everything runs on
``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import time

PAPER = dict(N_rand=3072, N_samples=64, N_importance=128, dim_aud=64,
             dim_latent=32, mouth_rays=512, torso_rays=512,
             lrate=3e-4, lc_weight=0.005, i_weights=2000, i_print=200)

# the smoke run: a net the CPU trains in seconds
SMOKE = dict(N_rand=128, N_samples=8, N_importance=8, dim_aud=32,
             dim_latent=4, mouth_rays=16, torso_rays=16, netdepth=4,
             netwidth=64, netdepth_fine=4, netwidth_fine=64, smo_size=4,
             i_weights=20, i_print=10)

# render_val flags of each eval mode (see the JAX script for the history
# of each row); the masked keep fractions are of frame rays
ALL_MODES = {
    "full": [],
    "pruned_40": ["--pruned", "40"],
    "pruned_60": ["--pruned", "60"],
    "masked_40": ["--pruned", "40", "--prior_masked", "1"],
    "masked_60": ["--pruned", "60", "--prior_masked", "1"],
    "masked_40_maskbasis": ["--pruned", "40", "--prior_masked", "1",
                            "--keep_basis", "mask"],
    "masked_28": ["--pruned", "28", "--prior_masked", "1"],
    "masked_40_hp": ["--pruned", "40", "--prior_masked", "1",
                     "--head_parse", "1"],
    "masked_28_hp": ["--pruned", "28", "--prior_masked", "1",
                     "--head_parse", "1"],
    "masked_40_tight": ["--pruned", "40", "--prior_masked", "1",
                        "--tighten_bounds", "1"],
    "masked_60_occ": ["--pruned", "60", "--prior_masked", "1",
                      "--occ_prior", "1"],
    "masked_40_occ": ["--pruned", "40", "--prior_masked", "1",
                      "--occ_prior", "1"],
    "masked_28_occ": ["--pruned", "28", "--prior_masked", "1",
                      "--occ_prior", "1"],
}
DEFAULT_MODES = "full,pruned_40,masked_40,masked_28,masked_40_hp,masked_28_hp"


def _flags(settings: dict) -> list:
    return [a for k, v in settings.items() for a in (f"--{k}", str(v))]


def phase_make(args, paper: dict) -> str:
    from idealnerf_tpu_torch.data.export import write_reference_format
    from idealnerf_tpu_torch.data.jpeg import encode_jpeg
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset

    def subject(with_torso):
        # one seed and geometry: the same poses, audio and expressions
        return make_synthetic_dataset(
            n_frames=args.frames, H=args.hw, W=args.hw,
            dim_expr=args.dim_expr, seed=args.seed, with_torso=with_torso,
            sphere_radius=args.sphere_radius, cam_radius=args.cam_radius,
            motion_scale=args.motion_scale)

    ds = subject(args.with_torso)
    cfg_path = write_reference_format(ds, args.out, subject="rehearsal",
                                      train_fraction=args.train_fraction)
    if args.with_torso:
        head = subject(False)
        for i in range(head.size):
            with open(os.path.join(args.out, "head_imgs", f"{i}.jpg"),
                      "wb") as fh:
                fh.write(encode_jpeg(head.images[i], 95))
    with open(cfg_path, "a") as fh:
        for k, v in paper.items():
            fh.write(f"{k} = {v}\n")
    print("wrote subject:", cfg_path, flush=True)
    return cfg_path


def phase_train(args, paper: dict) -> dict:
    from idealnerf_tpu_torch.cli import train_head, train_torso

    base = ["--config", os.path.join(args.out, "HeadNeRF_config.txt"),
            "--device", args.device, *_flags(paper)]
    t0 = time.time()
    head = train_head.main([*base, "--epochs", str(args.epochs)])
    res = {"head": {"step": head["step"], "ckpt_dir": head["ckpt_dir"],
                    "wall_s": time.time() - t0,
                    "last": head["history"][-1][1] if head["history"]
                    else None}}
    print(f"head: {head['step']} steps in {res['head']['wall_s']:.0f}s",
          flush=True)
    if args.with_torso:
        t0 = time.time()
        torso = train_torso.main([*base, "--head_ckpt", head["ckpt_dir"],
                                  "--steps", str(args.torso_steps)])
        res["torso"] = {"step": torso["step"], "ckpt_dir": torso["ckpt_dir"],
                        "wall_s": time.time() - t0,
                        "last": torso["history"][-1][1] if torso["history"]
                        else None}
        print(f"torso: {torso['step']} steps in "
              f"{res['torso']['wall_s']:.0f}s", flush=True)
    return res


def phase_eval(args, paper: dict) -> dict:
    from idealnerf_tpu_torch.cli import render_val
    from idealnerf_tpu_torch.config import ExperimentConfig

    cfg_path = os.path.join(args.out, "HeadNeRF_config.txt")
    cfg = ExperimentConfig.from_file(cfg_path)
    ckpt = args.head_ckpt or os.path.join(cfg.basedir, cfg.expname, "ckpt")
    base = ["--config", cfg_path, "--head_ckpt", ckpt, "--device",
            args.device, "--save_path", os.path.join(args.out, "renders"),
            *_flags(paper)]
    modes = [m for m in (args.eval_modes or DEFAULT_MODES).split(",") if m]
    results = {}
    for name in modes:
        t0 = time.time()
        m = render_val.main(base + ALL_MODES[name])
        results[name] = {"psnr": m["psnr"], "ssim": m["ssim"],
                         "wall_s": round(time.time() - t0, 1),
                         "frame_ms": m["frame_ms"]}
        print(name, results[name], flush=True)
    res_path = os.path.join(args.out, "results.json")
    if os.path.exists(res_path):  # merge: keep earlier modes' rows
        with open(res_path) as fh:
            results = {**json.load(fh), **results}
    for mode in modes:
        if mode != "full" and "full" in results:
            results[f"delta_psnr_{mode}"] = round(
                results["full"]["psnr"] - results[mode]["psnr"], 3)
    with open(res_path, "w") as fh:
        json.dump(results, fh, indent=2)
    print(json.dumps(results, indent=2))
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="subject directory")
    p.add_argument("--hw", type=int, default=450)
    p.add_argument("--frames", type=int, default=110)
    p.add_argument("--dim_expr", type=int, default=79)
    p.add_argument("--epochs", type=int, default=140,
                   help="head epochs over the train split (a step a frame)")
    p.add_argument("--torso_steps", type=int, default=None,
                   help="with --with_torso: torso steps after the head "
                        "(default: the head's, a train frame an epoch)")
    p.add_argument("--phase", default="all",
                   choices=("all", "make", "train", "eval"))
    p.add_argument("--seed", type=int, default=7,
                   help="subject seed (7 = the canonical rehearsal "
                        "subject; another seed with the same geometry "
                        "makes a driving clip, other geometry/motion "
                        "knobs an independent subject)")
    p.add_argument("--sphere_radius", type=float, default=0.35)
    p.add_argument("--cam_radius", type=float, default=1.5)
    p.add_argument("--motion_scale", type=float, default=1.0)
    p.add_argument("--train_fraction", type=float, default=10.0 / 11.0,
                   help="train/val split point; 1.0 writes every frame to "
                        "the train json: a held-out driving clip for "
                        "temporal_delta --split train")
    p.add_argument("--head_ckpt", default=None,
                   help="eval phase: head checkpoint dir (default: the "
                        "subject config's <basedir>/<expname>/ckpt)")
    p.add_argument("--eval_modes", default=None,
                   help=f"comma list of eval modes (default "
                        f"{DEFAULT_MODES}; all: {','.join(ALL_MODES)})")
    p.add_argument("--with_torso", action="store_true",
                   help="make: the composite subject (com_imgs with the "
                        "torso, head_imgs without); train: also the torso")
    p.add_argument("--smoke", action="store_true",
                   help="tiny CPU wiring check (16x16, 8 frames, a narrow "
                        "net, a few steps)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and render on")
    args = p.parse_args(argv)
    paper = dict(PAPER)
    if args.smoke:
        args.hw, args.frames, args.dim_expr = 16, 8, 8
        args.epochs = min(args.epochs, 3)
        paper.update(SMOKE)
    if args.torso_steps is None:
        n_train = int(args.frames * args.train_fraction)
        args.torso_steps = n_train * args.epochs
    os.makedirs(args.out, exist_ok=True)
    res = {}
    if args.phase in ("all", "make"):
        res["config"] = phase_make(args, paper)
    if args.phase in ("all", "train"):
        res["train"] = phase_train(args, paper)
    if args.phase in ("all", "eval"):
        res["eval"] = phase_eval(args, paper)
    return res


if __name__ == "__main__":
    main()
