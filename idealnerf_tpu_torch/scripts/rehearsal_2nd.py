"""Second-stage rehearsal through the port's CLI (counterpart of
scripts/rehearsal_2nd.py): the reference-scale second stage
(distribute_nerf.py:433-491: the whole face crop rendered every step with
the FAN landmark loss in the gradient, fine-tuning a trained head) on a
rehearsal subject, driven by a second synthetic subject's audio.

    python -m idealnerf_tpu_torch.scripts.rehearsal_2nd \\
        [--out output/rehearsal2] [--steps 2000] [--crop 256] \\
        [--aux_landmark 0.001] [--fan_proxy 1] [--ablate] [--device cuda]

``--out`` is a subject written by ``scripts.rehearsal`` (its head at
``<out>/logs/rehearsal_head/ckpt``). The landmark weight is
probe-normalised: the raw landmark loss of the subject's first frame
against its plate over the crop is measured once and the CLI's weight set
to ``--aux_landmark / probe``, so the term lands at that magnitude in
image-loss units whatever the FAN's scale. The FAN is ``<out>/
fan_proxy.npz`` (``scripts.train_fan_proxy``) where ``--fan_proxy`` is 1
and it exists, passed on as ``--fan_npz``, else ``init_fan(1)`` as the
CLI draws it. ``--ablate`` runs three otherwise equal rows instead (MSE
only, + landmark, + VGG16 probe-normalised to ``--aux_vgg``) and writes
``<out>/second_stage_ablation.json``; else
``<out>/second_stage_rehearsal.json`` (the trajectory of loss, PSNR and
aux loss, steps per second, the device). ``--smoke``: a CPU wiring check
on a 6-frame 40x40 subject written into ``--out`` where it holds none,
without a head, at a narrow net, crop 24, 4 steps.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from idealnerf_tpu_torch.scripts import device_of, timing

# the CLI's model flags: the JAX script's, and the smoke run's narrow net
PAPER_FLAGS = ["--N_rand", "3072", "--N_samples", "64", "--N_importance",
               "128", "--dim_aud", "64", "--dim_latent", "32", "--lrate",
               "3e-4"]
SMOKE_FLAGS = ["--N_rand", "128", "--N_samples", "8", "--N_importance", "8",
               "--dim_aud", "32", "--dim_latent", "4", "--dim_expr", "8",
               "--netdepth", "4", "--netwidth", "64", "--smo_size", "4"]


def _collect_traj(run: dict) -> list:
    """About 20 (step, loss, psnr, aux_loss) rows of the metrics.jsonl
    beside the checkpoint of a ``train_second_stage.main`` run."""
    mfile = os.path.join(os.path.dirname(run["ckpt_dir"]), "metrics.jsonl")
    with open(mfile) as fh:
        traj = [json.loads(ln) for ln in fh if ln.strip()]
    return [{k.split("/")[-1]: t[k]
             for k in ("step", "train/loss", "train/psnr", "train/aux_loss")
             if k in t} for t in traj[::max(1, len(traj) // 20)]]


def _tail_psnr(traj: list):
    tail = [t["psnr"] for t in traj[-5:] if "psnr" in t]
    return sum(tail) / len(tail) if tail else None


def run_ablation(args, base_argv, w_landmark, fan_npz, fan_src, gt_crop,
                 bc_crop, dev) -> dict:
    """MSE only, + landmark, + VGG16 (probe-normalised; the reference wires
    VGG but leaves its application commented out,
    distribute_nerf.py:483-486): the same steps and seed but the aux term;
    each row's final train PSNR (the mean of the last five logged)."""
    from idealnerf_tpu_torch.cli import train_second_stage
    from idealnerf_tpu_torch.losses.vgg import init_vgg16, make_vgg16_loss

    with torch.no_grad():
        vraw = float(make_vgg16_loss(init_vgg16(2, device=dev))(
            2.0 * gt_crop[None] - 1.0, 2.0 * bc_crop[None] - 1.0))
    w_vgg = args.aux_vgg / max(vraw, 1e-12)
    print(f"vgg16-loss probe (random init): raw={vraw:.3e} -> "
          f"weight={w_vgg:.3e}", flush=True)
    rows = {}
    runs = [("mse", []),
            ("landmark", ["--aux_landmark", str(w_landmark)]
             + (["--fan_npz", fan_npz] if fan_npz else [])),
            ("vgg", ["--aux_vgg", str(w_vgg)])]
    for tag, extra in runs:
        expname = f"rehearsal_2nd_abl_{tag}"
        t0 = time.perf_counter()
        traj = _collect_traj(train_second_stage.main(
            base_argv + extra + ["--expname", expname]))
        rows[tag] = {"final_psnr_mean_tail": _tail_psnr(traj),
                     "wall_s": time.perf_counter() - t0, "trajectory": traj}
        print(f"[ablate {tag}] tail PSNR "
              f"{rows[tag]['final_psnr_mean_tail']}", flush=True)
    mse = rows["mse"]["final_psnr_mean_tail"]
    res = {"steps_per_row": args.steps, "crop": args.crop, "fan": fan_src,
           "aux_landmark_target": args.aux_landmark,
           "aux_vgg_target": args.aux_vgg, "w_landmark": w_landmark,
           "w_vgg": w_vgg, "rows": rows,
           "psnr_effect_vs_mse": {
               t: (rows[t]["final_psnr_mean_tail"] - mse
                   if rows[t]["final_psnr_mean_tail"] is not None
                   and mse is not None else None)
               for t in ("landmark", "vgg")},
           **timing.device_fields(dev)}
    out_json = os.path.join(args.out, "second_stage_ablation.json")
    timing.write_json(out_json, res)
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}))
    print("wrote", out_json)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    timing.add_common(p, "rehearsal subject directory (default "
                         "output/rehearsal2; with --smoke "
                         "output/rehearsal_2nd_smoke)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--aux_landmark", type=float, default=0.001,
                   help="target aux magnitude in image-loss units: the raw "
                        "landmark loss is probed once on a GT/plate crop "
                        "pair and the CLI weight set to aux_landmark / "
                        "probe (a random FAN's heatmaps have an arbitrary "
                        "scale; a trained one makes the probe O(1))")
    p.add_argument("--driving_seed", type=int, default=31)
    p.add_argument("--fan_proxy", type=int, default=1,
                   help="use <out>/fan_proxy.npz (scripts.train_fan_proxy) "
                        "where it exists; 0 = random init")
    p.add_argument("--ablate", action="store_true",
                   help="the per-loss ablation instead of one rehearsal: "
                        "mse only vs + landmark vs + vgg16, same seed and "
                        "steps -> second_stage_ablation.json")
    p.add_argument("--aux_vgg", type=float, default=0.001,
                   help="target aux magnitude of the vgg16 ablation row")
    args = p.parse_args(argv)
    from idealnerf_tpu_torch.cli import train_second_stage
    from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.losses.landmark import make_fan_landmark_loss
    from idealnerf_tpu_torch.pipeline.fan import FAN, init_fan

    dev = device_of(args.device)
    head_ckpt = None
    if args.smoke:
        from idealnerf_tpu_torch.data.export import write_reference_format

        args.out = args.out or os.path.join("output", "rehearsal_2nd_smoke")
        args.crop, args.steps = 24, 4
        cfg_path = os.path.join(args.out, "HeadNeRF_config.txt")
        if not os.path.exists(cfg_path):
            write_reference_format(make_synthetic_dataset(
                n_frames=6, H=40, W=40, dim_expr=8, seed=3), args.out,
                subject="rehearsal")
    else:
        args.out = args.out or os.path.join("output", "rehearsal2")
        cfg_path = os.path.join(args.out, "HeadNeRF_config.txt")
        head_ckpt = os.path.join(args.out, "logs", "rehearsal_head", "ckpt")
        if not os.path.exists(cfg_path):
            raise SystemExit(f"no rehearsal subject at {args.out}: run "
                             "idealnerf_tpu_torch.scripts.rehearsal first")

    # the driving audio: another synthetic subject's (cross-identity)
    drv = make_synthetic_dataset(n_frames=24, H=66, W=66, dim_expr=8,
                                 seed=args.driving_seed)
    drv_aud = os.path.join(args.out, "driving_aud_2nd.npy")
    np.save(drv_aud, drv.auds)

    # the raw landmark loss of the first frame against the plate
    probe = load_transforms_dataset(args.out, mode="train", max_frames=1)
    crop = min(args.crop, min(probe.hw))
    x0 = int(min(max(probe.face_rects[0][0], 0), probe.hw[1] - crop))
    y0 = int(min(max(probe.face_rects[0][1], 0), probe.hw[0] - crop))

    def crop_of(img):
        return (torch.from_numpy(img[y0:y0 + crop, x0:x0 + crop])
                .to(dev).float() / 255.0)

    gt_crop, bc_crop = crop_of(probe.images[0]), crop_of(probe.bc_img)
    fan_npz = os.path.join(args.out, "fan_proxy.npz")
    if args.fan_proxy and os.path.exists(fan_npz):
        with np.load(fan_npz) as npz:
            fan = FAN.from_state_dict(dict(npz), device=dev)
        fan_src = "proxy"
    else:
        fan = FAN.from_state_dict(init_fan(1), device=dev)
        fan_src, fan_npz = "random", None
    with torch.no_grad():
        raw = float(make_fan_landmark_loss(fan)(gt_crop, bc_crop))
    del fan
    weight = args.aux_landmark / max(raw, 1e-12)
    print(f"landmark-loss probe ({fan_src} FAN): raw={raw:.3e} -> "
          f"weight={weight:.3e} (target magnitude {args.aux_landmark})",
          flush=True)

    base_argv = ["--config", cfg_path, "--crop", str(args.crop), "--steps",
                 str(args.steps), "--driving_aud", drv_aud, "--device",
                 args.device, "--i_print", str(max(1, args.steps // 20)),
                 *(SMOKE_FLAGS if args.smoke else PAPER_FLAGS)]
    if head_ckpt:
        base_argv += ["--head_ckpt", head_ckpt]
    if args.ablate:
        return run_ablation(args, base_argv, weight, fan_npz, fan_src,
                            gt_crop, bc_crop, dev)

    argv = base_argv + ["--aux_landmark", str(weight), "--expname",
                        "rehearsal_2nd"]
    if fan_npz:
        argv += ["--fan_npz", fan_npz]
    t0 = time.perf_counter()
    run = train_second_stage.main(argv)
    wall = time.perf_counter() - t0
    res = {"steps": args.steps, "crop": run["crop"], "fan": fan_src,
           "aux_target_magnitude": args.aux_landmark, "aux_probe_raw": raw,
           "aux_weight_used": weight, "wall_s": wall,
           "steps_per_sec": args.steps / wall,
           "step_ms_rolling": [1e3 / m["steps_per_sec_rolling"]
                               for _, m in run["history"]],
           "trajectory": _collect_traj(run),
           **timing.device_fields(dev)}
    out_json = os.path.join(args.out, "second_stage_rehearsal.json")
    timing.write_json(out_json, res)
    print(json.dumps({k: v for k, v in res.items() if k != "trajectory"}))
    print("trajectory points:", len(res["trajectory"]), "->", out_json)
    return res


if __name__ == "__main__":
    main()
