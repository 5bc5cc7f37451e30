"""Eval sample-count sweep on a trained checkpoint (counterpart of
scripts/sample_sweep.py).

The paper evaluates at 64 coarse + 128-192 importance samples per ray,
tuned for generic scenes; a talking head is one surface in a shallow
depth range, and the hierarchical CDF concentrates the fine samples on
it, so fewer samples may hold quality. This renders the val split at a
ladder of (N_samples, N_importance) rungs through the frame renderer
(``cli.render_val``: the coarse + depth-placement kernel, then the fine
kernel) and writes per-rung PSNR/SSIM against ground truth to
``<out>/sample_sweep.json``, the keys
``operating_points.pick_quality_matched_rung`` reads:

    python -m idealnerf_tpu_torch.scripts.sample_sweep --out runs/rehearsal \\
        [--rungs 64+128,32+64,16+32] [--tighten]

``--out`` is the subject directory: its HeadNeRF_config.txt gives the
model (scripts/rehearsal.py writes the trained settings there) and the
head checkpoint is the one train_head writes for it
(``<basedir>/<expname>/ckpt``). ``--tighten`` also sweeps each rung within
the head's own depth band (``render_val --tighten_bounds``). A run merges
into an existing file, and every delta is anchored at the paper schedule
(64+192) where the file has it, else at this run's first rung.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from idealnerf_tpu_torch.config import ExperimentConfig

LADDER = [(64, 192), (64, 128), (48, 96), (32, 64), (24, 48), (16, 32)]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True,
                   help="subject directory (HeadNeRF_config.txt); the "
                        "sweep is written there")
    p.add_argument("--rungs", type=str, default=None,
                   help="comma list like 64+192,32+64 (default: ladder)")
    p.add_argument("--tighten", action="store_true",
                   help="also sweep within the head's own depth band "
                        "(eval.renderer.subject_depth_range): higher "
                        "sample density at the same count")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on")
    args = p.parse_args(argv)

    from idealnerf_tpu_torch.cli import render_val

    cfg_path = os.path.join(args.out, "HeadNeRF_config.txt")
    cfg = ExperimentConfig.from_file(cfg_path)
    ckpt = os.path.join(cfg.basedir, cfg.expname, "ckpt")
    base = ["--config", cfg_path, "--head_ckpt", ckpt, "--device",
            args.device, "--save_path", os.path.join(args.out,
                                                     "renders_sweep")]

    rungs = LADDER
    if args.rungs:
        rungs = [tuple(int(x) for x in r.split("+"))
                 for r in args.rungs.split(",")]

    results = {}
    variants = [("", [])]
    if args.tighten:
        variants.append(("_tight", ["--tighten_bounds", "1"]))
    for s, imp in rungs:
        for suffix, extra in variants:
            t0 = time.time()
            m = render_val.main(base + extra +
                                ["--N_samples", str(s),
                                 "--N_importance", str(imp)])
            results[f"{s}+{imp}{suffix}"] = {
                "psnr": round(m["psnr"], 3), "ssim": round(m["ssim"], 4),
                "wall_s": round(time.time() - t0, 1),
                "frame_ms": m["frame_ms"],
            }
            print(f"{s}+{imp}{suffix}:", results[f"{s}+{imp}{suffix}"],
                  flush=True)

    # merge into an existing sweep file: a --rungs subset run keeps the
    # rungs measured before
    dest = os.path.join(args.out, "sample_sweep.json")
    if os.path.exists(dest):
        with open(dest) as fh:
            old = json.load(fh)
        old.update(results)
        results = old
    ref_key = "64+192" if "64+192" in results else (
        f"{rungs[0][0]}+{rungs[0][1]}")
    if ref_key in results:
        for k in results:
            results[k]["delta_psnr_vs_" + ref_key] = round(
                results[ref_key]["psnr"] - results[k]["psnr"], 3)
    with open(dest, "w") as fh:
        json.dump(results, fh, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
