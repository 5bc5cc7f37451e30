"""What does a net's width cost on the card? Times the paper model (D=8,
dim_aud 64, dim_expr 76, dim_latent 32, 64 coarse + 128 fine depths) at
each width of ``--widths`` on a 450x450 frame of the synthetic subject,
each checkout in its own process:

    frame_ms   the frame's two passes through ``render_rays_fused`` on its
               202,500 rays (K2 ``fused_render_coarse_hier``, then K1
               ``fused_render_rays`` on K2's fine depths)
    k2_ms      K2 alone on the frame's rays
    k1_ms      K1 alone on K2's fine depths
    step_ms    a ``train_head`` step (``train_fused`` 2: K4 and the bf16
               K6, twice a step) at N_rand 2048, as
               ``scripts/train_profile`` builds it (its ``full`` variant),
               the median of 3 windows of ``--steps`` steps

A width the checkout's kernels refuse records the refusal. With
``--parent DIR`` the checkout at DIR (a ``git archive`` of the parent
commit) is timed in turns with this one (parent, this, this, parent):

    python -m idealnerf_tpu_torch.scripts.kwidth --parent PARENT_DIR \\
        [--widths 128,256,512] [--steps 5]

Kernel times are CUDA events over launches after a warm-up; the frame
and step times end in a synchronise. Each worker's launch counters are
kept beside its times (``launches``). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HW, N_SAMPLES, N_IMPORTANCE, N_RAND = 450, 64, 128, 2048


def _width(W: int, steps: int, seed: int) -> dict:
    """One width in the imported checkout's package."""
    import numpy as np
    import torch
    from harness import event_ms  # this checkout's harness

    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.core.rays import get_rays
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.kernels import fused_mlp as fm
    from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
    from idealnerf_tpu_torch.kernels import fused_render as fr
    from idealnerf_tpu_torch.models.face_nerf import (
        FaceNeRF, fold_conditioning,
    )
    from idealnerf_tpu_torch.scripts import timing
    from idealnerf_tpu_torch.scripts.train_profile import PAPER, Profile

    dev = torch.device("cuda:0")
    for m in (fr, fm, fmg):
        m.reset_launch_counts()
    ncfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32,
                            netwidth=W).face_nerf_config()
    g = torch.Generator().manual_seed(seed)
    coarse, fine = (FaceNeRF(ncfg, g).to(dev) for _ in range(2))
    cond = (torch.randn(64, generator=g).to(dev),
            torch.randn(76, generator=g).to(dev), torch.ones(32, device=dev))
    with torch.no_grad():
        fc, ff = (fold_conditioning(m, ncfg, *cond) for m in (coarse, fine))
    ds = make_synthetic_dataset(n_frames=1, H=HW, W=HW, dim_expr=76)
    ro, rd = get_rays(HW, HW, ds.focal, torch.from_numpy(ds.poses[0]).to(dev),
                      ds.cx, ds.cy)
    bc = torch.from_numpy(ds.bc_img).to(dev).float() / 255.0
    ro, rd, bc = (x.reshape(-1, 3).contiguous() for x in (ro, rd, bc))
    out = {"width": W}
    with torch.no_grad():
        def k2():
            return fr.fused_render_coarse_hier(coarse, fc, ncfg, ro, rd, bc,
                                               ds.near, ds.far, N_SAMPLES,
                                               N_IMPORTANCE)

        try:
            _, z_all = k2()
        except ValueError as e:
            return {"width": W, "refused": str(e)}
        out["k2_ms"] = event_ms(k2, 3)
        out["k1_ms"] = event_ms(
            lambda: fr.fused_render_rays(fine, ff, ncfg, ro, rd, z_all, bc), 3)
        out["frame_ms"] = event_ms(
            lambda: fr.render_rays_fused(coarse, fc, ncfg, ro, rd, bc,
                                         ds.near, ds.far, N_SAMPLES,
                                         N_IMPORTANCE, fine, ff), 3)
    del z_all
    torch.cuda.empty_cache()
    cfg = ExperimentConfig(**{**PAPER, "N_rand": N_RAND, "netwidth": W,
                              "dim_expr": 76})
    prof = Profile(cfg, HW, 4, dev)
    st, step = prof.state("adam"), prof.step_fn("full")
    gen = torch.Generator(device=dev).manual_seed(1)
    i = [0]

    def one():
        loss = step(st, i[0] % prof.ds.size, gen)
        i[0] += 1
        return loss

    windows = [timing.window_ms(one, steps, dev, warmup=1 if r == 0 else 0)
               for r in range(3)]
    out.update(step_ms=float(np.median(windows)), step_windows_ms=windows,
               launches={k: v for m in (fr, fm, fmg)
                         for k, v in m.launch_counts.items() if v})
    return out


def _worker(tree: str, widths, steps: int, seed: int) -> dict:
    sys.path.insert(0, tree)
    import torch

    res = {}
    for W in widths:
        res[str(W)] = _width(W, steps, seed)
        print(json.dumps(res[str(W)]), flush=True)
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from harness import run_worker

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="",
                    help="root of another checkout to time in turns")
    ap.add_argument("--widths", default="128,256,512")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    widths = [int(w) for w in args.widths.split(",")]
    if args.worker:
        res = _worker(args.worker, widths, args.steps, args.seed)
        print("RESULT " + json.dumps(res), flush=True)
        return res
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    trees = [("this", ROOT)]
    if args.parent:
        p = Path(args.parent).resolve()
        trees = [("parent", p), ("this", ROOT), ("this", ROOT),
                 ("parent", p)]
    argv_w = ["--widths", args.widths, "--steps", str(args.steps), "--seed",
              str(args.seed)]
    runs = []
    for label, tree in trees:
        r = run_worker(__file__, tree, argv_w, timeout=1800)
        runs.append({"tree": label, "widths": r})
        print(label, json.dumps(r), flush=True)
    out = {"nvidia_smi": smi.strip(), "runs": runs}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
