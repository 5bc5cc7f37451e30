"""BFM-scale photometric-tracking wall time (counterpart of
scripts/track_bench.py).

Builds the reference-scale synthetic BFM stand-in (34,500 vertices /
68,242 triangles, id 100 / exp 79 — face_tracker.py:37-53) at 450²,
renders a 4-frame ground truth through the tile-binned soft rasterizer
(``RasterConfig.bfm``, zero overflow asserted), and times (a) one
rasterizer forward of the batch, (b) one photometric sliding-window
refine step, and (c) a 40-step window refine — the per-window unit the
tracker's fit() loop repeats (tracker.py:248-343). Times are wall
seconds on the host's clock, each closed by a device synchronize.

    python -m idealnerf_tpu_torch.scripts.track_bench [--hw 450]
        [--frames 4] [--steps 40] [--out track_bench.json]
    python -m idealnerf_tpu_torch.scripts.track_bench --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from idealnerf_tpu_torch.scripts import device_of, timing


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    timing.add_common(p, "JSON file for the result")
    p.add_argument("--hw", type=int, default=450)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    args = p.parse_args(argv)
    if args.smoke:
        args.hw, args.steps = 96, 3

    from idealnerf_tpu_torch.pipeline.tracking.facemodel import Face3DMM
    from idealnerf_tpu_torch.pipeline.tracking.geometry import (
        euler2rot, forward_transform, rot_trans_pts,
    )
    from idealnerf_tpu_torch.pipeline.tracking.rasterizer import (
        RasterConfig, Render3DMM,
    )
    from idealnerf_tpu_torch.pipeline.tracking.tracker import FaceTracker

    dev = device_of(args.device)
    rng = np.random.RandomState(0)
    kw = (dict(n_id=20, n_exp=10) if args.smoke else
          dict(n_id=100, n_exp=79, n_lat=150, n_lon=230, shell=True))
    model = Face3DMM.synthetic(with_contours=True, seed=5, device=dev, **kw)
    n = args.frames
    h = w = args.hw
    focal = 1200.0 * args.hw / 450.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def smooth(a, b):
        s = np.linspace(0.0, 1.0, n)[:, None]
        return t((1 - s) * a + s * b)

    n_id, n_exp = model.dims
    gt = {
        "id": t(rng.randn(n_id) * 0.3),
        "exp": smooth(rng.randn(n_exp) * 0.3, rng.randn(n_exp) * 0.3),
        "euler": smooth(rng.uniform(-0.1, 0.1, 3),
                        rng.uniform(-0.1, 0.1, 3)),
        "trans": t(np.array([0.0, 0.0, -7.0])) + smooth(
            rng.uniform(-0.05, 0.05, 3), rng.uniform(-0.05, 0.05, 3)),
    }
    tex_gt = t(rng.randn(model.n_tex) * 0.5)
    light = torch.zeros(n, 27, device=dev)
    light[:, ::9] += 0.3

    cfg = RasterConfig.bfm(h, w)
    renderer = Render3DMM(focal, h, w, model.tris, cfg)
    geo = model.geometry(gt["id"][None], gt["exp"])
    rott = rot_trans_pts(geo, euler2rot(gt["euler"]), gt["trans"])
    texture = model.texture(tex_gt[None]).expand(geo.shape)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        out, overflow = renderer(rott, texture, light, return_overflow=True)
        if int(overflow) != 0:
            raise AssertionError(f"bin overflow {int(overflow)} at "
                                 f"{h}x{w} with {model.tris.shape[0]} "
                                 "triangles")
        gt_imgs = out[..., :3].cpu().numpy()
        coverage = float(out[0, ..., 3].mean())
        raster_ms = timing.window_ms(lambda: renderer(rott, texture, light),
                                     6, dev, warmup=1)
        lan3d = model.get_3dlandmarks(gt["id"][None], gt["exp"],
                                      gt["euler"], gt["trans"], focal,
                                      (w / 2, h / 2))
        lms = forward_transform(lan3d, gt["euler"], gt["trans"], focal,
                                (w / 2, h / 2))[..., :2].cpu().numpy()

    tracker = FaceTracker(model, h, w, focal_candidates=[focal],
                          raster_cfg=cfg)
    params = {
        "id": gt["id"],
        "exp": gt["exp"] + 0.08,
        "euler": gt["euler"] + t([[0.006, -0.004, 0.003]] * n),
        "trans": gt["trans"] + t([[0.015, -0.01, 0.03]] * n),
    }

    def refine(steps):
        timing.sync(dev)
        t0 = time.perf_counter()
        refined, _ = tracker._photometric_refine(
            params, tex_gt, light, gt_imgs, lms, focal, batch=n, steps=steps)
        timing.sync(dev)
        return refined, time.perf_counter() - t0

    _, t_first = refine(1)
    refined, t_window = refine(args.steps)
    if not bool(torch.isfinite(refined["exp"]).all()):
        raise AssertionError("the window refine produced non-finite "
                             "expressions")
    res = {
        "hw": h, "frames": n, "vertices": model.n_vertices,
        "tris": int(model.tris.shape[0]), "max_faces_per_tile":
            cfg.max_faces_per_tile, "overflow": int(overflow),
        "alpha_coverage": coverage,
        "raster_forward_s": raster_ms / 1e3,
        "photometric_window_1step_s": t_first,
        f"photometric_window_{args.steps}step_s": t_window,
        "s_per_photometric_step": t_window / args.steps,
        **timing.device_fields(dev),
    }
    if dev.type == "cuda":
        res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    timing.write_json(args.out, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
