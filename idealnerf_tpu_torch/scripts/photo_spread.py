"""How far float noise carries the tracker's initial photometric fit
(``FaceTracker._photometric_initial``).

The case is the window case of tests/test_torch_tracking.py with its
ground truth rendered without bin overflow: a 24 x 32 shell, 5 frames of
48² rendered from a pose the start is perturbed from, the first 3 fitted
for 52 steps (past the rates' decay at update 50 and the loss weights'
switch after step 50). The fit runs on the host at the default thread
count (the reference run), at each of ``--threads``, from a start scaled
by 1 + ``--eps``, and on the card (``--device cuda``) twice. For each run
the record holds the largest distance from the reference of id / exp /
euler / trans ("pose") and of texture and light, and the first step whose
colour mask holds another pixel count (null where none does).

    python -m idealnerf_tpu_torch.scripts.photo_spread [--out spread.json]
    python -m idealnerf_tpu_torch.scripts.photo_spread --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from idealnerf_tpu_torch.scripts import device_of, timing

STEPS = 52
FIT_FRAMES = 3


def window_case(device="cpu") -> dict:
    """The case on ``device``: the tracker, its start, the images and
    landmarks (numpy), the focal and the frames fitted."""
    from idealnerf_tpu_torch.pipeline.tracking import (
        Face3DMM, FaceTracker, RasterConfig, Render3DMM, euler2rot,
        forward_transform, rot_trans_pts,
    )

    model = Face3DMM.synthetic(n_id=4, n_exp=3, n_lat=24, n_lon=32,
                               shell=True, with_contours=True, seed=1,
                               device=device)
    rng = np.random.RandomState(6)
    n, hw, focal = 5, 48, 120.0
    gt = {k: torch.from_numpy(a.astype(np.float32)).to(device) for k, a in (
        ("id", rng.randn(4) * 0.3), ("exp", rng.randn(n, 3) * 0.3),
        ("euler", rng.randn(n, 3) * 0.05),
        ("trans", np.tile([0.0, 0.0, -7.0], (n, 1))))}
    tex = torch.from_numpy((rng.randn(model.n_tex) * 0.5).astype(
        np.float32)).to(device)
    light = torch.zeros(n, 27, device=device)
    light[:, ::9] = 0.3
    cfg = RasterConfig(hw, hw, tile=8, max_faces_per_tile=256, span=3)
    cxy = (hw / 2, hw / 2)
    with torch.no_grad():
        geo = model.geometry(gt["id"][None], gt["exp"])
        rott = rot_trans_pts(geo, euler2rot(gt["euler"]), gt["trans"])
        imgs, overflow = Render3DMM(focal, hw, hw, model.tris, cfg)(
            rott, model.texture(tex[None]).expand(geo.shape), light,
            return_overflow=True)
        if int(overflow):
            raise AssertionError(f"bin overflow {int(overflow)}")
        lms = forward_transform(model.get_3dlandmarks(
            gt["id"][None], gt["exp"], gt["euler"], gt["trans"], focal, cxy),
            gt["euler"], gt["trans"], focal, cxy)[..., :2]
    start = dict(gt, exp=gt["exp"] + 0.1, euler=gt["euler"] + 0.01,
                 trans=gt["trans"] + torch.tensor([0.02, -0.01, 0.05],
                                                  device=device))
    return {"tracker": FaceTracker(model, hw, hw, focal_candidates=[focal],
                                   raster_cfg=cfg),
            "start": start, "images": imgs[..., :3].cpu().numpy(),
            "landmarks": lms.cpu().numpy(), "focal": focal,
            "tex": tex, "light": light}


def _fit(case, steps: int, scale: float = 1.0):
    """The fit from the case's start scaled by ``scale`` -> (params, tex,
    light, each step's colour-mask pixel count)."""
    import idealnerf_tpu_torch.pipeline.tracking.tracker as tracker_mod

    counts = []
    loss_fn = tracker_mod.masked_color_loss

    def counted(pred, gt, mask):
        counts.append(int(mask.sum()))
        return loss_fn(pred, gt, mask)

    tracker_mod.masked_color_loss = counted
    try:
        params, tex, light = case["tracker"]._photometric_initial(
            {k: v * scale for k, v in case["start"].items()},
            case["images"], case["landmarks"], case["focal"],
            batch=FIT_FRAMES, steps=steps)
    finally:
        tracker_mod.masked_color_loss = loss_fn
    return ({k: v.cpu() for k, v in params.items()}, tex.cpu(), light.cpu(),
            counts)


def _gap(run, ref) -> dict:
    pose = max(float((run[0][k] - ref[0][k]).abs().max()) for k in ref[0])
    tex_light = max(float((run[i] - ref[i]).abs().max()) for i in (1, 2))
    first = next((s for s, (a, b) in enumerate(zip(run[3], ref[3]))
                  if a != b), None)
    return {"pose": pose, "tex_light": tex_light, "first_mask_step": first}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    timing.add_common(p, "JSON file for the result")
    p.add_argument("--threads", default="1,3",
                   help="host thread counts to run besides the default")
    p.add_argument("--eps", type=float, default=1e-6,
                   help="relative scale of the perturbed start")
    args = p.parse_args(argv)
    steps = 3 if args.smoke else STEPS
    dev = device_of(args.device)

    default_threads = torch.get_num_threads()
    host = window_case("cpu")
    ref = _fit(host, steps)
    runs = {}
    try:
        for t in (int(x) for x in args.threads.split(",") if x):
            torch.set_num_threads(t)
            runs[f"host_{t}_threads"] = _gap(_fit(host, steps), ref)
    finally:
        torch.set_num_threads(default_threads)
    runs[f"host_start_x(1+{args.eps:g})"] = _gap(
        _fit(host, steps, 1.0 + args.eps), ref)
    if dev.type == "cuda":
        card = window_case(dev)
        for i in (1, 2):
            runs[f"card_run_{i}"] = _gap(_fit(card, steps), ref)
    res = {"steps": steps, "fit_frames": FIT_FRAMES,
           "host_threads": default_threads, "runs": runs,
           **timing.device_fields(dev)}
    timing.write_json(args.out, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
