"""Per-stage cost profile of the composite fast frame (counterpart of
scripts/comp_profile.py): where does a frame of
``eval.renderer.make_composite_fast_renderer`` spend its time at the
16+32 rung?

The frame runs six stages (``render.stages``): per field K2 on its prior's
rays (``coarse_head``, ``coarse_torso``), the fine-ray selection
(``keep``), per field K1 on its kept rays (``fine_head``,
``fine_torso``) and the layered composite. Each is timed in its own
window, then the whole frame, so that ``glue = end_to_end - sum of the
stages`` is measured. ``stage_chain_max_abs_err``: the stages run in
order against the whole frame (0 on the CPU).

Random fields at the paper width on the synthetic subject, keep 0.4 per
field (450², 16+32 by default; ``--smoke``: 32², 2 reps).

    python -m idealnerf_tpu_torch.scripts.comp_profile [--reps 30] \\
        [--samples 16 --importance 32] [--out comp_profile.json]
"""

from __future__ import annotations

import argparse
import json

import torch

from idealnerf_tpu_torch.eval.renderer import make_composite_fast_renderer
from idealnerf_tpu_torch.scripts import device_of, timing


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--hw", type=int, default=450)
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--importance", type=int, default=32)
    p.add_argument("--keep", type=float, default=0.4)
    timing.add_common(p, "output json path")
    args = p.parse_args(argv)
    if args.smoke:
        args.hw, args.reps = 32, 2
    dev = device_of(args.device)
    f = timing.random_composite(args.hw, args.samples, args.importance, dev)
    c, ds = f["cond"], f["ds"]
    H, W = ds.hw
    params, torso, pose, bc = f["params"], f["torso"], f["pose"], f["bc"]
    before = timing.launch_snapshot()
    render = make_composite_fast_renderer(
        f["ncfg"], f["tcfg"], H, W, ds.focal, f["near"], f["far"],
        f["cfg"].render_config(), prior_mask_head=f["mask_h"],
        prior_mask_torso=f["mask_t"], keep_head=args.keep,
        keep_torso=args.keep, _expose_stages=True)
    st = render.stages
    cond_h = (c["aud"], c["expr"], c["latent"])
    cond_t = (c["signal"], None, None)

    def ms(fn):
        return timing.window_ms(fn, args.reps, dev)

    def frame():
        return render(params, torso, pose, pose, bc, aud=c["aud"],
                      signal=c["signal"], expr=c["expr"],
                      latent=c["latent"])

    with torch.no_grad():
        sh = st["coarse"](params, pose, bc, cond_h)
        s_t = st["coarse"](torso, pose, bc, cond_t, is_torso=True)
        keep_h, keep_t = st["keep"](sh["acc"], sh["lw"], s_t["acc"],
                                    s_t["lw"])
        head_f = st["fine"](params, sh, keep_h, cond_h)
        torso_f = st["fine"](torso, s_t, keep_t, cond_t, is_torso=True)
        chain = st["composite"](sh, s_t, keep_h, keep_t, head_f, torso_f, bc)
        whole = frame()
        timing.sync(dev)
        res = {"hw": args.hw, "rung": f"{args.samples}+{args.importance}",
               "keep": args.keep, "reps": args.reps,
               **timing.device_fields(dev),
               "stage_chain_max_abs_err": float((chain - whole).abs().max()),
               "stages_ms": {
                   "coarse_head": ms(lambda: st["coarse"](params, pose, bc,
                                                          cond_h)),
                   "coarse_torso": ms(lambda: st["coarse"](
                       torso, pose, bc, cond_t, is_torso=True)),
                   "keep": ms(lambda: st["keep"](sh["acc"], sh["lw"],
                                                 s_t["acc"], s_t["lw"])),
                   "fine_head": ms(lambda: st["fine"](params, sh, keep_h,
                                                      cond_h)),
                   "fine_torso": ms(lambda: st["fine"](
                       torso, s_t, keep_t, cond_t, is_torso=True)),
                   "composite": ms(lambda: st["composite"](
                       sh, s_t, keep_h, keep_t, head_f, torso_f, bc))}}
        res["end_to_end_ms"] = ms(frame)
    res["sum_stages_ms"] = sum(res["stages_ms"].values())
    res["glue_ms"] = res["end_to_end_ms"] - res["sum_stages_ms"]
    res["fps"] = 1e3 / res["end_to_end_ms"]
    res["launches"] = timing.launches_since(before)
    timing.write_json(args.out, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
