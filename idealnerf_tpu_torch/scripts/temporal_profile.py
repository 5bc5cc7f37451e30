"""Per-stage cost profile of the temporal composite delta frame
(counterpart of scripts/temporal_profile.py): where does a steady delta
frame's time go, and how much of it is fixed per frame (ray rotation,
band update and dilation, cache scatters, dispatch) rather than per
sample?

A delta frame runs three stages (``render.stages`` of
``eval.temporal.make_temporal_composite_renderer``): the head field's
delta pass (K3 and its band update), the torso's, and the composite.
Each is timed in its own window from the same steady cache, then the
whole delta frame, and the whole frame again at ``--s_delta2`` so that
the fixed cost comes off the slope:

    t(s) = fixed + slope * s   =>   fixed = t(s1) - slope * s1

``end_to_end_ms_nodilate`` (dilation never after the keyframe) gives the
band dilation's share, ``cycle_ms_per_frame`` the frames of
``render.cycle`` (T per-frame calls). ``stage_chain_max_abs_err``: the
stages run in order against the whole delta frame from the same cache
(0 on the CPU). The JAX script's ``end_to_end_ms_xla_delta`` and
``kernel_delta_saving_ms`` timed its XLA delta path, which the port does
not have (K3 always places the depths), and are not ported.

Random fields at the paper width on the synthetic subject (450², the
16+32 rung by default; ``--smoke``: 32², 2 reps).

    python -m idealnerf_tpu_torch.scripts.temporal_profile [--reps 20] \\
        [--samples 16 --importance 32 --s_delta 32 --s_delta2 16] \\
        [--out temporal_profile.json]
"""

from __future__ import annotations

import argparse
import json

import torch

from idealnerf_tpu_torch.eval.temporal import (
    make_temporal_composite_renderer,
)
from idealnerf_tpu_torch.scripts import device_of, timing


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--hw", type=int, default=450)
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--importance", type=int, default=32)
    p.add_argument("--s_delta", type=int, default=32)
    p.add_argument("--s_delta2", type=int, default=16,
                   help="second operating point for the slope fit")
    p.add_argument("--delta_keep", type=float, default=0.6)
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

    def build(s_delta, dilate_every=1):
        return make_temporal_composite_renderer(
            f["ncfg"], f["tcfg"], H, W, ds.focal, f["near"], f["far"],
            f["cfg"].render_config(), prior_mask_head=f["mask_h"],
            prior_mask_torso=f["mask_t"], s_delta=s_delta,
            delta_keep_head=args.delta_keep,
            delta_keep_torso=args.delta_keep, dilate_every=dilate_every)

    def call(r, cache):
        return r(params, torso, pose, pose, bc, aud=c["aud"],
                 signal=c["signal"], expr=c["expr"], latent=c["latent"],
                 cache=cache)

    def ms(fn, warmup=2):
        return timing.window_ms(fn, args.reps, dev, warmup=warmup)

    render = build(args.s_delta)
    st = render.stages
    cond_h = (c["aud"], c["expr"], c["latent"])
    cond_t = (c["signal"], None, None)
    # a keyframe, then one delta frame: the steady caches
    with torch.no_grad():
        frame, cache = call(render, None)
        frame, cache = call(render, cache)
        rgb_h, _, _, _ = st["head"](params, pose, bc, cond_h, cache["head"])
        _, lw_t, fg_t, _ = st["torso"](torso, pose, bc, cond_t,
                                       cache["torso"])
        chain = st["composite"](rgb_h, lw_t, fg_t, bc)
        whole, _ = call(render, cache)
    timing.sync(dev)
    res = {"hw": args.hw, "rung": f"{args.samples}+{args.importance}",
           "s_delta": args.s_delta, "delta_keep": args.delta_keep,
           "reps": args.reps, **timing.device_fields(dev),
           "stage_chain_max_abs_err": float((chain - whole).abs().max()),
           "stages_ms": {}}
    with torch.no_grad():
        res["stages_ms"]["head_delta"] = ms(lambda: st["head"](
            params, pose, bc, cond_h, cache["head"]))
        res["stages_ms"]["torso_delta"] = ms(lambda: st["torso"](
            torso, pose, bc, cond_t, cache["torso"]))
        res["stages_ms"]["composite"] = ms(lambda: st["composite"](
            rgb_h, lw_t, fg_t, bc))

    @torch.no_grad()
    def steady(r):
        """ms of a delta frame at the renderer's own cache."""
        cur = [call(r, None)[1]]

        def one():
            cur[0] = call(r, cur[0])[1]

        return ms(one, warmup=3)

    res["end_to_end_ms"] = steady(render)
    res["sum_stages_ms"] = sum(res["stages_ms"].values())
    res["glue_ms"] = res["end_to_end_ms"] - res["sum_stages_ms"]
    res["fps"] = 1e3 / res["end_to_end_ms"]
    if args.s_delta2 and args.s_delta2 != args.s_delta:
        t2 = steady(build(args.s_delta2))
        s1, s2 = args.s_delta, args.s_delta2
        slope = (res["end_to_end_ms"] - t2) / (s1 - s2)
        res.update(end_to_end_ms_s2=t2, s_delta2=s2, ms_per_sample=slope,
                   fixed_ms=res["end_to_end_ms"] - slope * s1)
    res["end_to_end_ms_nodilate"] = steady(build(args.s_delta,
                                                 dilate_every=1_000_000))
    res["dilation_ms"] = res["end_to_end_ms"] - res["end_to_end_ms_nodilate"]

    @torch.no_grad()
    def steady_cycle(r, T):
        """ms a frame of ``render.cycle`` over T delta frames."""
        cache = call(r, call(r, None)[1])[1]
        xs = dict(auds=c["aud"].expand(T, -1),
                  signals=c["signal"].expand(T, -1),
                  exprs=c["expr"].expand(T, -1),
                  latents=c["latent"].expand(T, -1))
        poses = pose.expand(T, -1, -1)
        cur = [cache]

        def one():
            cur[0] = r.cycle(params, torso, poses, pose, bc, cur[0], **xs)[1]

        return timing.window_ms(one, max(2, args.reps // 4), dev,
                                warmup=1) / T

    T = 4 if args.smoke else 24
    res["cycle_ms_per_frame"] = steady_cycle(build(args.s_delta), T)
    res["cycle_T"] = T
    res["cycle_fps"] = 1e3 / res["cycle_ms_per_frame"]
    if args.s_delta2 and args.s_delta2 != args.s_delta:
        res["cycle_ms_per_frame_s2"] = steady_cycle(build(args.s_delta2), T)
    res["launches"] = timing.launches_since(before)
    timing.write_json(args.out, res)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
