"""Where the fused fine pass's time goes beyond its MLP. (Counterpart of
the JAX package's scripts/kdiag3.py.)

    A  the ray-organised MLP from given encodings (xyz-PE per point, read
       from memory; dir-PE per ray): trunk + skip + view + heads
    B  A with the PE built in the kernel from the ray packet and depths
    C  B with compositing: the production fine pass (fused_render_rays)

on ``--kd3_r`` rays at each ``--kd3_s`` depths, the static linspace of
[0.58, 1.18], relu density. Rates count the MLP's multiply-adds. A runs
render_body.cuh's wmma blocks of about 768 points of whole rays; B and C
the fine pass's wgmma chain at its own launch plan (C less B is the fine
pass's per-ray code and compositing), so there is no
``--rows_per_block``.

    python -m idealnerf_tpu_torch.scripts.kdiag3 [--kd3 ABC --kd3_r 202500]
"""

from __future__ import annotations

import sys

import torch

from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.kernels import kdiag as kd
from idealnerf_tpu_torch.scripts import (
    ATOL, close, close_lanes, device_of, ints, measure, paper_field, parser,
    timed_plain,
)

NEAR, FAR = 0.58, 1.18


def rays(R: int, S: int, dev, seed: int = 0):
    """(rays_o uniform in [0, 1)^3, unit rays_d, bc uniform, z (R, S))."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    o = torch.rand(R, 3, generator=g, device=dev)
    d = torch.randn(R, 3, generator=g, device=dev)
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    bc = torch.rand(R, 3, generator=g, device=dev)
    z = torch.linspace(NEAR, FAR, S, device=dev)[None].expand(R, S)
    return o, d, bc, z.contiguous()


def close_render(label: str, got: dict, want: dict) -> float:
    """C's maps against the plain fine pass: rgb, acc and weights within
    ATOL; rgb also correlated (acc and weights are ~1 / ~0 almost
    everywhere, where a correlation measures nothing)."""
    err = close(f"{label} rgb_map", got["rgb_map"], want["rgb_map"])
    for k in ("acc_map", "weights"):
        e = float((got[k] - want[k]).abs().max())
        print(f"  {label} {k}: max abs err {e:.3e} (tol {ATOL:g})",
              flush=True)
        if not e <= ATOL:
            raise AssertionError(f"{label} {k} disagrees with its plain "
                                 "version")
        err = max(err, e)
    return err


def main(argv=None) -> dict:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--kd3", default="ABC")
    ap.add_argument("--kd3_r", type=int, default=202500)
    ap.add_argument("--kd3_s", default="64,192")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    model, folded, cfg, net = paper_field(dev, args.seed)
    R, chk = args.kd3_r, args.check
    per_point = kd.ladder_macs(net, 3)
    results = {}
    for S in ints(args.kd3_s):
        o, d, bc, z = rays(R, S, dev, args.seed)
        ops = 2.0 * R * S * per_point
        tag = f"S={S} R={R}"
        if "A" in args.kd3:
            pe, ped = kd.encode_rays(net, o, d, z)
            plain = timed_plain(
                lambda: kd.render_probe_a_reference(net, pe, ped, S))
            results[f"A S={S}"] = measure(
                f"A {tag}", lambda: kd.render_probe_a(net, pe, ped, S), ops,
                "bf16", dev, plain=plain if chk else None, check=close_lanes)
            del pe, ped
        if "B" in args.kd3:
            plain = timed_plain(
                lambda: kd.render_probe_b_reference(net, o, d, z))
            results[f"B S={S}"] = measure(
                f"B {tag}", lambda: kd.render_probe_b(net, o, d, z), ops,
                "bf16", dev, plain=plain if chk else None, check=close_lanes)
        if "C" in args.kd3:
            plain = timed_plain(lambda: fr.fused_render_rays_reference(
                model, folded, cfg, o, d, z, bc))
            with torch.no_grad():
                results[f"C S={S}"] = measure(
                    f"C {tag} (fused_render_rays)",
                    lambda: fr.fused_render_rays(model, folded, cfg, o, d, z,
                                                 bc), ops, "bf16", dev,
                    plain=plain if chk else None, check=close_render)
    return {"rays": R, "results": results}


if __name__ == "__main__":
    main(sys.argv[1:])
