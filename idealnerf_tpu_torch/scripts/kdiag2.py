"""What each part of the fused point MLP adds to its time: trunk -> +skip
-> +view -> +heads -> +in-kernel PE. (Counterpart of the JAX package's
scripts/kdiag2.py, on the production operand table of the paper head
model instead of unstructured random weights.)

    v0  trunk only (layer 0 from the xyz-PE, 7 hidden layers, no skip)
    v1  + the skip layer's pe-part
    v2  + the view branch with its dir-PE part
    v3  + the packed heads: the encoded-input point MLP (K5)
    v4  + the PE built in the kernel from raw coordinates (K4)

Every rung runs on the same points (uniform in [-1, 1]^3, unit view
directions): v4 from the coordinates, v0-v3 from their bf16 encodings.
Rates count each rung's own multiply-adds, so they compare as shares of
the peak for the work each one does. Every rung runs K5's chain at K5's
launch plan (128-point tiles, at most one block per SM), v0-v2 stopped
early, so v0, v1, v2 and v3 split K5's time into trunk, skip, view branch
and heads, and there is no ``--rows_per_block``.

    python -m idealnerf_tpu_torch.scripts.kdiag2 [--rows 2097152]
"""

from __future__ import annotations

import sys

import torch

from idealnerf_tpu_torch.kernels import fused_mlp
from idealnerf_tpu_torch.kernels import kdiag as kd
from idealnerf_tpu_torch.scripts import (
    close, close_lanes, device_of, measure, paper_field, parser,
    timed_plain,
)


def inputs(net, rows: int, dev, seed: int = 0):
    """(pe (rows, PE_PAD) bf16, ped (rows, PED_PAD) bf16, pts (rows, 3),
    dirs (rows, 3)): points uniform in [-1, 1]^3, unit directions, and
    their encodings."""
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pts = torch.rand(rows, 3, generator=g, device=dev) * 2.0 - 1.0
    dirs = torch.randn(rows, 3, generator=g, device=dev)
    dirs = (dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)).contiguous()
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fused_mlp.encode_points(net, pts, dirs))
    return pe, ped, pts, dirs


def rung(net, stage: int, pe, ped, pts, dirs):
    """Rung ``stage``'s launch on the inputs."""
    if stage == 4:
        return fused_mlp.point_mlp(net, pts, dirs)
    return kd.ladder(net, pe, ped, stage)


def plain(net, stage: int, pe, ped, pts, dirs):
    """Rung ``stage``'s plain version on the inputs."""
    if stage == 4:
        return fused_mlp.point_mlp_reference(net, pts, dirs)
    return kd.ladder_reference(net, pe, ped, stage)


def main(argv=None) -> dict:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 21)
    ap.add_argument("--rungs", default="0,1,2,3,4")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    net = paper_field(dev, args.seed)[3]
    ins = inputs(net, args.rows, dev, args.seed)
    results = {}
    for stage in (int(s) for s in args.rungs.split(",")):
        macs = kd.ladder_macs(net, min(stage, 3))
        check = timed_plain(lambda: plain(net, stage, *ins))
        results[f"v{stage}"] = measure(
            f"v{stage} {kd.LADDER[stage]:14s} rows {args.rows}",
            lambda: rung(net, stage, *ins), 2.0 * macs * args.rows, "bf16",
            dev, plain=check if args.check else None,
            check=close_lanes if stage >= 3 else close)
    return {"rows": args.rows, "results": results}


if __name__ == "__main__":
    main(sys.argv[1:])
