"""The int8 ceiling of the fused MLP's trunk chain on the card.
(Counterpart of the JAX package's scripts/kdiag5.py.)

    B0  the bf16 chain (kdiag4 V0), measured in the same run so that the
        int8 / bf16 ratio holds on one card
    I0  int8 chain with a realistic requant: s32 accumulation -> relu ->
        f32 scale 0.25 / (layer + 2) -> +0.5, clip to [0, 127], truncate
    I1  int8 chain with a shift requant: s32 -> relu -> >> 6 -> clip
    IX  I0 as PyTorch calls (torch._int_mm + the requant per layer)

Each kernel variant runs at every ``--rows_per_block`` on 1M and 4M rows
(slope as in kdiag4); IX on 1M rows. The JAX script's decision rule: a
quantised trunk is worth pursuing only if I0 >= 1.4x B0 on the slope.

    python -m idealnerf_tpu_torch.scripts.kdiag5 [--kd5_out results.json]
"""

from __future__ import annotations

import json
import sys

import torch

from idealnerf_tpu_torch.kernels import kdiag as kd
from idealnerf_tpu_torch.scripts import (
    DEPTH, W, chain_inputs, device_of, ints, measure, parser, sweep,
)

MODES = {"B0": "relu", "I0": "i0", "I1": "i1"}


def main(argv=None) -> dict:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--kd5", default="B0,I0,I1,IX")
    ap.add_argument("--rows_per_block", "--kd5_m", dest="rows_per_block",
                    default="64,128")
    ap.add_argument("--kd5_out", default=None)
    ap.add_argument("--slope_rows", default=f"{1 << 20},{1 << 22}")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    rows = tuple(ints(args.slope_rows))
    results = {}
    for name in args.kd5.split(","):
        if name == "IX":
            n = rows[0]
            x, ws = chain_inputs(n, torch.int8, dev, args.seed)
            results["IX"] = measure(
                f"IX (torch._int_mm) rows {n} int8",
                lambda: kd.chain_library(x, ws, "i0"),
                2.0 * n * DEPTH * W * W, "int8", dev, reps=3)
            del x, ws
            continue
        int8 = name != "B0"
        results.update(sweep(
            name, MODES[name], torch.int8 if int8 else torch.bfloat16,
            "int8" if int8 else "bf16", rows, ints(args.rows_per_block), dev,
            args.seed, args.check))
    out = {"results": results}
    if args.kd5_out:
        with open(args.kd5_out, "w") as fh:
            json.dump(out, fh, indent=1)
        print(f"wrote {args.kd5_out}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
