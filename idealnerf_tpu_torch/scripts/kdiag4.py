"""The matmul chain's ceiling on the card: the fused MLP's trunk in
isolation. (Counterpart of the JAX package's scripts/kdiag4.py.)

    V0  8x [bf16 product, f32 accumulation, relu, bf16 cast]: the
        production inner loop, nothing else
    V2  the same without relu (cast only)      -- relu's cost
    V3  all f32 on the CUDA cores (no casts)   -- what bf16 buys
    V5  relu as compare + select
    V6  bias add before the max (bias li + 1), the production pattern
    V7  cast to bf16 first, then the max in bf16
    VP  the products alone: x times every layer's weights into one f32
        accumulator, no epilogue or barrier between layers (a variant of
        this port only)                        -- what the epilogue costs
    VX  the chain as PyTorch calls (torch.matmul + relu per layer, bf16):
        the library's rate on this dependency chain
    V3X V3 as PyTorch calls (torch.matmul + relu per layer in f32, TF32
        off): V3's library yardstick

Each kernel variant runs at every ``--rows_per_block`` (V3 at 64 only) on
1M and 4M rows; the rate between the two sizes (the slope) is free of
launch overhead. VX and V3X run on ``--kd4_rows`` rows.

    python -m idealnerf_tpu_torch.scripts.kdiag4 --kd4 V0,V2,V3,VX
"""

from __future__ import annotations

import sys

import torch

from idealnerf_tpu_torch.kernels import kdiag as kd
from idealnerf_tpu_torch.scripts import (
    DEPTH, W, chain_inputs, device_of, ints, measure, parser, sweep,
)

MODES = {"V0": "relu", "V2": "cast", "V3": "relu", "V5": "select",
         "V6": "bias_relu", "V7": "cast_max", "VP": "sum"}


def v6_bias(dev) -> torch.Tensor:
    """V6's bias: li + 1 in every column of layer li."""
    return (torch.arange(DEPTH, device=dev, dtype=torch.float32)[:, None]
            + 1.0).expand(DEPTH, W).contiguous()


def main(argv=None) -> dict:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--kd4", default="V0")
    ap.add_argument("--rows_per_block", "--kd4_m", dest="rows_per_block",
                    default="64,128")
    ap.add_argument("--kd4_rows", type=int, default=1 << 20)
    ap.add_argument("--slope_rows", default=f"{1 << 20},{1 << 22}")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    rows = tuple(ints(args.slope_rows))
    results = {}
    for name in args.kd4.split(","):
        if name in ("VX", "V3X"):
            kind, dtype = (("bf16", torch.bfloat16) if name == "VX"
                           else ("f32", torch.float32))
            x, ws = chain_inputs(args.kd4_rows, dtype, dev, args.seed)
            results[name] = measure(
                f"{name} (torch.matmul) rows {args.kd4_rows} {kind}",
                lambda: kd.chain_library(x, ws), 2.0 * args.kd4_rows * DEPTH
                * W * W, kind, dev, reps=3)
            del x, ws
            continue
        f32 = name == "V3"
        rpbs = ints(args.rows_per_block)
        if f32 and rpbs != [64]:
            print("V3: the f32 chain runs at 64 rows per block only",
                  flush=True)
            rpbs = [64] if 64 in rpbs else []
        bias = v6_bias(dev) if name == "V6" else None
        results.update(sweep(
            name, MODES[name], torch.float32 if f32 else torch.bfloat16,
            "f32" if f32 else "bf16", rows, rpbs, dev, args.seed,
            args.check, bias))
    return {"results": results}


if __name__ == "__main__":
    main(sys.argv[1:])
