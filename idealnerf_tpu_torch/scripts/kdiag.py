"""Is the fused MLP's time in the epilogue between its products, or in the
products themselves? (Counterpart of the JAX package's scripts/kdiag.py.)

    plain   8 chained (rows, 256) @ (256, 256) bf16 products, f32
            accumulation, bf16 cast only
    relu    the same with bias + relu between layers (the real pattern)
    relu2   relu with the block's two warpgroups (half tiles) skewed by
            half a layer, so that one's epilogue overlaps the other's
            products
    sum     the products and the weight stream alone: x times every
            layer into one accumulator, no epilogue or barrier between
            layers (a variant of this port only)
    matmul  relu as 8 torch.matmul calls + relu (the library's rate; a
            variant of this port only)

each kernel variant at every ``--rows_per_block`` (the TPU script's tile
sweep; on the wgmma chain 128 is one 128-row tile on two warpgroups, 64
one warpgroup's 64-row tile, two blocks an SM: kernels/kdiag.py). sum
against plain, relu and relu2 splits the chain's time between the
products with their stream, the per-layer barrier and store, the real
epilogue and its overlap.

    python -m idealnerf_tpu_torch.scripts.kdiag [--rows 2097152]
"""

from __future__ import annotations

import functools
import sys

import torch

from idealnerf_tpu_torch.kernels import kdiag as kd
from idealnerf_tpu_torch.scripts import (
    DEPTH, W, chain_check, chain_inputs, device_of, ints, measure, parser,
    timed_plain,
)

VARIANTS = {"plain": "cast", "relu": "bias_relu", "relu2": "relu2",
            "sum": "sum"}


def main(argv=None) -> dict:
    ap = parser(__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 21)
    ap.add_argument("--variants", default="plain,relu,relu2,sum,matmul")
    ap.add_argument("--rows_per_block", default="64,128")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    # kdiag.py's zero biases
    x, ws = chain_inputs(args.rows, torch.bfloat16, dev, args.seed)
    b = torch.zeros(DEPTH, W, device=dev)
    flops = 2.0 * args.rows * DEPTH * W * W
    names = args.variants.split(",")
    results = {}
    for name in (n for n in names if n in VARIANTS):
        mode = VARIANTS[name]
        bias = b if mode in ("bias_relu", "relu2") else None
        plain = functools.cache(timed_plain(lambda: kd.chain_reference(
            x, ws, mode, bias, torch.bfloat16))) if args.check else None
        for rpb in ints(args.rows_per_block):
            results[f"{name} r{rpb}"] = measure(
                f"{name:5s} r{rpb:<3d} rows {args.rows}",
                lambda: kd.chain(x, ws, mode, bias, rpb, torch.bfloat16),
                flops, "bf16", dev, plain=plain,
                check=chain_check(torch.bfloat16))
        del plain
    if "matmul" in names:
        results["matmul"] = measure(
            f"matmul (torch.matmul) rows {args.rows}",
            lambda: kd.chain_library(x, ws), flops, "bf16", dev)
    return {"rows": args.rows, "results": results}


if __name__ == "__main__":
    main(sys.argv[1:])
