"""Where do the point kernels (K4 ``k_point_mlp``, the training forward,
and K5 ``k_point_mlp_pe``, its encoded-input twin) spend their time? Times
K4 on 524,288 points (the training step's 2,048 rays x (64 + 192)) and K5
on 2^21, each checkout in its own process:

    parent    ``--parent DIR``: the kernels of another checkout (a
              ``git archive`` of the parent commit), through their
              wrappers on a packed net (``point_mlp``, ``point_mlp_pe``)
              and K4 also through ``fused_point_mlp``, which packs the net
              on every call (the span of chip_smoke.py's ``kernels``
              line), timed in turns with this one (parent, this, this,
              parent); then ``cli.train_head.main`` for 20 steps of the
              paper model (4 synthetic frames of 450x450, N_rand 2048,
              64 + 128), parent and this in turns, its ms per step
    this      the checkout's kernels through their wrappers, then their C
              entries alone at other launch plans (ring stages, tiles per
              block)

    python -m idealnerf_tpu_torch.scripts.kpoint --parent PARENT_DIR

Every plan's output is held bitwise against the wrapper's (a point's
arithmetic does not depend on the plan), and each worker's launch counters
against the wrapper calls it made; the script exits 1 if either differs.
Times are CUDA events over launches after a warm-up
(``harness.event_ms``). The field and its conditioning are drawn by
``harness.paper_nets`` from ``--seed``, the points uniform in [-1, 1]^3 with unit directions. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"K4": 2048 * (64 + 192), "K5": 1 << 21}
NAMES = {"K4": "fused_point_mlp", "K5": "fused_point_mlp_pe"}
# (kernel, label, tiles per block, ring stages); 0: the wrapper's own
PLANS = [("K4", "auto", 0, 0), ("K4", "ring 2", 0, 2),
         ("K4", "ring 3", 0, 3), ("K4", "ring 5", 0, 5),
         ("K4", "ring 6", 0, 6), ("K4", "1 tile per block", 1, 0),
         ("K4", "two waves", -2, 0), ("K5", "auto", 0, 0),
         ("K5", "ring 3", 0, 3), ("K5", "ring 5", 0, 5),
         ("K5", "ring 6", 0, 6)]
TRAIN = ["--synthetic", "4", "--synthetic_hw", "450", "--dim_aud", "64",
         "--dim_expr", "76", "--dim_latent", "32", "--N_rand", "2048",
         "--N_samples", "64", "--N_importance", "128", "--epochs", "5",
         "--i_print", "5", "--i_weights", "10", "--device", "cuda",
         "--expname", "head"]


def _worker(tree: str, plans, seed: int) -> dict:
    """In tree's package: the wrappers' times and, for each plan, the
    kernel's C entry alone, its output against the wrapper's."""
    from harness import event_ms, paper_nets  # this checkout's harness

    sys.path.insert(0, tree)
    import torch

    from idealnerf_tpu_torch.kernels import build
    from idealnerf_tpu_torch.kernels import fused_mlp as fm
    from idealnerf_tpu_torch.kernels import fused_render as fr

    dev = torch.device("cuda:0")
    ncfg, (model,), (folded,) = paper_nets(dev, seed)
    net = fr.pack_operands(model, folded, ncfg)
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    N = max(SIZES.values())
    pts = (torch.rand(N, 3, generator=gd, device=dev) * 2 - 1).contiguous()
    dirs = torch.randn(N, 3, generator=gd, device=dev)
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).contiguous()
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fm.encode_points(net, pts, dirs))
    ins = {"K4": (pts[:SIZES["K4"]], dirs[:SIZES["K4"]]), "K5": (pe, ped)}

    calls = dict.fromkeys(NAMES.values(), 0)
    wrappers = {"K4": fm.point_mlp, "K5": fm.point_mlp_pe}

    def call(kern):
        calls[NAMES[kern]] += 1
        return wrappers[kern](net, *ins[kern])

    def k4_model():  # the kernels line's span: packs the net every call
        calls[NAMES["K4"]] += 1
        return fm.fused_point_mlp(model, folded, ncfg, *ins["K4"])

    out = {}
    fm.reset_launch_counts()
    with torch.no_grad():
        want = {k: call(k) for k in SIZES}
        for k in SIZES:
            out[f"{k}_wrapper_ms"] = event_ms(lambda: call(k), 10)
        out["K4_model_ms"] = event_ms(k4_model, 10)
        if plans:
            lib = build.load_library()
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for kern, label, per_block, ring in plans:
            auto, _, auto_ring = fm._point_plan(lib, SIZES[kern], sms)
            per_block = {0: auto, -2: -(-auto // 2)}.get(per_block,
                                                         per_block)
            ring = ring or auto_ring

            def launch():
                return fm.launch_point_kernel(net, *ins[kern], kern == "K5",
                                              (per_block, ring))

            got = launch()
            t = event_ms(launch, 10)
            tiles = -(-SIZES[kern] // fr.CHAIN_TILE)
            out[f"{kern} {label}"] = {
                "points": SIZES[kern], "tiles_per_block": per_block,
                "blocks": -(-tiles // per_block), "ring": ring,
                "kernel_ms": t,
                "bitwise_equal": bool(torch.equal(got, want[kern]))}
    out["launches"] = {k: fm.launch_counts[k] for k in NAMES.values()}
    out["calls"] = dict(calls)
    return out


def _train_worker(tree: str) -> dict:
    """In tree's package: train_head.main for 20 steps -> ms per step over
    the last logged window, first and last loss."""
    sys.path.insert(0, tree)
    from idealnerf_tpu_torch.cli import train_head

    basedir = Path(tree) / "output" / "kpoint_train"
    shutil.rmtree(basedir, ignore_errors=True)  # no resume
    res = train_head.main([*TRAIN, "--basedir", str(basedir)])
    first, last = res["history"][0][1], res["history"][-1][1]
    return {"steps": res["step"],
            "step_ms": 1e3 / last["steps_per_sec_rolling"],
            "loss": [first["loss"], last["loss"]]}


def main(argv=None) -> dict:
    """-> {"results": per worker, "train": the train_head A/B (with a
    parent), "ok": every plan bitwise equal and every worker's launch
    counters equal to its wrapper calls}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--plans", default="[]", help=argparse.SUPPRESS)
    ap.add_argument("--train", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        res = (_train_worker(args.worker) if args.train else
               _worker(args.worker, json.loads(args.plans), args.seed))
        print("RESULT " + json.dumps(res), flush=True)
        return {"results": [res], "ok": True}

    from idealnerf_tpu_torch.scripts import card
    from idealnerf_tpu_torch.scripts.harness import build_trees, run_worker

    trees = {"this": ROOT}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    build_trees(trees, ("11k_point_mlp", "14k_point_mlp_pe"))
    print(f"card: {card()}; K4 on {SIZES['K4']} points, K5 on "
          f"{SIZES['K5']}", flush=True)
    turns = ["parent", "this", "this", "parent"] if args.parent else []
    script = str(Path(__file__).resolve())
    results, ok = [], True
    for k, plans in [(k, []) for k in turns] + [("this", PLANS)]:
        res = run_worker(script, trees[k], [
            "--plans", json.dumps(plans), "--seed", str(args.seed)])
        results.append({"tree": k, **res})
        plan_res = {lb: v for lb, v in res.items()
                    if isinstance(v, dict) and "kernel_ms" in v}
        counted = res["launches"] == res["calls"]
        ok = ok and counted and all(v["bitwise_equal"]
                                    for v in plan_res.values())
        print(f"{k:7s} K4 wrapper {res['K4_wrapper_ms']:.3f} ms (through "
              f"fused_point_mlp {res['K4_model_ms']:.3f}), K5 wrapper "
              f"{res['K5_wrapper_ms']:.3f} ms; launches {res['launches']} "
              f"({'equal to' if counted else 'DIFFER FROM'} the calls "
              f"{res['calls']})" + "".join(
                  f"; {lb} {v['kernel_ms']:.3f} ms ({v['tiles_per_block']} "
                  f"tiles x {v['blocks']} blocks, ring {v['ring']}, "
                  f"{'bitwise equal' if v['bitwise_equal'] else 'DIFFERS'})"
                  for lb, v in plan_res.items()), flush=True)
    train = []
    for k in turns:
        res = run_worker(script, trees[k], ["--train"])
        train.append({"tree": k, **res})
        print(f"{k:7s} train_head {res['steps']} steps: {res['step_ms']:.2f} "
              f"ms/step, loss {res['loss'][0]:.5f} -> {res['loss'][1]:.5f}",
              flush=True)
    print("RESULTS " + json.dumps({"kernels": results, "train": train}),
          flush=True)
    return {"results": results, "train": train, "ok": ok}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
