"""Where do the training step's kernels spend their time? Times K4
``k_point_mlp`` (the training forward) on 524,288 points (the training
step's 2,048 rays x (64 + 192)), K5 ``k_point_mlp_pe`` (its encoded-input
twin) on 2^21, the bf16 backward K6 (``grad_pass_a``, the recompute and
d_h chain, and the whole backward, ``point_mlp_grad``) on 524,288 and the
fine pass's 393,216, and the f32 backward (``point_mlp_grad`` on an f32
net, ``train_fused`` 1) on 524,288, each checkout in its own process:

    parent    ``--parent DIR``: the kernels of another checkout (a
              ``git archive`` of the parent commit), through their
              wrappers on a packed net (``point_mlp``, ``point_mlp_pe``,
              ``grad_pass_a``, ``point_mlp_grad``) and K4 also through
              ``fused_point_mlp``, which packs the net on every call (the
              span of chip_smoke.py's ``kernels`` line), timed in turns
              with this one (parent, this, this, parent); then
              ``cli.train_head.main`` for 20 steps of the paper model (4
              synthetic frames of 450x450, N_rand 2048, 64 + 128) at
              ``--train_fused`` 2 and then 1, parent and this in turns,
              its ms per step
    this      the checkout's kernels through their wrappers, then their C
              entries alone at other launch plans (ring stages, tiles per
              block; pass A's ring where it fits beside its tiles)

    python -m idealnerf_tpu_torch.scripts.kpoint --parent PARENT_DIR

Every plan's output is held bitwise against the wrapper's (a point's
arithmetic does not depend on the plan), and each worker's launch counters
against the wrapper calls it made; the script exits 1 if either differs.
Times are CUDA events over launches after a warm-up
(``harness.event_ms``). The field and its conditioning are drawn by
``harness.paper_nets`` from ``--seed``, the points uniform in [-1, 1]^3
with unit directions and a cotangent of normal draws over N. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIZES = {"K4": 2048 * (64 + 192), "K5": 1 << 21, "A": 2048 * (64 + 192)}
NAMES = {"K4": "fused_point_mlp", "K5": "fused_point_mlp_pe",
         "A": "grad_pass_a"}
# the bf16 backward's sizes: both passes of a step at once, the fine pass
GRAD_SIZES = (2048 * (64 + 192), 2048 * 192)
F32_SIZE = 2048 * (64 + 192)  # the f32 backward's
# the f32 backward's kernels, where the measured checkout has them
F32_PASSES = ("grad_pass_a_f32", "grad_pass_b_f32")
# (kernel, label, tiles per block, ring stages); 0: the wrapper's own
PLANS = [("K4", "auto", 0, 0), ("K4", "ring 2", 0, 2),
         ("K4", "ring 3", 0, 3), ("K4", "ring 5", 0, 5),
         ("K4", "ring 6", 0, 6), ("K4", "1 tile per block", 1, 0),
         ("K4", "two waves", -2, 0), ("K5", "auto", 0, 0),
         ("K5", "ring 3", 0, 3), ("K5", "ring 5", 0, 5),
         ("K5", "ring 6", 0, 6), ("A", "auto", 0, 0), ("A", "ring 2", 0, 2),
         ("A", "ring 3", 0, 3), ("A", "ring 5", 0, 5),
         ("A", "two waves", -2, 0)]
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
    from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
    from idealnerf_tpu_torch.kernels import fused_render as fr

    dev = torch.device("cuda:0")
    ncfg, (model,), (folded,) = paper_nets(dev, seed)
    net = fr.pack_operands(model, folded, ncfg)
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    N = max(SIZES.values())
    pts = (torch.rand(N, 3, generator=gd, device=dev) * 2 - 1).contiguous()
    dirs = torch.randn(N, 3, generator=gd, device=dev)
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).contiguous()
    na = SIZES["A"]
    g = (torch.randn(na, 4, generator=gd, device=dev) / na).contiguous()
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fm.encode_points(net, pts, dirs))
    ins = {"K4": (pts[:SIZES["K4"]], dirs[:SIZES["K4"]]), "K5": (pe, ped),
           "A": (pts[:na], dirs[:na], g)}

    net32 = fr.pack_leaves(ncfg, fr.model_leaves(model, folded, ncfg),
                           torch.float32)
    f32_passes = [k for k in F32_PASSES if k in fmg.launch_counts]
    calls = dict.fromkeys([*NAMES.values(), "grad_pass_b",
                           "fused_point_mlp_grad", *f32_passes], 0)
    wrappers = {"K4": fm.point_mlp, "K5": fm.point_mlp_pe,
                "A": fmg.grad_pass_a}

    def call(kern):
        calls[NAMES[kern]] += 1
        return wrappers[kern](net, *ins[kern])

    def k4_model():  # the kernels line's span: packs the net every call
        calls[NAMES["K4"]] += 1
        return fm.fused_point_mlp(model, folded, ncfg, *ins["K4"])

    def pass_a(n):
        calls["grad_pass_a"] += 1
        return fmg.grad_pass_a(net, pts[:n], dirs[:n], g[:n])

    def grad(n):  # the whole bf16 backward: pass A, then pass B
        calls["grad_pass_a"] += 1
        calls["grad_pass_b"] += 1
        calls["fused_point_mlp_grad"] += 1
        return fmg.point_mlp_grad(net, pts[:n], dirs[:n], g[:n])

    def grad32(n):  # the whole f32 backward
        calls["fused_point_mlp_grad"] += 1
        for k in f32_passes:
            calls[k] += 1
        return fmg.point_mlp_grad(net32, pts[:n], dirs[:n], g[:n])

    out = {}
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    with torch.no_grad():
        want = {k: call(k) for k in SIZES}
        for k in ("K4", "K5"):
            out[f"{k}_wrapper_ms"] = event_ms(lambda: call(k), 10)
        out["K4_model_ms"] = event_ms(k4_model, 10)
        for n in GRAD_SIZES:
            out[f"A_{n}_ms"] = event_ms(lambda: pass_a(n), 10)
            out[f"K6_{n}_ms"] = event_ms(lambda: grad(n), 10)
        out["K6f32_ms"] = event_ms(lambda: grad32(F32_SIZE), 3)
        torch.cuda.empty_cache()
        if plans:
            lib = build.load_library()
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for kern, label, per_block, ring in plans:
            if kern == "A":
                D, V = len(net.w), len(net.wv)
                auto, _, auto_ring = fmg.pass_a_plan(lib, na, sms, D, V)
                if ring and (lib.fr_grad_pass_a_smem_bytes(ring, D, V)
                             > fr.SMEM_LIMIT):
                    out[f"A {label}"] = {"fits": False}
                    continue
            else:
                auto, _, auto_ring = fm._point_plan(lib, SIZES[kern], sms)
            per_block = {0: auto, -2: -(-auto // 2)}.get(per_block,
                                                         per_block)
            ring = ring or auto_ring

            def launch():
                if kern == "A":
                    return fmg.launch_pass_a(net, *ins[kern],
                                             (per_block, ring))
                return fm.launch_point_kernel(net, *ins[kern], kern == "K5",
                                              (per_block, ring))

            got = launch()
            t = event_ms(launch, 10)
            if kern == "A":  # the planes and the bias rows
                same = (torch.equal(got[0], want[kern][0])
                        and torch.equal(got[2], want[kern][2]))
            else:
                same = torch.equal(got, want[kern])
            del got
            tiles = -(-SIZES[kern] // fr.CHAIN_TILE)
            out[f"{kern} {label}"] = {
                "points": SIZES[kern], "tiles_per_block": per_block,
                "blocks": -(-tiles // per_block), "ring": ring,
                "kernel_ms": t, "bitwise_equal": bool(same)}
    out["launches"] = {k: {**fm.launch_counts, **fmg.launch_counts}[k]
                       for k in calls}
    out["calls"] = dict(calls)
    return out


def _train_worker(tree: str, train_fused: int) -> dict:
    """In tree's package: train_head.main for 20 steps at ``train_fused``
    -> ms per step over the last logged window, first and last loss."""
    sys.path.insert(0, tree)
    from idealnerf_tpu_torch.cli import train_head

    basedir = Path(tree) / "output" / "kpoint_train"
    shutil.rmtree(basedir, ignore_errors=True)  # no resume
    res = train_head.main([*TRAIN, "--train_fused", str(train_fused),
                           "--basedir", str(basedir)])
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
    ap.add_argument("--train", type=int, default=0,
                    help=argparse.SUPPRESS)  # a train_fused value
    args = ap.parse_args(argv)
    if args.worker:
        res = (_train_worker(args.worker, args.train) if args.train else
               _worker(args.worker, json.loads(args.plans), args.seed))
        print("RESULT " + json.dumps(res), flush=True)
        return {"results": [res], "ok": True}

    from idealnerf_tpu_torch.scripts import card
    from idealnerf_tpu_torch.scripts.harness import build_trees, run_worker

    trees = {"this": ROOT}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    build_trees(trees, ("11k_point_mlp", "14k_point_mlp_pe",
                        "13k_grad_pass_a", "16k_point_mlp_grad",
                        "17k_grad_pass_a_f32",
                        "17k_grad_pass_b_f32"))
    print(f"card: {card()}; K4 on {SIZES['K4']} points, K5 on "
          f"{SIZES['K5']}, K6 pass A and the bf16 backward on "
          f"{' and '.join(map(str, GRAD_SIZES))}, the f32 backward on "
          f"{F32_SIZE}", flush=True)
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
              f"{res['K5_wrapper_ms']:.3f} ms, " + ", ".join(
                  f"pass A {res[f'A_{n}_ms']:.3f} ms and the bf16 backward "
                  f"{res[f'K6_{n}_ms']:.3f} at {n}" for n in GRAD_SIZES)
              + f", the f32 backward {res['K6f32_ms']:.3f} ms at {F32_SIZE}"
              + f"; launches {res['launches']} "
              f"({'equal to' if counted else 'DIFFER FROM'} the calls "
              f"{res['calls']})" + "".join(
                  f"; {lb} {v['kernel_ms']:.3f} ms ({v['tiles_per_block']} "
                  f"tiles x {v['blocks']} blocks, ring {v['ring']}, "
                  f"{'bitwise equal' if v['bitwise_equal'] else 'DIFFERS'})"
                  for lb, v in plan_res.items())
              + "".join(f"; {lb}: does not fit" for lb, v in res.items()
                        if isinstance(v, dict) and v.get("fits") is False),
              flush=True)
    train = []
    for tf in (2, 1):
        for k in turns:
            res = run_worker(script, trees[k], ["--train", str(tf)])
            train.append({"tree": k, "train_fused": tf, **res})
            print(f"{k:7s} train_head --train_fused {tf}, {res['steps']} "
                  f"steps: {res['step_ms']:.2f} ms/step, loss "
                  f"{res['loss'][0]:.5f} -> {res['loss'][1]:.5f}",
                  flush=True)
    print("RESULTS " + json.dumps({"kernels": results, "train": train}),
          flush=True)
    return {"results": results, "train": train, "ok": ok}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
