"""Where do a frame's fine and coarse kernels (K1 ``k_render_rays``, K2
``k_coarse_hier``) spend their time? Times both on the 202,500 rays of a
450x450 frame of the synthetic subject (64 coarse + 128 fine depths), each
checkout in its own process:

    parent    ``--parent DIR``: the kernels of another checkout (a
              ``git archive`` of the parent commit), through their
              wrappers, timed in turns with this one (parent, this, this,
              parent)
    this      the checkout's kernels through their wrappers, then their C
              entries alone on prepared operands at other launch plans
              (rays per block, ring stages) and on one wave of blocks: one
              block per SM, then one on half the SMs. Each block does the
              same work in both, so a time that stays says each SM's own
              rate sets the pace, one that halves says a shared one (L2)
              does.

    python -m idealnerf_tpu_torch.scripts.kframe --parent PARENT_DIR

K2 runs on the frame's rays, K1 on K2's fine depths. One more plan runs
K1's entry on the coarse net at K2's own depths, rays per block and ring:
K2's time less that one is its depth placement (``hier_depths``). Every
plan's outputs
are held bitwise against the wrapper's on the rays they cover (the grouping
of rays into blocks and tiles changes no ray's arithmetic), and each
worker's launch counters against the wrapper calls it made; the script
exits 1 if either differs. Times are CUDA events over launches after a
warm-up. The fields and their conditioning are drawn as chip_smoke.py
draws them (``--seed``, 0 there). Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HW, N_SAMPLES, N_IMPORTANCE = 450, 64, 128
# (kernel, label, rays per block, ring stages, blocks); 0: the wrapper's
# own plan or every block; -1 / -2 blocks: one per SM / half the SMs
PLANS = [("K2", "auto", 0, 0, 0), ("K2", "14 rays, ring 4", 14, 4, 0),
         ("K2", "15 rays, ring 4", 15, 4, 0),
         ("K2", "24 rays, ring 2", 24, 2, 0),
         ("K2", "10 rays, ring 5", 10, 5, 0),
         ("K2", "wave, all SMs", 0, 0, -1),
         ("K2", "wave, half the SMs", 0, 0, -2),
         ("K2 less hier_depths", "auto", 0, 0, 0),
         ("K1", "auto", 0, 0, 0), ("K1", "8 rays, ring 4", 8, 4, 0),
         ("K1", "9 rays, ring 4", 9, 4, 0),
         ("K1", "14 rays, ring 2", 14, 2, 0),
         ("K1", "6 rays, ring 5", 6, 5, 0),
         ("K1", "wave, all SMs", 0, 0, -1),
         ("K1", "wave, half the SMs", 0, 0, -2)]
NAMES = {"K1": "fused_render_rays", "K2": "fused_render_coarse_hier"}
# a plan's kernel -> (entry, net, depths S, fine depths placed)
KERNELS = {"K2": ("K2", "coarse", N_SAMPLES, N_IMPORTANCE),
           "K2 less hier_depths": ("K1", "coarse", N_SAMPLES, 0),
           "K1": ("K1", "fine", N_SAMPLES + N_IMPORTANCE, 0)}


def _worker(tree: str, plans, seed: int) -> dict:
    """In tree's package: the wrappers' times and, for each plan, the
    kernel's C entry alone, its outputs against the wrapper's."""
    sys.path.insert(0, tree)
    import torch

    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.core.rays import get_rays
    from idealnerf_tpu_torch.core.sampling import stratified_sample
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.kernels import build
    from idealnerf_tpu_torch.kernels import fused_render as fr
    from idealnerf_tpu_torch.models.face_nerf import (
        FaceNeRF, fold_conditioning,
    )

    dev = torch.device("cuda:0")
    ncfg = ExperimentConfig(dim_aud=64, dim_expr=76,
                            dim_latent=32).face_nerf_config()
    g = torch.Generator().manual_seed(seed)
    nets = {k: FaceNeRF(ncfg, g).to(dev) for k in ("coarse", "fine")}
    cond = [torch.randn(64, generator=g).to(dev),
            torch.randn(76, generator=g).to(dev), torch.ones(32, device=dev)]
    folded = {k: fold_conditioning(m, ncfg, *cond) for k, m in nets.items()}
    ds = make_synthetic_dataset(n_frames=1, H=HW, W=HW, dim_expr=76)
    ro, rd = get_rays(HW, HW, ds.focal, torch.from_numpy(ds.poses[0]).to(dev),
                      ds.cx, ds.cy)
    ro, rd = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    bc = (torch.from_numpy(ds.bc_img).to(dev).float() / 255.0).reshape(-1, 3)
    bc = bc.contiguous()
    near, far = float(ds.near), float(ds.far)
    R = ro.shape[0]

    def ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    calls = dict.fromkeys(NAMES.values(), 0)

    def k2():
        calls["fused_render_coarse_hier"] += 1
        return fr.fused_render_coarse_hier(
            nets["coarse"], folded["coarse"], ncfg, ro, rd, bc, near, far,
            N_SAMPLES, N_IMPORTANCE)

    out = {}
    fr.reset_launch_counts()
    with torch.no_grad():
        coarse, z_all = k2()
        z_all = z_all.contiguous()

        def k1():
            calls["fused_render_rays"] += 1
            return fr.fused_render_rays(nets["fine"], folded["fine"], ncfg,
                                        ro, rd, z_all, bc)

        fine = k1()
        out["K2_wrapper_ms"] = ms(k2, 5)
        out["K1_wrapper_ms"] = ms(k1, 5)
        if not plans:
            return _counted(out, fr, calls)
        lib = build.load_library()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        args = {}
        for key in ("coarse", "fine"):
            packed = fr.pack_operands(nets[key], folded[key], ncfg)
            args[key] = (packed, *fr._chain_args(packed, dev))
        depths = {"coarse": stratified_sample(near, far, N_SAMPLES, R,
                                              device=dev).contiguous(),
                  "fine": z_all}
        for kern, label, rb, ring, blocks in plans:
            entry, key, S, n_imp = KERNELS[kern]
            packed, table, _, ws, n_stages = args[key]
            zin = depths[key]
            if not rb:  # the wrapper's plan; K2's on the coarse net
                widths = (fr._state_widths(N_SAMPLES, N_IMPORTANCE)
                          if key == "coarse" else (0, 0))
                rb, ring = fr._render_plan(lib, S, *widths)
            n = min(R, rb * {-1: sms, -2: sms // 2}.get(blocks, R))
            outs = [torch.empty((n, c), device=dev)
                    for c in ((8, S, S + n_imp) if n_imp else (8, S))]
            tail = (*fr._net_args(packed), ws, n_stages, ring,
                    torch.cuda.current_stream().cuda_stream)

            def launch():
                if n_imp:
                    err = lib.fr_coarse_hier(
                        ro.data_ptr(), rd.data_ptr(), bc.data_ptr(), near,
                        far, *(o.data_ptr() for o in outs), n, S, n_imp, rb,
                        table, *tail)
                else:
                    err = lib.fr_render_rays(
                        ro.data_ptr(), rd.data_ptr(), bc.data_ptr(),
                        zin.data_ptr(), *(o.data_ptr() for o in outs), n,
                        S, rb, table, *tail)
                fr._raise_on(lib, err, NAMES[entry])

            t = ms(launch, 5 if n == R else 100)
            want = coarse if key == "coarse" else fine
            summary, weights = outs[:2]
            same = (torch.equal(summary[:, :3], want["rgb_map"][:n])
                    and torch.equal(summary[:, 3], want["acc_map"][:n])
                    and torch.equal(summary[:, 4], want["last_weight"][:n])
                    and torch.equal(summary[:, 5], want["depth"][:n])
                    and torch.equal(weights, want["weights"][:n]))
            if n_imp:
                same = same and torch.equal(outs[2], z_all[:n])
            out[f"{kern} {label}"] = {
                "rays": n, "rays_per_group": rb, "ring": ring,
                "kernel_ms": t, "bitwise_equal": bool(same)}
        del args
    return _counted(out, fr, calls)


def _counted(out: dict, fr, calls: dict) -> dict:
    out["launches"] = {k: fr.launch_counts[k] for k in NAMES.values()}
    out["calls"] = dict(calls)
    return out


def main(argv=None) -> dict:
    """-> {"results": per worker, "ok": every plan bitwise equal and every
    worker's launch counters equal to its wrapper calls}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--plans", default="[]", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        res = _worker(args.worker, json.loads(args.plans), args.seed)
        print("RESULT " + json.dumps(res), flush=True)
        return {"results": [res], "ok": True}

    from idealnerf_tpu_torch.scripts import build_trees, card, run_worker

    trees = {"this": ROOT}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    build_trees(trees, ("13k_render_rays", "13k_coarse_hier"))
    print(f"card: {card()}; K2 and K1 on the {HW * HW} rays of a {HW}x{HW} "
          f"frame, {N_SAMPLES} coarse + {N_IMPORTANCE} fine depths",
          flush=True)
    order = ([("parent", []), ("this", []), ("this", []), ("parent", [])]
             if args.parent else []) + [("this", PLANS)]
    results, ok = [], True
    for k, plans in order:
        res = run_worker(str(Path(__file__).resolve()), trees[k], [
            "--plans", json.dumps(plans), "--seed", str(args.seed)])
        results.append({"tree": k, **res})
        plan_res = {lb: v for lb, v in res.items()
                    if isinstance(v, dict) and "kernel_ms" in v}
        counted = res["launches"] == res["calls"]
        ok = ok and counted and all(v["bitwise_equal"]
                                    for v in plan_res.values())
        print(f"{k:7s} K2 wrapper {res['K2_wrapper_ms']:.3f} ms, K1 wrapper "
              f"{res['K1_wrapper_ms']:.3f} ms; launches {res['launches']} "
              f"({'equal to' if counted else 'DIFFER FROM'} the calls "
              f"{res['calls']})" + "".join(
                  f"; {lb} {v['kernel_ms']:.3f} ms ({v['rays']} rays, "
                  f"{v['rays_per_group']} per block, ring {v['ring']}, "
                  f"{'bitwise equal' if v['bitwise_equal'] else 'DIFFERS'})"
                  for lb, v in plan_res.items()), flush=True)
    print("RESULTS " + json.dumps(results), flush=True)
    return {"results": results, "ok": ok}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
