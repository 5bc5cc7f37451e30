"""Where does the temporal delta kernel (K3, ``k_render_delta``) spend its
time? Times it at a serving frame's 129,024 prior rays, each checkout in
its own process:

    parent    ``--parent DIR``: the kernel of another checkout (a
              ``git archive`` of the parent commit), through its wrapper,
              timed in turns with this one (parent, this, this, parent)
    this      the checkout's kernel through its wrapper, then its C entry
              alone on prepared operands at other launch plans (rays per
              group, ring stages) and on one wave of ray groups: one group
              per SM, then one on half the SMs. Each block does the same
              work in both, so a time that stays says each SM's own rate
              sets the pace, one that halves says a shared one (L2) does.

    python -m idealnerf_tpu_torch.scripts.kdelta --parent PARENT_DIR

Every plan's outputs are held bitwise against the wrapper's on the rays
they cover (the grouping of rays into blocks and tiles changes no row's
arithmetic); the script exits 1 if one differs. Times are CUDA events over
launches after a warm-up. The rays are seeded random (``--seed``): the
field's cost does not depend on them. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# (label, rays per group, ring stages, ray groups); 0: the wrapper's own
# plan or every group; -1 / -2 groups: one per SM / half the SMs
PLANS = [("auto", 0, 0, 0), ("ring 3", 32, 3, 0), ("ring 2", 32, 2, 0),
         ("8 rays, ring 6", 8, 6, 0), ("wave, all SMs", 0, 0, -1),
         ("wave, half the SMs", 0, 0, -2)]


def _worker(tree: str, plans, rays: int, seed: int) -> dict:
    """In tree's package: the wrapper's time and, for each plan, the
    kernel's C entry alone, its outputs against the wrapper's."""
    from harness import event_ms, paper_nets  # this checkout's harness

    sys.path.insert(0, tree)
    import torch

    from idealnerf_tpu_torch.kernels import build
    from idealnerf_tpu_torch.kernels import fused_render as fr

    dev = torch.device("cuda:0")
    ncfg, (net,), (folded,) = paper_nets(dev, seed)
    gd = torch.Generator(device=dev).manual_seed(seed + 1)
    R, s_prev, s_uni, s_imp, far = rays, 16, 3, 12, 1.2
    ro = (torch.rand(R, 3, generator=gd, device=dev) - 0.5) * 0.2
    ro[:, 2] += 1.0
    rd = torch.randn(R, 3, generator=gd, device=dev)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    rd[:, 2] = -rd[:, 2].abs() - 1.0
    bc = torch.rand(R, 3, generator=gd, device=dev)
    z = torch.sort(torch.rand(R, s_prev, generator=gd, device=dev) * 0.6
                   + 0.55, -1)[0]
    z[:, -1] = far
    w = torch.rand(R, s_prev, generator=gd, device=dev) * 0.1
    lo = torch.full((R,), 0.7, device=dev)
    hi = torch.full((R,), 1.0, device=dev)
    args = (net, folded, ncfg, ro, rd, z, w, lo, hi, bc, far, s_uni, s_imp)

    out = {}
    with torch.no_grad():
        out["wrapper_ms"] = event_ms(lambda: fr.fused_render_delta(*args),
                                     10)
        if not plans:
            return out
        want = fr.fused_render_delta(*args)
        lib = build.load_library()
        packed = fr.pack_operands(net, folded, ncfg)
        table, keep = fr._slots(packed, dev)
        ws, _ = fr.chain_weight_stream(packed)
        S = s_uni + s_imp + 1
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, rb, ring, groups in plans:
            if not rb:
                rb, ring = fr._delta_plan(lib, S, s_prev)
            n = min(R, rb * {-1: sms, -2: sms // 2}.get(groups, R))
            outs = [torch.empty((n, c), device=dev) for c in (8, S, S)]

            def launch():
                err = lib.fr_render_delta(
                    ro.data_ptr(), rd.data_ptr(), bc.data_ptr(), z.data_ptr(),
                    w.data_ptr(), lo.data_ptr(), hi.data_ptr(), far, 0.02,
                    0.98, *(o.data_ptr() for o in outs), n, s_prev, s_uni,
                    s_imp, rb, table, *fr._net_args(packed), ws.data_ptr(),
                    ws.numel() // fr.STAGE_ELEMS, ring,
                    torch.cuda.current_stream().cuda_stream)
                fr._raise_on(lib, err, "k_render_delta")

            t = event_ms(launch, 10 if n == R else 200)
            summary, weights, z_out = outs
            same = (torch.equal(weights, want["weights"][:n])
                    and torch.equal(z_out, want["z_vals"][:n])
                    and torch.equal(summary[:, :3], want["rgb_map"][:n])
                    and torch.equal(summary[:, 6], want["band_lo"][:n])
                    and torch.equal(summary[:, 7], want["band_hi"][:n]))
            out[label] = {"rays": n, "rays_per_group": rb, "ring": ring,
                          "kernel_ms": t, "bitwise_equal": bool(same)}
        del keep
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="")
    ap.add_argument("--rays", type=int, default=129024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--plans", default="[]", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        res = _worker(args.worker, json.loads(args.plans), args.rays,
                      args.seed)
        print("RESULT " + json.dumps(res), flush=True)
        return 0

    from idealnerf_tpu_torch.scripts import card
    from idealnerf_tpu_torch.scripts.harness import build_trees, run_worker

    trees = {"this": ROOT}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    build_trees(trees, ("14k_render_delta",))
    print(f"card: {card()}; K3 at {args.rays} rays, s_prev 16, 3 uniform + "
          "12 importance + plate", flush=True)
    order = ([("parent", []), ("this", []), ("this", []), ("parent", [])]
             if args.parent else []) + [("this", PLANS)]
    results, same = [], True
    for k, plans in order:
        res = run_worker(str(Path(__file__).resolve()), trees[k], [
            "--plans", json.dumps(plans), "--rays", str(args.rays), "--seed",
            str(args.seed)])
        results.append({"tree": k, **res})
        plan_res = {lb: v for lb, v in res.items() if isinstance(v, dict)}
        same = same and all(v["bitwise_equal"] for v in plan_res.values())
        print(f"{k:7s} wrapper {res['wrapper_ms']:.3f} ms" + "".join(
            f"; {lb} {v['kernel_ms']:.3f} ms ({v['rays']} rays, "
            f"{v['rays_per_group']} per group, ring {v['ring']}, "
            f"{'bitwise equal' if v['bitwise_equal'] else 'DIFFERS'})"
            for lb, v in plan_res.items()), flush=True)
    print("RESULTS " + json.dumps(results), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
