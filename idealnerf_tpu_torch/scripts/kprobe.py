"""Where does the wgmma chain's time go, and how much of the fine pass is
its per-ray code? Times the kernel-diagnosis probes that run the chain
(kernels/kdiag.py) against another checkout's, each checkout in its own
process:

    7a  ``chain`` bf16 on 2^21 rows, out bf16 (scripts/kdiag.py): cast,
        bias_relu, relu2 and sum at 128 and 64 rows per block, in that
        order and then in reverse (labels ``#2``); sum
        against the others splits the chain's time between the products
        with their weight stream, the per-layer barrier and store, the
        real epilogue and its overlap between warpgroups
    7f  ``chain`` relu (kdiag4 V0, kdiag5 B0) on 1M rows, out f32, at 128
        and 64; int8 I0 (kdiag5) on the same rows at 64, the int8 / bf16
        ratio of one card
    7c  ``render_probe_a`` (the fine pass's MLP from given PE rows), 7d
        ``render_probe_b`` (the fine pass without compositing) and 7e the
        fine pass itself (``fused_render_rays``, K1) at 8,192 and 202,500
        (a 450x450 frame's) rays x 192 depths; 7e less 7d is K1's
        per-ray code and compositing, 7d less 7c the PE built in the
        kernel. 7d runs before 7c and again right after it (``after
        7c``), so that 7d's time can be read apart from the card's
        state that 7c, at the power limit, leaves behind
    7b  the ladder's rungs v0 (trunk without the skip's pe-part), v1
        (trunk), v2 (+ view branch) and v3 (+ heads: K5) on 2^21 points
        of kdiag2's encodings; v1 - v0, v2 - v1 and v3 - v2 split K5's
        time into skip, view branch and heads
    lib the same chains as torch.matmul / torch._int_mm calls
        (``chain_library``), timed in this checkout's workers only

    python -m idealnerf_tpu_torch.scripts.kprobe --parent PARENT_DIR

With ``--parent`` (a ``git archive`` of the parent commit) the workers run
in turns: parent, this, this, parent. Times are CUDA events over 10
launches after a warm-up (``harness.event_ms``); inputs are those of the
entry points (``scripts.chain_inputs``, ``kdiag3.rays``, the paper field
of ``scripts.paper_field``) from ``--seed``. Each worker's launch
counters must equal its wrapper calls (else the script exits 1), and each
output is held on a slice of 4,096 rows (or 64 rays) against its plain
version at the entry points' ``--check`` bounds (a worker whose output
leaves them fails, and the script with it). After each timing, about
1.5 s of the same launches are queued and ``nvidia-smi`` reads the SM
clock and power draw under them. ``7a sum r128 zero input`` is sum on an
all-zero x: the same instructions with no operand bits toggling. Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROWS_7A, ROWS_7F, POINTS_7B = 1 << 21, 1 << 20, 1 << 21
RAYS, S = (8192, 202500), 192
MODES_7A = ("cast", "bias_relu", "relu2", "sum")
RPBS = (128, 64)
SLICE_ROWS, SLICE_RAYS = 4096, 64
_ITERS = 10
_LOAD_MS = 1500.0  # launches queued before reading the clock under load


def _smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` reading of the card."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() or r.stderr.strip()


def _worker(tree: str, seed: int, library: bool) -> dict:
    """In tree's package: every probe's time, its launches and its output
    against the plain version on a slice."""
    from harness import event_ms  # this checkout's harness

    sys.path.insert(0, tree)
    import torch

    from idealnerf_tpu_torch import scripts as sc
    from idealnerf_tpu_torch.kernels import fused_mlp as fm
    from idealnerf_tpu_torch.kernels import fused_render as fr
    from idealnerf_tpu_torch.kernels import kdiag as kd
    from idealnerf_tpu_torch.scripts import kdiag2, kdiag3

    dev = torch.device("cuda:0")
    out, errs, smi = {}, {}, {}
    calls = {"kdiag_chain_bf16": 0, "kdiag_chain_int8": 0,
             "kdiag_render_a": 0, "kdiag_render_b": 0,
             "fused_render_rays": 0, "kdiag_ladder": 0,
             "fused_point_mlp_pe": 0}
    for m in (kd, fm, fr):
        m.reset_launch_counts()

    def timed(label, count, fn, plain):
        calls[count] += 1
        got = fn()
        calls[count] += _ITERS + 1
        out[label] = event_ms(fn, _ITERS)
        # the SM clock and power under this load
        n = max(1, int(_LOAD_MS / out[label]))
        calls[count] += n
        for _ in range(n):
            fn()
        smi[label] = _smi("clocks.sm,power.draw")
        torch.cuda.synchronize()
        errs[label] = plain(got)
        del got
        torch.cuda.empty_cache()

    def chain_slice(x, ws, mode, bias, out_dtype):
        want = kd.chain_reference(x[:SLICE_ROWS], ws, mode, bias, out_dtype)
        if x.dtype == torch.int8:
            return lambda got: sc.same(mode, got[:SLICE_ROWS], want)
        check = sc.chain_check(x.dtype)
        return lambda got: check(mode, got[:SLICE_ROWS].contiguous(), want)

    with torch.no_grad():
        x, ws = sc.chain_inputs(ROWS_7A, torch.bfloat16, dev, seed)
        bias = torch.zeros(sc.DEPTH, sc.W, device=dev)  # kdiag.py's
        # the modes in order, then in reverse order (the chain draws the
        # card's power limit, so its clock and its times drift in a run)
        for i, mode in enumerate(MODES_7A + MODES_7A[::-1]):
            b = bias if mode in ("bias_relu", "relu2") else None
            plain = chain_slice(x, ws, mode, b, torch.bfloat16)
            for rpb in RPBS:
                timed(f"7a {mode} r{rpb}" + (" #2" if i >= len(MODES_7A)
                                             else ""), "kdiag_chain_bf16",
                      lambda: kd.chain(x, ws, mode, b, rpb, torch.bfloat16),
                      plain)
        # sum on an all-zero input: the same instructions, no operand bits
        # toggling in the tensor cores
        zero = torch.zeros_like(x)
        timed("7a sum r128 zero input", "kdiag_chain_bf16",
              lambda: kd.chain(zero, ws, "sum", None, 128, torch.bfloat16),
              lambda got: sc.same("sum zero", got[:SLICE_ROWS],
                                  torch.zeros_like(got[:SLICE_ROWS])))
        del zero
        if library:
            out["7a matmul"] = event_ms(lambda: kd.chain_library(x, ws),
                                        _ITERS)
        del x, ws
        for dtype in (torch.bfloat16, torch.int8):
            x, ws = sc.chain_inputs(ROWS_7F, dtype, dev, seed)
            mode = "relu" if dtype == torch.bfloat16 else "i0"
            plain = chain_slice(x, ws, mode, None, torch.float32)
            for rpb in RPBS if dtype == torch.bfloat16 else (64,):
                timed(f"7f {mode} r{rpb}", "kdiag_chain_bf16"
                      if dtype == torch.bfloat16 else "kdiag_chain_int8",
                      lambda: kd.chain(x, ws, mode, None, rpb), plain)
            if library:
                out[f"7f {mode} library"] = event_ms(
                    lambda: kd.chain_library(x, ws, mode), _ITERS)
            del x, ws
        model, folded, cfg, net = sc.paper_field(dev, seed)
        for R in RAYS:
            o, d, bc, z = kdiag3.rays(R, S, dev, seed)
            s = slice(0, SLICE_RAYS)
            pe, ped = kd.encode_rays(net, o, d, z)
            want_a = kd.render_probe_a_reference(net, pe[:SLICE_RAYS * S],
                                                 ped[s], S)
            want_b = kd.render_probe_b_reference(net, o[s], d[s], z[s])
            for label in (f"7d R={R}", f"7c R={R}", f"7d R={R} after 7c"):
                if label.startswith("7c"):
                    timed(label, "kdiag_render_a",
                          lambda: kd.render_probe_a(net, pe, ped, S),
                          lambda got: sc.close_lanes(
                              "7c", got[s].contiguous(), want_a))
                else:
                    timed(label, "kdiag_render_b",
                          lambda: kd.render_probe_b(net, o, d, z),
                          lambda got: sc.close_lanes(
                              "7d", got[s].contiguous(), want_b))
            del pe, ped
            want_c = fr.fused_render_rays_reference(model, folded, cfg, o[s],
                                                    d[s], z[s], bc[s])
            timed(f"7e R={R}", "fused_render_rays",
                  lambda: fr.fused_render_rays(model, folded, cfg, o, d, z,
                                               bc),
                  lambda got: kdiag3.close_render(
                      "7e", {k: v[s] for k, v in got.items()}, want_c))
            del o, d, bc, z
        pe, ped = kdiag2.inputs(net, POINTS_7B, dev, seed)[:2]
        for stage in range(4):
            want = kd.ladder_reference(net, pe[:SLICE_ROWS],
                                       ped[:SLICE_ROWS], stage)
            timed(f"7b v{stage}", "kdiag_ladder" if stage < 3
                  else "fused_point_mlp_pe",
                  lambda: kd.ladder(net, pe, ped, stage),
                  lambda got: (sc.close_lanes if stage == 3 else sc.close)(
                      f"7b v{stage}", got[:SLICE_ROWS].contiguous(), want))
        del pe, ped
    torch.cuda.synchronize()
    launches = {**kd.launch_counts, **fm.launch_counts, **fr.launch_counts}
    res = {"ms": out, "max_err": errs, "calls": calls,
           "launches": {k: launches[k] for k in calls}, "smi": smi}
    if hasattr(kd, "chain_launch_config"):
        res["plans"] = {f"chain r{rpb}": kd.chain_launch_config(ROWS_7A, rpb)
                        for rpb in RPBS}
        if hasattr(kd, "render_probe_launch_config"):
            res["plans"]["7c"] = kd.render_probe_launch_config(S, "a")
            res["plans"]["7d"] = kd.render_probe_launch_config(S, "b")
        else:  # a parent before probe A's plan was K1's
            res["plans"]["7d"] = kd.render_b_launch_config(S)
        res["plans"]["7e"] = fr.render_launch_config(S)
        res["plans"]["7b"] = fm.point_launch_config(POINTS_7B)
    return res


def main(argv=None) -> dict:
    """-> {"results": per worker, "ok": every worker's launch counters
    equal to its wrapper calls and every slice within its bounds}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    ap.add_argument("--library", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        res = _worker(args.worker, args.seed, bool(args.library))
        print("RESULT " + json.dumps(res), flush=True)
        return {"results": [res], "ok": True}

    from idealnerf_tpu_torch.scripts import card
    from idealnerf_tpu_torch.scripts.harness import build_trees, run_worker

    trees = {"this": ROOT}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    build_trees(trees, ("2kd10k_chain_wg", "2kd7k_chain",
                        "2kd12k_mlp_ladder", "2kd16k_render_probe",
                        "13k_render_rays", "14k_point_mlp_pe"))
    print(f"card: {card()}; 7a on {ROWS_7A} rows, 7f and I0 on {ROWS_7F}, "
          f"7c, 7d and 7e at {' and '.join(map(str, RAYS))} rays x {S}, "
          f"7b on {POINTS_7B} points", flush=True)
    turns = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    script = str(Path(__file__).resolve())
    results, ok, lib_done = [], True, False
    for k in turns:
        library = k == "this" and not lib_done
        lib_done = lib_done or library
        res = run_worker(script, trees[k], ["--seed", str(args.seed),
                                            "--library", str(int(library))])
        results.append({"tree": k, **res})
        counted = res["launches"] == res["calls"]
        ok = ok and counted
        print(f"{k:7s} " + ", ".join(
            f"{lb} {ms:.3f} ms" + (f" ({res['smi'][lb]})" if lb in
                                   res.get("smi", {}) else "")
            for lb, ms in res["ms"].items())
              + f"; launches {'equal to' if counted else 'DIFFER FROM'} the "
              f"calls {res['calls']}"
              + (f"; plans {res['plans']}" if "plans" in res else ""),
              flush=True)
    print("RESULTS " + json.dumps(results), flush=True)
    return {"results": results, "ok": ok}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
