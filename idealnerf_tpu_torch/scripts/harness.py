"""The A/B harness of ``kdelta``, ``kframe``, ``kpoint`` and ``kprobe``:
each times a checkout's kernels in a worker process of its own, so that
the checkout's package is the one the worker imports.

A worker is run as a file (``run_worker``), so Python puts this directory
first on its path: the worker imports this module as ``harness``, from the
checkout that holds the script, before it puts the measured checkout's
root in front. A parent checkout's scripts package may predate these
helpers; the worker's timing and fields are then still this file's. The
module imports nothing of the package at its top, for the same reason.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch


def run_worker(script: str, tree, argv, timeout: int = 900) -> dict:
    """``script --worker TREE argv`` in a fresh process, so that TREE's
    package is the one it imports -> the dict of its ``RESULT`` line."""
    r = subprocess.run([sys.executable, script, "--worker", str(tree),
                        *argv], capture_output=True, text=True,
                       timeout=timeout)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    if r.returncode or not line:
        raise RuntimeError(f"{tree}: worker failed\n{r.stdout[-3000:]}\n"
                           f"{r.stderr[-3000:]}")
    return json.loads(line[0][len("RESULT "):])


def build_trees(trees: dict, kernels, sass=None) -> dict:
    """One kernel build per checkout (label -> root), all started
    together; prints each one's ptxas lines of the kernels whose mangled
    names hold one of ``kernels`` (and any wgmma serialized by ptxas,
    C7511) -> {label: {"ptxas": {mangled name: its lines}, "sass": the
    ``sass_counts`` of ``sass`` = (names, ops) in the tree's library}}."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            "idealnerf_tpu_torch.kernels import build; b = build.build(); "
            "print(b['log']); print('LIB ' + b['path'])")
    procs = {k: subprocess.Popen([sys.executable, "-c", code, str(t)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, t in trees.items()}
    out = {}
    for k, p in procs.items():
        log = p.communicate()[0].splitlines()
        if p.returncode:
            raise RuntimeError(f"{k}: build failed\n" + "\n".join(log[-60:]))
        out[k] = {"ptxas": {}, "sass": {}}
        for i, ln in enumerate(log):
            if "C7511" in ln:
                print(f"{k:7s} ptxas: {ln.strip()}", flush=True)
            name = ln.split("Function properties for ")[-1].strip()
            if any(f"Function properties for _ZN2fr{f}" in ln
                   for f in kernels):
                lines = [x.strip() for x in log[i:i + 3]]
                out[k]["ptxas"][name] = lines[1:]
                print(f"{k:7s} ptxas: " + " | ".join(lines), flush=True)
        if sass:
            lib = [ln[4:] for ln in log if ln.startswith("LIB ")][-1]
            out[k]["sass"] = sass_counts(lib, *sass)
            print(f"{k:7s} SASS: {out[k]['sass']}", flush=True)
    return out


def sass_counts(so_path: str, names, ops) -> dict:
    """Instructions of each opcode of ``ops`` (HGMMA: bf16 wgmma, IGMMA: s8
    wgmma, HMMA / IMMA: wmma and mma.sync, FFMA, WARPGROUP: wgmma's
    warpgroup synchronisations) in the SASS of each kernel whose mangled
    name holds one of ``names`` (``cuobjdump -sass`` of the built library,
    the toolkit's beside this checkout's nvcc) -> {op: {name: count}}."""
    from idealnerf_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {op: dict.fromkeys(names, 0) for op in ops}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = next((n for n in names if n in ln), None)
        elif fn:
            for t in ln.split():
                if t.split(".")[0] in counts:
                    counts[t.split(".")[0]][fn] += 1
    return counts


def event_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one warm-up call, CUDA
    events."""
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


def launch_ms(fn, n: int) -> list:
    """ms of each of ``n`` calls of ``fn`` queued back to back after one
    warm-up call, each between its own CUDA events."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]


def paper_nets(dev: torch.device, seed: int = 0, dim_expr: int = 76,
               n: int = 1):
    """``n`` paper head models at full width (D=8, W=256, dim_aud 64,
    dim_latent 32) with random weights, then one conditioning (aud, expr,
    latent of ones), all drawn in that order from one generator of
    ``seed`` -> (cfg, models, each model's folded conditioning)."""
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.models.face_nerf import (
        FaceNeRF, fold_conditioning,
    )

    cfg = ExperimentConfig(dim_aud=64, dim_expr=dim_expr,
                           dim_latent=32).face_nerf_config()
    g = torch.Generator().manual_seed(seed)
    models = [FaceNeRF(cfg, g).to(dev) for _ in range(n)]
    cond = (torch.randn(64, generator=g).to(dev),
            torch.randn(dim_expr, generator=g).to(dev),
            torch.ones(32, device=dev))
    with torch.no_grad():
        folded = [fold_conditioning(m, cfg, *cond) for m in models]
    return cfg, models, folded
