#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on one CUDA card.

    python3 chip_smoke.py            # the full check, as documented below
    python3 chip_smoke.py --rays 1024 --hw 64 --frames 2   # a quicker run

Phases, one line each (any failed check raises; the exit code is then
non-zero and no result line is printed):

1. device name, CUDA version and ``nvidia-smi`` name/power limit; build
   the CUDA kernels from ``idealnerf_tpu_torch/kernels/csrc`` (timed).
2. each kernel against its plain PyTorch version on the card, at the
   main path's shapes: ``--rays`` rays of a 450x450 frame through the
   paper head model (D=8, W=256, 64 coarse + 128 importance samples).
   rgb / acc / weights / last_weight are held to 3e-2 absolute, and rgb
   also to a correlation above 0.999 (the bf16 rounding points can round
   one ulp apart); the coarse kernel's fine depths are held to 2e-6 against the
   plain inverse CDF + sort run on the kernel's own coarse weights. A
   softplus-density field, a ragged ray count (1001) and the 16+16
   sampling (a power-of-two union) are checked too. Both kernels run their
   field MLP on the wgmma chain: their ptxas lines, the HGMMA
   instructions in their SASS (``cuobjdump -sass``) and each case's launch
   plan (rays per block, shared memory, weight ring) are printed. Both are
   timed at ``--rays`` and on the 202,500 rays of a whole 450x450 frame,
   the launch shape of the render path, beside a yardstick the port never
   calls: the same points' MLP as bf16 ``torch.addmm`` calls (their
   ``library_ms``), with the host time of each timed call and the
   profiled device time of one; at both sizes the last timed launch is
   held bitwise against the first and, at the tolerances above, against
   the plain version, which is timed too.
3. the slice: ``idealnerf_tpu_torch.cli.render_val.main`` renders
   ``--frames`` synthetic frames of ``--hw``² on the card. The frames must
   be finite (a non-finite pixel makes the PSNR non-finite) and each
   kernel's launch counter must equal the number of frames.
4. a small frame rendered on the card and by the plain versions on the
   host must agree (3e-2, correlation > 0.999).
5. torch.profiler over one 450x450 frame: wall and device-busy time and
   the kernels by device time (full table in chiprun_out/).
6. the fused point MLP (K4, on the wgmma chain like K1-K3, as is K5):
   both point kernels' ptxas lines and the HGMMA instructions in their
   SASS; K4 against its plain version at the training step's coarse and
   fine passes (131,072 and 393,216 points), at ``--points`` (both passes,
   524,288), at a ragged 1,001 and at one point: 3e-2 absolute and a
   correlation above 0.999 per output lane (one point: the bound alone).
   Each case's launch plan (``fused_mlp.point_launch_config``: tiles per
   block, blocks, shared memory, ring) is printed, and two launches and a
   second plan (half the tiles per block, ring 3) must be bitwise equal.
   Timed at ``--points`` through ``fused_point_mlp``, which packs the net
   on every call (the ``kernels`` line's ``ms``, as K1/K2's in phase 2),
   with the host ms of each timed call, beside its plain version
   (``plain_ms``); the last timed launch is held bitwise against the first
   and, at the tolerances above, against the plain version. Then through
   ``point_mlp`` on a packed net (weight stream + launch) with its host ms
   and the profiled device time of one call, and a yardstick the port
   never calls: the same points' MLP as bf16 ``torch.addmm`` calls with
   the dir-PE product per point (``library_ms``).
7. the gradient kernel, f32 and bf16 variants, through the training
   autograd Function against its plain version (explicit backward in
   torch ops) and against f32 autograd of the plain MLP (TF32 off), per
   parameter: the f32 variant within 1e-4 norm-relative of both; the bf16
   variant within 2e-2 of its plain version and 0.15 of f32 autograd (the
   JAX package's bound). aud/expr/latent gradients within 0.05 of their
   maximum. Two launches must give bitwise-equal gradients. Timed at
   ``--points``; the bf16 checks run again at the step's fine pass,
   393,216 points. The bf16 backward is two kernels: at both sizes pass B
   alone is held against its plain version on pass A's own buffers (1e-4
   norm-relative per gradient), each pass is timed apart, a torch.bmm of
   the trunk's seven H^T @ dc products is timed as a yardstick (the port
   never calls it), and the peak memory of one call is read. The new
   kernels' ptxas lines are printed again.
8. the training slice: ``idealnerf_tpu_torch.cli.train_head.main`` on
   ``--train_frames`` synthetic frames of ``--train_hw``² at full width
   (D=8, W=256, N_rand 2048, 64+128) for ``--train_epochs`` epochs: ms per
   step after warm-up, first and last loss and PSNR (finite), both kernels
   launched twice per step; the checkpoint it writes then renders one
   frame through ``render_val.main --head_ckpt`` with a finite PSNR. Then
   torch.profiler over one training step (table in chiprun_out/).
9. the temporal delta kernel against its plain version (depth placement,
   fine pass, next band) on the phase-2 rays and a ragged 1,001 at the
   serving default s_delta 16 (3 uniform + 12 importance depths + the
   plate pin): the previous frame's (z, w) first from a real coarse +
   fine keyframe (192 wide), then from the kernel's own output (16 wide);
   also a softplus field and s_delta 17 (a union of 16 depths). Depths are
   held to 2e-6 against the plain placement, the render to 3e-2 and rgb
   correlation > 0.999, the band to 2e-6 against the plain band of the
   kernel's own depths and weights; two launches must be bitwise equal.
   The wgmma kernel's ptxas line and each case's launch (rays per group,
   shared memory, weight ring) are printed. Timed at ``--rays`` and at the
   129,024 prior rays of a 450x450 frame, beside a yardstick the port
   never calls: the same points' MLP as bf16 ``torch.addmm`` calls (K3's
   ``library_ms``); at both sizes the last timed launch is held bitwise
   against the first and, at the tolerances above, against the plain
   version.
10. the serving slice: ``idealnerf_tpu_torch.cli.serve.main`` streams
   ``--serve_frames`` synthetic frames of 450² at full width under the
   serving defaults (refresh 25, s_delta 16, prior on, AudioAttNet
   smoothing). Past its warm-up (keyframe, then two delta frames) the
   coarse and fine kernels must launch once per keyframe and the delta
   kernel once per delta frame, and every frame must be finite. Then
   ``--roll_k 4 --max_frames 10``: after frame 0 all three launch once per
   frame. A delta frame at the keyframe's own pose (rotated, off-centre
   principal point, s_delta 32) must stay above 20 dB PSNR against the
   keyframe. Then torch.profiler over one steady delta frame.
11. the kernel-diagnosis path: the encoded-input point MLP (K5,
   ``fused_point_mlp(fuse_pe=False)``) against its plain version at
   ``--points`` and a ragged 1,001 (3e-2, correlation > 0.999 per lane),
   timed beside K4 on the same points; every probe kernel of
   ``kernels/kdiag.py`` against its plain version at a ragged 1,001 rows;
   then each ``idealnerf_tpu_torch.scripts.kdiag*`` entry point at its
   own size with ``--check`` (chains at 2^21 rows, kdiag4/5 at 1M and 4M
   rows for the slope, both rows-per-block; the ladder and K5 at 2^21
   points; kdiag3 at the phase-2 rays with S 64 and 192), with the launch
   counters set to 0 before each and read after: every timed output is
   held against its plain version on the same inputs, which is timed
   once (bf16 chains within 3e-2 of the output's max abs, the f32 chain
   within 1e-5 of it, both with a correlation above 0.999; int8 chains
   bitwise equal; the ladder, K5 and the render probes 3e-2 absolute and
   correlation > 0.999, per lane for raw outputs). The library chains
   (``torch.matmul``, ``torch._int_mm``) are timed by the same entry
   points. Last, ``idealnerf_tpu_torch.scripts.kframe`` times the coarse
   and fine kernels on a whole 450x450 frame through their wrappers and
   alone at other launch plans and on one wave of blocks over all and
   half the SMs: every plan's outputs must be bitwise equal to the
   wrapper's and each worker's launch counters equal to its wrapper calls.
   Then ``idealnerf_tpu_torch.scripts.kpoint`` likewise for K4 at 524,288
   points and K5 at 2^21 (ring depths, tiles per block). K5's
   ``library_ms`` is the torch.addmm yardstick on kdiag2's own encodings.

Then the kernel summary as one JSON line (each kernel's launches on its
path, its max error, its time and its plain version's, and its bound: the
larger of the bytes it must move over 3.35 TB/s and its operations at the
H100 SXM data sheet's dense rate for their type, 989 TFLOP/s bf16, 1,979
TOP/s int8, 67 TFLOP/s f32: ``idealnerf_tpu_torch.scripts.PEAK``), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. With no
CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ATOL = 3e-2
MIN_CORR = 0.999
Z_ATOL = 2e-6
GRAD_TOL = {"f32": {"plain": 1e-4, "autograd": 1e-4},
            "bf16": {"plain": 2e-2, "autograd": 0.15}}
COND_TOL = 0.05
PASS_B_TOL = 1e-4
FINE_POINTS = 2048 * 192  # the training step's fine pass
STEP_POINTS = (2048 * 64, FINE_POINTS)  # its coarse and fine passes
KERNELS = {
    "fused_render_coarse_hier": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cu",
        "replaces": "idealnerf_tpu/kernels/fused_render.py:499",
    },
    "fused_render_rays": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cu",
        "replaces": "idealnerf_tpu/kernels/fused_render.py:393",
    },
    "fused_point_mlp": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "idealnerf_tpu/kernels/fused_mlp.py:289",
    },
    "fused_point_mlp_grad": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp_grad.cu",
        "replaces": "idealnerf_tpu/kernels/fused_mlp_grad.py:178",
    },
    "fused_render_delta": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cu",
        "replaces": "idealnerf_tpu/kernels/fused_render.py:604",
    },
    "fused_point_mlp_pe": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "idealnerf_tpu/kernels/fused_mlp.py:311",
    },
    "kdiag_chain": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag.py:70",
    },
    "kdiag2_ladder": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag2.py:114",
    },
    "kdiag3_render_a": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag3.py:269",
    },
    "kdiag3_render_b": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag3.py:291",
    },
    "kdiag3_render_c": {
        "source": "idealnerf_tpu_torch/kernels/csrc/fused_render.cu",
        "replaces": "scripts/kdiag3.py:315",
    },
    "kdiag4_chain": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag4.py:90",
    },
    "kdiag5_chain": {
        "source": "idealnerf_tpu_torch/kernels/csrc/kdiag.cu",
        "replaces": "scripts/kdiag5.py:114",
    },
}
HBM_BYTES_S = 3.35e12
# launches of stream.warmup(): keyframe -> first delta -> steady delta, and
# with --roll_k: keyframe -> two rolling frames
WARMUP = {"fused_render_coarse_hier": 1, "fused_render_rays": 1,
          "fused_render_delta": 2}
WARMUP_ROLL = {"fused_render_coarse_hier": 3, "fused_render_rays": 3,
               "fused_render_delta": 2}
MIN_GEOMETRY_PSNR = 20.0


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
            "nvidia-smi: " + out.stderr.strip())
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def _agree(name, got, want, atol=ATOL, corr=False):
    """Max abs error within ``atol``; with ``corr`` also the correlation
    (rgb only: acc and last_weight are ~1 on every ray, where a
    correlation measures nothing)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    c = float("nan")
    if corr:
        c = float(torch.corrcoef(torch.stack([got.reshape(-1),
                                              want.reshape(-1)]))[0, 1])
    ok = err <= atol and (not corr or c > MIN_CORR)
    print(f"  {name}: max_abs_err {err:.3e} (tol {atol:g})"
          + (f", corr {c:.6f} (> {MIN_CORR})" if corr else ""))
    if not ok:
        raise AssertionError(f"{name} disagrees with the plain version")
    return err


def _time_ms(fn, iters: int, host=None) -> float:
    """CUDA-event ms per call of fn over ``iters`` calls after a warm-up;
    ``host`` (a list) gets the host ms each timed call takes to return."""
    import torch

    fn()                                   # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        h0 = time.perf_counter()
        fn()
        if host is not None:
            host.append(1e3 * (time.perf_counter() - h0))
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _device_ms(run, key: str) -> float:
    """Device ms of the kernels whose name holds ``key`` in one warm call
    of ``run`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages() if key in e.key) / 1e3


def _profile(run, label: str, fname: str) -> dict:
    """torch.profiler over one warm call of ``run``: wall time, device busy
    time and the kernels by device time (table in chiprun_out/)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: an aten op's own row repeats its kernels' time
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    top = sorted(on_dev, key=dev_us, reverse=True)[:8]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", fname), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top": [[e.key, dev_us(e) / 1e3, e.count] for e in top]}
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {out['idle_share']:.3f}; by device "
          "time: " + "; ".join(f"{k[:40]} {ms:.2f} ms x{n}"
                               for k, ms, n in out["top"]))
    return out


def _mlp_macs(ncfg):
    """(multiply-adds per point, per ray) of the field: the trunk with its
    skip input, the view branch and the heads per point; the view layer's
    dir-PE part per ray (the point kernels pay it per point)."""
    W, D, V = ncfg.width, ncfg.depth, ncfg.width // 2
    pt = ncfg.input_ch * W + (D - 1) * W * W + W * V + (D // 4) * V * V
    pt += sum(ncfg.input_ch * W for i in range(1, D) if i - 1 in ncfg.skips)
    return pt + W + 3 * V, ncfg.input_ch_views * V


def _bound(flops: float, nbytes: float, kind: str = "bf16") -> dict:
    """The least time the card could take: operations at the dense peak
    for their type or bytes at the memory rate, whichever is longer."""
    from idealnerf_tpu_torch.scripts import PEAK

    t_ops, t_bytes = flops / PEAK[kind], nbytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _weight_bytes(ncfg) -> int:
    """bf16 weights and f32 biases, each read once."""
    pt, ray = _mlp_macs(ncfg)
    V = ncfg.width // 2
    return 2 * (pt + ray) + 4 * (ncfg.depth * ncfg.width
                                 + (1 + ncfg.depth // 4) * V + 4)


def _ray_bound(ncfg, rays: int, S: int, cols_in: int, cols_out: int):
    """Bound of a ray kernel: ``rays`` rays of S samples, reading
    ``cols_in`` and writing ``cols_out`` f32 values per ray."""
    pt, ray = _mlp_macs(ncfg)
    return _bound(2.0 * rays * (S * pt + ray),
                  _weight_bytes(ncfg) + 4.0 * rays * (cols_in + cols_out))


def _point_bound(ncfg, n: int, passes: int, grads: bool):
    """Bound of a point kernel on n points (pts, dirs in; raw out, or the
    cotangent in and f32 weight gradients out): ``passes`` multiply-add
    passes over the MLP (1 forward; 3 for the rematerialising backward)."""
    pt, ray = _mlp_macs(ncfg)
    nbytes = _weight_bytes(ncfg) + 4.0 * n * (6 + 4)
    if grads:
        nbytes += 2 * _weight_bytes(ncfg)
    return _bound(2.0 * passes * n * (pt + ray), nbytes)


def _delta_split(s_delta: int):
    """(s_uni, s_imp) of a delta frame of s_delta depths, at the
    renderers' default uni_frac 0.25."""
    n_in = s_delta - 1
    s_uni = max(2, int(n_in * 0.25))
    return s_uni, n_in - s_uni


def _addmm_mlp(packed):
    """The yardsticks' MLP as bf16 torch.addmm calls, bias in the call and
    relu in place: (pe, view-layer-0 term pv) -> raw (n, HEADS), the trunk
    with the skip layer's PE product, the view branch, the heads."""
    import torch

    bf = torch.bfloat16
    b = [x.to(bf) for x in packed.b]
    bv = [x.to(bf) for x in packed.bv]
    bh = packed.b_heads.to(bf)

    def mlp(pe, pv):
        h = torch.addmm(b[0], pe, packed.w[0]).relu_()
        for i in range(1, len(packed.w)):
            acc = b[i]
            if i in packed.wskip:
                acc = torch.addmm(acc, pe, packed.wskip[i])
            h = torch.addmm(acc, h, packed.w[i]).relu_()
        hv = torch.addmm(pv, h, packed.wv[0]).relu_()
        for v in range(1, len(packed.wv)):
            hv = torch.addmm(bv[v], hv, packed.wv[v]).relu_()
        return torch.addmm(torch.addmm(bh, h, packed.w_alpha), hv,
                           packed.w_rgb)
    return mlp


def _mlp_library_ms(fr, packed, o, d, z, chunk: int = 1 << 22) -> float:
    """The ray kernels' yardstick, timed only (the port never calls it):
    the field MLP of the R x S points of rays o, d at depths z as bf16
    torch.addmm calls (_addmm_mlp) on chunks of whole rays of at most
    ``chunk`` points, the view branch's per-ray term expanded per point.
    The encodings are made before the timing."""
    import torch
    import torch.nn.functional as F

    from idealnerf_tpu_torch.core.embedding import positional_encoding

    bf = torch.bfloat16
    S = z.shape[1]
    ped = positional_encoding(d / d.norm(dim=-1, keepdim=True),
                              packed.multires_views)
    ped = F.pad(ped, (0, fr.PED_PAD - ped.shape[1])).to(bf).float()
    pv = (ped @ packed.wv0d.float() + packed.bv[0]).to(bf)
    step = max(1, chunk // S)
    parts = []
    for s in range(0, o.shape[0], step):
        pts = (o[s:s + step, None] + d[s:s + step, None]
               * z[s:s + step, :, None]).reshape(-1, 3)
        pe = positional_encoding(pts, packed.multires)
        parts.append((F.pad(pe, (0, fr.PE_PAD - pe.shape[1])).to(bf),
                      pv[s:s + step].repeat_interleave(S, 0)))
        del pts, pe
    mlp = _addmm_mlp(packed)

    def run():
        for pe, pv in parts:
            mlp(pe, pv)

    ms = _time_ms(run, 3)
    del parts
    return ms


def _point_library_ms(packed, pe, ped, chunk: int = 1 << 22) -> float:
    """The point kernels' yardstick, timed only (the port never calls it):
    the MLP of the points of the bf16 encodings pe (N, PE_PAD) and ped (N,
    PED_PAD) as bf16 torch.addmm calls (_addmm_mlp) on chunks of at most
    ``chunk`` points, view layer 0's dir-PE product per point (bv[0] +
    ped @ wv0d) one more torch.addmm."""
    import torch

    mlp = _addmm_mlp(packed)
    bv0 = packed.bv[0].to(torch.bfloat16)

    def run():
        for s in range(0, pe.shape[0], chunk):
            mlp(pe[s:s + chunk],
                torch.addmm(bv0, ped[s:s + chunk], packed.wv0d))

    return _time_ms(run, 3)


def _hgmma_counts(so_path: str, names) -> dict:
    """HGMMA instructions in the SASS of each kernel whose mangled name
    holds one of ``names`` (``cuobjdump -sass`` of the built library)."""
    from idealnerf_tpu_torch.kernels import build as kbuild

    tool = os.path.join(os.path.dirname(kbuild._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = dict.fromkeys(names, 0), None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = next((n for n in names if n in ln), None)
        elif fn and "HGMMA" in ln:
            counts[fn] += 1
    return counts


def _phase_frame(fr, nets, fc, ff, ncfg, near, far, n_s, n_i, sizes,
                 ptxas, so_path) -> dict:
    """Phase 2b: the coarse and fine kernels' ptxas lines and HGMMA
    counts, then both timed at each size of ``sizes`` (tag -> rays o, d,
    bc) beside the plain versions, the torch.addmm yardstick and the
    bound; the last timed launch is held bitwise against the first and,
    like phase 2a, against the plain version."""
    import torch

    from idealnerf_tpu_torch.core.sampling import stratified_sample

    for i, ln in enumerate(ptxas):
        if any(f"Function properties for _ZN2fr{k}" in ln
               for k in ("13k_render_rays", "13k_coarse_hier")):
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
    names = ("k_coarse_hier", "k_render_rays", "k_render_delta")
    hgmma = _hgmma_counts(so_path, names)
    print(f"  HGMMA instructions in the SASS: {hgmma}")
    if not all(hgmma[k] > 0 for k in names):
        raise AssertionError(f"a chain kernel has no HGMMA: {hgmma}")
    S = n_s + n_i
    pt, ray = _mlp_macs(ncfg)
    packed = {k: fr.pack_operands(nets[k], f, ncfg)
              for k, f in (("coarse", fc), ("fine", ff))}
    out = {"hgmma": hgmma}
    for tag, (o, d, b) in sizes.items():
        R, dev = o.shape[0], o.device
        c_args = (nets["coarse"], fc, ncfg, o, d, b, near, far, n_s, n_i)
        first_c, z = fr.fused_render_coarse_hier(*c_args)
        f_args = (nets["fine"], ff, ncfg, o, d, z, b)
        first_f = fr.fused_render_rays(*f_args)
        last = {}
        runs = {
            "coarse": lambda: last.update(
                coarse=fr.fused_render_coarse_hier(*c_args)),
            "coarse plain": lambda: last.update(
                coarse_plain=fr.fused_render_coarse_hier_reference(*c_args)),
            "fine": lambda: last.update(fine=fr.fused_render_rays(*f_args)),
            "fine plain": lambda: last.update(
                fine_plain=fr.fused_render_rays_reference(*f_args))}
        host = {k: [] for k in runs}
        ms = {k: _time_ms(fn, 2 if "plain" in k else 5, host[k])
              for k, fn in runs.items()}
        (kc, kz), (pc, _) = last["coarse"], last["coarse_plain"]
        kf, pf = last["fine"], last["fine_plain"]
        same = (all(torch.equal(first_c[k], kc[k]) for k in first_c)
                and torch.equal(z, kz)
                and all(torch.equal(first_f[k], kf[k]) for k in first_f))
        print(f"  R={R} ({tag}): the last timed launches bitwise equal to "
              f"the first: {same}; against the plain versions:")
        if not same:
            raise AssertionError("a timed launch differs from the first")
        keys = ("rgb_map", "acc_map", "weights", "last_weight")
        zc = stratified_sample(near, far, n_s, R, device=dev)
        e2 = [_agree(f"coarse {k}", kc[k], pc[k], corr=k == "rgb_map")
              for k in keys]
        e2.append(_agree("coarse z_all vs plain merge of the kernel's "
                         "weights", kz, fr.importance_depths(
                             zc, kc["weights"], n_i), atol=Z_ATOL))
        e1 = [_agree(f"fine {k}", kf[k], pf[k], corr=k == "rgb_map")
              for k in keys]
        res = {}
        for name, kernel, key, n, zz, cols, err in (
                ("fused_render_coarse_hier", "k_coarse_hier", "coarse", n_s,
                 zc, (9, 8 + n_s + S), max(e2)),
                ("fused_render_rays", "k_render_rays", "fine", S, z,
                 (9 + S, 8 + S), max(e1))):
            lib = _mlp_library_ms(fr, packed[key], o, d, zz)
            bnd = _ray_bound(ncfg, R, n, *cols)
            flops = 2.0 * R * (n * pt + ray)
            t = ms[key]
            dms = _device_ms(runs[key], kernel)
            res[name] = {"ms": t, "plain_ms": ms[key + " plain"],
                         "library_ms": lib, "max_abs_err": err,
                         "device_ms": dms, "host_ms": host[key],
                         "tflops": flops / t / 1e9,
                         "bound_share": bnd["bound_ms"] / t, **bnd}
            print(f"  {name} at R={R} ({tag}), S {n}: kernel {t:.3f} ms "
                  f"({flops / t / 1e9:.1f} TFLOP/s, "
                  f"{100 * bnd['bound_ms'] / t:.1f} % of the bound; "
                  f"profiled device time of one call {dms:.3f} ms, host "
                  "ms per timed call "
                  + ", ".join(f"{h:.2f}" for h in host[key]) + "), plain "
                  f"{ms[key + ' plain']:.3f} ms, torch.addmm chain of the MLP"
                  f" {lib:.3f} ms (yardstick, timed only), bound "
                  f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} (CUDA "
                  "events)")
        out[tag] = res
        del first_c, first_f, z, last, runs, kc, kz, pc, kf, pf
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def _phase_delta(fr, nets, fold, ncfg, near, far, n_s, n_i, ro, rd, bc,
                 prior, ptxas) -> dict:
    """Phase 9: the delta kernel against its plain version, two launches
    bitwise equal, then timed at the phase-2 rays and at the prior rays
    of a 450x450 frame beside its torch.matmul yardstick; the timed
    launches are held against the first and the plain version there too."""
    import torch

    from idealnerf_tpu_torch.core.composite import fg_band

    print("phase 9 temporal delta kernel vs plain version")
    for i, ln in enumerate(ptxas):  # the wgmma kernel's registers, spills
        if "k_render_delta" in ln:
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
    span = far - near

    def keyframe(c, o, d, b):
        fc, ff = fold(nets["coarse"], c), fold(nets["fine"], c)
        _, z = fr.fused_render_coarse_hier(nets["coarse"], fc, c, o, d, b,
                                           near, far, n_s, n_i)
        w = fr.fused_render_rays(nets["fine"], ff, c, o, d, z, b)["weights"]
        return z, w

    def band(z, w):
        lo, hi, _ = fg_band(z, w)
        return ((lo - 0.02 * span).clamp(near, far).contiguous(),
                (hi + 0.02 * span).clamp(near, far).contiguous())

    def agree(k, again, p):
        """The kernel's two outputs bitwise equal, and against the plain
        version: depths, render, and the band of the kernel's own z, w."""
        if not all(torch.equal(k[key], again[key]) for key in k):
            raise AssertionError("two delta launches differ")
        print("  two launches bitwise equal")
        e = [_agree("z_vals vs plain placement", k["z_vals"], p["z_vals"],
                    atol=Z_ATOL)]
        e += [_agree(key, k[key], p[key], corr=key == "rgb_map") for key
              in ("rgb_map", "acc_map", "weights", "last_weight")]
        b_lo, b_hi, _ = fg_band(k["z_vals"], k["weights"])
        e.append(_agree("band_lo vs plain band of the kernel's z, w",
                        k["band_lo"], b_lo, atol=Z_ATOL))
        e.append(_agree("band_hi vs plain band of the kernel's z, w",
                        k["band_hi"], b_hi, atol=Z_ATOL))
        return max(e)

    def check(tag, c, n, s_delta):
        o, d, b = ro[:n], rd[:n], bc[:n]
        s_uni, s_imp = _delta_split(s_delta)
        ff = fold(nets["fine"], c)
        z, w = keyframe(c, o, d, b)
        err = 0.0
        for _ in range(2):   # from the keyframe, then from its own output
            lo, hi = band(z, w)
            args = (nets["fine"], ff, c, o, d, z, w, lo, hi, b, far, s_uni,
                    s_imp)
            k = fr.fused_render_delta(*args)
            again = fr.fused_render_delta(*args)
            p = fr.fused_render_delta_reference(*args)
            lc = fr.delta_launch_config(s_uni + s_imp + 1, z.shape[1])
            print(f" fused_render_delta [{tag}, R={n}, s_prev {z.shape[1]}, "
                  f"{s_uni} uniform + {s_imp} importance + plate]: "
                  f"{lc['rays_per_group']} rays per group, "
                  f"{lc['smem_bytes']} bytes of shared memory, a ring of "
                  f"{lc['ring_stages']} stages of {lc['stage_bytes']} bytes")
            err = max(err, agree(k, again, p))
            z, w = k["z_vals"], k["weights"]
        torch.cuda.synchronize()
        return err

    sp = dataclasses.replace(ncfg, density_activation="softplus")
    rays = ro.shape[0]
    err = max(check("relu", ncfg, rays, 16),
              check("relu, ragged", ncfg, min(1001, rays), 16),
              check("softplus, ragged", sp, min(1001, rays), 16),
              check("relu, ragged, union of 16", ncfg, min(1001, rays), 17))

    # timing on steady-state inputs (s_prev 16), as a serving delta frame
    s_uni, s_imp = _delta_split(16)
    ff = fold(nets["fine"], ncfg)
    out = {"max_abs_err": err}
    for tag, (o, d, b) in (("phase-2 rays", (ro, rd, bc)),
                           ("450x450 prior rays", prior)):
        z, w = keyframe(ncfg, o, d, b)
        lo, hi = band(z, w)
        k = fr.fused_render_delta(nets["fine"], ff, ncfg, o, d, z, w, lo, hi,
                                  b, far, s_uni, s_imp)
        z, w = k["z_vals"], k["weights"]
        lo, hi = band(z, w)
        args = (nets["fine"], ff, ncfg, o, d, z, w, lo, hi, b, far, s_uni,
                s_imp)
        first = fr.fused_render_delta(*args)
        last = {}

        def kernel():
            last.update(fr.fused_render_delta(*args))

        def plain():
            last["plain"] = fr.fused_render_delta_reference(*args)

        ms = _time_ms(kernel, 5)
        pms = _time_ms(plain, 2)
        # the timed launches against the first, then against the plain
        # version at the timed size
        print(f"  R={o.shape[0]} ({tag}), s_prev 16: the last timed launch "
              "against the first, and against the plain version")
        err = max(err, agree(first, {key: last[key] for key in first},
                             last["plain"]))
        lib = _mlp_library_ms(fr, fr.pack_operands(nets["fine"], ff, ncfg),
                              o, d, k["z_vals"])
        n = o.shape[0]
        bnd = _ray_bound(ncfg, n, 16, 9 + 2 * 16 + 2, 8 + 2 * 16)
        print(f"  fused_render_delta at R={n} ({tag}), s_prev 16, 3+12+1: "
              f"kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"torch.addmm chain of the MLP "
              f"{lib:.3f} ms (yardstick, timed only), bound "
              f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} (CUDA events)")
        out[n] = {"ms": ms, "plain_ms": pms, "library_ms": lib, **bnd}
        del z, w, k, args, first, last
    torch.cuda.synchronize()
    out["max_abs_err"] = err
    out.update(out[prior[0].shape[0]])
    return out


def _phase_serve(fr, nets, ncfg, cond, ds, prior_mask) -> dict:
    """Phase 10: cli.serve.main under the serving defaults and rolling,
    the delta geometry check, and a profiled steady delta frame."""
    import numpy as np
    import torch

    from idealnerf_tpu_torch.cli import serve
    from idealnerf_tpu_torch.eval.temporal import (
        make_temporal_frame_renderer,
    )

    H, W = ds.hw
    base = ["--synthetic", str(ds.size), "--synthetic_hw", str(H),
            "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
            "--device", "cuda"]
    out = {}
    for tag, extra, warm in (("defaults", [], WARMUP),
                             ("roll_k 4", ["--roll_k", "4", "--max_frames",
                                           "10"], WARMUP_ROLL)):
        fr.reset_launch_counts()
        stats = serve.main(base + extra)
        counts = dict(fr.launch_counts)
        live = {k: counts[k] - warm[k] for k in warm}
        n = stats["frames"]
        if extra:
            want = {"fused_render_coarse_hier": n, "fused_render_rays": n,
                    "fused_render_delta": n - 1}
        else:
            want = {"fused_render_coarse_hier": stats["keyframes"],
                    "fused_render_rays": stats["keyframes"],
                    "fused_render_delta": stats["delta_frames"]}
        print(f"phase 10 serve [{tag}]: {n} frames of {H}x{W}, "
              f"{stats['keyframes']} keyframes + {stats['delta_frames']} "
              f"delta frames; launches {counts} (live {live}, want {want}); "
              f"p50 {stats['p50_ms']:.2f} ms, p95 {stats['p95_ms']:.2f} ms, "
              f"steady {stats['steady_fps']:.2f} fps, keyframe "
              f"{stats['keyframe_ms']} ms, delta p50 {stats['delta_p50_ms']}"
              f" ms, warm-up {stats['warmup_s']:.2f} s")
        if not stats["finite"]:
            raise AssertionError(f"serve [{tag}] emitted a non-finite frame")
        if live != want:
            raise AssertionError(f"serve [{tag}] launched {live}, want {want}")
        out[tag] = {"stats": stats, "launches": counts}

    # a delta frame at the keyframe's own pose: the delta path's rays must
    # be the keyframe's (rotated pose, off-centre principal point)
    h = w = 64
    th = 0.35
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]], np.float32)
    pose = torch.from_numpy(np.concatenate(
        [rot, np.array([[0.3], [0.1], [0.9]], np.float32)], 1)).cuda()
    bc64 = torch.rand(h, w, 3, generator=torch.Generator().manual_seed(4))
    tm = make_temporal_frame_renderer(ncfg, h, w, 96.0, 0.5, 1.5,
                                      _render_cfg(), cx=w * 0.41,
                                      cy=h * 0.57, s_delta=32)
    kf, c0 = tm(nets, pose, bc64.cuda(), *cond)
    dl, _ = tm(nets, pose, bc64.cuda(), *cond, cache=c0)
    psnr = float(-10.0 * torch.log10(((kf - dl) ** 2).mean() + 1e-12))
    print(f"  delta frame at the keyframe's pose (rotated, off-centre, "
          f"s_delta 32, {h}x{w}): PSNR {psnr:.2f} dB against the keyframe "
          f"(> {MIN_GEOMETRY_PSNR:g})")
    if not psnr > MIN_GEOMETRY_PSNR:
        raise AssertionError("delta-frame rays disagree with the keyframe's")
    out["geometry_psnr"] = psnr

    # one steady delta frame of the serving configuration, profiled
    tm = make_temporal_frame_renderer(
        ncfg, H, W, ds.focal, ds.near, ds.far, _render_cfg(), cx=ds.cx,
        cy=ds.cy, prior_mask=prior_mask, s_delta=16)
    pose = torch.from_numpy(ds.poses[1]).cuda()
    bc = torch.from_numpy(ds.bc_img).cuda().float() / 255
    _, c = tm(nets, torch.from_numpy(ds.poses[0]).cuda(), bc, *cond)
    _, c = tm(nets, pose, bc, *cond, cache=c)
    prof = _profile(lambda: tm(nets, pose, bc, *cond, cache=c),
                    f"steady delta frame ({H}x{W}, prior, s_delta 16)",
                    "profile_delta_frame.txt")
    prof["k3_ms"] = sum(ms for k, ms, _ in prof["top"]
                        if "k_render_delta" in k)
    out["profile"] = prof
    torch.cuda.synchronize()
    return out


def _plan_text(lc: dict) -> str:
    return (f"{lc['rays_per_group']} rays per block, {lc['smem_bytes']} "
            f"bytes of shared memory, a ring of {lc['ring_stages']} stages "
            f"of {lc['stage_bytes']} bytes")


def _render_cfg():
    from idealnerf_tpu_torch.config import ExperimentConfig

    return ExperimentConfig(dim_aud=64, dim_expr=76,
                            dim_latent=32).render_config()


def _norm_rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / (want.norm() + 1e-12))


def _grads_of(train_fn, model, folded_fn, cond, pts, dirs, w):
    """(per-parameter gradients, conditioning gradients) of
    sum(raw * w) through ``train_fn``."""
    c = [x.detach().clone().requires_grad_(True) for x in cond]
    model.zero_grad(set_to_none=True)
    raw = train_fn(model, folded_fn(model, c), pts, dirs)
    (raw * w).sum().backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads, [x.grad.detach().clone() for x in c]


def _phase_point_mlp(fm, fr, net, folded, ncfg, pts, dirs, ptxas,
                     so_path) -> dict:
    """Phase 6: K4's (and K5's) ptxas lines and HGMMA counts; K4 against its
    plain version at the training step's coarse and fine passes, at
    ``pts``' size and ragged, each case's two launches and another plan
    bitwise equal; then timed at ``pts``' size beside its plain version and
    the torch.addmm yardstick, the last timed launch held bitwise against
    the first."""
    import torch

    print("phase 6 fused point MLP (K4) vs plain version")
    names = ("11k_point_mlp", "14k_point_mlp_pe")
    for i, ln in enumerate(ptxas):
        if any(f"Function properties for _ZN2fr{k}" in ln for k in names):
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))
    hgmma = _hgmma_counts(so_path, names)
    print(f"  HGMMA instructions in the SASS: {hgmma}")
    if not all(hgmma[k] > 0 for k in names):
        raise AssertionError(f"a point kernel has no HGMMA: {hgmma}")
    packed = fr.pack_operands(net, folded, ncfg)
    n = pts.shape[0]
    sizes = sorted({m for m in (*STEP_POINTS, n) if m <= n}, reverse=True)
    err, first = 0.0, None
    for m in sizes + [1001, 1]:
        p, d = pts[:m], dirs[:m]
        lc = fm.point_launch_config(m)
        got = fm.fused_point_mlp(net, folded, ncfg, p, d)
        again = fm.fused_point_mlp(net, folded, ncfg, p, d)
        plan = (max(1, lc["tiles_per_block"] // 2), 3)
        other = fm.launch_point_kernel(packed, p, d, False, plan)
        want = fm.fused_point_mlp_reference(net, folded, ncfg, p, d)
        same = torch.equal(got, again) and torch.equal(got, other)
        print(f" fused_point_mlp N={m}: {lc['tiles_per_block']} tiles x "
              f"{lc['blocks']} blocks, {lc['smem_bytes']} bytes of shared "
              f"memory, a ring of {lc['ring_stages']} stages of "
              f"{lc['stage_bytes']} bytes; two launches and the plan of "
              f"{plan[0]} tiles per block, ring {plan[1]}, bitwise equal: "
              f"{same}")
        if not same:
            raise AssertionError("K4's launches or plans differ")
        # one point has no correlation: N = 1 is held to the bound alone
        for c in range(4):
            err = max(err, _agree(f"N={m} raw[:, {c}]", got[:, c],
                                  want[:, c], corr=m > 1))
        if m == n:
            first = got
        del got, again, other, want
    torch.cuda.synchronize()
    # the kernels line's span, as the parent's: the wrapper that packs the
    # net on every call (as K1/K2's in phase 2), and its plain version
    last, host, point_host = {}, [], []
    ms = _time_ms(lambda: last.update(k=fm.fused_point_mlp(
        net, folded, ncfg, pts, dirs)), 5, host)
    pms = _time_ms(lambda: last.update(p=fm.fused_point_mlp_reference(
        net, folded, ncfg, pts, dirs)), 2)
    same = torch.equal(first, last["k"])
    print(f"  N={n}: the last timed launch bitwise equal to the first: "
          f"{same}; against the plain version:")
    if not same:
        raise AssertionError("a timed K4 launch differs from the first")
    for c in range(4):
        err = max(err, _agree(f"N={n} timed raw[:, {c}]", last["k"][:, c],
                              last["p"][:, c], corr=True))
    del last, first
    # beside it: the kernel on a packed net (weight stream + launch), its
    # host ms and the profiled device time of one call
    point_ms = _time_ms(lambda: fm.point_mlp(packed, pts, dirs), 5,
                        point_host)
    dms = _device_ms(lambda: fm.point_mlp(packed, pts, dirs), "k_point_mlp")
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fm.encode_points(packed, pts, dirs))
    lib = _point_library_ms(packed, pe, ped)
    del pe, ped
    bnd = _point_bound(ncfg, n, 1, False)
    pt, ray = _mlp_macs(ncfg)
    flops = 2.0 * n * (pt + ray)
    print(f"  fused_point_mlp at N={n}: {ms:.3f} ms through fused_point_mlp "
          "(packs the net every call; host ms per timed call "
          + ", ".join(f"{h:.2f}" for h in host) + f"), plain {pms:.3f} ms; "
          f"through point_mlp on a packed net {point_ms:.3f} ms "
          f"({flops / point_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bnd['bound_ms'] / point_ms:.1f} % of the bound; host ms "
          "per timed call " + ", ".join(f"{h:.2f}" for h in point_host)
          + f"), profiled device time of one call {dms:.3f} ms "
          f"({100 * bnd['bound_ms'] / dms:.1f} % of the bound); torch.addmm "
          f"chain of the MLP {lib:.3f} ms (yardstick, timed only); bound "
          f"{bnd['bound_ms']:.3f} ms by {bnd['bound_by']} (CUDA events)")
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms,
            "library_ms": lib, "host_ms": host, "point_mlp_ms": point_ms,
            "point_mlp_host_ms": point_host, "device_ms": dms,
            "hgmma": hgmma, "tflops": flops / point_ms / 1e9, **bnd}


def _grad_checks(fmg, tag, gd, ncfg, net, cond, pts, dirs, ref, ref_c, w):
    """The kernel's gradients through the training autograd Function
    against the plain backward and f32 autograd per parameter, the
    conditioning gradients, and two launches bitwise equal -> (max abs
    error against the plain backward, worst errors, packed operands,
    cotangent)."""
    import torch

    from idealnerf_tpu_torch.kernels.fused_render import (
        model_leaves, pack_leaves,
    )
    from idealnerf_tpu_torch.models.face_nerf import fold_conditioning

    n = pts.shape[0]

    def folded_fn(model, c):
        return fold_conditioning(model, ncfg, *c)

    def kern(model, folded, p, d):
        return fmg.fused_point_mlp_train(ncfg, model, folded, p, d, gd)

    def plain(model, folded, p, d):
        return fmg.fused_point_mlp_train_reference(ncfg, model, folded, p, d,
                                                   gd)

    got, got_c = _grads_of(kern, net, folded_fn, cond, pts, dirs, w)
    want, _ = _grads_of(plain, net, folded_fn, cond, pts, dirs, w)
    worst = {"plain": (0.0, ""), "autograd": (0.0, "")}
    err = 0.0
    for name in ref:
        for what, r in (("plain", want[name]), ("autograd", ref[name])):
            e = _norm_rel(got[name], r)
            if e > worst[what][0]:
                worst[what] = (e, name)
        err = max(err, float((got[name] - want[name]).abs().max()))
    for what, (e, name) in worst.items():
        tol = GRAD_TOL[tag][what]
        print(f"  {tag} N={n}: worst norm-relative error vs {what} {e:.3e} "
              f"({name}; tol {tol:g})")
        if not e <= tol:
            raise AssertionError(f"{tag} gradients disagree with {what}")
    for x, r, name in zip(got_c, ref_c, ("aud", "expr", "latent")):
        scale = float(r.abs().max())
        e = float((x - r).abs().max()) / (scale + 1e-12)
        print(f"  {tag} N={n}: d{name} max error {e:.3e} relative to its "
              f"max {scale:.3e} (tol {COND_TOL:g})")
        if not (e < COND_TOL and float(x.abs().max()) > 0):
            raise AssertionError(f"{tag} d{name} disagrees or is zero")

    # bitwise repeatability of the kernels themselves, on packed operands
    folded = fold_conditioning(net, ncfg, *cond)
    packed = pack_leaves(ncfg, model_leaves(net, folded, ncfg), gd)
    g = (w * n).contiguous()
    a = fmg.point_mlp_grad(packed, pts, dirs, g)
    b = fmg.point_mlp_grad(packed, pts, dirs, g)
    same = all(torch.equal(x, y) for x, y in zip(_packed_list(a),
                                                  _packed_list(b)))
    print(f"  {tag} N={n}: two launches bitwise equal: {same}")
    if not same:
        raise AssertionError(f"{tag} gradient kernel is not repeatable")
    return err, {k: v[0] for k, v in worst.items()}, packed, g


def _packed_list(p):
    return [*p.w, *p.b, *p.wskip.values(), *p.wv, *p.bv, p.wv0d, p.w_alpha,
            p.w_rgb, p.b_heads]


def _pass_bounds(fmg, ncfg, packed, n: int):
    """Bounds of the bf16 backward's two passes on n points: pass A does
    the forward's and the input gradients' multiply-adds and writes the
    operand planes and bias rows; pass B does every weight gradient's
    multiply-adds and reads them."""
    n_tiles = -(-n // fmg.GRAD_TILE)
    _, widths, total = fmg.grad_planes(packed, n_tiles)
    nb = sum(x.numel() for x in packed.b) + sum(
        x.numel() for x in packed.bv) + packed.b_heads.numel()
    out_bytes = 2 * total + 4 * n_tiles * nb
    pt, ray = _mlp_macs(ncfg)
    a = _bound(2.0 * 2 * n * (pt + ray),
               _weight_bytes(ncfg) + 4.0 * n * (6 + 4) + out_bytes)
    macs = sum(x.numel() for x in (*packed.w, *packed.wskip.values(),
                                   *packed.wv, packed.wv0d, packed.w_alpha,
                                   packed.w_rgb))
    _, G = fmg._grad_layout(packed)
    b = _bound(2.0 * n * macs, out_bytes + 4.0 * G)
    return a, b


def _phase_grad_split(fmg, ncfg, packed, pts, dirs, g) -> dict:
    """The bf16 backward's passes apart: pass B alone against its plain
    version on pass A's own buffers (1e-4 norm-relative per gradient),
    each pass timed with CUDA events, the torch.bmm yardstick of the
    trunk's seven H^T @ dc products (timed only), the peak memory of one
    backward call, and each pass's bound."""
    import torch

    n = pts.shape[0]
    dev = pts.device
    planes, offs, bias = fmg.grad_pass_a(packed, pts, dirs, g)
    got = fmg.grad_pass_b(packed, planes, offs, bias)
    bufs = fmg.buffers_from_planes(packed, planes, offs, bias, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = fmg.grad_pass_b_reference(
        packed, bufs, fmg.grad_chunks(bias.shape[0], sms))
    worst = max(_norm_rel(x, y) for x, y in zip(_packed_list(got),
                                                _packed_list(want)))
    print(f"  pass B alone vs its plain version on pass A's buffers, N={n}: "
          f"worst norm-relative error {worst:.3e} (tol {PASS_B_TOL:g})")
    if not worst <= PASS_B_TOL:
        raise AssertionError("pass B disagrees with its plain version")
    D = len(packed.w)
    hts = torch.stack([x.to(torch.bfloat16) for x in bufs.hs[:D - 1]]
                      ).transpose(1, 2)
    dcs = torch.stack([x.to(torch.bfloat16) for x in bufs.dcs[1:]])
    del bufs, want, got
    ms_a = _time_ms(lambda: fmg.grad_pass_a(packed, pts, dirs, g), 3)
    ms_b = _time_ms(lambda: fmg.grad_pass_b(packed, planes, offs, bias), 5)
    ms_bmm = _time_ms(lambda: torch.bmm(hts, dcs), 5)
    del hts, dcs, planes, bias
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fmg.point_mlp_grad(packed, pts, dirs, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    bound_a, bound_b = _pass_bounds(fmg, ncfg, packed, n)
    print(f"  bf16 passes at N={n}: pass A {ms_a:.3f} ms (bound "
          f"{bound_a['bound_ms']:.3f}, {bound_a['bound_by']}), pass B "
          f"{ms_b:.3f} ms (bound {bound_b['bound_ms']:.3f}, "
          f"{bound_b['bound_by']}); torch.bmm of the {D - 1} trunk H^T @ dc "
          f"products {ms_bmm:.3f} ms (yardstick, timed only); peak memory "
          f"of one call {peak / 2 ** 30:.3f} GiB (CUDA events)")
    return {"pass_b_err": worst, "pass_a_ms": ms_a, "pass_b_ms": ms_b,
            "bmm_ms": ms_bmm, "peak_bytes": peak, "bound_a": bound_a,
            "bound_b": bound_b}


def _phase_grad(net, ncfg, cond, pts, dirs, ptxas) -> dict:
    import torch

    from idealnerf_tpu_torch.core.embedding import positional_encoding
    from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
    from idealnerf_tpu_torch.models.face_nerf import (
        apply_folded, fold_conditioning,
    )

    print("phase 7 gradient kernel vs plain backward and f32 autograd")
    for i, ln in enumerate(ptxas):  # the bf16 kernels' registers, spills
        if any(k in ln for k in ("k_grad_pass", "k_bias_partials")):
            print("  ptxas: " + " | ".join(ptxas[i:i + 3]))

    def folded_fn(model, c):
        return fold_conditioning(model, ncfg, *c)

    def autograd_fn(model, folded, p, d):
        return apply_folded(model, folded, ncfg,
                            positional_encoding(p, ncfg.multires),
                            positional_encoding(d, ncfg.multires_views))

    out = {"max_abs_err": 0.0}
    sizes = [pts.shape[0]] + [FINE_POINTS] * (FINE_POINTS < pts.shape[0])
    for n in sizes:
        p, d = pts[:n], dirs[:n]
        w = (torch.linspace(0.5, 1.5, n, device=pts.device)[:, None]
             * torch.tensor([1.0, -0.7, 0.3, 0.05], device=pts.device)) / n
        ref, ref_c = _grads_of(autograd_fn, net, folded_fn, cond, p, d, w)
        tags = (("f32", torch.float32), ("bf16", torch.bfloat16))
        for tag, gd in tags if n == pts.shape[0] else tags[1:]:
            err, worst, packed, g = _grad_checks(
                fmg, tag, gd, ncfg, net, cond, p, d, ref, ref_c, w)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            ms = _time_ms(lambda: fmg.point_mlp_grad(packed, p, d, g), 3)
            pms = _time_ms(lambda: fmg.point_mlp_grad_reference(
                packed, p, d, g), 2)
            print(f"  {tag} gradient kernel at N={n}: kernel {ms:.3f} ms, "
                  f"plain {pms:.3f} ms (CUDA events)")
            res = {"n": n, "ms": ms, "plain_ms": pms, "worst": worst}
            if tag == "bf16":
                res.update(_phase_grad_split(fmg, ncfg, packed, p, d, g))
            out[f"{tag}_{n}"] = res
            del packed, g
            torch.cuda.synchronize()
        del ref, ref_c
        torch.cuda.empty_cache()
    main = out[f"bf16_{pts.shape[0]}"]
    out["ms"], out["plain_ms"] = main["ms"], main["plain_ms"]
    return out


def _phase_train(args, fm, fmg, fr) -> dict:
    import torch

    from idealnerf_tpu_torch.ckpt import CheckpointManager
    from idealnerf_tpu_torch.cli import render_val, train_head

    dims = ["--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32"]
    data = ["--synthetic", str(args.train_frames), "--synthetic_hw",
            str(args.train_hw)]
    shutil.rmtree("output/chip_smoke_train", ignore_errors=True)  # no resume
    fm.reset_launch_counts()
    fmg.reset_launch_counts()
    res = train_head.main([
        *data, *dims, "--N_rand", "2048", "--N_samples", "64",
        "--N_importance", "128", "--epochs", str(args.train_epochs),
        "--i_print", "5", "--i_weights", "10", "--device", "cuda",
        "--basedir", "output/chip_smoke_train", "--expname", "head"])
    counts = {"fused_point_mlp": fm.launch_counts["fused_point_mlp"],
              **fmg.launch_counts}
    steps = res["step"]
    first, last = res["history"][0][1], res["history"][-1][1]
    step_ms = 1e3 / last["steps_per_sec_rolling"]
    print(f"phase 8 train_head: {steps} steps on {args.train_frames} frames "
          f"of {args.train_hw}x{args.train_hw}, D=8 W=256 N_rand 2048 64+128: "
          f"{step_ms:.1f} ms/step over steps "
          f"{res['history'][-2][0] if len(res['history']) > 1 else 0}-"
          f"{res['history'][-1][0]}; loss {first['loss']:.5f} -> "
          f"{last['loss']:.5f}, PSNR {first['psnr']:.3f} -> "
          f"{last['psnr']:.3f}; launches {counts}")
    vals = [first["loss"], last["loss"], first["psnr"], last["psnr"]]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError("train_head produced a non-finite loss or PSNR")
    for k, n in counts.items():
        if n != 2 * steps:
            raise AssertionError(f"{k} launched {n} times for {steps} steps")
    ck = CheckpointManager(res["ckpt_dir"])
    if ck.latest_step() != steps:
        raise AssertionError(f"no checkpoint at step {steps} in "
                             f"{res['ckpt_dir']}")
    fr.reset_launch_counts()
    rv = render_val.main([*data, *dims, "--head_ckpt", res["ckpt_dir"],
                          "--max_frames", "1", "--device", "cuda",
                          "--save_path", "output/chip_smoke_train"])
    print(f"  render_val --head_ckpt (step {steps}): PSNR {rv['psnr']:.3f}, "
          f"SSIM {rv['ssim']:.4f}, {rv['frame_ms']:.1f} ms, launches "
          f"{dict(fr.launch_counts)}")
    if not math.isfinite(rv["psnr"]):
        raise AssertionError("the trained checkpoint rendered non-finite")
    torch.cuda.synchronize()
    return {"steps": steps, "step_ms": step_ms, "first": first, "last": last,
            "launches": counts, "render_psnr": rv["psnr"]}


def _points(ro, rd, near, far, n):
    """n points on the phase-2 rays at seeded uniform depths in [near,
    far], and their unit view directions."""
    import torch

    dev = ro.device
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.arange(n, device=dev) % ro.shape[0]
    z = near + (far - near) * torch.rand(n, 1, generator=g, device=dev)
    pts = (ro[idx] + rd[idx] * z).contiguous()
    dirs = (rd / rd.norm(dim=-1, keepdim=True))[idx].contiguous()
    return pts, dirs


def _phase_k5(fm, fr, model, folded, ncfg, pts, dirs) -> dict:
    """Phase 11a: K5 against its plain version at the phase-6 points and
    a ragged 1,001, then timed beside K4 on the same points (a finding:
    K5's entry is timed on its own path, kdiag2 rung v3)."""
    import torch

    print("phase 11 encoded-input point MLP (K5) vs plain version")
    err = 0.0
    for n in (pts.shape[0], 1001):
        got = fm.fused_point_mlp(model, folded, ncfg, pts[:n], dirs[:n],
                                 fuse_pe=False)
        want = fm.fused_point_mlp_reference(model, folded, ncfg, pts[:n],
                                            dirs[:n])
        for c in range(4):
            err = max(err, _agree(f"N={n} raw[:, {c}]", got[:, c],
                                  want[:, c], corr=True))
    net = fr.pack_operands(model, folded, ncfg)
    pe, ped = (x.to(torch.bfloat16).contiguous()
               for x in fm.encode_points(net, pts, dirs))
    n = pts.shape[0]
    ms = _time_ms(lambda: fm.point_mlp_pe(net, pe, ped), 5)
    k4 = _time_ms(lambda: fm.point_mlp(net, pts, dirs), 5)
    wrapper = _time_ms(lambda: fm.fused_point_mlp(model, folded, ncfg, pts,
                                                  dirs, fuse_pe=False), 5)
    print(f"  K5 at N={n}: kernel {ms:.3f} ms on bf16 encodings (K4 on the "
          f"same points {k4:.3f} ms: in-kernel PE {k4 - ms:+.3f} ms), "
          f"fused_point_mlp(fuse_pe=False) with its torch PE {wrapper:.3f} "
          "ms (CUDA events)")
    return {"max_abs_err": err, "ms": ms, "k4_ms": k4, "wrapper_ms": wrapper}


def _check_probes(kd, fm, fr, probe, pts, dirs) -> dict:
    """Phase 11b: every probe kernel against its plain version at a ragged
    1,001 rows (a part-filled last block) -> max error by kernel entry (the
    chains' relative to their plain output's max abs)."""
    import torch

    from idealnerf_tpu_torch import scripts as sc
    from idealnerf_tpu_torch.scripts import kdiag3, kdiag4

    print("phase 11 kernel-diagnosis probes vs plain versions, ragged")
    model, folded, pcfg, net = probe
    dev = pts.device
    err = dict.fromkeys(("kdiag_chain", "kdiag4_chain", "kdiag5_chain",
                         "kdiag2_ladder", "kdiag3_render_a",
                         "kdiag3_render_b", "kdiag3_render_c"), 0.0)
    # the chain modes of each TPU probe (kdiag.py, kdiag4.py, kdiag5.py)
    users = {"cast": ("kdiag_chain", "kdiag4_chain"),
             "bias_relu": ("kdiag_chain", "kdiag4_chain"),
             "relu2": ("kdiag_chain",),
             "relu": ("kdiag4_chain", "kdiag5_chain"),
             "select": ("kdiag4_chain",), "cast_max": ("kdiag4_chain",),
             "sum": ("kdiag4_chain",)}
    rows = 1001
    bias = kdiag4.v6_bias(dev)
    for dtype, rpbs in ((torch.bfloat16, (64, 128)), (torch.float32, (64,))):
        x, ws = sc.chain_inputs(rows, dtype, dev, seed=11)
        check = sc.chain_check(dtype)
        for mode in kd.CHAIN_MODES[dtype]:
            b = bias if mode in ("bias_relu", "relu2") else None
            want = kd.chain_reference(x, ws, mode, b)
            for rpb in rpbs:
                e = check(f"chain {str(dtype)[6:]} {mode} r{rpb} rows {rows}",
                          kd.chain(x, ws, mode, b, rpb), want)
                for k in users[mode] if dtype == torch.bfloat16 else (
                        "kdiag4_chain",):
                    err[k] = max(err[k], e)
    x, ws = sc.chain_inputs(rows, torch.bfloat16, dev, seed=12)
    b = torch.zeros_like(bias)
    err["kdiag_chain"] = max(err["kdiag_chain"], sc.chain_check(
        torch.bfloat16)(f"chain bf16 relu2 r128 rows {rows}, bf16 out",
                        kd.chain(x, ws, "relu2", b, 128, torch.bfloat16),
                        kd.chain_reference(x, ws, "relu2", b,
                                           torch.bfloat16)))
    for depth in (2, 8):
        x, ws = sc.chain_inputs(rows, torch.int8, dev, seed=13, depth=depth)
        for mode in ("i0", "i1"):
            want = kd.chain_reference(x, ws, mode)
            for rpb in (64, 128):
                sc.same(f"chain int8 {mode} r{rpb} rows {rows} depth {depth}",
                        kd.chain(x, ws, mode, None, rpb), want)
    n = 1001
    pe, ped = (x.to(torch.bfloat16).contiguous() for x in
               fm.encode_points(net, pts[:n], dirs[:n]))
    for stage in (0, 1, 2):
        err["kdiag2_ladder"] = max(err["kdiag2_ladder"], sc.close(
            f"ladder v{stage} N={n}", kd.ladder(net, pe, ped, stage),
            kd.ladder_reference(net, pe, ped, stage)))
    for S in (64, 192):
        o, d, bc, z = kdiag3.rays(n, S, dev, seed=11)
        pe, ped = kd.encode_rays(net, o, d, z)
        err["kdiag3_render_a"] = max(err["kdiag3_render_a"], sc.close_lanes(
            f"render_a R={n} S={S}", kd.render_probe_a(net, pe, ped, S),
            kd.render_probe_a_reference(net, pe, ped, S)))
        err["kdiag3_render_b"] = max(err["kdiag3_render_b"], sc.close_lanes(
            f"render_b R={n} S={S}", kd.render_probe_b(net, o, d, z),
            kd.render_probe_b_reference(net, o, d, z)))
        with torch.no_grad():
            err["kdiag3_render_c"] = max(
                err["kdiag3_render_c"], kdiag3.close_render(
                    f"render_c R={n} S={S}",
                    fr.fused_render_rays(model, folded, pcfg, o, d, z, bc),
                    fr.fused_render_rays_reference(model, folded, pcfg, o, d,
                                                   z, bc)))
    torch.cuda.synchronize()
    return err


def _chain_bound(rows: int, kind: str, in_bytes: int, out_bytes: int,
                 extra_bytes: int = 0) -> dict:
    """Bound of an 8-layer 256-wide chain on ``rows`` rows: its operations
    at the peak for ``kind``; x read and the output written once, the
    weights (and biases) read once."""
    W, depth = 256, 8
    w_bytes = depth * W * W * (1 if kind == "int8" else 2) + extra_bytes
    return _bound(2.0 * rows * depth * W * W,
                  rows * W * (in_bytes + out_bytes) + w_bytes, kind)


def _worst(results: dict, labels=None) -> float:
    """The largest ``--check`` error over an entry point's kernel variants
    (those in ``labels``); the library variants have no plain version."""
    err = 0.0
    for label, r in results.items():
        if label in ("matmul", "VX", "IX") or (labels and label not in
                                                labels):
            continue
        for v in (r["rows"].values() if "rows" in r else [r]):
            err = max(err, v["max_err"])
    return err


def _phase_kdiag(fm, fr, pts, dirs, rays: int, big: int = 1 << 21,
                 slope=(1 << 20, 1 << 22)) -> dict:
    """Phase 11b-c: the ragged probe checks, then each kdiag entry point at
    its own size with ``--check`` (every timed output against its plain
    version on the same inputs, that version timed once), the launch
    counters set to 0 before it and read after -> the entries of K5 and
    the probe kernels by name."""
    import torch

    from idealnerf_tpu_torch.kernels import kdiag as kd
    from idealnerf_tpu_torch.scripts import (
        kdiag, kdiag2, kdiag3, kdiag4, kdiag5, paper_field,
    )

    dev = pts.device
    model, folded, pcfg, net = probe = paper_field(dev)
    errs = _check_probes(kd, fm, fr, probe, pts, dirs)
    runs, launches = {}, {}
    for name, mod, argv in (
            ("kdiag", kdiag, ["--rows", str(big)]),
            ("kdiag2", kdiag2, ["--rows", str(big)]),
            ("kdiag3", kdiag3, ["--kd3_r", str(rays), "--kd3_s", "64,192"]),
            ("kdiag4", kdiag4, ["--kd4", "V0,V2,V3,V5,V6,V7,VP,VX",
                                "--kd4_rows", str(slope[0]),
                                "--slope_rows", "%d,%d" % slope]),
            ("kdiag5", kdiag5, ["--slope_rows", "%d,%d" % slope])):
        argv = argv + ["--check"]
        print(f"phase 11 {name}.main({' '.join(argv)})")
        for m in (kd, fm, fr):
            m.reset_launch_counts()
        with torch.no_grad():
            runs[name] = mod.main(argv)["results"]
        torch.cuda.synchronize()
        launches[name] = {**kd.launch_counts, **fm.launch_counts,
                          **fr.launch_counts}
        torch.cuda.empty_cache()

    # the entries' times: the chains' real pattern at r64, the ladder's own
    # last rung, K5 as rung v3, the render probes at the fine pass's 192
    # depths; each beside its plain version's time from the same run
    mid, S = slope[0], 192
    pt, ray = _mlp_macs(pcfg)
    # K5's yardstick on kdiag2's own encodings (rung v3's inputs)
    k5_lib = _point_library_ms(net, *kdiag2.inputs(net, big, dev)[:2])
    torch.cuda.empty_cache()
    wb = _weight_bytes(pcfg)
    ops = 2.0 * rays * (S * pt + ray)
    raw_bytes = rays * S * 16.0
    k3 = runs["kdiag3"]

    def entry(r, n, bound, err, library=None):
        return {"ms": r["ms"], "plain_ms": r["plain_ms"], "launches": n,
                "library_ms": library, "max_abs_err": err, **bound}

    out = {
        "kdiag_chain": entry(
            runs["kdiag"]["relu r64"], launches["kdiag"]["kdiag_chain_bf16"],
            _chain_bound(big, "bf16", 2, 2, 8 * 256 * 4),
            max(errs["kdiag_chain"], _worst(runs["kdiag"])),
            runs["kdiag"]["matmul"]["ms"]),
        "kdiag4_chain": entry(
            runs["kdiag4"]["V0 r64"]["rows"][str(mid)],
            launches["kdiag4"]["kdiag_chain_bf16"]
            + launches["kdiag4"]["kdiag_chain_f32"],
            _chain_bound(mid, "bf16", 2, 4),
            max(errs["kdiag4_chain"], _worst(runs["kdiag4"])),
            runs["kdiag4"]["VX"]["ms"]),
        "kdiag5_chain": entry(
            runs["kdiag5"]["I0 r64"]["rows"][str(mid)],
            launches["kdiag5"]["kdiag_chain_int8"]
            + launches["kdiag5"]["kdiag_chain_bf16"],
            _chain_bound(mid, "int8", 1, 4),
            max(errs["kdiag5_chain"], _worst(runs["kdiag5"])),
            runs["kdiag5"]["IX"]["ms"]),
        "kdiag2_ladder": entry(
            runs["kdiag2"]["v2"], launches["kdiag2"]["kdiag_ladder"],
            _bound(2.0 * big * kd.ladder_macs(net, 2),
                   big * 2.0 * (fr.PE_PAD + fr.PED_PAD + 128) + wb),
            max(errs["kdiag2_ladder"],
                _worst(runs["kdiag2"], ("v0", "v1", "v2")))),
        "fused_point_mlp_pe": entry(
            runs["kdiag2"]["v3"], launches["kdiag2"]["fused_point_mlp_pe"],
            _bound(2.0 * big * (pt + ray),
                   wb + big * (2.0 * (fr.PE_PAD + fr.PED_PAD) + 16)),
            _worst(runs["kdiag2"], ("v3",)), k5_lib),
        "kdiag3_render_a": entry(
            k3[f"A S={S}"], launches["kdiag3"]["kdiag_render_a"],
            _bound(ops, rays * (S * 2.0 * fr.PE_PAD + 2.0 * fr.PED_PAD)
                   + raw_bytes + wb),
            max(errs["kdiag3_render_a"], _worst(k3, ("A S=64", "A S=192")))),
        "kdiag3_render_b": entry(
            k3[f"B S={S}"], launches["kdiag3"]["kdiag_render_b"],
            _bound(ops, rays * (24.0 + 4.0 * S) + raw_bytes + wb),
            max(errs["kdiag3_render_b"], _worst(k3, ("B S=64", "B S=192")))),
        "kdiag3_render_c": entry(
            k3[f"C S={S}"], launches["kdiag3"]["fused_render_rays"],
            _ray_bound(pcfg, rays, S, 9 + S, 8 + S),
            max(errs["kdiag3_render_c"], _worst(k3, ("C S=64", "C S=192")))),
    }
    for k, e in out.items():
        print(f"  {k}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms"
              + (f", library {e['library_ms']:.3f} ms"
                 if e["library_ms"] is not None else "")
              + f", bound {e['bound_ms']:.3f} ms by {e['bound_by']}, "
              f"launches {e['launches']}, max error {e['max_abs_err']:.3e}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"entries": out, "runs": runs, "launches": launches}


def _phase_kframe() -> list:
    """Phase 11d: scripts.kframe on a whole 450x450 frame, the coarse and
    fine kernels through their wrappers and alone at other launch plans;
    every plan's outputs bitwise equal to the wrapper's and each worker's
    launch counters equal to its wrapper calls."""
    import torch

    from idealnerf_tpu_torch.scripts import kframe

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("phase 11 kframe.main()")
    res = kframe.main([])
    if not res["ok"]:
        raise AssertionError("kframe: a plan's outputs differ from the "
                             "wrapper's or a launch count from its calls")
    return res["results"]


def _phase_kpoint() -> list:
    """Phase 11e: scripts.kpoint, K4 and K5 through their wrappers and
    alone at other launch plans; every plan's output bitwise equal to the
    wrapper's and each worker's launch counters equal to its wrapper
    calls."""
    import torch

    from idealnerf_tpu_torch.scripts import kpoint

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("phase 11 kpoint.main()")
    res = kpoint.main([])
    if not res["ok"]:
        raise AssertionError("kpoint: a plan's output differs from the "
                             "wrapper's or a launch count from its calls")
    return res["results"]


def _profile_train_step(args):
    """One warm training step of the phase-8 configuration, profiled."""
    import torch

    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.train.head import HeadTrainer

    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32)
    ds = make_synthetic_dataset(n_frames=2, H=args.train_hw, W=args.train_hw,
                                dim_expr=76)
    tr = HeadTrainer(cfg, ds, seed=0, device="cuda")
    step = tr._step_fn(smooth=False)
    return _profile(lambda: step(tr.state, tr.data, 0, tr.generator),
                    f"training step ({args.train_hw}x{args.train_hw}, "
                    "N_rand 2048, 64+128)", "profile_train_step.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--hw", type=int, default=450)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--points", type=int, default=2048 * (64 + 192))
    ap.add_argument("--train_hw", type=int, default=450)
    ap.add_argument("--train_frames", type=int, default=4)
    ap.add_argument("--train_epochs", type=int, default=5)
    ap.add_argument("--serve_frames", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from idealnerf_tpu_torch.cli import render_val
        from idealnerf_tpu_torch.config import ExperimentConfig
        from idealnerf_tpu_torch.core.rays import get_rays
        from idealnerf_tpu_torch.core.sampling import stratified_sample
        from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
        from idealnerf_tpu_torch.eval.renderer import (
            foreground_prior, make_frame_renderer,
        )
        from idealnerf_tpu_torch.eval.temporal import _prior_sel
        from idealnerf_tpu_torch.kernels import build as kbuild
        from idealnerf_tpu_torch.kernels import fused_mlp as fm
        from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
        from idealnerf_tpu_torch.kernels import fused_render as fr
        from idealnerf_tpu_torch.models.face_nerf import (
            FaceNeRF, fold_conditioning,
        )
        from idealnerf_tpu_torch.train.state import init_params
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    report = {"device": kind, "nvidia_smi": smi, "cuda": torch.version.cuda,
              "torch": torch.__version__}

    # ---- phase 1: device + build
    t0 = time.perf_counter()
    info = kbuild.build()
    kbuild.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln
             or "Function properties" in ln]
    report.update(build_seconds=build_s, ptxas=ptxas)
    print(f"phase 1 device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvidia-smi: {smi} | kernels built in "
          f"{build_s:.1f} s (nvcc {info['seconds']:.1f} s)")
    for ln in ptxas:
        print(f"  ptxas: {ln}")

    # ---- phase 2: kernels vs plain versions at main-path shapes
    cfg = ExperimentConfig(dim_aud=64, dim_expr=76, dim_latent=32)
    ncfg = cfg.face_nerf_config()
    gen = torch.Generator().manual_seed(0)
    nets = {k: FaceNeRF(ncfg, gen).to(dev) for k in ("coarse", "fine")}
    aud = torch.randn(64, generator=gen).to(dev)
    expr = torch.randn(76, generator=gen).to(dev)
    latent = torch.ones(32, device=dev)
    ds = make_synthetic_dataset(n_frames=1, H=450, W=450, dim_expr=76)
    ro, rd = get_rays(450, 450, ds.focal, torch.from_numpy(ds.poses[0]).to(dev),
                      ds.cx, ds.cy)
    bc = (torch.from_numpy(ds.bc_img).to(dev).float() / 255.0).reshape(-1, 3)
    frame = tuple(x.reshape(-1, 3).contiguous() for x in (ro, rd, bc))
    pick = torch.linspace(0, 450 * 450 - 1, args.rays).long().to(dev)
    ro, rd, bc = (x[pick].contiguous() for x in frame)
    near, far, n_s, n_i = ds.near, ds.far, cfg.N_samples, cfg.N_importance
    errs = {k: 0.0 for k in KERNELS}

    def fold(net, c):
        return fold_conditioning(net, c, aud, expr, latent)

    def check(tag, c, rays, s_c=n_s, s_i=n_i):
        o, d, b = ro[:rays], rd[:rays], bc[:rays]
        fc, ff = fold(nets["coarse"], c), fold(nets["fine"], c)
        ck, zk = fr.fused_render_coarse_hier(nets["coarse"], fc, c, o, d, b,
                                             near, far, s_c, s_i)
        cp, _ = fr.fused_render_coarse_hier_reference(
            nets["coarse"], fc, c, o, d, b, near, far, s_c, s_i)
        lc = {k: fr.render_launch_config(*a) for k, a in
              (("coarse", (s_c, s_i)), ("fine", (s_c + s_i,)))}
        print(f" fused_render_coarse_hier [{tag}, R={rays}, {s_c}+{s_i}]: "
              + _plan_text(lc["coarse"]))
        e = [_agree(k, ck[k], cp[k], corr=k == "rgb_map") for k in
             ("rgb_map", "acc_map", "weights", "last_weight")]
        zc = stratified_sample(near, far, s_c, rays, device=dev)
        e.append(_agree("z_all vs plain merge of the kernel's weights", zk,
                        fr.importance_depths(zc, ck["weights"], s_i),
                        atol=Z_ATOL))
        errs["fused_render_coarse_hier"] = max(
            errs["fused_render_coarse_hier"], *e)
        fk = fr.fused_render_rays(nets["fine"], ff, c, o, d, zk, b)
        fp = fr.fused_render_rays_reference(nets["fine"], ff, c, o, d, zk, b)
        print(f" fused_render_rays [{tag}, R={rays}, S={s_c + s_i}]: "
              + _plan_text(lc["fine"]))
        e = [_agree(k, fk[k], fp[k], corr=k == "rgb_map") for k in
             ("rgb_map", "acc_map", "weights", "last_weight")]
        errs["fused_render_rays"] = max(errs["fused_render_rays"], *e)
        torch.cuda.synchronize()
        return fc, ff, zk

    print("phase 2 kernels vs plain versions")
    fc, ff, zk = check("relu", ncfg, args.rays)
    sp = dataclasses.replace(ncfg, density_activation="softplus")
    check("softplus, ragged", sp, min(1001, args.rays))
    # a power-of-two union, where the TPU kernel's merge had no filler
    check("relu, ragged", ncfg, min(1001, args.rays), 16, 16)

    res2 = _phase_frame(fr, nets, fc, ff, ncfg, near, far, n_s, n_i,
                        {"phase-2 rays": (ro, rd, bc), "450x450 frame": frame},
                        ptxas, info["path"])
    report["frame_kernels"] = res2
    del frame
    torch.cuda.empty_cache()
    for k in res2["450x450 frame"]:
        errs[k] = max(errs[k], max(res2[t][k]["max_abs_err"]
                                   for t in ("phase-2 rays", "450x450 frame")))

    # ---- phase 3: the slice through its CLI entry point
    fr.reset_launch_counts()
    res = render_val.main([
        "--synthetic", str(args.frames), "--synthetic_hw", str(args.hw),
        "--dim_aud", "64", "--dim_expr", "76", "--dim_latent", "32",
        "--device", "cuda", "--save_path", "output/chip_smoke"])
    counts = {k: fr.launch_counts[k] for k in ("fused_render_coarse_hier",
                                               "fused_render_rays")}
    print(f"phase 3 render_val: {args.frames} frames of {args.hw}x{args.hw}, "
          f"D=8 W=256 {n_s}+{n_i}: {res['frame_ms']:.1f} ms/frame after the "
          f"first, PSNR {res['psnr']:.3f}, SSIM {res['ssim']:.4f}, "
          f"launches {counts}")
    if not (math.isfinite(res["psnr"]) and math.isfinite(res["ssim"])):
        raise AssertionError("render_val produced non-finite frames")
    for k, n in counts.items():
        if n != args.frames:
            raise AssertionError(f"{k} launched {n} times for "
                                 f"{args.frames} frames")
    report.update(render_val=res, launches=counts)

    # ---- phase 4: a small frame, card vs plain versions on the host
    st = init_params(cfg, 1, torch.Generator().manual_seed(1))
    sds = make_synthetic_dataset(n_frames=1, H=24, W=24, dim_expr=76)
    render = make_frame_renderer(ncfg, 24, 24, sds.focal, sds.near, sds.far,
                                 cfg.render_config(), cx=sds.cx, cy=sds.cy)
    frames = {}
    for d in ("cpu", "cuda"):
        p = st.params.to(d)
        a = torch.randn(64, generator=torch.Generator().manual_seed(2)).to(d)
        e = torch.from_numpy(sds.exprs[0]).to(d)
        frames[d] = render(p, torch.from_numpy(sds.poses[0]).to(d),
                           torch.from_numpy(sds.bc_img).to(d).float() / 255,
                           aud=a, expr=e, latent=torch.ones(32, device=d))
    print("phase 4 24x24 frame, card vs plain versions on the host")
    report["frame_24_err"] = _agree("frame", frames["cuda"].cpu(),
                                    frames["cpu"], corr=True)

    # ---- where a frame's time goes (torch.profiler)
    render = make_frame_renderer(ncfg, 450, 450, ds.focal, near, far,
                                 cfg.render_config(), cx=ds.cx, cy=ds.cy)
    report["profile"] = _profile(
        lambda: render(nets, torch.from_numpy(ds.poses[0]).to(dev),
                       torch.from_numpy(ds.bc_img).to(dev).float() / 255,
                       aud=aud, expr=expr, latent=latent),
        "450x450 frame", "profile_frame.txt")

    # ---- phases 6 and 7: the training kernels at the step's shapes; the
    # points lie on the phase-2 rays at uniform depths in [near, far]
    pts, dirs = _points(ro, rd, near, far, args.points)
    res6 = _phase_point_mlp(fm, fr, nets["fine"], ff, ncfg, pts, dirs, ptxas,
                            info["path"])
    res7 = _phase_grad(nets["coarse"], ncfg, (aud, expr, latent), pts, dirs,
                      ptxas)
    report.update(point_mlp=res6, point_mlp_grad=res7)
    del pts, dirs
    torch.cuda.empty_cache()

    # ---- phase 8: the training slice through its CLI entry point
    res8 = _phase_train(args, fm, fmg, fr)
    report["train"] = res8
    report["profile_train_step"] = _profile_train_step(args)

    # ---- phases 9 and 10: the serving slice on the synthetic subject whose
    # foreground prior holds 129,024 rays of the 450x450 frame
    sds = make_synthetic_dataset(n_frames=args.serve_frames, H=450, W=450,
                                 dim_expr=76)
    mask, _ = foreground_prior(sds)
    sel = torch.from_numpy(_prior_sel(mask, 450 * 450)).long().to(dev)
    po, pd = get_rays(450, 450, sds.focal,
                      torch.from_numpy(sds.poses[0]).to(dev), sds.cx, sds.cy)
    pb = (torch.from_numpy(sds.bc_img).to(dev).float() / 255.0).reshape(-1, 3)
    prior = tuple(x.reshape(-1, 3)[sel].contiguous() for x in (po, pd, pb))
    res9 = _phase_delta(fr, nets, fold, ncfg, near, far, n_s, n_i, ro, rd,
                        bc, prior, ptxas)
    del prior, po, pd, pb
    torch.cuda.empty_cache()
    res10 = _phase_serve(fr, nets, ncfg, (aud, expr, latent), sds, mask)
    report.update(delta=res9, serve=res10)
    del sds, mask, sel
    torch.cuda.empty_cache()

    # ---- phase 11: K5 and the kernel-diagnosis probes (K7)
    pts, dirs = _points(ro, rd, near, far, args.points)
    res11 = _phase_k5(fm, fr, nets["fine"], ff, ncfg, pts, dirs)
    probes = _phase_kdiag(fm, fr, pts, dirs, args.rays)
    report.update(k5=res11, kdiag=probes)
    del pts, dirs
    torch.cuda.empty_cache()
    report["kframe"] = _phase_kframe()
    report["kpoint"] = _phase_kpoint()

    counts.update(res8["launches"])
    counts["fused_render_delta"] = (
        res10["defaults"]["launches"]["fused_render_delta"])
    errs.update(fused_point_mlp=res6["max_abs_err"],
                fused_point_mlp_grad=res7["max_abs_err"],
                fused_render_delta=res9["max_abs_err"])
    # the frame's kernels at their path's launch shape, a whole frame
    frame_res = res2["450x450 frame"]
    times = {k: (r["ms"], r["plain_ms"]) for k, r in frame_res.items()}
    times.update(fused_point_mlp=(res6["ms"], res6["plain_ms"]),
                 fused_point_mlp_grad=(res7["ms"], res7["plain_ms"]),
                 fused_render_delta=(res9["ms"], res9["plain_ms"]))
    bounds = {
        **{k: {f: r[f] for f in ("bound_ms", "bound_by")}
           for k, r in frame_res.items()},
        "fused_point_mlp": {k: res6[k] for k in ("bound_ms", "bound_by")},
        "fused_point_mlp_grad": _point_bound(ncfg, args.points, 3, True),
        "fused_render_delta": {k: res9[k] for k in ("bound_ms", "bound_by")},
    }
    # no single PyTorch call computes K1-K6; the library column of K1-K3 is
    # their MLP as torch.addmm calls, the chains' the same chain as
    # torch.matmul / torch._int_mm calls
    entries = {k: {"launches": counts[k], "max_abs_err": errs[k],
                   "ms": times[k][0], "plain_ms": times[k][1], **bounds[k],
                   "library_ms": None} for k in times}
    entries["fused_render_delta"]["library_ms"] = res9["library_ms"]
    entries["fused_point_mlp"]["library_ms"] = res6["library_ms"]
    for k, r in frame_res.items():
        entries[k]["library_ms"] = r["library_ms"]
    entries.update(probes["entries"])
    k5 = entries["fused_point_mlp_pe"]
    k5["max_abs_err"] = max(k5["max_abs_err"], res11["max_abs_err"])
    kernels = [{"name": k, "route": "cuda", **KERNELS[k],
                **{f: entries[k][f] for f in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}} for k in KERNELS]
    idle = [e["name"] for e in kernels if not e["launches"] > 0]
    if idle:
        raise AssertionError(f"not launched on their paths: {idle}")
    report["kernels"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
