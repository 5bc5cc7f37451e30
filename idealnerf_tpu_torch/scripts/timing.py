"""Shared pieces of the measurement scripts (``train_profile``,
``stream_latency``, ``temporal_profile``, ``comp_profile``,
``composite_delta`` and ``audatt_peak``): the device flag, the timing
window, the card's name and the JSON writer.

A window is what the JAX scripts time as an accumulate-then-fetch loop:
``reps`` calls between two ``torch.cuda.synchronize`` points on the
host's clock, so the host's dispatch counts as it does for a caller; on
the CPU the same loop runs on the host's clock alone.
"""

from __future__ import annotations

import json
import os
import time

import torch

from idealnerf_tpu_torch.scripts import card


def add_common(p, out_help: str, smoke: bool = True) -> None:
    """``--device`` (default cuda), ``--out`` and, for a script with a
    CPU size, ``--smoke``."""
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: the card; cpu: the kernels' plain versions, "
                        "times of the host")
    p.add_argument("--out", default=None, help=out_help)
    if smoke:
        p.add_argument("--smoke", action="store_true",
                       help="a CPU-sized run for the tests")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window_ms(fn, reps: int, dev: torch.device, warmup: int = 2) -> float:
    """ms per call of ``fn`` over one window of ``reps`` calls after
    ``warmup`` calls, the window closed by a synchronize."""
    for _ in range(warmup):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def device_profile(fn, reps: int, dev: torch.device) -> dict:
    """torch.profiler over ``reps`` warm calls of ``fn`` -> per call: the
    wall ms of an unprofiled window of ``reps`` calls right before it,
    the profiled window's wall ms, the device-busy ms, the ms of the
    port's hand-written kernels (namespace ``fr::``) and the idle share
    against the unprofiled wall (the profiler's own host time lengthens
    its window); the device numbers are None on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    wall = window_ms(fn, reps, dev, warmup=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if dev.type == "cuda" else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync(dev)
        profiled = (time.perf_counter() - t0) * 1e3 / reps
    out = {"wall_ms": wall, "profiled_wall_ms": profiled}
    if dev.type != "cuda":
        return dict(out, device_busy_ms=None, kernels_ms=None,
                    idle_share=None)
    # device-side events only: an op's own row repeats its kernels' time
    on_dev = [(e.key, getattr(e, "self_device_time_total", 0.0))
              for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(us for _, us in on_dev) / 1e3 / reps
    return dict(out, device_busy_ms=busy,
                kernels_ms=sum(us for k, us in on_dev
                               if k.startswith("fr::")) / 1e3 / reps,
                idle_share=max(0.0, 1.0 - busy / wall))


def device_fields(dev: torch.device) -> dict:
    """The run's device for the record: ``backend`` (the JAX scripts'
    key), the card's name and ``nvidia-smi``'s name and power limit."""
    if dev.type != "cuda":
        return {"backend": "cpu", "device": "cpu"}
    return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
            "card": card()}


def write_json(path, out: dict) -> None:
    """``out`` to ``path`` (no-op without one), written whole or not at
    all."""
    if not path:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(out, fh, indent=1)
    os.replace(tmp, path)


def launch_snapshot() -> dict:
    """The launch counters of every kernel wrapper, merged."""
    from idealnerf_tpu_torch.kernels import fused_mlp, fused_mlp_grad
    from idealnerf_tpu_torch.kernels import fused_render

    return {**fused_render.launch_counts, **fused_mlp.launch_counts,
            **fused_mlp_grad.launch_counts}


def launches_since(before: dict) -> dict:
    """Launches of each kernel since ``before`` (``launch_snapshot``),
    those that launched only."""
    now = launch_snapshot()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


def random_composite(hw: int, samples: int, importance: int, dev,
                     seed: int = 0) -> dict:
    """The profiles' random head and torso fields at the paper width (D=8,
    W=256; the head conditioned on dim_aud 64, dim_expr 8, dim_latent 32,
    the torso on its 74-wide signal), drawn from ``seed``, with their
    conditioning and the synthetic with-torso subject's first pose, plate
    and per-field priors at ``hw``². Times do not depend on what the
    fields hold, so random fields measure real cost."""
    import torch.nn as nn

    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
    from idealnerf_tpu_torch.eval.renderer import foreground_prior_fields
    from idealnerf_tpu_torch.models.face_nerf import FaceNeRF
    from idealnerf_tpu_torch.train.torso import torso_nerf_config

    cfg = ExperimentConfig(dim_aud=64, dim_expr=8, dim_latent=32,
                           N_samples=samples, N_importance=importance)
    ncfg, tcfg = cfg.face_nerf_config(), torso_nerf_config(cfg)
    g = torch.Generator().manual_seed(seed)

    def field(c):
        return nn.ModuleDict({k: FaceNeRF(c, g) for k in
                              ("coarse", "fine")}).to(dev)

    params, torso = field(ncfg), field(tcfg)
    cond = {k: torch.randn(n, generator=g).to(dev) for k, n in
            (("aud", cfg.dim_aud), ("expr", cfg.dim_expr),
             ("latent", cfg.dim_latent), ("signal", tcfg.dim_aud))}
    ds = make_synthetic_dataset(n_frames=2, H=hw, W=hw, dim_expr=8,
                                with_torso=True)
    mask_h, mask_t = foreground_prior_fields(ds)
    return dict(cfg=cfg, ncfg=ncfg, tcfg=tcfg, params=params, torso=torso,
                cond=cond, ds=ds, pose=torch.from_numpy(ds.poses[0]).to(dev),
                bc=torch.from_numpy(ds.bc_img).to(dev).float() / 255.0,
                mask_h=mask_h, mask_t=mask_t, near=0.3, far=0.9)
