"""Train-step cost bisection (counterpart of scripts/train_profile.py):
where does a head step's time go beyond the fused MLP's forward and
backward?

Times four variants of the paper-config head step (N_rand 3072, 64 + 128
samples, dim_aud 64, ``train_fused`` 2 on the card) built from the port's
own ``train/head.make_frame_loss``, ``apply_update`` and
``data/sampler.py``, each in 3 windows of ``--steps`` steps (after one
warm-up step), the variants in turns with each round starting at the
next one, as the median of its windows (``windows_ms``: a host-bound
step varies more between windows than the variants differ):

  full          sampling + loss forward/backward + Adam (the real step)
  fixed_coords  the same on fixed coordinates (no ray sampling)
  sgd           Adam replaced by plain SGD (rate 1e-4)
  grad_only     no optimizer update (gradients zeroed)

and the differences ``sampler_ms`` (full - fixed_coords),
``adam_vs_sgd_ms`` (full - sgd) and ``optimizer_ms`` (full - grad_only).
``profile``: 3 more full steps unprofiled, then 3 under torch.profiler,
per step the wall of each window, the device-busy ms, the port's
kernels' ms (K4, K6) and the idle share against the unprofiled wall;
``glue_ms`` = full - kernels - sampler - optimizer, the host and device
time of the rest (rays, PE, compositing, loss, autograd). Each variant's
kernel launches (``launches``) are counted over its timed and warm-up
steps. The JAX script's ``flat_adam``, ``approx_sampler``
and ``flat_adam_approx`` variants and their ``*_saves_ms`` are not
ported: the port has no flat-vector Adam or approximate top-k sampler
(``config.py``).

    python -m idealnerf_tpu_torch.scripts.train_profile [--steps 100] \\
        [--out train_profile.json]
    python -m idealnerf_tpu_torch.scripts.train_profile --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.sampler import RayBudget, sample_ray_coords
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.scripts import device_of, timing
from idealnerf_tpu_torch.train.head import apply_update, make_frame_loss
from idealnerf_tpu_torch.train.schedule import exponential_lr
from idealnerf_tpu_torch.train.state import init_train_state

PAPER = dict(N_rand=3072, N_samples=64, N_importance=128, dim_aud=64,
             dim_expr=79, dim_latent=32, mouth_rays=512, torso_rays=512,
             train_fused=2)
SMOKE = dict(N_rand=128, N_samples=8, N_importance=8, dim_expr=8,
             mouth_rays=16, torso_rays=16)
ROUNDS = 3     # windows of each variant, in turns
PROFILED = 3   # profiled steps of the full variant
# name -> (sample rays, optimizer)
VARIANTS = {"full": (True, "adam"), "fixed_coords": (False, "adam"),
            "sgd": (True, "sgd"), "grad_only": (True, "none")}


class Profile:
    """The synthetic subject on ``device`` and the step variants."""

    def __init__(self, cfg, hw: int, frames: int, device):
        self.cfg, self.device = cfg, device
        self.ds = make_synthetic_dataset(n_frames=frames, H=hw, W=hw,
                                         dim_expr=cfg.dim_expr)
        self.data = self.ds.to_device(device)
        self.budget = RayBudget.from_config(cfg.N_rand, cfg.mouth_rays,
                                            cfg.torso_rays, cfg.sample_rate)
        self.loss_fn = make_frame_loss(cfg, self.ds, False, device)
        self.lr = exponential_lr(cfg.lrate, cfg.lrate_decay)
        H, W = self.ds.hw
        n = torch.arange(cfg.N_rand, device=device)
        self.coords0 = torch.stack([n // W % H, n % W], -1)

    def sample(self, index: int, generator) -> torch.Tensor:
        d, (H, W) = self.data, self.ds.hw
        return sample_ray_coords(generator, H, W, d["face_rects"][index],
                                 d["mouth_boxes"][index],
                                 d["torso_masks"][index], self.budget)

    def state(self, opt: str):
        st = init_train_state(self.cfg, self.ds.size,
                              torch.Generator().manual_seed(0), self.device)
        if opt == "sgd":
            st.optimizer = torch.optim.SGD(st.trainable(), lr=1e-4)
        return st

    def step_fn(self, name: str, coords0=None):
        """``step(state, index, generator) -> loss`` of variant ``name``;
        the fixed-coordinate variant renders at ``coords0`` (default: the
        first N_rand pixels in raster order)."""
        sample, opt = VARIANTS[name]
        fixed = self.coords0 if coords0 is None else coords0

        def step(st, index, generator):
            coords = self.sample(index, generator) if sample else fixed
            loss, _ = self.loss_fn(st.params, st.latent_codes, self.data,
                                   index, coords, generator)
            loss.backward()
            if opt == "adam":
                apply_update(st, self.lr(st.step))
            else:
                if opt == "sgd":
                    st.optimizer.step()
                st.optimizer.zero_grad(set_to_none=False)
                st.step += 1
            return loss.detach()

        return step


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--hw", type=int, default=450)
    timing.add_common(p, "output json path")
    args = p.parse_args(argv)
    dev = device_of(args.device)
    kw = dict(PAPER)
    hw, frames, steps = args.hw, 8, args.steps
    if args.smoke:
        kw.update(SMOKE)
        hw, frames, steps = 48, 3, min(steps, 4)
    cfg = ExperimentConfig(**kw)
    prof = Profile(cfg, hw, frames, dev)

    def runner(name):
        """One step of variant ``name`` on its own state and draws."""
        st, step = prof.state(VARIANTS[name][1]), prof.step_fn(name)
        gen = torch.Generator(device=dev).manual_seed(1)
        i = [0]

        def one():
            loss = step(st, i[0] % prof.ds.size, gen)
            i[0] += 1
            return loss

        return one

    runners = {name: runner(name) for name in VARIANTS}
    windows = {name: [] for name in VARIANTS}
    launches = {name: {} for name in VARIANTS}
    rounds = 1 if args.smoke else ROUNDS
    for r in range(rounds):
        # each round starts at another variant, so that no variant always
        # runs first (or after the same neighbour)
        names = list(VARIANTS)[r % len(VARIANTS):] + list(VARIANTS)[
            :r % len(VARIANTS)]
        for name in names:
            before = timing.launch_snapshot()
            windows[name].append(timing.window_ms(
                runners[name], steps, dev, warmup=1 if r == 0 else 0))
            for k, v in timing.launches_since(before).items():
                launches[name][k] = launches[name].get(k, 0) + v
    results = {}
    for name in VARIANTS:
        ms = float(np.median(windows[name]))
        results[name] = {"ms_per_step": ms, "steps_per_sec": 1e3 / ms,
                         "windows_ms": windows[name],
                         "steps": rounds * steps + 1,
                         "launches": launches[name]}
        print(name, json.dumps(results[name]), flush=True)
    results["profile"] = timing.device_profile(runners["full"], PROFILED, dev)

    full = results["full"]["ms_per_step"]
    results["sampler_ms"] = full - results["fixed_coords"]["ms_per_step"]
    results["adam_vs_sgd_ms"] = full - results["sgd"]["ms_per_step"]
    results["optimizer_ms"] = full - results["grad_only"]["ms_per_step"]
    kernels = results["profile"]["kernels_ms"]
    results["glue_ms"] = (None if kernels is None else full - kernels
                          - results["sampler_ms"] - results["optimizer_ms"])
    results.update(timing.device_fields(dev), hw=hw,
                   config={k: getattr(cfg, k) for k in PAPER})
    timing.write_json(args.out, results)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
