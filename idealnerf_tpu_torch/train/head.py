"""Head trainer — the paper model (counterpart of train/head.py).

FaceNeRF coarse + fine conditioned on aud (dim_aud) + expr (dim_expr) + a
per-frame latent; region-stratified ray budget; loss = MSE(fine) +
MSE(coarse) + 10·lc_weight·‖latent‖; Adam over params and latents with
exponential decay; AudioNet → AudioAttNet smoothing switch at
nosmo_iters; optional central-crop warm-up for precrop_iters steps.

On a CUDA device every field call of a step goes through the fused point
MLP kernel and its rematerialising gradient kernel (``train_fused`` 1 or
2); on the CPU, or with ``train_fused`` 0, through plain autograd.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from idealnerf_tpu_torch.core.render import render_rays
from idealnerf_tpu_torch.data.sampler import (
    RayBudget, rays_at_coords, sample_ray_coords,
)
from idealnerf_tpu_torch.kernels.fused_render import kernels_cover
from idealnerf_tpu_torch.models.variants import (
    build_field_fns, variant_nerf_config,
)
from idealnerf_tpu_torch.train.schedule import exponential_lr
from idealnerf_tpu_torch.train.state import TrainState, init_train_state

logger = logging.getLogger("idealnerf")


def compute_aud_feature(
    params,
    auds: torch.Tensor,       # (M, 16, 29) raw DeepSpeech windows
    aud_ids: torch.Tensor,    # (N,) per-frame window index
    index: int,               # frame index
    cfg,
    smooth: bool,
) -> torch.Tensor:
    """Per-frame audio conditioning vector.

    dim_aud>29 selects AudioNet (with AudioAttNet smoothing over smo_size
    neighbouring frames once ``smooth``), else DeepSpeechAudNet. The
    smoothing window indexes frames, zero-padded at the sequence edges.
    """
    if cfg.dim_aud <= 29:
        return params["ds_aud"](auds[aud_ids[index]][None])[0]
    if not smooth:
        return params["aud_net"](auds[aud_ids[index]][None])[0]
    n = aud_ids.shape[0]
    half = cfg.smo_size // 2
    idx = index - half + torch.arange(cfg.smo_size, device=auds.device)
    valid = (idx >= 0) & (idx < n)
    windows = auds[aud_ids[torch.clamp(idx, 0, n - 1)]]
    windows = torch.where(valid[:, None, None], windows,
                          torch.zeros_like(windows))
    feats = params["aud_net"](windows)
    return params["aud_att"](feats)


def train_use_pallas(cfg, device):
    """The field path of a train step, by cfg.train_fused, on a CUDA device
    only: 0 = plain autograd, 1 = fused kernels with the f32 backward,
    2 = fused kernels with the bf16 backward. Off the card: plain. A net
    the kernels do not take (``fused_render.kernels_cover`` of the
    variant's net; the head and torso nets share the width and depth)
    raises on the card before any step."""
    if cfg.train_fused and torch.device(device).type == "cuda":
        ncfg = variant_nerf_config(cfg)
        if not kernels_cover(ncfg):
            raise ValueError(
                f"the kernels take nets of width <= 256 and depth <= 16 with "
                f"the view branch, not W={ncfg.width}, D={ncfg.depth} "
                "(ROADMAP.md B10); --train_fused 0 trains it by autograd")
        return "train_bf16" if cfg.train_fused >= 2 else "train"
    return False


def make_frame_loss(cfg, dataset, smooth_audio: bool, device="cpu"):
    """``loss_fn(params, latent_codes, data, index, coords, generator) ->
    (loss, aux)`` for one frame. ``generator=None`` draws nothing: the
    stratified and importance depths are the deterministic ones."""
    focal, cx, cy = dataset.focal, dataset.cx, dataset.cy
    near, far = dataset.near, dataset.far
    render_cfg = cfg.render_config()
    use_pallas = train_use_pallas(cfg, device)

    def loss_fn(params, latent_codes, data, index, coords, generator):
        aud = compute_aud_feature(params, data["auds"], data["aud_ids"],
                                  index, cfg, smooth_audio)
        expr = data["exprs"][index] if cfg.dim_expr > 0 else None
        latent = latent_codes[index] if cfg.dim_latent > 0 else None

        rays_o, rays_d = rays_at_coords(coords, focal, data["poses"][index],
                                        cx, cy)
        rows, cols = coords[:, 0], coords[:, 1]
        target = data["images"][index][rows, cols].float() / 255.0
        bc_rgb = data["bc_img"][rows, cols].float() / 255.0

        coarse_fn, fine_fn = build_field_fns(params, cfg, aud, expr, latent,
                                             use_pallas=use_pallas)
        out = render_rays(coarse_fn, rays_o, rays_d, bc_rgb, near, far,
                          render_cfg, generator=generator, fine_fn=fine_fn)

        img_loss = torch.mean((out["rgb_map"] - target) ** 2)
        loss = img_loss
        if "rgb0" in out:
            loss = loss + torch.mean((out["rgb0"] - target) ** 2)
        latent_loss = torch.zeros((), device=loss.device)
        if cfg.dim_latent > 0:
            latent_loss = torch.linalg.norm(latent) * cfg.lc_weight
            loss = loss + latent_loss * 10.0
        return loss, {"img_loss": img_loss, "latent_loss": latent_loss}

    return loss_fn


def apply_update(state: TrainState, lr: float) -> None:
    """One Adam update at rate ``lr`` from the gradients in ``.grad``.
    A tensor the loss did not reach (aud_att before the smoothing switch,
    ds_aud when dim_aud > 29) gets a zero gradient rather than none, so
    Adam updates every tensor at every step with one shared step count,
    as optax does; then the gradients are zeroed."""
    for p in state.trainable():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=False)
    state.step += 1


def make_head_train_step(cfg, dataset, smooth_audio: bool,
                         precrop: bool = False, device="cpu"):
    """``train_step(state, data, index, generator) -> metrics``: sample
    rays, render, backward, one Adam update (state changes in place).

    ``precrop`` draws every ray from the central precrop_frac crop (the
    warm-up of the first precrop_iters steps)."""
    H, W = dataset.hw
    if precrop:
        dH = int(H // 2 * cfg.precrop_frac)
        dW = int(W // 2 * cfg.precrop_frac)
        budget = RayBudget(face=cfg.N_rand, background=0, mouth=0, torso=0)
        crop_rect = torch.tensor([W // 2 - dW, H // 2 - dH, 2 * dW - 1,
                                  2 * dH - 1], device=device)
    else:
        budget = RayBudget.from_config(cfg.N_rand, cfg.mouth_rays,
                                       cfg.torso_rays, cfg.sample_rate)
    lr_sched = exponential_lr(cfg.lrate, cfg.lrate_decay)
    loss_fn = make_frame_loss(cfg, dataset, smooth_audio, device)

    def train_step(state: TrainState, data, index: int,
                   generator: Optional[torch.Generator]):
        face_rect = crop_rect if precrop else data["face_rects"][index]
        coords = sample_ray_coords(generator, H, W, face_rect,
                                   data["mouth_boxes"][index],
                                   data["torso_masks"][index], budget)
        loss, aux = loss_fn(state.params, state.latent_codes, data, index,
                            coords, generator)
        loss.backward()
        lr = lr_sched(state.step)
        apply_update(state, lr)
        return {"loss": loss.detach(),
                "psnr": -10.0 * torch.log10(aux["img_loss"].detach()),
                "latent_loss": aux["latent_loss"].detach(), "lr": lr}

    return train_step


class HeadTrainer:
    """Epochs over frames (sequential order, as the reference's
    shuffle=False loader, or random), periodic metrics, the nosmo→smooth
    and precrop switches, checkpoints every i_weights steps, resume, and
    fine-tune surgery from ``cfg.ft_path``.

    Weights are drawn on the host from ``seed``; rays and render jitter
    come from a generator on ``device`` seeded with ``seed``, whose state
    is checkpointed so a resumed run continues the same stream."""

    def __init__(self, cfg, dataset, seed: int = 0,
                 ckpt_dir: Optional[str] = None, resume: bool = True,
                 device="cpu"):
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.data = dataset.to_device(self.device)
        self.state = init_train_state(cfg, dataset.size,
                                      torch.Generator().manual_seed(seed),
                                      self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._steps = {}
        self.ckpt = None
        if ckpt_dir is not None:
            from idealnerf_tpu_torch.ckpt import CheckpointManager

            self.ckpt = CheckpointManager(ckpt_dir)
            if resume and self.ckpt.latest_step() is not None:
                self._load(self.ckpt.restore(map_location=self.device))
                logger.info("resumed from step %d", self.global_step)
            elif cfg.ft_path:
                merged, dropped = CheckpointManager(
                    cfg.ft_path).restore_partial(
                        {"params": self.state.params.state_dict()})
                self.state.params.load_state_dict(merged["params"])
                logger.info("fine-tune init from %s (kept fresh: %s)",
                            cfg.ft_path, ", ".join(dropped) or "nothing")

    def state_dict(self) -> Dict[str, Any]:
        st = self.state
        return {"step": st.step, "params": st.params.state_dict(),
                "latent_codes": st.latent_codes.detach(),
                "optimizer": st.optimizer.state_dict(),
                "rng": self.generator.get_state()}

    def _load(self, ck: Dict[str, Any]) -> None:
        st = self.state
        st.params.load_state_dict(ck["params"])
        with torch.no_grad():
            st.latent_codes.copy_(ck["latent_codes"])
        st.optimizer.load_state_dict(ck["optimizer"])
        st.step = int(ck["step"])
        # a checkpoint converted from the JAX package holds no generator
        # state (orbax_to_torch.py): the run draws on from its seed
        if "rng" in ck:
            self.generator.set_state(ck["rng"].cpu())

    def save(self):
        if self.ckpt is not None:
            self.ckpt.save(self.global_step, self.state_dict())

    def _step_fn(self, smooth: bool, precrop: bool = False):
        key = (smooth, precrop)
        if key not in self._steps:
            self._steps[key] = make_head_train_step(
                self.cfg, self.dataset, smooth, precrop=precrop,
                device=self.device)
        return self._steps[key]

    @property
    def global_step(self) -> int:
        return self.state.step

    def run(self, n_epochs: Optional[int] = None,
            log_every: Optional[int] = None, on_metrics=None,
            frame_order: str = "sequential") -> Dict[str, float]:
        n_epochs = self.cfg.N_iters if n_epochs is None else n_epochs
        log_every = self.cfg.i_print if log_every is None else log_every
        metrics = {}
        t0 = time.perf_counter()
        rng = np.random.RandomState(0)
        s0 = self.global_step  # rates exclude checkpoint-restored steps
        t_log, s_log = t0, s0
        for epoch in range(n_epochs):
            if frame_order == "random":
                order = rng.randint(0, self.dataset.size,
                                    size=self.dataset.size)
            else:
                order = range(self.dataset.size)
            for index in order:
                step = self.global_step
                smooth = self.cfg.dim_aud > 29 and step >= self.cfg.nosmo_iters
                precrop = step < self.cfg.precrop_iters
                m = self._step_fn(smooth, precrop)(
                    self.state, self.data, int(index), self.generator)
                step += 1
                if step % log_every == 0:
                    # float() waits for the device: the rates below are
                    # taken around finished work
                    metrics = {k: float(v) for k, v in m.items()}
                    now = time.perf_counter()
                    metrics["steps_per_sec"] = (step - s0) / max(now - t0,
                                                                 1e-9)
                    metrics["steps_per_sec_rolling"] = (
                        (step - s_log) / max(now - t_log, 1e-9))
                    t_log, s_log = now, step
                    if on_metrics is not None:
                        on_metrics(step, metrics)
                    else:
                        logger.info("[TRAIN] epoch %d step %d loss %.5f psnr "
                                    "%.2f lr %.2e", epoch, step,
                                    metrics["loss"], metrics["psnr"],
                                    metrics["lr"])
                if self.ckpt is not None and step % self.cfg.i_weights == 0:
                    self.save()
        return metrics
