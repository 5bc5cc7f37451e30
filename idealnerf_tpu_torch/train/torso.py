"""Torso / composite trainer (counterpart of train/torso.py).

The torso NeRF is a FaceNeRF whose "audio" conditioning is the torso
signal ``aud[:dim_aud_body] ‖ PE3(euler) ‖ PE3(trans)`` of the head pose,
with no expr or latent. Its rays are cast from the first frame's pose at
the head rays' pixel coords; the composite ``rgb_head · last_weight_torso
+ rgb_fg_torso`` (fine and coarse) is held to the com images, and only
the torso nets learn: the head and its audio nets stay frozen.

The frozen head runs under ``torch.no_grad()`` (audio feature, fold and
render), so its fields never reach the gradient kernel and never get a
``.grad``; Adam holds the torso parameters only. On a CUDA device both
fields go through the fused point MLP (``train_use_pallas``): four forward
launches and two backward launches a step.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from idealnerf_tpu_torch.core.composite import layered_composite
from idealnerf_tpu_torch.core.embedding import pe_dim, positional_encoding
from idealnerf_tpu_torch.core.rays import pose_to_euler_trans
from idealnerf_tpu_torch.core.render import render_rays
from idealnerf_tpu_torch.data.sampler import (
    RayBudget, rays_at_coords, sample_ray_coords,
)
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF, make_field_fn
from idealnerf_tpu_torch.models.variants import build_field_fns
from idealnerf_tpu_torch.train.head import (
    apply_update, compute_aud_feature, train_use_pallas,
)
from idealnerf_tpu_torch.train.schedule import exponential_lr

logger = logging.getLogger("idealnerf.torso")

TORSO_POSE_PE = 2 * pe_dim(3, 3)  # PE3(euler) ‖ PE3(trans) = 42 channels


def torso_signal(aud_feature: torch.Tensor, pose: torch.Tensor,
                 dim_aud_body: int) -> torch.Tensor:
    """The torso conditioning vector of one frame."""
    et = pose_to_euler_trans(pose[None].float())[0]
    return torch.cat([aud_feature[:dim_aud_body],
                      positional_encoding(et[:3], 3),
                      positional_encoding(et[3:], 3)], dim=-1)


def torso_nerf_config(cfg):
    return cfg.face_nerf_config(dim_aud=cfg.dim_aud_body + TORSO_POSE_PE,
                                dim_expr=0, dim_latent=0)


def init_torso_params(cfg, generator: Optional[torch.Generator] = None,
                      device=None) -> nn.ModuleDict:
    """Fresh {"coarse", "fine"} torso FaceNeRFs drawn from ``generator``."""
    tcfg = torso_nerf_config(cfg)
    return nn.ModuleDict({"coarse": FaceNeRF(tcfg, generator, device),
                          "fine": FaceNeRF(tcfg, generator, device)})


def torso_ray_budget(cfg, H: int, W: int, device=None):
    """(budget, rect, mouth box) for sample_ray_coords: half of N_rand in
    the bottom-half rect [x, y, w, h] = [0, H//2, W-1, H-H//2-1], the rest
    outside it, and an empty mouth box."""
    rect_rays = int(cfg.N_rand * 0.5)
    budget = RayBudget(face=rect_rays, background=cfg.N_rand - rect_rays,
                       mouth=0, torso=0)
    bottom_rect = torch.tensor([0, H // 2, W - 1, H - H // 2 - 1],
                               device=device)
    zero_box = torch.full((4,), -1.0, device=device)
    return budget, bottom_rect, zero_box


def make_torso_frame_loss(cfg, dataset, smooth_audio: bool = True,
                          device="cpu"):
    """``loss_fn(torso_params, head_params, latent_codes, data, index,
    coords, generator) -> (loss, aux)`` for one frame. ``generator=None``
    draws nothing: the depths are the deterministic ones."""
    focal, cx, cy = dataset.focal, dataset.cx, dataset.cy
    near, far = dataset.near, dataset.far
    tcfg = torso_nerf_config(cfg)
    render_cfg = cfg.render_config()
    use_pallas = train_use_pallas(cfg, device)

    def loss_fn(torso_params, head_params, latent_codes, data, index, coords,
                generator):
        pose, pose0 = data["poses"][index], data["poses"][0]
        rows, cols = coords[:, 0], coords[:, 1]
        target = data["images"][index][rows, cols].float() / 255.0
        bc_rgb = data["bc_img"][rows, cols].float() / 255.0
        rays_o, rays_d = rays_at_coords(coords, focal, pose, cx, cy)
        rays_o_t, rays_d_t = rays_at_coords(coords, focal, pose0, cx, cy)

        with torch.no_grad():
            aud = compute_aud_feature(head_params, data["auds"],
                                      data["aud_ids"], index, cfg,
                                      smooth_audio)
            expr = data["exprs"][index] if cfg.dim_expr > 0 else None
            latent = latent_codes[index] if cfg.dim_latent > 0 else None
            head_coarse, head_fine = build_field_fns(
                head_params, cfg, aud, expr, latent, use_pallas=use_pallas)
            head = render_rays(head_coarse, rays_o, rays_d, bc_rgb, near,
                               far, render_cfg, generator=generator,
                               fine_fn=head_fine)
        signal = torso_signal(aud, pose, cfg.dim_aud_body)

        def field(model):
            return make_field_fn(model, tcfg, aud=signal,
                                 use_pallas=use_pallas)

        torso = render_rays(field(torso_params["coarse"]), rays_o_t,
                            rays_d_t, bc_rgb, near, far, render_cfg,
                            generator=generator,
                            fine_fn=field(torso_params["fine"]))
        img_loss = torch.mean((layered_composite(
            head["rgb_map"], torso["last_weight"], torso["rgb_fg"])
            - target) ** 2)
        loss = img_loss
        if "rgb0" in torso:
            loss = loss + torch.mean((layered_composite(
                head["rgb0"], torso["last_weight0"], torso["rgb_fg0"])
                - target) ** 2)
        return loss, {"img_loss": img_loss}

    return loss_fn


@dataclasses.dataclass
class TorsoState:
    step: int                        # updates made so far
    params: nn.ModuleDict            # {"coarse", "fine"} torso FaceNeRFs
    optimizer: torch.optim.Optimizer

    def trainable(self) -> List[torch.Tensor]:
        return list(self.params.parameters())


def make_torso_optimizer(cfg, params: nn.Module) -> torch.optim.Adam:
    """Adam over the torso parameters only; the step sets the rate from
    exponential_lr, as train/state.make_optimizer's does."""
    return torch.optim.Adam(params.parameters(), lr=cfg.lrate,
                            betas=(0.9, 0.999), eps=1e-8)


def make_torso_train_step(cfg, dataset, smooth_audio: bool = True,
                          device="cpu"):
    """``train_step(state, head_params, latent_codes, data, index,
    generator) -> metrics``: sample the torso budget's rays, render both
    fields, backward into the torso, one Adam update (in place)."""
    H, W = dataset.hw
    budget, rect, zero_box = torso_ray_budget(cfg, H, W, device)
    no_parse = torch.zeros((H, W), dtype=torch.uint8, device=device)
    lr_sched = exponential_lr(cfg.lrate, cfg.lrate_decay)
    loss_fn = make_torso_frame_loss(cfg, dataset, smooth_audio, device)

    def train_step(state: TorsoState, head_params, latent_codes, data,
                   index: int, generator: Optional[torch.Generator]):
        coords = sample_ray_coords(generator, H, W, rect, zero_box, no_parse,
                                   budget)
        loss, aux = loss_fn(state.params, head_params, latent_codes, data,
                            index, coords, generator)
        loss.backward()
        lr = lr_sched(state.step)
        apply_update(state, lr)
        return {"loss": loss.detach(),
                "psnr": -10.0 * torch.log10(aux["img_loss"].detach()),
                "lr": lr}

    return train_step


class TorsoTrainer:
    """A frozen head (params + latent table, e.g. from a train_head
    checkpoint) and the torso's optimisation on com images, frames in
    order, with checkpoints and resume.

    Torso weights are drawn on the host from ``seed``; rays come from a
    generator on ``device`` seeded with ``seed``, checkpointed with the
    weights."""

    def __init__(self, cfg, dataset, head_params: nn.ModuleDict,
                 latent_codes: Optional[torch.Tensor] = None, seed: int = 0,
                 smooth_audio: bool = True, ckpt_dir: Optional[str] = None,
                 resume: bool = True, device="cpu"):
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.data = dataset.to_device(self.device)
        self.head_params = head_params.to(self.device)
        if latent_codes is None:  # a fresh head's table
            latent_codes = torch.ones((dataset.size, max(cfg.dim_latent, 1)))
        self.latent_codes = latent_codes.detach().to(self.device)
        params = init_torso_params(
            cfg, torch.Generator().manual_seed(seed)).to(self.device)
        self.state = TorsoState(step=0, params=params,
                                optimizer=make_torso_optimizer(cfg, params))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._step_fn = make_torso_train_step(cfg, dataset, smooth_audio,
                                              self.device)
        self.ckpt = None
        if ckpt_dir is not None:
            from idealnerf_tpu_torch.ckpt import CheckpointManager

            self.ckpt = CheckpointManager(ckpt_dir)
            if resume and self.ckpt.latest_step() is not None:
                self._load(self.ckpt.restore(map_location=self.device))
                logger.info("torso resumed from step %d", self.step)

    @property
    def step(self) -> int:
        return self.state.step

    @property
    def torso_params(self) -> nn.ModuleDict:
        return self.state.params

    def state_dict(self) -> Dict[str, Any]:
        return {"torso_params": self.state.params.state_dict(),
                "opt_state": self.state.optimizer.state_dict(),
                "step": self.state.step, "rng": self.generator.get_state()}

    def _load(self, ck: Dict[str, Any]) -> None:
        self.state.params.load_state_dict(ck["torso_params"])
        self.state.optimizer.load_state_dict(ck["opt_state"])
        self.state.step = int(ck["step"])
        # a checkpoint converted from the JAX package holds no generator
        # state (orbax_to_torch.py): the run draws on from its seed
        if "rng" in ck:
            self.generator.set_state(ck["rng"].cpu())

    def save(self):
        if self.ckpt is not None:
            self.ckpt.save(self.step, self.state_dict())

    def run(self, n_steps: int, log_every: int = 50,
            on_metrics=None) -> Dict[str, float]:
        """``n_steps`` steps; every step whose count of earlier updates is
        a multiple of ``log_every`` reports its metrics (waiting for the
        device) with the steps per second since the last report."""
        metrics = {}
        t_log, s_log = time.perf_counter(), self.step
        for _ in range(n_steps):
            step = self.step
            m = self._step_fn(self.state, self.head_params,
                              self.latent_codes, self.data,
                              step % self.dataset.size, self.generator)
            if step % log_every == 0:
                metrics = {k: float(v) for k, v in m.items()}
                now = time.perf_counter()
                metrics["steps_per_sec_rolling"] = (
                    (self.step - s_log) / max(now - t_log, 1e-9))
                t_log, s_log = now, self.step
                if on_metrics is not None:
                    on_metrics(step, metrics)
                else:
                    logger.info("[TORSO] step %d loss %.5f psnr %.2f", step,
                                metrics["loss"], metrics["psnr"])
        return metrics
