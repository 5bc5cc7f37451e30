"""GRF-style UNet-attention trainer (counterpart of train/unet.py).

  UNet(PE(frame)) -> (C, H, W) features
  per point: project -> gather (C + 2) ‖ PE(point) -> AttSets -> (512,)
  decoder: the FaceNeRF topology with PER-POINT conditioning in the aud
           slot (models/face_nerf.apply_point_conditioned)

Each ray batch puts the frame's 68 landmark pixels first, then the
regular budget. Nothing here folds: each point has its own conditioning,
so the field runs as plain torch on every device, and the UNet's
convolutions are cuDNN calls in f32 (``face_unet.ieee_convs``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from idealnerf_tpu_torch.core.embedding import pe_dim, positional_encoding
from idealnerf_tpu_torch.core.render import render_rays
from idealnerf_tpu_torch.data.sampler import (
    RayBudget, rays_at_coords, sample_ray_coords,
)
from idealnerf_tpu_torch.models.attention import AttentionSets
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, FaceNeRFConfig, apply_point_conditioned,
)
from idealnerf_tpu_torch.models.face_unet import FaceUNet, ieee_convs
from idealnerf_tpu_torch.models.projection import gather_image_features
from idealnerf_tpu_torch.train.head import apply_update
from idealnerf_tpu_torch.train.schedule import exponential_lr

logger = logging.getLogger("idealnerf.unet")

ATT_OUT = 512           # attention_output_length (unet_att_nerf.py:68)
EMBED_IMG_MULTIRES = 5  # the frame's PE: 33 channels
N_LANDMARKS = 68


def unet_nerf_config(cfg) -> FaceNeRFConfig:
    return cfg.face_nerf_config(dim_aud=ATT_OUT, dim_expr=0, dim_latent=0)


def init_unet_params(cfg, generator: Optional[torch.Generator] = None,
                     device=None) -> nn.ModuleDict:
    """{"unet", "attsets", "coarse", "fine"} drawn from ``generator``."""
    embed_ln = pe_dim(3, EMBED_IMG_MULTIRES)
    ncfg = unet_nerf_config(cfg)
    feat_ch = 128 + embed_ln + 2  # unet features + embedded rgb + indices
    return nn.ModuleDict({
        "unet": FaceUNet(embed_ln, generator, device),
        "attsets": AttentionSets(feat_ch + pe_dim(3, cfg.multires),
                                 attention_output_length=ATT_OUT,
                                 generator=generator, device=device),
        "coarse": FaceNeRF(ncfg, generator, device),
        "fine": FaceNeRF(ncfg, generator, device),
    })


def landmark_coords(lms: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(68, 2) [row, col] of the frame's landmarks, stored (x, y)."""
    rows = torch.clamp(torch.round(lms[:, 1]), 0, H - 1)
    cols = torch.clamp(torch.round(lms[:, 0]), 0, W - 1)
    return torch.stack([rows, cols], dim=-1).long()


def make_unet_loss(cfg, dataset):
    """``loss_fn(params, data, index, coords, generator) -> (loss, aux)``:
    the UNet features of frame ``index``, then the render of its rays at
    ``coords`` (generator=None: deterministic depths)."""
    focal, cx, cy = dataset.focal, dataset.cx, dataset.cy
    near, far = dataset.near, dataset.far
    ncfg = unet_nerf_config(cfg)
    render_cfg = cfg.render_config()

    def field_fn(params, net, feature_map, pose, intrinsic):
        def fn(pts, viewdirs):
            R, S, _ = pts.shape
            flat = pts.reshape(R * S, 3)
            pe_pts = positional_encoding(flat, cfg.multires)
            dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(R * S, 3)
            pe_dirs = positional_encoding(dirs, cfg.multires_views)
            feats = gather_image_features(flat, pose, intrinsic, feature_map,
                                          channels_first=True)
            cond = params["attsets"](torch.cat([feats, pe_pts],
                                               dim=-1)[:, None, :])
            return apply_point_conditioned(params[net], ncfg, pe_pts,
                                           pe_dirs, cond).reshape(R, S, 4)

        return fn

    def loss_fn(params, data, index, coords, generator):
        pose = data["poses"][index].float()
        image = data["images"][index].float() / 255.0
        bc = data["bc_img"].float() / 255.0
        rows, cols = coords[:, 0], coords[:, 1]
        target, bc_rgb = image[rows, cols], bc[rows, cols]
        rays_o, rays_d = rays_at_coords(coords, focal, pose, cx, cy)
        intrinsic = torch.tensor([[focal, 0.0, cx], [0.0, focal, cy],
                                  [0.0, 0.0, 1.0]], device=pose.device)
        embedded = positional_encoding(image, EMBED_IMG_MULTIRES)[None]
        feature_map = params["unet"](embedded,
                                     embed_ln=embedded.shape[-1])[0]
        out = render_rays(
            field_fn(params, "coarse", feature_map, pose, intrinsic),
            rays_o, rays_d, bc_rgb, near, far, render_cfg,
            generator=generator,
            fine_fn=field_fn(params, "fine", feature_map, pose, intrinsic))
        img_loss = torch.mean((out["rgb_map"] - target) ** 2)
        loss = img_loss
        if "rgb0" in out:
            loss = loss + torch.mean((out["rgb0"] - target) ** 2)
        return loss, {"img_loss": img_loss}

    return loss_fn


@dataclasses.dataclass
class UNetState:
    step: int                        # updates made so far
    params: nn.ModuleDict
    optimizer: torch.optim.Optimizer

    def trainable(self) -> List[torch.Tensor]:
        return list(self.params.parameters())


def make_unet_train_step(cfg, dataset):
    """``step(state, data, index, generator) -> metrics``: the landmark
    pixels and a region-stratified budget of rays, the render, backward
    and one Adam update (the state changes in place)."""
    H, W = dataset.hw
    budget = RayBudget.from_config(max(cfg.N_rand - N_LANDMARKS,
                                       N_LANDMARKS), cfg.mouth_rays,
                                   cfg.torso_rays, cfg.sample_rate)
    lr_sched = exponential_lr(cfg.lrate, cfg.lrate_decay)
    loss_fn = make_unet_loss(cfg, dataset)

    def step(state: UNetState, data, index: int,
             generator: Optional[torch.Generator]):
        coords = sample_ray_coords(generator, H, W, data["face_rects"][index],
                                   data["mouth_boxes"][index],
                                   data["torso_masks"][index], budget)
        coords = torch.cat([landmark_coords(data["landmarks"][index], H, W),
                            coords])
        with ieee_convs():
            loss, aux = loss_fn(state.params, data, index, coords, generator)
            loss.backward()
        lr = lr_sched(state.step)
        apply_update(state, lr)
        return {"loss": loss.detach(),
                "psnr": -10.0 * torch.log10(aux["img_loss"].detach()),
                "lr": lr}

    return step


class UNetTrainer:
    """Frames in order, one step each; weights drawn on the host from
    ``seed``, rays from a generator on ``device`` seeded with it."""

    def __init__(self, cfg, dataset, seed: int = 0, device="cpu"):
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.data = dataset.to_device(self.device)
        params = init_unet_params(
            cfg, torch.Generator().manual_seed(seed)).to(self.device)
        self.state = UNetState(step=0, params=params,
                               optimizer=torch.optim.Adam(
                                   params.parameters(), lr=cfg.lrate,
                                   betas=(0.9, 0.999), eps=1e-8))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._step_fn = make_unet_train_step(cfg, dataset)

    @property
    def params(self) -> nn.ModuleDict:
        return self.state.params

    @property
    def step(self) -> int:
        return self.state.step

    def run(self, n_steps: int, log_every: int = 20,
            on_metrics=None) -> Dict[str, float]:
        metrics = {}
        for _ in range(n_steps):
            step = self.state.step
            m = self._step_fn(self.state, self.data,
                              step % self.dataset.size, self.generator)
            if step % log_every == 0:
                metrics = {k: float(v) for k, v in m.items()}
                if on_metrics is not None:
                    on_metrics(step, metrics)
                else:
                    logger.info("[UNET] step %d loss %.5f psnr %.2f", step,
                                metrics["loss"], metrics["psnr"])
        return metrics
