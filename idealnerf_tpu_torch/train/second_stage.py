"""Second-stage / cross-identity fine-tuning (counterpart of
train/second_stage.py).

A trained head is fine-tuned on the target identity's frames while
conditioned on a driving subject's audio (and expressions): every step
renders the whole face crop and optimises MSE(fine) + MSE(coarse) over it,
plus an optional aux loss on the assembled crop.

The crop's rays go in tiles of ``tile`` rays (8,192, the JAX package's),
each through ``torch.utils.checkpoint``, so the backward holds one tile's
temporaries at a time and recomputes them; a crop that is not a whole
number of tiles is padded and sliced back. A tile's random numbers come
from a seed drawn before it: the recompute must draw the same stratified
and importance depths, and checkpoint restores only the global RNG, not a
caller's generator. On a CUDA device each tile runs the fused point-MLP
kernel and its gradient kernel (``train_fused`` 1 or 2).

The aux loss (``make_aux_loss``: the FAN landmark, VGG16 and VGGFace
terms) takes the assembled crop; its nets are plain torch and cuDNN
convolutions in f32 without TF32 (``face_unet.ieee_convs``, the backward
too) and add no kernel launch. The sharded crop waits for ROADMAP.md A13
and raises until then.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from idealnerf_tpu_torch.core.render import render_rays
from idealnerf_tpu_torch.data.sampler import rays_at_coords
from idealnerf_tpu_torch.models.face_unet import ieee_convs
from idealnerf_tpu_torch.models.variants import build_field_fns
from idealnerf_tpu_torch.train.head import (
    apply_update, compute_aud_feature, train_use_pallas,
)
from idealnerf_tpu_torch.train.schedule import exponential_lr
from idealnerf_tpu_torch.train.state import TrainState, init_train_state

logger = logging.getLogger("idealnerf.second_stage")

TILE = 8192
A13 = "ROADMAP.md A13 (multi-device)"


def make_cross_identity_dataset(identity, driving_auds: np.ndarray,
                                driving_exprs: Optional[np.ndarray] = None):
    """The identity's frames, poses and crops with the driving subject's
    audio (and expressions), index-aligned and clamped to the driving
    clip's length."""
    n = identity.size
    ids = np.minimum(np.arange(n), driving_auds.shape[0] - 1).astype(np.int32)
    exprs = identity.exprs
    if driving_exprs is not None:
        exprs = driving_exprs[np.minimum(np.arange(n),
                                         driving_exprs.shape[0] - 1)]
    return dataclasses.replace(identity,
                               auds=driving_auds.astype(np.float32),
                               aud_ids=ids, exprs=exprs.astype(np.float32))


def make_aux_loss(fan=None, vgg16=None, vggface=None,
                  w_landmark: float = 1.0, w_vgg: float = 0.0,
                  w_vggface: float = 0.0) -> Optional[Callable]:
    """The reference's second-stage aux losses as one ``(pred_crop,
    target_crop) -> scalar`` over (crop, crop, 3) crops in [0, 1]
    (distribute_nerf.py:433-491, which optimises only the landmark term:
    hence the zero default weights of the others). A term is on when its
    net (``pipeline.fan.FAN``, ``losses.vgg.VGG16``, ``losses.vgg.VGGFace``)
    is given and its weight is not zero: the FAN's final-stack heatmaps of
    both crops under an L1; VGG16 on ``2 p - 1`` and ``2 t - 1``; VGGFace
    on the raw crops. The nets given are frozen (``requires_grad_(False)``):
    the gradient reaches the crop, not them. With no term on: None."""
    terms, nets = [], []
    if fan is not None and w_landmark:
        from idealnerf_tpu_torch.losses.landmark import make_fan_landmark_loss

        lm = make_fan_landmark_loss(fan)
        terms.append(lambda p, t: w_landmark * lm(p, t))
        nets.append(fan)
    if vgg16 is not None and w_vgg:
        from idealnerf_tpu_torch.losses.vgg import make_vgg16_loss

        v = make_vgg16_loss(vgg16)
        terms.append(lambda p, t: w_vgg * v(2.0 * p[None] - 1.0,
                                            2.0 * t[None] - 1.0))
        nets.append(vgg16)
    if vggface is not None and w_vggface:
        from idealnerf_tpu_torch.losses.vgg import make_vggface_loss

        vf = make_vggface_loss(vggface)
        terms.append(lambda p, t: w_vggface * vf(p[None], t[None]))
        nets.append(vggface)
    if not terms:
        return None
    for net in nets:
        net.requires_grad_(False)

    def aux(pred_crop, target_crop):
        return sum(term(pred_crop, target_crop) for term in terms)

    return aux


def crop_coords(face_rect: torch.Tensor, crop: int, H: int,
                W: int) -> torch.Tensor:
    """(crop², 2) [row, col] of the crop anchored at the face rect's
    corner, clipped into the image."""
    x0 = torch.clamp(face_rect[0], 0, W - crop)
    y0 = torch.clamp(face_rect[1], 0, H - crop)
    r = torch.arange(crop, device=face_rect.device)
    rr = (y0 + r)[:, None].expand(crop, crop)
    cc = (x0 + r)[None, :].expand(crop, crop)
    return torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=-1).long()


def _pad(x: torch.Tensor, pad: int, fill: float) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)])


def make_second_stage_loss(cfg, dataset, crop: int,
                           smooth_audio: bool = False,
                           aux_loss: Optional[Callable] = None,
                           tile: int = TILE, checkpoint_tiles: bool = True,
                           device="cpu"):
    """``loss_fn(params, latent_codes, data, index, generator) -> (loss,
    aux)`` over the frame's whole crop. ``generator=None`` draws nothing
    (the deterministic depths). ``checkpoint_tiles=False`` keeps every
    tile's temporaries instead of recomputing them (the same gradients)."""
    H, W = dataset.hw
    focal, cx, cy = dataset.focal, dataset.cx, dataset.cy
    near, far = dataset.near, dataset.far
    render_cfg = cfg.render_config()
    use_pallas = train_use_pallas(cfg, device)

    def loss_fn(params, latent_codes, data, index, generator):
        aud = compute_aud_feature(params, data["auds"], data["aud_ids"],
                                  index, cfg, smooth_audio)
        expr = data["exprs"][index] if cfg.dim_expr > 0 else None
        latent = latent_codes[index] if cfg.dim_latent > 0 else None

        coords = crop_coords(data["face_rects"][index], crop, H, W)
        rows, cols = coords[:, 0], coords[:, 1]
        rays_o, rays_d = rays_at_coords(coords, focal, data["poses"][index],
                                        cx, cy)
        target = data["images"][index][rows, cols].float() / 255.0
        bc_rgb = data["bc_img"][rows, cols].float() / 255.0
        coarse_fn, fine_fn = build_field_fns(params, cfg, aud, expr, latent,
                                             use_pallas=use_pallas)
        n_rays = crop * crop
        t = min(n_rays, tile)
        if n_rays > t:
            n_tiles = -(-n_rays // t)
            pad = n_tiles * t - n_rays
            seeds = [None] * n_tiles
            if generator is not None:
                seeds = torch.randint(0, 2 ** 62, (n_tiles,),
                                      generator=generator,
                                      device=generator.device).tolist()

            def tile_fn(o, d, b, seed):
                gen = None
                if seed is not None:
                    gen = torch.Generator(device=o.device).manual_seed(seed)
                out = render_rays(coarse_fn, o, d, b, near, far, render_cfg,
                                  generator=gen, fine_fn=fine_fn)
                return out["rgb_map"], out["rgb0"]

            parts = zip(_pad(rays_o, pad, 1.0).split(t),
                        _pad(rays_d, pad, -1.0).split(t),
                        _pad(bc_rgb, pad, 0.0).split(t), seeds)
            rgb, rgb0 = zip(*(checkpoint(tile_fn, *p, use_reentrant=False)
                              if checkpoint_tiles else tile_fn(*p)
                              for p in parts))
            out = {"rgb_map": torch.cat(rgb)[:n_rays],
                   "rgb0": torch.cat(rgb0)[:n_rays]}
        else:
            out = render_rays(coarse_fn, rays_o, rays_d, bc_rgb, near, far,
                              render_cfg, generator=generator,
                              fine_fn=fine_fn)
        img_loss = torch.mean((out["rgb_map"] - target) ** 2)
        loss = img_loss + torch.mean((out["rgb0"] - target) ** 2)
        aux = torch.zeros((), device=loss.device)
        if aux_loss is not None:
            aux = aux_loss(out["rgb_map"].reshape(crop, crop, 3),
                           target.reshape(crop, crop, 3))
            loss = loss + aux
        return loss, {"img_loss": img_loss, "aux_loss": aux}

    return loss_fn


def make_second_stage_step(cfg, dataset, crop: int,
                           smooth_audio: bool = False,
                           aux_loss: Optional[Callable] = None, mesh=None,
                           tile: int = TILE, device="cpu"):
    """``step(state, data, index, generator) -> metrics``: the crop's
    loss, backward, one Adam update (the state changes in place).
    ``mesh`` (the crop's rays over several devices) raises: A13."""
    if mesh is not None:
        raise NotImplementedError(f"the ray-sharded second stage is not "
                                  f"ported yet ({A13})")
    lr_sched = exponential_lr(cfg.lrate, cfg.lrate_decay)
    loss_fn = make_second_stage_loss(cfg, dataset, crop, smooth_audio,
                                     aux_loss, tile=tile, device=device)

    def step(state: TrainState, data, index: int,
             generator: Optional[torch.Generator]):
        loss, aux = loss_fn(state.params, state.latent_codes, data, index,
                            generator)
        with ieee_convs():  # the aux nets' backward convolutions
            loss.backward()
        lr = lr_sched(state.step)
        apply_update(state, lr)
        return {"loss": loss.detach(),
                "psnr": -10.0 * torch.log10(aux["img_loss"].detach()),
                "aux_loss": aux["aux_loss"].detach(), "lr": lr}

    return step


class SecondStageTrainer:
    """The cross-identity dataset, a fresh TrainState (weights drawn on the
    host from ``seed``) merged with a head's parameters (``init_params``,
    a state_dict; ``ckpt.partial_restore`` keeps fresh what does not fit),
    and steps over the frames in order, rays from a generator on
    ``device`` seeded with ``seed``."""

    def __init__(self, cfg, identity, driving_auds: np.ndarray,
                 driving_exprs: Optional[np.ndarray] = None,
                 init_params: Optional[Dict[str, torch.Tensor]] = None,
                 crop: int = 256, seed: int = 0, smooth_audio: bool = False,
                 aux_loss: Optional[Callable] = None, mesh=None,
                 tile: int = TILE, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dataset = make_cross_identity_dataset(identity, driving_auds,
                                                   driving_exprs)
        self.data = self.dataset.to_device(self.device)
        self.crop = min(crop, min(self.dataset.hw))
        self.state = init_train_state(cfg, self.dataset.size,
                                      torch.Generator().manual_seed(seed),
                                      self.device)
        if init_params is not None:
            from idealnerf_tpu_torch.ckpt import partial_restore

            merged, dropped = partial_restore(
                init_params, self.state.params.state_dict())
            self.state.params.load_state_dict(merged)
            if dropped:
                logger.info("surgery kept %d tensors fresh", len(dropped))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._step = make_second_stage_step(
            cfg, self.dataset, self.crop, smooth_audio, aux_loss, mesh=mesh,
            tile=tile, device=self.device)

    def run(self, n_steps: int, log_every: int = 20,
            on_metrics=None) -> Dict[str, float]:
        """``n_steps`` steps; every ``log_every``-th reports its metrics
        (waiting for the device) with the steps per second since the last
        report (``steps_per_sec_rolling``)."""
        metrics = {}
        t_log, i_log = time.perf_counter(), 0
        for i in range(n_steps):
            m = self._step(self.state, self.data, i % self.dataset.size,
                           self.generator)
            if i % log_every == 0:
                metrics = {k: float(v) for k, v in m.items()}
                now = time.perf_counter()
                metrics["steps_per_sec_rolling"] = (
                    (i + 1 - i_log) / max(now - t_log, 1e-9))
                t_log, i_log = now, i + 1
                if on_metrics is not None:
                    on_metrics(i, metrics)
                else:
                    logger.info("[2ND] step %d loss %.5f psnr %.2f", i,
                                metrics["loss"], metrics["psnr"])
        return metrics
