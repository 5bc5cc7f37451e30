"""Multi-device training steps and renderers (counterpart of
parallel/sharded.py).

The JAX package lets GSPMD shard one program over a ('data', 'ray')
mesh. Here each rank of the mesh (``parallel.mesh.Mesh``) runs its own
share and the ranks meet in two collectives, ``all_reduce`` and nothing
else (gloo reduces CUDA tensors but gathers none):

- Training: rank (d, r) takes the d-th contiguous block of the step's B
  frames (one frame where B = n_data, as the trainers step) and the r-th
  contiguous block of each frame's rays. The whole batch's ray samples
  and render jitter are drawn on every rank from generators seeded
  alike, in the order one device draws them (frame by frame: the coords,
  then the render's numbers, ``core.render.render_draws``); each rank
  renders its rows of its frames (``core.sampling.Replay``). Its MSE
  terms are its rows' share of the frame's (the sum over its rows over
  the frame's N_rand), the latent-norm term rides on ray rank 0, and
  each frame's loss is scaled by 1/B, so one ``all_reduce`` SUM of the
  gradients gives every rank the frame-averaged gradient of the batch;
  Adam then steps alike on every rank and the parameters stay equal.
- Rendering: a frame's rays go in tiles of ``tile`` rays, each tile's
  rows split over the ray ranks (``tile_rows``), padded to whole tiles
  with dummy rays (``_pad_rays``). Each rank renders all its rows in one
  call of the port's frame route (K2 then K1 on the card), and the frame
  is assembled by an ``all_reduce`` SUM of a zero-filled buffer holding
  each rank's rows, exact on every route. The JAX package's sharded
  renderers take the unfused ``render_rays`` (GSPMD does not split a
  Pallas call); the port's kernels render whole rays per block, so a
  sharded frame is, ray for ray, the single-device frame (ROADMAP.md C).
- Video renderers batch B frames over 'data' (B divisible by it), each
  frame's conditioning riding with it, one ``all_reduce`` a batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from idealnerf_tpu_torch.core.composite import layered_composite
from idealnerf_tpu_torch.core.rays import get_rays
from idealnerf_tpu_torch.core.render import render_draws
from idealnerf_tpu_torch.core.sampling import Replay
from idealnerf_tpu_torch.eval.renderer import render_field_rays
from idealnerf_tpu_torch.train.head import (
    apply_update, make_frame_loss, make_head_sampler,
)
from idealnerf_tpu_torch.train.schedule import exponential_lr
from idealnerf_tpu_torch.train.torso import (
    make_torso_frame_loss, make_torso_sampler,
)


# ------------------------------------------------------------ helpers

def _pad_rays(ro, rd, n_pad):
    """Pad flat (N, 3) origins/directions with unit-origin, -z-direction
    dummy rays so N becomes a whole tile count (results are sliced back
    before assembly: every sharded renderer shares this convention)."""
    if not n_pad:
        return ro, rd
    ro = torch.cat([ro, ro.new_ones((n_pad, 3))])
    rd = torch.cat([rd, rd.new_tensor([0.0, 0.0, -1.0]).expand(n_pad, 3)])
    return ro, rd


def _pad_zeros(x, n_pad):
    if not n_pad:
        return x
    return torch.cat([x, x.new_zeros((n_pad,) + x.shape[1:])])


def _block(n: int, parts: int, i: int) -> slice:
    """The i-th of ``parts`` equal contiguous blocks of n rows."""
    per = n // parts
    return slice(i * per, (i + 1) * per)


def tile_rows(n_rows: int, tile: int, n_ray: int, ray_index: int,
              device=None) -> torch.Tensor:
    """The rows ray rank ``ray_index`` takes of ``n_rows`` rows in tiles of
    ``tile``: the ray_index-th of each tile's n_ray equal blocks."""
    per = tile // n_ray
    starts = torch.arange(0, n_rows, tile, device=device)
    return (starts[:, None] + ray_index * per
            + torch.arange(per, device=device)).reshape(-1)


class _AssembleRows(torch.autograd.Function):
    """Forward: this rank's rows placed into a zero-filled (n, ...) buffer
    and summed over the group, the whole on every rank. Backward: this
    rank's rows of the whole's gradient, with no collective, so a loss
    that every rank evaluates on the whole reaches the parameters once
    after the gradients' all-reduce."""

    @staticmethod
    def forward(ctx, part, rows, n, group):
        ctx.save_for_backward(rows)
        whole = part.new_zeros((n,) + part.shape[1:])
        whole[rows] = part
        dist.all_reduce(whole, group=group)
        return whole

    @staticmethod
    def backward(ctx, grad):
        rows, = ctx.saved_tensors
        return grad[rows], None, None, None


def assemble_rows(part: torch.Tensor, rows: torch.Tensor, n: int,
                  group=None) -> torch.Tensor:
    """The (n, ...) whole of which this rank holds ``part`` at ``rows``
    and the group's other ranks the rest (``_AssembleRows``)."""
    return _AssembleRows.apply(part, rows, n, group)


def all_reduce_gradients(tensors: Sequence[torch.Tensor],
                         extras: Sequence[torch.Tensor],
                         group=None) -> torch.Tensor:
    """Sum every tensor's ``.grad`` (zeros where the loss did not reach it)
    and the scalars ``extras`` over the group in one ``all_reduce``; the
    sums go back into ``.grad`` -> the summed extras."""
    flat = [p.grad.reshape(-1) if p.grad is not None
            else p.new_zeros(p.numel()) for p in tensors]
    buf = torch.cat(flat + [torch.stack([e.detach().float().reshape(())
                                         for e in extras])])
    dist.all_reduce(buf, group=group)
    off = 0
    for p in tensors:
        g = buf[off:off + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        off += p.numel()
    return buf[off:]


def _my_frames(n_frames: int, mesh) -> range:
    """The contiguous block of a batch's frames this rank's 'data' index
    takes; the batch must divide by the 'data' axis."""
    if n_frames % mesh.n_data:
        raise ValueError(f"frame batch {n_frames} not divisible by 'data' "
                         f"axis {mesh.n_data}")
    return range(*_block(n_frames, mesh.n_data, mesh.data_index)
                 .indices(n_frames))


def _rows_of(draws: Optional[List[torch.Tensor]], rows: slice):
    return None if draws is None else [t[rows] for t in draws]


def _replay(draws: Optional[List[torch.Tensor]]):
    """A fresh Replay of a frame's drawn rows, made inside the (perhaps
    rematerialised) forward, so that its recompute replays them again."""
    return None if draws is None else Replay(draws)


def _batch_grads(frame_loss, inputs, n_frames: int, remat: bool, tensors):
    """Backward of this rank's frames' loss shares, each scaled by
    1/n_frames, then one all-reduce of the gradients with the summed
    shares of every frame_loss output -> those sums."""
    totals = None
    for args in inputs:
        parts = (checkpoint(frame_loss, *args, use_reentrant=False) if remat
                 else frame_loss(*args))
        if n_frames > 1:
            parts = [p / n_frames for p in parts]
        parts[0].backward()
        parts = [p.detach() for p in parts]
        totals = parts if totals is None else [
            a + b for a, b in zip(totals, parts)]
    return all_reduce_gradients(tensors, totals)


# ------------------------------------------------------------ training

def make_sharded_grads(cfg, dataset, mesh, smooth_audio: bool = False,
                       remat: bool = False, precrop: bool = False):
    """``grads(state, data, indices (B,), generator, coords=None) ->
    metrics``: this rank's share of the batch's head loss (its block of
    B / n_data frames, ray block r of each), its backward, and the
    all-reduced gradients of the frame-averaged loss left in each
    trainable tensor's ``.grad``. ``coords`` (B, N_rand, 2) replaces the
    ray sample; ``generator=None`` draws nothing (deterministic depths).
    ``remat`` recomputes each frame's forward in the backward
    (``torch.utils.checkpoint``; the render's numbers are drawn outside,
    so the recompute renders the same)."""
    n_ray = mesh.n_ray
    if cfg.N_rand % n_ray:
        raise ValueError(f"N_rand={cfg.N_rand} must divide by the ray axis "
                         f"({n_ray})")
    device = mesh.device
    sample = make_head_sampler(cfg, *dataset.hw, precrop, device)
    render_cfg = cfg.render_config()
    loss_fn = make_frame_loss(
        cfg, dataset, smooth_audio, device,
        n_total=None if n_ray == 1 else cfg.N_rand,
        latent_term=mesh.ray_index == 0)
    rows = _block(cfg.N_rand, n_ray, mesh.ray_index)

    def frame_loss(params, latent_codes, data, index, coords, draws):
        loss, aux = loss_fn(params, latent_codes, data, index, coords,
                            _replay(draws))
        return loss, aux["img_loss"], aux["latent_loss"]

    def grads(state, data, indices, generator, coords=None):
        mine = _my_frames(len(indices), mesh)
        inputs = []
        for b, index in enumerate(indices):
            c = (sample(generator, data, int(index)) if coords is None
                 else coords[b])
            draws = (render_draws(generator, cfg.N_rand, render_cfg,
                                  device=device)
                     if generator is not None else None)
            if b in mine:
                inputs.append((state.params, state.latent_codes, data,
                               int(index), c[rows], _rows_of(draws, rows)))
        loss, img, latent = _batch_grads(frame_loss, inputs, len(indices),
                                         remat, state.trainable())
        return {"loss": loss, "psnr": -10.0 * torch.log10(img),
                "latent_loss": latent}

    return grads


def make_sharded_train_step(cfg, dataset, mesh, smooth_audio: bool = False,
                            remat: bool = False, precrop: bool = False):
    """``step(state, data, indices (B,), generator) -> metrics``: the
    sharded head step (``make_sharded_grads``) and one Adam update, alike
    on every rank; B divisible by the mesh's 'data' axis, N_rand by its
    'ray' axis. On a mesh of one rank it is ``train.head``'s step."""
    grads = make_sharded_grads(cfg, dataset, mesh, smooth_audio, remat,
                               precrop)
    lr_sched = exponential_lr(cfg.lrate, cfg.lrate_decay)

    def train_step(state, data, indices, generator):
        m = grads(state, data, indices, generator)
        lr = lr_sched(state.step)
        apply_update(state, lr)
        return {**m, "lr": lr}

    return train_step


def make_sharded_torso_grads(cfg, dataset, mesh, smooth_audio: bool = True,
                             remat: bool = False):
    """``grads(state, head_params, latent_codes, data, indices, generator,
    coords=None) -> metrics``: the torso counterpart of
    ``make_sharded_grads`` (the frozen head replicated on every rank; per
    frame the coords, then the head's and the torso's render numbers)."""
    n_ray = mesh.n_ray
    if cfg.N_rand % n_ray:
        raise ValueError(f"N_rand={cfg.N_rand} must divide by the ray axis "
                         f"({n_ray})")
    device = mesh.device
    sample = make_torso_sampler(cfg, *dataset.hw, device)
    render_cfg = cfg.render_config()
    loss_fn = make_torso_frame_loss(
        cfg, dataset, smooth_audio, device,
        n_total=None if n_ray == 1 else cfg.N_rand)
    rows = _block(cfg.N_rand, n_ray, mesh.ray_index)

    def frame_loss(torso_params, head_params, latent_codes, data, index,
                   coords, draws):
        loss, aux = loss_fn(torso_params, head_params, latent_codes, data,
                            index, coords, _replay(draws))
        return loss, aux["img_loss"]

    def grads(state, head_params, latent_codes, data, indices, generator,
              coords=None):
        mine = _my_frames(len(indices), mesh)
        inputs = []
        for b, index in enumerate(indices):
            c = sample(generator) if coords is None else coords[b]
            draws = None
            if generator is not None:  # the head's render, then the torso's
                draws = [t for _ in range(2) for t in render_draws(
                    generator, cfg.N_rand, render_cfg, device=device)]
            if b in mine:
                inputs.append((state.params, head_params, latent_codes, data,
                               int(index), c[rows], _rows_of(draws, rows)))
        loss, img = _batch_grads(frame_loss, inputs, len(indices), remat,
                                 state.trainable())
        return {"loss": loss, "psnr": -10.0 * torch.log10(img)}

    return grads


def make_sharded_torso_train_step(cfg, dataset, mesh,
                                  smooth_audio: bool = True,
                                  remat: bool = False):
    """``step(state, head_params, latent_codes, data, indices (B,),
    generator) -> metrics``: the sharded counterpart of
    ``train.torso.make_torso_train_step`` (frames over 'data', rays over
    'ray'; only the torso learns)."""
    grads = make_sharded_torso_grads(cfg, dataset, mesh, smooth_audio,
                                     remat)
    lr_sched = exponential_lr(cfg.lrate, cfg.lrate_decay)

    def train_step(state, head_params, latent_codes, data, indices,
                   generator):
        m = grads(state, head_params, latent_codes, data, indices, generator)
        lr = lr_sched(state.step)
        apply_update(state, lr)
        return {**m, "lr": lr}

    return train_step


# ------------------------------------------------------------ rendering

def _check_tile(tile: int, mesh) -> None:
    if tile % mesh.n_ray:
        raise ValueError(f"tile {tile} not divisible by 'ray' axis "
                         f"{mesh.n_ray}")


def _frame(H, W, focal, pose, cx, cy, n_pad):
    """A frame's flat rays from ``pose``, padded to whole tiles."""
    ro, rd = get_rays(H, W, focal, pose, cx, cy)
    return _pad_rays(ro.reshape(-1, 3), rd.reshape(-1, 3), n_pad)


def _plate(bc_img, n_pad):
    return _pad_zeros(bc_img.reshape(-1, 3).float(), n_pad)


def _at(x, b):
    return None if x is None else x[b]


def make_sharded_frame_renderer(nerf_cfg, mesh, H: int, W: int, focal, near,
                                far, render_cfg, cx=None, cy=None,
                                tile: int = 8192):
    """``render(params, pose, bc_img, aud, expr, latent) -> (H, W, 3)`` on
    every rank, each tile's rows split over the mesh's 'ray' axis (the
    'data' axis replicates). ``tile`` must divide by the 'ray' axis."""
    _check_tile(tile, mesh)
    cfg = render_cfg.eval_mode()
    n = H * W
    n_pad = (-n) % tile

    @torch.no_grad()
    def render(params, pose, bc_img, aud=None, expr=None, latent=None):
        rows = tile_rows(n + n_pad, tile, mesh.n_ray, mesh.ray_index,
                         pose.device)
        ro, rd = _frame(H, W, focal, pose, cx, cy, n_pad)
        bc = _plate(bc_img, n_pad)
        out = render_field_rays(params, nerf_cfg, ro[rows], rd[rows],
                                bc[rows], near, far, cfg, aud, expr, latent)
        rgb = assemble_rows(out["rgb_map"], rows, n + n_pad, mesh.ray_group)
        return rgb[:n].reshape(H, W, 3)

    return render


def make_sharded_composite_renderer(head_cfg, torso_cfg, mesh, H: int,
                                    W: int, focal, near, far, render_cfg,
                                    cx=None, cy=None, tile: int = 8192):
    """``render(head_params, torso_params, pose, pose0, bc_img, aud,
    signal, expr, latent) -> (H, W, 3)``: the head + torso composite of
    ``eval.renderer.make_composite_frame_renderer`` with each tile's rows
    split over the 'ray' axis; head rays from ``pose``, torso rays from
    the fixed ``pose0``, both fields and the layering per ray."""
    _check_tile(tile, mesh)
    cfg = render_cfg.eval_mode()
    n = H * W
    n_pad = (-n) % tile

    @torch.no_grad()
    def render(head_params, torso_params, pose, pose0, bc_img, aud=None,
               signal=None, expr=None, latent=None):
        rows = tile_rows(n + n_pad, tile, mesh.n_ray, mesh.ray_index,
                         pose.device)
        bc = _plate(bc_img, n_pad)[rows]
        ho, hd = _frame(H, W, focal, pose, cx, cy, n_pad)
        to, td = _frame(H, W, focal, pose0, cx, cy, n_pad)
        head = render_field_rays(head_params, head_cfg, ho[rows], hd[rows],
                                 bc, near, far, cfg, aud, expr, latent)
        torso = render_field_rays(torso_params, torso_cfg, to[rows],
                                  td[rows], bc, near, far, cfg, signal)
        rgb = layered_composite(head["rgb_map"], torso["last_weight"],
                                torso["rgb_fg"])
        rgb = assemble_rows(rgb, rows, n + n_pad, mesh.ray_group)
        return rgb[:n].reshape(H, W, 3)

    return render


def make_sharded_video_renderer(nerf_cfg, mesh, H: int, W: int, focal, near,
                                far, render_cfg, cx=None, cy=None,
                                tile: int = 8192):
    """``render(params, poses (B, 3, 4), bc_img, auds (B, da), exprs (B,
    de), latents (B, dl)) -> (B, H, W, 3)`` on every rank: B frames over
    the 'data' axis (B divisible by it), each frame's rays over 'ray',
    each frame's conditioning riding with it."""
    _check_tile(tile, mesh)
    cfg = render_cfg.eval_mode()
    n = H * W
    n_pad = (-n) % tile

    @torch.no_grad()
    def render(params, poses, bc_img, auds=None, exprs=None, latents=None):
        B = poses.shape[0]
        frames = _my_frames(B, mesh)
        rows = tile_rows(n + n_pad, tile, mesh.n_ray, mesh.ray_index,
                         poses.device)
        bc = _plate(bc_img, n_pad)[rows]
        out = torch.zeros((B, n + n_pad, 3), device=poses.device)
        for b in frames:
            ro, rd = _frame(H, W, focal, poses[b], cx, cy, n_pad)
            res = render_field_rays(params, nerf_cfg, ro[rows], rd[rows], bc,
                                    near, far, cfg, _at(auds, b),
                                    _at(exprs, b), _at(latents, b))
            out[b, rows] = res["rgb_map"]
        dist.all_reduce(out)
        return out[:, :n].reshape(B, H, W, 3)

    return render


def make_sharded_composite_video_renderer(head_cfg, torso_cfg, mesh, H: int,
                                          W: int, focal, near, far,
                                          render_cfg, cx=None, cy=None,
                                          tile: int = 8192):
    """``render(head_params, torso_params, poses (B, 3, 4), pose0, bc_img,
    auds, signals, exprs, latents) -> (B, H, W, 3)``: the composite video,
    frames over 'data', rays over 'ray'. The torso rays come from the
    fixed ``pose0``, the same for every frame; only the torso's
    conditioning ``signals`` ride with the frames."""
    _check_tile(tile, mesh)
    cfg = render_cfg.eval_mode()
    n = H * W
    n_pad = (-n) % tile

    @torch.no_grad()
    def render(head_params, torso_params, poses, pose0, bc_img, auds=None,
               signals=None, exprs=None, latents=None):
        B = poses.shape[0]
        frames = _my_frames(B, mesh)
        rows = tile_rows(n + n_pad, tile, mesh.n_ray, mesh.ray_index,
                         poses.device)
        bc = _plate(bc_img, n_pad)[rows]
        to, td = (x[rows] for x in _frame(H, W, focal, pose0, cx, cy, n_pad))
        out = torch.zeros((B, n + n_pad, 3), device=poses.device)
        for b in frames:
            ho, hd = _frame(H, W, focal, poses[b], cx, cy, n_pad)
            head = render_field_rays(head_params, head_cfg, ho[rows],
                                     hd[rows], bc, near, far, cfg,
                                     _at(auds, b), _at(exprs, b),
                                     _at(latents, b))
            torso = render_field_rays(torso_params, torso_cfg, to, td, bc,
                                      near, far, cfg, _at(signals, b))
            out[b, rows] = layered_composite(
                head["rgb_map"], torso["last_weight"], torso["rgb_fg"])
        dist.all_reduce(out)
        return out[:, :n].reshape(B, H, W, 3)

    return render
