"""Full-frame rendering (counterpart of eval/renderer.py): the fused
"ray" frame and composite, the plain tiled frame, the depth-band probes,
the per-frame fast modes and the subject priors.

- ``make_frame_renderer`` / ``make_composite_frame_renderer``: a field's
  frame is one whole-frame call pair of the fused kernels (K2: the coarse
  pass with the importance depth placement, then K1: the fine pass) with
  no host-side tiling; the composite renders the head and the torso field
  so and layers them.
- ``render_frame`` / ``render_frame_outputs``: the plain hierarchical
  frame over ``core.render.render_rays`` and any field fns, swept over
  tiles of rays. The JAX package computes these in XLA outside its
  kernels, so here they are plain torch ops on any device; the depth-band
  probes (``subject_depth_range``, ``torso_depth_range``) run on them.
- The fast modes: ``make_pruned_frame_renderer`` (K1 coarse over all or
  the prior's rays, the fine pass on the top rays by coarse foreground
  opacity, each pass ONE K1 launch over its ray set), its field-fn
  counterparts ``render_frame_pruned`` / ``render_frame_prior_masked``,
  and ``make_composite_fast_renderer`` (per field K2 on its own prior
  rays, a keep ranking that skips head work the torso hides, K1 fine on
  the kept rays, the layered composite over the union of the priors).
- ``field_occupancy_prior`` cuts a geometric prior to where the trained
  coarse field carries foreground mass; ``cached_occupancy_prior`` and
  ``cached_depth_band`` keep such per-checkpoint constants beside it.

Ray selections follow ``jax.lax.top_k``'s order (ties lowest index
first) through a stable descending sort: ``torch.topk`` on CUDA promises
no order among ties, and empty rays score exactly 0.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from idealnerf_tpu_torch.core.composite import layered_composite, raw2outputs
from idealnerf_tpu_torch.core.rays import get_rays
from idealnerf_tpu_torch.core.render import RenderConfig, render_rays
from idealnerf_tpu_torch.core.sampling import stratified_sample
from idealnerf_tpu_torch.eval.temporal import _prior_sel
from idealnerf_tpu_torch.kernels.fused_render import (
    fused_render_coarse_hier, fused_render_rays, importance_depths,
    render_rays_fused,
)
from idealnerf_tpu_torch.models.face_nerf import (
    fold_conditioning, make_field_fn,
)
from idealnerf_tpu_torch.models.variants import (
    variant_conditioning, variant_nerf_config,
)
from idealnerf_tpu_torch.train.head import compute_aud_feature
from idealnerf_tpu_torch.train.torso import torso_nerf_config, torso_signal


def render_field_rays(params, nerf_cfg, rays_o, rays_d, bc, near, far,
                      cfg: RenderConfig, aud=None, expr=None,
                      latent=None) -> Dict[str, torch.Tensor]:
    """One field's render of the (R, 3) rays: fold the conditioning into
    each net's biases, run the fused passes (K2 then K1 on a CUDA device,
    their plain versions on the CPU). ``bc`` is the (R, 3) f32 plate."""
    fine = params["fine"] if "fine" in params else None
    folded_c = fold_conditioning(params["coarse"], nerf_cfg, aud, expr,
                                 latent)
    folded_f = (fold_conditioning(fine, nerf_cfg, aud, expr, latent)
                if fine is not None else None)
    return render_rays_fused(
        params["coarse"], folded_c, nerf_cfg, rays_o.contiguous(),
        rays_d.contiguous(), bc.contiguous(), near, far, cfg.n_samples,
        cfg.n_importance, fine_params=fine, fine_folded=folded_f,
        lindisp=cfg.lindisp)


def _render_field(params, nerf_cfg, H: int, W: int, focal, pose, bc,
                  near, far, cfg: RenderConfig, cx, cy, aud=None, expr=None,
                  latent=None) -> Dict[str, torch.Tensor]:
    """One field's whole-frame render from ``pose``, the rays cast on the
    pose's device. ``bc`` is the (H*W, 3) f32 plate."""
    rays_o, rays_d = get_rays(H, W, focal, pose, cx, cy)
    return render_field_rays(params, nerf_cfg, rays_o.reshape(-1, 3),
                             rays_d.reshape(-1, 3), bc, near, far, cfg, aud,
                             expr, latent)


def _plate(bc_img: torch.Tensor) -> torch.Tensor:
    return bc_img.reshape(-1, 3).float().contiguous()


def make_frame_renderer(
    nerf_cfg,
    H: int, W: int, focal, near, far, cfg: RenderConfig,
    cx=None, cy=None,
) -> Callable:
    """-> ``render(params, pose, bc_img, aud, expr, latent) -> (H, W, 3)``.

    ``params`` holds "coarse" and optionally "fine" FaceNeRF modules; the
    per-frame conditioning is folded into their biases, and the rays are
    built on the device of ``pose``. Deterministic eval semantics."""
    cfg = cfg.eval_mode()

    @torch.no_grad()
    def render(params, pose, bc_img, aud=None, expr=None, latent=None):
        out = _render_field(params, nerf_cfg, H, W, focal, pose,
                            _plate(bc_img), near, far, cfg, cx, cy, aud,
                            expr, latent)
        return out["rgb_map"].reshape(H, W, 3)

    return render


def make_composite_frame_renderer(
    head_cfg, torso_cfg,
    H: int, W: int, focal, near, far, cfg: RenderConfig,
    cx=None, cy=None,
) -> Callable:
    """-> ``render(head_params, torso_params, pose, pose0, bc_img, aud,
    signal, expr, latent) -> (H, W, 3)``: the head field from ``pose``
    (conditioned on aud, expr, latent) and the torso field from the fixed
    first-frame pose ``pose0`` (conditioned on the torso ``signal``), each
    a coarse + fine pass pair over the whole frame, layered as
    ``rgb_head · last_weight_torso + rgb_fg_torso``. Deterministic eval
    semantics."""
    cfg = cfg.eval_mode()

    @torch.no_grad()
    def render(head_params, torso_params, pose, pose0, bc_img, aud=None,
               signal=None, expr=None, latent=None):
        bc = _plate(bc_img)
        head = _render_field(head_params, head_cfg, H, W, focal, pose, bc,
                             near, far, cfg, cx, cy, aud, expr, latent)
        torso = _render_field(torso_params, torso_cfg, H, W, focal, pose0,
                              bc, near, far, cfg, cx, cy, signal)
        return layered_composite(head["rgb_map"].reshape(H, W, 3),
                                 torso["last_weight"].reshape(H, W),
                                 torso["rgb_fg"].reshape(H, W, 3))

    return render


# ------------------------------------------------------ the plain tiled frame

# fills of the padded rays of a tiled frame (rays_o, rays_d, plate)
_FRAME_FILLS = (1.0, (0.0, 0.0, -1.0), 0.0)


def _frame_rays(H: int, W: int, focal, pose, bc_img, cx, cy):
    """(rays_o, rays_d, plate), each (H*W, 3) f32 on the pose's device."""
    rays_o, rays_d = get_rays(H, W, focal, pose, cx, cy)
    return (rays_o.reshape(-1, 3).contiguous(),
            rays_d.reshape(-1, 3).contiguous(), _plate(bc_img))


def _over_tiles(fn, tile: int, args, fills):
    """``fn`` over consecutive ``tile``-row slices of ``args``, each padded
    with its fill (a scalar or a row) to a multiple of ``tile`` -> fn's
    output (a tensor or a tuple of them) concatenated and cut back to the
    rows given."""
    n = args[0].shape[0]
    pad = (-n) % tile
    if pad:
        args = [torch.cat([a, torch.as_tensor(f, dtype=a.dtype,
                                              device=a.device)
                           .expand((pad,) + a.shape[1:])])
                for a, f in zip(args, fills)]
    outs = [fn(*(a[s:s + tile] for a in args))
            for s in range(0, n + pad, tile)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(p)[:n] for p in zip(*outs))
    return torch.cat(outs)[:n]


@torch.no_grad()
def render_frame_outputs(
    coarse_fn, H: int, W: int, focal, pose, bc_img, near, far,
    cfg: RenderConfig, cx=None, cy=None, fine_fn=None, tile: int = 8192,
    keys=("rgb_map", "last_weight", "rgb_fg"),
) -> Dict[str, torch.Tensor]:
    """The plain hierarchical frame of ``coarse_fn`` (+ ``fine_fn``) from
    ``pose`` over ``tile``-ray slices -> {key: (H, W, ...)} of the
    ``render_rays`` outputs named by ``keys`` (``depth_band`` among them).
    Deterministic eval semantics; the last slice is padded with rays
    from (1, 1, 1) along -z over a black plate."""
    cfg = cfg.eval_mode()
    o, d, b = _frame_rays(H, W, focal, pose, bc_img, cx, cy)

    def tile_fn(oo, dd, bb):
        out = render_rays(coarse_fn, oo, dd, bb, near, far, cfg,
                          fine_fn=fine_fn)
        return tuple(out[k] for k in keys)

    outs = _over_tiles(tile_fn, tile, (o, d, b), _FRAME_FILLS)
    return {k: v.reshape((H, W) + v.shape[1:]) for k, v in zip(keys, outs)}


def render_frame(coarse_fn, H: int, W: int, focal, pose, bc_img, near, far,
                 cfg: RenderConfig, cx=None, cy=None, fine_fn=None,
                 tile: int = 8192) -> torch.Tensor:
    """The plain hierarchical (H, W, 3) frame (``render_frame_outputs``'
    rgb_map)."""
    return render_frame_outputs(coarse_fn, H, W, focal, pose, bc_img, near,
                                far, cfg, cx=cx, cy=cy, fine_fn=fine_fn,
                                tile=tile, keys=("rgb_map",))["rgb_map"]


# ------------------------------------------------------ depth-band probes

def cached_depth_band(cache_dir, field: str, step, compute_fn):
    """Memoize a tightened depth band in ``<cache_dir>/depth_bands.json``
    under the key ``"<field>@<step>"`` (the JAX package's file and keys,
    so a band file reads the same in both packages).

    The band is a per-subject, per-checkpoint constant
    (``subject_depth_range`` / ``torso_depth_range``) that costs a
    multi-frame full-fidelity probe; ``cache_dir`` should be the
    checkpoint directory, and ``None`` skips the cache. The file is
    replaced atomically; a directory that cannot be written only loses
    the cache."""
    if cache_dir is None:
        return tuple(float(v) for v in compute_fn())
    path = os.path.join(cache_dir, "depth_bands.json")
    key = f"{field}@{int(step)}"
    bands = {}
    try:
        with open(path) as fh:
            bands = json.load(fh)
    except (OSError, ValueError):
        pass
    if key in bands:
        return tuple(bands[key])
    band = tuple(float(v) for v in compute_fn())
    bands[key] = list(band)
    try:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(bands, fh, indent=2)
        os.replace(tmp, path)
    except OSError:
        pass
    return band


def _device_of(params) -> torch.device:
    return next(params.parameters()).device


def subject_depth_range(cfg, params, latent_codes, dataset,
                        n_frames: int = 4, fg_thresh: float = 0.5,
                        margin_frac: float = 0.05, compute_dtype=None):
    """Per-subject tightened sampling bounds ``(near', far')`` from the
    trained head's own depth maps, on the device of ``params``.

    Renders ``n_frames`` frames of ``dataset`` (evenly spaced) at full
    fidelity (at least 64 + 64 samples) through the plain frame, masks
    the foreground pixels (acc - last_weight > fg_thresh: acc alone
    includes the plate sample) and brackets the union of their
    ``depth_band`` intervals (the central 96 % of each ray's foreground
    weight), padded by ``margin_frac`` of ``[near, far]`` per side and
    clipped to it. ``compute_dtype`` casts the plain field (None: f32)."""
    head_cfg = variant_nerf_config(cfg)
    dev = _device_of(params)
    latent = latent_codes[0].to(dev) if cfg.dim_latent > 0 else None
    exprs = torch.from_numpy(np.asarray(dataset.exprs, np.float32)).to(dev)
    poses = torch.from_numpy(np.asarray(dataset.poses, np.float32)).to(dev)

    def field_fns(aud, i):
        expr = exprs[i] if cfg.dim_expr > 0 else None
        aud_arg, expr_arg = variant_conditioning(params, cfg, aud, expr)

        def mk(model):
            return make_field_fn(model, head_cfg, aud_arg, expr_arg, latent,
                                 compute_dtype=compute_dtype)

        return mk(params["coarse"]), mk(params["fine"]), poses[i]

    return _depth_range_probe(cfg, params, dataset, field_fns, n_frames,
                              fg_thresh, margin_frac)


def torso_depth_range(cfg, torso_params, head_params, dataset,
                      n_frames: int = 4, fg_thresh: float = 0.5,
                      margin_frac: float = 0.05, compute_dtype=None):
    """``subject_depth_range`` for the torso field: its rays are cast from
    the first frame's pose, its conditioning sweeps the torso signal over
    the probe frames (the audio features from the HEAD's audio net, as in
    training)."""
    tcfg = torso_nerf_config(cfg)
    dev = _device_of(head_params)
    poses = torch.from_numpy(np.asarray(dataset.poses, np.float32)).to(dev)

    def field_fns(aud, i):
        sig = torso_signal(aud, poses[i], cfg.dim_aud_body)

        def mk(model):
            return make_field_fn(model, tcfg, aud=sig,
                                 compute_dtype=compute_dtype)

        return mk(torso_params["coarse"]), mk(torso_params["fine"]), poses[0]

    return _depth_range_probe(cfg, head_params, dataset, field_fns,
                              n_frames, fg_thresh, margin_frac)


@torch.no_grad()
def _depth_range_probe(cfg, aud_params, dataset, field_fns, n_frames,
                       fg_thresh, margin_frac):
    """The band-union probe behind subject_depth_range and
    torso_depth_range. ``field_fns(aud_feature, frame_index) -> (coarse_fn,
    fine_fn, pose)``. Moves only what it reads to the device (audio,
    plate), never the frame images."""
    dev = _device_of(aud_params)
    H, W = dataset.hw
    bc = torch.from_numpy(np.asarray(dataset.bc_img)).to(dev).float() / 255.0
    auds = torch.from_numpy(np.asarray(dataset.auds, np.float32)).to(dev)
    aud_ids = torch.from_numpy(np.asarray(dataset.aud_ids)).long().to(dev)
    # full fidelity whatever the eval schedule: a coarse probe is noisy
    base = cfg.render_config()
    rcfg = dataclasses.replace(base, n_samples=max(base.n_samples, 64),
                               n_importance=max(base.n_importance, 64))
    lo, hi = [], []
    for i in np.linspace(0, dataset.size - 1, n_frames).astype(int):
        aud = compute_aud_feature(aud_params, auds, aud_ids, int(i), cfg,
                                  False)
        coarse_fn, fine_fn, pose = field_fns(aud, int(i))
        outs = render_frame_outputs(
            coarse_fn, H, W, dataset.focal, pose, bc, dataset.near,
            dataset.far, rcfg, cx=dataset.cx, cy=dataset.cy,
            tile=min(8192, H * W), fine_fn=fine_fn,
            keys=("acc_map", "last_weight", "depth_band"))
        fg = ((outs["acc_map"] - outs["last_weight"]) > fg_thresh).cpu()
        if not fg.any():
            continue
        band = outs["depth_band"].cpu()[fg]
        lo.append(float(band[:, 0].min()))
        hi.append(float(band[:, 1].max()))
    if not lo:
        return float(dataset.near), float(dataset.far)
    pad = margin_frac * (dataset.far - dataset.near)
    return (max(float(dataset.near), min(lo) - pad),
            min(float(dataset.far), max(hi) + pad))


# ------------------------------------------------------ per-frame fast modes

def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores, ties lowest index first:
    ``jax.lax.top_k``'s order (``torch.topk`` on CUDA promises none)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _mask_np(mask) -> np.ndarray:
    """A prior mask (numpy, or a tensor on any device) as a flat bool
    array."""
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return np.asarray(mask).reshape(-1).astype(bool)


def _prior_rays(mask, k: int) -> np.ndarray:
    """The first ``k`` rays of ``jax.lax.top_k`` over a 0/1 prior mask: the
    prior's pixels in index order, then the first pixels outside it."""
    return np.argsort(~_mask_np(mask), kind="stable")[:k].astype(np.int64)


def _fine_k(base: int, frac: float, cap: int) -> int:
    """A fine budget: ``frac`` of ``base`` rays clamped to ``cap``, rounded
    down to a multiple of 256 and at least 256 (the JAX package's k)."""
    k = min(int(base * frac), cap)
    return max(k - k % 256, 256)


def _check_keep_basis(keep_basis: str) -> None:
    if keep_basis not in ("frame", "mask"):
        raise ValueError(f"keep_basis must be 'frame' or 'mask', got "
                         f"{keep_basis!r}")


def _coarse_depths(near, far, cfg: RenderConfig, n: int, device):
    return stratified_sample(near, far, cfg.n_samples, n,
                             lindisp=cfg.lindisp, device=device)


def _tile_fns(coarse_fn, fine_fn, near, far, cfg: RenderConfig, fused=None):
    """(coarse_tile_fn, fine_tile_fn) of the pruned and masked frames.

    ``coarse_tile_fn(o, d, b) -> (rgb, weights, acc)`` at the coarse
    depths; ``fine_tile_fn(o, d, viewdirs, weights, b) -> rgb`` at the
    coarse depths merged with ``sample_pdf``'s importance depths from the
    coarse weights. ``fused=None``: the field fns through the plain
    renderer. ``fused=(params, nerf_cfg, folded_coarse, folded_fine)``: K1
    (``fused_render_rays``) for both passes, the depths placed by torch
    ops between them."""
    if fused is not None:
        params, nerf_cfg, folded_c, folded_f = fused

        def coarse_tile(o, d, b):
            z = _coarse_depths(near, far, cfg, o.shape[0], o.device)
            out = fused_render_rays(params["coarse"], folded_c, nerf_cfg, o,
                                    d, z, b)
            return out["rgb_map"], out["weights"], out["acc_map"]

        def fine_tile(o, d, vd, w, b):
            z = importance_depths(
                _coarse_depths(near, far, cfg, o.shape[0], o.device), w,
                cfg.n_importance)
            return fused_render_rays(params["fine"], folded_f, nerf_cfg, o,
                                     d, z, b)["rgb_map"]

        return coarse_tile, fine_tile

    coarse_cfg = RenderConfig(
        n_samples=cfg.n_samples, n_importance=0, perturb=False,
        lindisp=cfg.lindisp, density_activation=cfg.density_activation,
        white_bkgd=cfg.white_bkgd)

    def coarse_tile(o, d, b):
        out = render_rays(coarse_fn, o, d, b, near, far, coarse_cfg)
        return out["rgb_map"], out["weights"], out["acc_map"]

    def fine_tile(o, d, vd, w, b):
        z = importance_depths(
            _coarse_depths(near, far, cfg, o.shape[0], o.device), w,
            cfg.n_importance)
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        return raw2outputs(fine_fn(pts, vd), z, d, b,
                           density_activation=cfg.density_activation).rgb

    return coarse_tile, fine_tile


# fills of padded rays in the pruned passes: (o, d, b) and (o, d,
# viewdirs, weights, b)
_COARSE_FILLS = (1.0, -1.0, 0.0)
_FINE_FILLS = (1.0, -1.0, -1.0, 1.0, 0.0)


def _fine_pass(fine_tile_fn, tile: int, o, d, b, w):
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return _over_tiles(fine_tile_fn, tile, (o, d, vd, w, b), _FINE_FILLS)


@torch.no_grad()
def render_frame_pruned(
    coarse_fn, fine_fn, H: int, W: int, focal, pose, bc_img, near, far,
    cfg: RenderConfig, cx=None, cy=None, tile: int = 8192,
    keep_fraction: float = 0.45, fine_tile: int = 4096, fused=None,
) -> torch.Tensor:
    """Foreground-pruned hierarchical frame -> (H, W, 3).

    The coarse pass renders every ray; the fine pass only the top
    ``keep_fraction`` · H·W rays (rounded down to a multiple of 256, at
    least 256) by coarse foreground opacity (acc - last weight), whose
    fine colour is scattered over the coarse image: a dropped ray's fine
    result would equal its coarse one (both composite the plate). The
    field-fn route sweeps ``tile`` / ``fine_tile`` rays at a time; with
    ``fused`` (see ``_tile_fns``) each pass is one K1 launch."""
    cfg = cfg.eval_mode()
    o, d, b = _frame_rays(H, W, focal, pose, bc_img, cx, cy)
    n = o.shape[0]
    one_launch = fused is not None
    coarse_t, fine_t = _tile_fns(coarse_fn, fine_fn, near, far, cfg, fused)
    rgb_c, w_c, acc_c = _over_tiles(coarse_t, n if one_launch else tile,
                                    (o, d, b), _COARSE_FILLS)
    k = _fine_k(n, keep_fraction, n)
    keep = _top_k(acc_c - w_c[:, -1], k)
    rgb_f = _fine_pass(fine_t, k if one_launch
                       else min(fine_tile, max(256, k)),
                       o[keep], d[keep], b[keep], w_c[keep])
    return rgb_c.index_copy(0, keep, rgb_f).reshape(H, W, 3)


@torch.no_grad()
def render_frame_prior_masked(
    coarse_fn, fine_fn, H: int, W: int, focal, pose, bc_img, near, far,
    cfg: RenderConfig, prior_mask, k_coarse: int, cx=None, cy=None,
    keep_fraction: float = 0.5, coarse_tile: int = 4096,
    fine_tile: int = 4096, fused=None, keep_basis: str = "frame",
) -> torch.Tensor:
    """Prior-masked + opacity-pruned frame -> (H, W, 3).

    Rays outside the subject prior (an (H, W) bool mask, numpy or tensor)
    see no network: their trained composite is the plate. The coarse pass
    runs on ``k_coarse`` prior rays (the prior's pixels, padded with the
    first pixels outside it); the fine pass on the top ``keep_fraction``
    of ``keep_basis`` rays by coarse opacity: "frame" = keep·H·W (clamped
    to k_coarse; the unmasked pruned frame's absolute budget), "mask" =
    keep·k_coarse. Routes and tiles as ``render_frame_pruned``."""
    _check_keep_basis(keep_basis)
    cfg = cfg.eval_mode()
    o, d, b = _frame_rays(H, W, focal, pose, bc_img, cx, cy)
    n = o.shape[0]
    sel = torch.from_numpy(_prior_rays(prior_mask, k_coarse)).to(o.device)
    o_s, d_s, b_s = o[sel], d[sel], b[sel]
    one_launch = fused is not None
    coarse_t, fine_t = _tile_fns(coarse_fn, fine_fn, near, far, cfg, fused)
    rgb_c, w_c, acc_c = _over_tiles(coarse_t, k_coarse if one_launch
                                    else coarse_tile, (o_s, d_s, b_s),
                                    _COARSE_FILLS)
    k = _fine_k(n if keep_basis == "frame" else k_coarse, keep_fraction,
                k_coarse)
    keep = _top_k(acc_c - w_c[:, -1], k)
    rgb_f = _fine_pass(fine_t, k if one_launch else fine_tile, o_s[keep],
                       d_s[keep], b_s[keep], w_c[keep])
    # outside the prior the plate, on its rays the coarse composite, on
    # the kept rays the fine one
    img = b.index_copy(0, sel, rgb_c).index_copy(0, sel[keep], rgb_f)
    return img.reshape(H, W, 3)


def make_pruned_frame_renderer(
    nerf_cfg, H: int, W: int, focal, near, far, cfg: RenderConfig,
    cx=None, cy=None, keep_fraction: float = 0.4, prior_mask=None,
    k_coarse: Optional[int] = None, keep_basis: str = "frame",
) -> Callable:
    """Foreground-pruned (optionally prior-masked) frame on the fused
    kernels -> ``render(params, pose, bc_img, aud, expr, latent) -> (H, W,
    3)``, on the device of ``pose``.

    One K1 launch renders the coarse pass at ``n_samples`` depths over all
    rays, or over the ``k_coarse`` rays of ``prior_mask`` (as
    ``render_frame_prior_masked`` selects them); the fine budget is
    keep·H·W rays (``keep_basis`` "frame", clamped to the coarse set) or
    keep·k_coarse ("mask"), chosen by the score acc - last weight; the
    kept rays' importance depths come from ``sample_pdf`` on the coarse
    weights, and a second K1 launch renders them. The frame is the plate,
    then the coarse result over it, then the fine result over that; an
    empty prior (an occupancy cut of a field with no foreground mass)
    leaves the plate and launches nothing."""
    _check_keep_basis(keep_basis)
    cfg = cfg.eval_mode()
    n = H * W
    masked = prior_mask is not None
    n_coarse = min(n, k_coarse) if masked else n
    k = _fine_k(n if keep_basis == "frame" else n_coarse, keep_fraction,
                n_coarse)
    sel_np = _prior_rays(prior_mask, n_coarse) if masked else None

    @functools.lru_cache(maxsize=None)
    def sel_on(device):
        return torch.from_numpy(sel_np).to(device)

    @torch.no_grad()
    def render(params, pose, bc_img, aud=None, expr=None, latent=None):
        if n_coarse == 0:
            return _plate(bc_img).reshape(H, W, 3).clone()
        o, d, b = _frame_rays(H, W, focal, pose, bc_img, cx, cy)
        if masked:
            sel = sel_on(o.device)
            o_c, d_c, b_c = o[sel], d[sel], b[sel]
        else:
            o_c, d_c, b_c = o, d, b
        z = _coarse_depths(near, far, cfg, n_coarse, o.device)
        coarse = fused_render_rays(
            params["coarse"], fold_conditioning(params["coarse"], nerf_cfg,
                                                aud, expr, latent),
            nerf_cfg, o_c, d_c, z, b_c)
        keep = _top_k(coarse["acc_map"] - coarse["last_weight"], k)
        z_f = importance_depths(z[keep], coarse["weights"][keep],
                                cfg.n_importance)
        fine = fused_render_rays(
            params["fine"], fold_conditioning(params["fine"], nerf_cfg, aud,
                                              expr, latent),
            nerf_cfg, o_c[keep], d_c[keep], z_f, b_c[keep])
        if masked:
            img = b.index_copy(0, sel, coarse["rgb_map"]).index_copy(
                0, sel[keep], fine["rgb_map"])
        else:
            img = coarse["rgb_map"].index_copy(0, keep, fine["rgb_map"])
        return img.reshape(H, W, 3)

    return render


def make_composite_fast_renderer(
    head_cfg, torso_cfg, H: int, W: int, focal, near, far,
    cfg: RenderConfig, cx=None, cy=None, prior_mask=None,
    k_coarse: Optional[int] = None, keep_head: float = 0.4,
    keep_torso: float = 0.4, prior_mask_head=None, prior_mask_torso=None,
    bounds_head=None, bounds_torso=None, _expose_stages: bool = False,
    keep_basis: str = "frame",
) -> Callable:
    """Pruned + prior-masked head + torso composite -> ``render(head_params,
    torso_params, pose, pose0, bc_img, aud=None, signal=None, expr=None,
    latent=None) -> (H, W, 3)``, the signature of
    ``make_composite_frame_renderer``, on the device of ``pose``.

    Per field: K2 (the coarse pass with its importance depths) on the
    field's own rays within its own bounds (``bounds_head`` /
    ``bounds_torso``, default ``(near, far)``; the torso's rays cast from
    ``pose0``), then K1 on its kept rays at K2's depths. The rays: the
    per-field priors' (``prior_mask_head`` and ``prior_mask_torso``), or
    one shared ``prior_mask`` (its first ``k_coarse`` rays when given), or
    the whole frame; each prior's pixels padded with the first pixels
    outside it to a multiple of 256. The fine budgets are keep·H·W
    (``keep_basis`` "frame", clamped to the field's rays) or keep·|rays|
    ("mask"), rounded down to a multiple of 256; the head ranks its rays
    by acc - last weight times the torso's coarse transmittance at the
    same pixel (1 off the torso's rays), so head work the torso hides is
    skipped; the torso ranks by its own score. The frame is ``rgb_head ·
    last_weight_torso + rgb_fg_torso`` over the union of the fields' rays
    through constant index maps built once on the host (a union pixel
    off the head's rays takes the plate as head colour, off the torso's
    an empty torso), and the plate elsewhere.

    ``render.stages`` (with ``_expose_stages``) holds the stage functions
    and the selections, for timing each stage alone."""
    if cfg.n_importance < 2:
        # K2 places the importance depths itself (it needs two at least),
        # and the pruning assumes a fine pass exists
        raise ValueError(
            "make_composite_fast_renderer requires n_importance >= 2; "
            "use make_composite_frame_renderer for coarse-only configs")
    _check_keep_basis(keep_basis)
    cfg = cfg.eval_mode()
    n = H * W
    per_field = prior_mask_head is not None and prior_mask_torso is not None
    masked = per_field or prior_mask is not None
    if per_field:
        mh, mt = _mask_np(prior_mask_head), _mask_np(prior_mask_torso)
        sel_h, sel_t, sel_u = (_prior_sel(mh, n), _prior_sel(mt, n),
                               _prior_sel(mh | mt, n))
    elif masked:
        sel_u = (_prior_rays(prior_mask, min(n, k_coarse))
                 if k_coarse is not None else _prior_sel(_mask_np(prior_mask),
                                                         n))
        sel_h = sel_t = sel_u
    else:
        sel_h = sel_t = sel_u = np.arange(n)

    def budget(count, frac):
        base = n if keep_basis == "frame" else count
        k = min(int(base * frac), count)
        return max(k - k % 256, min(256, count))

    k_h, k_t = budget(len(sel_h), keep_head), budget(len(sel_t), keep_torso)

    def pos(sel):
        p = np.full(n, -1, np.int64)
        p[sel] = np.arange(len(sel))
        return p

    pos_h, pos_t = pos(sel_h), pos(sel_t)
    u2h, u2t, h2t = pos_h[sel_u], pos_t[sel_u], pos_t[sel_h]

    @functools.lru_cache(maxsize=None)
    def maps_on(device):
        def t(a):
            return torch.from_numpy(np.asarray(a)).to(device)
        return dict(sel_h=t(sel_h.astype(np.int64)),
                    sel_t=t(sel_t.astype(np.int64)),
                    sel_u=t(sel_u.astype(np.int64)),
                    h2t=t(h2t.clip(0)), on_t_h=t(h2t >= 0),
                    u2h=t(u2h.clip(0)), in_h=t(u2h >= 0)[:, None],
                    u2t=t(u2t.clip(0)), in_t=t(u2t >= 0))

    nf_head = (float(near), float(far)) if bounds_head is None else (
        float(bounds_head[0]), float(bounds_head[1]))
    nf_torso = (float(near), float(far)) if bounds_torso is None else (
        float(bounds_torso[0]), float(bounds_torso[1]))

    def stage_coarse(params, pose_f, bc_img, cond, is_torso=False):
        """One field's K2 launch on its own rays."""
        ncfg = torso_cfg if is_torso else head_cfg
        nf = nf_torso if is_torso else nf_head
        o, d, b = _frame_rays(H, W, focal, pose_f, bc_img, cx, cy)
        if masked:
            sel = maps_on(o.device)["sel_t" if is_torso else "sel_h"]
            o, d, b = o[sel], d[sel], b[sel]
        c, z = fused_render_coarse_hier(
            params["coarse"], fold_conditioning(params["coarse"], ncfg,
                                                *cond),
            ncfg, o, d, b, nf[0], nf[1], cfg.n_samples, cfg.n_importance)
        return dict(rgb=c["rgb_map"], acc=c["acc_map"], lw=c["last_weight"],
                    fg=c["rgb_fg"], z=z, o=o, d=d, b=b)

    def stage_keep(acc_h, lw_h, acc_t, lw_t):
        """The fine rays of each field: the head's score weighted by the
        torso's coarse transmittance at the same pixel."""
        m = maps_on(acc_h.device)
        lw_t_on_h = torch.where(m["on_t_h"], lw_t[m["h2t"]], 1.0)
        return (_top_k((acc_h - lw_h) * lw_t_on_h, k_h),
                _top_k(acc_t - lw_t, k_t))

    def stage_fine(params, st, keep, cond, is_torso=False):
        """One field's K1 launch on its kept rays at K2's depths."""
        ncfg = torso_cfg if is_torso else head_cfg
        out = fused_render_rays(
            params["fine"], fold_conditioning(params["fine"], ncfg, *cond),
            ncfg, st["o"][keep], st["d"][keep], st["z"][keep],
            st["b"][keep])
        return out["rgb_map"], out["last_weight"], out["rgb_fg"]

    def stage_composite(sh, st_, keep_h, keep_t, head_f, torso_f, bc_img):
        """The layered composite over the union of the fields' rays, the
        plate elsewhere."""
        rgb_h = sh["rgb"].index_copy(0, keep_h, head_f[0])
        lw_t = st_["lw"].index_copy(0, keep_t, torso_f[1])
        fg_t = st_["fg"].index_copy(0, keep_t, torso_f[2])
        plate = _plate(bc_img)
        m = maps_on(plate.device)
        if per_field:
            rgb_h = torch.where(m["in_h"], rgb_h[m["u2h"]],
                                plate[m["sel_u"]])
            lw_t = torch.where(m["in_t"], lw_t[m["u2t"]], 1.0)
            fg_t = torch.where(m["in_t"][:, None], fg_t[m["u2t"]], 0.0)
        comp = layered_composite(rgb_h, lw_t, fg_t)
        img = plate.index_copy(0, m["sel_u"], comp) if masked else comp
        return img.reshape(H, W, 3)

    @torch.no_grad()
    def render(head_params, torso_params, pose, pose0, bc_img, aud=None,
               signal=None, expr=None, latent=None):
        if "fine" not in head_params or "fine" not in torso_params:
            raise ValueError(
                "composite fast mode needs 'fine' params in both fields "
                "(coarse-only checkpoints: use the full-fidelity "
                "composite renderer)")
        cond_h, cond_t = (aud, expr, latent), (signal, None, None)
        sh = stage_coarse(head_params, pose, bc_img, cond_h)
        st_ = stage_coarse(torso_params, pose0, bc_img, cond_t, is_torso=True)
        keep_h, keep_t = stage_keep(sh["acc"], sh["lw"], st_["acc"],
                                    st_["lw"])
        head_f = stage_fine(head_params, sh, keep_h, cond_h)
        torso_f = stage_fine(torso_params, st_, keep_t, cond_t,
                             is_torso=True)
        return stage_composite(sh, st_, keep_h, keep_t, head_f, torso_f,
                               bc_img)

    if _expose_stages:
        render.stages = dict(coarse=stage_coarse, keep=stage_keep,
                             fine=stage_fine, composite=stage_composite,
                             sel_h=sel_h, sel_t=sel_t, sel_u=sel_u)
    return render


# ------------------------------------------------------ subject priors

def _head_support(dataset, margin: int, head_parse: bool) -> np.ndarray:
    """The union of the frames' face rects grown by ``margin``; under
    ``head_parse`` each rect is replaced by the parse silhouette clipped
    to it, where that silhouette covers at least 10 % of the rect."""
    H, W = dataset.hw
    mask = np.zeros((H, W), bool)
    parse = (np.asarray(dataset.torso_masks).astype(bool)
             if head_parse else None)
    for i in range(dataset.size):
        x, y, w, h = [int(v) for v in dataset.face_rects[i]]
        y0, y1 = max(y - margin, 0), min(y + h + margin, H)
        x0, x1 = max(x - margin, 0), min(x + w + margin, W)
        rect = np.zeros((H, W), bool)
        rect[y0:y1, x0:x1] = True
        if parse is not None:
            sil = parse[i] & rect
            if sil.sum() >= 0.10 * rect.sum():
                mask |= sil
                continue
        mask |= rect
    return mask


def foreground_prior_fields(dataset, margin: int = 12,
                            head_parse: bool = False):
    """Per-field subject priors for the temporal composite -> (mask_head,
    mask_torso), (H, W) bools: the head's support is the union of the
    face rects (``head_parse`` as in ``foreground_prior``), the torso's
    the union of the torso masks, each dilated by ``margin`` pixels.
    Outside its own support a trained field is empty (the head composites
    the plate, the torso transmits), so each field renders only its own
    prior's rays."""
    from scipy.ndimage import binary_dilation

    mask_h = binary_dilation(_head_support(dataset, margin, head_parse),
                             iterations=margin)
    mask_t = binary_dilation(dataset.torso_masks.any(0).astype(bool),
                             iterations=margin)
    return mask_h, mask_t


def foreground_prior(dataset, margin: int = 12, head_parse: bool = False):
    """Subject foreground prior for masked rendering: the union of all
    frames' face rects and torso masks, dilated by ``margin`` pixels ->
    (mask (H, W) bool, k) with k the mask's pixel count padded to a
    multiple of 256 (at most H*W).

    ``head_parse``: replace each frame's face-rect box by the parse
    silhouette clipped to it, where that silhouette covers at least 10 %
    of the box."""
    from scipy.ndimage import binary_dilation

    H, W = dataset.hw
    mask = _head_support(dataset, margin, head_parse)
    mask |= dataset.torso_masks.any(0).astype(bool)
    mask = binary_dilation(mask, iterations=margin)
    k = int(mask.sum())
    k = min(H * W, ((k + 255) // 256) * 256)
    return mask, k


def _on(x, device) -> torch.Tensor:
    """A numpy array or tensor as an f32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


@torch.no_grad()
def field_occupancy_prior(nerf_cfg, params, H: int, W: int, focal, poses,
                          conds, near, far, cfg: RenderConfig, base_mask,
                          cx=None, cy=None, thresh: float = 1e-3,
                          margin: int = 6, tile: int = 8192,
                          compute_dtype=None, latent=None):
    """Zero-foreground-mass ray cut -> (mask (H, W) bool within
    ``base_mask``, k_coarse = its pixel count padded to a multiple of 256).

    The plain coarse pass of ``params["coarse"]`` renders ``base_mask``'s
    rays for each probe frame (``poses`` and ``conds``, per-probe (aud,
    expr) conditioning features; ``latent`` shared), on the device of
    ``params``. A ray stays where its foreground weight mass (the plate
    sample excluded) exceeds ``thresh`` on any probe; the kept set is
    dilated by ``margin`` pixels and intersected with ``base_mask``. By
    the plate-composite construction a ray with no foreground mass
    composites the plate, so the cut is exact up to ``thresh``."""
    from scipy.ndimage import binary_dilation

    base = _mask_np(base_mask)
    sel = np.nonzero(base)[0]
    pad = (-len(sel)) % 256
    if pad:
        sel = np.concatenate([sel, np.repeat(sel[-1:], pad)])
    ccfg = RenderConfig(
        n_samples=cfg.n_samples, n_importance=0, perturb=False,
        lindisp=cfg.lindisp, density_activation=cfg.density_activation,
        white_bkgd=False)
    model = params["coarse"]
    dev = _device_of(params)
    sel_t = torch.from_numpy(sel).to(dev)
    nrays = len(sel)
    t = min(tile, nrays)
    t -= t % 256
    if nrays % t:
        t = nrays

    mass = None
    for pose_f, (aud, expr) in zip(poses, conds):
        cf = make_field_fn(model, nerf_cfg, aud, expr, latent,
                           compute_dtype=compute_dtype)
        o, d = get_rays(H, W, focal, _on(pose_f, dev), cx, cy)
        o, d = o.reshape(-1, 3)[sel_t], d.reshape(-1, 3)[sel_t]
        b = torch.zeros_like(o)
        m = torch.cat([
            render_rays(cf, o[s:s + t], d[s:s + t], b[s:s + t], near, far,
                        ccfg)["weights"][..., :-1].sum(-1)
            for s in range(0, nrays, t)])
        mass = m if mass is None else torch.maximum(mass, m)
    occ = np.zeros(H * W, bool)
    occ[sel] = mass.cpu().numpy() > thresh
    occ = binary_dilation(occ.reshape(H, W), iterations=margin)
    occ &= base.reshape(H, W)
    k = int(occ.sum())
    return occ, min(H * W, ((k + 255) // 256) * 256)


def _hash_arrays(h, *xs) -> None:
    for x in xs:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.ascontiguousarray(x if x is not None else np.zeros(0))
        h.update(f"{x.dtype}{x.shape}".encode())
        h.update(x.tobytes())


def cached_occupancy_prior(cache_dir, step, compute_fn, *, base_mask, poses,
                           conds, near, far, thresh: float = 1e-3,
                           margin: int = 6, latent=None):
    """``field_occupancy_prior`` memoized beside the checkpoint in
    ``<cache_dir>/occ_prior_<step>_<key>.npy`` -> (mask, k_coarse).

    ``key`` hashes every input of the probe besides the checkpoint: the
    base mask (so the prior variant, ``head_parse`` or not), the probe
    frames' poses and conditioning, the bounds, ``thresh``, ``margin`` and
    the latent. Pass the values ``compute_fn`` uses. (The JAX package
    keys its file on the step alone, so a changed threshold or prior
    reads a stale mask.) ``cache_dir=None`` skips the cache."""
    if cache_dir is None:
        return compute_fn()
    h = hashlib.sha256()
    h.update(repr((float(near), float(far), float(thresh),
                   int(margin))).encode())
    _hash_arrays(h, np.asarray(tuple(base_mask.shape)), _mask_np(base_mask),
                 latent, *poses, *(c for cond in conds for c in cond))
    path = os.path.join(cache_dir,
                        f"occ_prior_{int(step)}_{h.hexdigest()[:16]}.npy")
    if os.path.exists(path):
        occ = np.load(path)
        k = int(occ.sum())
        return occ, min(occ.size, ((k + 255) // 256) * 256)
    occ, k = compute_fn()
    try:
        np.save(path, occ)
    except OSError:
        pass
    return occ, k
