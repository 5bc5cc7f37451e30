"""Temporal depth-cache video renderers, head only and head + torso
(counterpart of eval/temporal.py).

A talking-head video is one mostly static surface: between consecutive
frames each pixel's depth moves by a few pixels laterally and a small
fraction of the depth interval axially. Only KEYFRAMES pay the full
hierarchical schedule (the coarse kernel with its depth placement, then
the fine kernel, on the prior rays). In-between DELTA frames resample
each ray inside a narrow per-ray depth band carried over from the
previous frame: ``s_delta - 1`` depths (inverse-CDF draws over the
previous frame's weights plus uniform band coverage) and the plate pin
at the field's far, in one launch of the delta kernel, which also
returns the next frame's band. The band is padded, floored, spatially
dilated so rays the subject moves into inherit their neighbours' band,
and clipped.

Every delta frame with ``kf_blend == 0`` and at least two uniform and two
importance depths is one launch of ``fused_render_delta``; the others
(``kf_blend > 0``, or ``s_delta < 5``) place their depths with torch ops
and render through ``fused_render_rays``, the JAX package's own chain.

``delta_keep < 1`` re-renders only the keyframe's top rays by dilated
foreground mass; ``dilate_every = k`` dilates on every k-th delta frame
only; ``roll_k = K`` (serving) replaces the keyframe spikes after frame 0
by a refresh of 1/K of the rays on every frame.

The composite (``make_temporal_composite_renderer``) runs one such
pipeline per field, the torso's from the fixed first-frame pose, and
layers them over the union of the fields' rays. The torso has two modes
of its own: ``freeze_z`` (its delta frames re-render the keyframe's own
depth grid with the fine kernel) and ``roll_k_torso`` (no delta pass: every
frame refreshes 1/K of its rays at the keyframe schedule). ``render.cycle``
renders a run of delta frames as a loop of per-frame calls: the scanned
program it replaces saved TPU dispatches.
"""

from __future__ import annotations

import functools
import types
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.core.composite import fg_band, layered_composite
from idealnerf_tpu_torch.core.rays import get_rays
from idealnerf_tpu_torch.kernels.fused_render import (
    delta_depths, fused_render_coarse_hier, fused_render_delta,
    fused_render_rays, pdf_depths,
)
from idealnerf_tpu_torch.models.face_nerf import fold_conditioning

__all__ = ["check_roll_k", "dilate_bands", "fg_band",
           "make_temporal_composite_renderer", "make_temporal_frame_renderer"]


def _window2d(grid: torch.Tensor, k: int, op: str) -> torch.Tensor:
    """(k, k) max or min window with SAME padding (k odd)."""
    g = grid[None, None]
    if op == "min":
        return -F.max_pool2d(-g, k, stride=1, padding=k // 2)[0, 0]
    return F.max_pool2d(g, k, stride=1, padding=k // 2)[0, 0]


def dilate_bands(lo, hi, valid, sel, H: int, W: int, radius: int,
                 fb_lo: float, fb_hi: float):
    """Spatially dilate per-ray bands over the image grid.

    Valid rays scatter their band into the (H, W) grid; each ``sel`` pixel
    then takes the min-lo / max-hi over a (2r+1)² window, so a ray the
    subject is about to move into inherits its neighbours' band. Pixels
    with no valid ray in the window fall back to ``[fb_lo, fb_hi]``."""
    big = 1e10
    glo = torch.full((H * W,), big, dtype=torch.float32, device=lo.device)
    ghi = torch.full((H * W,), -big, dtype=torch.float32, device=lo.device)
    glo[sel] = torch.where(valid, lo, big)
    ghi[sel] = torch.where(valid, hi, -big)
    k = 2 * radius + 1
    lo_d = _window2d(glo.reshape(H, W), k, "min").reshape(-1)[sel]
    hi_d = _window2d(ghi.reshape(H, W), k, "max").reshape(-1)[sel]
    ok = lo_d < big * 0.5
    return torch.where(ok, lo_d, fb_lo), torch.where(ok, hi_d, fb_hi)


def _prior_sel(mask, n: int) -> np.ndarray:
    """Ray selection for a prior mask: prior rays first (stable order),
    padded with the next pixels to a multiple of 256."""
    m = np.asarray(mask).reshape(-1).astype(bool)
    k = min(n, ((int(m.sum()) + 255) // 256) * 256)
    return np.argsort(~m, kind="stable")[:k].astype(np.int32)


def _field_pipeline(ncfg, H, W, focal, cx, cy, cfg, nf, sel, s_delta,
                    band_pad_frac, min_band_frac, dilate_px, fg_thresh, tag,
                    delta_keep: float = 1.0, uni_frac: float = 0.25,
                    kf_blend: float = 0.0, freeze_z: bool = False,
                    dilate_every: int = 1, roll_k: int = 0):
    """Per-field temporal stages: ``run(params, pose, bc_img, cond, band)
    -> (rgb, last_weight, rgb_fg, new_band)`` on the field's ``sel`` rays.
    ``band=None`` renders the keyframe, otherwise a delta frame.

    Cache layouts (as the JAX package's): unpruned, the tuple (lo, hi, z,
    w [, kz, kw][, i]) — the keyframe's (z, w) anchor only under
    ``kf_blend``, the delta-frame counter only under ``dilate_every > 1``;
    pruned, a dict in kept-ray space that also holds the full-length
    rendered outputs; rolling, see ``run.roll``.

    ``freeze_z`` (the torso field, whose rays come from a fixed pose): a
    delta frame re-renders the keyframe's own depth grid with the fine
    kernel, and the cache passes through unchanged."""
    sel_np = np.asarray(sel).astype(np.int64)
    _cx = W * 0.5 if cx is None else cx
    _cy = H * 0.5 if cy is None else cy
    rows = (sel_np // W).astype(np.float32)
    cols = (sel_np % W).astype(np.float32)
    # static camera-space directions of this field's rays (get_rays'
    # formula restricted to sel): delta frames rotate them by the pose
    dirs_np = np.stack([(cols - _cx) / focal, -(rows - _cy) / focal,
                        -np.ones_like(cols)], axis=-1)

    @functools.lru_cache(maxsize=None)
    def consts(device):
        return (torch.from_numpy(sel_np).to(device),
                torch.from_numpy(dirs_np).to(device))

    def _rotate(dirs, pose):
        # explicit f32 multiply-adds, as core.rays.get_rays: a delta frame
        # at the keyframe's pose sees the keyframe's rays
        rot = pose[:3, :3].float()
        d = (dirs[:, 0:1] * rot[:, 0] + dirs[:, 1:2] * rot[:, 1]
             + dirs[:, 2:3] * rot[:, 2])
        return pose[:3, -1].float().expand(d.shape).contiguous(), d

    def _rays_sel(pose, idx=None):
        dirs = consts(pose.device)[1]
        return _rotate(dirs if idx is None else dirs[idx], pose)

    def _plate(bc_img, idx=None):
        sel_t = consts(bc_img.device)[0]
        return bc_img.reshape(-1, 3)[sel_t if idx is None else sel_t[idx]]

    def stage_kf_coarse(params, pose, bc_img, cond):
        """Keyframe coarse pass + depth placement on the field's rays."""
        folded = fold_conditioning(params["coarse"], ncfg, *cond)
        sel_t = consts(pose.device)[0]
        o, d = get_rays(H, W, focal, pose, cx, cy)
        o, d = o.reshape(-1, 3)[sel_t], d.reshape(-1, 3)[sel_t]
        b = _plate(bc_img)
        _, z_all = fused_render_coarse_hier(
            params["coarse"], folded, ncfg, o, d, b, nf[0], nf[1],
            cfg.n_samples, cfg.n_importance)
        return dict(o=o, d=d, b=b, z=z_all)

    def _widen(lo, hi):
        """Pad a band by band_pad_frac of the field interval on each
        side, then widen it about its middle to min_band_frac at least."""
        span = nf[1] - nf[0]
        pad = band_pad_frac * span
        lo, hi = lo - pad, hi + pad
        width = torch.clamp(hi - lo, min=min_band_frac * span)
        mid = 0.5 * (lo + hi)
        return mid - 0.5 * width, mid + 0.5 * width

    def _band_update(z, weights, sel_scatter=None, do_dilate=None,
                     prev_lo=None, prev_hi=None, lohimass=None):
        """Next-frame cache from this frame's depths and weights: central
        band -> pad -> width floor -> dilate -> clip, plus the raw (z, w)
        the next delta frame draws its importance depths from.
        ``do_dilate`` False (dilate_every > 1 frames) skips the spatial
        dilation and invalid rays carry ``prev_lo``/``prev_hi``.
        ``lohimass``: (lo, hi, mass) already computed by the delta
        kernel."""
        lo, hi, mass = (lohimass if lohimass is not None
                        else fg_band(z, weights))
        valid = mass > fg_thresh
        lo, hi = _widen(lo, hi)
        if do_dilate is None or do_dilate:
            sscat = consts(z.device)[0] if sel_scatter is None else sel_scatter
            lo, hi = dilate_bands(lo, hi, valid, sscat, H, W, dilate_px,
                                  nf[0], nf[1])
        else:
            lo = torch.where(valid, lo, prev_lo)
            hi = torch.where(valid, hi, prev_hi)
        return (torch.clamp(lo, nf[0], nf[1]), torch.clamp(hi, nf[0], nf[1]),
                z.float(), weights.float())

    def _fine(params, o, d, z, b, cond):
        folded = fold_conditioning(params["fine"], ncfg, *cond)
        out = fused_render_rays(params["fine"], folded, ncfg, o, d, z, b)
        return (out["rgb_map"], out["last_weight"], out["rgb_fg"],
                out["weights"])

    def _fine_delta(params, o, d, z_prev, w_prev, lo, hi, b, cond):
        """The whole delta frame in one launch of the delta kernel."""
        folded = fold_conditioning(params["fine"], ncfg, *cond)
        out = fused_render_delta(params["fine"], folded, ncfg, o, d, z_prev,
                                 w_prev, lo, hi, b, nf[1], s_uni, s_imp)
        return (out["rgb_map"], out["last_weight"], out["rgb_fg"],
                out["weights"], out["z_vals"],
                (out["band_lo"], out["band_hi"], out["fg_mass"]))

    # delta-frame budget: s_delta - 1 in-band depths + the plate pin
    n_in = s_delta - 1
    s_uni = max(2, int(n_in * uni_frac))
    s_imp = n_in - s_uni
    s_kf = (min(s_imp - 1, max(1, int(round(s_imp * kf_blend))))
            if kf_blend > 0 else 0)
    s_prev = s_imp - s_kf
    # a frozen grid is the keyframe's (z, w): the delta kernel would read
    # it as the previous frame's band draw
    use_kd = s_kf == 0 and s_imp >= 2 and s_uni >= 2 and not freeze_z
    counted = dilate_every > 1

    def _delta_depths(lo, hi, z_prev, w_prev, kz=None, kw=None):
        extra = pdf_depths(kz, kw, s_kf) if s_kf else None
        return delta_depths(z_prev, w_prev, lo, hi, nf[1], s_uni, s_prev,
                            extra)

    def _delta(params, o, d, b, cond, lo_p, hi_p, z_prev, w_prev, kz, kw,
               sel_scatter, do_dil):
        """One delta frame on the given rays -> outputs + band update."""
        if use_kd:
            rgb, lw, fg, w, z, lhm = _fine_delta(params, o, d, z_prev, w_prev,
                                                 lo_p, hi_p, b, cond)
        else:
            z = _delta_depths(lo_p, hi_p, z_prev, w_prev, kz, kw)
            rgb, lw, fg, w = _fine(params, o, d, z, b, cond)
            lhm = None
        band = _band_update(z, w, sel_scatter=sel_scatter, do_dilate=do_dil,
                            prev_lo=lo_p, prev_hi=hi_p, lohimass=lhm)
        return rgb, lw, fg, band

    def _tick(i):
        i = i + 1
        return i, (i % dilate_every) == 0

    def stage_kf_fine(params, st, cond):
        """Keyframe fine pass over the merged depths + band init."""
        rgb, lw, fg, w = _fine(params, st["o"], st["d"], st["z"], st["b"],
                               cond)
        band = _band_update(st["z"], w)
        if s_kf:  # anchor distribution for the cycle's delta frames
            band = band + (st["z"].float(), w.float())
        if counted:
            band = band + (0,)
        return rgb, lw, fg, band

    def stage_delta(params, pose, bc_img, cond, band):
        """A delta frame on all of the field's rays."""
        i, do_dil = None, None
        if counted:
            band, i = band[:-1], band[-1]
            i, do_dil = _tick(i)
        lo_p, hi_p, z_prev, w_prev = band[:4]
        kz, kw = (band[4], band[5]) if s_kf else (None, None)
        tail = ((kz, kw) if s_kf else ()) + ((i,) if counted else ())
        o, d = _rays_sel(pose)
        if freeze_z:
            rgb, lw, fg, _ = _fine(params, o, d, z_prev, _plate(bc_img), cond)
            return rgb, lw, fg, (lo_p, hi_p, z_prev, w_prev) + tail
        rgb, lw, fg, new = _delta(params, o, d, _plate(bc_img), cond, lo_p,
                                  hi_p, z_prev, w_prev, kz, kw, None, do_dil)
        return rgb, lw, fg, new + tail

    n_sel = int(sel_np.shape[0])
    k_keep = min(n_sel, max(256, (int(n_sel * delta_keep) // 256) * 256))
    pruned = delta_keep < 1.0 and k_keep < n_sel

    def _top_mass(mass):
        """The k_keep rays of largest foreground mass, max-dilated over the
        image window. A stable descending sort takes tied rays in index
        order, as jax.lax.top_k does."""
        sel_t = consts(mass.device)[0]
        grid = torch.zeros(H * W, dtype=torch.float32, device=mass.device)
        grid[sel_t] = mass.float()
        grid = _window2d(grid.reshape(H, W), 2 * dilate_px + 1, "max")
        score = grid.reshape(-1)[sel_t]
        return torch.sort(score, descending=True, stable=True)[1][:k_keep]

    def stage_select(weights):
        """Keyframe ray selection for the delta cycle."""
        return _top_mass(weights[..., :-1].sum(-1))

    def stage_cache_init(keep_idx, rgb, lw, fg, band):
        """Kept-space cache from the keyframe's full-frame outputs."""
        lo, hi, z, w = band[:4]
        out = dict(keep=keep_idx, lo=lo[keep_idx], hi=hi[keep_idx],
                   z=z[keep_idx], w=w[keep_idx], rgb=rgb, lw=lw, fg=fg)
        if s_kf:
            out["kz"] = band[4][keep_idx]
            out["kw"] = band[5][keep_idx]
        if counted:
            out["i"] = 0
        return out

    def stage_delta_pruned(params, pose, bc_img, cond, cache):
        """A delta frame on the kept rays only; the other rays hold the
        keyframe's rendered values."""
        keep_idx = cache["keep"]
        sel_kept = consts(pose.device)[0][keep_idx]
        o, d = _rays_sel(pose, keep_idx)
        if freeze_z:
            rgb_k, lw_k, fg_k, _ = _fine(params, o, d, cache["z"],
                                         _plate(bc_img, keep_idx), cond)
            new = dict(cache,
                       rgb=cache["rgb"].index_copy(0, keep_idx, rgb_k),
                       lw=cache["lw"].index_copy(0, keep_idx, lw_k),
                       fg=cache["fg"].index_copy(0, keep_idx, fg_k))
            return new["rgb"], new["lw"], new["fg"], new
        i, do_dil = None, None
        if counted:
            i, do_dil = _tick(cache["i"])
        rgb_k, lw_k, fg_k, (lo, hi, zf, wf) = _delta(
            params, o, d, _plate(bc_img, keep_idx), cond, cache["lo"],
            cache["hi"], cache["z"], cache["w"], cache.get("kz"),
            cache.get("kw"), sel_kept, do_dil)
        new = dict(keep=keep_idx, lo=lo, hi=hi, z=zf, w=wf,
                   rgb=cache["rgb"].index_copy(0, keep_idx, rgb_k),
                   lw=cache["lw"].index_copy(0, keep_idx, lw_k),
                   fg=cache["fg"].index_copy(0, keep_idx, fg_k))
        if s_kf:
            new["kz"], new["kw"] = cache["kz"], cache["kw"]
        if counted:
            new["i"] = i
        return new["rgb"], new["lw"], new["fg"], new

    def run(params, pose, bc_img, cond, band):
        if band is None:
            st = stage_kf_coarse(params, pose, bc_img, cond)
            rgb, lw, fg, kf_band = stage_kf_fine(params, st, cond)
            if not pruned:
                return rgb, lw, fg, kf_band
            keep_idx = stage_select(kf_band[3])
            return rgb, lw, fg, stage_cache_init(keep_idx, rgb, lw, fg,
                                                 kf_band)
        if pruned:
            return stage_delta_pruned(params, pose, bc_img, cond, band)
        return stage_delta(params, pose, bc_img, cond, band)

    roll = None
    if roll_k and roll_k > 1:
        # rolling keyframe refresh (serving): after frame 0 every frame
        # runs the delta pass plus the full schedule on slice p of the
        # rays — rows {p, K+p, 2K+p, ...} of sel — so a ray's refresh age
        # is at most K frames and no frame pays a whole keyframe
        if s_kf:
            raise ValueError("rolling refresh does not compose with "
                             "kf_blend (there is no keyframe CDF to "
                             "anchor on)")
        if n_sel % roll_k:
            raise ValueError(f"rolling refresh needs len(sel) divisible "
                             f"by roll_k ({n_sel} % {roll_k})")
        m_roll = n_sel // roll_k

        def _downsample_zw(z, w):
            """Keyframe-width (z, w) -> the cache's s_delta width: depths
            at evenly spaced quantiles carry equal mass, so (z', uniform
            w') keeps the CDF the delta draw consumes; plate pin last."""
            zq = pdf_depths(z, w, s_delta - 1)
            mass = w[..., :-1].sum(-1, keepdim=True)
            wq = (mass / (s_delta - 1)).expand(zq.shape)
            z2 = torch.cat([zq, torch.full_like(zq[:, :1], nf[1])], -1)
            w2 = torch.cat([wq, torch.clamp(1.0 - mass, 0.0, 1.0)], -1)
            return z2.float().contiguous(), w2.float().contiguous()

        def stage_roll_init(rgb, lw, fg, band_kf):
            """Full-length rolling cache from the frame-0 keyframe;
            ``keep`` is filled by the caller."""
            lo, hi, z_kf, w_kf = band_kf[:4]
            z2, w2 = _downsample_zw(z_kf, w_kf)
            return dict(lo=lo, hi=hi, z=z2, w=w2, rgb=rgb, lw=lw, fg=fg,
                        mass=w_kf[..., :-1].sum(-1), i=0)

        def stage_roll_delta(params, pose, bc_img, cond, cache):
            """The frame's delta pass on the kept rays, full-length
            cache layout."""
            keep_idx = cache["keep"]
            o, d = _rays_sel(pose, keep_idx)
            i = cache["i"] + 1

            def put(name, v):
                return cache[name].index_copy(0, keep_idx, v)

            if freeze_z:
                rgb_k, lw_k, fg_k, _ = _fine(
                    params, o, d, cache["z"][keep_idx],
                    _plate(bc_img, keep_idx), cond)
                return dict(cache, i=i, rgb=put("rgb", rgb_k),
                            lw=put("lw", lw_k), fg=put("fg", fg_k))
            lo_p, hi_p = cache["lo"][keep_idx], cache["hi"][keep_idx]
            do_dil = None if dilate_every == 1 else (i % dilate_every) == 0
            rgb_k, lw_k, fg_k, (lo, hi, zf, wf) = _delta(
                params, o, d, _plate(bc_img, keep_idx), cond, lo_p, hi_p,
                cache["z"][keep_idx], cache["w"][keep_idx], None, None,
                consts(pose.device)[0][keep_idx], do_dil)
            return dict(keep=keep_idx, i=i, lo=put("lo", lo),
                        hi=put("hi", hi), z=put("z", zf), w=put("w", wf),
                        mass=put("mass", wf[..., :-1].sum(-1)),
                        rgb=put("rgb", rgb_k), lw=put("lw", lw_k),
                        fg=put("fg", fg_k))

        def stage_roll_slice_coarse(params, pose, bc_img, cond, phase):
            """Coarse pass + depth placement on refresh slice ``phase``:
            the keyframe schedule on 1/K of the rays."""
            folded = fold_conditioning(params["coarse"], ncfg, *cond)
            dirs = consts(pose.device)[1]
            o, d = _rotate(dirs.reshape(m_roll, roll_k, 3)[:, phase], pose)
            b = _plate(bc_img).reshape(m_roll, roll_k, 3)[:, phase]
            b = b.contiguous()
            _, z_all = fused_render_coarse_hier(
                params["coarse"], folded, ncfg, o, d, b, nf[0], nf[1],
                cfg.n_samples, cfg.n_importance)
            return dict(o=o, d=d, b=b, z=z_all)

        def stage_roll_slice_fine(params, st, cond):
            """Fine pass over the slice's merged depths + the slice's
            refreshed cache rows (no spatial dilation: the delta pass
            keeps dilating at its own cadence)."""
            rgb, lw, fg, w = _fine(params, st["o"], st["d"], st["z"],
                                   st["b"], cond)
            lo, hi, mass = fg_band(st["z"], w)
            valid = mass > fg_thresh
            lo, hi = _widen(lo, hi)
            lo = torch.where(valid, lo, nf[0])
            hi = torch.where(valid, hi, nf[1])
            z2, w2 = _downsample_zw(st["z"], w)
            return dict(rgb=rgb, lw=lw, fg=fg,
                        lo=torch.clamp(lo, nf[0], nf[1]),
                        hi=torch.clamp(hi, nf[0], nf[1]),
                        z=z2, w=w2, mass=mass, valid=valid)

        def stage_roll_merge(cache, sl, phase):
            """Scatter the refreshed slice into the cache through the
            (m, K) strided view. A slice ray that found no foreground
            mass keeps its previous band."""
            def upd(full, block, valid=None):
                v = full.reshape(m_roll, roll_k, *full.shape[1:]).clone()
                if valid is not None:
                    block = torch.where(valid, block, v[:, phase])
                v[:, phase] = block
                return v.reshape(full.shape)

            new = dict(cache)
            for k in ("z", "w", "mass", "rgb", "lw", "fg"):
                new[k] = upd(cache[k], sl[k])
            new["lo"] = upd(cache["lo"], sl["lo"], sl["valid"])
            new["hi"] = upd(cache["hi"], sl["hi"], sl["valid"])
            return new

        roll = types.SimpleNamespace(
            k=roll_k, init=stage_roll_init, select=_top_mass,
            delta=stage_roll_delta, slice_coarse=stage_roll_slice_coarse,
            slice_fine=stage_roll_slice_fine, merge=stage_roll_merge,
            pruned_sel=pruned)

    run.tag = tag
    run.kf_coarse = stage_kf_coarse
    run.kf_fine = stage_kf_fine
    run.roll = roll
    run.uses_delta_kernel = use_kd
    return run


def _check_schedule(cfg, s_delta: int) -> None:
    if cfg.n_importance < 2:
        raise ValueError(
            "temporal renderers require n_importance >= 2 (keyframes "
            "use the in-kernel hierarchical path)")
    if s_delta < 4:
        raise ValueError("s_delta must be >= 4")


def _pad_sel_for_roll(sel_np: np.ndarray, roll_k: int) -> np.ndarray:
    """Pad a ray selection to a multiple of roll_k by repeating its last
    ray, so the (m, K) strided slice view is exact. A duplicated ray
    renders exactly as its original, so the scatter of either copy
    writes the same value."""
    r = (-len(sel_np)) % roll_k
    if r:
        sel_np = np.concatenate(
            [sel_np, np.repeat(sel_np[-1:], r)]).astype(np.int32)
    return sel_np


def _roll_frame(field, params, pose, bc_img, cond, cache):
    """One rolling-refresh frame of one field. Frame 0 (``cache=None``)
    is the keyframe + cache init; every later frame is the delta pass +
    the phase-th slice's full-schedule refresh + merge, with the
    delta_keep ranking re-run each time the comb wraps."""
    roll = field.roll
    if cache is None:
        st = field.kf_coarse(params, pose, bc_img, cond)
        rgb, lw, fg, band = field.kf_fine(params, st, cond)
        dev = roll.init(rgb, lw, fg, band)
        dev["keep"] = (roll.select(dev["mass"]) if roll.pruned_sel
                       else torch.arange(rgb.shape[0], device=rgb.device))
        return rgb, lw, fg, {"dev": dev, "phase": 0}
    dev, phase = cache["dev"], cache["phase"]
    dev = roll.delta(params, pose, bc_img, cond, dev)
    st = roll.slice_coarse(params, pose, bc_img, cond, phase)
    dev = roll.merge(dev, roll.slice_fine(params, st, cond), phase)
    nphase = (phase + 1) % roll.k
    if nphase == 0 and roll.pruned_sel:
        dev = dict(dev, keep=roll.select(dev["mass"]))
    return dev["rgb"], dev["lw"], dev["fg"], {"dev": dev, "phase": nphase}


def _roll_refresh_frame(field, params, pose, bc_img, cond, cache):
    """One refresh-only rolling frame of one field (the composite's torso
    under ``roll_k_torso``): no delta pass; the phase-th 1/K comb of the
    rays is re-rendered at the keyframe schedule and every other ray
    carries its cached outputs, so no ray's conditioning is more than K
    frames old. Frame 0 (``cache=None``) is the keyframe + cache init."""
    roll = field.roll
    if cache is None:
        st = field.kf_coarse(params, pose, bc_img, cond)
        rgb, lw, fg, band = field.kf_fine(params, st, cond)
        return rgb, lw, fg, {"dev": roll.init(rgb, lw, fg, band), "phase": 0}
    dev, phase = cache["dev"], cache["phase"]
    st = roll.slice_coarse(params, pose, bc_img, cond, phase)
    dev = roll.merge(dev, roll.slice_fine(params, st, cond), phase)
    return dev["rgb"], dev["lw"], dev["fg"], {"dev": dev,
                                              "phase": (phase + 1) % roll.k}


def check_roll_k(name: str, k) -> int:
    """A rolling-refresh period: 0 (off) or at least 2 (a field builds no
    rolling stages for K = 1)."""
    k = int(k or 0)
    if k == 1 or k < 0:
        raise ValueError(f"{name} must be 0 (off) or >= 2, got {k}")
    return k


def make_temporal_frame_renderer(
    nerf_cfg,
    H: int, W: int, focal, near, far, cfg,
    cx=None, cy=None,
    prior_mask=None, bounds=None,
    s_delta: int = 32,
    band_pad_frac: float = 0.02,
    min_band_frac: float = 0.04,
    dilate_px: int = 4,
    fg_thresh: float = 0.2,
    delta_keep: float = 1.0,
    uni_frac: float = 0.25,
    kf_blend: float = 0.0,
    dilate_every: int = 1,
    roll_k: int = 0,
):
    """Single-field (head-only) temporal depth-cache renderer.

    Returns ``render(params, pose, bc_img, aud=None, expr=None,
    latent=None, cache=None) -> (frame (H, W, 3), cache)`` on the device
    of ``pose``. ``cache=None`` renders a keyframe; a previous cache
    renders a delta frame. Outside ``prior_mask`` the frame is the plate.
    ``roll_k > 1`` enables rolling refresh: after frame 0 the caller keeps
    passing the previous cache, and every frame pays a delta frame plus
    1/roll_k of a keyframe. ``render.cycle(params, poses, bc_img, cache,
    auds=None, exprs=None, latents=None) -> (frames, cache)`` renders T
    delta frames as T per-frame calls."""
    roll_k = check_roll_k("roll_k", roll_k)
    _check_schedule(cfg, s_delta)
    cfg = cfg.eval_mode()
    n = H * W
    masked = prior_mask is not None
    sel_np = (_prior_sel(prior_mask, n) if masked
              else np.arange(n, dtype=np.int32))
    if roll_k:
        sel_np = _pad_sel_for_roll(sel_np, roll_k)
    nf = tuple(bounds) if bounds is not None else (float(near), float(far))
    nf = (float(nf[0]), float(nf[1]))

    field = _field_pipeline(nerf_cfg, H, W, focal, cx, cy, cfg, nf, sel_np,
                            s_delta, band_pad_frac, min_band_frac, dilate_px,
                            fg_thresh, tag="head", delta_keep=delta_keep,
                            uni_frac=uni_frac, kf_blend=kf_blend,
                            dilate_every=dilate_every, roll_k=roll_k)
    # roll padding can make len(sel) != H*W even unmasked: scatter through
    # sel whenever it is not the identity
    scatter_sel = masked or len(sel_np) != n

    @functools.lru_cache(maxsize=None)
    def sel_on(device):
        # kept on the device: a host copy per frame would wait for the
        # frame's kernels before the assembly could be queued
        return torch.from_numpy(sel_np.astype(np.int64)).to(device)

    def assemble(rgb, bc_img):
        if not scatter_sel:
            return rgb.reshape(H, W, 3)
        plate = bc_img.reshape(-1, 3).float()
        return plate.index_copy(0, sel_on(plate.device), rgb).reshape(H, W, 3)

    @torch.no_grad()
    def render(params, pose, bc_img, aud=None, expr=None, latent=None,
               cache=None):
        if "fine" not in params:
            raise ValueError("temporal rendering needs 'fine' params")
        cond = (aud, expr, latent)
        if roll_k:
            rgb, _, _, cache = _roll_frame(field, params, pose, bc_img,
                                           cond, cache)
            return assemble(rgb, bc_img), cache
        rgb, _, _, band = field(params, pose, bc_img, cond, cache)
        return assemble(rgb, bc_img), band

    def cycle(params, poses, bc_img, cache, auds=None, exprs=None,
              latents=None):
        """``T`` delta frames from a delta frame's ``cache``; ``poses`` and
        the conditioning carry a leading frame axis -> (frames (T, H, W,
        3), cache), those of T per-frame calls."""
        frames = []
        for t in range(_cycle_len(poses, cache)):
            aud, expr, latent = _at(t, auds, exprs, latents)
            frame, cache = render(params, poses[t], bc_img, aud=aud,
                                  expr=expr, latent=latent, cache=cache)
            frames.append(frame)
        return torch.stack(frames), cache

    render.cycle = cycle
    render.field = field
    return render


def _at(t: int, *xs):
    """Frame ``t`` of each per-frame tensor (None stays None)."""
    return tuple(None if x is None else x[t] for x in xs)


def _cycle_len(poses, cache) -> int:
    if cache is None:
        raise ValueError("render.cycle renders delta frames: pass the cache "
                         "of a keyframe or of a delta frame")
    return int(poses.shape[0])


def make_temporal_composite_renderer(
    head_cfg, torso_cfg,
    H: int, W: int, focal, near, far, cfg,
    cx=None, cy=None,
    prior_mask_head=None, prior_mask_torso=None,
    bounds_head=None, bounds_torso=None,
    s_delta: int = 32,
    band_pad_frac: float = 0.02,
    min_band_frac: float = 0.04,
    dilate_px: int = 4,
    fg_thresh: float = 0.2,
    delta_keep_head: float = 1.0,
    delta_keep_torso: float = 1.0,
    s_delta_torso: Optional[int] = None,
    uni_frac: float = 0.25,
    kf_blend: float = 0.0,
    freeze_z_torso: bool = False,
    dilate_every: int = 1,
    roll_k: int = 0,
    roll_k_torso: int = 0,
):
    """Head + torso temporal depth-cache renderer.

    Returns ``render(head_params, torso_params, pose, pose0, bc_img,
    aud=None, signal=None, expr=None, latent=None, cache=None) -> (frame
    (H, W, 3), cache)`` on the device of ``pose``; ``cache`` is
    ``{"head": ..., "torso": ...}``. The head field renders from ``pose``
    (conditioned on aud, expr, latent), the torso field from the fixed
    first-frame pose ``pose0`` (conditioned on ``signal``), each on its own
    prior's rays (``prior_mask_head``, ``prior_mask_torso``; both or
    neither) within its own ``bounds_*`` (default ``(near, far)``), and
    the frame is ``rgb_head · last_weight_torso + rgb_fg_torso`` over the
    union of the priors and the plate outside it. ``cache=None`` renders a
    keyframe; the caller passes ``None`` again to refresh.

    Per field: ``s_delta_torso`` (default ``s_delta``) and
    ``delta_keep_*``; ``freeze_z_torso`` re-renders the torso keyframe's
    depth grid on delta frames. ``roll_k = K`` rolls both fields' refresh
    (no keyframe after frame 0); ``roll_k_torso = K`` keeps the head's
    keyframe cycle and gives the torso a refresh-only roll with no delta
    pass (``_roll_refresh_frame``). The two are exclusive, and each is 0 or
    at least 2.

    ``render.cycle(head_params, torso_params, poses, pose0, bc_img, cache,
    auds=None, signals=None, exprs=None, latents=None) -> (frames, cache)``
    renders T delta frames as T per-frame calls (refused under
    ``roll_k_torso``); ``render.stages`` holds the head and torso field
    pipelines and the composite stage."""
    roll_k = check_roll_k("roll_k", roll_k)
    roll_k_torso = check_roll_k("roll_k_torso", roll_k_torso)
    if roll_k and roll_k_torso:
        raise ValueError("roll_k (both fields) and roll_k_torso (torso-only "
                         "refresh roll) are exclusive")
    _check_schedule(cfg, s_delta)
    s_delta_torso = s_delta if s_delta_torso is None else int(s_delta_torso)
    _check_schedule(cfg, s_delta_torso)
    cfg = cfg.eval_mode()
    n = H * W

    if prior_mask_head is not None and prior_mask_torso is not None:
        mh = np.asarray(prior_mask_head).reshape(-1).astype(bool)
        mt = np.asarray(prior_mask_torso).reshape(-1).astype(bool)
        sel_h, sel_t = _prior_sel(mh, n), _prior_sel(mt, n)
        sel_u = _prior_sel(mh | mt, n)
        masked = True
    else:
        sel_h = sel_t = sel_u = np.arange(n, dtype=np.int32)
        masked = False
    if roll_k or roll_k_torso:
        # pad the per-field selections only: the union maps key off pixel
        # ids, so a duplicated row resolves to its pixel's last position.
        # Padded field outputs are longer than H*W, so the composite then
        # goes through the maps even when unmasked.
        if roll_k:
            sel_h = _pad_sel_for_roll(sel_h, roll_k)
        sel_t = _pad_sel_for_roll(sel_t, roll_k or roll_k_torso)
        masked = masked or len(sel_h) != n or len(sel_t) != n

    def _pos(sel):
        """Pixel id -> the field's last row on it (-1 off the field). Built
        on the host: a CUDA index assignment with duplicates has no
        order."""
        p = np.full(n, -1, np.int64)
        np.maximum.at(p, sel.astype(np.int64), np.arange(len(sel)))
        return p[sel_u]

    u2h, u2t = _pos(sel_h), _pos(sel_t)

    @functools.lru_cache(maxsize=None)
    def maps_on(device):
        t = [torch.from_numpy(a).to(device) for a in
             (sel_u.astype(np.int64), u2h.clip(0), u2t.clip(0))]
        return (*t, torch.from_numpy(u2h >= 0).to(device)[:, None],
                torch.from_numpy(u2t >= 0).to(device))

    nf_head = (float(near), float(far)) if bounds_head is None else (
        float(bounds_head[0]), float(bounds_head[1]))
    nf_torso = (float(near), float(far)) if bounds_torso is None else (
        float(bounds_torso[0]), float(bounds_torso[1]))
    kb = (band_pad_frac, min_band_frac, dilate_px, fg_thresh)
    view = (H, W, focal, cx, cy, cfg)
    head = _field_pipeline(head_cfg, *view, nf_head, sel_h, s_delta, *kb,
                           tag="head", delta_keep=delta_keep_head,
                           uni_frac=uni_frac, kf_blend=kf_blend,
                           dilate_every=dilate_every, roll_k=roll_k)
    torso = _field_pipeline(torso_cfg, *view, nf_torso, sel_t, s_delta_torso,
                            *kb, tag="torso", delta_keep=delta_keep_torso,
                            uni_frac=uni_frac, kf_blend=kf_blend,
                            freeze_z=freeze_z_torso,
                            dilate_every=dilate_every,
                            roll_k=roll_k or roll_k_torso)

    def stage_composite(rgb_h, lw_t, fg_t, bc_img):
        """Layered composite over the union rays; outside both priors the
        frame is the plate."""
        if not masked:
            return layered_composite(rgb_h, lw_t, fg_t).reshape(H, W, 3)
        plate = bc_img.reshape(-1, 3).float()
        sel_u_t, h_idx, t_idx, in_h, in_t = maps_on(plate.device)
        rgb = torch.where(in_h, rgb_h[h_idx], plate[sel_u_t])
        lw = torch.where(in_t, lw_t[t_idx], 1.0)
        fg = torch.where(in_t[:, None], fg_t[t_idx], 0.0)
        return plate.index_copy(0, sel_u_t, layered_composite(
            rgb, lw, fg)).reshape(H, W, 3)

    @torch.no_grad()
    def render(head_params, torso_params, pose, pose0, bc_img, aud=None,
               signal=None, expr=None, latent=None, cache=None):
        if "fine" not in head_params or "fine" not in torso_params:
            raise ValueError("temporal composite needs 'fine' params in "
                             "both fields")
        c_h, c_t = (None, None) if cache is None else (cache["head"],
                                                       cache["torso"])
        cond_h, cond_t = (aud, expr, latent), (signal, None, None)
        if roll_k:
            rgb_h, _, _, c_h = _roll_frame(head, head_params, pose, bc_img,
                                           cond_h, c_h)
            _, lw_t, fg_t, c_t = _roll_frame(torso, torso_params, pose0,
                                             bc_img, cond_t, c_t)
        else:
            rgb_h, _, _, c_h = head(head_params, pose, bc_img, cond_h, c_h)
            if roll_k_torso:
                _, lw_t, fg_t, c_t = _roll_refresh_frame(
                    torso, torso_params, pose0, bc_img, cond_t, c_t)
            else:
                _, lw_t, fg_t, c_t = torso(torso_params, pose0, bc_img,
                                           cond_t, c_t)
        frame = stage_composite(rgb_h, lw_t, fg_t, bc_img)
        return frame, {"head": c_h, "torso": c_t}

    def cycle(head_params, torso_params, poses, pose0, bc_img, cache,
              auds=None, signals=None, exprs=None, latents=None):
        """``T`` delta frames from a delta frame's ``cache``; ``poses`` and
        the conditioning carry a leading frame axis -> (frames (T, H, W,
        3), cache), those of T per-frame calls."""
        if roll_k_torso:
            raise RuntimeError(
                "render.cycle is unavailable with roll_k_torso (the torso's "
                "refresh roll has no delta frame); use per-frame render "
                "calls")
        frames = []
        for t in range(_cycle_len(poses, cache)):
            aud, signal, expr, latent = _at(t, auds, signals, exprs, latents)
            frame, cache = render(head_params, torso_params, poses[t], pose0,
                                  bc_img, aud=aud, signal=signal, expr=expr,
                                  latent=latent, cache=cache)
            frames.append(frame)
        return torch.stack(frames), cache

    render.cycle = cycle
    render.stages = {"head": head, "torso": torso,
                     "composite": stage_composite}
    return render
