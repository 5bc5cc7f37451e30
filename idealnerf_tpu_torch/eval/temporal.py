"""Temporal depth-cache video renderer for the head field (counterpart of
eval/temporal.py).

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

The torso field's parts — ``freeze_z``, ``make_temporal_composite_
renderer`` — and the scanned keyframe cycle (``render.cycle``, used by
eval/reenact.py) belong to ROADMAP.md A7b and raise NotImplementedError.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.core.composite import fg_band
from idealnerf_tpu_torch.core.rays import get_rays
from idealnerf_tpu_torch.kernels.fused_render import (
    delta_depths, fused_render_coarse_hier, fused_render_delta,
    fused_render_rays, pdf_depths,
)
from idealnerf_tpu_torch.models.face_nerf import fold_conditioning

_A7 = "ROADMAP.md A7b: temporal composite video"

__all__ = ["dilate_bands", "fg_band", "make_temporal_composite_renderer",
           "make_temporal_frame_renderer"]


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
    rendered outputs; rolling, see ``run.roll``."""
    if freeze_z:
        raise NotImplementedError(
            f"freeze_z is the torso field's delta mode ({_A7})")
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
    use_kd = s_kf == 0 and s_imp >= 2 and s_uni >= 2
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
            lo_p, hi_p = cache["lo"][keep_idx], cache["hi"][keep_idx]
            do_dil = None if dilate_every == 1 else (i % dilate_every) == 0
            rgb_k, lw_k, fg_k, (lo, hi, zf, wf) = _delta(
                params, o, d, _plate(bc_img, keep_idx), cond, lo_p, hi_p,
                cache["z"][keep_idx], cache["w"][keep_idx], None, None,
                consts(pose.device)[0][keep_idx], do_dil)

            def put(name, v):
                return cache[name].index_copy(0, keep_idx, v)

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
    1/roll_k of a keyframe."""
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

    def _no_cycle(*args, **kwargs):
        raise NotImplementedError(
            "the scanned keyframe cycle (render.cycle) serves "
            f"eval/reenact.py, not ported yet ({_A7})")

    render.cycle = _no_cycle
    render.field = field
    return render


def make_temporal_composite_renderer(*args, **kwargs):
    """Head + torso temporal renderer: not ported yet."""
    raise NotImplementedError(
        f"make_temporal_composite_renderer is not ported yet ({_A7})")
