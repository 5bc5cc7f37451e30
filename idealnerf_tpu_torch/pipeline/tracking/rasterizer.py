"""Differentiable soft mesh rasterizer + SH-9 illumination (counterpart of
pipeline/tracking/rasterizer.py; reference: the pytorch3d path of
data_util/face_tracking/render_3dmm.py:32-77 SoftSimpleShader and
:80-191 Render_3DMM).

The JAX module's design, in torch ops:

1. **Tile binning** (integer work, no gradients): each face's padded
   screen bbox is expanded into a fixed ``span x span`` block of
   candidate tiles; (tile, face) pairs are sorted by tile id with a
   STABLE sort (``jnp.argsort`` is stable; which faces a full tile keeps,
   and so the ``overflow`` count, depend on it) and ranked within their
   tile, then scattered into a ``(n_tiles+1, max_faces_per_tile)`` table.
   Faces past a tile's capacity are dropped and counted in ``overflow``.
2. **Hard face selection** (no gradients): per pixel, every candidate
   face of its tile is tested (inside-or-within-blur via the signed
   point-triangle distance) and the ``faces_per_pixel`` nearest by depth
   are kept, the first of equal depths first (``jax.lax.top_k``'s rule,
   through a stable descending sort). Only the bin columns that some
   tile fills are tested (the rest hold the sentinel, which never hits),
   and the tiles run in chunks of at most
   ``SELECT_PAIRS`` (pixel, candidate) pairs, so a BFM-scale mesh at 450²
   never builds its whole (tiles x pixels x capacity) tensor, as the JAX
   module bounds it with ``lax.map`` over tile rows.
3. **Differentiable re-evaluation**: barycentrics, depth, attribute
   interpolation and the signed distance are recomputed from the selected
   faces' vertices with gradients attached (the nvdiffrast recipe).
4. **Softmax blending**: pytorch3d's ``softmax_rgb_blend`` (sigmoid edge
   alpha, depth-softmax color weights, background delta term).

Distances are measured in NDC units (2/min(H,W) per pixel) so the
reference's sigma/gamma/blur constants (render_3dmm.py:122-128) carry
over unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# pytorch3d BlendParams defaults, as instantiated by the reference
# (render_3dmm.py:122-129): sigma=1e-4, gamma=1e-4, black background.
DEFAULT_SIGMA = 1e-4
DEFAULT_GAMMA = 1e-4
# raster_settings.blur_radius = log(1/1e-4 - 1) * sigma / 18 (:125)
DEFAULT_BLUR = float(np.log(1.0 / 1e-4 - 1.0) * DEFAULT_SIGMA / 18.0)
SELECT_PAIRS = 1 << 23   # (pixel, candidate face) pairs per selection chunk


class RasterConfig(NamedTuple):
    height: int
    width: int
    tile: int = 16                  # pixels per tile side
    max_faces_per_tile: int = 128   # bin capacity (overflow reported)
    span: int = 5                   # max tile-span of a face bbox per axis
    faces_per_pixel: int = 2        # K (reference uses 2, :126)
    sigma: float = DEFAULT_SIGMA
    gamma: float = DEFAULT_GAMMA
    blur_radius: float = DEFAULT_BLUR   # NDC^2 units, like pytorch3d
    znear: float = 0.01
    zfar: float = 20.0

    @classmethod
    def bfm(cls, height: int, width: int) -> "RasterConfig":
        """Tuning for BFM-scale tracking (34.5k vertices / ~69k
        triangles at 450-512² — face_tracker.py:37-53): 8-px tiles,
        capacity 256 (zero overflow with headroom at 450²), span 3. Below
        450² the per-tile face density grows as (450/min_side)², and the
        capacity with it."""
        density = max(1.0, (450.0 / max(min(height, width), 1)) ** 2)
        cap = int(-(-256 * density // 8) * 8)
        return cls(height=height, width=width, tile=8,
                   max_faces_per_tile=cap, span=3)


def _ndc_scale(cfg: RasterConfig) -> float:
    """Pixel -> NDC unit conversion (pytorch3d: short side spans 2)."""
    return 2.0 / min(cfg.height, cfg.width)


def _tiles(cfg: RasterConfig) -> Tuple[int, int]:
    return -(-cfg.height // cfg.tile), -(-cfg.width // cfg.tile)


def _take(t: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``t`` indexed by ``idx`` along ``dim``, through ``index_select``:
    its backward is an index-add, where the backward of ``t[idx]`` on the
    card serializes the gradient rows of repeated indices (every pixel
    slot without a face repeats the pad row)."""
    out = t.index_select(dim, idx.reshape(-1))
    return out.reshape(t.shape[:dim] + idx.shape + t.shape[dim + 1:])


# --------------------------------------------------------------- binning


@torch.no_grad()
def bin_faces(face_xy: torch.Tensor, face_z: torch.Tensor,
              cfg: RasterConfig, pad_px: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, 3, 2) pixel-space face vertices -> ((n_tiles+1, M) int64 face
    ids, overflow count). F is the empty sentinel; faces behind the camera
    (any z <= znear) are discarded."""
    f = face_xy.shape[0]
    dev = face_xy.device
    ty, tx = _tiles(cfg)
    n_tiles = ty * tx

    xmin = face_xy[..., 0].amin(1) - pad_px
    xmax = face_xy[..., 0].amax(1) + pad_px
    ymin = face_xy[..., 1].amin(1) - pad_px
    ymax = face_xy[..., 1].amax(1) + pad_px
    valid = torch.all(face_z > cfg.znear, dim=1)
    valid &= ((xmax >= 0) & (ymax >= 0) & (xmin < cfg.width)
              & (ymin < cfg.height))

    def tile_of(v, hi):
        return torch.floor(v / cfg.tile).clamp(0, hi - 1).long()

    tx0, tx1 = tile_of(xmin, tx), tile_of(xmax, tx)
    ty0, ty1 = tile_of(ymin, ty), tile_of(ymax, ty)

    # fixed span x span block anchored at (ty0, tx0); offsets beyond the
    # true range go to the dump row n_tiles
    off = torch.arange(cfg.span, device=dev)
    gy = ty0[:, None] + off[None, :]                     # (F, S)
    gx = tx0[:, None] + off[None, :]
    ok = ((gy <= ty1[:, None])[:, :, None] & (gx <= tx1[:, None])[:, None, :]
          & valid[:, None, None])
    tile_id = torch.where(ok, gy[:, :, None] * tx + gx[:, None, :],
                          n_tiles).reshape(-1)
    face_id = torch.arange(f, device=dev)[:, None, None].expand(
        f, cfg.span, cfg.span).reshape(-1)

    st, order = torch.sort(tile_id, stable=True)
    sf = face_id[order]
    first = torch.searchsorted(st, st, side="left")
    rank = torch.arange(st.shape[0], device=dev) - first
    m = cfg.max_faces_per_tile
    keep = (st < n_tiles) & (rank < m)
    overflow = torch.sum((st < n_tiles) & (rank >= m))
    bins = torch.full((n_tiles + 1, m), f, dtype=torch.long, device=dev)
    bins[st[keep], rank[keep]] = sf[keep]
    return bins, overflow


# ---------------------------------------------------- per-pixel geometry


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: max then min, so a value at a bound passes half its
    gradient, as JAX's max and min do at ties (``torch.clamp`` passes
    all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _edge_dist2(p, a, b):
    """Squared distance from points p to segment ab. p (..., 2)."""
    ab = b - a
    t = torch.sum((p - a) * ab, -1) / (torch.sum(ab * ab, -1) + 1e-12)
    t = _clip(t, 0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    return torch.sum(d * d, -1)


def _barycentrics(p, v0, v1, v2):
    """Screen-space barycentrics of p wrt triangle (v0,v1,v2); (..., 3),
    signed edge functions over the signed area (orientation free)."""
    def ef(a, b):
        return (p[..., 0] - a[..., 0]) * (b[..., 1] - a[..., 1]) - (
            p[..., 1] - a[..., 1]) * (b[..., 0] - a[..., 0])
    w0 = ef(v1, v2)
    w1 = ef(v2, v0)
    w2 = ef(v0, v1)
    area = w0 + w1 + w2
    tiny = torch.where(area < 0, -1e-12, 1e-12)
    area = torch.where(torch.abs(area) < 1e-12, tiny, area)
    return torch.stack([w0, w1, w2], -1) / area[..., None]


def _signed_dist2(p, v0, v1, v2, bary):
    """pytorch3d-style signed squared point-triangle distance in the
    units of p (negative inside)."""
    d2 = torch.minimum(
        _edge_dist2(p, v0, v1),
        torch.minimum(_edge_dist2(p, v1, v2), _edge_dist2(p, v2, v0)))
    inside = torch.all(bary >= 0.0, dim=-1)
    return torch.where(inside, -d2, d2)


@torch.no_grad()
def _select(bins, face_xy_p, face_z_p, cfg: RasterConfig, f: int,
            blur_pix2: float) -> torch.Tensor:
    """Hard K-selection per pixel -> (H, W, K) face ids (f = none)."""
    dev = face_xy_p.device
    ty, tx = _tiles(cfg)
    ts, k, m = cfg.tile, cfg.faces_per_pixel, cfg.max_faces_per_tile
    py, px = torch.meshgrid(torch.arange(ts, device=dev) + 0.5,
                            torch.arange(ts, device=dev) + 0.5,
                            indexing="ij")
    local = torch.stack([px, py], -1).reshape(-1, 2)          # (P, 2)
    # a row fills from column 0, so past the fullest tile's count every
    # column is the sentinel, which never hits: test only the used ones
    m = min(m, max(k, int((bins[:-1] < f).sum(1).max())))
    bins = bins[:, :m]
    chunk = max(1, SELECT_PAIRS // (ts * ts * m))
    out = []
    for lo in range(0, ty * tx, chunk):
        tiles = torch.arange(lo, min(lo + chunk, ty * tx), device=dev)
        cand = bins[tiles]                                     # (T, M)
        corner = torch.stack([(tiles % tx) * ts, (tiles // tx) * ts],
                             -1).float()
        p = (local[None] + corner[:, None])[:, :, None, :]     # (T, P, 1, 2)
        fv = face_xy_p[cand][:, None]                          # (T, 1, M, 3, 2)
        fz = face_z_p[cand][:, None]                           # (T, 1, M, 3)
        v0, v1, v2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
        bary = _barycentrics(p, v0, v1, v2)                    # (T, P, M, 3)
        d2 = _signed_dist2(p, v0, v1, v2, bary)
        zpix = torch.sum(bary * fz, -1)                        # (T, P, M)
        hit = ((d2 <= blur_pix2) & (cand[:, None, :] < f)
               & (zpix > cfg.znear) & (zpix < cfg.zfar))
        key = torch.where(hit, zpix, torch.inf)
        top = torch.sort(-key, dim=-1, descending=True,
                         stable=True).indices[..., :k]         # nearest K
        sel = torch.gather(cand[:, None, :].expand(-1, ts * ts, -1), -1, top)
        out.append(torch.where(torch.gather(hit, -1, top), sel, f))
    sel = torch.cat(out).reshape(ty, tx, ts, ts, k)
    pix_face = sel.permute(0, 2, 1, 3, 4).reshape(ty * ts, tx * ts, k)
    return pix_face[: cfg.height, : cfg.width]


# ------------------------------------------------------------- rasterize


def rasterize_soft(verts_pix: torch.Tensor, tris, attrs: torch.Tensor,
                   cfg: RasterConfig,
                   background: Optional[torch.Tensor] = None,
                   return_overflow: bool = False):
    """Soft-rasterize one mesh.

    verts_pix (V, 3): x_pixel, y_pixel, depth (positive in front; the
      tracker projection proj_pts gives z<0 in front — pass -z).
    tris (F, 3) int, attrs (V, C) per-vertex attributes (e.g. RGB).
    Returns (H, W, C+1): softmax-blended attributes + alpha; with
    ``return_overflow`` also the count of (tile, face) pairs dropped
    because a bin exceeded ``cfg.max_faces_per_tile`` (nonzero means
    missing geometry in dense regions)."""
    dev = verts_pix.device
    tris = torch.as_tensor(tris, dtype=torch.long, device=dev)
    v_xy = verts_pix[:, :2]
    v_z = verts_pix[:, 2]
    s_ndc = _ndc_scale(cfg)
    blur_pix2 = cfg.blur_radius / (s_ndc * s_ndc)
    pad_px = float(np.sqrt(max(blur_pix2, 0.0))) + 1.0
    f = tris.shape[0]

    with torch.no_grad():
        face_xy = v_xy[tris]             # (F, 3, 2)
        face_z = v_z[tris]               # (F, 3)
        bins, overflow = bin_faces(face_xy, face_z, cfg, pad_px)
        # a sentinel face (id f) that never wins
        face_xy_p = torch.cat([face_xy, face_xy.new_full((1, 3, 2), 1e9)])
        face_z_p = torch.cat([face_z, face_z.new_full((1, 3), 1e9)])
        pix_face = _select(bins, face_xy_p, face_z_p, cfg, f, blur_pix2)

    # ---- differentiable re-evaluation on the selected faces
    c = attrs.shape[-1]
    attrs_p = torch.cat([attrs, attrs.new_zeros((1, c))])
    tris_p = torch.cat([tris, tris.new_zeros((1, 3))])
    gy, gx = torch.meshgrid(
        torch.arange(cfg.height, device=dev, dtype=torch.float32) + 0.5,
        torch.arange(cfg.width, device=dev, dtype=torch.float32) + 0.5,
        indexing="ij")
    p = torch.stack([gx, gy], -1)[:, :, None, :]    # (H, W, 1, 2)
    tvi = tris_p[pix_face]                          # (H, W, K, 3)
    fv = _take(v_xy, tvi)                           # (H, W, K, 3, 2)
    fz = _take(v_z, tvi)                            # (H, W, K, 3)
    mask = pix_face < f                             # (H, W, K)
    fa = _take(attrs_p, torch.where(mask[..., None], tvi, attrs.shape[0]))
    v0, v1, v2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    bary = _barycentrics(p, v0, v1, v2)
    d2_pix = _signed_dist2(p, v0, v1, v2, bary)
    # clip barycentrics for interpolation (pytorch3d clip_barycentric)
    bc = _clip(bary, 0.0, 1.0)
    bc = bc / _clip(torch.sum(bc, -1, keepdim=True), 1e-8, float("inf"))
    zbuf = torch.sum(bc * fz, -1)                   # (H, W, K)
    feat = torch.sum(bc[..., None] * fa, -2)        # (H, W, K, C)
    d2_ndc = d2_pix * (s_ndc * s_ndc)

    # ---- softmax_rgb_blend (pytorch3d blending.py semantics)
    eps = 1e-10
    prob = torch.sigmoid(-d2_ndc / cfg.sigma) * mask
    alpha = 1.0 - torch.prod(1.0 - prob, dim=-1)
    z_inv = torch.where(mask, (cfg.zfar - zbuf) / (cfg.zfar - cfg.znear),
                        0.0)
    z_inv_max = torch.maximum(torch.amax(z_inv, -1, keepdim=True),
                              z_inv.new_tensor(eps))
    weights_num = prob * torch.exp((z_inv - z_inv_max) / cfg.gamma)
    delta = torch.exp((eps - z_inv_max[..., 0]) / cfg.gamma)
    denom = torch.sum(weights_num, -1) + delta
    if background is None:
        background = attrs.new_zeros((c,))
    pix = (torch.sum(weights_num[..., None] * feat, -2)
           + delta[..., None] * background) / denom[..., None]
    img = torch.cat([pix, alpha[..., None]], -1)
    if return_overflow:
        return img, overflow
    return img


# ------------------------------------------------- normals / illumination


def compute_vertex_normals(geometry: torch.Tensor, tris) -> torch.Tensor:
    """(B, V, 3), (F, 3) -> (B, V, 3) unit vertex normals: the sum of the
    unit normals of each vertex's triangles (render_3dmm.py:97-105),
    through three index-adds."""
    tris = torch.as_tensor(tris, dtype=torch.long, device=geometry.device)
    v1, v2, v3 = (_take(geometry, tris[:, i], 1) for i in range(3))
    n = torch.linalg.cross(v2 - v1, v3 - v1, dim=-1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
    vn = torch.zeros_like(geometry)
    for i in range(3):
        vn = vn.index_add(1, tris[:, i], n)
    return vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-12)


# SH-9 constants (render_3dmm.py:153-159)
_A0, _A1, _A2 = np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0)
_C0 = 1.0 / np.sqrt(4 * np.pi)
_C1 = np.sqrt(3.0) / np.sqrt(4 * np.pi)
_C2 = 3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)
_D0 = 0.5 / np.sqrt(3.0)


def sh9_illumination(texture: torch.Tensor, normals: torch.Tensor,
                     gamma: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) texture x SH-9 lighting -> lit per-vertex color
    (Illumination_layer, render_3dmm.py:143-181): gamma (B, 27) ->
    (B, 3, 9) with +0.8 on the DC term; basis H(n) (9,) per vertex;
    color = texture * (H @ gamma^T)."""
    g = gamma.reshape(-1, 3, 9)
    dc = torch.zeros_like(g)
    dc[:, :, 0] = 0.8
    g = (g + dc).transpose(1, 2)                    # (B, 9, 3)
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    h = torch.stack([
        torch.ones_like(nx) * _A0 * _C0,
        -_A1 * _C1 * ny,
        _A1 * _C1 * nz,
        -_A1 * _C1 * nx,
        _A2 * _C2 * nx * ny,
        -_A2 * _C2 * ny * nz,
        _A2 * _C2 * _D0 * (3 * nz ** 2 - 1),
        -_A2 * _C2 * nx * nz,
        _A2 * _C2 * 0.5 * (nx ** 2 - ny ** 2),
    ], -1)                                          # (B, V, 9)
    return texture * torch.einsum("bvn,bnc->bvc", h, g)


# --------------------------------------------------------------- Render3DMM


class Render3DMM:
    """Batch renderer (Render_3DMM.forward, render_3dmm.py:183-191):
    vertex normals -> SH-9 lit vertex colors -> soft rasterization, one
    frame at a time. Geometry arrives in the tracker's camera frame (z
    negative in front), projected with proj_pts' convention."""

    def __init__(self, focal: float, img_h: int, img_w: int,
                 tris: np.ndarray, cfg: Optional[RasterConfig] = None):
        self.focal = float(focal)
        self.h, self.w = img_h, img_w
        self.tris = np.asarray(tris, np.int32)
        self.cfg = cfg or RasterConfig(height=img_h, width=img_w)

    def __call__(self, rott_geo: torch.Tensor, texture: torch.Tensor,
                 gamma: torch.Tensor, return_overflow: bool = False):
        """(B, V, 3), (B, V, 3) tex in [0,255], (B, 27) -> (B, H, W, 4);
        with ``return_overflow`` also the largest bin overflow of the
        batch (0 for a trustworthy render)."""
        tris = torch.as_tensor(self.tris, dtype=torch.long,
                               device=rott_geo.device)
        normals = compute_vertex_normals(rott_geo, tris)
        color = sh9_illumination(texture, normals, gamma)
        x, y, z = rott_geo[..., 0], rott_geo[..., 1], rott_geo[..., 2]
        px = -self.focal * x / z + self.w / 2.0
        py = self.focal * y / z + self.h / 2.0
        verts = torch.stack([px, py, -z], -1)       # depth = -z > 0 in front
        imgs, overflow = zip(*(
            rasterize_soft(v, tris, c, self.cfg, return_overflow=True)
            for v, c in zip(verts, color)))
        img = _clip(torch.stack(imgs), 0.0, 255.0)  # alpha <= 1 (:190)
        if return_overflow:
            return img, torch.stack(overflow).max()
        return img
