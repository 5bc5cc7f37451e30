"""Linear 3DMM face model (counterpart of pipeline/tracking/facemodel.py;
reference: data_util/face_tracking/facemodel.py): geo = (id·sig_id)·B_id
+ (exp·sig_exp)·B_exp + mu, texture analogously, 68-keypoint selection
with per-frame contour-aware jaw landmarks (facemodel.py:48-90). The
Basel Face Model data (3DMM_info.npy + keys_info.npy, produced offline by
convert_BFM.py) is loaded when given; ``synthetic`` builds bases of the
same structure from ``np.random.RandomState(seed)``, the JAX package's
draws bit for bit.

The bases live as float32 tensors on ``device``; index sets (keypoints,
contours, rigid ids, triangles) stay numpy int32 arrays, with their
device copies cached per use.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from idealnerf_tpu_torch.pipeline.tracking.geometry import forward_transform


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


class Face3DMM:
    def __init__(self, mu: np.ndarray, base_id: np.ndarray,
                 base_exp: np.ndarray, keypoints: np.ndarray,
                 mu_tex: Optional[np.ndarray] = None,
                 base_tex: Optional[np.ndarray] = None,
                 tris: Optional[np.ndarray] = None,
                 sig_id: Optional[np.ndarray] = None,
                 sig_exp: Optional[np.ndarray] = None,
                 sig_tex: Optional[np.ndarray] = None,
                 left_contour: Optional[np.ndarray] = None,
                 right_contour: Optional[np.ndarray] = None,
                 rigid_ids: Optional[np.ndarray] = None,
                 device=None):
        """mu (3V,), base_id (3V, n_id), base_exp (3V, n_exp),
        keypoints (68,) vertex indices of the landmark set.

        sig_id/sig_exp/sig_tex: coefficient scales applied before the
        basis matmul (facemodel.py:49-50, 93-94, 104-105, 110); identity
        when absent. left_contour/right_contour (8, P): per jaw landmark
        row, candidate silhouette vertex indices (keys_info.npy);
        rigid_ids: vertex subset used for the temporal Laplacian in the
        tracker's sliding refinement (face_tracker.py:310-312)."""
        self.device = torch.device(device or "cpu")
        self.mu = _f32(mu, self.device)
        self.base_id = _f32(base_id, self.device)
        self.base_exp = _f32(base_exp, self.device)
        self.keypoints = np.asarray(keypoints, np.int32)
        self.mu_tex = None if mu_tex is None else _f32(mu_tex, self.device)
        self.base_tex = (None if base_tex is None
                         else _f32(base_tex, self.device))
        self.tris = None if tris is None else np.asarray(tris, np.int32)
        n_id, n_exp = self.base_id.shape[1], self.base_exp.shape[1]
        self.sig_id = (torch.ones(n_id, device=self.device) if sig_id is None
                       else _f32(np.asarray(sig_id).reshape(-1)[:n_id],
                                 self.device))
        self.sig_exp = (torch.ones(n_exp, device=self.device)
                        if sig_exp is None
                        else _f32(np.asarray(sig_exp).reshape(-1)[:n_exp],
                                  self.device))
        self.sig_tex = (None if sig_tex is None
                        else _f32(np.asarray(sig_tex).reshape(-1),
                                  self.device))
        self.left_contour = (None if left_contour is None
                             else np.asarray(left_contour, np.int32))
        self.right_contour = (None if right_contour is None
                              else np.asarray(right_contour, np.int32))
        self.rigid_ids = (None if rigid_ids is None
                          else np.asarray(rigid_ids, np.int32))
        self._subsets: Dict[bytes, tuple] = {}

    @property
    def n_vertices(self) -> int:
        return self.mu.shape[0] // 3

    @property
    def dims(self):
        return self.base_id.shape[1], self.base_exp.shape[1]

    @property
    def has_contours(self) -> bool:
        return self.left_contour is not None and self.right_contour is not None

    def _subset(self, vert_idx: np.ndarray):
        """(base_id, base_exp, mu) rows of the flat 3V axis for the vertex
        subset, gathered once per subset."""
        vert_idx = np.asarray(vert_idx, np.int64)
        key = vert_idx.tobytes()
        if key not in self._subsets:
            sel3 = torch.as_tensor(
                (3 * vert_idx[:, None] + np.arange(3)[None, :]).reshape(-1),
                device=self.device)
            self._subsets[key] = (self.base_id[sel3], self.base_exp[sel3],
                                  self.mu[sel3])
        return self._subsets[key]

    def _geo_flat(self, id_coef, exp_coef, sub=None):
        """Sig-scaled linear combination over the 3V geometry axis or a
        ``_subset`` of it (facemodel.py:55-59)."""
        base_id, base_exp, mu = sub or (self.base_id, self.base_exp, self.mu)
        idc = id_coef * self.sig_id
        expc = exp_coef * self.sig_exp
        return idc @ base_id.T + expc @ base_exp.T + mu[None]

    def geometry(self, id_coef: torch.Tensor,
                 exp_coef: torch.Tensor) -> torch.Tensor:
        """(B, n_id), (B, n_exp) -> (B, V, 3) (facemodel.py:102-107)."""
        g = self._geo_flat(id_coef, exp_coef)
        return g.reshape(g.shape[0], -1, 3)

    def geometry_sub(self, id_coef: torch.Tensor, exp_coef: torch.Tensor,
                     vert_idx: np.ndarray) -> torch.Tensor:
        """Geometry restricted to a vertex subset (facemodel.py:92-100)."""
        g = self._geo_flat(id_coef, exp_coef, self._subset(vert_idx))
        return g.reshape(g.shape[0], -1, 3)

    def landmarks(self, id_coef: torch.Tensor,
                  exp_coef: torch.Tensor) -> torch.Tensor:
        """(B, 68, 3) keypoint vertices (fixed indices, no contour)."""
        return self.geometry_sub(id_coef, exp_coef, self.keypoints)

    def get_3dlandmarks(self, id_coef: torch.Tensor, exp_coef: torch.Tensor,
                        euler: torch.Tensor, trans: torch.Tensor,
                        focal, cxy) -> torch.Tensor:
        """Contour-aware 68 3D landmarks (facemodel.py:48-90).

        Jaw rows 0:8 / 9:17 are re-selected per frame from candidate
        silhouette vertices by min / max projected x under the current
        pose (the first extreme on ties, as ``jnp.argmin``); remaining
        rows come from the fixed keypoint set. The selection carries no
        gradient; the positions do."""
        lands = self.landmarks(id_coef, exp_coef)       # (B, 68, 3)
        if not self.has_contours:
            return lands

        def contour_pick(cands: np.ndarray, take_max: bool):
            geo = self.geometry_sub(id_coef, exp_coef, cands.reshape(-1))
            b = geo.shape[0]
            with torch.no_grad():
                px = forward_transform(geo, euler, trans, focal, cxy)[..., 0]
                px = px.reshape(b, cands.shape[0], cands.shape[1])
                idx = (torch.argmax(px, -1) if take_max
                       else torch.argmin(px, -1))        # (B, 8)
            geo = geo.reshape(b, cands.shape[0], cands.shape[1], 3)
            return torch.gather(
                geo, 2, idx[..., None, None].expand(-1, -1, 1, 3))[:, :, 0]

        left = contour_pick(self.left_contour, take_max=False)
        right = contour_pick(self.right_contour, take_max=True)
        return torch.cat([left, lands[:, 8:9], right, lands[:, 17:]], dim=1)

    def texture(self, tex_coef: torch.Tensor) -> torch.Tensor:
        """(B, n_tex) -> (B, V, 3) (facemodel.py:109-112)."""
        assert self.base_tex is not None and self.mu_tex is not None
        if self.sig_tex is not None:
            tex_coef = tex_coef * self.sig_tex[: tex_coef.shape[-1]]
        t = tex_coef @ self.base_tex.T + self.mu_tex[None]
        return t.reshape(t.shape[0], -1, 3)

    @property
    def n_tex(self) -> int:
        return 0 if self.base_tex is None else self.base_tex.shape[1]

    @classmethod
    def load(cls, path: str, device=None) -> "Face3DMM":
        """Load convert_BFM.py-format 3DMM_info.npy (+ keys_info.npy /
        topology_info.npy beside it when present — facemodel.py:15-46,
        render_3dmm.py:90-95)."""
        info = np.load(path, allow_pickle=True).item()
        kw = {}
        base = os.path.dirname(path)
        keys_path = os.path.join(base, "keys_info.npy")
        if os.path.exists(keys_path):
            keys = np.load(keys_path, allow_pickle=True).item()
            kw.update(keypoints=keys["keyinds"],
                      left_contour=keys.get("left_contour"),
                      right_contour=keys.get("right_contour"),
                      rigid_ids=keys.get("rigid_ids"))
        else:
            kw.update(keypoints=info["keypoints"])
        topo_path = os.path.join(base, "topology_info.npy")
        tris = info.get("tris")
        if tris is None and os.path.exists(topo_path):
            tris = np.load(topo_path, allow_pickle=True).item().get("tris")
        if "mu_shape" in info:
            # reference centers mu per-axis and scales bases by 1e-5
            # (facemodel.py:21-28)
            mu = (info["mu_shape"] + info["mu_exp"]).reshape(-1, 3)
            mu = (mu - mu.mean(0, keepdims=True)).reshape(-1) / 100000.0
            base_id = info["b_shape"].T / 100000.0
            base_exp = info["b_exp"].T / 100000.0
        else:
            mu, base_id, base_exp = info["mu"], info["base_id"], info["base_exp"]
        if "b_tex" in info:          # reference layout: (n_tex, 3V)
            base_tex = np.asarray(info["b_tex"]).T
        else:
            base_tex = info.get("base_tex")
        return cls(
            mu=mu, base_id=base_id, base_exp=base_exp,
            mu_tex=info.get("mu_tex"),
            base_tex=base_tex,
            tris=tris,
            sig_id=info.get("sig_shape"),
            sig_exp=info.get("sig_exp"),
            sig_tex=info.get("sig_tex"),
            device=device,
            **kw,
        )

    @classmethod
    def synthetic(cls, n_vertices: int = 300, n_id: int = 20, n_exp: int = 10,
                  n_tex: int = 8, seed: int = 0,
                  with_contours: bool = False,
                  n_lat: int = 15, n_lon: int = 20,
                  shell: bool = False, device=None) -> "Face3DMM":
        """A random-basis stand-in with the BFM structure: a face-like
        ellipsoid mean with smooth random deformation bases, optional
        texture model, triangulation, and silhouette contour candidate
        rows (lat/long grid mesh when with_contours).

        ``shell=True`` builds an OPEN front-facing dome over a regular
        (n_lat, n_lon) grid instead of the closed ellipsoid — the
        topology of the real BFM (a face shell, no back surface, no
        polar density singularities). Reference scale
        (face_tracker.py:37-53, convert_BFM output):
        ``synthetic(n_id=100, n_exp=79, n_lat=150, n_lon=230,
        shell=True, with_contours=True)`` — 34 500 vertices / 68 242
        triangles (the JAX docstring's 68 206 miscounts 149 x 229 x 2),
        matching the BFM's 34 650 / ~69k."""
        rng = np.random.RandomState(seed)
        grid = n_lat * n_lon
        if shell:
            n_vertices = grid
            v, u = np.meshgrid(np.linspace(-1.0, 1.0, n_lat),
                               np.linspace(-1.0, 1.0, n_lon),
                               indexing="ij")
            u, v = u.reshape(-1), v.reshape(-1)
            dome = np.sqrt(np.maximum(1.0 - 0.5 * (u * u + v * v), 0.0))
            mu = np.stack([0.8 * u, 1.0 * v, 0.6 * dome], -1).reshape(-1)

            def smooth_basis(n_modes, scale):
                # spatially smooth random bases (the real BFM's are):
                # low-frequency sinusoid fields keep triangle size ~grid
                # spacing at any V
                freq = rng.uniform(0.5, 3.0, (n_modes, 2))
                phase = rng.uniform(0, 2 * np.pi, (n_modes, 3))
                amp = rng.randn(n_modes, 3) * scale
                arg = (freq[:, 0, None] * u[None] +
                       freq[:, 1, None] * v[None])        # (K, V)
                b = (amp[:, None, :] *
                     np.sin(arg[:, :, None] + phase[:, None, :]))  # (K,V,3)
                return b.reshape(n_modes, -1).T.astype(np.float32)

            base_id = smooth_basis(n_id, 0.02)
            base_exp = smooth_basis(n_exp, 0.01)
            # landmarks in the central face region
            rows = (n_lat // 4 + rng.choice(n_lat // 2, 68)) * n_lon
            keypoints = rows + n_lon // 4 + rng.choice(n_lon // 2, 68)
            a = (np.arange(n_lat - 1)[:, None] * n_lon
                 + np.arange(n_lon - 1)[None, :]).reshape(-1)
            b, c = a + 1, a + n_lon
            tris = np.stack([np.stack([a, b, c], -1),
                             np.stack([b, c + 1, c], -1)], 1).reshape(-1, 3)
            kw = {"tris": tris.astype(np.int32)}
            if n_tex:
                kw["mu_tex"] = np.full(3 * n_vertices, 128.0, np.float32)
                kw["base_tex"] = (
                    rng.randn(3 * n_vertices, n_tex).astype(np.float32) * 20.0
                )
            if with_contours:
                rows = np.linspace(n_lat // 2, n_lat - 1, 8).astype(int)
                kw["left_contour"] = (rows[:, None] * n_lon
                                      + np.arange(n_lon)[None, :])
                kw["right_contour"] = kw["left_contour"].copy()
                kw["rigid_ids"] = rng.choice(n_vertices, 20, replace=False)
            return cls(mu.astype(np.float32), base_id, base_exp,
                       keypoints, device=device, **kw)
        use_grid = with_contours or n_vertices == grid
        if use_grid:
            n_vertices = grid
            phi = np.repeat(np.linspace(0.3, np.pi - 0.3, n_lat), n_lon)
            th = np.tile(np.linspace(0, 2 * np.pi, n_lon, endpoint=False), n_lat)
        else:
            phi = rng.uniform(0, np.pi, n_vertices)
            th = rng.uniform(0, 2 * np.pi, n_vertices)
        mu = np.stack([
            0.8 * np.sin(phi) * np.cos(th),
            1.0 * np.cos(phi),
            0.6 * np.sin(phi) * np.sin(th),
        ], -1).reshape(-1)
        base_id = rng.randn(3 * n_vertices, n_id).astype(np.float32) * 0.02
        base_exp = rng.randn(3 * n_vertices, n_exp).astype(np.float32) * 0.01
        keypoints = rng.choice(n_vertices, 68, replace=False)
        kw = {}
        if n_tex:
            kw["mu_tex"] = np.full(3 * n_vertices, 128.0, np.float32)
            kw["base_tex"] = rng.randn(3 * n_vertices, n_tex).astype(np.float32) * 20.0
        if use_grid:
            # grid triangulation (wrapping in longitude)
            i = np.arange(n_lat - 1)[:, None]
            j = np.arange(n_lon)[None, :]
            a = (i * n_lon + j).reshape(-1)
            b = (i * n_lon + (j + 1) % n_lon).reshape(-1)
            c, d = a + n_lon, b + n_lon
            kw["tris"] = np.stack([np.stack([a, b, c], -1),
                                   np.stack([b, d, c], -1)],
                                  1).reshape(-1, 3).astype(np.int32)
        if with_contours:
            # 8 left/right jaw rows: candidates = full longitude rings of
            # the lower half; silhouette selection picks the extreme-x
            # vertex per ring under the current pose.
            rows = np.linspace(n_lat // 2, n_lat - 1, 8).astype(int)
            kw["left_contour"] = (rows[:, None] * n_lon
                                  + np.arange(n_lon)[None, :])
            kw["right_contour"] = kw["left_contour"].copy()
            kw["rigid_ids"] = rng.choice(n_vertices, 20, replace=False)
        return cls(mu.astype(np.float32), base_id, base_exp, keypoints,
                   device=device, **kw)

    def save(self, path: str) -> None:
        """Write the model as a 3DMM_info.npy at ``path`` and its index
        sets as keys_info.npy beside it, the layout ``load`` reads."""
        def np_(t):
            return None if t is None else t.cpu().numpy()

        info = {"mu": np_(self.mu), "base_id": np_(self.base_id),
                "base_exp": np_(self.base_exp), "keypoints": self.keypoints,
                "mu_tex": np_(self.mu_tex), "base_tex": np_(self.base_tex),
                "tris": self.tris, "sig_shape": np_(self.sig_id),
                "sig_exp": np_(self.sig_exp), "sig_tex": np_(self.sig_tex)}
        np.save(path, {k: v for k, v in info.items() if v is not None},
                allow_pickle=True)
        keys = {"keyinds": self.keypoints, "left_contour": self.left_contour,
                "right_contour": self.right_contour,
                "rigid_ids": self.rigid_ids}
        np.save(os.path.join(os.path.dirname(path), "keys_info.npy"),
                {k: v for k, v in keys.items() if v is not None},
                allow_pickle=True)
