"""3DMM tracker (counterpart of pipeline/tracking/tracker.py; reference:
data_util/face_tracking/face_tracker.py:29-347).

Stage parity:
1. focal grid search 600..1400 in steps of 100 — short landmark fit per
   candidate, keep the focal with the lowest loss (:55-114);
2. global fit — shared identity coefficients, per-frame expression /
   euler / translation, Adam on landmark MSE (+ small coefficient
   regularization) (:116-177);
3. temporal refinement — continued fit with Laplacian smoothing over the
   euler/trans/exp trajectories;
4. photometric fit (:179-235): texture + SH lighting + pose/exp/id on a
   10-frame batch through the differentiable soft rasterizer
   (rasterizer.Render3DMM), masked color loss (util.py cal_col_loss);
5. sliding per-batch refinement (:248-343): per 10-frame window, 50 Adam
   steps on 0.5·col + 8·lan + 1e5·lap(rigid-vertex trajectories over the
   previous-5+window frames) + regexp, landmark weight dropping to 1.5
   after iter 30.

Each stage is a loop of ``torch.optim.Adam`` steps on the model's device
(optax's Adam: the same moments, bias corrections and eps placement, eps
1e-8). Where the JAX module schedules a rate with
``piecewise_constant_schedule(lr, {50: 0.2})``, the rate is scaled from
the update whose 0-based count is 50; its ``multi_transform`` groups are
two parameter groups of one optimizer. The loss of a stage is the one of
its last step, taken before that step's update (the last of JAX's
``lax.scan`` losses).
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from idealnerf_tpu_torch.pipeline.tracking.facemodel import Face3DMM
from idealnerf_tpu_torch.pipeline.tracking.geometry import (
    euler2rot, forward_transform, lap_loss, landmark_loss, rot_trans_pts,
)
from idealnerf_tpu_torch.pipeline.tracking.rasterizer import (
    RasterConfig, Render3DMM,
)

logger = logging.getLogger("idealnerf.tracker")


class TrackResult(NamedTuple):
    focal: float
    id_coef: np.ndarray    # (n_id,)
    exp: np.ndarray        # (N, n_exp)
    euler: np.ndarray      # (N, 3)
    trans: np.ndarray      # (N, 3)
    loss: float
    tex: Optional[np.ndarray] = None    # (n_tex,) when photometric ran
    light: Optional[np.ndarray] = None  # (N, 27)


def masked_color_loss(pred: torch.Tensor, gt: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """util.py cal_col_loss: mean over frames of sum(|pred-gt|_2 · mask)
    / sum(mask), colors in 0..255 (the /255 scales the norm)."""
    err = torch.sqrt(torch.sum((pred - gt) ** 2, -1) + 1e-12) * mask / 255.0
    return torch.mean(torch.sum(err, (1, 2)) / (torch.sum(mask, (1, 2))
                                               + 1e-8))


def _leaves(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Detached copies that require grad: the optimizer's leaves."""
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def _adam_loop(leaves: Dict[str, torch.Tensor], groups, steps: int,
               loss_fn: Callable, decay_at: Optional[int] = None):
    """``steps`` Adam updates of ``leaves`` on ``loss_fn(step)``; groups =
    [(names, lr)]; with ``decay_at`` every rate is scaled by 0.2 from the
    update of that 0-based count. -> the last step's loss (pre-update),
    a 0-d tensor, or None for no steps."""
    opt = torch.optim.Adam(
        [{"params": [leaves[n] for n in names], "lr": lr, "base_lr": lr}
         for names, lr in groups], eps=1e-8)
    loss = None
    for step in range(steps):
        if decay_at is not None:
            for g in opt.param_groups:
                g["lr"] = g["base_lr"] * (0.2 if step >= decay_at else 1.0)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(step)
        loss.backward()
        opt.step()
    return None if loss is None else loss.detach()


class FaceTracker:
    def __init__(self, model: Face3DMM, img_h: int, img_w: int,
                 focal_candidates: Sequence[float] = tuple(range(600, 1500,
                                                                 100)),
                 init_z: float = -7.0,
                 raster_cfg: Optional[RasterConfig] = None):
        self.model = model
        self.device = model.device
        self.h, self.w = img_h, img_w
        self.cxy = (img_w / 2.0, img_h / 2.0)
        self.focal_candidates = list(focal_candidates)
        self.init_z = init_z
        self.raster_cfg = raster_cfg

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------ internals

    def _project_landmarks(self, params, focal):
        lan3d = self.model.get_3dlandmarks(
            params["id"][None], params["exp"], params["euler"],
            params["trans"], focal, self.cxy)
        return forward_transform(lan3d, params["euler"], params["trans"],
                                 focal, self.cxy)[..., :2]

    def _loss(self, params, gt_lan, focal, reg: float, lap_w: float):
        proj = self._project_landmarks(params, focal)
        loss = landmark_loss(proj, gt_lan)
        loss = loss + reg * (torch.mean(params["id"] ** 2)
                             + torch.mean(params["exp"] ** 2))
        if lap_w > 0:
            loss = loss + (
                lap_loss(params["euler"], lap_w)
                + lap_loss(params["trans"], lap_w)
                + lap_loss(params["exp"], lap_w)
            )
        return loss

    def _fit_stage(self, params, gt_lan, focal, steps, lr, reg, lap_w):
        """``steps`` Adam updates on the landmark loss -> (params, the
        last step's loss)."""
        q = _leaves(params)
        loss = _adam_loop(q, [(list(q), lr)], steps,
                          lambda _: self._loss(q, gt_lan, focal, reg, lap_w))
        return {k: v.detach() for k, v in q.items()}, loss

    def _init_params(self, n_frames):
        n_id, n_exp = self.model.dims
        dev = self.device
        return {
            "id": torch.zeros(n_id, device=dev),
            "exp": torch.zeros(n_frames, n_exp, device=dev),
            "euler": torch.zeros(n_frames, 3, device=dev),
            "trans": torch.tensor([0.0, 0.0, self.init_z],
                                  device=dev).repeat(n_frames, 1),
        }

    # ----------------------------------------------------------- photometric

    def _make_renderer(self, focal) -> Render3DMM:
        cfg = self.raster_cfg or RasterConfig(height=self.h, width=self.w)
        return Render3DMM(focal, self.h, self.w, self.model.tris, cfg)

    @torch.no_grad()
    def _renderer_checked(self, focal, id_c, exp, euler, trans, tex,
                          light) -> Render3DMM:
        """Renderer whose bin capacity is verified on a probe frame.

        Bin overflow drops (tile, face) pairs (rasterize_soft), which
        poisons photometric fits with missing geometry; the capacity is
        raised until the probe renders clean."""
        renderer = self._make_renderer(focal)
        for _ in range(4):
            _, ov = self._render_window(
                renderer, id_c, exp[:1], euler[:1], trans[:1], tex,
                light[:1], return_overflow=True)
            ov = int(ov)
            if ov == 0:
                return renderer
            # capacity + total dropped pairs upper-bounds the worst
            # single tile's need, so this converges in one retry
            cap = renderer.cfg.max_faces_per_tile
            new_cap = int(-(-max(2 * cap, cap + ov) // 8) * 8)
            cfg = renderer.cfg._replace(max_faces_per_tile=new_cap)
            logger.warning(
                "raster bin overflow %d at capacity %d — raising to %d",
                ov, cap, new_cap)
            renderer = Render3DMM(focal, self.h, self.w, self.model.tris,
                                  cfg)
        logger.error("raster bins still overflow at capacity %d; the "
                     "photometric fit will see incomplete geometry",
                     renderer.cfg.max_faces_per_tile)
        return renderer

    def _render_window(self, renderer, id_c, exp, euler, trans, tex, light,
                       return_overflow: bool = False):
        geometry = self.model.geometry(id_c[None], exp)
        rott = rot_trans_pts(geometry, euler2rot(euler), trans)
        texture = self.model.texture(tex[None]).expand(geometry.shape)
        return renderer(rott, texture, light,
                        return_overflow=return_overflow)  # (B, H, W, 4)

    def _initial_loss(self, renderer, focal, q, imgs, lms, step: int):
        """The initial photometric fit's loss (face_tracker.py:207-225):
        ``q`` the batch's id/exp/euler/trans/tex/light."""
        proj = self._project_landmarks(q, focal)
        loss_lan = landmark_loss(proj, lms)
        regid = torch.mean(q["id"] ** 2)
        regexp = torch.mean(q["exp"] ** 2)
        img = self._render_window(renderer, q["id"], q["exp"], q["euler"],
                                  q["trans"], q["tex"], q["light"])
        mask = img[..., 3].detach() > 0.0
        loss_col = masked_color_loss(img[..., :3], imgs, mask)
        # weight switch after iter 50 (:222-224)
        late = step > 50
        w_lan, w_id, w_exp = (0.05, 1.0, 0.8) if late else (3.0, 2.0, 1.0)
        return loss_col + w_lan * loss_lan + w_id * regid + w_exp * regexp

    def _photometric_initial(self, params, images, landmarks, focal,
                             batch: int, steps: int):
        """face_tracker.py:179-235: joint tex/light/pose/exp/id fit on an
        evenly spaced frame batch. Returns updated params + tex + mean
        light (broadcast to every frame, :240-241)."""
        n = images.shape[0]
        dev = self.device
        renderer = self._renderer_checked(
            focal, params["id"], params["exp"], params["euler"],
            params["trans"], torch.zeros(self.model.n_tex, device=dev),
            torch.zeros(1, 27, device=dev))
        sel = np.arange(0, n, max(int(n / batch), 1))[:batch]
        sel_imgs = self._t(images[sel])
        sel_lms = self._t(landmarks[sel])
        sel_t = torch.as_tensor(sel, device=dev)

        q = _leaves({"id": params["id"], "exp": params["exp"][sel_t],
                     "euler": params["euler"][sel_t],
                     "trans": params["trans"][sel_t],
                     "tex": torch.zeros(self.model.n_tex, device=dev),
                     "light": torch.zeros(len(sel), 27, device=dev)})
        # two Adams, reference lrs (:194-196), both x0.2 at iter 50
        loss = _adam_loop(
            q, [(["id", "exp", "euler", "trans"], 0.01),
                (["tex", "light"], 0.1)], steps,
            lambda step: self._initial_loss(renderer, focal, q, sel_imgs,
                                            sel_lms, step),
            decay_at=50)
        logger.info("photometric initial fit: col-loss %.4f", float(loss))
        q = {k: v.detach() for k, v in q.items()}
        params = dict(params)
        params["id"] = q["id"]
        for k in ("exp", "euler", "trans"):
            params[k] = params[k].index_copy(0, sel_t, q[k])
        light = q["light"].mean(0, keepdim=True).repeat(n, 1)
        return params, q["tex"], light

    def _rigid_traj(self, id_c, rigid, exp, euler, trans):
        geo = self.model.geometry_sub(id_c[None], exp, rigid)
        rott = rot_trans_pts(geo, euler2rot(euler), trans)
        return rott.reshape(rott.shape[0], -1)   # (T, 3R)

    def _window_loss(self, renderer, focal, id_c, tex, rigid, q, pre, imgs,
                     lms, step: int):
        """The sliding refine's loss of one window (face_tracker.py:
        290-320): ``q`` the window's exp/euler/trans/light, ``pre`` the
        previous refined frames' exp/euler/trans or None."""
        proj = self._project_landmarks(
            {"id": id_c, "exp": q["exp"], "euler": q["euler"],
             "trans": q["trans"]}, focal)
        loss_lan = landmark_loss(proj, lms)
        regexp = torch.mean(q["exp"] ** 2)
        img = self._render_window(renderer, id_c, q["exp"], q["euler"],
                                  q["trans"], tex, q["light"])
        mask = img[..., 3].detach() > 0.0
        loss_col = masked_color_loss(img[..., :3], imgs, mask)
        traj = [q[k] if pre is None else torch.cat([pre[k], q[k]])
                for k in ("exp", "euler", "trans")]
        loss_lap = lap_loss(self._rigid_traj(id_c, rigid, *traj))
        w_lan = 1.5 if step > 30 else 8.0
        return (0.5 * loss_col + w_lan * loss_lan
                + 1e5 * loss_lap + 1.0 * regexp)

    def _photometric_refine(self, params, tex, light, images, landmarks,
                            focal, batch: int, steps: int):
        """face_tracker.py:248-343: sliding-window photometric refinement
        with a 1e5-weighted temporal Laplacian over the rigid-vertex
        trajectories (previous 5 refined frames + current window)."""
        n = images.shape[0]
        renderer = self._renderer_checked(
            focal, params["id"], params["exp"], params["euler"],
            params["trans"], tex, light)
        rigid = (self.model.rigid_ids if self.model.rigid_ids is not None
                 else self.model.keypoints[:20])
        pre_num = 5
        id_c = params["id"].detach()
        tex = tex.detach()
        exp, euler, trans = params["exp"], params["euler"], params["trans"]
        light = light.detach()
        n_win = int((n - 1) / batch + 1)
        for i in range(n_win):
            start = min(i * batch, n - batch)
            ids = torch.arange(start, start + batch, device=self.device)
            q = _leaves({"exp": exp[ids], "euler": euler[ids],
                         "trans": trans[ids], "light": light[ids]})
            imgs = self._t(images[start:start + batch])
            lms = self._t(landmarks[start:start + batch])
            pre = None
            if i > 0:
                # the previous pre_num frames; below frame 0 they wrap
                # around to the clip's end, as the JAX module's indices do
                pids = torch.arange(start - pre_num, start,
                                    device=self.device) % n
                pre = {"exp": exp[pids], "euler": euler[pids],
                       "trans": trans[pids]}
            loss = _adam_loop(
                q, [(list(q), 0.005)], steps,
                lambda step: self._window_loss(renderer, focal, id_c, tex,
                                               rigid, q, pre, imgs, lms,
                                               step))
            exp, euler, trans, light = (
                t.index_copy(0, ids, q[k].detach())
                for k, t in (("exp", exp), ("euler", euler),
                             ("trans", trans), ("light", light)))
            logger.info("photometric window %d/%d: loss %.4f",
                        i + 1, n_win, float("nan") if loss is None
                        else float(loss))
        return {"id": id_c, "exp": exp, "euler": euler, "trans": trans}, light

    # ---------------------------------------------------------------- fit

    def fit(self, landmarks: np.ndarray, images: Optional[np.ndarray] = None,
            steps_focal: int = 100, steps_global: int = 600,
            steps_refine: int = 200, lr: float = 0.03,
            reg: float = 1e-3, lap_weight: float = 1e-2,
            photo_batch: int = 10, photo_steps: int = 71,
            photo_refine_steps: int = 50) -> TrackResult:
        """landmarks (N, 68, 2) detected pixel coords; images (N, H, W, 3)
        uint8/float 0..255 enables the photometric stages -> TrackResult."""
        gt = self._t(landmarks)
        n = gt.shape[0]
        sel = gt[:: max(n // 16, 1)]  # focal search on a frame subset (:55)

        best = (None, np.inf)
        for focal in self.focal_candidates:
            p0 = self._init_params(sel.shape[0])
            _, loss = self._fit_stage(p0, sel, float(focal), steps_focal,
                                      lr, reg, 0.0)
            loss = float(loss)
            logger.info("focal %d -> loss %.4f", focal, loss)
            if loss < best[1]:
                best = (float(focal), loss)
        focal = best[0]

        params = self._init_params(n)
        params, loss = self._fit_stage(params, gt, focal, steps_global,
                                       lr, reg, 0.0)
        params, loss = self._fit_stage(params, gt, focal, steps_refine,
                                       lr * 0.3, reg, lap_weight)

        tex = light = None
        can_photo = (self.model.tris is not None
                     and self.model.base_tex is not None)
        if images is not None and can_photo:
            images = np.asarray(images)
            batch = min(photo_batch, n)
            params, tex, light = self._photometric_initial(
                params, images, np.asarray(landmarks), focal, batch,
                photo_steps)
            params, light = self._photometric_refine(
                params, tex, light, images, np.asarray(landmarks), focal,
                batch, photo_refine_steps)
        elif images is not None:
            logger.warning("photometric stage skipped: model lacks "
                           "texture basis or triangulation")

        def np_(t):
            return None if t is None else t.detach().cpu().numpy()

        return TrackResult(
            focal=focal,
            id_coef=np_(params["id"]),
            exp=np_(params["exp"]),
            euler=np_(params["euler"]),
            trans=np_(params["trans"]),
            loss=float(loss),
            tex=np_(tex),
            light=np_(light),
        )
