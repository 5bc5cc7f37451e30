"""FaceNeRF — the conditioned NeRF MLP (counterpart of models/face_nerf.py).

D=8, W=256 trunk with a skip concat after layer 4; input = PE(xyz) ‖ aud ‖
expr/3 ‖ latent; density head from the trunk; colour head = trunk feature
‖ PE(dir) ‖ expr/3 through 1 + D//4 half-width layers.

Within a frame the conditioning vector is the same for every sample
point, so ``fold_conditioning`` adds its contribution to the biases of
the layers that see it, once per frame, and ``apply_folded`` runs an
unconditioned point MLP. The fused kernels consume the folded form.
Weights are ``nn.Linear`` layouts, (out, in).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from idealnerf_tpu_torch.core.embedding import positional_encoding
from idealnerf_tpu_torch.kernels.fused_mlp import fused_point_mlp
from idealnerf_tpu_torch.kernels.fused_mlp_grad import fused_point_mlp_train
from idealnerf_tpu_torch.models.nn import init_weights_


@dataclasses.dataclass(frozen=True)
class FaceNeRFConfig:
    depth: int = 8            # netdepth
    width: int = 256          # netwidth
    input_ch: int = 63        # PE(xyz), multires=10
    input_ch_views: int = 27  # PE(dir), multires_views=4
    dim_aud: int = 64
    dim_expr: int = 0
    dim_latent: int = 0
    skips: tuple = (4,)
    use_viewdirs: bool = True
    output_ch: int = 4        # only used when use_viewdirs=False
    multires: int = 10
    multires_views: int = 4
    density_activation: str = "relu"

    @property
    def dim_cond(self) -> int:
        return self.dim_aud + self.dim_expr + self.dim_latent

    @property
    def input_ch_all(self) -> int:
        return self.input_ch + self.dim_cond


class FaceNeRF(nn.Module):
    def __init__(self, cfg: FaceNeRFConfig,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        in_all = cfg.input_ch_all
        pts = [nn.Linear(in_all, cfg.width, device=device)]
        for i in range(cfg.depth - 1):
            d_in = cfg.width + in_all if i in cfg.skips else cfg.width
            pts.append(nn.Linear(d_in, cfg.width, device=device))
        self.pts_linears = nn.ModuleList(pts)
        if cfg.use_viewdirs:
            views = [nn.Linear(cfg.input_ch_views + cfg.width + cfg.dim_expr,
                               cfg.width // 2, device=device)]
            for _ in range(cfg.depth // 4):
                views.append(nn.Linear(cfg.width // 2, cfg.width // 2,
                                       device=device))
            self.views_linears = nn.ModuleList(views)
            self.alpha_linear = nn.Linear(cfg.width, 1, device=device)
            self.rgb_linear = nn.Linear(cfg.width // 2, 3, device=device)
        else:
            self.output_linear = nn.Linear(cfg.width, cfg.output_ch,
                                           device=device)
        init_weights_(self, generator)

    def forward(self, pe_pts, pe_dirs=None, aud=None, expr=None,
                latent=None) -> torch.Tensor:
        return apply_face_nerf(self, self.cfg, pe_pts, pe_dirs, aud, expr,
                               latent)


def _cond_vector(cfg: FaceNeRFConfig, aud, expr, latent, dtype, device):
    """Concatenated conditioning (with the reference's expr/3 scaling)."""
    parts = []
    if cfg.dim_aud > 0:
        parts.append(torch.as_tensor(aud, dtype=dtype, device=device))
    if cfg.dim_expr > 0:
        parts.append(torch.as_tensor(expr, dtype=dtype, device=device) / 3.0)
    if cfg.dim_latent > 0:
        parts.append(torch.as_tensor(latent, dtype=dtype, device=device))
    if not parts:
        return None
    return torch.cat(parts, dim=-1)


def fold_conditioning(
    model: FaceNeRF,
    cfg: FaceNeRFConfig,
    aud: Optional[torch.Tensor] = None,
    expr: Optional[torch.Tensor] = None,
    latent: Optional[torch.Tensor] = None,
) -> Dict:
    """Per-frame folded biases {"b_pts": [b'_0..b'_{D-1}], "b_view0": b'}."""
    w0 = model.pts_linears[0].weight
    cond = _cond_vector(cfg, aud, expr, latent, w0.dtype, w0.device)
    pe, in_all = cfg.input_ch, cfg.input_ch_all

    b_pts = []
    for i, layer in enumerate(model.pts_linears):
        b = layer.bias
        if cond is not None:
            if i == 0:
                b = b + cond @ layer.weight[:, pe:].T
            elif (i - 1) in cfg.skips:
                # skip layer input order: [initial(=pe‖cond), h]
                b = b + cond @ layer.weight[:, pe:in_all].T
        b_pts.append(b)

    folded = {"b_pts": b_pts}
    if cfg.use_viewdirs:
        bv = model.views_linears[0].bias
        if cfg.dim_expr > 0:
            w = model.views_linears[0].weight
            off = cfg.width + cfg.input_ch_views
            e = torch.as_tensor(expr, dtype=w.dtype, device=w.device) / 3.0
            bv = bv + e @ w[:, off:].T
        folded["b_view0"] = bv
    return folded


def apply_folded(
    model: FaceNeRF,
    folded: Dict,
    cfg: FaceNeRFConfig,
    pe_pts: torch.Tensor,
    pe_dirs: Optional[torch.Tensor],
) -> torch.Tensor:
    """Unconditioned point MLP with folded per-frame biases.

    pe_pts (N, input_ch), pe_dirs (N, input_ch_views) -> raw (N, 4).
    """
    pe, in_all = cfg.input_ch, cfg.input_ch_all
    relu = torch.relu
    lin = model.pts_linears
    h = relu(pe_pts @ lin[0].weight[:, :pe].T + folded["b_pts"][0])
    for i in range(1, cfg.depth):
        w, b = lin[i].weight, folded["b_pts"][i]
        if (i - 1) in cfg.skips:
            h = relu(pe_pts @ w[:, :pe].T + h @ w[:, in_all:].T + b)
        else:
            h = relu(h @ w.T + b)

    if not cfg.use_viewdirs:
        return model.output_linear(h)

    alpha = model.alpha_linear(h)
    wv0 = model.views_linears[0].weight
    hv = relu(
        h @ wv0[:, : cfg.width].T
        + pe_dirs @ wv0[:, cfg.width: cfg.width + cfg.input_ch_views].T
        + folded["b_view0"]
    )
    for layer in model.views_linears[1:]:
        hv = relu(layer(hv))
    rgb = model.rgb_linear(hv)
    return torch.cat([rgb, alpha], dim=-1)


def apply_point_conditioned(
    model: FaceNeRF,
    cfg: FaceNeRFConfig,
    pe_pts: torch.Tensor,
    pe_dirs: Optional[torch.Tensor],
    cond_pts: torch.Tensor,
) -> torch.Tensor:
    """Forward with PER-POINT conditioning ``cond_pts`` (N, dim_aud) in the
    aud slot (the UNet path, where every sample point carries the image
    features it gathered). Nothing folds here: the conditioning is
    concatenated to each point's input, and no kernel takes this form."""
    initial = torch.cat([pe_pts, cond_pts.to(pe_pts.dtype)], dim=-1)
    h = initial
    for i, layer in enumerate(model.pts_linears):
        h = torch.relu(layer(h))
        if i in cfg.skips:
            h = torch.cat([initial, h], dim=-1)
    if not cfg.use_viewdirs:
        return model.output_linear(h)
    alpha = model.alpha_linear(h)
    hv = torch.cat([h, pe_dirs], dim=-1)
    for layer in model.views_linears:
        hv = torch.relu(layer(hv))
    return torch.cat([model.rgb_linear(hv), alpha], dim=-1)


def apply_face_nerf(model: FaceNeRF, cfg: FaceNeRFConfig, pe_pts,
                    pe_dirs=None, aud=None, expr=None,
                    latent=None) -> torch.Tensor:
    """Reference-equivalent forward: fold the conditioning, then the
    unconditioned point MLP."""
    folded = fold_conditioning(model, cfg, aud, expr, latent)
    return apply_folded(model, folded, cfg, pe_pts, pe_dirs)


def make_field_fn(
    model: FaceNeRF,
    cfg: FaceNeRFConfig,
    aud: Optional[torch.Tensor] = None,
    expr: Optional[torch.Tensor] = None,
    latent: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
    use_pallas=False,
):
    """Close the model and its conditioning into the renderer's signature
    ``field_fn(pts (R, S, 3), viewdirs (R, 3)) -> raw (R, S, 4)``.

    ``use_pallas`` keeps the JAX package's name for the fused path:
    "train" / "train_bf16" = the differentiable fused kernel pair with an
    f32 / bf16 rematerialising backward (kernels/fused_mlp_grad.py), True =
    the fused forward kernel without gradient (kernels/fused_mlp.py),
    False = the plain autograd MLP. ``compute_dtype`` casts the parameters
    and inputs of the plain path (the kernels fix their own types)."""
    if use_pallas not in (False, True, "train", "train_bf16"):
        raise ValueError(f"use_pallas must be False, True, 'train' or "
                         f"'train_bf16', got {use_pallas!r}")
    fused = bool(use_pallas)
    if fused and not cfg.use_viewdirs:
        raise ValueError("the fused kernels cover the use_viewdirs path; "
                         "use_pallas=False (train_fused 0) runs without it")
    if fused and compute_dtype is not None:
        raise ValueError("compute_dtype applies to the plain path only")
    if compute_dtype is not None:
        cast = {k: v.to(compute_dtype) for k, v in model.named_parameters()}

        def fold_and_apply(pe_pts, pe_dirs):
            return torch.func.functional_call(
                model, cast, (pe_pts, pe_dirs, aud, expr, latent))
    else:
        folded = fold_conditioning(model, cfg, aud, expr, latent)

        def fold_and_apply(pe_pts, pe_dirs):
            return apply_folded(model, folded, cfg, pe_pts, pe_dirs)

    def field_fn(pts, viewdirs):
        R, S, _ = pts.shape
        flat = pts.reshape(R * S, 3)
        dirs = None
        if cfg.use_viewdirs:
            dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(R * S, 3)
        if fused:
            flat, dirs = flat.float().contiguous(), dirs.float().contiguous()
            if use_pallas in ("train", "train_bf16"):
                gd = (torch.bfloat16 if use_pallas == "train_bf16"
                      else torch.float32)
                raw = fused_point_mlp_train(cfg, model, folded, flat, dirs, gd)
            else:
                raw = fused_point_mlp(model, folded, cfg, flat, dirs)
            return raw.reshape(R, S, 4)
        if compute_dtype is not None:
            flat = flat.to(compute_dtype)
            dirs = dirs.to(compute_dtype) if dirs is not None else None
        pe_pts = positional_encoding(flat, cfg.multires)
        pe_dirs = (positional_encoding(dirs, cfg.multires_views)
                   if dirs is not None else None)
        return fold_and_apply(pe_pts, pe_dirs).reshape(R, S, 4).float()

    return field_fn
