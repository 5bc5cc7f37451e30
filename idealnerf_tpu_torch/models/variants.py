"""Model-variant machinery (counterpart of models/variants.py): one
trainer, pluggable conditioning. Every variant maps (audio feature, expr,
latent) onto the folded-bias FaceNeRF point MLP, so each runs on the
same kernels:

- "face_nerf" (the paper head model): cond = aud ‖ expr/3 ‖ latent.
- "face_nerf_agg": a 2-layer *linear* MLP (no activations, as the
  reference) fuses aud ‖ expr/3 into dim_agg, which conditions the trunk
  and the view branch: FaceNeRF(dim_aud=0, dim_expr=dim_agg) driven with
  expr = 3·agg (cancelling the /3).
- "attention_nerf": SelfAttention over aud ‖ expr/3; its output takes the
  aud slot of FaceNeRF(dim_aud=dim_aud+dim_expr, dim_expr=0). The
  reference recomputes it over identical broadcast rows, whose softmax is
  uniform, so it is one vector per frame, folded like any conditioning.

The extras learn only through the folded biases' gradients.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from idealnerf_tpu_torch.models.attention import SelfAttention
from idealnerf_tpu_torch.models.face_nerf import FaceNeRFConfig, make_field_fn
from idealnerf_tpu_torch.models.nn import init_weights_

VARIANTS = ("face_nerf", "face_nerf_agg", "attention_nerf")


def _unknown(v: str) -> ValueError:
    return ValueError(f"unknown model_variant {v!r}; expected one of "
                      f"{VARIANTS}")


def variant_nerf_config(cfg) -> FaceNeRFConfig:
    """The FaceNeRF topology used by cfg.model_variant."""
    v = cfg.model_variant
    if v == "face_nerf":
        return cfg.face_nerf_config()
    if v == "face_nerf_agg":
        return cfg.face_nerf_config(dim_aud=0, dim_expr=cfg.dim_agg)
    if v == "attention_nerf":
        return cfg.face_nerf_config(dim_aud=cfg.dim_aud + cfg.dim_expr,
                                    dim_expr=0)
    raise _unknown(v)


def init_variant_extras(cfg, generator: Optional[torch.Generator] = None,
                        device=None) -> Dict[str, nn.Module]:
    """The extra (non-NeRF) modules the variant needs: {"agg": two linear
    layers} or {"self_att": SelfAttention}, or none."""
    v = cfg.model_variant
    fused = cfg.dim_aud + cfg.dim_expr
    if v == "face_nerf_agg":
        agg = nn.ModuleList([nn.Linear(fused, cfg.dim_agg, device=device),
                             nn.Linear(cfg.dim_agg, cfg.dim_agg,
                                       device=device)])
        return {"agg": init_weights_(agg, generator)}
    if v == "attention_nerf":
        return {"self_att": SelfAttention(fused, cfg.attn_output_ch,
                                          generator, device)}
    if v == "face_nerf":
        return {}
    raise _unknown(v)


def variant_conditioning(
    params,
    cfg,
    aud_feature: Optional[torch.Tensor],
    expr: Optional[torch.Tensor],
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """-> (aud_arg, expr_arg) to feed the variant's FaceNeRF config."""
    v = cfg.model_variant
    if v == "face_nerf":
        return aud_feature, expr
    if v not in VARIANTS:
        raise _unknown(v)
    fused = torch.cat([aud_feature, expr / 3.0], dim=-1)
    if v == "face_nerf_agg":
        h = fused
        for layer in params["agg"]:
            h = layer(h)  # linear, no activations (reference parity)
        return None, 3.0 * h  # the expr path re-applies the /3
    return params["self_att"](fused[None])[0], None


def build_field_fns(
    params,
    cfg,
    aud_feature: Optional[torch.Tensor],
    expr: Optional[torch.Tensor],
    latent: Optional[torch.Tensor],
    compute_dtype=None,
    use_pallas=False,
):
    """(coarse_fn, fine_fn) for the configured variant (see make_field_fn
    for ``use_pallas``); fine_fn is None without a "fine" network."""
    ncfg = variant_nerf_config(cfg)
    aud_arg, expr_arg = variant_conditioning(params, cfg, aud_feature, expr)

    def mk(model):
        return make_field_fn(model, ncfg, aud_arg, expr_arg, latent,
                             compute_dtype=compute_dtype,
                             use_pallas=use_pallas)

    return mk(params["coarse"]), (mk(params["fine"]) if "fine" in params
                                  else None)
