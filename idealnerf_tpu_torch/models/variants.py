"""Model-variant machinery (counterpart of models/variants.py).

Only "face_nerf" (the paper head model, cond = aud ‖ expr/3 ‖ latent) is
ported so far. "face_nerf_agg" and "attention_nerf" wait for ROADMAP.md
item A10 ("Variants and second-stage trainers") and raise until then.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from idealnerf_tpu_torch.models.face_nerf import FaceNeRFConfig, make_field_fn

VARIANTS = ("face_nerf", "face_nerf_agg", "attention_nerf")


def _check(v: str) -> None:
    if v == "face_nerf":
        return
    if v in VARIANTS:
        raise NotImplementedError(
            f"model_variant {v!r} is not ported yet (ROADMAP.md A10: "
            "variants and second-stage trainers)")
    raise ValueError(f"unknown model_variant {v!r}; expected one of {VARIANTS}")


def variant_nerf_config(cfg) -> FaceNeRFConfig:
    """The FaceNeRF topology used by cfg.model_variant."""
    _check(cfg.model_variant)
    return cfg.face_nerf_config()


def variant_conditioning(
    params,
    cfg,
    aud_feature: Optional[torch.Tensor],
    expr: Optional[torch.Tensor],
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """-> (aud_arg, expr_arg) to feed the variant's FaceNeRF config."""
    _check(cfg.model_variant)
    return aud_feature, expr


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
