"""Experiment configuration (counterpart of idealnerf_tpu/config.py).

Field names and defaults are those of the JAX ``ExperimentConfig``, so
reference ``key = value`` config files parse the same way. Two knobs of
the JAX package have no counterpart here: ``flat_optimizer`` (one flat
Adam vector) and ``sampler_approx`` (approximate top-k); ``from_file``
ignores them like any other unknown key.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from idealnerf_tpu_torch.core.render import RenderConfig
from idealnerf_tpu_torch.models.face_nerf import FaceNeRFConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # experiment dirs
    expname: str = "exp"
    basedir: str = "logs"
    datadir: str = "dataset/Obama"
    vis_path: str = ""
    save_path: str = ""
    evalExpr_path: str = ""

    # conditioning dims
    dim_aud: int = 64
    dim_expr: int = 0
    dim_latent: int = 32
    dim_aud_body: int = 32

    # ray budget
    N_rand: int = 2048
    mouth_rays: int = 0
    torso_rays: int = 0
    sample_rate: float = 0.95

    # model variant
    model_variant: str = "face_nerf"  # face_nerf | face_nerf_agg | attention_nerf
    dim_agg: int = 64
    attn_output_ch: int = 256

    # network
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    use_viewdirs: bool = True

    # rendering
    N_samples: int = 64
    N_importance: int = 128
    perturb: float = 1.0
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    near: float = 0.3
    far: float = 0.9
    density_activation: str = "relu"  # "relu" (reference parity) | "softplus"

    # optimization
    train_fused: int = 2     # train-step field path on a CUDA device: 0 =
                             # plain autograd, 1 = fused kernels with the
                             # f32 backward, 2 = with the bf16 backward
                             # (kernels/fused_mlp_grad.py); ignored on cpu
    lrate: float = 8e-4
    lrate_decay: int = 500
    lc_weight: float = 0.0005
    N_iters: int = 90
    batch_size: int = 1

    # audio
    aud_file: str = "aud.npy"
    win_size: int = 16
    smo_size: int = 8
    nosmo_iters: int = 300000

    # dataset
    gt_dirs: str = "head_imgs"
    testskip: int = 8
    with_test: int = 0
    test_file: str = ""

    # logging / checkpoint cadence
    i_print: int = 10
    i_img: int = 500
    i_weights: int = 5000
    i_testset: int = 1000
    i_video: int = 5000
    ft_path: Optional[str] = None

    # legacy/compat knobs accepted from reference config files
    chunk: int = 1024 * 8
    netchunk: int = 1024 * 64
    num_work: int = 1
    gpu_num: int = 0
    precrop_iters: int = 0
    precrop_frac: float = 0.5
    render_factor: int = 0
    use_highlight: int = 0

    def render_config(self) -> RenderConfig:
        return RenderConfig(
            n_samples=self.N_samples,
            n_importance=self.N_importance,
            perturb=self.perturb > 0,
            lindisp=self.lindisp,
            raw_noise_std=self.raw_noise_std,
            white_bkgd=self.white_bkgd,
            density_activation=self.density_activation,
        )

    def face_nerf_config(self, dim_aud: Optional[int] = None,
                         dim_expr: Optional[int] = None,
                         dim_latent: Optional[int] = None) -> FaceNeRFConfig:
        from idealnerf_tpu_torch.core.embedding import pe_dim

        return FaceNeRFConfig(
            depth=self.netdepth,
            width=self.netwidth,
            input_ch=pe_dim(3, self.multires),
            input_ch_views=pe_dim(3, self.multires_views),
            dim_aud=self.dim_aud if dim_aud is None else dim_aud,
            dim_expr=self.dim_expr if dim_expr is None else dim_expr,
            dim_latent=self.dim_latent if dim_latent is None else dim_latent,
            use_viewdirs=self.use_viewdirs,
            multires=self.multires,
            multires_views=self.multires_views,
            density_activation=self.density_activation,
        )

    @classmethod
    def from_file(cls, path: str, **overrides) -> "ExperimentConfig":
        """Parse a reference-style ``key = value`` config .txt."""
        values = {}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        aliases = {"N_sample": "N_samples"}  # typo in may/blend_highlight.txt
        with open(path) as fh:
            for line in fh:
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                key, val = (s.strip() for s in line.split("=", 1))
                key = aliases.get(key, key)
                if key not in fields:
                    continue  # unknown reference flags are ignored, not fatal
                typ = fields[key].type
                if typ in ("int", int):
                    values[key] = int(val)
                elif typ in ("float", float):
                    values[key] = float(val)
                elif typ in ("bool", bool):
                    values[key] = val.lower() in ("1", "true", "yes")
                else:
                    values[key] = val
        values.update(overrides)
        return cls(**values)

    def write(self, path: str) -> None:
        """Dump args like the reference's write_config."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            for f in sorted(dataclasses.fields(self), key=lambda f: f.name):
                fh.write(f"{f.name} = {getattr(self, f.name)}\n")
