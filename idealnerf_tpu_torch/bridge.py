"""Weight bridge between the JAX package's parameter tree and the port.

The JAX tree is given as nested dicts and lists of numpy arrays (the
caller does the ``np.asarray`` on the JAX side; this module never imports
jax). Dense weights are (in, out) in JAX and (out, in) in ``nn.Linear``;
Conv1d weights are (out, in, k) in both.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from idealnerf_tpu_torch.models.audio_net import (
    AudioAttNet, AudioNet, DeepSpeechAudNet,
)
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF


def _set(p: torch.Tensor, value) -> None:
    v = torch.from_numpy(np.array(value, copy=True))
    if tuple(v.shape) != tuple(p.shape):
        raise ValueError(f"shape {tuple(v.shape)} does not fit {tuple(p.shape)}")
    p.copy_(v.to(dtype=p.dtype, device=p.device))


def _np(p: torch.Tensor) -> np.ndarray:
    return p.detach().cpu().numpy().copy()


def _dense_in(lin: nn.Linear, d) -> None:
    _set(lin.weight, np.asarray(d["w"]).T)
    _set(lin.bias, np.asarray(d["b"]))


def _dense_out(lin: nn.Linear) -> Dict[str, np.ndarray]:
    return {"w": _np(lin.weight).T.copy(), "b": _np(lin.bias)}


def _conv_in(conv: nn.Conv1d, d) -> None:
    _set(conv.weight, np.asarray(d["w"]))
    _set(conv.bias, np.asarray(d["b"]))


def _conv_out(conv: nn.Conv1d) -> Dict[str, np.ndarray]:
    return {"w": _np(conv.weight), "b": _np(conv.bias)}


def load_module_(module: nn.Module, tree) -> nn.Module:
    """Copy one JAX sub-tree into the matching port module, in place."""
    with torch.no_grad():
        if isinstance(module, FaceNeRF):
            if len(tree["pts"]) != len(module.pts_linears):
                raise ValueError("trunk depth differs")
            for lin, d in zip(module.pts_linears, tree["pts"]):
                _dense_in(lin, d)
            if module.cfg.use_viewdirs:
                if len(tree["views"]) != len(module.views_linears):
                    raise ValueError("view-branch depth differs")
                for lin, d in zip(module.views_linears, tree["views"]):
                    _dense_in(lin, d)
                _dense_in(module.alpha_linear, tree["alpha"])
                _dense_in(module.rgb_linear, tree["rgb"])
            else:
                _dense_in(module.output_linear, tree["output"])
        elif isinstance(module, AudioNet):
            for conv, d in zip(module.conv, tree["conv"], strict=True):
                _conv_in(conv, d)
            for lin, d in zip(module.fc, tree["fc"], strict=True):
                _dense_in(lin, d)
        elif isinstance(module, AudioAttNet):
            for conv, d in zip(module.conv, tree["conv"], strict=True):
                _conv_in(conv, d)
            _dense_in(module.att, tree["att"])
        elif isinstance(module, DeepSpeechAudNet):
            _dense_in(module.fc, tree["fc"])
        elif isinstance(module, nn.ModuleDict):
            for name, sub in module.items():
                load_module_(sub, tree[name])
        else:
            raise TypeError(f"no bridge for {type(module).__name__}")
    return module


def module_to_tree(module: nn.Module) -> Any:
    """The JAX-layout numpy tree of a port module (or ModuleDict)."""
    if isinstance(module, FaceNeRF):
        tree = {"pts": [_dense_out(lin) for lin in module.pts_linears]}
        if module.cfg.use_viewdirs:
            tree["views"] = [_dense_out(lin) for lin in module.views_linears]
            tree["alpha"] = _dense_out(module.alpha_linear)
            tree["rgb"] = _dense_out(module.rgb_linear)
        else:
            tree["output"] = _dense_out(module.output_linear)
        return tree
    if isinstance(module, AudioNet):
        return {"conv": [_conv_out(c) for c in module.conv],
                "fc": [_dense_out(lin) for lin in module.fc]}
    if isinstance(module, AudioAttNet):
        return {"conv": [_conv_out(c) for c in module.conv],
                "att": _dense_out(module.att)}
    if isinstance(module, DeepSpeechAudNet):
        return {"fc": _dense_out(module.fc)}
    if isinstance(module, nn.ModuleDict):
        return {name: module_to_tree(sub) for name, sub in module.items()}
    raise TypeError(f"no bridge for {type(module).__name__}")


def params_from_jax(tree, cfg, device=None) -> nn.ModuleDict:
    """JAX ``init_train_state(...).params`` (as numpy) -> the port's
    parameter ModuleDict for ``cfg``."""
    from idealnerf_tpu_torch.train.state import init_params

    params = init_params(cfg, 1, device=device).params
    return load_module_(params, {k: tree[k] for k in params.keys()})


def params_to_jax(params: nn.ModuleDict) -> Dict[str, Any]:
    """The port's parameter ModuleDict -> JAX-layout numpy tree."""
    return module_to_tree(params)


def train_state_from_jax(params_tree, latent_codes, cfg, device=None):
    """A JAX ``TrainState``'s params and latent table (as numpy) -> a port
    TrainState at step 0 with a fresh Adam over them (the JAX optimizer
    state is not carried over)."""
    from idealnerf_tpu_torch.train.state import TrainState, make_optimizer

    params = params_from_jax(params_tree, cfg).to(device)
    latent = nn.Parameter(torch.from_numpy(
        np.array(latent_codes, dtype=np.float32, copy=True)).to(device))
    return TrainState(step=0, params=params, latent_codes=latent,
                      optimizer=make_optimizer(cfg, params, latent))


def torso_params_from_jax(tree, cfg, device=None) -> nn.ModuleDict:
    """JAX ``init_torso_params`` / ``TorsoTrainer.torso_params`` (as numpy)
    -> the port's {"coarse", "fine"} torso ModuleDict for ``cfg``."""
    from idealnerf_tpu_torch.train.torso import init_torso_params

    params = init_torso_params(cfg, device=device)
    return load_module_(params, {k: tree[k] for k in params.keys()})


def torso_params_to_jax(params: nn.ModuleDict) -> Dict[str, Any]:
    """The port's torso ModuleDict -> JAX-layout numpy tree."""
    return module_to_tree(params)


def seeded_tree(cfg, seed: int) -> Dict[str, Any]:
    """The JAX-layout parameter tree of ``cfg`` drawn with numpy from
    ``seed``: every dense and conv weight xavier-uniform and every bias
    0.01, as ``init_train_state`` initialises them. The JAX package takes
    the tree as it is and the port through ``params_from_jax``, so one seed
    gives the same model on both sides and on every machine."""
    from idealnerf_tpu_torch.train.state import init_params

    rng = np.random.RandomState(seed)

    def draw(node):
        if isinstance(node, dict) and "w" in node:
            w = np.asarray(node["w"])
            if w.ndim == 2:              # dense (in, out)
                fan_in, fan_out = w.shape
            else:                        # conv (out, in, k)
                fan_in = w.shape[1] * w.shape[2]
                fan_out = w.shape[0] * w.shape[2]
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            return {"w": rng.uniform(-lim, lim, w.shape).astype(np.float32),
                    "b": np.full(np.shape(node["b"]), 0.01, np.float32)}
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return [draw(v) for v in node]

    return draw(params_to_jax(init_params(cfg, 1).params))


def seeded_conditioning(cfg, seed: int) -> Dict[str, np.ndarray]:
    """One frame's conditioning drawn with numpy from ``seed``: an AudioNet
    feature (dim_aud) of unit scale, an expression (dim_expr) and a latent
    code (dim_latent) near the table's initial ones."""
    rng = np.random.RandomState(seed + 1)
    return {"aud": rng.randn(cfg.dim_aud).astype(np.float32),
            "expr": rng.randn(cfg.dim_expr).astype(np.float32),
            "latent": (1.0 + 0.1 * rng.randn(cfg.dim_latent))
            .astype(np.float32)}
