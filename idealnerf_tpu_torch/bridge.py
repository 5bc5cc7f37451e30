"""Weight bridge between the JAX package's parameter tree and the port.

The JAX tree is given as nested dicts and lists of numpy arrays (the
caller does the ``np.asarray`` on the JAX side; this module never imports
jax). Dense weights are (in, out) in JAX and (out, in) in ``nn.Linear``;
conv weights are the same in both: Conv1d and Conv2d (out, in, k...),
ConvTranspose2d (in, out, k, k). The GRU of SlotAttention is (in, 3·out)
per gate matrix in JAX and (3·out, in) in ``nn.GRUCell``. The aux nets
of the second stage: FAN's flat dict is the same on both sides; the VGG
nets' 3x3 kernels are HWIO in JAX ({name: {"w", "b"}}) and OIHW here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from idealnerf_tpu_torch.models.attention import (
    AttentionSets, SelfAttention, SlotAttention,
)
from idealnerf_tpu_torch.models.audio_net import (
    AudioAttNet, AudioNet, DeepSpeechAudNet,
)
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF
from idealnerf_tpu_torch.models.face_unet import FaceUNet

_LAYERS = {SelfAttention: ("q", "k", "v", "out"),
           AttentionSets: ("d1", "d2", "d3", "d4", "d5", "d6"),
           SlotAttention: ("dense7", "q", "k", "v", "mlp1", "mlp2")}
_NORMS = ("ln_input", "ln_slots", "ln_pre_ff")


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


def _slot_extras_in(m: SlotAttention, tree) -> None:
    for lin, d in zip(m.dense, tree["dense"], strict=True):
        _dense_in(lin, d)
    for name in _NORMS:
        _set(getattr(m, name).weight, tree[name]["g"])
        _set(getattr(m, name).bias, tree[name]["b"])
    _set(m.slots_mu, tree["slots_mu"])
    _set(m.slots_sigma, tree["slots_sigma"])
    _set(m.gru.weight_ih, np.asarray(tree["gru"]["wi"]).T)
    _set(m.gru.weight_hh, np.asarray(tree["gru"]["wh"]).T)
    _set(m.gru.bias_ih, tree["gru"]["bi"])
    _set(m.gru.bias_hh, tree["gru"]["bh"])


def _slot_extras_out(m: SlotAttention) -> Dict[str, Any]:
    return {"dense": [_dense_out(lin) for lin in m.dense],
            **{name: {"g": _np(getattr(m, name).weight),
                      "b": _np(getattr(m, name).bias)} for name in _NORMS},
            "slots_mu": _np(m.slots_mu), "slots_sigma": _np(m.slots_sigma),
            "gru": {"wi": _np(m.gru.weight_ih).T.copy(),
                    "wh": _np(m.gru.weight_hh).T.copy(),
                    "bi": _np(m.gru.bias_ih), "bh": _np(m.gru.bias_hh)}}


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
        elif isinstance(module, nn.Linear):
            _dense_in(module, tree)
        elif type(module) in _LAYERS:
            for name in _LAYERS[type(module)]:
                _dense_in(getattr(module, name), tree[name])
            if isinstance(module, SlotAttention):
                _slot_extras_in(module, tree)
        elif isinstance(module, FaceUNet):
            for conv, d in zip([*module.enc, *module.dec],
                               [*tree["enc"], *tree["dec"]], strict=True):
                _conv_in(conv, d)
        elif isinstance(module, nn.ModuleList):
            for sub, d in zip(module, tree, strict=True):
                load_module_(sub, d)
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
    if isinstance(module, nn.Linear):
        return _dense_out(module)
    if type(module) in _LAYERS:
        tree = {name: _dense_out(getattr(module, name))
                for name in _LAYERS[type(module)]}
        if isinstance(module, SlotAttention):
            tree.update(_slot_extras_out(module))
        return tree
    if isinstance(module, FaceUNet):
        return {"enc": [_conv_out(c) for c in module.enc],
                "dec": [_conv_out(c) for c in module.dec]}
    if isinstance(module, nn.ModuleList):
        return [module_to_tree(sub) for sub in module]
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


def fan_from_jax(params, device=None):
    """A JAX FAN parameter dict (flat, torch names, as numpy) -> a
    ``pipeline.fan.FAN`` with as many stacks."""
    from idealnerf_tpu_torch.pipeline.fan import FAN

    return FAN.from_state_dict(params, device=device)


def fan_to_jax(fan: nn.Module) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in fan.state_dict().items()}


def _vgg_in(convs, params) -> None:
    with torch.no_grad():
        for name, conv in convs:
            _set(conv.weight, np.asarray(params[name]["w"]).transpose(
                3, 2, 0, 1))
            _set(conv.bias, np.asarray(params[name]["b"]))


def _vgg_out(convs) -> Dict[str, Dict[str, np.ndarray]]:
    return {name: {"w": _np(conv.weight).transpose(2, 3, 1, 0).copy(),
                   "b": _np(conv.bias)} for name, conv in convs}


def _vgg16_convs(net) -> list:
    """The convs the JAX VGG16 holds, through relu4_3 (its index as its
    name); the port's net also holds relu5_3's, for LPIPS."""
    from idealnerf_tpu_torch.losses.vgg import VGG16_CONVS, VGG16_TAPS

    return [(str(i), net[i]) for i, _, _ in VGG16_CONVS
            if i < VGG16_TAPS[-1]]


def vgg16_from_jax(params, device=None):
    """JAX ``init_vgg16`` params (as numpy) -> a ``losses.vgg.VGG16``; its
    convs past relu4_3, which the JAX net lacks, keep the seed-0 He
    draws."""
    from idealnerf_tpu_torch.losses.vgg import VGG16

    net = VGG16(torch.Generator().manual_seed(0))
    _vgg_in(_vgg16_convs(net), params)
    return net.to(device)


def vgg16_to_jax(net: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    return _vgg_out(_vgg16_convs(net))


def vggface_from_jax(params, device=None):
    """JAX ``init_vggface`` params (as numpy) -> a ``losses.vgg.VGGFace``."""
    from idealnerf_tpu_torch.losses.vgg import VGGFace

    net = VGGFace()
    _vgg_in(net.named_children(), params)
    return net.to(device)


def vggface_to_jax(net: nn.Module) -> Dict[str, Dict[str, np.ndarray]]:
    return _vgg_out(net.named_children())
