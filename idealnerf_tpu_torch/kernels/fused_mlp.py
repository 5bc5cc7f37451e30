"""Fused point MLP: (N, 3) points + (N, 3) view directions -> (N, 4) raw
[rgb logits, sigma] in one kernel launch (counterpart of
idealnerf_tpu/kernels/fused_mlp.py, the ``fuse_pe=True`` branch).

The kernel (``csrc/fused_mlp.cu``, CUDA C++ for sm_90a) builds both
positional encodings from the raw coordinates in shared memory and runs
the conditioned MLP with folded per-frame biases through the wmma body it
shares with the render kernels (``csrc/render_body.cuh``). It is the
forward of every training field call (kernels/fused_mlp_grad.py).

``fused_point_mlp`` launches it for CUDA tensors and counts the launch in
``launch_counts``; for CPU tensors it runs ``fused_point_mlp_reference``,
the plain PyTorch version with the same bf16 rounding points (bf16 weights,
PE and post-relu activations, f32 accumulation and biases).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.core.embedding import positional_encoding
from idealnerf_tpu_torch.kernels import build
from idealnerf_tpu_torch.kernels.fused_render import (
    PE_PAD, PED_PAD, PackedNet, _bf16, _check_rays, _mlp_reference,
    _raise_on, _slots, _stream, pack_operands,
)

launch_counts = {"fused_point_mlp": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def encode_points(net: PackedNet, pts: torch.Tensor, dirs: torch.Tensor):
    """-> (pe (N, PE_PAD), ped (N, PED_PAD)): the zero-padded positional
    encodings of points and of the directions as given, rounded to the
    dtype of the net's weights and returned as f32."""
    dt = net.w[0].dtype
    pe = positional_encoding(pts.float(), net.multires)
    ped = positional_encoding(dirs.float(), net.multires_views)
    pe = F.pad(pe, (0, PE_PAD - pe.shape[-1])).to(dt).float()
    ped = F.pad(ped, (0, PED_PAD - ped.shape[-1])).to(dt).float()
    return pe, ped


def point_mlp_reference(net: PackedNet, pts: torch.Tensor,
                        dirs: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on a packed (bf16) net -> (N, 4)."""
    pe, ped = encode_points(net, pts, dirs)
    return _mlp_reference(net, pe, ped @ net.wv0d.float() + net.bv[0])


def point_mlp(net: PackedNet, pts: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
    """The kernel on a packed bf16 net: CUDA tensors launch it, CPU tensors
    take the plain version."""
    if pts.device.type == "cpu":
        return point_mlp_reference(net, pts, dirs)
    if net.w[0].dtype != torch.bfloat16:
        raise TypeError("fused_point_mlp: the kernel takes bf16 weights")
    dev = _check_rays("fused_point_mlp", net, pts=pts, dirs=dirs)
    N = pts.shape[0]
    if pts.shape != (N, 3) or dirs.shape != (N, 3):
        raise ValueError("fused_point_mlp: pts and dirs must both be (N, 3), "
                         f"got {tuple(pts.shape)} and {tuple(dirs.shape)}")
    if N < 1 or N >= 2 ** 31 - 64:
        raise ValueError(f"fused_point_mlp: unsupported N={N}")
    lib = build.load_library()
    table, keep = _slots(net, dev)
    out = torch.empty((N, 4), dtype=torch.float32, device=dev)
    err = lib.fr_point_mlp(pts.data_ptr(), dirs.data_ptr(), out.data_ptr(), N,
                           table, len(net.w), len(net.wv), net.multires,
                           net.multires_views, _stream(dev))
    _raise_on(lib, err, "fused_point_mlp")
    launch_counts["fused_point_mlp"] += 1
    del keep  # stream-ordered: the caching allocator reuses it after the kernel
    return out


def fused_point_mlp(model, folded: Dict, cfg, pts: torch.Tensor,
                    dirs: torch.Tensor) -> torch.Tensor:
    """(N, 4) raw of the FaceNeRF ``model`` with folded biases at (N, 3)
    points and (N, 3) per-point view directions (not normalised here).
    No gradient: training goes through fused_mlp_grad.fused_point_mlp_train."""
    return point_mlp(pack_operands(model, folded, cfg), pts, dirs)


def fused_point_mlp_reference(model, folded: Dict, cfg, pts: torch.Tensor,
                              dirs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fused_point_mlp`` on any device."""
    return point_mlp_reference(pack_operands(model, folded, cfg), pts, dirs)
