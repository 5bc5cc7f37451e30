"""Fused point MLP: (N, 3) points + (N, 3) view directions -> (N, 4) raw
[rgb logits, sigma] in one kernel launch (counterpart of
idealnerf_tpu/kernels/fused_mlp.py, both branches of ``fuse_pe``).

Two kernels in ``csrc/fused_mlp.cuh`` (CUDA C++ for sm_90a) run the
conditioned MLP with folded per-frame biases on the wgmma chain the render
kernels run (``csrc/chain.cuh``), fed by the net's weight stream with one
more stage than theirs: view layer 0's dir-PE part, a per-point product
(``fused_render.chain_weight_stream(net, dir_stage=True)``), each at the
instance of the net's width (``fused_render.kernel_width``: 128, 256 or
512; a narrower net runs zero-padded). One block per SM walks a
contiguous run of tiles (128 points, 64 at W=512; ``point_launch_config``):

- ``point_mlp`` (``fuse_pe=True``) builds both positional encodings from
  the raw coordinates in shared memory. It is the forward of every
  training field call (kernels/fused_mlp_grad.py).
- ``point_mlp_pe`` (``fuse_pe=False``) reads encodings built outside the
  kernel, (N, PE_PAD) and (N, PED_PAD) bf16 rows. Its caller is the
  kernel-diagnosis path (``idealnerf_tpu_torch.scripts.kdiag2``, rung v3).

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``launch_counts``; for CPU tensors it runs the plain PyTorch version with
the same bf16 rounding points (bf16 weights, PE and post-relu activations,
f32 accumulation and biases).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.core.embedding import positional_encoding
from idealnerf_tpu_torch.kernels import build
from idealnerf_tpu_torch.kernels.fused_render import (
    CHAIN_TILE, KERNEL_WIDTH, PE_PAD, PED_PAD, SMEM_LIMIT, PackedNet,
    _chain_args,
    _check_cuda, _check_rays, _mlp_reference, _raise_on, _stream,
    chain_tile, entry, pack_operands, widen,
)

launch_counts = {"fused_point_mlp": 0, "fused_point_mlp_pe": 0}
# the weight ring's stages in the point kernels
_POINT_RING = 4


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


def point_mlp_pe_reference(net: PackedNet, pe: torch.Tensor,
                           ped: torch.Tensor) -> torch.Tensor:
    """Plain version of the encoded-input kernel -> (N, 4)."""
    pe, ped = pe.float(), ped.float()
    return _mlp_reference(net, pe, ped @ net.wv0d.float() + net.bv[0])


def point_mlp_reference(net: PackedNet, pts: torch.Tensor,
                        dirs: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on a packed (bf16) net -> (N, 4)."""
    return point_mlp_pe_reference(net, *encode_points(net, pts, dirs))


def _point_plan(lib, N: int, sms: int, ring: int = _POINT_RING,
                smem=None, width: int = KERNEL_WIDTH):
    """(tiles per block, blocks, ring stages) of a point kernel on N
    points at the kernels' ``width``: the tiles (chain_tile points) split
    evenly over at most one wave of ``sms`` blocks, each walking a
    contiguous run of them. ``smem`` (ring stages -> shared memory bytes)
    is the point kernels' by default; the gradient kernel's pass A gives
    its own."""
    if (smem or entry(lib, "fr_point_smem_bytes", width))(ring) > SMEM_LIMIT:
        raise ValueError(f"a ring of {ring} stages does not fit the point "
                         f"kernels' shared memory at W={width}; ROADMAP.md "
                         "B10")
    tiles = -(-N // chain_tile(width))
    per_block = -(-tiles // sms)
    return per_block, -(-tiles // per_block), ring


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def point_launch_config(N: int, width: int = KERNEL_WIDTH) -> Dict[str, int]:
    """The point kernels' launch on N points on the current card at the
    kernels' ``width``: tiles per block, blocks, dynamic shared memory,
    stage bytes and ring depth."""
    lib = build.load_library()
    per_block, blocks, ring = _point_plan(
        lib, N, _sm_count(torch.cuda.current_device()), width=width)
    return {"tiles_per_block": per_block, "blocks": blocks,
            "smem_bytes": entry(lib, "fr_point_smem_bytes", width)(ring),
            "stage_bytes": lib.fr_stage_bytes(), "ring_stages": ring}


def _check_n(name: str, N: int) -> None:
    if N < 1 or N >= 2 ** 31 - CHAIN_TILE:
        raise ValueError(f"{name}: unsupported N={N}")


def launch_point_kernel(net: PackedNet, a: torch.Tensor, b: torch.Tensor,
                        encoded: bool, plan=None) -> torch.Tensor:
    """One launch of K4 (``a``, ``b``: points and directions) or, with
    ``encoded``, K5 (PE and dir-PE rows) on checked CUDA operands -> (N, 4)
    raw. ``plan`` (tiles per block, ring stages) replaces the launch plan
    of ``_point_plan`` (a point's output does not depend on it). Counts
    nothing: the wrappers count their launches."""
    dev, N, W = a.device, a.shape[0], net.width
    lib = build.load_library()
    if plan is None:
        per_block, _, ring = _point_plan(lib, N, _sm_count(dev), width=W)
    else:
        per_block, ring = plan
    table, keep, ws, n_stages = _chain_args(net, dev, dir_stage=True)
    out = torch.empty((N, 4), dtype=torch.float32, device=dev)
    if encoded:
        err = entry(lib, "fr_point_mlp_pe", W)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), N, per_block, table,
            len(net.w), len(net.wv), ws, n_stages, ring, _stream(dev))
    else:
        err = entry(lib, "fr_point_mlp", W)(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), N, per_block, table,
            len(net.w), len(net.wv), net.multires, net.multires_views, ws,
            n_stages, ring, _stream(dev))
    _raise_on(lib, err, "fused_point_mlp_pe" if encoded
              else "fused_point_mlp")
    del keep  # stream-ordered: the caching allocator reuses it after the kernel
    return out


def point_mlp(net: PackedNet, pts: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
    """The kernel on a packed bf16 net: CUDA tensors launch it, CPU tensors
    take the plain version."""
    if pts.device.type == "cpu":
        return point_mlp_reference(net, pts, dirs)
    if net.w[0].dtype != torch.bfloat16:
        raise TypeError("fused_point_mlp: the kernel takes bf16 weights")
    net = widen(net)
    _check_rays("fused_point_mlp", net, pts=pts, dirs=dirs)
    N = pts.shape[0]
    if pts.shape != (N, 3) or dirs.shape != (N, 3):
        raise ValueError("fused_point_mlp: pts and dirs must both be (N, 3), "
                         f"got {tuple(pts.shape)} and {tuple(dirs.shape)}")
    _check_n("fused_point_mlp", N)
    out = launch_point_kernel(net, pts, dirs, encoded=False)
    launch_counts["fused_point_mlp"] += 1
    return out


def point_mlp_pe(net: PackedNet, pe: torch.Tensor,
                 ped: torch.Tensor) -> torch.Tensor:
    """The encoded-input kernel on a packed bf16 net: (N, PE_PAD) and (N,
    PED_PAD) bf16 encodings -> (N, 4). CUDA tensors launch it, CPU tensors
    take the plain version."""
    if pe.device.type == "cpu":
        return point_mlp_pe_reference(net, pe, ped)
    if net.w[0].dtype != torch.bfloat16:
        raise TypeError("fused_point_mlp_pe: the kernel takes bf16 weights")
    _check_cuda("fused_point_mlp_pe", torch.bfloat16, 16, pe=pe, ped=ped)
    net = widen(net)
    _check_rays("fused_point_mlp_pe", net)
    N = pe.shape[0]
    if pe.shape != (N, PE_PAD) or ped.shape != (N, PED_PAD):
        raise ValueError(f"fused_point_mlp_pe: pe and ped must be (N, {PE_PAD})"
                         f" and (N, {PED_PAD}), got {tuple(pe.shape)} and "
                         f"{tuple(ped.shape)}")
    _check_n("fused_point_mlp_pe", N)
    out = launch_point_kernel(net, pe, ped, encoded=True)
    launch_counts["fused_point_mlp_pe"] += 1
    return out


def fused_point_mlp(model, folded: Dict, cfg, pts: torch.Tensor,
                    dirs: torch.Tensor, fuse_pe: bool = True) -> torch.Tensor:
    """(N, 4) raw of the FaceNeRF ``model`` with folded biases at (N, 3)
    points and (N, 3) per-point view directions (not normalised here).
    ``fuse_pe=False`` builds the encodings outside the kernel, rounded to
    bf16 (as the JAX branch does), and launches the encoded-input kernel.
    No gradient: training goes through fused_mlp_grad.fused_point_mlp_train."""
    net = pack_operands(model, folded, cfg)
    if fuse_pe:
        return point_mlp(net, pts, dirs)
    pe, ped = encode_points(net, pts, dirs)
    return point_mlp_pe(net, pe.to(net.w[0].dtype).contiguous(),
                        ped.to(net.w[0].dtype).contiguous())


def fused_point_mlp_reference(model, folded: Dict, cfg, pts: torch.Tensor,
                              dirs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``fused_point_mlp`` (either ``fuse_pe``:
    both round the encodings to bf16 at the same point) on any device."""
    return point_mlp_reference(pack_operands(model, folded, cfg), pts, dirs)
