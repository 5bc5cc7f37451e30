"""Training path of the fused point MLP: an autograd Function whose forward
is the fused kernel (kernels/fused_mlp.py) and whose backward is a second
kernel that recomputes the forward per tile and back-propagates through it
(counterpart of idealnerf_tpu/kernels/fused_mlp_grad.py).

The backward kernel (``csrc/fused_mlp_grad.cu``, CUDA C++ for sm_90a)
emits f32 gradients of every packed operand: layer weights, folded biases,
the skip layer's pe-part, the view branch, the dir-PE part and the packed
heads. ``unpack_grads`` maps them onto the nn.Linear weights and the folded
biases; gradients of the conditioning slices of W0, the skip layer and
Wv0, and of aud/expr/latent, then reach them through fold_conditioning in
autograd. Points and directions get no gradient (the fine depths are
detached and rays are data), as the JAX VJP returns zeros for them.

``grad_dtype`` picks the backward's recompute and product type:
torch.float32 reproduces f32 autograd (f32 FMAs on the card),
torch.bfloat16 runs bf16 products with f32 accumulation and rounds the
cotangent and each d_h to bf16 before its products, as the TPU kernel does.

For CPU tensors both passes run their plain PyTorch versions
(``point_mlp_reference``, ``point_mlp_grad_reference``), which round at
the kernels' points; ``fused_point_mlp_train_reference`` runs the plain
versions on any device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.kernels import build
from idealnerf_tpu_torch.kernels.fused_mlp import (
    encode_points, point_mlp, point_mlp_reference,
)
from idealnerf_tpu_torch.kernels.fused_render import (
    HEADS, SMEM_LIMIT, PackedNet, _NSLOTS, _SLOT_B, _SLOT_BHEADS, _SLOT_BV,
    _SLOT_W, _SLOT_WALPHA, _SLOT_WRGB, _SLOT_WSKIP, _SLOT_WV, _SLOT_WV0D,
    _check_rays, _raise_on, _slots, _stream, model_leaves, pack_leaves,
)

GRAD_TILE = 64  # points per backward tile (csrc/fused_mlp_grad.cu: GP)

launch_counts = {"fused_point_mlp_grad": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------- plain version

def point_mlp_grad_reference(net: PackedNet, pts: torch.Tensor,
                             dirs: torch.Tensor,
                             g: torch.Tensor) -> PackedNet:
    """The gradient kernel in torch ops: recompute in the dtype of the
    net's weights, then back-propagate with the kernel's rounding points.
    -> a PackedNet of f32 gradients, one per packed operand."""
    dt = net.w[0].dtype

    def rnd(x):
        return x.to(dt).float()

    relu = torch.relu
    W = [x.float() for x in net.w]
    WV = [x.float() for x in net.wv]
    pe, ped = encode_points(net, pts, dirs)
    hs = [rnd(relu(pe @ W[0] + net.b[0]))]
    for i in range(1, len(W)):
        acc = hs[-1] @ W[i]
        if i in net.wskip:
            acc = pe @ net.wskip[i].float() + acc
        hs.append(rnd(relu(acc + net.b[i])))
    hvs = [rnd(relu(hs[-1] @ WV[0] + ped @ net.wv0d.float() + net.bv[0]))]
    for v in range(1, len(WV)):
        hvs.append(rnd(relu(hvs[-1] @ WV[v] + net.bv[v])))

    g16 = F.pad(g.float(), (0, HEADS - 4))
    gb = rnd(g16)
    d_alpha, d_rgb, d_bheads = hs[-1].T @ gb, hvs[-1].T @ gb, g16.sum(0)
    dh = g16 @ net.w_alpha.float().T
    dv = g16 @ net.w_rgb.float().T

    dwv, dbv = [None] * len(WV), [None] * len(WV)
    for v in range(len(WV) - 1, 0, -1):
        dv = dv * (hvs[v] > 0)
        dc = rnd(dv)
        dwv[v], dbv[v] = hvs[v - 1].T @ dc, dv.sum(0)
        dv = dc @ WV[v].T
    dv = dv * (hvs[0] > 0)
    dc = rnd(dv)
    dwv[0], dwv0d, dbv[0] = hs[-1].T @ dc, ped.T @ dc, dv.sum(0)
    dh = dh + dc @ WV[0].T

    dw, db, dskip = [None] * len(W), [None] * len(W), {}
    for i in range(len(W) - 1, 0, -1):
        dh = dh * (hs[i] > 0)
        dc = rnd(dh)
        dw[i], db[i] = hs[i - 1].T @ dc, dh.sum(0)
        if i in net.wskip:
            dskip[i] = pe.T @ dc
        dh = dc @ W[i].T
    dh = dh * (hs[0] > 0)
    dc = rnd(dh)
    dw[0], db[0] = pe.T @ dc, dh.sum(0)
    return PackedNet(w=dw, b=db, wskip=dskip, wv=dwv, bv=dbv, wv0d=dwv0d,
                     w_alpha=d_alpha, w_rgb=d_rgb, b_heads=d_bheads,
                     multires=net.multires,
                     multires_views=net.multires_views, softplus=net.softplus)


# ------------------------------------------------------------------ kernel

def _grad_layout(net: PackedNet) -> Tuple[Dict[int, Tuple[int, tuple]], int]:
    """Slot -> (float offset, shape) of each gradient inside one slab,
    every offset 64-float aligned for wmma accumulator loads; -> (layout,
    slab size G)."""
    items = {_SLOT_W + i: x for i, x in enumerate(net.w)}
    items.update({_SLOT_B + i: x for i, x in enumerate(net.b)})
    items.update({_SLOT_WSKIP + i: x for i, x in net.wskip.items()})
    items.update({_SLOT_WV + v: x for v, x in enumerate(net.wv)})
    items.update({_SLOT_BV + v: x for v, x in enumerate(net.bv)})
    items.update({_SLOT_WV0D: net.wv0d, _SLOT_WALPHA: net.w_alpha,
                  _SLOT_WRGB: net.w_rgb, _SLOT_BHEADS: net.b_heads})
    layout, n = {}, 0
    for slot, x in sorted(items.items()):
        layout[slot] = (n, tuple(x.shape))
        n += -(-x.numel() // 64) * 64
    return layout, n


def point_mlp_grad(net: PackedNet, pts: torch.Tensor, dirs: torch.Tensor,
                   g: torch.Tensor) -> PackedNet:
    """The gradient kernel on a packed net (bf16 or f32 weights): CUDA
    tensors launch it, CPU tensors take the plain version. The same inputs
    on the same card give bitwise-equal gradients."""
    if pts.device.type == "cpu":
        return point_mlp_grad_reference(net, pts, dirs, g)
    dt = net.w[0].dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_point_mlp_grad: weights must be bf16 or f32, "
                        f"got {dt}")
    dev = _check_rays("fused_point_mlp_grad", net, pts=pts, dirs=dirs, g=g)
    N = pts.shape[0]
    if pts.shape != (N, 3) or dirs.shape != (N, 3) or g.shape != (N, 4):
        raise ValueError("fused_point_mlp_grad: pts, dirs, g must be (N, 3), "
                         f"(N, 3), (N, 4); got {tuple(pts.shape)}, "
                         f"{tuple(dirs.shape)}, {tuple(g.shape)}")
    if N < 1 or N >= 2 ** 31 - GRAD_TILE:
        raise ValueError(f"fused_point_mlp_grad: unsupported N={N}")
    lib = build.load_library()
    use_bf16 = int(dt == torch.bfloat16)
    if lib.fr_point_mlp_grad_smem_bytes(use_bf16) > SMEM_LIMIT:
        raise ValueError("fused_point_mlp_grad: shared memory over the limit")
    layout, G = _grad_layout(net)
    W, WV = net.width, net.width // 2
    n_tiles = -(-N // GRAD_TILE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(n_tiles, sms)  # one block per SM: ~175-221 KB shared memory
    act_stride = GRAD_TILE * (len(net.w) * W + len(net.wv) * WV)
    act = torch.empty(blocks * act_stride, dtype=dt, device=dev)
    slabs = torch.zeros((blocks, G), dtype=torch.float32, device=dev)
    out = torch.empty(G, dtype=torch.float32, device=dev)
    table, keep = _slots(net, dev)
    offs = (ctypes.c_longlong * _NSLOTS)(*([-1] * _NSLOTS))
    for slot, (off, _) in layout.items():
        offs[slot] = off
    err = lib.fr_point_mlp_grad(
        pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), act.data_ptr(),
        act_stride, slabs.data_ptr(), out.data_ptr(), G, blocks, N, table,
        offs, len(net.w), len(net.wv), net.multires, net.multires_views,
        use_bf16, _stream(dev))
    _raise_on(lib, err, "fused_point_mlp_grad")
    launch_counts["fused_point_mlp_grad"] += 1
    del keep, act, slabs  # stream-ordered reuse by the caching allocator

    def at(slot):
        off, shape = layout[slot]
        n = 1
        for s in shape:
            n *= s
        return out[off:off + n].view(shape)

    return PackedNet(
        w=[at(_SLOT_W + i) for i in range(len(net.w))],
        b=[at(_SLOT_B + i) for i in range(len(net.b))],
        wskip={i: at(_SLOT_WSKIP + i) for i in net.wskip},
        wv=[at(_SLOT_WV + v) for v in range(len(net.wv))],
        bv=[at(_SLOT_BV + v) for v in range(len(net.bv))],
        wv0d=at(_SLOT_WV0D), w_alpha=at(_SLOT_WALPHA), w_rgb=at(_SLOT_WRGB),
        b_heads=at(_SLOT_BHEADS), multires=net.multires,
        multires_views=net.multires_views, softplus=net.softplus)


# ------------------------------------------------------- autograd plumbing

def unpack_grads(grads: PackedNet, cfg, leaves) -> List[torch.Tensor]:
    """Packed-operand gradients -> one gradient per model_leaves tensor.
    The conditioning columns of W0, the skip layer and Wv0 get zeros here:
    their gradient arrives through the folded biases."""
    D, pe, in_all, W = cfg.depth, cfg.input_ch, cfg.input_ch_all, cfg.width
    nv = 1 + D // 4
    wp, wvs = leaves[:D], leaves[2 * D:2 * D + nv]
    d_pts = []
    for i in range(D):
        if i == 0 or (i - 1) in cfg.skips:
            dw = torch.zeros(wp[i].shape, dtype=torch.float32,
                             device=wp[i].device)
            if i == 0:
                dw[:, :pe] = grads.w[0][:pe].T
            else:
                dw[:, :pe] = grads.wskip[i][:pe].T
                dw[:, in_all:] = grads.w[i].T
        else:
            dw = grads.w[i].T
        d_pts.append(dw)
    dv0 = torch.zeros(wvs[0].shape, dtype=torch.float32, device=wvs[0].device)
    dv0[:, :W] = grads.wv[0].T
    dv0[:, W:W + cfg.input_ch_views] = grads.wv0d[:cfg.input_ch_views].T
    d_views = [dv0] + [x.T for x in grads.wv[1:]]
    out = (d_pts + list(grads.b) + d_views + list(grads.bv)
           + [grads.w_alpha[:, 3][None], grads.b_heads[3:4],
              grads.w_rgb[:, :3].T, grads.b_heads[:3]])
    return [d.to(leaf.dtype).contiguous() for d, leaf in zip(out, leaves)]


class _FusedPointMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, grad_dtype, plain, pts, dirs, *leaves):
        net = pack_leaves(cfg, leaves)
        raw = (point_mlp_reference if plain else point_mlp)(net, pts, dirs)
        ctx.save_for_backward(pts, dirs, *leaves)
        ctx.cfg, ctx.grad_dtype, ctx.plain = cfg, grad_dtype, plain
        return raw

    @staticmethod
    def backward(ctx, g):
        pts, dirs, *leaves = ctx.saved_tensors
        net = pack_leaves(ctx.cfg, leaves, ctx.grad_dtype)
        grad_fn = point_mlp_grad_reference if ctx.plain else point_mlp_grad
        grads = grad_fn(net, pts, dirs, g.float().contiguous())
        return (None, None, None, None, None,
                *unpack_grads(grads, ctx.cfg, leaves))


def fused_point_mlp_train(cfg, model, folded: Dict, pts: torch.Tensor,
                          dirs: torch.Tensor,
                          grad_dtype=torch.float32) -> torch.Tensor:
    """(N, 4) raw, differentiable with respect to the FaceNeRF ``model``'s
    parameters and the folded biases: the fused kernel forward and the
    rematerialising gradient kernel (plain versions for CPU tensors)."""
    return _FusedPointMLP.apply(cfg, grad_dtype, False, pts, dirs,
                                *model_leaves(model, folded, cfg))


def fused_point_mlp_train_reference(cfg, model, folded: Dict,
                                    pts: torch.Tensor, dirs: torch.Tensor,
                                    grad_dtype=torch.float32) -> torch.Tensor:
    """``fused_point_mlp_train`` with the plain versions of both kernels
    (forward and explicit backward in torch ops) on any device."""
    return _FusedPointMLP.apply(cfg, grad_dtype, True, pts, dirs,
                                *model_leaves(model, folded, cfg))
