"""Training path of the fused point MLP: an autograd Function whose forward
is the fused kernel (kernels/fused_mlp.py) and whose backward recomputes
the forward per tile and back-propagates through it (counterpart of
idealnerf_tpu/kernels/fused_mlp_grad.py).

The backward (``csrc/fused_mlp_grad.cuh``, CUDA C++ for sm_90a) emits f32
gradients of every packed operand: layer weights, folded biases, the skip
layer's pe-part, the view branch, the dir-PE part and the packed heads.
``unpack_grads`` maps them onto the nn.Linear weights and the folded
biases; gradients of the conditioning slices of W0, the skip layer and
Wv0, and of aud/expr/latent, then reach them through fold_conditioning in
autograd. Points and directions get no gradient (the fine depths are
detached and rays are data), as the JAX VJP returns zeros for them.

``grad_dtype`` picks the backward's recompute and product type:
torch.float32 reproduces f32 autograd (f32 FFMAs on the card),
torch.bfloat16 runs bf16 products with f32 accumulation and rounds each
d_h to bf16 before its products, as the TPU kernel does (d_h from the
heads takes the unrounded cotangent, the heads' weight gradients the
rounded one). Either backward is two kernels, each at the instance of the
net's width (``fused_render.kernel_width``: 128, 256 or 512; a narrower
net runs widened and its gradients are cut back). bf16: ``grad_pass_a``
recomputes and runs d_h back on the wgmma chain of the forward kernels
(``csrc/chain.cuh``), fed by ``grad_weight_stream``: the point kernels'
stream without the heads, then the transposed matrices of the backward.
It writes every activation and rounded d_h of all N points to the planes
of ``grad_planes`` with streaming stores. ``grad_pass_b`` computes every
weight gradient as a long-K product over those points. On f32 weights
the same two wrappers launch the f32 kernels: pass A runs the same walk on
f32 FFMAs from the f32 stream of ``grad_weight_stream_f32`` into the
row-major f32 planes of ``grad_planes_f32``, and pass B sums the weight
gradients from them. Their plain versions are ``grad_pass_a_reference`` and
``grad_pass_b_reference`` (both dtypes), whose composition is
``point_mlp_grad_reference``.

For CPU tensors both the forward and the backward run their plain PyTorch
versions (``point_mlp_reference``, ``point_mlp_grad_reference``), which
round at the kernels' points; ``fused_point_mlp_train_reference`` runs
the plain versions on any device.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.kernels import build
from idealnerf_tpu_torch.kernels.fused_mlp import (
    _point_plan, _sm_count, encode_points, point_mlp, point_mlp_reference,
)
from idealnerf_tpu_torch.kernels.fused_render import (
    CHAIN_TILE, HEADS, KERNEL_WIDTH, PE_PAD, PED_PAD, SMEM_LIMIT,
    STAGE_ELEMS, PackedNet, _NSLOTS, _SLOT_B, _SLOT_BHEADS, _SLOT_BV, _SLOT_W, _SLOT_WALPHA,
    _SLOT_WRGB, _SLOT_WSKIP, _SLOT_WV, _SLOT_WV0D,
    _check_cuda, _check_rays, _raise_on, _slots, _stream, _stream_parts,
    entry, model_leaves, narrow, pack_leaves, stage_rows, stream_matrices,
    swizzle_image_index, weight_stream, widen,
)

GRAD_TILE = 64  # points per tile of the planes (csrc/fused_mlp_grad.cuh: GP)
# pass A's weight ring: the deepest that fits beside its tiles and relu'
# bits (4 at the paper depth and width, where 5 does not; fewer, at least
# 2, for a deeper or a W=512 net)
_PASS_A_RING = 4
# pass A f32's ring likewise: 4 at W <= 256 at every depth the operand
# table takes; 2 at W=512, where its tiles fill most of the shared memory
_PASS_A_F32_RING = 4
F32_STAGE = STAGE_ELEMS // 2  # floats per 16 KB stage of the f32 stream

# the wrapper, and the two kernels of each of its paths
launch_counts = {"fused_point_mlp_grad": 0, "grad_pass_a": 0,
                 "grad_pass_b": 0, "grad_pass_a_f32": 0,
                 "grad_pass_b_f32": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------- plain version

class GradBuffers(NamedTuple):
    """What the backward's first pass hands to its second, as f32 tensors
    holding values of the gradient type: the encodings ``pe`` (N, PE_PAD)
    and ``ped`` (N, PED_PAD), the rounded cotangent ``gb`` (N, HEADS),
    every activation ``hs[i]`` (N, W) and ``hvs[v]`` (N, W/2), every
    rounded d_h ``dcs[i]`` and ``dvs[v]`` of the same shapes, and ``bias``
    (tiles, D*W + V*W/2 + HEADS): per tile of GRAD_TILE points the column
    sums of the unrounded d_h of every layer, then of the cotangent."""

    pe: torch.Tensor
    ped: torch.Tensor
    gb: torch.Tensor
    hs: List[torch.Tensor]
    hvs: List[torch.Tensor]
    dcs: List[torch.Tensor]
    dvs: List[torch.Tensor]
    bias: torch.Tensor


def _tile_sums(d: torch.Tensor) -> torch.Tensor:
    """(N, F) -> (tiles, F): column sums over each tile of GRAD_TILE rows."""
    n = d.shape[0]
    tiles = -(-n // GRAD_TILE)
    d = F.pad(d, (0, 0, 0, tiles * GRAD_TILE - n))
    return d.reshape(tiles, GRAD_TILE, d.shape[1]).sum(1)


def grad_pass_a_reference(net: PackedNet, pts: torch.Tensor,
                          dirs: torch.Tensor, g: torch.Tensor,
                          acc=torch.float32,
                          forward: Optional[GradBuffers] = None
                          ) -> GradBuffers:
    """The backward's first pass in torch ops: recompute in the dtype of
    the net's weights, then run d_h back through the heads, the view
    branch and the trunk with the kernel's rounding points (d_h from the
    heads with the unrounded cotangent, each d_h rounded before its
    products, relu' = h > 0 on the rounded activation) -> GradBuffers.
    Products and sums run in ``acc`` (f32; f64 where a test needs sums
    whose order leaves no trace), and so do the buffers. With ``forward``
    (another pass A's buffers, the kernel's) its encodings and activations
    stand for the recompute: the backward then takes the same relu'
    decisions as that pass, where an activation that rounds to 0 in one
    summation order and not in another would flip a d_h element whole."""
    dt = net.w[0].dtype

    def rnd(x):
        return x.to(dt).to(acc)

    relu = torch.relu
    W = [x.to(acc) for x in net.w]
    WV = [x.to(acc) for x in net.wv]
    b, bv = [x.to(acc) for x in net.b], [x.to(acc) for x in net.bv]
    if forward is not None:
        pe, ped = forward.pe.to(acc), forward.ped.to(acc)
        hs = [x.to(acc) for x in forward.hs]
        hvs = [x.to(acc) for x in forward.hvs]
    else:
        pe, ped = (x.to(acc) for x in encode_points(net, pts, dirs))
        hs = [rnd(relu(pe @ W[0] + b[0]))]
        for i in range(1, len(W)):
            a = hs[-1] @ W[i]
            if i in net.wskip:
                a = pe @ net.wskip[i].to(acc) + a
            hs.append(rnd(relu(a + b[i])))
        hvs = [rnd(relu(hs[-1] @ WV[0] + ped @ net.wv0d.to(acc) + bv[0]))]
        for v in range(1, len(WV)):
            hvs.append(rnd(relu(hvs[-1] @ WV[v] + bv[v])))

    g16 = F.pad(g.to(acc), (0, HEADS - 4))
    dh = g16 @ net.w_alpha.to(acc).T
    dv = g16 @ net.w_rgb.to(acc).T
    dvs, bvs = [None] * len(WV), [None] * len(WV)
    for v in range(len(WV) - 1, -1, -1):
        dv = dv * (hvs[v] > 0)
        dvs[v], bvs[v] = rnd(dv), _tile_sums(dv)
        if v:
            dv = dvs[v] @ WV[v].T
    dh = dh + dvs[0] @ WV[0].T
    dcs, bs = [None] * len(W), [None] * len(W)
    for i in range(len(W) - 1, -1, -1):
        dh = dh * (hs[i] > 0)
        dcs[i], bs[i] = rnd(dh), _tile_sums(dh)
        if i:
            dh = dcs[i] @ W[i].T
    return GradBuffers(pe=pe, ped=ped, gb=rnd(g16), hs=hs, hvs=hvs, dcs=dcs,
                       dvs=dvs, bias=torch.cat([*bs, *bvs, _tile_sums(g16)],
                                               dim=1))


def grad_chunks(n_tiles: int, sms: int) -> int:
    """Number of point chunks of the backward's second pass: each sums its
    tiles into one f32 partial per gradient. Depends on N and the card's
    SM count only, so a card repeats its sums bitwise."""
    return max(1, min(n_tiles, sms // 4))


def chunk_bounds(n_tiles: int, n_chunks: int) -> List[Tuple[int, int]]:
    """[first tile, end tile) of each chunk (csrc/fused_mlp_grad.cuh:
    k_grad_pass_b, k_bias_partials)."""
    return [(c * n_tiles // n_chunks, (c + 1) * n_tiles // n_chunks)
            for c in range(n_chunks)]


def grad_pass_b_reference(net: PackedNet, bufs: GradBuffers,
                          n_chunks: int = 1) -> PackedNet:
    """The backward's second pass in torch ops: every weight gradient as a
    product over the points, X^T @ d, summed chunk by chunk in order (the
    kernel's chunks of tiles), and every bias gradient as the sum of the
    per-tile column sums, chunk by chunk -> a PackedNet of f32 gradients."""
    n = bufs.pe.shape[0]
    spans = chunk_bounds(bufs.bias.shape[0], n_chunks)

    def prod(x, y):
        out = 0
        for a, b in spans:
            r = slice(a * GRAD_TILE, min(b * GRAD_TILE, n))
            out = out + x[r].T @ y[r]
        return out

    def bsum(lo, width):
        out = 0
        for a, b in spans:
            out = out + bufs.bias[a:b, lo:lo + width].sum(0)
        return out

    D, V = len(net.w), len(net.wv)
    W, WV = net.width, net.wv[0].shape[1]
    hs, hvs, dcs, dvs = bufs.hs, bufs.hvs, bufs.dcs, bufs.dvs
    return PackedNet(
        w=[prod(bufs.pe if i == 0 else hs[i - 1], dcs[i]) for i in range(D)],
        b=[bsum(i * W, W) for i in range(D)],
        wskip={i: prod(bufs.pe, dcs[i]) for i in net.wskip},
        wv=[prod(hs[-1] if v == 0 else hvs[v - 1], dvs[v]) for v in range(V)],
        bv=[bsum(D * W + v * WV, WV) for v in range(V)],
        wv0d=prod(bufs.ped, dvs[0]), w_alpha=prod(hs[-1], bufs.gb),
        w_rgb=prod(hvs[-1], bufs.gb), b_heads=bsum(D * W + V * WV, HEADS),
        multires=net.multires, multires_views=net.multires_views,
        softplus=net.softplus)


def point_mlp_grad_reference(net: PackedNet, pts: torch.Tensor,
                             dirs: torch.Tensor,
                             g: torch.Tensor) -> PackedNet:
    """The gradient kernel in torch ops: the two passes composed, one
    chunk -> a PackedNet of f32 gradients, one per packed operand."""
    return grad_pass_b_reference(
        net, grad_pass_a_reference(net, pts, dirs, g))


# ------------------------------------------------------------------ kernel

def _grad_layout(net: PackedNet) -> Tuple[Dict[int, Tuple[int, tuple]], int]:
    """Slot -> (float offset, shape) of each gradient inside one chunk's
    partial of the second pass, every offset 64-float aligned; -> (layout,
    partial size G)."""
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


def grad_planes(net: PackedNet, n_tiles: int
                ) -> Tuple[List[int], List[int], int]:
    """The bf16 backward's operand buffer, which its first pass writes and
    its second reads -> (bf16 element offset of each plane, the plane's
    width, total elements). Planes in the kernel's order (csrc/
    fused_mlp_grad.cuh: plane indices): pe, ped, gb, h[0..D), hv[0..V),
    dc[0..D), dv[0..V); ped and gb zero-padded to 64 lanes. A plane holds
    one image of GRAD_TILE x width per tile, in swizzle_index's order, so
    every image and every 64-lane block of it starts 8 KB aligned."""
    W, WV = net.width, net.wv[0].shape[1]
    D, V = len(net.w), len(net.wv)
    widths = [PE_PAD, 64, 64] + [W] * D + [WV] * V + [W] * D + [WV] * V
    offs, n = [], 0
    for w in widths:
        offs.append(n)
        n += n_tiles * GRAD_TILE * w
    return offs, widths, n


def swizzle_index(width: int) -> torch.Tensor:
    """(GRAD_TILE, width) element offsets of one tile's image of a plane:
    64-lane blocks of 4,096 elements; in a block, 8 groups of 8 points;
    in a group, one 128-byte row per point whose 16-byte chunks are
    permuted by chunk ^ (point % 8). That is wgmma's MN-major layout with
    128-byte swizzle, so one bulk copy moves a block into shared memory
    in the order the second pass's descriptors read."""
    return swizzle_image_index(GRAD_TILE, width)


def unswizzle_plane(planes: torch.Tensor, off: int, width: int,
                    n_tiles: int) -> torch.Tensor:
    """One plane of the operand buffer -> (n_tiles * GRAD_TILE, width)."""
    img = planes[off:off + n_tiles * GRAD_TILE * width].view(
        n_tiles, GRAD_TILE * width)
    idx = swizzle_index(width).reshape(-1).to(planes.device)
    return img[:, idx].reshape(n_tiles * GRAD_TILE, width)


def buffers_from_planes(net: PackedNet, planes: torch.Tensor,
                        offs: List[int], bias: torch.Tensor,
                        n: int) -> GradBuffers:
    """The first pass's kernel output as the GradBuffers its plain
    version returns (f32, n rows)."""
    n_tiles = bias.shape[0]
    W, WV = net.width, net.wv[0].shape[1]
    D, V = len(net.w), len(net.wv)

    def plane(j, width, lanes=None):
        x = unswizzle_plane(planes, offs[j], width, n_tiles)[:n].float()
        return x if lanes is None else x[:, :lanes]

    return GradBuffers(
        pe=plane(0, PE_PAD), ped=plane(1, 64, PED_PAD), gb=plane(2, 64, HEADS),
        hs=[plane(3 + i, W) for i in range(D)],
        hvs=[plane(3 + D + v, WV) for v in range(V)],
        dcs=[plane(3 + D + V + i, W) for i in range(D)],
        dvs=[plane(3 + 2 * D + V + v, WV) for v in range(V)], bias=bias)


def grad_planes_f32(net: PackedNet, n_tiles: int
                    ) -> Tuple[List[int], List[int], int]:
    """The f32 backward's operand buffer, which grad_pass_a writes and
    grad_pass_b reads on f32 weights -> (float offset of each plane, its
    width, total floats). The planes of grad_planes in the same order,
    each row-major (n_tiles * GRAD_TILE rows of its width) and unpadded:
    pe PE_PAD, ped PED_PAD, gb HEADS wide; every plane starts 128-byte
    aligned."""
    W, WV = net.width, net.wv[0].shape[1]
    D, V = len(net.w), len(net.wv)
    widths = [PE_PAD, PED_PAD, HEADS] + [W] * D + [WV] * V + [W] * D + [WV] * V
    offs, n = [], 0
    for w in widths:
        offs.append(n)
        n += -(-n_tiles * GRAD_TILE * w // 32) * 32
    return offs, widths, n


def buffers_from_planes_f32(net: PackedNet, planes: torch.Tensor,
                            offs: List[int], bias: torch.Tensor,
                            n: int) -> GradBuffers:
    """grad_pass_a's output on f32 weights as the GradBuffers its plain
    version returns: views of the planes' first n rows."""
    rows = bias.shape[0] * GRAD_TILE
    _, widths, _ = grad_planes_f32(net, bias.shape[0])
    p = [planes[o:o + rows * w].view(rows, w)[:n]
         for o, w in zip(offs, widths)]
    D, V = len(net.w), len(net.wv)
    return GradBuffers(pe=p[0], ped=p[1], gb=p[2], hs=p[3:3 + D],
                       hvs=p[3 + D:3 + D + V], dcs=p[3 + D + V:3 + 2 * D + V],
                       dvs=p[3 + 2 * D + V:], bias=bias)


def _check_inputs(net: PackedNet, pts, dirs, g) -> torch.device:
    dev = _check_rays("fused_point_mlp_grad", net, pts=pts, dirs=dirs, g=g)
    N = pts.shape[0]
    if pts.shape != (N, 3) or dirs.shape != (N, 3) or g.shape != (N, 4):
        raise ValueError("fused_point_mlp_grad: pts, dirs, g must be (N, 3), "
                         f"(N, 3), (N, 4); got {tuple(pts.shape)}, "
                         f"{tuple(dirs.shape)}, {tuple(g.shape)}")
    if N < 1 or N >= 2 ** 31 - CHAIN_TILE:
        raise ValueError(f"fused_point_mlp_grad: unsupported N={N}")
    return dev


def _offsets(layout) -> ctypes.Array:
    offs = (ctypes.c_longlong * _NSLOTS)(*([-1] * _NSLOTS))
    for slot, (off, _) in layout.items():
        offs[slot] = off
    return offs


def _unflatten(net: PackedNet, out: torch.Tensor, layout) -> PackedNet:
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


def _grad_stream_parts(net: PackedNet):
    """Pass A's weight stream as stream parts (fused_render.weight_stream):
    the point kernels' forward parts (dir-PE stage, no heads), then the
    matrices the backward multiplies d_h by, transposed, in the order it
    does (csrc/fused_mlp_grad.cuh, note at the top): ``wv{v}T`` for v =
    V-1..1 (W/2 lanes; at W=256 64-row stages of 128 lanes), ``wv0T`` (W/2
    x W, 32-row stages at 256), ``w{i}T`` for i = D-1..1."""
    kw, kv = stage_rows(net.width), stage_rows(net.wv[0].shape[1])
    back = [(f"wv{v}T", net.wv[v].T, kv)
            for v in range(len(net.wv) - 1, 0, -1)]
    back.append(("wv0T", net.wv[0].T, kw))
    back += [(f"w{i}T", net.w[i].T, kw)
             for i in range(len(net.w) - 1, 0, -1)]
    return _stream_parts(net, dir_stage=True) + back


def grad_weight_stream(net: PackedNet):
    """PackedNet -> (stream, order) of the gradient kernel's pass A: 133
    stages of 16 KB for the paper model, the forward's 69 and the
    backward's 64. One concatenation and one gather per call, the
    transposed matrices gathered from the net's own."""
    return weight_stream(_grad_stream_parts(net))


def grad_stream_matrices(stream: torch.Tensor, net: PackedNet) -> Dict:
    """The plain inverse of grad_weight_stream: the stream read back into
    its matrices by name (the forward's, as chain_stream_matrices names
    them, without the heads; ``wv{v}T``, ``wv0T`` and ``w{i}T`` the
    transposes the backward reads); ``net`` gives only the shapes."""
    return stream_matrices(stream, _grad_stream_parts(net))


def _grad_stream_parts_f32(net: PackedNet):
    """Pass A f32's weight stream as (name, matrix (K, N)) in the order it
    multiplies by them (csrc/fused_mlp_grad.cuh: f32_stages): layer 0,
    each later layer's skip pe-part then its h-part, view layer 0's h-part
    and dir-PE part, the later view layers, then ``wv{v}T`` for v =
    V-1..1, ``wv0T`` and ``w{i}T`` for i = D-1..1, the transposes the
    backward multiplies d_h by."""
    parts = [("w0", net.w[0])]
    for i in range(1, len(net.w)):
        if i in net.wskip:
            parts.append((f"wskip{i}", net.wskip[i]))
        parts.append((f"w{i}", net.w[i]))
    parts += [("wv0", net.wv[0]), ("wv0d", net.wv0d)]
    parts += [(f"wv{v}", x) for v, x in enumerate(net.wv) if v]
    parts += [(f"wv{v}T", net.wv[v].T) for v in range(len(net.wv) - 1, 0, -1)]
    parts.append(("wv0T", net.wv[0].T))
    return parts + [(f"w{i}T", net.w[i].T)
                    for i in range(len(net.w) - 1, 0, -1)]


def _f32_rows(m: torch.Tensor) -> int:
    """Rows a matrix takes in the f32 stream: its K-rows, padded to whole
    stages of F32_STAGE / N rows (only W=128's dir-PE part, 32 rows of a
    64-row stage, is padded)."""
    k, n = m.shape
    kr = F32_STAGE // n
    if n * kr != F32_STAGE:
        raise ValueError(f"f32 weight stream: a {n}-wide matrix does not cut "
                         "into stages")
    return -(-k // kr) * kr


def grad_weight_stream_f32(net: PackedNet):
    """An f32 PackedNet -> (stream, order) of pass A f32: each matrix
    row-major, back to back, so every 16 KB stage (F32_STAGE floats) is a
    K-slab of F32_STAGE / N whole rows (16 of a 256-wide matrix, 32 of a
    128-wide one; a matrix of fewer rows than a stage is padded with zero
    rows to one); ``order`` is the (name, first K-row) of every stage: 265
    for the paper model, the forward's 137 and the backward's 128."""
    parts = _grad_stream_parts_f32(net)
    order, chunks = [], []
    for name, m in parts:
        rows, (k, n) = _f32_rows(m), m.shape
        order += [(name, k0) for k0 in range(0, rows, F32_STAGE // n)]
        chunks.append(F.pad(m.float(), (0, 0, 0, rows - k)).reshape(-1))
    return torch.cat(chunks), order


def grad_stream_matrices_f32(stream: torch.Tensor, net: PackedNet) -> Dict:
    """The plain inverse of grad_weight_stream_f32: the stream read back
    into its (K, N) matrices by name; ``net`` gives only the shapes."""
    out, q = {}, 0
    for name, m in _grad_stream_parts_f32(net):
        out[name] = stream[q:q + m.numel()].view(m.shape)
        q += _f32_rows(m) * m.shape[1]
    return out


def _deepest_ring(smem, most: int, name: str, width: int, depth: int) -> int:
    """The deepest ring of at most ``most`` stages, at least 2, whose
    shared memory (``smem(ring)``) fits; a net for which 2 do not fit is
    refused (ROADMAP.md B10)."""
    for ring in range(most, 1, -1):
        if smem(ring) <= SMEM_LIMIT:
            return ring
    raise ValueError(f"{name}: a W={width}, D={depth} net's tiles and relu' "
                     "bits do not fit the shared memory beside a ring of 2 "
                     "stages; ROADMAP.md B10")


def pass_a_plan(lib, N: int, sms: int, depth: int, n_views: int,
                width: int = KERNEL_WIDTH):
    """(tiles per block, blocks, ring stages) of pass A on N points at the
    kernels' ``width``: the point kernels' plan (one wave of blocks over
    runs of chain tiles) with pass A's shared memory, at _PASS_A_RING
    stages, or fewer (at least 2) where the relu' bits of a deeper or a
    wider net leave less room."""
    def smem(ring):
        return entry(lib, "fr_grad_pass_a_smem_bytes", width)(ring, depth,
                                                              n_views)

    ring = _deepest_ring(smem, _PASS_A_RING, "grad_pass_a", width, depth)
    return _point_plan(lib, N, sms, ring, smem, width)


def pass_a_f32_plan(lib, N: int, sms: int, depth: int, n_views: int,
                    width: int = KERNEL_WIDTH):
    """(tiles per block, blocks, ring stages) of pass A f32 on N points at
    the kernels' ``width``: its 64-point tiles split evenly over at most
    one wave of ``sms`` blocks, each walking a contiguous run of them, at
    _PASS_A_F32_RING stages or the deepest ring below that fits."""
    def smem(ring):
        return entry(lib, "fr_grad_pass_a_f32_smem_bytes", width)(
            ring, depth, n_views)

    ring = _deepest_ring(smem, _PASS_A_F32_RING, "grad_pass_a_f32", width,
                         depth)
    tiles = -(-N // GRAD_TILE)
    per_block = -(-tiles // sms)
    return per_block, -(-tiles // per_block), ring


def pass_a_launch_config(net: PackedNet, N: int) -> Dict[str, int]:
    """Pass A's launch on N points on the current card, bf16 or f32 by the
    net's weights: tiles per block (of 128 points in bf16, 64 in f32),
    blocks, dynamic shared memory, ring depth and stages per tile."""
    lib = build.load_library()
    D, V, W = len(net.w), len(net.wv), net.width
    if net.w[0].dtype == torch.float32:
        plan, smem, stream = (pass_a_f32_plan,
                              entry(lib, "fr_grad_pass_a_f32_smem_bytes", W),
                              grad_weight_stream_f32)
    else:
        plan, smem, stream = (pass_a_plan,
                              entry(lib, "fr_grad_pass_a_smem_bytes", W),
                              grad_weight_stream)
    per_block, blocks, ring = plan(
        lib, N, _sm_count(torch.cuda.current_device()), D, V, W)
    return {"tiles_per_block": per_block, "blocks": blocks,
            "smem_bytes": smem(ring, D, V), "ring_stages": ring,
            "stages_per_tile": len(stream(net)[1])}


def launch_pass_a(net: PackedNet, pts: torch.Tensor, dirs: torch.Tensor,
                  g: torch.Tensor, plan=None):
    """One launch of pass A on checked CUDA operands -> (operand buffer,
    its plane offsets, per-tile bias sums (tiles, NB) f32). ``plan``
    (tiles per block, ring stages) replaces pass_a_plan's (a point's
    outputs do not depend on it). Counts nothing: grad_pass_a counts."""
    dev, N = pts.device, pts.shape[0]
    lib = build.load_library()
    D, V, W = len(net.w), len(net.wv), net.width
    if plan is None:
        per_block, _, ring = pass_a_plan(lib, N, _sm_count(dev), D, V, W)
    else:
        per_block, ring = plan
    n_tiles = -(-N // GRAD_TILE)
    offs, _, total = grad_planes(net, n_tiles)
    nb = D * net.width + V * net.wv[0].shape[1] + HEADS
    planes = torch.empty(total, dtype=torch.bfloat16, device=dev)
    bias = torch.empty((n_tiles, nb), dtype=torch.float32, device=dev)
    table, keep = _slots(net, dev)
    stream, order = grad_weight_stream(net)
    err = entry(lib, "fr_grad_pass_a", W)(
        pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), planes.data_ptr(),
        (ctypes.c_longlong * len(offs))(*offs), bias.data_ptr(), N,
        per_block, table, D, V, net.multires, net.multires_views,
        stream.data_ptr(), len(order), ring, _stream(dev))
    _raise_on(lib, err, "grad_pass_a")
    del keep, stream  # stream-ordered reuse by the caching allocator
    return planes, offs, bias


def launch_pass_a_f32(net: PackedNet, pts: torch.Tensor, dirs: torch.Tensor,
                      g: torch.Tensor):
    """One launch of pass A f32 on checked CUDA operands -> (f32 operand
    buffer, its plane offsets, per-tile bias sums (tiles, NB) f32).
    Counts nothing: grad_pass_a counts."""
    dev, N = pts.device, pts.shape[0]
    lib = build.load_library()
    D, V, W = len(net.w), len(net.wv), net.width
    per_block, _, ring = pass_a_f32_plan(lib, N, _sm_count(dev), D, V, W)
    n_tiles = -(-N // GRAD_TILE)
    offs, _, total = grad_planes_f32(net, n_tiles)
    nb = D * net.width + V * net.wv[0].shape[1] + HEADS
    planes = torch.empty(total, dtype=torch.float32, device=dev)
    bias = torch.empty((n_tiles, nb), dtype=torch.float32, device=dev)
    table, keep = _slots(net, dev)
    stream, order = grad_weight_stream_f32(net)
    err = entry(lib, "fr_grad_pass_a_f32", W)(
        pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), planes.data_ptr(),
        (ctypes.c_longlong * len(offs))(*offs), bias.data_ptr(), N,
        per_block, table, D, V, net.multires, net.multires_views,
        stream.data_ptr(), len(order), ring, _stream(dev))
    _raise_on(lib, err, "grad_pass_a_f32")
    del keep, stream  # stream-ordered reuse by the caching allocator
    return planes, offs, bias


def pass_b_tasks(net: PackedNet, f32: bool = False) -> int:
    """Output tiles in the second pass's task table (csrc/
    fused_mlp_grad.cuh: add_tasks, add_ftasks): every weight gradient cut
    into 128 x 128 tiles (bf16: pairs of 64-lane blocks of its planes,
    whose ped and gb planes are 64 lanes wide)."""
    W, WV = net.width, net.wv[0].shape[1]
    if f32:
        def tiles(x, y):
            return -(-x // 128) * -(-y // 128)
        ped, gb = PED_PAD, HEADS
    else:
        def tiles(x, y):
            return -(-(x // 64) // 2) * -(-(y // 64) // 2)
        ped, gb = 64, 64
    n = (tiles(PE_PAD, W) + (len(net.w) - 1) * tiles(W, W)
         + len(net.wskip) * tiles(PE_PAD, W))
    n += tiles(W, WV) + tiles(ped, WV) + (len(net.wv) - 1) * tiles(WV, WV)
    return n + tiles(W, gb) + tiles(WV, gb)


def _check_tasks(lib, net: PackedNet, f32: bool) -> None:
    """A net whose second pass has more output tiles than its kernels'
    task table holds (a deep W=512 net) is refused before any launch."""
    most = entry(lib, "fr_grad_max_tasks", net.width)()
    if pass_b_tasks(net, f32) > most:
        raise ValueError(f"fused_point_mlp_grad: a W={net.width}, "
                         f"D={len(net.w)} net's {pass_b_tasks(net, f32)} "
                         f"weight-gradient tiles exceed the second pass's "
                         f"{most}; ROADMAP.md B10")


def grad_pass_a(net: PackedNet, pts: torch.Tensor, dirs: torch.Tensor,
                g: torch.Tensor):
    """The backward's first kernel (CUDA tensors only) -> (operand buffer,
    its plane offsets, per-tile bias sums (tiles, NB) f32): the recompute
    and the d_h chain, every operand of the weight gradients written in
    grad_planes' layout (bf16 weights, ``k_grad_pass_a``) or in
    grad_planes_f32's (f32 weights, ``k_grad_pass_a_f32``)."""
    _check_inputs(net, pts, dirs, g)
    _check_cuda("grad_pass_a", torch.float32, 16, g=g)
    dt = net.w[0].dtype
    if dt in (torch.bfloat16, torch.float32):
        _check_tasks(build.load_library(), net, dt == torch.float32)
    if dt == torch.bfloat16:
        out, key = launch_pass_a(net, pts, dirs, g), "grad_pass_a"
    elif dt == torch.float32:
        out, key = launch_pass_a_f32(net, pts, dirs, g), "grad_pass_a_f32"
    else:
        raise TypeError(f"grad_pass_a: weights must be bf16 or f32, got {dt}")
    launch_counts[key] += 1
    return out


def grad_pass_b(net: PackedNet, planes: torch.Tensor, offs: List[int],
                bias: torch.Tensor) -> PackedNet:
    """The backward's second kernel on grad_pass_a's buffer: every weight
    gradient as a long-K product over its points (wgmma on bf16 planes,
    ``k_grad_pass_b``; FFMA on f32 planes, ``k_grad_pass_b_f32``), one
    f32 partial per chunk of tiles (grad_chunks), and the bias sums,
    added in a fixed order -> a PackedNet of f32 gradients."""
    _check_rays("fused_point_mlp_grad", net)
    dev, W = planes.device, net.width
    lib = build.load_library()
    sfx = {torch.bfloat16: "", torch.float32: "_f32"}[planes.dtype]
    if entry(lib, f"fr_grad_pass_b{sfx}_smem_bytes", W)() > SMEM_LIMIT:
        raise ValueError("grad_pass_b: shared memory over the limit")
    _check_tasks(lib, net, planes.dtype == torch.float32)
    n_tiles = bias.shape[0]
    layout, G = _grad_layout(net)
    n_chunks = grad_chunks(n_tiles, _sm_count(dev))
    partials = torch.empty((n_chunks, G), dtype=torch.float32, device=dev)
    out = torch.empty(G, dtype=torch.float32, device=dev)
    err = entry(lib, f"fr_grad_pass_b{sfx}", W)(
        planes.data_ptr(), (ctypes.c_longlong * len(offs))(*offs),
        bias.data_ptr(), bias.shape[1], partials.data_ptr(), out.data_ptr(),
        G, n_tiles, n_chunks, _offsets(layout), len(net.w), len(net.wv),
        _stream(dev))
    _raise_on(lib, err, f"grad_pass_b{sfx}")
    launch_counts[f"grad_pass_b{sfx}"] += 1
    del partials  # stream-ordered reuse by the caching allocator
    return _unflatten(net, out, layout)


def point_mlp_grad(net: PackedNet, pts: torch.Tensor, dirs: torch.Tensor,
                   g: torch.Tensor) -> PackedNet:
    """The gradient kernels on a packed net (bf16 or f32 weights): CUDA
    tensors launch them, CPU tensors take the plain version: grad_pass_a
    then grad_pass_b, each on the bf16 or the f32 kernel. The same inputs
    on the same card give bitwise-equal gradients. A narrower net runs
    widened (``fused_render.widen``) and its gradients are cut back to its
    shapes."""
    if pts.device.type == "cpu":
        return point_mlp_grad_reference(net, pts, dirs, g)
    dt = net.w[0].dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_point_mlp_grad: weights must be bf16 or f32, "
                        f"got {dt}")
    narrow_net, net = net, widen(net)
    grads = grad_pass_b(net, *grad_pass_a(net, pts, dirs, g))
    launch_counts["fused_point_mlp_grad"] += 1
    return narrow(grads, narrow_net)


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
