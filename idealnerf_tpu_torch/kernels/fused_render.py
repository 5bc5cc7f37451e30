"""Per-ray fused render: PE -> conditioned MLP -> alpha composite, one
kernel launch per pass (counterpart of idealnerf_tpu/kernels/fused_render.py).

Three kernels, CUDA C++ for sm_90a in ``csrc/``, each running its field
MLP on one wgmma chain fed by its net's weight stream
(``chain_weight_stream``; see the note at the top of
``csrc/fused_render.cuh`` for what bounds them and how they are built):

- ``fused_render_rays`` replaces the JAX package's ``fused_render_rays``
  (``_render_kernel``/``_render_body``): rays at given depths -> per-ray
  summaries and compositing weights. The fine pass.
- ``fused_render_coarse_hier`` replaces ``fused_render_coarse_hier``
  (``_coarse_hier_kernel``/``_pdf_merge``): the coarse pass on the static
  near/far linspace plus, in the same launch, the deterministic
  inverse-CDF importance depths merged with the coarse ones.
- ``fused_render_delta`` replaces ``fused_render_delta`` (``_delta_kernel``):
  a temporal delta frame in one launch — depths placed from the previous
  frame's per-ray (z, w) and the cached band, the fine render, and the
  next frame's foreground band.

Each wrapper launches its kernel for CUDA tensors and counts the launch
in ``launch_counts``; for CPU tensors it runs the plain PyTorch version
beside it (``*_reference``), which computes the same function with the
same bf16 rounding points: weights and every post-relu activation are
rounded to bf16 and multiplied in f32, where a product of two bf16
values is exact, so it equals bf16 x bf16 with f32 accumulation.

The chain and every kernel on it are templates over the net's width,
built at W = 128, 256 and 512 (view branch W/2; ``KERNEL_WIDTHS``; one
set of C entries per width, ``fr_render_rays_w128`` ...). A net runs on
the instance of the smallest of them at least as wide as it, zero-padded
to it (``widen``): the padded units stay 0 and the result is the net's.
A wider or deeper net, or PE wider than the kernels' lanes, is refused
naming ROADMAP.md B10 (``kernels_cover``), as is any net whose launch
plan cannot fit the shared memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.core.composite import fg_band
from idealnerf_tpu_torch.core.embedding import positional_encoding
from idealnerf_tpu_torch.core.sampling import sample_pdf, stratified_sample
from idealnerf_tpu_torch.kernels import build

PE_PAD = 64     # 63 xyz-PE lanes + 1 zero lane
PED_PAD = 32    # 27 dir-PE lanes + 5 zero lanes
HEADS = 16      # packed head columns: rgb 0..2, sigma 3
KERNEL_WIDTHS = (128, 256, 512)  # the widths the kernels are built at
KERNEL_WIDTH = 256  # the paper width, the diagnosis probes' (kernels/kdiag.py)
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper

# operand table of the kernels (csrc/render_body.cuh, enum Slot)
_MAXD, _MAXV = 16, 8
_SLOT_W, _SLOT_B, _SLOT_WSKIP = 0, _MAXD, 2 * _MAXD
_SLOT_WV = 3 * _MAXD
_SLOT_BV = _SLOT_WV + _MAXV
_SLOT_WV0D = _SLOT_BV + _MAXV
_SLOT_WALPHA, _SLOT_WRGB, _SLOT_BHEADS = (_SLOT_WV0D + 1, _SLOT_WV0D + 2,
                                         _SLOT_WV0D + 3)
_NSLOTS = _SLOT_WV0D + 4

# the delta kernel (csrc/fused_render.cuh, k_render_delta): points per ray
# group (four 128-point tiles), at most 32 rays, and the fewest stages its
# weight ring keeps before the group gives up rays (3 and 4 measured
# alike, 2 slower)
_DELTA_POINTS, _DELTA_MAX_RAYS, _DELTA_MIN_RING = 512, 32, 4
# the render and coarse kernels (k_render_rays, k_coarse_hier): the weight
# ring's stages (3 with the rays they leave room for measured about 2 %
# faster than 4, scripts/kframe.py), at most this many rays per block, and
# the share of a block's tile rows its last 128-point tile may leave empty
_RENDER_RING, _RENDER_MAX_RAYS, _MAX_TAIL = 3, 64, 1 / 32
CHAIN_TILE = 128              # points per tile of the chain at W <= 256
STAGE_ELEMS = 8192            # bf16 per stage (16 KB)
# K-rows per stage of a 256- / 128-wide layer (the paper width's; a stage
# holds STAGE_ELEMS // N rows of an N-wide one)
_KC_W, _KC_V = 32, 64
# rays per chunk of the plain versions: bounds their (points x W) f32
# activations (a whole 450^2 fine pass would need ~53 GB)
_REF_CHUNK_POINTS = 1 << 16

launch_counts = {"fused_render_rays": 0, "fused_render_coarse_hier": 0,
                 "fused_render_delta": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


@dataclasses.dataclass
class PackedNet:
    """One FaceNeRF with folded biases, in the kernels' operand layout:
    bf16 weights as (in, out), f32 biases, PE rows zero-padded, the skip
    layer split into its pe and h parts, and both heads packed into
    HEADS columns (rgb 0..2 from the view branch, sigma 3 from the trunk)."""

    w: List[torch.Tensor]        # layer i: (PE_PAD, W) for i=0, else (W, W)
    b: List[torch.Tensor]        # folded biases (W,)
    wskip: Dict[int, torch.Tensor]  # layer i -> (PE_PAD, W) pe-part
    wv: List[torch.Tensor]       # view layer v: (W, W/2) for v=0, else (W/2, W/2)
    bv: List[torch.Tensor]       # view biases (W/2,), bv[0] folded
    wv0d: torch.Tensor           # (PED_PAD, W/2) dir-PE part of view layer 0
    w_alpha: torch.Tensor        # (W, HEADS)
    w_rgb: torch.Tensor          # (W/2, HEADS)
    b_heads: torch.Tensor        # (HEADS,)
    multires: int
    multires_views: int
    softplus: bool

    @property
    def width(self) -> int:
        return self.w[0].shape[1]


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(w, (0, 0, 0, rows - w.shape[0]))


def model_leaves(model, folded: Dict, cfg) -> List[torch.Tensor]:
    """The tensors the packed operands are made of, in a fixed order:
    trunk weights (D), folded trunk biases (D), view weights (V), the
    folded view-layer-0 bias and the other view biases (V), then the alpha
    weight and bias and the rgb weight and bias. Weights are nn.Linear
    layouts (out, in)."""
    if not cfg.use_viewdirs:
        raise ValueError("the fused kernels cover the use_viewdirs path")
    views = model.views_linears
    return ([lin.weight for lin in model.pts_linears]
            + list(folded["b_pts"])
            + [lin.weight for lin in views]
            + [folded["b_view0"]] + [lin.bias for lin in views[1:]]
            + [model.alpha_linear.weight, model.alpha_linear.bias,
               model.rgb_linear.weight, model.rgb_linear.bias])


def pack_leaves(cfg, leaves, dtype=torch.bfloat16) -> PackedNet:
    """model_leaves(...) -> PackedNet with weights in ``dtype`` (bf16 for
    the forward kernels; bf16 or f32 for the gradient kernel) and f32
    biases. Detached: gradients reach the leaves through
    kernels/fused_mlp_grad.py's autograd Function."""
    if cfg.input_ch > PE_PAD or cfg.input_ch_views > PED_PAD:
        raise ValueError(
            f"PE widths {cfg.input_ch}/{cfg.input_ch_views} exceed the "
            f"kernel's {PE_PAD}/{PED_PAD} lanes (multires <= 10, "
            "multires_views <= 4)")
    D, pe, in_all, W = cfg.depth, cfg.input_ch, cfg.input_ch_all, cfg.width
    nv = 1 + D // 4
    if len(leaves) != 2 * D + 2 * nv + 4:
        raise ValueError(f"expected {2 * D + 2 * nv + 4} leaves, got "
                         f"{len(leaves)}")
    leaves = [x.detach() for x in leaves]
    wp, bp = leaves[:D], leaves[D:2 * D]
    wvs, bvs = leaves[2 * D:2 * D + nv], leaves[2 * D + nv:2 * D + 2 * nv]
    wa, ba, wr, br = leaves[2 * D + 2 * nv:]

    def cast(x):
        return x.to(dtype).contiguous()

    w, wskip = [], {}
    for i in range(D):
        if i == 0:
            w.append(_pad_rows(wp[i][:, :pe].T, PE_PAD))
        elif (i - 1) in cfg.skips:
            w.append(wp[i][:, in_all:].T)
            wskip[i] = cast(_pad_rows(wp[i][:, :pe].T, PE_PAD))
        else:
            w.append(wp[i].T)
    wv = [wvs[0][:, :W].T] + [x.T for x in wvs[1:]]
    wv0d = _pad_rows(wvs[0][:, W: W + cfg.input_ch_views].T, PED_PAD)
    dev = wa.device
    w_alpha = torch.zeros((W, HEADS), dtype=torch.float32, device=dev)
    w_alpha[:, 3] = wa[0].float()
    w_rgb = torch.zeros((W // 2, HEADS), dtype=torch.float32, device=dev)
    w_rgb[:, :3] = wr.T.float()
    b_heads = torch.zeros((HEADS,), dtype=torch.float32, device=dev)
    b_heads[:3] = br.float()
    b_heads[3] = ba[0].float()
    return PackedNet(
        w=[cast(x) for x in w], b=[x.float().contiguous() for x in bp],
        wskip=wskip, wv=[cast(x) for x in wv],
        bv=[x.float().contiguous() for x in bvs], wv0d=cast(wv0d),
        w_alpha=cast(w_alpha), w_rgb=cast(w_rgb), b_heads=b_heads,
        multires=cfg.multires, multires_views=cfg.multires_views,
        softplus=cfg.density_activation == "softplus")


def pack_operands(model, folded: Dict, cfg) -> PackedNet:
    """FaceNeRF module + folded biases -> PackedNet (f32 params are cast
    to bf16 here, as the JAX wrapper casts them)."""
    with torch.no_grad():
        return pack_leaves(cfg, model_leaves(model, folded, cfg))


# ----------------------------------------------------------- plain versions

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _mlp_reference(net: PackedNet, pe: torch.Tensor,
                   pv: torch.Tensor) -> torch.Tensor:
    """pe (N, PE_PAD) bf16-valued f32, pv (N, W/2) per-point view-layer-0
    term -> raw (N, 4). Products and sums run in pe's dtype (f32; f64
    where a test needs sums whose order leaves no trace)."""
    dt = pe.dtype

    def rnd(x):
        return x.to(torch.bfloat16).to(dt)

    h = rnd(torch.relu(pe @ net.w[0].to(dt) + net.b[0]))
    for i in range(1, len(net.w)):
        acc = h @ net.w[i].to(dt)
        if i in net.wskip:
            acc = pe @ net.wskip[i].to(dt) + acc
        h = rnd(torch.relu(acc + net.b[i]))
    hv = rnd(torch.relu(h @ net.wv[0].to(dt) + pv))
    for v in range(1, len(net.wv)):
        hv = rnd(torch.relu(hv @ net.wv[v].to(dt) + net.bv[v]))
    raw = h @ net.w_alpha.to(dt) + hv @ net.w_rgb.to(dt) + net.b_heads
    return raw[:, :4]


def _composite_reference(raw, z, d_norm, bc, softplus: bool):
    """The kernels' compositing: raw (R, S, 4) -> (rgb_map, acc, last_w,
    depth, weights); transmittance is the running product of
    max(1 - alpha, 1e-10), the last sample takes the plate colour."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                      dim=1) * d_norm[:, None]
    sigma = raw[..., 3]
    if softplus:
        act = torch.where(sigma > 20.0, sigma,
                          torch.log(1.0 + torch.exp(torch.clamp(sigma, max=20.0))))
    else:
        act = torch.relu(sigma)
    alpha = 1.0 - torch.exp(-(act + 1e-6) * dists)
    keep = torch.cumprod(torch.clamp(1.0 - alpha, min=1e-10), dim=1)
    trans = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], dim=1)
    weights = alpha * trans
    rgb = torch.sigmoid(raw[..., :3])
    last_w = weights[:, -1]
    rgb_fg = torch.sum(weights[:, :-1, None] * rgb[:, :-1], dim=1)
    rgb_map = rgb_fg + last_w[:, None] * bc
    return (rgb_map, weights.sum(1), last_w, (weights * z).sum(1), weights)


def _outputs(rgb_map, acc, last_w, depth, weights, bc) -> Dict[str, torch.Tensor]:
    return {
        "rgb_map": rgb_map,
        "acc_map": acc,
        "last_weight": last_w,
        "depth": depth,
        "weights": weights,
        # composite excluding the plate sample: its colour IS bc_rgb
        "rgb_fg": rgb_map - last_w[:, None] * bc,
    }


def fused_render_rays_reference(params, folded, cfg, rays_o, rays_d,
                                z_vals, bc_rgb) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the fused_render_rays kernel, in ray
    chunks on the tensors' device."""
    net = pack_operands(params, folded, cfg)
    rays_o, rays_d = rays_o.float(), rays_d.float()
    z_vals, bc_rgb = z_vals.float(), bc_rgb.float()
    R, S = z_vals.shape
    d_norm = torch.linalg.norm(rays_d, dim=-1)
    viewdirs = rays_d / d_norm[:, None]
    ped = _bf16(F.pad(positional_encoding(viewdirs, net.multires_views),
                      (0, PED_PAD - 3 * (1 + 2 * net.multires_views))))
    pv = ped @ net.wv0d.float() + net.bv[0]                  # (R, W/2)

    parts = []
    step = max(1, _REF_CHUNK_POINTS // S)
    for s in range(0, R, step):
        o, d, z = rays_o[s:s + step], rays_d[s:s + step], z_vals[s:s + step]
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        pe = positional_encoding(pts, net.multires)
        pe = _bf16(F.pad(pe, (0, PE_PAD - pe.shape[-1]))).reshape(-1, PE_PAD)
        raw = _mlp_reference(net, pe, pv[s:s + step].repeat_interleave(S, 0))
        parts.append(_composite_reference(raw.reshape(-1, S, 4), z,
                                          d_norm[s:s + step],
                                          bc_rgb[s:s + step], net.softplus))
    return _outputs(*[torch.cat(p, 0) for p in zip(*parts)], bc_rgb)


def importance_depths(z_vals, weights, n_imp: int) -> torch.Tensor:
    """sort(concat(z, sample_pdf(mids, weights[:, 1:-1], n_imp))): the
    fine depths the coarse kernel places."""
    z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
    z_samples = sample_pdf(z_mid, weights[:, 1:-1], n_imp)
    return torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1)[0]


def fused_render_coarse_hier_reference(params, folded, cfg, rays_o, rays_d,
                                       bc_rgb, near, far, n_samples: int,
                                       n_imp: int):
    """Plain PyTorch version of the fused_render_coarse_hier kernel."""
    z = stratified_sample(float(near), float(far), n_samples,
                          rays_o.shape[0], device=rays_o.device)
    coarse = fused_render_rays_reference(params, folded, cfg, rays_o, rays_d,
                                         z, bc_rgb)
    return coarse, importance_depths(z, coarse["weights"], n_imp)


def pdf_depths(z_src, w_src, count: int) -> torch.Tensor:
    """``count`` deterministic inverse-CDF depths from a render's (z, w)
    distribution, its last (plate) sample excluded: bins are the mids of
    z[:, :-1], weights w[:, 1:-2] (eval/temporal.py:_imp_from)."""
    zin, win = z_src[..., :-1], w_src[..., :-1]
    mids = 0.5 * (zin[..., 1:] + zin[..., :-1])
    return sample_pdf(mids, win[..., 1:-1], count)


def delta_depths(z_prev, w_prev, band_lo, band_hi, far, s_uni: int,
                 s_imp: int, extra: Optional[torch.Tensor] = None):
    """A delta frame's depth grid (R, s_imp + s_uni [+ extra] + 1): s_imp
    inverse-CDF depths over the previous frame's (z, w), ``extra`` depths
    if given, s_uni depths lo + (hi - lo) * j / (s_uni - 1) across the
    band, sorted, then the plate pin at ``far`` (eval/temporal.py:
    _delta_depths)."""
    parts = [pdf_depths(z_prev, w_prev, s_imp)]
    if extra is not None:
        parts.append(extra)
    # t_j = j / (s_uni - 1), correctly rounded, as the delta kernel has it
    t = torch.arange(s_uni, dtype=torch.float64, device=band_lo.device)
    t = (t / (s_uni - 1)).to(torch.float32)
    parts.append(band_lo[:, None] + (band_hi - band_lo)[:, None] * t[None])
    z = torch.sort(torch.cat(parts, dim=-1), dim=-1)[0]
    return torch.cat([z, torch.full_like(z[:, :1], float(far))], dim=1)


def _delta_outputs(out, z, lo, hi) -> Dict[str, torch.Tensor]:
    out.update(z_vals=z, band_lo=lo, band_hi=hi,
               fg_mass=out["acc_map"] - out["last_weight"])
    return out


def fused_render_delta_reference(params, folded, cfg, rays_o, rays_d, z_prev,
                                 w_prev, band_lo, band_hi, bc_rgb, far,
                                 s_uni: int, s_imp: int, q_lo: float = 0.02,
                                 q_hi: float = 0.98):
    """Plain PyTorch version of the fused_render_delta kernel: the chain
    delta_depths -> fused_render_rays_reference -> fg_band."""
    z = delta_depths(z_prev.float(), w_prev.float(), band_lo.float(),
                     band_hi.float(), far, s_uni, s_imp)
    out = fused_render_rays_reference(params, folded, cfg, rays_o, rays_d,
                                      z, bc_rgb)
    lo, hi, _ = fg_band(z, out["weights"], q_lo, q_hi)
    return _delta_outputs(out, z, lo, hi)


# ------------------------------------------------ the chain's weights

def swizzle_image_index(rows: int, lanes: int) -> torch.Tensor:
    """(rows, lanes) element offsets of a bf16 matrix in wgmma's 128-byte
    swizzled shared-memory image: 64-lane blocks of rows * 64 elements; in
    a block, groups of 8 rows (1,024 bytes); in a group, one 128-byte row
    whose 16-byte chunks are permuted by chunk ^ (row % 8). With the rows
    along K it is the MN-major layout, with the lanes along K the K-major
    one (csrc/hopper.cuh); fused_mlp_grad.swizzle_index is its 64-row
    case."""
    r = torch.arange(rows)[:, None]
    f = torch.arange(lanes)[None, :]
    return ((f >> 6) * (rows * 64) + ((r >> 3) << 9) + ((r & 7) << 6)
            + ((((f >> 3) & 7) ^ (r & 7)) << 3) + (f & 7))


def chain_tile(width: int) -> int:
    """Points per tile of the chain at a kernel width: 128, or 64 at
    W=512, where the two warpgroups share a tile's rows and split its
    columns (csrc/chain.cuh)."""
    return CHAIN_TILE if width <= 256 else 64


def stage_rows(n: int) -> int:
    """K-rows per 16 KB stage of an n-wide matrix in the bf16 stream."""
    return STAGE_ELEMS // n


def _stream_parts(net: PackedNet, dir_stage: bool = False):
    """The chain's weight stream as (name, matrix (K, N), K-rows per
    stage) in the order the kernel consumes it (csrc/chain.cuh, note at
    the top): STAGE_ELEMS // N K-rows of an N-wide matrix a stage; with
    ``dir_stage`` (the point kernels) view layer 0's dir-PE part follows
    its h-part, as one stage whose rows past PED_PAD are zero. The heads
    have stages of their own."""
    kw, kv = stage_rows(net.width), stage_rows(net.wv[0].shape[1])
    parts = [("w0", net.w[0], kw)]
    for i in range(1, len(net.w)):
        if i in net.wskip:
            parts.append((f"wskip{i}", net.wskip[i], kw))
        parts.append((f"w{i}", net.w[i], kw))
    parts.append(("wv0", net.wv[0], kv))
    if dir_stage:
        parts.append(("wv0d", net.wv0d, kv))
    return parts + [(f"wv{v}", x, kv) for v, x in enumerate(net.wv) if v]


def head_stages(heads) -> int:
    """Stages of the heads' matrices (K-rows of each, HEADS lanes) in the
    stream: w_alpha^T then w_rgb^T, K-major (one at W <= 256, two at
    512)."""
    return -(-HEADS * sum(heads) // STAGE_ELEMS)


@functools.lru_cache(maxsize=16)
def _stream_layout(shapes, heads, device: str):
    """(gather, zero, stage order) for stream parts of the given (name, K,
    N, K-rows per stage, transposed) and heads widths: stream element e is
    source element gather[e], where the source is the parts' matrices
    flattened row-major (a transposed part as the matrix it is the
    transpose of), then w_alpha and w_rgb (row-major, (K, HEADS)), then
    ``zero`` (one bf16 zero), which every element outside the matrices
    takes (a part's rows past K in its last stage, the heads' stages
    past their matrices). No heads, no heads' stages. Built once per net
    shape and device."""
    dst, order, q = [], [], 0
    for name, k, n, kr, transposed in shapes:
        if n * kr != STAGE_ELEMS:
            raise ValueError(f"weight stream: {name} ({k}, {n}) does not cut "
                             f"into {kr}-row stages")
        idx = swizzle_image_index(kr, n)
        rows = torch.arange(k)
        d = ((q + rows // kr) * STAGE_ELEMS)[:, None] + idx[rows % kr]
        dst.append(d.T if transposed else d)
        order += [(name, k0) for k0 in range(0, k, kr)]
        q += -(-k // kr)
    for i, width in enumerate(heads):
        # w_alpha^T (16 x W) then w_rgb^T (16 x WV), K-major, back to back
        img = swizzle_image_index(HEADS, width) + i * HEADS * heads[0]
        dst.append(q * STAGE_ELEMS + img.T)
    if heads:
        order += [("heads", k) for k in range(head_stages(heads))]
    dst = torch.cat([d.reshape(-1) for d in dst])
    gather = torch.full((len(order) * STAGE_ELEMS,), dst.numel(),
                        dtype=torch.long)
    gather[dst] = torch.arange(dst.numel())
    return (gather.to(device), torch.zeros(1, dtype=torch.bfloat16,
                                           device=device), tuple(order))


def weight_stream(parts, heads=()):
    """Stream parts (name, matrix (K, N), K-rows per stage) and the heads'
    matrices (K, HEADS) -> (stream, order): the bf16 weights as (n_stages *
    STAGE_ELEMS,) on the weights' device, each 16 KB stage in its swizzled
    shared-memory image so that one bulk copy fills a stage, and the
    (name, first K-row) of every stage. A part that is the transposed view
    of a contiguous matrix is gathered from that matrix. One concatenation
    and one gather per call."""
    flips = [not m.is_contiguous() for _, m, _ in parts]
    gather, zero, order = _stream_layout(
        tuple((name, *m.shape, kr, t) for (name, m, kr), t in
              zip(parts, flips)),
        tuple(h.shape[0] for h in heads), str(parts[0][1].device))
    src = torch.cat([(m.T if t else m).reshape(-1)
                     for (_, m, _), t in zip(parts, flips)]
                    + [h.reshape(-1) for h in heads] + [zero])
    return src.to(torch.bfloat16)[gather], list(order)


def stream_matrices(stream: torch.Tensor, parts) -> Dict:
    """The plain inverse of weight_stream for its parts: the stream read
    back into (K, N) matrices by name; the parts give only names, shapes
    and stage heights."""
    img = stream.reshape(-1, STAGE_ELEMS)
    out, q = {}, 0
    for name, m, kr in parts:
        k, n = m.shape
        stages = -(-k // kr)
        idx = swizzle_image_index(kr, n).reshape(-1).to(stream.device)
        out[name] = img[q:q + stages][:, idx].reshape(stages * kr, n)[:k]
        q += stages
    return out


def chain_weight_stream(net: PackedNet, dir_stage: bool = False):
    """PackedNet -> (stream, order) of the chain kernels' field MLP
    (weight_stream): matrices of K-rows x N lanes MN-major (32 K-rows of
    256 lanes, 64 of 128: STAGE_ELEMS // N); the heads' stages hold
    w_alpha^T (16 x W) then w_rgb^T (16 x W/2), K-major. ``dir_stage``
    adds view layer 0's dir-PE part (the point kernels' stream)."""
    return weight_stream(_stream_parts(net, dir_stage),
                         (net.w_alpha, net.w_rgb))


def chain_stream_matrices(stream: torch.Tensor, net: PackedNet,
                          dir_stage: bool = False) -> Dict:
    """The plain inverse of chain_weight_stream: the stream read back into
    its matrices by name (``w{i}``, ``wskip{i}``, ``wv{v}``, ``wv0d`` with
    ``dir_stage``, ``w_alpha``, ``w_rgb``); ``net`` gives only the shapes
    and the skip layers."""
    parts = _stream_parts(net, dir_stage)
    out = stream_matrices(stream, parts)
    img = stream.reshape(-1, STAGE_ELEMS)
    q = sum(-(-m.shape[0] // kr) for _, m, kr in parts)
    W, WV = net.w_alpha.shape[0], net.w_rgb.shape[0]
    ia = swizzle_image_index(HEADS, W).reshape(-1).to(stream.device)
    ir = swizzle_image_index(HEADS, WV).reshape(-1).to(stream.device)
    heads = img[q:q + head_stages((W, WV))].reshape(-1)
    out["w_alpha"] = heads[ia].reshape(HEADS, W).T
    out["w_rgb"] = heads[ia.numel() + ir].reshape(HEADS, WV).T
    return out


# ------------------------------------------------------------------ kernels

def _check_cuda(name: str, dtype, align: int = 1,
                **tensors) -> torch.device:
    """Contiguous CUDA tensors of ``dtype`` on one device, each starting at
    a multiple of ``align`` bytes -> that device; anything else raises."""
    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected cuda")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name}: {key} must be contiguous and "
                             f"{align}-byte aligned")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
    return dev


def _check_rays(name: str, net: PackedNet, **tensors) -> torch.device:
    """The kernels take f32, contiguous CUDA tensors of one device and a
    network of one of KERNEL_WIDTHS with its view branch half as wide (the
    wrappers ``widen`` a narrower one first), D<=16; anything else
    raises."""
    dev = _check_cuda(name, torch.float32, **tensors) if tensors else None
    if (net.width not in KERNEL_WIDTHS
            or net.wv[0].shape[1] != net.width // 2):
        raise ValueError(f"{name}: kernel widths are {KERNEL_WIDTHS} (view "
                         f"branch half as wide), network width {net.width} "
                         f"(view branch {net.wv[0].shape[1]}); ROADMAP.md "
                         "B10")
    if not 1 <= len(net.w) <= _MAXD or not 1 <= len(net.wv) <= _MAXV:
        raise ValueError(f"{name}: depth {len(net.w)} / view layers "
                         f"{len(net.wv)} exceed {_MAXD} / {_MAXV}; "
                         "ROADMAP.md B10")
    return dev


def kernels_cover(nerf_cfg) -> bool:
    """Whether the kernels take this FaceNeRF: the view branch, width at
    most the widest of KERNEL_WIDTHS (a net runs on the next width up,
    zero-padded, ``widen``), depth 1.._MAXD, and PE widths inside PE_PAD /
    PED_PAD. The wrappers raise for a net it refuses (ROADMAP.md B10), and
    a launch plan for a net whose tiles cannot fit the shared memory (a
    deep W=512 net's backward)."""
    return (nerf_cfg.use_viewdirs
            and 1 <= nerf_cfg.width <= KERNEL_WIDTHS[-1]
            and 1 <= nerf_cfg.depth <= _MAXD
            and nerf_cfg.input_ch <= PE_PAD
            and nerf_cfg.input_ch_views <= PED_PAD)


def kernel_width(width: int) -> int:
    """The kernels' instance a net of this width runs on: the smallest of
    KERNEL_WIDTHS at least as wide. A wider net raises (ROADMAP.md
    B10)."""
    for kw in KERNEL_WIDTHS:
        if width <= kw:
            return kw
    raise ValueError(f"network width {width} exceeds the kernels' widest, "
                     f"{KERNEL_WIDTHS[-1]}; ROADMAP.md B10")


def widen(net: PackedNet, width: Optional[int] = None) -> PackedNet:
    """A net zero-padded to its kernels' instance (``kernel_width``: 64 ->
    128, 192 -> 256, 384 -> 512; view branch half as wide), or to the
    wider instance ``width``: every padded unit has zero weights in and
    out and a zero bias, so it stays 0 through relu (relu' 0 in the
    backward) and adds nothing, and the kernels compute the narrow net's
    function and gradients. A net of an instance's widths passes as it
    is; a wider net raises (ROADMAP.md B10)."""
    W, WV = net.width, net.wv[0].shape[1]
    KW = kernel_width(max(W, 2 * WV))
    if width is not None:
        if width not in KERNEL_WIDTHS or width < KW:
            raise ValueError(f"widen: {width} is no kernel width at least "
                             f"{KW}; ROADMAP.md B10")
        KW = width
    KV = KW // 2
    if (W, WV) == (KW, KV):
        return net
    pw, pv = KW - W, KV - WV

    def pad(x, rows, cols):
        return F.pad(x, (0, cols, 0, rows)).contiguous()

    return dataclasses.replace(
        net,
        w=[pad(net.w[0], 0, pw)] + [pad(x, pw, pw) for x in net.w[1:]],
        b=[F.pad(x, (0, pw)) for x in net.b],
        wskip={i: pad(x, 0, pw) for i, x in net.wskip.items()},
        wv=[pad(net.wv[0], pw, pv)] + [pad(x, pv, pv) for x in net.wv[1:]],
        bv=[F.pad(x, (0, pv)) for x in net.bv],
        wv0d=pad(net.wv0d, 0, pv), w_alpha=pad(net.w_alpha, pw, 0),
        w_rgb=pad(net.w_rgb, pv, 0))


def narrow(grads: PackedNet, net: PackedNet) -> PackedNet:
    """Gradients of ``widen(net)`` cut back to ``net``'s shapes."""
    if grads.width == net.width:
        return grads

    def cut(x, like):
        return x[tuple(slice(0, n) for n in like.shape)].contiguous()

    return dataclasses.replace(
        grads, w=[cut(x, y) for x, y in zip(grads.w, net.w)],
        b=[cut(x, y) for x, y in zip(grads.b, net.b)],
        wskip={i: cut(x, net.wskip[i]) for i, x in grads.wskip.items()},
        wv=[cut(x, y) for x, y in zip(grads.wv, net.wv)],
        bv=[cut(x, y) for x, y in zip(grads.bv, net.bv)],
        wv0d=cut(grads.wv0d, net.wv0d), w_alpha=cut(grads.w_alpha,
                                                    net.w_alpha),
        w_rgb=cut(grads.w_rgb, net.w_rgb))


def _slots(net: PackedNet, device):
    """Operands flattened into one weight buffer (bf16, or f32 for the
    gradient kernel's f32 variant) and one f32 bias buffer, each matrix
    128-element aligned -> (ctypes slot table, buffers)."""
    wmats = {_SLOT_W + i: x for i, x in enumerate(net.w)}
    wmats.update({_SLOT_WSKIP + i: x for i, x in net.wskip.items()})
    wmats.update({_SLOT_WV + v: x for v, x in enumerate(net.wv)})
    wmats.update({_SLOT_WV0D: net.wv0d, _SLOT_WALPHA: net.w_alpha,
                  _SLOT_WRGB: net.w_rgb})
    fvecs = {_SLOT_B + i: x for i, x in enumerate(net.b)}
    fvecs.update({_SLOT_BV + v: x for v, x in enumerate(net.bv)})
    fvecs[_SLOT_BHEADS] = net.b_heads

    def flatten(items, dtype, align):
        offs, chunks, n = {}, [], 0
        for slot, x in sorted(items.items()):
            flat = x.reshape(-1).to(device=device, dtype=dtype)
            pad = (-flat.numel()) % align
            offs[slot] = n
            chunks.append(F.pad(flat, (0, pad)) if pad else flat)
            n += flat.numel() + pad
        return torch.cat(chunks), offs

    wdtype = net.w[0].dtype
    wbuf, woffs = flatten(wmats, wdtype, 128)
    fbuf, foffs = flatten(fvecs, torch.float32, 32)
    table = (ctypes.c_ulonglong * _NSLOTS)()
    for slot, off in woffs.items():
        table[slot] = wbuf.data_ptr() + wbuf.element_size() * off
    for slot, off in foffs.items():
        table[slot] = fbuf.data_ptr() + 4 * off
    return table, (wbuf, fbuf)


def entry(lib, name: str, width: int):
    """The library's C entry ``name`` of the kernels' instance at
    ``width`` (``fr_render_rays_w128`` ...)."""
    return getattr(lib, f"{name}_w{width}")


def _delta_plan(lib, S: int, s_prev: int, width: int = KERNEL_WIDTH):
    """(rays per group, ring stages) of the delta kernel at ``width``:
    about _DELTA_POINTS points but at most _DELTA_MAX_RAYS rays, with the
    deepest ring (at least _DELTA_MIN_RING stages) that fits the shared
    memory beside them and the block's tiles; fewer rays where nothing
    fits."""
    smem = entry(lib, "fr_chain_smem_bytes", width)
    rb = max(1, min(_DELTA_MAX_RAYS, _DELTA_POINTS // S))
    while True:
        for n in range(lib.fr_max_ring(), _DELTA_MIN_RING - 1, -1):
            if smem(rb, S, s_prev - 2, S - 1, s_prev, n) <= SMEM_LIMIT:
                return rb, n
        if rb == 1:
            raise ValueError(f"S={S}, s_prev={s_prev} does not fit the "
                             f"delta kernel's shared memory at W={width}; "
                             "ROADMAP.md B10")
        rb -= 1


@functools.lru_cache(maxsize=64)
def _render_plan(lib, S: int, n_cdf: int, n_union: int,
                 width: int = KERNEL_WIDTH):
    """(rays per block, ring stages) of the render and coarse kernels at S
    depths and ``width``: a ring of _RENDER_RING stages (fewer only where
    one ray would not fit beside it), the most rays (at most
    _RENDER_MAX_RAYS) that fit the shared memory beside it and the block's
    tiles, cut back to the largest count whose last tile (chain_tile
    points) leaves at most _MAX_TAIL of the block's tile rows empty (the
    most that fit if none does)."""
    smem = entry(lib, "fr_chain_smem_bytes", width)
    tile = chain_tile(width)

    def fits(rb, ring):
        return smem(rb, S, n_cdf, n_union, 0, ring) <= SMEM_LIMIT

    ring = _RENDER_RING
    while not fits(1, ring):
        if ring == 2:
            raise ValueError(f"S={S} does not fit the kernel's shared memory "
                             f"at W={width}; ROADMAP.md B10")
        ring -= 1
    most = 1
    while most < _RENDER_MAX_RAYS and fits(most + 1, ring):
        most += 1
    for rb in range(most, 0, -1):
        rows = -(-rb * S // tile) * tile
        if rows - rb * S <= _MAX_TAIL * rows:
            return rb, ring
    return most, ring


def _state_widths(S: int, n_imp: int):
    """(n_cdf, n_union) of the render kernel (n_imp 0) or of the coarse
    kernel placing n_imp fine depths."""
    return (S - 1, S + n_imp) if n_imp else (0, 0)


def _launch_config(lib, rb: int, ring: int, S: int, n_cdf: int,
                   n_union: int, n_prev: int, width: int) -> Dict[str, int]:
    return {"rays_per_group": rb,
            "smem_bytes": entry(lib, "fr_chain_smem_bytes", width)(
                rb, S, n_cdf, n_union, n_prev, ring),
            "stage_bytes": lib.fr_stage_bytes(), "ring_stages": ring}


def render_launch_config(S: int, n_imp: int = 0,
                         width: int = KERNEL_WIDTH) -> Dict[str, int]:
    """The render kernel's launch at S depths (n_imp 0), or the coarse
    kernel's at S coarse depths placing n_imp fine ones, at the kernels'
    ``width``: rays per block, dynamic shared memory, stage bytes and ring
    depth."""
    lib = build.load_library()
    widths = _state_widths(S, n_imp)
    return _launch_config(lib, *_render_plan(lib, S, *widths, width), S,
                          *widths, 0, width)


def delta_launch_config(S: int, s_prev: int,
                        width: int = KERNEL_WIDTH) -> Dict[str, int]:
    """The delta kernel's launch at S depths from s_prev previous ones, at
    the kernels' ``width``: rays per group, dynamic shared memory, stage
    bytes and ring depth."""
    lib = build.load_library()
    return _launch_config(lib, *_delta_plan(lib, S, s_prev, width), S,
                          s_prev - 2, S - 1, s_prev, width)


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.fr_error_string(err).decode()}")


def _net_args(net: PackedNet):
    return (len(net.w), len(net.wv), net.multires, net.multires_views,
            int(net.softplus))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _chain_args(net: PackedNet, device, dir_stage: bool = False):
    """A chain kernel's operands of one net: (slot table, the buffers it
    and the stream live in, the weight stream's address, its stages);
    ``dir_stage`` for the point kernels' stream."""
    table, keep = _slots(net, device)
    stream, order = chain_weight_stream(net, dir_stage)
    return table, (keep, stream), stream.data_ptr(), len(order)


def fused_render_rays(params, folded, cfg, rays_o, rays_d, z_vals,
                      bc_rgb) -> Dict[str, torch.Tensor]:
    """Fused render of (R,) rays at given sorted depths (R, S) -> dict of
    rgb_map / acc_map / last_weight / depth / weights / rgb_fg.
    Deterministic (eval) semantics; relu or softplus density."""
    if rays_o.device.type == "cpu":
        return fused_render_rays_reference(params, folded, cfg, rays_o,
                                           rays_d, z_vals, bc_rgb)
    net = widen(pack_operands(params, folded, cfg))
    dev = _check_rays("fused_render_rays", net, rays_o=rays_o,
                      rays_d=rays_d, z_vals=z_vals, bc_rgb=bc_rgb)
    R, S = z_vals.shape
    if rays_o.shape != (R, 3) or rays_d.shape != (R, 3) or bc_rgb.shape != (R, 3):
        raise ValueError("fused_render_rays: rays_o/rays_d/bc_rgb must be "
                         f"({R}, 3) to match z_vals {tuple(z_vals.shape)}")
    if R < 1 or S < 2 or R * S >= 2 ** 31:
        raise ValueError(f"fused_render_rays: unsupported R={R}, S={S}")
    lib = build.load_library()
    rb, ring = _render_plan(lib, S, 0, 0, net.width)
    table, keep, ws, n_stages = _chain_args(net, dev)
    summary = torch.empty((R, 8), dtype=torch.float32, device=dev)
    weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    err = entry(lib, "fr_render_rays", net.width)(
        rays_o.data_ptr(), rays_d.data_ptr(), bc_rgb.data_ptr(),
        z_vals.data_ptr(), summary.data_ptr(), weights.data_ptr(), R, S, rb,
        table, *_net_args(net), ws, n_stages, ring, _stream(dev))
    _raise_on(lib, err, "fused_render_rays")
    launch_counts["fused_render_rays"] += 1
    del keep  # stream-ordered: the caching allocator reuses it after the kernel
    return _outputs(summary[:, :3], summary[:, 3], summary[:, 4],
                    summary[:, 5], weights, bc_rgb)


def fused_render_coarse_hier(params, folded, cfg, rays_o, rays_d, bc_rgb,
                             near, far, n_samples: int, n_imp: int):
    """Coarse pass + importance depth placement in one launch ->
    (coarse output dict, z_all (R, n_samples + n_imp) sorted fine depths).
    Deterministic eval semantics, scalar near/far, n_imp > 1."""
    if n_imp <= 1 or n_samples < 3:
        raise ValueError("fused_render_coarse_hier needs n_importance > 1 "
                         f"and n_samples >= 3, got {n_samples}+{n_imp}")
    if rays_o.device.type == "cpu":
        return fused_render_coarse_hier_reference(
            params, folded, cfg, rays_o, rays_d, bc_rgb, near, far,
            n_samples, n_imp)
    net = widen(pack_operands(params, folded, cfg))
    dev = _check_rays("fused_render_coarse_hier", net, rays_o=rays_o,
                      rays_d=rays_d, bc_rgb=bc_rgb)
    R = rays_o.shape[0]
    S, SU = n_samples, n_samples + n_imp
    if rays_d.shape != (R, 3) or bc_rgb.shape != (R, 3) or rays_o.shape != (R, 3):
        raise ValueError("fused_render_coarse_hier: rays_o/rays_d/bc_rgb "
                         "must all be (R, 3)")
    if R < 1 or R * SU >= 2 ** 31:
        raise ValueError(f"fused_render_coarse_hier: unsupported R={R}")
    lib = build.load_library()
    rb, ring = _render_plan(lib, S, *_state_widths(S, n_imp), net.width)
    table, keep, ws, n_stages = _chain_args(net, dev)
    summary = torch.empty((R, 8), dtype=torch.float32, device=dev)
    weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    z_all = torch.empty((R, SU), dtype=torch.float32, device=dev)
    err = entry(lib, "fr_coarse_hier", net.width)(
        rays_o.data_ptr(), rays_d.data_ptr(), bc_rgb.data_ptr(), float(near),
        float(far), summary.data_ptr(), weights.data_ptr(), z_all.data_ptr(),
        R, S, n_imp, rb, table, *_net_args(net), ws, n_stages, ring,
        _stream(dev))
    _raise_on(lib, err, "fused_render_coarse_hier")
    launch_counts["fused_render_coarse_hier"] += 1
    del keep
    coarse = _outputs(summary[:, :3], summary[:, 3], summary[:, 4],
                      summary[:, 5], weights, bc_rgb)
    return coarse, z_all


def fused_render_delta(params, folded, cfg, rays_o, rays_d, z_prev, w_prev,
                       band_lo, band_hi, bc_rgb, far, s_uni: int, s_imp: int,
                       q_lo: float = 0.02, q_hi: float = 0.98
                       ) -> Dict[str, torch.Tensor]:
    """Temporal delta frame in one launch: (R,) rays, the previous frame's
    (R, s_prev) depths and weights and the cached (R,) band -> the
    fused_render_rays dict plus ``z_vals`` (R, S = s_uni + s_imp + 1, the
    plate pin at ``far`` last), ``band_lo``/``band_hi`` (the central
    [q_lo, q_hi] band of this frame's weights) and ``fg_mass`` (acc -
    last_weight). Deterministic eval semantics; s_uni, s_imp >= 2."""
    if s_uni < 2 or s_imp < 2:
        raise ValueError("fused_render_delta needs s_uni >= 2 and s_imp >= 2,"
                         f" got {s_uni} and {s_imp}")
    R, s_prev = z_prev.shape
    if s_prev < 4:
        raise ValueError(f"fused_render_delta: s_prev={s_prev} leaves no "
                         "weight to place depths by (needs >= 4)")
    if rays_o.device.type == "cpu":
        return fused_render_delta_reference(
            params, folded, cfg, rays_o, rays_d, z_prev, w_prev, band_lo,
            band_hi, bc_rgb, far, s_uni, s_imp, q_lo, q_hi)
    net = widen(pack_operands(params, folded, cfg))
    dev = _check_rays("fused_render_delta", net, rays_o=rays_o,
                      rays_d=rays_d, z_prev=z_prev, w_prev=w_prev,
                      band_lo=band_lo, band_hi=band_hi, bc_rgb=bc_rgb)
    S = s_uni + s_imp + 1
    if (rays_o.shape != (R, 3) or rays_d.shape != (R, 3)
            or bc_rgb.shape != (R, 3) or w_prev.shape != (R, s_prev)
            or band_lo.shape != (R,) or band_hi.shape != (R,)):
        raise ValueError("fused_render_delta: rays_o/rays_d/bc_rgb must be "
                         f"({R}, 3), w_prev ({R}, {s_prev}), band_lo/band_hi "
                         f"({R},) to match z_prev {tuple(z_prev.shape)}")
    if R < 1 or R * max(S, s_prev) >= 2 ** 31:
        raise ValueError(f"fused_render_delta: unsupported R={R}")
    lib = build.load_library()
    rb, ring = _delta_plan(lib, S, s_prev, net.width)
    table, keep, ws, n_stages = _chain_args(net, dev)
    summary = torch.empty((R, 8), dtype=torch.float32, device=dev)
    weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    z_out = torch.empty((R, S), dtype=torch.float32, device=dev)
    err = entry(lib, "fr_render_delta", net.width)(
        rays_o.data_ptr(), rays_d.data_ptr(), bc_rgb.data_ptr(),
        z_prev.data_ptr(), w_prev.data_ptr(), band_lo.data_ptr(),
        band_hi.data_ptr(), float(far), float(q_lo), float(q_hi),
        summary.data_ptr(), weights.data_ptr(), z_out.data_ptr(), R, s_prev,
        s_uni, s_imp, rb, table, *_net_args(net), ws, n_stages, ring,
        _stream(dev))
    _raise_on(lib, err, "fused_render_delta")
    launch_counts["fused_render_delta"] += 1
    del keep
    out = _outputs(summary[:, :3], summary[:, 3], summary[:, 4],
                   summary[:, 5], weights, bc_rgb)
    return _delta_outputs(out, z_out, summary[:, 6], summary[:, 7])


def _is_scalar(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.ndim == 0


def render_rays_fused(
    coarse_params,
    coarse_folded: Dict,
    cfg,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    bc_rgb: torch.Tensor,
    near,
    far,
    n_samples: int,
    n_importance: int = 0,
    fine_params=None,
    fine_folded: Optional[Dict] = None,
    lindisp: bool = False,
) -> Dict[str, torch.Tensor]:
    """Hierarchical render with both passes in the fused kernels.

    Deterministic (eval) semantics — the fused counterpart of
    core.render.render_rays with perturb=0. With scalar near/far, linear
    depth and n_importance > 1 the coarse kernel places the fine depths
    itself; otherwise the plain sampler places them and both passes go
    through the fine kernel."""
    n_rays = rays_o.shape[0]
    fp = fine_params if fine_params is not None else coarse_params
    ff = fine_folded if fine_folded is not None else coarse_folded
    use_hier = (n_importance > 1 and not lindisp and _is_scalar(near)
                and _is_scalar(far))

    if use_hier:
        coarse, z_all = fused_render_coarse_hier(
            coarse_params, coarse_folded, cfg, rays_o, rays_d, bc_rgb,
            float(near), float(far), n_samples, n_importance)
    else:
        z_vals = stratified_sample(near, far, n_samples, n_rays,
                                   lindisp=lindisp, device=rays_o.device)
        coarse = fused_render_rays(coarse_params, coarse_folded, cfg, rays_o,
                                   rays_d, z_vals, bc_rgb)
        if n_importance <= 0:
            return coarse
        z_all = importance_depths(z_vals, coarse["weights"],
                                            n_importance)
    fine = fused_render_rays(fp, ff, cfg, rays_o, rays_d, z_all, bc_rgb)
    fine.update(
        rgb0=coarse["rgb_map"], acc0=coarse["acc_map"],
        rgb_fg0=coarse["rgb_fg"], last_weight0=coarse["last_weight"],
    )
    return fine
