"""Kernel-diagnosis probes of the fused MLP (counterparts of the Pallas
kernels in the JAX package's ``scripts/kdiag{,2,3,4,5}.py``).

The kernels (``csrc/kdiag.cu``, and ``csrc/kdiag_pe.cu`` for the two on
given encodings, the ladder and render probe A; CUDA C++ for sm_90a) each
isolate a part of the production kernels' time:

- ``chain``: ``depth`` chained (rows, 256) @ (256, 256) products with one
  epilogue between layers (kdiag.py, kdiag4.py, kdiag5.py). bf16 with f32
  accumulation runs on the wgmma chain that K1-K5 run (``csrc/chain.cuh``),
  fed by ``chain_weight_stream(ws)`` (cached per ``ws``), in seven modes:
  cast, relu, bias_relu, select, cast_max, relu2 (bias_relu with the two
  warpgroups skewed by half a layer, so that one's epilogue overlaps the
  other's products) and sum (the input times every layer into one
  accumulator, no epilogue or barrier between layers: the products' and
  the stream's own rate, a mode of this port only). ``rows_per_block``
  names the plan: 128 is one 128-row tile a step on two consumer
  warpgroups that share each weight stage (one block per SM, a ring of 8
  stages), 64 a block of one consumer warpgroup on 64-row tiles (two
  blocks per SM, each streaming its own weights, a ring of 4); blocks walk
  a run of tiles, at most one wave (``chain_launch_config``). f32 runs on
  the CUDA cores (64 rows per block), int8 with s32 accumulation and two
  requants on wmma (64 or 128 rows per block).
- ``ladder``: the production trunk, then + skip, + view branch (rungs
  v0-v2): the encoded-input point MLP (K5) stopped after its trunk or its
  view branch, on K5's chain, launch plan and a prefix of its weight
  stream (``ladder_stream``; v0 on the net without its skip pe-part),
  the last activation written out; rung v3 is K5 itself and v4 the
  in-kernel-PE point MLP (K4) (kdiag2.py). v0, v1, v2 and v3 split K5's
  time into trunk, skip, view branch and heads.
- ``render_probe_a``: the fine pass's MLP from given PE, without
  compositing (kdiag3.py A), on K1's chain, weight stream and launch
  plan, each point's PE row copied into the tile; B less A is the PE
  built in the kernel.
- ``render_probe_b``: the fine pass (K1) without its compositing, on K1's
  chain, tile source and launch plan, raw rows to global memory
  (kdiag3.py B; its C is the fine pass itself). K1 less B is K1's
  per-ray code and compositing.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``launch_counts``; for CPU tensors it runs the plain PyTorch version
beside it (``*_reference``). ``chain_library`` is the yardstick made of
PyTorch calls (``torch.matmul`` or ``torch._int_mm`` per layer), never
called by the probes themselves.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.core.embedding import positional_encoding
from idealnerf_tpu_torch.kernels import build, fused_render
from idealnerf_tpu_torch.kernels.fused_mlp import (
    _check_n, _point_plan, _sm_count, point_mlp_pe, point_mlp_pe_reference,
)
from idealnerf_tpu_torch.kernels.fused_render import (
    _KC_W, _REF_CHUNK_POINTS, KERNEL_WIDTH, PE_PAD, PED_PAD, SMEM_LIMIT,
    STAGE_ELEMS, PackedNet, _bf16, _chain_args, _check_cuda, _check_rays,
    _mlp_reference, _raise_on, _render_plan, _slots, _stream, weight_stream,
)

# epilogue modes of csrc/kdiag.cu (enum Mode)
MODES = {"cast": 0, "relu": 1, "bias_relu": 2, "select": 3, "cast_max": 4,
         "relu2": 5, "i0": 6, "i1": 7, "sum": 8}
CHAIN_MODES = {torch.bfloat16: ("cast", "relu", "bias_relu", "select",
                                "cast_max", "relu2", "sum"),
               torch.float32: ("relu",), torch.int8: ("i0", "i1")}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
_CHAIN_COUNT = {torch.bfloat16: "kdiag_chain_bf16",
                torch.float32: "kdiag_chain_f32",
                torch.int8: "kdiag_chain_int8"}
_BIAS_MODES = ("bias_relu", "relu2")

# the bf16 chain's weight streams by weights (chain_weight_stream), at most
# this many
_STREAM_CACHE: dict = {}
_STREAM_CACHE_SIZE = 4

launch_counts = {"kdiag_chain_bf16": 0, "kdiag_chain_f32": 0,
                 "kdiag_chain_int8": 0, "kdiag_ladder": 0,
                 "kdiag_render_a": 0, "kdiag_render_b": 0}

# rows of the ladder's rungs (kdiag2.py's names)
LADDER = ("trunk only", "+skip", "+view", "+heads", "+in-kernel PE")


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ------------------------------------------------------------------ chains

def i0_scale(li: int) -> torch.Tensor:
    """I0's requant scale of layer ``li``, rounded to f32 once."""
    return torch.tensor(0.25 / (li + 2.0), dtype=torch.float32)


def _requant(acc: torch.Tensor, mode: str, li: int) -> torch.Tensor:
    """Integer-valued accumulator -> int8 (kdiag5.py's I0 and I1)."""
    if mode == "i1":
        return (acc.clamp_min(0).long() >> 6).clamp_max(127).to(torch.int8)
    q = acc.clamp_min(0).float() * i0_scale(li).to(acc.device)
    return torch.clamp(q + 0.5, 0.0, 127.0).to(torch.int8)


def _epilogue(acc: torch.Tensor, mode: str, b: Optional[torch.Tensor]):
    """f32 accumulator -> the next layer's input, before its cast to the
    chain's type (relu is left in f32: the bf16 chain rounds it after)."""
    if mode == "cast":
        return acc.to(torch.bfloat16)
    if mode == "select":
        return torch.where(acc > 0, acc, 0.0).to(torch.bfloat16)
    if mode == "cast_max":
        return acc.to(torch.bfloat16).clamp_min(0)
    if mode in _BIAS_MODES:
        return torch.relu(acc + b).to(torch.bfloat16)
    return torch.relu(acc)


def chain_reference(x: torch.Tensor, ws: torch.Tensor, mode: str,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of ``chain``. bf16 values multiply exactly in f32, so
    an f32 product of bf16-valued operands is bf16 x bf16 with f32
    accumulation; int8 products are summed in f64, exactly."""
    _check_mode(x.dtype, mode, bias, out_dtype)
    if x.dtype == torch.int8:
        h = x
        for li in range(ws.shape[0]):
            h = _requant(h.double() @ ws[li].double(), mode, li)
        return h.to(out_dtype)
    if mode == "sum":
        acc = sum(x.float() @ w.float() for w in ws)
        return acc.to(torch.bfloat16).to(out_dtype)
    h = x.float()
    for li in range(ws.shape[0]):
        acc = h @ ws[li].float()
        h = _epilogue(acc, mode, None if bias is None else bias[li])
        h = h.to(x.dtype).float()
    return h.to(out_dtype)


def chain_library(x: torch.Tensor, ws: torch.Tensor, mode: str = "relu"
                  ) -> torch.Tensor:
    """The chain as PyTorch calls: ``torch.matmul`` + relu per layer in
    the input's type (bf16, or f32 with TF32 off, as the f32 chain
    computes), or ``torch._int_mm`` + I0's requant for int8 -> f32. The
    yardstick the probes are timed against."""
    h = x
    if x.dtype == torch.int8:
        if mode != "i0":
            raise ValueError("chain_library: int8 takes mode i0")
        for li in range(ws.shape[0]):
            h = _requant(torch._int_mm(h, ws[li]), mode, li)
        return h.float()
    if mode != "relu":
        raise ValueError("chain_library: float chains take mode relu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for li in range(ws.shape[0]):
            h = torch.relu(torch.matmul(h, ws[li]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return h.float()


def _check_mode(dtype, mode: str, bias, out_dtype) -> None:
    if dtype not in CHAIN_MODES or mode not in CHAIN_MODES[dtype]:
        raise ValueError(f"chain: mode {mode!r} is not one of "
                         f"{CHAIN_MODES.get(dtype)} for {dtype}")
    if (bias is None) == (mode in _BIAS_MODES):
        raise ValueError(f"chain: mode {mode!r} "
                         + ("needs" if bias is None else "takes no")
                         + " bias")
    if out_dtype not in (torch.float32, dtype) or out_dtype == torch.int8:
        raise ValueError(f"chain: {dtype} chains write f32"
                         + (" or bf16" if dtype == torch.bfloat16 else ""))


def chain_stream_parts(ws: torch.Tensor):
    """The bf16 chain's weight stream as stream parts (name, matrix (K, N),
    K-rows per stage) for ``fused_render.weight_stream``: layer l's (256,
    256) matrix as 8 stages of 32 K-rows, in layer order."""
    return [(f"w{li}", ws[li], _KC_W) for li in range(ws.shape[0])]


def chain_weight_stream(ws: torch.Tensor) -> torch.Tensor:
    """(depth, 256, 256) bf16 weights -> the bf16 chain's weight stream,
    (depth * 8 * 8192,) bf16, each 16 KB stage in wgmma's swizzled MN-major
    image; ``fused_render.stream_matrices`` with ``chain_stream_parts``
    reads it back."""
    return weight_stream(chain_stream_parts(ws))[0]


def _cached_stream(ws: torch.Tensor) -> torch.Tensor:
    """``chain_weight_stream(ws)``, built once per weights (their address,
    version and shape; the cache holds ``ws``, so no other tensor can take
    its address while the entry lives), so that a timed call measures the
    kernel and not the gather."""
    key = (ws.data_ptr(), ws._version, tuple(ws.shape), str(ws.device))
    hit = _STREAM_CACHE.get(key)
    if hit is None:
        hit = _STREAM_CACHE[key] = (ws, chain_weight_stream(ws))
        while len(_STREAM_CACHE) > _STREAM_CACHE_SIZE:
            del _STREAM_CACHE[next(iter(_STREAM_CACHE))]
    return hit[1]


def _check_shapes(x: torch.Tensor, ws: torch.Tensor, bias,
                  rows_per_block: int) -> None:
    """What every chain takes, on either device: x (rows, 256), ws (depth,
    256, 256) with depth 1..64, bias (depth, 256), and the rows per block
    of the kernel of x's type."""
    rows = x.shape[0]
    if x.shape != (rows, KERNEL_WIDTH) or ws.ndim != 3 or ws.shape[1:] != (
            KERNEL_WIDTH, KERNEL_WIDTH) or not 1 <= ws.shape[0] <= 64:
        raise ValueError(f"chain: x must be (rows, {KERNEL_WIDTH}) and ws "
                         f"(depth 1..64, {KERNEL_WIDTH}, {KERNEL_WIDTH}), got "
                         f"{tuple(x.shape)} and {tuple(ws.shape)}")
    if bias is not None and bias.shape != (ws.shape[0], KERNEL_WIDTH):
        raise ValueError(f"chain: bias must be ({ws.shape[0]}, "
                         f"{KERNEL_WIDTH}), got {tuple(bias.shape)}")
    allowed = (64,) if x.dtype == torch.float32 else (64, 128)
    if rows_per_block not in allowed:
        raise ValueError(f"chain: rows_per_block {rows_per_block} not in "
                         f"{allowed} for {x.dtype}")
    if not 1 <= rows < 2 ** 31 - 128:
        raise ValueError(f"chain: unsupported rows={rows}")


def chain(x: torch.Tensor, ws: torch.Tensor, mode: str,
          bias: Optional[torch.Tensor] = None, rows_per_block: int = 64,
          out_dtype=torch.float32) -> torch.Tensor:
    """x (rows, 256) through ws (depth, 256, 256) with ``mode``'s epilogue
    after every layer -> (rows, 256) ``out_dtype``. bf16 modes: cast,
    relu, bias_relu, select, cast_max, relu2 (bias_relu with the two
    warpgroups of a 128-row tile skewed by half a layer; at 64 rows per
    block, bias_relu), sum (bf16 of x @ ws[0] + x @ ws[1] + ..., no
    epilogue between layers); f32: relu; int8: i0, i1. ``bias`` (depth,
    256) f32 for bias_relu and relu2. ``rows_per_block``: the plan (the
    module's note; f32 takes 64 only). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    _check_mode(x.dtype, mode, bias, out_dtype)
    _check_shapes(x, ws, bias, rows_per_block)
    if x.device.type == "cpu":
        return chain_reference(x, ws, mode, bias, out_dtype)
    dev = _check_cuda("chain", x.dtype, 16, x=x, ws=ws)
    if bias is not None and _check_cuda("chain", torch.float32, 16,
                                        bias=bias) != dev:
        raise ValueError(f"chain: bias on {bias.device}, x on {dev}")
    w = _cached_stream(ws) if x.dtype == torch.bfloat16 else ws
    lib = build.load_library()
    out = torch.empty((x.shape[0], KERNEL_WIDTH), dtype=out_dtype,
                      device=dev)
    err = lib.kd_chain(x.data_ptr(), w.data_ptr(),
                       None if bias is None else bias.data_ptr(),
                       out.data_ptr(), int(out_dtype == torch.float32),
                       x.shape[0], ws.shape[0], _DTYPE_CODE[x.dtype],
                       MODES[mode], rows_per_block, _stream(dev))
    _raise_on(lib, err, "chain")
    launch_counts[_CHAIN_COUNT[x.dtype]] += 1
    return out


def chain_launch_config(rows: int, rows_per_block: int) -> dict:
    """The bf16 chain's launch on ``rows`` rows on the current card:
    tiles per block, blocks, ring stages, dynamic shared memory, threads
    per block."""
    lib = build.load_library()
    plan = (ctypes.c_int * 5)()
    _raise_on(lib, lib.kd_chain_config(rows, rows_per_block, plan),
              "chain_launch_config")
    return dict(zip(("tiles_per_block", "blocks", "ring_stages",
                     "smem_bytes", "threads"), plan))


# ------------------------------------------------------------------ ladder

def ladder_macs(net: PackedNet, stage: int) -> int:
    """Multiply-adds per point of rung ``stage`` on the net's useful
    (unpadded) widths: the trunk, + the skip's pe-part, + the view branch
    with its dir-PE part, + the heads (rgb 3 and sigma 1 columns)."""
    W, V = net.width, net.width // 2
    pe, ped = 3 * (1 + 2 * net.multires), 3 * (1 + 2 * net.multires_views)
    m = pe * W + (len(net.w) - 1) * W * W
    if stage >= 1:
        m += pe * W * len(net.wskip)
    if stage >= 2:
        m += W * V + ped * V + (len(net.wv) - 1) * V * V
    if stage >= 3:
        m += W + 3 * V
    return m


def ladder_reference(net: PackedNet, pe: torch.Tensor, ped: torch.Tensor,
                     stage: int) -> torch.Tensor:
    """Plain version of ``ladder``'s rungs 0-3."""
    if stage == 3:
        return point_mlp_pe_reference(net, pe, ped)
    pe = pe.float()
    h = _bf16(torch.relu(pe @ net.w[0].float() + net.b[0]))
    for i in range(1, len(net.w)):
        acc = h @ net.w[i].float()
        if stage >= 1 and i in net.wskip:
            acc = pe @ net.wskip[i].float() + acc
        h = _bf16(torch.relu(acc + net.b[i]))
    if stage < 2:
        return h.to(torch.bfloat16)
    hv = _bf16(torch.relu(h @ net.wv[0].float() + ped.float()
                          @ net.wv0d.float() + net.bv[0]))
    for v in range(1, len(net.wv)):
        hv = _bf16(torch.relu(hv @ net.wv[v].float() + net.bv[v]))
    return hv.to(torch.bfloat16)


def ladder_net(net: PackedNet, stage: int) -> PackedNet:
    """The net rung ``stage`` runs: without its skip pe-part for v0."""
    return dataclasses.replace(net, wskip={}) if stage == 0 else net


def ladder_stream(net: PackedNet, stage: int):
    """Rung ``stage``'s weight stream -> (stream, stages): the prefix of
    K5's stream (``fused_render.chain_weight_stream(ladder_net(net,
    stage), dir_stage=True)``) that the rung consumes, the trunk's stages
    for v0 and v1 (58 and 60 for the paper model) or all but the heads'
    for v2 (69 of 70)."""
    stream, order = fused_render.chain_weight_stream(ladder_net(net, stage),
                                                     dir_stage=True)
    n = sum(name != "heads" and (stage == 2 or not name.startswith("wv"))
            for name, _ in order)
    return stream[:n * STAGE_ELEMS], n


def ladder(net: PackedNet, pe: torch.Tensor, ped: torch.Tensor,
           stage: int) -> torch.Tensor:
    """Rung ``stage`` of kdiag2.py's ladder on a packed bf16 net from (N,
    PE_PAD) and (N, PED_PAD) bf16 encodings: 0 the trunk without the
    skip's pe-part -> (N, W) bf16; 1 the whole trunk -> (N, W); 2 + the
    view branch -> (N, W/2); 3 + the heads -> (N, 4) f32, the encoded-input
    point MLP kernel (K5). Rungs 0-2 run K5's chain at K5's launch plan
    (``fused_mlp._point_plan``) on ``ladder_stream``, built on every call
    as K5's wrapper builds its stream. Rung 4, + the PE in the kernel, is
    ``fused_mlp.point_mlp`` (K4) on raw coordinates. CUDA tensors launch
    the kernel, CPU tensors take the plain version."""
    if stage == 3:
        return point_mlp_pe(net, pe, ped)
    if stage not in (0, 1, 2):
        raise ValueError(f"ladder: stage {stage} not in 0-3")
    if pe.device.type == "cpu":
        return ladder_reference(net, pe, ped, stage)
    if net.w[0].dtype != torch.bfloat16:
        raise TypeError("ladder: the kernel takes bf16 weights")
    dev = _check_cuda("ladder", torch.bfloat16, 16, pe=pe, ped=ped)
    _check_rays("ladder", net)
    N = pe.shape[0]
    if pe.shape != (N, PE_PAD) or ped.shape != (N, PED_PAD):
        raise ValueError(f"ladder: pe and ped must be (N, {PE_PAD}) and (N, "
                         f"{PED_PAD}), got {tuple(pe.shape)} and "
                         f"{tuple(ped.shape)}")
    _check_n("ladder", N)
    lib = build.load_library()
    per_block, _, ring = _point_plan(lib, N, _sm_count(dev))
    table, keep = _slots(ladder_net(net, stage), dev)
    stream, n_stages = ladder_stream(net, stage)
    width = net.width if stage < 2 else net.width // 2
    out = torch.empty((N, width), dtype=torch.bfloat16, device=dev)
    err = lib.kd_ladder(pe.data_ptr(), ped.data_ptr(), out.data_ptr(), N,
                        stage, per_block, table, len(net.w), len(net.wv),
                        stream.data_ptr(), n_stages, ring, _stream(dev))
    _raise_on(lib, err, "ladder")
    launch_counts["kdiag_ladder"] += 1
    del keep, stream
    return out


# ------------------------------------------------------------ render probes

def encode_rays(net: PackedNet, rays_o: torch.Tensor, rays_d: torch.Tensor,
                z: torch.Tensor):
    """The fine pass's encodings of rays at depths z (R, S) -> (pe (R*S,
    PE_PAD), ped (R, PED_PAD)), zero-padded bf16: the xyz-PE of o + z d and
    the dir-PE of the unit view direction."""
    R, S = z.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    pe = positional_encoding(pts.reshape(R * S, 3).float(), net.multires)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    ped = positional_encoding(viewdirs.float(), net.multires_views)
    return (F.pad(pe, (0, PE_PAD - pe.shape[-1])).to(torch.bfloat16),
            F.pad(ped, (0, PED_PAD - ped.shape[-1])).to(torch.bfloat16))


def render_probe_a_reference(net: PackedNet, pe: torch.Tensor,
                             ped: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version of ``render_probe_a`` -> raw (R, S*4)."""
    R = ped.shape[0]
    pv = ped.float() @ net.wv0d.float() + net.bv[0]
    step = max(1, _REF_CHUNK_POINTS // S)
    parts = [_mlp_reference(net, pe[s * S:(s + step) * S].float(),
                            pv[s:s + step].repeat_interleave(S, 0))
             for s in range(0, R, step)]
    return torch.cat(parts, 0).reshape(R, S * 4)


def render_probe_b_reference(net: PackedNet, rays_o: torch.Tensor,
                             rays_d: torch.Tensor, z: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of ``render_probe_b`` -> raw (R, S*4)."""
    R, S = z.shape
    step = max(1, _REF_CHUNK_POINTS // S)
    parts = []
    for s in range(0, R, step):
        pe, ped = encode_rays(net, rays_o[s:s + step], rays_d[s:s + step],
                              z[s:s + step])
        parts.append(render_probe_a_reference(net, pe, ped, S))
    return torch.cat(parts, 0)


def _render_probe_plan(lib, S: int, probe: str):
    """Render probe ``probe``'s ("a" or "b") (rays per block, ring stages)
    at S depths: K1's (fused_render._render_plan), so that its blocks,
    tiles and ring are K1's, K1 less probe B is K1's per-ray code and
    compositing, and B less A is the PE built in the kernel. A probe's
    per-ray state has no raw or weight rows, so it fits wherever K1's
    does; the shared memory this frees stays unused."""
    rb, ring = _render_plan(lib, S, 0, 0)
    smem = getattr(lib, f"kd_render_{probe}_smem_bytes")
    if smem(rb, S, ring) > SMEM_LIMIT:
        raise ValueError(f"S={S} does not fit probe {probe.upper()}'s "
                         "shared memory")
    return rb, ring


def render_probe_launch_config(S: int, probe: str) -> dict:
    """Render probe ``probe``'s ("a" or "b") launch at S depths: rays per
    block, dynamic shared memory, ring stages."""
    lib = build.load_library()
    rb, ring = _render_probe_plan(lib, S, probe)
    return {"rays_per_group": rb, "ring_stages": ring,
            "smem_bytes": getattr(lib, f"kd_render_{probe}_smem_bytes")(
                rb, S, ring)}


def render_probe_a(net: PackedNet, pe: torch.Tensor, ped: torch.Tensor,
                   S: int) -> torch.Tensor:
    """kdiag3.py A: the fine pass's MLP from given encodings, (R*S,
    PE_PAD) bf16 xyz-PE and (R, PED_PAD) bf16 per-ray dir-PE -> raw (R,
    S*4) f32 [rgb logits, sigma], no compositing. K1's chain, weight
    stream and launch plan; the stream and operand table built on every
    call, as K1's wrapper builds them. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if pe.device.type == "cpu":
        return render_probe_a_reference(net, pe, ped, S)
    dev = _check_cuda("render_probe_a", torch.bfloat16, 16, pe=pe, ped=ped)
    _check_rays("render_probe_a", net)
    R = ped.shape[0]
    if pe.shape != (R * S, PE_PAD) or ped.shape != (R, PED_PAD):
        raise ValueError(f"render_probe_a: pe must be ({R * S}, {PE_PAD}) and "
                         f"ped ({R}, {PED_PAD}), got {tuple(pe.shape)} and "
                         f"{tuple(ped.shape)}")
    if R < 1 or S < 1 or R * S >= 2 ** 31:
        raise ValueError(f"render_probe_a: unsupported R={R}, S={S}")
    if net.w[0].dtype != torch.bfloat16:
        raise TypeError("render_probe_a: the kernel takes bf16 weights")
    lib = build.load_library()
    rb, ring = _render_probe_plan(lib, S, "a")
    table, keep, ws, n_stages = _chain_args(net, dev)
    raw = torch.empty((R, S * 4), dtype=torch.float32, device=dev)
    err = lib.kd_render_a(pe.data_ptr(), ped.data_ptr(), raw.data_ptr(), R,
                          S, rb, table, len(net.w), len(net.wv), ws,
                          n_stages, ring, _stream(dev))
    _raise_on(lib, err, "render_probe_a")
    launch_counts["kdiag_render_a"] += 1
    del keep
    return raw


def render_probe_b(net: PackedNet, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """kdiag3.py B: the fine pass (K1) without its compositing, the PE
    built in the kernel from (R, 3) rays and (R, S) depths -> raw (R, S*4)
    f32. K1's chain, ray tile source and launch plan; the net's weight
    stream and operand table built on every call, as K1's wrapper builds
    them. CUDA tensors launch the kernel, CPU tensors take the plain
    version."""
    if rays_o.device.type == "cpu":
        return render_probe_b_reference(net, rays_o, rays_d, z)
    if net.w[0].dtype != torch.bfloat16:
        raise TypeError("render_probe_b: the kernel takes bf16 weights")
    dev = _check_rays("render_probe_b", net, rays_o=rays_o, rays_d=rays_d,
                      z=z)
    R, S = z.shape
    if rays_o.shape != (R, 3) or rays_d.shape != (R, 3):
        raise ValueError(f"render_probe_b: rays must be ({R}, 3) to match z "
                         f"{tuple(z.shape)}")
    if R < 1 or S < 1 or R * S >= 2 ** 31:
        raise ValueError(f"render_probe_b: unsupported R={R}, S={S}")
    lib = build.load_library()
    rb, ring = _render_probe_plan(lib, S, "b")
    table, keep, ws, n_stages = _chain_args(net, dev)
    raw = torch.empty((R, S * 4), dtype=torch.float32, device=dev)
    err = lib.kd_render_b(rays_o.data_ptr(), rays_d.data_ptr(), z.data_ptr(),
                          raw.data_ptr(), R, S, rb, table, len(net.w),
                          len(net.wv), net.multires, net.multires_views, ws,
                          n_stages, ring, _stream(dev))
    _raise_on(lib, err, "render_probe_b")
    launch_counts["kdiag_render_b"] += 1
    del keep
    return raw
