"""The f32 backward of the fused point MLP (``train_fused`` 1) as its two
CUDA kernels lay it out (kernels/fused_mlp_grad.py: grad_pass_a and
grad_pass_b on f32 weights), on the CPU: the row-major f32 operand planes, the f32
weight stream and its plain inverse, a torch emulation of pass A f32's
tile walk (64-point tiles, the stream's stages, the bias sums' order)
against grad_pass_a_reference, an emulation of pass B f32's output tiles
and point chunks, and the emulated pass A composed with pass B against
the JAX package's f32 VJP (Pallas in interpret mode) at 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_mlp_grad import (
    TOL, _jax_grads, _norm_rel, _port_grads, _setup,
)

from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.kernels.fused_render import (
    HEADS, PED_PAD, PE_PAD, model_leaves, pack_leaves,
)
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, FaceNeRFConfig, fold_conditioning,
)

DIMS = dict(depth=8, width=256, dim_aud=16, dim_expr=8, dim_latent=4)
# 2-layer nets of the kernel's width with and without a skip layer, and a
# narrow net of the paper's depth, which the kernels run widened
NETS = {"d2-skip": dict(depth=2, skips=(0,)),
        "d2-noskip": dict(depth=2, skips=()),
        "narrow": dict(depth=8, width=64)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensor ops on one thread: under the suite's parallel workers
    a thread pool per op made these emulations many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(name, n, seed=7):
    """A packed f32 net of NETS, widened to the paper width (W=256; the
    kernels' other widths: test_torch_widths.py), and n seeded points,
    unit directions and a cotangent."""
    cfg = FaceNeRFConfig(**{**DIMS, **NETS[name]})
    model = FaceNeRF(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + n)
    folded = fold_conditioning(
        model, cfg, torch.from_numpy(rng.randn(16) * 0.3).float(),
        torch.from_numpy(rng.randn(8) * 0.3).float(), torch.full((4,), 0.1))
    net = fr.widen(pack_leaves(cfg, model_leaves(model, folded, cfg),
                               torch.float32), 256)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = (rng.randn(n, 4) / 64).astype(np.float32)
    return net, *(torch.from_numpy(x) for x in (pts, dirs, g))


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / (want.norm() + 1e-30))


def _flat(p):
    return [*p.w, *p.b, *p.wskip.values(), *p.wv, *p.bv, p.wv0d, p.w_alpha,
            p.w_rgb, p.b_heads]


def _planes_of(b):
    return [b.pe, b.ped, b.gb, *b.hs, *b.hvs, *b.dcs, *b.dvs]


def _write_planes(net, bufs, n_tiles):
    """GradBuffers (rows up to n_tiles * 64; fewer are zero-padded) written
    into grad_planes_f32's buffer as pass A f32 writes it."""
    offs, widths, total = fmg.grad_planes_f32(net, n_tiles)
    planes = torch.full((total,), float("nan"))
    rows = n_tiles * fmg.GRAD_TILE
    for off, width, x in zip(offs, widths, _planes_of(bufs)):
        assert x.shape[1] == width
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, rows - x.shape[0]))
        planes[off:off + rows * width] = x.reshape(-1)
    return planes, offs


# ------------------------------------------------------- layout and stream

def test_f32_planes_layout_and_round_trip_to_pass_b():
    """The planes that csrc/fused_mlp_grad.cuh's f32 passes assume: pe,
    ped, gb, h, hv, dc, dv back to back, row-major at their own widths
    (64, 32, 16, then W or W/2), each 128-byte aligned; grad_pass_a_
    reference's buffers written there and read back (buffers_from_planes_
    f32, as a check on the card reads the kernel's planes) give pass B the
    same gradients, bitwise."""
    net, pts, dirs, g = _net("d2-skip", 300)
    D, V, W, WV = len(net.w), len(net.wv), net.width, net.width // 2
    n_tiles = 5
    offs, widths, total = fmg.grad_planes_f32(net, n_tiles)
    assert widths == ([PE_PAD, PED_PAD, HEADS] + [W] * D + [WV] * V
                      + [W] * D + [WV] * V)
    ends = [o + n_tiles * 64 * w for o, w in zip(offs, widths)]
    assert offs[0] == 0 and offs[1:] == ends[:-1] and total == ends[-1]
    assert all((4 * o) % 128 == 0 for o in offs)
    bufs = fmg.grad_pass_a_reference(net, pts, dirs, g)
    assert bufs.bias.shape[0] == n_tiles
    planes, offs = _write_planes(net, bufs, n_tiles)
    back = fmg.buffers_from_planes_f32(net, planes, offs, bufs.bias, 300)
    for a, b in zip(_planes_of(back), _planes_of(bufs)):
        assert torch.equal(a, b)
    for a, b in zip(_flat(fmg.grad_pass_b_reference(net, back, 3)),
                    _flat(fmg.grad_pass_b_reference(net, bufs, 3))):
        assert torch.equal(a, b)


def _expected_f32_order(net):
    """The stage order of csrc/fused_mlp_grad.cuh's f32_stages: layer 0,
    each later layer's skip pe-part then its h-part, view layer 0's h-part
    and dir-PE part, the other view layers, then WV_v^T for v = V-1..1,
    WV_0^T and W_i^T for i = D-1..1; 16 K-rows a stage of a 256-wide
    matrix, 32 of a 128-wide one."""
    order = [("w0", k) for k in range(0, 64, 16)]
    for i in range(1, len(net.w)):
        if i in net.wskip:
            order += [(f"wskip{i}", k) for k in range(0, 64, 16)]
        order += [(f"w{i}", k) for k in range(0, 256, 16)]
    order += [("wv0", k) for k in range(0, 256, 32)] + [("wv0d", 0)]
    for v in range(1, len(net.wv)):
        order += [(f"wv{v}", k) for k in range(0, 128, 32)]
    for v in range(len(net.wv) - 1, 0, -1):
        order += [(f"wv{v}T", k) for k in range(0, 128, 32)]
    order += [("wv0T", k) for k in range(0, 128, 16)]
    for i in range(len(net.w) - 1, 0, -1):
        order += [(f"w{i}T", k) for k in range(0, 256, 16)]
    return order


@pytest.mark.parametrize("name", list(NETS))
def test_f32_stream_round_trips_and_follows_the_kernel_header(name):
    """Pass A f32's weight stream holds every matrix it multiplies by in
    the kernel's order, each 16 KB stage a K-slab of whole rows, and reads
    back bitwise into them (the backward's as the transposes of the net's);
    its count is the kernel's check: 137 + 128 = 265 stages at the paper
    depth (the narrow net, widened)."""
    net = _net(name, 1)[0]
    stream, order = fmg.grad_weight_stream_f32(net)
    assert stream.dtype == torch.float32
    assert order == _expected_f32_order(net)
    assert stream.numel() == len(order) * fmg.F32_STAGE
    back = fmg.grad_stream_matrices_f32(stream, net)
    want = {f"w{i}": w for i, w in enumerate(net.w)}
    want.update({f"wskip{i}": w for i, w in net.wskip.items()})
    want.update({f"wv{v}": w for v, w in enumerate(net.wv)})
    want.update({f"w{i}T": w.T for i, w in enumerate(net.w) if i})
    want.update({f"wv{v}T": w.T for v, w in enumerate(net.wv)})
    want["wv0d"] = net.wv0d
    assert set(back) == set(want)
    for k, w in want.items():
        assert torch.equal(back[k], w), k
    D, V = len(net.w), len(net.wv)
    fwd = (4 + sum(16 + 4 * (i in net.wskip) for i in range(1, D)) + 8 + 1
           + 4 * (V - 1))
    assert len(order) == fwd + 4 * (V - 1) + 8 + 16 * (D - 1)
    if name == "narrow":
        assert (fwd, len(order) - fwd) == (137, 128)


# ----------------------------------------------- pass A f32, emulated here

def _stages(net, acc):
    """The f32 stream's stages in order, each a (K-rows, N) slab."""
    stream, _ = fmg.grad_weight_stream_f32(net)
    out, q = [], 0
    for _, m in fmg._grad_stream_parts_f32(net):
        kr = fmg.F32_STAGE // m.shape[1]
        for _ in range(0, m.shape[0], kr):
            out.append(stream[q:q + fmg.F32_STAGE].view(kr, -1).to(acc))
            q += fmg.F32_STAGE
    return out


def _emulate_pass_a_f32(net, pts, dirs, g, acc, whole_tiles=False):
    """Pass A f32's tile walk in plain torch, in ``acc``: 64-point tiles
    (inputs and cotangent zero past N), every product summed one stage of
    the f32 stream at a time, relu' kept from the forward; d_h from the
    heads' K = 4 products with the cotangent, masked and multiplied back
    through the transposed stages; each bias row summed over a warp's 8
    rows, then over the 8 warps in order. -> GradBuffers of N rows, or of
    every tile's rows (as the kernel writes the planes) with
    ``whole_tiles``."""
    stages = _stages(net, acc)
    n = pts.shape[0]
    tiles = -(-n // fmg.GRAD_TILE)
    pad = tiles * fmg.GRAD_TILE - n
    pe, ped = (torch.nn.functional.pad(x.to(acc), (0, 0, 0, pad))
               for x in fmg.encode_points(net, pts, dirs))
    g4 = torch.nn.functional.pad(g.to(acc), (0, 0, 0, pad))
    wa, wr = net.w_alpha[:, :4].to(acc), net.w_rgb[:, :4].to(acc)
    D, V = len(net.w), len(net.wv)

    def col_sums(d):  # each warp's 8 rows, then the warps in order
        return d.reshape(8, 8, d.shape[1]).sum(1).sum(0)

    out = {k: [] for k in ("pe", "ped", "gb", "hs", "hvs", "dcs", "dvs",
                           "bias")}
    for t0 in range(0, n + pad, fmg.GRAD_TILE):
        q = 0

        def prod(a, lanes, s=None):
            nonlocal q
            s = torch.zeros(a.shape[0], lanes, dtype=acc) if s is None else s
            for k0 in range(0, a.shape[1], stages[q].shape[0]):
                s = s + a[:, k0:k0 + stages[q].shape[0]] @ stages[q]
                q += 1
            return s

        x, xd, gt = (v[t0:t0 + fmg.GRAD_TILE] for v in (pe, ped, g4))
        hs = [torch.relu(prod(x, 256) + net.b[0].to(acc))]
        for i in range(1, D):
            s = prod(x, 256) if i in net.wskip else None
            hs.append(torch.relu(prod(hs[-1], 256, s) + net.b[i].to(acc)))
        s = prod(xd, 128, prod(hs[-1], 128))
        hvs = [torch.relu(s + net.bv[0].to(acc))]
        for v in range(1, V):
            hvs.append(torch.relu(prod(hvs[-1], 128) + net.bv[v].to(acc)))
        dvs, dcs, bv, bs = [None] * V, [None] * D, [None] * V, [None] * D
        dv = gt @ wr.T
        for v in range(V - 1, -1, -1):
            dvs[v] = torch.where(hvs[v] > 0, dv, torch.zeros_like(dv))
            bv[v] = col_sums(dvs[v])
            if v:
                dv = prod(dvs[v], 128)
        dh = prod(dvs[0], 256) + gt @ wa.T
        for i in range(D - 1, -1, -1):
            dcs[i] = torch.where(hs[i] > 0, dh, torch.zeros_like(dh))
            bs[i] = col_sums(dcs[i])
            if i:
                dh = prod(dcs[i], 256)
        assert q == len(stages)
        g16 = torch.nn.functional.pad(gt, (0, HEADS - 4))
        for k, v in (("pe", x), ("ped", xd), ("gb", g16), ("hs", hs),
                     ("hvs", hvs), ("dcs", dcs), ("dvs", dvs),
                     ("bias", torch.cat([*bs, *bv, g16.sum(0)])[None])):
            out[k].append(v)
    rows = n + pad if whole_tiles else n
    cat = (lambda k: torch.cat(out[k])[:rows])
    layers = (lambda k, L: [torch.cat([t[j] for t in out[k]])[:rows]
                            for j in range(L)])
    return fmg.GradBuffers(
        pe=cat("pe"), ped=cat("ped"), gb=cat("gb"), hs=layers("hs", D),
        hvs=layers("hvs", V), dcs=layers("dcs", D), dvs=layers("dvs", V),
        bias=torch.cat(out["bias"]))


def _buffers(b):
    return {"pe": b.pe, "ped": b.ped, "gb": b.gb, "bias": b.bias,
            **{f"h{i}": x for i, x in enumerate(b.hs)},
            **{f"hv{v}": x for v, x in enumerate(b.hvs)},
            **{f"dc{i}": x for i, x in enumerate(b.dcs)},
            **{f"dv{v}": x for v, x in enumerate(b.dvs)}}


@pytest.mark.parametrize("name,n", [
    ("d2-skip", 1), ("d2-skip", 127), ("d2-noskip", 1001), ("narrow", 1),
    ("narrow", 127), ("narrow", 1001)])
def test_pass_a_f32_emulation_matches_grad_pass_a_reference(name, n):
    """The emulation of pass A f32's tile walk against
    grad_pass_a_reference, every plane and the bias rows: within 1e-5
    norm-relative in f64, where the order of the sums leaves no trace; in
    f32 within twice the reference's own distance from f64 (at least
    1e-5). Ragged N (one point in a tile of zeros, a ragged last tile)
    leaves the valid rows and the bias rows as they are."""
    net, pts, dirs, g = _net(name, n)
    want64 = _buffers(fmg.grad_pass_a_reference(net, pts, dirs, g,
                                                torch.float64))
    want32 = _buffers(fmg.grad_pass_a_reference(net, pts, dirs, g))
    got64 = _buffers(_emulate_pass_a_f32(net, pts, dirs, g, torch.float64))
    got32 = _buffers(_emulate_pass_a_f32(net, pts, dirs, g, torch.float32))
    assert want64["bias"].shape[0] == -(-n // 64)
    for k, w in want64.items():
        assert got64[k].shape == got32[k].shape == w.shape, k
        assert _rel(got64[k], w) <= 1e-5, (k, _rel(got64[k], w))
        own = _rel(want32[k], w)
        assert _rel(got32[k], w) <= max(2 * own, 1e-5), (k, own)


# ----------------------------------------------- pass B f32, emulated here

def _f32_tasks(net):
    """csrc/fused_mlp_grad.cuh fr_grad_pass_b_f32's task table: (gradient
    slot, X plane, Y plane) of every weight gradient, each cut into 128 x
    128 output tiles (first row, first column)."""
    D, V = len(net.w), len(net.wv)
    H, HV, DC = 3, 3 + D, 3 + D + V
    DV = DC + D
    grads = [(fr._SLOT_W, 0, DC)]
    for i in range(1, D):
        grads.append((fr._SLOT_W + i, H + i - 1, DC + i))
        if i in net.wskip:
            grads.append((fr._SLOT_WSKIP + i, 0, DC + i))
    grads += [(fr._SLOT_WV, H + D - 1, DV), (fr._SLOT_WV0D, 1, DV)]
    grads += [(fr._SLOT_WV + v, HV + v - 1, DV + v) for v in range(1, V)]
    grads += [(fr._SLOT_WALPHA, H + D - 1, 2), (fr._SLOT_WRGB, HV + V - 1, 2)]
    _, widths, _ = fmg.grad_planes_f32(net, 1)
    return [(slot, xp, yp, m0, n0) for slot, xp, yp in grads
            for m0 in range(0, widths[xp], 128)
            for n0 in range(0, widths[yp], 128)]


def _emulate_pass_b_f32(net, planes, offs, bias, n_chunks):
    """Pass B f32 in plain torch on the f32 planes: every task's output
    tile summed over its chunk's points in stages of 32 (whole tiles of 64
    points), one partial per chunk; the bias rows summed per chunk; the
    partials added in chunk order -> a PackedNet of f32 gradients."""
    n_tiles = bias.shape[0]
    rows = n_tiles * fmg.GRAD_TILE
    _, widths, _ = fmg.grad_planes_f32(net, n_tiles)
    pl = [planes[o:o + rows * w].view(rows, w) for o, w in zip(offs, widths)]
    layout, G = fmg._grad_layout(net)
    out = torch.zeros(G)
    seen = torch.zeros(G, dtype=torch.int64)
    for c0, c1 in fmg.chunk_bounds(n_tiles, n_chunks):
        part = torch.full((G,), float("nan"))
        for slot, xp, yp, m0, n0 in _f32_tasks(net):
            x = pl[xp][:, m0:m0 + 128]
            y = pl[yp][:, n0:n0 + 128]
            s = torch.zeros(x.shape[1], y.shape[1])
            for p in range(c0 * 64, c1 * 64, 32):
                s = s + x[p:p + 32].T @ y[p:p + 32]
            off, shape = layout[slot]
            grid = part[off:off + shape[0] * shape[1]].view(shape)
            grid[m0:m0 + x.shape[1], n0:n0 + y.shape[1]] = s
            if c0 == 0:
                seen[off:off + shape[0] * shape[1]].view(shape)[
                    m0:m0 + x.shape[1], n0:n0 + y.shape[1]] += 1
        sums = bias[c0:c1].sum(0)
        D, V, W, WV = len(net.w), len(net.wv), net.width, net.width // 2
        for e, (slot, lo, width) in enumerate(
                [(fr._SLOT_B + i, i * W, W) for i in range(D)]
                + [(fr._SLOT_BV + v, D * W + v * WV, WV) for v in range(V)]
                + [(fr._SLOT_BHEADS, D * W + V * WV, HEADS)]):
            off, _ = layout[slot]
            part[off:off + width] = sums[lo:lo + width]
            if c0 == 0:
                seen[off:off + width] += 1
        out = out + torch.nan_to_num(part, nan=0.0)
    # every gradient element is written by exactly one task or bias sum
    for off, shape in layout.values():
        assert torch.all(seen[off:off + int(np.prod(shape))] == 1)
    return fmg._unflatten(net, out, layout)


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_pass_b_f32_chunkings_agree(n_chunks):
    """Pass B f32's 128 x 128 tiles and point chunks, emulated on the
    planes of the emulated pass A (every tile's rows, so the rows past N
    hold the activations of zero inputs and zero d_h): every gradient
    element written once; at 1, 3 and 8 chunks within 1e-6 of each other
    and of grad_pass_b_reference at the same chunks."""
    net, pts, dirs, g = _net("d2-skip", 500)
    bufs = _emulate_pass_a_f32(net, pts, dirs, g, torch.float32, True)
    n_tiles = bufs.bias.shape[0]
    assert n_tiles == 8  # 500 points in tiles of 64
    planes, offs = _write_planes(net, bufs, n_tiles)
    got = _emulate_pass_b_f32(net, planes, offs, bufs.bias, n_chunks)
    one = fmg.grad_pass_b_reference(
        net, fmg.buffers_from_planes_f32(net, planes, offs, bufs.bias, 500))
    want = fmg.grad_pass_b_reference(
        net, fmg.buffers_from_planes_f32(net, planes, offs, bufs.bias, 500),
        n_chunks)
    for a, b, c in zip(_flat(got), _flat(want), _flat(one)):
        assert a.shape == b.shape
        assert _rel(a, b) < 1e-6 and _rel(a, c) < 1e-6


# ---------------------------------------------- the two passes against JAX

def test_pass_a_f32_emulation_composes_to_the_jax_vjp(monkeypatch):
    """The emulated pass A f32, then grad_pass_b_reference, through the
    training autograd Function at grad_dtype f32: every parameter gradient
    within TOL[torch.float32] (1e-4) of the JAX package's f32 VJP
    (fused_point_mlp_train, Pallas in interpret mode)."""
    jcfg, jparams, cfg, model, pts, dirs, cond, w = _setup()

    def composed(net, p, d, g):
        return fmg.grad_pass_b_reference(
            net, _emulate_pass_a_f32(net, p, d, g, torch.float32))

    monkeypatch.setattr(fmg, "point_mlp_grad_reference", composed)
    got = _port_grads(cfg, model, pts, dirs, cond, w, torch.float32)
    ref = _jax_grads(jcfg, jparams, pts, dirs, cond, w, jnp.float32)
    for name, err in _norm_rel(got, ref).items():
        assert err < TOL[torch.float32], f"{name}: {err:.3e}"
