"""The delta kernel's weight stream and layer chain (kernels/fused_render.py:
delta_weight_stream, csrc/fused_render.cu k_render_delta), on the CPU.

The kernel itself runs only on the card (chip_smoke.py phase 9 holds it
against its plain version there). Here: the stream round-trips bitwise
through its plain inverse, its stages lie where the kernel's header says,
and a plain emulation of the kernel's chain (128-row tiles, one 16 KB
stage at a time, bf16 after every relu) equals the plain MLP
the render kernels' plain versions use. The JAX agreement of the delta
frame as a whole is tests/test_torch_fused_render.py's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF, fold_conditioning

# the paper model, and 2-layer nets of the kernel's width with and without
# a skip layer (layer 1 takes the PE again when 0 is in skips)
NETS = {"paper": dict(depth=8), "d2-skip": dict(depth=2, skips=(0,)),
        "d2-noskip": dict(depth=2, skips=())}


def _packed(name: str, seed: int = 0) -> fr.PackedNet:
    cfg = ExperimentConfig(dim_aud=16, dim_expr=8, dim_latent=4)
    ncfg = dataclasses.replace(cfg.face_nerf_config(), **NETS[name])
    gen = torch.Generator().manual_seed(seed)
    model = FaceNeRF(ncfg, gen)
    rng = np.random.RandomState(seed)
    cond = [torch.from_numpy(rng.randn(n).astype(np.float32))
            for n in (16, 8, 4)]
    with torch.no_grad():
        folded = fold_conditioning(model, ncfg, *cond)
    return fr.pack_operands(model, folded, ncfg)


def _expected_order(net: fr.PackedNet):
    """The stage order of the kernel's header comment: layer 0 in 32-row
    stages, each later layer's skip pe-part before its h-part, the view
    layers in 64-row stages, the heads last."""
    order = [("w0", 0), ("w0", 32)]
    for i in range(1, len(net.w)):
        if i in net.wskip:
            order += [(f"wskip{i}", 0), (f"wskip{i}", 32)]
        order += [(f"w{i}", k) for k in range(0, 256, 32)]
    order += [("wv0", k) for k in range(0, 256, 64)]
    for v in range(1, len(net.wv)):
        order += [(f"wv{v}", 0), (f"wv{v}", 64)]
    return order + [("heads", 0)]


@pytest.mark.parametrize("name", list(NETS))
def test_delta_stream_round_trips(name):
    """The plain inverse gives back every PackedNet matrix bitwise."""
    net = _packed(name)
    stream, _ = fr.delta_weight_stream(net)
    assert stream.dtype == torch.bfloat16
    back = fr.delta_stream_matrices(stream, net)
    want = {f"w{i}": w for i, w in enumerate(net.w)}
    want.update({f"wskip{i}": w for i, w in net.wskip.items()})
    want.update({f"wv{v}": w for v, w in enumerate(net.wv)})
    want.update(w_alpha=net.w_alpha, w_rgb=net.w_rgb)
    assert set(back) == set(want)
    for k, w in want.items():
        assert torch.equal(back[k], w), k


@pytest.mark.parametrize("name", list(NETS))
def test_delta_stream_stages_follow_the_kernel_header(name):
    """Fixed 16 KB stages, each at a multiple of 1,024 bytes, in the order
    of fused_render.cu's header; the heads' stage is zero past its 12 KB;
    the paper model streams 69 stages (1.13 MB)."""
    net = _packed(name)
    stream, order = fr.delta_weight_stream(net)
    assert order == _expected_order(net)
    assert stream.numel() == len(order) * fr.STAGE_ELEMS
    stage_bytes = 2 * fr.STAGE_ELEMS
    assert stage_bytes == 16384
    assert all(q * stage_bytes % 1024 == 0 for q in range(len(order)))
    heads = stream.reshape(-1, fr.STAGE_ELEMS)[-1]
    assert torch.all(heads[16 * (256 + 128):] == 0)
    if name == "paper":
        assert len(order) == 69
        assert abs(stream.numel() * 2 / 1e6 - 1.13) < 0.01


def test_swizzle_image_matches_the_kernels_swz():
    """At 64 rows the image is csrc/hopper.cuh's swz (the delta kernel's
    activation tiles, the gradient kernel's planes), written out here
    bit by bit; each image is a permutation of its (rows, lanes)
    elements."""
    p = torch.arange(64)[:, None]
    for lanes in (64, 128, 256):
        f = torch.arange(lanes)[None, :]
        swz = (((f >> 6) << 12) + ((p >> 3) << 9) + ((p & 7) << 6)
               + ((((f >> 3) & 7) ^ (p & 7)) << 3) + (f & 7))
        assert torch.equal(fr.swizzle_image_index(64, lanes), swz)
    for rows, lanes in ((32, 256), (64, 128), (16, 256), (16, 128)):
        idx = fr.swizzle_image_index(rows, lanes).reshape(-1)
        assert torch.equal(torch.sort(idx)[0], torch.arange(rows * lanes))


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _emulate(stream: torch.Tensor, net: fr.PackedNet, pe, pv, tile=128):
    """The kernel's chain in plain torch: tiles of ``tile`` rows (zeros
    past the last point); every layer sums its products one stage (K-chunk)
    at a time in pe's dtype, reading B from the stage's swizzled image;
    bf16 after every relu; the skip layer's PE product first, in the same
    sum; the heads from their one stage."""
    dt = pe.dtype
    img = stream.reshape(-1, fr.STAGE_ELEMS).to(dt)
    n = pe.shape[0]
    pad = (-n) % tile
    pe, pv = F.pad(pe, (0, 0, 0, pad)), F.pad(pv, (0, 0, 0, pad))
    W, WV = net.w_alpha.shape[0], net.w_rgb.shape[0]
    outs = []
    for t0 in range(0, n + pad, tile):
        q = 0

        def prod(acc, a, lanes):
            nonlocal q
            kr = fr.STAGE_ELEMS // lanes
            idx = fr.swizzle_image_index(kr, lanes).reshape(-1)
            for k0 in range(0, a.shape[1], kr):
                acc = acc + a[:, k0:k0 + kr] @ img[q][idx].reshape(kr, lanes)
                q += 1
            return acc

        x = pe[t0:t0 + tile]
        h = _bf16(torch.relu(prod(torch.zeros(tile, W, dtype=dt), x, W)
                             + net.b[0]))
        for i in range(1, len(net.w)):
            acc = torch.zeros(tile, W, dtype=dt)
            if i in net.wskip:
                acc = prod(acc, x, W)
            h = _bf16(torch.relu(prod(acc, h, W) + net.b[i]))
        hv = _bf16(torch.relu(prod(torch.zeros(tile, WV, dtype=dt), h, WV)
                              + pv[t0:t0 + tile]))
        for v in range(1, len(net.wv)):
            acc = prod(torch.zeros(tile, WV, dtype=dt), hv, WV)
            hv = _bf16(torch.relu(acc + net.bv[v]))
        ia = fr.swizzle_image_index(fr.HEADS, W).reshape(-1)
        ir = fr.swizzle_image_index(fr.HEADS, WV).reshape(-1)
        wa = img[q][ia].reshape(fr.HEADS, W).T
        wr = img[q][ia.numel() + ir].reshape(fr.HEADS, WV).T
        assert q + 1 == img.shape[0]
        outs.append((h @ wa + hv @ wr + net.b_heads)[:, :4])
    return torch.cat(outs)[:n]


def _rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("name,n_rays,S", [
    ("paper", 16, 16), ("paper", 7, 17), ("d2-skip", 9, 16),
    ("d2-noskip", 5, 33), ("paper", 1, 5), ("paper", 3, 96),
    ("d2-skip", 40, 16), ("d2-noskip", 8, 32)])
def test_tiled_emulation_matches_mlp_reference(name, n_rays, S):
    """The emulation of the kernel's chain against _mlp_reference on the
    same bf16 weights and rounding points. In f64 the order of the sums
    leaves no trace: within 1e-5 norm-relative. In f32 a sum that lands
    one ulp apart can round an activation to the neighbouring bf16 value,
    and deep chains carry it on: the f32 reference itself lies about 3e-4
    from the f64 one at paper depth, so the f32 emulation is held to
    twice that distance (and 1e-3). Ragged point counts (rays straddling
    128-row tiles at S = 17, 33 and 96, one ray in a tile of zeros) and
    whole tiles (640 and 256 points) leave the valid rows unchanged."""
    net = _packed(name, seed=3)
    rng = np.random.RandomState(n_rays)
    n = n_rays * S
    pe = _bf16(torch.from_numpy(rng.uniform(-1, 1, (n, fr.PE_PAD))
                                .astype(np.float32)))
    pe[:, 63:] = 0.0
    pv_ray = torch.from_numpy(rng.randn(n_rays, 128).astype(np.float32))
    pv = pv_ray.repeat_interleave(S, 0)
    stream, _ = fr.delta_weight_stream(net)
    want64 = fr._mlp_reference(net, pe.double(), pv.double())
    got64 = _emulate(stream, net, pe.double(), pv.double())
    assert got64.shape == want64.shape == (n, 4)
    assert _rel(got64, want64) <= 1e-5, _rel(got64, want64)
    got, want = _emulate(stream, net, pe, pv), fr._mlp_reference(net, pe, pv)
    assert got.dtype == want.dtype == torch.float32
    own = _rel(want.double(), want64)
    assert _rel(got.double(), want64) <= max(2 * own, 1e-5), own
    assert _rel(got, want) <= 1e-3
