"""The kernels' widths besides the paper's (ROADMAP.md B10): the wgmma
chain and every kernel on it (K1-K6) are templates over the net's width
(csrc/chain.cuh Layout<W>), built at W = 128, 256 and 512 with the view
branch at W / 2. The kernels run only on the card (chip_smoke.py phase
12d holds each width's instances against their plain versions there).
Here, on the CPU, at W = 128 and 512 (the paper width's own tests are
test_torch_delta_chain.py, test_torch_fused_mlp_grad.py and
test_torch_grad_f32.py):

- the weight streams (the chain's, pass A's bf16 and f32) read back
  bitwise into every matrix, lie in the order of the kernels' headers
  (8192 / N K-rows of an N-wide matrix a bf16 stage, 4096 / N an f32 one;
  the heads in one stage at W=128, two at 512) and have the stage counts
  the kernels check;
- plain emulations of the kernels' tile walks equal the plain versions:
  the chain at W=128 on 128-point tiles; at W=512 the N-split chain on
  64-point tiles, whose two warpgroups each compute one half of every
  layer's columns from the whole input tile, the trunk ping-ponging
  between two tiles and the view branch between the halves of the one the
  trunk finished with, the heads from two stages. The emulation keeps the
  block's tiles as 64-lane blocks and lets warpgroup 0 write its half
  before warpgroup 1 reads, as nothing in the kernel orders them, so a
  layer whose output overlapped an input still to be read would show.
  Pass A's walk likewise (bf16: the split one at W=512, with the dir-PE
  tile inside a trunk tile and the d_h tiles ping-ponging; f32:
  row-major 64-point tiles at both widths);
- the launch plans fit the shared memory at each width, a W=512 net too
  deep for a pass's tiles and relu' bits is refused naming B10, and pass
  B's task tables stay within their bound;
- a frame (K2 then K1) and a head step at W = 128 and 512 agree with the
  JAX package, whose kernels take any width (Pallas in interpret mode),
  at the paper width's bounds.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from idealnerf_tpu.config import ExperimentConfig as JaxConfig
from idealnerf_tpu.core.sampling import stratified_sample as jax_stratified
from idealnerf_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from idealnerf_tpu.kernels import fused_render as jfr
from idealnerf_tpu.models import face_nerf as jax_fn
from idealnerf_tpu.train.head import make_frame_loss as jax_frame_loss
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.kernels import fused_mlp as fm
from idealnerf_tpu_torch.kernels import fused_mlp_grad as fmg
from idealnerf_tpu_torch.kernels import fused_render as fr
from idealnerf_tpu_torch.models.face_nerf import FaceNeRF, fold_conditioning
from idealnerf_tpu_torch.train.head import make_frame_loss
from idealnerf_tpu_torch.train.state import init_train_state

WIDTHS = (128, 512)
HEADS, PE_PAD, PED_PAD = fr.HEADS, fr.PE_PAD, fr.PED_PAD
STAGE = fr.STAGE_ELEMS          # bf16 a stage
F32_STAGE = fmg.F32_STAGE       # floats a stage
# the paper depth, and a 2-layer net whose layer 1 takes the PE again
NETS = {"paper": dict(depth=8), "d2-skip": dict(depth=2, skips=(0,))}
COND = dict(dim_aud=16, dim_expr=8, dim_latent=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensor ops on one thread: under the suite's parallel workers
    a thread pool per op made these emulations many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _packed(W: int, name: str, dtype=torch.bfloat16, seed: int = 0):
    """A PackedNet of NETS[name] at width W (narrow conditioning, folded
    from seeded numpy draws), weights in ``dtype``."""
    ncfg = dataclasses.replace(
        ExperimentConfig(netwidth=W, **COND).face_nerf_config(), **NETS[name])
    model = FaceNeRF(ncfg, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    cond = [_t(rng.randn(n).astype(np.float32) * 0.3) for n in (16, 8, 4)]
    with torch.no_grad():
        folded = fold_conditioning(model, ncfg, *cond)
        return fr.pack_leaves(ncfg, fr.model_leaves(model, folded, ncfg),
                              dtype)


def _points(n: int, seed: int):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    g = (rng.randn(n, 4) / 64).astype(np.float32)
    return _t(pts), _t(dirs), _t(g)


def _mats(net, transposed: bool = False):
    """Every matrix a stream may hold, by the names the streams use."""
    out = {f"w{i}": w for i, w in enumerate(net.w)}
    out.update({f"wskip{i}": w for i, w in net.wskip.items()})
    out.update({f"wv{v}": w for v, w in enumerate(net.wv)})
    out["wv0d"] = net.wv0d
    if transposed:
        out.update({f"w{i}T": w.T for i, w in enumerate(net.w) if i})
        out.update({f"wv{v}T": w.T for v, w in enumerate(net.wv)})
    return out


# ------------------------------------------------------------ the streams

def _stages(k: int, rows: int):
    return [k0 for k0 in range(0, k, rows)]


def _forward_order(net, rows, dir_stage: bool):
    """The chain's stage order (csrc/chain.cuh, note at the top) at the
    net's widths; ``rows(n)``: K-rows of an n-wide matrix a stage."""
    W, WV = net.width, net.wv[0].shape[1]
    order = [("w0", k) for k in _stages(PE_PAD, rows(W))]
    for i in range(1, len(net.w)):
        if i in net.wskip:
            order += [(f"wskip{i}", k) for k in _stages(PE_PAD, rows(W))]
        order += [(f"w{i}", k) for k in _stages(W, rows(W))]
    order += [("wv0", k) for k in _stages(W, rows(WV))]
    if dir_stage:
        order += [("wv0d", k) for k in _stages(PED_PAD, rows(WV))]
    for v in range(1, len(net.wv)):
        order += [(f"wv{v}", k) for k in _stages(WV, rows(WV))]
    return order


def _backward_order(net, rows):
    """Pass A's backward stages (csrc/fused_mlp_grad.cuh, note at the top):
    WV_v^T for v = V-1..1, WV_0^T's h-part, W_i^T for i = D-1..1."""
    W, WV = net.width, net.wv[0].shape[1]
    order = []
    for v in range(len(net.wv) - 1, 0, -1):
        order += [(f"wv{v}T", k) for k in _stages(WV, rows(WV))]
    order += [("wv0T", k) for k in _stages(WV, rows(W))]
    for i in range(len(net.w) - 1, 0, -1):
        order += [(f"w{i}T", k) for k in _stages(W, rows(W))]
    return order


def _chain_stage_count(net, dir_stage: bool) -> int:
    """csrc/chain.cuh chain_stages (+ the dir-PE stage), as the kernels
    check it: KC_W = 8192 / W, KC_V = 8192 / WV, HEAD_STAGES."""
    W, WV = net.width, net.wv[0].shape[1]
    kc_w, kc_v = STAGE // W, STAGE // WV
    trunk = PE_PAD // kc_w + sum(W // kc_w + (PE_PAD // kc_w if i in net.wskip
                                              else 0)
                                 for i in range(1, len(net.w)))
    view = W // kc_v + (len(net.wv) - 1) * -(-WV // kc_v)
    heads = -(-(32 * W + 32 * WV) // (2 * STAGE))
    return trunk + view + heads + dir_stage


@pytest.mark.parametrize("dir_stage", [False, True], ids=["rays", "points"])
@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("W", WIDTHS)
def test_chain_stream_round_trips_and_follows_the_header(W, name, dir_stage):
    """The chain's stream at W: stages in the header's order at 8192 / N
    K-rows of an N-wide matrix (a matrix of fewer K-rows than that, W=128's
    64 x 64 view layers and 32-row dir-PE part, fills part of one stage,
    its other rows zero), then the heads: w_alpha^T (16 x W) and w_rgb^T
    (16 x W/2) K-major, back to back, in one stage at W=128 and two at 512
    (w_alpha^T fills the first), zero past them. It reads back bitwise,
    and its count is the kernels' check (chain_stages): 20 stages for the
    paper model at W=128, 266 at 512."""
    net = _packed(W, name)
    WV = W // 2
    stream, order = fr.chain_weight_stream(net, dir_stage)
    n_heads = 1 if W <= 256 else 2
    assert order == (_forward_order(net, lambda n: STAGE // n, dir_stage)
                     + [("heads", k) for k in range(n_heads)])
    assert stream.numel() == len(order) * STAGE
    assert len(order) == _chain_stage_count(net, dir_stage)
    if name == "paper":
        assert len(order) - dir_stage == {128: 20, 512: 266}[W]
    back = fr.chain_stream_matrices(stream, net, dir_stage)
    want = _mats(net)
    if not dir_stage:
        del want["wv0d"]
    want.update(w_alpha=net.w_alpha, w_rgb=net.w_rgb)
    assert set(back) == set(want)
    for k, w in want.items():
        assert torch.equal(back[k], w), k
    # every stage: its K-slab's swizzled image, zero past the matrix
    img = stream.reshape(-1, STAGE)
    mats = _mats(net)
    for q, (k, k0) in enumerate(order):
        if k == "heads":
            continue
        m = mats[k]
        kr = STAGE // m.shape[1]
        slab = F.pad(m[k0:k0 + kr], (0, 0, 0, kr - min(kr, m.shape[0] - k0)))
        idx = fr.swizzle_image_index(kr, m.shape[1]).reshape(-1)
        assert torch.equal(img[q][idx].reshape(kr, -1), slab), (k, k0)
    heads = img[len(order) - n_heads:].reshape(-1)
    ia = fr.swizzle_image_index(HEADS, W).reshape(-1)
    ir = fr.swizzle_image_index(HEADS, WV).reshape(-1) + HEADS * W
    assert torch.equal(heads[ia].reshape(HEADS, W), net.w_alpha.T)
    assert torch.equal(heads[ir].reshape(HEADS, WV), net.w_rgb.T)
    rest = torch.ones(heads.numel(), dtype=torch.bool)
    rest[ia] = rest[ir] = False
    assert torch.all(heads[rest] == 0)


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("W", WIDTHS)
def test_pass_a_streams_round_trip_and_follow_the_header(W, name):
    """Pass A's streams at W. bf16: the point kernels' stream less the
    heads, then the transposed matrices of the backward in 8192 / N K-row
    stages; its count is chain_stages + grad_back_stages (the paper model:
    20 + 17 at W=128, 265 + 256 at 512). f32: every matrix row-major in
    stages of 4096 / N whole rows (a matrix of fewer rows, W=128's 32-row
    dir-PE part, padded to a stage), in f32_stages' order. Both read back
    bitwise, the backward's as the transposes of the net's."""
    net = _packed(W, name)
    WV = W // 2
    stream, order = fmg.grad_weight_stream(net)
    rows = (lambda n: STAGE // n)
    fwd = _forward_order(net, rows, True)
    assert order == fwd + _backward_order(net, rows)
    back_count = ((len(net.wv) - 1) * -(-WV // (STAGE // WV))
                  + WV // (STAGE // W) + (len(net.w) - 1) * W // (STAGE // W))
    assert len(order) == _chain_stage_count(net, True) - (
        1 if W <= 256 else 2) + back_count
    if name == "paper":
        assert (len(fwd), len(order) - len(fwd)) == {
            128: (20, 17), 512: (265, 256)}[W]
    k4, k4_order = fr.chain_weight_stream(net, dir_stage=True)
    assert order[:len(fwd)] == k4_order[:len(fwd)]
    assert torch.equal(stream[:len(fwd) * STAGE], k4[:len(fwd) * STAGE])
    back = fmg.grad_stream_matrices(stream, net)
    want = _mats(net, transposed=True)
    assert set(back) == set(want)
    for k, w in want.items():
        assert torch.equal(back[k], w), k

    net32 = _packed(W, name, torch.float32)
    s32, o32 = fmg.grad_weight_stream_f32(net32)
    rows32 = (lambda n: F32_STAGE // n)
    assert o32 == (_forward_order(net32, rows32, True)
                   + _backward_order(net32, rows32))
    assert s32.numel() == len(o32) * F32_STAGE
    back32 = fmg.grad_stream_matrices_f32(s32, net32)
    want32 = _mats(net32, transposed=True)
    assert set(back32) == set(want32)
    for k, w in want32.items():
        assert torch.equal(back32[k], w), k


# ------------------------------------------- the chain's tile walk, emulated

class _Tiles:
    """A block's tiles in shared memory as 64-lane blocks of ``rows`` rows
    (csrc/hopper.cuh swz keeps each 64-lane block of a 64-row image in 8 KB
    of its own, so a tile of 64 k lanes is k blocks and a 64-lane-aligned
    part of one is a run of them)."""

    def __init__(self, n_blocks: int, rows: int, dtype):
        self.b = torch.full((n_blocks, rows, 64), float("nan"), dtype=dtype)

    def read(self, blocks, lanes=None):
        x = torch.cat([self.b[j] for j in blocks], dim=1)
        return x if lanes is None else x[:, :lanes]

    def write(self, blocks, x):
        x = F.pad(x, (0, 64 * len(blocks) - x.shape[1]))
        for j, blk in enumerate(blocks):
            self.b[blk] = x[:, 64 * j:64 * j + 64]


def _stage_slabs(stream, order_parts, acc):
    """The stream's stages read back from their swizzled images: one (K-rows,
    N) slab a stage, for the parts (name, matrix, K-rows) in order."""
    img = stream.reshape(-1, STAGE).to(acc)
    out = []
    for _, m, kr in order_parts:
        idx = fr.swizzle_image_index(kr, m.shape[1]).reshape(-1)
        for _ in range(0, m.shape[0], kr):
            out.append(img[len(out)][idx].reshape(kr, -1))
    return out


class _Walk:
    """A consumer's walk over the stream's slabs: prod(a, lanes, cols)
    sums a's products one stage at a time into the columns ``cols`` (a
    slice of the layer's lanes: a warpgroup's half at W=512) from stage q
    on; ``at`` rewinds to a layer's first stage for the other warpgroup."""

    def __init__(self, slabs):
        self.slabs, self.q = slabs, 0

    def prod(self, a, cols=slice(None), s=None):
        k0 = 0
        while k0 < a.shape[1]:
            b = self.slabs[self.q][:, cols]
            ku = min(b.shape[0], a.shape[1] - k0)
            p = a[:, k0:k0 + ku] @ b[:ku]
            s = p if s is None else s + p
            k0 += b.shape[0]
            self.q += 1
        return s


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _emulate_chain(net, pe, ped=None, pv=None, acc=torch.float64):
    """The chain's forward in plain torch at the net's width, through the
    heads: rows in tiles of chain_tile(W) (zeros past the last row),
    every product one stage at a time from the stream's images, bf16 after
    every relu. View layer 0 takes ``ped`` (the point kernels: its dir-PE
    product in the same sum, then bv[0]) or the per-row term ``pv`` (the
    ray kernels). W <= 256: a layer's product over the tile, then its
    activation in place. W=512 (chain_tile_split): the PE tile, trunk
    tiles H0 and H1 and a dir-PE tile as 64-lane blocks; trunk layer i
    writes H[i % 2] from H[(i - 1) % 2], the view branch ping-pongs
    between the halves of the trunk tile the last layer did not write;
    each layer's two column halves computed by one warpgroup each, the
    first written before the second reads."""
    W, WV = net.width, net.wv[0].shape[1]
    split = W > 256
    T = fr.chain_tile(W)
    stream, _ = fr.chain_weight_stream(net, ped is not None)
    slabs = _stage_slabs(stream, fr._stream_parts(net, ped is not None), acc)
    heads = stream.reshape(-1, STAGE)[-(2 if split else 1):].reshape(-1)
    ia = fr.swizzle_image_index(HEADS, W).reshape(-1)
    ir = fr.swizzle_image_index(HEADS, WV).reshape(-1) + HEADS * W
    wa = heads[ia].reshape(HEADS, W).T.to(acc)
    wr = heads[ir].reshape(HEADS, WV).T.to(acc)
    n = pe.shape[0]
    pad = (-n) % T
    pe = F.pad(pe.to(acc), (0, 0, 0, pad))
    if ped is not None:
        ped = F.pad(ped.to(acc), (0, 0, 0, pad))
        bias0 = net.bv[0].to(acc).expand(n + pad, WV)
    else:
        bias0 = F.pad(pv.to(acc), (0, 0, 0, pad))
    b = [x.to(acc) for x in net.b]
    bv = [x.to(acc) for x in net.bv]
    out = []
    for t0 in range(0, n + pad, T):
        walk = _Walk(slabs)
        x = pe[t0:t0 + T]
        vb = [bias0[t0:t0 + T]] + [x_.expand(T, WV) for x_ in bv[1:]]
        if not split:
            h = None
            for i in range(len(net.w)):
                s = walk.prod(x) if i == 0 or i in net.wskip else None
                s = s if i == 0 else walk.prod(h, s=s)
                h = _bf16(torch.relu(s + b[i]))
            hv = h
            for v in range(len(net.wv)):
                s = walk.prod(hv)
                if v == 0 and ped is not None:
                    s = walk.prod(ped[t0:t0 + T], s=s)
                hv = _bf16(torch.relu(s + vb[v]))
            out.append((h @ wa + hv @ wr + net.b_heads.to(acc))[:, :4])
            continue
        # W=512: blocks 0 = PE, 1..8 = H0, 9..16 = H1, 17 = dir-PE
        nb = W // 64
        H = [list(range(1, 1 + nb)), list(range(1 + nb, 1 + 2 * nb))]
        sm = _Tiles(2 + 2 * nb, T, acc)
        sm.write([0], x)
        if ped is not None:
            sm.write([1 + 2 * nb], ped[t0:t0 + T])

        def layer(read, out_blocks, lanes, bias, extra=None):
            q0, half = walk.q, lanes // 2
            for wg in (0, 1):
                walk.q = q0
                cols = slice(wg * half, (wg + 1) * half)
                s = None
                for a in read():
                    s = walk.prod(a, cols, s)
                if extra is not None:
                    s = walk.prod(extra(), cols, s)
                hb = _bf16(torch.relu(s + bias[:, cols]))
                per = len(out_blocks) // 2
                sm.write(out_blocks[wg * per:(wg + 1) * per], hb)

        for i in range(len(net.w)):
            src = H[(i & 1) ^ 1]
            reads = ([lambda: sm.read([0])] if i == 0 or i in net.wskip
                     else [])
            if i:
                reads.append(lambda src=src: sm.read(src))
            layer(lambda reads=reads: [r() for r in reads], H[i & 1], W,
                  b[i].expand(T, W))
        hl = H[(len(net.w) - 1) & 1]
        hv0 = H[((len(net.w) - 1) & 1) ^ 1]
        hvs = [hv0[:nb // 2], hv0[nb // 2:]]
        for v in range(len(net.wv)):
            src = hl if v == 0 else hvs[(v & 1) ^ 1]
            extra = ((lambda: sm.read([1 + 2 * nb], PED_PAD))
                     if v == 0 and ped is not None else None)
            layer(lambda src=src: [sm.read(src)], hvs[v & 1], WV, vb[v],
                  extra)
        h, hv = sm.read(hl), sm.read(hvs[(len(net.wv) - 1) & 1])
        out.append((h @ wa + hv @ wr + net.b_heads.to(acc))[:, :4])
    return torch.cat(out)[:n]


@pytest.mark.parametrize("name,n,points", [
    ("paper", 130, True), ("paper", 65, False), ("d2-skip", 200, True),
    ("d2-skip", 1, False)])
@pytest.mark.parametrize("W", WIDTHS)
def test_chain_emulation_matches_the_plain_mlp(W, name, n, points):
    """The emulated tile walk (N-split at W=512) against the plain MLP the
    kernels' plain versions use, on the same bf16 weights and rounding
    points: within 1e-5 norm-relative in f64, where the order of the sums
    leaves no trace; in f32 within twice the plain version's own distance
    from f64 (and 1e-3), since a sum one ulp apart can round an
    activation to the neighbouring bf16 value. Points (the dir-PE product
    in view layer 0) and rays (a per-row view term); ragged tiles (130 and
    65 rows at 64- and 128-row tiles, one row in a tile of zeros)."""
    net = _packed(W, name, seed=3)
    pts, dirs, _ = _points(n, seed=n)
    pe, ped = fm.encode_points(net, pts, dirs)
    if points:
        kw = dict(ped=ped)
        pv = ped.double() @ net.wv0d.double() + net.bv[0].double()
    else:
        pv = torch.from_numpy(np.random.RandomState(n).randn(n, W // 2)
                              .astype(np.float32))
        kw = dict(pv=pv)
    want64 = fr._mlp_reference(net, pe.double(), pv.double())
    got64 = _emulate_chain(net, pe, acc=torch.float64, **kw)
    assert got64.shape == want64.shape == (n, 4)
    assert _rel(got64, want64) <= 1e-5, _rel(got64, want64)
    want32 = (fm.point_mlp_pe_reference(net, pe, ped) if points
              else fr._mlp_reference(net, pe, pv))
    got32 = _emulate_chain(net, pe, acc=torch.float32, **kw)
    own = _rel(want32, want64)
    assert _rel(got32, want64) <= max(2 * own, 1e-5), own
    assert _rel(got32, want32) <= 1e-3


def test_the_split_emulation_sees_a_tile_overwritten_too_early(monkeypatch):
    """The W=512 emulation is a check of the tile plan: with the view
    branch's first layer written over its own input tile (the trunk tile
    the last layer wrote) instead of the other one, warpgroup 1 reads
    warpgroup 0's output and the result leaves the plain MLP."""
    net = _packed(512, "d2-skip", seed=3)
    pts, dirs, _ = _points(64, seed=1)
    pe, ped = fm.encode_points(net, pts, dirs)
    want = fr._mlp_reference(net, pe.double(), ped.double()
                             @ net.wv0d.double() + net.bv[0].double())
    assert _rel(_emulate_chain(net, pe, ped=ped), want) <= 1e-5
    real = _Tiles.write

    def late(self, blocks, x):  # view layer 0's output onto H[1] (hl)
        if x.shape[1] == 128 and blocks[0] in (1, 3):
            blocks = [b + 8 for b in blocks]
        real(self, blocks, x)

    monkeypatch.setattr(_Tiles, "write", late)
    assert _rel(_emulate_chain(net, pe, ped=ped), want) > 1e-3


# ------------------------------------------------ pass A's walk, emulated

def _emulate_pass_a(net, pts, dirs, g, acc=torch.float64):
    """Pass A (bf16) in plain torch at the net's width: the recompute on
    the chain (relu' kept), then d_h back from the heads' K = 4 products
    with the unrounded cotangent, masked, rounded and multiplied back
    through the transposed stages, bias rows per 64-point tile. W <= 256:
    128-point tiles, every layer in place. W=512 (pass_a_tile_split):
    64-point tiles; the PE tile and trunk tiles H0, H1 as 64-lane blocks;
    the dir-PE tile in the second half of the trunk tile the last trunk
    layer does not write, filled again after the trunk; the view branch
    ping-pongs between that tile's halves; in the backward DV(v) goes on
    ping-ponging, then DC(D-1) to the last trunk layer's tile and DC(i)
    alternates. Both warpgroups' products precede a layer's writes (the
    kernel's barrier); each writes its half. -> GradBuffers of N rows."""
    W, WV = net.width, net.wv[0].shape[1]
    D, V = len(net.w), len(net.wv)
    split = W > 256
    T = fr.chain_tile(W)
    stream, _ = fmg.grad_weight_stream(net)
    slabs = _stage_slabs(stream, fmg._grad_stream_parts(net), acc)
    n = pts.shape[0]
    pad = (-n) % T
    pe, ped = (F.pad(x.to(acc), (0, 0, 0, pad))
               for x in fm.encode_points(net, pts, dirs))
    g4 = F.pad(g.to(acc), (0, 0, 0, pad))
    wa, wr = net.w_alpha[:, :4].to(acc), net.w_rgb[:, :4].to(acc)
    b = [x.to(acc) for x in net.b]
    bv = [x.to(acc) for x in net.bv]

    def sums(d):  # column sums per 64-point tile of the planes
        return d.reshape(-1, 64, d.shape[1]).sum(1)

    planes = {k: [] for k in ("hs", "hvs", "dcs", "dvs")}
    bias = []
    for t0 in range(0, n + pad, T):
        walk = _Walk(slabs)
        x, xd, gt = (v[t0:t0 + T] for v in (pe, ped, g4))
        nb = W // 64
        H = [list(range(1, 1 + nb)), list(range(1 + nb, 1 + 2 * nb))]
        sm = _Tiles(1 + 2 * nb, T, acc)
        sm.write([0], x)
        halves = 2 if split else 1

        def layer(reads, lanes, post=None):
            """Both warpgroups' sums of one layer (their column halves),
            each over the reads (a list of (tile read, lanes))."""
            q0, per = walk.q, lanes // halves
            out = []
            for wg in range(halves):
                walk.q = q0
                s = None
                for a in reads:
                    s = walk.prod(a, slice(wg * per, (wg + 1) * per), s)
                out.append(s)
            s = torch.cat(out, dim=1)
            return s if post is None else s + post

        hl = H[(D - 1) & 1] if split else H[0]
        other = H[((D - 1) & 1) ^ 1] if split else H[1]
        hvt = [other[:nb // 2], other[nb // 2:]] if split else [other,
                                                               other]
        ped_blk = [other[nb // 2]] if split else None

        def fill_ped():
            if split:
                sm.write(ped_blk, xd)

        fill_ped()
        hs, hvs = [], []
        for i in range(D):
            src = H[(i & 1) ^ 1] if split else H[0]
            reads = ([sm.read([0])] if i == 0 or i in net.wskip else [])
            if i:
                reads.append(sm.read(src))
            h = _bf16(torch.relu(layer(reads, W) + b[i]))
            sm.write(H[i & 1] if split else H[0], h)
            hs.append(h)
        fill_ped()
        for v in range(V):
            src = sm.read(hl) if v == 0 else sm.read(hvt[(v & 1) ^ 1], WV)
            reads = [src] + ([sm.read(ped_blk, PED_PAD) if split else xd]
                             if v == 0 else [])
            hv = _bf16(torch.relu(layer(reads, WV) + bv[v]))
            sm.write(hvt[v & 1], hv)
            hvs.append(hv)
        # backward
        dvs, dcs, bvr, bsr = [None] * V, [None] * D, [None] * V, [None] * D
        dv = V & 1
        d = torch.where(hvs[V - 1] > 0, gt @ wr.T, torch.zeros(()).to(acc))
        for v in range(V - 1, -1, -1):
            dvs[v], bvr[v] = _bf16(d), sums(d)
            sm.write(hvt[dv], dvs[v])
            if v:
                s = layer([sm.read(hvt[dv], WV)], WV)
                dv ^= 1
                d = torch.where(hvs[v - 1] > 0, s, torch.zeros(()).to(acc))
        s = layer([sm.read(hvt[dv], WV)], W, gt @ wa.T)
        dc = (D - 1) & 1 if split else 0
        for i in range(D - 1, -1, -1):
            d = torch.where(hs[i] > 0, s, torch.zeros(()).to(acc))
            dcs[i], bsr[i] = _bf16(d), sums(d)
            sm.write(H[dc], dcs[i])
            if i:
                s = layer([sm.read(H[dc])], W)
                dc ^= 1 if split else 0
        assert walk.q == len(slabs)
        for k, v in (("hs", hs), ("hvs", hvs), ("dcs", dcs), ("dvs", dvs)):
            planes[k].append(v)
        g16 = F.pad(gt, (0, HEADS - 4))
        bias.append(torch.cat([*bsr, *bvr, sums(g16)], dim=1))

    def layers(k, L):
        return [torch.cat([t[j] for t in planes[k]])[:n] for j in range(L)]

    return (layers("hs", D), layers("hvs", V), layers("dcs", D),
            layers("dvs", V), torch.cat(bias)[:-(-n // 64)])


@pytest.mark.parametrize("name,n", [("paper", 130), ("d2-skip", 65)])
@pytest.mark.parametrize("W", WIDTHS)
def test_pass_a_emulation_matches_grad_pass_a_reference(W, name, n):
    """The emulation of pass A's walk (split at W=512) against
    grad_pass_a_reference, every activation and d_h plane and the bias
    rows: within 1e-5 norm-relative in f64, where the order of the sums
    leaves no trace; ragged tiles leave the valid rows and the bias rows
    as they are."""
    net = _packed(W, name, seed=5)
    pts, dirs, g = _points(n, seed=n + 1)
    want = fmg.grad_pass_a_reference(net, pts, dirs, g, torch.float64)
    hs, hvs, dcs, dvs, bias = _emulate_pass_a(net, pts, dirs, g)
    assert bias.shape == want.bias.shape == (-(-n // 64), want.bias.shape[1])
    for key, got in (("hs", hs), ("hvs", hvs), ("dcs", dcs), ("dvs", dvs)):
        for j, (x, w) in enumerate(zip(got, getattr(want, key))):
            assert x.shape == w.shape, (key, j)
            assert _rel(x, w) <= 1e-5, (key, j, _rel(x, w))
    assert _rel(bias, want.bias) <= 1e-5


def _emulate_pass_a_f32(net, pts, dirs, g, acc=torch.float64):
    """Pass A f32's walk in plain torch at the net's width: 64-point
    tiles, every product one stage of the f32 stream at a time (4096 / N
    whole rows a stage; a stage's rows past a matrix unused), relu' kept
    from the forward, d_h from the heads' K = 4 products, masked and
    multiplied back through the transposed stages; bias rows summed over
    a warp's 8 rows, then the 8 warps in order. -> (hs, hvs, dcs, dvs,
    bias) of N rows."""
    stream, _ = fmg.grad_weight_stream_f32(net)
    slabs, q = [], 0
    for _, m in fmg._grad_stream_parts_f32(net):
        kr = F32_STAGE // m.shape[1]
        for _ in range(0, m.shape[0], kr):
            slabs.append(stream[q:q + F32_STAGE].view(kr, -1).to(acc))
            q += F32_STAGE
    n = pts.shape[0]
    pad = (-n) % 64
    pe, ped = (F.pad(x.to(acc), (0, 0, 0, pad))
               for x in fm.encode_points(net, pts, dirs))
    g4 = F.pad(g.to(acc), (0, 0, 0, pad))
    wa, wr = net.w_alpha[:, :4].to(acc), net.w_rgb[:, :4].to(acc)
    D, V = len(net.w), len(net.wv)

    def col_sums(d):
        return d.reshape(8, 8, d.shape[1]).sum(1).sum(0)

    out = {k: [] for k in ("hs", "hvs", "dcs", "dvs", "bias")}
    for t0 in range(0, n + pad, 64):
        walk = _Walk(slabs)
        x, xd, gt = (v[t0:t0 + 64] for v in (pe, ped, g4))
        hs = [torch.relu(walk.prod(x) + net.b[0].to(acc))]
        for i in range(1, D):
            s = walk.prod(x) if i in net.wskip else None
            hs.append(torch.relu(walk.prod(hs[-1], s=s) + net.b[i].to(acc)))
        hvs = [torch.relu(walk.prod(xd, s=walk.prod(hs[-1]))
                          + net.bv[0].to(acc))]
        for v in range(1, V):
            hvs.append(torch.relu(walk.prod(hvs[-1]) + net.bv[v].to(acc)))
        dvs, dcs, bv, bs = [None] * V, [None] * D, [None] * V, [None] * D
        d = gt @ wr.T
        for v in range(V - 1, -1, -1):
            dvs[v] = torch.where(hvs[v] > 0, d, torch.zeros_like(d))
            bv[v] = col_sums(dvs[v])
            if v:
                d = walk.prod(dvs[v])
        d = walk.prod(dvs[0]) + gt @ wa.T
        for i in range(D - 1, -1, -1):
            dcs[i] = torch.where(hs[i] > 0, d, torch.zeros_like(d))
            bs[i] = col_sums(dcs[i])
            if i:
                d = walk.prod(dcs[i])
        assert walk.q == len(slabs)
        g16 = F.pad(gt, (0, HEADS - 4))
        for k, v in (("hs", hs), ("hvs", hvs), ("dcs", dcs), ("dvs", dvs),
                     ("bias", torch.cat([*bs, *bv, g16.sum(0)])[None])):
            out[k].append(v)

    def layers(k, L):
        return [torch.cat([t[j] for t in out[k]])[:n] for j in range(L)]

    return (layers("hs", D), layers("hvs", V), layers("dcs", D),
            layers("dvs", V), torch.cat(out["bias"]))


@pytest.mark.parametrize("name,n", [("paper", 65), ("d2-skip", 1)])
@pytest.mark.parametrize("W", WIDTHS)
def test_pass_a_f32_emulation_matches_grad_pass_a_reference(W, name, n):
    """The emulation of pass A f32's walk against grad_pass_a_reference on
    f32 weights, every plane and the bias rows: within 1e-5 norm-relative
    in f64; ragged tiles (65 points, one point in a tile of zeros)."""
    net = _packed(W, name, torch.float32, seed=7)
    pts, dirs, g = _points(n, seed=n + 2)
    want = fmg.grad_pass_a_reference(net, pts, dirs, g, torch.float64)
    hs, hvs, dcs, dvs, bias = _emulate_pass_a_f32(net, pts, dirs, g)
    for key, got in (("hs", hs), ("hvs", hvs), ("dcs", dcs), ("dvs", dvs)):
        for j, (x, w) in enumerate(zip(got, getattr(want, key))):
            assert x.shape == w.shape, (key, j)
            assert _rel(x, w) <= 1e-5, (key, j, _rel(x, w))
    assert bias.shape == want.bias.shape
    assert _rel(bias, want.bias) <= 1e-5


# ---------------------------------------------------------- launch plans

def _layout(W):
    """csrc/chain.cuh Layout<W>'s byte sizes: the block's tiles (each
    warpgroup's PE, trunk and view tile at W <= 256; one PE tile and two
    trunk tiles the warpgroups share at 512), the point kernels' (plus
    dir-PE tiles), and pass A's relu' words a thread per layer."""
    WV, split = W // 2, W > 256
    pe, h, hv, ped = 2 * 64 * PE_PAD, 2 * 64 * W, 2 * 64 * WV, 2 * 64 * 64
    wg = pe + h + hv
    cw, cv = (W // 2, WV // 2) if split else (W, WV)
    return dict(tiles=pe + 2 * h if split else 2 * wg,
                point_tiles=pe + 2 * h + ped if split else 2 * (wg + ped),
                mw=cw // 64, mv=cv // 64)


def _chain_smem(W):
    def smem(rb, S, n_cdf, n_union, n_prev, ring):
        regions = [3, 3, 1, PED_PAD, W // 2, S, 4 * S, S, n_cdf, n_union,
                   n_prev, n_prev]
        state = sum(-(-4 * rb * x // 128) * 128 for x in regions)
        return 1024 + ring * 2 * STAGE + _layout(W)["tiles"] + 128 + state
    return smem


def _point_smem(W):
    return lambda ring: (1024 + ring * 2 * STAGE + _layout(W)["point_tiles"]
                         + 128)


def _pass_a_smem(W):
    """pass_a_smem_bytes: the ring, the tiles (pass A's at W <= 256 are the
    ray kernels' two warpgroups' tiles; the dir-PE tile shares a view or
    trunk tile), both warpgroups' relu' bits (rounded up to 1 KB each),
    the ring's mbarriers and the two store mailboxes."""
    L = _layout(W)

    def smem(ring, depth, n_views):
        masks = 128 * 4 * (L["mw"] * depth + L["mv"] * n_views)
        masks = -(-masks // 1024) * 1024
        return (1024 + ring * 2 * STAGE + L["tiles"] + 2 * masks + 128
                + 32 + 2 * 48)
    return smem


def _pass_a_f32_smem(W):
    """pass_a_f32_smem_bytes: the ring, the f32 activation, PE and dir-PE
    tiles and the column sums' scratch (over the PE tiles at W=512), the
    relu' bits (64-bit words a thread per layer), the mbarriers."""
    WV = W // 2

    def smem(ring, depth, n_views):
        tiles = 4 * (64 * W + 64 * PE_PAD + 64 * PED_PAD
                     + (0 if W > 256 else 8 * W))
        words = (-(-W // 4 // 64)) * depth + (-(-WV // 4 // 64)) * n_views
        return 1024 + ring * 2 * STAGE + tiles + 8 * 256 * words + 128
    return smem


class _Lib:
    """The library calls the plans make, from the layouts above."""

    def __getattr__(self, name):
        base, width = name.rsplit("_w", 1)
        W = int(width)
        return {"fr_chain_smem_bytes": _chain_smem,
                "fr_point_smem_bytes": _point_smem,
                "fr_grad_pass_a_smem_bytes": _pass_a_smem,
                "fr_grad_pass_a_f32_smem_bytes": _pass_a_f32_smem,
                "fr_grad_max_tasks": lambda W: (lambda: 224 if W > 256
                                                else 160)}[base](W)

    @staticmethod
    def fr_max_ring():
        return 8


@pytest.mark.parametrize("W", WIDTHS)
def test_render_plans_fit_the_shared_memory_at_each_width(W):
    """The ray kernels' plans at W, for the paper's 64 + 128 sampling (the
    coarse kernel placing 128 depths, the fine pass at 192) and a delta
    frame of 16 depths from 192: the most rays (at most 64 a block) that
    fit beside the ring and the tiles, none more, each plan within the
    shared memory; at W=512 the tiles leave fewer rays a block than at
    W=128, and its 64-point tiles are what the last tile's waste is
    counted in."""
    lib = _Lib()
    smem = _chain_smem(W)
    fr._render_plan.cache_clear()
    rays = {}
    for S, n_imp in ((64, 128), (192, 0)):
        widths = fr._state_widths(S, n_imp)
        rb, ring = fr._render_plan(lib, S, *widths, W)
        assert ring == fr._RENDER_RING
        assert smem(rb, S, *widths, 0, ring) <= fr.SMEM_LIMIT
        tile = fr.chain_tile(W)
        rows = -(-rb * S // tile) * tile
        assert rb == fr._RENDER_MAX_RAYS or (
            smem(rb + 1, S, *widths, 0, ring) > fr.SMEM_LIMIT
            or rows - rb * S <= fr._MAX_TAIL * rows)
        rays[S] = rb
    rb, ring = fr._delta_plan(lib, 16, 192, W)
    assert ring >= fr._DELTA_MIN_RING
    assert smem(rb, 16, 190, 15, 192, ring) <= fr.SMEM_LIMIT
    if W == 512:
        rays128 = {S: fr._render_plan(lib, S, *fr._state_widths(S, n), 128)[0]
                   for S, n in ((64, 128), (192, 0))}
        assert all(rays[S] < rays128[S] for S in rays)
    fr._render_plan.cache_clear()


@pytest.mark.parametrize("N", [393216, 524288, 1001, 1])
@pytest.mark.parametrize("W", WIDTHS)
def test_point_plans_cover_every_point_once_at_each_width(W, N):
    """The point kernels' and pass A's (bf16) plans at W on a 132-SM card:
    tiles of chain_tile(W) points (128, 64 at W=512) in contiguous runs
    over at most one wave of blocks, every point covered once; the point
    kernels' ring and pass A's deepest (4 at W=128, 3 at W=512 for the
    paper model) fit beside their tiles. Pass A f32's 64-point tiles:
    4 stages at W=128, 2 at 512."""
    lib = _Lib()
    tile = fr.chain_tile(W)
    for per_block, blocks, ring in (
            fm._point_plan(lib, N, 132, width=W),
            fmg.pass_a_plan(lib, N, 132, 8, 3, W)):
        assert blocks <= 132
        seen = torch.zeros(N, dtype=torch.int32)
        for blk in range(blocks):
            p0 = blk * per_block * tile
            assert p0 < N
            seen[p0:min(p0 + per_block * tile, N)] += 1
        assert torch.all(seen == 1)
    assert _point_smem(W)(fm._POINT_RING) <= fr.SMEM_LIMIT
    ring = fmg.pass_a_plan(lib, N, 132, 8, 3, W)[2]
    assert ring == {128: 4, 512: 3}[W]
    assert _pass_a_smem(W)(ring, 8, 3) <= fr.SMEM_LIMIT
    per_block, blocks, ring = fmg.pass_a_f32_plan(lib, N, 132, 8, 3, W)
    assert ring == {128: 4, 512: 2}[W] and blocks <= 132
    assert (blocks - 1) * per_block * 64 < N <= blocks * per_block * 64


def test_plans_refuse_a_w512_net_too_deep_for_their_tiles():
    """At W=512 pass A's relu' bits grow with depth beside 64 KB trunk
    tiles: bf16 takes depth 12 at a 2-stage ring and refuses 13, f32 takes
    the paper depth (8) and refuses 9; each refusal names B10 before any
    launch (and a depth-16 W=512 net is refused by both). At W=128 the
    deepest net the operand table takes (16) fits both."""
    lib = _Lib()
    assert fmg.pass_a_plan(lib, 1000, 132, 12, 4, 512)[2] == 2
    assert fmg.pass_a_f32_plan(lib, 1000, 132, 8, 3, 512)[2] == 2
    for plan, depth in ((fmg.pass_a_plan, 13), (fmg.pass_a_plan, 16),
                        (fmg.pass_a_f32_plan, 9), (fmg.pass_a_f32_plan, 16)):
        with pytest.raises(ValueError, match="B10"):
            plan(lib, 1000, 132, depth, 1 + depth // 4, 512)
    assert fmg.pass_a_plan(lib, 1000, 132, 16, 5, 128)[2] >= 2
    assert fmg.pass_a_f32_plan(lib, 1000, 132, 16, 5, 128)[2] >= 2


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_pass_b_task_tables_stay_within_their_bound_at_w512(f32):
    """Pass B's output tiles at W=512 (csrc/fused_mlp_grad.cuh max_tasks:
    224): the paper model's 144, and every net pass A's plan takes there
    (bf16 to depth 12, f32 to depth 8, with up to four skip layers), fit
    the table; a deeper net's table does not, and _check_tasks refuses it
    naming B10."""
    lib = _Lib()
    most = lib.fr_grad_max_tasks_w512()
    net = _packed(512, "paper", torch.float32 if f32 else torch.bfloat16)
    assert fmg.pass_b_tasks(net, f32) == 144
    fmg._check_tasks(lib, net, f32)
    deepest = 8 if f32 else 12
    for depth in range(1, deepest + 1):
        for n_skip in range(min(4, depth - 1) + 1):
            d = dataclasses.replace(
                net, w=net.w[:1] + [net.w[1]] * (depth - 1),
                wv=net.wv[:1] + [net.wv[1]] * (depth // 4),
                wskip={i: net.w[0] for i in range(1, n_skip + 1)})
            assert fmg.pass_b_tasks(d, f32) <= most, (depth, n_skip)
    deep = dataclasses.replace(net, w=net.w[:1] + [net.w[1]] * 15,
                               wv=net.wv[:1] + [net.wv[1]] * 4,
                               wskip={5: net.w[0]})
    assert fmg.pass_b_tasks(deep, f32) > most
    with pytest.raises(ValueError, match="B10"):
        fmg._check_tasks(lib, deep, f32)


# ------------------------------------------------ against the JAX package

def _jax_and_port(W, depth, seed=0):
    """The JAX net and its folded biases, the bridged port model and its
    folded biases, at width W (narrow conditioning from numpy draws)."""
    cfg_kw = dict(COND, netwidth=W, netdepth=depth)
    jcfg = JaxConfig(**cfg_kw).face_nerf_config()
    jparams = jax_fn.init_face_nerf(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    cond = (rng.randn(16).astype(np.float32),
            rng.randn(8).astype(np.float32),
            (rng.randn(4) * 0.1).astype(np.float32))
    jfold = jax_fn.fold_conditioning(jparams, jcfg, *map(jnp.asarray, cond))
    ncfg = ExperimentConfig(**cfg_kw).face_nerf_config()
    model = bridge.load_module_(FaceNeRF(ncfg),
                                jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        folded = fold_conditioning(model, ncfg, *map(_t, cond))
    return (jparams, jfold, jcfg), (model, folded, ncfg)


@pytest.mark.parametrize("W", WIDTHS)
def test_frame_matches_jax_at_each_width(W):
    """A frame's two passes at W (depth 2): the coarse
    kernel's 16 + 16 sampling with its in-kernel depth placement (K2),
    then the fine pass at its 32 depths (K1), the port's wrappers (their
    plain versions on CPU tensors) against the JAX package's Pallas
    kernels in interpret mode: the render within 3e-2 with rgb correlated
    above 0.999, the depths within 3e-2 (each follows its side's
    bf16-rounded coarse weights), as at the paper width
    (test_torch_fused_render.py)."""
    (jp, jf, jc), (m, f, c) = _jax_and_port(W, 2, seed=W)
    rng = np.random.RandomState(W)
    n = 24
    ro = np.tile(np.array([[0.0, 0.0, 1.5]], np.float32), (n, 1))
    rd = (rng.randn(n, 3) * 0.08 + [0.0, 0.0, -1.0]).astype(np.float32)
    bc = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    near, far = 0.5772, 1.1772
    cj, zj = jfr.fused_render_coarse_hier(
        jp, jf, jc, *map(jnp.asarray, (ro, rd, bc)), near, far, 16, 16,
        point_tile=512)
    with torch.no_grad():
        cp, zp = fr.fused_render_coarse_hier(m, f, c, _t(ro), _t(rd), _t(bc),
                                             near, far, 16, 16)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=3e-2)
    z = np.asarray(jax_stratified(0.6, 2.2, 32, n, key=None))
    fj = jfr.fused_render_rays(jp, jf, jc, *map(jnp.asarray, (ro, rd, z, bc)),
                               point_tile=512)
    with torch.no_grad():
        fp = fr.fused_render_rays(m, f, c, _t(ro), _t(rd), _t(z), _t(bc))
    for port, ref in ((cp, cj), (fp, fj)):
        for k in ("rgb_map", "acc_map", "weights", "last_weight"):
            np.testing.assert_allclose(port[k].numpy(), np.asarray(ref[k]),
                                       atol=3e-2, err_msg=k)
        corr = np.corrcoef(port["rgb_map"].numpy().ravel(),
                           np.asarray(ref["rgb_map"]).ravel())[0, 1]
        assert corr > 0.999, corr


@pytest.mark.parametrize("W", WIDTHS)
def test_head_step_matches_jax_at_each_width(W):
    """One step of the head trainer's frame loss at W (depth 2, narrow
    conditioning, 30 rays): the loss within 1e-5 relative and every
    gradient within 1e-4 norm-relative of the JAX package's, on the same
    coords with no random draws, with the settings of
    test_torch_train.py::test_train_steps_match_jax (softplus density,
    multires 6)."""
    kw = dict(dim_aud=32, dim_expr=8, dim_latent=4, netdepth=2, netwidth=W,
              N_rand=30, mouth_rays=8, torso_rays=8, N_samples=6,
              N_importance=6, lrate=5e-4, smo_size=4, nosmo_iters=10 ** 9,
              density_activation="softplus", multires=6)
    jcfg, cfg = JaxConfig(**kw, flat_optimizer=False), ExperimentConfig(**kw)
    ds = make_synthetic_dataset(n_frames=2, H=12, W=12, dim_expr=8)
    init = init_train_state(cfg, ds.size, torch.Generator().manual_seed(W))
    jparams = jax.tree.map(jnp.asarray, bridge.params_to_jax(init.params))
    jlatent = jnp.ones((ds.size, cfg.dim_latent), jnp.float32)
    state = bridge.train_state_from_jax(jax.tree.map(np.asarray, jparams),
                                        np.asarray(jlatent), cfg)
    jds = jax_synthetic(n_frames=2, H=12, W=12, dim_expr=8)
    coords = np.stack(np.meshgrid(np.arange(1, 11, 2), np.arange(0, 12, 2),
                                  indexing="ij"), -1).reshape(-1, 2)
    step = jax.jit(jax.value_and_grad(jax_frame_loss(jcfg, jds, False),
                                      has_aux=True), static_argnums=(4,))
    with jax.default_matmul_precision("highest"):
        (jl, _), jg = step((jparams, jlatent), jds.to_device(), 1,
                           jnp.asarray(coords, jnp.int32), None)
    loss, _ = make_frame_loss(cfg, ds, False)(
        state.params, state.latent_codes, ds.to_device("cpu"), 1,
        torch.from_numpy(coords), None)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    holder = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), state.params.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    got = jax.tree.map(np.asarray, bridge.module_to_tree(holder))
    ref = {k: jg[0][k] for k in got}
    floor = 1e-6 * max(np.linalg.norm(np.asarray(r))
                       for r in jax.tree.leaves(ref))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got)):
        r = np.asarray(r)
        err = np.linalg.norm(g - r) / max(np.linalg.norm(r), floor)
        assert err < 1e-4, (jax.tree_util.keystr(path), err)
