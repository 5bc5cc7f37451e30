"""The kernel-diagnosis probes of the PyTorch port (kernels/kdiag.py and
the scripts in idealnerf_tpu_torch/scripts/) against the Pallas kernel
bodies of the JAX package's probe scripts (scripts/kdiag{,2,3,4,5}.py),
each run under its own ``pl.pallas_call(..., interpret=True)`` at 16-64
rows. On the CPU every wrapper runs its plain version and launches
nothing.

Bounds: bf16 chains within 3e-2 of the output's max abs with a
correlation above 0.999 (both sides round every layer to bf16, at points
that can land one ulp apart; the probes' 0.05-scaled weights shrink the
activations layer by layer, so the bound is relative); the f32 chain
within 1e-5 of its max abs (no rounding but the summation order); int8
chains bitwise (integer products and sums, then one f32 scale and a
truncation that both sides round the same way); the render probes and the
ladder 3e-2 absolute and a correlation above 0.999 per output lane, the
fused kernels' bound.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from idealnerf_tpu.kernels.fused_mlp import (
    _PE_PAD, _PED_PAD, _pack_weights, _pe_operands,
)
from idealnerf_tpu.kernels.fused_mlp import fused_point_mlp as jax_fused
from idealnerf_tpu.models import face_nerf as jax_fn
from idealnerf_tpu_torch import bridge
from idealnerf_tpu_torch.kernels import fused_mlp, fused_render
from idealnerf_tpu_torch.kernels import kdiag as kd
from idealnerf_tpu_torch.models.face_nerf import (
    FaceNeRF, FaceNeRFConfig, fold_conditioning,
)
from idealnerf_tpu_torch import scripts as sc
from idealnerf_tpu_torch.scripts import kdiag as pkdiag
from idealnerf_tpu_torch.scripts import kdiag2 as pkdiag2
from idealnerf_tpu_torch.scripts import kdiag3 as pkdiag3
from idealnerf_tpu_torch.scripts import kdiag4 as pkdiag4
from idealnerf_tpu_torch.scripts import kdiag5 as pkdiag5
from scripts import kdiag, kdiag2, kdiag3, kdiag4, kdiag5

ATOL = 3e-2
MIN_CORR = 0.999
W = 256


def _counts():
    return {**kd.launch_counts, **fused_mlp.launch_counts,
            **fused_render.launch_counts}


def _rel_close(got, want, rtol=ATOL, corr=True):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=rtol)
    if corr:
        r = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert r > MIN_CORR, r


def _close_per_lane(got, want):
    got = np.asarray(got, np.float32).reshape(-1, 4)
    want = np.asarray(want, np.float32).reshape(-1, 4)
    np.testing.assert_allclose(got, want, atol=ATOL)
    for c in range(4):
        r = np.corrcoef(got[:, c], want[:, c])[0, 1]
        assert r > MIN_CORR, (c, r)


def _chain_inputs(rows, depth, seed, bf16=True):
    """kdiag4.py's inputs from numpy: x ~ N(0, 1), weights ~ 0.05 N(0, 1),
    as f32 arrays of bf16 values (or of f32 values)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, W).astype(np.float32)
    ws = (rng.randn(depth, W, W) * 0.05).astype(np.float32)
    if bf16:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        ws = np.array(jnp.asarray(ws, jnp.bfloat16).astype(jnp.float32))
    return x, ws


def _int8_inputs(rows, depth, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (rows, W)).astype(np.int8)
    ws = rng.randint(-4, 5, (depth, W, W)).astype(np.int8)
    return x, ws


def _call(body, out_dtype, rows, *args):
    return np.asarray(pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct((rows, W), out_dtype),
        interpret=True)(*args)).astype(np.float32)


# ---------------------------------------------------------------- chains

@pytest.mark.parametrize("name,mode", [
    ("k_plain", "cast"), ("k_relu", "bias_relu"), ("k_relu2", "relu2")])
def test_kdiag_chain_matches_jax_kernel(name, mode):
    """kdiag.py's three kernels (8 layers, bf16 out) against the port's
    chain in the matching mode; the bias is non-zero to exercise it."""
    rows = 32
    x, ws = _chain_inputs(rows, kdiag.L, seed=1)
    b = (np.random.RandomState(2).randn(kdiag.L, W) * 0.02).astype(
        np.float32)
    jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, ws))
    args = (jx, jw) if name == "k_plain" else (jx, jw, jnp.asarray(
        b[:, None, :]))
    want = _call(getattr(kdiag, name), jnp.bfloat16, rows, *args)
    before = _counts()
    got = kd.chain(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(ws).to(torch.bfloat16), mode,
                   None if name == "k_plain" else torch.from_numpy(b),
                   out_dtype=torch.bfloat16)
    assert _counts() == before
    assert got.dtype == torch.bfloat16 and got.shape == (rows, W)
    _rel_close(got.float().numpy(), want)


@pytest.mark.parametrize("mode", ["V0", "V2", "V3", "V5", "V6", "V7"])
def test_kdiag4_chain_matches_jax_kernel(mode):
    """kdiag4.py's chain_kernel in each mode against the port's chain (V3
    all f32 at full f32 precision on both sides)."""
    rows = 48
    f32 = mode == "V3"
    x, ws = _chain_inputs(rows, kdiag4.DEPTH, seed=3, bf16=not f32)
    dt = jnp.float32 if f32 else jnp.bfloat16
    with jax.default_matmul_precision("highest"):
        want = _call(functools.partial(kdiag4.chain_kernel, mode),
                     jnp.float32, rows, jnp.asarray(x, dt),
                     *[jnp.asarray(w, dt) for w in ws])
    tdt = torch.float32 if f32 else torch.bfloat16
    bias = pkdiag4.v6_bias("cpu") if mode == "V6" else None
    got = kd.chain(torch.from_numpy(x).to(tdt), torch.from_numpy(ws).to(tdt),
                   pkdiag4.MODES[mode], bias)
    assert got.dtype == torch.float32
    if f32:
        _rel_close(got.numpy(), want, rtol=1e-5)
    else:
        _rel_close(got.numpy(), want)


@pytest.mark.parametrize("mode", ["B0", "I0", "I1"])
def test_kdiag5_chain_matches_jax_kernel(mode):
    """kdiag5.py's chain_kernel at depth 2 (its I1 requant drives the
    script's inputs to zeros by layer 8): int8 bitwise, B0 as bf16."""
    rows, depth = 64, 2
    if mode == "B0":
        x, ws = _chain_inputs(rows, depth, seed=4)
        jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, *ws)]
        targs = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, ws)]
    else:
        x, ws = _int8_inputs(rows, depth, seed=4)
        jargs = [jnp.asarray(a) for a in (x, *ws)]
        targs = [torch.from_numpy(a) for a in (x, ws)]
    want = _call(functools.partial(kdiag5.chain_kernel, mode), jnp.float32,
                 rows, *jargs)
    got = kd.chain(*targs, {"B0": "relu", "I0": "i0", "I1": "i1"}[mode])
    if mode == "B0":
        _rel_close(got.numpy(), want)
    else:
        assert want.mean() > 1.0    # the requant keeps a signal at depth 2
        np.testing.assert_array_equal(got.numpy(), want)


def test_products_only_chain_sums_the_layers():
    """The port's own "sum" mode (kdiag4 VP): bf16 of x @ w_0 + ... +
    x @ w_7 in f32, against the same sum in JAX."""
    x, ws = _chain_inputs(32, 8, seed=14)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = sum(jnp.dot(jx, jnp.asarray(w, jnp.bfloat16),
                       preferred_element_type=jnp.float32) for w in ws)
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    got = kd.chain(torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(ws).to(torch.bfloat16),
                   pkdiag4.MODES["VP"])
    _rel_close(got.numpy(), want)


def test_i1_chain_collapses_at_depth_8():
    """The JAX script's I1 inputs reach all zeros by layer 8 on both sides
    (a fault of the reference probe, kept: it is what kdiag5.py measures)."""
    x, ws = _int8_inputs(32, 8, seed=5)
    want = _call(functools.partial(kdiag5.chain_kernel, "I1"), jnp.float32,
                 32, *[jnp.asarray(a) for a in (x, *ws)])
    got = kd.chain(torch.from_numpy(x), torch.from_numpy(ws), "i1")
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want.any()


@pytest.mark.parametrize("mode", ["relu", "i0"])
def test_library_chain_matches_plain_chain(mode):
    """The yardstick chain (torch.matmul / torch._int_mm per layer) computes
    the probe's function: bitwise for int8, to bf16 rounding for bf16."""
    if mode == "i0":
        x, ws = (torch.from_numpy(a) for a in _int8_inputs(40, 3, seed=6))
        np.testing.assert_array_equal(kd.chain_library(x, ws, mode).numpy(),
                                      kd.chain_reference(x, ws, mode).numpy())
    else:
        x, ws = (torch.from_numpy(a).to(torch.bfloat16)
                 for a in _chain_inputs(40, 3, seed=6))
        _rel_close(kd.chain_library(x, ws, mode).numpy(),
                   kd.chain_reference(x, ws, mode).numpy())


def test_chain_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(16, W, dtype=torch.bfloat16)
    ws = torch.zeros(2, W, W, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mode"):
        kd.chain(x, ws, "i0")
    with pytest.raises(ValueError, match="needs"):
        kd.chain(x, ws, "bias_relu")
    with pytest.raises(ValueError, match="takes no"):
        kd.chain(x, ws, "relu", torch.zeros(2, W))
    with pytest.raises(ValueError, match="write"):
        kd.chain(x.to(torch.int8), ws.to(torch.int8), "i0",
                 out_dtype=torch.int8)
    with pytest.raises(ValueError, match="mode"):
        kd.chain(x.float(), ws.float(), "i0")
    # the plans: 64 or 128 rows per block for bf16 and int8, 128 for f32
    # (the default of each the first), depth 1..64, a bias row per layer;
    # refused on either device
    for dtype, mode, rpbs in ((torch.bfloat16, "relu", (64, 128)),
                              (torch.float32, "relu", (128,)),
                              (torch.int8, "i0", (64, 128))):
        for rpb in {32, 64, 96, 128, 256} - set(rpbs):
            with pytest.raises(ValueError, match="rows_per_block"):
                kd.chain(x.to(dtype), ws.to(dtype), mode, None, rpb)
        assert tuple(kd.CHAIN_PLANS[dtype]) == rpbs
        for rpb in rpbs + (None,):
            assert torch.equal(
                kd.chain(x.to(dtype), ws.to(dtype), mode, None, rpb),
                kd.chain_reference(x.to(dtype), ws.to(dtype), mode))
    for depth in (0, 65):
        with pytest.raises(ValueError, match="depth 1..64"):
            kd.chain(x, torch.zeros(depth, W, W, dtype=torch.bfloat16),
                     "relu")
    with pytest.raises(ValueError, match="bias must be"):
        kd.chain(x, ws, "bias_relu", torch.zeros(3, W))
    with pytest.raises(ValueError, match="stage"):
        kd.ladder(_paper()[4], x[:, :64], x[:, :32], 5)


# ------------------------------------------------------- the paper model

@functools.lru_cache(maxsize=None)
def _paper(seed=0):
    """The paper head model (D=8, W=256) in both frameworks from one JAX
    init, with folded conditioning -> (jcfg, jparams, jfold, cfg, net,
    model, folded)."""
    dims = dict(dim_aud=64, dim_expr=79, dim_latent=32)
    jcfg = jax_fn.FaceNeRFConfig(**dims)
    cfg = FaceNeRFConfig(**dims)
    jparams = jax_fn.init_face_nerf(jax.random.PRNGKey(seed), jcfg)
    model = bridge.load_module_(FaceNeRF(cfg),
                                jax.tree.map(np.asarray, jparams))
    rng = np.random.RandomState(seed + 1)
    cond = [rng.randn(d).astype(np.float32) for d in (64, 79, 32)]
    jfold = jax_fn.fold_conditioning(jparams, jcfg,
                                     *[jnp.asarray(c) for c in cond])
    with torch.no_grad():
        folded = fold_conditioning(model, cfg,
                                   *[torch.from_numpy(c) for c in cond])
    net = fused_render.pack_operands(model, folded, cfg)
    return jcfg, jparams, jfold, cfg, net, model, folded


def _rays(R, S, seed):
    rng = np.random.RandomState(seed)
    o = rng.rand(R, 3).astype(np.float32)
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bc = rng.rand(R, 3).astype(np.float32)
    z = np.broadcast_to(np.linspace(0.58, 1.18, S, dtype=np.float32),
                        (R, S)).copy()
    return o, d, bc, z


def _pack8(x, one_lane):
    pad = [np.ones((len(x), 1), np.float32), np.zeros((len(x), 4),
                                                      np.float32)]
    if not one_lane:
        pad = [np.zeros((len(x), 5), np.float32)]
    return jnp.asarray(np.concatenate([x, *pad], axis=1))


def _kdiag3_call(kernel, R, S, ins, outs):
    jcfg, jparams, jfold = _paper()[:3]
    ops = _pack_weights(jparams, jfold, jcfg, jnp.bfloat16)
    n_views = 1 + jcfg.depth // 4
    return pl.pallas_call(
        functools.partial(kernel, jcfg, n_views, S), out_shape=outs,
        interpret=True)(*ins, *ops)


def _pe_consts():
    jcfg = _paper()[0]
    F_p, id_p = (jnp.asarray(a) for a in _pe_operands(jcfg.multires,
                                                      _PE_PAD))
    F_d, id_d = (jnp.asarray(a) for a in _pe_operands(jcfg.multires_views,
                                                      _PED_PAD))
    return [F_p, id_p, F_d, id_d]


@pytest.mark.parametrize("S", [8, 16])
def test_render_probe_a_matches_jax_kernel(S):
    """kdiag3.kernel_A (given PE) against render_probe_a on the same bf16
    encodings (the port's own, so that only the MLP is compared)."""
    R = 6
    net = _paper()[4]
    o, d, _, z = _rays(R, S, seed=7)
    pe, ped = kd.encode_rays(net, *(torch.from_numpy(a) for a in (o, d, z)))
    want = _kdiag3_call(
        kdiag3.kernel_A, R, S,
        [jnp.asarray(pe.float().numpy(), jnp.bfloat16),
         jnp.asarray(ped.float().numpy(), jnp.bfloat16)],
        jax.ShapeDtypeStruct((R, S * 4), jnp.float32))
    before = _counts()
    got = kd.render_probe_a(net, pe, ped, S)
    assert _counts() == before
    assert got.shape == (R, S * 4)
    _close_per_lane(got.numpy(), want)


def test_render_probe_b_matches_jax_kernel():
    """kdiag3.kernel_B (PE in the kernel from ray packets and depths)
    against render_probe_b."""
    R, S = 6, 12
    o, d, _, z = _rays(R, S, seed=8)
    want = _kdiag3_call(
        kdiag3.kernel_B, R, S,
        [_pack8(o, True), _pack8(d, False), _pack8(d, True),
         jnp.asarray(z), *_pe_consts()],
        jax.ShapeDtypeStruct((R, S * 4), jnp.float32))
    got = kd.render_probe_b(_paper()[4],
                            *(torch.from_numpy(a) for a in (o, d, z)))
    _close_per_lane(got.numpy(), want)


def test_render_c_matches_jax_kernel():
    """kdiag3.kernel_C (B + compositing) against the production fine pass
    it stands for (fused_render_rays, relu density)."""
    R, S = 6, 12
    o, d, bc, z = _rays(R, S, seed=9)
    bc4 = np.concatenate([bc, np.ones((R, 1), np.float32)], axis=1)
    U = jnp.asarray(np.triu(np.ones((S, S), np.float32), k=1))
    summary, weights = _kdiag3_call(
        kdiag3.kernel_C, R, S,
        [_pack8(o, True), _pack8(d, False), _pack8(d, True),
         jnp.asarray(z), jnp.asarray(bc4), *_pe_consts()[:4], U],
        (jax.ShapeDtypeStruct((R, 8), jnp.float32),
         jax.ShapeDtypeStruct((R, S), jnp.float32)))
    _, _, _, cfg, _, model, folded = _paper()
    with torch.no_grad():
        got = fused_render.fused_render_rays(
            model, folded, cfg, *(torch.from_numpy(a) for a in (o, d, z, bc)))
    summary, weights = np.asarray(summary), np.asarray(weights)
    np.testing.assert_allclose(got["rgb_map"].numpy(), summary[:, :3],
                               atol=ATOL)
    np.testing.assert_allclose(got["acc_map"].numpy(), summary[:, 3],
                               atol=ATOL)
    np.testing.assert_allclose(got["weights"].numpy(), weights, atol=ATOL)
    r = np.corrcoef(got["rgb_map"].numpy().ravel(),
                    summary[:, :3].ravel())[0, 1]
    assert r > MIN_CORR, r


# ------------------------------------------------------------- the ladder

def _ladder_inputs(n, seed):
    jcfg, jparams, jfold, cfg, net = _paper()[:5]
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pe, ped = (x.to(torch.bfloat16) for x in fused_mlp.encode_points(
        net, torch.from_numpy(pts), torch.from_numpy(dirs)))
    return pts, dirs, pe, ped


@pytest.mark.parametrize("stage", [3, 4])
def test_ladder_top_rungs_match_jax_fused_point_mlp(stage):
    """Rung v3 is the encoded-input point MLP (JAX fuse_pe=False), v4 the
    in-kernel-PE one (fuse_pe=True); kdiag2.py itself cannot be built
    against the current package (test_kdiag2_build_fails_as_written)."""
    jcfg, jparams, jfold, cfg, net = _paper()[:5]
    pts, dirs, pe, ped = _ladder_inputs(96, seed=10)
    want = np.asarray(jax_fused(jparams, jfold, jcfg, jnp.asarray(pts),
                                jnp.asarray(dirs), tile=32, interpret=True,
                                fuse_pe=stage == 4))
    before = _counts()
    got = pkdiag2.rung(net, stage, pe, ped, torch.from_numpy(pts),
                       torch.from_numpy(dirs))
    assert _counts() == before
    _close_per_lane(got.numpy(), want)


def test_ladder_rungs_compose_into_the_point_mlp():
    """v1 (the whole trunk) and v2 (the view branch) under the packed heads
    give v3; v0 is v1 with the skip layer's pe-part zeroed."""
    net = _paper()[4]
    _, _, pe, ped = _ladder_inputs(64, seed=11)
    h, hv = kd.ladder(net, pe, ped, 1), kd.ladder(net, pe, ped, 2)
    assert h.shape == (64, W) and hv.shape == (64, W // 2)
    assert h.dtype == hv.dtype == torch.bfloat16
    raw = (h.float() @ net.w_alpha.float() + hv.float() @ net.w_rgb.float()
           + net.b_heads)[:, :4]
    np.testing.assert_allclose(raw.numpy(),
                               kd.ladder(net, pe, ped, 3).numpy(), atol=1e-5)
    no_skip = fused_render.PackedNet(**{
        **net.__dict__, "wskip": {i: torch.zeros_like(x)
                                  for i, x in net.wskip.items()}})
    np.testing.assert_array_equal(kd.ladder(net, pe, ped, 0).float().numpy(),
                                  kd.ladder(no_skip, pe, ped, 1).float()
                                  .numpy())
    assert not torch.equal(kd.ladder(net, pe, ped, 0), h)


def test_ladder_macs_count_the_paper_model():
    net = _paper()[4]
    trunk = 63 * W + 7 * W * W
    assert kd.ladder_macs(net, 0) == trunk
    assert kd.ladder_macs(net, 1) == trunk + 63 * W
    view = W * 128 + 27 * 128 + 2 * 128 * 128
    assert kd.ladder_macs(net, 2) == trunk + 63 * W + view
    assert kd.ladder_macs(net, 3) == trunk + 63 * W + view + W + 3 * 128


def test_kdiag2_build_fails_as_written():
    """scripts/kdiag2.py unpacks three arrays from _pe_operands, which
    returns two since the one-sin PE form: its build raises before any
    variant. When it is repaired this test shows it."""
    with pytest.raises(ValueError, match="unpack"):
        kdiag2.build(0, 2048)


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("name,argv", [
    ("kdiag", ["--rows", "40", "--rows_per_block", "64,128"]),
    ("kdiag2", ["--rows", "24"]),
    ("kdiag3", ["--kd3", "ABC", "--kd3_r", "5", "--kd3_s", "8"]),
    ("kdiag4", ["--kd4", "V0,V3,V6,VX", "--kd4_m", "64,128", "--kd4_rows",
                "32", "--slope_rows", "32,48"]),
    ("kdiag5", ["--kd5", "B0,I0,I1,IX", "--slope_rows", "32,48"]),
])
def test_entry_points_run_the_plain_versions_on_the_cpu(name, argv, tmp_path):
    mod = {"kdiag": pkdiag, "kdiag2": pkdiag2, "kdiag3": pkdiag3,
           "kdiag4": pkdiag4, "kdiag5": pkdiag5}[name]
    if name == "kdiag5":
        argv = argv + ["--kd5_out", str(tmp_path / "kd5.json")]
    before = _counts()
    res = mod.main(["--device", "cpu", *argv])
    assert _counts() == before
    means = [r["mean"] for v in res["results"].values()
             for r in (v["rows"].values() if "rows" in v else [v])]
    assert len(means) >= 3 and np.isfinite(means).all()
    labels = set(res["results"])
    want = {"kdiag": {"plain r64", "relu r64", "relu2 r128"},
            "kdiag2": {"v0", "v1", "v2", "v3", "v4"},
            "kdiag3": {"A S=8", "B S=8", "C S=8"},
            "kdiag4": {"V0 r64", "V0 r128", "V3 r128", "V6 r128", "VX"},
            "kdiag5": {"B0 r64", "I0 r128", "I1 r64", "IX"}}[name]
    assert want <= labels, (want - labels)
    if name == "kdiag5":
        assert (tmp_path / "kd5.json").exists()


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkdiag.main(["--rows", "16"])


# ------------------------------------------------- the entry points' checks

def test_checks_refuse_what_the_bounds_refuse():
    """``--check``'s comparisons: bf16 chains relative to the output's max
    abs, the f32 chain at 1e-5 of it (a bf16 or TF32 rounding fails),
    raw outputs per lane, int8 bitwise."""
    g = torch.Generator().manual_seed(0)
    want = torch.randn(64, W, generator=g) * 10.0
    one_ulp = want.to(torch.bfloat16).float()
    assert sc.chain_check(torch.bfloat16)("bf16", one_ulp, want) < 1e-2
    with pytest.raises(AssertionError, match="disagrees"):
        sc.chain_check(torch.float32)("f32", one_ulp, want)
    assert sc.chain_check(torch.float32)("f32", want * (1 + 1e-7), want) \
        < 1e-5
    with pytest.raises(AssertionError, match="disagrees"):
        sc.close("abs", want + 0.05, want)
    with pytest.raises(AssertionError, match="disagrees"):
        sc.close("corr", want[torch.randperm(64, generator=g)] * 1e-3,
                 want * 1e-3)
    raw = torch.randn(100, 4, generator=g)
    bad = raw.clone()
    bad[:, 3] += 0.1
    assert sc.close_lanes("raw", raw, raw) == 0.0
    with pytest.raises(AssertionError, match="lane 3"):
        sc.close_lanes("raw", bad, raw)
    x = torch.randint(-127, 128, (8, W), generator=g).to(torch.int8)
    y = x.clone()
    y[3, 5] ^= 1
    assert sc.same("int8", x, x.clone()) == 0.0
    with pytest.raises(AssertionError, match="differs"):
        sc.same("int8", y, x)


def _card_stubs(monkeypatch, mods):
    """The entry points' card branch on CPU tensors: a device named cuda
    for ``measure``, one untimed call for ``time_ms``."""
    fake = types.SimpleNamespace(type="cuda")
    measure = sc.measure
    monkeypatch.setattr(sc, "time_ms",
                        lambda fn, warmup=2, reps=5: (1.0, fn()))
    for mod in (sc, *mods):
        monkeypatch.setattr(mod, "measure", lambda *a, **k: measure(
            *a[:4], fake, *a[5:], **k))
        monkeypatch.setattr(mod, "device_of", lambda name: torch.device(
            "cpu"), raising=False)


_SMALL = {"kdiag": ["--rows", "40"], "kdiag2": ["--rows", "24"],
          "kdiag3": ["--kd3_r", "5", "--kd3_s", "8"],
          "kdiag4": ["--kd4", "V0,V3,V6,VP,VX", "--kd4_rows", "32",
                     "--slope_rows", "32,48"],
          "kdiag5": ["--slope_rows", "32,48"]}


@pytest.mark.parametrize("name", sorted(_SMALL))
def test_entry_point_check_holds_every_timed_output(name, monkeypatch):
    """With ``--check`` every kernel variant's timed output is held against
    its plain version and reports its error and the plain version's time;
    a kernel whose output is off raises."""
    mods = {"kdiag": pkdiag, "kdiag2": pkdiag2, "kdiag3": pkdiag3,
            "kdiag4": pkdiag4, "kdiag5": pkdiag5}
    _card_stubs(monkeypatch, mods.values())
    res = mods[name].main([*_SMALL[name], "--check"])["results"]
    checked = [v for k, r in res.items() if k not in ("matmul", "VX", "IX")
               for v in (r["rows"].values() if "rows" in r else [r])]
    assert len(checked) >= 3
    assert all(v["max_err"] == 0.0 and v["plain_ms"] == 1.0
               for v in checked)

    def off(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if isinstance(out, dict):
                return {**out, "rgb_map": out["rgb_map"] + 0.5}
            return out + 1 if out.dtype == torch.int8 else out * 1.5 + 0.5
        return wrapped

    for mod, fn in ((kd, "chain"), (kd, "ladder"), (kd, "render_probe_a"),
                    (kd, "render_probe_b"), (fused_mlp, "point_mlp"),
                    (fused_render, "fused_render_rays")):
        monkeypatch.setattr(mod, fn, off(getattr(mod, fn)))
    with pytest.raises(AssertionError):
        mods[name].main([*_SMALL[name], "--check"])
