"""Kernel-diagnosis entry points: card probes of the fused MLP's time,
one module per probe script of the JAX package (``kdiag``, ``kdiag2``,
``kdiag3``, ``kdiag4``, ``kdiag5``), with its variant labels, and
``kdelta``, this port's probe of the temporal delta kernel (its own
docstring says how it runs).

    python -m idealnerf_tpu_torch.scripts.kdiag4 --kd4 V0,V2,V3,VX
    python -m idealnerf_tpu_torch.scripts.kdiag --device cpu --rows 256

Each ``main(argv)`` prints one line per variant and returns the results as
a dict. On ``--device cuda`` (the default) a variant is timed with CUDA
events after a warm-up, and its rate is given against the H100 SXM data
sheet's dense peak for its type; with ``--check`` the plain version then
runs once on the same inputs, timed, and the last timed output is held
against it. On ``--device cpu`` the plain versions run at the size given
and nothing is timed.

Bounds of ``--check``: bf16 chains (and the ladder's bf16 activations)
within 3e-2 of the plain output's max abs with a correlation above 0.999
(both sides round every layer to bf16, at points that can land one ulp
apart); the f32 chain within 1e-5 of its max abs; int8 chains bitwise;
raw MLP outputs 3e-2 absolute and a correlation above 0.999 per lane.
"""

from __future__ import annotations

import argparse
import functools
import math
import subprocess

import torch

# dense peaks of one H100 SXM (NVIDIA data sheet), operations per second
PEAK = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
UNIT = {"bf16": "TFLOP/s", "f32": "TFLOP/s", "int8": "TOP/s"}
ATOL = 3e-2
F32_TOL = 1e-5
MIN_CORR = 0.999
# the TPU probes' chain: DEPTH layers of W x W
W = 256
DEPTH = 8
_CHUNK = 1 << 26


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="on the card, time each variant's plain version "
                    "once on its inputs and hold the variant against it")
    return ap


def ints(text: str):
    return [int(s) for s in str(text).split(",") if s]


def device_of(name: str) -> torch.device:
    """The run's device; ``cuda`` without a card raises (no CPU timings
    under a card's name), with one prints the card's name and power limit,
    which every rate below depends on."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device (use --device "
                               "cpu for the plain versions)")
        print(f"card: {card()}", flush=True)
    return torch.device(name)


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, for the record."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def run_worker(script: str, tree, argv, timeout: int = 900) -> dict:
    """``script --worker TREE argv`` in a fresh process, so that TREE's
    package is the one it imports -> the dict of its ``RESULT`` line."""
    import json
    import sys

    r = subprocess.run([sys.executable, script, "--worker", str(tree),
                        *argv], capture_output=True, text=True,
                       timeout=timeout)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    if r.returncode or not line:
        raise RuntimeError(f"{tree}: worker failed\n{r.stdout[-3000:]}\n"
                           f"{r.stderr[-3000:]}")
    return json.loads(line[0][len("RESULT "):])


def build_trees(trees: dict, kernels) -> None:
    """One kernel build per checkout (label -> root), all started
    together; prints each one's ptxas lines of the kernels whose mangled
    names hold one of ``kernels``."""
    import sys

    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            "idealnerf_tpu_torch.kernels import build; print(build.build()"
            "['log'])")
    procs = {k: subprocess.Popen([sys.executable, "-c", code, str(t)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, t in trees.items()}
    for k, p in procs.items():
        log = p.communicate()[0].splitlines()
        if p.returncode:
            raise RuntimeError(f"{k}: build failed\n" + "\n".join(log[-60:]))
        for i, ln in enumerate(log):
            if any(f"Function properties for _ZN2fr{f}" in ln
                   for f in kernels):
                print(f"{k:7s} ptxas: " + " | ".join(
                    x.strip() for x in log[i:i + 3]), flush=True)


def chain_inputs(rows: int, dtype, dev, seed: int = 0, depth: int = DEPTH):
    """The TPU probes' chain inputs -> (x (rows, W), ws (depth, W, W)) in
    ``dtype``: bf16 or f32 x ~ N(0, 1) and weights ~ 0.05 N(0, 1); int8 x
    uniform in [-127, 127] and weights uniform in [-4, 4]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int8:
        x = torch.randint(-127, 128, (rows, W), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        ws = torch.randint(-4, 5, (depth, W, W), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8)
        return x, ws
    x = torch.randn(rows, W, generator=g, device=dev).to(dtype)
    ws = (torch.randn(depth, W, W, generator=g, device=dev) * 0.05).to(dtype)
    return x, ws


# ------------------------------------------------------------ agreement

def _chunks(a: torch.Tensor, b: torch.Tensor):
    a, b = a.reshape(-1), b.reshape(-1)
    for i in range(0, a.numel(), _CHUNK):
        yield a[i:i + _CHUNK].float(), b[i:i + _CHUNK].float()


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    """Pearson correlation, centred in f32 and summed in f64 by chunks (a
    4M x 256 output would need several copies of itself at once)."""
    n = a.numel()
    ma = sum(float(x.sum(dtype=torch.float64)) for x, _ in _chunks(a, b)) / n
    mb = sum(float(y.sum(dtype=torch.float64)) for _, y in _chunks(a, b)) / n
    sab = saa = sbb = 0.0
    for x, y in _chunks(a, b):
        x, y = x - ma, y - mb
        sab += float((x * y).sum(dtype=torch.float64))
        saa += float((x * x).sum(dtype=torch.float64))
        sbb += float((y * y).sum(dtype=torch.float64))
    return sab / math.sqrt(saa * sbb) if saa * sbb > 0 else float("nan")


def close(label: str, got: torch.Tensor, want: torch.Tensor,
          tol: float = ATOL, rel: bool = False) -> float:
    """``got`` against its plain version ``want``: the max abs error
    (divided by want's max abs with ``rel``) within ``tol`` and a
    correlation above MIN_CORR. Prints one line, raises on disagreement
    -> the error."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)}, plain "
                             f"{tuple(want.shape)}")
    err, scale = 0.0, 1.0
    if rel:
        scale = float(want.abs().max().float()) or 1.0
    for x, y in _chunks(got, want):
        if not torch.isfinite(x).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = max(err, float((x - y).abs().max()) / scale)
    c = _corr(got, want)
    print(f"  {label}: max {'rel ' if rel else 'abs '}err {err:.3e} (tol "
          f"{tol:g}), corr {c:.6f} (> {MIN_CORR})"
          + (f", plain max abs {scale:.4g}" if rel else ""), flush=True)
    if not (err <= tol and c > MIN_CORR):
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def close_lanes(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``close`` per output lane of raw [rgb logits, sigma] rows."""
    got, want = got.reshape(-1, 4), want.reshape(-1, 4)
    return max(close(f"{label} lane {c}", got[:, c].contiguous(),
                     want[:, c].contiguous()) for c in range(4))


def same(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Bitwise equality (the int8 chains) -> 0.0; raises otherwise."""
    eq = got.shape == want.shape and torch.equal(got, want)
    print(f"  {label}: bitwise equal {eq} (plain output mean "
          f"{float(want.float().mean()):.4g})", flush=True)
    if not eq:
        raise AssertionError(f"{label} differs from its plain version")
    return 0.0


# ---------------------------------------------------------------- timing

def time_ms(fn, warmup: int = 2, reps: int = 5):
    """Mean ms of ``fn`` over ``reps`` launches, CUDA events, after
    ``warmup`` launches -> (ms, the last launch's output)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


def timed_plain(fn):
    """A ``--check``'s plain version: a call that times ``fn`` once on
    the card after one warm-up call -> (ms, output). Wrap it in
    ``functools.cache`` to share one run between variants."""
    return lambda: time_ms(fn, warmup=1, reps=1)


def measure(label: str, fn, ops: float, kind: str, dev: torch.device,
            reps: int = 5, plain=None, check=close) -> dict:
    """Run ``fn`` once (cpu) or time it (cuda) and print one line. On the
    card with ``plain`` (a ``timed_plain`` of the plain version on fn's
    inputs) also hold fn's last timed output against the plain output with
    ``check(label, got, want)``."""
    if dev.type == "cpu":
        out = fn()
        out = out["rgb_map"] if isinstance(out, dict) else out
        mean = float(out.float().mean())
        print(f"{label}: plain version on cpu, output mean {mean:.6g} "
              "(no timing on the CPU)", flush=True)
        return {"mean": mean}
    ms, out = time_ms(fn, reps=reps)
    rate = ops / (ms * 1e-3)
    share = rate / PEAK[kind]
    print(f"{label}: {ms:8.3f} ms  {rate / 1e12:7.1f} {UNIT[kind]}  "
          f"{100 * share:5.1f} % of the {kind} peak", flush=True)
    res = {"ms": ms, "rate": rate, "share": share, "ops": ops}
    if plain is not None:
        res["plain_ms"], want = plain()
        res["max_err"] = check(f"{label} vs plain ({res['plain_ms']:.3f} "
                               "ms)", out, want)
    return res


def slope(label: str, small: dict, large: dict, rows: tuple, ops_per_row:
          float, kind: str) -> dict:
    """The overhead-free rate between two sizes (the TPU scripts' slope
    method): extra operations over extra time."""
    if "ms" not in small:
        return {}
    dt = max(large["ms"] - small["ms"], 1e-9)
    rate = (rows[1] - rows[0]) * ops_per_row / (dt * 1e-3)
    print(f"{label} SLOPE: {rate / 1e12:7.1f} {UNIT[kind]}  "
          f"{100 * rate / PEAK[kind]:5.1f} % of the {kind} peak", flush=True)
    return {"slope_rate": rate, "slope_share": rate / PEAK[kind]}


# ---------------------------------------------------------------- chains

def chain_check(dtype):
    """The ``--check`` of a chain of ``dtype``: int8 bitwise, f32 within
    F32_TOL of its max abs, bf16 within ATOL of it."""
    if dtype == torch.int8:
        return same
    tol = F32_TOL if dtype == torch.float32 else ATOL

    def check(label, got, want):
        return close(label, got, want, tol, rel=True)
    return check


def sweep(name: str, mode: str, dtype, kind: str, rows: tuple, rpbs, dev,
          seed: int, check: bool, bias=None) -> dict:
    """kdiag4/kdiag5's timing of one chain variant: fresh inputs at each
    row count, the kernel at every rows per block (with ``check`` held
    against one plain run shared by them) -> results by ``"{name}
    r{rpb}"``: the sizes' results and, with two row counts, the slope."""
    from idealnerf_tpu_torch.kernels import kdiag as kd

    sizes = {rpb: {} for rpb in rpbs}
    for r in rows:
        x, ws = chain_inputs(r, dtype, dev, seed)
        plain = functools.cache(timed_plain(
            lambda: kd.chain_reference(x, ws, mode, bias))) if check else None
        for rpb in rpbs:
            sizes[rpb][r] = measure(
                f"{name} r{rpb:<3d} rows {r} {kind}",
                lambda: kd.chain(x, ws, mode, bias, rpb),
                2.0 * r * DEPTH * W * W, kind, dev, reps=3, plain=plain,
                check=chain_check(dtype))
        del x, ws, plain
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    results = {}
    for rpb, by_rows in sizes.items():
        res = {"rows": {str(r): v for r, v in by_rows.items()}}
        if len(rows) == 2:
            res.update(slope(f"{name} r{rpb:<3d}", by_rows[rows[0]],
                             by_rows[rows[1]], rows, 2.0 * DEPTH * W * W,
                             kind))
        results[f"{name} r{rpb}"] = res
    return results


def paper_field(dev: torch.device, seed: int = 0):
    """The paper head model at full width (D=8, W=256, dim_aud 64, dim_expr
    79, dim_latent 32, as the TPU scripts build it) with random weights and
    conditioning from ``seed`` -> (model, folded, cfg, packed bf16 net)."""
    from idealnerf_tpu_torch.config import ExperimentConfig
    from idealnerf_tpu_torch.kernels.fused_render import pack_operands
    from idealnerf_tpu_torch.models.face_nerf import (
        FaceNeRF, fold_conditioning,
    )

    cfg = ExperimentConfig(dim_aud=64, dim_expr=79,
                           dim_latent=32).face_nerf_config()
    g = torch.Generator().manual_seed(seed)
    model = FaceNeRF(cfg, g).to(dev)
    aud, expr = torch.randn(64, generator=g), torch.randn(79, generator=g)
    with torch.no_grad():
        folded = fold_conditioning(model, cfg, aud.to(dev), expr.to(dev),
                                   torch.ones(32, device=dev))
    return model, folded, cfg, pack_operands(model, folded, cfg)
