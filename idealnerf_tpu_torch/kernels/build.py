"""Build and load the CUDA kernels of this package.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` into
a shared library with a plain C interface, loaded through ctypes: one
``nvcc -c`` per ``.cu`` file, all started together, then one link. The
library lands in ``kernels/build/`` (not committed), named by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads the cached file. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# No --use_fast_math: the PE phases reach ~300 rad and __sinf is wrong there.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libidealnerf_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library if it is missing; -> {path, seconds, log}.

    ``log`` holds nvcc's output, including ptxas' register, shared-memory
    and spill report for each kernel."""
    so = library_path()
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(so), "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *[str(o) for o, _ in jobs]],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(link.returncode)
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return {"path": str(so), "seconds": seconds, "log": log}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its argtypes."""
    lib = ctypes.CDLL(build()["path"])
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    slots = ctypes.POINTER(ctypes.c_ulonglong)
    lib.fr_num_slots.argtypes = []
    lib.fr_num_slots.restype = i32
    lib.fr_error_string.argtypes = [i32]
    lib.fr_error_string.restype = ctypes.c_char_p
    lib.fr_render_rays.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i32, i32, slots, i32, i32, i32, i32,
        i32, vp, i32, i32, vp]
    lib.fr_render_rays.restype = i32
    lib.fr_coarse_hier.argtypes = [
        vp, vp, vp, f32, f32, vp, vp, vp, i32, i32, i32, i32, slots, i32,
        i32, i32, i32, i32, vp, i32, i32, vp]
    lib.fr_coarse_hier.restype = i32
    lib.fr_render_delta.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, f32, f32, f32, vp, vp, vp, i32, i32, i32,
        i32, i32, slots, i32, i32, i32, i32, i32, vp, i32, i32, vp]
    lib.fr_render_delta.restype = i32
    lib.fr_chain_smem_bytes.argtypes = [i32, i32, i32, i32, i32, i32]
    lib.fr_chain_smem_bytes.restype = ctypes.c_ulonglong
    for fn in (lib.fr_stage_bytes, lib.fr_max_ring):
        fn.argtypes = []
        fn.restype = i32
    lib.fr_point_smem_bytes.argtypes = [i32]
    lib.fr_point_smem_bytes.restype = ctypes.c_ulonglong
    lib.fr_point_mlp.argtypes = [vp, vp, vp, i32, i32, slots, i32, i32, i32,
                                 i32, vp, i32, i32, vp]
    lib.fr_point_mlp.restype = i32
    lib.fr_point_mlp_pe.argtypes = [vp, vp, vp, i32, i32, slots, i32, i32, vp,
                                    i32, i32, vp]
    lib.fr_point_mlp_pe.restype = i32
    lib.kd_chain.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.kd_chain.restype = i32
    lib.kd_ladder.argtypes = [vp, vp, vp, i32, i32, i32, slots, i32, i32,
                              vp, i32, i32, vp]
    lib.kd_ladder.restype = i32
    lib.kd_render_a.argtypes = [vp, vp, vp, i32, i32, i32, slots, i32, i32,
                                vp, i32, i32, vp]
    lib.kd_render_a.restype = i32
    lib.kd_render_b.argtypes = [vp, vp, vp, vp, i32, i32, i32, slots, i32, i32,
                                i32, i32, vp, i32, i32, vp]
    lib.kd_render_b.restype = i32
    for fn in (lib.kd_render_a_smem_bytes, lib.kd_render_b_smem_bytes):
        fn.argtypes = [i32, i32, i32]
        fn.restype = ctypes.c_ulonglong
    lib.kd_chain_config.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    lib.kd_chain_config.restype = i32
    i64 = ctypes.c_longlong
    # the gradient kernels' two passes, bf16 and f32 (the same arguments)
    for sfx in ("", "_f32"):
        getattr(lib, f"fr_grad_pass_a{sfx}_smem_bytes").argtypes = [i32, i32,
                                                                   i32]
        getattr(lib, f"fr_grad_pass_a{sfx}_smem_bytes").restype = (
            ctypes.c_ulonglong)
        getattr(lib, f"fr_grad_pass_b{sfx}_smem_bytes").argtypes = []
        getattr(lib, f"fr_grad_pass_b{sfx}_smem_bytes").restype = (
            ctypes.c_ulonglong)
        getattr(lib, f"fr_grad_pass_a{sfx}").argtypes = [
            vp, vp, vp, vp, ctypes.POINTER(i64), vp, i32, i32, slots, i32,
            i32, i32, i32, vp, i32, i32, vp]
        getattr(lib, f"fr_grad_pass_a{sfx}").restype = i32
        getattr(lib, f"fr_grad_pass_b{sfx}").argtypes = [
            vp, ctypes.POINTER(i64), vp, i32, vp, vp, i64, i32, i32,
            ctypes.POINTER(i64), i32, i32, vp]
        getattr(lib, f"fr_grad_pass_b{sfx}").restype = i32
    return lib
