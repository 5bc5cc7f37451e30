"""Build and load the CUDA kernels of this package.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` into
a shared library with a plain C interface, loaded through ctypes: one
``nvcc -c`` per ``.cu`` file, all started together, then one link. The
fused kernels are templates over the net's width; each width's instances
are a translation unit of their own (``csrc/fused_*_w<W>.cu``), so the
widths compile in parallel too. The
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
        out = open(obj.with_suffix(".txt"), "w+")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=out,
                                           stderr=subprocess.STDOUT),
                     out))
    # each translation unit's seconds, as they finish
    secs, logs, failed = {}, [], []
    while len(secs) < len(jobs):
        for obj, proc, _ in jobs:
            if obj not in secs and proc.poll() is not None:
                secs[obj] = time.perf_counter() - t0
        time.sleep(0.05)
    for obj, proc, out in jobs:
        out.seek(0)
        logs.append(out.read())
        out.close()
        obj.with_suffix(".txt").unlink()
        if proc.returncode != 0:
            failed.append(proc.returncode)
    logs.append("nvcc seconds per translation unit: " + ", ".join(
        f"{obj.stem.split('.')[-1]} {t:.1f}" for obj, t in sorted(
            secs.items(), key=lambda kv: kv[1])) + "\n")
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *[str(o) for o, _, _ in jobs]],
            capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(link.returncode)
    for obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return {"path": str(so), "seconds": seconds, "log": log}


# the kernels' instances, one translation unit each per source
# (csrc/fused_*_w<W>.cu): their entries end in _w<W>
WIDTHS = (128, 256, 512)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its argtypes.
    The entries of the kernels' instance at the paper width (W=256) also
    answer to their names without the width: the A/B scripts call them so
    in this checkout and in parent checkouts built before the widths."""
    lib = ctypes.CDLL(build()["path"])
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64, u64 = ctypes.c_longlong, ctypes.c_ulonglong
    slots = ctypes.POINTER(ctypes.c_ulonglong)
    lib.fr_num_slots.argtypes = []
    lib.fr_num_slots.restype = i32
    lib.fr_error_string.argtypes = [i32]
    lib.fr_error_string.restype = ctypes.c_char_p
    for fn in (lib.fr_stage_bytes, lib.fr_max_ring):
        fn.argtypes = []
        fn.restype = i32
    pass_a = [vp, vp, vp, vp, ctypes.POINTER(i64), vp, i32, i32, slots, i32,
              i32, i32, i32, vp, i32, i32, vp]
    pass_b = [vp, ctypes.POINTER(i64), vp, i32, vp, vp, i64, i32, i32,
              ctypes.POINTER(i64), i32, i32, vp]
    # name -> (argtypes, restype) of every width's entries
    entries = {
        "fr_render_rays": ([vp, vp, vp, vp, vp, vp, i32, i32, i32, slots,
                            i32, i32, i32, i32, i32, vp, i32, i32, vp], i32),
        "fr_coarse_hier": ([vp, vp, vp, f32, f32, vp, vp, vp, i32, i32, i32,
                            i32, slots, i32, i32, i32, i32, i32, vp, i32,
                            i32, vp], i32),
        "fr_render_delta": ([vp, vp, vp, vp, vp, vp, vp, f32, f32, f32, vp,
                             vp, vp, i32, i32, i32, i32, i32, slots, i32,
                             i32, i32, i32, i32, vp, i32, i32, vp], i32),
        "fr_chain_smem_bytes": ([i32] * 6, u64),
        "fr_point_smem_bytes": ([i32], u64),
        "fr_point_mlp": ([vp, vp, vp, i32, i32, slots, i32, i32, i32, i32,
                          vp, i32, i32, vp], i32),
        "fr_point_mlp_pe": ([vp, vp, vp, i32, i32, slots, i32, i32, vp, i32,
                             i32, vp], i32),
        # the gradient kernels' two passes, bf16 and f32 (the same
        # arguments)
        "fr_grad_pass_a_smem_bytes": ([i32, i32, i32], u64),
        "fr_grad_pass_a_f32_smem_bytes": ([i32, i32, i32], u64),
        "fr_grad_pass_b_smem_bytes": ([], u64),
        "fr_grad_pass_b_f32_smem_bytes": ([], u64),
        "fr_grad_max_tasks": ([], i32),
        "fr_grad_pass_a": (pass_a, i32),
        "fr_grad_pass_a_f32": (pass_a, i32),
        "fr_grad_pass_b": (pass_b, i32),
        "fr_grad_pass_b_f32": (pass_b, i32),
    }
    for name, (args, res) in entries.items():
        for w in WIDTHS:
            fn = getattr(lib, f"{name}_w{w}")
            fn.argtypes, fn.restype = args, res
        setattr(lib, name, getattr(lib, f"{name}_w256"))
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
    return lib
