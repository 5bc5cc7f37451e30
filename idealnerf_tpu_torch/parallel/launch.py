"""Start the ranks of a multi-device run.

The JAX package needs no processes: one process drives every device of
its mesh. Here ``launch`` spawns one process per rank of an ``n_data x
n_ray`` mesh (``torch.multiprocessing``, the spawn start method), joins
them through a ``file://`` rendezvous in a temporary directory (no TCP
port, so concurrent runs cannot collide) and calls ``fn(mesh, *args)`` on
every rank.

- Devices and backend: rank r takes ``cuda:(r % device_count)``. The
  backend is NCCL when every rank has a GPU of its own; when ranks share
  a GPU, gloo on CUDA tensors (NCCL refuses two ranks on one device), and
  the choice is logged once. ``device="cpu"`` gives gloo on the CPU.
  Nothing changes backend or device because an init failed.
- ``init_process_group`` gets a timeout, so a collective that hangs fails
  instead; ``timeout`` bounds the whole run, after which the ranks are
  terminated and ``TimeoutError`` raised. A rank that raises fails the
  launch with its traceback.
- The CUDA kernels are built in the calling process before the ranks
  start, so the ranks load one library instead of building it each. The
  ranks take the caller's float32 matmul precision and cuDNN TF32
  setting (process state a spawned process does not inherit), so they
  compute as the caller would.
- Each rank's return value comes back (``torch.save`` into the temporary
  directory, tensors mapped to the CPU), and the kernel launches the
  ranks made are added to this process's launch counters, so a caller
  counts a multi-rank run's launches as it counts its own.
"""

from __future__ import annotations

import datetime
import logging
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger("idealnerf.parallel")

# seconds a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT_S = 900


def device_count(device) -> int:
    """Devices of ``device``'s type a mesh can spread over: the GPUs, or
    one CPU."""
    return (torch.cuda.device_count() if torch.device(device).type == "cuda"
            else 1)


def mesh_shape(data_devices: int, ray_devices: int, device,
               fill: bool = True) -> Optional[Tuple[int, int]]:
    """The CLIs' ``--data_devices`` / ``--ray_devices`` -> (n_data,
    n_ray), or None when both are 0 (the single-device path). An axis
    left at 0 takes the devices the other leaves, at least 1, as the JAX
    CLIs' ``make_mesh`` over all devices does; ``fill=False`` sets it to
    1 (the JAX reenact CLI's rule)."""
    if not (data_devices or ray_devices):
        return None
    if fill:
        n = device_count(device)
        data_devices = data_devices or max(1, n // ray_devices)
        ray_devices = ray_devices or max(1, n // data_devices)
    return data_devices or 1, ray_devices or 1


def pick_backend(device, world: int) -> str:
    """NCCL when each of ``world`` ranks has a GPU of its own, else gloo
    (on CUDA tensors where ranks share a GPU, or on the CPU)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _launch_counters() -> Dict[str, Dict[str, int]]:
    from idealnerf_tpu_torch.kernels import (
        fused_mlp, fused_mlp_grad, fused_render,
    )

    return {"fused_render": fused_render.launch_counts,
            "fused_mlp": fused_mlp.launch_counts,
            "fused_mlp_grad": fused_mlp_grad.launch_counts}


def _rank_main(rank: int, world: int, n_data: int, n_ray: int,
               device_type: str, backend: str, init: str, out_dir: str,
               fn: Callable, args: Sequence, log_level: Optional[int],
               threads: int, precision: Tuple[str, bool]) -> None:
    import torch.distributed as dist

    from idealnerf_tpu_torch.parallel.mesh import make_mesh

    if log_level is not None:
        logging.basicConfig(level=log_level if rank == 0
                            else max(log_level, logging.WARNING))
    torch.set_float32_matmul_precision(precision[0])
    torch.backends.cudnn.allow_tf32 = precision[1]
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=init, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_mesh(n_data, n_ray, device=dev)
        result = fn(mesh, *args)
        counts = {k: dict(v) for k, v in _launch_counters().items()}
        torch.save({"result": result, "launches": counts},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_data: int, n_ray: int, device="cuda",
           args: Sequence = (), timeout: Optional[float] = None) -> List[Any]:
    """``fn(mesh, *args)`` on each rank of an ``n_data x n_ray`` mesh on
    ``device``'s type -> the ranks' return values, rank 0 first. ``fn``
    and ``args`` are pickled: ``fn`` is a module-level function."""
    import torch.multiprocessing as mp

    world = n_data * n_ray
    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh but no CUDA device is available")
        from idealnerf_tpu_torch.kernels import build

        build.build()
    backend = pick_backend(device, world)
    if device_type == "cuda" and backend == "gloo":
        logger.info("%d ranks share %d GPU(s): gloo on CUDA tensors (NCCL "
                    "refuses two ranks on one device)", world,
                    torch.cuda.device_count())
    logger.info("launching a %d x %d ('data', 'ray') mesh: %d ranks on %s, "
                "%s", n_data, n_ray, world, device_type, backend)
    out_dir = tempfile.mkdtemp(prefix="idealnerf_mesh_")
    root = logging.getLogger()
    log_level = root.level if root.handlers else None
    threads = max(1, torch.get_num_threads() // world)
    precision = (torch.get_float32_matmul_precision(),
                 torch.backends.cudnn.allow_tf32)
    try:
        ctx = mp.spawn(
            _rank_main, nprocs=world, join=False,
            args=(world, n_data, n_ray, device_type, backend,
                  "file://" + os.path.join(out_dir, "rendezvous"), out_dir,
                  fn, tuple(args), log_level, threads, precision))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10.0)
                raise TimeoutError(f"the {world} ranks did not finish "
                                   f"within {timeout} s")
        outs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    counters = _launch_counters()
    for out in outs:
        for mod, counts in out["launches"].items():
            for k, n in counts.items():
                counters[mod][k] += n
    return [out["result"] for out in outs]


def wait_for_ranks(mesh) -> None:
    """Return when every rank of the mesh has called this: an all-reduce
    of one element on the rank's device (the ranks meet in all-reduces
    only, which gloo runs on CUDA tensors too)."""
    import torch.distributed as dist

    dist.all_reduce(torch.zeros(1, device=mesh.device))


def main_first(mesh, fn: Callable) -> Any:
    """``fn()`` on rank 0 first, then on the other ranks: for work that
    fills a cache file the others then read (a depth band), so no two
    ranks write it at once. Without a mesh, ``fn()``."""
    if mesh is None:
        return fn()
    if mesh.is_main:
        out = fn()
        wait_for_ranks(mesh)
        return out
    wait_for_ranks(mesh)
    return fn()
