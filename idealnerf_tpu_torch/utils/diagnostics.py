"""Numerical diagnostics and profiling (counterpart of
utils/diagnostics.py).

- ``finite_check``: 1.0 iff every floating tensor given is finite, over
  a tensor, a nested container of tensors or a module's parameters.
- ``profile``: context manager around a ``torch.profiler`` trace of the
  CPU and, where there is one, the CUDA device, exported as a Chrome
  trace into the log directory.
- ``StepTimer``: per-step wall clock with a warm-up skip; ``tick(sync)``
  waits for the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


def _floating(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _floating(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _floating(v)


def finite_check(tree) -> torch.Tensor:
    """A 0-d f32 tensor: 1.0 iff every floating leaf of ``tree`` is finite
    (no host sync; read it with ``float``)."""
    oks = [torch.isfinite(t).all() for t in _floating(tree)
           if t.is_floating_point()]
    if not oks:
        return torch.ones(())
    return torch.stack(oks).float().prod()


@contextlib.contextmanager
def profile(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block into ``<logdir>/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._n = 0
        self._t0 = None
        self._steps = 0

    def tick(self, sync=None) -> Dict[str, float]:
        """Call once per step; pass the step's device (or a tensor on it)
        to wait for its work before reading the clock."""
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) else \
                torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._n += 1
        if self._n == self.warmup:
            self._t0 = time.perf_counter()
            self._steps = 0
        elif self._n > self.warmup:
            self._steps += 1
        if self._t0 is None or self._steps == 0:
            return {}
        dt = time.perf_counter() - self._t0
        return {"steps_per_sec": self._steps / dt,
                "ms_per_step": 1000.0 * dt / self._steps}
