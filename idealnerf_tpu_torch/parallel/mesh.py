"""The ('data', 'ray') layout of a multi-device run (counterpart of
parallel/mesh.py).

The JAX package drives a GSPMD mesh from one process. Here every device
of the layout is one process, a rank of ``torch.distributed``
(``parallel.launch`` starts them); ``make_mesh`` names the layout of the
ranks: rank ``d * n_ray + r`` takes frame ``d`` of a step and the ``r``-th
share of that frame's rays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an ``n_data x n_ray`` layout of ranks."""

    n_data: int
    n_ray: int
    rank: int
    device: torch.device
    backend: str
    # the process group of this rank's row of ray ranks (one frame's);
    # None: the whole world (n_data == 1)
    ray_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "ray": self.n_ray}

    @property
    def size(self) -> int:
        return self.n_data * self.n_ray

    @property
    def data_index(self) -> int:
        return self.rank // self.n_ray

    @property
    def ray_index(self) -> int:
        return self.rank % self.n_ray

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, metrics and videos."""
        return self.rank == 0


def make_mesh(n_data: Optional[int] = None, n_ray: Optional[int] = None,
              device=None) -> Mesh:
    """The ('data', 'ray') mesh over the ranks of the initialised process
    group, for this rank's ``device``.

    Defaults as the JAX package's: all rays on one axis (n_data = 1,
    n_ray = the world); with one axis given the other takes the rest.
    ``n_data x n_ray`` must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "start the ranks with parallel.launch")
    n = dist.get_world_size()
    if n_data is None and n_ray is None:
        n_data, n_ray = 1, n
    elif n_data is None:
        n_data = n // n_ray
    elif n_ray is None:
        n_ray = n // n_data
    if n_data * n_ray != n:
        raise ValueError(f"mesh {n_data} x {n_ray} does not cover the "
                         f"{n} ranks")
    rank = dist.get_rank()
    ray_group = None
    if n_data > 1:
        # every rank creates every group, in the same order
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_ray, (d + 1) * n_ray)))
            if d == rank // n_ray:
                ray_group = g
    return Mesh(n_data=n_data, n_ray=n_ray, rank=rank,
                device=torch.device(device if device is not None else "cpu"),
                backend=dist.get_backend(), ray_group=ray_group)
