"""Step-numbered checkpoints with the reference's resume semantics
(counterpart of ckpt/manager.py), stored as torch files.

``save(step, tree)`` writes ``step_{step:010d}.pt`` under the directory
(a dict of tensors, numbers and nested dicts/lists, e.g. a state_dict),
keeps the newest ``max_to_keep``, and ``restore`` loads the newest.
``restore_partial`` is the fine-tune surgery: entries whose path or shape
differ from a freshly initialised target keep the fresh value, so changing
the conditioning dims keeps the fresh init of exactly the conditioned
layers (audio_exp_nerf.py:498-514 in the reference).

The JAX package writes orbax directories ``step_{step:010d}/``; reading
them is not ported yet (ROADMAP.md A6), and a directory that holds only
those raises NotImplementedError.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_NOT_PORTED = ("orbax checkpoints of the JAX package are not readable yet "
               "(ROADMAP.md A6: orbax checkpoint reading)")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def partial_restore(restored: Any, like: Any) -> Tuple[Any, List[str]]:
    """Merge ``restored`` into ``like``: leaves with matching path and
    shape come from the checkpoint (in ``like``'s dtype and device), the
    rest keep ``like``'s value. -> (merged, dropped paths)."""
    got = dict(_flatten(restored))
    dropped = []

    def rebuild(tree, prefix=()):
        if isinstance(tree, dict):
            return type(tree)((k, rebuild(v, prefix + (str(k),)))
                              for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        r = got.get(prefix)
        name = "/".join(prefix)
        if r is None:
            dropped.append(f"{name} (missing in ckpt)")
            return tree
        if _shape(r) != _shape(tree):
            dropped.append(f"{name} (shape {_shape(r)} != {_shape(tree)})")
            return tree
        if isinstance(tree, torch.Tensor):
            return r.to(dtype=tree.dtype, device=tree.device)
        return r

    return rebuild(like), dropped


class CheckpointManager:
    """Step-numbered checkpoints under ``directory``, newest-first resume."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}.pt")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)\.pt", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Dict[str, Any]) -> str:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return path

    def restore(self, step: Optional[int] = None,
                map_location="cpu") -> Dict[str, Any]:
        """The checkpoint at ``step`` (default: the newest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            if any(re.fullmatch(r"step_\d+", n)
                   and os.path.isdir(os.path.join(self.directory, n))
                   for n in os.listdir(self.directory)):
                raise NotImplementedError(
                    f"{self.directory} holds {_NOT_PORTED}")
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def restore_partial(self, like: Any,
                        step: Optional[int] = None) -> Tuple[Any, List[str]]:
        """The checkpoint merged into ``like`` with shape-mismatch surgery
        (see partial_restore)."""
        return partial_restore(self.restore(step), like)
