#!/usr/bin/env python3
"""Convert the JAX package's orbax checkpoints into the port's torch ones.

    python orbax_to_torch.py --src <JAX ckpt dir> --dst <port ckpt dir> \\
        [--config <subject>/HeadNeRF_config.txt] [config flags] [--step N]

Reads every ``step_{step:010d}/`` directory under ``--src`` (or the one
of ``--step``) through the JAX package's own
``CheckpointManager.restore_raw`` and writes the ``step_{step:010d}.pt``
file that ``idealnerf_tpu_torch.ckpt.CheckpointManager.restore`` reads,
one per step, under ``--dst``. The model configuration (``--config`` and
any ExperimentConfig flag, as the port's CLIs take them) must be the one
the checkpoint was trained with: every leaf is checked against the port's
tree for it.

- A head checkpoint (``train/head.py``'s ``TrainState``: step, params,
  latent codes and the Adam state) becomes ``{"step", "params",
  "latent_codes", "optimizer"}``, what ``train.head.HeadTrainer`` resumes
  from and ``cli.common.load_head`` renders from. The Adam moments carry
  over in either optimizer layout of the JAX package (one flat vector,
  ``flat_optimizer``, or one per leaf), with their step count. A variant
  head (``--model_variant face_nerf_agg`` or ``attention_nerf``) carries
  its ``agg`` or ``self_att`` leaves and their moments too.
- A torso checkpoint (``train/torso.py``'s ``{"torso_params",
  "opt_state", "step"}``) becomes the same keys in the port's layout,
  what ``train.torso.TorsoTrainer`` resumes from and
  ``cli.common.load_torso`` renders from.

The JAX trainers save no random key, so the files carry no generator
state: a run resumed from one draws its rays from its own seed. A leaf
with no counterpart in the port raises, naming its path; nothing is
dropped. The script imports jax, orbax and both packages, so it runs
where those are installed, not on the card's machine; the port never
imports it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _leaves(tree, prefix=()) -> Dict[str, Any]:
    """{"a/b/0/w": leaf} of a tree of dicts, lists and arrays."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree, key=str):
            out.update(_leaves(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _check_tree(got, want, where: str) -> None:
    """Raise, naming the path, where ``got`` has a leaf ``want`` lacks,
    lacks one it has, or holds one of another shape."""
    g, w = _leaves(got), _leaves(want)
    extra = sorted(set(g) - set(w))
    if extra:
        raise ValueError(f"{where}/{extra[0]}: no counterpart in the port's "
                         f"tree for this config ({len(extra)} such leaves)")
    missing = sorted(set(w) - set(g))
    if missing:
        raise ValueError(f"{where}/{missing[0]}: missing from the checkpoint "
                         f"({len(missing)} such leaves)")
    for k in sorted(g):
        if np.shape(g[k]) != np.shape(w[k]):
            raise ValueError(f"{where}/{k}: shape {np.shape(g[k])}, the "
                             f"port's is {np.shape(w[k])}")


def _check_keys(raw: dict, keys, where: str) -> None:
    extra = sorted(set(raw) - set(keys), key=str)
    if extra:
        raise ValueError(f"{where}/{extra[0]}: no counterpart in the port's "
                         "checkpoint")
    missing = sorted(set(keys) - set(raw))
    if missing:
        raise ValueError(f"{where}/{missing[0]}: missing from the checkpoint")


def _numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _adam_moments(opt_state, diff, where: str):
    """(count, mu, nu) of an optax adam state (``[ScaleByAdamState,
    ScaleByScheduleState]``, as orbax restores it) over the tree
    ``diff``; a flat mu/nu (``optax.flatten``) is unravelled in
    ``ravel_pytree``'s order, the order it was flattened in."""
    from jax.flatten_util import ravel_pytree

    if not (isinstance(opt_state, (list, tuple)) and len(opt_state) == 2):
        raise ValueError(f"{where}: not an adam state with a schedule "
                         f"({type(opt_state).__name__})")
    adam, sched = opt_state
    _check_keys(adam, ("count", "mu", "nu"), f"{where}/0")
    _check_keys(sched, ("count",), f"{where}/1")
    count = int(np.asarray(adam["count"]))
    if int(np.asarray(sched["count"])) != count:
        raise ValueError(f"{where}: adam count {count} and schedule count "
                         f"{int(np.asarray(sched['count']))} differ; the "
                         "port keeps one step count")
    flat, unravel = ravel_pytree(diff)
    moments = []
    for name in ("mu", "nu"):
        m = adam[name]
        if isinstance(m, (dict, list, tuple)):
            _check_tree(m, diff, f"{where}/0/{name}")
        else:
            if np.shape(m) != np.shape(flat):
                raise ValueError(f"{where}/0/{name}: flat vector of shape "
                                 f"{np.shape(m)}, the parameters' is "
                                 f"{np.shape(flat)}")
            m = unravel(np.asarray(m))
        moments.append(_numpy(m))
    return count, moments[0], moments[1]


def _adam_state_dict(optimizer, params: List, count: int, mus: List,
                     nus: List) -> dict:
    """The port optimizer's state_dict with every parameter's moments and
    the shared step count set."""
    import torch

    for p, mu, nu in zip(params, mus, nus, strict=True):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu, np.float32)).reshape(
                p.shape),
            "exp_avg_sq": torch.from_numpy(np.array(nu, np.float32)).reshape(
                p.shape)}
    return optimizer.state_dict()


def _step_of(raw: dict, count: int, where: str) -> int:
    step = int(np.asarray(raw["step"]))
    if step != count:
        raise ValueError(f"{where}/step {step} differs from the adam count "
                         f"{count}")
    return step


def convert_head(raw: dict, cfg) -> dict:
    """A restored JAX head ``TrainState`` (``restore_raw``) -> the port's
    head checkpoint for ``cfg`` (the port's ExperimentConfig)."""
    from idealnerf_tpu_torch import bridge
    from idealnerf_tpu_torch.train.state import init_params

    _check_keys(raw, ("step", "params", "latent_codes", "opt_state"), "head")
    params, latent = _numpy(raw["params"]), np.asarray(raw["latent_codes"])
    _check_tree(params, bridge.params_to_jax(init_params(cfg, 1).params),
                "head/params")
    if latent.ndim != 2 or latent.shape[1] != max(cfg.dim_latent, 1):
        raise ValueError(f"head/latent_codes: shape {latent.shape}, the "
                         f"port's is (frames, {max(cfg.dim_latent, 1)})")
    count, mu, nu = _adam_moments(raw["opt_state"], (params, latent),
                                  "head/opt_state")
    state = bridge.train_state_from_jax(params, latent, cfg)
    state.step = _step_of(raw, count, "head")

    def per_param(m):
        tree, lat = m
        return [*(x.detach().numpy() for x in
                  bridge.params_from_jax(tree, cfg).parameters()), lat]

    opt = _adam_state_dict(state.optimizer, state.trainable(), count,
                           per_param(mu), per_param(nu))
    return {"step": state.step, "params": state.params.state_dict(),
            "latent_codes": state.latent_codes.detach(), "optimizer": opt}


def convert_torso(raw: dict, cfg) -> dict:
    """A restored JAX torso checkpoint (``TorsoTrainer.save``'s dict) ->
    the port's torso checkpoint for ``cfg``."""
    from idealnerf_tpu_torch import bridge
    from idealnerf_tpu_torch.train.torso import (
        init_torso_params, make_torso_optimizer,
    )

    _check_keys(raw, ("step", "torso_params", "opt_state"), "torso")
    params = _numpy(raw["torso_params"])
    _check_tree(params, bridge.torso_params_to_jax(init_torso_params(cfg)),
                "torso/torso_params")
    count, mu, nu = _adam_moments(raw["opt_state"], params, "torso/opt_state")
    torso = bridge.torso_params_from_jax(params, cfg)
    opt = make_torso_optimizer(cfg, torso)

    def per_param(m):
        return [x.detach().numpy() for x in
                bridge.torso_params_from_jax(m, cfg).parameters()]

    return {"torso_params": torso.state_dict(),
            "opt_state": _adam_state_dict(opt, list(torso.parameters()),
                                          count, per_param(mu), per_param(nu)),
            "step": _step_of(raw, count, "torso")}


def convert_raw(raw: dict, cfg) -> dict:
    """A restored JAX checkpoint of either trainer -> the port's."""
    if isinstance(raw, dict) and "params" in raw:
        return convert_head(raw, cfg)
    if isinstance(raw, dict) and "torso_params" in raw:
        return convert_torso(raw, cfg)
    raise ValueError("neither a head TrainState (params) nor a torso "
                     "checkpoint (torso_params): keys "
                     f"{sorted(raw) if isinstance(raw, dict) else type(raw)}")


def convert_dir(src: str, dst: str, cfg, step=None) -> List[int]:
    """Every step under the JAX checkpoint directory ``src`` (or ``step``)
    converted into ``dst`` -> the steps written."""
    from idealnerf_tpu.ckpt import CheckpointManager as JaxManager
    from idealnerf_tpu_torch.ckpt import CheckpointManager

    jm = JaxManager(src)
    steps = [step] if step is not None else jm.all_steps()
    if not steps:
        raise FileNotFoundError(f"no orbax checkpoints under {src}")
    out = CheckpointManager(dst, max_to_keep=max(len(steps), 1))
    for s in steps:
        out.save(s, convert_raw(jm.restore_raw(s), cfg))
    return steps


def main(argv=None) -> List[int]:
    from idealnerf_tpu_torch.cli.common import build_parser, resolve_config

    p = build_parser(__doc__.split("\n")[0])
    p.add_argument("--src", required=True,
                   help="the JAX checkpoint directory (step_*/ inside)")
    p.add_argument("--dst", required=True,
                   help="the port's checkpoint directory to write")
    p.add_argument("--step", type=int, default=None,
                   help="convert this step only (default: every step)")
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    steps = convert_dir(args.src, args.dst, resolve_config(args), args.step)
    print(f"converted steps {steps} of {args.src} into {args.dst}")
    return steps


if __name__ == "__main__":
    main()
