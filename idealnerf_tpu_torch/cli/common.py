"""Shared CLI plumbing (counterpart of cli/common.py): every
ExperimentConfig field becomes a flag, plus dataset resolution (a
procedural subject with ``--synthetic N``, else the reference-format
directory ``--datadir``) and the metrics stream."""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Optional

import torch

from idealnerf_tpu_torch.ckpt import CheckpointManager
from idealnerf_tpu_torch.config import ExperimentConfig
from idealnerf_tpu_torch.data.dataset import (
    FrameDataset, load_transforms_dataset,
)
from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset
from idealnerf_tpu_torch.train.state import ModelState, init_params
from idealnerf_tpu_torch.train.torso import init_torso_params
from idealnerf_tpu_torch.utils.summary import SummaryWriter

logger = logging.getLogger("idealnerf.cli")


def build_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=None,
                        help="reference-style key=value config file")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="use an N-frame procedural synthetic dataset")
    parser.add_argument("--synthetic_hw", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=None,
                        help="override N_iters epochs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt_dir", type=str, default=None)
    for f in dataclasses.fields(ExperimentConfig):
        if f.type in ("int", int):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        elif f.type in ("float", float):
            parser.add_argument(f"--{f.name}", type=float, default=None)
        elif f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=None)
    return parser


def resolve_device(name: str) -> torch.device:
    """The ``--device`` of a CLI; cuda where no CUDA device is available
    raises (no CPU fallback)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available")
    return device


def resolve_config(args) -> ExperimentConfig:
    overrides = {}
    for f in dataclasses.fields(ExperimentConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = bool(v) if f.type in ("bool", bool) else v
    if args.config:
        return ExperimentConfig.from_file(args.config, **overrides)
    return ExperimentConfig(**overrides)


def resolve_dataset(args, cfg: ExperimentConfig, mode: str = "train",
                    gt_dirs: Optional[str] = None) -> FrameDataset:
    if args.synthetic:
        return make_synthetic_dataset(
            n_frames=args.synthetic, H=args.synthetic_hw, W=args.synthetic_hw,
            dim_expr=max(cfg.dim_expr, 1),
            with_torso=(gt_dirs == "com_imgs"),
        )
    return load_transforms_dataset(
        cfg.datadir, mode=mode, aud_file=cfg.aud_file,
        gt_dirs=gt_dirs or cfg.gt_dirs, near=cfg.near, far=cfg.far)


def make_summary(cfg: ExperimentConfig, default_dir: str) -> SummaryWriter:
    """The run's metrics writer, in ``vis_path`` or else ``default_dir``."""
    return SummaryWriter(cfg.vis_path or default_dir)


def load_head(args, cfg: ExperimentConfig, data_size: int) -> ModelState:
    """The head model of an eval or torso run, on the host: restored from
    ``--head_ckpt`` (params, latent table and step; the table is sized to
    the head's training set), else drawn from ``--seed`` with a warning.
    Weights are drawn on the host so a seed gives the same model on every
    device."""
    state = init_params(cfg, data_size,
                        torch.Generator().manual_seed(args.seed))
    if not args.head_ckpt:
        logger.warning("no --head_ckpt: fresh head weights (dry run)")
        return state
    ck = CheckpointManager(args.head_ckpt).restore()
    state.params.load_state_dict(ck["params"])
    state = state._replace(step=int(ck["step"]),
                           latent_codes=ck["latent_codes"])
    logger.info("head from %s at step %d", args.head_ckpt, state.step)
    return state


def load_torso(torso_ckpt: Optional[str], cfg: ExperimentConfig, device):
    """The torso nets restored from a ``train_torso`` checkpoint directory
    onto ``device``, or None without one."""
    if not torso_ckpt:
        return None
    torso = init_torso_params(cfg)
    torso.load_state_dict(CheckpointManager(torso_ckpt).restore()
                          ["torso_params"])
    return torso.to(device)
