"""Multi-device trainers behind the CLIs' ``--data_devices`` /
``--ray_devices`` (counterpart of parallel/trainers.py).

Each rank of the mesh runs one of these. Frames of a step go over the
'data' axis (one frame a data rank, in order: ``start .. start + batch``
modulo the dataset), each frame's rays over 'ray'
(``parallel.sharded``); parameters and optimizer state are replicated and
stay equal, since every rank applies the same all-reduced gradients.
The API is the single-device ``HeadTrainer`` / ``TorsoTrainer``'s
(``run`` / ``save`` / ``global_step``), with their initialisation, the
nosmo_iters and precrop switches, resume and checkpoint layout: every
rank restores, only rank 0 writes.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np

from idealnerf_tpu_torch.parallel.sharded import (
    make_sharded_torso_train_step, make_sharded_train_step,
)
from idealnerf_tpu_torch.train.head import HeadTrainer
from idealnerf_tpu_torch.train.torso import TorsoTrainer

logger = logging.getLogger("idealnerf.parallel")


def _check_divisible(cfg, mesh) -> None:
    if cfg.N_rand % mesh.n_ray:
        raise ValueError(f"N_rand={cfg.N_rand} must divide by the ray axis "
                         f"({mesh.n_ray})")


def _rate(step: int, s0: int, t0: float) -> float:
    return (step - s0) / max(time.perf_counter() - t0, 1e-9)


class ShardedHeadTrainer(HeadTrainer):
    """Data + ray parallel head training: a batch of one frame per 'data'
    rank a step, each frame's rays over 'ray'. On a mesh of one rank it
    trains as ``HeadTrainer`` does, draw for draw."""

    def __init__(self, cfg, dataset, mesh, seed: int = 0,
                 ckpt_dir: Optional[str] = None, resume: bool = True,
                 remat: bool = False):
        _check_divisible(cfg, mesh)
        self.mesh = mesh
        self.batch = mesh.n_data
        self.remat = remat
        super().__init__(cfg, dataset, seed=seed, ckpt_dir=ckpt_dir,
                         resume=resume, device=mesh.device)

    def save(self):
        if self.mesh.is_main:
            super().save()

    def _step_fn(self, smooth: bool, precrop: bool = False):
        key = (smooth, precrop)
        if key not in self._steps:
            self._steps[key] = make_sharded_train_step(
                self.cfg, self.dataset, self.mesh, smooth_audio=smooth,
                remat=self.remat, precrop=precrop)
        return self._steps[key]

    def run(self, n_epochs: Optional[int] = None,
            log_every: Optional[int] = None,
            on_metrics=None) -> Dict[str, float]:
        n_epochs = self.cfg.N_iters if n_epochs is None else n_epochs
        log_every = self.cfg.i_print if log_every is None else log_every
        size = self.dataset.size
        metrics = {}
        t0 = t_log = time.perf_counter()
        s0 = s_log = self.global_step  # rates exclude restored steps
        for epoch in range(n_epochs):
            for start in range(0, size, self.batch):
                idx = np.arange(start, start + self.batch) % size
                step = self.global_step
                smooth = self.cfg.dim_aud > 29 and step >= self.cfg.nosmo_iters
                precrop = step < self.cfg.precrop_iters
                m = self._step_fn(smooth, precrop)(
                    self.state, self.data, idx.tolist(), self.generator)
                step += 1
                if step % log_every == 0:
                    metrics = {k: float(v) for k, v in m.items()}
                    metrics["steps_per_sec"] = _rate(step, s0, t0)
                    metrics["steps_per_sec_rolling"] = _rate(step, s_log,
                                                             t_log)
                    t_log, s_log = time.perf_counter(), step
                    metrics["frames_per_step"] = float(self.batch)
                    if on_metrics is not None:
                        on_metrics(step, metrics)
                    else:
                        logger.info("[TRAIN] epoch %d step %d loss %.5f psnr "
                                    "%.2f lr %.2e", epoch, step,
                                    metrics["loss"], metrics["psnr"],
                                    metrics["lr"])
                if self.ckpt is not None and step % self.cfg.i_weights == 0:
                    self.save()
        return metrics


class ShardedTorsoTrainer(TorsoTrainer):
    """Data + ray parallel torso training against a frozen head that every
    rank holds (``train.torso`` semantics: only the torso learns)."""

    def __init__(self, cfg, dataset, head_params, mesh, latent_codes=None,
                 seed: int = 0, smooth_audio: bool = True,
                 ckpt_dir: Optional[str] = None, resume: bool = True,
                 remat: bool = False):
        _check_divisible(cfg, mesh)
        self.mesh = mesh
        self.batch = mesh.n_data
        super().__init__(cfg, dataset, head_params,
                         latent_codes=latent_codes, seed=seed,
                         smooth_audio=smooth_audio, ckpt_dir=ckpt_dir,
                         resume=resume, device=mesh.device)
        self._step_fn = make_sharded_torso_train_step(
            cfg, dataset, mesh, smooth_audio=smooth_audio, remat=remat)

    def save(self):
        if self.mesh.is_main:
            super().save()

    def run(self, n_steps: int, log_every: int = 50,
            on_metrics=None) -> Dict[str, float]:
        """``n_steps`` steps of one frame a data rank; the steps whose
        count of earlier updates is a multiple of ``log_every`` report."""
        metrics = {}
        t_log, s_log = time.perf_counter(), self.step
        size = self.dataset.size
        for _ in range(n_steps):
            step = self.step
            idx = (step * self.batch + np.arange(self.batch)) % size
            m = self._step_fn(self.state, self.head_params,
                              self.latent_codes, self.data, idx.tolist(),
                              self.generator)
            if step % log_every == 0:
                metrics = {k: float(v) for k, v in m.items()}
                metrics["steps_per_sec_rolling"] = _rate(self.step, s_log,
                                                         t_log)
                t_log, s_log = time.perf_counter(), self.step
                metrics["frames_per_step"] = float(self.batch)
                if on_metrics is not None:
                    on_metrics(step, metrics)
                else:
                    logger.info("[TORSO] step %d loss %.5f psnr %.2f", step,
                                metrics["loss"], metrics["psnr"])
        return metrics
