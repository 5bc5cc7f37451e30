"""Experiment observability (counterpart of utils/summary.py): the
reference's TensorBoard scalars (train/loss, train/psnr, train/lr,
train/latent_loss) and val image panels.

Always writes a JSONL metrics stream, ``<logdir>/metrics.jsonl``, one
record per call: ``step``, ``time`` and ``<prefix>/<name>`` for each
scalar. TensorBoard events are written as well where
``torch.utils.tensorboard`` imports; which of the two holds is logged once.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np

logger = logging.getLogger("idealnerf.summary")


class SummaryWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter as TBWriter
            except ImportError as exc:
                logger.info("metrics.jsonl only in %s (no TensorBoard: %s)",
                            logdir, exc)
            else:
                self._tb = TBWriter(logdir)
                logger.info("metrics.jsonl and TensorBoard events in %s",
                            logdir)

    def scalars(self, step: int, values: Dict[str, float],
                prefix: str = "train") -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({f"{prefix}/{k}": float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v),
                                    global_step=step)

    def image(self, step: int, tag: str, img: np.ndarray) -> str:
        """img (H, W, 3) float in [0, 1]; saved as a .jpg (data/jpeg.py)
        and a TensorBoard image panel. -> the .jpg path."""
        from idealnerf_tpu_torch.data.jpeg import write_jpeg

        img8 = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
        path = os.path.join(self.logdir,
                            f"{tag.replace('/', '_')}_{step:08d}.jpg")
        write_jpeg(path, img8)
        if self._tb is not None:
            self._tb.add_image(tag, img8.transpose(2, 0, 1), global_step=step)
        return path

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
