"""Where does a trained AudioAttNet put its attention? (counterpart of
scripts/audatt_peak.py)

The synthetic subject's mouth follows the centre frame's audio window, so
a converged smoothing regime peaks the attention over the smo_size
windows at the centre position (index smo_size // 2). Over a subject's
audio track this gives the mean attention over the window positions, the
share of windows whose argmax is the centre and the mean centre weight:
the evidence to read when val PSNR stalls after the AudioNet ->
AudioAttNet switch (the reference gives that regime 100k+ steps).

Each interior frame i (smo_size // 2 <= i < frames - smo_size // 2) takes
the window of AudioNet features i - smo_size // 2 ... as the smoothing
does; the attention is the softmax ``models.audio_net.AudioAttNet.
attention`` computes.

    python -m idealnerf_tpu_torch.scripts.audatt_peak --ckpt <head ckpt> \\
        --subject <dir with aud.npy> [--config <HeadNeRF_config.txt>] \\
        [config flags] [--out PATH]

``--config`` defaults to ``<subject>/HeadNeRF_config.txt`` where it
exists; config flags (``--dim_aud 64`` ...) override it, as in the
port's CLIs.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, load_head, resolve_config,
)
from idealnerf_tpu_torch.scripts import device_of, timing


@torch.no_grad()
def attention_weights(params, auds: np.ndarray, smo_size: int,
                      device) -> np.ndarray:
    """(frames - 2 (smo_size // 2), smo_size) attention weights of the
    interior frames of the (frames, 16, 29) windows ``auds``."""
    feats = params["aud_net"](torch.from_numpy(
        np.asarray(auds, np.float32)).to(device))
    half, m = smo_size // 2, feats.shape[0]
    idx = (torch.arange(half, m - half, device=device)[:, None] - half
           + torch.arange(smo_size, device=device)[None])
    return params["aud_att"].attention(feats[idx]).cpu().numpy()


def main(argv=None) -> dict:
    p = build_parser(__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="head checkpoint directory written by train_head")
    p.add_argument("--subject", required=True,
                   help="subject directory holding aud.npy")
    timing.add_common(p, "output json path", smoke=False)
    args = p.parse_args(argv)
    cfg_file = os.path.join(args.subject, "HeadNeRF_config.txt")
    if args.config is None and os.path.exists(cfg_file):
        args.config = cfg_file
    cfg = resolve_config(args)
    dev = device_of(args.device)
    state = load_head(argparse.Namespace(seed=0, head_ckpt=args.ckpt), cfg, 1)
    params = state.params.to(dev)
    auds = np.load(os.path.join(args.subject, cfg.aud_file))
    if len(auds) <= 2 * (cfg.smo_size // 2):
        raise ValueError(f"{len(auds)} audio windows hold no interior frame "
                         f"of a {cfg.smo_size}-frame smoothing window")
    w = attention_weights(params, auds, cfg.smo_size, dev)
    half = cfg.smo_size // 2
    out = {
        "ckpt": args.ckpt,
        "step": int(state.step),
        "smo_size": int(cfg.smo_size),
        "center_index": int(half),
        "mean_attention_by_position": [float(x) for x in w.mean(0)],
        "argmax_at_center_fraction": float((w.argmax(1) == half).mean()),
        "mean_center_weight": float(w[:, half].mean()),
        "uniform_weight": 1.0 / cfg.smo_size,
        "frames": int(w.shape[0]),
        **timing.device_fields(dev),
    }
    timing.write_json(args.out, out)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
