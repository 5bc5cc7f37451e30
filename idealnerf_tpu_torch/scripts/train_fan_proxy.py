"""Train a FAN proxy on the synthetic subject's known landmarks
(counterpart of scripts/train_fan_proxy.py).

Released 2DFAN-4 weights are not bundled, so a random FAN's landmark loss
carries no landmark signal. The synthetic subject's .lms landmarks are
known (the exporter wrote them), so the port's FAN (``pipeline.fan``) is
trained on them here: square face-rect crops resized to ``--crop_size``²,
each stack regressing Gaussian heatmaps of the landmarks (intermediate
supervision, Bulat & Tzimiropoulos ICCV'17). The result plugs into
``cli.train_second_stage --fan_npz`` and ``scripts.rehearsal_2nd``.

    python -m idealnerf_tpu_torch.scripts.train_fan_proxy \\
        --out <subject dir> [--steps 300] [--batch 2] [--device cuda]

As the JAX script: the FAN is ``init_fan(1)`` with its conv kernels
rescaled until the raw outputs are O(10) (a random stack grows its
activations about 2x per residual block), its ``l{i}`` heads zeroed, and
Adam after clipping the global gradient norm at 1.0 (optax's rule: scale
by 1 / norm, not ``clip_grad_norm_``'s 1 / (norm + 1e-6)); every tensor of
the dict trains, the batch norms' statistics too. It writes
``<out>/fan_proxy.npz`` (the torch names, which the JAX ``--fan_npz``
reads too) and ``<out>/fan_proxy.json`` (the landmark error in heatmap
pixels before and after, the loss trajectory, the device). ``--smoke``:
a CPU-sized run (a one-stack FAN, crop 64, 4 steps, batch 1, 4 frames),
writing a 4-frame subject into ``--out`` first where it holds none.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from idealnerf_tpu_torch.scripts import device_of, timing


def _smoke_subject(out: str) -> None:
    from idealnerf_tpu_torch.data.export import write_reference_format
    from idealnerf_tpu_torch.data.synthetic import make_synthetic_dataset

    if not os.path.exists(os.path.join(out, "HeadNeRF_config.txt")):
        write_reference_format(make_synthetic_dataset(
            n_frames=4, H=66, W=66, dim_expr=8, seed=3), out,
            subject="rehearsal")


def face_crops(ds, crop_size: int, dev):
    """Square face-rect crops of every frame resized to crop_size²
    (N, C, C, 3) on ``dev``, and their landmarks in heatmap pixels
    (N, 68, 2)."""
    from idealnerf_tpu_torch.pipeline.fan import resize_linear

    H, W = ds.hw
    hm = crop_size // 4
    crops, lms = [], []
    for i in range(ds.size):
        x, y, w, h = [int(v) for v in ds.face_rects[i]]
        side = max(w, h)
        x0 = int(np.clip(x + w // 2 - side // 2, 0, max(W - side, 0)))
        y0 = int(np.clip(y + h // 2 - side // 2, 0, max(H - side, 0)))
        side = min(side, W - x0, H - y0)
        crop = torch.from_numpy(ds.images[i, y0:y0 + side, x0:x0 + side]
                                .astype(np.float32) / 255.0).to(dev)
        crops.append(resize_linear(crop, (crop_size, crop_size)))
        lms.append(((ds.landmarks[i] - np.array([x0, y0])) * (hm / side))
                   .astype(np.float32))
    return torch.stack(crops), torch.from_numpy(np.stack(lms)).to(dev)


def gauss_maps(lms: torch.Tensor, hm: int, sigma: float) -> torch.Tensor:
    """(N, 68, 2) landmarks -> (N, 68, hm, hm) Gaussian heatmaps."""
    ax = torch.arange(hm, dtype=torch.float32, device=lms.device)
    d2 = ((ax[None, None, None, :] - lms[..., 0, None, None]) ** 2
          + (ax[None, None, :, None] - lms[..., 1, None, None]) ** 2)
    return torch.exp(-d2 / (2.0 * sigma ** 2))


def calibrate_(fan, x: torch.Tensor, rounds: int = 8) -> float:
    """Scale every conv kernel by one factor a round until the largest raw
    output is below 30: homogeneity over the ~60 convs of the deepest path
    gives the exponent. -> the final magnitude."""
    with torch.no_grad():
        for _ in range(rounds):
            m = max(float(o.abs().max()) for o in fan(x))
            if m < 30.0:
                return m
            s = m ** (-1.0 / 60.0)
            for p in fan.parameters():
                if p.ndim == 4:
                    p.mul_(s)
        return max(float(o.abs().max()) for o in fan(x))


def clip_global_norm_(params, max_norm: float) -> float:
    """optax.clip_by_global_norm: gradients scaled by max_norm / norm where
    the norm reaches max_norm. -> the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = float(torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(grads))))
    if norm >= max_norm:
        torch._foreach_mul_(grads, max_norm / norm)
    return norm


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    timing.add_common(p, "subject directory (reads its train split, writes "
                         "fan_proxy.npz and fan_proxy.json there)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--sigma", type=float, default=1.5,
                   help="target-heatmap gaussian sigma (heatmap px)")
    p.add_argument("--crop_size", type=int, default=256,
                   help="FAN input crop (pipeline.fan.CROP_SIZE)")
    p.add_argument("--max_frames", type=int, default=48)
    args = p.parse_args(argv)
    from idealnerf_tpu_torch.data.dataset import load_transforms_dataset
    from idealnerf_tpu_torch.models.face_unet import ieee_convs
    from idealnerf_tpu_torch.pipeline.fan import (
        FAN, heatmaps_to_landmarks, init_fan,
    )

    if args.smoke:
        args.crop_size, args.steps, args.batch, args.max_frames = 64, 4, 1, 4
        args.out = args.out or os.path.join("output", "fan_proxy_smoke")
        _smoke_subject(args.out)
    if not args.out:
        p.error("--out (the subject directory) is required")
    dev = device_of(args.device)
    ds = load_transforms_dataset(args.out, mode="train",
                                 max_frames=args.max_frames)
    C, HM = args.crop_size, args.crop_size // 4
    crops, lms = face_crops(ds, C, dev)
    imgs = crops.permute(0, 3, 1, 2).contiguous()
    heat = gauss_maps(lms, HM, args.sigma)

    fan = FAN.from_state_dict(init_fan(1, 1 if args.smoke else None),
                              device=dev)
    mag = calibrate_(fan, imgs[:1])
    print(f"calibrated forward magnitude: {mag:.2f}", flush=True)
    with torch.no_grad():
        for name, t in fan.named_parameters():
            head = name.split(".")[0]
            if head[0] == "l" and head[1:].isdigit():
                t.zero_()
    opt = torch.optim.Adam(fan.parameters(), lr=args.lr)

    def lm_err(x, want):
        with torch.no_grad():
            pred = heatmaps_to_landmarks(fan(x)[-1])
            return float(torch.mean(torch.linalg.norm(pred - want, dim=-1)))

    n_val = max(1, len(imgs) // 8)
    tr_x, tr_y = imgs[n_val:], heat[n_val:]
    va_x, va_l = imgs[:n_val], lms[:n_val]
    err0 = lm_err(va_x, va_l)
    print(f"landmark error at random init: {err0:.2f} hm-px "
          f"({len(tr_x)} train crops, {n_val} val)", flush=True)

    rng = np.random.default_rng(0)
    losses = []
    timing.sync(dev)
    t0 = time.perf_counter()
    for s in range(args.steps):
        idx = torch.from_numpy(rng.integers(0, len(tr_x), args.batch)).to(dev)
        outs = fan(tr_x[idx])
        target = tr_y[idx]
        loss = sum(torch.mean((o - target) ** 2) for o in outs) / len(outs)
        opt.zero_grad(set_to_none=True)
        with ieee_convs():  # the backward convolutions in f32, as forward
            loss.backward()
        clip_global_norm_(list(fan.parameters()), 1.0)
        opt.step()
        if s % 20 == 0 or s == args.steps - 1:
            losses.append((s, float(loss.detach())))
            print(f"step {s}: heatmap mse {losses[-1][1]:.5f}", flush=True)
    timing.sync(dev)
    wall = time.perf_counter() - t0
    err1 = lm_err(va_x, va_l)
    print(f"landmark error after {args.steps} steps: {err1:.2f} hm-px "
          f"(was {err0:.2f}; {args.steps / max(wall, 1e-9):.2f} steps/s)",
          flush=True)

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "fan_proxy.npz"),
             **{k: v.detach().cpu().numpy()
                for k, v in fan.state_dict().items()})
    out = {"steps": args.steps, "batch": args.batch, "lr": args.lr,
           "crop_size": C, "train_crops": int(len(tr_x)),
           "val_crops": int(n_val), "wall_s": wall,
           "landmark_err_hm_px_random_init": err0,
           "landmark_err_hm_px_trained": err1,
           "loss_trajectory": losses, **timing.device_fields(dev)}
    timing.write_json(os.path.join(args.out, "fan_proxy.json"), out)
    print("wrote", os.path.join(args.out, "fan_proxy.npz"))
    return out


if __name__ == "__main__":
    main()
