"""Export a FrameDataset to the reference's on-disk subject layout
(counterpart of data/export.py): ``ori_imgs/*.jpg + .lms``,
``parsing/*.png``, ``head_imgs/``, ``com_imgs/``, ``bc.jpg``, ``aud.npy``,
``transforms_exp_{train,val}.json`` and a HeadNeRF config .txt.

A procedurally generated subject (data/synthetic.py) written to disk in
the format the CLIs and ``load_transforms_dataset`` consume, so training
and eval runs go through the real file-based path (JPEG decode, .lms
parsing, parse-map masks, json poses).
"""

from __future__ import annotations

import json
import os

import numpy as np

from idealnerf_tpu_torch.data.dataset import FrameDataset
from idealnerf_tpu_torch.data.jpeg import encode_jpeg, write_jpeg


def write_reference_format(ds: FrameDataset, out_dir: str,
                           subject: str = "synthetic",
                           train_fraction: float = 10.0 / 11.0,
                           jpg_quality: int = 95) -> str:
    """Write ``ds`` under ``out_dir`` in reference subject layout.

    The parse maps mark subject pixels (frame != plate) in red, the
    channel the loader reads the torso ray budget from. Returns the path
    of the written HeadNeRF config .txt."""
    from idealnerf_tpu_torch.eval.video import write_png

    ori = os.path.join(out_dir, "ori_imgs")
    parsing = os.path.join(out_dir, "parsing")
    head = os.path.join(out_dir, "head_imgs")
    com = os.path.join(out_dir, "com_imgs")
    for d in (ori, parsing, head, com):
        os.makedirs(d, exist_ok=True)

    write_jpeg(os.path.join(out_dir, "bc.jpg"), ds.bc_img, jpg_quality)
    np.save(os.path.join(out_dir, "aud.npy"), ds.auds)

    n = ds.size
    plate = ds.bc_img.astype(np.int16)
    for i in range(n):
        img = ds.images[i]
        jpg = encode_jpeg(img, jpg_quality)
        for d in (ori, head, com):
            with open(os.path.join(d, f"{i}.jpg"), "wb") as fh:
                fh.write(jpg)
        np.savetxt(os.path.join(ori, f"{i}.lms"), ds.landmarks[i],
                   fmt="%.2f")
        subject_px = np.abs(img.astype(np.int16) - plate).max(-1) > 12
        parse = np.full(img.shape, 255, np.uint8)           # white bg
        parse[subject_px] = (255, 0, 0)                     # red subject
        write_png(os.path.join(parsing, f"{i}.png"), parse)

    split = int(n * train_fraction)
    for name, ids in (("train", range(split)), ("val", range(split, n))):
        frames = []
        for i in ids:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :4] = ds.poses[i]
            frames.append({
                "img_id": int(i),
                "aud_id": int(ds.aud_ids[i]),
                "transform_matrix": pose.tolist(),
                "face_rect": np.asarray(ds.face_rects[i]).tolist(),
                "exp": np.asarray(ds.exprs[i]).tolist(),
            })
        doc = {"focal_len": float(ds.focal), "cx": float(ds.cx),
               "cy": float(ds.cy), "frames": frames}
        with open(os.path.join(out_dir, f"transforms_exp_{name}.json"),
                  "w") as fh:
            json.dump(doc, fh)

    cfg_path = os.path.join(out_dir, "HeadNeRF_config.txt")
    with open(cfg_path, "w") as fh:
        fh.write(f"expname = {subject}_head\n")
        fh.write(f"datadir = {out_dir}\n")
        fh.write(f"basedir = {os.path.join(out_dir, 'logs')}\n")
        fh.write(f"near = {ds.near}\n")
        fh.write(f"far = {ds.far}\n")
        fh.write(f"dim_expr = {ds.exprs.shape[1]}\n")
    return cfg_path
