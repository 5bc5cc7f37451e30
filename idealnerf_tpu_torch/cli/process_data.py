"""Offline dataset production (counterpart of cli/process_data.py;
reference: data_util/process_data.py's 8 steps).

Given a subject directory holding ``ori_imgs/*.jpg`` frames and an audio
``.wav``, this runs the steps in order: audio features (step 0, the
DeepSpeech graph with ``--deepspeech_pb``, else the fixed projection of
``pipeline.audio``), FAN landmarks -> ``ori_imgs/*.lms`` (step 2,
``--fan_weights``), BiSeNet parsing -> ``parsing/*.png`` (step 3,
``--parse_weights``), the background plate -> ``bc.jpg`` (step 4),
head/com image decoupling -> ``head_imgs/``, ``com_imgs/`` (step 5), 3DMM
head-pose tracking -> ``track_params.npz`` (step 6, landmark stages;
``--bfm`` or the synthetic stand-in model) and the transforms/config
writer (step 7). Frame extraction (step 1) is
``utils.video_tools.video_to_images``. Where a step's input is missing it
says what is missing instead of failing midway.

The nets and the tracker run on ``--device`` (``cuda`` by default); the
audio chain, the plate and the decoupling are numpy on the host. Frames
and plates are read and written through Pillow (``data/jpeg.py``) at
JPEG quality 75, Pillow's default and the quality the JAX CLI's
``imageio.v2`` writes with; parse maps through ``eval/video``'s PNG
codec. ``main`` returns each step's wall seconds (and the peak device
memory on a CUDA device); run as a module it prints them as one JSON
line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import wave

import numpy as np
import torch

from idealnerf_tpu_torch.data.jpeg import read_jpeg, write_jpeg
from idealnerf_tpu_torch.eval.video import read_png, write_png
from idealnerf_tpu_torch.pipeline.audio import extract_deepspeech_features
from idealnerf_tpu_torch.pipeline.process import (
    decouple_images, extract_background_plate, head_mask_from_parse,
    parse_color_map, write_transforms,
)

logger = logging.getLogger("idealnerf.process")

JPEG_QUALITY = 75
STEPS = ("audio", "landmarks", "parse", "bg", "decouple", "track",
         "transforms")


def _read_wav(path):
    with wave.open(path, "rb") as wf:
        sr = wf.getframerate()
        n = wf.getnframes()
        data = np.frombuffer(wf.readframes(n), dtype=np.int16)
        if wf.getnchannels() > 1:
            data = data.reshape(-1, wf.getnchannels()).mean(1)
    return data.astype(np.float64), sr


def _state_dict(path: str):
    """A weights file: an ``.npz`` of arrays, else a torch state dict
    (or a module holding one)."""
    if path.endswith(".npz"):
        return dict(np.load(path))
    sd = torch.load(path, map_location="cpu")
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--id_dir", required=True, help="subject directory")
    parser.add_argument("--wav", default=None,
                        help="audio wav (default aud.wav)")
    parser.add_argument("--subject", default=None)
    parser.add_argument("--step", default="all",
                        help="all | " + " | ".join(STEPS))
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--bfm", default=None, help="3DMM_info.npy path")
    parser.add_argument("--parse_weights", default=None,
                        help="BiSeNet weights (torch 79999_iter.pth or an "
                             ".npz of the same names) — enables the parse "
                             "step")
    parser.add_argument("--fan_weights", default=None,
                        help="FAN 2DFAN-4 weights (torch .pth state dict or "
                             "an .npz of the same names) — enables the "
                             "landmarks step")
    parser.add_argument("--deepspeech_pb", default=None,
                        help="DeepSpeech 0.1.0 frozen graph (output_graph.pb)"
                             " — real acoustic-model logits for the audio "
                             "step (parsed without TensorFlow)")
    parser.add_argument("--device", default="cuda",
                        help="where the nets and the tracker run")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here")

    d = args.id_dir
    ori = os.path.join(d, "ori_imgs")
    parsing = os.path.join(d, "parsing")
    ids = sorted(
        int(f[:-4]) for f in os.listdir(ori) if f.endswith(".jpg")
    ) if os.path.isdir(ori) else []
    if args.max_frames:
        ids = ids[: args.max_frames]
    if not ids:
        logger.error("no frames in %s — extract them first "
                     "(utils.video_tools.video_to_images)", ori)
        return {"frames": 0, "steps": {}}
    steps = list(STEPS) if args.step == "all" else [args.step]
    h, w = read_jpeg(os.path.join(ori, f"{ids[0]}.jpg")).shape[:2]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = {}

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[name] = time.perf_counter() - t0

    if "audio" in steps:
        wav = args.wav or os.path.join(d, "aud.wav")
        if os.path.exists(wav):
            with timed("audio"):
                audio, sr = _read_wav(wav)
                logits_fn = None
                if args.deepspeech_pb:
                    from idealnerf_tpu_torch.pipeline.deepspeech import (
                        make_logits_fn_from_graph,
                    )

                    logits_fn = make_logits_fn_from_graph(args.deepspeech_pb,
                                                          device=dev)
                aud = extract_deepspeech_features(
                    audio, sr, num_frames=len(ids), logits_fn=logits_fn)
                np.save(os.path.join(d, "aud.npy"), aud)
            logger.info("audio features %s -> aud.npy", aud.shape)
        else:
            logger.warning("no wav at %s — skipping audio step", wav)

    if "landmarks" in steps and args.fan_weights:
        # step 2 (reference process_data.py:104-123): FAN landmark
        # detection -> .lms files. The face box comes from the parse map
        # when one exists, else the full frame (the reference's s3fd
        # detector is replaced, as in the JAX package's fan.py)
        from idealnerf_tpu_torch.pipeline.fan import FAN, detect_landmarks

        with timed("landmarks"):
            fan = FAN.from_state_dict(_state_dict(args.fan_weights),
                                      device=dev)
            fan.requires_grad_(False)
            for i in ids:
                img = read_jpeg(os.path.join(ori, f"{i}.jpg"))
                box = np.array([0, 0, img.shape[1], img.shape[0]],
                               np.float32)
                ppath = os.path.join(parsing, f"{i}.png")
                if os.path.exists(ppath):
                    ys, xs = np.nonzero(head_mask_from_parse(read_png(ppath)))
                    if len(xs):
                        m = 0.25 * max(xs.max() - xs.min(),
                                       ys.max() - ys.min())
                        box = np.array([xs.min() - m, ys.min() - m,
                                        xs.max() + m, ys.max() + m],
                                       np.float32)
                lms = detect_landmarks(fan, img, box)
                np.savetxt(os.path.join(ori, f"{i}.lms"), lms, "%f")
            del fan
        logger.info("FAN landmarks -> ori_imgs/*.lms (%d frames)", len(ids))
    elif "landmarks" in steps and args.step == "landmarks":
        logger.error("landmarks step needs --fan_weights")

    if "parse" in steps and args.parse_weights:
        # step 3 (reference process_data.py:138-139 + face_parsing/test.py):
        # BiSeNet 19-class parse -> reference color coding
        from idealnerf_tpu_torch.pipeline.parsing_net import (
            BiSeNet, parse_image,
        )

        with timed("parse"):
            net = BiSeNet.from_state_dict(_state_dict(args.parse_weights),
                                          device=dev)
            os.makedirs(parsing, exist_ok=True)
            for i in ids:
                classes = parse_image(net, read_jpeg(os.path.join(
                    ori, f"{i}.jpg")))
                write_png(os.path.join(parsing, f"{i}.png"),
                          parse_color_map(classes))
            del net
        logger.info("BiSeNet parsing -> parsing/ (%d frames)", len(ids))
    elif "parse" in steps and args.step == "parse":
        logger.error("parse step needs --parse_weights (79999_iter.pth)")

    has_parsing = os.path.isdir(parsing) and os.listdir(parsing)
    if "bg" in steps:
        if not has_parsing:
            logger.error("parsing/ missing — run the parse step (BiSeNet "
                         "weights) before the background step")
        else:
            with timed("bg"):
                sel = ids[:: max(len(ids) // 25, 1)][:25]
                imgs = np.stack([read_jpeg(os.path.join(ori, f"{i}.jpg"))
                                 for i in sel])
                masks = np.stack([
                    head_mask_from_parse(read_png(os.path.join(
                        parsing, f"{i}.png"))) for i in sel])
                plate = extract_background_plate(imgs, masks)
                write_jpeg(os.path.join(d, "bc.jpg"), plate, JPEG_QUALITY)
            logger.info("background plate -> bc.jpg")

    if "decouple" in steps and has_parsing and os.path.exists(
        os.path.join(d, "bc.jpg")
    ):
        with timed("decouple"):
            plate = read_jpeg(os.path.join(d, "bc.jpg"))
            for sub in ("com_imgs", "head_imgs"):
                os.makedirs(os.path.join(d, sub), exist_ok=True)
            for i in ids:
                com, head = decouple_images(
                    read_jpeg(os.path.join(ori, f"{i}.jpg")),
                    read_png(os.path.join(parsing, f"{i}.png")), plate)
                write_jpeg(os.path.join(d, "com_imgs", f"{i}.jpg"), com,
                           JPEG_QUALITY)
                write_jpeg(os.path.join(d, "head_imgs", f"{i}.jpg"), head,
                           JPEG_QUALITY)
        logger.info("decoupled %d frames -> com_imgs/ head_imgs/", len(ids))

    track_path = os.path.join(d, "track_params.npz")
    if "track" in steps:
        from idealnerf_tpu_torch.pipeline.tracking import (
            Face3DMM, FaceTracker,
        )

        with timed("track"):
            lms = np.stack([
                np.loadtxt(os.path.join(ori, f"{i}.lms")) for i in ids
            ])[..., :2]
            model = (Face3DMM.load(args.bfm, device=dev) if args.bfm
                     else Face3DMM.synthetic(device=dev))
            if not args.bfm:
                logger.warning("no --bfm given: tracking with the synthetic "
                               "stand-in model (poses indicative only)")
            result = FaceTracker(model, h, w).fit(lms)
            np.savez(track_path, focal=result.focal, euler=result.euler,
                     trans=result.trans, exp=result.exp, id=result.id_coef)
        logger.info("tracking -> %s (focal %.0f, loss %.3f)",
                    track_path, result.focal, result.loss)

    if "transforms" in steps:
        if not os.path.exists(track_path):
            logger.error("no %s — run the track step first", track_path)
            return {"frames": len(ids), "steps": times}
        with timed("transforms"):
            tp = np.load(track_path)
            lms = {i: np.loadtxt(os.path.join(ori, f"{i}.lms"))[:, :2]
                   for i in ids}
            write_transforms(
                d, ids, tp["euler"], tp["trans"] / 10.0, tp["exp"], lms,
                focal=float(tp["focal"]), h=h, w=w,
                subject=args.subject or os.path.basename(d.rstrip("/")),
            )
        logger.info("transforms_exp_{train,val}.json + config files written")
    out = {"frames": len(ids), "hw": [h, w], "device": str(dev),
           "steps": times}
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(main()))
