"""Second-stage / cross-identity fine-tune (counterpart of
idealnerf_tpu/cli/train_second_stage.py): start from a trained head
checkpoint of the port (``--head_ckpt``), render the whole face crop of
the target identity every step while conditioned on a driving subject's
audio (``--driving_aud``, its aud.npy; default the identity's own), and
optimise the crop's MSE plus the aux losses weighted by
``--aux_landmark`` (the FAN heatmap L1, the reference's active term),
``--aux_vgg`` and ``--aux_vggface`` (instantiated but not applied by the
reference: zero by default).

    python -m idealnerf_tpu_torch.cli.train_second_stage --synthetic 4 \\
        --synthetic_hw 450 --dim_aud 64 --dim_expr 76 --dim_latent 32 \\
        --head_ckpt <basedir>/<expname>/ckpt --crop 256 --steps 100 \\
        --aux_landmark 1e-3 [--fan_npz <dir>/fan_proxy.npz] \\
        [--aux_vgg 1e-3] [--aux_vggface 1e-3]

Released FAN, VGG16 and VGGFace weights are not bundled: the FAN is
``--fan_npz`` (a flat dict under the torch names, as the JAX package's
``--fan_npz`` reads and ``scripts.train_fan_proxy`` writes) or else drawn
by ``pipeline.fan.init_fan(1)``, and VGG16 and VGGFace are He-initialised
from seeds 2 and 3. The JAX CLI seeds its nets with ``PRNGKey(1/2/3)``;
the draws differ. ``--fan_npz`` without ``--aux_landmark`` does nothing,
as in the JAX CLI.

On ``--device cuda`` (the default) the crop's tiles run the fused kernels
(``--train_fused`` 1 or 2) and the aux nets cuDNN in f32.
``--ray_devices R`` splits the crop's ray tiles over R ranks, one process
each (train/second_stage.py ``mesh``); rank 0 writes the checkpoint and
metrics. The checkpoint goes to ``--ckpt_dir`` (default ``<basedir>/<expname>_second/ckpt``); the
metrics (``aux_loss`` among them) every ``--i_print`` steps.
``main(argv)`` returns {"step", "ckpt_dir", "crop", "history"}.
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch

from idealnerf_tpu_torch.cli.common import (
    build_parser, make_summary, resolve_config, resolve_dataset,
    resolve_device,
)
from idealnerf_tpu_torch.parallel.launch import launch
from idealnerf_tpu_torch.train.second_stage import (
    SecondStageTrainer, make_aux_loss,
)

logger = logging.getLogger("idealnerf.cli")


def build_aux_loss(args, device):
    """``make_aux_loss`` over the nets that ``args``' weights turn on
    (``aux_landmark``, ``aux_vgg``, ``aux_vggface``, ``fan_npz``), on
    ``device``; None with every weight zero."""
    if not (args.aux_landmark or args.aux_vgg or args.aux_vggface):
        return None
    from idealnerf_tpu_torch.losses.vgg import init_vgg16, init_vggface
    from idealnerf_tpu_torch.pipeline import fan as fan_mod

    fan = vgg16 = vggface = None
    if args.aux_landmark:
        if args.fan_npz:
            with np.load(args.fan_npz) as npz:
                fan = fan_mod.FAN.from_state_dict(dict(npz), device=device)
        else:
            fan = fan_mod.FAN.from_state_dict(fan_mod.init_fan(1),
                                              device=device)
            logger.info("aux landmark loss with a RANDOM-init FAN (no "
                        "released weights here)")
    if args.aux_vgg:
        vgg16 = init_vgg16(2, device=device)
    if args.aux_vggface:
        vggface = init_vggface(3, device=device)
    return make_aux_loss(fan, vgg16, vggface, w_landmark=args.aux_landmark,
                         w_vgg=args.aux_vgg, w_vggface=args.aux_vggface)


def main(argv=None):
    parser = build_parser(__doc__)
    parser.add_argument("--head_ckpt", type=str, default=None,
                        help="the port's trained head checkpoint directory "
                             "to fine-tune from")
    parser.add_argument("--driving_aud", type=str, default=None,
                        help="driving subject's aud.npy; default: the "
                             "identity's own audio (self pairing)")
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--aux_landmark", type=float, default=0.0,
                        help="weight of the FAN heatmap landmark loss "
                             "(reference LandmarkLoss, the active term)")
    parser.add_argument("--aux_vgg", type=float, default=0.0,
                        help="weight of the VGG16 perceptual loss")
    parser.add_argument("--aux_vggface", type=float, default=0.0,
                        help="weight of the VGGFace perceptual loss")
    parser.add_argument("--fan_npz", type=str, default=None,
                        help="FAN weights, a flat npz under the torch "
                             "names (scripts.train_fan_proxy); unset = "
                             "random init (no released weights here)")
    parser.add_argument("--ray_devices", type=int, default=0,
                        help="split the crop's ray tiles over this many "
                             "ranks")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.ray_devices:
        return launch(_train, 1, args.ray_devices, device=device,
                      args=(args,))[0]
    return _train(None, args)


def _train(mesh, args):
    """The fine-tune on one device (``mesh`` None) or on this rank of a
    ray-sharded mesh."""
    cfg = resolve_config(args)
    main_rank = mesh is None or mesh.is_main
    device = torch.device(args.device) if mesh is None else mesh.device
    identity = resolve_dataset(args, cfg, mode="train")
    run_dir = os.path.join(cfg.basedir, cfg.expname + "_second")
    if main_rank:
        cfg.write(os.path.join(run_dir, "args.txt"))
    auds = (np.load(args.driving_aud).astype(np.float32) if args.driving_aud
            else identity.auds)

    init_params = None
    if args.head_ckpt:
        from idealnerf_tpu_torch.ckpt import CheckpointManager

        ck = CheckpointManager(args.head_ckpt).restore()
        init_params = ck["params"]
        logger.info("fine-tune from %s step %d", args.head_ckpt,
                    int(ck["step"]))
    aux = build_aux_loss(args, device)
    trainer = SecondStageTrainer(cfg, identity, auds,
                                 init_params=init_params, crop=args.crop,
                                 seed=args.seed, aux_loss=aux, mesh=mesh,
                                 device=device)
    logger.info("train_second_stage: %d frames, crop %d, device %s, aux %s%s",
                identity.size, trainer.crop, device,
                "off" if aux is None else "on",
                "" if mesh is None else f", rays over {mesh.n_ray} ranks")
    summary = (make_summary(cfg, run_dir) if main_rank
               else contextlib.nullcontext())
    history = []

    def on_metrics(step, m):
        history.append((step, m))
        if main_rank:
            summary.scalars(step, m)
        logger.info("[2ND] step %d loss %.5f psnr %.2f aux %.4f", step,
                    m["loss"], m["psnr"], m["aux_loss"])

    with summary:
        trainer.run(args.steps, log_every=cfg.i_print, on_metrics=on_metrics)

    from idealnerf_tpu_torch.ckpt import CheckpointManager

    ckpt_dir = args.ckpt_dir or os.path.join(run_dir, "ckpt")
    st = trainer.state
    if main_rank:
        CheckpointManager(ckpt_dir).save(
            args.steps, {"step": args.steps,
                         "params": st.params.state_dict(),
                         "latent_codes": st.latent_codes.detach()})
    logger.info("done; checkpoint in %s", ckpt_dir)
    return {"step": args.steps, "ckpt_dir": ckpt_dir, "crop": trainer.crop,
            "history": history}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
