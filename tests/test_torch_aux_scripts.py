"""The port's second-stage scripts on the CPU at their ``--smoke`` sizes:
``scripts.train_fan_proxy`` writes ``fan_proxy.npz`` (a one-stack FAN
at this size) under the JAX FAN's names (its ``init_fan`` keys, which its
``--fan_npz`` reads) and
``fan_proxy.json`` with the JAX script's keys, the proxy trains every
tensor of the dict; ``scripts.rehearsal_2nd`` then runs the second stage
with that proxy as ``--fan_npz`` and, with ``--ablate``, its three rows,
each writing the JAX script's keys. The landmark detector runs on a 64x64
crop (``pipeline.fan.CROP_SIZE`` patched), the proxy's own crop size."""

import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

import idealnerf_tpu.pipeline.fan as jfan
from idealnerf_tpu_torch.cli import common as cli_common
from idealnerf_tpu_torch.pipeline import fan as pfan
from idealnerf_tpu_torch.scripts import rehearsal_2nd, train_fan_proxy
from idealnerf_tpu_torch.utils.summary import SummaryWriter

PROXY_KEYS = {"steps", "batch", "lr", "crop_size", "train_crops",
              "val_crops", "wall_s", "landmark_err_hm_px_random_init",
              "landmark_err_hm_px_trained", "loss_trajectory"}
REHEARSAL_KEYS = {"steps", "crop", "fan", "aux_target_magnitude",
                  "aux_probe_raw", "aux_weight_used", "wall_s",
                  "steps_per_sec", "trajectory"}
ABLATION_KEYS = {"steps_per_row", "crop", "fan", "aux_landmark_target",
                 "aux_vgg_target", "w_landmark", "w_vgg", "rows",
                 "psnr_effect_vs_mse"}


@pytest.fixture(autouse=True)
def _cpu_sized(monkeypatch):
    """One torch thread, metrics without TensorBoard, the 64x64 crop."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(cli_common, "SummaryWriter", functools.partial(
        SummaryWriter, use_tensorboard=False))
    monkeypatch.setattr(pfan, "CROP_SIZE", 64)
    yield
    torch.set_num_threads(n)


def test_fan_proxy_then_the_second_stage_rehearsal(tmp_path, monkeypatch):
    out = str(tmp_path / "subject")
    steps = []
    adam_step = torch.optim.Adam.step

    def spy(self, *a, **kw):  # every tensor of the FAN has a gradient
        steps.append(all(p.grad is not None for g in self.param_groups
                         for p in g["params"]))
        return adam_step(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", spy)
    proxy = train_fan_proxy.main(["--device", "cpu", "--smoke", "--out",
                                  out])
    monkeypatch.setattr(torch.optim.Adam, "step", adam_step)
    assert steps == [True] * 4
    assert PROXY_KEYS <= set(proxy) and proxy["device"] == "cpu"
    assert proxy["crop_size"] == 64 and len(proxy["loss_trajectory"]) == 2
    with open(tmp_path / "subject" / "fan_proxy.json") as fh:
        assert json.load(fh).keys() == proxy.keys()
    with np.load(tmp_path / "subject" / "fan_proxy.npz") as npz:
        saved = dict(npz)
    want = jfan.init_fan(jax.random.PRNGKey(0), num_modules=1)
    assert {k: v.shape for k, v in saved.items()} == {
        k: v.shape for k, v in want.items()}
    assert all(np.abs(saved[k]).max() > 0 for k in ("l0.weight", "l0.bias"))

    res = rehearsal_2nd.main(["--device", "cpu", "--smoke", "--out", out])
    assert REHEARSAL_KEYS <= set(res) and res["fan"] == "proxy"
    assert res["steps"] == 4 and res["crop"] == 24
    assert [t["step"] for t in res["trajectory"]] == [0, 1, 2, 3]
    assert all(math.isfinite(t["aux_loss"]) and t["aux_loss"] > 0
               for t in res["trajectory"])
    abl = rehearsal_2nd.main(["--device", "cpu", "--smoke", "--out", out,
                              "--ablate"])
    assert ABLATION_KEYS <= set(abl) and set(abl["rows"]) == {
        "mse", "landmark", "vgg"}
    assert all(math.isfinite(r["final_psnr_mean_tail"])
               for r in abl["rows"].values())
    assert all(t["aux_loss"] == 0.0
               for t in abl["rows"]["mse"]["trajectory"])
    assert all(t["aux_loss"] > 0 for tag in ("landmark", "vgg")
               for t in abl["rows"][tag]["trajectory"])
