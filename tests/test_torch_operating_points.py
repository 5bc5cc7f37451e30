"""The port's eval/operating_points against the JAX module's on seeded
evidence: mode keys over the whole grammar, several files per directory,
the repo's recorded evidence, sample sweeps and rehearsal results. The
port's cost constants are passed as the JAX module's (fixed=5.6, dil=1.0).
Three faults of the JAX module are fixed in the port and asserted as
intended (ROADMAP.md C): ``_filter_roll`` matched ``roll2`` against
``roll25``, ``_cost`` left the rolling keyframe share out of a frozen-z
torso, and a val-clip file opened a gate that the driving clip failed
(C2). The head gate's read of the same-bounds agreement (C3) is asserted
as intended too."""

import glob
import json
import os

import numpy as np
import pytest

from idealnerf_tpu.eval import operating_points as jop
from idealnerf_tpu_torch.eval import operating_points as op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONSTS = dict(fixed=5.6, dil=1.0)
REFRESHES = (8, 25, 50)


def _mode_key(rng, head: bool, rolls=(0, 4, 16), fz_roll: bool = False):
    """A random mode key over the grammar; composite-only tags (t, kt,
    rt, fz) only on composite keys. Without ``fz_roll`` no key is both
    frozen-z and rolling (the fixed cost fault)."""
    s = int(rng.choice([8, 12, 16, 24, 32, 48]))
    key = str(s)
    if not head and rng.rand() < 0.3:
        key += f"t{int(rng.choice([16, 32, 48]))}"
    if rng.rand() < 0.4:
        key += f"_k{int(rng.choice([40, 60, 80]))}"
    if not head and rng.rand() < 0.3:
        key += f"_kt{int(rng.choice([1, 20, 40]))}"
    if rng.rand() < 0.2:
        key += f"_u{int(rng.choice([10, 50]))}"
    if rng.rand() < 0.2:
        key += f"_b{int(rng.choice([30, 50]))}"
    if rng.rand() < 0.3:
        key += f"_d{int(rng.choice([2, 3]))}"
    roll = int(rng.choice(rolls))
    rt = 0
    if not head and not roll and rng.rand() < 0.25:
        rt = int(rng.choice([10, 25]))
    fz = not head and not rt and rng.rand() < 0.3 and (fz_roll or not roll)
    if roll:
        key += f"_roll{roll}"
    if rt:
        key += f"_rt{rt}"
    if fz:
        key += "_fz"
    if rng.rand() < 0.2:
        key += "_hp"
    return ("head_only_s_delta_" if head else "s_delta_") + key


def _row(rng, head: bool):
    row = {"psnr_temporal_vs_full": float(rng.uniform(36.0, 48.0))}
    if rng.rand() < 0.85:
        row["delta_psnr_vs_gt"] = float(np.round(rng.uniform(-0.05, 0.12),
                                                 3))
    if rng.rand() < 0.8:
        row["fps_delta_frames"] = float(np.round(rng.uniform(5.0, 60.0), 3))
    if not head:
        row["psnr_temporal_vs_gt"] = float(rng.uniform(25.0, 32.0))
    return row


def _evidence(rng, n_modes: int = 14, **kw) -> dict:
    modes = {}
    for _ in range(n_modes):
        head = rng.rand() < 0.4
        modes[_mode_key(rng, head, **kw)] = _row(rng, head)
    if rng.rand() < 0.3:   # keys outside the grammar parse to nothing
        modes["s_delta_x16"] = {"delta_psnr_vs_gt": 0.0}
        modes["s_delta_16_q5"] = {"delta_psnr_vs_gt": 0.0}
    td = {"refresh": int(rng.choice(REFRESHES)), "modes": modes,
          "tightened_bounds": (None if rng.rand() < 0.5 else
                               {"head": [0.6, 1.9], "torso": [0.7, 2.2]})}
    if rng.rand() < 0.8:
        td["keyframe_rung"] = str(rng.choice(["32+64", "16+32", "64+128"]))
    if rng.rand() < 0.9:
        td["fps_full_warm"] = float(rng.uniform(2.0, 8.0))
        td["fps_head_full_warm"] = float(rng.uniform(4.0, 12.0))
    return td


def _evidence_dir(tmp_path, seed: int, n_files: int = 4, **kw):
    rng = np.random.RandomState(seed)
    names = ["temporal_delta.json"] + [
        f"temporal_delta_{i}.json" for i in range(1, n_files)]
    for name in names:
        with open(tmp_path / name, "w") as fh:
            json.dump(_evidence(rng, **kw), fh)
    with open(tmp_path / "other.json", "w") as fh:   # not evidence
        json.dump({"refresh": 25, "modes": {}}, fh)
    return str(tmp_path)


RECORDED = sorted({os.path.relpath(os.path.dirname(p), ROOT) for p in
                   glob.glob(os.path.join(ROOT, "runs", "**",
                                          "temporal_delta*.json"),
                             recursive=True)})


@pytest.mark.parametrize("seed", range(12))
def test_pick_temporal_points_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(6):
        td = _evidence(rng)
        for refresh in (td["refresh"], 25):
            for trust in (True, False):
                want = jop.pick_temporal_points(td, refresh, 32,
                                                fps_trust=trust)
                got = op.pick_temporal_points(td, refresh, 32,
                                              fps_trust=trust, **JAX_CONSTS)
                assert got == want
    assert op.pick_temporal_points(None, 25) == jop.pick_temporal_points(
        None, 25)


@pytest.mark.parametrize("roll_k", [0, 4, 16])
@pytest.mark.parametrize("seed", range(4))
def test_pick_temporal_mode_configs_matches_jax(seed, roll_k):
    rng = np.random.RandomState(200 + seed)
    cands = [_evidence(rng) for _ in range(5)]
    want = jop.pick_temporal_mode_configs(cands, 32, 25, roll_k=roll_k)
    got = op.pick_temporal_mode_configs(cands, 32, 25, roll_k=roll_k,
                                        **JAX_CONSTS)
    assert got == want


@pytest.mark.parametrize("mode", ["comp", "head"])
@pytest.mark.parametrize("seed", range(4))
def test_gated_video_config_matches_jax_on_a_dir_of_files(seed, mode,
                                                          tmp_path):
    d = _evidence_dir(tmp_path, 300 + seed)
    assert ([json.dumps(x, sort_keys=True) for x in
             op.load_temporal_evidence(d)]
            == [json.dumps(x, sort_keys=True) for x in
                jop.load_temporal_evidence(d)])
    assert len(op.load_temporal_evidence(d)) == 4
    for roll_k in (0, 4, 16):
        for refresh in (25, 50):
            want = jop.gated_video_config(d, mode, 32, refresh, roll_k)
            got = op.gated_video_config(d, mode, 32, refresh, roll_k,
                                        **JAX_CONSTS)
            assert got == want


@pytest.mark.parametrize("evidence_dir", RECORDED)
def test_gated_video_config_matches_jax_on_recorded_evidence(evidence_dir):
    d = os.path.join(ROOT, evidence_dir)
    for mode in ("comp", "head"):
        for roll_k in (0, 10, 16):
            assert (op.gated_video_config(d, mode, roll_k=roll_k,
                                          **JAX_CONSTS)
                    == jop.gated_video_config(d, mode, roll_k=roll_k))


def test_recorded_evidence_exists():
    assert len(RECORDED) >= 3, RECORDED


def _sweep(rng) -> dict:
    rungs = ["64+192", "64+128", "48+96", "32+64", "24+48", "16+32"]
    sweep = {}
    for r in rungs:
        for suffix in ("", "_tight"):
            if rng.rand() < 0.8:
                sweep[r + suffix] = {"psnr": float(rng.uniform(28, 30))}
    ref = next((k for k in sweep if k.startswith("64+")
                and "_tight" not in k), None)
    for k, v in sweep.items():
        if ref and rng.rand() < 0.9:
            v[f"delta_psnr_vs_{ref}"] = round(
                sweep[ref]["psnr"] - v["psnr"], 3)
    return sweep


def _results(rng) -> dict:
    res = {}
    for keep in (28, 40, 60):
        for kind in ("", "_hp", "_occ"):
            key = f"masked_{keep}{kind}"
            if rng.rand() < 0.7:
                res[f"delta_psnr_{key}"] = round(float(rng.uniform(
                    -0.02, 0.1)), 3)
            if rng.rand() < 0.6:
                res[key] = {"psnr": 29.0, "wall_s": (
                    None if rng.rand() < 0.2 else float(rng.uniform(20, 90)))}
    return res


@pytest.mark.parametrize("seed", range(4))
def test_rung_and_masked_pickers_match_jax(seed):
    rng = np.random.RandomState(400 + seed)
    for _ in range(20):
        sweep = _sweep(rng)
        for max_delta in (0.05, 0.2):
            assert (op.pick_quality_matched_rung(sweep, max_delta=max_delta)
                    == jop.pick_quality_matched_rung(sweep,
                                                     max_delta=max_delta))
        res = _results(rng)
        for max_delta in (0.05, 0.1):
            assert (op.pick_masked_point(res, max_delta)
                    == jop.pick_masked_point(res, max_delta))


@pytest.mark.parametrize("name", ["sample_sweep.json", "results.json",
                                  "results_100k.json"])
def test_rung_and_masked_pickers_match_jax_on_recorded_files(name):
    paths = glob.glob(os.path.join(ROOT, "runs", "*", name))
    assert paths
    for p in paths:
        with open(p) as fh:
            doc = json.load(fh)
        assert (op.pick_quality_matched_rung(doc)
                == jop.pick_quality_matched_rung(doc))
        assert op.pick_masked_point(doc) == jop.pick_masked_point(doc)


def test_filter_roll_matches_the_roll_segment_exactly():
    """JAX's _filter_roll selects by substring, so roll_k=2 also takes the
    roll25 points (ROADMAP.md C); the port takes only roll2's."""
    td = {"refresh": 25, "keyframe_rung": "32+64", "modes": {
        "s_delta_16_roll2": {"delta_psnr_vs_gt": 0.2},
        "s_delta_8_roll25": {"delta_psnr_vs_gt": 0.01},
        "s_delta_16_roll4": {"delta_psnr_vs_gt": 0.01},
        "s_delta_16": {"delta_psnr_vs_gt": 0.01}}}
    assert set(jop._filter_roll([td], 2)[0]["modes"]) == {
        "s_delta_16_roll2", "s_delta_8_roll25"}
    assert set(op._filter_roll([td], 2)[0]["modes"]) == {"s_delta_16_roll2"}
    for k in (0, 4, 25):
        assert (op._filter_roll([td], k)[0]["modes"]
                == jop._filter_roll([td], k)[0]["modes"])
    # the fault changes the pick: roll2's own evidence fails the gate
    assert jop.pick_temporal_mode_configs([td], 32, 25, roll_k=2)[
        "comp"]["quality_ok"]
    assert not op.pick_temporal_mode_configs([td], 32, 25, roll_k=2,
                                             **JAX_CONSTS)["comp"][
        "quality_ok"]


@pytest.mark.parametrize("rung,roll", [("32+64", 4), ("16+32", 16),
                                       (None, 8)])
def test_frozen_torso_cost_gains_the_rolling_keyframe_share(rung, roll):
    """JAX prices a frozen-z torso under a both-field roll without the
    1/roll keyframe share it charges a live torso (ROADMAP.md C); the
    port adds it: the mean over the two fields grows by kf_width/(2 roll).
    Every other point costs the same."""
    kf_width = sum(map(int, rung.split("+"))) if rung else 48
    for key, extra in ((f"s_delta_16_kt40_roll{roll}_fz", True),
                       (f"s_delta_16_kt40_roll{roll}", False),
                       ("s_delta_16_kt40_fz", False)):
        td = {"refresh": 25, "modes": {key: {"delta_psnr_vs_gt": 0.0}}}
        if rung:
            td["keyframe_rung"] = rung
        want = jop.pick_temporal_points(td, 25)["cost_comp"]
        got = op.pick_temporal_points(td, 25, **JAX_CONSTS)["cost_comp"]
        if extra:
            assert got == pytest.approx(want + kf_width / (2.0 * roll),
                                        abs=1e-12)
        else:
            assert got == want


_COMP_PICK = ("s_delta_comp", "s_delta_torso_comp", "delta_keep_comp",
              "delta_keep_torso_comp", "freeze_z_torso_comp",
              "roll_k_torso_comp", "roll_k_comp", "uni_frac_comp",
              "kf_blend_comp", "dilate_every_comp", "head_parse_comp",
              "cost_comp", "fps_delta_comp", "fps_ratio_comp")


@pytest.mark.parametrize("seed", range(3))
def test_fz_roll_evidence_differs_from_jax_only_in_the_composite_pick(seed):
    """On evidence with frozen-z rolling points the port agrees with JAX
    on every key but the composite pick, and picks the gated point of
    least (banded measured speed, corrected cost, s_delta)."""
    rng = np.random.RandomState(500 + seed)
    for _ in range(6):
        td = _evidence(rng, fz_roll=True)
        want = jop.pick_temporal_points(td, td["refresh"])
        got = op.pick_temporal_points(td, td["refresh"], **JAX_CONSTS)
        assert {k: v for k, v in got.items() if k not in _COMP_PICK} == {
            k: v for k, v in want.items() if k not in _COMP_PICK}
        kfw = sum(map(int, td["keyframe_rung"].split("+"))) if td.get(
            "keyframe_rung") else 48
        base = td.get("fps_full_warm")
        ranked = []
        for k, v in td["modes"].items():
            pt = op.parse_mode_key(k, "s_delta_")
            if pt is None or v.get("delta_psnr_vs_gt", 99.0) > 0.05:
                continue
            cost = op.mode_cost(pt, kfw, 5.6, 1.0)
            fps = v.get("fps_delta_frames")
            r = fps / base if fps and base else None
            ranked.append(((0, -round(r * 4) / 4, cost, pt["s"]) if r
                           else (1, 0.0, cost, pt["s"]), pt, cost))
        if ranked:
            _, pt, cost = min(ranked, key=lambda x: x[0])
            assert got["cost_comp"] == cost
            assert (got["s_delta_comp"], got["freeze_z_torso_comp"],
                    got["roll_k_comp"]) == (pt["s"], pt["fz"], pt["roll"])
        else:
            assert got["cost_comp"] is None


def test_mode_key_round_trips_the_grammar():
    rng = np.random.RandomState(7)
    for _ in range(200):
        k = _mode_key(rng, head=False, fz_roll=True)
        pt = op.parse_mode_key(k, "s_delta_")
        assert pt is not None and op.mode_key(pt) == k
    assert op.parse_mode_key("s_delta_16_q2", "s_delta_") is None
    assert op.parse_mode_key("head_only_s_delta_16", "s_delta_") is None


def _fitted_modes(prefix, s_values, fixed, dil, b, kf_width, suffix="",
                  noise=0.0, rng=None):
    modes = {}
    for s in s_values:
        k = f"{prefix}{s}{suffix}"
        pt = op.parse_mode_key(k, prefix)
        ms = b * op.mode_cost(pt, kf_width, fixed, dil)
        if noise:
            ms *= 1.0 + noise * rng.randn()
        modes[k] = {"fps_delta_frames": 1000.0 / ms}
    return modes


@pytest.mark.parametrize("prefix,suffix,live", [
    ("s_delta_", "", 2), ("s_delta_", "_d2", 2), ("s_delta_", "_kt40_fz", 1),
    ("head_only_s_delta_", "", 1), ("head_only_s_delta_", "_k60_d3", 1)])
def test_fit_delta_cost_recovers_the_cost_constants(prefix, suffix, live):
    """Delta-frame ms made from the cost model itself (b ms a sample
    unit) give back its constants; the dilation's ms gives dil."""
    kf_width, b, fixed, dil = 96, 0.9, 7.0, 1.5
    modes = _fitted_modes(prefix, (32, 16, 24), fixed, dil, b, kf_width,
                          suffix)
    c = 0.5 if "_fz" in suffix else 1.0
    fit = op.fit_delta_cost(modes, prefix, kf_width,
                            dilation_ms=dil * b * c / live)
    assert fit["ms_per_sample"] == pytest.approx(b, rel=1e-9)
    assert fit["fixed"] == pytest.approx(fixed, rel=1e-9)
    assert fit["dil"] == pytest.approx(dil, rel=1e-9)
    assert fit["s_delta"] == [16, 24, 32]
    # one s_delta value is no fit; nor are times that fall with s
    assert op.fit_delta_cost(dict(list(modes.items())[:1]), prefix,
                             kf_width) is None
    rev = {k: {"fps_delta_frames": 1.0 / v["fps_delta_frames"]}
           for k, v in modes.items()}
    assert op.fit_delta_cost(rev, prefix, kf_width) is None


def test_picker_prices_points_with_the_files_own_fit():
    """A file's delta_cost_fit gives the cost constants of its kind; the
    caller's values, then the card defaults, come before and after it."""
    td = {"refresh": 25, "keyframe_rung": "32+64", "modes": {
        "s_delta_16_d2": {"delta_psnr_vs_gt": 0.0},
        "head_only_s_delta_16_d2": {"delta_psnr_vs_gt": 0.0,
                                    "psnr_temporal_vs_full": 45.0}},
        "delta_cost_fit": {"comp": {"fixed": 9.0, "dil": 2.0},
                           "head": {"fixed": 3.0, "dil": 0.5}}}
    got = op.pick_temporal_points(td, 25)
    comp = op.parse_mode_key("s_delta_16_d2", "s_delta_")
    head = op.parse_mode_key("head_only_s_delta_16_d2", "head_only_s_delta_")
    assert got["cost_comp"] == op.mode_cost(comp, 96, 9.0, 2.0)
    assert got["cost_head"] == op.mode_cost(head, 96, 3.0, 0.5)
    assert op.pick_temporal_points(td, 25, fixed=5.6, dil=1.0)[
        "cost_comp"] == op.mode_cost(comp, 96, 5.6, 1.0)
    del td["delta_cost_fit"]
    assert op.pick_temporal_points(td, 25)["cost_comp"] == op.mode_cost(
        comp, 96, op.FIXED_CARD, op.DIL_CARD)
    td["delta_cost_fit"] = {"comp": None}
    assert op.cost_constants(td, "comp") == (op.FIXED_CARD, op.DIL_CARD)


def _split_file(path, split, comp_db, head_db, refresh=25):
    """One evidence file of ``split`` with one composite and one head
    point, at ``comp_db`` / ``head_db`` dB against GT."""
    td = {"refresh": refresh, "split": split, "keyframe_rung": "16+32",
          "fps_full_warm": 3.0, "fps_head_full_warm": 6.0, "modes": {
              "s_delta_32": {"delta_psnr_vs_gt": comp_db,
                             "fps_delta_frames": 40.0},
              "head_only_s_delta_32": {"delta_psnr_vs_gt": head_db,
                                       "psnr_temporal_vs_full": 45.0,
                                       "fps_delta_frames": 50.0}}}
    with open(path, "w") as fh:
        json.dump(td, fh)


@pytest.mark.parametrize("mode", ["comp", "head"])
def test_a_driving_clip_file_overrules_the_val_clip(mode, tmp_path):
    """C2: the val clip holds the gate, the driving clip (``split``
    train) fails it at the same refresh: the gate stays closed, where the
    JAX picker opens it on the val file. Where the driving clip holds it
    and the val clip fails, it opens; a directory of val files alone
    decides as before."""
    d = tmp_path / "both"
    d.mkdir()
    _split_file(d / "temporal_delta.json", "val", -0.134, -0.1)
    _split_file(d / "temporal_delta_drive.json", "train", 0.151, 0.2)
    assert jop.gated_video_config(str(d), mode) is not None
    assert op.gated_video_config(str(d), mode) is None
    _split_file(d / "temporal_delta.json", "val", 0.151, 0.2)
    _split_file(d / "temporal_delta_drive.json", "train", -0.134, -0.1)
    conf = op.gated_video_config(str(d), mode)
    assert conf is not None and conf["s_delta"] == 32
    v = tmp_path / "val_only"
    v.mkdir()
    _split_file(v / "temporal_delta.json", "val", -0.134, -0.1)
    assert op.gated_video_config(str(v), mode) == jop.gated_video_config(
        str(v), mode) is not None


def test_driving_clip_evidence_decides_each_mode_on_its_own_points(tmp_path):
    """A driving-clip file with composite points only leaves the head gate
    to the val file's head points, and the other way round."""
    _split_file(tmp_path / "temporal_delta.json", "val", -0.1, -0.1)
    td = {"refresh": 25, "split": "train", "keyframe_rung": "16+32",
          "modes": {"s_delta_32": {"delta_psnr_vs_gt": 0.3}}}
    with open(tmp_path / "temporal_delta_drive.json", "w") as fh:
        json.dump(td, fh)
    assert op.gated_video_config(str(tmp_path), "comp") is None
    assert op.gated_video_config(str(tmp_path), "head") is not None


@pytest.mark.parametrize("with_gt", [True, False])
def test_head_gate_reads_the_same_bounds_agreement(with_gt):
    """C3: a head row 30 dB from the full render at the config's bounds
    but 45 dB from the full render in its own tightened bounds opens the
    head gate where the row also holds its delta against GT (which
    carries the cost of the tighter bounds); without that delta the gate
    reads the config-bounds agreement and stays closed. The JAX picker,
    which ignores the new field, keeps it closed."""
    row = {"psnr_temporal_vs_full": 30.0,
           "psnr_temporal_vs_full_same_bounds": 45.0,
           "fps_delta_frames": 50.0}
    if with_gt:
        row["delta_psnr_vs_gt"] = 0.01
    td = {"refresh": 25, "keyframe_rung": "16+32",
          "modes": {"head_only_s_delta_16": row}}
    got = op.pick_temporal_points(td, 25)
    assert got["head_video_quality_ok"] is with_gt
    assert got["head_agreement_db_vs_full"] == {
        "s_delta_16": 45.0 if with_gt else 30.0}
    assert not jop.pick_temporal_points(td, 25)["head_video_quality_ok"]
    assert op.head_agreement({}) is None
