"""Evidence-gated eval operating points (counterpart of
idealnerf_tpu/eval/operating_points.py, which is pure Python: this is a
copy, not an import).

Every fast rendering mode is quality-gated: its configuration (sample
rung, keyframe interval, delta sample count, ray keep fraction) is used
only where a measurement on a trained checkpoint shows that its quality
cost is within tolerance. The measurements are JSON evidence files
written by the port's harness: ``scripts/sample_sweep.py`` (per-rung
PSNR/SSIM of the val render), ``scripts/rehearsal.py`` (the per-frame fast
modes) and ``scripts/temporal_delta.py`` (the temporal keyframe + delta
video against the per-frame full render and against ground truth). This
module is their one reader: ``cli/serve.py --auto_temporal`` and
``cli/eval_reenact.py --auto_temporal`` take the gated configuration from
it.

Three faults of the JAX module are fixed here: ``_filter_roll`` matches
the ``roll<K>`` segment of a mode key exactly (``roll2`` does not select
``roll25``), the cost model adds the rolling keyframe share to a frozen-z
torso as it does to a live one, and evidence of the held-out driving clip
overrules evidence of the val clip (``_drive_first``): a gate the driving
clip fails stays closed whatever the val clip says. One rule differs on
purpose: where a head row holds the agreement with a full render in the
temporal mode's own tightened bounds (``psnr_temporal_vs_full_same_bounds``,
written by the harness under ``--tighten``) and a PSNR-vs-GT delta, the
head gate reads that agreement (``head_agreement``), so that it measures
the temporal error alone while the delta against GT holds the cost of the
tighter bounds. The cost model's constants (the fixed work of a delta
frame and the band dilation's share of it, in sample-equivalents) are
keyword arguments: an evidence file carries the fit of its own run
(``fit_delta_cost``), else the card's defaults below apply.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

# evidence filename pattern: every scripts/temporal_delta.py output in a
# subject's run directory (the canonical temporal_delta.json and side
# studies such as temporal_delta_drive.json); the mode keys inside carry
# the configuration
TEMPORAL_EVIDENCE_FILES = "temporal_delta*.json"

# The delta-frame cost model's constants on the card, in sample-
# equivalents (one unit = the ms of one more delta sample per field):
# a live field's fixed work per delta frame (temporal inverse CDF, band
# update and dilation, cache scatters) and the band dilation's share of
# it. scripts/temporal_delta.py's composite fit on the long rehearsal's
# 60-frame driving clip (450x450, s_delta 32 and 16; NVIDIA H100 80GB
# HBM3, 700 W; PERF.md §5); an evidence file's own fit wins.
FIXED_CARD = 7.095
DIL_CARD = 1.234

GATE_DB = 0.05       # composite and head: PSNR-vs-GT loss allowed, dB
AGREEMENT_DB = 40.0  # head: least PSNR against the per-frame full render

# the split scripts/temporal_delta.py records for a run on the driving
# clip (--split train --subject_dir <drive dir>): the clip held out from
# the val split the model was selected on
DRIVE_SPLIT = "train"


def load_temporal_evidence(evidence_dir: str) -> list:
    """All temporal evidence dicts found in ``evidence_dir``."""
    cands = []
    for p in sorted(glob.glob(
            os.path.join(evidence_dir, TEMPORAL_EVIDENCE_FILES))):
        with open(p) as fh:
            cands.append(json.load(fh))
    return cands


def pick_quality_matched_rung(sweep, ref_prefix="64+", max_delta=0.05):
    """Cheapest (N_samples, N_importance) rung in a sample_sweep.json
    dict whose measured PSNR delta vs the paper schedule is within
    ``max_delta`` dB. Cost model: coarse s + fine (s+imp) point evals.
    Returns (s, imp, rung_key, delta) or None."""
    ref_key = next((k for k in sweep
                    if k.startswith(ref_prefix) and "_tight" not in k),
                   None)
    if ref_key is None:
        return None
    best = None
    for k, v in sweep.items():
        delta = v.get(f"delta_psnr_vs_{ref_key}")
        if delta is None or delta > max_delta:
            continue
        s, imp = map(int, k.replace("_tight", "").split("+"))
        cost = 2 * s + imp
        if best is None or cost < best[0]:
            best = (cost, s, imp, k, delta)
    return best[1:] if best else None


def pick_masked_point(results: dict, max_delta: float = 0.05):
    """Fastest measured-gated prior-masked eval config from a rehearsal
    results.json (scripts/rehearsal.py phase_eval rows
    ``delta_psnr_masked_<keep>[_hp|_occ]`` with per-row ``wall_s``).

    Returns (keep_fraction, prior_kind, delta_db) or None, where
    prior_kind is "rect" (face-rect ∪ torso-parse union), "hp"
    (parse-silhouette prior) or "occ" (field-occupancy zero-mass cut).
    Ranking: smallest measured wall_s among gated rows; rows without a
    measured wall fall back to the cost model (fine cost ∝ keep), ranked
    after every measured row."""
    kind_rank = {"occ": 0.0, "hp": 0.0005, "rect": 0.001}
    cands = []
    for keep in (28, 40, 60):
        for kind in ("occ", "hp", "rect"):
            key = (f"masked_{keep}"
                   + ("" if kind == "rect" else f"_{kind}"))
            d = results.get(f"delta_psnr_{key}")
            if d is None or d > max_delta:
                continue
            wall = (results.get(key) or {}).get("wall_s")
            rank = ((0, wall) if wall
                    else (1, keep / 100.0 + kind_rank[kind]))
            cands.append((rank, (keep / 100.0, kind, d)))
    cands.sort(key=lambda c: c[0])
    return cands[0][1] if cands else None


# ------------------------------------------------------ temporal mode keys

_TAGS = dict(roll=("roll", 1), rt=("rt", 1), kt=("keep_t", 100.0),
             k=("keep", 100.0), u=("uni", 100.0), b=("blend", 100.0),
             d=("dil", 1))


def parse_mode_key(k: str, prefix: str) -> Optional[dict]:
    """Mode key -> point dict, or None when ``k`` is not a ``prefix`` key
    of this grammar: "<s>[t<st>][_k<pct>][_kt<pct>][_u<pct>][_b<pct>]
    [_d<k>][_roll<K>][_rt<K>][_fz][_hp]" — delta samples (head, torso),
    delta keep (head, torso), uniform fraction, keyframe-CDF blend,
    dilation thinning, both-field rolling refresh, torso refresh-only
    roll, frozen-z torso, parse-silhouette priors; all from
    scripts/temporal_delta.py flags."""
    if not k.startswith(prefix):
        return None
    rest = k[len(prefix):].split("_")
    pt = dict(keep=1.0, keep_t=None, uni=0.25, blend=0.0, fz=False,
              dil=1, hp=False, rt=0, roll=0)
    for seg in rest[1:]:
        if seg == "fz":  # boolean tag: torso frozen-z delta frames
            pt["fz"] = True
            continue
        if seg == "hp":  # boolean tag: parse-silhouette priors
            pt["hp"] = True
            continue
        tag = next((t for t in ("roll", "rt", "kt", "k", "u", "b", "d")
                    if seg.startswith(t) and seg[len(t):].isdigit()), None)
        if tag is None:
            return None
        name, div = _TAGS[tag]
        v = int(seg[len(tag):])
        pt[name] = v if div == 1 else v / div
    seg = rest[0].split("t")
    if len(seg) == 1 and seg[0].isdigit():
        pt.update(s=int(seg[0]), st=None)
    elif len(seg) == 2 and seg[0].isdigit() and seg[1].isdigit():
        pt.update(s=int(seg[0]), st=int(seg[1]))
    else:
        return None
    return pt


def mode_key(pt: dict) -> str:
    """The composite mode key of a point dict (parse_mode_key's inverse)."""
    return (f"s_delta_{pt['s']}"
            + ("" if pt["st"] is None else f"t{pt['st']}")
            + ("" if pt["keep"] >= 1.0 else f"_k{round(pt['keep'] * 100)}")
            + ("" if pt["keep_t"] is None
               else f"_kt{round(pt['keep_t'] * 100)}")
            + ("" if pt["uni"] == 0.25 else f"_u{round(pt['uni'] * 100)}")
            + ("" if pt["blend"] <= 0 else f"_b{round(pt['blend'] * 100)}")
            + ("" if pt["dil"] <= 1 else f"_d{pt['dil']}")
            + ("" if pt["roll"] <= 0 else f"_roll{pt['roll']}")
            + ("" if pt["rt"] <= 0 else f"_rt{pt['rt']}")
            + ("_fz" if pt["fz"] else "")
            + ("_hp" if pt["hp"] else ""))


def mode_cost(pt: dict, kf_width: int, fixed: float, dil: float) -> float:
    """Delta-frame cost of a point in sample-equivalents: the mean over
    the two fields of (fixed work + samples x kept fraction); the torso
    defaults to the head's values, and a head-only point prices its one
    field twice. ``dilate_every`` amortizes the dilation share ``dil`` of
    each live field's ``fixed`` work. A frozen-z torso evaluates the
    keyframe grid (``kf_width`` samples) and pays no fixed work; a torso
    refresh-only roll re-renders 1/rt of its rays at the keyframe
    schedule; a both-field roll adds 1/roll of the keyframe schedule to
    each field, the frozen-z torso included."""
    s, st = pt["s"], pt["st"]
    kt = pt["keep_t"] if pt["keep_t"] is not None else pt["keep"]
    live_fixed = fixed - dil * (1.0 - 1.0 / pt["dil"])
    roll = kf_width / pt["roll"] if pt["roll"] else 0.0
    head_cost = live_fixed + s * pt["keep"] + roll
    if pt["rt"]:
        torso_cost = kf_width / pt["rt"]
    elif pt["fz"]:
        torso_cost = kf_width * kt + roll
    else:
        torso_cost = live_fixed + (st if st is not None else s) * kt + roll
    return (head_cost + torso_cost) / 2.0


def _kf_width(td) -> int:
    rung = td.get("keyframe_rung") if td else None
    return sum(map(int, rung.split("+"))) if rung else 48


def _live_fields(pt: dict, composite: bool) -> int:
    """Fields whose band a delta frame dilates."""
    return 1 + int(composite and not pt["fz"] and not pt["rt"])


def fit_delta_cost(modes: dict, prefix: str, kf_width: int,
                   dilation_ms: Optional[float] = None) -> Optional[dict]:
    """Fit of the cost model's constants to one run's measured delta
    frames: ms = b x (sample term + c x fixed), where the sample term is
    ``mode_cost`` without fixed work and c its coefficient of ``fixed``,
    by least squares over the ``prefix`` modes (at least two distinct
    s_delta). ``dilation_ms``: the measured ms of one field's band
    dilation, which gives ``dil`` in the same units; ``fixed`` is then the
    fixed work with the dilation counted on every frame.

    Returns {ms_per_sample, fixed_ms, fixed, dilation_ms, dil, s_delta,
    points} or None (fewer than two s_delta values, or a fit that is not
    positive: per-frame wall times too noisy to order the points)."""
    rows = []
    for k, v in modes.items():
        pt = parse_mode_key(k, prefix)
        fps = (v or {}).get("fps_delta_frames")
        if pt is None or not fps:
            continue
        x = mode_cost(pt, kf_width, 0.0, 0.0)
        c = mode_cost(pt, kf_width, 1.0, 0.0) - x
        amort = c * (1.0 - 1.0 / pt["dil"])
        rows.append((pt, x, c, amort, 1000.0 / fps))
    if len({pt["s"] for pt, *_ in rows}) < 2:
        return None
    a = np.array([[x, c] for _, x, c, _, _ in rows])
    t = np.array([r[-1] for r in rows])
    (b, g), *_ = np.linalg.lstsq(a, t, rcond=None)
    if not (b > 0 and g >= 0):
        return None
    composite = not prefix.startswith("head")
    pt0, _, c0, amort0, _ = rows[0]
    dil = None
    if dilation_ms is not None and c0 > 0:
        # each live field dilates once a frame: n x dilation_ms = b x c x dil
        dil = _live_fields(pt0, composite) * dilation_ms / (b * c0)
    # the fitted g/b is the fixed work net of the amortized dilation
    fixed = g / b + (dil or 0.0) * amort0 / c0
    return {"ms_per_sample": float(b), "fixed_ms": float(g * c0),
            "fixed": float(fixed), "dilation_ms": dilation_ms,
            "dil": None if dil is None else float(dil),
            "s_delta": sorted({pt["s"] for pt, *_ in rows}),
            "points": [[float(x), float(ms)] for _, x, _, _, ms in rows]}


def cost_constants(td, kind: str, fixed=None, dil=None) -> tuple:
    """(fixed, dil) for ``kind`` ("comp" or "head") points of ``td``: the
    caller's values, else the file's own fit, else the card defaults."""
    fit = ((td or {}).get("delta_cost_fit") or {}).get(kind) or {}
    if fixed is None:
        fixed = fit.get("fixed")
    if dil is None:
        dil = fit.get("dil")
    return (FIXED_CARD if fixed is None else fixed,
            DIL_CARD if dil is None else dil)


def head_agreement(v: dict) -> Optional[float]:
    """The agreement (dB) the head gate reads from a head row: the one
    against a full render in the same bounds where the row has it and a
    PSNR-vs-GT delta to hold the bounds' own cost, else the one against
    the full render at the config's bounds (None where the row has
    neither)."""
    same = v.get("psnr_temporal_vs_full_same_bounds")
    if same is not None and v.get("delta_psnr_vs_gt") is not None:
        return same
    return v.get("psnr_temporal_vs_full")


def pick_temporal_points(td, refresh, default_s_delta=32, fps_trust=True,
                         fixed=None, dil=None):
    """Per-mode temporal operating points from temporal_delta.json
    evidence (scripts/temporal_delta.py, trained checkpoints).

    For each of composite / head-only, picks the cheapest measured point
    whose quality gate holds - composite: <= 0.05 dB PSNR-vs-GT delta;
    head-only: >= 40 dB agreement with the per-frame full render
    (``head_agreement``) and, where the evidence has head_imgs ground
    truth, <= 0.05 dB PSNR-vs-GT delta - provided the evidence was
    measured at this keyframe interval (drift grows with refresh). Falls
    back to ``default_s_delta`` with the quality gate closed when no
    measured point holds. ``fixed``/``dil``: the cost model's constants
    (``cost_constants``)."""
    modes = td.get("modes", {}) if td else {}
    usable = bool(td) and td.get("refresh") == refresh
    kf_width = _kf_width(td)
    consts = {kind: cost_constants(td, kind, fixed, dil)
              for kind in ("comp", "head")}

    def _cost(pt, prefix):
        kind = "head" if prefix.startswith("head") else "comp"
        return mode_cost(pt, kf_width, *consts[kind])

    def _fps_ratio(v, prefix):
        # run-normalized speed: each file records its own full-render
        # fps in the same run, so delta_fps / full_fps is comparable
        # across files where raw fps is not
        if not fps_trust:
            return None
        fps = v.get("fps_delta_frames")
        base = (td or {}).get("fps_head_full_warm"
                              if prefix.startswith("head") else
                              "fps_full_warm")
        if fps and base:
            return fps / base
        return None

    def _rank(pv, prefix):
        # the measured speedup ranks points where the evidence has fps,
        # banded to quarter steps so that per-frame-loop noise falls
        # through to the cost model; the cost model alone otherwise
        p, v = pv
        r = _fps_ratio(v, prefix)
        if r:
            return (0, -round(r * 4) / 4, _cost(p, prefix), p["s"])
        return (1, 0.0, _cost(p, prefix), p["s"])

    def _pts(prefix):
        pts = [(p, v) for k, v in modes.items()
               if (p := parse_mode_key(k, prefix)) is not None]
        return sorted(pts, key=lambda pv: _rank(pv, prefix))

    comp = _pts("s_delta_")
    head = _pts("head_only_s_delta_")
    comp_ok = [(p, v) for p, v in comp
               if usable and v.get("delta_psnr_vs_gt", 99.0) <= GATE_DB]
    head_ok = [(p, v) for p, v in head
               if usable
               and (head_agreement(v) or 0.0) >= AGREEMENT_DB
               and v.get("delta_psnr_vs_gt", 0.0) <= GATE_DB]
    comp_ok_pts = [p for p, _ in comp_ok]
    head_ok_pts = [p for p, _ in head_ok]
    c0 = comp_ok_pts[0] if comp_ok_pts else None
    h0 = head_ok_pts[0] if head_ok_pts else None

    return {
        "refresh_measured": td.get("refresh") if td else None,
        "keyframe_rung": td.get("keyframe_rung") if usable else None,
        "evidence_tightened_bounds": (
            bool(td.get("tightened_bounds")) if td else None),
        "evidence_at_this_refresh": usable,
        "composite_delta_db_vs_gt": {
            mode_key(p): v.get("delta_psnr_vs_gt") for p, v in comp},
        "head_agreement_db_vs_full": {
            mode_key(p): head_agreement(v) for p, v in head},
        "s_delta_comp": c0["s"] if c0 else default_s_delta,
        "s_delta_torso_comp": c0["st"] if c0 else None,
        "delta_keep_comp": c0["keep"] if c0 else 1.0,
        "delta_keep_torso_comp": c0["keep_t"] if c0 else None,
        "freeze_z_torso_comp": c0["fz"] if c0 else False,
        "roll_k_torso_comp": c0["rt"] if c0 else 0,
        "roll_k_comp": c0["roll"] if c0 else 0,
        "roll_k_head": h0["roll"] if h0 else 0,
        "uni_frac_comp": c0["uni"] if c0 else 0.25,
        "kf_blend_comp": c0["blend"] if c0 else 0.0,
        "dilate_every_comp": c0["dil"] if c0 else 1,
        "head_parse_comp": c0["hp"] if c0 else False,
        "cost_comp": _cost(c0, "s_delta_") if c0 else None,
        "fps_delta_comp": (comp_ok[0][1].get("fps_delta_frames")
                           if comp_ok else None),
        "fps_ratio_comp": (_fps_ratio(comp_ok[0][1], "s_delta_")
                           if comp_ok else None),
        "composite_video_quality_ok": bool(comp_ok_pts),
        "s_delta_head": h0["s"] if h0 else default_s_delta,
        "delta_keep_head": h0["keep"] if h0 else 1.0,
        "uni_frac_head": h0["uni"] if h0 else 0.25,
        "kf_blend_head": h0["blend"] if h0 else 0.0,
        "dilate_every_head": h0["dil"] if h0 else 1,
        "head_parse_head": h0["hp"] if h0 else False,
        "cost_head": _cost(h0, "head_only_") if h0 else None,
        "fps_delta_head": (head_ok[0][1].get("fps_delta_frames")
                           if head_ok else None),
        "fps_ratio_head": (_fps_ratio(head_ok[0][1], "head_only_")
                           if head_ok else None),
        "head_video_quality_ok": bool(head_ok_pts),
    }


def _roll_of(k: str) -> int:
    """The K of a mode key's ``roll<K>`` segment, 0 without one."""
    return next((int(seg[4:]) for seg in k.split("_")
                 if seg.startswith("roll") and seg[4:].isdigit()), 0)


def _filter_roll(cands, roll_k):
    """Evidence filtered to one rolling cadence: roll_k=0 keeps only
    keyframed (non-roll) mode keys; roll_k=K keeps only the keys measured
    at exactly that cadence (a keyframed gate says nothing about
    unbounded-horizon rolling drift)."""
    return [dict(td, modes={k: v for k, v in (td.get("modes") or
                                              {}).items()
                            if _roll_of(k) == roll_k})
            for td in cands]


_PREFIX = {"comp": "s_delta_", "head": "head_only_s_delta_"}


def _drive_first(cands, mode: str) -> list:
    """The files that decide ``mode``'s gate: of the files holding a
    point of that mode, the driving-clip ones (``split`` DRIVE_SPLIT)
    where there are any, else all of them. So a val-clip file cannot open
    a gate that a driving-clip file measured."""
    has = [td for td in cands
           if any(parse_mode_key(k, _PREFIX[mode]) is not None
                  for k in td.get("modes") or {})]
    drive = [td for td in has if td.get("split") == DRIVE_SPLIT]
    return drive or has


def pick_temporal_mode_configs(cands, default_s_delta, default_refresh,
                               roll_k: int = 0, fixed=None, dil=None):
    """Per-mode temporal configuration across several evidence files
    (scripts/temporal_delta.py runs at different keyframe intervals).

    For composite and head-only independently: among the files whose
    quality gate holds (pick_temporal_points), prefer the largest
    keyframe interval - keyframe cost amortizes over more frames - with
    that file's cheapest quality-holding point and its keyframe rung.
    Only the files ``_drive_first`` keeps for the mode take part. Falls
    back to the defaults with the gate closed.

    ``roll_k``: 0 (default) selects among keyframed points only; K > 1
    among points measured at the roll<K> rolling cadence."""
    cands = _filter_roll(cands, roll_k)
    # run-speed sanity: a file whose own full-render fps is at most
    # half the median of its siblings gets its measured fps ignored; its
    # quality rows stay valid
    bases = [td.get("fps_full_warm") for td in cands
             if td.get("fps_full_warm")]
    med = sorted(bases)[len(bases) // 2] if bases else None

    out = {}
    for mode, ok_key, sd_key in (
            ("comp", "composite_video_quality_ok", "s_delta_comp"),
            ("head", "head_video_quality_ok", "s_delta_head")):
        best = None
        for td in _drive_first(cands, mode):
            trust = bool(med and td.get("fps_full_warm")
                         and td["fps_full_warm"] >= 0.5 * med)
            tq = pick_temporal_points(td, td.get("refresh"),
                                      default_s_delta, fps_trust=trust,
                                      fixed=fixed, dil=dil)
            if not tq[ok_key]:
                continue
            st = (tq.get("s_delta_torso_comp") if mode == "comp"
                  else None)
            # across files the measured speedup counts in whole units
            # only (runs differ), else the cost model decides
            ratio = tq.get(f"fps_ratio_{mode}")
            cost = ((-round(ratio), tq[f"cost_{mode}"]) if ratio
                    else (0.0, tq[f"cost_{mode}"]))
            if (best is None or td["refresh"] > best["refresh"]
                    or (td["refresh"] == best["refresh"]
                        and cost < best["_cost"])):
                comp = mode == "comp"
                best = {"refresh": td["refresh"], "s_delta": tq[sd_key],
                        "s_delta_torso": st,
                        "delta_keep": tq[f"delta_keep_{mode}"],
                        "delta_keep_torso": (
                            tq.get("delta_keep_torso_comp") if comp
                            else None),
                        "freeze_z_torso": (
                            tq.get("freeze_z_torso_comp", False) if comp
                            else False),
                        "roll_k_torso": (
                            tq.get("roll_k_torso_comp", 0) if comp else 0),
                        "roll_k": tq.get(f"roll_k_{mode}", 0),
                        "uni_frac": tq[f"uni_frac_{mode}"],
                        "kf_blend": tq[f"kf_blend_{mode}"],
                        "dilate_every": tq[f"dilate_every_{mode}"],
                        "head_parse": tq[f"head_parse_{mode}"],
                        "keyframe_rung": tq["keyframe_rung"],
                        "_cost": cost}
        out[mode] = {
            "quality_ok": best is not None,
            "refresh": best["refresh"] if best else default_refresh,
            "s_delta": best["s_delta"] if best else default_s_delta,
            "s_delta_torso": best["s_delta_torso"] if best else None,
            "delta_keep": best["delta_keep"] if best else 1.0,
            "delta_keep_torso": best["delta_keep_torso"] if best else None,
            "freeze_z_torso": best["freeze_z_torso"] if best else False,
            "roll_k_torso": best["roll_k_torso"] if best else 0,
            "roll_k": best["roll_k"] if best else 0,
            "uni_frac": best["uni_frac"] if best else 0.25,
            "kf_blend": best["kf_blend"] if best else 0.0,
            "dilate_every": best["dilate_every"] if best else 1,
            "head_parse": best["head_parse"] if best else False,
            "keyframe_rung": best["keyframe_rung"] if best else None,
        }
    out["evidence"] = [
        {"refresh": td.get("refresh"),
         "keyframe_rung": td.get("keyframe_rung"),
         "tightened": bool(td.get("tightened_bounds")),
         "modes": {k: (v.get("delta_psnr_vs_gt")
                       if not k.startswith("head") else
                       v.get("psnr_temporal_vs_full"))
                   for k, v in td.get("modes", {}).items()}}
        for td in cands]
    return out


def gated_video_config(evidence_dir: str, mode: str,
                       default_s_delta: int = 32,
                       default_refresh: int = 25,
                       roll_k: int = 0, fixed=None,
                       dil=None) -> Optional[dict]:
    """The quality-gated temporal video configuration for ``mode``
    ("head" or "comp"), or None when no measured point holds the gate.

    Returns pick_temporal_mode_configs' dict for the mode (refresh,
    s_delta, s_delta_torso, delta_keep(_torso), freeze_z_torso,
    roll_k(_torso), uni_frac, kf_blend, dilate_every, head_parse,
    keyframe_rung, quality_ok), ready for eval.reenact and
    eval.stream.TemporalStream(operating_point=). ``roll_k``: require a
    point measured at that rolling cadence."""
    cands = load_temporal_evidence(evidence_dir)
    conf = pick_temporal_mode_configs(
        cands, default_s_delta, default_refresh, roll_k=roll_k,
        fixed=fixed, dil=dil)[mode]
    return conf if conf["quality_ok"] else None
