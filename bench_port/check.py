"""The comparison that decides ``correct``: each answer of a sample drawn
from the seed against the plain reference (``reference/icp.py``), run on
the same inputs once the window has closed.

Each answer gives its gaps to the reference; over the sample every gap
is taken at its worst and the pose and residual gaps also at their third
quartile (``.q3``).  The cell's file under ``limits/`` names the numbers
compared, each with its limit; the others are printed for the record.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import icp as ref


def rot_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle of Ra^T Rb, from its skew part (arccos of the trace alone
    reads a float32 matrix's rounding as an angle of ~3e-4 rad)."""
    M = Ra.T @ Rb
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                              M[1, 0] - M[0, 1]])
    return float(np.arctan2(s, (np.trace(M) - 1.0) * 0.5))


def rel_gap(a: float, b: float) -> float:
    if math.isinf(a) and math.isinf(b):
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def pose_gaps(T_prog: np.ndarray, out: dict, k: int):
    """(translation gap m, rotation gap rad) of the program's pose against
    the reference's after the program's own number of steps."""
    R = out["R"][k].double().cpu().numpy()
    t = out["t"][k].double().cpu().numpy()
    return (float(np.linalg.norm(T_prog[:3, 3] - t)),
            rot_angle(T_prog[:3, :3], R))


def plane_gaps(T_prog: np.ndarray, out: dict, kappa: float) -> tuple:
    """How far the program's final pose moves the scan off the reference's
    planes: sqrt(d^T H d / sum of the rows' squared scales), with d the
    right perturbation (rotation vector, translation) from the
    reference's final pose (its own stop) to the program's and H the
    reference's last system: the weighted RMS displacement of the scan's
    points along their planes' normals, in metres.  Returned twice: over
    every direction, and over the directions the scan constrains (H's
    eigenvalues at least the largest over ``kappa``, the degeneracy
    threshold), where a pose is determined well enough to compare."""
    k = out["steps"]
    R = out["R"][k].double().cpu().numpy()
    t = out["t"][k].double().cpu().numpy()
    M = R.T @ T_prog[:3, :3]
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]])
    d = np.concatenate([w, R.T @ (T_prog[:3, 3] - t)])
    H = out["H"][k].double().cpu().numpy()
    w2 = max(out["w2"][k], 1e-30)
    lam, V = np.linalg.eigh(0.5 * (H + H.T))
    c = V.T @ d
    keep = lam >= lam[-1] / kappa
    return (float(np.sqrt(max(float(lam @ (c * c)), 0.0) / w2)),
            float(np.sqrt(max(float(lam[keep] @ (c[keep] ** 2)), 0.0) / w2)))


def frame_numbers(answer: dict, ref_out: dict, cond_full: bool,
                  kappa: float) -> dict:
    """The numbers of one localization frame: ``answer`` holds the
    program's pose, iterations, condition numbers and mask."""
    k = int(answer["iterations"])
    dt, dr = pose_gaps(answer["pose"], ref_out, k)
    ana = ref_out["ana"][k]
    cond = max(rel_gap(answer["cond_schur_rot"], ana["cond_rot"]),
               rel_gap(answer["cond_schur_trans"], ana["cond_trans"]))
    mask = (bool(answer["is_degenerate"]) != bool(ana["degenerate"])
            or [bool(m) for m in answer["degenerate_mask"]] != ana["mask"])
    out = {"trans_gap_m": dt, "rot_gap_rad": dr, "cond_gap_rel": cond,
           "mask_mismatch_frames": int(mask),
           "rmse_gap_rel": rel_gap(answer["rmse"], ref_out["rmse"][k])}
    out["plane_gap_m"], out["plane_gap_constrained_m"] = plane_gaps(
        answer["pose"], ref_out, kappa)
    if cond_full:
        out["cond_full_gap_rel"] = rel_gap(answer["cond_full"],
                                           ana["cond_full"])
    return out


def lane_numbers(answer: dict, out: dict, kappa: float) -> dict:
    """The numbers of one lane of a batch: pose and the final system."""
    k = int(answer["iterations"])
    dt, dr = pose_gaps(answer["pose"], out, k)
    H_ref = out["H"][k].double().cpu().numpy()
    H_gap = float(np.linalg.norm(answer["H_last"] - H_ref)
                  / max(np.linalg.norm(H_ref), 1e-30))
    plane, constrained = plane_gaps(answer["pose"], out, kappa)
    return {"trans_gap_m": dt, "rot_gap_rad": dr, "H_gap_rel": H_gap,
            "plane_gap_m": plane, "plane_gap_constrained_m": constrained,
            "rmse_gap_rel": rel_gap(answer["rmse"], out["rmse"][k])}


QUARTILED = ("plane_gap_m", "plane_gap_constrained_m", "rot_gap_rad",
             "trans_gap_m", "rmse_gap_rel")


def worst(rows: list) -> dict:
    """Per number the worst over ``rows`` (counts add up), and of the pose
    gaps also the third quartile over ``rows`` (``<name>.q3``): the few
    frames that sit at the iteration cap on a weakly constrained axis
    amplify any rounding into the worst gap, while a fault moves every
    answer, or a half of them, past the third quartile."""
    out = {}
    for r in rows:
        for name, v in r.items():
            if name.endswith("_frames"):
                out[name] = out.get(name, 0) + v
            else:
                out[name] = max(out.get(name, 0), v)
    for name in QUARTILED:
        if rows and name in rows[0]:
            out[name + ".q3"] = float(np.percentile([r[name] for r in rows],
                                                    75))
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number the cell's
    limits name at or under its limit (NaN fails)."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"the check gives no {sorted(missing)}")
    report = {n: {"value": numbers[n], "limit": limits[n]}
              for n in sorted(limits)}
    ok = all(v["value"] <= v["limit"] for v in report.values())
    return ok, report


def run_reference(answers, world, method, icp, precision="float64"):
    """The reference's numbers over the sampled answers: per answer its
    own numbers and ``iters_gap``, the steps the program took against
    the reference's own stop."""
    rows = []
    with torch.no_grad():
        for a in answers:
            out = ref.register(a["scan"], world, a["seed_pose"], method, icp,
                               precision, steps_at_least=int(a["iterations"]))
            kappa = icp["thresholds"]["cond_thresh"]
            if a["kind"] == "frame":
                rows.append(frame_numbers(a, out, a["cond_full_checked"],
                                          kappa))
            else:
                rows.append(lane_numbers(a, out, kappa))
            rows[-1]["iters_gap"] = abs(int(a["iterations"]) - out["steps"])
    return worst(rows)
