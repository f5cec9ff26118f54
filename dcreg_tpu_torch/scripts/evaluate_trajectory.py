"""evo_ape-equivalent trajectory scoring (counterpart of
``scripts/evaluate_trajectory.py``): ATE (aligned and raw), RPE and
registration recall (RRE < 5 deg and RTE < 0.2 m) from two TUM files,
plus the MapEval-style AC map accuracy when the scans and the map are
given.

Usage: python -m dcreg_tpu_torch.scripts.evaluate_trajectory GT.tum EST.tum
           [--delta 1] [--max-dt 0.02] [--scans S.npy --map M.npy]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..io.tum import ate, load_tum, map_accuracy, registration_recall, rpe


def associate(ts_gt, ts_est, max_dt=0.02):
    """Nearest-timestamp association (the evo/TUM convention), one to
    one: when several est frames share the same nearest GT frame, only
    the closest in time keeps the match."""
    best_for_gt = {}           # gt index -> (|dt|, est index)
    for i, t in enumerate(ts_est):
        j = int(np.argmin(np.abs(ts_gt - t)))
        dt = abs(float(ts_gt[j] - t))
        if dt <= max_dt and (j not in best_for_gt or dt < best_for_gt[j][0]):
            best_for_gt[j] = (dt, i)
    pairs = sorted((j, ie) for j, (_, ie) in best_for_gt.items())
    idx_gt = [j for j, _ in pairs]
    idx_est = [ie for _, ie in pairs]
    return np.asarray(idx_gt, int), np.asarray(idx_est, int)


def evaluate(gt_path, est_path, scans=None, map_xyz=None, delta: int = 1,
             max_dt: float = 0.02):
    """The scores of the trajectory in ``est_path`` against ``gt_path``,
    as the dict ``main`` prints; ``{"error": ...}`` when no frame
    associates.  ``scans`` (F, N, 3) body-frame frames and ``map_xyz``
    (M, 3) add the ``map_accuracy`` block."""
    ts_gt, P_gt = load_tum(gt_path)
    ts_est, P_est = load_tum(est_path)
    ig, ie = associate(ts_gt, ts_est, max_dt)
    if len(ig) == 0:
        return {"error": "no associated frames"}
    gt, est = P_gt[ig], P_est[ie]
    a_aligned = ate(est, gt, align=True)
    a_raw = ate(est, gt, align=False)
    rre, rte = rpe(est, gt, delta=delta)
    recall, _ = registration_recall(est, gt)
    out = {
        "frames": int(len(ig)),
        "ate_rmse_m": a_aligned["rmse"],
        "ate_mean_m": a_aligned["mean"],
        "ate_max_m": a_aligned["max"],
        "ate_raw_rmse_m": a_raw["rmse"],
        "rpe_rot_mean_deg": float(rre.mean()) if len(rre) else None,
        "rpe_trans_mean_m": float(rte.mean()) if len(rte) else None,
        "registration_recall": recall,
    }
    if scans is not None and map_xyz is not None:
        out["map_accuracy"] = map_accuracy(np.asarray(scans)[ie], P_est[ie],
                                           map_xyz)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--delta", type=int, default=1, help="RPE frame delta")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--scans", default=None,
                    help="(F, N, 3) .npy of body-frame frames -> adds the "
                         "MapEval-style AC map-accuracy block (needs --map)")
    ap.add_argument("--map", dest="map_path", default=None,
                    help="(M, 3) .npy reference map for --scans")
    args = ap.parse_args(argv)
    with_map = args.scans and args.map_path
    out = evaluate(args.gt, args.est,
                   scans=np.load(args.scans) if with_map else None,
                   map_xyz=np.load(args.map_path) if with_map else None,
                   delta=args.delta, max_dt=args.max_dt)
    if "error" in out:
        print(json.dumps(out))
        return 1
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
