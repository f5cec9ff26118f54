"""Per-iteration timing and PCG solver telemetry (counterpart of
``dcreg_tpu/telemetry.py``): the fig18 ``pcg.txt`` artifact and the
``iter_time_ms`` column of iteration_details_with_dx.csv.

Both are replays of the recorded state:

  * stepped_iteration_times re-executes each recorded iteration
    (pose_k -> correspondences + build + analyze + solve) as its own call
    and times it on the host clock, the device synchronised;
  * pcg_replay_rows re-runs the 6x6 PCG on each iteration's recorded
    (H, g, P) in numpy on the host, with a direct solve beside it.

``degenerate_update_ratio`` = |projection of dx onto the detected
degenerate eigendirections| / |dx|; ``noise_amplification_factor`` =
kappa_target / cond(H).
"""
from __future__ import annotations

import time

import numpy as np
import torch

PCG_COLUMNS = [
    "timestamp", "cond_H", "cond_PH", "cond_improvement_ratio",
    "converged_iterations", "time_pcg_ms", "time_qr_direct_ms",
    "first_iter_residual", "first_iter_precond_residual",
    "first_iter_alpha", "first_iter_rz_product",
    "final_residual_pcg", "final_residual_qr_direct",
    "solution_diff_norm", "degenerate_update_ratio",
    "noise_amplification_factor", "is_degenerate",
]


def _pcg_numpy(H, g, P, max_iter=10, tol=1e-6):
    """Plain preconditioned CG on H x = g (solvers.pcg_unrolled semantics),
    returning (x, iters, |r|, first-iteration stats)."""
    x = np.zeros(6)
    r = g - H @ x
    z = P @ r
    p = z.copy()
    rz = float(r @ z)
    first = dict(residual=float(np.linalg.norm(r)),
                 precond_residual=float(np.linalg.norm(z)),
                 alpha=np.nan, rz=rz)
    iters = 0
    for it in range(max_iter):
        Hp = H @ p
        denom = float(p @ Hp)
        if abs(denom) < 1e-300:
            break
        alpha = rz / denom
        if it == 0:
            first["alpha"] = alpha
        x = x + alpha * p
        r = r - alpha * Hp
        iters = it + 1
        if np.linalg.norm(r) < tol:
            break
        z = P @ r
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, iters, float(np.linalg.norm(g - H @ x)), first


def pcg_replay_rows(log, kappa_target=10.0, max_iter=10, tol=1e-6,
                    t0=0.0, dt=0.1):
    """fig18 pcg.txt rows from one run's IterationLog (executed rows only).

    log must carry H (6x6), gradient (= -g), P_preconditioner, cond_full,
    cond_PH, pcg_iterations, is_degenerate, degenerate_mask, dx, and the
    Schur eigenvector blocks for the degenerate-subspace projection.
    """
    executed = np.asarray(log.executed)
    rows = []
    for k in np.nonzero(executed)[0]:
        H = np.asarray(log.H[k], np.float64)
        g = -np.asarray(log.gradient[k], np.float64)
        P = np.asarray(log.P_preconditioner[k], np.float64)
        if not (np.all(np.isfinite(H)) and np.all(np.isfinite(g))):
            continue
        if not np.all(np.isfinite(P)):
            P = np.eye(6)

        t_start = time.perf_counter()
        x_pcg, iters, res_pcg, first = _pcg_numpy(H, g, P, max_iter, tol)
        time_pcg_ms = (time.perf_counter() - t_start) * 1e3

        t_start = time.perf_counter()
        x_qr, *_ = np.linalg.lstsq(H, g, rcond=None)
        time_qr_ms = (time.perf_counter() - t_start) * 1e3
        res_qr = float(np.linalg.norm(g - H @ x_qr))

        dx = np.asarray(log.dx[k], np.float64)
        mask = np.asarray(log.degenerate_mask[k], bool)
        Vr = np.asarray(log.V_schur_rot[k], np.float64)
        Vt = np.asarray(log.V_schur_trans[k], np.float64)
        ratio = 0.0
        if np.all(np.isfinite(dx)) and np.linalg.norm(dx) > 0 and \
                np.all(np.isfinite(Vr)) and np.all(np.isfinite(Vt)):
            proj = 0.0
            for i in range(3):
                if mask[i]:      # rotation subspace direction i
                    proj += float(Vr[:, i] @ dx[:3]) ** 2
                if mask[3 + i]:  # translation subspace direction i
                    proj += float(Vt[:, i] @ dx[3:]) ** 2
            ratio = float(np.sqrt(proj) / np.linalg.norm(dx))

        cond_H = float(log.cond_full[k])
        cond_PH = float(log.cond_PH[k])
        rows.append(dict(zip(PCG_COLUMNS, [
            t0 + dt * float(k), cond_H, cond_PH,
            (cond_H / cond_PH) if cond_PH and np.isfinite(cond_PH)
            and cond_PH > 0 else 0.0,
            iters, time_pcg_ms, time_qr_ms,
            first["residual"], first["precond_residual"],
            first["alpha"], first["rz"],
            res_pcg, res_qr,
            float(np.linalg.norm(x_pcg - x_qr)),
            ratio,
            (kappa_target / cond_H) if np.isfinite(cond_H) and cond_H > 0
            else 0.0,
            int(bool(log.is_degenerate[k])),
        ])))
    return rows


def write_pcg_txt(path, rows):
    """Space-separated pcg.txt in the reference's column order (no header,
    matching the archived file; schema in fig18 README.MD)."""
    with open(path, "w") as f:
        for row in rows:
            f.write(" ".join(_fmt(row[c]) for c in PCG_COLUMNS) + "\n")


def _fmt(v):
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if not np.isfinite(v):
        return "0"
    return repr(float(v))


def _synchronize(x):
    """Wait for the card if ``x`` (a tensor, or a tuple that leads with
    one, such as an engine's result) lives there."""
    while isinstance(x, tuple):
        x = x[0]
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def stepped_iteration_times(run_one_iteration, poses, reps: int = 3):
    """Wall-time each recorded iteration as its own call.

    run_one_iteration: callable (R (3,3), t (3,)) -> tensor or engine
    result; poses: the (R, t) at which each executed iteration ran.
    Returns the per-iteration ms, the minimum over ``reps`` timed calls
    after one untimed call."""
    times = []
    for R, t in poses:
        _synchronize(run_one_iteration(R, t))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _synchronize(run_one_iteration(R, t))
            best = min(best, time.perf_counter() - t0)
        times.append(best * 1e3)
    return times
