"""Result writers (counterpart of ``dcreg_tpu/writers.py``): the
reference's eight artifact families, with headers byte-identical to the
JAX package's.

Schema- and format-compatible with the writer block at
``DCReg/src/icp_test_runner.cpp:667-1606``:

  * statistics_summary.txt / complete_log.txt      (:667-796)
  * transform_details.csv                          (:799-892)
  * condition_numbers_detailed.csv                 (:894-993)
  * all_results.csv                                (:995-1028)
  * degeneracy_analysis_first_iter.txt /
    degeneracy_analysis_last_iter.txt              (:1031-1386)
  * iteration_history.csv                          (:1389-1413)
  * iteration_details_with_dx.csv                  (:1415-1510)
  * aligned / error PCDs                           (:519-600)

Note: iteration_details_with_dx.csv's recorded data carries the rotation
error in the ``Trans_Error_m`` column and vice versa (writer quirk of the
reference); we reproduce the recorded column order for golden-file parity.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .io.pcd import jet_color, save_pcd
from .ops.degeneracy import align_to_axes


def _fmt(x, nd=6):
    return f"{x:.{nd}f}"


class MethodRunRecord:
    """Host-side record of one method run (TestResult, utils.hpp:253-303)."""

    def __init__(self, method_name, run_idx, result, time_ms,
                 p2p=(np.nan, np.nan, np.nan, 0), corr_number=0):
        self.method = method_name
        self.run = run_idx
        self.result = result          # ICPResult with numpy fields
        self.time_ms = time_ms
        self.p2p_rmse, self.p2p_fitness, self.chamfer, self.p2p_corr = p2p
        self.corr_number = corr_number

    # -- convenience accessors over the stacked log --
    @property
    def n_iters(self):
        return int(self.result.iterations)

    @property
    def converged(self):
        return bool(self.result.converged)

    def last_iter(self):
        return max(self.n_iters - 1, 0)

    def final_transform(self):
        k = self.last_iter()
        T = np.asarray(self.result.log.transform[k])
        if not np.isfinite(T).all():
            T = np.eye(4)
        return T

    def final_errors(self):
        k = self.last_iter()
        return (float(self.result.log.trans_error[k]),
                float(self.result.log.rot_error_deg[k]))

    def final_rmse_fitness(self):
        k = self.last_iter()
        return (float(self.result.log.rmse[k]),
                float(self.result.log.fitness[k]))


def write_all_results_csv(path, records: List[MethodRunRecord]):
    """all_results.csv (icp_test_runner.cpp:995-1028)."""
    with open(path, "w") as f:
        f.write("Method,Run,Converged,Iterations,Time_ms,Trans_Error_m,"
                "Rot_Error_deg,ICP_RMSE,ICP_Fitness,P2P_RMSE,P2P_Fitness,"
                "Chamfer_Distance\n")
        for r in records:
            te, re = r.final_errors()
            rmse, fit = r.final_rmse_fitness()
            f.write(f"{r.method},{r.run},{int(r.converged)},{r.n_iters},"
                    f"{r.time_ms:g},{te:g},{re:g},{rmse:g},{fit:g},"
                    f"{r.p2p_rmse:g},{r.p2p_fitness:g},{r.chamfer:g}\n")


def write_timing_provenance_csv(path, records: List[MethodRunRecord]):
    """Sidecar provenance for iter_time_ms: which values are MEASURED
    (stepped_replay / engine_1iter_replay) vs uniform total/n estimates.
    Kept out of iteration_details_with_dx.csv so its header stays
    byte-identical to the reference schema (icp_test_runner.cpp:1415)."""
    with open(path, "w") as f:
        f.write("Method,Run,Iteration,IterTimeMs,Provenance\n")
        for r in records:
            if r.run != 0:
                continue
            prov = getattr(r, "iter_time_provenance", "uniform_estimate")
            times = getattr(r, "iter_time_ms", None) or []
            for k, t_ms in enumerate(times):
                f.write(f"{r.method},{r.run},{k},{t_ms:.4f},{prov}\n")


def write_iteration_history_csv(path, records: List[MethodRunRecord]):
    """iteration_history.csv (icp_test_runner.cpp:1389-1413)."""
    with open(path, "w") as f:
        f.write("Method,Iteration,RMSE,Fitness,TransError,RotError,CorrNum\n")
        for r in records:
            if r.run != 0:
                continue
            log = r.result.log
            for k in range(r.n_iters):
                f.write(f"{r.method},{k},{log.rmse[k]:.8f},"
                        f"{log.fitness[k]:.8f},{log.trans_error[k]:.8f},"
                        f"{log.rot_error_deg[k]:.8f},"
                        f"{int(log.corr_num[k])}\n")


def write_condition_numbers_csv(path, records: List[MethodRunRecord]):
    """condition_numbers_detailed.csv (icp_test_runner.cpp:894-993)."""
    header = ("Method,Iteration,Effective_Points,RMSE,Fitness,"
              "Cond_Schur_Rot,Cond_Schur_Trans,Cond_Diag_Rot,Cond_Diag_Trans,"
              "Cond_Full_EVD_Sub_Rot,Cond_Full_EVD_Sub_Trans,Cond_Full_SVD,"
              + ",".join(f"Lambda_Schur_Rot_{i}" for i in range(3)) + ","
              + ",".join(f"Lambda_Schur_Trans_{i}" for i in range(3)) + ","
              + ",".join(f"Eigenvalues_Full_{i}" for i in range(6)) + ","
              + ",".join(f"Singular_Values_{i}" for i in range(6))
              + ",Is_Degenerate,"
              + ",".join(f"Degenerate_Mask_{i}" for i in range(6)) + "\n")
    with open(path, "w") as f:
        f.write(header)
        for r in records:
            if r.run != 0:
                continue
            log = r.result.log
            for k in range(r.n_iters):
                vals = [r.method, k, int(log.effective_points[k]),
                        f"{log.rmse[k]:g}", f"{log.fitness[k]:g}",
                        f"{log.cond_schur_rot[k]:g}",
                        f"{log.cond_schur_trans[k]:g}",
                        f"{log.cond_diag_rot[k]:g}",
                        f"{log.cond_diag_trans[k]:g}",
                        f"{log.cond_full_sub_rot[k]:g}",
                        f"{log.cond_full_sub_trans[k]:g}",
                        f"{log.cond_full[k]:g}"]
                vals += [f"{v:g}" for v in log.lambda_schur_rot[k]]
                vals += [f"{v:g}" for v in log.lambda_schur_trans[k]]
                vals += [f"{v:g}" for v in log.eigenvalues_full[k]]
                vals += [f"{v:g}" for v in log.singular_values[k]]
                vals += [str(int(log.is_degenerate[k]))]
                vals += [str(int(m)) for m in log.degenerate_mask[k]]
                f.write(",".join(str(v) for v in vals) + "\n")


def write_iteration_details_csv(path, records: List[MethodRunRecord]):
    """iteration_details_with_dx.csv (icp_test_runner.cpp:1415-1510).

    Reproduces the reference's recorded column order, including its
    rot/trans column swap, and per-iteration P2P metrics when supplied via
    record.per_iter_p2p (list of (p2p_rmse, chamfer))."""
    head = ("Method,Run,Iteration,RMSE,Fitness,Time_ms,Trans_Error_m,"
            "Rot_Error_deg,P2P_RMSE,Chamfer_Distance,"
            "dx_wx,dx_wy,dx_wz,dx_x,dx_y,dx_z,"
            "grad_wx,grad_wy,grad_wz,grad_x,grad_y,grad_z,objective_value,"
            + ",".join(f"T_{i}{j}" for i in range(4) for j in range(4)) + ","
            "Cond_Schur_Rot,Cond_Schur_Trans,Cond_Sub_Rot,Cond_Sub_Trans,"
            "Cond_Full_SVD,"
            + ",".join(f"Degenerate_{i}" for i in range(6))
            + ",Is_Degenerate\n")
    with open(path, "w") as f:
        f.write(head)
        for r in records:
            log = r.result.log
            per_iter_p2p = getattr(r, "per_iter_p2p", None)
            for k in range(r.n_iters):
                p2p = per_iter_p2p[k] if per_iter_p2p else (np.nan, np.nan)
                iter_times = getattr(r, "iter_time_ms", None)
                t_ms = iter_times[k] if iter_times is not None else np.nan
                row = [r.method, r.run, k,
                       f"{log.rmse[k]:.8f}", f"{log.fitness[k]:.8f}",
                       f"{t_ms:.8f}",
                       # recorded order: rotation error under Trans_Error_m
                       f"{log.rot_error_deg[k]:.8f}",
                       f"{log.trans_error[k]:.8f}",
                       f"{p2p[0]:.8f}", f"{p2p[1]:.8f}"]
                row += [f"{v:.8f}" for v in log.dx[k]]
                row += [f"{v:.8f}" for v in log.gradient[k]]
                row += [f"{log.objective[k]:.8f}"]
                row += [f"{v:.8f}" for v in np.asarray(log.transform[k]).ravel()]
                row += [f"{log.cond_schur_rot[k]:.8f}",
                        f"{log.cond_schur_trans[k]:.8f}",
                        f"{log.cond_diag_rot[k]:.8f}",
                        f"{log.cond_diag_trans[k]:.8f}",
                        f"{log.cond_full[k]:.8f}"]
                row += [str(int(m)) for m in log.degenerate_mask[k]]
                row += [str(int(log.is_degenerate[k]))]
                f.write(",".join(str(v) for v in row) + "\n")


def write_transform_details_csv(path, records: List[MethodRunRecord]):
    """transform_details.csv (icp_test_runner.cpp:799-892)."""
    head = ("Method,Run,Converged,Iterations,Time_ms,Trans_Error_m,"
            "Rot_Error_deg,Final_RMSE,Final_Fitness,Corr_Number,"
            + ",".join(f"Transform_{i}{j}" for i in range(4) for j in range(4)) + ","
            + ",".join(f"SVD_Sigma_{i}" for i in range(6)) + ","
            + ",".join(f"EVD_Lambda_{i}" for i in range(6)) + ","
            + ",".join(f"Schur_Rot_Lambda_{i}" for i in range(3)) + ","
            + ",".join(f"Schur_Trans_Lambda_{i}" for i in range(3)) + ","
            "Cond_Full_SVD,Cond_Sub_Rot,Cond_Sub_Trans,Cond_Schur_Rot,"
            "Cond_Schur_Trans,"
            # NOTE: no comma between Degenerate_Mask_5 and
            # SuperLoc_Has_Data -- the reference's writer fuses these two
            # columns (icp_test_runner.cpp:799-892 header bug, visible in
            # the archived transform_details.csv as "...Mask_5SuperLoc_..."
            # and "00" data cells); reproduced for byte-identical headers.
            + ",".join(f"Degenerate_Mask_{i}" for i in range(6)) +
            "SuperLoc_Has_Data,SuperLoc_Uncertainty_X,SuperLoc_Uncertainty_Y,"
            "SuperLoc_Uncertainty_Z,SuperLoc_Uncertainty_Roll,"
            "SuperLoc_Uncertainty_Pitch,SuperLoc_Uncertainty_Yaw,"
            "SuperLoc_Cond_Full,SuperLoc_Cond_Rot,SuperLoc_Cond_Trans,"
            "SuperLoc_Is_Degenerate\n")
    with open(path, "w") as f:
        f.write(head)
        for r in records:
            log = r.result.log
            k = r.last_iter()
            te, re = r.final_errors()
            rmse, fit = r.final_rmse_fitness()
            row = [r.method, r.run, int(r.converged), r.n_iters,
                   f"{r.time_ms:g}", f"{te:g}", f"{re:g}", f"{rmse:g}",
                   f"{fit:g}", int(log.effective_points[k])]
            row += [f"{v:g}" for v in np.asarray(log.transform[k]).ravel()]
            row += [f"{v:g}" for v in log.singular_values[k]]
            row += [f"{v:g}" for v in log.eigenvalues_full[k]]
            row += [f"{v:g}" for v in log.lambda_schur_rot[k]]
            row += [f"{v:g}" for v in log.lambda_schur_trans[k]]
            row += [f"{log.cond_full[k]:g}", f"{log.cond_diag_rot[k]:g}",
                    f"{log.cond_diag_trans[k]:g}",
                    f"{log.cond_schur_rot[k]:g}",
                    f"{log.cond_schur_trans[k]:g}"]
            row += [str(int(m)) for m in log.degenerate_mask[k][:5]]
            sl = getattr(r, "superloc", None)
            # fused "Mask_5 + Has_Data" cell (see header note above)
            m5 = str(int(log.degenerate_mask[k][5]))
            if sl is None:
                row += [m5 + "0"] + ["NaN"] * 9 + ["0"]
            else:
                row += [m5 + "1"] + [f"{v:g}" for v in sl["uncertainties"]]
                row += [f"{sl['cond_full']:g}", f"{sl['cond_rot']:g}",
                        f"{sl['cond_trans']:g}", str(int(sl["is_degenerate"]))]
            f.write(",".join(str(v) for v in row) + "\n")


def _write_analysis_block(f, r: MethodRunRecord, k: int, first: bool):
    log = r.result.log
    f.write(f"Method: {r.method}\n")
    if not first:
        f.write("Final Transform Matrix:\n")
        T = np.asarray(log.transform[k])
        for i in range(4):
            f.write("".join(f"{T[i, j]:12.6f} " for j in range(4)) + "\n")
        f.write("\n")
    f.write("  Condition Numbers:\n")
    f.write(f"    Schur Rot: {log.cond_schur_rot[k]:.2f}\n")
    f.write(f"    Schur Trans: {log.cond_schur_trans[k]:.2f}\n")
    f.write(f"    Diag Rot: {log.cond_diag_rot[k]:.2f}\n")
    f.write(f"    Diag Trans: {log.cond_diag_trans[k]:.2f}\n")
    f.write(f"    SVD Diag Rot: {log.cond_full_sub_rot[k]:.2f}\n")
    f.write(f"    SVD Diag Trans: {log.cond_full_sub_trans[k]:.2f}\n")
    f.write(f"    Full SVD: {log.cond_full[k]:.2f}\n")
    f.write("  Eigenvalues (Full): "
            + " ".join(f"{v:.3f}" for v in log.eigenvalues_full[k]) + " \n")
    f.write("  Degenerate Mask (wxwywz xyz): "
            + " ".join(str(int(m)) for m in log.degenerate_mask[k]) + " \n")
    f.write(f"  Is Degenerate: {'Yes' if log.is_degenerate[k] else 'No'}\n")

    P = np.asarray(log.P_preconditioner[k])
    if np.isfinite(P).all() and not np.allclose(P, np.eye(6)):
        # The reference prints P with rows/cols reordered by the alignment
        # order of each Schur eigenbasis (orig_idx list) -- reproduce that
        # display convention (verified against the recorded first_iter.txt).
        f.write("\n  Preconditioner Matrix P:\n")
        perm = _alignment_permutation(r, k)
        Pp = P[np.ix_(perm, perm)]
        for i in range(6):
            f.write("    " + " ".join(f"{Pp[i, j]:12.6f}" for j in range(6)) + " \n")
        _write_alignment_analysis(f, r, k)
    f.write("\n")


def _alignment_permutation(r: "MethodRunRecord", k: int):
    """Display permutation [rot orig_idx | trans orig_idx] from the greedy
    axis alignment of each Schur eigenbasis (the reference's convention)."""
    log = r.result.log
    perm = []
    for b, (vk, lk) in enumerate((("V_schur_rot", "lambda_schur_rot"),
                                  ("V_schur_trans", "lambda_schur_trans"))):
        V = np.asarray(getattr(log, vk)[k])
        lam = np.asarray(getattr(log, lk)[k])
        if not (np.isfinite(V).all() and np.isfinite(lam).all()):
            perm += [3 * b + i for i in range(3)]
            continue
        info = align_to_axes(torch.as_tensor(V), torch.as_tensor(lam))
        perm += [3 * b + int(o) for o in info.order]
    return perm


def _write_alignment_analysis(f, r: MethodRunRecord, k: int):
    """Alignment Analysis block: Schur eigen-directions characterized
    against the physical axes (recorded format, first_iter.txt)."""
    log = r.result.log
    names_rot = ["R", "P", "Y"]
    names_trans = ["X", "Y", "Z"]
    f.write("\n  Alignment Analysis:\n")
    for title, names, lam_key, v_key in (
            ("Rotation Axes", names_rot, "lambda_schur_rot", "V_schur_rot"),
            ("Translation Axes", names_trans, "lambda_schur_trans",
             "V_schur_trans")):
        lam = np.asarray(getattr(log, lam_key)[k])
        V = np.asarray(getattr(log, v_key)[k])
        if not (np.isfinite(V).all() and np.isfinite(lam).all()):
            continue
        info = align_to_axes(torch.as_tensor(V), torch.as_tensor(lam))
        f.write(f"    {title}:\n")
        for i in range(3):
            o = int(info.order[i])
            pct = info.percents[i].numpy()
            f.write(f"      [{i}]~{names[i]} (orig_idx={o}): "
                    f"lambda={float(info.lambdas[i]):.6f}, "
                    f"Angle={float(info.angles_deg[i]):.6f} deg, "
                    f"{pct[0]:.6f}%{names[0]}+{pct[1]:.6f}%{names[1]}"
                    f"+{pct[2]:.6f}%{names[2]}\n")


def write_degeneracy_analysis_txt(path, records: List[MethodRunRecord],
                                  first: bool):
    """degeneracy_analysis_{first,last}_iter.txt (:1031-1386)."""
    with open(path, "w") as f:
        if first:
            f.write("Degeneracy Analysis Results (First Iteration)\n")
            f.write("============================================\n\n")
        else:
            f.write("Degeneracy Analysis Results\n")
            f.write("==========================\n\n")
        for r in records:
            if r.run != 0:
                continue
            k = 0 if first else r.last_iter()
            _write_analysis_block(f, r, k, first)
            if not first:
                f.write("\n" + "-" * 60 + "\n")


def write_statistics_summary(path, config, stats: Dict[str, dict],
                             cloud_sizes=(0, 0)):
    """statistics_summary.txt (icp_test_runner.cpp:667-760)."""
    with open(path, "w") as f:
        f.write("ICP Test Statistics Summary\n===========================\n\n")
        f.write("Configuration:\n")
        f.write(f"  Source: {config.source_pcd}\n")
        f.write(f"  Target: {config.target_pcd}\n")
        f.write(f"  Cloud size: {cloud_sizes[0]} {cloud_sizes[1]}\n")
        f.write(f"  Runs per method: {config.num_runs}\n\n")
        f.write(f"{'Method':>15}{'Success%':>12}{'Trans(m)':>12}"
                f"{'Rot(deg)':>12}{'ICP_RMSE':>12}{'Avg_Iters':>12}"
                f"{'P2PDis':>12}{'ChamferDis':>12}{'P2P_Fit%':>12}"
                f"{'P2P_Corr':>12}{'Time(ms)':>11}\n")
        f.write("-" * 135 + "\n")
        for name, s in sorted(stats.items()):
            f.write(f"{name:>15}{s['success_rate'] * 100:>12.1f}"
                    f"{s['trans_error_mean']:>12.4f}"
                    f"{s['rot_error_mean']:>12.4f}"
                    f"{s['rmse_mean']:>12.4f}"
                    f"{s['iters_mean']:>12.1f}"
                    f"{s['p2p_rmse_mean']:>12.4f}"
                    f"{s['chamfer_mean']:>12.4f}"
                    f"{s['p2p_fitness_mean'] * 100:>12.2f}"
                    f"{s['p2p_corr_mean']:>12.0f}"
                    f"{s['time_mean']:>11.2f}\n")
        f.write("\n\nDetailed Statistics:\n===================\n\n")
        for name, s in sorted(stats.items()):
            f.write(f"Method: {name}\n")
            f.write(f"  Converged: {s['n_converged']}/{s['n_runs']} "
                    f"(Success Rate: {s['success_rate'] * 100:.1f}%)\n")
            f.write(f"  Iterations: {s['iters_mean']:.1f}\n")
            f.write(f"  Translation Error (m): {s['trans_error_mean']:.6f} "
                    f"\u00b1 {s['trans_error_std']:.6f} "
                    f"[{s['trans_error_min']:.6f}, {s['trans_error_max']:.6f}]\n")
            f.write(f"  Rotation Error (deg): {s['rot_error_mean']:.6f} "
                    f"\u00b1 {s['rot_error_std']:.6f} "
                    f"[{s['rot_error_min']:.6f}, {s['rot_error_max']:.6f}]\n")
            f.write(f"  Time (ms): {s['time_mean']:.2f} \u00b1 {s['time_std']:.2f}\n")
            f.write(f"  ICP RMSE: {s['rmse_mean']:.6f}\n")
            f.write(f"  ICP Fitness: {s['fitness_mean']:.4f}\n")
            f.write(f"  ICP Correspondence: {s['corr_mean']:.0f}\n")
            f.write(f"  Point-to-Point RMSE: {s['p2p_rmse_mean']:.6f}\n")
            f.write(f"  Point-to-Point Fitness: {s['p2p_fitness_mean']:.4f}\n")
            f.write(f"  Chamfer Distance: {s['chamfer_mean']:.6f}\n\n")


def write_complete_log(path, config, stats: Dict[str, dict]):
    """complete_log.txt (icp_test_runner.cpp:762-796)."""
    n = config.initial_noise
    with open(path, "w") as f:
        f.write("Complete ICP Test Log\n====================\n\n")
        f.write("Configuration:\n")
        f.write(f"  Source: {config.source_pcd}\n")
        f.write(f"  Target: {config.target_pcd}\n")
        f.write(f"  Runs: {config.num_runs}\n")
        f.write(f"  Initial noise: x={n.x:.6f}, y={n.y:.6f}, z={n.z:.6f}, "
                f"roll={np.degrees(n.roll):.6f}, "
                f"pitch={np.degrees(n.pitch):.6f}, "
                f"yaw={np.degrees(n.yaw):.6f} deg\n\n")
        f.write("ICP Parameters:\n")
        f.write(f"  DEGENERACY_THRES_COND: {config.condition_threshold:.6f}\n")
        f.write(f"  DEGENERACY_THRES_EIG: {config.eigenvalue_threshold:.6f}\n")
        f.write(f"  STD_REG_GAMMA: {config.std_reg_gamma:.6f}\n")
        f.write(f"  ADAPTIVE_REG_ALPHA: {config.adaptive_reg_alpha:.6f}\n")
        f.write(f"  KAPPA_TARGET: {config.kappa_target:.6f}\n")
        f.write(f"  PCG_TOLERANCE: {config.pcg_tolerance:.6f}\n")
        f.write(f"  PCG_MAX_ITER: {config.pcg_max_iter}\n\n")
        f.write("Results Summary:\n================\n\n")
        for name, s in sorted(stats.items()):
            f.write(f"Method: {name}\n")
            f.write(f"  Success rate: {s['success_rate'] * 100:.6f}%\n")
            f.write(f"  Trans error: {s['trans_error_mean']:.6f} \u00b1 "
                    f"{s['trans_error_std']:.6f} m\n")
            f.write(f"  Rot error: {s['rot_error_mean']:.6f} \u00b1 "
                    f"{s['rot_error_std']:.6f} deg\n")
            f.write(f"  P2P RMSE: {s['p2p_rmse_mean']:.6f} m\n")
            f.write(f"  Chamfer: {s['chamfer_mean']:.6f} m\n")
            f.write(f"  Time: {s['time_mean']:.6f} \u00b1 {s['time_std']:.6f} ms\n\n")


def save_aligned_clouds(path, aligned_xyz, target_xyz):
    """Red source + green target combined cloud (saveAlignedClouds,
    icp_test_runner.cpp:519-545)."""
    xyz = np.concatenate([aligned_xyz, target_xyz], axis=0)
    rgb = np.concatenate([
        np.tile([255, 0, 0], (len(aligned_xyz), 1)),
        np.tile([0, 255, 0], (len(target_xyz), 1))], axis=0)
    save_pcd(path, xyz, rgb=rgb)


def save_error_cloud(path, aligned_xyz, nn_dists, error_threshold):
    """Jet-colored per-point error cloud (saveErrorPointCloud, :548-600)."""
    rgb = jet_color(nn_dists, error_threshold)
    save_pcd(path, aligned_xyz, rgb=rgb)
