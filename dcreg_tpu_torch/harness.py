"""Test harness: the method matrix over one frame pair, statistics and
artifacts (counterpart of ``dcreg_tpu/harness.py``).

Host-side Python, as in the JAX package: each method run is one engine
call on the device, timed on the host clock with the device
synchronised; everything after is bookkeeping on numpy.  The engine of a
row: O3D ``o3d_icp``, XICP* ``xicp_register``, SuperLoc
``superloc_register``, any other the SO(3) engine, or the Euler engine
when ``use_so3_parameterization`` is false.  On the card every engine
replays CUDA graphs (the warm-up call of a row captures, the timed call
replays).
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from . import telemetry, writers
from .config import Config
from .io.pcd import load_pcd, save_pcd
from .models.icp import ICPResult, IterationLog, icp_point_to_plane_so3
from .models.icp_euler import icp_point_to_plane_euler
from .models.o3d_style import o3d_icp
from .models.superloc import superloc_register
from .models.xicp import xicp_register
from .ops.correspondence import find_correspondences
from .ops.degeneracy import DetectionMethod, HandlingMethod, analyze
from .ops.gauss_newton import build_system
from .ops.knn import nn1
from .ops.metrics import point_to_point_error
from .ops.solvers import solve as solve_system
from .ops.voxel_grid import build_grid_index
from .utils import resolve_device

def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def result_to_host(result: ICPResult) -> ICPResult:
    """The ICPResult with every tensor fetched to a numpy array."""
    log = IterationLog(*[_host(v) for v in result.log])
    return ICPResult(*[_host(v) for v in result[:-1]], log=log)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TestRunner:
    """Drives the configured method matrix over one frame pair on
    ``device`` (cuda unless told otherwise), in ``dtype``: by default f32
    on the card (which runs no f64 search) and f64 on the CPU.  ``graph``
    goes to every row's engine: None replays CUDA graphs on the card,
    False runs them eagerly (for checking), True raises on the CPU."""

    def __init__(self, config: Config, dtype=None, device=None, graph=None):
        self.config = config
        self.device = resolve_device(device)
        self.graph = graph
        if dtype is None:
            dtype = (torch.float64 if self.device.type == "cpu"
                     else torch.float32)
        self.dtype = dtype
        self.records: List[writers.MethodRunRecord] = []
        self.stats: Dict[str, dict] = {}
        self.source = None
        self.target = None
        self.grid = None

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    # -- data ------------------------------------------------------------
    def load_point_clouds(self, source_xyz=None, target_xyz=None):
        """Load from the config's paths, or take arrays directly."""
        if source_xyz is None:
            src_path = os.path.join(self.config.folder_path,
                                    self.config.source_pcd)
            tgt_path = os.path.join(self.config.folder_path,
                                    self.config.target_pcd)
            source_xyz = load_pcd(src_path)["xyz"]
            target_xyz = (source_xyz if os.path.abspath(src_path) ==
                          os.path.abspath(tgt_path)
                          else load_pcd(tgt_path)["xyz"])
        self.source = self._tensor(source_xyz)
        self.target = self._tensor(target_xyz)
        if self.config.use_grid_index:
            # one-time spatial index, shared by every method and run
            self.grid = build_grid_index(
                self.target.cpu().numpy(), self.config.search_radius,
                dtype=self.dtype, device=self.device)
        return self

    def _engine(self, method_name, detection, handling, params):
        """fn(R, t) running the row's engine from the pose (R, t)."""
        cfg = self.config
        T_gt = self._tensor(cfg.gt_matrix())
        common = dict(T_gt=T_gt, grid=self.grid, device=self.device,
                      graph=self.graph)
        src, tgt = self.source, self.target
        if method_name == "O3D":
            return lambda R, t: o3d_icp(src, tgt, R, t, params, **common)
        if method_name.startswith("XICP"):
            return lambda R, t: xicp_register(src, tgt, R, t, detection,
                                              handling, params, cfg.xicp,
                                              **common)
        if method_name == "SuperLoc":
            return lambda R, t: superloc_register(src, tgt, R, t, params,
                                                  **common)
        engine = (icp_point_to_plane_so3 if cfg.use_so3_parameterization
                  else icp_point_to_plane_euler)
        return lambda R, t: engine(src, tgt, R, t, detection, handling,
                                   params, **common)

    # -- single test ------------------------------------------------------
    def run_single_test(self, method_name: str, detection: DetectionMethod,
                        handling: HandlingMethod, warmup: bool = False):
        """(host ICPResult, ms on the host clock, SuperLocInfo on the host
        or None) of one run of the row's engine."""
        T0 = self._tensor(self.config.initial_matrix())
        engine = self._engine(method_name, detection, handling,
                              self.config.icp_params())
        run = lambda: engine(T0[:3, :3], T0[:3, 3])
        if warmup:   # first-call costs outside the timed region
            run()
            _synchronize(self.device)
        t0 = time.perf_counter()
        result = run()
        _synchronize(self.device)
        time_ms = (time.perf_counter() - t0) * 1e3
        superloc_info = None
        if method_name == "SuperLoc":
            result, superloc_info = result
            superloc_info = type(superloc_info)(
                *[_host(v) for v in superloc_info])
        return result_to_host(result), time_ms, superloc_info

    # -- method loop ------------------------------------------------------
    def run_method(self, method_name, detection, handling):
        cfg = self.config
        for run_idx in range(cfg.num_runs):
            result, time_ms, superloc_info = self.run_single_test(
                method_name, detection, handling, warmup=(run_idx == 0))
            rec = writers.MethodRunRecord(method_name, run_idx, result,
                                          time_ms)
            if superloc_info is not None:
                rec.superloc = dict(
                    uncertainties=list(superloc_info.uncertainties),
                    cond_full=float(superloc_info.cond_full),
                    cond_rot=float(superloc_info.cond_rot),
                    cond_trans=float(superloc_info.cond_trans),
                    is_degenerate=bool(superloc_info.is_degenerate))
            # final p2p metrics on the aligned cloud
            T = self._tensor(rec.final_transform())
            aligned = self.source @ T[:3, :3].T + T[:3, 3]
            rmse, fit, chamfer, n_corr = point_to_point_error(
                aligned, self.target, cfg.error_threshold)
            rec.p2p_rmse = float(rmse)
            rec.p2p_fitness = float(fit)
            rec.chamfer = float(chamfer)
            rec.p2p_corr = int(n_corr)
            self.records.append(rec)
            if run_idx == 0:
                self._fill_iteration_times(rec, method_name, detection,
                                           handling)
            if run_idx == 0 and (cfg.save_pcd or cfg.save_error_pcd):
                self._save_clouds(method_name, aligned)
        return True

    # -- per-iteration timing -----------------------------------------------
    def _fill_iteration_times(self, rec, method_name, detection, handling):
        """rec.iter_time_ms and its provenance: total / n
        ("uniform_estimate"), or with ``stepped_timing`` each recorded
        iteration replayed and timed as its own call: the SO(3) family's
        iteration work ("stepped_replay"), or for the other engines the
        engine run for one iteration from each recorded pre-iteration
        pose ("engine_1iter_replay", which includes the engine's set-up,
        e.g. the normal estimation, so it bounds the iteration from
        above)."""
        cfg = self.config
        n = max(rec.n_iters, 1)
        rec.iter_time_ms = [rec.time_ms / n] * rec.n_iters
        rec.iter_time_provenance = "uniform_estimate"
        if not cfg.stepped_timing:
            return
        params = cfg.icp_params()
        source, target, grid = self.source, self.target, self.grid
        Ts = [cfg.initial_matrix()] + [rec.result.log.transform[k]
                                       for k in range(rec.n_iters - 1)]
        poses = [(self._tensor(T[:3, :3]), self._tensor(T[:3, 3]))
                 for T in Ts]

        so3_family = (not method_name.startswith("XICP")
                      and method_name not in ("SuperLoc", "O3D")
                      and cfg.use_so3_parameterization)
        if so3_family:
            def step(R, t):
                corr = find_correspondences(source, R, t, target,
                                            params=params.corr,
                                            chunk=params.chunk, grid=grid)
                sysm = build_system(
                    source, R, t, corr,
                    use_weight_derivative=params.use_weight_derivative,
                    weight_slope=params.corr.weight_slope)
                analysis = analyze(sysm.H, detection, params.thresholds)
                dx, _ = solve_system(sysm.H, sysm.g, handling, analysis,
                                     params.thresholds, telemetry=False)
                return dx
            provenance = "stepped_replay"
        else:
            step = self._engine(method_name, detection, handling,
                                params._replace(max_iterations=1))
            provenance = "engine_1iter_replay"
        rec.iter_time_ms = telemetry.stepped_iteration_times(step, poses)
        rec.iter_time_provenance = provenance

    def run_all(self):
        if self.source is None:
            self.load_point_clouds()
        for name, det, hand in self.config.methods():
            self.run_method(name, det, hand)
        self.finalize_statistics()
        self.save_results()
        return self

    # -- statistics ---------------------------------------------------------
    def finalize_statistics(self):
        by_method: Dict[str, List[writers.MethodRunRecord]] = {}
        for r in self.records:
            by_method.setdefault(r.method, []).append(r)
        self.stats = {}
        for name, recs in by_method.items():
            te = np.array([r.final_errors()[0] for r in recs])
            re = np.array([r.final_errors()[1] for r in recs])
            times = np.array([r.time_ms for r in recs])
            iters = np.array([r.n_iters for r in recs])
            rmse = np.array([r.final_rmse_fitness()[0] for r in recs])
            fit = np.array([r.final_rmse_fitness()[1] for r in recs])
            corr = np.array([int(r.result.log.effective_points[r.last_iter()])
                             for r in recs])
            conv = np.array([r.converged for r in recs])
            self.stats[name] = dict(
                n_runs=len(recs), n_converged=int(conv.sum()),
                success_rate=float(conv.mean()),
                trans_error_mean=float(te.mean()),
                trans_error_std=float(te.std()),
                trans_error_min=float(te.min()),
                trans_error_max=float(te.max()),
                rot_error_mean=float(re.mean()), rot_error_std=float(re.std()),
                rot_error_min=float(re.min()), rot_error_max=float(re.max()),
                time_mean=float(times.mean()), time_std=float(times.std()),
                iters_mean=float(iters.mean()),
                rmse_mean=float(rmse.mean()), fitness_mean=float(fit.mean()),
                corr_mean=float(corr.mean()),
                p2p_rmse_mean=float(np.mean([r.p2p_rmse for r in recs])),
                p2p_fitness_mean=float(np.mean([r.p2p_fitness
                                                for r in recs])),
                p2p_corr_mean=float(np.mean([r.p2p_corr for r in recs])),
                chamfer_mean=float(np.mean([r.chamfer for r in recs])),
            )
        return self.stats

    # -- artifacts ----------------------------------------------------------
    def save_results(self):
        cfg = self.config
        out = cfg.output_folder
        if not out:
            return
        os.makedirs(out, exist_ok=True)
        n_src = self.source.shape[0] if self.source is not None else 0
        n_tgt = self.target.shape[0] if self.target is not None else 0
        if cfg.save_statistics:
            writers.write_statistics_summary(
                os.path.join(out, "statistics_summary.txt"), cfg, self.stats,
                (n_src, n_tgt))
            writers.write_complete_log(
                os.path.join(out, "complete_log.txt"), cfg, self.stats)
        if cfg.save_csv:
            writers.write_all_results_csv(
                os.path.join(out, "all_results.csv"), self.records)
            writers.write_iteration_history_csv(
                os.path.join(out, "iteration_history.csv"), self.records)
            writers.write_iteration_details_csv(
                os.path.join(out, "iteration_details_with_dx.csv"),
                self.records)
            writers.write_transform_details_csv(
                os.path.join(out, "transform_details.csv"), self.records)
            writers.write_timing_provenance_csv(
                os.path.join(out, "iteration_timing_provenance.csv"),
                self.records)
            if cfg.num_runs == 1:
                writers.write_condition_numbers_csv(
                    os.path.join(out, "condition_numbers_detailed.csv"),
                    self.records)
        if cfg.save_summary:
            # fig18-style PCG solver telemetry for the first PCG method
            pcg_methods = [m for m, _, h in cfg.methods()
                           if h == HandlingMethod.PRECONDITIONED_CG]
            if pcg_methods:
                rec0 = next((r for r in self.records
                             if r.method == pcg_methods[0] and r.run == 0),
                            None)
                if rec0 is not None:
                    rows = telemetry.pcg_replay_rows(
                        rec0.result.log,
                        kappa_target=cfg.icp_params().thresholds.kappa_target)
                    telemetry.write_pcg_txt(os.path.join(out, "pcg.txt"),
                                            rows)
            writers.write_degeneracy_analysis_txt(
                os.path.join(out, "degeneracy_analysis_first_iter.txt"),
                self.records, first=True)
            writers.write_degeneracy_analysis_txt(
                os.path.join(out, "degeneracy_analysis_last_iter.txt"),
                self.records, first=False)

    def _save_clouds(self, method_name, aligned):
        cfg = self.config
        out = cfg.output_folder
        os.makedirs(out, exist_ok=True)
        aligned_np = aligned.cpu().numpy()
        tgt = self.target.cpu().numpy()
        if cfg.save_pcd:
            writers.save_aligned_clouds(
                os.path.join(out, f"{method_name}_aligned_clouds.pcd"),
                aligned_np, tgt)
            save_pcd(os.path.join(out,
                                  f"{method_name}_aligned_clouds_sig.pcd"),
                     aligned_np)
            T0 = self._tensor(cfg.initial_matrix())
            save_pcd(os.path.join(out, "initial_clouds.pcd"),
                     (self.source @ T0[:3, :3].T + T0[:3, 3]).cpu().numpy())
            save_pcd(os.path.join(out, "target_clouds.pcd"), tgt)
        if cfg.save_error_pcd:
            d_sq, _ = nn1(aligned, self.target)
            writers.save_error_cloud(
                os.path.join(out, f"{method_name}_error.pcd"), aligned_np,
                np.sqrt(d_sq.cpu().numpy()), cfg.error_threshold)
