"""Run configuration (counterpart of ``dcreg_tpu/config.py``): the same
YAML schema, so every config of ``configs/`` loads unchanged into frozen
NamedTuples; poses become matrices through the port's ``se3``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import yaml

from .models.icp import ICPParams
from .ops import se3
from .ops.correspondence import CorrespondenceParams
from .ops.degeneracy import (DegeneracyThresholds, DetectionMethod,
                             HandlingMethod)


class Pose6DConfig(NamedTuple):
    """roll/pitch/yaw (rad) + xyz, matching Pose6D (utils.hpp:50)."""
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def as_array(self):
        return np.array([self.roll, self.pitch, self.yaw,
                         self.x, self.y, self.z])


class XICPParamsConfig(NamedTuple):
    """XICP thresholds (xicp.h:37-60, config/icp.yaml:88-96)."""
    enough_info_threshold: float = 300.0
    insufficient_info_threshold: float = 150.0
    high_info_threshold: float = 1000.0
    solution_remapping_threshold: float = 120.0
    minimal_alignment_angle_deg: float = 60.0
    strong_alignment_angle_deg: float = 45.0
    inequality_bound_multiplier: float = 100.0


class Config(NamedTuple):
    """Top-level run configuration (Config struct, utils.hpp:132-171)."""
    # test block
    num_runs: int = 1
    save_pcd: bool = False
    save_error_pcd: bool = False
    visualize: bool = False
    # output block
    save_csv: bool = True
    save_summary: bool = True
    save_statistics: bool = True
    # paths
    folder_path: str = ""
    output_folder: str = ""
    source_pcd: str = ""
    target_pcd: str = ""
    # icp block
    search_radius: float = 1.0
    max_iterations: int = 30
    error_threshold: float = 0.2
    convergence_thresh_trans: float = 1e-3
    convergence_thresh_rot: float = 1e-4
    normal_nn: int = 5
    use_so3_parameterization: bool = True
    use_weight_derivative: bool = True
    use_grid_index: bool = True   # CSR voxel grid instead of brute force
    stepped_timing: bool = False  # per-iteration wall-time replay (slower)
    # poses
    initial_noise: Pose6DConfig = Pose6DConfig()
    gt_pose: Pose6DConfig = Pose6DConfig()
    # degeneracy block
    condition_threshold: float = 10.0
    eigenvalue_threshold: float = 120.0
    # method params
    std_reg_gamma: float = 100.0
    kappa_target: float = 10.0
    pcg_tolerance: float = 1e-6
    pcg_max_iter: int = 10
    tsvd_singular_thresh: float = 120.0
    loam_eigen_thresh: float = 120.0
    adaptive_reg_alpha: float = 10.0
    # xicp
    xicp: XICPParamsConfig = XICPParamsConfig()
    # method matrix: name -> (DetectionMethod, HandlingMethod)
    test_methods: Tuple[Tuple[str, str, str], ...] = ()

    # ---- derived helpers ----
    def icp_params(self) -> ICPParams:
        return ICPParams(
            max_iterations=self.max_iterations,
            convergence_thresh_trans=self.convergence_thresh_trans,
            convergence_thresh_rot=self.convergence_thresh_rot,
            use_weight_derivative=self.use_weight_derivative,
            corr=CorrespondenceParams(search_radius=self.search_radius),
            thresholds=DegeneracyThresholds(
                cond_thresh=self.condition_threshold,
                eig_thresh=self.eigenvalue_threshold,
                std_reg_gamma=self.std_reg_gamma,
                kappa_target=self.kappa_target,
                pcg_tolerance=self.pcg_tolerance,
                pcg_max_iter=self.pcg_max_iter,
                adaptive_reg_alpha=self.adaptive_reg_alpha,
            ))

    def methods(self):
        out = []
        for name, det, hand in self.test_methods:
            out.append((name, DetectionMethod(det),
                        HandlingMethod(_HAND_ALIAS.get(hand, hand))))
        return out

    def initial_matrix(self):
        return _pose_matrix(self.initial_noise)

    def gt_matrix(self):
        return _pose_matrix(self.gt_pose)


def _pose_matrix(pose: Pose6DConfig) -> np.ndarray:
    """4x4 float64 matrix of a Pose6DConfig (Z * Y * X Euler)."""
    return se3.pose6d_to_matrix(torch.as_tensor(pose.as_array())).numpy()


# handling-name aliases used in the YAMLs vs our enum values
_HAND_ALIAS = {"O3D": "O3D", "SUPERLOC": "SUPERLOC"}


def _pose_from_yaml(d) -> Pose6DConfig:
    """Noise/GT poses are given in degrees for rotations (icp.yaml:36-58)."""
    if d is None:
        return Pose6DConfig()
    return Pose6DConfig(
        roll=math.radians(float(d.get("roll_deg", 0.0))),
        pitch=math.radians(float(d.get("pitch_deg", 0.0))),
        yaw=math.radians(float(d.get("yaw_deg", 0.0))),
        x=float(d.get("x", 0.0)), y=float(d.get("y", 0.0)),
        z=float(d.get("z", 0.0)))


def load_config(path: str) -> Config:
    """Parse a reference-format YAML (icp_test_runner.cpp:20-153)."""
    with open(path) as f:
        raw = yaml.safe_load(f)

    test = raw.get("test", {}) or {}
    output = raw.get("output", {}) or {}
    paths = raw.get("paths", {}) or {}
    icp = raw.get("icp", {}) or {}
    degeneracy = raw.get("degeneracy", {}) or {}
    mp = raw.get("method_params", {}) or {}
    xicp_raw = raw.get("icp_params", {}) or {}

    std_reg = mp.get("standard_reg", {}) or {}
    pcg = mp.get("pcg", {}) or {}
    tsvd = mp.get("tsvd", {}) or {}
    sr = mp.get("solution_remapping", {}) or {}
    areg = mp.get("adaptive_reg", {}) or {}

    methods = []
    for name, pair in (raw.get("test_methods", {}) or {}).items():
        methods.append((str(name), str(pair[0]), str(pair[1])))

    return Config(
        num_runs=int(test.get("num_runs", 1)),
        save_pcd=bool(test.get("save_pcd", False)),
        save_error_pcd=bool(test.get("save_error_pcd", False)),
        visualize=bool(test.get("visualize", False)),
        save_csv=bool(output.get("save_csv", True)),
        save_summary=bool(output.get("save_summary", True)),
        save_statistics=bool(output.get("save_statistics", True)),
        folder_path=str(paths.get("folder_path", "")),
        output_folder=str(paths.get("output_folder", "")),
        source_pcd=str(paths.get("source_pcd", "")),
        target_pcd=str(paths.get("target_pcd", "")),
        search_radius=float(icp.get("search_radius", 1.0)),
        max_iterations=int(icp.get("max_iterations", 30)),
        error_threshold=float(icp.get("error_threshold", 0.2)),
        convergence_thresh_trans=float(icp.get("CONVERGENCE_THRESH_TRANS", 1e-3)),
        convergence_thresh_rot=float(icp.get("CONVERGENCE_THRESH_ROT", 1e-4)),
        normal_nn=int(icp.get("normal_nn", 5)),
        use_so3_parameterization=bool(icp.get("use_so3_parameterization", True)),
        use_weight_derivative=bool(icp.get("use_weight_derivative", True)),
        use_grid_index=bool(icp.get("use_grid_index", True)),
        stepped_timing=bool(test.get("stepped_timing", False)),
        initial_noise=_pose_from_yaml(raw.get("initial_noise")),
        gt_pose=_pose_from_yaml(raw.get("gt_pose")),
        condition_threshold=float(degeneracy.get("condition_threshold", 10.0)),
        eigenvalue_threshold=float(degeneracy.get("eigenvalue_threshold", 120.0)),
        std_reg_gamma=float(std_reg.get("gamma", 100.0)),
        kappa_target=float(pcg.get("kappa_target", 10.0)),
        pcg_tolerance=float(pcg.get("tolerance", 1e-6)),
        pcg_max_iter=int(pcg.get("max_iter", 10)),
        tsvd_singular_thresh=float(tsvd.get("singular_threshold", 120.0)),
        loam_eigen_thresh=float(sr.get("eigen_threshold", 120.0)),
        adaptive_reg_alpha=float(areg.get("alpha", 10.0)),
        xicp=XICPParamsConfig(
            enough_info_threshold=float(xicp_raw.get("XICP_ENOUGH_INFO_THRESHOLD", 300.0)),
            insufficient_info_threshold=float(xicp_raw.get("XICP_INSUFFICIENT_INFO_THRESHOLD", 150.0)),
            high_info_threshold=float(xicp_raw.get("XICP_HIGH_INFO_THRESHOLD", 1000.0)),
            solution_remapping_threshold=float(xicp_raw.get("XICP_SOLUTION_REMAPPING_THRESHOLD", 120.0)),
            minimal_alignment_angle_deg=float(xicp_raw.get("XICP_MINIMAL_ALIGNMENT_ANGLE", 60.0)),
            strong_alignment_angle_deg=float(xicp_raw.get("XICP_STRONG_ALIGNMENT_ANGLE", 45.0)),
            inequality_bound_multiplier=float(xicp_raw.get("XICP_INEQUALITY_BOUND_MULTIPLIER", 100.0)),
        ),
        test_methods=tuple(methods),
    )


def select_methods(config: Config, names) -> Config:
    """The config with its method matrix cut to ``names`` (in the YAML's
    order); an unknown name raises."""
    names = list(names)
    known = [m[0] for m in config.test_methods]
    missing = [n for n in names if n not in known]
    if missing:
        raise ValueError(f"methods {missing} are not in the config's "
                         f"matrix {known}")
    return config._replace(test_methods=tuple(
        m for m in config.test_methods if m[0] in names))
