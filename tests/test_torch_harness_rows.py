"""Every row of every config through the port's harness on the CPU
(no JAX), and the per-iteration timing replay of each engine.
"""
import os

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from chip_smoke import (CONFIGS, CYLINDER_YAML, pair_scenarios,
                        synthetic_cylinder)
from dcreg_tpu_torch.config import load_config
from dcreg_tpu_torch.harness import TestRunner as TRunner


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(CONFIGS) if f.endswith(".yaml")))
def test_every_row_of_every_config_runs(name):
    """Every row of each config, through its own engine and, for the
    SO(3) rows, also through the Euler engine (use_so3_parameterization
    false), runs on the CPU and logs a finite final pose.  On the
    synthetic cylinder, so with the cylinder's poses, and at most 5
    iterations (cylinder_iter.yaml asks for 5,000)."""
    pts = synthetic_cylinder(13, 600).astype(np.float64)
    cyl = load_config(CYLINDER_YAML)
    cfg = load_config(os.path.join(CONFIGS, name))._replace(
        output_folder="", save_pcd=False, save_error_pcd=False,
        max_iterations=min(5, cyl.max_iterations),
        initial_noise=cyl.initial_noise, gt_pose=cyl.gt_pose)
    for so3 in (True, False):
        runner = TRunner(cfg._replace(use_so3_parameterization=so3),
                         device="cpu").load_point_clouds(pts, pts)
        for method, det, hand in cfg.methods():
            runner.run_method(method, det, hand)
        runner.finalize_statistics()
        assert set(runner.stats) == {m for m, _, _ in cfg.methods()}
        for rec in runner.records:
            assert rec.n_iters >= 1 and np.isfinite(
                rec.final_transform()).all(), (name, so3, rec.method)


def test_stepped_timing_replays_every_engine():
    """With stepped_timing, each executed iteration of a baseline or Euler
    row is timed by its engine run for one iteration from the recorded
    pose ("engine_1iter_replay"), of an SO(3) row by the iteration's own
    work ("stepped_replay"), as the JAX harness labels them."""
    pts = synthetic_cylinder(17, 600).astype(np.float64)
    scen = pair_scenarios(load_config)
    want = {"ME-SR": "stepped_replay", "XICP": "engine_1iter_replay",
            "SuperLoc": "engine_1iter_replay", "O3D": "engine_1iter_replay"}
    cfgs = [scen["cylinder"], scen["parkinglot"],
            scen["euler"]._replace(test_methods=scen["euler"].test_methods[
                :1])]
    for cfg in cfgs:
        cfg = cfg._replace(output_folder="", stepped_timing=True,
                           max_iterations=3, save_pcd=False,
                           save_error_pcd=False)
        cfg = cfg._replace(test_methods=tuple(
            m for m in cfg.test_methods if m[0] in want))
        runner = TRunner(cfg, device="cpu").load_point_clouds(pts, pts)
        for name, det, hand in cfg.methods():
            runner.run_method(name, det, hand)
        for rec in runner.records:
            expect = want[rec.method] if cfg.use_so3_parameterization \
                else "engine_1iter_replay"
            assert rec.iter_time_provenance == expect, rec.method
            assert len(rec.iter_time_ms) == rec.n_iters
            assert all(t > 0 for t in rec.iter_time_ms)
