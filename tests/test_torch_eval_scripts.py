"""Port parity: the trajectory-evaluation CLIs of
``dcreg_tpu_torch/scripts/`` against ``scripts/evaluate_trajectory.py``,
``scripts/get_gtpose.py`` and ``scripts/e57_to_pcd.py``, and against the
recorded corridor artifact.

Stated tolerances, with the largest differences found:
  * ``evaluate`` on the recorded .tum files, with the map and scans
    regenerated by the port's ``corridor_world``, ``gt_trajectory`` and
    ``make_frames``, against corridor_summary.json for all six methods:
    the ATE, RPE and recall numbers within rtol 1e-9 (found: equal), the
    AC distances within 1e-6 m (found: 1.9e-7 m; the recorded scans came
    from rotations one float32 ulp away, so the AC median, one order
    statistic, moves by up to 9.5e-6 relative), inlier fraction and
    point count equal.
  * ``main`` prints the JSON of the JAX script's ``main`` character for
    character; ``associate`` returns the JAX script's pairs.
  * ``get_gtpose`` and ``e57_to_pcd`` print the JAX scripts' lines, and
    the PCDs they write are byte-identical.
"""
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401

from dcreg_tpu_torch.io.e57 import write_e57
from dcreg_tpu_torch.io.tum import save_tum
from dcreg_tpu_torch.scripts import e57_to_pcd, evaluate_trajectory, \
    get_gtpose
from dcreg_tpu_torch.scripts import run_corridor_experiment as rce

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECORDED = ROOT / "results" / "corridor_experiment"
SUMMARY = json.loads((RECORDED / "corridor_summary.json").read_text())
TRAJ_KEYS = ("frames", "ate_rmse_m", "ate_mean_m", "ate_max_m",
             "ate_raw_rmse_m", "rpe_rot_mean_deg", "rpe_trans_mean_m",
             "registration_recall")


def jax_script(name):
    """``scripts/<name>.py`` imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corridor_inputs():
    world = rce.corridor_world()
    _, _, gt = rce.gt_trajectory()
    frames = rce.make_frames(world, gt, n=rce.SCAN_POINTS)
    return frames.astype(np.float32), world.astype(np.float32)


@pytest.mark.parametrize("method", [m for m, _, _ in rce.METHODS])
def test_evaluate_reproduces_recorded_summary(corridor_inputs, method):
    scans, map_xyz = corridor_inputs
    out = evaluate_trajectory.evaluate(
        str(RECORDED / "gt.tum"), str(RECORDED / f"{method}.tum"),
        scans=scans, map_xyz=map_xyz)
    rec = SUMMARY[method]
    for k in TRAJ_KEYS:
        np.testing.assert_allclose(out[k], rec[k], rtol=1e-9, err_msg=k)
    ac, ac_rec = out["map_accuracy"], rec["map_accuracy"]
    assert ac.keys() == ac_rec.keys()
    for k in ("ac_mean", "ac_rmse", "ac_median"):
        np.testing.assert_allclose(ac[k], ac_rec[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert (ac["inlier_frac"], ac["points"]) == (ac_rec["inlier_frac"],
                                                 ac_rec["points"])


def test_evaluate_main_prints_the_jax_json(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(3)
    gt = np.broadcast_to(np.eye(4), (12, 4, 4)).copy()
    gt[:, 0, 3] = np.arange(12) * 0.4
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.05, (12, 3))
    ts = np.arange(12) * 0.1
    save_tum(str(tmp_path / "gt.tum"), ts, gt)
    # est at another rate: two frames share a nearest GT frame, one has
    # none within max_dt
    save_tum(str(tmp_path / "est.tum"),
             np.concatenate([ts[:6], ts[6:] + 0.015]), est)
    scans = rng.normal(0, 1.0, (12, 50, 3)).astype(np.float32)
    np.save(tmp_path / "scans.npy", scans)
    np.save(tmp_path / "map.npy",
            (scans[0] + [2.0, 0.0, 0.0]).astype(np.float32))
    js = jax_script("evaluate_trajectory")
    for extra in ([], ["--delta", "2", "--scans", str(tmp_path / "scans.npy"),
                       "--map", str(tmp_path / "map.npy")]):
        argv = [str(tmp_path / "gt.tum"), str(tmp_path / "est.tum")] + extra
        assert evaluate_trajectory.main(argv) == 0
        ours = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["evaluate_trajectory.py"] + argv)
        assert js.main() == 0
        assert ours == capsys.readouterr().out
    assert "map_accuracy" in json.loads(ours)
    save_tum(str(tmp_path / "far.tum"), ts + 5.0, est)
    assert evaluate_trajectory.main(
        [str(tmp_path / "gt.tum"), str(tmp_path / "far.tum")]) == 1
    assert json.loads(capsys.readouterr().out) == {
        "error": "no associated frames"}


def test_associate_matches():
    rng = np.random.default_rng(5)
    js = jax_script("evaluate_trajectory")
    for _ in range(20):
        ts_gt = np.sort(rng.uniform(0, 3, 40))
        ts_est = np.sort(np.concatenate([
            ts_gt[rng.choice(40, 25)] + rng.normal(0, 0.01, 25),
            rng.uniform(0, 3, 5)]))
        for a, b in zip(evaluate_trajectory.associate(ts_gt, ts_est),
                        js.associate(ts_gt, ts_est)):
            assert np.array_equal(a, b)


def test_get_gtpose_matches(tmp_path, capsys):
    rng = np.random.default_rng(7)
    T = np.broadcast_to(np.eye(4), (8, 4, 4)).copy()
    T[:, :3, 3] = rng.normal(0, 2.0, (8, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    est = T.copy()
    est[:, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    est[:, :3, 3] = T[:, :3, 3] @ est[0, :3, :3] + [1.0, -2.0, 0.5]
    save_tum(str(tmp_path / "gt.tum"), np.arange(8) * 0.1, T)
    save_tum(str(tmp_path / "est.tum"), np.arange(9) * 0.1 + 0.02,
             np.concatenate([est, est[-1:]]))
    js = jax_script("get_gtpose")
    gt_path, est_path = str(tmp_path / "gt.tum"), str(tmp_path / "est.tum")
    for argv in ([gt_path, "0.33"], [gt_path, "--align", est_path]):
        get_gtpose.main(argv)
        ours = capsys.readouterr().out
        js.main(argv)
        assert ours == capsys.readouterr().out
    assert "alignment T" in ours
    ts, poses = np.arange(8) * 0.1, T
    assert get_gtpose.nearest_pose(ts, poses, 0.33)[1] == \
        js.nearest_pose(ts, poses, 0.33)[1]
    for mod in (get_gtpose, js):
        with pytest.raises(ValueError, match="away"):
            mod.nearest_pose(ts, poses, 2.0)


@pytest.mark.parametrize("voxel", ["0", "0.5"])
def test_e57_to_pcd_matches(tmp_path, capsys, monkeypatch, voxel):
    xyz = np.random.default_rng(9).uniform(-3, 3, (700, 3))
    write_e57(str(tmp_path / "in.e57"), xyz)
    e57_to_pcd.main([str(tmp_path / "in.e57"), str(tmp_path / "port.pcd"),
                     "--voxel", voxel])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "e57_to_pcd.py", str(tmp_path / "in.e57"), str(tmp_path / "jax.pcd"),
        "--voxel", voxel])
    jax_script("e57_to_pcd").main()
    assert ours.replace("port.pcd", "jax.pcd") == capsys.readouterr().out
    assert (tmp_path / "port.pcd").read_bytes() == \
        (tmp_path / "jax.pcd").read_bytes()
    assert "read 700 points" in ours
