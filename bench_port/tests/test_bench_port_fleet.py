"""The fleet cell (``fleet8.closed_loop``, ``drivers/fleet.py``) on the CPU
at a tiny size: the port passes the cell's limits, the TF32 control fails
them, and a run with the fleet's written poses moved by 2 mrad and 1 cm
(every lane's, or every second lane's) comes out not correct; on the
chip, the control fails the cell's own limits on three seeds while the
port passes."""
import json
import os

import pytest
import torch

import check
import control
from dcreg_tpu_torch.ops import se3

from conftest import BENCH, ROOT, write_tiny
from test_bench_port_data import run_tiny

# the tiny fleet: fleet8's keys with a smaller map (of the real one's
# density), fewer and smaller scans, 4 robots 1 frame apart; scans of
# 2,000 points, as at 800 the port's own gap nears the cell's limit
# (PERF.md, section 6), and a window of a few ticks
SECONDS = 4.0
TINY_FLEET = {"map_points": 400000, "min_extent_m": 14.0, "frames": 6,
              "scan_points": 2000, "sensors": 4, "robot_spacing_frames": 1}
TINY_TRAFFIC = {"check_answers": 6, "trace_ticks": 2}
CELL = "tfleet.closed_loop"


@pytest.fixture(scope="module")
def fleet_root(tmp_path_factory):
    """The tiny data directory with the tiny fleet cell added, under the
    real cell's limits and metrics."""
    root = write_tiny(tmp_path_factory.mktemp("tiny_fleet"))
    with open(os.path.join(BENCH, "configs", "fleet8.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY_FLEET, name="tfleet")
    with open(os.path.join(root, "configs", "tfleet.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(BENCH, "traffic", "closed_loop.json")) as f:
        traffic = json.load(f)
    traffic.update(TINY_TRAFFIC)
    with open(os.path.join(root, "traffic", "closed_loop.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(BENCH, "limits",
                           "fleet8.closed_loop.json")) as f:
        limits = f.read()
    with open(os.path.join(root, "limits", CELL + ".json"), "w") as f:
        f.write(limits)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    bench["configs"].append({"name": "tfleet", "source": "tiny",
                             "reduced": [], "file": "configs/tfleet.json",
                             "why": "tiny"})
    bench["workloads"].append({"name": CELL, "config": "tfleet",
                               "traffic": "closed_loop", "chips": 1,
                               "why": "tiny"})
    for key in ("end_to_end", "per_layer"):
        listed = {m["name"]: m.get("workloads") for m in real[key]}
        for m in bench[key]:
            if "fleet8.closed_loop" in (listed.get(m["name"]) or ()):
                m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_tiny_fleet_is_correct_and_counts_its_ticks(fleet_root):
    result, lines = run_tiny(fleet_root, CELL, seconds=SECONDS)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] % 4 == 0
    assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms",
                                      "setup_s"}
    counts = json.loads(lines[2].split(": ", 1)[1])
    assert counts["sensors"] == 4
    assert counts["frames"] == 4 * counts["ticks"]
    # a tick waits for its slowest lane, and no lane steps past it
    assert counts["steps_per_tick"] >= counts["iters_per_frame"]
    assert counts["lane_occupancy"] == pytest.approx(
        100 * counts["iters_per_frame"] / counts["steps_per_tick"])


def test_traced_fleet_reads_its_program_counters(fleet_root):
    result, _ = run_tiny(fleet_root, CELL, trace=1)
    # on the CPU the trace's readers find no device operation
    assert set(result["metrics"]) == {"steps_per_tick.fleet",
                                      "lane_occupancy.fleet"}


def test_control_fails_the_tiny_fleet(fleet_root):
    r = control.readings(CELL, 2147483701, SECONDS, device="cpu",
                         root=fleet_root, search=[fleet_root])
    assert (check.judge(r["program"], r["limits"])[0],
            check.judge(r["control"], r["limits"])[0]) == (True, False), r


REAL_SE3_MATRIX = se3.se3_matrix


def lanes_moved(step):
    """The fleet loop's written poses with every ``step``-th lane (from
    lane 0) moved by 2 mrad and 1 cm about and along an oblique body axis;
    a single pose as it is."""
    def fault(R, t):
        if R.ndim != 3:
            return REAL_SE3_MATRIX(R, t)
        axis = torch.tensor([0.3, 0.5, 0.81], dtype=R.dtype,
                            device=R.device)
        axis = axis / axis.norm()
        w = 2e-3 * axis
        K = torch.zeros(3, 3, dtype=R.dtype, device=R.device)
        K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
        K = K - K.T
        R, t = R.clone(), t.clone()
        R[::step] = R[::step] @ torch.linalg.matrix_exp(K)
        t[::step] = t[::step] + 0.01 * (R[::step] @ axis)
        return REAL_SE3_MATRIX(R, t)
    return fault


@pytest.mark.parametrize("step", [1, 2], ids=["every_lane", "half_the_lanes"])
def test_moved_lanes_are_not_correct(fleet_root, monkeypatch, step):
    # the check compares third quartiles: a fault that moves half of the
    # sampled answers or more is seen (PERF.md, section 6)
    monkeypatch.setattr(se3, "se3_matrix", lanes_moved(step))
    result, lines = run_tiny(fleet_root, CELL, seconds=SECONDS)
    assert not result["correct"], lines


@pytest.mark.chip
def test_control_fails_the_fleet_on_chip(chip):
    for seed in (3100000001, 3100000002, 3100000003):
        r = control.readings("fleet8.closed_loop", seed, 2.0, root=ROOT)
        assert (check.judge(r["program"], r["limits"])[0],
                check.judge(r["control"], r["limits"])[0]) == (True,
                                                                False), r
