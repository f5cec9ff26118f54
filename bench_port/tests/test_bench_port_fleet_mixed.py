"""The mixed fleet's cell (``fleet32mix.mixed_loop``,
``drivers/fleet_mixed.py``) on the CPU at a tiny size: the driver's
scans and counts, a window and a traced run through the harness, and
the check against the plain reference."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, write_tiny
from test_bench_port_data import run_tiny

# the tiny mixed fleet: fleet32mix's keys with a smaller map (of the real
# one's density), 4 robots 1 frame apart, every second one sparse, scans
# of at most 2,000 points
SECONDS = 4.0
TINY_MIX = {"map_points": 400000, "min_extent_m": 14.0, "frames": 6,
            "scan_points": 2000, "sensors": 4, "robot_spacing_frames": 1,
            "sparse_every": 2, "sparse_points": [800, 1200],
            "dense_points": [1500, 2000]}
TINY_TRAFFIC = {"check_answers": 6, "check_sparse_answers": 2,
                "trace_ticks": 2}
CELL = "tmix.mixed_loop"
REAL = "fleet32mix.mixed_loop"


@pytest.fixture(scope="module")
def mix_root(tmp_path_factory):
    """The tiny data directory with the tiny mixed cell added, under the
    real cell's limits and metrics."""
    root = write_tiny(tmp_path_factory.mktemp("tiny_mix"))
    with open(os.path.join(BENCH, "configs", "fleet32mix.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY_MIX, name="tmix")
    with open(os.path.join(root, "configs", "tmix.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(BENCH, "traffic", "mixed_loop.json")) as f:
        traffic = json.load(f)
    traffic.update(TINY_TRAFFIC)
    with open(os.path.join(root, "traffic", "mixed_loop.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(BENCH, "limits", REAL + ".json")) as f:
        limits = f.read()
    with open(os.path.join(root, "limits", CELL + ".json"), "w") as f:
        f.write(limits)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    bench["configs"].append({"name": "tmix", "source": "tiny",
                             "reduced": [], "file": "configs/tmix.json",
                             "why": "tiny"})
    bench["workloads"].append({"name": CELL, "config": "tmix",
                               "traffic": "mixed_loop", "chips": 1,
                               "why": "tiny"})
    for key in ("end_to_end", "per_layer"):
        listed = {m["name"]: m.get("workloads") for m in real[key]}
        for m in bench[key]:
            if REAL in (listed.get(m["name"]) or ()):
                m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def test_tiny_mixed_fleet_is_correct_and_counts_its_points(mix_root):
    result, lines = run_tiny(mix_root, CELL, seconds=SECONDS)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] % 4 == 0
    assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms",
                                      "setup_s"}
    counts = json.loads(lines[2].split(": ", 1)[1])
    assert counts["sensors"] == 4 and counts["capacity_per_tick"] == 8000
    # two sparse robots of 800-1,200 points, two dense of 1,500-2,000
    assert 4600 <= counts["points_per_tick"] <= 6400


def test_traced_mixed_fleet_reads_its_program_counters(mix_root):
    result, _ = run_tiny(mix_root, CELL, trace=1)
    # on the CPU the trace's readers find no device operation, and the
    # graphs' capture time is the card's
    assert set(result["metrics"]) == {"steps_per_tick.fleet",
                                      "lane_occupancy.fleet"}


def driver_module():
    import harness
    return harness.Registry(ROOT).module("drivers", "fleet_mixed.py")


def test_runs_sort_as_each_run_alone():
    from kdorder import kd_leaf_order
    fm = driver_module()
    sizes = torch.tensor([700, 300, 129, 1, 128, 650])
    pts = torch.rand((int(sizes.sum()), 3),
                     generator=torch.Generator().manual_seed(5))
    perm = fm.kd_leaf_order_runs(pts, sizes)
    at = 0
    for n in sizes.tolist():
        alone = kd_leaf_order(pts[at:at + n], 128) + at
        assert torch.equal(perm[at:at + n], alone)
        at += n


def test_mixed_scans_are_subsets_of_their_frames():
    fm = driver_module()
    frames = torch.rand((3, 700, 3),
                        generator=torch.Generator().manual_seed(5))
    counts = torch.tensor([[700, 300, 129], [1, 128, 650]])
    out = fm.subsets(frames, counts, torch.Generator().manual_seed(6))
    assert out.shape == (2, 3, 700, 3)
    for r in range(2):
        for f in range(3):
            n = int(counts[r, f])
            assert not out[r, f, n:].any()
            mine = {tuple(p) for p in out[r, f, :n].tolist()}
            assert len(mine) == n
            assert mine <= {tuple(p) for p in frames[f].tolist()}
