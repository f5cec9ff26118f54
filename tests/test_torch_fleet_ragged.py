"""A fleet's tick with scans of their own sizes (``run_odometry_fleet``
with ``counts``): each lane's first ``counts[s]`` rows are its scan, the
rest pads whose values must not matter.

The scene is ``chip_smoke.py``'s at 200,000 points over a square of side
23 m (the 53M-point map's density), its S-curve from seed 7 and scans of
up to 512 points (four query blocks); four sensors two frames apart, each
seeded from the ground truth's two poses before its frame.  The lanes'
counts cover what the masks must handle: a full lane, a partly filled
last block, whole blocks of pads, and a lane of one block and a bit.
Each lane's scan is a random subset of its frame's points, kd-block-
sorted as the fleet's contract asks.  No JAX: the lanes are held against
the port's one-sensor loop and the benchmark's float64 reference.

Stated tolerances:
  * pads: every result field bit-equal whatever the pads hold (the
    prologue overwrites them before anything reads them).
  * a lane against its own unpadded scan through ``run_odometry_map``:
    iterations equal, pose entries within 1e-6: the same pair list and
    neighbours, but H and g summed over N rows against the scan's own
    count and the seed composed batched, so float32 rounding differs
    (9.6e-7 measured for full lanes, ``tests/test_torch_fleet.py``).
  * a lane against the float64 reference: the weighted RMS displacement
    along the reference's planes (the benchmark's ``plane_gap_m``) within
    2e-5 m of the one-sensor loop's own gap on the same scan, as
    ``test_torch_fleet.py`` holds full lanes (found: 4.7e-8 apart at
    most), and under 3e-3 m.  That loop reads 1.6e-5 to 4.3e-4 m on the
    three larger lanes and 1.41e-3 m on the 140-point one, where the port
    stops after 5 steps and the reference after 7: a scan of 140 points
    constrains the pose less, so where each stops moves the gap more
    (``test_torch_fleet.py``'s 1e-3 m is for 700-point scans).
  * full counts: ``counts`` all N is bit-equal to ``counts=None`` on
    the CPU (ATen divides by a host scalar and by a tensor alike there).

The ``chip`` cases run on the card (no JAX there; the tests' conftest
imports it):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m chip \\
        tests/test_torch_fleet_ragged.py
"""
import importlib.util
import json
import os

import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

import chip_smoke as cs
from dcreg_tpu_torch import graphs, tracing
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.ops import block_knn as tk
from dcreg_tpu_torch.ops import block_sparse as tbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_POINTS, EXTENT, SEED, CAPACITY = 200_000, 11.5, 7, 512
STARTS = (0, 2, 4, 6)
COUNTS = (512, 301, 200, 140)      # full; part of a block; pad blocks
R0, MARGIN = 0.18, 0.12
METHOD = ("SCHUR_CONDITION_NUMBER", "PRECONDITIONED_CG")
FAR = 1000.0                      # pads 1 km away


def _reference():
    spec = importlib.util.spec_from_file_location(
        "ragged_test_reference", os.path.join(ROOT, "bench_port",
                                              "reference", "icp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_scene(device="cpu"):
    world = cs.synthetic_map(MAP_POINTS, EXTENT, SEED) \
        + np.array([0.0, 0.0, 9.0], np.float32)
    world = world[tbs.kd_block_order(world, 128)]
    T_pre2, T_pre1, gt = cs.trajectory(EXTENT, max(STARTS) + 1)
    rng = np.random.default_rng(SEED + 4)
    frames, _ = cs.scans(world, gt, CAPACITY, rng)
    # each lane's scan: a random subset of its frame, kd-block-sorted
    lanes = []
    for s, n in zip(STARTS, COUNTS):
        sub = frames[s][np.sort(rng.choice(CAPACITY, n, replace=False))]
        lanes.append(sub[tbs.kd_block_order(sub, 128)])
    mindex = tbs.build_map_index(world, tb=128, sb=64, device=device)
    # capacities over every lane's own scan at its pose, the one before
    # and the constant-velocity prediction
    known = np.concatenate([[T_pre2, T_pre1], gt])   # frame f at f + 2
    caps = np.max([todo.estimate_odometry_capacities(
        mindex, np.repeat(scan[None], 3, 0), known[s:s + 3], R0 + MARGIN,
        margin=1.25, slot_margin=1.6, sup_margin=4)
        for s, scan in zip(STARTS, lanes)], axis=0)
    return dict(world=world, world_t=torch.as_tensor(world, device=device),
                lanes=lanes, full=todo.prepare_frames(frames[list(STARTS)]),
                known=known, mindex=mindex,
                caps=tuple(int(c) for c in caps), device=device)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def common(sc, **kw):
    S, G, P = sc["caps"]
    return dict(num_supers=S, max_per_query=G, num_pairs=P,
                initial_cull_radius=R0, reuse_margin=MARGIN,
                detection=METHOD[0], handling=METHOD[1],
                device=sc["device"], **kw)


def seeds(sc):
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                    device=sc["device"])
    return (f32([sc["known"][s + 1] for s in STARTS]),
            f32([sc["known"][s] for s in STARTS]))


def padded(sc, fill="zeros", lanes=None):
    """(S, CAPACITY, 3) scans: each lane's scan, then pads of ``fill``:
    zeros, copies of the lane's own points, or points 1 km away."""
    lanes = sc["lanes"] if lanes is None else lanes
    out = np.zeros((len(lanes), CAPACITY, 3), np.float32)
    for i, scan in enumerate(lanes):
        n = len(scan)
        out[i, :n] = scan
        if fill == "copies":
            out[i, n:] = np.resize(scan, (CAPACITY - n, 3))
        elif fill == "far":
            out[i, n:] = FAR + np.arange(3 * (CAPACITY - n)).reshape(-1, 3)
    return torch.as_tensor(out, device=sc["device"])


def tick(sc, fill="zeros", counts=COUNTS, lanes=None, **kw):
    T1, T2 = seeds(sc)
    return todo.run_odometry_fleet(padded(sc, fill, lanes), sc["mindex"],
                                   sc["world_t"], T1, T2, counts=counts,
                                   **common(sc, **kw))


@pytest.fixture(scope="module")
def ragged(scene):
    return tick(scene)


def same(a, b) -> bool:
    """Bit-equal, NaNs where NaNs are."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(), b.nan_to_num()) if a.dtype.is_floating_point \
        else torch.equal(a, b)


@pytest.mark.parametrize("fill", ["copies", "far"])
def test_pads_have_no_influence(scene, ragged, fill):
    res = tick(scene, fill)
    for name in todo.MapOdometryResult._fields:
        assert same(getattr(res, name), getattr(ragged, name)), name


def rot_angle(Ra, Rb):
    M = Ra.T @ Rb
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                              M[1, 0] - M[0, 1]])
    return float(np.arctan2(s, (np.trace(M) - 1.0) * 0.5))


@pytest.fixture(scope="module")
def alone(scene):
    """Each lane's unpadded scan through its own ``run_odometry_map``."""
    return [todo.run_odometry_map(
        scan[None], scene["mindex"], scene["world_t"],
        T0=scene["known"][s + 1], T_prev_init=scene["known"][s],
        **common(scene)) for s, scan in zip(STARTS, scene["lanes"])]


@pytest.mark.parametrize("lane", range(len(STARTS)))
def test_each_lane_matches_its_scan_alone(ragged, alone, lane):
    one = alone[lane]
    assert int(ragged.iterations[lane]) == int(one.iterations[0])
    assert float((ragged.poses[lane] - one.poses[0]).abs().max()) < 1e-6
    for name in ("converged", "aborted", "pair_overflow", "is_degenerate",
                 "effective_points", "fitness"):
        assert same(getattr(ragged, name)[lane], getattr(one, name)[0]), \
            name
    assert not bool(ragged.aborted[lane])
    assert int(ragged.pair_overflow[lane]) == 0


def plane_gap(T, out):
    """The benchmark's ``plane_gap_m`` of pose T against the reference's
    registration ``out``."""
    k = out["steps"]
    R, t = out["R"][k].numpy(), out["t"][k].numpy()
    M = R.T @ T[:3, :3]
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]])
    d = np.concatenate([w, R.T @ (T[:3, 3] - t)])
    H = out["H"][k].numpy()
    return float(np.sqrt(max(d @ H @ d, 0.0) / max(out["w2"][k], 1e-30)))


def test_each_lane_against_the_float64_reference(scene, ragged, alone):
    ref = _reference()
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "map53m.json")) as f:
        icp = json.load(f)["icp"]
    world = torch.as_tensor(scene["world"])
    T1, T2 = seeds(scene)
    for lane, scan in enumerate(scene["lanes"]):
        out = ref.register(torch.as_tensor(scan, dtype=torch.float64), world,
                           ("cv", T1[lane].double(), T2[lane].double()),
                           METHOD, icp)
        gap = plane_gap(ragged.poses[lane].double().numpy(), out)
        own = plane_gap(alone[lane].poses[0].double().numpy(), out)
        assert gap < 3e-3, (lane, gap)
        assert abs(gap - own) < 2e-5, (lane, gap, own)


def method_enums():
    from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod,
                                                HandlingMethod)
    return DetectionMethod[METHOD[0]], HandlingMethod[METHOD[1]]


def fleet_key(sc, ragged_lanes):
    S, G, P = sc["caps"]
    loop = todo.BatchLoop(sc["mindex"], sc["world_t"], len(STARTS), CAPACITY,
                          *method_enums(), todo.ICPParams(), P, S, G, R0,
                          MARGIN, torch.device("cpu"), per_lane=True,
                          ragged=ragged_lanes)
    return loop.key()


def test_full_counts_change_nothing(scene):
    full = (CAPACITY,) * len(STARTS)
    none = tick(scene, lanes=scene["full"], counts=None)
    every = tick(scene, lanes=scene["full"], counts=full)
    for name in todo.MapOdometryResult._fields:
        assert same(getattr(none, name), getattr(every, name)), name
    # the key of a fleet without counts is the one it always had; with
    # counts it differs in the mode alone
    S, G, P = scene["caps"]
    old = ("icp_batch_so3", "reuse_lanes", len(STARTS), CAPACITY,
           CAPACITY // tk.QB, P, S, G, *method_enums(), todo.ICPParams(),
           R0, MARGIN, "torch.float32", "cpu")
    assert fleet_key(scene, False)[:-1] == old
    with_counts = fleet_key(scene, True)
    assert with_counts[1] == "reuse_lanes_ragged"
    assert with_counts[2:] == fleet_key(scene, False)[2:]
    with pytest.raises(ValueError, match="point count per lane"):
        todo.BatchLoop(scene["mindex"], scene["world_t"], 1, CAPACITY,
                       *method_enums(), todo.ICPParams(), P, S, G, R0,
                       MARGIN, torch.device("cpu"), ragged=True)


@pytest.mark.parametrize("counts", [(512, 301, 200), (512, 301, 200, 0),
                                    (512, 301, 200, 513),
                                    (512.0, 301.0, 200.0, 140.0)])
def test_counts_are_checked(scene, counts):
    with pytest.raises(ValueError, match="counts"):
        tick(scene, counts=counts)


THIN = 6          # fewer points than ``min_effective_points`` (10)


def test_a_thin_lane_aborts_alone(scene, ragged):
    res = tick(scene, counts=COUNTS[:2] + (THIN,) + COUNTS[3:])
    assert bool(res.aborted[2])
    assert int(res.effective_points[2]) < 10
    for name in todo.MapOdometryResult._fields:
        for lane in (0, 1, 3):
            assert same(getattr(res, name)[lane],
                        getattr(ragged, name)[lane]), (name, lane)


def test_the_fleet_span_counts_points_and_capacity(scene):
    with tracing.record() as rec:
        tick(scene, icp_params=todo.ICPParams(max_iterations=1))
        tick(scene, counts=None, icp_params=todo.ICPParams(max_iterations=1))
    calls = [s[4] for s in rec.spans if s[0] == "odometry.fleet_call"]
    assert [(c["sensors"], c["points"], c["capacity"]) for c in calls] == [
        (len(STARTS), sum(COUNTS), len(STARTS) * CAPACITY),
        (len(STARTS), len(STARTS) * CAPACITY, len(STARTS) * CAPACITY)]


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_scene("cuda")


@pytest.mark.chip
def test_captured_ragged_tick_replays_its_eager_run(cuda_scene):
    eager = tick(cuda_scene, graph=False)
    graphed = tick(cuda_scene, graph=True)
    again = tick(cuda_scene, graph=True)               # replays
    for name in todo.MapOdometryResult._fields:
        x, y, z = (getattr(r, name).cpu() for r in (eager, graphed, again))
        assert same(x, y) and same(y, z), name


@pytest.mark.chip
def test_other_counts_replay_without_a_capture(cuda_scene):
    tick(cuda_scene, graph=True)                       # warm-up
    captures = graphs.CACHE.captures
    for counts in ((140, 512, 301, 200), (200, 200, 512, 130)):
        res = tick(cuda_scene, counts=counts, graph=True)
        assert not bool(res.aborted.any())
    assert graphs.CACHE.captures == captures


@pytest.mark.chip
def test_k1_keys_of_valid_rows_match_the_twin(cuda_scene):
    """K1's inputs as the ragged prologue builds them (the tick's own
    state after an eager prologue), through the kernel and its twin."""
    sc = cuda_scene
    S_, G, P = sc["caps"]
    loop = todo.BatchLoop(sc["mindex"], sc["world_t"], len(STARTS), CAPACITY,
                          *method_enums(), todo.ICPParams(), P, S_, G, R0,
                          MARGIN, torch.device("cuda"), per_lane=True,
                          ragged=True)
    mloop = todo.MapLoop(loop, True, True, 1)
    T1, T2 = seeds(sc)
    counts = torch.as_tensor(COUNTS, device="cuda")
    run, S = graphs.bind(mloop, lambda S: mloop.load(
        S, padded(sc, "far"), T1, T2, counts), False, "ragged", "cuda")
    run("prologue")
    nq = loop.nq
    ib = tk._index_bits(G * tk.TB)
    _, _, clamp, scale = tk.key_params(loop.radius, ib)
    i32 = lambda t: t.to(torch.int32).contiguous()
    poses = torch.cat([S.R0.reshape(-1, 9), S.t0], 1)
    args = (S.src_blocks, sc["mindex"].block.blocks, poses, i32(S.qid0),
            i32(S.tid0), i32(S.slot0), None, ib, scale, clamp)
    keys = tk.block_knn_keys(*args, nq_lane=nq)
    twin = tk.block_knn_keys_plain(*args, nq_lane=nq)
    valid = torch.arange(nq * tk.QB, device="cuda")[None] \
        < counts[:, None]                              # (S, nq * QB)
    rows = lambda k: k.reshape(len(STARTS), nq, tk.KP, tk.QB).transpose(
        2, 3).reshape(len(STARTS), nq * tk.QB, tk.KP)[valid]
    assert int(valid.sum()) == sum(COUNTS)
    assert torch.equal(rows(keys), rows(twin))
    assert torch.equal(keys, twin)
