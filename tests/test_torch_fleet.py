"""A fleet's tick (``run_odometry_fleet``): S sensors' scans registered
against one map in one batched map-mode registration, a source per lane
(``BatchLoop(per_lane=True)``) and K1 in its per-lane mode.

The scene is ``chip_smoke.py``'s (undulating ground, wall strips,
pillars) at 300,000 points over a square of side 28 m, the density of
the 53M-point map; its S-curve and 700-point scans from seed 7; three
sensors starting 2 frames apart, each seeded from the ground truth's two
poses before its first frame and then by its own estimates, two ticks;
capacities, cull radius and reuse margin as the benchmark's map cells.
No JAX: the lanes are held against the port's own one-sensor loop and
the benchmark's plain float64 reference (``bench_port/reference``).

Stated tolerances:
  * a lane against its own ``run_odometry_map`` call: iterations equal on
    every frame but at most one; translations within 1e-3 m and rotations
    within 1e-4 rad, the loop's convergence thresholds, since the only
    difference is float32 rounding in the batched seed and reductions,
    which can move a stop by one step of at most that size.  Found:
    iterations equal on every frame, pose entries within 9.6e-7.
  * a lane against the float64 reference, on the second tick (each lane
    seeded by its own estimates): the weighted RMS displacement along the
    reference's planes (the benchmark's ``plane_gap_m``) within 2e-5 m of
    the one-sensor loop's own gap on the same frame (found: 2e-7 apart
    at most), and under 1e-3 m: that loop reads 1.5e-5 to 5.6e-5 m here
    and up to 4.5e-4 m on other frames of this scene (K1's fixed-point
    keys and the reused pair list, PERF.md section 7; scans of 700
    points, a seventh of the cell's).
  * K1's per-lane mode (plain twin) against brute force: every kept
    neighbour's true squared distance equals the brute-force one of its
    rank within one quantum of the fixed-point keys (1.1 r^2 / 2^(31 -
    index bits)), and each lane's keys equal those of that lane alone
    (B = 1) bit for bit.
  * a lane forced to abort or to overflow its pair list leaves the other
    lanes' answers bit-equal.

The ``chip`` cases run on the card (no JAX there; the tests' conftest
imports it):

    python3 -m pytest -q -p no:cacheprovider --noconftest -m chip \\
        tests/test_torch_fleet.py
"""
import importlib.util
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
MAP_POINTS, EXTENT, SEED, SCAN_POINTS = 300_000, 14.0, 7, 700
STARTS, TICKS = (0, 2, 4), 2
R0, MARGIN = 0.18, 0.12
METHOD = ("SCHUR_CONDITION_NUMBER", "PRECONDITIONED_CG")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "fleet_test_reference", os.path.join(ROOT, "bench_port",
                                             "reference", "icp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_scene(device="cpu"):
    world = cs.synthetic_map(MAP_POINTS, EXTENT, SEED) \
        + np.array([0.0, 0.0, 9.0], np.float32)
    world = world[tbs.kd_block_order(world, 128)]
    frames_n = max(STARTS) + TICKS
    T_pre2, T_pre1, gt = cs.trajectory(EXTENT, frames_n)
    frames, _ = cs.scans(world, gt, SCAN_POINTS,
                         np.random.default_rng(SEED + 4))
    frames_s = todo.prepare_frames(frames)
    mindex = tbs.build_map_index(world, tb=128, sb=64, device=device)
    caps = todo.estimate_odometry_capacities(
        mindex, frames_s, gt, R0 + MARGIN, margin=1.25, slot_margin=1.6,
        sup_margin=4)
    known = np.concatenate([[T_pre2, T_pre1], gt])   # frame f at f + 2
    return dict(world=world, world_t=torch.as_tensor(world, device=device),
                frames_s=frames_s, gt=gt, known=known, mindex=mindex,
                caps=caps, device=device)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def common(sc, **kw):
    S, G, P = sc["caps"]
    return dict(num_supers=S, max_per_query=G, num_pairs=P,
                initial_cull_radius=R0, reuse_margin=MARGIN,
                detection=METHOD[0], handling=METHOD[1],
                device=sc["device"], **kw)


def fleet_ticks(sc, **kw):
    """The fleet's TICKS ticks: [(T1, T2, result)] per tick, each sensor
    seeded by its own last two poses."""
    dev = sc["device"]
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                    device=dev)
    T1 = f32([sc["known"][s + 1] for s in STARTS])
    T2 = f32([sc["known"][s] for s in STARTS])
    out = []
    for k in range(TICKS):
        scans = f32(np.stack([sc["frames_s"][s + k] for s in STARTS]))
        res = todo.run_odometry_fleet(scans, sc["mindex"], sc["world_t"],
                                      T1, T2, **common(sc, **kw))
        out.append((T1, T2, res))
        T2, T1 = T1, res.poses
    return out


@pytest.fixture(scope="module")
def fleet(scene):
    return fleet_ticks(scene)


@pytest.fixture(scope="module")
def single(scene):
    """Each sensor's own ``run_odometry_map`` call over its TICKS frames."""
    return [todo.run_odometry_map(
        scene["frames_s"][s:s + TICKS], scene["mindex"], scene["world_t"],
        T0=scene["known"][s + 1], T_prev_init=scene["known"][s],
        **common(scene)) for s in STARTS]


def rot_angle(Ra, Rb):
    M = Ra.T @ Rb
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                              M[1, 0] - M[0, 1]])
    return float(np.arctan2(s, (np.trace(M) - 1.0) * 0.5))


def test_each_lane_is_its_own_single_sensor_loop(fleet, single):
    differ = 0
    for k, (_, _, res) in enumerate(fleet):
        for lane, one in enumerate(single):
            differ += int(res.iterations[lane]) != int(one.iterations[k])
            a, b = res.poses[lane].double(), one.poses[k].double()
            assert float((a[:3, 3] - b[:3, 3]).norm()) < 1e-3
            assert rot_angle(a[:3, :3].numpy(), b[:3, :3].numpy()) < 1e-4
            for name in ("aborted", "pair_overflow", "is_degenerate"):
                assert bool(getattr(res, name)[lane]) \
                    == bool(getattr(one, name)[k]), name
    assert differ <= 1
    assert all(r.poses.shape == (len(STARTS), 4, 4) for _, _, r in fleet)


def test_fleet_counters_come_from_the_step_reads(scene):
    reads0 = graphs.STATS.host_reads
    ticks = fleet_ticks(scene)
    it = torch.stack([r.iterations for _, _, r in ticks])
    assert it.shape == (TICKS, len(STARTS))
    # a tick runs its step until its slowest lane is done, one read each
    assert graphs.STATS.host_reads - reads0 == int(
        it.max(dim=1).values.sum())


def plane_gap(T, out):
    """The benchmark's ``plane_gap_m``: sqrt(d^T H d / w2), d the right
    perturbation from the reference's final pose to T, H the reference's
    last system."""
    k = out["steps"]
    R, t = out["R"][k].numpy(), out["t"][k].numpy()
    M = R.T @ T[:3, :3]
    w = 0.5 * np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                        M[1, 0] - M[0, 1]])
    d = np.concatenate([w, R.T @ (T[:3, 3] - t)])
    H = out["H"][k].numpy()
    return float(np.sqrt(max(d @ H @ d, 0.0) / max(out["w2"][k], 1e-30)))


def test_each_lane_against_the_float64_reference(scene, fleet, single):
    import json
    ref = _reference()
    with open(os.path.join(ROOT, "bench_port", "configs",
                           "map53m.json")) as f:
        icp = json.load(f)["icp"]
    world = torch.as_tensor(scene["world"])
    k = TICKS - 1                 # the lanes seeded by their own estimates
    T1, T2, res = fleet[k]
    for lane, s in enumerate(STARTS):
        out = ref.register(
            torch.as_tensor(scene["frames_s"][s + k], dtype=torch.float64),
            world, ("cv", T1[lane].double(), T2[lane].double()), METHOD, icp)
        gap = plane_gap(res.poses[lane].double().numpy(), out)
        own = plane_gap(single[lane].poses[k].double().numpy(), out)
        assert gap < 1e-3, (lane, gap)
        assert abs(gap - own) < 2e-5, (lane, gap, own)


def per_lane_inputs(scene, lanes=STARTS):
    """K1's inputs for the lanes' scans at their ground-truth poses, as the
    fleet's prologue builds them: the per-lane blocks stacked, one pair
    list over them from the per-lane cull, slot-local ids."""
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                    device=scene["device"])
    src = f32(np.stack([scene["frames_s"][s] for s in lanes]))
    Rs = f32(np.stack([scene["gt"][s][:3, :3] for s in lanes]))
    ts = f32(np.stack([scene["gt"][s][:3, 3] for s in lanes]))
    L, N = src.shape[:2]
    nq = -(-N // tk.QB)
    src_q = torch.cat([src, src[:, -1:].expand(L, nq * tk.QB - N, 3)],
                      1).reshape(L, nq, tk.QB, 3)
    qbox = tuple(x.reshape(1, L * nq, 3)
                 for x in tk.exact_qbox(src_q, Rs, ts))
    mindex, radius = scene["mindex"], R0 + MARGIN
    S, G, P = scene["caps"]
    sel, ok, sovf = tk.super_candidates(None, None, None, None, mindex,
                                        radius, S, qbox=qbox, lanes=L)
    rel_l, bids = tk.hier_relevance(None, None, None, None, mindex, sel, ok,
                                    radius, qbox=qbox)
    qid, tid, slot, _, table, ovf, rovf = tk.make_pair_list_slotted(
        rel_l[0], P, G, block_ids=bids, nbt=mindex.block.num_blocks,
        lanes=L)
    assert int((ovf + rovf + sovf).sum()) == 0
    kw = dict(slot=slot, tid_table=table, max_per_query=G)
    blocks = src_q.reshape(L * nq, tk.QB, 3).transpose(1, 2).contiguous()
    poses = torch.cat([Rs.reshape(L, 9), ts], 1)
    return dict(blocks=blocks, poses=poses, qid=qid, tid=tid, kw=kw,
                src=src, Rs=Rs, ts=ts, nq=nq, radius=radius)


def k1_points(src, pose):
    """The world-frame points as K1 computes them, in float32: each
    coordinate ((r0 x + r1 y) + r2 z) + t."""
    R, t = pose[:9], pose[9:]
    return torch.stack([(R[3 * c] * src[:, 0] + R[3 * c + 1] * src[:, 1])
                        + R[3 * c + 2] * src[:, 2] + t[c]
                        for c in range(3)], 1)


def sq_dist(p, g):
    """K1's squared distance, (dx^2 + dy^2) + dz^2, of points p (..., 3)
    to map points g (..., 3)."""
    d = g - p
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def brute_knn(p, world, radius):
    """(squared distances (N, K) ascending, a function of ids giving the
    squared distances of each point to those map points), by brute force
    over the map points within ``radius`` of ``p``'s box, in K1's float
    operations."""
    lo, hi = p.amin(0) - radius, p.amax(0) + radius
    cand = world[((world >= lo) & (world <= hi)).all(1)]
    best = torch.cat([torch.topk(sq_dist(q[:, None], cand[None]), tk.K,
                                 dim=1, largest=False).values
                      for q in p.split(100)])
    return best, lambda ids: sq_dist(p[:, None], world[ids])


def test_k1_per_lane_mode_against_brute_force(scene):
    a = per_lane_inputs(scene)
    bi, world = scene["mindex"].block, scene["world_t"]
    val, idx = tk.batched_block_knn(bi, a["blocks"], a["poses"], a["qid"],
                                    a["tid"], radius=a["radius"],
                                    layout="nk", per_lane=True, **a["kw"])
    L, N = a["src"].shape[:2]
    ib = tk._index_bits(a["kw"]["max_per_query"] * tk.TB)
    _, _, _, scale = tk.key_params(a["radius"], ib)
    quantum = 1.0001 / scale
    checked = 0
    for lane in range(L):
        p = k1_points(a["src"][lane], a["poses"][lane])
        best, dist = brute_knn(p, world, a["radius"])
        got = idx[lane, :N, :tk.K].long()
        # every neighbour within the culled radius is among the culled
        # blocks: there K1's ranks hold the brute-force distances
        within = best <= a["radius"] ** 2
        assert bool((got[within] >= 0).all())
        true = dist(got.clamp(min=0))
        assert float((true - best)[within].abs().max()) <= quantum
        # the key truncates: its distance lies within a quantum under
        gap = (true - val[lane, :N, :tk.K])[within]
        assert float(gap.min()) >= -1e-7 * a["radius"] ** 2
        assert float(gap.max()) <= quantum
        checked += int(within.sum())
    assert checked > 0.9 * L * N * tk.K


def test_k1_per_lane_keys_are_each_lanes_own(scene):
    """Each lane's keys in the per-lane mode equal K1's keys for that lane
    alone (B = 1) over its own run of the pair list."""
    a = per_lane_inputs(scene)
    pid = a["kw"]["slot"]
    ib = tk._index_bits(a["kw"]["max_per_query"] * tk.TB)
    _, _, clamp, scale = tk.key_params(a["radius"], ib)
    tgt = scene["mindex"].block.blocks
    i32 = lambda t: t.to(torch.int32).contiguous()
    keys = tk.block_knn_keys(a["blocks"], tgt, a["poses"], i32(a["qid"]),
                             i32(a["tid"]), i32(pid), None, ib, scale,
                             clamp, nq_lane=a["nq"])
    nq, L = a["nq"], len(STARTS)
    assert keys.shape == (L * nq, 1, tk.KP, tk.QB)
    for lane in range(L):
        mine = (a["qid"] >= lane * nq) & (a["qid"] < (lane + 1) * nq)
        qid = torch.where(mine, a["qid"] - lane * nq, nq)
        order = torch.sort(qid, stable=True).indices
        one = tk.block_knn_keys(
            a["blocks"][lane * nq:(lane + 1) * nq], tgt,
            a["poses"][lane:lane + 1], i32(qid[order]), i32(a["tid"][order]),
            i32(pid[order]), None, ib, scale, clamp)
        assert torch.equal(keys[lane * nq:(lane + 1) * nq], one)


ODD_ITERATIONS = 6          # an overflowed lane need not converge


def first_tick(sc, kind=None):
    """The first tick, with lane 1 forced to abort (its seed 60 m off the
    map: no neighbours) or to overflow its pair list (its scan spread
    threefold about its centroid: far more pairs than the capacities
    hold), or as it is; at most ODD_ITERATIONS steps."""
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    T1 = f32([sc["known"][s + 1] for s in STARTS])
    T2 = f32([sc["known"][s] for s in STARTS])
    scans = f32(np.stack([sc["frames_s"][s] for s in STARTS]))
    if kind == "abort":
        T1[1, 0, 3] += 60.0
        T2[1, 0, 3] += 60.0
    elif kind == "overflow":
        c = scans[1].mean(0)
        scans[1] = (scans[1] - c) * 3.0 + c
    return todo.run_odometry_fleet(
        scans, sc["mindex"], sc["world_t"], T1, T2, **common(
            sc, icp_params=todo.ICPParams(max_iterations=ODD_ITERATIONS)))


@pytest.fixture(scope="module")
def first(scene):
    return first_tick(scene)


@pytest.mark.parametrize("kind", ["abort", "overflow"])
def test_an_odd_lane_leaves_the_others_bit_equal(scene, first, kind):
    res = first_tick(scene, kind)
    if kind == "abort":
        assert bool(res.aborted[1])
    else:
        assert int(res.pair_overflow[1]) > 0
    ok = first
    for name in todo.MapOdometryResult._fields:
        a, b = getattr(res, name), getattr(ok, name)
        for lane in (0, 2):
            assert torch.equal(a[lane], b[lane]) or (
                a[lane].dtype.is_floating_point
                and torch.equal(a[lane].isnan(), b[lane].isnan())
                and torch.equal(a[lane].nan_to_num(), b[lane].nan_to_num())), \
                (name, lane)


def method_enums():
    from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod,
                                                HandlingMethod)
    return DetectionMethod[METHOD[0]], HandlingMethod[METHOD[1]]


def test_the_fleet_graph_key_carries_the_lane_count(scene):
    S, G, P = scene["caps"]
    keys = set()
    for lanes in (1, 3):
        loop = todo.BatchLoop(scene["mindex"], scene["world_t"], lanes,
                              SCAN_POINTS, *method_enums(), todo.ICPParams(),
                              P, S, G, R0, MARGIN, torch.device("cpu"),
                              per_lane=True)
        keys.add(todo.MapLoop(loop, True, True, 1).key())
    one = todo.BatchLoop(scene["mindex"], scene["world_t"], 1, SCAN_POINTS,
                         *method_enums(), todo.ICPParams(), P, S, G, R0,
                         MARGIN, torch.device("cpu"))
    keys.add(todo.MapLoop(one, True, True, 128).key())
    assert len(keys) == 3
    with pytest.raises(ValueError, match="reused pair list"):
        todo.BatchLoop(scene["mindex"], scene["world_t"], 3, SCAN_POINTS,
                       *method_enums(), todo.ICPParams(), P, S, G, R0, 0.0,
                       torch.device("cpu"), per_lane=True)


def test_a_fleet_span_names_its_sensors(scene):
    with tracing.record() as rec:
        fleet_ticks(scene)
    calls = [s for s in rec.spans if s[0] == "odometry.fleet_call"]
    rows = len(STARTS) * SCAN_POINTS          # no counts: every row
    assert [s[4] for s in calls] == [
        {"call": calls[0][4]["call"] + k, "sensors": len(STARTS),
         "points": rows, "capacity": rows}
        for k in range(TICKS)]
    reads = [s for s in rec.spans if s[0] == "graphs.done_read"]
    assert all(rec.spans[s[1]][0] == "odometry.fleet_call" for s in reads)


@pytest.fixture(scope="module")
def cuda_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_scene("cuda")


@pytest.mark.chip
def test_captured_fleet_step_replays_its_eager_run(cuda_scene):
    eager = fleet_ticks(cuda_scene, graph=False)
    graphed = fleet_ticks(cuda_scene, graph=True)
    again = fleet_ticks(cuda_scene, graph=True)     # replays
    for (_, _, a), (_, _, b), (_, _, c) in zip(eager, graphed, again):
        for name in todo.MapOdometryResult._fields:
            x, y, z = (getattr(r, name).cpu() for r in (a, b, c))
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), name
            assert torch.equal(y.nan_to_num(), z.nan_to_num()), name


@pytest.mark.chip
def test_k1_per_lane_kernel_matches_its_twin(cuda_scene):
    a = per_lane_inputs(cuda_scene)
    ib = tk._index_bits(a["kw"]["max_per_query"] * tk.TB)
    _, _, clamp, scale = tk.key_params(a["radius"], ib)
    i32 = lambda t: t.to(torch.int32).contiguous()
    args = (a["blocks"], cuda_scene["mindex"].block.blocks, a["poses"],
            i32(a["qid"]), i32(a["tid"]), i32(a["kw"]["slot"]), None, ib,
            scale, clamp)
    keys = tk.block_knn_keys(*args, nq_lane=a["nq"])
    twin = tk.block_knn_keys_plain(*args, nq_lane=a["nq"])
    assert torch.equal(keys, twin)
    # with the live mask of a reused list: every second pair dropped
    mask = i32((torch.arange(a["qid"].numel(), device=a["qid"].device)
                % 2)[:, None])
    args = args[:6] + (mask,) + args[7:]
    assert torch.equal(tk.block_knn_keys(*args, nq_lane=a["nq"]),
                       tk.block_knn_keys_plain(*args, nq_lane=a["nq"]))
