"""The pair engines and the voxel odometry loop as CUDA graphs: what can
be checked without a card.

* The host-sync guard of ``tests/test_torch_graph_capture.py`` fails on
  every op that reads the device from the host or builds a tensor from
  host data inside the prologue, step and epilogue of
  ``icp_point_to_plane_so3`` (``PairLoop``: the DCReg fast path and the
  full analysis, on the brute-force, ``GridIndex`` and ``BlockIndex``
  backends), ``icp_point_to_plane_euler`` (``EulerLoop``) and
  ``run_odometry``'s frame (``VoxelLoop``, DCReg and ME-TSVD): such an op
  cannot be captured.  The only exemption is the kernel boundary: the
  ops under ``knn_candidates_plain``, K2's plain twin, which the card
  does not run (it launches K2).
* Driving the parts reproduces, bit for bit, each loop as it was written
  before the split (Python-index history writes, out-of-place state),
  kept below as ``_seed_pair``, ``_seed_euler`` and ``_seed_voxel``: R,
  t, iterations, flags, ``H_last``, the telemetry log and the covariance;
  the voxel loop's every output row, on frames that stop early and on
  frames that run out of trips.
* ``graph=True`` on the CPU raises; the cache key follows the storage of
  the target, the index and the grid.

Small scenes (1,200 cylinder points, three voxel frames of 400 points,
float32 as on the card), no JAX: about 30 s on one worker.
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from chip_smoke import synthetic_cylinder
from dcreg_tpu_torch import graphs
from dcreg_tpu_torch.config import load_config
from dcreg_tpu_torch import harness
from dcreg_tpu_torch.models import icp as ticp
from dcreg_tpu_torch.models import icp_euler as teul
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.models.icp import (Hist, _empty_log, covariance_from_H,
                                        empty_hist, telemetry_row)
from dcreg_tpu_torch.ops import knn_kernels as kn
from dcreg_tpu_torch.ops import linalg, se3
from dcreg_tpu_torch.ops.block_sparse import build_block_index, morton_argsort
from dcreg_tpu_torch.ops.correspondence import find_correspondences
from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod, HandlingMethod,
                                            analyze)
from dcreg_tpu_torch.ops.gauss_newton import build_system
from dcreg_tpu_torch.ops.solvers import solve
from dcreg_tpu_torch.ops.voxel_grid import build_grid_index, build_voxel_grid
from test_torch_graph_capture import HostSyncGuard, _same

CFG = load_config("configs/cylinder.yaml")
ROWS = {name: (det, hand) for name, det, hand in CFG.methods()}
PARAMS = CFG.icp_params()._replace(max_iterations=10)
CPU = torch.device("cpu")


# --------------------------------------------------------------------------
# scenes (numpy, seeded), float32
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    pts = synthetic_cylinder(11, 1200)
    pts = pts[morton_argsort(pts)]
    cloud = torch.as_tensor(pts)
    T0 = torch.as_tensor(CFG.initial_matrix(), dtype=torch.float32)
    return {"cloud": cloud, "R0": T0[:3, :3].contiguous(),
            "t0": T0[:3, 3].contiguous(),
            "T_gt": torch.as_tensor(CFG.gt_matrix(), dtype=torch.float32),
            "brute": None,
            "grid": build_grid_index(pts, CFG.search_radius,
                                     device="cpu"),
            "block": build_block_index(pts, device="cpu")}


def _world(seed=0, m=4000):
    """A floor and two walls, as ``tests/test_odometry.py``'s world."""
    rng = np.random.default_rng(seed)
    q = m // 4
    floor = np.column_stack([rng.uniform(-15, 15, 2 * q),
                             rng.uniform(-15, 15, 2 * q),
                             rng.normal(0, 0.01, 2 * q)])
    wall1 = np.column_stack([rng.uniform(-15, 15, q),
                             -5.0 + rng.normal(0, 0.01, q),
                             rng.uniform(0, 4, q)])
    wall2 = np.column_stack([8.0 + rng.normal(0, 0.01, q),
                             rng.uniform(-15, 15, q), rng.uniform(0, 4, q)])
    return np.vstack([floor, wall1, wall2])


@pytest.fixture(scope="module")
def voxel():
    world = _world()
    rng = np.random.default_rng(1)
    gt, frames = [], []
    for i in range(3):
        c, s = np.cos(0.03 * i), np.sin(0.03 * i)
        T = np.eye(4)
        T[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        T[:3, 3] = [0.4 * i, 0.1 * i, 0.0]
        gt.append(T)
        sel = world[rng.choice(world.shape[0], 400, replace=False)]
        frames.append((sel - T[:3, 3]) @ T[:3, :3]
                      + rng.normal(0, 0.004, (400, 3)))
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)
    frames = f32(frames)
    valid = torch.ones(frames.shape[:2], dtype=torch.bool)
    valid[1, :40] = False
    return {"grid": build_voxel_grid(f32(world), 1.0, device="cpu"),
            "frames": frames, "valid": valid, "T0": f32(gt[0])}


# the method rows per loop: the DCReg pair (the fast path in the SO(3)
# engine) and rows of the full analysis
PAIR_CASES = [("brute", "Ours"), ("brute", "ME-TSVD"), ("grid", "Ours"),
              ("grid", "FCN-SR"), ("block", "Ours"), ("block", "ME-SR")]
EULER_CASES = [("brute", "Ours"), ("grid", "ME-TReg")]
# (row, icp_iterations, constant velocity): the second runs frames out of
# trips
VOXEL_CASES = [("Ours", 8, True), ("ME-TSVD", 3, False)]


def _pair_loop(pair, cls, backend, row, params=PARAMS):
    det, hand = ROWS[row]
    cloud = pair["cloud"]
    loop = cls(cloud, cloud.shape[0], det, hand, params, None, None, None,
               pair[backend], CPU, torch.float32)
    state = graphs.State()
    loop.load(state, cloud, pair["R0"], pair["t0"], pair["T_gt"])
    return loop, state


def _voxel_loop(voxel, row, trips, cv):
    det, hand = ROWS[row]
    params = todo.OdometryParams(icp_iterations=trips, capacity=64,
                                 use_constant_velocity=cv)
    frames = voxel["frames"]
    loop = todo.VoxelLoop(voxel["grid"], frames.shape[1], det, hand, params,
                          todo.ROW_BLOCK, CPU, torch.float32)
    state = graphs.State()
    loop.load(state, frames[0], voxel["valid"][0], voxel["T0"])
    return loop, state, params


# --------------------------------------------------------------------------
# the host-sync guard
# --------------------------------------------------------------------------

@pytest.fixture
def guard(monkeypatch):
    g = HostSyncGuard()
    plain = kn.K2.twin

    def exempt_plain(*args, **kwargs):
        g.exempt += 1
        try:
            return plain(*args, **kwargs)
        finally:
            g.exempt -= 1

    monkeypatch.setattr(kn.K2, "twin", exempt_plain)
    return g


def _warm_up(parts):
    """One eager run of every part, as ``graphs.Graphs`` runs them before
    capture: host-side constants cached at first use are made there."""
    for fn in parts.values():
        fn()


def _guarded(guard, parts):
    """The parts, each under the guard."""
    def run(name):
        with guard:
            parts[name]()
    return run


@pytest.mark.parametrize("backend,row", PAIR_CASES,
                         ids=[f"{b}-{r}" for b, r in PAIR_CASES])
def test_pair_parts_do_not_read_the_host(pair, guard, backend, row):
    loop, state = _pair_loop(pair, ticp.PairLoop, backend, row,
                             PARAMS._replace(max_iterations=3))
    parts = graphs.parts(loop, state)
    _warm_up(parts)
    graphs.drive(_guarded(guard, parts), state, 3)
    assert guard.seen["aten.where"] > 0 and int(state.k) >= 1
    if backend == "brute":
        assert guard.seen["aten.topk"] > 0          # under K2's twin


@pytest.mark.parametrize("backend,row", EULER_CASES,
                         ids=[f"{b}-{r}" for b, r in EULER_CASES])
def test_euler_parts_do_not_read_the_host(pair, guard, backend, row):
    loop, state = _pair_loop(pair, teul.EulerLoop, backend, row,
                             PARAMS._replace(max_iterations=3))
    parts = graphs.parts(loop, state)
    _warm_up(parts)
    graphs.drive(_guarded(guard, parts), state, 3)
    assert int(state.k) >= 1


@pytest.mark.parametrize("row,trips,cv", VOXEL_CASES,
                         ids=[c[0] for c in VOXEL_CASES])
def test_voxel_parts_do_not_read_the_host(voxel, guard, row, trips, cv):
    loop, state, params = _voxel_loop(voxel, row, trips, cv)
    parts = graphs.parts(loop, state)
    _warm_up(parts)
    loop.load(state, voxel["frames"][0], voxel["valid"][0], voxel["T0"])
    for f in range(2):
        state.put("scan", voxel["frames"][f])
        state.put("scan_valid", voxel["valid"][f])
        graphs.drive(_guarded(guard, parts), state, params.icp_iterations)
    assert int(state.f) == 2


# --------------------------------------------------------------------------
# bit for bit against the loops before the split
# --------------------------------------------------------------------------

def _seed_pair(source_xyz, target_xyz, R, t, detection, handling, params,
               T_gt, grid):
    """``icp_point_to_plane_so3``'s loop as written before the split:
    the history written at the Python index ``k``, the state rebound out
    of place, one host read of (converged | aborted) per iteration.
    Returns (ICPResult, H_last)."""
    dtype = source_xyz.dtype
    I = params.max_iterations
    fast = (detection is DetectionMethod.SCHUR_CONDITION_NUMBER and
            handling is HandlingMethod.PRECONDITIONED_CG)
    hist = empty_hist(I, dtype)
    converged = torch.zeros((), dtype=torch.bool)
    aborted = torch.zeros((), dtype=torch.bool)
    k = 0
    while k < I and not bool(converged | aborted):
        corr = find_correspondences(source_xyz, R, t, target_xyz,
                                    params=params.corr, chunk=params.chunk,
                                    grid=grid)
        sysm = build_system(source_xyz, R, t, corr,
                            use_weight_derivative=params.use_weight_derivative,
                            weight_slope=params.corr.weight_slope)
        analysis = analyze(sysm.H, detection, params.thresholds, fast=fast)
        dx, _ = solve(sysm.H, sysm.g, handling, analysis, params.thresholds,
                      telemetry=False, fast=fast)
        too_few = sysm.num_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        hist.R[k], hist.t[k], hist.H[k], hist.g[k] = R, t, sysm.H, sysm.g
        hist.dx[k] = dx
        hist.num_valid[k] = sysm.num_valid.to(torch.int32)
        hist.rmse[k], hist.fitness[k] = sysm.rmse, sysm.fitness
        hist.objective[k] = sysm.objective
        R_new, t_new = se3.boxplus(R, t, dx)
        R = torch.where(abort_now, R, R_new)
        t = torch.where(abort_now, t, t_new)
        converged = (torch.linalg.norm(dx[:3])
                     < params.convergence_thresh_rot) & \
            (torch.linalg.norm(dx[3:]) < params.convergence_thresh_trans) \
            & ~abort_now
        aborted = abort_now
        k += 1
    H_last = hist.H[max(k - 1, 0)]
    if params.full_telemetry:
        log = telemetry_row(hist, torch.arange(I) < k, detection, handling,
                            params.thresholds, params.min_effective_points,
                            T_gt)
    else:
        log = _empty_log(I, dtype)
    cov = covariance_from_H(H_last, converged, dtype)
    return ticp.ICPResult(R=R, t=t, converged=converged, aborted=aborted,
                          iterations=torch.tensor(k, dtype=torch.int32),
                          covariance=cov, log=log), H_last


def _seed_euler(source_xyz, target_xyz, R0, t0, detection, handling, params,
                T_gt, grid):
    """``icp_point_to_plane_euler``'s loop as written before the split.
    Returns (ICPResult, H_last)."""
    dtype = source_xyz.dtype
    I = params.max_iterations
    pose = se3.matrix_to_pose6d(se3.se3_matrix(R0, t0))
    denom = float(source_xyz.shape[0])
    z = lambda *s: torch.zeros((I,) + s, dtype=dtype)
    nan = lambda: torch.full((I,), float("nan"), dtype=dtype)
    hist = teul.EulerHist(pose=z(6), H=z(6, 6), g=z(6),
                          num_valid=torch.zeros(I, dtype=torch.int32),
                          rmse=nan(), fitness=nan(), objective=nan())
    prev_rmse = torch.tensor(torch.finfo(dtype).max, dtype=dtype)
    prev_fitness = torch.zeros((), dtype=dtype)
    converged = torch.zeros((), dtype=torch.bool)
    aborted = torch.zeros((), dtype=torch.bool)
    k = 0
    while k < I and not bool(converged | aborted):
        T = se3.pose6d_to_matrix(pose)
        corr = find_correspondences(source_xyz, T[:3, :3], T[:3, 3],
                                    target_xyz, params=params.corr,
                                    chunk=params.chunk, grid=grid)
        s = torch.where(corr.valid, corr.weight, 0.0).to(dtype)
        J = teul._euler_jacobian_rows(source_xyz, corr.normal * s[:, None],
                                      pose)
        J = torch.where(corr.valid[:, None], J, 0.0)
        b = -(s * corr.residual)
        H = J.T @ J
        g = J.T @ b
        n_valid = torch.sum(corr.valid)
        raw_sq = torch.where(corr.valid, corr.residual ** 2, 0.0)
        rmse = torch.sqrt(torch.sum(raw_sq)
                          / torch.clamp(n_valid, min=1).to(dtype))
        fitness = torch.sum(corr.in_radius.to(dtype)) / denom
        analysis = analyze(H, detection, params.thresholds)
        dx, _ = solve(H, g, handling, analysis, params.thresholds,
                      telemetry=False)
        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        hist.pose[k], hist.H[k], hist.g[k] = pose, H, g
        hist.num_valid[k] = n_valid.to(torch.int32)
        hist.rmse[k], hist.fitness[k] = rmse, fitness
        hist.objective[k] = 0.5 * torch.sum(b * b)
        pose = torch.where(abort_now, pose, pose + dx)
        converged = (torch.abs(rmse - prev_rmse) < 1e-4) & \
            (torch.abs(fitness - prev_fitness) < 1e-4) & ~abort_now
        aborted = abort_now
        prev_rmse, prev_fitness = rmse, fitness
        k += 1
    H_last = hist.H[max(k - 1, 0)]
    executed = torch.arange(I) < k
    ana = analyze(hist.H, detection, params.thresholds)
    dx, sinfo = solve(hist.H, hist.g, handling, ana, params.thresholds,
                      telemetry=True)
    too_few = hist.num_valid < params.min_effective_points
    abort = too_few | ~torch.all(torch.isfinite(dx), dim=-1)
    dx = torch.where(abort[:, None], 0.0, dx)
    T_new = se3.pose6d_to_matrix(hist.pose + dx)
    log = ticp.log_rows(hist, executed, too_few, dx, T_new, T_gt, ana, sinfo)
    w_h, V_h = linalg.symmetric_eigh(H_last)
    invertible = torch.amin(torch.abs(w_h)) > 1e-12
    w_inv = 1.0 / torch.where(torch.abs(w_h) > 1e-12, w_h,
                              torch.ones_like(w_h))
    cov_euler = (V_h * w_inv[None, :]) @ V_h.T
    w_c, V_c = linalg.symmetric_eigh(cov_euler)
    cov_euler = (V_c * torch.clamp(w_c, min=1e-9)[None, :]) @ V_c.T
    J_cov = torch.eye(6, dtype=dtype)
    J_cov[:3, :3] = se3.euler_to_lie_jacobian(pose[0], pose[1], pose[2])
    cov = J_cov @ cov_euler @ J_cov.T
    w_f, V_f = linalg.symmetric_eigh(cov)
    cov = (V_f * torch.clamp(w_f, min=1e-9)[None, :]) @ V_f.T
    cov = torch.where(converged & invertible, cov,
                      1e6 * torch.eye(6, dtype=dtype))
    T_final = se3.pose6d_to_matrix(pose)
    return ticp.ICPResult(R=T_final[:3, :3], t=T_final[:3, 3],
                          converged=converged, aborted=aborted,
                          iterations=torch.tensor(k, dtype=torch.int32),
                          covariance=cov, log=log), H_last


def _same_result(out, ref, H_last, H_ref):
    for name in ("R", "t", "converged", "aborted", "iterations",
                 "covariance"):
        _same(getattr(out, name), getattr(ref, name), name)
    _same(H_last, H_ref, "H_last")
    for name in ticp.IterationLog._fields:
        _same(getattr(out.log, name), getattr(ref.log, name), name)


@pytest.mark.parametrize("backend,row", PAIR_CASES,
                         ids=[f"{b}-{r}" for b, r in PAIR_CASES])
def test_pair_steps_match_the_seed_loop(pair, backend, row):
    params = PARAMS._replace(full_telemetry=backend != "block")
    loop, state = _pair_loop(pair, ticp.PairLoop, backend, row, params)
    graphs.drive(graphs.run_eager(graphs.parts(loop, state)), state,
                 params.max_iterations)
    out = loop.result(state)
    H_last = state.get_tuple("hist", Hist).H[max(int(state.k) - 1, 0)]
    ref, H_ref = _seed_pair(pair["cloud"], pair["cloud"], pair["R0"],
                            pair["t0"], *ROWS[row], params, pair["T_gt"],
                            pair[backend])
    _same_result(out, ref, H_last, H_ref)
    assert int(out.iterations) >= 2


@pytest.mark.parametrize("backend,row", EULER_CASES,
                         ids=[f"{b}-{r}" for b, r in EULER_CASES])
def test_euler_steps_match_the_seed_loop(pair, backend, row):
    loop, state = _pair_loop(pair, teul.EulerLoop, backend, row)
    graphs.drive(graphs.run_eager(graphs.parts(loop, state)), state,
                 PARAMS.max_iterations)
    out = loop.result(state)
    H_last = state.get_tuple("hist", teul.EulerHist).H[
        max(int(state.k) - 1, 0)]
    ref, H_ref = _seed_euler(pair["cloud"], pair["cloud"], pair["R0"],
                             pair["t0"], *ROWS[row], PARAMS, pair["T_gt"],
                             pair[backend])
    _same_result(out, ref, H_last, H_ref)
    assert int(out.iterations) >= 2


def _seed_voxel(frames, frames_valid, grid, T0, detection, handling,
                params):
    """``run_odometry``'s frame loop as written before the split: the
    trips with one host read of ``active`` each, the outputs stacked on
    the host."""
    thr = params.thresholds
    R_prev, t_prev = T0[:3, :3], T0[:3, 3]
    R_prev2, t_prev2 = R_prev, t_prev
    outs = []
    for f in range(frames.shape[0]):
        R, t = todo._seed(R_prev, t_prev, R_prev2, t_prev2,
                          params.use_constant_velocity)
        scan, scan_valid = frames[f], frames_valid[f]
        n_done, active = 0, True
        H, g, n_valid, rmse, fitness = todo._map_system(
            scan, scan_valid, grid, R, t, params)
        ana = analyze(H, detection, thr)
        for trip in range(params.icp_iterations):
            if trip:
                H, g, n_valid, rmse, fitness = todo._map_system(
                    scan, scan_valid, grid, R, t, params)
                ana = analyze(H, detection, thr)
                if not active:
                    break
            dx, _ = solve(H, g, handling, ana, thr, telemetry=False)
            ok = (n_valid >= params.min_effective_points) \
                & torch.all(torch.isfinite(dx))
            dx = torch.where(ok, dx, torch.zeros_like(dx))
            R, t = se3.boxplus(R, t, dx)
            conv = (torch.linalg.norm(dx[:3])
                    < params.convergence_thresh_rot) \
                & (torch.linalg.norm(dx[3:])
                   < params.convergence_thresh_trans)
            n_done += 1
            active = bool(ok & ~conv)
        outs.append((se3.se3_matrix(R, t), n_done, not active, rmse,
                     fitness, n_valid, ana.is_degenerate,
                     ana.degenerate_mask, ana.cond_schur_rot,
                     ana.cond_schur_trans, ana.cond_full))
        R_prev2, t_prev2, R_prev, t_prev = R_prev, t_prev, R, t
    cols = [torch.stack(c) if torch.is_tensor(c[0]) else torch.tensor(c)
            for c in zip(*outs)]
    return todo.OdometryResult(*cols)


@pytest.mark.parametrize("row,trips,cv", VOXEL_CASES,
                         ids=[c[0] for c in VOXEL_CASES])
def test_voxel_frames_match_the_seed_loop(voxel, row, trips, cv):
    det, hand = ROWS[row]
    params = todo.OdometryParams(icp_iterations=trips, capacity=64,
                                 use_constant_velocity=cv)
    out = todo.run_odometry(voxel["frames"], voxel["grid"], T0=voxel["T0"],
                            detection=det, handling=hand, params=params,
                            frames_valid=voxel["valid"], device="cpu")
    ref = _seed_voxel(voxel["frames"], voxel["valid"], voxel["grid"],
                      voxel["T0"], det, hand, params)
    for name in todo.OdometryResult._fields:
        a, b = getattr(out, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _same(a, b, name)
    # the cases hold frames that stop early and frames out of trips
    if cv:
        assert bool(out.converged.all()) and int(out.iterations.max()) < trips
    else:
        assert not bool(out.converged.all())


# --------------------------------------------------------------------------
# options and cache keys
# --------------------------------------------------------------------------

def test_graph_true_on_the_cpu_raises(pair, voxel):
    cloud, det_hand = pair["cloud"], ROWS["Ours"]
    for engine in (ticp.icp_point_to_plane_so3,
                   teul.icp_point_to_plane_euler):
        with pytest.raises(ValueError, match="CUDA device"):
            engine(cloud, cloud, pair["R0"], pair["t0"], *det_hand, PARAMS,
                   device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        todo.run_odometry(voxel["frames"], voxel["grid"], device="cpu",
                          graph=True)
    runner = harness.TestRunner(CFG._replace(use_grid_index=False), device="cpu",
                        dtype=torch.float32, graph=True)
    runner.load_point_clouds(cloud.numpy(), cloud.numpy())
    with pytest.raises(ValueError, match="CUDA device"):
        runner.run_single_test("Ours", *det_hand)


@pytest.mark.parametrize("cls", [ticp.PairLoop, teul.EulerLoop],
                         ids=["so3", "euler"])
def test_pair_cache_key_follows_the_storage_read_in_place(pair, cls):
    key = _pair_loop(pair, cls, "grid", "Ours")[0].key()
    assert _pair_loop(pair, cls, "grid", "Ours")[0].key() == key
    g = pair["grid"]
    moved = dict(pair, grid=type(g)(points=g.points, order=g.order.clone(),
                                    start=g.start, origin=g.origin,
                                    dims=g.dims, voxel_size=g.voxel_size,
                                    cap=g.cap))
    assert _pair_loop(moved, cls, "grid", "Ours")[0].key() != key
    wider = dict(pair, grid=type(g)(points=g.points, order=g.order,
                                    start=g.start, origin=g.origin,
                                    dims=g.dims, voxel_size=g.voxel_size,
                                    cap=g.cap + 8))
    assert _pair_loop(wider, cls, "grid", "Ours")[0].key() != key
    assert _pair_loop(dict(pair, cloud=pair["cloud"].clone()), cls, "grid",
                      "Ours")[0].key() != key
    b = pair["block"]
    bkey = _pair_loop(pair, cls, "block", "Ours")[0].key()
    shifted = type(b)(blocks=b.blocks, valid=b.valid, lo=b.lo.clone(),
                      hi=b.hi, num_blocks=b.num_blocks,
                      num_points=b.num_points, tb=b.tb)
    assert _pair_loop(dict(pair, block=shifted), cls, "block",
                      "Ours")[0].key() != bkey
    assert _pair_loop(pair, cls, "brute", "Ours")[0].key() not in (key, bkey)


def test_voxel_cache_key_follows_the_grid(voxel):
    key = _voxel_loop(voxel, "Ours", 8, True)[0].key()
    assert _voxel_loop(voxel, "Ours", 8, True)[0].key() == key
    grid = voxel["grid"]
    moved = dict(voxel, grid=grid._replace(points=grid.points.clone()))
    assert _voxel_loop(moved, "Ours", 8, True)[0].key() != key
    assert _voxel_loop(voxel, "Ours", 4, True)[0].key() != key
