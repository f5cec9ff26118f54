"""The last compiled loops as CUDA graphs -- XICP, O3D, SuperLoc, the pose
graph and the sharded engine: what can be checked without a card.

* The host-sync guard of ``tests/test_torch_graph_capture.py`` fails on
  every op that reads the device from the host or builds a tensor from
  host data inside the parts of ``XICPLoop`` (each detection and
  handling pair the harness runs), ``O3DLoop`` and ``SuperLocLoop`` on
  the brute-force and grid backends, ``PoseGraphLoop``, and
  ``ShardedLoop`` (two-level, flat and dense search) on a one-rank gloo
  world: such an op cannot be captured.  The only exemptions are the
  ops under ``knn_candidates_plain``, K2's plain twin, which the card
  does not run (it launches K2), and the collective calls themselves.
* Driving the parts reproduces, bit for bit, each loop as written before
  the split (Python-index history writes, host reads in the loop), kept
  below as ``_seed_xicp``, ``_seed_o3d``, ``_seed_superloc``,
  ``_seed_pose_graph`` (its CG stopping early on a host read; the masked
  CG of the JAX body gives the same poses) and ``_seed_sharded``.
* ``graph=True`` on the CPU and on a gloo mesh raises; the cache key
  follows the storage of the target, the grid and the sharded map; a
  cache miss on any rank makes every rank capture anew.

Small scenes (the pair tests' 1,200-point cylinder, a W = 8 pose window,
f32), no JAX: about 40 s on one worker.
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch
import torch.distributed as dist

from chip_smoke import pose_graph_inputs, synthetic_cylinder, trajectory
from dcreg_tpu_torch import graphs, harness
from dcreg_tpu_torch.config import load_config
from dcreg_tpu_torch.models import logpack
from dcreg_tpu_torch.models import o3d_style as to3d
from dcreg_tpu_torch.models import pose_graph as tpg
from dcreg_tpu_torch.models import superloc as tsl
from dcreg_tpu_torch.models import xicp as tx
from dcreg_tpu_torch.models.icp import ICPResult, IterationLog, _empty_log
from dcreg_tpu_torch.models.icp import log_from_buffer
from dcreg_tpu_torch.ops import knn_kernels as kn
from dcreg_tpu_torch.ops import linalg, se3
from dcreg_tpu_torch.ops.block_sparse import kd_block_order, morton_argsort
from dcreg_tpu_torch.ops.correspondence import correspondence_tail
from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod, HandlingMethod,
                                            analyze)
from dcreg_tpu_torch.ops.gauss_newton import build_system
from dcreg_tpu_torch.ops.normals import estimate_normals
from dcreg_tpu_torch.ops.solvers import solve
from dcreg_tpu_torch.ops.voxel_grid import build_grid_index
from dcreg_tpu_torch.parallel import make_mesh, shard_points
from dcreg_tpu_torch.parallel import sharded as tsh
from test_torch_graph_capture import HostSyncGuard, _same

# the parking-lot matrix's rows and parameters on the cylinder's poses, as
# chip_smoke's phase 6 runs them
CFG = load_config("configs/parkinglot.yaml")
CYL = load_config("configs/cylinder.yaml")
ROWS = {name: (det, hand) for name, det, hand in CFG.methods()}
# the detection and handling pairs of the harness's XICP rows (XICP and
# XICP-INQ share theirs)
XICP_ROWS = ("XICP-INQ", "XICP-1", "XICP-EQ", "XICP-OP")
PARAMS = CFG.icp_params()._replace(max_iterations=10)
CPU = torch.device("cpu")
DCREG = (DetectionMethod.SCHUR_CONDITION_NUMBER,
         HandlingMethod.PRECONDITIONED_CG)


# --------------------------------------------------------------------------
# scenes (numpy, seeded), float32
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    pts = synthetic_cylinder(11, 1200)
    pts = pts[morton_argsort(pts)]
    T0 = torch.as_tensor(CYL.initial_matrix(), dtype=torch.float32)
    return {"cloud": torch.as_tensor(pts), "R0": T0[:3, :3].contiguous(),
            "t0": T0[:3, 3].contiguous(),
            "T_gt": torch.as_tensor(CYL.gt_matrix(), dtype=torch.float32),
            "brute": None,
            "grid": build_grid_index(pts, CFG.search_radius, device="cpu")}


def _window(dtype=torch.float32):
    """A W = 8 window: noisy odometry edges, one closure, the chain as the
    initial guess (``chip_smoke.pose_graph_inputs``)."""
    i, j, Z, info, init = pose_graph_inputs(trajectory(40.0, 8)[2], 5)
    cast = lambda x: torch.as_tensor(x, dtype=dtype)
    return cast(init), tpg.make_edges(i, j, cast(Z), info=cast(info),
                                      device="cpu")


@pytest.fixture(scope="module")
def window():
    return _window()


@pytest.fixture(scope="module")
def mesh():
    """A 1 x 1 mesh of a one-rank gloo world in this process."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield make_mesh(1, 1, device="cpu")
    if own:
        dist.destroy_process_group()


SHARD_BLOCK = 32


@pytest.fixture(scope="module")
def shard_scene():
    """The cylinder in kd-leaf order as the map (padded to whole blocks),
    600 of its points, noisy, as the scan, and a seed off the truth."""
    pts = synthetic_cylinder(12, 1200)
    pts = pts[kd_block_order(pts, SHARD_BLOCK)]
    rng = np.random.default_rng(4)
    scan = pts[np.sort(rng.choice(1200, 600, replace=False))] \
        + rng.normal(0.0, 0.002, (600, 3)).astype(np.float32)
    tgt, tgt_v = shard_points(torch.as_tensor(pts), 1, block=SHARD_BLOCK)
    T0 = torch.as_tensor(CYL.initial_matrix(), dtype=torch.float32)
    return {"src": torch.as_tensor(scan), "tgt": tgt, "tgt_v": tgt_v,
            "R0": T0[:3, :3].contiguous(), "t0": T0[:3, 3].contiguous()}


# the sharded searches: two-level cull, flat cull, dense
SHARD_CASES = {"two_level": dict(block_cull=True, num_blocks=24,
                                 super_size=4, num_supers=8),
               "flat": dict(block_cull=True, num_blocks=24),
               "dense": dict(block_cull=False)}


def _engine_loop(pair, engine, backend, row=None, params=PARAMS):
    cloud = pair["cloud"]
    args = (cloud, cloud.shape[0])
    tail = (None, None, None)
    if engine == "xicp":
        loop = tx.XICPLoop(*args, *ROWS[row], params, CFG.xicp, *tail, 5,
                           pair[backend], CPU, torch.float32)
    elif engine == "o3d":
        loop = to3d.O3DLoop(*args, params, *tail, 30, pair[backend], CPU,
                            torch.float32)
    else:
        loop = tsl.SuperLocLoop(*args, params, *tail, 4, pair[backend], CPU,
                                torch.float32)
    state = graphs.State()
    loop.load(state, cloud, pair["R0"], pair["t0"], pair["T_gt"])
    return loop, state


def _shard_loop(mesh, scene, case):
    kw = dict(block_size=SHARD_BLOCK, num_blocks=16, super_size=0,
              num_supers=8)
    kw.update({k: v for k, v in SHARD_CASES[case].items()})
    loop = tsh.ShardedLoop(mesh, scene["tgt"], scene["src"].shape[0], *DCREG,
                           tsh.ICPParams(), kw["block_cull"],
                           kw["block_size"], kw["num_blocks"],
                           kw["super_size"], kw["num_supers"], torch.float32)
    state = graphs.State()
    loop.load(state, scene["src"], torch.ones(600, dtype=torch.bool),
              scene["tgt_v"], scene["R0"], scene["t0"])
    return loop, state


def _pg_loop(window, cg_iters=64):
    poses, edges = window
    W = poses.shape[0]
    loop = tpg.PoseGraphLoop(W, edges.i.shape[0], 1, cg_iters, 1e-8, CPU,
                             torch.float32)
    state = graphs.State()
    loop.load(state, poses, edges, torch.zeros(1, dtype=torch.long),
              poses[:1], 1e8 * torch.eye(6)[None])
    return loop, state


# --------------------------------------------------------------------------
# the host-sync guard
# --------------------------------------------------------------------------

def _exempt(guard, fn):
    def run(*args, **kwargs):
        guard.exempt += 1
        try:
            return fn(*args, **kwargs)
        finally:
            guard.exempt -= 1
    return run


@pytest.fixture
def guard(monkeypatch):
    g = HostSyncGuard()
    monkeypatch.setattr(kn.K2, "twin", _exempt(g, kn.K2.twin))
    for name in ("all_reduce", "all_gather_into_tensor"):
        monkeypatch.setattr(tsh.dist, name, _exempt(g, getattr(dist, name)))
    return g


def _guarded_drive(guard, loop, state, max_iterations):
    parts = graphs.parts(loop, state)
    for fn in parts.values():      # the warm-up before a capture
        fn()

    def run(name):
        with guard:
            parts[name]()

    graphs.drive(run, state, max_iterations)
    assert guard.seen["aten.where"] > 0


ENGINE_CASES = [("xicp", r, b) for r in XICP_ROWS
                for b in ("brute", "grid")] + [
    (e, None, b) for e in ("o3d", "superloc") for b in ("brute", "grid")]
ENGINE_IDS = [f"{e}-{r or ''}-{b}" for e, r, b in ENGINE_CASES]


@pytest.mark.parametrize("engine,row,backend", ENGINE_CASES, ids=ENGINE_IDS)
def test_engine_parts_do_not_read_the_host(pair, guard, engine, row,
                                           backend):
    loop, state = _engine_loop(pair, engine, backend, row,
                               PARAMS._replace(max_iterations=3))
    _guarded_drive(guard, loop, state, 0 if engine == "superloc" else 3)
    assert int(state.iterations) >= 1
    if backend == "brute":
        assert guard.seen["aten.topk"] > 0          # under K2's twin


def test_pose_graph_parts_do_not_read_the_host(window, guard):
    loop, state = _pg_loop(window, cg_iters=8)
    _guarded_drive(guard, loop, state, 3)
    assert int(state.k) >= 1


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_sharded_parts_do_not_read_the_host(mesh, shard_scene, guard, case):
    loop, state = _shard_loop(mesh, shard_scene, case)
    _guarded_drive(guard, loop, state, 3)
    assert int(state.k) >= 1


# --------------------------------------------------------------------------
# bit for bit against the loops before the split
# --------------------------------------------------------------------------

def _seed_xicp(source_xyz, target_xyz, R, t, detection, handling, params,
               xicp_cfg, T_gt, grid, normal_k=5):
    """``xicp_register``'s loop as written before the split: one host read
    of (converged | aborted) per iteration, the log row written at the
    Python index ``k``.  Returns (ICPResult, H_last)."""
    dtype = source_xyz.dtype
    I = params.max_iterations
    denom = float(source_xyz.shape[0])
    target_normals = estimate_normals(target_xyz, k=normal_k,
                                      chunk=params.chunk)
    inequality = detection == DetectionMethod.XICP_INEQUALITY
    use_remap = detection == DetectionMethod.XICP_SOLUTION_REMAPPING
    buf = logpack.empty_buffer(I, dtype)
    cum_cnt = torch.zeros((), dtype=dtype)
    cum_err = torch.zeros((), dtype=dtype)
    converged = torch.zeros((), dtype=torch.bool)
    aborted = torch.zeros((), dtype=torch.bool)
    H_last = torch.eye(6, dtype=dtype)
    k = 0
    while k < I and not bool(converged | aborted):
        src_w = source_xyz @ R.T + t
        sq_d, idx = to3d.nearest(src_w, target_xyz, None, params.chunk, grid)
        mask = sq_d < params.corr.search_radius ** 2
        normals = target_normals[idx]
        tgt = target_xyz[idx]
        w = mask.to(dtype)
        F = torch.cat([torch.linalg.cross(src_w, normals, dim=-1), normals],
                      dim=-1)
        Fw = F * w[:, None]
        H = Fw.T @ F
        dot = torch.sum((src_w - tgt) * normals, dim=-1)
        b = -(Fw.T @ dot)
        n_valid = torch.sum(mask)
        err_sum = torch.sum(w * dot * dot)
        cum_cnt = cum_cnt + n_valid.to(dtype)
        cum_err = cum_err + err_sum
        rmse = torch.sqrt(cum_err / torch.clamp(cum_cnt, min=1.0))
        fitness = cum_cnt / denom
        if detection == DetectionMethod.XICP_OPTIMIZED_EQUALITY:
            det = tx.detect_optimized(src_w, normals, H, mask, xicp_cfg)
        elif detection in (DetectionMethod.XICP_EQUALITY,
                           DetectionMethod.XICP_INEQUALITY):
            det = tx.detect_ternary(src_w, tgt, normals, H, mask, inequality,
                                    xicp_cfg)
        else:
            det = tx.detect_solution_remapping(H, xicp_cfg)
        if handling == HandlingMethod.XICP_CONSTRAINT:
            dx = tx._solve_constraint(H, b, det, inequality, xicp_cfg)
        else:
            dx = tx._solve_projection(H, b, det, use_remap)
        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        R_new, t_new = se3.boxplus_left(R, t, dx)
        R = torch.where(abort_now, R, R_new)
        t = torch.where(abort_now, t, t_new)
        T_new = se3.se3_matrix(R, t)
        te, re = se3.pose_error(T_gt, T_new)
        mask6 = torch.cat([~det.loc_rot, ~det.loc_trans])
        wf, _ = linalg.symmetric_eigh(H)
        buf[k] = logpack.pack_row(
            dtype, None, executed=~too_few, effective_points=n_valid,
            corr_num=det.n_high_rot, rmse=rmse, fitness=fitness,
            objective=0.5 * err_sum, gradient=-b, dx=dx, transform=T_new,
            trans_error=te, rot_error_deg=re, eigenvalues_full=wf,
            singular_values=torch.flip(torch.abs(wf), (0,)),
            cond_full=linalg.condition_number(wf),
            is_degenerate=torch.any(mask6), degenerate_mask=mask6, H=H)
        converged = (torch.linalg.norm(dx[:3])
                     < params.convergence_thresh_rot) & \
            (torch.linalg.norm(dx[3:]) < params.convergence_thresh_trans) \
            & ~abort_now
        aborted = abort_now
        H_last = torch.where(abort_now, H_last, H)
        k += 1
    w_h, V_h = linalg.symmetric_eigh(H_last)
    invertible = torch.amin(torch.abs(w_h)) > 1e-12
    w_inv = 1.0 / torch.where(torch.abs(w_h) > 1e-12, w_h,
                              torch.ones_like(w_h))
    cov = (V_h * w_inv[None, :]) @ V_h.T
    cov = torch.where(converged & invertible, cov,
                      1e6 * torch.eye(6, dtype=dtype))
    return ICPResult(R=R, t=t, converged=converged, aborted=aborted,
                     iterations=torch.tensor(k, dtype=torch.int32),
                     covariance=cov, log=log_from_buffer(buf)), H_last


def _seed_o3d(source_xyz, target_xyz, R, t, params, T_gt, grid,
              normal_k=30):
    """``o3d_icp``'s loop as written before the split.  Returns
    (ICPResult, H_last)."""
    dtype = source_xyz.dtype
    I = params.max_iterations
    denom = float(source_xyz.shape[0])
    eye6 = torch.eye(6, dtype=dtype)
    normals = estimate_normals(target_xyz, k=normal_k, chunk=params.chunk)
    buf = logpack.empty_buffer(I, dtype)
    prev_fit = torch.zeros((), dtype=dtype)
    prev_rmse = torch.tensor(float("inf"), dtype=dtype)
    converged = torch.zeros((), dtype=torch.bool)
    aborted = torch.zeros((), dtype=torch.bool)
    H_last = eye6
    k = 0
    while k < I and not bool(converged | aborted):
        p_w = source_xyz @ R.T + t
        sq_d, idx = to3d.nearest(p_w, target_xyz, None, params.chunk, grid)
        mask = sq_d < params.corr.search_radius ** 2
        n = normals[idx]
        w = mask.to(dtype)
        r = torch.sum((p_w - target_xyz[idx]) * n, dim=-1)
        J = torch.cat([torch.linalg.cross(p_w, n, dim=-1), n],
                      dim=-1) * w[:, None]
        H = J.T @ J
        g = -(J.T @ (w * r))
        dx = linalg.solve_qr_6x6(H + 1e-12 * eye6, g)
        n_valid = torch.sum(mask)
        rmse = torch.sqrt(torch.sum(torch.where(mask, sq_d, 0.0))
                          / torch.clamp(n_valid, min=1).to(dtype))
        fitness = n_valid.to(dtype) / denom
        too_few = n_valid < params.min_effective_points
        abort_now = too_few | ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort_now, 0.0, dx)
        R_new, t_new = se3.boxplus_left(R, t, dx)
        R = torch.where(abort_now, R, R_new)
        t = torch.where(abort_now, t, t_new)
        T_new = se3.se3_matrix(R, t)
        te, re = se3.pose_error(T_gt, T_new)
        buf[k] = logpack.pack_row(
            dtype, None, executed=~too_few, effective_points=n_valid,
            corr_num=n_valid, rmse=rmse, fitness=fitness, dx=dx,
            transform=T_new, trans_error=te, rot_error_deg=re, H=H)
        converged = (torch.abs(fitness - prev_fit) < 1e-6) & \
            (torch.abs(rmse - prev_rmse) < 1e-6) & ~abort_now
        aborted = abort_now
        H_last = torch.where(abort_now, H_last, H)
        prev_fit, prev_rmse = fitness, rmse
        k += 1
    w_h, V_h = linalg.symmetric_eigh(H_last)
    inv = 1.0 / torch.clamp(torch.abs(w_h), min=1e-12)
    cov = (V_h * inv[None, :]) @ V_h.T
    return ICPResult(R=R, t=t, converged=converged, aborted=aborted,
                     iterations=torch.tensor(k, dtype=torch.int32),
                     covariance=cov, log=log_from_buffer(buf)), H_last


def _seed_superloc(source_xyz, target_xyz, R, t, params, T_gt, grid,
                   inner_iters=4):
    """``superloc_register`` as written before the split: the log's row 0
    written field by field from Python values at index 0."""
    dtype = source_xyz.dtype
    I = params.max_iterations
    tukey_a = (3.0 * tsl.PLANE_RESOLUTION) ** 0.5
    valid, normal, d_off, fit_q, _ = tsl._correspondences(
        source_xyz, R, t, target_xyz, None, params.corr.search_radius,
        params.chunk, grid=grid)
    n_valid = torch.sum(valid)
    for _ in range(inner_iters):
        p_w = source_xyz @ R.T + t
        r = torch.sum(p_w * normal, dim=-1) + d_off
        w = fit_q * tsl._tukey_weight(r, tukey_a) * valid.to(dtype)
        J = torch.cat([torch.linalg.cross(p_w, normal, dim=-1), normal],
                      dim=-1)
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = -(Jw.T @ r)
        dx = linalg.solve_qr_6x6(H + 1e-4 * torch.diag(torch.diagonal(H)),
                                 g)
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        R, t = se3.boxplus_left(R, t, dx)
    H_final = H
    p_w = source_xyz @ R.T + t
    r = torch.sum(p_w * normal, dim=-1) + d_off
    r_masked = torch.where(valid, r, 0.0)
    rmse = torch.sqrt(torch.sum(r_masked * r_masked)
                      / torch.clamp(n_valid, min=1).to(dtype))
    denom = float(source_xyz.shape[0])
    inliers = torch.sum(valid & (torch.abs(r) < 0.3))
    fitness = inliers.to(dtype) / denom
    hist = tsl._observability_histogram(p_w, normal, valid, R)
    histf = hist.to(dtype)
    tot_t = torch.clamp(histf[6] + histf[7] + histf[8], min=1e-12)
    unc_xyz = torch.clamp(histf[6:9] / tot_t * 3.0, max=1.0)
    tot_r = torch.clamp(torch.sum(histf[:6]), min=1e-12)
    unc_rpy = torch.clamp(torch.stack([
        (histf[0] + histf[1]) / tot_r * 3.0,
        (histf[2] + histf[3]) / tot_r * 3.0,
        (histf[4] + histf[5]) / tot_r * 3.0]), max=1.0)
    thr = torch.tensor([0.2, 0.1, 0.2], dtype=dtype)
    mask6 = torch.cat([unc_rpy < thr, unc_xyz < thr])
    is_degen = torch.any(mask6)

    def cond(w_asc):
        return torch.sqrt(torch.clamp(w_asc[-1], min=1e-10)
                          / torch.clamp(w_asc[0], min=1e-10))

    w_h, V_h = linalg.symmetric_eigh(H_final)
    inv = 1.0 / torch.clamp(w_h, min=1e-10)
    cov = (V_h * inv[None, :]) @ V_h.T
    T_new = se3.se3_matrix(R, t)
    te, re = se3.pose_error(T_gt, T_new)
    log = _empty_log(I, dtype)
    wf, _ = linalg.symmetric_eigh(H_final)
    row0 = dict(
        executed=True, effective_points=inliers.to(torch.int32), rmse=rmse,
        fitness=fitness, objective=0.5 * torch.sum(r_masked ** 2),
        transform=T_new, trans_error=te, rot_error_deg=re,
        eigenvalues_full=wf, singular_values=torch.flip(torch.abs(wf), (0,)),
        cond_full=linalg.condition_number(wf), is_degenerate=is_degen,
        degenerate_mask=mask6, H=H_final)
    for name, v in row0.items():
        getattr(log, name)[0] = v
    result = ICPResult(
        R=R, t=t, converged=rmse < 0.01,
        aborted=n_valid < params.min_effective_points,
        iterations=torch.tensor(1, dtype=torch.int32), covariance=cov,
        log=log)
    info = tsl.SuperLocInfo(
        uncertainties=torch.cat([unc_xyz, unc_rpy]), histogram=hist,
        cond_full=cond(linalg.symmetric_eigh(cov)[0]),
        cond_rot=cond(linalg.symmetric_eigh(cov[:3, :3])[0]),
        cond_trans=cond(linalg.symmetric_eigh(cov[3:, 3:])[0]),
        is_degenerate=is_degen, degeneracy_mask=mask6)
    return result, info


def _same_result(out, ref):
    for name in ("R", "t", "converged", "aborted", "iterations",
                 "covariance"):
        _same(getattr(out, name), getattr(ref, name), name)
    for name in IterationLog._fields:
        _same(getattr(out.log, name), getattr(ref.log, name), name)


@pytest.mark.parametrize("row,backend", [
    ("XICP-INQ", "brute"), ("XICP-1", "grid"), ("XICP-EQ", "brute"),
    ("XICP-OP", "grid")])
def test_xicp_steps_match_the_seed_loop(pair, row, backend):
    loop, state = _engine_loop(pair, "xicp", backend, row)
    graphs.drive(graphs.run_eager(graphs.parts(loop, state)), state,
                 PARAMS.max_iterations)
    cloud = pair["cloud"]
    ref, H_ref = _seed_xicp(cloud, cloud, pair["R0"], pair["t0"], *ROWS[row],
                            PARAMS, CFG.xicp, pair["T_gt"], pair[backend])
    _same_result(loop.result(state), ref)
    _same(state.H_last, H_ref, "H_last")
    assert int(ref.iterations) >= 2


@pytest.mark.parametrize("backend", ["brute", "grid"])
def test_o3d_steps_match_the_seed_loop(pair, backend):
    loop, state = _engine_loop(pair, "o3d", backend)
    graphs.drive(graphs.run_eager(graphs.parts(loop, state)), state,
                 PARAMS.max_iterations)
    cloud = pair["cloud"]
    ref, H_ref = _seed_o3d(cloud, cloud, pair["R0"], pair["t0"], PARAMS,
                           pair["T_gt"], pair[backend])
    _same_result(loop.result(state), ref)
    _same(state.H_last, H_ref, "H_last")
    assert int(ref.iterations) >= 2


@pytest.mark.parametrize("backend", ["brute", "grid"])
def test_superloc_parts_match_the_seed(pair, backend):
    loop, state = _engine_loop(pair, "superloc", backend)
    graphs.drive(graphs.run_eager(graphs.parts(loop, state)), state, 0)
    cloud = pair["cloud"]
    out, info = loop.result(state)
    ref, ref_info = _seed_superloc(cloud, cloud, pair["R0"], pair["t0"],
                                   PARAMS, pair["T_gt"], pair[backend])
    _same_result(out, ref)
    for name in tsl.SuperLocInfo._fields:
        _same(getattr(info, name), getattr(ref_info, name), name)


def _seed_pcg(H, g, W, iters=64, damping=1e-8):
    """The block-Jacobi CG as written before the split: it stops on a host
    read after the trip that meets the residual bound."""
    n = 6 * W
    H = H + damping * torch.eye(n, dtype=H.dtype)
    ar = torch.arange(W)
    diag = H.reshape(W, 6, W, 6)[ar, :, ar, :]
    w, V = linalg.symmetric_eigh(diag)
    w_inv = 1.0 / torch.clamp(torch.abs(w), min=1e-12) * torch.sign(
        torch.where(w == 0, 1.0, w))
    P_blocks = torch.einsum("wij,wj,wkj->wik", V, w_inv, V)

    def applyP(r):
        return torch.einsum("wij,wj->wi", P_blocks, r.reshape(W, 6)).reshape(n)

    x = torch.zeros(n, dtype=H.dtype)
    r = g
    z = applyP(r)
    p = z
    rz = r @ z
    thresh = 1e-10 * torch.clamp(torch.linalg.norm(g), min=1e-30)
    for _ in range(iters):
        Hp = H @ p
        pHp = p @ Hp
        safe = torch.abs(pHp) > 1e-30
        alpha = torch.where(safe, rz / torch.where(safe, pHp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        z = applyP(r)
        rz_new = r @ z
        rz_ok = torch.abs(rz) > 1e-30
        beta = torch.where(rz_ok, rz_new / torch.where(rz_ok, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_new
        if bool((torch.linalg.norm(r) <= thresh) | ~safe):
            break
    return x


def _seed_pose_graph(poses, edges, prior_idx, prior_T, prior_info,
                     max_gn_iters=10, cg_iters=64, tol=1e-8):
    """``optimize_pose_graph``'s loop as written before the split: one
    host read per GN step and one per CG trip."""
    W = poses.shape[0]
    it, converged = 0, False
    while it < max_gn_iters and not converged:
        H, g, _ = tpg._assemble(poses, edges, prior_idx, prior_T, prior_info)
        dx = _seed_pcg(H, g, W, iters=cg_iters)
        dx = torch.where(torch.all(torch.isfinite(dx)), dx,
                         torch.zeros_like(dx))
        R, t = se3.boxplus(poses[:, :3, :3], poses[:, :3, 3],
                           dx.reshape(W, 6))
        poses = se3.se3_matrix(R, t)
        converged = bool(torch.linalg.norm(dx) < tol * W)
        it += 1
    _, _, cost = tpg._assemble(poses, edges, prior_idx, prior_T, prior_info)
    return tpg.PoseGraphResult(poses=poses, iterations=it, final_cost=cost,
                               converged=converged)


@pytest.mark.parametrize("dtype,cg_iters,max_gn", [
    (torch.float64, 64, 10), (torch.float32, 6, 3)],
    ids=["f64-converging", "f32-trip-limited"])
def test_pose_graph_steps_match_the_seed_loop(dtype, cg_iters, max_gn):
    """The masked CG of the JAX body equals the early-stopping one: on a
    window that converges (in f64, 6 GN steps), and with CG and GN trips
    cut short."""
    poses, edges = _window(dtype)
    out = tpg.optimize_pose_graph(poses, edges, max_gn_iters=max_gn,
                                  cg_iters=cg_iters, device="cpu")
    ref = _seed_pose_graph(poses, edges, torch.zeros(1, dtype=torch.long),
                           poses[:1], 1e8 * torch.eye(6, dtype=dtype)[None],
                           max_gn, cg_iters)
    _same(out.poses, ref.poses, "poses")
    _same(out.final_cost, ref.final_cost, "final_cost")
    assert (out.iterations, out.converged) == (ref.iterations,
                                               ref.converged)
    assert isinstance(out.iterations, int) and isinstance(out.converged,
                                                          bool)
    assert out.converged == (dtype == torch.float64)


def _seed_sharded(mesh, src, tgt, R, t, detection, handling, params,
                  tgt_val, block_cull, block_size, num_blocks, super_size,
                  num_supers):
    """``sharded_icp_register``'s loop on a 1 x 1 mesh as written before
    the split: one host read of (conv | abort) per iteration, histories
    written at the Python index, the list form of the gather."""
    dtype = src.dtype
    cp = params.corr
    k = cp.k
    I = params.max_iterations
    src_val = torch.ones(src.shape[0], dtype=torch.bool)
    num_source = tsh._all_reduce(mesh, torch.sum(src_val, dtype=torch.int64))
    if block_cull:
        nbt_loc = tgt.shape[0] // block_size
        tgt_blocks = tgt.reshape(nbt_loc, block_size, 3)
        tgt_bval = tgt_val.reshape(nbt_loc, block_size)
        blo = torch.amin(torch.where(tgt_bval[..., None], tgt_blocks,
                                     float("inf")), dim=1)
        bhi = torch.amax(torch.where(tgt_bval[..., None], tgt_blocks,
                                     float("-inf")), dim=1)

    def one_iteration(R, t):
        p_w = src @ R.T + t
        if block_cull:
            d_loc, c_loc, b_ovf = tsh._local_topk_culled(
                p_w, src_val, tgt_blocks, tgt_bval, blo, bhi,
                cp.search_radius, k, num_blocks, sb=super_size,
                GS=num_supers)
        else:
            d_loc, c_loc = tsh._local_topk(p_w, tgt, tgt_val, k)
            b_ovf = torch.zeros((), dtype=torch.int64)
        n_loc = p_w.shape[0]
        packed = torch.cat([torch.cat([d_loc[..., None], c_loc],
                                      dim=-1).reshape(-1),
                            b_ovf.to(dtype).reshape(1)])
        out = [torch.empty_like(packed) for _ in mesh.map_slots]
        dist.all_gather(out, packed, group=mesh.map)
        gathered = torch.stack([out[s] for s in mesh.map_slots])
        ovf_map = torch.sum(gathered[:, -1])
        cands = gathered[:, :-1].reshape(1, n_loc, k, 4)
        flat = cands.permute(1, 0, 2, 3).reshape(n_loc, k, 4)
        sq_d, sel = tsh._smallest(flat[..., 0], k)
        neigh = torch.gather(flat[..., 1:], 1,
                             sel[..., None].expand(n_loc, k, 3))
        corr = correspondence_tail(p_w, sq_d, sel, neigh, cp,
                                   source_valid=src_val)
        sysm = build_system(src, R, t, corr,
                            use_weight_derivative=params.use_weight_derivative,
                            weight_slope=cp.weight_slope)
        sq_sum = torch.sum(torch.where(corr.valid,
                                       corr.residual * corr.residual, 0.0))
        n_fit = torch.sum(sq_d[:, k - 1] < cp.search_radius ** 2)
        f64 = lambda *xs: torch.cat([x.reshape(-1).double() for x in xs])
        tot = tsh._all_reduce(mesh, f64(sysm.H, sysm.g, sq_sum,
                                        sysm.objective, sysm.num_valid,
                                        n_fit, ovf_map))
        H = tot[:36].reshape(6, 6).to(dtype)
        g = tot[36:42].to(dtype)
        sq_sum, obj, n_valid, n_fit, ovf = tot[42:]
        rmse = torch.sqrt(sq_sum / torch.clamp(n_valid, min=1)).to(dtype)
        fitness = (n_fit / torch.clamp(num_source, min=1)).to(dtype)
        analysis = analyze(H, detection, params.thresholds)
        dx, _ = solve(H, g, handling, analysis, params.thresholds,
                      telemetry=False)
        return dx, n_valid.long(), rmse, fitness, ovf.long()

    dx_h = torch.full((I, 6), float("nan"), dtype=dtype)
    T_h = torch.full((I, 4, 4), float("nan"), dtype=dtype)
    conv = torch.zeros((), dtype=torch.bool)
    abort = torch.zeros((), dtype=torch.bool)
    rmse = fit = torch.full((), float("nan"), dtype=dtype)
    neff = ovf = torch.zeros((), dtype=torch.int64)
    it = 0
    while it < I and not bool(conv | abort):
        dx, n_valid, rmse, fit, b_ovf = one_iteration(R, t)
        abort = (n_valid < params.min_effective_points) | \
            ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort, 0.0, dx)
        R_new, t_new = se3.boxplus(R, t, dx)
        R = torch.where(abort, R, R_new)
        t = torch.where(abort, t, t_new)
        conv = (torch.linalg.norm(dx[:3]) < params.convergence_thresh_rot) \
            & (torch.linalg.norm(dx[3:]) < params.convergence_thresh_trans) \
            & ~abort
        dx_h[it] = dx
        T_h[it] = se3.se3_matrix(R, t)
        neff = n_valid
        ovf = torch.maximum(ovf, b_ovf)
        it += 1
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)
    return tsh.ShardedICPResult(R=R, t=t, converged=conv, aborted=abort,
                                iterations=i32(it), rmse=rmse, fitness=fit,
                                effective_points=i32(neff), dx_history=dx_h,
                                transform_history=T_h,
                                block_overflow=i32(ovf))


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_sharded_steps_match_the_seed_loop(mesh, shard_scene, case):
    sc = shard_scene
    kw = dict(block_size=SHARD_BLOCK, num_blocks=16, super_size=0,
              num_supers=8)
    kw.update(SHARD_CASES[case])
    params = tsh.ICPParams()
    out = tsh.sharded_icp_register(mesh, sc["src"], sc["tgt"], sc["R0"],
                                   sc["t0"], *DCREG, params,
                                   target_valid=sc["tgt_v"], **kw)
    ref = _seed_sharded(mesh, sc["src"], sc["tgt"], sc["R0"], sc["t0"],
                        *DCREG, params, sc["tgt_v"], kw["block_cull"],
                        kw["block_size"], kw["num_blocks"],
                        kw["super_size"], kw["num_supers"])
    for name in tsh.ShardedICPResult._fields:
        _same(getattr(out, name), getattr(ref, name), name)
    assert bool(out.converged) and int(out.iterations) >= 2
    assert int(out.block_overflow) == 0


# --------------------------------------------------------------------------
# options and cache keys
# --------------------------------------------------------------------------

def test_graph_true_on_the_cpu_raises(pair, window):
    cloud, R0, t0 = pair["cloud"], pair["R0"], pair["t0"]
    calls = [
        lambda: tx.xicp_register(cloud, cloud, R0, t0, *ROWS["XICP-EQ"],
                                 PARAMS, device="cpu", graph=True),
        lambda: to3d.o3d_icp(cloud, cloud, R0, t0, PARAMS, device="cpu",
                             graph=True),
        lambda: tsl.superloc_register(cloud, cloud, R0, t0, PARAMS,
                                      device="cpu", graph=True),
        lambda: tpg.optimize_pose_graph(*window, device="cpu", graph=True)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    runner = harness.TestRunner(CFG._replace(use_grid_index=False),
                                device="cpu", dtype=torch.float32,
                                graph=True)
    runner.load_point_clouds(cloud.numpy(), cloud.numpy())
    for name in ("O3D", "XICP-OP", "SuperLoc"):
        with pytest.raises(ValueError, match="CUDA device"):
            runner.run_single_test(name, *ROWS[name])


def test_graph_true_on_a_gloo_mesh_raises(mesh, shard_scene):
    sc = shard_scene
    with pytest.raises(ValueError, match="NCCL mesh: gloo"):
        tsh.sharded_icp_register(mesh, sc["src"], sc["tgt"], sc["R0"],
                                 sc["t0"], *DCREG, target_valid=sc["tgt_v"],
                                 graph=True)


@pytest.mark.parametrize("engine", ["xicp", "o3d", "superloc"])
def test_engine_cache_key_follows_the_storage_read_in_place(pair, engine):
    row = "XICP-EQ" if engine == "xicp" else None
    key = _engine_loop(pair, engine, "grid", row)[0].key()
    assert _engine_loop(pair, engine, "grid", row)[0].key() == key
    g = pair["grid"]
    moved = dict(pair, grid=type(g)(points=g.points, order=g.order.clone(),
                                    start=g.start, origin=g.origin,
                                    dims=g.dims, voxel_size=g.voxel_size,
                                    cap=g.cap))
    assert _engine_loop(moved, engine, "grid", row)[0].key() != key
    assert _engine_loop(dict(pair, cloud=pair["cloud"].clone()), engine,
                        "grid", row)[0].key() != key
    assert _engine_loop(pair, engine, "brute", row)[0].key() != key


def test_sharded_cache_key_follows_the_map(mesh, shard_scene):
    key = _shard_loop(mesh, shard_scene, "two_level")[0].key()
    assert _shard_loop(mesh, shard_scene, "two_level")[0].key() == key
    moved = dict(shard_scene, tgt=shard_scene["tgt"].clone())
    assert _shard_loop(mesh, moved, "two_level")[0].key() != key
    assert _shard_loop(mesh, shard_scene, "flat")[0].key() != key


def test_a_miss_on_any_rank_drops_the_entry(mesh, monkeypatch):
    """Before a graphed sharded call every rank of the mesh agrees: where
    one rank's cache misses the key, every rank drops its entry and
    captures anew (another rank's miss stands in as an all-reduce that
    returns 1)."""
    key = ("sharded_probe", 1)
    graphs.CACHE._entries[key] = "entry"
    try:
        tsh._agree_on_captures(mesh, key)
        assert key in graphs.CACHE
        monkeypatch.setattr(tsh.dist, "all_reduce",
                            lambda t, op=None, group=None: t.fill_(1))
        tsh._agree_on_captures(mesh, key)
        assert key not in graphs.CACHE
    finally:
        graphs.CACHE.discard(key)
