"""Port parity: the voxel map index (``build_voxel_grid``, ``voxel_knn``)
and the voxel-grid odometry loop ``run_odometry`` against dcreg_tpu on
the CPU, in float64 as the JAX tests run.

Stated tolerances: ``build_voxel_grid``, every field equal (f64 and f32);
``voxel_knn``, ids equal and distances within 1e-12 in f64 (within 2 ulp
in f32, where XLA sums the three squares in another order), capacity 64
and chunks smaller than N; ``run_odometry`` on 3 frames of 500 points of
``tests/test_odometry.py``'s world, with the constant-velocity model and
without it (4 trips, so a frame runs out of trips), iterations and
``converged`` equal, poses within 1e-8 (m, and per rotation entry), rmse,
fitness and the condition numbers within 1e-8 relative.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.models import odometry as jodo
from dcreg_tpu.ops import voxel_grid as jvg
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.ops import voxel_grid as tvg
from test_odometry import _gt_trajectory, _make_world

DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}


def _cloud(seed=0, m=3000):
    """Uniform points with exact duplicates (equal distances from any
    query) and a tenth of them invalid."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, 5, (m, 3))
    pts[100:110] = pts[50]
    pts[200:203] = pts[7]
    valid = rng.uniform(size=m) > 0.1
    valid[[50, 100, 105, 7, 200]] = True
    q = pts[:700] + rng.normal(0, 0.3, (700, 3))
    q[:4] = pts[50]
    q[4] = [40.0, 0.0, 0.0]          # outside the grid: no neighbour
    return pts, valid, q


def _grids(name):
    jdt, tdt = DTYPES[name]
    pts, valid, q = _cloud()
    gj = jvg.build_voxel_grid(jnp.asarray(pts, jdt), 1.0,
                              valid=jnp.asarray(valid))
    gt = tvg.build_voxel_grid(torch.as_tensor(pts, dtype=tdt), 1.0,
                              valid=torch.as_tensor(valid), device="cpu")
    return gj, gt, q


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_build_voxel_grid_fields_equal(name):
    gj, gt, _ = _grids(name)
    for f in jvg.VoxelGrid._fields:
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f).numpy()
        assert a.dtype.kind == b.dtype.kind, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_voxel_knn_matches(name):
    gj, gt, q = _grids(name)
    jdt, tdt = DTYPES[name]
    dj, ij = jvg.voxel_knn(gj, jnp.asarray(q, jdt), k=5, capacity=64,
                           chunk=256)
    dt, it = tvg.voxel_knn(gt, torch.as_tensor(q, dtype=tdt), k=5,
                           capacity=64, chunk=256)
    dj, dt, it = np.asarray(dj), dt.numpy(), it.numpy()
    assert it.dtype == np.int64
    assert np.array_equal(np.asarray(ij), it)
    fin = np.isfinite(dj)
    assert np.array_equal(fin, np.isfinite(dt))
    assert not fin[4].any() and np.all(it[4] == 0)
    assert np.all(dt[:4, :3] == 0.0)
    if name == "f64":
        np.testing.assert_allclose(dt[fin], dj[fin], rtol=0, atol=1e-12)
    else:
        ulp = np.abs(dt[fin].view(np.int32).astype(np.int64)
                     - dj[fin].view(np.int32).astype(np.int64))
        assert ulp.max() <= 2


def test_k_smallest_key_order_equals_stable_sort():
    """The f32 selection (an exact int64 key of distance bits and slot)
    returns what a stable sort returns, ties in slot order."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 6, (50, 200)).astype(np.float32) * 0.25
    d[:, ::7] = np.inf
    cand = torch.as_tensor(rng.integers(0, 10_000, (50, 200)))
    vals, ids = tvg._k_smallest_by_slot(torch.as_tensor(d), cand, 9)
    ref_v, ref_s = torch.sort(torch.as_tensor(d), dim=-1, stable=True)
    assert torch.equal(vals, ref_v[:, :9])
    assert torch.equal(ids, torch.gather(cand, 1, ref_s[:, :9]))


def test_voxel_grid_from_arrays():
    """A JAX-built grid carried across answers queries as the JAX one
    does."""
    gj, _, q = _grids("f64")
    gt = convert.voxel_grid_from_arrays(
        {f: np.asarray(getattr(gj, f)) for f in gj._fields}, device="cpu")
    assert gt.sorted_idx.dtype == torch.int64
    dj, ij = jvg.voxel_knn(gj, jnp.asarray(q), k=3, capacity=64, chunk=512)
    dt, it = tvg.voxel_knn(gt, torch.as_tensor(q), k=3, capacity=64)
    assert np.array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                               atol=1e-12)


# --------------------------------------------------------------------------
# run_odometry
# --------------------------------------------------------------------------

CASES = {"constant_velocity": dict(icp_iterations=8, capacity=64),
         "no_motion_model": dict(icp_iterations=4, capacity=64,
                                 use_constant_velocity=False)}


def _sequence():
    world = _make_world()
    gt = _gt_trajectory(3)
    rng = np.random.default_rng(1)
    frames = []
    for T in gt:
        sel = world[rng.choice(world.shape[0], 500, replace=False)]
        frames.append((sel - T[:3, 3]) @ T[:3, :3]
                      + rng.normal(0, 0.004, (500, 3)))
    return world, gt, np.asarray(frames)


@pytest.fixture(scope="module")
def jax_runs():
    world, gt, frames = _sequence()
    out = {}
    for name, kw in CASES.items():
        params = jodo.OdometryParams(**kw)
        out[name] = (params, jodo.run_odometry(
            jnp.asarray(frames), jnp.asarray(world), T0=jnp.asarray(gt[0]),
            params=params))
    return world, gt, frames, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_odometry_matches(jax_runs, case):
    world, gt, frames, runs = jax_runs
    params, rj = runs[case]
    rt = todo.run_odometry(frames, world, T0=gt[0],
                           params=convert.odometry_params(params._asdict()),
                           device="cpu")
    assert rt.poses.dtype == torch.float64
    for f in ("iterations", "converged", "effective_points",
              "is_degenerate", "degenerate_mask"):
        assert np.array_equal(getattr(rt, f).numpy(),
                              np.asarray(getattr(rj, f))), f
    np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses),
                               rtol=0, atol=1e-8)
    for f in ("rmse", "fitness", "cond_schur_rot", "cond_schur_trans",
              "cond_full"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-8,
                                   err_msg=f)
    err = np.linalg.norm(rt.poses.numpy()[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err.max() < 0.05


def test_run_odometry_case_covers_stops(jax_runs):
    """The cases hold frames that stop before the last trip (the loop's
    early end) and one that runs out of trips (converged False)."""
    runs = jax_runs[3]
    iters = np.concatenate([np.asarray(r.iterations) for _, r in
                            runs.values()])
    conv = np.concatenate([np.asarray(r.converged) for _, r in
                           runs.values()])
    assert (iters < 4).any() and not conv.all()


def test_run_odometry_takes_a_grid_and_enum_names():
    """A prebuilt VoxelGrid in place of the map, and the enums in place of
    their names, give the same run."""
    from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod,
                                                HandlingMethod)
    world, gt, frames = _sequence()
    params = todo.OdometryParams(icp_iterations=3, capacity=64)
    a = todo.run_odometry(frames[:2], world, T0=gt[0], params=params,
                          device="cpu")
    grid = tvg.build_voxel_grid(world, 1.0, device="cpu")
    b = todo.run_odometry(frames[:2], grid, T0=gt[0], params=params,
                          detection=DetectionMethod.SCHUR_CONDITION_NUMBER,
                          handling=HandlingMethod.PRECONDITIONED_CG,
                          device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_odometry_params_convert():
    p = jodo.OdometryParams(icp_iterations=5, capacity=48, chunk=64,
                            use_weight_derivative=False)
    q = convert.odometry_params(p._asdict())
    assert isinstance(q, todo.OdometryParams)
    assert q.corr._asdict() == p.corr._asdict()
    assert q.thresholds._asdict() == p.thresholds._asdict()
    assert (q.icp_iterations, q.capacity, q.chunk,
            q.use_weight_derivative) == (5, 48, 64, False)
