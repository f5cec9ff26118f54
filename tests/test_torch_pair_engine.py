"""Port parity: the pair-mode engine ``icp_point_to_plane_so3`` and the
modules under it against dcreg_tpu on the same inputs, in f64 on the CPU.

Stated tolerances (f64 throughout, so the two sides differ only by
summation order):
- ``householder_lstsq``, ``fit_planes``, ``correspondence_tail``,
  ``build_system`` (both modes), ``point_to_point_error`` and the Euler
  pose helpers: rtol 1e-9 (atol 1e-12 near zero); masks and counts
  identical.
- ``icp_point_to_plane_so3`` for the five SO(3) method pairs of
  ``configs/cylinder.yaml`` on the brute-force backend (the grid backend
  runs under the harness, ``tests/test_torch_harness.py``):
  converged, aborted and iterations identical; R and t within 1e-8; on
  executed rows the spectra within rtol 1e-6 and ``degenerate_mask``
  identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from chip_smoke import synthetic_cylinder
from dcreg_tpu.config import load_config
from dcreg_tpu.models.icp import icp_point_to_plane_so3 as j_icp
from dcreg_tpu.ops import correspondence as jc
from dcreg_tpu.ops import se3 as jse3
from dcreg_tpu.ops.degeneracy import DetectionMethod as JD
from dcreg_tpu.ops.degeneracy import HandlingMethod as JH
from dcreg_tpu.ops.gauss_newton import build_system as j_build
from dcreg_tpu.ops.metrics import point_to_point_error as j_p2p
from dcreg_tpu.ops.voxel_grid import build_grid_index as j_grid
from dcreg_tpu.ops.voxel_grid import grid_knn as j_grid_knn
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models.icp import icp_point_to_plane_so3 as t_icp
from dcreg_tpu_torch.ops import correspondence as tc
from dcreg_tpu_torch.ops import se3 as tse3
from dcreg_tpu_torch.ops.degeneracy import DetectionMethod, HandlingMethod
from dcreg_tpu_torch.ops.gauss_newton import build_system as t_build
from dcreg_tpu_torch.ops.metrics import point_to_point_error as t_p2p

T = torch.from_numpy
CFG = load_config("configs/cylinder.yaml")
SO3_ROWS = [m for m in CFG.test_methods
            if m[0] in ("ME-SR", "ME-TSVD", "ME-TReg", "FCN-SR", "Ours")]


def _close(ours, ref, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def world():
    pts = synthetic_cylinder(5, 1500).astype(np.float64)
    return pts, CFG.initial_matrix()


def test_euler_pose_helpers():
    rng = np.random.default_rng(1)
    # pitch inside (-pi/2, pi/2): at +-pi/2 roll and yaw are not unique
    poses = np.column_stack([rng.uniform(-3, 3, (20, 1)),
                             rng.uniform(-1.5, 1.5, (20, 1)),
                             rng.uniform(-3, 3, (20, 1)),
                             rng.uniform(-5, 5, (20, 3))])
    Mj = np.array(jse3.pose6d_to_matrix(jnp.asarray(poses)))
    Mt = tse3.pose6d_to_matrix(T(poses)).numpy()
    _close(Mt, Mj)
    _close(tse3.matrix_to_pose6d(T(Mj)).numpy(),
           np.asarray(jse3.matrix_to_pose6d(jnp.asarray(Mj))), atol=1e-7)
    _close(tse3.rot_to_quat(T(Mj[:, :3, :3])).numpy(),
           np.asarray(jse3.rot_to_quat(jnp.asarray(Mj[:, :3, :3]))))


def test_householder_lstsq_and_fit_planes():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(50, 5, 3))
    b = rng.normal(size=(50, 5))
    _close(tc.householder_lstsq(T(A), T(b)).numpy(),
           np.asarray(jc.householder_lstsq(jnp.asarray(A), jnp.asarray(b))))
    # noisy planar sets, exactly coplanar ones through the origin and a
    # degenerate (collinear) set
    n = rng.normal(size=(60, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    base = rng.normal(size=(60, 5, 3))
    base -= np.einsum("nkj,nj->nk", base, n)[..., None] * n[:, None]
    neigh = base + 0.01 * rng.normal(size=base.shape) + 2.0 * n[:, None]
    neigh[:10] = base[:10]
    neigh[10] = np.outer(np.arange(5.0), [1.0, 2.0, 0.5])
    nj, dj, okj = jc.fit_planes(jnp.asarray(neigh))
    nt, dt, okt = tc.fit_planes(T(neigh))
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    _close(nt.numpy()[ok], np.asarray(nj)[ok], rtol=1e-9, atol=1e-9)
    _close(dt.numpy()[ok], np.asarray(dj)[ok], rtol=1e-9, atol=1e-9)


def _corr_inputs(world):
    pts, T0 = world
    grid = j_grid(pts, 1.0, dtype=jnp.float64)
    p_world = pts @ T0[:3, :3].T + T0[:3, 3]
    sq_d, idx = j_grid_knn(grid, jnp.asarray(p_world), k=5)
    return pts, T0, p_world, np.asarray(sq_d), np.asarray(idx)


def test_correspondence_tail_and_build_system(world):
    pts, T0, p_world, sq_d, idx = _corr_inputs(world)
    src_valid = np.random.default_rng(3).uniform(size=len(pts)) > 0.05
    cj = jc.correspondence_tail(jnp.asarray(p_world), jnp.asarray(sq_d),
                                jnp.asarray(idx), jnp.asarray(pts[idx]),
                                jc.CorrespondenceParams(),
                                jnp.asarray(src_valid))
    ct = tc.correspondence_tail(T(p_world), T(sq_d.copy()),
                                T(idx.copy()).long(),
                                T(pts[idx]), tc.CorrespondenceParams(),
                                T(src_valid))
    for f in ("valid", "in_radius"):
        assert np.array_equal(getattr(ct, f).numpy(),
                              np.asarray(getattr(cj, f))), f
    assert int(ct.valid.sum()) > 500
    for f in ("normal", "residual", "weight"):
        _close(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)),
               atol=1e-9)
    R, t = T0[:3, :3], T0[:3, 3]
    for wd in (True, False):
        sj = j_build(jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t), cj,
                     num_source=len(pts) + 7, use_weight_derivative=wd)
        st = t_build(T(pts), T(R), T(t), ct, num_source=len(pts) + 7,
                     use_weight_derivative=wd)
        assert int(st.num_valid) == int(sj.num_valid)
        scale = np.abs(np.asarray(sj.H)).max()
        for f in ("H", "g"):
            _close(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                   atol=1e-12 * scale)
        for f in ("rmse", "fitness", "objective"):
            _close(getattr(st, f).numpy(), np.asarray(getattr(sj, f)))


@pytest.mark.parametrize("masked", [False, True])
def test_point_to_point_error(world, masked):
    pts, T0 = world
    aligned = pts @ T0[:3, :3].T + 0.1 * T0[:3, 3]
    rng = np.random.default_rng(4)
    av = rng.uniform(size=len(pts)) > 0.1 if masked else None
    tv = rng.uniform(size=len(pts)) > 0.1 if masked else None
    j = j_p2p(jnp.asarray(aligned), jnp.asarray(pts), 0.2,
              None if av is None else jnp.asarray(av),
              None if tv is None else jnp.asarray(tv))
    t = t_p2p(T(aligned), T(pts), 0.2, None if av is None else T(av),
              None if tv is None else T(tv))
    assert int(t[3]) == int(j[3]) > 0
    for a, b in zip(t[:3], j[:3]):
        _close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("row", SO3_ROWS, ids=[m[0] for m in SO3_ROWS])
def test_icp_point_to_plane_so3(world, row):
    """Brute-force backend (K2's twin on the port's side); the grid
    backend is held to the same bar through the harness's method runs
    (tests/test_torch_harness.py::test_engine_results_match)."""
    pts, T0 = world
    _, det, hand = row
    params = CFG.icp_params()
    T_gt = np.eye(4)
    jg = tg = None
    rj = j_icp(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(T0[:3, :3]),
               jnp.asarray(T0[:3, 3]), JD(det), JH(hand), params,
               T_gt=jnp.asarray(T_gt), grid=jg)
    rt = t_icp(pts, pts, T0[:3, :3], T0[:3, 3], DetectionMethod(det),
               HandlingMethod(hand), convert.icp_params(params._asdict()),
               T_gt=T_gt, grid=tg, device="cpu")
    for f in ("converged", "aborted", "iterations"):
        assert np.array_equal(getattr(rt, f).numpy(),
                              np.asarray(getattr(rj, f))), f
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-8)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-8)
    ex = np.asarray(rj.log.executed)
    assert np.array_equal(rt.log.executed.numpy(), ex)
    assert np.array_equal(rt.log.degenerate_mask.numpy()[ex],
                          np.asarray(rj.log.degenerate_mask)[ex])
    assert np.array_equal(rt.log.effective_points.numpy(),
                          np.asarray(rj.log.effective_points))
    for f in ("eigenvalues_full", "singular_values", "lambda_schur_rot",
              "lambda_schur_trans", "cond_schur_rot", "cond_schur_trans"):
        np.testing.assert_allclose(getattr(rt.log, f).numpy()[ex],
                                   np.asarray(getattr(rj.log, f))[ex],
                                   rtol=1e-6, atol=1e-9, err_msg=f)
    np.testing.assert_allclose(rt.log.transform.numpy()[ex],
                               np.asarray(rj.log.transform)[ex], atol=1e-8)
    np.testing.assert_allclose(rt.covariance.numpy(),
                               np.asarray(rj.covariance), rtol=1e-6,
                               atol=1e-12)
