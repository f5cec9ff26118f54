"""Port parity: the baseline engines SuperLoc, O3D and the Euler/LOAM
engine, the pieces under them (``solve_qr_6x6``, ``boxplus_left``,
``euler_to_lie_jacobian``, ``logpack``/``log_from_buffer``) against
dcreg_tpu on the same inputs, f64 on the CPU.

Stated tolerances (f64 throughout, so the two sides differ only by
summation order):
- the small ops, the Euler Jacobian rows and the SuperLoc helpers: rtol
  1e-9, atol 1e-12 (the pair-engine tolerance); masks, counts and the
  observability histogram identical; the packed logs exactly equal.
- each engine on the brute-force backend (the CSR grid runs under the
  harness, ``tests/test_torch_harness*.py``): converged, aborted and
  iterations identical; R, t and every logged pose, dx, rmse, fitness
  and objective within rtol 1e-9, atol 1e-12, H and the gradient within
  rtol 1e-9 and atol 1e-12 of their largest entry (sums of signed terms,
  as ``tests/test_torch_pair_engine.py`` holds build_system); every logged
  flag and count identical; the logged spectra, condition numbers and
  solver extras and the covariance, which invert or decompose H, within
  rtol 1e-6, atol 1e-9 (the pair engine's bar for spectra);
  rot_error_deg within atol 1e-6 deg, since the arccos of the trace
  loses half the digits near a zero angle (1e-16 in the trace is 1e-8
  rad there).
- ``SuperLocInfo``: histogram and masks identical, uncertainties and
  condition numbers within rtol 1e-9.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from chip_smoke import synthetic_cylinder
from dcreg_tpu.config import load_config
from dcreg_tpu.models import icp as jicp
from dcreg_tpu.models import logpack as jlp
from dcreg_tpu.models import superloc as jsl
from dcreg_tpu.models.icp_euler import _euler_jacobian_rows as j_rows
from dcreg_tpu.models.icp_euler import icp_point_to_plane_euler as j_euler
from dcreg_tpu.models.o3d_style import o3d_icp as j_o3d
from dcreg_tpu.ops import linalg as jla
from dcreg_tpu.ops import se3 as jse3
from dcreg_tpu.ops.degeneracy import DetectionMethod as JD
from dcreg_tpu.ops.degeneracy import HandlingMethod as JH
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models import icp as ticp
from dcreg_tpu_torch.models import logpack as tlp
from dcreg_tpu_torch.models import superloc as tsl
from dcreg_tpu_torch.models.icp_euler import _euler_jacobian_rows as t_rows
from dcreg_tpu_torch.models.icp_euler import \
    icp_point_to_plane_euler as t_euler
from dcreg_tpu_torch.models.o3d_style import o3d_icp as t_o3d
from dcreg_tpu_torch.ops import linalg as tla
from dcreg_tpu_torch.ops import se3 as tse3
from dcreg_tpu_torch.ops.degeneracy import DetectionMethod, HandlingMethod

T = torch.from_numpy
CYL = load_config("configs/cylinder.yaml")
PARK = load_config("configs/parkinglot.yaml")
SO3_ROWS = [m for m in CYL.test_methods
            if m[0] in ("ME-SR", "ME-TSVD", "ME-TReg", "FCN-SR", "Ours")]
# fields of the log that decompose or invert H
DERIVED = {"eigenvalues_full", "singular_values", "lambda_schur_rot",
           "lambda_schur_trans", "V_schur_rot", "V_schur_trans",
           "lambda_diag_rot", "lambda_diag_trans", "cond_full",
           "cond_schur_rot", "cond_schur_trans", "cond_diag_rot",
           "cond_diag_trans", "cond_full_sub_rot", "cond_full_sub_trans",
           "pcg_residual", "cond_PH", "P_preconditioner", "W_adaptive"}


def _close(ours, ref, rtol=1e-9, atol=1e-12, **kw):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), rtol=rtol,
                               atol=atol, **kw)


def assert_results_match(rt, rj):
    """The port's ICPResult ``rt`` against the JAX one ``rj`` at the
    tolerances of the module docstring."""
    for f in ("converged", "aborted", "iterations"):
        assert np.array_equal(getattr(rt, f).numpy(),
                              np.asarray(getattr(rj, f))), f
    _close(rt.R.numpy(), rj.R)
    _close(rt.t.numpy(), rj.t)
    _close(rt.covariance.numpy(), rj.covariance, rtol=1e-6, atol=1e-9)
    for f in ticp.IterationLog._fields:
        ours, ref = getattr(rt.log, f).numpy(), np.asarray(getattr(rj.log,
                                                                   f))
        assert ours.shape == ref.shape, f
        if ref.dtype.kind in "bi":
            assert np.array_equal(ours, ref), f
        elif f in DERIVED:
            _close(ours, ref, rtol=1e-6, atol=1e-9, err_msg=f)
        elif f == "rot_error_deg":
            _close(ours, ref, rtol=1e-9, atol=1e-6, err_msg=f)
        elif f in ("H", "gradient"):
            _close(ours, ref, atol=1e-12 * np.nanmax(np.abs(ref), initial=0),
                   err_msg=f)
        else:
            _close(ours, ref, err_msg=f)


@pytest.fixture(scope="module")
def world():
    pts = synthetic_cylinder(5, 1500).astype(np.float64)
    return pts, CYL.initial_matrix()


# --------------------------------------------------------------------------
# small ops
# --------------------------------------------------------------------------

def test_solve_qr_6x6():
    rng = np.random.default_rng(1)
    for i in range(6):
        A = rng.normal(size=(40, 6))
        H = A.T @ A * 10.0 ** (i - 2)
        if i == 4:                       # LM-damped, one weak direction
            H[:, 0] *= 1e-6
            H[0, :] *= 1e-6
            H = H + 1e-4 * np.diag(np.diag(H))
        b = rng.normal(size=6)
        _close(tla.solve_qr_6x6(T(H), T(b)).numpy(),
               jla.solve_qr_6x6(jnp.asarray(H), jnp.asarray(b)), rtol=1e-9,
               atol=1e-12 * np.abs(np.asarray(
                   jla.solve_qr_6x6(jnp.asarray(H), jnp.asarray(b)))).max())


def test_boxplus_left_and_euler_to_lie_jacobian():
    rng = np.random.default_rng(2)
    R = np.array(jse3.exp_so3(jnp.asarray(rng.normal(size=(20, 3)))))
    t = rng.normal(size=(20, 3))
    d = rng.normal(size=(20, 6)) * 0.3
    d[0] = 0.0
    d[1, :3] = 1e-7                      # the small-angle branch
    Rj, tj = jse3.boxplus_left(jnp.asarray(R), jnp.asarray(t),
                               jnp.asarray(d))
    Rt, tt = tse3.boxplus_left(T(R), T(t), T(d))
    _close(Rt.numpy(), Rj)
    _close(tt.numpy(), tj)
    ang = rng.uniform(-1.4, 1.4, (3, 30))
    ang[1, 0] = np.pi / 2                # gimbal lock: the identity
    Jj = jse3.euler_to_lie_jacobian(*[jnp.asarray(a) for a in ang])
    Jt = tse3.euler_to_lie_jacobian(*[T(a) for a in ang])
    _close(Jt.numpy(), Jj)
    assert np.array_equal(Jt.numpy()[0], np.eye(3))


@pytest.mark.parametrize("faithful", [False, True])
def test_euler_jacobian_rows(faithful):
    rng = np.random.default_rng(3)
    p = rng.normal(size=(200, 3)) * 5
    wn = rng.normal(size=(200, 3))
    pose = np.array([0.03, -0.2, 1.1, 0.5, -0.2, 0.1])
    _close(t_rows(T(p), T(wn), T(pose), faithful).numpy(),
           j_rows(jnp.asarray(p), jnp.asarray(wn), jnp.asarray(pose),
                  faithful))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_logpack_round_trip(dtype):
    """pack_row / empty_buffer / unpack / log_from_buffer: the same rows
    and the same structured log as the JAX module, field by field."""
    rng = np.random.default_rng(4)
    fields = dict(executed=True, effective_points=812, corr_num=5,
                  rmse=rng.uniform(), fitness=1.7, gradient=rng.normal(
                      size=6), dx=rng.normal(size=6),
                  transform=rng.normal(size=(4, 4)), is_degenerate=True,
                  degenerate_mask=rng.uniform(size=6) > 0.5,
                  H=rng.normal(size=(6, 6)).astype(dtype))
    jbuf = jlp.empty_buffer(4, dtype)
    jbuf = jbuf.at[1].set(jlp.pack_row(dtype, **fields))
    jbuf = jbuf.at[2].set(jlp.pack_row(dtype, executed=False, rmse=0.5))
    tbuf = tlp.empty_buffer(4, torch.float64 if dtype == np.float64
                            else torch.float32)
    tbuf[1] = tlp.pack_row(tbuf.dtype, **{
        k: T(np.asarray(v)) if isinstance(v, np.ndarray) else v
        for k, v in fields.items()})
    tbuf[2] = tlp.pack_row(tbuf.dtype, executed=False, rmse=0.5)
    assert tlp.ROW_SIZE == jlp.ROW_SIZE
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    lj, lt = jicp.log_from_buffer(jbuf), ticp.log_from_buffer(tbuf)
    for f in ticp.IterationLog._fields:
        ours, ref = getattr(lt, f).numpy(), np.asarray(getattr(lj, f))
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, f
        np.testing.assert_array_equal(ours, ref, err_msg=f)


def test_superloc_helpers(world):
    pts, T0 = world
    R, t = T0[:3, :3], T0[:3, 3]
    rj = jsl._correspondences(jnp.asarray(pts), jnp.asarray(R),
                              jnp.asarray(t), jnp.asarray(pts), None, 1.0,
                              2048)
    rt = tsl._correspondences(T(pts), T(R), T(t), T(pts), None, 1.0, 2048)
    assert np.array_equal(rt[0].numpy(), np.asarray(rj[0]))
    assert int(rt[0].sum()) > 500
    for a, b in zip(rt[1:], rj[1:]):
        _close(a.numpy(), b, atol=1e-9)
    valid, normal, _, _, p_w = rt
    hj = jsl._observability_histogram(jnp.asarray(p_w.numpy()),
                                      jnp.asarray(normal.numpy()),
                                      jnp.asarray(valid.numpy()),
                                      jnp.asarray(R))
    ht = tsl._observability_histogram(p_w, normal, valid, T(R))
    assert ht.dtype == torch.int32
    assert np.array_equal(ht.numpy(), np.asarray(hj))
    r = np.linspace(-1.0, 1.0, 41)
    _close(tsl._tukey_weight(T(r), 0.5).numpy(),
           jsl._tukey_weight(jnp.asarray(r), 0.5))


# --------------------------------------------------------------------------
# the engines, brute-force backend
# --------------------------------------------------------------------------

def _pose(T0):
    return (jnp.asarray(T0[:3, :3]), jnp.asarray(T0[:3, 3])), \
        (T(T0[:3, :3].copy()), T(T0[:3, 3].copy()))


def test_superloc_register(world):
    pts, T0 = world
    (Rj, tj), (Rt, tt) = _pose(T0)
    params = CYL.icp_params()
    rj, ij = jsl.superloc_register(jnp.asarray(pts), jnp.asarray(pts), Rj,
                                   tj, params, T_gt=jnp.eye(4))
    rt, it = tsl.superloc_register(
        T(pts), T(pts), Rt, tt, convert.icp_params(params._asdict()),
        T_gt=torch.eye(4, dtype=torch.float64), device="cpu")
    assert_results_match(rt, rj)
    for f in ("histogram", "is_degenerate", "degeneracy_mask"):
        assert np.array_equal(getattr(it, f).numpy(),
                              np.asarray(getattr(ij, f))), f
    for f in ("uncertainties", "cond_full", "cond_rot", "cond_trans"):
        _close(getattr(it, f).numpy(), getattr(ij, f))
    assert bool(it.is_degenerate) and int(it.histogram.sum()) > 0


def test_o3d_icp(world):
    pts, T0 = world
    (Rj, tj), (Rt, tt) = _pose(T0)
    params = PARK.icp_params()
    rj = j_o3d(jnp.asarray(pts), jnp.asarray(pts), Rj, tj, params,
               T_gt=jnp.eye(4))
    rt = t_o3d(T(pts), T(pts), Rt, tt, convert.icp_params(params._asdict()),
               T_gt=torch.eye(4, dtype=torch.float64), device="cpu")
    assert_results_match(rt, rj)
    assert int(rt.iterations) > 2


@pytest.mark.parametrize("row", SO3_ROWS, ids=[m[0] for m in SO3_ROWS])
def test_icp_point_to_plane_euler(world, row):
    pts, T0 = world
    _, det, hand = row
    (Rj, tj), (Rt, tt) = _pose(T0)
    params = CYL.icp_params()
    rj = j_euler(jnp.asarray(pts), jnp.asarray(pts), Rj, tj, JD(det),
                 JH(hand), params, T_gt=jnp.eye(4))
    rt = t_euler(T(pts), T(pts), Rt, tt, DetectionMethod(det),
                 HandlingMethod(hand), convert.icp_params(params._asdict()),
                 T_gt=torch.eye(4, dtype=torch.float64), device="cpu")
    assert_results_match(rt, rj)


@pytest.mark.parametrize("engine", ["superloc", "o3d", "euler", "xicp"])
def test_engines_raise_without_gpu(monkeypatch, engine):
    """No silent CPU fallback: without a card and without device="cpu"
    each new engine raises before it computes anything."""
    from dcreg_tpu_torch.models.xicp import xicp_register
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = torch.zeros(50, 3, dtype=torch.float64)
    R, t = torch.eye(3, dtype=torch.float64), torch.zeros(3,
                                                          dtype=torch.float64)
    det, hand = DetectionMethod.XICP_EQUALITY, HandlingMethod.XICP_CONSTRAINT
    run = {"superloc": lambda: tsl.superloc_register(pts, pts, R, t),
           "o3d": lambda: t_o3d(pts, pts, R, t),
           "euler": lambda: t_euler(pts, pts, R, t, DetectionMethod.NONE,
                                    HandlingMethod.NONE),
           "xicp": lambda: xicp_register(pts, pts, R, t, det, hand)}[engine]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()
