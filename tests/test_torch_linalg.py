"""Port parity: SE(3), 6x6 linear algebra, degeneracy analysis and the
degenerate-system solves (dcreg_tpu_torch.ops.{se3,linalg,degeneracy,
solvers}) against dcreg_tpu on the same f64 inputs.

Tolerance: rtol 1e-9 -- both sides run the same f64 algorithms (fixed-
sweep Jacobi, closed-form 3x3, unrolled Cholesky/PCG); only the summation
order inside small matmuls differs.  Every ``analyze`` field and every
``solve`` result is held to it elementwise; eigenvectors compare up to
column sign; masks, is_degenerate and PCG iteration counts must be
identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.ops import degeneracy as jdeg
from dcreg_tpu.ops import linalg as jlin
from dcreg_tpu.ops import se3 as jse3
from dcreg_tpu.ops import solvers as jsol
from dcreg_tpu_torch.ops import degeneracy as tdeg
from dcreg_tpu_torch.ops import linalg as tlin
from dcreg_tpu_torch.ops import se3 as tse3
from dcreg_tpu_torch.ops import solvers as tsol

RTOL = 1e-9


def _hessians(seed=0, n=12):
    """Random SPD GN Hessians, half of them near-degenerate (one direction
    3-30x weaker, which trips the Schur test).  Conditioning stays in the
    range of real GN systems: PCG then ends with a residual well away from
    its stopping threshold, so iteration counts are well defined."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        J = rng.normal(size=(60, 6)) * rng.uniform(1.0, 10.0, 6)
        if i % 2:
            u = rng.normal(size=6)
            u /= np.linalg.norm(u)
            J = J - (1.0 - 10.0 ** -rng.uniform(0.5, 1.5)) * np.outer(J @ u, u)
        out.append(J.T @ J)
    return np.stack(out)


def _close(a, b, rtol=RTOL, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    atol = 0.0 if scale is None else 1e-12 * scale
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _close_cols_up_to_sign(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign(np.sum(a * b, axis=-2, keepdims=True))
    np.testing.assert_allclose(a * s, b, rtol=rtol, atol=1e-15)


def test_symmetric_eigh_and_cholesky():
    H = _hessians()
    w_j, V_j = jax.vmap(jlin.symmetric_eigh)(jnp.asarray(H))
    w_t, V_t = tlin.symmetric_eigh(torch.as_tensor(H))
    _close(w_t, w_j, scale=np.abs(H).max())
    _close_cols_up_to_sign(V_t, V_j)
    g = np.random.default_rng(1).normal(size=(H.shape[0], 6))
    x_j, ok_j = jax.vmap(jlin.cholesky_solve_6x6)(jnp.asarray(H),
                                                   jnp.asarray(g))
    x_t, ok_t = tlin.cholesky_solve_6x6(torch.as_tensor(H),
                                        torch.as_tensor(g))
    _close(x_t, x_j)
    assert np.array_equal(np.asarray(ok_t), np.asarray(ok_j))
    # a non-PD matrix trips the ok flag on both sides
    bad = -np.eye(6)[None]
    _, ok_bad = tlin.cholesky_solve_6x6(torch.as_tensor(bad),
                                        torch.as_tensor(g[:1]))
    assert not bool(ok_bad[0])


def test_eigh3_inv3_condition():
    A = _hessians(seed=2)[:, :3, :3]
    w_j, V_j = jlin.eigh3_closed(jnp.asarray(A))
    w_t, V_t = tlin.eigh3_closed(torch.as_tensor(A))
    _close(w_t, w_j, rtol=1e-8, scale=np.abs(A).max())
    _close_cols_up_to_sign(V_t, V_j, rtol=1e-7)
    i_j, d_j = jlin.inv_3x3(jnp.asarray(A))
    i_t, d_t = tlin.inv_3x3(torch.as_tensor(A))
    _close(i_t, i_j)
    _close(d_t, d_j)
    _close(tlin.condition_number(w_t), jlin.condition_number(w_j), rtol=1e-8)
    sv_j, U_j = jlin.psd_svd_from_eigh(w_j, V_j)
    sv_t, U_t = tlin.psd_svd_from_eigh(w_t, V_t)
    _close(sv_t, sv_j, rtol=1e-8, scale=np.abs(A).max())


def test_se3_functions():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(20, 3)) * 0.5
    w[0] = 0.0
    w[1] = [1e-7, 0.0, 0.0]
    R_j = jse3.exp_so3(jnp.asarray(w))
    R_t = tse3.exp_so3(torch.as_tensor(w))
    _close(R_t, R_j, rtol=1e-12 + RTOL)
    _close(tse3.log_so3(R_t), jse3.log_so3(R_j), rtol=1e-8)
    t = rng.normal(size=(20, 3))
    d = rng.normal(size=(20, 6)) * 0.1
    Rb_j, tb_j = jse3.boxplus(R_j, jnp.asarray(t), jnp.asarray(d))
    Rb_t, tb_t = tse3.boxplus(R_t, torch.as_tensor(t), torch.as_tensor(d))
    _close(Rb_t, Rb_j)
    _close(tb_t, tb_j)
    T_j = jse3.se3_matrix(Rb_j, tb_j)
    T_t = tse3.se3_matrix(Rb_t, tb_t)
    _close(T_t, T_j)
    noisy = R_j + 1e-4 * jnp.asarray(rng.normal(size=(20, 3, 3)))
    _close(tse3.orthonormalize(torch.as_tensor(np.asarray(noisy))),
           jse3.orthonormalize(noisy))
    rpy = rng.uniform(-1, 1, (3, 20))
    _close(tse3.euler_zyx_to_rot(*map(torch.as_tensor, rpy)),
           jse3.euler_zyx_to_rot(*map(jnp.asarray, rpy)))
    te_j, re_j = jse3.pose_error(T_j[:1], T_j)
    te_t, re_t = tse3.pose_error(T_t[:1], T_t)
    _close(te_t, te_j, rtol=1e-8)
    _close(re_t, re_j, rtol=1e-6)


DETECTIONS = [jdeg.DetectionMethod.NONE,
              jdeg.DetectionMethod.FULL_EVD_MIN_EIGENVALUE,
              jdeg.DetectionMethod.EVD_SUB_CONDITION,
              jdeg.DetectionMethod.FULL_SVD_CONDITION,
              jdeg.DetectionMethod.SCHUR_CONDITION_NUMBER]


def _analyses(H, det_name, fast=False):
    th = jdeg.DegeneracyThresholds()
    jdet = jdeg.DetectionMethod[det_name]
    tdet = tdeg.DetectionMethod[det_name]
    a_j = jax.vmap(lambda h: jdeg.analyze(h, jdet, th, fast=fast))(
        jnp.asarray(H))
    a_t = tdeg.analyze(torch.as_tensor(H), tdet,
                       tdeg.DegeneracyThresholds(**th._asdict()), fast=fast)
    return a_j, a_t


def _check_analysis(a_j, a_t):
    for name in a_j._fields:
        x_j, x_t = np.asarray(getattr(a_j, name)), \
            np.asarray(getattr(a_t, name))
        if x_j.dtype == bool:
            assert np.array_equal(x_j, x_t), name
        elif name in ("eigenvectors_full", "V_schur_rot", "V_schur_trans"):
            if np.isnan(x_j).all():
                assert np.isnan(x_t).all(), name
            else:
                _close_cols_up_to_sign(x_t, x_j)
        else:
            fin = np.isfinite(x_j)
            assert np.array_equal(fin, np.isfinite(x_t)), name
            _close(x_t[fin], x_j[fin])


@pytest.mark.parametrize("det", [d.name for d in DETECTIONS])
def test_analyze_matches(det):
    H = _hessians(seed=4)
    a_j, a_t = _analyses(H, det)
    _check_analysis(a_j, a_t)


def test_analyze_fast_matches_full_path():
    H = _hessians(seed=5)
    a_j, a_t = _analyses(H, "SCHUR_CONDITION_NUMBER", fast=True)
    _check_analysis(a_j, a_t)
    _, full = _analyses(H, "SCHUR_CONDITION_NUMBER")
    assert torch.equal(a_t.degenerate_mask, full.degenerate_mask)
    assert torch.equal(a_t.is_degenerate, full.is_degenerate)
    np.testing.assert_allclose(a_t.cond_schur_rot, full.cond_schur_rot,
                               rtol=1e-6)
    np.testing.assert_allclose(a_t.lambda_schur_trans,
                               full.lambda_schur_trans, rtol=1e-6,
                               atol=1e-9 * np.abs(H).max())


HANDLINGS = [h.name for h in tdeg.HandlingMethod]


@pytest.mark.parametrize("hand", HANDLINGS)
@pytest.mark.parametrize("det", ["FULL_EVD_MIN_EIGENVALUE",
                                 "SCHUR_CONDITION_NUMBER"])
def test_solve_matches(det, hand):
    H = _hessians(seed=6)
    g = np.random.default_rng(7).normal(size=(H.shape[0], 6)) * 10.0
    a_j, a_t = _analyses(H, det)
    th = jdeg.DegeneracyThresholds()
    x_j, i_j = jax.vmap(lambda h, gg, a: jsol.solve(
        h, gg, jdeg.HandlingMethod[hand], a, th, telemetry=True))(
        jnp.asarray(H), jnp.asarray(g), a_j)
    x_t, i_t = tsol.solve(torch.as_tensor(H), torch.as_tensor(g),
                          tdeg.HandlingMethod[hand], a_t,
                          tdeg.DegeneracyThresholds(), telemetry=True)
    _close(x_t, x_j)
    assert np.array_equal(np.asarray(i_t.pcg_iterations),
                          np.asarray(i_j.pcg_iterations))
    # the final PCG residual sits below the stopping tolerance tol*|g|,
    # where it is rounding noise of the recursion: compare it absolutely
    # at that tolerance
    np.testing.assert_allclose(np.asarray(i_t.pcg_residual),
                               np.asarray(i_j.pcg_residual),
                               atol=1e-6 * np.abs(g).max() * 6)
    for name in ("P_preconditioner", "W_adaptive", "cond_PH"):
        x1, x2 = np.asarray(getattr(i_t, name)), \
            np.asarray(getattr(i_j, name))
        fin = np.isfinite(x2)
        assert np.array_equal(fin, np.isfinite(x1)), name
        _close(x1[fin], x2[fin])


def test_solve_fast_and_helpers():
    H = _hessians(seed=8)
    g = np.random.default_rng(9).normal(size=(H.shape[0], 6))
    a_j, a_t = _analyses(H, "SCHUR_CONDITION_NUMBER", fast=True)
    th = jdeg.DegeneracyThresholds()
    x_j, i_j = jax.vmap(lambda h, gg, a: jsol.solve(
        h, gg, jdeg.HandlingMethod.PRECONDITIONED_CG, a, th,
        telemetry=False, fast=True))(jnp.asarray(H), jnp.asarray(g), a_j)
    x_t, i_t = tsol.solve(torch.as_tensor(H), torch.as_tensor(g),
                          tdeg.HandlingMethod.PRECONDITIONED_CG, a_t,
                          tdeg.DegeneracyThresholds(), telemetry=False,
                          fast=True)
    _close(x_t, x_j)
    assert np.array_equal(np.asarray(i_t.pcg_iterations),
                          np.asarray(i_j.pcg_iterations))
    S_j = jax.vmap(lambda a: jsol._schur_sqrt_precond(a, 10.0))(a_j)
    _close(tsol._schur_sqrt_precond(a_t, 10.0), S_j)
    al_j = jax.vmap(jdeg.align_to_axes)(a_j.V_schur_rot, a_j.lambda_schur_rot)
    al_t = tdeg.align_to_axes(a_t.V_schur_rot, a_t.lambda_schur_rot)
    assert np.array_equal(np.asarray(al_t.order), np.asarray(al_j.order))
    for name in ("lambdas", "angles_deg", "percents", "V_aligned"):
        _close(getattr(al_t, name), getattr(al_j, name), rtol=1e-7,
               scale=1e3)
