"""Port parity: ``degeneracy.preconditioner_axis_aligned_view`` (the
recorded "Ours" P block's coordinate convention) and
``linalg.solve_lstsq_normal`` against dcreg_tpu on the CPU in f64.

Stated tolerances: the axis-aligned P within rtol 1e-9 (atol 1e-12 of
its largest entry) for fast and full Schur analyses, batched and single;
the normal-equation solves within rtol 1e-9 of JAX (x and det) and 1e-8
of numpy's least squares.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.ops import degeneracy as jdeg
from dcreg_tpu.ops import linalg as jlin
from dcreg_tpu_torch.ops import degeneracy as tdeg
from dcreg_tpu_torch.ops import linalg as tlin
from test_torch_linalg import _analyses, _close, _hessians


@pytest.mark.parametrize("kappa", [10.0, 3.0])
@pytest.mark.parametrize("fast", [False, True])
def test_preconditioner_axis_aligned_view_matches(fast, kappa):
    H = _hessians(seed=11)
    a_j, a_t = _analyses(H, "SCHUR_CONDITION_NUMBER", fast=fast)
    P_j = jax.vmap(lambda a: jdeg.preconditioner_axis_aligned_view(
        a, kappa))(a_j)
    P_t = tdeg.preconditioner_axis_aligned_view(a_t, kappa)
    assert P_t.shape == (H.shape[0], 6, 6)
    _close(P_t, P_j, scale=float(np.abs(np.asarray(P_j)).max()))
    # the view only permutes each block: same spectrum as the world frame
    P_w = tdeg.targeted_preconditioner(a_t, kappa)
    for blk in (slice(0, 3), slice(3, 6)):
        np.testing.assert_allclose(
            torch.linalg.eigvalsh(P_t[:, blk, blk]),
            torch.linalg.eigvalsh(P_w[:, blk, blk]), rtol=1e-9, atol=1e-15)
    assert torch.all(P_t[:, :3, 3:] == 0) and torch.all(P_t[:, 3:, :3] == 0)


def test_preconditioner_axis_aligned_view_single():
    """One unbatched analysis, as the writers call it."""
    H = _hessians(seed=12, n=2)[1]
    th = jdeg.DegeneracyThresholds()
    a_j = jdeg.analyze(jnp.asarray(H),
                       jdeg.DetectionMethod.SCHUR_CONDITION_NUMBER, th)
    a_t = tdeg.analyze(torch.as_tensor(H),
                       tdeg.DetectionMethod.SCHUR_CONDITION_NUMBER,
                       tdeg.DegeneracyThresholds(**th._asdict()))
    _close(tdeg.preconditioner_axis_aligned_view(a_t, 10.0),
           jdeg.preconditioner_axis_aligned_view(a_j, 10.0),
           scale=float(np.abs(H).max()))


@pytest.mark.parametrize("reg", [0.0, 1e-3])
def test_solve_lstsq_normal_matches(reg):
    rng = np.random.default_rng(13)
    A = rng.normal(size=(64, 5, 3))
    b = rng.normal(size=(64, 5))
    x_j, det_j = jlin.solve_lstsq_normal(jnp.asarray(A), jnp.asarray(b),
                                         reg=reg)
    x_t, det_t = tlin.solve_lstsq_normal(torch.as_tensor(A),
                                         torch.as_tensor(b), reg=reg)
    _close(x_t, x_j)
    _close(det_t, det_j)
    if not reg:
        x_np = np.stack([np.linalg.lstsq(a, bb, rcond=None)[0]
                         for a, bb in zip(A, b)])
        np.testing.assert_allclose(x_t.numpy(), x_np, rtol=1e-8,
                                   atol=1e-12)
    x1, d1 = tlin.solve_lstsq_normal(torch.as_tensor(A[0]),
                                     torch.as_tensor(b[0]), reg=reg)
    _close(x1, np.asarray(x_j)[0])
    _close(d1, np.asarray(det_j)[0])
