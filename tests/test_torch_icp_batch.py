"""Port parity: the batched engine ``icp_batch_so3`` in BlockIndex mode,
the SoA tail and the ICP telemetry pieces against dcreg_tpu on the same
inputs (CPU, plain K1 on the port side, interpret-mode K1 on the JAX
side).

Stated tolerances: converged, aborted, iterations and pair_overflow are
identical; R and t agree within 2e-4 (the bar tests/test_icp_batch.py
sets for the batched engine against the single-lane one); executed
telemetry rows agree within f32 roundoff of the 6x6 spectra.  SoA tail:
H and g within 1e-4 of max|H| (the einsum summation order differs),
num_valid identical, rmse and fitness within rtol 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import torch
from torch_threads import one_intra_op_thread  # noqa: F401

from dcreg_tpu.models.icp import ICPParams, covariance_from_H
from dcreg_tpu.models.icp_batch import estimate_num_pairs, icp_batch_so3
from dcreg_tpu.ops import se3
from dcreg_tpu.ops.block_sparse import build_block_index, morton_argsort
from dcreg_tpu.ops.correspondence import CorrespondenceParams
from dcreg_tpu.ops.degeneracy import DetectionMethod, HandlingMethod
from dcreg_tpu.ops.soa_tail import batched_tail_system
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models import icp as ticp
from dcreg_tpu_torch.models import icp_batch as tib
from dcreg_tpu_torch.ops import block_sparse as tbs
from dcreg_tpu_torch.ops import degeneracy as tdeg
from dcreg_tpu_torch.ops import soa_tail as tsoa

RNG = np.random.default_rng(23)


def _scene(n=1200):
    a = RNG.uniform(-5, 5, (n // 2, 2))
    p1 = np.column_stack([a[:, 0], a[:, 1], 0.02 * RNG.normal(size=n // 2)])
    b = RNG.uniform(-5, 5, (n // 2, 2))
    p2 = np.column_stack([b[:, 0], 0.02 * RNG.normal(size=n // 2) + 3.0,
                          b[:, 1]])
    return np.concatenate([p1, p2])


def _poses(B, rng, rot=0.02, trans=0.3):
    rpy = rng.uniform(-rot, rot, (B, 3))
    R0s = np.stack([np.asarray(se3.euler_zyx_to_rot(*map(jnp.float32, r)))
                    for r in rpy]).astype(np.float32)
    return R0s, rng.uniform(-trans, trans, (B, 3)).astype(np.float32)


def _compare_results(rj, rt, atol=2e-4):
    for f in ("converged", "aborted", "iterations"):
        assert np.array_equal(np.asarray(getattr(rj, f)),
                              getattr(rt, f).numpy()), f
    assert int(rj.pair_overflow) == int(rt.pair_overflow)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=atol)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=atol)


def test_soa_tail_matches():
    pts = _scene()
    spts = pts[morton_argsort(pts)].astype(np.float32)
    rng = np.random.default_rng(1)
    B, N, k = 3, spts.shape[0], 5
    R0s, t0s = _poses(B, rng)
    # neighbour ids from a brute-force 5-NN at each lane's pose, with some
    # missing (-1) entries
    idx = np.empty((B, k, N), np.int32)
    d5 = np.empty((B, N), np.float32)
    for b in range(B):
        q = spts @ R0s[b].T + t0s[b]
        d = ((q[:, None] - spts[None]) ** 2).sum(-1)
        nn = np.argsort(d, axis=1)[:, :k]
        idx[b] = nn.T
        d5[b] = d[np.arange(N), nn[:, -1]]
    # a point with a missing neighbour carries d5 = BIG, as K1's decode
    # gives it
    idx[:, 3:, ::97] = -1
    d5[:, ::97] = 3.0e38
    cp = CorrespondenceParams()
    sj = batched_tail_system(jnp.asarray(spts), jnp.asarray(spts),
                             jnp.asarray(R0s), jnp.asarray(t0s),
                             jnp.asarray(d5), jnp.asarray(idx), cp)
    st = tsoa.batched_tail_system(
        torch.as_tensor(spts), torch.as_tensor(spts), torch.as_tensor(R0s),
        torch.as_tensor(t0s), torch.as_tensor(d5), torch.as_tensor(idx),
        convert.correspondence_params(cp._asdict()))
    scale = np.abs(np.asarray(sj.H)).max()
    np.testing.assert_allclose(st.H.numpy(), np.asarray(sj.H),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(st.g.numpy(), np.asarray(sj.g),
                               atol=1e-4 * scale)
    assert np.array_equal(st.num_valid.numpy(), np.asarray(sj.num_valid))
    assert st.num_valid.min() > 100
    for f in ("rmse", "fitness", "objective"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)), rtol=1e-5)


def test_empty_log_hist_and_covariance():
    I = 4
    log = ticp._empty_log(I, torch.float32, lead=(2,))
    assert log.transform.shape == (2, I, 4, 4)
    assert bool(torch.all(log.pcg_iterations == -1))
    assert bool(torch.isnan(log.H).all()) and not bool(log.executed.any())
    h = ticp.empty_hist(I, torch.float32, lead=(2,))
    assert h.R.shape == (2, I, 3, 3) and bool(torch.isnan(h.rmse).all())
    rng = np.random.default_rng(2)
    J = rng.normal(size=(3, 40, 6))
    H = np.einsum("bni,bnj->bij", J, J)
    H[2] = 0.0                                    # not invertible
    conv = np.array([True, False, True])
    cj = np.stack([np.asarray(covariance_from_H(jnp.asarray(H[b]),
                                                jnp.asarray(conv[b]),
                                                jnp.float64))
                   for b in range(3)])
    ct = ticp.covariance_from_H(torch.as_tensor(H), torch.as_tensor(conv),
                                torch.float64)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-9)


def test_block_index_mode_matches():
    pts = _scene()
    spts = pts[morton_argsort(pts)].astype(np.float32)
    index = build_block_index(spts, dtype=jnp.float32, tb=128)
    B = 3
    R0s, t0s = _poses(B, np.random.default_rng(3))
    params = ICPParams(max_iterations=12)
    P = estimate_num_pairs(index, spts, [(R0s[i], t0s[i]) for i in range(B)],
                           1.0)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, 3] = [0.01, -0.02, 0.0]
    rj = icp_batch_so3(jnp.asarray(spts), jnp.asarray(spts),
                       jnp.asarray(R0s), jnp.asarray(t0s),
                       DetectionMethod.SCHUR_CONDITION_NUMBER,
                       HandlingMethod.PRECONDITIONED_CG, params, index, P,
                       T_gt=jnp.asarray(T_gt))
    ti = tbs.build_block_index(spts, tb=128, device="cpu")
    assert tib.estimate_num_pairs(
        ti, spts, [(R0s[i], t0s[i]) for i in range(B)], 1.0) == P
    rt = tib.icp_batch_so3(spts, spts, R0s, t0s,
                           tdeg.DetectionMethod.SCHUR_CONDITION_NUMBER,
                           tdeg.HandlingMethod.PRECONDITIONED_CG,
                           convert.icp_params(params._asdict()), ti, P,
                           T_gt=T_gt, device="cpu")
    _compare_results(rj, rt)
    assert int(rt.pair_overflow) == 0 and bool(rt.converged.all())
    # executed telemetry rows
    ex = np.asarray(rj.log.executed)
    assert np.array_equal(rt.log.executed.numpy(), ex)
    assert np.array_equal(rt.log.pcg_iterations.numpy(),
                          np.asarray(rj.log.pcg_iterations))
    assert np.array_equal(rt.log.degenerate_mask.numpy(),
                          np.asarray(rj.log.degenerate_mask))
    # rot_error_deg is arccos((tr R - 1) / 2) in f32: near 0 its steps are
    # sqrt(2 eps32) rad = 0.028 deg, so two steps is the bar
    for f, tol in (("trans_error", 1e-4), ("rot_error_deg", 0.06),
                   ("rmse", 1e-5), ("fitness", 1e-6)):
        np.testing.assert_allclose(getattr(rt.log, f).numpy()[ex],
                                   np.asarray(getattr(rj.log, f))[ex],
                                   atol=tol)
    for f in ("lambda_schur_trans", "lambda_schur_rot", "eigenvalues_full",
              "cond_schur_rot", "cond_schur_trans"):
        np.testing.assert_allclose(getattr(rt.log, f).numpy()[ex],
                                   np.asarray(getattr(rj.log, f))[ex],
                                   rtol=2e-2)
    np.testing.assert_allclose(rt.covariance.numpy(),
                               np.asarray(rj.covariance), rtol=5e-2,
                               atol=1e-6)
