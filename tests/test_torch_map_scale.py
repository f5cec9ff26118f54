"""Port parity: ``icp_batch_so3`` in MapIndex mode (per-iteration
two-level cull, slotted K1 ids, lane mask) and in MapIndex mode with a
reused pair list at B = 1, against dcreg_tpu on the same small map; and
``convert`` of JAX-built indexes and parameters.

Stated tolerances: converged, aborted, iterations and pair_overflow are
identical; R and t within 2e-4 (the batched-engine bar of
tests/test_icp_batch.py); the capacity estimators return identical
numbers; converted indexes equal the port-built ones exactly.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.models.icp import ICPParams
from dcreg_tpu.models.icp_batch import estimate_map_capacities, icp_batch_so3
from dcreg_tpu.ops.block_sparse import (build_block_index, build_map_index,
                                        kd_block_order)
from dcreg_tpu.ops.degeneracy import DetectionMethod, HandlingMethod
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models import icp_batch as tib
from dcreg_tpu_torch.ops import block_sparse as tbs
from dcreg_tpu_torch.ops import degeneracy as tdeg


def _terrain(m, extent, seed):
    rng = np.random.default_rng(seed)
    g = int(m * 0.7)
    xy = rng.uniform(-extent, extent, (g, 2))
    z = 0.4 * np.sin(0.25 * xy[:, 0]) * np.cos(0.2 * xy[:, 1]) \
        + rng.normal(0, 0.01, g)
    w = m - g
    wall = np.column_stack([rng.uniform(-extent, extent, w),
                            np.where(rng.random(w) < 0.5, -0.6, 0.6) * extent
                            + rng.normal(0, 0.02, w),
                            rng.uniform(0, 4, w)])
    return np.vstack([np.column_stack([xy, z]), wall]).astype(np.float32)


def _euler(r, p, y):
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), \
        np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


@pytest.fixture(scope="module")
def world():
    w = _terrain(40_000, 25.0, 5)
    return w[kd_block_order(w, 128)]


def _scan(world, center, n, seed):
    rng = np.random.default_rng(seed)
    near = world[np.linalg.norm(world - center, axis=1) < 10.0]
    scan = (near[rng.choice(near.shape[0], n, replace=False)] - center
            + rng.normal(0, 0.003, (n, 3))).astype(np.float32)
    return scan[kd_block_order(scan, 128)]


def _compare(rj, rt):
    for f in ("converged", "aborted", "iterations"):
        assert np.array_equal(np.asarray(getattr(rj, f)),
                              getattr(rt, f).numpy()), f
    assert int(rj.pair_overflow) == int(rt.pair_overflow) == 0
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-4)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=2e-4)


def _det_hand():
    return ((DetectionMethod.SCHUR_CONDITION_NUMBER,
             HandlingMethod.PRECONDITIONED_CG),
            (tdeg.DetectionMethod.SCHUR_CONDITION_NUMBER,
             tdeg.HandlingMethod.PRECONDITIONED_CG))


def test_map_mode_matches(world):
    center = np.array([6.0, -4.0, 0.5])
    scan = _scan(world, center, 800, 1)
    mj = build_map_index(world, tb=128, sb=16)
    mt = tbs.build_map_index(world, tb=128, sb=16, device="cpu")
    rng = np.random.default_rng(9)
    B = 2
    Rs = np.stack([_euler(*rng.uniform(-0.02, 0.02, 3))
                   for _ in range(B)]).astype(np.float32)
    ts = (center[None] + rng.uniform(-0.2, 0.2, (B, 3))).astype(np.float32)
    poses = [(Rs[b], ts[b]) for b in range(B)]
    params = ICPParams(max_iterations=15)
    S, G, P = estimate_map_capacities(mj, scan, poses, 1.0)
    assert tib.estimate_map_capacities(mt, scan, poses, 1.0) == (S, G, P)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, 3] = center
    (jd, jh), (td, th) = _det_hand()
    rj = icp_batch_so3(jnp.asarray(scan), jnp.asarray(world),
                       jnp.asarray(Rs), jnp.asarray(ts), jd, jh, params, mj,
                       P, T_gt=jnp.asarray(T_gt), num_supers=S,
                       max_per_query=G)
    rt = tib.icp_batch_so3(scan, world, Rs, ts, td, th,
                           convert.icp_params(params._asdict()), mt, P,
                           T_gt=T_gt, num_supers=S, max_per_query=G,
                           device="cpu")
    _compare(rj, rt)
    assert bool(rt.converged.all())
    ex = np.asarray(rj.log.executed)
    assert np.array_equal(rt.log.executed.numpy(), ex)
    for f in ("pcg_iterations", "degenerate_mask", "effective_points"):
        assert np.array_equal(getattr(rt.log, f).numpy(),
                              np.asarray(getattr(rj.log, f))), f
    np.testing.assert_allclose(rt.log.trans_error.numpy()[ex],
                               np.asarray(rj.log.trans_error)[ex], atol=2e-4)
    for f, tol in (("rmse", 1e-5), ("fitness", 1e-6)):
        np.testing.assert_allclose(getattr(rt.log, f).numpy()[ex],
                                   np.asarray(getattr(rj.log, f))[ex],
                                   atol=tol)
    np.testing.assert_allclose(rt.log.lambda_schur_trans.numpy()[ex],
                               np.asarray(rj.log.lambda_schur_trans)[ex],
                               rtol=2e-2)


def test_reuse_pair_list_matches(world):
    center = np.array([-7.0, 5.0, 0.5])
    scan = _scan(world, center, 900, 2)
    mj = build_map_index(world, tb=128, sb=16)
    mt = tbs.build_map_index(world, tb=128, sb=16, device="cpu")
    R0 = np.eye(3, dtype=np.float32)[None]
    t0 = (center[None] + [0.05, -0.04, 0.02]).astype(np.float32)
    r0, margin = 0.35, 0.4
    S, G, P = estimate_map_capacities(mj, scan, [(R0[0], t0[0])],
                                      r0 + margin)
    params = ICPParams(max_iterations=20, full_telemetry=False)
    (jd, jh), (td, th) = _det_hand()
    rj = icp_batch_so3(jnp.asarray(scan), jnp.asarray(world),
                       jnp.asarray(R0), jnp.asarray(t0), jd, jh, params, mj,
                       P, num_supers=S, max_per_query=G,
                       initial_cull_radius=r0, reuse_pair_list=margin)
    rt = tib.icp_batch_so3(scan, world, R0, t0, td, th,
                           convert.icp_params(params._asdict()), mt, P,
                           num_supers=S, max_per_query=G,
                           initial_cull_radius=r0, reuse_pair_list=margin,
                           device="cpu")
    _compare(rj, rt)
    assert bool(rt.converged.all())
    np.testing.assert_allclose(rt.rmse.numpy(), np.asarray(rj.rmse),
                               rtol=1e-3)
    assert np.array_equal(rt.num_valid.numpy(), np.asarray(rj.num_valid))


def _fields(dc):
    return {f.name: (np.asarray(getattr(dc, f.name))
                     if not isinstance(getattr(dc, f.name), int)
                     else getattr(dc, f.name))
            for f in dataclasses.fields(dc)}


def test_convert_indexes_and_params(world):
    pts = world[:5000]
    bj = build_block_index(pts, tb=128)
    bt = convert.block_index_from_arrays(_fields(bj), device="cpu")
    own = tbs.build_block_index(pts, tb=128, device="cpu")
    for f in ("blocks", "valid", "lo", "hi"):
        assert torch.equal(getattr(bt, f), getattr(own, f)), f
    assert (bt.num_blocks, bt.num_points, bt.tb) == \
        (own.num_blocks, own.num_points, own.tb)
    mj = build_map_index(pts, tb=128, sb=8)
    d = _fields(mj)
    d["block"] = _fields(mj.block)
    mt = convert.map_index_from_arrays(d, device="cpu")
    own_m = tbs.build_map_index(pts, tb=128, sb=8, device="cpu")
    for f in ("sup_lo", "sup_hi", "blk_lo_g", "blk_hi_g"):
        assert torch.equal(getattr(mt, f), getattr(own_m, f)), f
    assert torch.equal(mt.block.blocks, own_m.block.blocks)
    assert (mt.sb, mt.num_supers) == (own_m.sb, own_m.num_supers)
    p = ICPParams(max_iterations=7)
    q = convert.icp_params(p._asdict())
    assert q.max_iterations == 7
    assert tuple(q.corr) == tuple(p.corr)
    assert tuple(q.thresholds) == tuple(p.thresholds)
