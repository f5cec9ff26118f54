"""Port parity: the map-scale localization loop ``run_odometry_map``
(constant-velocity seed + B = 1 map-mode DCReg with a reused pair list per
frame) against dcreg_tpu on a 6-frame sequence and a 60k-point map.

Stated tolerances: per-frame iterations, convergence and pair_overflow
identical; poses within 1e-3 m (translation) and 1e-4 (rotation entries);
the capacity estimates identical.
"""
import numpy as np
import jax.numpy as jnp
from torch_threads import one_intra_op_thread  # noqa: F401

from dcreg_tpu.models.icp import ICPParams
from dcreg_tpu.models.odometry import (estimate_odometry_capacities,
                                       prepare_frames, run_odometry_map)
from dcreg_tpu.ops.block_sparse import build_map_index, kd_block_order
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.ops import block_sparse as tbs


def _world(m=60_000, extent=30.0, seed=7):
    """Undulating ground + wall strips, lifted clear of the origin."""
    rng = np.random.default_rng(seed)
    g = int(m * 0.7)
    xy = rng.uniform(-extent, extent, (g, 2))
    z = 0.5 * np.sin(0.12 * xy[:, 0]) * np.cos(0.1 * xy[:, 1]) \
        + rng.normal(0, 0.01, g)
    w = m - g
    wall = np.column_stack([rng.uniform(-extent, extent, w),
                            np.round(rng.uniform(-3, 3, w)) * extent / 3.0
                            + rng.normal(0, 0.02, w),
                            rng.uniform(0, 5, w)])
    world = np.vstack([np.column_stack([xy, z]), wall]) + [0.0, 0.0, 9.0]
    return world.astype(np.float32)


def _trajectory(F):
    gt, pos = [], np.array([4.0, -4.5, 9.8])
    for i in range(-2, F):
        yaw = 0.3 + 0.35 * np.sin(0.05 * i)
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1.0]]
        T[:3, 3] = pos
        gt.append(T)
        pos = pos + [0.25 * c, 0.25 * s, 0.0]
    return gt[0], gt[1], np.asarray(gt[2:])


def test_run_odometry_map_matches():
    world = _world()
    world = world[kd_block_order(world, 128)]
    T_pre2, T_pre1, gt = _trajectory(6)
    rng = np.random.default_rng(11)
    frames = []
    for T in gt:
        near = world[np.sum((world - T[:3, 3]) ** 2, axis=1) < 8.0 ** 2]
        sel = near[rng.choice(near.shape[0], 1000, replace=False)]
        frames.append((sel - T[:3, 3]) @ T[:3, :3]
                      + rng.normal(0, 0.003, (1000, 3)))
    frames_s = prepare_frames(np.asarray(frames, np.float32))
    assert np.array_equal(todo.prepare_frames(np.asarray(frames, np.float32)),
                          frames_s)
    r0, margin = 0.25, 0.2
    mj = build_map_index(world, tb=128, sb=16)
    mt = tbs.build_map_index(world, tb=128, sb=16, device="cpu")
    S, G, P = estimate_odometry_capacities(mj, frames_s, gt, r0 + margin,
                                           slot_margin=1.6, sup_margin=4)
    assert todo.estimate_odometry_capacities(
        mt, frames_s, gt, r0 + margin, slot_margin=1.6,
        sup_margin=4) == (S, G, P)
    params = ICPParams(full_telemetry=False)
    common = dict(num_supers=S, max_per_query=G, num_pairs=P,
                  initial_cull_radius=r0, reuse_margin=margin)
    rj = run_odometry_map(jnp.asarray(frames_s), mj, jnp.asarray(world),
                          T0=jnp.asarray(T_pre1, jnp.float32),
                          T_prev_init=jnp.asarray(T_pre2, jnp.float32),
                          icp_params=params, **common)
    rt = todo.run_odometry_map(frames_s, mt, world, T0=T_pre1,
                               T_prev_init=T_pre2,
                               icp_params=convert.icp_params(
                                   params._asdict()),
                               device="cpu", **common)
    assert np.array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert np.array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert np.array_equal(rt.pair_overflow.numpy(),
                          np.asarray(rj.pair_overflow))
    assert bool(rt.converged.all()) and int(rt.pair_overflow.max()) == 0
    pj, pt = np.asarray(rj.poses), rt.poses.numpy()
    np.testing.assert_allclose(pt[:, :3, 3], pj[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(pt[:, :3, :3], pj[:, :3, :3], atol=1e-4)
    assert np.linalg.norm(pt[:, :3, 3] - gt[:, :3, 3], axis=1).max() < 0.05
    assert np.array_equal(rt.is_degenerate.numpy(),
                          np.asarray(rj.is_degenerate))
    np.testing.assert_allclose(rt.cond_schur_trans.numpy(),
                               np.asarray(rj.cond_schur_trans), rtol=1e-2)
