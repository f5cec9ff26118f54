"""Port parity: ``bench.py``'s map-scale FCN-SR row (``chip_smoke.py``
phase 10b) through both packages' ``run_odometry_map``, on phase 2's
scene at the size the script takes for a CPU rehearsal.

The scene is ``chip_smoke.py``'s own: its world at 5.4M points (extent
60 m, the ground density of the card's 53M-point map), trajectory and
scans from seed 7, the map cut to the tube the first 10 frames' scans
are drawn from (9 m around their bounding box; no search of the loop
reaches further), capacities as phase 2 estimates them and
``bench.py``'s parameters (default ICPParams, r0 0.18 m, reuse margin
0.12 m).  FCN-SR's full-6x6 condition detector remaps real directions
away on this scene, so the registration drifts and the reuse guard
fires: a breach counts one in ``pair_overflow``.

Stated tolerances: ``pair_overflow`` equal on every frame, and nonzero
on frame 9 in both packages; ``iterations``, ``converged`` and
``is_degenerate`` equal on frames 0-7 (at frame 8 the two float32 loops
stop one iteration apart); translations within 1e-3 m on every frame.
Found: 1.0e-4 m at most.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

import chip_smoke as cs
from dcreg_tpu.models.icp import ICPParams
from dcreg_tpu.models.odometry import run_odometry_map
from dcreg_tpu.ops.block_sparse import build_map_index
from dcreg_tpu.ops.degeneracy import DetectionMethod, HandlingMethod
from dcreg_tpu_torch.models import icp as ticp
from dcreg_tpu_torch.models import odometry as todo
from dcreg_tpu_torch.ops import block_sparse as tbs

MAP_POINTS, EXTENT, SEED, FRAMES = 5_400_000, 60.0, 7, 10
SAME_STEPS = 8          # frames whose iteration counts agree


@pytest.fixture(scope="module")
def scene():
    world = cs.synthetic_map(MAP_POINTS, EXTENT, SEED) \
        + np.array([0.0, 0.0, 9.0], np.float32)
    world = world[tbs.kd_block_order(world, 128)]
    T_pre2, T_pre1, gt = cs.trajectory(EXTENT, cs.FRAMES)
    gt = gt[:FRAMES]
    frames, tube = cs.scans(world, gt, cs.SCAN_POINTS,
                            np.random.default_rng(SEED + 4))
    frames_s = todo.prepare_frames(frames)
    mindex = tbs.build_map_index(tube, tb=128, sb=64, device="cpu")
    caps = todo.estimate_odometry_capacities(
        mindex, frames_s, gt, cs.R_CULL0 + cs.REUSE_MARGIN, margin=1.25,
        slot_margin=1.6, sup_margin=4)
    return dict(T_pre2=T_pre2, T_pre1=T_pre1, gt=gt, tube=tube,
                frames_s=frames_s, mindex=mindex, caps=caps)


def test_fcn_sr_breaches_the_reuse_guard_where_jax_does(scene):
    name, det, hand = cs.MAP_BASELINES[2]
    assert name == "FCN-SR"
    S, G, P = scene["caps"]
    common = dict(num_supers=S, max_per_query=G, num_pairs=P,
                  initial_cull_radius=cs.R_CULL0,
                  reuse_margin=cs.REUSE_MARGIN)
    rt = todo.run_odometry_map(
        scene["frames_s"], scene["mindex"], torch.as_tensor(scene["tube"]),
        T0=scene["T_pre1"], T_prev_init=scene["T_pre2"], detection=det,
        handling=hand, icp_params=ticp.ICPParams(), device="cpu", **common)
    rj = run_odometry_map(
        jnp.asarray(scene["frames_s"]),
        build_map_index(scene["tube"], tb=128, sb=64),
        jnp.asarray(scene["tube"]),
        T0=jnp.asarray(scene["T_pre1"], jnp.float32),
        T_prev_init=jnp.asarray(scene["T_pre2"], jnp.float32),
        detection=DetectionMethod[det], handling=HandlingMethod[hand],
        icp_params=ICPParams()._replace(full_telemetry=False), **common)
    ovf = rt.pair_overflow.numpy()
    assert np.array_equal(ovf, np.asarray(rj.pair_overflow))
    assert ovf[FRAMES - 1] > 0
    same = slice(0, SAME_STEPS)
    for f in ("iterations", "converged", "is_degenerate"):
        assert np.array_equal(getattr(rt, f).numpy()[same],
                              np.asarray(getattr(rj, f))[same]), f
    np.testing.assert_allclose(rt.poses.numpy()[:, :3, 3],
                               np.asarray(rj.poses)[:, :3, 3], rtol=0,
                               atol=1e-3)
