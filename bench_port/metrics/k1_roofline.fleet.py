"""K1's share of its roofline in the fleet's ticks, in its per-lane mode
(``ops.block_knn``, ``csrc/block_knn.cu``): the least time the card could
take for one K1 launch's work, over K1's device time per launch in the
trace.  Moves ``frame_ms``.

The work is reckoned from the inputs as ``k1_roofline.batch.py`` reckons
it, lane by lane, so it reads the same whatever implements the search:

  * operations: 10 float32 operations per (scan point, map point) pair
    within the configuration's initial cull radius, at each lane's
    ground-truth pose;
  * bytes: each lane's scan and the map points it touches read once
    (12 bytes a point), and 5 keys of 8 bytes written per query.

A launch answers every lane of its tick; the least time of a launch is
the larger of the tick's operations over the card's float32 peak and its
bytes over the memory rate (``peaks.json``), averaged over the traced
window's ticks (robot r at frame start_r + k of tick k, as
``drivers/fleet.py`` runs them).
"""
import importlib.util
import os

import torch

_spec = importlib.util.spec_from_file_location(
    "k1_roofline_batch", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "k1_roofline.batch.py"))
batch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(batch)


def traced_frames(cfg, traffic, frames: int) -> list:
    """Each traced tick's frames, one per robot."""
    starts = [min(cfg["robot_spacing_frames"] * r, frames - 1)
              for r in range(cfg["sensors"])]
    return [[s + k % (frames - s) for s in starts]
            for k in range(traffic["trace_ticks"])]


def tick_least_seconds(points, world, radius, peaks):
    """Least seconds of one launch over the lanes' world-frame scans
    ``points``."""
    ops = nbytes = 0
    for pts in points:
        pairs, touched = batch.pairs_within(pts, world, radius)
        ops += batch.OPS_PER_PAIR * pairs
        nbytes += batch.POINT_BYTES * (pts.shape[0] + touched) \
            + batch.K * batch.KEY_BYTES * pts.shape[0]
    return max(ops / peaks["f32_ops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])


def read(ctx):
    tr = ctx["trace"]
    launches = tr.device_count("block_knn_keys_kernel")
    if not launches:
        return None
    per_launch = tr.device_seconds("block_knn_") / launches
    scene, cfg = ctx["scene"], ctx["cfg"]
    world, scans = scene["world"], scene["frames"]
    peaks = next(v for k, v in ctx["peaks"].items()
                 if k in torch.cuda.get_device_name(0))
    least = []
    for tick in traced_frames(cfg, ctx["traffic"], scans.shape[0]):
        pts = []
        for f in tick:
            T = torch.as_tensor(scene["gt"][f], dtype=torch.float32,
                                device=world.device)
            pts.append(scans[f] @ T[:3, :3].T + T[:3, 3])
        least.append(tick_least_seconds(
            pts, world, cfg["stream"]["initial_cull_radius"], peaks))
    return 100.0 * (sum(least) / len(least)) / per_launch
