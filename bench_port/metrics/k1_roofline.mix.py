"""K1's share of its roofline in the mixed fleet's ticks, in its per-lane
mode (``ops.block_knn``, ``csrc/block_knn.cu``): the least time the card
could take for one K1 launch's work, over K1's device time per launch in
the trace.  Moves ``frame_ms``.

The work is reckoned from the inputs as ``k1_roofline.fleet.py`` reckons
it, over each lane's valid points only (its first ``count`` rows): 10
float32 operations per (scan point, map point) pair within the initial
cull radius at the lane's ground-truth pose; each lane's points and the
map points they touch read once, and 5 keys of 8 bytes written per
point.  Work that K1 spends on pad rows is no part of it, so it lowers
the share.  The driver leaves the tick's scans and counts in the scene
(``scene["mixed"]``); without them the reader finds nothing.
"""
import importlib.util
import os

import torch

_spec = importlib.util.spec_from_file_location(
    "k1_roofline_fleet", os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "k1_roofline.fleet.py"))
fleet = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fleet)


def read(ctx):
    tr, scene, cfg = ctx["trace"], ctx["scene"], ctx["cfg"]
    launches = tr.device_count("block_knn_keys_kernel")
    if not launches or "mixed" not in scene:
        return None
    per_launch = tr.device_seconds("block_knn_") / launches
    world, gt = scene["world"], scene["gt"]
    scans, counts = scene["mixed"]["scans"], scene["mixed"]["counts"]
    peaks = next(v for k, v in ctx["peaks"].items()
                 if k in torch.cuda.get_device_name(0))
    least = []
    for tick in fleet.traced_frames(cfg, ctx["traffic"], scans.shape[1]):
        pts = []
        for lane, f in enumerate(tick):
            T = torch.as_tensor(gt[f], dtype=torch.float32,
                                device=world.device)
            body = scans[lane, f, :int(counts[lane, f])]
            pts.append(body @ T[:3, :3].T + T[:3, 3])
        least.append(fleet.tick_least_seconds(
            pts, world, cfg["stream"]["initial_cull_radius"], peaks))
    return 100.0 * (sum(least) / len(least)) / per_launch
