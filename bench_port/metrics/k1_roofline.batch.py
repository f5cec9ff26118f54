"""K1's share of its roofline in the Monte-Carlo batch (``ops.block_knn``,
``csrc/block_knn.cu``): the least time the card could take for one K1
launch's work, over K1's device time per launch in the trace.  Moves
``reg_per_s``.

The work is reckoned from the inputs, not from the implementation's pair
list, so it reads the same whatever implements the search:

  * operations: 10 float32 operations (3 sub, 3 mul, 2 add, a compare and
    a scale) per (scan point, map point) pair within the traffic's initial
    cull radius, at each lane's ground-truth pose;
  * bytes: the scan and those map points read once (12 bytes a point), and
    5 keys of 8 bytes written per query and lane.

The least time is the larger of operations over the card's float32 peak
and bytes over its memory rate (``peaks.json``).  A launch is one
``block_knn_keys_kernel``; its time adds the merge kernel's where the
wrapper split the work.
"""
import torch

K = 5
OPS_PER_PAIR = 10
KEY_BYTES = 8
POINT_BYTES = 12


def pairs_within(points, world, radius):
    """(pairs, touched): the (point, map point) pairs within ``radius``,
    and the map points within ``radius`` of any point; brute force over
    the map's points near ``points``."""
    lo, hi = points.amin(0) - radius, points.amax(0) + radius
    cand = world[((world >= lo) & (world <= hi)).all(1)]
    r2 = radius * radius
    pairs = 0
    hit = torch.zeros(cand.shape[0], dtype=torch.bool, device=cand.device)
    chunk = max(1, (1 << 24) // max(1, cand.shape[0]))
    for s in range(0, points.shape[0], chunk):
        q = points[s:s + chunk]
        d = (q[:, None, 0] - cand[None, :, 0]) ** 2
        d += (q[:, None, 1] - cand[None, :, 1]) ** 2
        d += (q[:, None, 2] - cand[None, :, 2]) ** 2
        near = d <= r2
        pairs += int(near.sum())
        hit |= near.any(0)
    return pairs, int(hit.sum())


def least_seconds(n_points, lanes, pairs, touched, peaks):
    """(seconds, bound) of one launch's work at ``lanes`` lanes that each
    see ``pairs`` pairs."""
    ops = OPS_PER_PAIR * pairs * lanes
    nbytes = POINT_BYTES * (n_points + touched) + K * KEY_BYTES * n_points \
        * lanes
    t_ops = ops / peaks["f32_ops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def read(ctx):
    tr = ctx["trace"]
    launches = tr.device_count("block_knn_keys_kernel")
    if not launches:
        return None
    per_launch = tr.device_seconds("block_knn_") / launches
    traffic, scene = ctx["traffic"], ctx["scene"]
    T = torch.as_tensor(scene["gt"][traffic["frame"]], dtype=torch.float32,
                        device=scene["world"].device)
    scan = scene["frames"][traffic["frame"]]
    pts = scan @ T[:3, :3].T + T[:3, 3]
    pairs, touched = pairs_within(pts, scene["world"],
                                  ctx["cfg"]["batch"]["initial_cull_radius"])
    peaks = next(v for k, v in ctx["peaks"].items()
                 if k in torch.cuda.get_device_name(0))
    least, _ = least_seconds(scan.shape[0], traffic["batch"], pairs,
                             touched, peaks)
    return 100.0 * least / per_launch
