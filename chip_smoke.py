"""Drive the PyTorch/CUDA port (dcreg_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed 7]

Builds every kernel from csrc/ (one nvcc per source, in parallel,
sm_90a), then runs on the card:

  1. K1 against its plain PyTorch twin, keys bit for bit, at the main
     path's shapes: (a) map mode, B=1, slot-local ids, no mask;
     (b) map mode, B=128, slot-local ids, lane mask; (c) BlockIndex mode,
     B=128, global ids, lane mask; (a_live) the localization loop's own
     call: the reused pair list with its live mask; (e) B=33, two mask
     words; (f) B=1 with one query block's run max_per_query long; each
     row prints the split and CTA count the wrapper launched;
  2. the localization loop ``run_odometry_map``: 128 frames of 5,000
     points against a synthetic prior map (53M points by default,
     DCREG_SMOKE_MAP_POINTS overrides), gated on every frame converging,
     zero overflow, mean translation error < 5 cm and max < 10 cm;
  3. a B=128 Monte-Carlo batch in MapIndex mode with full telemetry,
     gated on convergence, zero overflow, mean errors < 5 cm / 0.5 deg;
  4. a B=128 BlockIndex-mode batch on a 16,384-point neighbourhood of
     frame 0, gated on convergence and zero overflow, and rerun with
     the plain K1 forced (per-lane iterations equal, poses within 1e-5);
  5. K2 and K3 against their plain twins, bit for bit, at (d) the 5-NN
     self query of the 8,192-point cylinder, (e) its nn1, (f) 65,536
     points with 30% of the targets invalid, where ``knn_grouped`` must
     also return what ``knn`` returns, (g) 333 queries against 1,000
     targets, 30% invalid, (h) the O3D engine's normal search (self
     query, k 30, kk 60) and (i) kk 128 (the moved cylinder against
     itself), and (j) (g)'s shapes at kk 128; each row prints the grids
     the wrappers launched;
  6. the pair harness on the 8,192-point synthetic cylinder (source ==
     target), f32, through the port's TestRunner, once with the CSR grid
     search and once with K2 as every iteration's search, for three
     method matrices (``pair_scenarios``): every row of
     configs/cylinder.yaml (the SO(3) family, XICP, SuperLoc); the rows
     only configs/parkinglot.yaml has (O3D, XICP-1, XICP-EQ, XICP-INQ,
     XICP-OP) with its parameters and the cylinder's poses; the SO(3)
     rows through the Euler engine.  Gated on every artifact written,
     finite rows and SuperLoc fields, Ours converging with TE < 5 cm and
     RE < 0.5 deg and flagging a degenerate direction at iteration 0,
     O3D launching K2 at kk 60, and the two backends agreeing per method
     (iterations within 1, poses within 1e-4 m and 1e-3 deg: the final
     poses of a method that converged on both, the poses after
     iteration 10 of any other); one Ours, XICP and O3D run each under
     the profiler;
  7. the ``kernels`` line: K1, K2 and K3 with their launches on each
     path (K2's including (8b)), times, bounds and library times;
  8. on phase 2's world, trajectory and scans: (8a) the voxel map index
     (``build_voxel_grid`` over the whole map on the card) and the voxel
     odometry loop ``run_odometry`` over the 128 frames from the pose
     before frame 0, f32, voxel edge = search radius, the voxel capacity
     from the largest occupancy around the trajectory; gated on every
     frame converging, mean translation error < 5 cm, max < 10 cm and
     every position within 3 cm of phase 2's; a profile window of 8
     frames; (8b) ``voxel_knn`` against K2 (``knn``) for frame 0 at its
     GT pose: for every query whose 5th distance is within the search
     radius the same neighbours (but for exact ties) at distances
     within 2 ulp; (8c) ``optimize_pose_graph`` on a 128-pose window of
     the ground truth (noisy odometry edges, one exact closure) in f32
     on the card, gated on the last pose's drift falling at least 2x, a
     final cost < 1 and poses within 1 mm of the same graph in f64 on
     the CPU; (8d) the ground truth and both loops' trajectories through
     TUM files and back (within 1e-6), gated on ATE RMSE < 3 cm and
     registration recall 1.

Every phase prints one JSON object on a line of its own; the last line is
{"ok": true, "device": {...}}.  A failed phase raises, and the script
exits non-zero.  Without a CUDA device it exits non-zero at once.  The
worlds, trajectory and scans are made from ``--seed`` in numpy.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MAP_POINTS = int(os.environ.get("DCREG_SMOKE_MAP_POINTS", "53000000"))
FRAMES = 128
SCAN_POINTS = 5000
BATCH = 128
BLOCK_POINTS = 16384
PROFILE_FRAMES = 8
# odometry-loop cull bound and reuse margin; Monte-Carlo batch radii
R_CULL0, REUSE_MARGIN = 0.18, 0.12
MC_CULL0, MC_MARGIN = 0.25, 0.2
PAIR_POINTS = 8192
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12
# clock cycles of the spin kernel in time_ms (about 50 ms on an H100)
SPIN_CYCLES = 100_000_000


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events).  A
    spin kernel ahead of the first event holds the card while the host
    enqueues the calls, so a call shorter than its host-side launch path
    is timed by the card, not by the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wall(fn):
    """(result, seconds) of ``fn`` on the host clock, device synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# names of the port's hand-written CUDA kernels (csrc/)
PORT_KERNELS = ("block_knn_keys_kernel", "block_knn_merge_kernel",
                "knn_candidates_kernel", "group_min_kernel")


def profile_window(name, fn, top=8):
    """Where the time of one call of ``fn`` goes: wall time, device-busy
    share (sum of kernel times over wall time), the port's own kernels,
    the kernels with the most device time and the host-side ops with the
    most self time, the CUDA kernels K1's wrapper ran per call, counted
    by the profiler, and K2's wrapper calls per kk.  Only
    events that ran on the card count as device time: a host op's own
    device total repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from dcreg_tpu_torch.ops import block_knn as tk
    from dcreg_tpu_torch.ops import knn_kernels as kn
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    k1_before = tk.block_knn_keys.launches
    k2_before = dict(kn.knn_candidates.launches_by_kk)
    with profile(activities=acts) as prof:
        _, seconds = wall(fn)
    k1_calls = tk.block_knn_keys.launches - k1_before
    k2_calls = {kk: n - k2_before.get(kk, 0)
                for kk, n in sorted(kn.knn_candidates.launches_by_kk.items())
                if n > k2_before.get(kk, 0)}
    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    dev_us = lambda e: e.self_device_time_total
    busy_us = sum(dev_us(e) for e in on_card)
    by_dev = sorted(on_card, key=dev_us, reverse=True)[:top]
    by_cpu = sorted(on_host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]
    row = lambda e, t: {"name": e.key[:60], "count": e.count, "ms": t / 1e3}
    ours = [e for e in on_card if any(k in e.key for k in PORT_KERNELS)]
    k1_kernels = sum(e.count for e in ours if "block_knn_" in e.key)
    return {"phase": name, "wall_s": seconds, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / seconds,
            "kernel_launches": sum(e.count for e in on_card),
            "port_kernels": [row(e, dev_us(e)) for e in ours],
            "k1_calls": k1_calls, "k2_calls_by_kk": k2_calls,
            "k1_cuda_kernels_per_call": (k1_kernels / k1_calls
                                         if k1_calls else None),
            "top_device": [row(e, dev_us(e)) for e in by_dev],
            "top_host_self": [row(e, e.self_cpu_time_total) for e in by_cpu]}


# --------------------------------------------------------------------------
# synthetic world, trajectory and scans (numpy, from the seed)
# --------------------------------------------------------------------------

def synthetic_map(n_points, extent, seed):
    """Undulating ground + wall strips + pillars."""
    rng = np.random.default_rng(seed)
    g = int(n_points * 0.65)
    xy = rng.uniform(-extent, extent, (g, 2))
    z = 0.5 * np.sin(0.12 * xy[:, 0]) * np.cos(0.1 * xy[:, 1]) \
        + rng.normal(0, 0.01, g)
    ground = np.column_stack([xy, z])
    w = int(n_points * 0.25)
    wall = np.column_stack([
        rng.uniform(-extent, extent, w),
        np.round(rng.uniform(-3, 3, w)) * (extent / 3.0)
        + rng.normal(0, 0.02, w),
        rng.uniform(0, 5, w)])
    p = n_points - g - w
    n_pil = max(8, int((2 * extent) ** 2 / 60.0))
    centers = rng.uniform(-extent, extent, (n_pil, 2))
    which = rng.integers(0, n_pil, p)
    ang = rng.uniform(0, 2 * np.pi, p)
    pil = np.column_stack([centers[which, 0] + 0.4 * np.cos(ang),
                           centers[which, 1] + 0.4 * np.sin(ang),
                           rng.uniform(0, 6, p)])
    return np.vstack([ground, wall, pil]).astype(np.float32)


def trajectory(extent, frames):
    """Integrated S-curve path between the wall lines; returns the two
    poses before frame 0 and the (F, 4, 4) ground truth."""
    start = np.array([9.0, -0.45 * (extent / 3.0), 9.0 + 0.8])
    gt, pos = [], start.copy()
    for i in range(-2, frames):
        yaw = 0.3 + 0.35 * np.sin(0.05 * i) + 0.01 * np.sin(0.25 * i)
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1.0]]
        T[:3, 3] = pos
        gt.append(T)
        step = 0.22 + 0.06 * np.sin(0.2 * i)
        pos = pos + [step * c, step * s, 0.0]
    return gt[0], gt[1], np.asarray(gt[2:])


def tube_mask(world, gt):
    """The map points within 9 m of the trajectory's bounding box."""
    tube_lo = gt[:, :3, 3].min(axis=0) - 9.0
    tube_hi = gt[:, :3, 3].max(axis=0) + 9.0
    return np.all((world >= tube_lo) & (world <= tube_hi), axis=1)


def scans(world, gt, n, rng):
    tube = world[tube_mask(world, gt)]
    out = []
    for T in gt:
        c = T[:3, 3]
        near = tube[np.sum((tube - c) ** 2, axis=1) < 6.0 ** 2]
        sel = near[rng.choice(near.shape[0], n, replace=False)]
        out.append((sel - c) @ T[:3, :3] + rng.normal(0, 0.003, (n, 3)))
    return np.asarray(out, np.float32), tube


def euler(r, p, y):
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), \
        np.cos(y), np.sin(y)
    return (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
            @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]))


# --------------------------------------------------------------------------
# K1 inputs at the main path's shapes, and its bound
# --------------------------------------------------------------------------

def k1_inputs(kind, src_xyz, index, Rs, ts, radius, caps, device,
              live_radius=None, key_radius=None):
    """The (src_blocks, poses, qid, tid, pid, lane_mask, ib, scale, clamp)
    that iteration 0 of ``icp_batch_so3`` hands to K1.  ``kind`` "block"
    or "map" culls at ``radius``; "map_reuse" is the localization loop's
    call: the pair list culled at ``radius`` (the reuse radius) with the
    live mask of the pairs within ``live_radius`` at these poses, as
    ``icp_batch_so3`` builds it.  Keys use ``key_radius`` (default
    ``radius``)."""
    from dcreg_tpu_torch.ops import block_knn as tk
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    src = f32(src_xyz)
    Rs, ts = f32(Rs), f32(ts)
    B, N = Rs.shape[0], src.shape[0]
    nq = -(-N // tk.QB)
    src_q = torch.cat([src, src[-1:].expand(nq * tk.QB - N, 3)]).reshape(
        nq, tk.QB, 3)
    slo, shi = src_q.amin(1), src_q.amax(1)
    qbox = tk.exact_qbox(src_q, Rs, ts)
    if kind == "block":
        bi = index
        rel_l = tk.lane_relevance(slo, shi, Rs, ts, bi.lo, bi.hi, radius,
                                  per_lane=True, qbox=qbox)
        rel = rel_l.any(0)
        qid, tid, ovf = tk.make_pair_list(rel, caps["P"])
        pid = tid
        mask = tk.pack_lane_mask(rel_l, qid, tid)
        ib = tk._index_bits((bi.num_blocks + 1) * tk.TB)
    else:
        bi = index.block
        sel, ok, sovf = tk.super_candidates(slo, shi, Rs, ts, index, radius,
                                            caps["S"], qbox=qbox)
        rel_l, bids = tk.hier_relevance(slo, shi, Rs, ts, index, sel, ok,
                                        radius, qbox=qbox)
        rel = rel_l.any(0)
        qid, tid, slot, col, _, ovf, rovf = tk.make_pair_list_slotted(
            rel, caps["P"], caps["G"], block_ids=bids, nbt=bi.num_blocks)
        ovf = ovf + rovf + sovf
        pid = slot
        mask = tk.pack_lane_mask(rel_l, qid, col) if B > 1 else None
        ib = tk._index_bits(caps["G"] * tk.TB)
        if kind == "map_reuse":
            pad = qid >= nq
            t_safe = torch.where(pad, 0, tid).long()
            q_safe = torch.where(pad, 0, qid).long()
            qlo, qhi = qbox[0][0][q_safe], qbox[1][0][q_safe]
            gap = torch.clamp(torch.maximum(qlo - bi.hi[t_safe],
                                            bi.lo[t_safe] - qhi), min=0.0)
            live = ((gap * gap).sum(-1) <= live_radius ** 2) & ~pad
            mask = live.to(torch.int32)[:, None]
    if int(ovf) != 0:
        raise RuntimeError(f"K1 inputs ({kind}) overflow the pair list")
    _, _, clamp, scale = tk.key_params(
        radius if key_radius is None else key_radius, ib)
    poses = torch.cat([Rs.reshape(B, 9), ts], dim=1).contiguous()
    i32 = lambda t: t.to(torch.int32).contiguous()
    return dict(src_blocks=src_q.transpose(1, 2).contiguous(),
                tgt=bi.blocks, poses=poses, qid=i32(qid), tid=i32(tid),
                pid=i32(pid), lane_mask=None if mask is None else i32(mask),
                index_bits=ib, scale=scale, clamp=clamp)


def k1_bound(a):
    """Least time for the work of one K1 call on this data: the larger of
    bytes moved (each input read once, each output written once) over the
    memory rate, and f32 operations (10 per candidate: 3 sub, 3 mul,
    2 add, 1 min, 1 scale) over the f32 rate.  Only live (pair, lane)
    combinations and the target blocks they touch count."""
    nq, B = a["src_blocks"].shape[0], a["poses"].shape[0]
    real = a["qid"] < nq
    if a["lane_mask"] is None:
        live_lanes = torch.where(real, B, 0)
    else:
        words = a["lane_mask"].reshape(real.shape[0], -1).to(torch.int64)
        words = words & 0xFFFFFFFF
        cnt = torch.zeros_like(words)
        for bit in range(32):
            cnt = cnt + ((words >> bit) & 1)
        live_lanes = torch.where(real, cnt.sum(1), 0)
    evals = int(live_lanes.sum()) * 128 * 128
    touched = torch.unique(a["tid"][live_lanes > 0]).numel()
    nbytes = (a["qid"].numel() * 3 * 4
              + (0 if a["lane_mask"] is None else a["lane_mask"].numel() * 4)
              + a["src_blocks"].numel() * 4 + touched * 3 * 128 * 4
              + a["poses"].numel() * 4 + nq * B * 8 * 128 * 4)
    ops = 10.0 * evals
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "candidate_evals": evals, "bytes": int(nbytes),
            "pairs": int(real.sum()), "live_pair_lanes": int(
                live_lanes.sum())}


def long_run_inputs(a, G):
    """(f): ``a``'s shape (slot-local ids, B = 1, no mask) with query block
    0 given a run of ``G`` (max_per_query) pairs, the distinct target
    blocks of ``a``'s list, and every other block its first 2 pairs."""
    from dcreg_tpu_torch.ops import block_knn as tk
    nq = a["src_blocks"].shape[0]
    qid, tid = a["qid"].long(), a["tid"].long()
    real = qid < nq
    tids = torch.unique(tid[real])
    if tids.numel() < G:
        raise RuntimeError(f"(f) needs {G} distinct target blocks, "
                           f"(a) has {tids.numel()}")
    run_start = tk._run_start(a["qid"], nq).long()
    rank = torch.arange(qid.numel(), device=qid.device) - run_start[
        torch.clamp(qid, max=nq - 1)]
    keep = real & (qid > 0) & (rank < 2)
    q = torch.cat([torch.zeros(G, dtype=torch.long, device=qid.device),
                   qid[keep]])
    t = torch.cat([tids[:G], tid[keep]])
    slot = torch.cat([torch.arange(G, device=qid.device), rank[keep]])
    i32 = lambda x: x.to(torch.int32).contiguous()
    return dict(a, qid=i32(q), tid=i32(t), pid=i32(slot), lane_mask=None)


def check_k1(name, a):
    """Keys of K1 and its plain twin on the card, bit for bit; times.  The
    split and CTA counts are those the wrapper launched."""
    from dcreg_tpu_torch.ops import block_knn as tk
    args = [a[k] for k in ("src_blocks", "tgt", "poses", "qid", "tid",
                           "pid", "lane_mask", "index_bits", "scale",
                           "clamp")]
    nq, B = a["src_blocks"].shape[0], a["poses"].shape[0]
    tk.block_knn_keys.last_grid = None
    keys = tk.block_knn_keys(*args)
    grid = tk.block_knn_keys.last_grid or {"nsplit": None, "ctas": None}
    ref = tk.block_knn_keys(*args, plain=True)
    mismatches = int((keys != ref).sum())
    max_abs_err = int((keys.long() - ref.long()).abs().max())
    if mismatches:
        raise RuntimeError(f"K1 {name}: {mismatches} keys differ from the "
                           f"plain version (max |diff| {max_abs_err})")
    ms = time_ms(lambda: tk.block_knn_keys(*args), 20)
    plain_ms = time_ms(lambda: tk.block_knn_keys(*args, plain=True), 2)
    qid = a["qid"].long()
    runs = torch.bincount(qid[qid < nq], minlength=nq)
    row = {"phase": "k1_check", "shape": name, "B": int(B), "nq": int(nq),
           "keys": int(keys.numel()), "mismatches": mismatches,
           "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
           **grid,
           "run_mean": float(runs.float().mean()),
           "run_max": int(runs.max())}
    row.update(k1_bound(a))
    emit(row)
    return row


# --------------------------------------------------------------------------
# K2 and K3: the pair-mode brute-force k-NN kernels
# --------------------------------------------------------------------------

def synthetic_cylinder(seed, n=PAIR_POINTS):
    """The pair harness's world: the upper part (z > -2) of a cylinder of
    radius 3 m along y, 24 m long, whose radius undulates by 3 cm with a
    6 m period along the axis, and a floor strip at z = -2,
    |x| < 1.8, clear of the wall (15% of the points).  The undulation is
    the only thing that pins the axial translation, weakly; the floor
    pins the rotation about the axis.  (n, 3) f32."""
    rng = np.random.default_rng(seed)
    radius, length, period, amp = 3.0, 24.0, 6.0, 0.03
    n_floor = int(0.15 * n)
    n_wall = n - n_floor
    y = rng.uniform(-length / 2, length / 2, n_wall)
    # angles of the wall above the floor plane: sin(th) > -2 / 3
    lo = np.arcsin(-2.0 / radius)
    th = rng.uniform(lo, np.pi - lo, n_wall)
    r = radius + amp * np.sin(2.0 * np.pi * y / period)
    wall = np.column_stack([r * np.cos(th), y, r * np.sin(th)])
    floor = np.column_stack([rng.uniform(-1.8, 1.8, n_floor),
                             rng.uniform(-length / 2, length / 2, n_floor),
                             np.full(n_floor, -2.0)])
    pts = np.vstack([wall, floor]) + rng.normal(0.0, 0.002, (n, 3))
    return pts.astype(np.float32)


def knn_bound(n, m, out_bytes):
    """Least time for one K2 or K3 call: the larger of 10 f32 operations
    per (query, target) pair (3 sub, 3 mul, 3 add, 1 min) over the f32
    rate and the bytes (queries, targets and penalties read once, the
    output written once) over the memory rate."""
    nbytes = n * 12 + m * 16 + out_bytes
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 10.0 * n * m / H100_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "pairs_nm": n * m, "bytes": int(nbytes)}


def check_knn(name, query, target, valid, k, kk):
    """K2 and K3 against their plain twins on the card, bit for bit on
    (val, idx) and on the group minima; the grids the wrappers launched;
    times of both kernels, their twins, and for K2 the nearest library
    pair (cdist + topk)."""
    from dcreg_tpu_torch.ops import knn_kernels as kn
    n, m = query.shape[0], target.shape[0]
    pen = kn._penalty(m, valid, query.device)
    kn.knn_candidates.last_grid = kn.group_min.last_grid = None
    val, idx = kn.knn_candidates(query, target, pen, kk)
    val_p, idx_p = kn.knn_candidates_plain(query, target, pen, kk)
    gmin = kn.group_min(query, target, pen)
    gmin_p = kn.group_min_plain(query, target, pen)
    torch.cuda.synchronize()
    bits = lambda x: x.view(torch.int32)
    k2_bad = int((bits(val) != bits(val_p)).sum() + (idx != idx_p).sum())
    k3_bad = int((bits(gmin) != bits(gmin_p)).sum())
    k2_err = float((val - val_p).abs().max())
    k3_err = float((gmin - gmin_p).abs().max())
    if k2_bad or k3_bad:
        raise RuntimeError(f"{name}: K2 differs from its plain version in "
                           f"{k2_bad} entries, K3 in {k3_bad}")
    def lib():
        # cdist's launch refuses 65,536 x 65,536 outputs, so the library
        # pair runs over query chunks of 8,192 rows
        for c0 in range(0, n, 8192):
            torch.topk(torch.cdist(
                query[c0:c0 + 8192], target,
                compute_mode="donot_use_mm_for_euclid_dist"), k, dim=1,
                largest=False)
    k2 = {"ms": time_ms(lambda: kn.knn_candidates(query, target, pen, kk),
                        20),
          "plain_ms": time_ms(lambda: kn.knn_candidates_plain(
              query, target, pen, kk), 2),
          "library_ms": time_ms(lib, 1), "max_abs_err": k2_err,
          "mismatches": k2_bad, "grid": kn.knn_candidates.last_grid}
    k2.update(knn_bound(n, m, n * kk * 8))
    k3 = {"ms": time_ms(lambda: kn.group_min(query, target, pen), 20),
          "plain_ms": time_ms(lambda: kn.group_min_plain(query, target,
                                                          pen), 2),
          "library_ms": None, "max_abs_err": k3_err, "mismatches": k3_bad,
          "grid": kn.group_min.last_grid}
    k3.update(knn_bound(n, m, gmin.numel() * 4))
    emit({"phase": "knn_check", "shape": name, "N": n, "M": m, "k": k,
          "kk": kk, "invalid_targets": 0 if valid is None
          else int((~valid).sum()), "K2": k2, "K3": k3})
    return k2, k3


def knn_checks(seed, T0, device):
    """K2 and K3 at the shapes of the pair path: (d) the 5-NN self query
    of the 8,192-point cylinder, (e) nn1 of the cylinder moved by the
    initial pose T0 against itself, (f) 65,536 points with 30% of the targets
    invalid, where knn_grouped must also return what knn returns,
    (g) ragged sizes, 333 queries and 1,000 targets with 30% invalid, which
    hold K2's merge and partial slices and K3's partial chunk and group
    on the card, (h) the O3D engine's normal search, the cylinder's self
    query at k 30 and kk 60 (two list slots per lane), (i) kk 128
    (four slots), the moved cylinder against itself, and (j) (g)'s
    shapes at kk 128, K2's merge with four slots."""
    from dcreg_tpu_torch.ops import knn_kernels as kn
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    cyl = f32(synthetic_cylinder(seed))
    moved = cyl @ f32(T0[:3, :3]).T + f32(T0[:3, 3])
    big = synthetic_cylinder(seed + 1, 65536)
    rng = np.random.default_rng(seed + 2)
    big_q = f32(big + rng.normal(0.0, 0.05, big.shape))
    valid = torch.as_tensor(rng.uniform(size=65536) >= 0.3, device=device)
    small = synthetic_cylinder(seed + 3, 1000)
    small_q = f32(small[:333] + rng.normal(0.0, 0.05, (333, 3)))
    small_valid = torch.as_tensor(rng.uniform(size=1000) >= 0.3,
                                  device=device)
    rows = {"d_self_5nn": check_knn("d_self_5nn", cyl, cyl, None, 5, 10),
            "e_nn1": check_knn("e_nn1", moved, cyl, None, 1, 8),
            "f_65k_invalid": check_knn("f_65k_invalid", big_q, f32(big),
                                       valid, 5, 10),
            "g_ragged_invalid": check_knn("g_ragged_invalid", small_q,
                                          f32(small), small_valid, 5, 10),
            "h_normals_o3d": check_knn("h_normals_o3d", cyl, cyl, None, 30,
                                       60),
            "i_kk128": check_knn("i_kk128", moved, cyl, None, 125, 128),
            "j_ragged_kk128": check_knn("j_ragged_kk128", small_q,
                                        f32(small), small_valid, 125, 128)}
    kn.group_min.launches = 0
    dg, ig = kn.knn_grouped(big_q, f32(big), valid, k=5)
    k3_launches = kn.group_min.launches
    dk, ik = kn.knn(big_q, f32(big), valid, k=5, kk=10)
    same = bool(torch.equal(ig, ik)) and bool(torch.equal(dg, dk))
    emit({"phase": "knn_grouped_check", "shape": "f_65k_invalid",
          "equal_to_knn": same, "k3_launches": k3_launches})
    if not same:
        raise RuntimeError("knn_grouped differs from knn at (f)")
    return rows, k3_launches


# --------------------------------------------------------------------------
# The pair harness: the method matrices of configs/cylinder.yaml and
# configs/parkinglot.yaml
# --------------------------------------------------------------------------

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
CYLINDER_YAML = os.path.join(CONFIGS, "cylinder.yaml")
PARKINGLOT_YAML = os.path.join(CONFIGS, "parkinglot.yaml")
SO3_ROWS = ("ME-SR", "ME-TSVD", "ME-TReg", "FCN-SR", "Ours")
PARKING_ROWS = ("O3D", "XICP-1", "XICP-EQ", "XICP-INQ", "XICP-OP")
ARTIFACTS = ("statistics_summary.txt", "complete_log.txt", "all_results.csv",
             "iteration_history.csv", "iteration_details_with_dx.csv",
             "transform_details.csv", "iteration_timing_provenance.csv",
             "condition_numbers_detailed.csv", "pcg.txt",
             "degeneracy_analysis_first_iter.txt",
             "degeneracy_analysis_last_iter.txt")


def pair_scenarios(load_config):
    """Phase 6's three method matrices, {name: config}, from
    ``load_config`` (the port's loader; the CPU rehearsal and the tests
    pass the JAX package's too): "cylinder", every row of
    configs/cylinder.yaml; "parkinglot", the rows only
    configs/parkinglot.yaml has (O3D and four XICP variants) with its
    parameters and the cylinder's poses, since its frames are not in the
    repository; "euler", the five SO(3) rows of configs/cylinder.yaml
    through the Euler engine (use_so3_parameterization false)."""
    cyl = load_config(CYLINDER_YAML)
    park = load_config(PARKINGLOT_YAML)

    def rows(cfg, names):
        return cfg._replace(test_methods=tuple(
            m for m in cfg.test_methods if m[0] in names))

    return {"cylinder": cyl,
            "parkinglot": rows(park, PARKING_ROWS)._replace(
                initial_noise=cyl.initial_noise, gt_pose=cyl.gt_pose),
            "euler": rows(cyl, SO3_ROWS)._replace(
                use_so3_parameterization=False)}


def cylinder_config():
    from dcreg_tpu_torch.config import load_config
    return load_config(CYLINDER_YAML)


def expected_artifacts(cfg):
    """ARTIFACTS, less pcg.txt where no row of ``cfg`` solves by PCG (the
    harness writes it for the first PCG row)."""
    from dcreg_tpu_torch.ops.degeneracy import HandlingMethod
    pcg = any(h == HandlingMethod.PRECONDITIONED_CG
              for _, _, h in cfg.methods())
    return tuple(f for f in ARTIFACTS if pcg or f != "pcg.txt")


def pair_harness(world, scenario, cfg, backend, device):
    """The rows of ``cfg`` through the port's TestRunner (f32) on
    ``world`` (source == target), with the CSR grid (``backend`` "grid")
    or brute force (K2, "brute") as every iteration's search, into a
    temporary folder.  Gates: every artifact written, finite rows in
    all_results.csv, finite SuperLoc record fields, and in the cylinder
    matrix Ours converging with TE < 5 cm and RE < 0.5 deg and a
    degenerate direction flagged at iteration 0.  Returns the per-method
    summary (with each row's K2 launches in total and per kk) and the
    run's K2 launches ({"total", "by_kk"})."""
    import csv
    from dcreg_tpu_torch.harness import TestRunner
    from dcreg_tpu_torch.ops import knn_kernels as kn
    out = tempfile.mkdtemp(prefix=f"dcreg_pair_{scenario}_{backend}_")
    try:
        cfg = cfg._replace(output_folder=out,
                           use_grid_index=backend == "grid")
        runner = TestRunner(cfg, dtype=torch.float32, device=device)
        per_method = {}
        t0 = time.perf_counter()
        kn.knn_candidates.launches = 0
        kn.knn_candidates.launches_by_kk = {}
        runner.load_point_clouds(world, world)
        for name, det, hand in cfg.methods():
            before = dict(kn.knn_candidates.launches_by_kk)
            runner.run_method(name, det, hand)
            per_method[name] = {
                kk: n - before.get(kk, 0)
                for kk, n in sorted(kn.knn_candidates.launches_by_kk.items())
                if n > before.get(kk, 0)}
        runner.finalize_statistics()
        runner.save_results()
        seconds = time.perf_counter() - t0
        launches = {"total": kn.knn_candidates.launches,
                    "by_kk": dict(sorted(
                        kn.knn_candidates.launches_by_kk.items()))}
        missing = [f for f in expected_artifacts(cfg)
                   if not os.path.isfile(os.path.join(out, f))
                   or os.path.getsize(os.path.join(out, f)) == 0]
        with open(os.path.join(out, "all_results.csv")) as f:
            rows = list(csv.DictReader(f))
        finite = {r["Method"]: all(np.isfinite(float(v))
                                   for k, v in r.items() if k != "Method")
                  for r in rows}
        summary = {}
        for rec in runner.records:
            s = runner.stats[rec.method]
            sl = getattr(rec, "superloc", None)
            summary[rec.method] = {
                "iterations": rec.n_iters, "converged": rec.converged,
                "te_m": s["trans_error_mean"], "re_deg": s["rot_error_mean"],
                "time_mean_ms": s["time_mean"],
                "k2_launches": sum(per_method[rec.method].values()),
                "k2_launches_by_kk": per_method[rec.method],
                "mask_iter0": [int(m) for m in
                               rec.result.log.degenerate_mask[0]],
                "finite_rows": finite.get(rec.method, False),
                "record": rec}
            if sl is not None:
                sl = dict(sl, uncertainties=[float(u) for u in
                                             sl["uncertainties"]])
                summary[rec.method]["superloc"] = sl
                summary[rec.method]["finite_rows"] &= bool(np.all(
                    np.isfinite(np.asarray(sl["uncertainties"] + [
                        sl["cond_full"], sl["cond_rot"],
                        sl["cond_trans"]], np.float64))))
        emit({"phase": f"pair_harness_{scenario}_{backend}",
              "points": len(world), "seconds": seconds,
              "k2_launches": launches["total"],
              "k2_launches_by_kk": launches["by_kk"],
              "missing_artifacts": missing,
              "methods": {m: {k: v for k, v in d.items() if k != "record"}
                          for m, d in summary.items()}})
        ok = not missing and all(d["finite_rows"] for d in summary.values())
        if "Ours" in summary and cfg.use_so3_parameterization:
            ours = summary["Ours"]
            ok &= bool(ours["converged"] and ours["te_m"] < 0.05
                       and ours["re_deg"] < 0.5 and any(ours["mask_iter0"]))
        if not ok:
            raise RuntimeError(f"pair harness ({scenario}, {backend}) gates "
                               "failed")
        if device != "cpu":
            if backend == "brute" and launches["total"] <= 0:
                raise RuntimeError(f"K2 was not launched by the brute-force "
                                   f"{scenario} run")
            if "O3D" in summary and not \
                    summary["O3D"]["k2_launches_by_kk"].get(60):
                raise RuntimeError("K2 was not launched at kk 60 by O3D")
        # one method run each under the profiler: Ours of the cylinder
        # matrix on both backends, XICP and O3D where K2 is the search
        methods = {m: (d, h) for m, d, h in cfg.methods()}
        profiled = ["Ours"] if scenario == "cylinder" else []
        if backend == "brute":
            profiled += ["XICP", "O3D"]
        for name in profiled:
            if name in methods:
                emit(profile_window(
                    f"pair_{name.lower()}_profile_{scenario}_{backend}",
                    lambda: runner.run_single_test(name, *methods[name])))
        return summary, launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


# a method that does not converge on both backends is compared after this
# many iterations (or its last, if fewer), not at the iteration limit
AGREE_ITERS = 10


def backend_agreement(a, b):
    """How far one method's runs on the grid and the brute-force backend
    (``a``, ``b``: records with ``n_iters``, ``converged`` and the log's
    per-iteration ``transform``) lie apart, and whether that passes: the
    iterations within 1, the poses within 1e-4 m and 1e-3 deg.

    The grid orders near-tie neighbours by a packed key, K2 by exact
    distance, so the plane fits round differently; a method that
    converges settles both runs on one pose, but one that runs to the
    iteration limit creeps along its weak direction and carries the
    difference on.  A method that converged on both backends is compared
    at its final poses, any other at iteration ``AGREE_ITERS``."""
    both = bool(a.converged) and bool(b.converged)
    if both:
        ka, kb = a.last_iter(), b.last_iter()
    else:
        ka = kb = max(min(AGREE_ITERS, a.n_iters, b.n_iters) - 1, 0)
    A = np.asarray(a.result.log.transform[ka], np.float64)
    B = np.asarray(b.result.log.transform[kb], np.float64)
    out = {"iterations": [int(a.n_iters), int(b.n_iters)],
           "compared_at": "final" if both else f"iteration {ka + 1}",
           "dt_m": float(np.linalg.norm(A[:3, 3] - B[:3, 3])),
           "dang_deg": rotation_angle_deg(A[:3, :3].T @ B[:3, :3])}
    out["ok"] = (abs(out["iterations"][0] - out["iterations"][1]) <= 1
                 and out["dt_m"] < 1e-4 and out["dang_deg"] < 1e-3)
    return out


def rotation_angle_deg(R):
    """Angle of a rotation from its skew and trace parts together (exact
    near 0, where arccos of the trace alone loses half the digits)."""
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.degrees(np.arctan2(0.5 * np.linalg.norm(w),
                                       0.5 * (np.trace(R) - 1.0))))


def run_pair(seed: int, device: str = "cuda"):
    """Phases 5 and 6: K2 and K3 against their plain twins, then the three
    method matrices of ``pair_scenarios`` on both search backends, each
    method held to its backend agreement.  Returns the K2 and K3 entries
    of the ``kernels`` line."""
    from dcreg_tpu_torch.config import load_config
    scenarios = pair_scenarios(load_config)
    rows, k3_launches = knn_checks(seed,
                                   scenarios["cylinder"].initial_matrix(),
                                   device)
    world = synthetic_cylinder(seed)
    runs, launches, agree = {}, {}, {}
    for name, cfg in scenarios.items():
        for backend in ("grid", "brute"):
            runs[name, backend], launches[f"pair_{name}_{backend}"] = \
                pair_harness(world, name, cfg, backend, device)
        grid, brute = runs[name, "grid"], runs[name, "brute"]
        agree[name] = {m: backend_agreement(grid[m]["record"],
                                            brute[m]["record"])
                       for m in grid}
    emit({"phase": "pair_backends_agree", "matrices": agree})
    bad = [f"{s}/{m}" for s, d in agree.items() for m, a in d.items()
           if not a["ok"]]
    if bad:
        raise RuntimeError(f"grid and brute-force backends disagree: {bad}")
    d = rows["d_self_5nn"]
    k2 = {"name": "K2 knn_candidates", "route": "cuda",
          "source": "dcreg_tpu_torch/csrc/knn.cu",
          "replaces": "dcreg_tpu/ops/pallas_knn.py:47",
          "launches": sum(v["total"] for v in launches.values()),
          "launches_by_path": {p: v["total"] for p, v in launches.items()},
          "launches_by_path_and_kk": {p: v["by_kk"]
                                      for p, v in launches.items()},
          "launches_per_method_run": {
              f"{s}_{b}": {m: r["k2_launches_by_kk"] for m, r in s_b.items()}
              for (s, b), s_b in runs.items()},
          "max_abs_err": max(r[0]["max_abs_err"] for r in rows.values()),
          "ms": d[0]["ms"], "plain_ms": d[0]["plain_ms"],
          "bound_ms": d[0]["bound_ms"], "bound_by": d[0]["bound_by"],
          "library_ms": d[0]["library_ms"],
          "library": "torch.cdist + torch.topk (two calls)",
          "shapes": {k: {f: v[0][f] for f in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms",
                                               "grid")}
                     for k, v in rows.items()}}
    f = rows["f_65k_invalid"][1]
    k3 = {"name": "K3 group_min", "route": "cuda",
          "source": "dcreg_tpu_torch/csrc/knn.cu",
          "replaces": "dcreg_tpu/ops/pallas_knn.py:196",
          "launches": k3_launches,
          "launches_by_path": {"knn_grouped_check_f": k3_launches},
          "max_abs_err": max(r[1]["max_abs_err"] for r in rows.values()),
          "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
          "bound_by": f["bound_by"], "library_ms": None,
          "shapes": {k: {g: v[1][g] for g in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "grid")}
                     for k, v in rows.items()}}
    return k2, k3


# --------------------------------------------------------------------------
# Phase 8: the voxel-grid odometry loop, the pose graph and TUM scoring
# --------------------------------------------------------------------------

# the voxel loop's timed run falls back to its first 64 frames when the
# warm-up predicts more than this many seconds for all of them
VOXEL_TIMED_LIMIT_S = 120.0
VOXEL_WARM_FRAMES = 4


def voxel_capacity(tube, grid):
    """(capacity, largest occupancy): the most points in one voxel of
    ``grid`` among ``tube``'s points (the map around the trajectory),
    counted on the host with the grid's own origin and scale in f32, plus
    2% for points that f32 rounding puts across a voxel face, rounded up
    to a multiple of 32."""
    origin = grid.origin.cpu().numpy()
    inv = grid.inv_size.cpu().numpy()
    dims = grid.dims.cpu().numpy()
    c = np.floor((tube.astype(np.float32) - origin) * inv).astype(np.int64)
    ids = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    occ = int(np.unique(ids, return_counts=True)[1].max())
    return -(-int(np.ceil(occ * 1.02)) // 32) * 32, occ


def ulp_diff(a, b):
    """|a - b| in units in the last place of non-negative f32 values."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def pose_graph_inputs(gt, seed):
    """A window over ``gt``: odometry edges with seeded noise (0.01 rad,
    0.02 m), one exact closure from the first pose to the last with
    information x100, and the noisy chain integrated as the initial
    guess (f64 numpy): (i, j, Z, info, init)."""
    from dcreg_tpu_torch.ops import se3
    W = gt.shape[0]
    rng = np.random.default_rng(seed)
    Z = np.linalg.inv(gt[:-1]) @ gt[1:]
    rot = se3.exp_so3(torch.as_tensor(rng.normal(0.0, 0.01, (W - 1, 3))))
    Z[:, :3, :3] = Z[:, :3, :3] @ rot.numpy()
    Z[:, :3, 3] += rng.normal(0.0, 0.02, (W - 1, 3))
    init = [gt[0]]
    for k in range(W - 1):
        init.append(init[-1] @ Z[k])
    Z = np.concatenate([Z, (np.linalg.inv(gt[0]) @ gt[-1])[None]])
    info = np.broadcast_to(np.eye(6), (W, 6, 6)).copy()
    info[-1] *= 100.0
    i = np.append(np.arange(W - 1), 0)
    j = np.append(np.arange(1, W), W - 1)
    return i, j, Z, info, np.asarray(init)


def run_voxel(seed, ctx, device: str = "cuda"):
    """Phase 8 on phase 2's world, trajectory and scans: (8a) the voxel
    map index and ``run_odometry`` from T_pre1, (8b) ``voxel_knn`` held
    against K2 on frame 0 at its GT pose, (8c) the pose graph of a
    128-pose window in f32 on the card against f64 on the CPU, (8d) the
    trajectories through TUM files and their scores.  Returns K2's
    launches in (8b)."""
    from dcreg_tpu_torch.io import tum
    from dcreg_tpu_torch.models.odometry import OdometryParams, run_odometry
    from dcreg_tpu_torch.models.pose_graph import (make_edges,
                                                   optimize_pose_graph)
    from dcreg_tpu_torch.ops import knn_kernels as kn
    from dcreg_tpu_torch.ops.voxel_grid import build_voxel_grid, voxel_knn
    world, gt, frames = ctx["world"], ctx["gt"], ctx["frames"]
    radius = OdometryParams().corr.search_radius
    t_start = time.perf_counter()
    since = lambda: time.perf_counter() - t_start

    # ---- 8a. the voxel odometry loop --------------------------------------
    world_t = torch.as_tensor(world, device=device)
    grid, build_s = wall(lambda: build_voxel_grid(world_t, radius,
                                                  device=device))
    tube_idx = np.nonzero(tube_mask(world, gt))[0]
    cap, occ = voxel_capacity(world[tube_idx], grid)
    params = OdometryParams(capacity=cap)

    def odom(n):
        return run_odometry(frames[:n], grid, T0=ctx["T_pre1"],
                            params=params, device=device)

    _, warm_s = wall(lambda: odom(VOXEL_WARM_FRAMES))
    n_timed = FRAMES
    if warm_s / VOXEL_WARM_FRAMES * FRAMES > VOXEL_TIMED_LIMIT_S:
        n_timed = FRAMES // 2
    res, dt = wall(lambda: odom(n_timed))
    est = res.poses.double().cpu().numpy()
    te = np.linalg.norm(est[:, :3, 3] - gt[:n_timed, :3, 3], axis=1)
    vs_map = np.linalg.norm(est[:, :3, 3]
                            - ctx["odom_poses"][:n_timed, :3, 3], axis=1)
    row = {"phase": "voxel_odometry", "frames": n_timed,
           "timed_frames_note": ("all frames" if n_timed == FRAMES else
                                 f"first {n_timed} frames: the warm-up "
                                 f"predicted over {VOXEL_TIMED_LIMIT_S} s "
                                 "for all"),
           "map_points": int(world.shape[0]), "grid_build_s": build_s,
           "grid_dims": [int(d) for d in grid.dims],
           "capacity": cap, "largest_occupancy": occ,
           "warm_run_s": warm_s, "ms_per_frame": dt / n_timed * 1e3,
           "iters_per_frame": float(res.iterations.float().mean()),
           "converged_frac": float(res.converged.float().mean()),
           "te_mean_m": float(te.mean()), "te_max_m": float(te.max()),
           "max_dist_to_map_loop_m": float(vs_map.max()),
           "phase8_s": since()}
    emit(row)
    if not (bool(res.converged.all()) and te.mean() < 0.05
            and te.max() < 0.10 and vs_map.max() < 0.03):
        raise RuntimeError(f"voxel odometry gates failed: {row}")
    prof = profile_window("voxel_odometry_profile",
                          lambda: odom(PROFILE_FRAMES))
    prof_iters = int(res.iterations[:PROFILE_FRAMES].sum())
    prof["icp_trips"] = prof_iters
    prof["kernels_per_icp_trip"] = prof["kernel_launches"] / max(prof_iters,
                                                                 1)
    prof["phase8_s"] = since()
    emit(prof)

    # ---- 8b. voxel_knn held against K2 ------------------------------------
    T = torch.as_tensor(gt[0], dtype=torch.float32, device=device)
    q = torch.as_tensor(frames[0], device=device) @ T[:3, :3].T + T[:3, 3]
    tube_t = world_t[torch.as_tensor(tube_idx, device=device)].contiguous()
    dv, iv = voxel_knn(grid, q, k=5, capacity=cap, chunk=params.chunk)
    kn.knn_candidates.launches = 0
    dk, ik = kn.knn(q, tube_t, k=5)
    k2_launches = kn.knn_candidates.launches
    ik = torch.as_tensor(tube_idx, device=device)[ik]
    sel = dv[:, 4] < radius ** 2
    ulps = ulp_diff(dv[sel], dk[sel])
    same_ids = torch.all(torch.sort(iv[sel], dim=1).values
                         == torch.sort(ik[sel], dim=1).values, dim=1)
    exact_d = torch.all(dv[sel] == dk[sel], dim=1)
    bad = int((~same_ids & ~exact_d).sum())
    row = {"phase": "voxel_knn_check", "queries": int(q.shape[0]),
           "targets_k2": int(tube_t.shape[0]), "gated_queries": int(sel.sum()),
           "max_ulp": int(ulps.max()) if ulps.numel() else 0,
           "id_sets_differ": int((~same_ids).sum()),
           "id_sets_differ_not_tied": bad, "k2_launches": k2_launches,
           "voxel_knn_ms": time_ms(lambda: voxel_knn(
               grid, q, k=5, capacity=cap, chunk=params.chunk), 5),
           "k2_knn_ms": time_ms(lambda: kn.knn(q, tube_t, k=5), 5),
           "phase8_s": since()}
    emit(row)
    if bad or row["max_ulp"] > 2 or row["gated_queries"] == 0 \
            or (device != "cpu" and k2_launches <= 0):
        raise RuntimeError(f"voxel_knn disagrees with K2: {row}")

    # ---- 8c. the pose graph -------------------------------------------------
    i, j, Z, info, init = pose_graph_inputs(gt, seed + 8)
    dtype = torch.float32

    def pg(dev, dt):
        edges = make_edges(i, j, torch.as_tensor(Z, dtype=dt), info=info,
                           device=dev)
        return optimize_pose_graph(torch.as_tensor(init, dtype=dt), edges,
                                   device=dev)

    ref = pg("cpu", torch.float64)
    ref_p = ref.poses.numpy()
    wall(lambda: pg(device, dtype))
    out, pg_s = wall(lambda: pg(device, dtype))
    opt = out.poses.double().cpu().numpy()
    drift0 = float(np.linalg.norm(init[-1, :3, 3] - gt[-1, :3, 3]))
    drift1 = float(np.linalg.norm(opt[-1, :3, 3] - gt[-1, :3, 3]))
    vs_ref = float(np.linalg.norm(opt[:, :3, 3] - ref_p[:, :3, 3],
                                  axis=1).max())
    row = {"phase": "pose_graph", "window": int(gt.shape[0]),
           "edges": int(len(i)), "dtype": str(dtype).split(".")[-1],
           "gn_iterations": out.iterations, "converged": out.converged,
           "ms": pg_s * 1e3, "final_cost": float(out.final_cost),
           "drift_before_m": drift0, "drift_after_m": drift1,
           "max_dist_to_cpu_f64_m": vs_ref,
           "cpu_f64_iterations": ref.iterations,
           "cpu_f64_final_cost": float(ref.final_cost),
           "phase8_s": since()}
    emit(row)
    if not (drift1 <= 0.5 * drift0 and row["final_cost"] < 1.0
            and vs_ref < 1e-3):
        raise RuntimeError(f"pose graph gates failed: {row}")

    # ---- 8d. TUM files and trajectory scores ------------------------------
    out_dir = tempfile.mkdtemp(prefix="dcreg_tum_")
    try:
        stamps = np.arange(n_timed) * 0.1
        trajs = {"gt": gt[:n_timed], "map_loop": ctx["odom_poses"][:n_timed],
                 "voxel_loop": est}
        back = {}
        for name, poses in trajs.items():
            path = os.path.join(out_dir, f"{name}.tum")
            tum.save_tum(path, stamps, poses)
            ts, back[name] = tum.load_tum(path)
            if not (np.allclose(ts, stamps) and np.abs(
                    back[name] - poses).max() <= 1e-6):
                raise RuntimeError(f"TUM round trip of {name} differs")
        scores = {}
        for name in ("map_loop", "voxel_loop"):
            a = tum.ate(back[name], back["gt"])
            rre, rte = tum.rpe(back[name], back["gt"], delta=1)
            recall, _ = tum.registration_recall(back[name], back["gt"])
            scores[name] = {"ate_rmse_m": a["rmse"], "ate_max_m": a["max"],
                            "rpe_rot_mean_deg": float(rre.mean()),
                            "rpe_trans_mean_m": float(rte.mean()),
                            "recall": recall}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "tum_scores", "frames": n_timed, **scores,
          "phase8_s": since()})
    if not all(v["ate_rmse_m"] < 0.03 and v["recall"] == 1.0
               for v in scores.values()):
        raise RuntimeError(f"trajectory scores failed: {scores}")
    return k2_launches


# --------------------------------------------------------------------------

def run(seed: int, device: str = "cuda"):
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.models.icp_batch import (estimate_map_capacities,
                                                  estimate_num_pairs,
                                                  icp_batch_so3)
    from dcreg_tpu_torch.models.odometry import (
        estimate_odometry_capacities, prepare_frames, run_odometry_map)
    from dcreg_tpu_torch.ops import block_knn as tk
    from dcreg_tpu_torch.ops.block_sparse import (build_block_index,
                                                  build_map_index,
                                                  kd_block_order,
                                                  morton_argsort)
    from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod,
                                                HandlingMethod)
    from dcreg_tpu_torch.utils import precise

    precise()
    DET = DetectionMethod.SCHUR_CONDITION_NUMBER
    HAND = HandlingMethod.PRECONDITIONED_CG
    t0 = time.perf_counter()
    extent = max(60.0, (MAP_POINTS / 1500.0) ** 0.5)
    world = synthetic_map(MAP_POINTS, extent, seed) \
        + np.array([0.0, 0.0, 9.0], np.float32)
    world = world[kd_block_order(world, 128)]
    mindex = build_map_index(world, tb=128, sb=64, device=device)
    world_t = torch.as_tensor(world, device=device)
    T_pre2, T_pre1, gt = trajectory(extent, FRAMES)
    frames, tube = scans(world, gt, SCAN_POINTS,
                         np.random.default_rng(seed + 4))
    frames_s = prepare_frames(frames)
    S, G, P = estimate_odometry_capacities(mindex, frames_s, gt,
                                           R_CULL0 + REUSE_MARGIN,
                                           margin=1.25, slot_margin=1.6,
                                           sup_margin=4)
    # Monte-Carlo batch around frame 0 (map mode)
    nominal = np.array([np.deg2rad(0.1), np.deg2rad(0.1), np.deg2rad(0.3),
                        0.03, 0.05, 0.02])
    pert = nominal[None] * np.random.default_rng(seed - 4).uniform(
        0.9, 1.1, (BATCH, 6))
    R0s = np.stack([gt[0][:3, :3] @ euler(*p[:3]) for p in pert])
    t0s = gt[0][:3, 3][None] + pert[:, 3:]
    S2, G2, P2 = estimate_map_capacities(
        mindex, frames_s[0], list(zip(R0s, t0s)), MC_CULL0 + MC_MARGIN,
        include_identity=False)
    # BlockIndex scene: map points within 8 m of frame 0, source == target
    c0 = gt[0][:3, 3]
    near = tube[np.sum((tube - c0) ** 2, axis=1) < 8.0 ** 2]
    blk = near[np.random.default_rng(seed + 1).choice(
        near.shape[0], BLOCK_POINTS, replace=False)]
    blk = blk[morton_argsort(blk)].astype(np.float32)
    bindex = build_block_index(blk, tb=128, device=device)
    jit = nominal[None] * np.random.default_rng(seed - 7).uniform(
        0.98, 1.02, (BATCH, 6))
    R0b = np.stack([euler(*p[:3]) for p in jit])
    t0b = jit[:, 3:]
    Pb = estimate_num_pairs(bindex, blk, list(zip(R0b, t0b)), 1.0)
    emit({"phase": "setup", "map_points": MAP_POINTS,
          "extent_m": extent, "frames": FRAMES, "scan_points": SCAN_POINTS,
          "odom_caps": [S, G, P], "mc_caps": [S2, G2, P2],
          "block_scene_points": BLOCK_POINTS, "block_num_pairs": Pb,
          "seconds": time.perf_counter() - t0})

    # ---- 1. K1 against its plain twin at the main path's shapes ---------
    # frame 0's constant-velocity seed, as the loop computes it
    T_pred = T_pre1 @ np.linalg.inv(T_pre2) @ T_pre1
    a_inputs = k1_inputs("map", frames_s[0], mindex, T_pred[None, :3, :3],
                         T_pred[None, :3, 3], R_CULL0 + REUSE_MARGIN,
                         {"S": S, "G": G, "P": P}, device)
    rows = {
        "a_map_B1_slotted_nomask": check_k1("a_map_B1_slotted_nomask",
                                            a_inputs),
        "b_map_B128_slotted_mask": check_k1("b_map_B128_slotted_mask",
                                            k1_inputs(
            "map", frames_s[0], mindex, R0s, t0s, MC_CULL0,
            {"S": S2, "G": G2, "P": P2}, device)),
        "c_block_B128_global_mask": check_k1("c_block_B128_global_mask",
                                             k1_inputs(
            "block", blk, bindex, R0b, t0b, 1.0, {"P": Pb}, device)),
        # the loop's own call: the reused list and the live mask at the
        # seed pose, keys at the search radius
        "a_live_map_B1_reuse_mask": check_k1("a_live_map_B1_reuse_mask",
                                             k1_inputs(
            "map_reuse", frames_s[0], mindex, T_pred[None, :3, :3],
            T_pred[None, :3, 3], R_CULL0 + REUSE_MARGIN,
            {"S": S, "G": G, "P": P}, device, live_radius=R_CULL0,
            key_radius=ICPParams().corr.search_radius)),
        "e_map_B33_slotted_mask": check_k1("e_map_B33_slotted_mask",
                                           k1_inputs(
            "map", frames_s[0], mindex, R0s[:33], t0s[:33], MC_CULL0,
            {"S": S2, "G": G2, "P": P2}, device)),
    }
    rows["f_map_B1_long_run"] = check_k1("f_map_B1_long_run",
                                         long_run_inputs(a_inputs, G))

    params = ICPParams()
    launches = {}

    # ---- 2. the localization loop -----------------------------------------
    def run_odom():
        return run_odometry_map(
            frames_s, mindex, world_t, T0=T_pre1, T_prev_init=T_pre2,
            icp_params=params, num_supers=S, max_per_query=G, num_pairs=P,
            initial_cull_radius=R_CULL0, reuse_margin=REUSE_MARGIN,
            device=device)

    _, warm_s = wall(run_odom)
    tk.block_knn_keys.launches = 0
    res, dt = wall(run_odom)
    launches["odometry"] = tk.block_knn_keys.launches
    est = res.poses.cpu().numpy()
    te = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    odom = {"phase": "odometry", "frames": FRAMES,
            "ms_per_frame": dt / FRAMES * 1e3, "warm_run_s": warm_s,
            "iters_per_frame": float(res.iterations.float().mean()),
            "te_mean_m": float(te.mean()), "te_max_m": float(te.max()),
            "converged_frac": float(res.converged.float().mean()),
            "ovf_max": int(res.pair_overflow.max()),
            "k1_launches": launches["odometry"],
            "k1_launches_per_frame": launches["odometry"] / FRAMES}
    emit(odom)
    if not (bool(res.converged.all()) and odom["ovf_max"] == 0
            and te.mean() < 0.05 and te.max() < 0.10):
        raise RuntimeError(f"odometry gates failed: {odom}")
    emit(profile_window("odometry_profile", lambda: run_odometry_map(
        frames_s[:PROFILE_FRAMES], mindex, world_t, T0=T_pre1,
        T_prev_init=T_pre2, icp_params=params, num_supers=S,
        max_per_query=G, num_pairs=P, initial_cull_radius=R_CULL0,
        reuse_margin=REUSE_MARGIN, device=device)))

    # ---- 3. Monte-Carlo batch, map mode, full telemetry ------------------
    def mc():
        return icp_batch_so3(frames_s[0], world_t, R0s, t0s, DET, HAND,
                             params, mindex, P2, T_gt=gt[0], num_supers=S2,
                             max_per_query=G2, initial_cull_radius=MC_CULL0,
                             device=device)

    wall(mc)
    tk.block_knn_keys.launches = 0
    out, dt = wall(mc)
    launches["mc_map"] = tk.block_knn_keys.launches
    last = (out.iterations.long() - 1).clamp(min=0)
    lane = torch.arange(BATCH, device=last.device)
    te = out.log.trans_error[lane, last].cpu().numpy()
    re = out.log.rot_error_deg[lane, last].cpu().numpy()
    row = {"phase": "mc_map", "B": BATCH, "reg_per_s": BATCH / dt,
           "seconds": dt, "iters_mean": float(out.iterations.float().mean()),
           "te_mean_m": float(te.mean()), "re_mean_deg": float(re.mean()),
           "converged_frac": float(out.converged.float().mean()),
           "pair_overflow": int(out.pair_overflow),
           "k1_launches": launches["mc_map"]}
    emit(row)
    if not (bool(out.converged.all()) and row["pair_overflow"] == 0
            and te.mean() < 0.05 and re.mean() < 0.5):
        raise RuntimeError(f"map-mode batch gates failed: {row}")
    emit(profile_window("mc_map_profile", mc))

    # ---- 4. BlockIndex batch, then the same with the plain K1 ------------
    def blk_run(plain=False):
        return icp_batch_so3(blk, blk, R0b, t0b, DET, HAND, params, bindex,
                             Pb, device=device, plain_knn=plain)

    wall(blk_run)
    tk.block_knn_keys.launches = 0
    out, dt = wall(blk_run)
    launches["mc_block"] = tk.block_knn_keys.launches
    ref = blk_run(plain=True)
    last = (out.iterations.long() - 1).clamp(min=0)
    te = out.log.trans_error[lane, last].cpu().numpy()
    same_iters = bool(torch.equal(out.iterations, ref.iterations))
    pose_diff = max(float((out.R - ref.R).abs().max()),
                    float((out.t - ref.t).abs().max()))
    row = {"phase": "mc_block", "B": BATCH, "reg_per_s": BATCH / dt,
           "seconds": dt, "iters_mean": float(out.iterations.float().mean()),
           "te_mean_m": float(te.mean()),
           "converged_frac": float(out.converged.float().mean()),
           "pair_overflow": int(out.pair_overflow),
           "plain_same_iterations": same_iters,
           "plain_pose_max_diff": pose_diff,
           "k1_launches": launches["mc_block"]}
    emit(row)
    if not (bool(out.converged.all()) and row["pair_overflow"] == 0
            and same_iters and pose_diff <= 1e-5):
        raise RuntimeError(f"BlockIndex batch gates failed: {row}")

    # ---- K1's entry of the kernels line (phase 7) -------------------------
    if min(launches.values()) <= 0:
        raise RuntimeError(f"K1 not launched on every path: {launches}")
    a = rows["a_map_B1_slotted_nomask"]
    ctx = {"world": world, "gt": gt, "frames": frames_s, "T_pre1": T_pre1,
           "odom_poses": est.astype(np.float64)}
    return ctx, {
        "name": "K1 block_knn_keys", "route": "cuda",
        "source": "dcreg_tpu_torch/csrc/block_knn.cu",
        "replaces": "dcreg_tpu/ops/pallas_block_knn.py:91",
        "launches": int(sum(launches.values())),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": a["ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "library_ms": None,
        "shapes": {k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "pairs", "B", "nsplit",
                                          "ctas", "run_max")}
                   for k, v in rows.items()}}


def build_kernels():
    """Build every CUDA source at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor
    from dcreg_tpu_torch.ops import block_knn, knn_kernels
    mods = {"block_knn.cu": block_knn, "knn.cu": knn_kernels}
    with ThreadPoolExecutor(len(mods)) as ex:
        futures = {name: ex.submit(m.build_library)
                   for name, m in mods.items()}
        for name, fut in futures.items():
            b = fut.result()
            emit({"phase": "build", "source": name, "seconds": b["seconds"],
                  "library": os.path.relpath(b["path"]),
                  "ptxas": ptxas_summary(b["log"])})


def ptxas_summary(log):
    """Registers, spills and shared memory of each kernel in a ptxas -v
    log."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    build_kernels()
    ctx, k1 = run(args.seed)
    k2, k3 = run_pair(args.seed)
    k2_voxel = run_voxel(args.seed, ctx)
    k2["launches"] += k2_voxel
    k2["launches_by_path"]["voxel_knn_check"] = k2_voxel
    emit({"kernels": [k1, k2, k3]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
