"""Drive the PyTorch/CUDA port (dcreg_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed 7]

Builds the K1 kernel from csrc/ (nvcc, sm_90a), then runs on the card:

  1. K1 against its plain PyTorch twin, keys bit for bit, at the main
     path's three shapes: (a) map mode, B=1, slot-local ids, no mask;
     (b) map mode, B=128, slot-local ids, lane mask; (c) BlockIndex mode,
     B=128, global ids, lane mask;
  2. the localization loop ``run_odometry_map``: 128 frames of 5,000
     points against a synthetic prior map (53M points by default,
     DCREG_SMOKE_MAP_POINTS overrides), gated on every frame converging,
     zero overflow, mean translation error < 5 cm and max < 10 cm;
  3. a B=128 Monte-Carlo batch in MapIndex mode with full telemetry,
     gated on convergence, zero overflow, mean errors < 5 cm / 0.5 deg;
  4. a B=128 BlockIndex-mode batch on a 16,384-point neighbourhood of
     frame 0, gated on convergence and zero overflow, and rerun with
     the plain K1 forced (per-lane iterations equal, poses within 1e-5);
  5. the ``kernels`` line with K1's launches on the paths above.

Every phase prints one JSON object on a line of its own; the last line is
{"ok": true, "device": {...}}.  A failed phase raises, and the script
exits non-zero.  Without a CUDA device it exits non-zero at once.  The
world, trajectory and scans are made from ``--seed`` in numpy.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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


def profile_window(name, fn, top=8):
    """Where the time of one call of ``fn`` goes: wall time, device-busy
    share (sum of kernel times over wall time), the kernels with the most
    device time and the host-side ops with the most self time.  Only
    events that ran on the card count as device time: a host op's own
    device total repeats its kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        _, seconds = wall(fn)
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
    return {"phase": name, "wall_s": seconds, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / seconds,
            "kernel_launches": sum(e.count for e in on_card),
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


def scans(world, gt, n, rng):
    tube_lo = gt[:, :3, 3].min(axis=0) - 9.0
    tube_hi = gt[:, :3, 3].max(axis=0) + 9.0
    tube = world[np.all((world >= tube_lo) & (world <= tube_hi), axis=1)]
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

def k1_inputs(kind, src_xyz, index, Rs, ts, radius, caps, device):
    """The (src_blocks, poses, qid, tid, pid, lane_mask, ib, scale, clamp)
    that iteration 0 of ``icp_batch_so3`` hands to K1."""
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
    if int(ovf) != 0:
        raise RuntimeError(f"K1 inputs ({kind}) overflow the pair list")
    _, _, clamp, scale = tk.key_params(radius, ib)
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


def check_k1(name, a):
    """Keys of K1 and its plain twin on the card, bit for bit; times."""
    from dcreg_tpu_torch.ops import block_knn as tk
    args = [a[k] for k in ("src_blocks", "tgt", "poses", "qid", "tid",
                           "pid", "lane_mask", "index_bits", "scale",
                           "clamp")]
    keys = tk.block_knn_keys(*args)
    ref = tk.block_knn_keys(*args, plain=True)
    mismatches = int((keys != ref).sum())
    max_abs_err = int((keys.long() - ref.long()).abs().max())
    if mismatches:
        raise RuntimeError(f"K1 {name}: {mismatches} keys differ from the "
                           f"plain version (max |diff| {max_abs_err})")
    ms = time_ms(lambda: tk.block_knn_keys(*args), 20)
    plain_ms = time_ms(lambda: tk.block_knn_keys(*args, plain=True), 2)
    row = {"phase": "k1_check", "shape": name,
           "B": int(a["poses"].shape[0]), "nq": int(a["src_blocks"].shape[0]),
           "keys": int(keys.numel()), "mismatches": mismatches,
           "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms}
    row.update(k1_bound(a))
    emit(row)
    return row


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
    rows = {
        "a_map_B1_slotted_nomask": check_k1("a_map_B1_slotted_nomask",
                                            k1_inputs(
            "map", frames_s[0], mindex, T_pred[None, :3, :3],
            T_pred[None, :3, 3], R_CULL0 + REUSE_MARGIN,
            {"S": S, "G": G, "P": P}, device)),
        "b_map_B128_slotted_mask": check_k1("b_map_B128_slotted_mask",
                                            k1_inputs(
            "map", frames_s[0], mindex, R0s, t0s, MC_CULL0,
            {"S": S2, "G": G2, "P": P2}, device)),
        "c_block_B128_global_mask": check_k1("c_block_B128_global_mask",
                                             k1_inputs(
            "block", blk, bindex, R0b, t0b, 1.0, {"P": Pb}, device)),
    }

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

    # ---- 5. kernels ------------------------------------------------------
    if min(launches.values()) <= 0:
        raise RuntimeError(f"K1 not launched on every path: {launches}")
    a = rows["a_map_B1_slotted_nomask"]
    emit({"kernels": [{
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
                                          "bound_by", "pairs", "B")}
                   for k, v in rows.items()}}]})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dcreg_tpu_torch.ops.block_knn import build_library
    build = build_library()
    emit({"phase": "build", "seconds": build["seconds"],
          "library": os.path.relpath(build["path"]),
          "ptxas": build["log"][-600:]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    run(args.seed)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
