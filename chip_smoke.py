"""Drive the PyTorch/CUDA port (dcreg_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py [--seed 7]

Builds every kernel from csrc/ (one nvcc per source, in parallel,
sm_90a), then runs on the card:

  1. K1 against its plain PyTorch twin, keys bit for bit, at the main
     path's shapes: (a) map mode, B=1, slot-local ids, no mask;
     (b) map mode, B=128, slot-local ids, lane mask; (c) BlockIndex mode,
     B=128, global ids, lane mask; (a_live) the localization loop's own
     call: the reused pair list with its live mask; (e) B=33, two mask
     words; (f) B=1 with one query block's run max_per_query long;
     (g) the per-lane mode at the fleet's shape: 8 scans (frames 0, 16,
     ..., 112) each at its own seed, their reused pair lists in one with
     the live mask, as ``run_odometry_fleet`` calls it; each
     row prints the split and CTA count the wrapper launched; and K1
     alone captured in a CUDA graph and replayed, bit for bit, one launch
     counted per replay;
  2. the localization loop ``run_odometry_map``, replayed as CUDA graphs
     (``dcreg_tpu_torch.graphs``; the capture timed apart, in the warm
     run): 128 frames of 5,000 points against a synthetic prior map (53M
     points by default, DCREG_SMOKE_MAP_POINTS overrides), gated on every
     frame converging, zero overflow, mean translation error < 5 cm and
     max < 10 cm; the first 16 frames eagerly (graph=False) and graphed
     in alternating order over three rounds: equal iterations, poses
     within 1e-6 m and 1e-6 rad, bit-equality and peak memory reported;
     a stale-cache check (a second map index over the map shifted by
     +1 m in x, the same shapes: frame 0 must come out shifted by 1 m,
     and the first index must replay its own graphs bit for bit); the
     kernel pcg6 (``solve_pcg_fast``) against its plain twin on the
     systems of the first eager 16-frame pass, each as launched
     (``pcg6_check`` B1_map_pass: the same branch per system, x
     bit-equal where Cholesky answers, the gates of ``pcg6_gates`` where
     PCG does, times and bound, and the share of systems that took
     PCG); the kernel plane_fit (``soa_tail._plane_fit``) launched once
     per ICP iteration of the 128 frames, each launch from a replay, and
     against its plain twin on the first eager iteration as launched
     (``plane_fit_check`` B1_map_first_iteration: every output
     bit-equal, times and bound); the 128 frames again eagerly with every
     plane fit through the twin (``odometry_plane_fit_vs_twin``: equal
     iterations, poses within 1e-6 m and 1e-6 rad, bit-equality
     reported); the kernel schur6 (``degeneracy.analyze(fast=True)``)
     launched once per ICP iteration and once per frame's epilogue of the
     128 frames, each launch from a replay, and against its plain twin on
     every analysis of the first eager 16-frame pass as launched
     (``schur6_check`` B1_map_pass: flags equal, every field bit-equal,
     times and bound); the 128 frames again eagerly with every analysis
     through schur6's twin (``odometry_schur6_vs_twin``: equal iterations
     and bit-equal poses and frame analyses); the fleet's first tick (8
     robots at frames 0, 16, ..., 112), graphed with one plane_fit launch
     per step and one schur6 launch per step and for the epilogue, and
     eagerly (``plane_fit_check`` and ``schur6_check``
     B8_fleet_first_tick); the mixed fleet's first tick at its
     benchmark cell's shape (``run_mixed_tick``: 32 robots at frames 0,
     4, ..., 124, each scan a kd-sorted random subset of its frame of
     1,000-2,000 or 3,000-5,000 points padded to 5,000, ``counts``):
     graphed with one K1, plane_fit and pcg6 launch per step and one
     schur6 launch per step and for the epilogue, each from a replay,
     and eagerly (equal iterations, poses within 1e-6 m and 1e-6 rad),
     K1 against its twin on the first step's inputs as launched
     (``k1_check`` g_mix32_ragged_reuse_mask), plane_fit, schur6 and
     pcg6 against theirs (B32_mix_first_tick); the
     8-frame profile window graphed (under 50 kernel-launch calls per
     ICP iteration, the rest by ``cudaGraphLaunch``) and eager;
  3. a B=128 Monte-Carlo batch in MapIndex mode with full telemetry,
     graphed, gated on convergence, zero overflow, mean errors < 5 cm /
     0.5 deg, and rerun eagerly (per-lane iterations equal, poses within
     1e-5), pcg6 against its plain twin on that rerun's systems as
     launched (``pcg6_check`` B128_mc_map), plane_fit on its first
     iteration (``plane_fit_check`` B128_mc_frame), schur6 on its
     analyses (``schur6_check`` B128_mc_map);
  4. a B=128 BlockIndex-mode batch on a 16,384-point neighbourhood of
     frame 0, graphed, gated on convergence and zero overflow, rerun
     eagerly and eagerly on K1's twin route (``K1.through_the_twin``;
     each: per-lane iterations equal, poses within 1e-5);
  5. K2 and K3 against their plain twins, bit for bit, at (d) the 5-NN
     self query of the 8,192-point cylinder, (e) its nn1, (f) 65,536
     points with 30% of the targets invalid, where ``knn_grouped`` must
     also return what ``knn`` returns, (g) 333 queries against 1,000
     targets, 30% invalid, (h) the O3D engine's normal search (self
     query, k 30, kk 60) and (i) kk 128 (the moved cylinder against
     itself), and (j) (g)'s shapes at kk 128; each row prints the grids
     the wrappers launched and the library pairs' times (K2: cdist +
     topk; K3: cdist + amin over the 128-target groups); and K2 alone
     captured in a CUDA graph and replayed at (d), (e) and (h), bit for
     bit, one launch counted per replay;
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
     iteration 10 of any other); every row as CUDA graph replays (the
     warm-up call captures), K2 counted from replays on every XICP, O3D
     and SuperLoc row that searches with it; every row of every matrix
     rerun eagerly (``TestRunner(graph=False)``) on each backend: equal
     iterations, poses within 1e-6 m and 1e-6 rad, SuperLoc's record
     fields equal, the SO(3) and Euler rows bit-equal (the others'
     bit-equality reported); one Ours, XICP, XICP-EQ and O3D run each
     under the profiler (the host's launch calls per ICP iteration
     printed; under one for XICP-EQ and O3D);
  7. the ``kernels`` line: K1, K2, K3, pcg6, plane_fit and schur6 with
     their launches on each path (K2's including (8b) and (9c), and those
     of them from graph replays; K1's (10a) and (10b)), times, bounds and
     library times; printed after phase 10;
  8. on phase 2's world, trajectory and scans: (8a) the voxel map index
     (``build_voxel_grid`` over the whole map on the card) and the voxel
     odometry loop ``run_odometry`` over the 128 frames from the pose
     before frame 0, f32, voxel edge = search radius, the voxel capacity
     from the largest occupancy around the trajectory, replayed as CUDA
     graphs (the capture timed in the warm run); gated on every frame
     converging, mean translation error < 5 cm, max < 10 cm and every
     position within 3 cm of phase 2's; its first 16 frames eagerly and
     graphed in alternating order over three rounds (equal iterations,
     poses within 1e-6 m and 1e-6 rad); a graphed profile window of 2
     frames (under 50 kernel-launch calls per ICP trip); (8b)
     ``voxel_knn`` against K2 (``knn``) for frame 0 at its
     GT pose: for every query whose 5th distance is within the search
     radius the same neighbours (but for exact ties) at distances
     within 2 ulp; (8c) ``optimize_pose_graph`` on a 128-pose window of
     the ground truth (noisy odometry edges, one exact closure) in f32
     on the card, graphed and eagerly in alternating order over three
     rounds (ms per solve of each), gated on equal GN steps and
     bit-equal poses and cost, the last pose's drift falling at least
     2x, a final cost < 1 and poses within 1 mm of the same graph in f64
     on the CPU; (8d) the ground truth and both loops' trajectories through
     TUM files and back (within 1e-6), gated on ATE RMSE < 3 cm and
     registration recall 1;
  9. the scale-out and the native runtime: (9a) ``sharded_icp_register``
     in a one-rank NCCL world, mesh 1 x 1, on 16 of phase 2's scans
     seeded as phase 2 seeds them, against the whole map in its kd-leaf
     order (128-point blocks), with the two-level and the flat cull,
     caps 1.5x the largest relevance counts, as CUDA graph replays with
     both collectives captured and eagerly, in alternating order over
     three rounds per cull; gated on equal iterations and bit-equal
     poses between the two, zero overflow, every frame converged,
     translation error mean < 5 cm, max < 10 cm and every position
     within 3 cm of phase 2's; ms per registration of both modes,
     iterations, kernels and launch calls per ICP iteration from a
     2-frame graphed profile, peak device memory; (9b) four rank
     processes of this script, on the one card over gloo (NCCL takes one
     rank per GPU; on a machine with four cards, one rank per card over
     NCCL; each rank prints whether it replayed graphs: eagerly over
     gloo): a 2 x 2 mesh, dense
     (4,096 map points, 512 scan points) and culled (the map within 30 m
     of frame 0, frame 0's scan), the host mesh with LOCAL_WORLD_SIZE=2
     and ``assemble_sharded`` of phase 8c's window over data = 2; gated
     on bit-equal ranks, host rows [[0, 0], [1, 1]], poses within 1e-4 m
     and 1e-3 deg of the 1 x 1 mesh with equal iterations, and H, g and
     the cost within 1e-5 relative of the unsharded assembly; (9c) the
     native runtime: its g++ build, a PCD written and read back byte for
     byte, the KD-tree over phase 8b's tube as K2's exact oracle (equal
     ids but at ties, within 1 ulp) and voxel downsampling against a
     numpy centroid per voxel (hash merges counted);
 10. the evaluation entry points: (10a) the degenerate-corridor
     experiment through ``dcreg_tpu_torch.scripts.run_corridor_experiment``
     (108,318 map points, 45 frames of 1,500 points, the six methods of
     its METHODS, f32), gated on its reference envelope (DCReg raw ATE
     < 10 cm and recall > 0.95; ME-SR, ME-TReg and FCN-SR above 10x
     DCReg's), zero overflow for DCReg, ME-TSVD and NONE, DCReg 45/45
     and NONE 0/45 frames degenerate, the raw ATE of DCReg, ME-TSVD and
     NONE within 0.5 cm of results/corridor_experiment's and DCReg's
     poses within 1e-4 m of NONE's; K1 held bit for bit against its
     plain twin at the corridor loop's own call (frame 0's reused pair
     list and live mask, the corridor's capacities and radii); K1's
     launches per method, and two DCReg and two ME-TSVD frames under
     the profiler; pcg6 against its plain twin on DCReg's systems,
     recorded from an eager pass (``pcg6_check``: each as launched, B = 1,
     and the first 128 stacked; all degenerate, so they take PCG: every
     stop legitimate, converged answers within float32 rounding, the
     residuals those of the answers, P to 1e-6); schur6 against its twin
     on the same pass's analyses (``schur6_check`` B1_corridor and
     B128_corridor, the first 128 stacked) and DCReg's frames eagerly
     through schur6's twin (``corridor_schur6_vs_twin``: equal iterations
     per frame, poses within 1e-6 m and 1e-6 rad); (10b) bench.py's
     map-scale baseline rows ME-TSVD, ME-TReg and FCN-SR through
     ``run_odometry_map`` on phase 2's map, capacities and first 16
     frames: finite poses for all three; for ME-TSVD and ME-TReg zero
     overflow, no degenerate frame, every frame converged, mean
     translation error < 5 cm and max < 10 cm; for FCN-SR, which drifts
     by design, no pair dropped from any frame's list (its reuse-guard
     breaches are counted) and its error beside the JAX package's
     recorded row.

Every registration of phases 2, 3, 4, 6, 8a, 9a, 10a and 10b, and the
pose graph of 8c, runs as CUDA graph replays; the ``graphs`` line counts
the captures and their seconds.

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
                "knn_candidates_kernel", "group_min_kernel", "pcg6_kernel",
                "plane_fit_kernel", "schur6_kernel", "loop_cond_kernel")


def _counted():
    from dcreg_tpu_torch.ops import block_knn, loop_cond, soa_tail
    return (block_knn.K1, soa_tail.PLANE_FIT, loop_cond.LOOP_COND)


# the kernels launched once per step of the map loop, whose counters a
# profile holds against the kernels it saw (by label: the CUDA kernel)
COUNTED_NAMES = {"K1": "block_knn_keys_kernel",
                 "plane_fit": "plane_fit_kernel",
                 "loop_cond": "loop_cond_kernel"}


# the pair engines whose pass graph holds more than graphs.PASS_OPS device
# ops at the harness's cap of 30 (a step of about 12,900 ops), so each
# pass runs on the host (graphs.host_pass); O3D's (3,761) fits
ON_THE_HOST = ("XICP", "XICP-EQ")


# host calls of the CUDA runtime that launch work: kernels one by one, or
# a captured graph at once
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaGraphLaunch")


class Tally:
    """The launches each of the port's kernels (``cuda_build.Kernel``)
    made since the tally was taken: deltas of their counters."""

    def __init__(self):
        from dcreg_tpu_torch.cuda_build import kernels
        self.at = {k: (k.launches, k.launches_replayed,
                       dict(k.launches_by_kk)) for k in kernels()}

    def launches(self, kernel) -> int:
        return kernel.launches - self.at[kernel][0]

    def replayed(self, kernel) -> int:
        """Those of them made by graph replays."""
        return kernel.launches_replayed - self.at[kernel][1]

    def by_kk(self, kernel) -> dict:
        at = self.at[kernel][2]
        return {kk: n - at.get(kk, 0)
                for kk, n in sorted(kernel.launches_by_kk.items())
                if n > at.get(kk, 0)}


class Passes:
    """The graph launches, passes on the card and host reads of a loop's
    flag (``graphs.STATS``) since it was taken."""

    def __init__(self):
        from dcreg_tpu_torch import graphs
        st = graphs.STATS
        self.at = (st.replays, st.device_passes, st.host_reads)

    def since(self) -> dict:
        from dcreg_tpu_torch import graphs
        st = graphs.STATS
        now = (st.replays, st.device_passes, st.host_reads)
        return dict(zip(("graph_launches", "device_passes", "host_reads"),
                        (b - a for a, b in zip(self.at, now))))


def pass_gates(what, passes, tally, n_passes, steps, device="cuda"):
    """Gate a graphed run of ``n_passes`` passes that ran ``steps`` steps
    (``passes``: a ``Passes``, ``tally``: a ``Tally``, both taken before
    it): one graph launch and no host read of the loop's flag per pass,
    and one launch of the condition kernel per step, each from a replay
    (on the card; on the CPU the loop runs on the host).  Returns the
    row."""
    from dcreg_tpu_torch.ops.loop_cond import LOOP_COND
    row = dict(passes.since(), passes=n_passes, steps=steps,
               loop_cond_launches=tally.launches(LOOP_COND),
               loop_cond_replayed=tally.replayed(LOOP_COND))
    if device != "cpu" and not (
            row["graph_launches"] == row["device_passes"] == n_passes
            and row["host_reads"] == 0
            and row["loop_cond_launches"] == row["loop_cond_replayed"]
            == steps):
        raise RuntimeError(f"{what}: not one graph launch and no host read "
                           f"per pass, one condition launch per step: {row}")
    return row


def profile_window(name, fn, top=8):
    """Where the time of one call of ``fn`` goes: wall time, device-busy
    share (sum of kernel times over wall time), the port's own kernels,
    the kernels with the most device time and the host-side ops with the
    most self time, the CUDA kernels K1's wrapper ran per call, counted
    by the profiler, K2's wrapper calls per kk, the launches the counters
    of K1, plane_fit and loop_cond add up (``counted_launches``, by label;
    a pass's steps count at ``graphs.settle``), and the host's launch
    calls (``LAUNCH_CALLS``: count and self ms).  Only
    events that ran on the card count as device time: a host op's own
    device total repeats its kernels' time; the profiler records the
    kernels of a graph replay one by one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from dcreg_tpu_torch.ops import block_knn as tk
    from dcreg_tpu_torch.ops import knn_kernels as kn
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    tally = Tally()
    with profile(activities=acts) as prof:
        _, seconds = wall(fn)
    k1_calls = tally.launches(tk.K1)
    k2_calls = tally.by_kk(kn.K2)
    counted = {k.label: tally.launches(k) for k in _counted()}
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
            "counted_launches": counted,
            "k1_cuda_kernels_per_call": (k1_kernels / k1_calls
                                         if k1_calls else None),
            "host_launch_calls": {
                e.key: {"count": e.count, "ms": e.self_cpu_time_total / 1e3}
                for e in on_host if e.key in LAUNCH_CALLS},
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


FLEET_SENSORS, FLEET_SPACING = 8, 16


def k1_fleet_inputs(frames_s, index, Rs, ts, caps, device):
    """The inputs of K1's per-lane mode at a fleet tick's first step: the
    lanes' scans (L, N, 3) at their seeds (Rs, ts), each lane's pair list
    culled at R_CULL0 + REUSE_MARGIN in a capacity of its own, in one
    list with the live mask at R_CULL0, keys at the search radius: what
    ``run_odometry_fleet``'s step hands K1."""
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.ops import block_knn as tk
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    src, Rs, ts = f32(frames_s), f32(Rs), f32(ts)
    L, N = src.shape[:2]
    nq = -(-N // tk.QB)
    src_q = torch.cat([src, src[:, -1:].expand(L, nq * tk.QB - N, 3)],
                      1).reshape(L, nq, tk.QB, 3)
    qlo, qhi = (x.reshape(L * nq, 3) for x in tk.exact_qbox(src_q, Rs, ts))
    qbox = (qlo[None], qhi[None])
    sel, ok, sovf = tk.super_candidates(None, None, None, None, index,
                                        R_CULL0 + REUSE_MARGIN, caps["S"],
                                        qbox=qbox, lanes=L)
    rel_l, bids = tk.hier_relevance(None, None, None, None, index, sel, ok,
                                    R_CULL0 + REUSE_MARGIN, qbox=qbox)
    bi = index.block
    qid, tid, slot, _, _, ovf, rovf = tk.make_pair_list_slotted(
        rel_l[0], caps["P"], caps["G"], block_ids=bids, nbt=bi.num_blocks,
        lanes=L)
    if int((ovf + rovf + sovf).sum()) != 0:
        raise RuntimeError("K1 fleet inputs overflow the pair lists")
    pad = qid >= L * nq
    t_safe = torch.where(pad, 0, tid).long()
    q_safe = torch.where(pad, 0, qid).long()
    gap = torch.clamp(torch.maximum(qlo[q_safe] - bi.hi[t_safe],
                                    bi.lo[t_safe] - qhi[q_safe]), min=0.0)
    live = ((gap * gap).sum(-1) <= R_CULL0 ** 2) & ~pad
    ib = tk._index_bits(caps["G"] * tk.TB)
    _, _, clamp, scale = tk.key_params(ICPParams().corr.search_radius, ib)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return dict(src_blocks=src_q.reshape(L * nq, tk.QB, 3).transpose(
                    1, 2).contiguous(),
                tgt=bi.blocks,
                poses=torch.cat([Rs.reshape(L, 9), ts], 1).contiguous(),
                qid=i32(qid), tid=i32(tid), pid=i32(slot),
                lane_mask=i32(live[:, None]), index_bits=ib, scale=scale,
                clamp=clamp, nq_lane=nq)


# the mixed fleet of the benchmark's ``fleet32mix`` configuration: 32
# robots 4 frames apart, robot r sparse (1,000-2,000 points a frame) where
# r % 4 is 0, else dense (3,000-5,000), in scans of capacity SCAN_POINTS
MIX_SENSORS, MIX_SPACING, MIX_SPARSE_EVERY = 32, 4, 4
MIX_SPARSE, MIX_DENSE = (1000, 2000), (3000, 5000)


def mixed_fleet_inputs(frames_s, known, mindex, seed):
    """The mixed fleet's first tick: (scans (32, N, 3), counts (32,),
    frames, capacities).  Each robot's count is drawn uniformly in its
    class's range, its scan is a random subset of that many of its
    frame's points, kd-block-sorted, then zero pads; the capacities cover
    every lane's own scan at its pose, the one before and the
    constant-velocity prediction."""
    from dcreg_tpu_torch.models.odometry import estimate_odometry_capacities
    from dcreg_tpu_torch.ops.block_sparse import kd_block_order
    rng = np.random.default_rng(seed + 22)
    F, N = frames_s.shape[:2]
    lanes = [min(MIX_SPACING * r, F - 1) for r in range(MIX_SENSORS)]
    scans_p = np.zeros((MIX_SENSORS, N, 3), np.float32)
    counts = np.zeros(MIX_SENSORS, np.int64)
    caps = np.zeros(3, np.int64)
    for r, f in enumerate(lanes):
        lo, hi = MIX_SPARSE if r % MIX_SPARSE_EVERY == 0 else MIX_DENSE
        n = int(rng.integers(lo, hi + 1))
        sub = frames_s[f][np.sort(rng.choice(N, n, replace=False))]
        scans_p[r, :n] = sub[kd_block_order(sub, 128)]
        counts[r] = n
        caps = np.maximum(caps, estimate_odometry_capacities(
            mindex, np.repeat(scans_p[r:r + 1, :n], 3, 0), known[f:f + 3],
            R_CULL0 + REUSE_MARGIN, margin=1.25, slot_margin=1.6,
            sup_margin=4))
    return scans_p, counts, lanes, tuple(int(c) for c in caps)


def k1_bound(a):
    """Least time for the work of one K1 call on this data: the larger of
    bytes moved (each input read once, each output written once) over the
    memory rate, and f32 operations (10 per candidate: 3 sub, 3 mul,
    2 add, 1 min, 1 scale) over the f32 rate.  Only live (pair, lane)
    combinations and the target blocks they touch count."""
    nq, B = a["src_blocks"].shape[0], a["poses"].shape[0]
    if a.get("nq_lane"):
        B = 1                  # the per-lane mode: one lane per block
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
    mode = {"nq_lane": a.get("nq_lane", 0)}
    keys = tk.block_knn_keys(*args, **mode)
    grid = tk.K1.last_grid or {"nsplit": None, "ctas": None}
    ref = tk.block_knn_keys_plain(*args, **mode)
    mismatches = int((keys != ref).sum())
    max_abs_err = int((keys.long() - ref.long()).abs().max())
    if mismatches:
        raise RuntimeError(f"K1 {name}: {mismatches} keys differ from the "
                           f"plain version (max |diff| {max_abs_err})")
    ms = time_ms(lambda: tk.block_knn_keys(*args, **mode), 20)
    plain_ms = time_ms(lambda: tk.block_knn_keys_plain(*args, **mode), 2)
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


def check_k1_graph(name, a):
    """K1 alone captured in a CUDA graph and replayed (``graphs.Graphs``):
    keys bit for bit against the plain twin, and one launch counted per
    replay.  The kernel's library links its own static CUDA runtime; this
    shows its launches into PyTorch's capturing stream are captured."""
    from dcreg_tpu_torch import graphs
    from dcreg_tpu_torch.ops import block_knn as tk
    args = [a[k] for k in ("src_blocks", "tgt", "poses", "qid", "tid",
                           "pid", "lane_mask", "index_bits", "scale",
                           "clamp")]
    state = graphs.State()
    g = graphs.Graphs(f"K1 {name}", state, {
        "k1": lambda: state.put("keys", tk.block_knn_keys(*args))},
        args[0].device)
    state.keys.fill_(0)
    tally = Tally()
    g("k1")
    torch.cuda.synchronize()
    counted = tally.launches(tk.K1)
    ref = tk.block_knn_keys_plain(*args)
    row = {"phase": "k1_graph_check", "shape": name,
           "keys": int(ref.numel()),
           "mismatches": int((state.keys != ref).sum()),
           "launches_per_replay": counted, "capture_s": g.seconds}
    emit(row)
    if row["mismatches"] or counted != 1:
        raise RuntimeError(f"K1 in a CUDA graph failed: {row}")


# bytes one system moves through pcg6 in float32, and its float operations
# (dcreg_tpu_torch/csrc/pcg6.cu's note): the preconditioner 122, the
# Cholesky solve 169, and where PCG runs 91 to start and 204 per trip
PCG6_BYTES = 590
PCG6_OPS = (122 + 169, 91, 204)
EPS32 = float(torch.finfo(torch.float32).eps)
# where the twin converged, the relative distance of pcg6's PCG answer
# from the twin's stays under 16 eps kappa(H) (256 eps kappa where H is
# indefinite), within these ends; the worst seen between the two, on
# map-like ground-only systems (kappa about 3e4), is 4.5e-4
PCG6_X_TOL = (1e-5, 1e-3)
# a PCG answer's residual |g - H x| and the residual its recursion
# reports part by float32 rounding, within this many eps of
# |g| + |H| |x| (the twin's own worst, on indefinite systems: 710)
PCG6_RESIDUAL_DRIFT = 1024
# float32 rounding moves the stop of some PCG systems by a trip or a few
# (about 6% of the battery's, 16% of the corridor's), a wrong count that
# of every one: at most this share of a row's PCG systems may differ
PCG6_ITERATIONS_DIFFER_SHARE = 0.5


def pcg6_bound(iterations):
    """Least time for pcg6's work on these systems: the larger of their
    bytes over the memory rate and their operations (the trips each
    system ran) over the f32 rate."""
    it = iterations.reshape(-1).long()
    ops = int((PCG6_OPS[0] + torch.where(
        it >= 0, PCG6_OPS[1] + PCG6_OPS[2] * it, 0)).sum())
    nbytes = PCG6_BYTES * it.numel()
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops}


def pcg6_x_tolerance(H):
    """Per system, the relative distance two float32 PCG solves of H that
    sum in different orders may keep: a float32 solve's forward error
    grows with the condition number, 16 eps kappa(H) (kappa over the
    eigenvalues' magnitudes above 1e-6 of the largest, in float64); 256
    eps kappa where H is indefinite, since CG's steps then divide by
    curvatures p.Hp that can pass near zero; within PCG6_X_TOL.  A zero H
    (a lane with no valid pair, whose answer is 0) takes kappa 1."""
    w = torch.linalg.eigvalsh(torch.nan_to_num(H.double()))
    indefinite = (w < 0).any(-1)
    w = w.abs()
    top = w.amax(-1, keepdim=True)
    low = torch.where(w > 1e-6 * top, w, top).amin(-1)
    kappa = torch.where(low > 0, top[..., 0] / low, 1.0)
    factor = torch.where(indefinite, 256.0, 16.0)
    return torch.clamp(factor * EPS32 * kappa, *PCG6_X_TOL)


def pcg6_gates(H, g, out, twin, thresholds):
    """pcg6's answer ``out`` = (x, SolveInfo) against its plain twin's
    ``twin`` on the same systems: a row of measures, with ``failed``, the
    gates that do not hold.  Gates: the same branch per system; x
    bit-equal where Cholesky answers; x's and the residual's NaN where the
    twin's are; every PCG stop legitimate (1 to the cap's trips, ending
    under the threshold, at the cap or at the twin's count); x of every
    system the twin converged within ``pcg6_x_tolerance`` of the twin's;
    the residual every PCG system reports, the cap's included, that of
    its answer (PCG6_RESIDUAL_DRIFT); P within 1e-6 of its largest entry;
    W and cond as the twin's."""
    (x, info), (x_t, info_t) = out, twin
    H, g = H.reshape(-1, 6, 6), g.reshape(-1, 6)
    x, x_t = x.reshape(-1, 6), x_t.reshape(-1, 6)
    it = info.pcg_iterations.reshape(-1)
    it_t = info_t.pcg_iterations.reshape(-1)
    res = info.pcg_residual.reshape(-1)
    res_t = info_t.pcg_residual.reshape(-1)
    use, cap = it_t >= 0, thresholds.pcg_max_iter
    thresh = thresholds.pcg_tolerance * torch.linalg.norm(
        g, dim=-1).clamp(min=1e-30) * (1.0 + 1e-5)
    stop_ok = (it >= 1) & (it <= cap) & (
        (res <= thresh) | (it == cap) | (it == it_t))
    fin = use & torch.isfinite(x_t).all(-1) & torch.isfinite(res_t)
    conv = fin & (res_t <= thresh)
    dist = ((x - x_t).abs().amax(-1)
            / x_t.abs().amax(-1).clamp(min=1e-30)).double()
    x_over = (dist[conv] / pcg6_x_tolerance(H[conv]) if conv.any()
              else dist[:0])
    r_over = dist[:0]
    if fin.any():
        Hd, xd, gd = H[fin].double(), x[fin].double(), g[fin].double()
        true = torch.linalg.norm(gd - (Hd @ xd[..., None])[..., 0], dim=-1)
        drift = PCG6_RESIDUAL_DRIFT * EPS32 * (
            torch.linalg.norm(gd, dim=-1) + torch.linalg.matrix_norm(
                Hd, ord=2) * torch.linalg.norm(xd, dim=-1))
        off = (true - res[fin].double()).abs()
        # a zero system (g = 0, H x = 0) drifts by nothing: only 0 passes
        r_over = torch.where(drift > 0, off / drift,
                             torch.where(off > 0, float("inf"), 0.0))
    P = info.P_preconditioner.reshape(-1, 36)
    P_t = info_t.P_preconditioner.reshape(-1, 36)
    p_rel = ((P - P_t).abs().amax(-1)
             / P_t.abs().amax(-1).clamp(min=1e-30))
    worst = lambda t: float(t.max()) if t.numel() else 0.0
    row = {"systems": int(x.shape[0]), "pcg_systems": int(use.sum()),
           "pcg_converged": int(conv.sum()),
           "pcg_at_cap": int((use & (it == cap)).sum()),
           "pcg_iterations_differ": int((it != it_t)[use].sum()),
           "pcg_max_rel": worst(dist[conv]),
           "x_over_tolerance": worst(x_over),
           "residual_over_drift": worst(r_over),
           "P_max_rel": worst(p_rel)}
    gates = {
        "branch": torch.equal(it >= 0, use),
        "cholesky_x": bit_equal([x[~use]], [x_t[~use]]),
        "nan": (torch.equal(x.isnan(), x_t.isnan())
                      and torch.equal(res.isnan(), res_t.isnan())),
        "stops": bool(stop_ok[use].all()),
        "pcg_x": row["x_over_tolerance"] <= 1.0,
        "residual": row["residual_over_drift"] <= 1.0,
        "P": bool((p_rel <= 1e-6).all()),
        "W_cond": bit_equal([info.W_adaptive, info.cond_PH],
                            [info_t.W_adaptive, info_t.cond_PH])}
    row["failed"] = [k for k, ok in gates.items() if not ok]
    return row


def pcg6_overall(row):
    """pcg6's gates over all the calls of a check: at most
    PCG6_ITERATIONS_DIFFER_SHARE of their PCG systems stop on another trip
    than the twin's.  Adds the share of systems that took PCG."""
    if row["pcg_iterations_differ"] > \
            PCG6_ITERATIONS_DIFFER_SHARE * row["pcg_systems"]:
        row["failed"].append("iterations_differ")
    row["pcg_share"] = row["pcg_systems"] / row["systems"]


def pcg6_timed(ops, out):
    """The timed call's batch, its first PCG trips and its bound."""
    it = out[1].pcg_iterations
    return {"batch": list(ops[0].shape[:-2]),
            "timed_pcg_trips": it.reshape(-1).tolist()[:8],
            **pcg6_bound(it)}


def stacked_solves(calls):
    """One call of the given B = 1 calls stacked (the first's
    thresholds)."""
    from dcreg_tpu_torch.ops.degeneracy import DegeneracyAnalysis
    return (torch.cat([c[0] for c in calls]), torch.cat([c[1] for c in calls]),
            DegeneracyAnalysis(*[torch.cat(f) for f in zip(
                *[c[2] for c in calls])]), calls[0][3])


# the outputs of plane_fit and of its plain twin, in their order
PLANE_FIT_OUTPUTS = ("nox", "noy", "noz", "d_off", "fit_ok", "plane_ok")


def plane_fit_bound(B, k, N):
    """Least time for plane_fit's work on B lanes of N points with k
    neighbours each (dcreg_tpu_torch/csrc/plane_fit.cu's note): the larger
    of its bytes (16 k + 18 a point) over the memory rate and its float
    operations (25 k + 330 a point) over the f32 rate."""
    points = B * N
    nbytes = (16 * k + 18) * points
    ops = (25 * k + 330) * points
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops}


def plane_fit_gates(out, twin):
    """plane_fit's answer ``out`` (nox, noy, noz, d_off, fit_ok, plane_ok)
    against its plain twin's ``twin`` on the same neighbourhoods: a row of
    measures, with ``failed``, the outputs that differ.  Gates: fit_ok and
    plane_ok equal; nox, noy, noz and d_off bit-equal (the same bits, so a
    zero's sign too), NaN where the twin's are.  No tolerance: the kernel
    repeats the twin's float32 operations one for one in the twin's order
    on the card (csrc/plane_fit.cu's note), so any difference is a fault.
    Each point that differs is counted per output (``differ``), and the
    first 8 of each printed with both values (``shown``)."""
    row = {"points": int(twin[0].numel()),
           "fit_ok": int(twin[4].sum()), "plane_ok": int(twin[5].sum()),
           "differ": {}, "shown": {}, "failed": []}
    for name, a, b in zip(PLANE_FIT_OUTPUTS, out, twin):
        a, b = a.reshape(-1), b.reshape(-1)
        if a.dtype.is_floating_point:
            nan_a, nan_b = a.isnan(), b.isnan()
            bad = (nan_a != nan_b) | (~nan_a & (
                a.view(torch.int32) != b.view(torch.int32)))
        else:
            bad = a != b
        n = int(bad.sum())
        row["differ"][name] = n
        if n:
            row["failed"].append(name)
            at = bad.nonzero()[:8, 0].tolist()
            row["shown"][name] = [[i, float(a[i]), float(b[i])] for i in at]
    return row


def plane_fit_timed(ops, out):
    """The timed call's shapes, the ids' layout and its bound."""
    B, k, N = ops[1].shape
    return {"batch": B, "k": k, "points_per_lane": N,
            "idx_contiguous": ops[1].is_contiguous(),
            **plane_fit_bound(B, k, N)}


# per system (dcreg_tpu_torch/csrc/schur6.cu's note): H read, 85 floats and
# 8 flags written; float operations
SCHUR6_BYTES = 144 + 4 * 85 + 8
SCHUR6_OPS = 920


def schur6_bound(nb):
    """Least time for schur6's work on nb systems: the larger of their
    bytes over the memory rate and their float operations over the f32
    rate."""
    nbytes, ops = SCHUR6_BYTES * nb, SCHUR6_OPS * nb
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bytes": nbytes, "ops": ops}


def schur6_gates(out, twin):
    """schur6's analysis ``out`` against its plain twin's ``twin`` of the
    same systems: a row of measures, with ``failed``, the fields that
    differ.  Gates: every field in the twin's shape and dtype;
    schur_valid, is_degenerate and degenerate_mask equal; every float
    field bit-equal (the same bits, so a zero's sign too), NaN where the
    twin's are.  No tolerance: the kernel repeats the twin's float32
    operations one for one in the order ATen's kernels take on the card
    (csrc/schur6.cu's note), so any difference is a fault.  Each system
    that differs is counted per field (``differ``), and the first 8 of
    each printed with both values (``shown``)."""
    n = twin.schur_valid.numel()
    row = {"systems": n, "schur_valid": int(twin.schur_valid.sum()),
           "degenerate": int(twin.is_degenerate.sum()),
           "differ": {}, "shown": {}, "failed": []}
    for name, b in zip(twin._fields, twin):
        a = getattr(out, name)
        if a.shape != b.shape or a.dtype != b.dtype:
            row["differ"][name] = n
            row["failed"].append(name)
            row["shown"][name] = [[-1, str(a.shape), str(b.shape)]]
            continue
        a, b = a.reshape(n, -1), b.reshape(n, -1)
        if a.dtype.is_floating_point:
            nan_a, nan_b = a.isnan(), b.isnan()
            bad = (nan_a != nan_b) | (~nan_a & (
                a.view(torch.int32) != b.view(torch.int32)))
        else:
            bad = a != b
        at = bad.any(-1).nonzero()[:, 0]
        row["differ"][name] = int(at.numel())
        if at.numel():
            row["failed"].append(name)
            row["shown"][name] = [[i, a[i].tolist(), b[i].tolist()]
                                  for i in at[:8].tolist()]
    return row


def schur6_timed(ops, out):
    """The timed call's batch and its bound."""
    batch = list(ops[0].shape[:-2])
    return {"batch": batch, **schur6_bound(int(np.prod(batch)))}


def same_layout_copy(t):
    """A copy of ``t`` over a copy of its whole storage, with its shape,
    strides and offset: the kernel reads it as it read ``t``."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage().clone(), t.storage_offset(), t.shape, t.stride())


# --------------------------------------------------------------------------
# the hand-written kernels against their plain twins inside the program
# --------------------------------------------------------------------------

# what ``check_kernel`` holds each kernel to: its gates on one call (the
# operands, the kernel's answer, the twin's), the fields of the timed call
# (its bound among them), and its gates over all the calls together
CHECKS = {
    "pcg6": (lambda ops, out, twin: pcg6_gates(ops[0], ops[1], out, twin,
                                               ops[3]),
             pcg6_timed, pcg6_overall),
    "plane_fit": (lambda ops, out, twin: plane_fit_gates(out, twin),
                  plane_fit_timed, None),
    "schur6": (lambda ops, out, twin: schur6_gates(out, twin),
               schur6_timed, None)}


def combined(rows):
    """One row of a kernel's gate rows over several calls: counts summed,
    the worst of each other measure, dicts of counts summed per key, the
    gates that failed on any call, and what the first four calls with a
    difference showed of it."""
    out = {}
    for key, first in rows[0].items():
        vals = [r[key] for r in rows]
        if key == "failed":
            out[key] = sorted({f for v in vals for f in v})
        elif key == "shown":
            out[key] = [v for v in vals if v][:4]
        elif isinstance(first, dict):
            out[key] = {k: sum(v[k] for v in vals) for k in first}
        else:
            out[key] = (sum if isinstance(first, int) else max)(vals)
    return out


def check_kernel(kernel, name, calls, timed=0, **fields):
    """``kernel`` (a ``cuda_build.Kernel``) against its plain twin on the
    card on each of ``calls``, its operands as launched (``recording``),
    held to its ``CHECKS``: the gates of every call, ``combined``, and
    those over all of them; the timed call's fields, and the times of the
    kernel and the twin on it (call ``timed``); ``fields``.  Raises where
    a gate fails."""
    gates, timed_fields, overall = CHECKS[kernel.label]
    row = {"phase": f"{kernel.label}_check", "shape": name,
           "calls": len(calls)}
    row.update(combined([gates(ops, kernel(*ops), kernel.twin(*ops))
                         for ops in calls]))
    if overall is not None:
        overall(row)
    ops = calls[timed]
    row.update(timed_fields(ops, kernel(*ops)))
    row["ms"] = time_ms(lambda: kernel(*ops), 200)
    row["plain_ms"] = time_ms(lambda: kernel.twin(*ops), 20)
    row.update(fields)
    emit(row)
    if row["failed"]:
        raise RuntimeError(f"{kernel.label} {name} differs from the plain "
                           f"twin: {row}")
    return row


def copied(x):
    """``x`` with every tensor in it, through tuples, a
    ``same_layout_copy``."""
    if isinstance(x, torch.Tensor):
        return same_layout_copy(x)
    if isinstance(x, tuple):
        items = [copied(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def recording(kernel, run, calls, limit=None):
    """``run(graph)`` whose first eager call (graph=False) appends copies
    of the operands of ``kernel``'s launches (``copied``), the first
    ``limit`` of them, to ``calls``."""
    def keep(*ops):
        if limit is None or len(calls) < limit:
            calls.append(copied(ops))

    def wrapped(graph=None):
        if graph is not False or calls:
            return run(graph)
        with kernel.watching(keep):
            return run(graph)

    return wrapped


def kernel_entry(kernel, boundary, rows, launches, main, fields, **extra):
    """``kernel``'s entry of the ``kernels`` line: its launches in all and
    per path, the times and bound of row ``main`` of ``rows``, ``fields``
    of each row, and ``extra``."""
    m = rows[main]
    return {"name": f"{kernel.label} {boundary}", "route": "cuda",
            "source": f"dcreg_tpu_torch/csrc/{kernel.source.name}",
            "replaces": None, "launches": int(sum(launches.values())),
            "launches_by_path": launches, "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
            "shapes": {k: {f: v[f] for f in fields}
                       for k, v in rows.items()}, **extra}


# --------------------------------------------------------------------------
# the compiled loops as CUDA graphs against their eager runs
# --------------------------------------------------------------------------

EAGER_CHECK_FRAMES = 16
EAGER_CHECK_ROUNDS = 3
def rotation_diff_rad(R_a, R_b):
    """Angle of R_a^T R_b per leading index (float64, exact near 0)."""
    M = R_a.double().transpose(-1, -2) @ R_b.double()
    A = (M - M.transpose(-1, -2)) / 2.0
    s = torch.stack([A[..., 2, 1], A[..., 0, 2], A[..., 1, 0]], -1).norm(
        dim=-1)
    return torch.arcsin(torch.clamp(s, max=1.0))


def bit_equal(a, b):
    """Every tensor field of two results equal, NaN where the other is."""
    for x, y in zip(a, b):
        if not isinstance(x, torch.Tensor):
            if not bit_equal(x, y):
                return False
            continue
        if x.dtype.is_floating_point:
            if not torch.equal(x.isnan(), y.isnan()):
                return False
            x, y = x.nan_to_num(0.0), y.nan_to_num(0.0)
        if not torch.equal(x, y):
            return False
    return True


def graph_pools_mib():
    """Device memory the captured graphs' private pools hold (the caching
    allocator's segments outside the default pool), MiB: what a graphed
    run keeps between calls, not counted in its peak above the memory
    allocated before it."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) \
        / 2 ** 20


def measured(fn):
    """(result, seconds, peak device MiB above what was allocated before,
    peak MiB in all) of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, seconds = wall(fn)
    peak = torch.cuda.max_memory_allocated()
    return out, seconds, (peak - base) / 2 ** 20, peak / 2 ** 20


def eager_vs_graphed(run, name):
    """``run(graph)`` of the localization loop eagerly (graph=False) and
    as graph replays, in alternating order over EAGER_CHECK_ROUNDS rounds:
    ms per frame and peak memory of each run; gated on equal iterations
    per frame and poses within 1e-6 m and 1e-6 rad; bit-equality of every
    output reported."""
    rows, first = [], {}
    for r in range(EAGER_CHECK_ROUNDS):
        for graph in ((False, None) if r % 2 == 0 else (None, False)):
            mode = "eager" if graph is False else "graphed"
            res, sec, peak, total = measured(lambda: run(graph))
            n = res.poses.shape[0]
            rows.append({"round": r, "mode": mode,
                         "ms_per_frame": sec / n * 1e3,
                         "iters_per_frame": float(
                             res.iterations.float().mean()),
                         "peak_mib": peak, "peak_total_mib": total})
            if mode in first:
                rows[-1]["bit_equal_to_round_0"] = bit_equal(first[mode],
                                                             res)
            first.setdefault(mode, res)
    e, g = first["eager"], first["graphed"]
    row = {"phase": name, "frames": int(e.poses.shape[0]), "runs": rows,
           "same_iterations": bool(torch.equal(e.iterations, g.iterations)),
           "pose_max_diff_m": float((e.poses[:, :3, 3].double()
                                     - g.poses[:, :3, 3].double()).norm(
                                         dim=1).max()),
           "rot_max_diff_rad": float(rotation_diff_rad(
               e.poses[:, :3, :3], g.poses[:, :3, :3]).max()),
           "bit_equal": bit_equal(e, g),
           "graph_pools_mib": graph_pools_mib()}
    if not (row["same_iterations"] and row["pose_max_diff_m"] <= 1e-6
            and row["rot_max_diff_rad"] <= 1e-6):
        raise RuntimeError(f"graphed loop differs from the eager one: "
                           f"{row}")
    return row


def batch_against_eager(out, run):
    """One eager rerun (``run(graph=False)``) of a graphed batch ``out``:
    per-lane iterations equal, the largest pose difference, bit-equality,
    and peak memory of the eager run and of one more graphed run."""
    ref, sec, peak_e, total_e = measured(lambda: run(graph=False))
    _, sec_g, peak_g, total_g = measured(run)
    return {"eager_seconds": sec, "graphed_seconds_rerun": sec_g,
            "eager_same_iterations": bool(torch.equal(out.iterations,
                                                      ref.iterations)),
            "eager_pose_max_diff": max(float((out.R - ref.R).abs().max()),
                                       float((out.t - ref.t).abs().max())),
            "eager_bit_equal": bit_equal(out, ref),
            "eager_peak_mib": peak_e, "eager_peak_total_mib": total_e,
            "graphed_peak_mib": peak_g, "graphed_peak_total_mib": total_g,
            "graph_pools_mib": graph_pools_mib()}


def stale_cache_check(run_odom, res, world, device):
    """A second MapIndex over the same map shifted by +1 m in x: the same
    shapes, so only the storage the graphs read in place tells the two
    apart.  Frame 0 seeded as phase 2 seeds it, shifted the same way,
    must land on phase 2's frame 0 shifted by 1 m, within 1 cm and 1e-3
    rad (the shifted map rounds differently; a stale replay would read
    the first map and miss by 1 m); the first map again must replay its
    own graphs and give phase 2's frame 0 bit for bit."""
    from dcreg_tpu_torch import graphs
    from dcreg_tpu_torch.ops.block_sparse import build_map_index
    t0 = time.perf_counter()
    shift = np.array([1.0, 0.0, 0.0])
    world2 = world + shift.astype(np.float32)
    mindex2 = build_map_index(world2, tb=128, sb=64, device=device)
    world2_t = torch.as_tensor(world2, device=device)
    build_s = time.perf_counter() - t0
    captures = graphs.CACHE.captures
    moved = run_odom(1, mi=mindex2, wt=world2_t, shift=shift)
    new_captures = graphs.CACHE.captures - captures
    again = run_odom(1)
    p0 = res.poses[0].double()
    p1 = moved.poses[0].double()
    row = {"phase": "stale_cache_check", "shift_m": shift.tolist(),
           "index_build_s": build_s, "new_captures": new_captures,
           "t_diff_m": float((p1[:3, 3] - p0[:3, 3] - torch.as_tensor(
               shift, device=p0.device)).norm()),
           "rot_diff_rad": float(rotation_diff_rad(p0[:3, :3],
                                                   p1[:3, :3])),
           "iterations": [int(res.iterations[0]), int(moved.iterations[0])],
           "first_map_again_bit_equal": bool(torch.equal(again.poses[0],
                                                         res.poses[0])),
           "seconds": time.perf_counter() - t0}
    del mindex2, world2_t
    if not ((device == "cpu" or new_captures == 1)
            and row["t_diff_m"] < 1e-2 and row["rot_diff_rad"] < 1e-3
            and row["first_map_again_bit_equal"]):
        raise RuntimeError(f"stale-cache check failed: {row}")
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
    times of both kernels, their twins, and the nearest library pairs:
    for K2 cdist + topk, for K3 cdist + amin over the 128-target
    groups."""
    from dcreg_tpu_torch.ops import knn_kernels as kn
    n, m = query.shape[0], target.shape[0]
    pen = kn._penalty(m, valid, query.device)
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
    # cdist's launch refuses 65,536 x 65,536 outputs, so the library pairs
    # run over query chunks of 8,192 rows
    chunks = lambda: (torch.cdist(
        query[c0:c0 + 8192], target,
        compute_mode="donot_use_mm_for_euclid_dist")
        for c0 in range(0, n, 8192))
    pad = (-m) % kn.GROUP

    def lib():
        for d in chunks():
            torch.topk(d, k, dim=1, largest=False)

    def lib_k3():
        for d in chunks():
            d = torch.nn.functional.pad(d, (0, pad), value=float("inf"))
            torch.amin(d.reshape(d.shape[0], -1, kn.GROUP), dim=2)
    k2 = {"ms": time_ms(lambda: kn.knn_candidates(query, target, pen, kk),
                        20),
          "plain_ms": time_ms(lambda: kn.knn_candidates_plain(
              query, target, pen, kk), 2),
          "library_ms": time_ms(lib, 1), "max_abs_err": k2_err,
          "mismatches": k2_bad, "grid": kn.K2.last_grid}
    k2.update(knn_bound(n, m, n * kk * 8))
    k3 = {"ms": time_ms(lambda: kn.group_min(query, target, pen), 20),
          "plain_ms": time_ms(lambda: kn.group_min_plain(query, target,
                                                          pen), 2),
          "library_ms": time_ms(lib_k3, 1), "max_abs_err": k3_err,
          "mismatches": k3_bad,
          "grid": kn.K3.last_grid}
    k3.update(knn_bound(n, m, gmin.numel() * 4))
    emit({"phase": "knn_check", "shape": name, "N": n, "M": m, "k": k,
          "kk": kk, "invalid_targets": 0 if valid is None
          else int((~valid).sum()), "K2": k2, "K3": k3})
    return k2, k3


def check_k2_graph(name, query, target, valid, kk):
    """K2 alone captured in a CUDA graph and replayed (``graphs.Graphs``),
    as ``check_k1_graph`` holds K1: (val, idx) bit for bit against the
    plain twin, and one launch counted per replay (of them one from the
    replay)."""
    from dcreg_tpu_torch import graphs
    from dcreg_tpu_torch.ops import knn_kernels as kn
    pen = kn._penalty(target.shape[0], valid, query.device)
    state = graphs.State()

    def part():
        val, idx = kn.knn_candidates(query, target, pen, kk)
        state.put("val", val)
        state.put("idx", idx)

    g = graphs.Graphs(f"K2 {name}", state, {"k2": part}, query.device)
    state.val.fill_(0.0)
    state.idx.fill_(0)
    tally = Tally()
    g("k2")
    torch.cuda.synchronize()
    counted, replayed = tally.launches(kn.K2), tally.replayed(kn.K2)
    val_p, idx_p = kn.knn_candidates_plain(query, target, pen, kk)
    bits = lambda x: x.view(torch.int32)
    row = {"phase": "k2_graph_check", "shape": name, "kk": kk,
           "entries": int(val_p.numel()),
           "mismatches": int((bits(state.val) != bits(val_p)).sum()
                             + (state.idx != idx_p).sum()),
           "launches_per_replay": counted,
           "launches_from_the_replay": replayed, "capture_s": g.seconds}
    emit(row)
    if row["mismatches"] or counted != 1 or replayed != 1:
        raise RuntimeError(f"K2 in a CUDA graph failed: {row}")


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
    if device != "cpu":
        check_k2_graph("d_self_5nn", cyl, cyl, None, 10)
        check_k2_graph("e_nn1", moved, cyl, None, 8)
        check_k2_graph("h_normals_o3d", cyl, cyl, None, 60)
    tally = Tally()
    dg, ig = kn.knn_grouped(big_q, f32(big), valid, k=5)
    k3_launches = tally.launches(kn.K3)
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
    degenerate direction flagged at iteration 0; on the card, K2 launched
    from graph replays by every XICP, O3D and SuperLoc row that searches
    with it, and under one ``cudaLaunchKernel`` call per ICP iteration in
    the profile windows of XICP-EQ and O3D.  Returns the per-method
    summary (with each row's K2 launches in total, per kk and from
    replays) and the run's K2 launches ({"total", "replayed",
    "by_kk"})."""
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
        run_tally = Tally()
        runner.load_point_clouds(world, world)
        replayed = {}
        for name, det, hand in cfg.methods():
            tally = Tally()
            runner.run_method(name, det, hand)
            per_method[name] = tally.by_kk(kn.K2)
            replayed[name] = tally.replayed(kn.K2)
        runner.finalize_statistics()
        runner.save_results()
        seconds = time.perf_counter() - t0
        launches = {"total": run_tally.launches(kn.K2),
                    "replayed": run_tally.replayed(kn.K2),
                    "by_kk": run_tally.by_kk(kn.K2)}
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
                "k2_launches_from_replays": replayed[rec.method],
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
              "k2_launches_from_replays": launches["replayed"],
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
            # the baselines' K2 searches (the normals on both backends,
            # SuperLoc's 5-NN on the brute-force one) come from replays
            silent = [m for m, d in summary.items()
                      if (m.startswith("XICP") or m == "O3D"
                          or (m == "SuperLoc" and backend == "brute"))
                      and d["k2_launches_from_replays"] <= 0]
            if silent:
                raise RuntimeError(f"K2 was not launched from graph replays "
                                   f"by {silent} ({scenario}, {backend})")
        # one method run each under the profiler: Ours of the cylinder
        # matrix on both backends, XICP, XICP-EQ and O3D where K2 is the
        # search
        methods = {m: (d, h) for m, d, h in cfg.methods()}
        profiled = ["Ours"] if scenario == "cylinder" else []
        if backend == "brute":
            profiled += ["XICP", "XICP-EQ", "O3D"]
        for name in profiled:
            if name in methods:
                # a warm call first: the window holds no capture
                runner.run_single_test(name, *methods[name])
                held, passes = {}, Passes()
                prof = profile_window(
                    f"pair_{name.lower()}_profile_{scenario}_{backend}",
                    lambda: held.update(r=runner.run_single_test(
                        name, *methods[name])))
                rates = launch_rates(prof, int(held["r"][0].iterations))
                route = passes.since()
                emit(dict(prof, **rates, route=route))
                if device != "cpu" and name in ("XICP-EQ", "O3D") and \
                        rates["launch_calls_per_icp_iteration"] >= 1:
                    raise RuntimeError(f"graphed {name} made {rates} kernel "
                                       "launch calls per ICP iteration")
                # XICP's pass graph is over graphs.PASS_OPS: it replays
                # part by part, its host reading the done flag; the others
                # run each pass on the card
                on_host = name in ON_THE_HOST
                if device != "cpu" and not (
                        (route["device_passes"] == 0) == on_host
                        and (route["host_reads"] > 0) == on_host):
                    raise RuntimeError(f"graphed {name} took the wrong "
                                       f"route (on the host: {on_host}): "
                                       f"{route}")
        return summary, launches
    finally:
        shutil.rmtree(out, ignore_errors=True)


def launch_rates(prof, iterations):
    """The host's kernel-launch calls (``cudaGraphLaunch`` apart) and the
    kernels on the card per ICP iteration of a profile window that ran
    ``iterations`` of them."""
    calls = prof["host_launch_calls"]
    kernel_calls = sum(calls.get(k, {}).get("count", 0)
                       for k in LAUNCH_CALLS if k != "cudaGraphLaunch")
    n = max(iterations, 1)
    return {"icp_iterations": iterations,
            "kernels_per_icp_iteration": prof["kernel_launches"] / n,
            "launch_calls_per_icp_iteration": kernel_calls / n,
            "graph_launches": calls.get("cudaGraphLaunch",
                                        {}).get("count", 0)}


def so3_or_euler(name):
    """Whether a row runs the SO(3) or the Euler engine, whose graphed
    runs are held bit for bit against their eager reruns."""
    return not (name.startswith("XICP") or name in ("O3D", "SuperLoc"))


def pair_eager_check(world, scenario, cfg, backend, summary, device):
    """One eager run (``TestRunner(graph=False)``) of every row of a
    matrix against its graphed run in ``summary``: gated on equal
    iterations, final poses within 1e-6 m and 1e-6 rad, SuperLoc's
    record fields equal, and the whole result (the log too) bit-equal
    for the SO(3) and Euler rows (reported for the others); both times
    reported."""
    from dcreg_tpu_torch.harness import TestRunner
    cfg = cfg._replace(output_folder="", use_grid_index=backend == "grid")
    runner = TestRunner(cfg, dtype=torch.float32, device=device,
                        graph=False)
    runner.load_point_clouds(world, world)
    rows = {}
    for name, det, hand in cfg.methods():
        ref, ms, info = runner.run_single_test(name, det, hand)
        out = summary[name]["record"].result
        dt = float(np.linalg.norm(np.asarray(out.t, np.float64)
                                  - np.asarray(ref.t, np.float64)))
        dr = float(rotation_diff_rad(
            torch.as_tensor(np.asarray(out.R)),
            torch.as_tensor(np.asarray(ref.R))))
        same = all(np.array_equal(np.asarray(a), np.asarray(b),
                                  equal_nan=np.asarray(a).dtype.kind == "f")
                   for a, b in zip(list(out[:-1]) + list(out.log),
                                   list(ref[:-1]) + list(ref.log)))
        rows[name] = {"iterations": [int(out.iterations),
                                     int(ref.iterations)],
                      "pose_diff_m": dt, "rot_diff_rad": dr,
                      "bit_equal": same,
                      "graphed_ms": summary[name]["time_mean_ms"],
                      "eager_ms": ms}
        if info is not None:
            sl = summary[name]["superloc"]
            rows[name]["superloc_fields_equal"] = bool(
                np.array_equal(sl["uncertainties"], info.uncertainties)
                and all(sl[f] == float(getattr(info, f))
                        for f in ("cond_full", "cond_rot", "cond_trans"))
                and sl["is_degenerate"] == bool(info.is_degenerate))
    row = {"phase": f"pair_eager_vs_graphed_{scenario}_{backend}",
           "methods": rows}
    emit(row)
    bad = [m for m, r in rows.items()
           if r["iterations"][0] != r["iterations"][1]
           or r["pose_diff_m"] > 1e-6 or r["rot_diff_rad"] > 1e-6
           or not r.get("superloc_fields_equal", True)
           or (so3_or_euler(m) and not r["bit_equal"])]
    if bad:
        raise RuntimeError(f"graphed method runs differ from eager ones: "
                           f"{bad}: {row}")
    return rows


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
    from dcreg_tpu_torch.ops import knn_kernels as kn
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
            pair_eager_check(world, name, cfg, backend, runs[name, backend],
                             device)
        grid, brute = runs[name, "grid"], runs[name, "brute"]
        agree[name] = {m: backend_agreement(grid[m]["record"],
                                            brute[m]["record"])
                       for m in grid}
    emit({"phase": "pair_backends_agree", "matrices": agree})
    bad = [f"{s}/{m}" for s, d in agree.items() for m, a in d.items()
           if not a["ok"]]
    if bad:
        raise RuntimeError(f"grid and brute-force backends disagree: {bad}")
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "grid")
    k2_rows = {k: v[0] for k, v in rows.items()}
    k2 = kernel_entry(
        kn.K2, "knn_candidates", k2_rows,
        {p: v["total"] for p, v in launches.items()}, "d_self_5nn", fields,
        replaces="dcreg_tpu/ops/pallas_knn.py:47",
        launches_from_replays_by_path={p: v["replayed"]
                                       for p, v in launches.items()},
        launches_by_path_and_kk={p: v["by_kk"] for p, v in launches.items()},
        launches_per_method_run={
            f"{s}_{b}": {m: r["k2_launches_by_kk"] for m, r in s_b.items()}
            for (s, b), s_b in runs.items()},
        max_abs_err=max(r["max_abs_err"] for r in k2_rows.values()),
        library_ms=k2_rows["d_self_5nn"]["library_ms"],
        library="torch.cdist + torch.topk (two calls)")
    k3_rows = {k: v[1] for k, v in rows.items()}
    k3 = kernel_entry(
        kn.K3, "group_min", k3_rows, {"knn_grouped_check_f": k3_launches},
        "f_65k_invalid", fields, replaces="dcreg_tpu/ops/pallas_knn.py:196",
        max_abs_err=max(r["max_abs_err"] for r in k3_rows.values()),
        library_ms=k3_rows["f_65k_invalid"]["library_ms"],
        library="torch.cdist + torch.amin over 128-target groups")
    return k2, k3


# --------------------------------------------------------------------------
# Phase 8: the voxel-grid odometry loop, the pose graph and TUM scoring
# --------------------------------------------------------------------------

# the voxel loop's timed run falls back to its first 64 frames when the
# warm-up predicts more than this many seconds for all of them
VOXEL_TIMED_LIMIT_S = 120.0
VOXEL_WARM_FRAMES = 4
# the profiler's processing of a voxel-loop frame costs about 12 s
VOXEL_PROFILE_FRAMES = 2


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
    from dcreg_tpu_torch import graphs
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

    def odom(n, graph=None):
        return run_odometry(frames[:n], grid, T0=ctx["T_pre1"],
                            params=params, device=device, graph=graph)

    cap0 = (graphs.CACHE.captures, graphs.CACHE.capture_seconds)
    _, warm_s = wall(lambda: odom(VOXEL_WARM_FRAMES))
    captures = graphs.CACHE.captures - cap0[0]
    capture_s = graphs.CACHE.capture_seconds - cap0[1]
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
           "capacity": cap, "largest_occupancy": occ, "graphed": True,
           "warm_run_s": warm_s, "graph_captures": captures,
           "graph_capture_s": capture_s,
           "ms_per_frame": dt / n_timed * 1e3,
           "iters_per_frame": float(res.iterations.float().mean()),
           "converged_frac": float(res.converged.float().mean()),
           "te_mean_m": float(te.mean()), "te_max_m": float(te.max()),
           "max_dist_to_map_loop_m": float(vs_map.max()),
           "phase8_s": since()}
    emit(row)
    if not (bool(res.converged.all()) and te.mean() < 0.05
            and te.max() < 0.10 and vs_map.max() < 0.03):
        raise RuntimeError(f"voxel odometry gates failed: {row}")
    row = eager_vs_graphed(lambda graph: odom(EAGER_CHECK_FRAMES, graph),
                           "voxel_eager_vs_graphed")
    row["phase8_s"] = since()
    emit(row)
    prof = profile_window("voxel_odometry_profile",
                          lambda: odom(VOXEL_PROFILE_FRAMES))
    prof.update(launch_rates(
        prof, int(res.iterations[:VOXEL_PROFILE_FRAMES].sum())))
    prof["phase8_s"] = since()
    emit(prof)
    if device != "cpu" and not (
            prof["graph_launches"] > 0
            and prof["launch_calls_per_icp_iteration"] < 50):
        raise RuntimeError(f"the graphed voxel loop's profile does not "
                           f"show graph replay: {prof}")

    # ---- 8b. voxel_knn held against K2 ------------------------------------
    T = torch.as_tensor(gt[0], dtype=torch.float32, device=device)
    q = torch.as_tensor(frames[0], device=device) @ T[:3, :3].T + T[:3, 3]
    tube_t = world_t[torch.as_tensor(tube_idx, device=device)].contiguous()
    dv, iv = voxel_knn(grid, q, k=5, capacity=cap, chunk=params.chunk)
    tally = Tally()
    dk, ik = kn.knn(q, tube_t, k=5)
    k2_launches = tally.launches(kn.K2)
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

    def pg(dev, dt, graph=None):
        edges = make_edges(i, j, torch.as_tensor(Z, dtype=dt), info=info,
                           device=dev)
        return optimize_pose_graph(torch.as_tensor(init, dtype=dt), edges,
                                   device=dev, graph=graph)

    ref = pg("cpu", torch.float64)
    ref_p = ref.poses.numpy()
    wall(lambda: pg(device, dtype))                 # captures on the card
    rounds, first = [], {}
    for r in range(EAGER_CHECK_ROUNDS):
        for graph in ((False, None) if r % 2 == 0 else (None, False)):
            mode = "eager" if graph is False else "graphed"
            res, sec = wall(lambda: pg(device, dtype, graph))
            rounds.append({"round": r, "mode": mode, "ms": sec * 1e3,
                           "gn_iterations": res.iterations})
            first.setdefault(mode, res)
    out, eager = first["graphed"], first["eager"]
    opt = out.poses.double().cpu().numpy()
    drift0 = float(np.linalg.norm(init[-1, :3, 3] - gt[-1, :3, 3]))
    drift1 = float(np.linalg.norm(opt[-1, :3, 3] - gt[-1, :3, 3]))
    vs_ref = float(np.linalg.norm(opt[:, :3, 3] - ref_p[:, :3, 3],
                                  axis=1).max())
    ms = lambda mode: [x["ms"] for x in rounds if x["mode"] == mode]
    row = {"phase": "pose_graph", "window": int(gt.shape[0]),
           "edges": int(len(i)), "dtype": str(dtype).split(".")[-1],
           "gn_iterations": out.iterations, "converged": out.converged,
           "ms": ms("graphed")[0], "graphed_ms": ms("graphed"),
           "eager_ms": ms("eager"), "rounds": rounds,
           "eager_same_iterations": eager.iterations == out.iterations,
           "eager_bit_equal": bool(torch.equal(eager.poses, out.poses)
                                   and torch.equal(eager.final_cost,
                                                   out.final_cost)),
           "final_cost": float(out.final_cost),
           "drift_before_m": drift0, "drift_after_m": drift1,
           "max_dist_to_cpu_f64_m": vs_ref,
           "cpu_f64_iterations": ref.iterations,
           "cpu_f64_final_cost": float(ref.final_cost),
           "phase8_s": since()}
    emit(row)
    if not (drift1 <= 0.5 * drift0 and row["final_cost"] < 1.0
            and vs_ref < 1e-3 and row["eager_same_iterations"]
            and row["eager_bit_equal"]):
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
# Phase 9: sharded registration, the sharded pose-graph assembly and the
# native host runtime
# --------------------------------------------------------------------------

SHARD_FRAMES = 16
SHARD_PROFILE_FRAMES = 2
# phase 2's kd leaves are 128-point blocks: the map serves unsorted
SHARD_BLOCK = 128
SHARD_SUPER = 64
SHARD_CAP_MARGIN = 1.5
RANK_TIMEOUT_S = 600


def cull_counts(p_w, tgt_xyz, tgt_valid, shards=1):
    """The most target blocks (of SHARD_BLOCK points) and supers (of
    SHARD_SUPER blocks) whose boxes lie within the search radius of one
    128-point query block, over the query blocks of ``p_w`` split into
    ``shards`` equal row ranges, as ``sharded_icp_register``'s cull
    counts them: the caps its ``num_blocks`` and ``num_supers`` must
    hold."""
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.parallel.sharded import _QBS, _bbox_gap_sq
    r2 = ICPParams().corr.search_radius ** 2
    blocks = tgt_xyz.reshape(-1, SHARD_BLOCK, 3)
    bval = tgt_valid.reshape(-1, SHARD_BLOCK, 1)
    blo = torch.amin(torch.where(bval, blocks, float("inf")), dim=1)
    bhi = torch.amax(torch.where(bval, blocks, float("-inf")), dim=1)
    ns = -(-blo.shape[0] // SHARD_SUPER)
    pad = ns * SHARD_SUPER - blo.shape[0]
    fill = lambda v: torch.full((pad, 3), v, device=blo.device)
    slo = torch.amin(torch.cat([blo, fill(float("inf"))]).reshape(
        ns, SHARD_SUPER, 3), dim=1)
    shi = torch.amax(torch.cat([bhi, fill(float("-inf"))]).reshape(
        ns, SHARD_SUPER, 3), dim=1)
    qblocks = [q for part in p_w.chunk(shards) for q in part.split(_QBS)]
    qlo = torch.stack([q.amin(dim=0) for q in qblocks])[:, None]
    qhi = torch.stack([q.amax(dim=0) for q in qblocks])[:, None]
    most = lambda lo, hi: int(torch.sum(_bbox_gap_sq(qlo, qhi, lo, hi)
                                        <= r2, dim=1).max())
    return most(blo, bhi), most(slo, shi)


def cull_caps(counts):
    """(num_blocks, num_supers) with SHARD_CAP_MARGIN over the largest
    counts; the supers' blocks always cover num_blocks."""
    G = int(np.ceil(max(c[0] for c in counts) * SHARD_CAP_MARGIN))
    GS = int(np.ceil(max(c[1] for c in counts) * SHARD_CAP_MARGIN)) + 2
    return G, max(GS, -(-G // SHARD_SUPER))


def const_velocity_seeds(T_pre2, T_pre1, poses):
    """Phase 2's seed of each frame (the loop's constant-velocity model)
    from the poses estimated before it, in f64."""
    from dcreg_tpu_torch.models.odometry import _seed
    from dcreg_tpu_torch.ops import se3
    prev = [torch.as_tensor(T, dtype=torch.float64)
            for T in (T_pre2, T_pre1, *poses)]
    return np.stack([se3.se3_matrix(*_seed(
        b[:3, :3], b[:3, 3], a[:3, :3], a[:3, 3], True)).numpy()
        for a, b in zip(prev, prev[1:len(poses) + 1])])


def sharded_case(mesh, inp, name):
    """``sharded_icp_register`` of phase 9b's case ``name`` on ``mesh``
    (every rank passes the same global arrays)."""
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod,
                                                HandlingMethod)
    from dcreg_tpu_torch.parallel import shard_points, sharded_icp_register
    dev = mesh.device
    src, src_v = shard_points(torch.as_tensor(inp[f"{name}.scan"],
                                              device=dev),
                              mesh.shape["data"])
    tgt, tgt_v = shard_points(torch.as_tensor(inp[f"{name}.map"],
                                              device=dev),
                              mesh.shape["map"], block=SHARD_BLOCK)
    kw = (dict(block_cull=False) if name == "dense" else
          dict(block_cull=True, block_size=SHARD_BLOCK,
               num_blocks=int(inp["culled.G"]), super_size=SHARD_SUPER,
               num_supers=int(inp["culled.GS"])))
    return sharded_icp_register(
        mesh, src, tgt, inp[f"{name}.R0"], inp[f"{name}.t0"],
        DetectionMethod.SCHUR_CONDITION_NUMBER,
        HandlingMethod.PRECONDITIONED_CG, ICPParams(), source_valid=src_v,
        target_valid=tgt_v, **kw)


def pose_graph_case(inp, dev):
    """(poses, edges, prior_idx, prior_T, prior_info) of phase 9b's
    window in f32 on ``dev``: optimize_pose_graph's default prior."""
    from dcreg_tpu_torch.models.pose_graph import make_edges
    poses = torch.as_tensor(inp["pg.init"], dtype=torch.float32, device=dev)
    edges = make_edges(inp["pg.i"], inp["pg.j"],
                       torch.as_tensor(inp["pg.Z"], dtype=torch.float32),
                       info=torch.as_tensor(inp["pg.info"],
                                            dtype=torch.float32), device=dev)
    return (poses, edges, torch.zeros(1, dtype=torch.long, device=dev),
            poses[:1], 1e8 * torch.eye(6, device=dev)[None])


def rank_backend(device, world):
    """How phase 9b's ranks meet: NCCL with a card per rank where the
    machine has that many cards, else gloo with every rank on card 0
    (NCCL refuses two ranks on one GPU)."""
    if device == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def sharded_rank(rank, world, init_method, workdir, device):
    """One rank of phase 9b's world (``rank_backend``): both
    registrations on a 2 x 2 mesh, the host mesh (two 'hosts' of two
    ranks) and the pose graph assembled with its edges over data = 2."""
    from dcreg_tpu_torch import convert
    from dcreg_tpu_torch.models.pose_graph import assemble_sharded
    from dcreg_tpu_torch.parallel import make_mesh
    from dcreg_tpu_torch.parallel.distributed import (init_distributed,
                                                      make_host_mesh)
    from dcreg_tpu_torch.parallel.sharded import _use_graphs
    backend = rank_backend(device, world)
    if device == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    init_distributed(init_method, world, rank, backend=backend)
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    mesh = make_mesh(2, 2, device=device)
    out = {"graphed": np.array(int(_use_graphs(mesh, None)))}
    for name in ("dense", "culled"):
        for f, v in convert.sharded_result_to_numpy(
                sharded_case(mesh, inp, name)).items():
            out[f"{name}.{f}"] = v
    host = make_host_mesh(map_per_host=2, device=device)
    out["host_rows"] = host.ranks // int(os.environ["LOCAL_WORLD_SIZE"])
    H, g, cost = assemble_sharded(host, *pose_graph_case(inp, device))
    out.update({"pg.H": H.cpu().numpy(), "pg.g": g.cpu().numpy(),
                "pg.cost": cost.cpu().numpy()})
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(workdir, world, device):
    """Run ``world`` ranks of this script (``--sharded-rank``) on
    localhost; returns each rank's saved arrays.  Every rank is ended
    before this returns."""
    env = {**os.environ, "LOCAL_WORLD_SIZE": "2"}
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank",
         str(r), str(world), init, workdir, device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"phase 9b rank {r} failed ({p.returncode}):"
                               f"\n{log[-4000:]}")
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]


def pose_diff(R, t, R_ref, t_ref):
    """(translation difference m, rotation angle deg) of two poses."""
    return (float(np.linalg.norm(np.asarray(t) - np.asarray(t_ref))),
            rotation_angle_deg(np.asarray(R_ref).T @ np.asarray(R)))


def run_sharded(seed, ctx, device: str = "cuda"):
    """Phase 9 on phase 2's world, trajectory, scans and poses: (9a)
    ``sharded_icp_register`` on a 1 x 1 mesh of a one-rank world (NCCL on
    the card) against the whole map, two-level and flat cull; (9b) four
    ranks (``rank_backend``): a 2 x 2 mesh (dense and culled), the
    host mesh and ``assemble_sharded``, held against the 1 x 1 mesh and
    the unsharded assembly; (9c) the native host runtime: its g++ build,
    PCD I/O, the KD-tree as K2's exact oracle, voxel downsampling.
    Returns K2's launches in (9c)."""
    from dcreg_tpu_torch.io import native
    from dcreg_tpu_torch.io.pcd import load_pcd
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.models.pose_graph import _assemble
    from dcreg_tpu_torch.ops import knn_kernels as kn
    from dcreg_tpu_torch.ops.block_sparse import kd_block_order
    from dcreg_tpu_torch.ops.degeneracy import (DetectionMethod,
                                                HandlingMethod)
    from dcreg_tpu_torch.parallel import (make_mesh, shard_points,
                                          sharded_icp_register)
    from dcreg_tpu_torch.parallel.distributed import init_distributed
    from dcreg_tpu_torch.parallel.sharded import _use_graphs
    world, gt, frames = ctx["world"], ctx["gt"], ctx["frames"]
    t_start = time.perf_counter()
    since = lambda: time.perf_counter() - t_start

    # ---- 9a. a one-rank world on the card, mesh 1 x 1 ---------------------
    backend = "nccl" if device == "cuda" else "gloo"
    init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                     backend=backend)
    try:
        mesh = make_mesh(1, 1, device=device)
        F = SHARD_FRAMES
        tgt, tgt_v = shard_points(torch.as_tensor(world, device=device), 1,
                                  block=SHARD_BLOCK)
        seeds = const_velocity_seeds(ctx["T_pre2"], ctx["T_pre1"],
                                     ctx["odom_poses"][:F])
        src = [torch.as_tensor(frames[f], device=device) for f in range(F)]
        counts = []
        for f in range(F):
            for T in (seeds[f], ctx["odom_poses"][f]):
                Tt = torch.as_tensor(T, dtype=torch.float32, device=device)
                counts.append(cull_counts(src[f] @ Tt[:3, :3].T + Tt[:3, 3],
                                          tgt, tgt_v))
        G, GS = cull_caps(counts)
        params = ICPParams()

        def register(f, super_size, graph=None):
            return sharded_icp_register(
                mesh, src[f], tgt, seeds[f][:3, :3], seeds[f][:3, 3],
                DetectionMethod.SCHUR_CONDITION_NUMBER,
                HandlingMethod.PRECONDITIONED_CG, params, target_valid=tgt_v,
                block_cull=True, block_size=SHARD_BLOCK, num_blocks=G,
                super_size=super_size, num_supers=GS, graph=graph)

        def sweep(super_size, n=F, graph=None):
            return [register(f, super_size, graph) for f in range(n)]

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rows = {}
        for name, sup in (("two_level", SHARD_SUPER), ("flat", 0)):
            wall(lambda: register(0, sup))          # captures on the card
            runs, first = [], {}
            for r in range(EAGER_CHECK_ROUNDS):
                for graph in ((False, None) if r % 2 == 0 else (None, False)):
                    mode = "eager" if graph is False else "graphed"
                    res, dt = wall(lambda: sweep(sup, graph=graph))
                    runs.append({"round": r, "mode": mode,
                                 "ms_per_registration": dt / F * 1e3})
                    first.setdefault(mode, res)
            res, eager = first["graphed"], first["eager"]
            ms = lambda mode: [x["ms_per_registration"] for x in runs
                               if x["mode"] == mode]
            pos = np.stack([r.t.double().cpu().numpy() for r in res])
            te = np.linalg.norm(pos - gt[:F, :3, 3], axis=1)
            vs_map = np.linalg.norm(pos - ctx["odom_poses"][:F, :3, 3],
                                    axis=1)
            rows[name] = (res, {
                "ms_per_registration": ms("graphed")[0],
                "graphed_ms_per_registration": ms("graphed"),
                "eager_ms_per_registration": ms("eager"), "rounds": runs,
                "iters_per_frame": float(np.mean([int(r.iterations)
                                                  for r in res])),
                "converged_frac": float(np.mean([bool(r.converged)
                                                 for r in res])),
                "block_overflow_max": max(int(r.block_overflow)
                                          for r in res),
                "te_mean_m": float(te.mean()), "te_max_m": float(te.max()),
                "max_dist_to_map_loop_m": float(vs_map.max()),
                "eager_same_iterations": all(
                    int(a.iterations) == int(b.iterations)
                    for a, b in zip(res, eager)),
                "eager_poses_bit_equal": all(
                    torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
                    for a, b in zip(res, eager)),
                "eager_bit_equal": all(bit_equal(a, b)
                                       for a, b in zip(res, eager))})
        two, flat = rows["two_level"][0], rows["flat"][0]
        flat_vs_two = max(pose_diff(a.R.cpu(), a.t.cpu(), b.R.cpu(),
                                    b.t.cpu())[0] for a, b in zip(two, flat))
        row = {"phase": "sharded_register", "mesh": [1, 1],
               "backend": backend,
               "mode": "graphed" if _use_graphs(mesh, None) else "eager",
               "frames": F, "map_points": int(world.shape[0]),
               "block_size": SHARD_BLOCK, "super_size": SHARD_SUPER,
               "num_blocks": G, "num_supers": GS,
               "most_relevant_blocks": max(c[0] for c in counts),
               "most_relevant_supers": max(c[1] for c in counts),
               **{k: v[1] for k, v in rows.items()},
               "flat_vs_two_level_max_m": flat_vs_two,
               "peak_device_mem_gib": (torch.cuda.max_memory_allocated()
                                       / 2 ** 30 if device == "cuda"
                                       else None),
               "graph_pools_mib": (graph_pools_mib() if device == "cuda"
                                   else None),
               "phase9_s": since()}
        emit(row)
        if not all(v[1]["block_overflow_max"] == 0
                   and v[1]["converged_frac"] == 1.0
                   and v[1]["te_mean_m"] < 0.05 and v[1]["te_max_m"] < 0.10
                   and v[1]["max_dist_to_map_loop_m"] < 0.03
                   and v[1]["eager_same_iterations"]
                   and v[1]["eager_poses_bit_equal"]
                   for v in rows.values()):
            raise RuntimeError(f"sharded registration gates failed: {row}")
        prof = profile_window("sharded_register_profile",
                              lambda: sweep(SHARD_SUPER,
                                            SHARD_PROFILE_FRAMES))
        trips = sum(int(r.iterations) for r in two[:SHARD_PROFILE_FRAMES])
        prof.update(launch_rates(prof, trips))
        prof["phase9_s"] = since()
        emit(prof)
        del tgt, tgt_v

        # ---- 9b. four ranks: on the one card over gloo ------------------
        c0 = gt[0][:3, 3]
        T0 = seeds[0]
        local = lambda pts: (pts - c0).astype(np.float32)
        d2 = np.sum((world - c0) ** 2, axis=1)
        # the dense case: 4,096 map points spread over the scan's 6 m
        # ball (ground, walls and pillars: every direction constrained)
        # and 512 of the scan's points
        rng = np.random.default_rng(seed + 9)
        ball = np.nonzero(d2 < 6.0 ** 2)[0]
        inp = {"dense.map": local(world[np.sort(rng.choice(
                   ball, 4096, replace=False))]),
               "dense.scan": frames[0][np.sort(rng.choice(
                   frames[0].shape[0], 512, replace=False))],
               "culled.scan": frames[0],
               "dense.R0": T0[:3, :3], "dense.t0": T0[:3, 3] - c0,
               "culled.R0": T0[:3, :3], "culled.t0": T0[:3, 3] - c0}
        disc = world[d2 < 30.0 ** 2]
        inp["culled.map"] = local(disc[kd_block_order(disc, SHARD_BLOCK)])
        cmap, cmap_v = shard_points(torch.as_tensor(inp["culled.map"],
                                                    device=device), 2,
                                    block=SHARD_BLOCK)
        Tt = torch.as_tensor(T0, dtype=torch.float32, device=device)
        p0 = torch.as_tensor(frames[0], device=device) @ Tt[:3, :3].T \
            + (Tt[:3, 3] - torch.as_tensor(c0, dtype=torch.float32,
                                           device=device))
        # both layouts: one source shard, and two (other query blocks)
        inp["culled.G"], inp["culled.GS"] = cull_caps(
            [cull_counts(p0, cmap, cmap_v, shards=s) for s in (1, 2)])
        i, j, Z, info, init = pose_graph_inputs(gt, seed + 8)
        inp.update({"pg.i": i, "pg.j": j, "pg.Z": Z, "pg.info": info,
                    "pg.init": init})
        workdir = tempfile.mkdtemp(prefix="dcreg_shard_")
        try:
            np.savez(os.path.join(workdir, "inputs.npz"), **inp)
            ranks, spawn_s = wall(lambda: spawn_ranks(workdir, 4, device))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        differ = sorted({k for r in ranks[1:] for k, v in ranks[0].items()
                         if not np.array_equal(r[k], v, equal_nan=True)})
        cases = {}
        for name in ("dense", "culled"):
            ref, ref_s = wall(lambda: sharded_case(mesh, inp, name))
            got = {f: ranks[0][f"{name}.{f}"] for f in ("R", "t",
                                                          "iterations",
                                                          "converged",
                                                          "block_overflow")}
            dt_m, dr_deg = pose_diff(got["R"], got["t"], ref.R.cpu(),
                                     ref.t.cpu())
            cases[name] = {
                "map_points": int(inp[f"{name}.map"].shape[0]),
                "scan_points": int(inp[f"{name}.scan"].shape[0]),
                "iterations_2x2": int(got["iterations"]),
                "iterations_1x1": int(ref.iterations),
                "converged_2x2": bool(got["converged"]),
                "block_overflow_2x2": int(got["block_overflow"]),
                "block_overflow_1x1": int(ref.block_overflow),
                "vs_1x1_m": dt_m, "vs_1x1_deg": dr_deg,
                "ms_1x1": ref_s * 1e3}
        H, g, cost = _assemble(*pose_graph_case(inp, device))
        rel = lambda a, b: float(np.abs(a - b).max()
                                 / max(np.abs(b).max(), 1e-30))
        pg = {"window": int(init.shape[0]), "edges": int(len(i)),
              "H_rel": rel(ranks[0]["pg.H"], H.cpu().numpy()),
              "g_rel": rel(ranks[0]["pg.g"], g.cpu().numpy()),
              "cost_rel": rel(ranks[0]["pg.cost"], cost.cpu().numpy())}
        row = {"phase": "sharded_multi_rank", "ranks": 4, "mesh": [2, 2],
               "backend": rank_backend(device, 4), "device": device,
               "cards": torch.cuda.device_count() if device == "cuda" else 0,
               "rank_modes": ["graphed" if int(r["graphed"]) else "eager"
                              for r in ranks],
               "host_rows": ranks[0]["host_rows"].tolist(),
               "culled_caps": [int(inp["culled.G"]), int(inp["culled.GS"])],
               "ranks_differ_in": differ, "spawn_and_run_s": spawn_s,
               **cases, "pose_graph": pg, "phase9_s": since()}
        emit(row)
        if differ or row["host_rows"] != [[0, 0], [1, 1]] or not all(
                c["vs_1x1_m"] <= 1e-4 and c["vs_1x1_deg"] <= 1e-3
                and c["iterations_2x2"] == c["iterations_1x1"]
                and c["block_overflow_2x2"] == 0 == c["block_overflow_1x1"]
                for c in cases.values()) or max(
                pg["H_rel"], pg["g_rel"], pg["cost_rel"]) > 1e-5:
            raise RuntimeError(f"multi-rank gates failed: {row}")
    finally:
        torch.distributed.destroy_process_group()

    # ---- 9c. the native host runtime ---------------------------------------
    from dcreg_tpu_torch.cuda_build import build_host_library
    b = native.build()          # the library the port loads
    if native.get_lib() is None:
        raise RuntimeError("the native library built but did not load")
    with tempfile.TemporaryDirectory() as d:   # a timed build from scratch
        fresh = build_host_library(native.SOURCE, "dcreg_native",
                                   build_dir=d)
    out_dir = tempfile.mkdtemp(prefix="dcreg_pcd_")
    try:
        path = os.path.join(out_dir, "scan.pcd")
        native.pcd_write_native(path, frames[0])
        a = native.pcd_read_native(path)["xyz"]
        pcd_same = (a.tobytes() == load_pcd(path, prefer_native=False)[
            "xyz"].tobytes() == frames[0].tobytes())
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    tube = world[tube_mask(world, gt)]
    T = torch.as_tensor(gt[0], dtype=torch.float32, device=device)
    q = torch.as_tensor(frames[0], device=device) @ T[:3, :3].T + T[:3, 3]
    tree, tree_s = wall(lambda: native.KDTree(tube))
    (d_t, i_t), kd_s = wall(lambda: tree.knn(q.cpu().numpy(), k=6))
    tube_t = torch.as_tensor(tube, device=device)
    tally = Tally()
    (dk, ik), k2_s = wall(lambda: kn.knn(q, tube_t, k=5, kk=8))
    k2_launches = tally.launches(kn.K2)
    dk, ik = dk.cpu(), ik.cpu().numpy()
    ulps = ulp_diff(dk, torch.from_numpy(np.ascontiguousarray(d_t[:, :5])))
    tie = np.any(d_t[:, 1:] == d_t[:, :-1], axis=1)
    ids_differ = ~np.all(ik == i_t[:, :5], axis=1)
    vox = 0.5
    cents, vox_s = wall(lambda: native.voxel_downsample_native(tube, vox))
    vc = voxel_check(tube, vox, cents)
    row = {"phase": "native_runtime", "build_s": fresh["seconds"],
           "library": os.path.relpath(b["path"]),
           "pcd_round_trip_bytes_equal": bool(pcd_same),
           "tube_points": int(tube.shape[0]), "queries": int(q.shape[0]),
           "kdtree_build_s": tree_s, "kdtree_knn_s": kd_s,
           "k2_knn_s": k2_s, "k2_launches": k2_launches,
           "max_ulp": int(ulps.max()), "ids_differ": int(ids_differ.sum()),
           "ids_differ_not_tied": int((ids_differ & ~tie).sum()),
           "voxel_m": vox, "centroids": int(cents.shape[0]),
           "voxel_s": vox_s, **vc, "phase9_s": since()}
    emit(row)
    if not (pcd_same and row["max_ulp"] <= 1
            and row["ids_differ_not_tied"] == 0
            and vc["unmatched_centroids"] == vc["hash_merges"]
            and vc["voxels_missing"] == 0
            and vc["centroids_expected"] == row["centroids"]
            and (device == "cpu" or k2_launches > 0)):
        raise RuntimeError(f"native runtime checks failed: {row}")
    return k2_launches


def voxel_check(xyz, voxel, cents, tol=1e-6):
    """``voxel_downsample_native``'s centroids against a numpy centroid
    per voxel (float64 sums in input order, as the C++ sums).  The C++
    keys voxels by a hash of their integer coordinates, so voxels whose
    keys collide merge into one centroid.  A centroid matches the unmerged
    voxel of its key when within ``tol`` metres of its numpy centroid; a
    right answer has one centroid per key, every unmerged voxel matched,
    and as many unmatched centroids as merged keys."""
    def key(c):
        return (c[:, 0] * 73856093) ^ (c[:, 1] * 19349669) \
            ^ (c[:, 2] * 83492791)

    inv = 1.0 / voxel
    cell = np.floor(xyz.astype(np.float64) * inv).astype(np.int64)
    cells, which, count = np.unique(cell, axis=0, return_inverse=True,
                                    return_counts=True)
    which = which.reshape(-1)
    mean = np.stack([np.bincount(which, xyz[:, a].astype(np.float64))
                     for a in range(3)], axis=1) / count[:, None]
    keys = key(cells)
    uk, kcount = np.unique(keys, return_counts=True)
    alone = np.isin(keys, uk[kcount == 1])
    single = dict(zip(keys[alone].tolist(), mean[alone].astype(np.float32)))
    got = key(np.floor(cents.astype(np.float64) * inv).astype(np.int64))
    err, unmatched, seen = 0.0, 0, set()
    for kk, c in zip(got.tolist(), cents):
        ref = single.get(kk)
        d = float(np.abs(ref - c).max()) if ref is not None else np.inf
        if kk not in seen and d <= tol:
            seen.add(kk)
            err = max(err, d)
        else:
            unmatched += 1
    return {"centroids_expected": int(uk.shape[0]),
            "hash_merges": int((kcount > 1).sum()),
            "unmatched_centroids": unmatched,
            "voxels_missing": len(single) - len(seen),
            "centroid_max_err_m": err}


# --------------------------------------------------------------------------
# phase 10: the corridor experiment and the map-scale baseline rows
# --------------------------------------------------------------------------

CORRIDOR_RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "results", "corridor_experiment",
                                 "corridor_summary.json")
CORRIDOR_PROFILE_FRAMES = 2
# raw ATE of these rows against the recorded artifact's, and their
# overflow; DCReg and NONE give the same poses
CORRIDOR_STABLE = ("DCReg", "ME-TSVD", "NONE")
CORRIDOR_ATE_TOL_M = 0.005
MAP_BASELINES = (("ME-TSVD", "FULL_EVD_MIN_EIGENVALUE", "TRUNCATED_SVD"),
                 ("ME-TReg", "FULL_EVD_MIN_EIGENVALUE",
                  "STANDARD_REGULARIZATION"),
                 ("FCN-SR", "FULL_SVD_CONDITION", "SOLUTION_REMAPPING"))
MAP_BASELINE_FRAMES = 16
MAP_BASELINE_WARM_FRAMES = 2
# the JAX package's recorded FCN-SR row at map scale (BENCH_r05.json
# map_scale.baselines); accuracy only
FCN_SR_RECORDED = {"te_mean_m": 0.45751, "iters_mean": 10.25}


def run_corridor(device: str = "cuda"):
    """(10a) The corridor experiment through the port's entry point
    ``scripts.run_corridor_experiment.main`` (108,318 map points, 45
    frames of 1,500 points, six methods, f32), gated on its own
    reference envelope, overflow, degenerate frames, the recorded raw ATE
    of DCReg, ME-TSVD and NONE, and DCReg's poses equal to NONE's; K1
    held bit for bit against its plain twin at the corridor loop's own
    call (frame 0's reused list and live mask); pcg6 against its plain
    twin on DCReg's own systems, which take PCG (every frame is
    degenerate), recorded from an eager pass: each as launched (B = 1)
    and the first 128 stacked; schur6 against its twin on the same pass's
    analyses, as launched and the first 128 stacked, and DCReg's frames
    eagerly through schur6 and through its twin (equal iterations per
    frame, poses within 1e-6 m and 1e-6 rad); then two DCReg and two
    ME-TSVD frames under the profiler.  Returns K1's launches in
    ``main``, the K1 check's row, the pcg6 rows, pcg6's launches in
    ``main``, plane_fit's launches in ``main``, the schur6 rows and
    schur6's launches in ``main``."""
    from dcreg_tpu_torch.io.tum import load_tum
    from dcreg_tpu_torch.ops import block_knn as tk
    from dcreg_tpu_torch.ops import degeneracy
    from dcreg_tpu_torch.ops import soa_tail
    from dcreg_tpu_torch.ops import solvers as tsol
    from dcreg_tpu_torch.scripts import run_corridor_experiment as rce
    t_start = time.perf_counter()
    with open(CORRIDOR_RECORDED) as f:
        recorded = json.load(f)
    inp = rce.prepare(torch.device(device))
    S, G, P = inp["caps"]
    # frame 0's constant-velocity seed, as the loop computes it
    T_pred = inp["T_pre1"] @ np.linalg.inv(inp["T_pre2"]) @ inp["T_pre1"]
    k1_row = check_k1("corridor_live_B1_reuse_mask", k1_inputs(
        "map_reuse", inp["frames_s"][0], inp["mindex"], T_pred[None, :3, :3],
        T_pred[None, :3, 3], rce.R_CULL0 + rce.REUSE_MARGIN,
        {"S": S, "G": G, "P": P}, device, live_radius=rce.R_CULL0,
        key_radius=inp["params"].corr.search_radius))

    by_method = {}                    # K1's launches per method in main
    tally = Tally()

    def after_method(name):
        by_method[name] = tally.launches(tk.K1) - sum(by_method.values())

    out_dir = rce.default_out_dir()
    rc, seconds = wall(lambda: rce.main(out_dir, device, inputs=inp,
                                        after_method=after_method))
    launches = tally.launches(tk.K1)
    pcg6_launches = tally.launches(tsol.PCG6)
    plane_launches = tally.launches(soa_tail.PLANE_FIT)
    schur_launches = tally.launches(degeneracy.SCHUR6)
    with open(os.path.join(out_dir, "corridor_summary.json")) as f:
        summary = json.load(f)
    poses = {m: load_tum(os.path.join(out_dir, f"{m}.tum"))[1]
             for m in ("DCReg", "NONE")}
    dc_vs_none = float(np.abs(poses["DCReg"][:, :3, 3]
                              - poses["NONE"][:, :3, 3]).max())
    rows = {}
    for name, _, _ in rce.METHODS:
        m, r = summary[name], recorded[name]
        rows[name] = {
            "ate_raw_cm": m["ate_raw_rmse_m"] * 100,
            "recorded_ate_raw_cm": r["ate_raw_rmse_m"] * 100,
            "rpe_trans_mean_m": m["rpe_trans_mean_m"],
            "rpe_rot_mean_deg": m["rpe_rot_mean_deg"],
            "rr": m["registration_recall"],
            "recorded_rr": r["registration_recall"],
            "ac_rmse_cm": m["map_accuracy"]["ac_rmse"] * 100,
            "recorded_ac_rmse_cm": r["map_accuracy"]["ac_rmse"] * 100,
            "degenerate_frames": m["degenerate_frames"],
            "converged_frames": m["converged_frames"],
            "pair_overflow_max": m["pair_overflow_max"],
            "ms_per_frame": m["ms_per_frame_wall"],
            "k1_launches": by_method.get(name, 0)}
    row = {"phase": "corridor", "out_dir": os.path.relpath(out_dir),
           "rc": rc, "seconds": seconds, "k1_launches": launches,
           "dcreg_vs_none_max_m": dc_vs_none, "methods": rows}
    emit(row)
    ate_ok = all(abs(summary[m]["ate_raw_rmse_m"]
                     - recorded[m]["ate_raw_rmse_m"]) < CORRIDOR_ATE_TOL_M
                 for m in CORRIDOR_STABLE)
    if not (rc == 0 and ate_ok and dc_vs_none < 1e-4
            and all(summary[m]["pair_overflow_max"] == 0
                    for m in CORRIDOR_STABLE)
            and summary["DCReg"]["degenerate_frames"] == 45
            and summary["NONE"]["degenerate_frames"] == 0
            and (device == "cpu"
                 or all(r["k1_launches"] > 0 for r in rows.values()))):
        raise RuntimeError(f"corridor gates failed: {row}")

    det, hand = next((d, h) for m, d, h in rce.METHODS if m == "DCReg")
    solves, analyses = [], []
    res = recording(degeneracy.SCHUR6, recording(
        tsol.PCG6, lambda graph: rce.run_method(
            inp, det, hand, device, graph=graph), solves), analyses)(False)
    first = next((i for i, c in enumerate(solves)
                  if bool(c[2].is_degenerate.any())), 0)
    pcg6_rows = {"B1_corridor": check_kernel(tsol.PCG6, "B1_corridor",
                                             solves, first),
                 "B128_corridor": check_kernel(
                     tsol.PCG6, "B128_corridor",
                     [stacked_solves(solves[:128])])}
    if min(r["pcg_systems"] for r in pcg6_rows.values()) == 0:
        raise RuntimeError(f"the corridor's DCReg took no PCG: {pcg6_rows}")
    stacked = (torch.cat([c[0].reshape(-1, 6, 6) for c in analyses[:128]]),
               analyses[0][1])
    schur_rows = {
        "B1_corridor": check_kernel(degeneracy.SCHUR6, "B1_corridor",
                                    analyses),
        "B128_corridor": check_kernel(degeneracy.SCHUR6, "B128_corridor",
                                      [stacked])}
    # DCReg's frames through the twin: the poses depend on the analysis
    # (every frame is degenerate; P comes from its Schur fields)
    with degeneracy.SCHUR6.through_the_twin():
        twin = rce.run_method(inp, det, hand, device, graph=False)
    twin_row = {"phase": "corridor_schur6_vs_twin",
                "frames": int(res.iterations.numel()),
                "same_iterations": bool(torch.equal(res.iterations,
                                                    twin.iterations)),
                "pose_max_diff_m": float((res.poses[:, :3, 3].double()
                                          - twin.poses[:, :3, 3].double()
                                          ).norm(dim=-1).max()),
                "rot_max_diff_rad": float(rotation_diff_rad(
                    res.poses[:, :3, :3], twin.poses[:, :3, :3]).max()),
                "bit_equal": bit_equal([res.poses, res.iterations],
                                       [twin.poses, twin.iterations])}
    emit(twin_row)
    if not (twin_row["same_iterations"]
            and twin_row["pose_max_diff_m"] <= 1e-6
            and twin_row["rot_max_diff_rad"] <= 1e-6):
        raise RuntimeError(f"the corridor's DCReg with schur6 differs from "
                           f"it through the twin: {twin_row}")

    for name, det, hand in rce.METHODS:
        if name not in ("DCReg", "ME-TSVD"):
            continue
        held = {}

        def frames():
            held["res"] = rce.run_method(inp, det, hand, device,
                                         n_frames=CORRIDOR_PROFILE_FRAMES)

        frames()
        prof = profile_window(f"corridor_profile_{name}", frames)
        trips = int(held["res"].iterations.sum())
        prof["icp_iterations"] = trips
        prof["kernels_per_icp_iteration"] = prof["kernel_launches"] / trips
        prof["phase10_s"] = time.perf_counter() - t_start
        emit(prof)
    return (launches, k1_row, pcg6_rows, pcg6_launches, plane_launches,
            schur_rows, schur_launches)


def run_map_baselines(ctx, device: str = "cuda"):
    """(10b) ``bench.py``'s map-scale baseline rows through
    ``run_odometry_map`` on phase 2's map, capacities and first 16
    frames: ME-TSVD and ME-TReg gated on finite poses, zero overflow, no
    degenerate frame, every frame converged and the translation limits of
    ``bench.py:356-358``; FCN-SR on finite poses and no pair dropped from
    the list (the reuse guard's breach, at most one per frame, is
    counted), its error printed beside the JAX package's recorded row.
    Returns K1's launches in the timed runs."""
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.models.odometry import run_odometry_map
    from dcreg_tpu_torch.ops import block_knn as tk
    S, G, P = ctx["caps"]
    gt = ctx["gt"][:MAP_BASELINE_FRAMES]
    launches = 0
    for name, det, hand in MAP_BASELINES:
        def run_b(n):
            return run_odometry_map(
                ctx["frames"][:n], ctx["mindex"], ctx["world_t"],
                T0=ctx["T_pre1"], T_prev_init=ctx["T_pre2"], detection=det,
                handling=hand, icp_params=ICPParams(), num_supers=S,
                max_per_query=G, num_pairs=P, initial_cull_radius=R_CULL0,
                reuse_margin=REUSE_MARGIN, device=device)

        wall(lambda: run_b(MAP_BASELINE_WARM_FRAMES))
        tally = Tally()
        res, dt = wall(lambda: run_b(MAP_BASELINE_FRAMES))
        k1 = tally.launches(tk.K1)
        launches += k1
        est = res.poses.double().cpu().numpy()
        te = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
        row = {"phase": "map_baseline", "method": name,
               "frames": MAP_BASELINE_FRAMES,
               "ms_per_frame": dt / MAP_BASELINE_FRAMES * 1e3,
               "iters_per_frame": float(res.iterations.float().mean()),
               "te_mean_m": float(te.mean()), "te_max_m": float(te.max()),
               "converged_frac": float(res.converged.float().mean()),
               "degenerate_frames": int(res.is_degenerate.sum()),
               "ovf_max": int(res.pair_overflow.max()),
               "k1_launches": k1}
        ok = bool(np.isfinite(est).all()) and (device == "cpu" or k1 > 0)
        if name == "FCN-SR":
            row["recorded_jax_row"] = FCN_SR_RECORDED
            # FCN-SR drifts by design, so the reuse guard may fire (one
            # count per frame), on the same frames as in the JAX package
            # (tests/test_torch_map_baselines.py); the pair list at the
            # frame's seed must still hold every pair (k1_inputs raises
            # where it does not)
            ovf = res.pair_overflow.cpu().numpy()
            seeds = const_velocity_seeds(ctx["T_pre2"], ctx["T_pre1"], est)
            for f in np.nonzero(ovf)[0]:
                k1_inputs("map", ctx["frames"][f], ctx["mindex"],
                          seeds[f][None, :3, :3], seeds[f][None, :3, 3],
                          R_CULL0 + REUSE_MARGIN, {"S": S, "G": G, "P": P},
                          device)
            row["guard_breach_frames"] = int((ovf > 0).sum())
            ok = ok and row["ovf_max"] <= 1
        else:
            ok = ok and (row["ovf_max"] == 0
                         and row["degenerate_frames"] == 0
                         and bool(res.converged.all())
                         and te.mean() < 0.05 and te.max() < 0.10)
        emit(row)
        if not ok:
            raise RuntimeError(f"map-scale baseline gates failed: {row}")
    return launches


# --------------------------------------------------------------------------

K1_OPERANDS = ("src_blocks", "tgt", "poses", "qid", "tid", "pid",
               "lane_mask", "index_bits", "scale", "clamp", "nq_lane")


def run_mixed_tick(seed, frames_s, known, mindex, world_t, params,
                   device="cuda"):
    """The mixed fleet's first tick at its cell's shape
    (``mixed_fleet_inputs``: 32 robots at frames 0, 4, ..., 124, scans of
    their own sizes in a capacity of SCAN_POINTS): graphed, gated on one
    K1, plane_fit and pcg6 launch per step and one schur6 launch per step
    and for the epilogue, each from a replay; then eagerly, recording the
    kernels' operands as launched, gated on equal iterations and poses
    within 1e-6 m and 1e-6 rad of the graphed tick (bit-equality
    reported); K1 against its twin on the first step's inputs (the
    ragged prologue's pair list and the live mask), plane_fit on the
    first step, schur6 and pcg6 on every call (``B32_mix_first_tick``).
    Also gated: one graph launch and no host read for the tick, one
    condition launch per step (``pass_gates``).  Returns (K1's row,
    {kernel label: row}, {kernel label: launches}); the condition
    kernel's row and launches under ``loop_cond``."""
    from dcreg_tpu_torch.models.odometry import run_odometry_fleet
    from dcreg_tpu_torch.ops import block_knn as tk
    from dcreg_tpu_torch.ops import degeneracy, soa_tail
    from dcreg_tpu_torch.ops import solvers as tsol
    scans_p, counts, lanes, (S, G, P) = mixed_fleet_inputs(
        frames_s, known, mindex, seed)
    known_t = np.stack(known)
    scans_t = torch.as_tensor(scans_p, device=device)

    def tick(graph=None):
        return run_odometry_fleet(
            scans_t, mindex, world_t, known_t[[f + 1 for f in lanes]],
            known_t[lanes], icp_params=params, num_supers=S,
            max_per_query=G, num_pairs=P, initial_cull_radius=R_CULL0,
            reuse_margin=REUSE_MARGIN, counts=counts, device=device,
            graph=graph)

    K1, PLANE, PCG6, SCHUR = (tk.K1, soa_tail.PLANE_FIT, tsol.PCG6,
                              degeneracy.SCHUR6)
    tick()                                      # captures
    tally, passes = Tally(), Passes()
    res = tick()
    steps = int(res.iterations.max())
    loop_row = pass_gates("the mixed fleet's tick", passes, tally, 1, steps,
                          device)
    want = {K1: steps, PLANE: steps, PCG6: steps, SCHUR: steps + 1}
    launches = {k.label: tally.launches(k) for k in want}
    replayed = {k.label: tally.replayed(k) for k in want}
    row = {"phase": "mixed_fleet_tick", "sensors": MIX_SENSORS,
           "capacity": int(scans_p.shape[1]), "counts": counts.tolist(),
           "points": int(counts.sum()), "caps": [S, G, P],
           "frames": lanes, "iterations": res.iterations.tolist(),
           "steps": steps, "launches": launches, "replayed": replayed,
           "aborted": int(res.aborted.sum()),
           "ovf_max": int(res.pair_overflow.max()), "loop": loop_row}
    if not all(launches[k.label] == replayed[k.label] == n
               for k, n in want.items()):
        emit(row)
        raise RuntimeError(f"the mixed fleet's launches differ from one "
                           f"per step (schur6: and one for the epilogue): "
                           f"{row}")
    k1_calls, planes, solves, analyses = [], [], [], []
    eager = recording(K1, recording(SCHUR, recording(PLANE, recording(
        PCG6, tick, solves), planes, limit=1), analyses), k1_calls,
        limit=1)(False)
    row.update({
        "eager_same_iterations": bool(torch.equal(res.iterations,
                                                  eager.iterations)),
        "eager_pose_max_diff_m": float((res.poses[:, :3, 3].double()
                                        - eager.poses[:, :3, 3].double())
                                       .norm(dim=1).max()),
        "eager_rot_max_diff_rad": float(rotation_diff_rad(
            res.poses[:, :3, :3], eager.poses[:, :3, :3]).max()),
        "eager_bit_equal": bit_equal(res, eager)})
    emit(row)
    if not (row["aborted"] == 0 and row["ovf_max"] == 0
            and row["eager_same_iterations"]
            and row["eager_pose_max_diff_m"] <= 1e-6
            and row["eager_rot_max_diff_rad"] <= 1e-6):
        raise RuntimeError(f"the mixed fleet's tick failed its gates: {row}")
    a = dict(zip(K1_OPERANDS, k1_calls[0]))
    a["tgt"] = mindex.block.blocks          # the map's blocks, not a copy
    del k1_calls
    k1_row = check_k1("g_mix32_ragged_reuse_mask", a)
    name = "B32_mix_first_tick"
    rows = {PLANE.label: check_kernel(PLANE, name, planes,
                                      launches=launches[PLANE.label]),
            SCHUR.label: check_kernel(SCHUR, name, analyses,
                                      launches=launches[SCHUR.label]),
            PCG6.label: check_kernel(PCG6, name, solves),
            "loop_cond": loop_row}
    launches["loop_cond"] = loop_row["loop_cond_launches"]
    return k1_row, rows, launches


def run(seed: int, device: str = "cuda"):
    from dcreg_tpu_torch.models.icp import ICPParams
    from dcreg_tpu_torch.models.icp_batch import (estimate_map_capacities,
                                                  estimate_num_pairs,
                                                  icp_batch_so3)
    from dcreg_tpu_torch.models.odometry import (
        estimate_odometry_capacities, prepare_frames, run_odometry_map)
    from dcreg_tpu_torch import graphs
    from dcreg_tpu_torch.models.odometry import run_odometry_fleet
    from dcreg_tpu_torch.ops import block_knn as tk
    from dcreg_tpu_torch.ops import degeneracy, soa_tail
    from dcreg_tpu_torch.ops import solvers as tsol
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
    # the fleet's tick: each robot at its constant-velocity seed
    known = [T_pre2, T_pre1] + list(gt)
    lanes = [min(FLEET_SPACING * r, FRAMES - 1)
             for r in range(FLEET_SENSORS)]
    seeds = [known[f + 1] @ np.linalg.inv(known[f]) @ known[f + 1]
             for f in lanes]
    rows["g_fleet8_per_lane_reuse_mask"] = check_k1(
        "g_fleet8_per_lane_reuse_mask", k1_fleet_inputs(
            frames_s[lanes], mindex, np.stack([T[:3, :3] for T in seeds]),
            np.stack([T[:3, 3] for T in seeds]), {"S": S, "G": G, "P": P},
            device))
    check_k1_graph("a_map_B1_slotted_nomask", a_inputs)

    params = ICPParams()
    launches, pcg6_launches, plane_launches = {}, {}, {}
    schur_launches, schur_replayed = {}, {}
    PLANE, PCG6, SCHUR = soa_tail.PLANE_FIT, tsol.PCG6, degeneracy.SCHUR6

    # ---- 2. the localization loop, replayed as CUDA graphs ---------------
    def run_odom(n=FRAMES, graph=None, mi=mindex, wt=world_t, shift=None):
        T0, Tp = T_pre1.copy(), T_pre2.copy()
        if shift is not None:
            T0[:3, 3] += shift
            Tp[:3, 3] += shift
        return run_odometry_map(
            frames_s[:n], mi, wt, T0=T0, T_prev_init=Tp,
            icp_params=params, num_supers=S, max_per_query=G, num_pairs=P,
            initial_cull_radius=R_CULL0, reuse_margin=REUSE_MARGIN,
            device=device, graph=graph)

    cap0 = (graphs.CACHE.captures, graphs.CACHE.capture_seconds)
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    _, warm_s = wall(run_odom)
    capture_s = graphs.CACHE.capture_seconds - cap0[1]
    held_mib = [(torch.cuda.memory_allocated() - mem0[0]) / 2 ** 20,
                (torch.cuda.memory_reserved() - mem0[1]) / 2 ** 20]
    tally, passes = Tally(), Passes()
    res, dt = wall(run_odom)
    loop_rows = {"B1_map_pass": pass_gates(
        "the map loop", passes, tally, FRAMES, int(res.iterations.sum()),
        device)}
    loop_launches = {"odometry": loop_rows["B1_map_pass"]["steps"]}
    launches["odometry"] = tally.launches(tk.K1)
    pcg6_launches["odometry"] = tally.launches(PCG6)
    plane_launches["odometry"] = tally.launches(PLANE)
    plane_replayed = tally.replayed(PLANE)
    schur_launches["odometry"] = tally.launches(SCHUR)
    schur_replayed["odometry"] = tally.replayed(SCHUR)
    est = res.poses.cpu().numpy()
    te = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    odom = {"phase": "odometry", "frames": FRAMES, "graphed": True,
            "ms_per_frame": dt / FRAMES * 1e3, "warm_run_s": warm_s,
            "graph_captures": graphs.CACHE.captures - cap0[0],
            "graph_capture_s": capture_s,
            "held_after_capture_mib": {"allocated": held_mib[0],
                                       "reserved": held_mib[1]},
            "graph_pools_mib": graph_pools_mib(),
            "iters_per_frame": float(res.iterations.float().mean()),
            "te_mean_m": float(te.mean()), "te_max_m": float(te.max()),
            "converged_frac": float(res.converged.float().mean()),
            "ovf_max": int(res.pair_overflow.max()),
            "k1_launches": launches["odometry"],
            "k1_launches_per_frame": launches["odometry"] / FRAMES,
            "plane_fit_launches": plane_launches["odometry"],
            "plane_fit_launches_replayed": plane_replayed,
            "schur6_launches": schur_launches["odometry"],
            "schur6_launches_replayed": schur_replayed["odometry"],
            "icp_iterations": int(res.iterations.sum()),
            "loop": loop_rows["B1_map_pass"]}
    emit(odom)
    if not (bool(res.converged.all()) and odom["ovf_max"] == 0
            and te.mean() < 0.05 and te.max() < 0.10):
        raise RuntimeError(f"odometry gates failed: {odom}")
    # one plane_fit launch per ICP iteration, each from a replay
    if not (plane_replayed == plane_launches["odometry"]
            == odom["icp_iterations"]):
        raise RuntimeError(f"plane_fit launches differ from the loop's "
                           f"ICP iterations: {odom}")
    # one schur6 launch per ICP iteration and one per frame's epilogue,
    # each from a replay
    if not (schur_replayed["odometry"] == schur_launches["odometry"]
            == odom["icp_iterations"] + FRAMES):
        raise RuntimeError(f"schur6 launches differ from the loop's ICP "
                           f"iterations and frames: {odom}")
    map_solves, map_planes, map_analyses = [], [], []
    pcg6_rows, plane_rows, schur_rows = {}, {}, {}
    emit(eager_vs_graphed(recording(SCHUR, recording(PLANE, recording(
        PCG6, lambda graph: run_odom(EAGER_CHECK_FRAMES, graph), map_solves),
        map_planes, limit=1), map_analyses), "odometry_eager_vs_graphed"))
    emit(stale_cache_check(run_odom, res, world, device))
    # pcg6 on the eager pass's own systems, each as launched (B = 1)
    pcg6_rows["B1_map_pass"] = check_kernel(PCG6, "B1_map_pass", map_solves)
    # plane_fit on the eager pass's first ICP iteration, as launched
    plane_rows["B1_map_first_iteration"] = check_kernel(
        PLANE, "B1_map_first_iteration", map_planes,
        launches=plane_launches["odometry"])
    # schur6 on the eager pass's own analyses, each as launched (the
    # step's (1, 6, 6) and the epilogue's (6, 6))
    schur_rows["B1_map_pass"] = check_kernel(
        SCHUR, "B1_map_pass", map_analyses,
        launches=schur_launches["odometry"])
    # the 128 frames again, every plane fit through the plain twin (eager)
    with PLANE.through_the_twin():
        twin_res, twin_s = wall(lambda: run_odom(graph=False))
    twin_row = {"phase": "odometry_plane_fit_vs_twin", "frames": FRAMES,
                "twin_eager_s": twin_s,
                "same_iterations": bool(torch.equal(res.iterations,
                                                    twin_res.iterations)),
                "pose_max_diff_m": float((res.poses[:, :3, 3].double()
                                          - twin_res.poses[:, :3, 3].double()
                                          ).norm(dim=-1).max()),
                "rot_max_diff_rad": float(rotation_diff_rad(
                    res.poses[:, :3, :3], twin_res.poses[:, :3, :3]).max()),
                "bit_equal": bit_equal([res.poses, res.iterations],
                                       [twin_res.poses, twin_res.iterations])}
    emit(twin_row)
    if not (twin_row["same_iterations"]
            and twin_row["pose_max_diff_m"] <= 1e-6
            and twin_row["rot_max_diff_rad"] <= 1e-6):
        raise RuntimeError(f"the loop with plane_fit differs from the loop "
                           f"through its twin: {twin_row}")
    # and with every degeneracy analysis through schur6's twin (eager)
    with SCHUR.through_the_twin():
        twin_res, twin_s = wall(lambda: run_odom(graph=False))
    twin_row = {"phase": "odometry_schur6_vs_twin", "frames": FRAMES,
                "twin_eager_s": twin_s,
                "same_iterations": bool(torch.equal(res.iterations,
                                                    twin_res.iterations)),
                "bit_equal": bit_equal(
                    [res.poses, res.iterations, res.is_degenerate,
                     res.cond_schur_rot, res.cond_schur_trans],
                    [twin_res.poses, twin_res.iterations,
                     twin_res.is_degenerate, twin_res.cond_schur_rot,
                     twin_res.cond_schur_trans])}
    emit(twin_row)
    if not (twin_row["same_iterations"] and twin_row["bit_equal"]):
        raise RuntimeError(f"the loop with schur6 differs from the loop "
                           f"through its twin: {twin_row}")
    # the fleet's first tick (8 robots at frames 0, 16, ..., 112): graphed,
    # then eagerly with plane_fit's first launch recorded (B = 8)
    known_t = np.stack(known)
    fleet_args = dict(icp_params=params, num_supers=S, max_per_query=G,
                      num_pairs=P, initial_cull_radius=R_CULL0,
                      reuse_margin=REUSE_MARGIN, device=device)

    def fleet_tick(graph=None):
        return run_odometry_fleet(
            frames_s[lanes], mindex, world_t, known_t[[f + 1 for f in lanes]],
            known_t[lanes], graph=graph, **fleet_args)

    fleet_tick()
    tally, passes = Tally(), Passes()
    tick = fleet_tick()
    loop_rows["B8_fleet_first_tick"] = pass_gates(
        "the fleet's tick", passes, tally, 1, int(tick.iterations.max()),
        device)
    loop_launches["fleet_tick"] = loop_rows["B8_fleet_first_tick"]["steps"]
    plane_launches["fleet_tick"] = tally.launches(PLANE)
    schur_launches["fleet_tick"] = tally.launches(SCHUR)
    schur_replayed["fleet_tick"] = tally.replayed(SCHUR)
    steps = int(tick.iterations.max())
    if plane_launches["fleet_tick"] != steps:
        raise RuntimeError(f"plane_fit launches "
                           f"{plane_launches['fleet_tick']} differ from the "
                           f"fleet tick's steps {tick.iterations.tolist()}")
    # one schur6 launch per step and one for the tick's 8 frame analyses
    if not (schur_replayed["fleet_tick"] == schur_launches["fleet_tick"]
            == steps + 1):
        raise RuntimeError(f"schur6 launches {schur_launches['fleet_tick']} "
                           f"differ from the fleet tick's steps and "
                           f"epilogue {tick.iterations.tolist()}")
    fleet_planes, fleet_analyses = [], []
    recording(SCHUR, recording(PLANE, fleet_tick, fleet_planes, limit=1),
              fleet_analyses)(False)
    plane_rows["B8_fleet_first_tick"] = check_kernel(
        PLANE, "B8_fleet_first_tick", fleet_planes,
        launches=plane_launches["fleet_tick"])
    # schur6 on the tick's steps and its epilogue, each as launched (B = 8)
    schur_rows["B8_fleet_first_tick"] = check_kernel(
        SCHUR, "B8_fleet_first_tick", fleet_analyses,
        launches=schur_launches["fleet_tick"])
    # the mixed fleet's first tick: 32 scans of their own sizes (counts)
    k1_mix, mix_rows, mix_launches = run_mixed_tick(
        seed, frames_s, known, mindex, world_t, params, device)
    rows["g_mix32_ragged_reuse_mask"] = k1_mix
    launches["mix_tick"] = mix_launches[tk.K1.label]
    for kernel_rows, kernel_launches, label in (
            (plane_rows, plane_launches, PLANE.label),
            (schur_rows, schur_launches, SCHUR.label),
            (pcg6_rows, pcg6_launches, PCG6.label),
            (loop_rows, loop_launches, "loop_cond")):
        kernel_rows["B32_mix_first_tick"] = mix_rows[label]
        kernel_launches["mix_tick"] = mix_launches[label]
    for graph in (None, False):
        held = {}

        def window():
            held["res"] = run_odom(PROFILE_FRAMES, graph)

        prof = profile_window("odometry_profile" if graph is None
                              else "odometry_profile_eager", window)
        prof.update(launch_rates(prof, int(held["res"].iterations.sum())))
        emit(prof)
        if graph is None and device != "cpu" and not (
                prof["graph_launches"] == PROFILE_FRAMES
                and prof["launch_calls_per_icp_iteration"] < 50):
            raise RuntimeError(f"the graphed loop's profile does not show "
                               f"one graph launch per frame: {prof}")
        if graph is None:
            cond = [r for r in prof["port_kernels"]
                    if "loop_cond_kernel" in r["name"]]
            steps = int(held["res"].iterations.sum())
            loop_rows["B1_map_pass"].update(
                ms=cond[0]["ms"] / cond[0]["count"] if cond else None,
                profiled_launches=cond[0]["count"] if cond else 0,
                profiled_steps=steps)
            # the counters' launches, a pass's steps counted at settle,
            # against the kernels the profiler saw: one each per step
            seen = {label: sum(r["count"] for r in prof["port_kernels"]
                               if name in r["name"])
                    for label, name in COUNTED_NAMES.items()}
            if device != "cpu" and not (
                    seen == prof["counted_launches"]
                    == dict.fromkeys(COUNTED_NAMES, steps)):
                raise RuntimeError(
                    f"the graphed loop's profile saw {seen} launches of "
                    f"K1, plane_fit and loop_cond, its counters "
                    f"{prof['counted_launches']}, over {steps} steps")

    # ---- 3. Monte-Carlo batch, map mode, full telemetry ------------------
    def mc(graph=None):
        return icp_batch_so3(frames_s[0], world_t, R0s, t0s, DET, HAND,
                             params, mindex, P2, T_gt=gt[0], num_supers=S2,
                             max_per_query=G2, initial_cull_radius=MC_CULL0,
                             device=device, graph=graph)

    wall(mc)
    tally = Tally()
    out, dt = wall(mc)
    launches["mc_map"] = tally.launches(tk.K1)
    pcg6_launches["mc_map"] = tally.launches(PCG6)
    plane_launches["mc_map"] = tally.launches(PLANE)
    schur_launches["mc_map"] = tally.launches(SCHUR)
    mc_solves, mc_planes, mc_analyses = [], [], []
    eager = batch_against_eager(out, recording(SCHUR, recording(
        PLANE, recording(PCG6, mc, mc_solves), mc_planes, limit=1),
        mc_analyses))
    # pcg6 on the eager rerun's own systems, each as launched (B = 128)
    pcg6_rows["B128_mc_map"] = check_kernel(PCG6, "B128_mc_map", mc_solves)
    # plane_fit on the eager rerun's first ICP iteration (B = 128)
    plane_rows["B128_mc_frame"] = check_kernel(
        PLANE, "B128_mc_frame", mc_planes, launches=plane_launches["mc_map"])
    # schur6 on the eager rerun's own analyses (B = 128)
    schur_rows["B128_mc_map"] = check_kernel(
        SCHUR, "B128_mc_map", mc_analyses, launches=schur_launches["mc_map"])
    last = (out.iterations.long() - 1).clamp(min=0)
    lane = torch.arange(BATCH, device=last.device)
    te = out.log.trans_error[lane, last].cpu().numpy()
    re = out.log.rot_error_deg[lane, last].cpu().numpy()
    row = {"phase": "mc_map", "B": BATCH, "graphed": True,
           "reg_per_s": BATCH / dt,
           "seconds": dt, "iters_mean": float(out.iterations.float().mean()),
           "te_mean_m": float(te.mean()), "re_mean_deg": float(re.mean()),
           "converged_frac": float(out.converged.float().mean()),
           "pair_overflow": int(out.pair_overflow),
           "k1_launches": launches["mc_map"], **eager}
    emit(row)
    if not (bool(out.converged.all()) and row["pair_overflow"] == 0
            and te.mean() < 0.05 and re.mean() < 0.5
            and eager["eager_same_iterations"]
            and eager["eager_pose_max_diff"] <= 1e-5):
        raise RuntimeError(f"map-mode batch gates failed: {row}")
    emit(profile_window("mc_map_profile", mc))

    # ---- 4. BlockIndex batch, then eagerly, then through K1's twin -------
    blk_t = torch.as_tensor(blk, device=device)

    def blk_run(graph=None):
        return icp_batch_so3(blk_t, blk_t, R0b, t0b, DET, HAND, params,
                             bindex, Pb, device=device, graph=graph)

    wall(blk_run)
    tally = Tally()
    out, dt = wall(blk_run)
    launches["mc_block"] = tally.launches(tk.K1)
    pcg6_launches["mc_block"] = tally.launches(PCG6)
    plane_launches["mc_block"] = tally.launches(PLANE)
    schur_launches["mc_block"] = tally.launches(SCHUR)
    eager = batch_against_eager(out, blk_run)
    with tk.K1.through_the_twin():
        ref = blk_run(graph=False)
    last = (out.iterations.long() - 1).clamp(min=0)
    te = out.log.trans_error[lane, last].cpu().numpy()
    same_iters = bool(torch.equal(out.iterations, ref.iterations))
    pose_diff = max(float((out.R - ref.R).abs().max()),
                    float((out.t - ref.t).abs().max()))
    row = {"phase": "mc_block", "B": BATCH, "graphed": True,
           "reg_per_s": BATCH / dt,
           "seconds": dt, "iters_mean": float(out.iterations.float().mean()),
           "te_mean_m": float(te.mean()),
           "converged_frac": float(out.converged.float().mean()),
           "pair_overflow": int(out.pair_overflow),
           "plain_same_iterations": same_iters,
           "plain_pose_max_diff": pose_diff,
           "k1_launches": launches["mc_block"], **eager}
    emit(row)
    if not (bool(out.converged.all()) and row["pair_overflow"] == 0
            and same_iters and pose_diff <= 1e-5
            and eager["eager_same_iterations"]
            and eager["eager_pose_max_diff"] <= 1e-5):
        raise RuntimeError(f"BlockIndex batch gates failed: {row}")

    # ---- K1's entry of the kernels line (phase 7) -------------------------
    if min(launches.values()) <= 0:
        raise RuntimeError(f"K1 not launched on every path: {launches}")
    if min(pcg6_launches.values()) <= 0:
        raise RuntimeError(f"pcg6 not launched on every path: "
                           f"{pcg6_launches}")
    if min(plane_launches.values()) <= 0:
        raise RuntimeError(f"plane_fit not launched on every path: "
                           f"{plane_launches}")
    if min(schur_launches.values()) <= 0:
        raise RuntimeError(f"schur6 not launched on every path: "
                           f"{schur_launches}")
    for row in loop_rows.values():
        row.setdefault("ms", None)
        row.update(plain_ms=None, bound_ms=None, bound_by="latency")
    a = rows["a_map_B1_slotted_nomask"]
    ctx = {"world": world, "gt": gt, "frames": frames_s, "T_pre1": T_pre1,
           "T_pre2": T_pre2, "odom_poses": est.astype(np.float64),
           "mindex": mindex, "world_t": world_t, "caps": (S, G, P),
           "pcg6": (pcg6_rows, pcg6_launches),
           "plane_fit": (plane_rows, plane_launches),
           "schur6": (schur_rows, schur_launches),
           "loop_cond": (loop_rows, loop_launches)}
    return ctx, kernel_entry(
        tk.K1, "block_knn_keys", rows, launches, "a_map_B1_slotted_nomask",
        ("ms", "plain_ms", "bound_ms", "bound_by", "pairs", "B", "nsplit",
         "ctas", "run_max"), replaces="dcreg_tpu/ops/pallas_block_knn.py:91",
        max_abs_err=max(r["max_abs_err"] for r in rows.values()))


def build_kernels():
    """Build every CUDA source at once (one nvcc each, in parallel): the
    libraries of the port's kernels (``cuda_build.kernels``)."""
    from concurrent.futures import ThreadPoolExecutor
    from dcreg_tpu_torch.cuda_build import kernels
    by_source = {k.source.name: k for k in kernels()}
    with ThreadPoolExecutor(len(by_source)) as ex:
        futures = {name: ex.submit(k.build) for name, k in by_source.items()}
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
    ap.add_argument("--sharded-rank", nargs=5, help=argparse.SUPPRESS,
                    metavar=("RANK", "WORLD", "INIT", "DIR", "DEVICE"))
    args = ap.parse_args()
    if args.sharded_rank:               # one rank process of phase 9b
        r, w, init, workdir, dev = args.sharded_rank
        sharded_rank(int(r), int(w), init, workdir, dev)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from dcreg_tpu_torch import graphs
    from dcreg_tpu_torch.ops import knn_kernels as kn
    from dcreg_tpu_torch.ops import degeneracy, loop_cond, soa_tail, solvers
    build_kernels()
    ctx, k1 = run(args.seed)
    k2, k3 = run_pair(args.seed)
    for path, phase in (("voxel_knn_check", lambda: run_voxel(args.seed,
                                                               ctx)),
                        ("native_kdtree_check",
                         lambda: run_sharded(args.seed, ctx))):
        tally = Tally()
        n = phase()
        k2["launches"] += n
        k2["launches_by_path"][path] = n
        k2["launches_from_replays_by_path"][path] = tally.replayed(kn.K2)
    corridor, k1_corridor, pcg6_corridor, pcg6_corridor_launches, \
        plane_corridor_launches, schur_corridor, schur_corridor_launches = \
        run_corridor()
    k1["shapes"]["corridor_live_B1_reuse_mask"] = {
        f: k1_corridor[f] for f in k1["shapes"]["a_map_B1_slotted_nomask"]}
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_corridor["max_abs_err"])
    for path, n in (("corridor", corridor),
                    ("map_baselines", run_map_baselines(ctx))):
        k1["launches"] += n
        k1["launches_by_path"][path] = n
    emit({"phase": "graphs", "captures": graphs.CACHE.captures,
          "capture_s": graphs.CACHE.capture_seconds,
          "cached": len(graphs.CACHE), "pools_mib": graph_pools_mib()})
    pcg6_rows, pcg6_launches = ctx["pcg6"]
    pcg6_rows.update(pcg6_corridor)
    pcg6_launches["corridor"] = pcg6_corridor_launches
    plane_rows, plane_launches = ctx["plane_fit"]
    plane_launches["corridor"] = plane_corridor_launches
    if plane_corridor_launches <= 0:
        raise RuntimeError("plane_fit not launched on the corridor")
    schur_rows, schur_launches = ctx["schur6"]
    schur_rows.update(schur_corridor)
    schur_launches["corridor"] = schur_corridor_launches
    if schur_corridor_launches <= 0:
        raise RuntimeError("schur6 not launched on the corridor")
    emit({"kernels": [
        k1, k2, k3,
        kernel_entry(solvers.PCG6, "solve_pcg_fast", pcg6_rows,
                     pcg6_launches, "B1_map_pass", (
                         "batch", "systems", "pcg_systems",
                         "timed_pcg_trips", "ms", "plain_ms", "bound_ms",
                         "bound_by", "pcg_max_rel")),
        kernel_entry(soa_tail.PLANE_FIT, "_plane_fit", plane_rows,
                     plane_launches, "B1_map_first_iteration", (
                         "batch", "points", "ms", "plain_ms", "bound_ms",
                         "bound_by", "launches")),
        kernel_entry(degeneracy.SCHUR6, "analyze", schur_rows,
                     schur_launches, "B1_map_pass", (
                         "batch", "calls", "systems", "degenerate", "ms",
                         "plain_ms", "bound_ms", "bound_by")),
        kernel_entry(loop_cond.LOOP_COND, "drive", *ctx["loop_cond"],
                     "B1_map_pass", (
                         "passes", "steps", "graph_launches", "host_reads",
                         "loop_cond_launches", "loop_cond_replayed",
                         "ms"))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
