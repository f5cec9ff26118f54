"""The robot's online loop: one sensor, a closed loop.  Each frame is one
call of the port's ``run_odometry_map`` on one scan, seeded with the two
poses estimated before it; a frame counts when its pose is on the host.
The scene's trajectory is replayed in passes, each pass restarting from
the two known poses before frame 0.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import port


class Driver:

    def __init__(self, cfg, traffic, scene, device, parts, seed):
        from dcreg_tpu_torch.models.odometry import (
            estimate_odometry_capacities)
        from dcreg_tpu_torch.ops.block_sparse import build_map_index
        self.cfg, self.traffic, self.dev = cfg, traffic, device
        self.world, self.frames = scene["world"], scene["frames"]
        self.F = self.frames.shape[0]
        self.method = tuple(traffic["method"])
        sc = cfg["stream"]
        self.r0, self.margin = sc["initial_cull_radius"], sc["reuse_margin"]
        self.fast = sc["frame_analysis_fast"]
        f32 = lambda T: torch.as_tensor(T, dtype=torch.float32, device=device)
        self.T_init = (f32(scene["T_pre1"]), f32(scene["T_pre2"]))
        with parts.timed("build_map_index"):
            self.mindex = build_map_index(self.world.cpu().numpy(),
                                          tb=cfg["tb"], sb=cfg["sb"],
                                          device=device)
        with parts.timed("capacities"):
            self.caps = estimate_odometry_capacities(
                self.mindex, self.frames.cpu().numpy(), scene["gt"],
                self.r0 + self.margin, **sc["capacity"])
        self.params = port.icp_params(cfg["icp"])
        with parts.timed("warm_up"):
            self.run_pass()                     # captures the graphs

    def call(self, f, T1, T2):
        from dcreg_tpu_torch.models.odometry import run_odometry_map
        S, G, P = self.caps
        return run_odometry_map(
            self.frames[f:f + 1], self.mindex, self.world, T0=T1,
            T_prev_init=T2, detection=self.method[0],
            handling=self.method[1], icp_params=self.params, num_supers=S,
            max_per_query=G, num_pairs=P, initial_cull_radius=self.r0,
            reuse_margin=self.margin, frame_analysis_fast=self.fast,
            device=self.dev)

    def frames_until(self, stop):
        """Run frames until ``stop(n, elapsed)``; returns (records, wall
        seconds, per-frame latencies)."""
        records, lat = [], []
        T1, T2 = self.T_init
        f = 0
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            res = self.call(f, T1, T2)
            res.poses[0].cpu()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            records.append((f, T1, T2, res))
            T2, T1 = T1, res.poses[0]
            f += 1
            if f == self.F:
                f = 0
                T1, T2 = self.T_init
            if stop(len(records), t1 - t_start):
                return records, t1 - t_start, lat

    def run_pass(self):
        return self.frames_until(lambda n, _: n >= self.F)

    def window(self, seconds):
        self.records, wall, lat = self.frames_until(
            lambda _, el: el >= seconds)
        n = len(self.records)
        return {"frame_ms": wall / n * 1e3,
                "frame_p95_ms": float(np.percentile(np.asarray(lat) * 1e3,
                                                    95))}, wall

    def traced(self):
        """The traced window: ``trace_frames`` frames from a pass start."""
        self.records, wall, _ = self.frames_until(
            lambda n, _: n >= self.traffic["trace_frames"])
        return wall

    def outcome(self):
        """(attempted, failed, per-frame iterations): a frame fails when
        its registration aborted or its pair list overflowed."""
        res = [r[3] for r in self.records]
        it = torch.cat([r.iterations for r in res]).cpu().numpy()
        bad = torch.cat([r.aborted | (r.pair_overflow > 0) for r in res])
        return len(res), int(bad.sum()), it

    def counts(self):
        """Iterations of the window's frames, and how far one frame's
        position moved between the passes of the window (0 where every
        pass gave every frame the same pose)."""
        _, _, it = self.outcome()
        pos = {}
        for f, _, _, r in self.records:
            pos.setdefault(f, []).append(r.poses[0, :3, 3])
        moved = max((float((torch.stack(p) - p[0]).norm(dim=1).max())
                     for p in pos.values()), default=0.0)
        res = [r[3] for r in self.records]
        return {"iterations": float(it.sum()), "frames": len(it),
                "iters_per_frame": float(it.mean()),
                "pass_to_pass_m": moved,
                "aborted": int(torch.cat([r.aborted for r in res]).sum()),
                "overflowed": int(torch.cat([r.pair_overflow > 0
                                             for r in res]).sum())}

    def answers(self, gen):
        """A sample, drawn from ``gen``, of the window's frames (each
        frame of the pass once, as its last pass ran it) with their inputs
        and the program's answers, on the host."""
        last = {rec[0]: rec for rec in self.records}    # one per frame
        frames = sorted(last)
        n = min(self.traffic["check_answers"], len(frames))
        pick = torch.randperm(len(frames), generator=gen)[:n].tolist()
        out = []
        for i in pick:
            f, T1, T2, r = last[frames[i]]
            host = lambda x: x[0].double().cpu().numpy()
            out.append({
                "kind": "frame", "frame": f,
                "scan": self.frames[f].double(),
                "seed_pose": ("cv", T1.double().cpu(), T2.double().cpu()),
                "pose": host(r.poses), "iterations": int(r.iterations[0]),
                "cond_schur_rot": float(r.cond_schur_rot[0]),
                "cond_schur_trans": float(r.cond_schur_trans[0]),
                "cond_full": float(r.cond_full[0]),
                "rmse": float(r.rmse[0]),
                "cond_full_checked": not self.fast,
                "is_degenerate": bool(r.is_degenerate[0]),
                "degenerate_mask": r.degenerate_mask[0].cpu().tolist()})
        return out

    def release(self):
        """Drop the program's state: its index and the results."""
        self.mindex = self.records = None
