"""A fleet's localization server: S robots against one shared map, a
closed loop.  Each tick is one call of the port's ``run_odometry_fleet``
that registers the current scan of every robot, each seeded by its own
two previous estimates; the next tick starts when every pose of the last
one is on the host, and each of its frames counts then.

Robot r replays the scene's trajectory from frame ``robot_spacing_frames``
x r, from the ground truth's two poses before that frame, and at the
path's end restarts there from those two known poses, as the stream
driver restarts from frame 0.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import port


class Driver:

    def __init__(self, cfg, traffic, scene, device, parts, seed):
        # first: a program without the fleet's entry point fails here,
        # before the index is built
        from dcreg_tpu_torch.models.odometry import (
            estimate_odometry_capacities, run_odometry_fleet)
        from dcreg_tpu_torch.ops.block_sparse import build_map_index
        self.fleet_call = run_odometry_fleet
        self.cfg, self.traffic, self.dev = cfg, traffic, device
        self.world, self.frames = scene["world"], scene["frames"]
        self.F = self.frames.shape[0]
        self.L = cfg["sensors"]
        self.start = [min(cfg["robot_spacing_frames"] * r, self.F - 1)
                      for r in range(self.L)]
        self.method = tuple(traffic["method"])
        sc = cfg["stream"]
        self.r0, self.margin = sc["initial_cull_radius"], sc["reuse_margin"]
        self.fast = sc["frame_analysis_fast"]
        # the two known poses before each robot's start frame
        known = [scene["T_pre2"], scene["T_pre1"]] + list(scene["gt"])
        f32 = lambda T: torch.as_tensor(np.asarray(T), dtype=torch.float32,
                                        device=device)
        self.T_init = (f32([known[s + 1] for s in self.start]),
                       f32([known[s] for s in self.start]))
        with parts.timed("build_map_index"):
            self.mindex = build_map_index(self.world.cpu().numpy(),
                                          tb=cfg["tb"], sb=cfg["sb"],
                                          device=device)
        with parts.timed("capacities"):
            # every frame any robot scans, at its pose, the one before and
            # the constant-velocity prediction: every lane of every tick
            self.caps = estimate_odometry_capacities(
                self.mindex, self.frames.cpu().numpy(), scene["gt"],
                self.r0 + self.margin, **sc["capacity"])
        self.params = port.icp_params(cfg["icp"])
        with parts.timed("warm_up"):
            self.run_pass()                     # captures the graphs

    def call(self, at, T1, T2):
        S, G, P = self.caps
        return self.fleet_call(
            self.frames[at], self.mindex, self.world, T1, T2,
            detection=self.method[0], handling=self.method[1],
            icp_params=self.params, num_supers=S, max_per_query=G,
            num_pairs=P, initial_cull_radius=self.r0,
            reuse_margin=self.margin, frame_analysis_fast=self.fast,
            device=self.dev)

    def ticks_until(self, stop):
        """Run ticks until ``stop(ticks, elapsed)``; returns (records,
        wall seconds, per-tick latencies).  A record is (frames (L,),
        T1, T2, result) of one tick."""
        records, lat = [], []
        T1, T2 = self.T_init
        frame = list(self.start)
        t_start = time.perf_counter()
        while True:
            at = torch.as_tensor(frame, device=self.dev)
            t0 = time.perf_counter()
            res = self.call(at, T1, T2)
            res.poses.cpu()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            records.append((list(frame), T1, T2, res))
            T2, T1 = T1, res.poses
            frame = [f + 1 for f in frame]
            ends = [r for r, f in enumerate(frame) if f == self.F]
            if ends:
                T1, T2 = T1.clone(), T2.clone()
                for r in ends:
                    frame[r] = self.start[r]
                    T1[r], T2[r] = self.T_init[0][r], self.T_init[1][r]
            if stop(len(records), t1 - t_start):
                return records, t1 - t_start, lat

    def run_pass(self):
        """Ticks until every robot has run its path once."""
        return self.ticks_until(lambda n, _: n >= self.F - min(self.start))

    def window(self, seconds):
        self.records, wall, lat = self.ticks_until(
            lambda _, el: el >= seconds)
        frames = self.L * len(self.records)
        # every frame's latency is its tick's
        per_frame = np.repeat(np.asarray(lat) * 1e3, self.L)
        return {"frame_ms": wall / frames * 1e3,
                "frame_p95_ms": float(np.percentile(per_frame, 95))}, wall

    def traced(self):
        """The traced window: ``trace_ticks`` ticks from a pass start."""
        self.records, wall, _ = self.ticks_until(
            lambda n, _: n >= self.traffic["trace_ticks"])
        return wall

    def _stacked(self, name):
        return torch.stack([getattr(r[3], name) for r in self.records])

    def outcome(self):
        """(attempted, failed, per-frame iterations (ticks, L)): a frame
        fails when its registration aborted or its pair list
        overflowed."""
        it = self._stacked("iterations").cpu().numpy()
        bad = self._stacked("aborted") | (self._stacked("pair_overflow") > 0)
        return it.size, int(bad.sum()), it

    def counts(self):
        """The window's iterations, step replays per tick (the slowest
        lane's iterations), the share of lane-steps that did work, and
        how far a (robot, frame)'s position moved between its passes."""
        _, _, it = self.outcome()
        steps = it.max(axis=1)
        pos = {}
        for frames, _, _, r in self.records:
            for lane, f in enumerate(frames):
                pos.setdefault((lane, f), []).append(r.poses[lane, :3, 3])
        moved = max((float((torch.stack(p) - p[0]).norm(dim=1).max())
                     for p in pos.values()), default=0.0)
        return {"iterations": float(it.sum()), "frames": int(it.size),
                "ticks": len(it), "sensors": self.L,
                "steps": float(steps.sum()),
                "steps_per_tick": float(steps.mean()),
                "lane_occupancy": 100.0 * float(it.sum())
                / (self.L * float(steps.sum())),
                "iters_per_frame": float(it.mean()),
                "pass_to_pass_m": moved,
                "aborted": int(self._stacked("aborted").sum()),
                "overflowed": int((self._stacked("pair_overflow") > 0)
                                  .sum())}

    def answers(self, gen):
        """A sample, drawn from ``gen``, of the window's (robot, frame)
        registrations, each as its last pass ran it, with their inputs and
        the program's answers, on the host."""
        last = {}
        for frames, T1, T2, r in self.records:
            for lane, f in enumerate(frames):
                last[(lane, f)] = (T1, T2, r)
        keys = sorted(last)
        n = min(self.traffic["check_answers"], len(keys))
        pick = torch.randperm(len(keys), generator=gen)[:n].tolist()
        out = []
        for i in pick:
            lane, f = keys[i]
            T1, T2, r = last[keys[i]]
            out.append({
                "kind": "frame", "frame": f, "robot": lane,
                "scan": self.frames[f].double(),
                "seed_pose": ("cv", T1[lane].double().cpu(),
                              T2[lane].double().cpu()),
                "pose": r.poses[lane].double().cpu().numpy(),
                "iterations": int(r.iterations[lane]),
                "cond_schur_rot": float(r.cond_schur_rot[lane]),
                "cond_schur_trans": float(r.cond_schur_trans[lane]),
                "cond_full": float(r.cond_full[lane]),
                "rmse": float(r.rmse[lane]),
                "cond_full_checked": not self.fast,
                "is_degenerate": bool(r.is_degenerate[lane]),
                "degenerate_mask": r.degenerate_mask[lane].cpu().tolist()})
        return out

    def release(self):
        """Drop the program's state: its index and the results."""
        self.mindex = self.records = None
