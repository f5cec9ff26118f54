"""A mixed fleet's localization server: S robots of two LiDAR classes
against one shared map, a closed loop, as ``drivers/fleet.py`` runs it,
but each robot's scan of its own size.  Each tick is one call of the
port's ``run_odometry_fleet`` with the robots' current scans padded to
the fleet's capacity (``scan_points``) and their point counts
(``counts``).

Robot r is sparse where r % ``sparse_every`` is 0, else dense; the count
of each (robot, frame) is drawn from the seed, uniformly in its class's
range (``sparse_points``, ``dense_points``), and its scan is a random
subset of that many of the frame's points, kd-block-sorted (as the
fleet's contract asks), with zeros in the rows after it.  All 128 x S
scans are made on the device in set-up.  The capacities cover the full
frames and, per frame, one subset of the sparse class's least count: a
sparser scan's query blocks span more of the map, so they need more
target blocks per query block than the full frame's.

The check's answers are drawn per class (``check_sparse_answers`` of
them from sparse robots, the rest from dense ones), each with the
robot's unpadded scan.
"""
from __future__ import annotations

import importlib.util
import inspect
import os

import numpy as np
import torch

import kdorder
import port
from seeds import generator

_spec = importlib.util.spec_from_file_location(
    "drivers_fleet", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "fleet.py"))
fleet = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fleet)


def kd_leaf_order_runs(points, sizes, block: int = 128):
    """``kdorder.kd_leaf_order`` of every run of ``points`` at once: the
    runs are consecutive, of ``sizes`` points each; returns the
    permutation that orders each run's points into its leaves, in place
    of the run."""
    dev = points.device
    n = points.shape[0]
    perm = torch.arange(n, device=dev)
    starts = torch.cumsum(sizes, 0) - sizes
    while bool((sizes > block).any()):
        nseg = sizes.numel()
        seg = torch.repeat_interleave(torch.arange(nseg, device=dev), sizes)
        p = points[perm]
        lo, hi = kdorder._extents(p, seg, starts, sizes)
        axis = torch.argmax(hi - lo, dim=1)
        split = sizes > block
        key = torch.gather(p, 1, axis[seg][:, None])[:, 0]
        rank = torch.arange(n, device=dev) - starts[seg]
        low = torch.where(split[seg], kdorder._ordered_bits(key), rank)
        perm = perm[torch.argsort((seg << 32) | low)]
        nb = sizes // block
        k = torch.where(nb >= 2, (nb // 2) * block,
                        torch.full_like(nb, block))
        new = torch.stack([torch.where(split, k, sizes),
                           torch.where(split, sizes - k, 0)], 1).reshape(-1)
        sizes = new[new > 0]
        starts = torch.cumsum(sizes, 0) - sizes
    return perm


def subsets(frames, counts, gen):
    """(R, F, N, 3) scans: for each (row, frame) of ``counts`` (R, F), a
    random subset of that many of the frame's N points (``frames``
    (F, N, 3)), kd-block-sorted, then zeros."""
    R, F = counts.shape
    N = frames.shape[1]
    dev = frames.device
    keys = torch.rand((R, F, N), generator=gen, device=dev)
    rank = torch.argsort(torch.argsort(keys, dim=2), dim=2)
    keep = rank < counts[..., None]
    # the kept points first, in the frame's order
    idx = torch.argsort((~keep).to(torch.int8), dim=2, stable=True)
    pts = torch.gather(frames.expand(R, F, N, 3), 2,
                       idx[..., None].expand(R, F, N, 3))
    valid = torch.arange(N, device=dev) < counts[..., None]
    flat = pts[valid]
    out = torch.zeros_like(pts)
    out[valid] = flat[kd_leaf_order_runs(flat, counts.reshape(-1))]
    return out


class Driver(fleet.Driver):

    def __init__(self, cfg, traffic, scene, device, parts, seed):
        # first: a program whose fleet takes no counts fails here, before
        # the index is built
        from dcreg_tpu_torch.models.odometry import (
            estimate_odometry_capacities, run_odometry_fleet)
        if "counts" not in inspect.signature(run_odometry_fleet).parameters:
            raise TypeError("run_odometry_fleet takes no counts: this "
                            "program cannot register scans of their own "
                            "sizes")
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
        known = [scene["T_pre2"], scene["T_pre1"]] + list(scene["gt"])
        f32 = lambda T: torch.as_tensor(np.asarray(T), dtype=torch.float32,
                                        device=device)
        self.T_init = (f32([known[s + 1] for s in self.start]),
                       f32([known[s] for s in self.start]))
        self.sparse = [r % cfg["sparse_every"] == 0 for r in range(self.L)]
        with parts.timed("scans"):
            lo, hi = (torch.as_tensor(
                [cfg["sparse_points" if s else "dense_points"][i]
                 for s in self.sparse], device=device) for i in (0, 1))
            u = torch.rand((self.L, self.F), generator=generator(
                seed, "mixed_counts", device), device=device)
            counts = lo[:, None] + (u * (hi - lo + 1)[:, None]).long()
            counts = torch.minimum(counts, hi[:, None])
            self.scans = subsets(self.frames, counts,
                                 generator(seed, "mixed_scans", device))
            self.counts_host = counts.cpu().numpy()
            least = torch.full((1, self.F), cfg["sparse_points"][0],
                               device=device)
            thin = subsets(self.frames, least,
                           generator(seed, "mixed_thin", device))
            thin = thin[0, :, :cfg["sparse_points"][0]].cpu().numpy()
            # the scans the readers reckon the work from
            scene["mixed"] = {"scans": self.scans,
                              "counts": self.counts_host}
        self.lane_ix = torch.arange(self.L, device=device)
        with parts.timed("build_map_index"):
            self.mindex = build_map_index(self.world.cpu().numpy(),
                                          tb=cfg["tb"], sb=cfg["sb"],
                                          device=device)
        with parts.timed("capacities"):
            r = self.r0 + self.margin
            full = estimate_odometry_capacities(
                self.mindex, self.frames.cpu().numpy(), scene["gt"], r,
                **sc["capacity"])
            sparse = estimate_odometry_capacities(
                self.mindex, thin, scene["gt"], r, **sc["capacity"])
            self.caps = tuple(max(a, b) for a, b in zip(full, sparse))
        self.params = port.icp_params(cfg["icp"])
        with parts.timed("warm_up"):
            self.run_pass()                     # captures the graphs

    def ticks_until(self, stop):
        """``drivers/fleet.py``'s, from the first tick of a pass."""
        self.tick = 0
        return super().ticks_until(stop)

    def call(self, at, T1, T2):
        """One tick: each robot's scan at its frame ``at`` (on the card)
        with its count, from the host: robot r is at frame start_r +
        tick % (F - start_r), as ``ticks_until`` steps and restarts it."""
        S, G, P = self.caps
        frame = [s + self.tick % (self.F - s) for s in self.start]
        self.tick += 1
        return self.fleet_call(
            self.scans[self.lane_ix, at], self.mindex, self.world, T1, T2,
            detection=self.method[0], handling=self.method[1],
            icp_params=self.params, num_supers=S, max_per_query=G,
            num_pairs=P, initial_cull_radius=self.r0,
            reuse_margin=self.margin, frame_analysis_fast=self.fast,
            counts=self.counts_host[np.arange(self.L), frame],
            device=self.dev)

    def counts(self):
        """``drivers/fleet.py``'s counts, the window's valid points per
        tick against its capacity, and the capacities the lanes ran
        with."""
        out = super().counts()
        points = sum(int(self.counts_host[np.arange(self.L), f].sum())
                     for f, _, _, _ in self.records)
        out["points_per_tick"] = points / len(self.records)
        out["capacity_per_tick"] = self.L * self.frames.shape[1]
        out["capacities"] = list(self.caps)
        return out

    def answers(self, gen):
        """``drivers/fleet.py``'s sample, drawn per class: each answer
        with its robot's unpadded scan and count."""
        last = {}
        for frames, T1, T2, r in self.records:
            for lane, f in enumerate(frames):
                last[(lane, f)] = (T1, T2, r)
        total = self.traffic["check_answers"]
        n_sparse = self.traffic["check_sparse_answers"]
        out = []
        for sparse, n in ((True, n_sparse), (False, total - n_sparse)):
            keys = sorted(k for k in last if self.sparse[k[0]] == sparse)
            n = min(n, len(keys))
            pick = torch.randperm(len(keys), generator=gen)[:n].tolist()
            for i in pick:
                lane, f = keys[i]
                T1, T2, r = last[keys[i]]
                count = int(self.counts_host[lane, f])
                out.append({
                    "kind": "frame", "frame": f, "robot": lane,
                    "points": count,
                    "scan": self.scans[lane, f, :count].double(),
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
                    "degenerate_mask": r.degenerate_mask[lane].cpu()
                    .tolist()})
        return out
