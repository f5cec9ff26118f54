"""The Monte-Carlo statistics batch: one frame registered from B perturbed
initial poses (drawn from the seed) in one call of the port's
``icp_batch_so3`` against the map index, with full telemetry; the batch
is repeated back to back, and counts when its poses are on the host.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import port
from seeds import generator


def rot_zyx(r, p, y):
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return (np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
            @ np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            @ np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]]))


class Driver:

    def __init__(self, cfg, traffic, scene, device, parts, seed):
        from dcreg_tpu_torch.models.icp_batch import estimate_map_capacities
        from dcreg_tpu_torch.ops.block_sparse import build_map_index
        self.cfg, self.traffic, self.dev = cfg, traffic, device
        self.world = scene["world"]
        f = traffic["frame"]
        self.scan = scene["frames"][f]
        self.T_gt = scene["gt"][f]
        self.B = traffic["batch"]
        self.method = tuple(traffic["method"])
        bc = cfg["batch"]
        self.r0 = bc["initial_cull_radius"]
        # perturbations of the ground truth: nominal sizes times a jitter
        g = generator(seed, "perturbation", "cpu")
        pt = traffic["perturbation"]
        nominal = torch.tensor(list(np.deg2rad(pt["rot_deg"]))
                               + list(pt["trans_m"]), dtype=torch.float64)
        lo, hi = pt["jitter"]
        pert = nominal * (lo + (hi - lo) * torch.rand(
            (self.B, 6), generator=g, dtype=torch.float64))
        pert = pert.numpy()
        self.R0 = np.stack([self.T_gt[:3, :3] @ rot_zyx(*p[:3]) for p in pert])
        self.t0 = self.T_gt[:3, 3][None] + pert[:, 3:]
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
        self.R0_d, self.t0_d = f32(self.R0), f32(self.t0)
        self.T_gt_d = f32(self.T_gt)
        with parts.timed("build_map_index"):
            self.mindex = build_map_index(self.world.cpu().numpy(),
                                          tb=cfg["tb"], sb=cfg["sb"],
                                          device=device)
        with parts.timed("capacities"):
            self.caps = estimate_map_capacities(
                self.mindex, self.scan.cpu().numpy(),
                list(zip(self.R0, self.t0)),
                self.r0 + bc["capacity_margin_radius"],
                include_identity=False)
        self.params = port.icp_params(
            cfg["icp"], full_telemetry=traffic["full_telemetry"])
        with parts.timed("warm_up"):
            self.batches_until(lambda n, _: n >= 1)   # captures the graphs

    def call(self):
        from dcreg_tpu_torch.models.icp_batch import icp_batch_so3
        S, G, P = self.caps
        return icp_batch_so3(
            self.scan, self.world, self.R0_d, self.t0_d, *port.method(
                self.method), self.params, self.mindex, P, T_gt=self.T_gt_d,
            num_supers=S, max_per_query=G, initial_cull_radius=self.r0,
            device=self.dev)

    def batches_until(self, stop):
        records, lat = [], []
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            out = self.call()
            R, t = out.R.cpu(), out.t.cpu()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            records.append({"R": R, "t": t, "iterations": out.iterations,
                            "aborted": out.aborted, "H_last": out.H_last,
                            "rmse": out.rmse,
                            "pair_overflow": out.pair_overflow})
            if stop(len(records), t1 - t_start):
                return records, t1 - t_start, lat

    def window(self, seconds):
        self.records, wall, _ = self.batches_until(
            lambda _, el: el >= seconds)
        return {"reg_per_s": self.B * len(self.records) / wall}, wall

    def traced(self):
        self.records, wall, _ = self.batches_until(
            lambda n, _: n >= self.traffic["trace_batches"])
        return wall

    def outcome(self):
        """(attempted, failed, per-batch steps): a registration fails when
        it aborted or its batch's pair list overflowed."""
        bad = sum(int((r["aborted"] | (r["pair_overflow"] > 0)).sum())
                  for r in self.records)
        steps = np.array([int(r["iterations"].max()) for r in self.records])
        return self.B * len(self.records), bad, steps

    def counts(self):
        _, _, steps = self.outcome()
        return {"iterations": float(steps.sum()), "batches": len(steps),
                "steps_per_batch": float(steps.mean())}

    def answers(self, gen):
        """A sample, drawn from ``gen``, of distinct lanes, as the window's
        last batch answered them (every batch registers the same lanes)."""
        n = min(self.traffic["check_answers"], self.B)
        r = self.records[-1]
        out = []
        for lane in torch.randperm(self.B, generator=gen)[:n].tolist():
            T = np.eye(4)
            T[:3, :3] = r["R"][lane].double().numpy()
            T[:3, 3] = r["t"][lane].double().numpy()
            out.append({
                "kind": "lane", "lane": lane, "scan": self.scan.double(),
                "seed_pose": ("pose", self.R0_d[lane].double().cpu(),
                              self.t0_d[lane].double().cpu()),
                "pose": T, "iterations": int(r["iterations"][lane]),
                "H_last": r["H_last"][lane].double().cpu().numpy(),
                "rmse": float(r["rmse"][lane])})
        return out

    def release(self):
        self.mindex = self.records = None
