"""Batched Monte-Carlo ICP engine: all pose lanes advance together
(counterpart of ``dcreg_tpu/models/icp_batch.py``).

Per iteration ONE pair list is built from the union of every lane's
relevant (query block, target block) interactions and ONE K1 call answers
all lanes' 5-NN queries; the SoA tail, Schur analysis, PCG solve and
boxplus run batched over lanes.  The JAX ``jit`` over a ``while_loop``
with per-lane freeze is a prologue, a step and an epilogue over fixed
state tensors (``BatchLoop``), captured as CUDA graphs on the card and
replayed (``graphs``): a pass is one launch in which the card tests the
done flag ``all(converged | aborted)`` after each step (``ops/loop_cond``;
the host loop of ``graphs.host_pass`` where the parts run eagerly), and
each lane freezes under
the JAX rule, so per-lane iteration counts are the JAX engine's.

Requirements as in the JAX module: source/target spatially sorted, the
index built with tb = 128 over the sorted target, f32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import graphs
from ..ops import se3
from ..ops.block_knn import (QB, batched_block_knn, exact_qbox,
                             hier_relevance, lane_relevance, make_pair_list,
                             make_pair_list_slotted, pack_lane_mask,
                             super_candidates)
from ..ops.block_sparse import BlockIndex, MapIndex
from ..ops.degeneracy import DetectionMethod, HandlingMethod, analyze
from ..ops.soa_tail import batched_tail_system
from ..ops.solvers import solve
from ..utils import check_precise, resolve_device
from .icp import (Hist, ICPParams, IterationLog, _empty_log,
                  covariance_from_H, empty_hist, telemetry_row)


class BatchICPResult(NamedTuple):
    R: torch.Tensor             # (B, 3, 3)
    t: torch.Tensor             # (B, 3)
    converged: torch.Tensor     # (B,) bool
    aborted: torch.Tensor       # (B,) bool
    iterations: torch.Tensor    # (B,) int32
    covariance: torch.Tensor    # (B, 6, 6)
    log: object                 # IterationLog with (B, I, ...) fields
    pair_overflow: torch.Tensor  # () max dropped pairs over iterations
    #   (+ reuse-guard breaches in reuse mode)
    H_last: torch.Tensor        # (B, 6, 6) final-iteration Hessian
    rmse: torch.Tensor          # (B,)
    fitness: torch.Tensor       # (B,)
    num_valid: torch.Tensor     # (B,) int32


def _index_device(index):
    bi = index.block if isinstance(index, MapIndex) else index
    return bi.blocks.device


class BatchLoop:
    """One configuration of ``icp_batch_so3`` split into the parts of its
    compiled loop, each reading and writing a ``graphs.State`` in place.
    Its lanes register one source scan from B initial poses, or, with
    ``per_lane`` (map mode with a reused pair list: the fleet's map
    loop), B scans of their own, one per lane, each with its own pair
    list, cull and query blocks, and K1 in its per-lane mode:

      * ``load`` copies the per-call inputs into the state: source
        ``src`` ((N, 3), or (B, N, 3) per lane), ``R0``, ``t0``,
        ``T_gt``; with ``ragged`` (per lane only) also ``count`` (B,),
        each lane's number of points: its first ``count`` rows are its
        scan, the rest pads whose values nothing reads (the prologue
        overwrites them with the lane's last point, the cull drops the
        query blocks they fill, the tail counts no pad row);
      * ``prologue`` the static query-block prep, in reuse mode the cull
        and the pair list at the initial pose, and the loop state;
      * ``step`` one iteration for every lane still active (``iterate``)
        and the state update, writing the history at the device-side
        iteration counter ``it`` and setting the ``done`` flag the loop's
        condition reads after each step (per lane: ``left``, the lanes
        still running and those aborted or over their pair list,
        ``graphs.drive_lanes``);
      * ``epilogue`` the reuse guard, ``H_last``, and the telemetry pass
        or the covariance.

    ``key()`` holds every static the parts bake in, and the address and
    layout of the tensors they read in place (the index and the target).
    """

    def __init__(self, index, target_xyz, B: int, N: int,
                 detection: DetectionMethod, handling: HandlingMethod,
                 params: ICPParams, num_pairs: int, num_supers: int,
                 max_per_query: int, initial_cull_radius, reuse_pair_list,
                 device, per_lane: bool = False, ragged: bool = False):
        self.map_mode = isinstance(index, MapIndex)
        if self.map_mode and (num_supers <= 0 or max_per_query <= 0):
            raise ValueError("map mode needs num_supers and max_per_query")
        if per_lane and not (self.map_mode and reuse_pair_list > 0):
            raise ValueError("a source per lane needs map mode with a "
                             "reused pair list (reuse_pair_list > 0)")
        if ragged and not per_lane:
            raise ValueError("a point count per lane needs a source per lane")
        self.index, self.target = index, target_xyz
        self.mindex = index if self.map_mode else None
        self.bi = index.block if self.map_mode else index
        self.B, self.N, self.nq = B, N, -(-N // QB)
        self.detection, self.handling, self.params = detection, handling, \
            params
        self.num_pairs, self.num_supers = num_pairs, num_supers
        self.max_per_query = max_per_query
        self.reuse_pair_list = float(reuse_pair_list)
        self.per_lane, self.ragged = per_lane, ragged
        self.reuse = self.map_mode and self.reuse_pair_list > 0 and (
            B == 1 or per_lane)
        self.radius = params.corr.search_radius
        self.r0 = float(self.radius if initial_cull_radius is None
                        else initial_cull_radius)
        self.fast = (detection is DetectionMethod.SCHUR_CONDITION_NUMBER and
                     handling is HandlingMethod.PRECONDITIONED_CG)
        self.dev, self.dtype = device, torch.float32

    def key(self) -> tuple:
        mode = "reuse" if self.reuse else "map" if self.map_mode else "block"
        if self.per_lane:
            mode = "reuse_lanes_ragged" if self.ragged else "reuse_lanes"
        return ("icp_batch_so3", mode, self.B, self.N, self.nq,
                self.num_pairs, self.num_supers, self.max_per_query,
                self.detection, self.handling, self.params, self.r0,
                self.reuse_pair_list, str(self.dtype), str(self.dev),
                graphs.tensor_key(self.index, self.target))

    def load(self, S, source_xyz, R0s, t0s, T_gt) -> None:
        S.put("src", source_xyz)
        S.put("R0", R0s)
        S.put("t0", t0s)
        S.put("T_gt", T_gt)

    def prologue(self, S) -> None:
        B, N, nq, dev, dtype = self.B, self.N, self.nq, self.dev, self.dtype
        f32 = lambda v: torch.full((), v, dtype=dtype, device=dev)
        src = S.src
        # ---- static query-block prep (body frame) ------------------------
        if self.per_lane:
            if self.ragged:
                # a lane's pad rows take its last point, so no pad value
                # reaches the boxes, ``pmax`` or the search
                last = torch.gather(src, 1, (S.count - 1)[:, None, None]
                                    .expand(B, 1, 3))
                pad = torch.arange(N, device=dev) >= S.count[:, None]
                S.put("src", torch.where(pad[:, :, None], last, src))
                src = S.src
            src_pad = torch.cat([src, src[:, -1:].expand(B, nq * QB - N, 3)],
                                dim=1)
            src_q = src_pad.reshape(B, nq, QB, 3)
            S.put("src_q", src_q)
            S.put("src_blocks", src_q.reshape(B * nq, QB, 3).transpose(
                1, 2).contiguous())                          # (B*nq,3,QB)
            S.put("slo", torch.amin(src_q, dim=2))
            S.put("shi", torch.amax(src_q, dim=2))
            S.put("pmax", torch.sqrt(torch.amax(torch.sum(src * src, dim=2),
                                                dim=1)))
        else:
            src_pad = torch.cat([src, src[-1:].expand(nq * QB - N, 3)])
            src_q = src_pad.reshape(nq, QB, 3)
            S.put("src_q", src_q)
            S.put("src_blocks", src_q.transpose(1, 2).contiguous())
            S.put("slo", torch.amin(src_q, dim=1))
            S.put("shi", torch.amax(src_q, dim=1))
            # a source point moves at most |dw| * pmax + |dv| per iteration
            S.put("pmax", torch.sqrt(torch.amax(torch.sum(src * src,
                                                          dim=1))))
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ovf = zero
        if self.reuse:
            bi, mindex = self.bi, self.mindex
            r_list = f32(self.r0) + f32(self.reuse_pair_list)
            qbox0 = exact_qbox(S.src_q, S.R0, S.t0)
            lanes = 0
            if self.per_lane:
                # the lanes' query blocks as one lane's, each at its pose
                qbox0 = tuple(x.reshape(1, B * nq, 3) for x in qbox0)
                lanes = B
            sup_sel0, sup_ok0, sup_ovf0 = super_candidates(
                S.slo, S.shi, S.R0, S.t0, mindex, r_list, self.num_supers,
                qbox=qbox0, lanes=lanes)
            rel_l0, block_ids0 = hier_relevance(
                S.slo, S.shi, S.R0, S.t0, mindex, sup_sel0, sup_ok0, r_list,
                qbox=qbox0)
            rel0 = torch.any(rel_l0, dim=0)
            if self.ragged:
                # a query block past its lane's count holds pads alone
                filled = (torch.arange(nq, device=dev) * QB
                          < S.count[:, None]).reshape(B * nq)
                rel0 = rel0 & filled[:, None]
            qid0, tid0, slot0, _, table0, ovf0, run_ovf0 = \
                make_pair_list_slotted(rel0, self.num_pairs,
                                       self.max_per_query,
                                       block_ids=block_ids0,
                                       nbt=bi.num_blocks, lanes=lanes)
            ovf = ovf0 + run_ovf0 + sup_ovf0
            S.put("qid0", qid0)
            S.put("tid0", tid0)
            S.put("slot0", slot0)
            S.put("table0", table0)
            S.put("covered0", torch.any(rel0, dim=1))
            # static per-pair target bboxes for the per-iteration LIVE mask
            pad0 = qid0 >= (B * nq if self.per_lane else nq)
            tid_safe0 = torch.where(pad0, 0, tid0).long()
            S.put("pad0", pad0)
            S.put("p_tlo0", torch.where(pad0[:, None], 3e38,
                                        bi.lo[tid_safe0]))
            S.put("p_thi0", torch.where(pad0[:, None], -3e38,
                                        bi.hi[tid_safe0]))
            S.put("qid_safe0", torch.where(pad0, 0, qid0).long())
            if self.per_lane:
                S.put("lane0", S.qid_safe0 // nq)    # each pair's lane
        # ---- the loop state ----------------------------------------------
        I = self.params.max_iterations
        S.put("Rs", S.R0)
        S.put("ts", S.t0)
        S.put("conv", torch.zeros(B, dtype=torch.bool, device=dev))
        S.put("abt", torch.zeros(B, dtype=torch.bool, device=dev))
        S.put("iters", torch.zeros(B, dtype=torch.int32, device=dev))
        S.put_tuple("hist", empty_hist(I, dtype, lead=(B,), device=dev))
        S.put("ovf", ovf)
        S.put("r_cull", torch.full((B, nq), self.r0, dtype=dtype,
                                   device=dev))
        S.put("cum_move", torch.zeros(B, dtype=dtype, device=dev))
        S.put("it", zero)
        S.put("done", torch.zeros((), dtype=torch.bool, device=dev))

    def iterate(self, S, Rs, ts, r_cull, active):
        """One ICP iteration of every lane at (Rs, ts): (system, dx,
        abort_now, overflow, d5bm).  Its modules are marked (``search``,
        ``tail.planes``, ``tail.system``, ``degeneracy``, ``solve``)."""
        B, nq, N = self.B, self.nq, self.N
        params = self.params
        with graphs.mark("search"):
            vals, idx, overflow = self.search(S, Rs, ts, r_cull, active)
            # exact 5th-NN distance per (lane, query block); BIG where a
            # block was uncovered -> the next radius falls back to the
            # full one
            k = params.corr.k
            d5row = vals[:, k - 1, :]
            d5bm = torch.sqrt(torch.amax(d5row.reshape(B, nq, QB), dim=2))
        sysm = batched_tail_system(
            S.src, self.target, Rs, ts, sq_d5=d5row[:, :N],
            idx_kn=idx[:, :k, :N], params=params.corr,
            use_weight_derivative=params.use_weight_derivative,
            weight_slope=params.corr.weight_slope,
            count=S.count if self.ragged else None)
        with graphs.mark("degeneracy"):
            analysis = analyze(sysm.H, self.detection, params.thresholds,
                               fast=self.fast)
        with graphs.mark("solve"):
            dx, _ = solve(sysm.H, sysm.g, self.handling, analysis,
                          params.thresholds, telemetry=False,
                          fast=self.fast)
            too_few = sysm.num_valid < params.min_effective_points
            bad_dx = ~torch.all(torch.isfinite(dx), dim=-1)
            abort_now = too_few | bad_dx
            dx = torch.where(abort_now[:, None], 0.0, dx)
        return sysm, dx, abort_now, overflow, d5bm

    def search(self, S, Rs, ts, r_cull, active):
        """The pair list (reused, or culled at (Rs, ts)) and K1's 5-NN
        answer over it: (vals, idx, overflow)."""
        B, bi = self.B, self.bi
        knn_kwargs = {}
        if self.reuse:
            qid, tid = S.qid0, S.tid0
            overflow = torch.zeros((), dtype=torch.int64, device=self.dev)
            covered = S.covered0
            knn_kwargs = dict(slot=S.slot0, tid_table=S.table0,
                              max_per_query=self.max_per_query)
            # live mask: pairs within this iteration's exact radius
            qlo_b, qhi_b = exact_qbox(S.src_q, Rs, ts)
            if self.per_lane:
                qlo, qhi = qlo_b.reshape(-1, 3), qhi_b.reshape(-1, 3)
                r_q = r_cull.reshape(-1)
            else:
                qlo, qhi, r_q = qlo_b[0], qhi_b[0], r_cull[0]
            qs = S.qid_safe0
            gap = torch.clamp(torch.maximum(qlo[qs] - S.p_thi0,
                                            S.p_tlo0 - qhi[qs]), min=0.0)
            d2p = torch.sum(gap * gap, dim=-1)
            rq = r_q[qs]
            live = (d2p <= rq * rq) & ~S.pad0
            if self.per_lane:
                live = live & active[S.lane0]    # a done lane searches not
            lmask = live.to(torch.int32)[:, None]
        elif self.map_mode:
            mindex = self.mindex
            qbox_i = exact_qbox(S.src_q, Rs, ts)
            sup_sel, sup_ok, sup_ovf = super_candidates(
                S.slo, S.shi, Rs, ts, mindex, r_cull, self.num_supers,
                active=active, qbox=qbox_i)
            rel_l, block_ids = hier_relevance(S.slo, S.shi, Rs, ts, mindex,
                                              sup_sel, sup_ok, r_cull,
                                              qbox=qbox_i)
            rel_l = rel_l & active[:, None, None]
            rel = torch.any(rel_l, dim=0)
            qid, tid, slot, col, table, ovf, run_ovf = \
                make_pair_list_slotted(rel, self.num_pairs,
                                       self.max_per_query,
                                       block_ids=block_ids,
                                       nbt=bi.num_blocks)
            overflow = ovf + run_ovf + sup_ovf
            lmask = pack_lane_mask(rel_l, qid, col) if B > 1 else None
            covered = torch.any(rel, dim=1)
            knn_kwargs = dict(slot=slot, tid_table=table,
                              max_per_query=self.max_per_query)
        else:
            rel_l = lane_relevance(S.slo, S.shi, Rs, ts, bi.lo, bi.hi,
                                   r_cull, per_lane=True,
                                   qbox=exact_qbox(S.src_q, Rs, ts))
            rel_l = rel_l & active[:, None, None]
            rel = torch.any(rel_l, dim=0)
            qid, tid, overflow = make_pair_list(rel, self.num_pairs)
            lmask = pack_lane_mask(rel_l, qid, tid) if B > 1 else None
            covered = torch.any(rel, dim=1)
        poses12 = torch.cat([Rs.reshape(B, 9), ts], dim=1)
        vals, idx = batched_block_knn(bi, S.src_blocks, poses12, qid, tid,
                                      radius=self.radius, covered=covered,
                                      lane_mask=lmask, layout="kn",
                                      per_lane=self.per_lane, **knn_kwargs)
        return vals, idx, overflow

    def step(self, S) -> None:
        with graphs.mark("update"):
            active = ~(S.conv | S.abt)
        result = self.iterate(S, S.Rs, S.ts, S.r_cull, active)
        with graphs.mark("update"):
            self.update(S, active, *result)

    def update(self, S, active, sysm, dx, abort_now, overflow,
               d5bm) -> None:
        """The step's bookkeeping after ``iterate``: the history, the
        pose update, the convergence test and the state."""
        B, params = self.B, self.params
        I = params.max_iterations
        Rs, ts, conv, abt = S.Rs, S.ts, S.conv, S.abt
        abort_now = abort_now & active
        # history column ``it`` of each active lane
        col = (torch.arange(I, device=self.dev) == S.it)[None, :] \
            & active[:, None]
        hist = S.get_tuple("hist", Hist)

        def put(name, val):
            dst = getattr(hist, name)
            sel = col.reshape(col.shape + (1,) * (val.ndim - 1))
            S.put(f"hist.{name}", torch.where(sel, val[:, None], dst))

        put("H", sysm.H)
        put("rmse", sysm.rmse)
        put("fitness", sysm.fitness)
        put("num_valid", sysm.num_valid.to(torch.int32))
        if params.full_telemetry:
            put("R", Rs)
            put("t", ts)
            put("g", sysm.g)
            put("dx", dx)
            put("objective", sysm.objective)
        Rn, tn = se3.boxplus(Rs, ts, dx)
        upd = active & ~abort_now
        n_rot = torch.linalg.norm(dx[:, :3], dim=1)
        n_trans = torch.linalg.norm(dx[:, 3:], dim=1)
        step_conv = (n_rot < params.convergence_thresh_rot) & \
            (n_trans < params.convergence_thresh_trans) & ~abort_now
        conv_new = conv | (active & step_conv)
        abt_new = abt | abort_now
        # next iteration's exact cull radius (motion bound slack +
        # fixed-point quantisation of d5)
        move = n_rot * S.pmax + n_trans
        r_new = torch.clamp(d5bm + (1.05 * move + 0.01)[:, None],
                            max=self.radius)
        S.put("Rs", torch.where(upd[:, None, None], Rn, Rs))
        S.put("ts", torch.where(upd[:, None], tn, ts))
        S.put("iters", torch.where(active, S.it + 1, S.iters)
              .to(torch.int32))
        S.put("r_cull", torch.where(active[:, None], r_new, S.r_cull))
        S.put("cum_move", S.cum_move + torch.where(active, move, 0.0))
        S.put("ovf", torch.maximum(S.ovf, overflow))
        S.put("conv", conv_new)
        S.put("abt", abt_new)
        S.put("it", S.it + 1)
        if not self.per_lane:
            S.put("done", torch.all(conv_new | abt_new))
            return
        # what the loop's condition reads after each step: lanes still
        # running, and lanes aborted or over their pair list (the reuse
        # guard as ``finish`` will count it)
        bad = abt_new | (S.ovf > 0) | (2.0 * S.cum_move > self.reuse_pair_list)
        S.put("left", torch.stack([
            torch.sum((~(conv_new | abt_new)).to(torch.int32)),
            torch.sum(bad.to(torch.int32))]))

    def finish(self, S) -> None:
        """The epilogue's first half: the reuse guard and each lane's
        last-iteration H, rmse, fitness and num_valid."""
        B = self.B
        if self.reuse:
            # the static list covers iteration k only while 2x the
            # accumulated motion stays inside the margin
            breach = (2.0 * S.cum_move > self.reuse_pair_list).to(torch.int64)
            S.put("ovf", S.ovf + (breach if self.per_lane
                                  else torch.sum(breach)))
        last = torch.clamp(S.iters - 1, min=0).long()
        lane_ix = torch.arange(B, device=self.dev)
        hist = S.get_tuple("hist", Hist)
        S.put("H_last", hist.H[lane_ix, last])
        S.put("rmse", hist.rmse[lane_ix, last])
        S.put("fitness", hist.fitness[lane_ix, last])
        S.put("num_valid", hist.num_valid[lane_ix, last])

    def epilogue(self, S) -> None:
        self.finish(S)
        # ---- pass 2: telemetry reconstruction, batched over (B, I) -------
        B, dev, dtype, params = self.B, self.dev, self.dtype, self.params
        I = params.max_iterations
        hist, H_last = S.get_tuple("hist", Hist), S.H_last
        if params.full_telemetry:
            executed = torch.arange(I, device=dev)[None, :] \
                < S.iters[:, None]
            S.put_tuple("log", telemetry_row(
                hist, executed, self.detection, self.handling,
                params.thresholds, params.min_effective_points, S.T_gt))
            S.put("cov", covariance_from_H(H_last, S.conv, dtype))
        else:
            S.put_tuple("log", _empty_log(I, dtype, lead=(B,), device=dev))
            eye6 = torch.eye(6, dtype=dtype, device=dev)
            inv, info = torch.linalg.solve_ex(H_last, eye6.expand(B, 6, 6))
            ok = S.conv & (info == 0) & torch.all(torch.isfinite(inv),
                                                  dim=(1, 2))
            S.put("cov", torch.where(ok[:, None, None], inv, 1e6 * eye6))

    def result(self, S) -> BatchICPResult:
        return BatchICPResult(R=S.Rs, t=S.ts, converged=S.conv,
                              aborted=S.abt, iterations=S.iters,
                              covariance=S.cov,
                              log=S.get_tuple("log", IterationLog),
                              pair_overflow=S.ovf, H_last=S.H_last,
                              rmse=S.rmse, fitness=S.fitness,
                              num_valid=S.num_valid)


def icp_batch_so3(source_xyz, target_xyz, R0s, t0s,
                  detection: DetectionMethod, handling: HandlingMethod,
                  params: ICPParams, index, num_pairs: int, T_gt=None,
                  num_supers: int = 0, max_per_query: int = 0,
                  initial_cull_radius=None, reuse_pair_list: float = 0.0,
                  device=None, graph=None) -> BatchICPResult:
    """Run B registrations of one (source, target) pair to convergence.

    source_xyz (N, 3) sorted body-frame points; target_xyz (M, 3) the same
    sorted cloud the index was built over; R0s (B, 3, 3), t0s (B, 3)
    initial poses; num_pairs: pair-list capacity (overflow is reported in
    ``pair_overflow``, never silently truncated).  ``index`` is a
    BlockIndex, or a MapIndex for map-scale targets (then ``num_supers``
    and ``max_per_query`` are required, see ``estimate_map_capacities``).
    ``initial_cull_radius``: iteration-0 cull radius (default: the search
    radius).  ``reuse_pair_list`` (map mode, B = 1): when > 0 the cull and
    pair list run once at the initial pose with radius
    initial_cull_radius + reuse_pair_list and serve every iteration; a
    breach of the motion guard is added to ``pair_overflow``.

    Runs on ``device`` (cuda unless told otherwise; the index must live
    there).  On the card the loop's parts (``BatchLoop``) run as CUDA
    graphs, captured at the first call of their statics and replayed
    after (``graphs.CACHE``); ``graph=False`` runs them eagerly, for
    checking only; on the CPU they run eagerly and ``graph=True`` raises.
    """
    check_precise()
    dev = resolve_device(device)
    if _index_device(index).type != dev.type:
        raise ValueError(f"index lives on {_index_device(index)}, engine "
                         f"runs on {dev}")
    graphed = graphs.use_graphs(dev, graph)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    source_xyz, target_xyz = f32(source_xyz), f32(target_xyz)
    R0s, t0s = f32(R0s), f32(t0s)
    T_gt = torch.eye(4, dtype=torch.float32, device=dev) if T_gt is None \
        else f32(T_gt)
    loop = BatchLoop(index, target_xyz, R0s.shape[0], source_xyz.shape[0],
                     detection, handling, params, num_pairs, num_supers,
                     max_per_query, initial_cull_radius, reuse_pair_list,
                     dev)

    def load(S):
        loop.load(S, source_xyz, R0s, t0s, T_gt)

    run, S = graphs.bind(loop, load, graphed, "icp_batch_so3", dev)
    graphs.drive(run, S, params.max_iterations)
    return graphs.detached(loop.result(S)) if graphed else loop.result(S)


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def estimate_map_capacities(mindex: MapIndex, source_xyz, poses_Rt,
                            radius: float, margin: float = 1.3,
                            sup_margin: int = 2,
                            include_identity: bool = True,
                            slot_margin: float = None):
    """Host-side (num_supers, max_per_query, num_pairs) for map-scale
    batch registration: the max over the (R, t) pose samples (plus
    identity unless ``include_identity`` is False), with margin.  Culls
    with exact transformed-point bboxes, as the engine does."""
    src = _host(source_xyz)
    N = src.shape[0]
    nq = -(-N // QB)
    pad = np.concatenate([src, np.repeat(src[-1:], nq * QB - N, axis=0)])
    qb = pad.reshape(nq, QB, 3)
    bi = mindex.block
    tlo, thi = _host(bi.lo), _host(bi.hi)
    slo_s, shi_s = _host(mindex.sup_lo), _host(mindex.sup_hi)
    r2 = radius * radius
    samples = ([(np.eye(3), np.zeros(3))] if include_identity else []) + [
        (_host(R), _host(t)) for R, t in poses_Rt]
    blk_count = np.zeros(nq, np.int64)
    rel_sup = np.zeros((nq, mindex.num_supers), bool)
    qlos, qhis = [], []
    for R, t in samples:
        qw = qb @ R.T + t
        qlos.append(qw.min(axis=1))
        qhis.append(qw.max(axis=1))
    for qlo, qhi in zip(qlos, qhis):
        gap = np.maximum(0.0, np.maximum(qlo[:, None] - shi_s[None],
                                         slo_s[None] - qhi[:, None]))
        rel_sup |= (gap * gap).sum(-1) <= r2
    total_pairs = 0
    for q in range(nq):
        sups = np.nonzero(rel_sup[q])[0]
        if sups.size == 0:
            continue
        bids = (sups[:, None] * mindex.sb
                + np.arange(mindex.sb)[None, :]).ravel()
        bids = bids[bids < bi.num_blocks]
        rel_b = np.zeros(bids.size, bool)
        for qlo, qhi in zip(qlos, qhis):
            gap = np.maximum(0.0, np.maximum(qlo[q][None] - thi[bids],
                                             tlo[bids] - qhi[q][None]))
            rel_b |= (gap * gap).sum(-1) <= r2
        blk_count[q] = int(rel_b.sum())
        total_pairs += int(rel_b.sum())
    num_supers = int(rel_sup.sum(axis=1).max()) + sup_margin
    sm = margin if slot_margin is None else slot_margin
    max_per_query = int(-(-int(blk_count.max()) * sm // 4) * 4) + 4
    if max_per_query > 2048:
        raise ValueError(
            f"map-scale slot capacity needs {max_per_query} target blocks "
            "per query block (cap 2048 = 2^18 candidate ids / 128).  The "
            f"scan is too sparse relative to the map for radius {radius}: "
            "tighten the radius to an initial-pose-error bound "
            "(icp_batch_so3 initial_cull_radius) or densify the scan")
    num_pairs = max(64, int(-(-total_pairs * margin // 64) * 64))
    return num_supers, max_per_query, num_pairs


def estimate_num_pairs(index: BlockIndex, source_xyz, poses_Rt,
                       radius: float, margin: float = 1.3) -> int:
    """Host-side pair-list capacity: union relevance over the (R, t) pose
    samples plus identity, x margin, rounded up to 64."""
    src = _host(source_xyz)
    N = src.shape[0]
    nq = -(-N // QB)
    pad = np.concatenate([src, np.repeat(src[-1:], nq * QB - N, axis=0)])
    qb = pad.reshape(nq, QB, 3)
    tlo, thi = _host(index.lo), _host(index.hi)
    rel = np.zeros((nq, tlo.shape[0]), bool)
    samples = [(np.eye(3), np.zeros(3))] + [(_host(R), _host(t))
                                            for R, t in poses_Rt]
    for R, t in samples:
        qw = qb @ R.T + t
        qlo, qhi = qw.min(axis=1), qw.max(axis=1)
        gap = np.maximum(0.0, np.maximum(qlo[:, None] - thi[None],
                                         tlo[None] - qhi[:, None]))
        rel |= (gap * gap).sum(-1) <= radius * radius
    total = int(rel.sum())
    return max(64, int(-(-total * margin // 64) * 64))
