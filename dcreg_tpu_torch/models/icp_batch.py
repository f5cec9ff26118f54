"""Batched Monte-Carlo ICP engine: all pose lanes advance together
(counterpart of ``dcreg_tpu/models/icp_batch.py``).

Per iteration ONE pair list is built from the union of every lane's
relevant (query block, target block) interactions and ONE K1 call answers
all lanes' 5-NN queries; the SoA tail, Schur analysis, PCG solve and
boxplus run batched over lanes.  The JAX ``while_loop`` with per-lane
freeze is a Python loop here: it syncs with the host once per iteration on
``all(converged | aborted)``, and each lane freezes under the same rule,
so per-lane iteration counts are the JAX engine's.

Requirements as in the JAX module: source/target spatially sorted, the
index built with tb = 128 over the sorted target, f32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
from .icp import (ICPParams, _empty_log, covariance_from_H, empty_hist,
                  telemetry_row)


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


def icp_batch_so3(source_xyz, target_xyz, R0s, t0s,
                  detection: DetectionMethod, handling: HandlingMethod,
                  params: ICPParams, index, num_pairs: int, T_gt=None,
                  num_supers: int = 0, max_per_query: int = 0,
                  initial_cull_radius=None, reuse_pair_list: float = 0.0,
                  device=None, plain_knn: bool = False) -> BatchICPResult:
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
    there).  ``plain_knn=True`` runs K1's plain PyTorch twin instead of
    the kernel -- for checking the kernel against it on the card only.
    """
    check_precise()
    dev = resolve_device(device)
    if _index_device(index).type != dev.type:
        raise ValueError(f"index lives on {_index_device(index)}, engine "
                         f"runs on {dev}")
    map_mode = isinstance(index, MapIndex)
    mindex = index if map_mode else None
    bi = index.block if map_mode else index
    if map_mode and (num_supers <= 0 or max_per_query <= 0):
        raise ValueError("map mode needs num_supers and max_per_query")
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    source_xyz, target_xyz = f32(source_xyz), f32(target_xyz)
    R0s, t0s = f32(R0s), f32(t0s)
    dtype = torch.float32
    B = R0s.shape[0]
    reuse = map_mode and reuse_pair_list > 0 and B == 1
    N = source_xyz.shape[0]
    I = params.max_iterations
    k = params.corr.k
    radius = params.corr.search_radius
    T_gt = torch.eye(4, dtype=dtype, device=dev) if T_gt is None \
        else f32(T_gt)
    fast = (detection is DetectionMethod.SCHUR_CONDITION_NUMBER and
            handling is HandlingMethod.PRECONDITIONED_CG)

    # ---- static query-block prep (body frame) ----------------------------
    nq = -(-N // QB)
    src_pad = torch.cat([source_xyz,
                         source_xyz[-1:].expand(nq * QB - N, 3)])
    src_q = src_pad.reshape(nq, QB, 3)
    src_blocks = src_q.transpose(1, 2).contiguous()          # (nq, 3, QB)
    slo = torch.amin(src_q, dim=1)
    shi = torch.amax(src_q, dim=1)
    # a source point moves at most |dw| * pmax + |dv| per iteration
    pmax = torch.sqrt(torch.amax(torch.sum(source_xyz * source_xyz, dim=1)))
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    if reuse:
        r0v = radius if initial_cull_radius is None else initial_cull_radius
        r_list = f32(r0v) + f32(reuse_pair_list)
        qbox0 = exact_qbox(src_q, R0s, t0s)
        sup_sel0, sup_ok0, sup_ovf0 = super_candidates(
            slo, shi, R0s, t0s, mindex, r_list, num_supers, qbox=qbox0)
        rel_l0, block_ids0 = hier_relevance(
            slo, shi, R0s, t0s, mindex, sup_sel0, sup_ok0, r_list,
            qbox=qbox0)
        rel0 = torch.any(rel_l0, dim=0)
        qid0, tid0, slot0, col0, table0, ovf0, run_ovf0 = \
            make_pair_list_slotted(rel0, num_pairs, max_per_query,
                                   block_ids=block_ids0, nbt=bi.num_blocks)
        static_overflow = ovf0 + run_ovf0 + sup_ovf0
        covered0 = torch.any(rel0, dim=1)
        # static per-pair target bboxes for the per-iteration LIVE mask
        pad0 = qid0 >= nq
        tid_safe0 = torch.where(pad0, 0, tid0).long()
        p_tlo0 = torch.where(pad0[:, None], 3e38, bi.lo[tid_safe0])
        p_thi0 = torch.where(pad0[:, None], -3e38, bi.hi[tid_safe0])
        qid_safe0 = torch.where(pad0, 0, qid0).long()

    def one_iteration(Rs, ts, r_cull, active):
        knn_kwargs = {}
        if reuse:
            qid, tid = qid0, tid0
            overflow = zero
            covered = covered0
            knn_kwargs = dict(slot=slot0, tid_table=table0,
                              max_per_query=max_per_query)
            # live mask: pairs within this iteration's exact radius
            qlo_b, qhi_b = exact_qbox(src_q, Rs, ts)
            qlo, qhi = qlo_b[0], qhi_b[0]
            gap = torch.clamp(torch.maximum(qlo[qid_safe0] - p_thi0,
                                            p_tlo0 - qhi[qid_safe0]),
                              min=0.0)
            d2p = torch.sum(gap * gap, dim=-1)
            rq = r_cull[0, qid_safe0]
            live = (d2p <= rq * rq) & ~pad0
            lmask = live.to(torch.int32)[:, None]
        elif map_mode:
            qbox_i = exact_qbox(src_q, Rs, ts)
            sup_sel, sup_ok, sup_ovf = super_candidates(
                slo, shi, Rs, ts, mindex, r_cull, num_supers, active=active,
                qbox=qbox_i)
            rel_l, block_ids = hier_relevance(slo, shi, Rs, ts, mindex,
                                              sup_sel, sup_ok, r_cull,
                                              qbox=qbox_i)
            rel_l = rel_l & active[:, None, None]
            rel = torch.any(rel_l, dim=0)
            qid, tid, slot, col, table, ovf, run_ovf = \
                make_pair_list_slotted(rel, num_pairs, max_per_query,
                                       block_ids=block_ids,
                                       nbt=bi.num_blocks)
            overflow = ovf + run_ovf + sup_ovf
            lmask = pack_lane_mask(rel_l, qid, col) if B > 1 else None
            covered = torch.any(rel, dim=1)
            knn_kwargs = dict(slot=slot, tid_table=table,
                              max_per_query=max_per_query)
        else:
            rel_l = lane_relevance(slo, shi, Rs, ts, bi.lo, bi.hi, r_cull,
                                   per_lane=True,
                                   qbox=exact_qbox(src_q, Rs, ts))
            rel_l = rel_l & active[:, None, None]
            rel = torch.any(rel_l, dim=0)
            qid, tid, overflow = make_pair_list(rel, num_pairs)
            lmask = pack_lane_mask(rel_l, qid, tid) if B > 1 else None
            covered = torch.any(rel, dim=1)
        poses12 = torch.cat([Rs.reshape(B, 9), ts], dim=1)
        vals, idx = batched_block_knn(bi, src_blocks, poses12, qid, tid,
                                      radius=radius, covered=covered,
                                      lane_mask=lmask, layout="kn",
                                      plain=plain_knn, **knn_kwargs)
        # exact 5th-NN distance per (lane, query block); BIG where a
        # block was uncovered -> the next radius falls back to the full one
        d5row = vals[:, k - 1, :]
        d5bm = torch.sqrt(torch.amax(d5row.reshape(B, nq, QB), dim=2))
        sysm = batched_tail_system(
            source_xyz, target_xyz, Rs, ts, sq_d5=d5row[:, :N],
            idx_kn=idx[:, :k, :N], params=params.corr,
            use_weight_derivative=params.use_weight_derivative,
            weight_slope=params.corr.weight_slope)
        analysis = analyze(sysm.H, detection, params.thresholds, fast=fast)
        dx, _ = solve(sysm.H, sysm.g, handling, analysis, params.thresholds,
                      telemetry=False, fast=fast)
        too_few = sysm.num_valid < params.min_effective_points
        bad_dx = ~torch.all(torch.isfinite(dx), dim=-1)
        abort_now = too_few | bad_dx
        dx = torch.where(abort_now[:, None], 0.0, dx)
        return sysm, dx, abort_now, overflow, d5bm

    # ---- pass 1: the joint optimisation loop -----------------------------
    Rs, ts = R0s, t0s
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    abt = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    # the history is preallocated and written in place, column by column
    hist = empty_hist(I, dtype, lead=(B,), device=dev)
    ovf = static_overflow if reuse else zero
    r0 = radius if initial_cull_radius is None else initial_cull_radius
    r_cull = torch.full((B, nq), float(r0), dtype=dtype, device=dev)
    cum_move = torch.zeros(B, dtype=dtype, device=dev)
    for it in range(I):
        if bool(torch.all(conv | abt)):          # one host sync per trip
            break
        active = ~(conv | abt)
        sysm, dx, abort_now, overflow, d5bm = one_iteration(
            Rs, ts, r_cull, active)
        abort_now = abort_now & active

        def put(dst, val):
            a = active.reshape((B,) + (1,) * (val.ndim - 1))
            dst[:, it] = torch.where(a, val, dst[:, it])

        put(hist.H, sysm.H)
        put(hist.rmse, sysm.rmse)
        put(hist.fitness, sysm.fitness)
        put(hist.num_valid, sysm.num_valid.to(torch.int32))
        if params.full_telemetry:
            put(hist.R, Rs)
            put(hist.t, ts)
            put(hist.g, sysm.g)
            put(hist.dx, dx)
            put(hist.objective, sysm.objective)
        Rn, tn = se3.boxplus(Rs, ts, dx)
        upd = active & ~abort_now
        Rs = torch.where(upd[:, None, None], Rn, Rs)
        ts = torch.where(upd[:, None], tn, ts)
        n_rot = torch.linalg.norm(dx[:, :3], dim=1)
        n_trans = torch.linalg.norm(dx[:, 3:], dim=1)
        step_conv = (n_rot < params.convergence_thresh_rot) & \
            (n_trans < params.convergence_thresh_trans) & ~abort_now
        conv = conv | (active & step_conv)
        abt = abt | abort_now
        iters = torch.where(active, it + 1, iters).to(torch.int32)
        # next iteration's exact cull radius (motion bound slack +
        # fixed-point quantisation of d5)
        move = n_rot * pmax + n_trans
        r_new = torch.clamp(d5bm + (1.05 * move + 0.01)[:, None],
                            max=radius)
        r_cull = torch.where(active[:, None], r_new, r_cull)
        cum_move = cum_move + torch.where(active, move, 0.0)
        ovf = torch.maximum(ovf, overflow)
    if reuse:
        # the static list covers iteration k only while 2x the accumulated
        # motion stays inside the margin
        ovf = ovf + torch.sum((2.0 * cum_move > reuse_pair_list)
                              .to(torch.int64))

    last = torch.clamp(iters - 1, min=0).long()
    lane_ix = torch.arange(B, device=dev)
    H_last = hist.H[lane_ix, last]

    # ---- pass 2: telemetry reconstruction, batched over (B, I) -----------
    if params.full_telemetry:
        executed = torch.arange(I, device=dev)[None, :] < iters[:, None]
        log = telemetry_row(hist, executed, detection, handling,
                            params.thresholds, params.min_effective_points,
                            T_gt)
        cov = covariance_from_H(H_last, conv, dtype)
    else:
        log = _empty_log(I, dtype, lead=(B,), device=dev)
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        inv, info = torch.linalg.solve_ex(H_last, eye6.expand(B, 6, 6))
        ok = conv & (info == 0) & torch.all(torch.isfinite(inv), dim=(1, 2))
        cov = torch.where(ok[:, None, None], inv, 1e6 * eye6)
    return BatchICPResult(R=Rs, t=ts, converged=conv, aborted=abt,
                          iterations=iters, covariance=cov, log=log,
                          pair_overflow=ovf, H_last=H_last,
                          rmse=hist.rmse[lane_ix, last],
                          fitness=hist.fitness[lane_ix, last],
                          num_valid=hist.num_valid[lane_ix, last])


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
