"""Batched ragged block-sparse 5-NN -- the ICP hot loop (counterpart of
``dcreg_tpu/ops/pallas_block_knn.py``).

One call answers the 5-NN queries of all B pose lanes for one ICP
iteration.  Work is a ragged, qid-sorted PAIR LIST of (query block,
target block) interactions that survived the bounding-box cull.  Every
candidate becomes one int32 key: the squared distance in fixed point in
the high 31-IB bits (clamped just above the search-radius gate) and the
candidate id in the low IB bits (global ``tid * TB + row``, or slot-local
``slot * TB + row`` in map mode), so merging top-5 lists compares keys
only.

``block_knn_keys`` is the kernel boundary.  A tensor on the card goes to
the hand-written CUDA kernel K1 (``csrc/block_knn.cu``, built on first use
with nvcc and bound with ctypes); a tensor on the CPU goes to the plain
PyTorch twin ``block_knn_keys_plain``, which computes the same keys with
the same operation order.  K1 splits each query block's run of pairs
across CTAs and merges the per-split lists exactly; ``_split_bounds``
and ``merge_partial_keys`` are that split and merge in plain torch, for
the tests.  In the per-lane mode (``nq_lane``) every lane brings query
blocks of its own, stacked, and each block is answered at its own lane's
pose only: the batched map loop of a fleet of sensors.  The cull and
pair-list helpers are the JAX module's jnp code as torch ops.  The
wrapper counts its launches through
``graphs.note_launch``, so a launch inside a captured CUDA graph counts
once per replay.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import cuda_build, graphs
from .block_sparse import BlockIndex

TB = 128
QB = 128
KP = 8
K = 5
BIG = 3.0e38
MAX_INDEX_BITS = 18
INIT_KEY = 0x7FFFFFFF

CSRC = cuda_build.CSRC / "block_knn.cu"
BUILD_DIR = cuda_build.BUILD_DIR


def _index_bits(num_cand: int) -> int:
    """Key bits needed to pack candidate ids 0..num_cand-1."""
    ib = max(1, int(np.ceil(np.log2(max(num_cand, 2)))))
    if ib > MAX_INDEX_BITS:
        raise ValueError(
            f"batched_block_knn packs at most 2^{MAX_INDEX_BITS} candidate "
            f"ids ({num_cand} requested); for map-scale targets pass the "
            "slot/tid_table pair from make_pair_list_slotted so ids are "
            "slot-local; beyond that the scan is too sparse relative to "
            "the map -- split it or densify")
    return ib


# ---------------------------------------------------------------------------
# K1: build, bind, launch
# ---------------------------------------------------------------------------

def build_library() -> dict:
    """Compile ``csrc/block_knn.cu`` with the shared nvcc command
    (``cuda_build``) unless ``_build/<source hash>/`` already holds it.
    Returns {"path", "seconds", "log"}."""
    return cuda_build.build_library(CSRC, "dcreg_block_knn", "K1",
                                    BUILD_DIR)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build_library()["path"])
    fn = lib.dcreg_block_knn_keys
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, i, i,
                   ctypes.c_float, ctypes.c_float, i, p]
    fn.restype = i
    return lib


# K1's grid: (nq, nsplit, B) CTAs of 128 threads, one pose lane each.
# Runs are split until the grid holds about CTAS_PER_SM CTAs for each of
# the card's SMs, at most MAX_SPLIT pieces per run.
CTAS_PER_SM = 32
MAX_SPLIT = 16


def _choose_nsplit(nq: int, B: int, sms: int) -> int:
    """Pieces each query block's run of pairs is split into, from the
    static shapes and the card's SM count only (no host sync)."""
    ctas = nq * B
    if ctas <= 0:
        return 1
    return max(1, min(MAX_SPLIT, -(-sms * CTAS_PER_SM // ctas)))


def _run_start(qid, nq: int):
    """(nq + 1,) int32: query block q's pairs are [run_start[q],
    run_start[q + 1]).  Pairs are sorted by qid; padding pairs (qid ==
    nq) sort last and fall outside every run."""
    return torch.searchsorted(
        qid, torch.arange(nq + 1, dtype=torch.int32, device=qid.device),
        out_int32=True)


def _split_bounds(run_start, nsplit: int):
    """(lo, hi), each (nq, nsplit): split s of query block q takes pairs
    [lo[q, s], hi[q, s]), the kernel's integer arithmetic
    run_start[q] + s * len // nsplit.  The splits of a run partition it;
    a split may be empty."""
    r0 = run_start[:-1, None].long()
    n = (run_start[1:] - run_start[:-1])[:, None].long()
    s = torch.arange(nsplit + 1, device=run_start.device)
    cut = r0 + s * n // nsplit
    return cut[:, :-1], cut[:, 1:]


def merge_partial_keys(partials):
    """Plain twin of K1's merge: (nq, S, B, R >= K, QB) int32 ascending
    per-split lists -> (nq, B, KP, QB), the K smallest keys of each point
    over all splits, rows K.. INIT_KEY."""
    nq, S, B, _, n = partials.shape
    cand = partials[:, :, :, :K].permute(0, 2, 1, 3, 4).reshape(
        nq, B, S * K, n)
    top = torch.topk(cand, K, dim=2, largest=False, sorted=True).values
    pad = torch.full((nq, B, KP - K, n), INIT_KEY, dtype=top.dtype,
                     device=top.device)
    return torch.cat([top, pad], dim=2)


def _check(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lanes(nq: int, poses, nq_lane: int) -> int:
    """The lane rows of K1's output: the poses, or 1 in the per-lane
    mode, where the nq query blocks are ``nq // nq_lane`` lanes' own."""
    if not nq_lane:
        return poses.shape[0]
    if nq != nq_lane * poses.shape[0]:
        raise ValueError(f"per-lane mode: {nq} query blocks are not "
                         f"{poses.shape[0]} lanes of {nq_lane}")
    return 1


def _launch_cuda(src_blocks, tgt, poses, qid, tid, pid, lane_mask,
                 index_bits, scale, clamp, nq_lane=0):
    nq, P = src_blocks.shape[0], qid.shape[0]
    B = _lanes(nq, poses, nq_lane)
    dev = src_blocks.device
    for name, t in (("tgt", tgt), ("poses", poses), ("qid", qid),
                    ("tid", tid), ("pid", pid)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, src on {dev}")
    _check(src_blocks, "src_blocks", torch.float32, (nq, 3, QB))
    _check(tgt, "tgt", torch.float32, (tgt.shape[0], 3, TB))
    _check(poses, "poses", torch.float32, (poses.shape[0], 12))
    for name, t in (("qid", qid), ("tid", tid), ("pid", pid)):
        _check(t, name, torch.int32, (P,))
    n_words = 0
    if lane_mask is not None:
        n_words = -(-B // 32)
        if lane_mask.device != dev:
            raise ValueError("lane_mask is not on the source's device")
        lane_mask = lane_mask.reshape(-1)
        _check(lane_mask, "lane_mask", torch.int32, (P * n_words,))
    fn = _library().dcreg_block_knn_keys
    nsplit = _choose_nsplit(
        nq, B, torch.cuda.get_device_properties(dev).multi_processor_count)
    run_start = _run_start(qid, nq)
    out = torch.empty((nq, B, KP, QB), dtype=torch.int32, device=dev)
    partial = None if nsplit == 1 else torch.empty(
        (nq, nsplit, B, K, QB), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(run_start.data_ptr(), tid.data_ptr(), pid.data_ptr(),
            0 if lane_mask is None else lane_mask.data_ptr(), n_words,
            src_blocks.data_ptr(), tgt.data_ptr(), poses.data_ptr(),
            out.data_ptr(), 0 if partial is None else partial.data_ptr(),
            nq, B, nsplit, index_bits, scale, clamp, nq_lane, stream)
    if rc != 0:
        raise RuntimeError(f"K1 block_knn kernel launch failed: "
                           f"cudaError {rc}")
    graphs.note_launch(block_knn_keys)
    block_knn_keys.last_grid = {"nsplit": nsplit, "ctas": nq * nsplit * B}
    return out


def block_knn_keys_plain(src_blocks, tgt, poses, qid, tid, pid, lane_mask,
                         index_bits, scale, clamp, nq_lane=0):
    """Plain PyTorch twin of K1: the same keys, the same float operation
    order, the same lane-mask and padding semantics.  Returns
    (nq, B, KP, QB) int32: rows 0..4 the ascending 5 smallest keys of each
    (query block, lane, query point), INIT_KEY where fewer candidates;
    rows 5..7 INIT_KEY.  With ``nq_lane`` (the per-lane mode) query block
    q is answered at pose q // nq_lane alone, and B is 1."""
    nq = src_blocks.shape[0]
    B = _lanes(nq, poses, nq_lane)
    dev = src_blocks.device
    out = torch.full((nq, B, KP, QB), INIT_KEY, dtype=torch.int32,
                     device=dev)
    real = torch.nonzero(qid < nq).flatten()
    if real.numel() == 0:
        return out
    qid_r = qid[real].long()
    run_start = torch.searchsorted(qid[real].contiguous(),
                                   torch.arange(nq + 1, dtype=qid.dtype,
                                                device=dev))
    rank = torch.arange(real.numel(), device=dev) - run_start[qid_r]
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    clamp_t, scale_t = f32(clamp), f32(scale)
    # (pairs or 1, lanes, ...): every lane at every pair, or per lane each
    # pair at its query block's lane
    Rm, tv = poses[None, :, :9], poses[None, :, 9:]
    if nq_lane:
        Rm, tv = poses[qid_r // nq_lane, None, :9], \
            poses[qid_r // nq_lane, None, 9:]
    rows = torch.arange(TB, dtype=torch.int32, device=dev)
    if lane_mask is not None:
        words = lane_mask.reshape(qid.shape[0], -1)[real]
        lanes = torch.arange(B, device=dev)
        bits = ((words[:, lanes // 32] >> (lanes % 32).to(torch.int32))
                & 1).bool()                                   # (Pr, B)
    budget = 1 << (26 if dev.type == "cuda" else 22)
    chunk = max(1, budget // (B * TB * QB))
    for c0 in range(0, real.numel(), chunk):
        sl = slice(c0, c0 + chunk)
        p = real[sl]
        s = src_blocks[qid_r[sl]]                             # (C, 3, QB)
        g = tgt[tid[p].long()]                                # (C, 3, TB)
        R_c, t_c = (Rm[sl], tv[sl]) if nq_lane else (Rm, tv)
        d = None
        for c in range(3):
            q = (R_c[:, :, 3 * c, None] * s[:, None, 0, :]
                 + R_c[:, :, 3 * c + 1, None] * s[:, None, 1, :]) \
                + R_c[:, :, 3 * c + 2, None] * s[:, None, 2, :]
            q = q + t_c[:, :, c, None]                        # (C, B, QB)
            diff = g[:, None, c, :, None] - q[:, :, None, :]  # (C,B,TB,QB)
            d = diff * diff if d is None else d + diff * diff
        dq = (torch.minimum(d, clamp_t) * scale_t).to(torch.int32)
        ids = (pid[p][:, None, None, None] * TB
               + rows[None, None, :, None])
        key = torch.bitwise_or(torch.bitwise_left_shift(dq, index_bits),
                               ids)
        if lane_mask is not None:
            key = torch.where(bits[sl][:, :, None, None], key, INIT_KEY)
        top = torch.topk(key, K, dim=2, largest=False, sorted=True).values
        # merge into the running lists: pairs of equal rank within their
        # runs belong to distinct query blocks, so each group scatters
        # without collisions; keys are unique, so merge order is free
        rk = rank[sl]
        for r in torch.unique(rk).tolist():
            sel = torch.nonzero(rk == r).flatten()
            qs = qid_r[sl][sel]
            both = torch.cat([out[qs, :, :K], top[sel]], dim=2)
            out[qs, :, :K] = torch.topk(both, K, dim=2, largest=False,
                                        sorted=True).values
    return out


def block_knn_keys(src_blocks, tgt, poses, qid, tid, pid, lane_mask,
                   index_bits: int, scale: float, clamp: float,
                   plain: bool = False, nq_lane: int = 0):
    """K1's boundary: (nq, B, KP, QB) int32 top-5 keys, or (nq, 1, KP,
    QB) in the per-lane mode (``nq_lane`` query blocks per lane).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise).  ``plain=True`` forces the plain version on the card, for
    verification against the kernel only."""
    if src_blocks.device.type == "cpu" or plain:
        return block_knn_keys_plain(src_blocks, tgt, poses, qid, tid, pid,
                                    lane_mask, index_bits, scale, clamp,
                                    nq_lane)
    return _launch_cuda(src_blocks, tgt, poses, qid, tid, pid, lane_mask,
                        index_bits, scale, clamp, nq_lane)


block_knn_keys.launches = 0
block_knn_keys.launches_replayed = 0  # those of them made by graph replays
block_knn_keys.last_grid = None


def key_params(radius: float, index_bits: int):
    """(imask, vmax, clamp, scale) of the fixed-point key layout."""
    imask = (1 << index_bits) - 1
    vmax = (1 << (31 - index_bits)) - 1
    clamp = 1.1 * float(radius) ** 2
    return imask, vmax, clamp, (vmax - 1) / clamp


def batched_block_knn(index: BlockIndex, src_blocks, poses, qid, tid,
                      radius: float = 1.0, covered=None, lane_mask=None,
                      layout: str = "nk", slot=None, tid_table=None,
                      max_per_query: int = 0, plain: bool = False,
                      per_lane: bool = False):
    """All-lane 5-NN for one ICP iteration.

    index: BlockIndex with tb = 128; src_blocks (nq, 3, QB) sorted source,
    blocked and transposed; poses (B, 12) rows [R row-major (9), t (3)];
    qid/tid (P,) int32 pair list sorted by qid, padding pairs qid = nq;
    covered: optional (nq,) bool, False rows are masked to (BIG, -1);
    lane_mask: optional (P, ceil(B/32)) int32 bit words (lanes whose bit
    is 0 skip the pair); slot/tid_table/max_per_query: slot-local id mode
    (all three together, from ``make_pair_list_slotted``).
    ``per_lane``: every lane has nq query blocks of its own, stacked in
    ``src_blocks`` (B * nq, 3, QB) and answered at that lane's pose only
    (K1's per-lane mode); qid, covered, tid_table and a lane mask (one
    word per pair, bit 0) run over the B * nq blocks.

    Returns (sq_dists ascending, idx into the sorted target, -1 where
    missing); rows K..KP-1 are BIG / -1.  ``layout`` "nk" -> (B, nq*QB,
    KP); "kn" -> (B, KP, nq*QB)."""
    if index.tb != TB:
        raise ValueError(f"batched_block_knn needs a BlockIndex with "
                         f"tb={TB}, got {index.tb}")
    src_blocks = src_blocks.to(torch.float32).contiguous()
    poses = poses.to(torch.float32).contiguous()
    nq, B = src_blocks.shape[0], poses.shape[0]
    nq_lane = nq // B if per_lane else 0
    slotted = tid_table is not None
    if slotted:
        if slot is None or max_per_query <= 0:
            raise ValueError("slot-local mode needs slot, tid_table and "
                             "max_per_query together")
        ib = _index_bits(max_per_query * TB)
        pid = slot
    else:
        ib = _index_bits((index.num_blocks + 1) * TB)
        pid = tid
    imask, vmax, clamp, scale = key_params(radius, ib)
    i32 = lambda t: t.to(torch.int32).contiguous()
    keys = block_knn_keys(
        src_blocks, index.blocks, poses, i32(qid), i32(tid), i32(pid),
        None if lane_mask is None else i32(lane_mask), ib, scale, clamp,
        plain=plain, nq_lane=nq_lane)

    missing = keys >= (vmax << ib)
    local = torch.bitwise_and(keys, imask)
    if slotted:
        s_of = torch.where(missing, 0, local // TB).long()
        off = local % TB
        t_of = torch.gather(tid_table.long(), 1,
                            s_of.reshape(nq, -1)).reshape(s_of.shape)
        gid = torch.clamp(t_of * TB + off, max=index.num_points - 1)
    else:
        gid = torch.clamp(local, max=index.num_points - 1)
    idx = torch.where(missing, -1, gid).to(torch.int32)
    val = torch.where(missing, BIG,
                      torch.bitwise_right_shift(keys, ib).to(torch.float32)
                      * (1.0 / scale))
    if covered is not None:
        cov = covered.reshape(nq, 1, 1, 1)
        val = torch.where(cov, val, BIG)
        idx = torch.where(cov, idx, -1)
    if per_lane:
        # (B * nq, 1, KP, QB) -> (nq, B, KP, QB): lane b's blocks in column b
        nq = nq_lane
        val = val.reshape(B, nq, KP, QB).transpose(0, 1)
        idx = idx.reshape(B, nq, KP, QB).transpose(0, 1)
    if layout == "kn":
        return (val.permute(1, 2, 0, 3).reshape(B, KP, nq * QB),
                idx.permute(1, 2, 0, 3).reshape(B, KP, nq * QB))
    return (val.permute(1, 0, 3, 2).reshape(B, nq * QB, KP),
            idx.permute(1, 0, 3, 2).reshape(B, nq * QB, KP))


# ---------------------------------------------------------------------------
# Cull and pair lists
# ---------------------------------------------------------------------------

def _radius_view(r_cull, like):
    """Broadcast a scalar, (B,) or (B, nq) radius against (B, nq, X)."""
    r = torch.as_tensor(r_cull, dtype=like.dtype, device=like.device)
    if r.ndim == 1:
        return r[:, None, None]
    if r.ndim == 2:
        return r[:, :, None]
    return r


def _interval_qbox(slo, shi, Rs, ts):
    m = Rs[:, None, :, :] * slo[None, :, None, :]
    M = Rs[:, None, :, :] * shi[None, :, None, :]
    return (torch.sum(torch.minimum(m, M), dim=-1) + ts[:, None, :],
            torch.sum(torch.maximum(m, M), dim=-1) + ts[:, None, :])


def exact_qbox(src_q, Rs, ts):
    """Per-lane, per-query-block bboxes of the TRANSFORMED points.
    src_q (nq, QB, 3), or (B, nq, QB, 3) where each lane has a source of
    its own; Rs (B, 3, 3); ts (B, 3) -> (qlo, qhi) (B, nq, 3)."""
    spec = "bqpj,bij->bqpi" if src_q.ndim == 4 else "qpj,bij->bqpi"
    pw = torch.einsum(spec, src_q.to(torch.float32), Rs.to(torch.float32)) \
        + ts.to(torch.float32)[:, None, None, :]
    return torch.amin(pw, dim=2), torch.amax(pw, dim=2)


def super_candidates(slo, shi, Rs, ts, mindex, r_cull, num_supers: int,
                     active=None, qbox=None, lanes: int = 0):
    """Per-query-block nearest relevant super-blocks (level-1 cull).
    Returns (sup_sel (nq, S) int64, sup_ok (nq, S) bool, sup_overflow ()
    = number of query blocks with more than S relevant supers).  Equal
    scores rank lowest super index first, as ``jax.lax.top_k`` does.
    ``lanes``: the nq blocks are that many lanes' own, in order, and
    sup_overflow is counted per lane, (lanes,)."""
    qlo, qhi = qbox if qbox is not None else _interval_qbox(slo, shi, Rs, ts)
    gap = torch.clamp(torch.maximum(qlo[:, :, None, :] - mindex.sup_hi,
                                    mindex.sup_lo - qhi[:, :, None, :]),
                      min=0.0)
    d2_l = torch.sum(gap * gap, dim=-1)                      # (B, nq, ns)
    r = _radius_view(r_cull, d2_l)
    rel = d2_l <= r * r
    if active is not None:
        rel = rel & active[:, None, None]
    d2 = torch.amin(d2_l, dim=0)
    any_rel = torch.any(rel, dim=0)
    n_rel = torch.sum(any_rel.to(torch.int32), dim=1)
    S = min(num_supers, mindex.num_supers)
    score = torch.where(any_rel, d2, float("inf"))
    sorted_score, order = torch.sort(score, dim=1, stable=True)
    sup_ok = torch.isfinite(sorted_score[:, :S])
    sup_sel = torch.where(sup_ok, order[:, :S], 0)
    if lanes:
        return sup_sel, sup_ok, torch.sum(
            (n_rel > S).reshape(lanes, -1).to(torch.int32), dim=1)
    return sup_sel, sup_ok, torch.sum((n_rel > S).to(torch.int32))


def hier_relevance(slo, shi, Rs, ts, mindex, sup_sel, sup_ok, r_cull,
                   qbox=None):
    """Level-0 cull over the selected supers' blocks.  Returns (rel_l
    (B, nq, S*sb) bool, block_ids (nq, S*sb) global block per column)."""
    nq, S = sup_sel.shape
    sb = mindex.sb
    block_ids = (sup_sel[:, :, None] * sb
                 + torch.arange(sb, device=sup_sel.device)).reshape(
                     nq, S * sb)
    in_map = (block_ids < mindex.block.num_blocks) & \
        sup_ok.repeat_interleave(sb, dim=1)
    safe_ids = torch.where(in_map, block_ids, 0)
    blo = mindex.blk_lo_g[sup_sel].reshape(nq, S * sb, 3)
    bhi = mindex.blk_hi_g[sup_sel].reshape(nq, S * sb, 3)
    qlo, qhi = qbox if qbox is not None else _interval_qbox(slo, shi, Rs, ts)
    gap = torch.clamp(torch.maximum(qlo[:, :, None, :] - bhi[None],
                                    blo[None] - qhi[:, :, None, :]),
                      min=0.0)
    d2 = torch.sum(gap * gap, dim=-1)                        # (B, nq, C)
    r = _radius_view(r_cull, d2)
    return (d2 <= r * r) & in_map[None], safe_ids


def lane_relevance(slo, shi, Rs, ts, tlo, thi, radius, per_lane=False,
                   qbox=None):
    """(nq, nbt) relevance (any lane within ``radius``), or per lane
    (B, nq, nbt) when ``per_lane``."""
    qlo, qhi = qbox if qbox is not None else _interval_qbox(slo, shi, Rs, ts)
    gap = torch.clamp(torch.maximum(qlo[:, :, None, :] - thi[None, None],
                                    tlo[None, None] - qhi[:, :, None, :]),
                      min=0.0)
    d2 = torch.sum(gap * gap, dim=-1)
    r = _radius_view(radius, d2)
    rel = d2 <= r * r
    return rel if per_lane else torch.any(rel, dim=0)


def _compact(valid_flat, num_pairs):
    """Sorted flat indices of the True entries, padded with the sentinel
    len(valid_flat) up to num_pairs (and cut there)."""
    n = valid_flat.shape[0]
    flat = torch.arange(n, device=valid_flat.device)
    keys = torch.sort(torch.where(valid_flat, flat, n), stable=True).values
    if num_pairs > n:
        keys = torch.cat([keys, torch.full((num_pairs - n,), n,
                                           dtype=keys.dtype,
                                           device=keys.device)])
    return keys[:num_pairs], n


def make_pair_list(rel, num_pairs: int):
    """Padded, qid-sorted pair list from an (nq, nbt) relevance matrix.
    Returns (qid, tid, overflow); padding pairs qid = nq, tid = nbt."""
    nq, nbt = rel.shape
    keys, sentinel = _compact(rel.reshape(-1), num_pairs)
    is_pad = keys >= sentinel
    qid = torch.where(is_pad, nq, keys // nbt).to(torch.int32)
    tid = torch.where(is_pad, nbt, keys % nbt).to(torch.int32)
    total = torch.sum(rel.to(torch.int64))
    return qid, tid, torch.clamp(total - num_pairs, min=0)


def make_pair_list_slotted(rel, num_pairs: int, max_per_query: int,
                           block_ids=None, nbt=None, lanes: int = 0):
    """Slotted pair list for the slot-local (map-scale) id mode.

    rel (nq, C) bool over candidate columns; block_ids (nq, C) maps columns
    to global target blocks (identity when None); nbt the global block
    count.  Returns (qid, tid, slot, col, tid_table, overflow,
    run_overflow) as the JAX function does; pairs beyond ``max_per_query``
    in a run are dropped and counted in run_overflow.

    ``lanes``: the nq query blocks are that many lanes' own, in order.
    Each lane's pairs are then compacted into a capacity of its own,
    ``num_pairs``, so that no lane's pairs can push out another's, and the
    lanes' lists are one list of lanes * num_pairs pairs sorted by qid
    (padding last); overflow and run_overflow are per lane, (lanes,)."""
    nq, C = rel.shape
    if nbt is None:
        nbt = C
    G = max_per_query
    if lanes:
        return _pair_list_lanes(rel, num_pairs, G, block_ids, nbt, lanes)
    total = torch.sum(rel.to(torch.int64))
    cols_c, valid, tidm, tbl = _slot_columns(rel, G, block_ids)
    kept = torch.sum(valid.to(torch.int64))
    run_overflow = total - kept

    keys, sentinel = _compact(valid.reshape(-1), num_pairs)
    is_pad = keys >= sentinel
    keys_c = torch.clamp(keys, max=sentinel - 1)
    qid = torch.where(is_pad, nq, keys_c // G).to(torch.int32)
    slot = torch.where(is_pad, 0, keys_c % G).to(torch.int32)
    col = torch.where(is_pad, 0, cols_c.reshape(-1)[keys_c]).to(torch.int32)
    tid = torch.where(is_pad, nbt, tidm.reshape(-1)[keys_c]).to(torch.int32)
    overflow = torch.clamp(kept - num_pairs, min=0)
    return qid, tid, slot, col, tbl.to(torch.int32), overflow, run_overflow


def _slot_columns(rel, G: int, block_ids):
    """Each query block's first ``G`` relevant columns: (cols_c, valid,
    tidm, tbl), the columns (0 where none), which are real, their target
    blocks and the slot table (0 where none)."""
    nq, C = rel.shape
    iota = torch.arange(C, device=rel.device).expand(nq, C)
    cols = torch.sort(torch.where(rel, iota, C), dim=1,
                      stable=True).values[:, :G]
    if cols.shape[1] < G:
        cols = torch.cat([cols, torch.full((nq, G - cols.shape[1]), C,
                                           dtype=cols.dtype,
                                           device=rel.device)], dim=1)
    valid = cols < C
    cols_c = torch.where(valid, cols, 0)
    tidm = cols_c if block_ids is None else torch.gather(
        block_ids.long(), 1, cols_c)
    return cols_c, valid, tidm, torch.where(valid, tidm, 0)


def _pair_list_lanes(rel, num_pairs: int, G: int, block_ids, nbt: int,
                     lanes: int):
    """``make_pair_list_slotted`` over ``lanes`` lanes' query blocks, each
    lane's pairs in a capacity of its own (see there)."""
    nq, _ = rel.shape
    dev = rel.device
    cols_c, valid, tidm, tbl = _slot_columns(rel, G, block_ids)
    total = torch.sum(rel.reshape(lanes, -1).to(torch.int64), dim=1)
    kept = torch.sum(valid.reshape(lanes, -1).to(torch.int64), dim=1)
    # per lane: the flat (block, slot) indices of its pairs, compacted
    n = (nq // lanes) * G
    flat = torch.arange(n, device=dev)
    keys = torch.sort(torch.where(valid.reshape(lanes, n), flat, n), dim=1,
                      stable=True).values
    if num_pairs > n:
        keys = torch.cat([keys, torch.full((lanes, num_pairs - n), n,
                                           dtype=keys.dtype, device=dev)],
                         dim=1)
    keys = keys[:, :num_pairs]
    is_pad = keys >= n
    at = torch.arange(lanes, device=dev)[:, None] * n \
        + torch.clamp(keys, max=n - 1)           # into the lanes' flat grid
    qid = torch.where(is_pad, nq, at // G)
    # one list sorted by qid: the lanes' pairs in lane order, padding last
    order = torch.sort(qid.reshape(-1), stable=True).indices
    at, is_pad = at.reshape(-1)[order], is_pad.reshape(-1)[order]
    qid = qid.reshape(-1)[order].to(torch.int32)
    slot = torch.where(is_pad, 0, at % G).to(torch.int32)
    col = torch.where(is_pad, 0, cols_c.reshape(-1)[at]).to(torch.int32)
    tid = torch.where(is_pad, nbt, tidm.reshape(-1)[at]).to(torch.int32)
    overflow = torch.clamp(kept - num_pairs, min=0)
    return qid, tid, slot, col, tbl.to(torch.int32), overflow, total - kept


def pack_lane_mask(rel_lanes, qid, tid):
    """(P, ceil(B/32)) int32 lane-relevance bit words of each pair; padding
    pairs (qid >= nq) get 0.  rel_lanes (B, nq, nbt) bool."""
    B, nq, nbt = rel_lanes.shape
    W = -(-B // 32)
    dev = rel_lanes.device
    pad = qid >= nq
    q = torch.where(pad, 0, qid).long()
    t = torch.where(pad, 0, tid).long()
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev),
        torch.arange(32, device=dev))
    rel = rel_lanes[:, q, t]                                 # (B, P)
    if W * 32 > B:
        rel = torch.cat([rel, rel.new_zeros((W * 32 - B, rel.shape[1]))])
    words = (rel.reshape(W, 32, -1).to(torch.int64)
             * weights[None, :, None]).sum(dim=1)            # (W, P)
    words = torch.where(pad[None], 0, words)
    # bit 31 wraps into the int32 sign bit, as in the JAX int32 sum
    return words.T.contiguous().to(torch.int32)
