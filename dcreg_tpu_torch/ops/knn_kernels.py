"""Brute-force exact k-NN kernels K2 and K3 (counterpart of
``dcreg_tpu/ops/pallas_knn.py``).

K2 (``knn_candidates``) returns, for every query point, its ``kk`` best
candidates over the whole target as exact (f32 squared distance, int32
index) pairs, ordered by distance and then by index.  Distances are
coordinate-wise, ``((pen + dx^2) + dy^2) + dz^2`` clamped at BIG, where
``pen`` is 0 for a valid target and BIG for an invalid one; never the
|q|^2 + |t|^2 - 2 q.t expansion.  ``knn`` re-ranks the candidates with
exactly computed distances and keeps ``k``, as the JAX ``knn`` does.
kk runs from 1 to 128, the width of the TPU kernel's list; above that
the port raises where the TPU kernel keeps its 128.

K3 (``group_min``) returns the per-query minimum of the same distance over
every group of 128 consecutive targets, stored (groups, queries): phase A
of ``knn_grouped``.  Phase B (top groups, gather, exact distances,
``_extract_k_smallest``) is PyTorch.

Where the TPU kernel packs the tile-local column into the low mantissa
bits of each distance (a quantisation that depends on the tile width),
the card compares 64-bit keys ``(float bits << 32) | index``: a
non-negative float orders like its bits, so the keys order exactly like
(distance, index), with the JAX merge's tie rule (lower index first).

The wrappers are the kernel boundary (``K2`` and ``K3``, two
``cuda_build.Kernel`` of one library): a tensor on the card launches the
hand-written CUDA kernel (``csrc/knn.cu``, built on first use with nvcc
and bound with ctypes) or raises; a tensor on the CPU takes the plain
PyTorch twin, which computes the same keys with the same float operations
in the same order.  The twins are public (``knn_candidates_plain``,
``group_min_plain``) so that the kernels can be checked against them on
the card.

Both kernels can split the targets.  Where N is too small to fill the
card, K2 gives each of a query's S warps one slice of every tile of TILE
targets (``knn_slices``) and merges the slices' lists exactly
(``knn_candidates_sliced_plain`` and ``merge_candidate_keys`` are that
split and merge in plain torch); K3 gives each CTA a chunk of whole
groups (``group_chunks``).  S and the chunk size are functions of the
shapes and the card's SM count only (``_choose_split``,
``_choose_group_chunk``), so no launch waits on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .. import cuda_build

BIG = 3.0e38
GROUP = 128
# K2 keeps 1..MAX_KK candidates per query, in list_slots(kk) registers
# per lane of the query's warp
MAX_KK = 128
INIT_LOW = 0xFFFFFFFF            # index bits of an empty K2 slot (-1)
# the 64-bit key of an empty K2 slot: (bits of f32 BIG, INIT_LOW)
INIT_KEY = (0x7F61B1E6 << 32) | INIT_LOW
# K2's layout: CTAs of K2_WARPS warps of QUERIES_PER_WARP queries each,
# sharing tiles of TILE targets.  With a split S > 1 the S warps of a
# query group each scan slice s of every tile and their lists are merged;
# S is the least power of two up to K2_WARPS that gives the card
# K2_WARPS_PER_SM warps per SM
QUERIES_PER_WARP = 4
K2_WARPS = 8
TILE = 1024
K2_WARPS_PER_SM = 8
# K3's layout: CTAs of 128 queries and one chunk of whole groups each,
# about K3_CTAS_PER_SM CTAs per SM
K3_QUERIES_PER_CTA = 128
K3_CTAS_PER_SM = 8

_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_inputs(query, target, pen):
    n, m = query.shape[0], target.shape[0]
    for name, t, shape in (("query", query, (n, 3)),
                           ("target", target, (m, 3)), ("pen", pen, (m,))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on "
                             f"{query.device}")
    if m >= 2 ** 31 - 1:
        raise ValueError("K2/K3 index targets with int32")


def _sq_dist(q, t, pen):
    """(C, M) coordinate-wise squared distances in the kernels' order:
    ((pen + dx^2) + dy^2) + dz^2, clamped at BIG."""
    d = pen[None, :]
    for c in range(3):
        diff = q[:, c, None] - t[None, :, c]
        d = d + diff * diff
    return torch.clamp(d, max=BIG)


def _query_chunk(n_targets: int, device) -> int:
    budget = 1 << (26 if device.type == "cuda" else 22)
    return max(1, budget // max(n_targets, 1))


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def _check_kk(kk: int):
    if not 1 <= kk <= MAX_KK:
        raise ValueError(f"K2 keeps 1..{MAX_KK} candidates, got kk={kk}")


def list_slots(kk: int) -> int:
    """E, the registers per lane that hold a query's list in K2: 1, 2
    or 4, the least of them with 32 E >= kk."""
    _check_kk(kk)
    return 1 if kk <= 32 else 2 if kk <= 64 else 4


def _decode(key):
    """(val f32, idx int32) of int64 keys; INIT_LOW index bits give -1."""
    val = torch.bitwise_right_shift(key, 32).to(torch.int32).view(
        torch.float32)
    low = torch.bitwise_and(key, INIT_LOW)
    return val, torch.where(low == INIT_LOW, -1, low).to(torch.int32)


def _pad_keys(key, kk: int):
    """(N, C) keys with empty slots appended up to kk columns."""
    if key.shape[1] >= kk:
        return key
    return torch.cat([key, torch.full((key.shape[0], kk - key.shape[1]),
                                      INIT_KEY, dtype=torch.int64,
                                      device=key.device)], 1)


def knn_candidates_plain(query, target, pen, kk: int):
    """Plain PyTorch twin of K2: (val (N, kk) f32 ascending, idx (N, kk)
    int32), the kk smallest (distance, index) keys of each query; slots
    past the M-th candidate hold (BIG, -1).  1 <= kk <= MAX_KK."""
    _check_kk(kk)
    n, m = query.shape[0], target.shape[0]
    dev = query.device
    cols = torch.arange(m, dtype=torch.int64, device=dev)
    keys = []
    step = _query_chunk(m, dev)
    for c0 in range(0, n, step):
        d = _sq_dist(query[c0:c0 + step], target, pen)
        key = torch.bitwise_or(torch.bitwise_left_shift(
            d.view(torch.int32).to(torch.int64), 32), cols)
        keys.append(torch.topk(key, min(kk, m), dim=1, largest=False,
                               sorted=True).values)
    key = torch.cat(keys) if keys else torch.empty(
        (0, min(kk, m)), dtype=torch.int64, device=dev)
    return _decode(_pad_keys(key, kk))


def knn_slices(m: int, nslices: int, device=None):
    """The targets each of K2's ``nslices`` split warps scans: slice w takes
    [w * TILE // nslices, (w + 1) * TILE // nslices) of every tile of
    TILE targets, in the kernel's integer arithmetic.  A list of
    ascending int64 index tensors that partition range(m); a slice may be
    empty."""
    j = torch.arange(m, device=device)
    bounds = torch.tensor([(w + 1) * TILE // nslices
                           for w in range(nslices)], device=device)
    owner = torch.searchsorted(bounds, j % TILE, right=True)
    return [j[owner == w] for w in range(nslices)]


def knn_candidates_sliced_plain(query, target, pen, kk: int, nslices: int):
    """K2's split in plain torch: the twin's kk candidates of every query
    over each slice of ``knn_slices`` alone.  Returns (val, idx), each
    (nslices, N, kk), with indices into the whole target."""
    _check_kk(kk)
    vals, idxs = [], []
    for sl in knn_slices(target.shape[0], nslices, query.device):
        v, i = knn_candidates_plain(query, target[sl].contiguous(),
                                    pen[sl].contiguous(), kk)
        vals.append(v)
        if sl.numel():
            i = torch.where(i >= 0, sl[i.clamp(min=0).long()], -1)
        idxs.append(i.to(torch.int32))
    return torch.stack(vals), torch.stack(idxs)


def merge_candidate_keys(val, idx, kk: int):
    """Plain twin of K2's merge: (S, N, C) candidate lists (any order of
    slices and entries; empty slots (BIG, -1)) -> (val, idx), each
    (N, kk), the kk smallest (distance, index) pairs of each query.  The
    pairs are unique per query, so the result does not depend on the
    order of the slices."""
    _check_kk(kk)
    s, n, c = val.shape
    key = torch.bitwise_or(
        torch.bitwise_left_shift(val.view(torch.int32).to(torch.int64), 32),
        torch.bitwise_and(idx.to(torch.int64), INIT_LOW))
    key = key.permute(1, 0, 2).reshape(n, s * c)
    key = torch.topk(key, min(kk, s * c), dim=1, largest=False,
                     sorted=True).values
    return _decode(_pad_keys(key, kk))


def _choose_split(n: int, sms: int) -> int:
    """K2's split: target slices per query, from N and the card's SM count
    only (no host sync)."""
    qwarps = -(-n // QUERIES_PER_WARP)
    split = 1
    while split < K2_WARPS and qwarps * split < sms * K2_WARPS_PER_SM:
        split *= 2
    return split


def _launch_candidates(query, target, pen, kk):
    n, m = query.shape[0], target.shape[0]
    dev = query.device
    val = torch.empty((n, kk), dtype=torch.float32, device=dev)
    idx = torch.empty((n, kk), dtype=torch.int32, device=dev)
    split = _choose_split(n, K2.sm_count(dev))
    per_cta = QUERIES_PER_WARP * K2_WARPS // split
    K2.launch(query.data_ptr(), n, target.data_ptr(), pen.data_ptr(), m, kk,
              split, val.data_ptr(), idx.data_ptr(), device=dev, kk=kk,
              grid={"ctas": -(-n // per_cta), "warps_per_cta": K2_WARPS,
                    "queries_per_warp": QUERIES_PER_WARP,
                    "queries_per_cta": per_cta, "split": split,
                    "list_slots": list_slots(kk)})
    return val, idx


K2 = cuda_build.Kernel("K2", "knn.cu", "dcreg_knn_candidates",
                       [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P],
                       twin=knn_candidates_plain, on_card=_launch_candidates)


def knn_candidates(query, target, pen, kk: int):
    """K2's boundary: (val (N, kk) f32, idx (N, kk) int32) for f32
    query (N, 3), target (M, 3) and pen (M,), 1 <= kk <= MAX_KK.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    _check_kk(kk)
    _check_inputs(query, target, pen)
    return K2(query, target, pen, kk)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def group_min_plain(query, target, pen):
    """Plain PyTorch twin of K3: (ceil(M / 128), N) f32 group minima; the
    last group's missing targets count as BIG."""
    n, m = query.shape[0], target.shape[0]
    ng = -(-m // GROUP)
    dev = query.device
    out = []
    step = _query_chunk(ng * GROUP, dev)
    for c0 in range(0, n, step):
        d = _sq_dist(query[c0:c0 + step], target, pen)
        d = torch.nn.functional.pad(d, (0, ng * GROUP - m), value=BIG)
        out.append(torch.amin(d.reshape(d.shape[0], ng, GROUP), dim=2))
    g = torch.cat(out) if out else torch.empty((0, ng), device=dev)
    return g.T.contiguous()


def _choose_group_chunk(n: int, m: int, sms: int) -> int:
    """Groups per K3 chunk, from N, M and the card's SM count only: the
    (query blocks, chunks) grid holds about K3_CTAS_PER_SM CTAs per SM,
    at least one group per chunk."""
    ng = -(-m // GROUP)
    qblocks = -(-n // K3_QUERIES_PER_CTA)
    want = max(1, min(ng, -(-sms * K3_CTAS_PER_SM // max(qblocks, 1))))
    return -(-ng // want)


def group_chunks(m: int, gpc: int):
    """(lo, hi) int64 tensors of K3's chunks: chunk s takes groups
    [s * gpc, min((s + 1) * gpc, ceil(M / 128))), as the kernel does."""
    ng = -(-m // GROUP)
    lo = torch.arange(0, ng, gpc)
    return lo, torch.clamp(lo + gpc, max=ng)


def group_min_chunked_plain(query, target, pen, gpc: int):
    """K3's split in plain torch: the twin on each chunk's targets alone,
    its rows placed at the chunk's groups."""
    m = target.shape[0]
    out = []
    for g0, g1 in zip(*group_chunks(m, gpc)):
        j0, j1 = int(g0) * GROUP, min(int(g1) * GROUP, m)
        out.append(group_min_plain(query, target[j0:j1].contiguous(),
                                   pen[j0:j1].contiguous()))
    return torch.cat(out)


def _launch_group_min(query, target, pen):
    n, m = query.shape[0], target.shape[0]
    dev = query.device
    out = torch.empty((-(-m // GROUP), n), dtype=torch.float32, device=dev)
    gpc = _choose_group_chunk(n, m, K3.sm_count(dev))
    chunks = -(-out.shape[0] // gpc)
    K3.launch(query.data_ptr(), n, target.data_ptr(), pen.data_ptr(), m, gpc,
              out.data_ptr(), device=dev,
              grid={"ctas": -(-n // K3_QUERIES_PER_CTA) * chunks,
                    "chunks": chunks, "groups_per_chunk": gpc,
                    "queries_per_cta": K3_QUERIES_PER_CTA})
    return out


K3 = cuda_build.Kernel("K3", "knn.cu", "dcreg_knn_group_min",
                       [_P, _I, _P, _P, _I, _I, _P, _P],
                       twin=group_min_plain, on_card=_launch_group_min)


def group_min(query, target, pen):
    """K3's boundary: (ceil(M / 128), N) f32 group minima.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    _check_inputs(query, target, pen)
    if target.shape[0] == 0:
        raise ValueError("group_min needs at least one target")
    return K3(query, target, pen)


# ---------------------------------------------------------------------------
# The public searches
# ---------------------------------------------------------------------------

def _penalty(m, target_valid, device):
    """(M,) f32: 0 at valid targets, BIG at invalid ones."""
    if target_valid is None:
        return torch.zeros(m, dtype=torch.float32, device=device)
    return torch.where(target_valid.to(device=device, dtype=torch.bool),
                       0.0, BIG).to(torch.float32).contiguous()


def _exact_sq(cand, query):
    """Exact squared distances of candidates (..., C, 3) to their queries
    (..., 3), summed x, y, z in that order."""
    diff = cand - query[..., None, :]
    return (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]


def _smallest(d, idx, k: int):
    """The k smallest (d, idx) pairs of each row, ascending, equal
    distances ordered by index."""
    by_idx = torch.argsort(idx, dim=-1, stable=True)
    d = torch.gather(d, -1, by_idx)
    idx = torch.gather(idx, -1, by_idx)
    sel = torch.argsort(d, dim=-1, stable=True)[..., :k]
    return torch.gather(d, -1, sel), torch.gather(idx, -1, sel)


def knn(query, target, target_valid=None, k: int = 5, kk: int = 8):
    """Exact k nearest neighbours through K2 (``pallas_knn.knn``).

    query (N, 3), target (M, 3); returns (sq_dists (N, k) ascending in the
    query's dtype, indices (N, k) int64).  kk >= k candidates per query
    come from K2 and are re-ranked with exactly computed distances;
    candidates at BIG or on invalid targets rank as inf."""
    n, m = query.shape[0], target.shape[0]
    kk = max(k, kk)
    orig_dtype = query.dtype
    q = query.to(torch.float32).contiguous()
    t = target.to(torch.float32).contiguous()
    val, idx = knn_candidates(q, t, _penalty(m, target_valid, q.device), kk)
    idx = torch.clamp(idx.long(), 0, m - 1)
    d = _exact_sq(t[idx], q)
    d = torch.where(val >= BIG, float("inf"), d)
    if target_valid is not None:
        d = torch.where(target_valid.to(q.device)[idx], d, float("inf"))
    d, i = _smallest(d, idx, k)
    return d.to(orig_dtype), i


def _extract_k_smallest(d, idx, k: int):
    """k rounds of packed-key (min, mask) over a wide f32 candidate strip:
    the column packed into the low mantissa bits makes every key unique.
    d (..., C) >= 0 exact distances (inf allowed); idx (..., C).  Returns
    (vals (..., k) exact, indices (..., k)), near-ties ordered at the
    packing's quantisation."""
    C = d.shape[-1]
    mask_c = (1 << max(1, C - 1).bit_length()) - 1
    col = torch.arange(C, dtype=torch.int32, device=d.device)
    dn = torch.clamp(d, max=BIG) + 2.0 ** -30
    key = torch.bitwise_or(torch.bitwise_and(dn.view(torch.int32), ~mask_c),
                           col).view(torch.float32)
    vals, idxs = [], []
    for _ in range(k):
        m = torch.amin(key, dim=-1, keepdim=True)
        c = torch.bitwise_and(m.view(torch.int32), mask_c).long()
        vals.append(torch.gather(d, -1, c)[..., 0])
        idxs.append(torch.gather(idx, -1, c)[..., 0])
        key = torch.where(key == m, BIG, key)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def knn_grouped(query, target, target_valid=None, k: int = 5,
                groups: int = 8):
    """Exact k-NN through K3's group-min prefilter (``knn_grouped``).

    Phase A: the minimum distance of each query over every 128-target
    group (K3).  Phase B: the query's ``groups`` nearest groups (lower
    group first on equal minima), exact distances to their points, k + 3
    extracted and re-ranked.  Exact for k <= groups.  Returns
    (sq_dists (N, k), indices (N, k) int64)."""
    if groups < k:
        raise ValueError("group margin must cover k")
    n, m = query.shape[0], target.shape[0]
    orig_dtype = query.dtype
    q = query.to(torch.float32).contiguous()
    t = target.to(torch.float32).contiguous()
    dev = q.device
    gmin = group_min(q, t, _penalty(m, target_valid, dev)).T
    ng = gmin.shape[1]
    g = min(groups, ng)
    gidx = torch.sort(gmin, dim=1, stable=True).indices[:, :g]   # (N, g)
    blocks = torch.nn.functional.pad(t, (0, 0, 0, ng * GROUP - m)).reshape(
        ng, GROUP, 3)
    cand_idx = (gidx[..., None] * GROUP
                + torch.arange(GROUP, device=dev)).reshape(n, g * GROUP)
    d = _exact_sq(blocks[gidx].reshape(n, g * GROUP, 3), q)
    d = torch.where(cand_idx < m, d, float("inf"))
    if target_valid is not None:
        ok = target_valid.to(dev)[torch.clamp(cand_idx, max=m - 1)]
        d = torch.where(ok, d, float("inf"))
    d_kk, i_kk = _extract_k_smallest(d, cand_idx, k + 3)
    d, i = _smallest(d_kk, i_kk, k)
    return d.to(orig_dtype), i
