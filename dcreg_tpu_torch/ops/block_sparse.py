"""Block index over a spatially sorted target cloud (counterpart of
``dcreg_tpu/ops/block_sparse.py``).

The builders run on the host in numpy, once per target cloud, and hand
the finished arrays to the device.  ``blocks`` is coordinate-major
(nbt + 1, 3, tb) with sentinel coordinates at padding slots and one
trailing all-sentinel block, the layout the K1 kernel reads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import resolve_device
from .knn_kernels import _extract_k_smallest

TB = 32    # default target block size (points)
QB = 128   # query block size (points)
BIG = 3.0e38


def morton_argsort(points) -> np.ndarray:
    """Morton (Z-order) sort permutation of an (M, 3) cloud, 21 bits per
    dimension."""
    pts = np.asarray(points, np.float64)
    lo = pts.min(axis=0)
    span = max(float((pts.max(axis=0) - lo).max()), 1e-9)
    q = np.minimum(((pts - lo) / span * ((1 << 21) - 1)).astype(np.uint64),
                   (1 << 21) - 1)

    def spread(x):
        x &= np.uint64(0x1FFFFF)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def kd_block_order(points, block: int = 128) -> np.ndarray:
    """Permutation grouping points into spatially compact ``block``-point
    runs by recursive median splits (balanced kd-tree leaves).  Splits land
    on multiples of ``block``, so every leaf but the last is full."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    out = np.empty(n, np.int64)
    pos = 0
    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if idx.size <= block:
            out[pos:pos + idx.size] = idx
            pos += idx.size
            continue
        p = pts[idx]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        nb = idx.size // block
        k = (nb // 2) * block if nb >= 2 else block
        part = np.argpartition(p[:, ax], k)
        stack.append(idx[part[k:]])
        stack.append(idx[part[:k]])
    return out


@dataclasses.dataclass(frozen=True)
class BlockIndex:
    """Blocked, spatially sorted target cloud + per-block bounding boxes.
    Indices refer to the SORTED target order."""
    blocks: torch.Tensor   # (nbt + 1, 3, tb) sorted target, sentinel pads
    valid: torch.Tensor    # (nbt, tb) bool, False at padding
    lo: torch.Tensor       # (nbt, 3) bbox over real points
    hi: torch.Tensor       # (nbt, 3)
    num_blocks: int
    num_points: int
    tb: int = TB


def build_block_index(sorted_points, dtype=torch.float32, tb: int = TB,
                      device=None) -> BlockIndex:
    """Build the block index from an already spatially sorted (M, 3)
    cloud, on ``device`` (cuda unless told otherwise)."""
    dev = resolve_device(device)
    pts = np.asarray(sorted_points, np.float64)
    M = pts.shape[0]
    nbt = -(-M // tb)
    pad = nbt * tb - M
    big = float(np.finfo(np.float32).max) if dtype == torch.float32 else BIG
    padded = np.concatenate([pts, np.full((pad, 3), big)])
    blocks = padded.reshape(nbt, tb, 3)
    valid = np.arange(nbt * tb).reshape(nbt, tb) < M
    lo = np.where(valid[..., None], blocks, np.inf).min(axis=1)
    hi = np.where(valid[..., None], blocks, -np.inf).max(axis=1)
    blocks = np.concatenate([blocks, np.full((1, tb, 3), big)])
    blocks = np.ascontiguousarray(blocks.transpose(0, 2, 1))
    put = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)
    return BlockIndex(blocks=put(blocks), valid=put(valid, torch.bool),
                      lo=put(lo), hi=put(hi), num_blocks=int(nbt),
                      num_points=int(M), tb=int(tb))


@dataclasses.dataclass(frozen=True)
class MapIndex:
    """Two-level block index for map-scale targets: level 0 is the flat
    BlockIndex, level 1 groups ``sb`` consecutive blocks into super-blocks
    with their own bboxes.  ``blk_lo_g``/``blk_hi_g`` hold the block bboxes
    grouped by super, (ns, sb * 3), padding rows inf / -inf."""
    block: BlockIndex
    sup_lo: torch.Tensor     # (ns, 3)
    sup_hi: torch.Tensor     # (ns, 3)
    blk_lo_g: torch.Tensor   # (ns, sb * 3)
    blk_hi_g: torch.Tensor   # (ns, sb * 3)
    sb: int
    num_supers: int


def build_map_index(sorted_points, dtype=torch.float32, tb: int = 128,
                    sb: int = 64, device=None) -> MapIndex:
    """Build the two-level index from an already sorted (M, 3) map."""
    dev = resolve_device(device)
    bi = build_block_index(sorted_points, dtype=dtype, tb=tb, device=dev)
    nbt = bi.num_blocks
    ns = -(-nbt // sb)
    pad = ns * sb - nbt
    lo = np.concatenate([bi.lo.cpu().numpy().astype(np.float64),
                         np.full((pad, 3), np.inf)])
    hi = np.concatenate([bi.hi.cpu().numpy().astype(np.float64),
                         np.full((pad, 3), -np.inf)])
    lo_g = lo.reshape(ns, sb, 3)
    hi_g = hi.reshape(ns, sb, 3)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return MapIndex(block=bi, sup_lo=put(lo_g.min(axis=1)),
                    sup_hi=put(hi_g.max(axis=1)),
                    blk_lo_g=put(lo_g.reshape(ns, sb * 3)),
                    blk_hi_g=put(hi_g.reshape(ns, sb * 3)),
                    sb=int(sb), num_supers=int(ns))


def suggest_num_blocks(index: BlockIndex, sample_queries, radius: float,
                       margin: int = 4) -> int:
    """Host-side estimate of ``block_knn``'s ``num_blocks``: the most
    relevant target blocks of any sample query block, plus margin."""
    q = np.asarray(sample_queries, np.float64).reshape(-1, 3)
    n = q.shape[0]
    nq = -(-n // QB)
    qb = np.concatenate([q, np.repeat(q[-1:], nq * QB - n, axis=0)]
                        ).reshape(nq, QB, 3)
    qlo, qhi = qb.min(axis=1), qb.max(axis=1)
    tlo = index.lo.cpu().numpy().astype(np.float64)
    thi = index.hi.cpu().numpy().astype(np.float64)
    gap = np.maximum(0.0, np.maximum(qlo[:, None] - thi[None, :],
                                     tlo[None, :] - qhi[:, None]))
    rel = (gap * gap).sum(-1) <= radius * radius
    return int(rel.sum(axis=1).max()) + margin


def block_knn(index: BlockIndex, query, radius: float, k: int = 5,
              num_blocks: int = 16):
    """Exact k-NN within ``radius`` by block culling.

    query (N, 3) spatially sorted like the cloud the index was built from.
    Each 128-point query block keeps its ``num_blocks`` nearest relevant
    target blocks (bbox gap <= radius; lower block first on equal gaps)
    and searches them densely with coordinate-wise distances.  Returns
    (sq_dists (N, k) ascending, idx (N, k) int64 into the sorted target,
    overflow () = query blocks with more relevant blocks than kept)."""
    n = query.shape[0]
    G = min(num_blocks, index.num_blocks)
    nq = -(-n // QB)
    qb = torch.cat([query, query[-1:].expand(nq * QB - n, 3)]).reshape(
        nq, QB, 3)
    qlo, qhi = torch.amin(qb, dim=1), torch.amax(qb, dim=1)
    gap = torch.clamp(torch.maximum(qlo[:, None] - index.hi[None, :],
                                    index.lo[None, :] - qhi[:, None]),
                      min=0.0)
    d_bb = torch.sum(gap * gap, dim=-1)                       # (nq, nbt)
    relevant = d_bb <= radius * radius
    overflow = torch.sum(torch.sum(relevant, dim=1) > G)
    score = torch.where(relevant, d_bb, float("inf"))
    score, bsel = torch.sort(score, dim=1, stable=True)
    slot_ok = torch.isfinite(score[:, :G])
    bsel = torch.where(slot_ok, bsel[:, :G], 0)               # (nq, G)
    tb = index.tb
    cand = index.blocks[bsel].transpose(-1, -2)               # (nq,G,tb,3)
    cok = index.valid[bsel] & slot_ok[..., None]
    cidx = bsel[..., None] * tb + torch.arange(tb, device=query.device)
    C = G * tb
    cand = cand.reshape(nq, C, 3)
    diff = qb[:, :, None, :] - cand[:, None, :, :]            # (nq,QB,C,3)
    d = torch.sum(diff * diff, dim=-1)
    d = torch.where(cok.reshape(nq, 1, C), d, float("inf"))
    idxb = cidx.reshape(nq, 1, C).expand(nq, QB, C)
    if query.dtype == torch.float64:
        d, sel = torch.sort(d, dim=-1, stable=True)
        vals, idx = d[..., :k], torch.gather(idxb, -1, sel[..., :k])
    else:
        vals, idx = _extract_k_smallest(d.reshape(nq * QB, C),
                                        idxb.reshape(nq * QB, C), k)
    vals = vals.reshape(nq * QB, k)[:n]
    idx = torch.clamp(idx.reshape(nq * QB, k)[:n], 0, index.num_points - 1)
    return vals, idx, overflow
