"""Block index over a spatially sorted target cloud (counterpart of
``dcreg_tpu/ops/block_sparse.py``; the pair-mode ``block_knn`` is not
ported yet).

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
