"""Brute-force nearest-neighbour search (counterpart of
``dcreg_tpu/ops/knn.py``).

The dispatch follows the JAX module's, by dtype:

* float32 takes K2's semantics (``knn_kernels.knn``): exact candidates
  from the kernel on the card, from its plain twin on the CPU, re-ranked
  with exactly computed distances, ``kk = max(k + 3, refine)`` of them;
* float64 takes the XLA path's semantics on the CPU: the
  |q|^2 + |t|^2 - 2 q.t expansion (exact to ~1e-12 relative in f64), the
  two-level ``_topk_min`` extraction and exact distances for the selected
  k.  The card runs f32, as the TPU did, so f64 on another device raises.
"""
from __future__ import annotations

import torch

from . import knn_kernels

LARGE = float("inf")


def _topk_min(d, k: int, group: int = 128):
    """Exact k smallest per row by two-level extraction: per-group minima
    once, then k rounds of (best group, its minimum, mask, patch that
    group's minimum).  d (C, M) -> (vals (C, k) ascending, idx (C, k));
    equal values resolve to the lower index."""
    C, M = d.shape
    rem = (-M) % group
    if rem:
        d = torch.nn.functional.pad(d, (0, rem), value=LARGE)
    G = d.shape[1] // group
    dg = d.reshape(C, G, group).clone()
    gmin = torch.amin(dg, dim=2)
    rows = torch.arange(C, device=d.device)
    vals, idxs = [], []
    for _ in range(k):
        g = torch.argmin(gmin, dim=1)
        block = dg[rows, g]                          # (C, group), a copy
        e = torch.argmin(block, dim=1)
        vals.append(block[rows, e])
        idxs.append(g * group + e)
        block[rows, e] = LARGE
        dg[rows, g] = block
        gmin[rows, g] = torch.amin(block, dim=1)
    return torch.stack(vals, 1), torch.stack(idxs, 1)


def knn(query, target, target_valid=None, k: int = 5, chunk: int = 1024,
        refine: int = 0):
    """k nearest neighbours of each query point in target.

    query (N, 3); target (M, 3); target_valid optional (M,) bool.  Returns
    (sq_dists (N, k) ascending, indices (N, k) int64)."""
    dtype = query.dtype
    if dtype == torch.float32:
        return knn_kernels.knn(query, target, target_valid, k=k,
                               kk=max(k + 3, refine))
    if dtype != torch.float64:
        raise TypeError(f"knn takes float32 or float64, got {dtype}")
    if query.device.type != "cpu":
        raise ValueError("float64 k-NN runs on the CPU only; the card "
                         "searches in float32 (K2)")
    t_sq = torch.sum(target * target, dim=-1)
    if target_valid is not None:
        t_sq = torch.where(target_valid, t_sq, LARGE)
    d_all, i_all = [], []
    for c0 in range(0, query.shape[0], chunk):
        q = query[c0:c0 + chunk]
        q_sq = torch.sum(q * q, dim=-1)
        d = q_sq[:, None] + t_sq[None, :] - 2.0 * (q @ target.T)
        dv, iv = _topk_min(d, k)
        d_all.append(dv)
        i_all.append(iv)
    i_k = torch.cat(i_all)
    # exact distances for the selected k (fixes the expansion's error)
    diff = target[i_k] - query[:, None, :]
    d_exact = torch.sum(diff * diff, dim=-1)
    if target_valid is not None:
        d_exact = torch.where(target_valid[i_k], d_exact, LARGE)
    return d_exact, i_k


def nn1(query, target, target_valid=None, chunk: int = 1024):
    """1-NN convenience wrapper returning ((N,) sqdist, (N,) index)."""
    d, i = knn(query, target, target_valid, k=1, chunk=chunk, refine=8)
    return d[:, 0], i[:, 0]
