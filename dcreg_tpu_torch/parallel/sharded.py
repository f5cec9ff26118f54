"""Sharded registration over a (data, map) mesh of ``torch.distributed``
ranks (counterpart of ``dcreg_tpu/parallel/sharded.py``).

One process per device; the JAX module's 2-D device mesh becomes a grid
of ranks, rank r at (r // n_map, r % n_map), with two families of
process groups:

  ``data`` -- the ranks that share a map shard j: their source shards
              together make the whole scan (the OpenMP point loop of the
              reference, as data parallelism);
  ``map``  -- the ranks that share a source shard i: their map shards
              together make the whole target map.

Every rank runs the whole ICP loop on its own source and map shard, with
two collectives per iteration:

  1. each rank finds the exact top-k of its source shard in its map
     shard and keeps the candidates' coordinates (so no index ever
     crosses a shard); one ``all_gather`` over ``map`` brings every
     shard's candidates, and a k-way merge keeps the global top-k --
     exact, since each shard's top-k holds its members of the global
     top-k;
  2. the plane fit, robust weights and GN rows run on the local shard
     through the port's shared ops; one ``all_reduce`` over ``data`` sums
     the 6x6 H, g, the counters and the cull overflow (in float64, so
     the counts stay exact).

The 6x6 analysis, the solve and the pose update are replicated, so every
rank returns the same ``ShardedICPResult``.  Selections keep
``lax.top_k``'s order: equal values go to the lower index.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.icp import ICPParams
from ..ops import se3
from ..ops.correspondence import correspondence_tail
from ..ops.degeneracy import DetectionMethod, HandlingMethod, analyze
from ..ops.gauss_newton import build_system
from ..ops.solvers import solve
from ..utils import check_precise, resolve_device


class Mesh:
    """This rank's view of a (data, map) mesh of ranks.

    ``ranks`` (n_data, n_map) lays the global ranks out; ``coords`` is
    this rank's (i, j), None when it is not in the mesh; ``data`` and
    ``map`` are its two process groups; ``device`` is where it computes
    (gloo takes CUDA tensors too, staging them through host memory)."""

    def __init__(self, ranks, device, data_groups, map_groups):
        self.ranks = ranks
        self.shape = {"data": ranks.shape[0], "map": ranks.shape[1]}
        self.device = device
        me = np.argwhere(ranks == dist.get_rank())
        self.coords = tuple(int(c) for c in me[0]) if len(me) else None
        self.data = self.map = None
        if self.coords is not None:
            i, j = self.coords
            self.data, self.map = data_groups[j], map_groups[i]
            # all_gather lists a group's tensors by group rank; the mesh
            # order of the map shards may differ
            self.map_slots = [dist.get_group_rank(self.map, int(r))
                              for r in ranks[i]]


def make_mesh(n_data: int, n_map: int, devices=None, device=None) -> Mesh:
    """A (data, map) mesh over the first n_data * n_map ranks of the
    default process group (``devices``: the ranks in mesh order, all of
    them by default).  Every rank of the world must call it: it creates
    every data and map group, in one order.  ``device``: where this rank
    computes, cuda unless told otherwise."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed; call "
                           "parallel.distributed.init_distributed first")
    ranks = list(devices) if devices is not None else list(
        range(dist.get_world_size()))
    n = n_data * n_map
    if len(ranks) < n:
        raise ValueError(f"need {n} ranks, have {len(ranks)}")
    grid = np.array(ranks[:n]).reshape(n_data, n_map)
    data_groups = [dist.new_group([int(r) for r in grid[:, j]])
                   for j in range(n_map)]
    map_groups = [dist.new_group([int(r) for r in grid[i]])
                  for i in range(n_data)]
    return Mesh(grid, resolve_device(device), data_groups, map_groups)


def factor_mesh(n_devices: int) -> tuple[int, int]:
    """Split n devices into (data, map) -- map gets the smaller factor."""
    n_map = 1
    for cand in (2, 3):
        if n_devices % cand == 0 and n_devices // cand >= cand:
            n_map = cand
            break
    return n_devices // n_map, n_map


def pad_for_mesh(arr_len: int, shards: int) -> int:
    """Smallest multiple of ``shards`` >= arr_len."""
    return ((arr_len + shards - 1) // shards) * shards


def shard_points(xyz, shards: int, fill: float = 1e6, block: int = 1):
    """Pad (N, 3) points to a multiple of ``shards * block``; far-away fill
    keeps padded rows out of every radius gate.  ``block`` aligns each
    shard to the block-cull block size.  Returns (padded_xyz, valid) on
    the points' device (a numpy array becomes a CPU tensor)."""
    xyz = torch.as_tensor(xyz)
    n = xyz.shape[0]
    m = pad_for_mesh(n, shards * block)
    pad = torch.full((m - n, 3), fill, dtype=xyz.dtype, device=xyz.device)
    return (torch.cat([xyz, pad]),
            torch.arange(m, device=xyz.device) < n)


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def _all_reduce(mesh: Mesh, x):
    """Sum of ``x`` over the ranks of this rank's ``data`` group, in
    place (callers pass a temporary)."""
    dist.all_reduce(x, group=mesh.data)
    return x


def _all_gather(mesh: Mesh, x):
    """(n_map, *x.shape): every map shard's ``x``, in mesh order."""
    out = [torch.empty_like(x) for _ in mesh.map_slots]
    dist.all_gather(out, x, group=mesh.map)
    return torch.stack([out[s] for s in mesh.map_slots])


# --------------------------------------------------------------------------
# local search
# --------------------------------------------------------------------------

def _smallest(x, k: int):
    """The k smallest entries of each row (..., C), ascending, equal
    values in index order (``lax.top_k``'s order on -x), and their
    indices.  f32 ranks an exact int64 key (order-preserving bits, index);
    other dtypes sort stably."""
    if x.dtype == torch.float32:
        bits = (x + 0.0).view(torch.int32)        # -0 ranks as +0
        bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
        idx = torch.arange(x.shape[-1], device=x.device)
        key = torch.topk((bits.long() << 32) | idx, k, dim=-1,
                         largest=False).values
        sel = key & 0xFFFFFFFF
        return torch.gather(x, -1, sel), sel
    vals, sel = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], sel[..., :k]


def _bbox_gap_sq(lo_a, hi_a, lo_b, hi_b):
    """Squared gap between boxes (broadcast over leading dims); 0 where
    they overlap."""
    gap = torch.clamp(torch.maximum(lo_a - hi_b, lo_b - hi_a), min=0.0)
    return torch.sum(gap * gap, dim=-1)


def _local_topk(p_w, tgt_loc, tgt_valid_loc, kk):
    """Exact top-kk (smallest sqdist) of each row of p_w in the local map
    shard; returns (sqdist (n, kk), coords (n, kk, 3)).

    Dense (n, M_shard) variant for small shards: selects through the
    |q|^2 + |t|^2 - 2 q.t expansion, then recomputes the chosen
    candidates' distances coordinate-wise (the JAX module's design)."""
    t_sq = torch.sum(tgt_loc * tgt_loc, dim=-1)
    t_sq = torch.where(tgt_valid_loc, t_sq, float("inf"))
    d = (torch.sum(p_w * p_w, dim=-1)[:, None] + t_sq[None, :]
         - 2.0 * p_w @ tgt_loc.T)
    _, idx = _smallest(d, kk)
    cand = tgt_loc[idx]
    diff = cand - p_w[:, None, :]
    d_exact = torch.sum(diff * diff, dim=-1)
    d_exact = torch.where(tgt_valid_loc[idx], d_exact, float("inf"))
    return d_exact, cand


_QBS = 128   # query block size for the culled local search


def _local_topk_culled(p_w, q_valid, tgt_blocks, tgt_bval, blo, bhi,
                       radius, kk, G, sb: int = 0, GS: int = 0):
    """Exact within-``radius`` top-kk through bounding-box block culling
    inside the map shard: per 128-query block only the nearest G target
    blocks whose box lies within ``radius`` are searched.  Neighbours
    beyond ``radius`` may come back as inf; the radius gate downstream
    rejects them either way.

    ``sb`` > 0 takes the two-level cull: blocks group into supers of
    ``sb``; the query blocks first keep their <= GS nearest relevant
    supers, then the nearest relevant blocks among those supers' blocks.

    Returns (sqdist (n, kk), coords (n, kk, 3), overflow () int64: query
    blocks whose relevant blocks or supers exceeded G or GS)."""
    n = p_w.shape[0]
    nbt, tb = tgt_bval.shape
    dev, dtype = p_w.device, p_w.dtype
    Gc = min(G, nbt)
    nq = -(-n // _QBS)
    pad = nq * _QBS - n
    qb = torch.cat([p_w, torch.full((pad, 3), 1e6, dtype=dtype,
                                    device=dev)]).reshape(nq, _QBS, 3)
    qvb = torch.cat([q_valid, torch.zeros(pad, dtype=torch.bool,
                                          device=dev)]).reshape(nq, _QBS)
    # query boxes over VALID rows only: padded rows carry the far fill
    qlo = torch.amin(torch.where(qvb[..., None], qb, float("inf")), dim=1)
    qhi = torch.amax(torch.where(qvb[..., None], qb, float("-inf")), dim=1)
    count_over = lambda rel, cap: torch.sum(torch.sum(rel, dim=1) > cap)

    r2 = radius * radius
    if sb and nbt > sb:
        ns = -(-nbt // sb)
        pad_b = ns * sb - nbt
        blo_p = torch.cat([blo, torch.full((pad_b, 3), float("inf"),
                                           dtype=dtype, device=dev)])
        bhi_p = torch.cat([bhi, torch.full((pad_b, 3), float("-inf"),
                                           dtype=dtype, device=dev)])
        slo = torch.amin(blo_p.reshape(ns, sb, 3), dim=1)
        shi = torch.amax(bhi_p.reshape(ns, sb, 3), dim=1)
        ds = _bbox_gap_sq(qlo[:, None], qhi[:, None], slo[None], shi[None])
        rel_s = ds <= r2                                       # (nq, ns)
        GSc = min(max(GS, 1), ns)
        if GSc * sb < Gc:
            raise ValueError(f"{GSc} supers of {sb} blocks hold fewer "
                             f"blocks than num_blocks = {Gc}")
        sup_ovf = count_over(rel_s, GSc)
        sval, ssel = _smallest(torch.where(rel_s, ds, float("inf")), GSc)
        s_ok = torch.isfinite(sval)
        ssel = torch.where(s_ok, ssel, 0)
        # candidate blocks of the selected supers only: (nq, GSc * sb)
        cand_ids = (ssel[:, :, None] * sb
                    + torch.arange(sb, device=dev)).reshape(nq, GSc * sb)
        in_map = (cand_ids < nbt) & s_ok.repeat_interleave(sb, dim=1)
        cand_ids = torch.where(in_map, cand_ids, 0)
        d_bb = _bbox_gap_sq(qlo[:, None], qhi[:, None], blo[cand_ids],
                            bhi[cand_ids])                     # (nq, C)
        rel = (d_bb <= r2) & in_map
        overflow = sup_ovf + count_over(rel, Gc)
        bval, col = _smallest(torch.where(rel, d_bb, float("inf")), Gc)
        slot_ok = torch.isfinite(bval)
        bsel = torch.where(slot_ok, torch.gather(cand_ids, 1, col), 0)
    else:
        d_bb = _bbox_gap_sq(qlo[:, None], qhi[:, None], blo[None],
                            bhi[None])                         # (nq, nbt)
        rel = d_bb <= r2
        overflow = count_over(rel, Gc)
        bval, bsel = _smallest(torch.where(rel, d_bb, float("inf")), Gc)
        slot_ok = torch.isfinite(bval)
        bsel = torch.where(slot_ok, bsel, 0)

    cand = tgt_blocks[bsel].reshape(nq, Gc * tb, 3)
    cok = (tgt_bval[bsel] & slot_ok[..., None]).reshape(nq, Gc * tb)
    # keep candidate coordinates finite (the padding fill is far but
    # finite; a clipped sentinel stays beyond every radius gate and
    # never puts a NaN into the plane fit)
    cand = torch.clamp(cand, -1e6, 1e6)
    diff = qb[:, :, None, :] - cand[:, None, :, :]
    d = torch.sum(diff * diff, dim=-1)                         # (nq, QBS, C)
    d = torch.where(cok[:, None, :], d, float("inf"))
    d_sel, sel = _smallest(d, kk)                              # (nq, QBS, kk)
    coords = cand[torch.arange(nq, device=dev)[:, None, None], sel]
    return (d_sel.reshape(nq * _QBS, kk)[:n],
            coords.reshape(nq * _QBS, kk, 3)[:n], overflow)


# --------------------------------------------------------------------------
# the sharded engine
# --------------------------------------------------------------------------

class ShardedICPResult(NamedTuple):
    R: torch.Tensor                  # (3, 3)
    t: torch.Tensor                  # (3,)
    converged: torch.Tensor          # () bool
    aborted: torch.Tensor            # () bool
    iterations: torch.Tensor         # () int32
    rmse: torch.Tensor               # () final-iteration rmse
    fitness: torch.Tensor            # ()
    effective_points: torch.Tensor   # () int32
    dx_history: torch.Tensor         # (I, 6)
    transform_history: torch.Tensor  # (I, 4, 4)
    block_overflow: torch.Tensor     # () int32 (block-cull capacity; 0 = exact)


def _shard(x, k: int, shards: int, dev, dtype=None):
    """Rows of shard k of ``shards`` of ``x`` on ``dev`` (a view when
    ``x`` is already there)."""
    rows = x.shape[0] // shards
    return torch.as_tensor(x[k * rows:(k + 1) * rows], dtype=dtype,
                           device=dev)


def sharded_icp_register(mesh: Mesh, source_xyz, target_xyz, R0, t0,
                         detection: DetectionMethod,
                         handling: HandlingMethod,
                         params: ICPParams = ICPParams(),
                         T_gt=None, source_valid=None, target_valid=None,
                         block_cull: bool = True, block_size: int = 32,
                         num_blocks: int = 16, super_size: int = 0,
                         num_supers: int = 8) -> ShardedICPResult:
    """Full degeneracy-aware point-to-plane ICP, sharded over ``mesh``.

    Every rank of the mesh calls it with the same global padded arrays:
    source_xyz (N, 3) with N divisible by mesh.shape['data'], target_xyz
    (M, 3) with M divisible by mesh.shape['map'] (and, with
    ``block_cull``, by map * block_size -- use ``shard_points(...,
    block=block_size)``); pads are marked by the validity masks.  Each
    rank takes its own rows to ``mesh.device``; the dtype is the
    source's.  Returns the same ShardedICPResult on every rank.

    block_cull: search each map shard through ``block_size``-point
    bounding-box blocks, at most ``num_blocks`` relevant blocks per
    128-query block (exact within the correspondence radius; the target
    should be spatially sorted, ``ops/block_sparse.kd_block_order``);
    ``False`` takes the dense (n, M_shard) search for small targets.
    super_size > 0 adds the two-level cull (supers of ``super_size``
    blocks, at most ``num_supers`` relevant supers per query block).
    ``T_gt`` is accepted for the JAX signature and not used."""
    del T_gt
    check_precise()
    if mesh.coords is None:
        raise ValueError("this rank is not in the mesh")
    dev = mesh.device
    source_xyz = torch.as_tensor(source_xyz)
    dtype = source_xyz.dtype
    N, M = source_xyz.shape[0], target_xyz.shape[0]
    n_data, n_map = mesh.shape["data"], mesh.shape["map"]
    tb = block_size
    if N % n_data or M % n_map:
        raise ValueError(f"source rows {N} / target rows {M} must divide "
                         f"by the mesh's data / map axes ({n_data}, "
                         f"{n_map}); pad with shard_points")
    if block_cull and M % (n_map * tb):
        raise ValueError(
            f"block_cull needs M divisible by map shards * block_size "
            f"({n_map} * {tb}); pad with shard_points(..., block={tb})")
    if source_valid is None:
        source_valid = torch.ones(N, dtype=torch.bool)
    if target_valid is None:
        target_valid = torch.ones(M, dtype=torch.bool)
    i, j = mesh.coords
    src = _shard(source_xyz, i, n_data, dev)
    src_val = _shard(source_valid, i, n_data, dev, torch.bool)
    tgt = _shard(target_xyz, j, n_map, dev, dtype)
    tgt_val = _shard(target_valid, j, n_map, dev, torch.bool)
    cp = params.corr
    k = cp.k
    I = params.max_iterations
    num_source = _all_reduce(mesh, torch.sum(src_val, dtype=torch.int64))

    if block_cull:
        # one-time per-shard block structure (the KD-tree build)
        nbt_loc = tgt.shape[0] // tb
        tgt_blocks = tgt.reshape(nbt_loc, tb, 3)
        tgt_bval = tgt_val.reshape(nbt_loc, tb)
        blo = torch.amin(torch.where(tgt_bval[..., None], tgt_blocks,
                                     float("inf")), dim=1)
        bhi = torch.amax(torch.where(tgt_bval[..., None], tgt_blocks,
                                     float("-inf")), dim=1)

    def one_iteration(R, t):
        p_w = src @ R.T + t
        if block_cull:
            d_loc, c_loc, b_ovf = _local_topk_culled(
                p_w, src_val, tgt_blocks, tgt_bval, blo, bhi,
                cp.search_radius, k, num_blocks, sb=super_size,
                GS=num_supers)
        else:
            d_loc, c_loc = _local_topk(p_w, tgt, tgt_val, k)
            b_ovf = torch.zeros((), dtype=torch.int64, device=dev)
        # collective 1: every map shard's candidates (and overflow: at
        # most one per 128-query block, exact in the dtype) ...
        n_loc = p_w.shape[0]
        packed = torch.cat([torch.cat([d_loc[..., None], c_loc],
                                      dim=-1).reshape(-1),
                            b_ovf.to(dtype).reshape(1)])
        gathered = _all_gather(mesh, packed)
        ovf_map = torch.sum(gathered[:, -1])
        cands = gathered[:, :-1].reshape(n_map, n_loc, k, 4)
        # ... merged into the exact global top-k, in (shard, rank) order
        flat = cands.permute(1, 0, 2, 3).reshape(n_loc, n_map * k, 4)
        sq_d, sel = _smallest(flat[..., 0], k)
        neigh = torch.gather(flat[..., 1:], 1,
                             sel[..., None].expand(n_loc, k, 3))
        corr = correspondence_tail(p_w, sq_d, sel, neigh, cp,
                                   source_valid=src_val)
        sysm = build_system(src, R, t, corr,
                            use_weight_derivative=params.use_weight_derivative,
                            weight_slope=cp.weight_slope)
        # collective 2: H, g and the counters, summed over the data axis
        sq_sum = torch.sum(torch.where(corr.valid,
                                       corr.residual * corr.residual, 0.0))
        n_fit = torch.sum(sq_d[:, k - 1] < cp.search_radius ** 2)
        f64 = lambda *xs: torch.cat([x.reshape(-1).double() for x in xs])
        tot = _all_reduce(mesh, f64(sysm.H, sysm.g, sq_sum, sysm.objective,
                                    sysm.num_valid, n_fit, ovf_map))
        H = tot[:36].reshape(6, 6).to(dtype)
        g = tot[36:42].to(dtype)
        sq_sum, obj, n_valid, n_fit, ovf = tot[42:]
        rmse = torch.sqrt(sq_sum / torch.clamp(n_valid, min=1)).to(dtype)
        fitness = (n_fit / torch.clamp(num_source, min=1)).to(dtype)
        analysis = analyze(H, detection, params.thresholds)
        # telemetry=False: the loop consumes only dx
        dx, _ = solve(H, g, handling, analysis, params.thresholds,
                      telemetry=False)
        return dx, n_valid.long(), rmse, fitness, ovf.long()

    R = torch.as_tensor(R0, dtype=dtype, device=dev)
    t = torch.as_tensor(t0, dtype=dtype, device=dev)
    dx_h = torch.full((I, 6), float("nan"), dtype=dtype, device=dev)
    T_h = torch.full((I, 4, 4), float("nan"), dtype=dtype, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    abort = torch.zeros((), dtype=torch.bool, device=dev)
    rmse = fit = torch.full((), float("nan"), dtype=dtype, device=dev)
    neff = ovf = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < I and not bool(conv | abort):          # one host sync
        dx, n_valid, rmse, fit, b_ovf = one_iteration(R, t)
        abort = (n_valid < params.min_effective_points) | \
            ~torch.all(torch.isfinite(dx))
        dx = torch.where(abort, 0.0, dx)
        R_new, t_new = se3.boxplus(R, t, dx)
        R = torch.where(abort, R, R_new)
        t = torch.where(abort, t, t_new)
        conv = (torch.linalg.norm(dx[:3]) < params.convergence_thresh_rot) \
            & (torch.linalg.norm(dx[3:]) < params.convergence_thresh_trans) \
            & ~abort
        dx_h[it] = dx
        T_h[it] = se3.se3_matrix(R, t)
        neff = n_valid
        ovf = torch.maximum(ovf, b_ovf)
        it += 1
    i32 = lambda x: torch.as_tensor(x, device=dev).to(torch.int32)
    return ShardedICPResult(R=R, t=t, converged=conv, aborted=abort,
                            iterations=i32(it), rmse=rmse, fitness=fit,
                            effective_points=i32(neff), dx_history=dx_h,
                            transform_history=T_h, block_overflow=i32(ovf))
