"""Port parity: block index, cull, pair lists and the plain K1 twin
(dcreg_tpu_torch.ops.{block_sparse,block_knn}) against dcreg_tpu, with the
JAX kernel run in interpret mode.

Stated tolerances: pair lists, slot tables and every overflow count are
identical.  Neighbour ids are identical except where two candidates tie:
their distances agree within one fixed-point step plus the f32 rounding
of the transformed query (see ``_assert_same_neighbours``), which the
test asserts; distances agree within the same bound everywhere.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.ops import block_sparse as jbs
from dcreg_tpu.ops import pallas_block_knn as jk
from dcreg_tpu_torch.ops import block_sparse as tbs
from dcreg_tpu_torch.ops import block_knn as tk

CPU = "cpu"


def _euler(r, p, y):
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), \
        np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _terrain(m, extent, seed):
    rng = np.random.default_rng(seed)
    g = int(m * 0.7)
    xy = rng.uniform(-extent, extent, (g, 2))
    z = 0.4 * np.sin(0.25 * xy[:, 0]) * np.cos(0.2 * xy[:, 1]) \
        + rng.normal(0, 0.01, g)
    w = m - g
    wall = np.column_stack([rng.uniform(-extent, extent, w),
                            np.where(rng.random(w) < 0.5, -0.6, 0.6) * extent
                            + rng.normal(0, 0.02, w),
                            rng.uniform(0, 4, w)])
    return np.vstack([np.column_stack([xy, z]), wall]).astype(np.float32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _blocks(scan):
    n = scan.shape[0]
    nq = -(-n // 128)
    pad = np.concatenate([scan, np.repeat(scan[-1:], nq * 128 - n, axis=0)])
    src_q = pad.reshape(nq, 128, 3)
    return n, src_q, src_q.transpose(0, 2, 1).copy(), src_q.min(1), \
        src_q.max(1)


def _assert_same_neighbours(vals_t, idx_t, vals_j, idx_j, radius, ib,
                            qmax):
    """Ids equal; a mismatch is a tie of the two sides' distances.

    The keys of the two sides can differ for one reason only: the f32
    rounding of the transformed query q = R p + t.  The port pins the JAX
    kernel's operation order, while XLA's CPU backend may contract it into
    fused multiply-adds; a difference of a few ulp(|q|) moves a squared
    distance by about 2 * sqrt(clamp) * that, plus one fixed-point step of
    the key.  Both sides' distances agree within that bound everywhere,
    and where the ids differ the two candidates tie within it."""
    vals_t, idx_t = _np(vals_t), _np(idx_t)
    vals_j, idx_j = _np(vals_j), _np(idx_j)
    clamp = 1.1 * radius ** 2
    step = clamp / ((1 << (31 - ib)) - 2)
    tol = 2 * step + 8 * np.sqrt(clamp) * np.finfo(np.float32).eps * qmax
    diff = idx_t != idx_j
    assert diff.mean() < 1e-3, diff.mean()
    live = vals_j < 1e30
    assert np.array_equal(live, vals_t < 1e30)
    np.testing.assert_allclose(vals_t[live], vals_j[live], atol=tol, rtol=0)
    assert np.all(np.abs(vals_t[diff] - vals_j[diff]) <= tol)


def test_index_builders_and_orders():
    pts = _terrain(5000, 20.0, 1)
    assert np.array_equal(tbs.morton_argsort(pts), jbs.morton_argsort(pts))
    assert np.array_equal(tbs.kd_block_order(pts, 128),
                          jbs.kd_block_order(pts, 128))
    s = pts[tbs.kd_block_order(pts, 128)]
    bj = jbs.build_block_index(s, tb=128)
    bt = tbs.build_block_index(s, tb=128, device=CPU)
    for f in ("blocks", "valid", "lo", "hi"):
        np.testing.assert_array_equal(_np(getattr(bt, f)),
                                      np.asarray(getattr(bj, f)))
    assert (bt.num_blocks, bt.num_points) == (bj.num_blocks, bj.num_points)
    mj = jbs.build_map_index(s, tb=128, sb=8)
    mt = tbs.build_map_index(s, tb=128, sb=8, device=CPU)
    for f in ("sup_lo", "sup_hi", "blk_lo_g", "blk_hi_g"):
        np.testing.assert_array_equal(_np(getattr(mt, f)),
                                      np.asarray(getattr(mj, f)))
    assert (mt.sb, mt.num_supers) == (mj.sb, mj.num_supers)


def test_pair_lists_and_overflow():
    rng = np.random.default_rng(4)
    rel = rng.random((7, 13)) < 0.3
    for P in (8, 64):
        qj, tj, oj = jk.make_pair_list(jnp.asarray(rel), P)
        qt, tt, ot = tk.make_pair_list(torch.as_tensor(rel), P)
        assert np.array_equal(_np(qt), np.asarray(qj))
        assert np.array_equal(_np(tt), np.asarray(tj))
        assert int(ot) == int(oj)
    block_ids = rng.integers(0, 50, (7, 13))
    for P, G in ((8, 3), (64, 4), (64, 13)):
        outs_j = jk.make_pair_list_slotted(jnp.asarray(rel), P, G,
                                           block_ids=jnp.asarray(block_ids),
                                           nbt=50)
        outs_t = tk.make_pair_list_slotted(torch.as_tensor(rel), P, G,
                                           block_ids=torch.as_tensor(
                                               block_ids), nbt=50)
        for a, b in zip(outs_t, outs_j):
            assert np.array_equal(_np(a), np.asarray(b))


def test_lane_mask_packing_wraps_sign_bit():
    rng = np.random.default_rng(5)
    rel_l = rng.random((40, 5, 9)) < 0.4          # 40 lanes: 2 words
    rel = rel_l.any(axis=0)
    qj, tj, _ = jk.make_pair_list(jnp.asarray(rel), 60)
    mj = jk.pack_lane_mask(jnp.asarray(rel_l), qj, tj)
    qt, tt, _ = tk.make_pair_list(torch.as_tensor(rel), 60)
    mt = tk.pack_lane_mask(torch.as_tensor(rel_l), qt, tt)
    assert np.array_equal(_np(mt), np.asarray(mj))
    assert (np.asarray(mj) < 0).any()             # bit 31 in use


def test_super_candidates_ties_and_hier_relevance():
    """Overlapping super bboxes all score gap 0: the tie order (lowest
    super first) decides slot order and the slot table."""
    world = _terrain(20000, 12.0, 2)
    world = world[jbs.kd_block_order(world, 128)]
    mj = jbs.build_map_index(world, tb=128, sb=4)
    mt = tbs.build_map_index(world, tb=128, sb=4, device=CPU)
    rng = np.random.default_rng(6)
    scan = world[rng.choice(world.shape[0], 700, replace=False)] + 0.02
    scan = scan[jbs.kd_block_order(scan, 128)].astype(np.float32)
    n, src_q, _, slo, shi = _blocks(scan)
    B = 3
    Rs = np.stack([_euler(*rng.uniform(-0.02, 0.02, 3))
                   for _ in range(B)]).astype(np.float32)
    ts = rng.uniform(-0.2, 0.2, (B, 3)).astype(np.float32)
    r_cull = rng.uniform(0.3, 1.0, (B, src_q.shape[0])).astype(np.float32)
    active = np.array([True, False, True])
    qb_j = jk.exact_qbox(jnp.asarray(src_q), jnp.asarray(Rs),
                         jnp.asarray(ts))
    qb_t = tk.exact_qbox(torch.as_tensor(src_q), torch.as_tensor(Rs),
                         torch.as_tensor(ts))
    np.testing.assert_allclose(_np(qb_t[0]), np.asarray(qb_j[0]), atol=2e-6)
    for S in (6, 40):
        sj = jk.super_candidates(jnp.asarray(slo), jnp.asarray(shi),
                                 jnp.asarray(Rs), jnp.asarray(ts), mj,
                                 jnp.asarray(r_cull), S,
                                 active=jnp.asarray(active), qbox=qb_j)
        st = tk.super_candidates(torch.as_tensor(slo), torch.as_tensor(shi),
                                 torch.as_tensor(Rs), torch.as_tensor(ts),
                                 mt, torch.as_tensor(r_cull), S,
                                 active=torch.as_tensor(active), qbox=qb_t)
        score = np.asarray(sj[1]).sum()
        assert score > 0
        for a, b in zip(st, sj):
            assert np.array_equal(_np(a), np.asarray(b))
        rj, bj = jk.hier_relevance(jnp.asarray(slo), jnp.asarray(shi),
                                   jnp.asarray(Rs), jnp.asarray(ts), mj,
                                   sj[0], sj[1], jnp.asarray(r_cull),
                                   qbox=qb_j)
        rt, bt = tk.hier_relevance(torch.as_tensor(slo),
                                   torch.as_tensor(shi), torch.as_tensor(Rs),
                                   torch.as_tensor(ts), mt, st[0], st[1],
                                   torch.as_tensor(r_cull), qbox=qb_t)
        assert np.array_equal(_np(rt), np.asarray(rj))
        assert np.array_equal(_np(bt), np.asarray(bj))
    # tied scores do occur here: query blocks whose box overlaps several
    # super boxes see gap 0 for all of them
    qlo, qhi = (np.asarray(x)[0] for x in qb_j)
    gap = np.maximum(0.0, np.maximum(qlo[:, None] - np.asarray(mj.sup_hi),
                                     np.asarray(mj.sup_lo) - qhi[:, None]))
    assert ((gap * gap).sum(-1) == 0).sum(axis=1).max() >= 2


@pytest.mark.parametrize("mask", [False, True])
def test_plain_k1_vs_jax_interpret_global_ids(mask):
    rng = np.random.default_rng(17)
    pts = rng.uniform(-8, 8, (1500, 3)).astype(np.float32)
    spts = pts[jbs.morton_argsort(pts)]
    ij = jbs.build_block_index(spts, tb=128)
    it = tbs.build_block_index(spts, tb=128, device=CPU)
    B, radius = 3, 1.0
    Rs = np.stack([_euler(*rng.uniform(-0.05, 0.05, 3))
                   for _ in range(B)]).astype(np.float32)
    ts = rng.uniform(-0.4, 0.4, (B, 3)).astype(np.float32)
    n, src_q, src_b, slo, shi = _blocks(spts)
    rel_l = jk.lane_relevance(jnp.asarray(slo), jnp.asarray(shi),
                              jnp.asarray(Rs), jnp.asarray(ts), ij.lo, ij.hi,
                              radius, per_lane=True)
    rel_lt = tk.lane_relevance(torch.as_tensor(slo), torch.as_tensor(shi),
                               torch.as_tensor(Rs), torch.as_tensor(ts),
                               it.lo, it.hi, radius, per_lane=True)
    assert np.array_equal(_np(rel_lt), np.asarray(rel_l))
    rel = jnp.any(rel_l, axis=0)
    P = int(rel.sum()) + 9
    qid, tid, _ = jk.make_pair_list(rel, P)
    lmask = jk.pack_lane_mask(rel_l, qid, tid) if mask else None
    poses = np.concatenate([Rs.reshape(B, 9), ts], axis=1)
    covered = jnp.any(rel, axis=1)
    vj, ij_ = jk.batched_block_knn(ij, jnp.asarray(src_b), jnp.asarray(poses),
                                   qid, tid, num_pairs=P, radius=radius,
                                   covered=covered, lane_mask=lmask,
                                   layout="kn", interpret=True)
    vt, it_ = tk.batched_block_knn(
        it, torch.as_tensor(src_b), torch.as_tensor(poses),
        torch.as_tensor(np.asarray(qid)), torch.as_tensor(np.asarray(tid)),
        radius=radius, covered=torch.as_tensor(np.asarray(covered)),
        lane_mask=None if lmask is None else torch.as_tensor(
            np.asarray(lmask)), layout="kn")
    ib = jk._index_bits((ij.num_blocks + 1) * 128)
    _assert_same_neighbours(vt, it_, vj, ij_, radius, ib,
                            np.abs(spts).max() + 1.0)
    # and the nk layout is the transpose of kn
    vt2, it2 = tk.batched_block_knn(
        it, torch.as_tensor(src_b), torch.as_tensor(poses),
        torch.as_tensor(np.asarray(qid)), torch.as_tensor(np.asarray(tid)),
        radius=radius, layout="nk")
    assert torch.equal(it2[:, :, :5].transpose(1, 2)[..., :n],
                       it_[:, :5, :n] if not mask else it2[:, :, :5]
                       .transpose(1, 2)[..., :n])


@pytest.mark.parametrize("mask", [False, True])
def test_plain_k1_vs_jax_interpret_slotted(mask):
    rng = np.random.default_rng(29)
    world = _terrain(60000, 30.0, 3)
    world = world[jbs.kd_block_order(world, 128)]
    mj = jbs.build_map_index(world, tb=128, sb=16)
    mt = tbs.build_map_index(world, tb=128, sb=16, device=CPU)
    center = np.array([5.0, -3.0, 0.5])
    near = world[np.linalg.norm(world - center, axis=1) < 8.0]
    scan_w = near[rng.choice(near.shape[0], 500, replace=False)]
    B, radius = 2, 1.0
    Rs = np.stack([_euler(*rng.uniform(-0.03, 0.03, 3))
                   for _ in range(B)]).astype(np.float32)
    ts = (center[None] + rng.uniform(-0.3, 0.3, (B, 3))).astype(np.float32)
    scan = ((scan_w - ts[0]) @ Rs[0]).astype(np.float32)
    scan = scan[jbs.morton_argsort(scan)]
    n, src_q, src_b, slo, shi = _blocks(scan)
    from dcreg_tpu.models.icp_batch import estimate_map_capacities
    S, G, P = estimate_map_capacities(mj, scan, [(Rs[b], ts[b])
                                                 for b in range(B)], radius)
    sel, ok, _ = jk.super_candidates(jnp.asarray(slo), jnp.asarray(shi),
                                     jnp.asarray(Rs), jnp.asarray(ts), mj,
                                     radius, S)
    rel_l, bids = jk.hier_relevance(jnp.asarray(slo), jnp.asarray(shi),
                                    jnp.asarray(Rs), jnp.asarray(ts), mj,
                                    sel, ok, radius)
    rel = jnp.any(rel_l, axis=0)
    qid, tid, slot, col, table, ovf, rovf = jk.make_pair_list_slotted(
        rel, P, G, block_ids=bids, nbt=mj.block.num_blocks)
    assert int(ovf) == 0 and int(rovf) == 0
    lmask = jk.pack_lane_mask(rel_l, qid, col) if mask else None
    poses = np.concatenate([Rs.reshape(B, 9), ts], axis=1)
    covered = jnp.any(rel, axis=1)
    vj, ij_ = jk.batched_block_knn(mj.block, jnp.asarray(src_b),
                                   jnp.asarray(poses), qid, tid,
                                   num_pairs=P, radius=radius,
                                   covered=covered, lane_mask=lmask,
                                   layout="kn", interpret=True, slot=slot,
                                   tid_table=table, max_per_query=G)
    T = lambda a: torch.as_tensor(np.asarray(a))
    vt, it_ = tk.batched_block_knn(
        mt.block, T(src_b), T(poses), T(qid), T(tid), radius=radius,
        covered=T(covered), lane_mask=None if lmask is None else T(lmask),
        layout="kn", slot=T(slot), tid_table=T(table), max_per_query=G)
    _assert_same_neighbours(vt, it_, vj, ij_, radius,
                            jk._index_bits(G * 128),
                            np.abs(world).max() + 1.0)
    # brute-force spot check of lane 0
    q = scan @ Rs[0].T + ts[0]
    idx0 = _np(it_)[0, :5, :n]
    for row in range(0, n, 37):
        full = np.sum((q[row] - world) ** 2, axis=-1)
        d_true = np.sort(full)[:5]
        for j in range(5):
            if d_true[j] <= radius ** 2:
                assert abs(full[idx0[j, row]] - d_true[j]) < \
                    max(2.0 ** -11 * d_true[j], 5e-6)


def test_index_bits_raise():
    with pytest.raises(ValueError):
        tk._index_bits((1 << 18) + 1)
    assert tk._index_bits(2048 * 128) == 18
