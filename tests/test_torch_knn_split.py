"""K2's and K3's splits on the CPU.

Where N is small, K2 gives each of a query's warps one slice of every
tile of targets (``knn_slices``); each warp keeps its slice's kk best
candidates, and the slices' lists are merged by the full (distance,
index) order (``merge_candidate_keys``).  The plain twin run slice by
slice and merged must give the unsplit twin's (val, idx) bit for bit, and
the composed ``knn`` must still match ``pallas_knn.knn(interpret=True)``
within ``tests/test_torch_knn.py``'s tolerance (identical index sets,
distances within 2 ulp).  ``_kernel_model`` replays the kernel's schedule in numpy
(lanes taking 32 targets at a time, lists of 32 entries, the bound of a
batch fixed as it begins, NaN while a list has an empty slot, insertion
in ballot order, the merge of the slices) and must give the plain twin's
bits too.

K3 gives each CTA a chunk of whole 128-target groups (``group_chunks``):
the chunks must cover every group exactly once, and the twin run chunk by
chunk must give the unsplit twin's minima bit for bit.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.ops import pallas_knn
from dcreg_tpu_torch.ops import knn_kernels as tkk
from tests import test_torch_knn as base

KKS = [1, 5, 8, 10, 16]
NSLICES = [1, 2, 3, 4, 7, 8, 16]
T = torch.from_numpy


def _case(kind, n=37, seed=21):
    """(query, target, pen) for one kind of target cloud:
    ragged: M = 2,500, a multiple of neither the tile nor any slice;
    tiny: M = 3, fewer targets than kk and than most slice counts;
    invalid: M = 1,030, 30% of the targets invalid;
    duplicates: M = 1,200 with 200 exact duplicates and queries on them;
    overflow: M = 300, 4 valid targets, the invalid ones so far away that
    BIG plus their squared distance overflows to inf."""
    rng = np.random.default_rng(seed)
    m = {"ragged": 2500, "tiny": 3, "invalid": 1030, "duplicates": 1000,
         "overflow": 300}[kind]
    t = rng.uniform(-3.0, 3.0, (m, 3)).astype(np.float32)
    q = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    valid = np.ones(m, bool)
    if kind == "invalid":
        valid = rng.uniform(size=m) >= 0.3
    if kind == "overflow":
        valid = np.zeros(m, bool)
        valid[[5, 60, 61, 250]] = True
        t[~valid] *= np.float32(1e19)
    if kind == "duplicates":
        t = np.concatenate([t, t[rng.choice(m, 200, replace=False)]])
        q[: n // 2] = t[rng.choice(len(t), n // 2)]
        valid = np.ones(len(t), bool)
    pen = tkk._penalty(len(t), T(valid), torch.device("cpu"))
    return T(q), T(t), pen


def _bits(x):
    return x.view(torch.int32)


# ---------------------------------------------------------------------------
# K2: slices, split and merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [0, 3, 1000, 1024, 2500, 4100])
@pytest.mark.parametrize("nslices", NSLICES)
def test_slices_partition_the_targets(m, nslices):
    slices = tkk.knn_slices(m, nslices)
    assert len(slices) == nslices
    owner = np.full(m, -1)
    for w, sl in enumerate(slices):
        sl = sl.numpy()
        assert (np.diff(sl) > 0).all()          # ascending: indices grow
        assert (owner[sl] == -1).all()
        owner[sl] = w
        # within a tile, slice w is [w * TILE // S, (w + 1) * TILE // S)
        pos = sl % tkk.TILE
        assert (pos >= w * tkk.TILE // nslices).all()
        assert (pos < (w + 1) * tkk.TILE // nslices).all()
    assert (owner >= 0).all()


@pytest.mark.parametrize("kind", ["ragged", "tiny", "invalid", "duplicates",
                                  "overflow"])
@pytest.mark.parametrize("nslices", NSLICES)
@pytest.mark.parametrize("kk", KKS)
def test_sliced_then_merged_equals_plain(kk, nslices, kind):
    q, t, pen = _case(kind)
    want_v, want_i = tkk.knn_candidates_plain(q, t, pen, kk)
    sv, si = tkk.knn_candidates_sliced_plain(q, t, pen, kk, nslices)
    assert sv.shape == si.shape == (nslices, q.shape[0], kk)
    got_v, got_i = tkk.merge_candidate_keys(sv, si, kk)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    assert torch.equal(_bits(got_v), _bits(want_v))
    assert torch.equal(got_i, want_i)
    # the merge does not depend on the order of the slices
    fv, fi = tkk.merge_candidate_keys(sv.flip(0), si.flip(0), kk)
    assert torch.equal(_bits(fv), _bits(want_v)) and torch.equal(fi, want_i)
    m = t.shape[0]
    if m < kk:
        # the missing slots are (BIG, -1), after every real candidate
        assert bool((want_i[:, m:] == -1).all())
        assert bool((want_v[:, m:] == tkk.BIG).all())
    if kind == "invalid":
        # enough valid targets: no candidate at BIG
        assert bool((want_v < tkk.BIG).all())
    if kind == "overflow":
        # after the 4 valid targets, invalid ones at BIG by index
        assert bool((want_v[:, min(kk, 4):] == tkk.BIG).all())
        assert bool((want_i[:, min(kk, 4):] >= 0).all())
    if kind == "duplicates" and kk > 1:
        # ties go to the lower index first
        tie = want_v[:, 1:] == want_v[:, :-1]
        assert bool(tie.any())
        assert bool((want_i[:, 1:][tie] > want_i[:, :-1][tie]).all())


@pytest.mark.parametrize("kk", [5, 16])
def test_merge_keeps_invalid_candidates_before_empty_slots(kk):
    """Fewer valid targets than kk: invalid ones fill in at (BIG, j) by
    index, then empty slots (BIG, -1)."""
    rng = np.random.default_rng(5)
    t = T(rng.uniform(-1, 1, (12, 3)).astype(np.float32))
    valid = np.zeros(12, bool)
    valid[[3, 7]] = True
    pen = tkk._penalty(12, T(valid), torch.device("cpu"))
    q = T(rng.uniform(-1, 1, (9, 3)).astype(np.float32))
    want_v, want_i = tkk.knn_candidates_plain(q, t, pen, kk)
    got_v, got_i = tkk.merge_candidate_keys(
        *tkk.knn_candidates_sliced_plain(q, t, pen, kk, 4), kk)
    assert torch.equal(_bits(got_v), _bits(want_v))
    assert torch.equal(got_i, want_i)
    assert bool((want_v[:, 2:] == tkk.BIG).all())
    assert torch.equal(want_i[0, 2:min(kk, 12)],
                       torch.tensor([j for j in range(12) if not valid[j]]
                                    [:min(kk, 12) - 2], dtype=torch.int32))
    assert bool((want_i[:, 12:] == -1).all())


# ---------------------------------------------------------------------------
# K2: the kernel's schedule
# ---------------------------------------------------------------------------

EMPTY = np.nextafter(np.float32(tkk.BIG), np.float32(np.inf))
LANES = 32


def _key_less(da, ja, db, jb):
    return da < db or (da == db and (ja & 0xFFFFFFFF) < (jb & 0xFFFFFFFF))


def _warp_insert(h, l, d, j, before):
    """The warp's insertion: (d, j) goes after the entries ``before``
    keeps ahead of it; lane 31's entry drops out."""
    pos = sum(before(h[r], l[r]) for r in range(len(h)))
    h.insert(pos, d)
    l.insert(pos, j)
    h.pop()
    l.pop()


def _kernel_model(q, t, pen, kk, split):
    """K2's schedule in numpy, one query at a time.  Each of the query's
    ``split`` warps keeps a list of LANES entries and scans its slice of
    every tile LANES targets at a time; the lanes whose unclamped distance
    passes !(d >= bound) (bound: entry kk - 1 as the batch began, or NaN
    while that is an empty slot) go in lowest lane first, clamped at BIG,
    after the entries <= them, with no second test.  Then the first warp's
    list takes, list by list, the other slices' first kk entries that beat
    its entry kk - 1, by the (d, j) order.  Returns (val, idx), each
    (N, kk): the first kk entries."""
    n, m = q.shape[0], t.shape[0]
    big = np.float32(tkk.BIG)
    val = np.empty((n, kk), np.float32)
    idx = np.empty((n, kk), np.int32)
    for i in range(n):
        lists = []
        for s in range(split):
            h, l = [EMPTY] * LANES, [-1] * LANES
            for j0 in range(0, m, tkk.TILE):
                nt = min(tkk.TILE, m - j0)
                end = min((s + 1) * tkk.TILE // split, nt)
                for b in range(s * tkk.TILE // split, end, LANES):
                    e = np.arange(b, b + LANES)
                    jj = j0 + np.minimum(e, end - 1)
                    with np.errstate(over="ignore"):
                        d = pen[jj] + (q[i, 0] - t[jj, 0]) ** 2
                        d = d + (q[i, 1] - t[jj, 1]) ** 2
                        d = d + (q[i, 2] - t[jj, 2]) ** 2
                    last = h[kk - 1]
                    bound = np.float32(np.nan) if last > big else last
                    with np.errstate(invalid="ignore"):
                        enter = (e < end) & ~(d >= bound)
                    for c in np.nonzero(enter)[0]:
                        dc = min(d[c], big)
                        _warp_insert(h, l, dc, j0 + b + c,
                                     lambda hr, lr: hr <= dc)
            lists.append((h, l))
        h, l = lists[0]
        for hv, lv in lists[1:]:
            ahead = [r for r in range(kk)
                     if _key_less(hv[r], lv[r], h[kk - 1], l[kk - 1])]
            for r in ahead:
                dc, jc = hv[r], lv[r]
                if _key_less(dc, jc, h[kk - 1], l[kk - 1]):
                    _warp_insert(h, l, dc, jc,
                                 lambda hr, lr: _key_less(hr, lr, dc, jc))
        h, l = h[:kk], l[:kk]
        filled = np.array(h) != EMPTY
        val[i] = np.where(filled, h, big)
        idx[i] = np.where(filled, l, -1)
    return val, idx


@pytest.mark.parametrize("kind,kk,split", [
    ("ragged", 10, 1), ("ragged", 16, 8), ("invalid", 5, 2),
    ("invalid", 10, 8), ("duplicates", 8, 4), ("tiny", 10, 8),
    ("overflow", 10, 1), ("overflow", 16, 4)])
def test_kernel_schedule_equals_plain(kind, kk, split):
    q, t, pen = _case(kind, n=23)
    want_v, want_i = tkk.knn_candidates_plain(q, t, pen, kk)
    got_v, got_i = _kernel_model(q.numpy(), t.numpy(), pen.numpy(), kk,
                                 split)
    assert np.array_equal(got_v.view(np.int32), _bits(want_v).numpy())
    assert np.array_equal(got_i, want_i.numpy())


# ---------------------------------------------------------------------------
# K2: the composed knn through the split, against JAX (interpret=True)
# ---------------------------------------------------------------------------

def _sliced_candidates(query, target, pen, kk, nslices):
    _sliced_candidates.calls += 1
    return tkk.merge_candidate_keys(
        *tkk.knn_candidates_sliced_plain(query, target, pen, kk, nslices),
        kk)


_sliced_candidates.calls = 0


@pytest.mark.parametrize("n,m,k,masked", [(777, 2500, 5, False),
                                          (64, 100, 1, False),
                                          (300, 1500, 5, True)])
@pytest.mark.parametrize("nslices", [3, 8])
def test_sliced_knn_vs_pallas_interpret(monkeypatch, n, m, k, masked,
                                        nslices):
    monkeypatch.setattr(tkk, "knn_candidates",
                        functools.partial(_sliced_candidates,
                                          nslices=nslices))
    q, t = base._clouds(n, m, seed=3)
    valid = np.random.default_rng(4).uniform(size=m) > 0.3 if masked \
        else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else T(valid)
    kk = max(k + 3, 8)
    before = _sliced_candidates.calls
    d1, i1 = pallas_knn.knn(jnp.asarray(q), jnp.asarray(t), jv, k=k, kk=kk,
                            tq=64, tt=256, interpret=True)
    d2, i2 = tkk.knn(T(q), T(t), tv, k=k, kk=kk)
    assert _sliced_candidates.calls == before + 1
    assert np.array_equal(np.sort(np.asarray(i1), -1),
                          np.sort(i2.numpy(), -1))
    base._assert_f32_dists(d2.numpy(), np.asarray(d1))


# ---------------------------------------------------------------------------
# Launch layouts: functions of the shapes and the SM count only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,sms,split", [
    (8192, 132, 1),          # (d), (e): 256 CTAs, 2,048 warps
    (65536, 132, 1),         # (f): 2,048 CTAs
    (333, 132, 8),           # (g): 84 query warps, split 8 ways
    (2000, 132, 4),
    (8192, 114, 1),          # an H100 PCIe's SMs
    (1000, 114, 4),
    (1, 132, 8)])
def test_choose_split(n, sms, split):
    got = tkk._choose_split(n, sms)
    assert got == split
    assert 1 <= got <= tkk.K2_WARPS and tkk.K2_WARPS % got == 0
    warps = -(-n // tkk.QUERIES_PER_WARP) * got
    # 8 warps per SM where the split can give them
    assert warps >= 8 * sms or got == tkk.K2_WARPS
    if n == 8192:
        # at frame scale, at least 8 resident warps per SM and no merge
        assert warps / sms >= 8 and got == 1


@pytest.mark.parametrize("m", [1, 127, 128, 129, 1000, 8192, 8193, 65536,
                               70001])
@pytest.mark.parametrize("n", [1, 333, 8192, 65536])
@pytest.mark.parametrize("sms", [132, 114])
def test_group_chunks_cover_every_group_once(m, n, sms):
    gpc = tkk._choose_group_chunk(n, m, sms)
    ng = -(-m // tkk.GROUP)
    assert 1 <= gpc <= ng
    lo, hi = tkk.group_chunks(m, gpc)
    assert int(lo[0]) == 0 and int(hi[-1]) == ng
    assert torch.equal(lo[1:], hi[:-1])        # consecutive, no overlap
    assert bool((hi > lo).all())               # no empty chunk
    assert bool((hi - lo <= gpc).all())
    cover = torch.zeros(ng, dtype=torch.int64)
    for a, b in zip(lo.tolist(), hi.tolist()):
        cover[a:b] += 1
    assert bool((cover == 1).all())
    if (n, m, sms) == (8192, 8192, 132):       # (d): about 1,000 CTAs
        assert -(-n // tkk.K3_QUERIES_PER_CTA) * len(lo) >= 1000
    if (n, m, sms) == (65536, 65536, 132):     # (f): as many as before
        assert -(-n // tkk.K3_QUERIES_PER_CTA) * len(lo) >= 512


@pytest.mark.parametrize("m", [1, 200, 1000, 2500])
@pytest.mark.parametrize("gpc", [1, 3, 64])
def test_group_min_chunked_equals_plain(m, gpc):
    rng = np.random.default_rng(m + gpc)
    q = T(rng.uniform(-2, 2, (45, 3)).astype(np.float32))
    t = T(rng.uniform(-2, 2, (m, 3)).astype(np.float32))
    valid = T(rng.uniform(size=m) >= 0.3)
    pen = tkk._penalty(m, valid, torch.device("cpu"))
    want = tkk.group_min_plain(q, t, pen)
    got = tkk.group_min_chunked_plain(q, t, pen, gpc)
    assert got.shape == want.shape == (-(-m // tkk.GROUP), 45)
    assert torch.equal(_bits(got), _bits(want))
