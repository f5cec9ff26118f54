"""Port parity: the brute-force k-NN kernels K2/K3 and the other k-NN
backends against dcreg_tpu on the same inputs (CPU: the port's plain
twins, the JAX kernels in interpret mode).

Stated tolerances:
- K2 twin (``knn_kernels.knn``) vs ``pallas_knn.knn(interpret=True)``:
  identical index sets; distances equal or within 2 ulp, the most XLA's
  CPU fusion (a fused multiply-add in the exact re-rank) moves them.
- K3 (``knn_grouped``) vs JAX's ``knn_grouped(interpret=True)`` and vs the
  port's own ``knn``: identical neighbour sets (and, port vs port,
  identical distances).
- f64 ``knn``/``nn1`` vs ``dcreg_tpu.ops.knn``: identical indices,
  distances within rtol 1e-12.
- ``grid_knn``, ``block_knn``, ``_extract_k_smallest``, ``_topk_min``:
  identical indices; distances within 2 ulp in f32, rtol 1e-12 in f64.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.ops import knn as jknn
from dcreg_tpu.ops import pallas_knn
from dcreg_tpu.ops import block_sparse as jbs
from dcreg_tpu.ops import voxel_grid as jvg
from dcreg_tpu_torch import convert
from dcreg_tpu_torch.ops import block_sparse as tbs
from dcreg_tpu_torch.ops import knn as tknn
from dcreg_tpu_torch.ops import knn_kernels as tkk
from dcreg_tpu_torch.ops import voxel_grid as tvg


def _clouds(n, m, seed=0, scale=40.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (n, 3)).astype(np.float32),
            rng.uniform(-scale, scale, (m, 3)).astype(np.float32))


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _assert_f32_dists(ours, ref):
    assert np.array_equal(np.isinf(ours), np.isinf(ref))
    fin = np.isfinite(ref)
    assert _ulps(ours[fin], ref[fin]).max(initial=0) <= 2


T = torch.from_numpy


@pytest.mark.parametrize("n,m,k", [(777, 2500, 5), (64, 100, 1),
                                   (1000, 5000, 5), (33, 4096, 3)])
def test_k2_twin_matches_pallas(n, m, k):
    q, t = _clouds(n, m)
    d1, i1 = pallas_knn.knn(jnp.asarray(q), jnp.asarray(t), k=k,
                            kk=max(k + 3, 8), tq=64, tt=256, interpret=True)
    d2, i2 = tknn.knn(T(q), T(t), k=k, refine=2 * k)
    assert np.array_equal(np.sort(np.asarray(i1), -1),
                          np.sort(i2.numpy(), -1))
    _assert_f32_dists(d2.numpy(), np.asarray(d1))


def test_k2_valid_mask():
    q, t = _clouds(300, 1500, seed=3)
    valid = np.random.default_rng(4).uniform(size=1500) > 0.3
    d1, i1 = pallas_knn.knn(jnp.asarray(q), jnp.asarray(t),
                            jnp.asarray(valid), k=5, kk=10, tq=64, tt=256,
                            interpret=True)
    d2, i2 = tknn.knn(T(q), T(t), T(valid), k=5, refine=10)
    assert np.array_equal(np.sort(np.asarray(i1), -1),
                          np.sort(i2.numpy(), -1))
    assert bool(valid[i2.numpy()].all())
    _assert_f32_dists(d2.numpy(), np.asarray(d1))


def test_k2_self_query_finds_self():
    # source == target (the cylinder benchmark setup): NN1 is self, d = 0
    _, t = _clouds(0, 900, seed=7)
    d1, i1 = pallas_knn.knn(jnp.asarray(t), jnp.asarray(t), k=5, tq=64,
                            tt=256, interpret=True)
    d, i = tkk.knn(T(t), T(t), k=5)
    assert np.array_equal(i[:, 0].numpy(), np.arange(900))
    assert bool((d[:, 0] == 0.0).all())
    assert np.array_equal(np.sort(np.asarray(i1), -1), np.sort(i.numpy(), -1))
    _assert_f32_dists(d.numpy(), np.asarray(d1))


def test_k2_duplicate_points_ties():
    rng = np.random.default_rng(11)
    base = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    t = np.concatenate([base, base[:50]])            # 50 exact duplicates
    q = base[:80]
    d1, _ = pallas_knn.knn(jnp.asarray(q), jnp.asarray(t), k=5, tq=64,
                           tt=256, interpret=True)
    d2, i2 = tkk.knn(T(q), T(t), k=5)
    _assert_f32_dists(np.sort(d2.numpy(), -1), np.sort(np.asarray(d1), -1))
    # equal distances come lower index first
    dd, ii = d2.numpy(), i2.numpy()
    tie = dd[:, 1:] == dd[:, :-1]
    assert bool((ii[:, 1:][tie] > ii[:, :-1][tie]).all())


def test_k2_candidates_layout_and_empty_slots():
    """Fewer targets than kk: the missing slots are (BIG, -1) and rank as
    inf after the re-rank."""
    q, t = _clouds(10, 4, seed=2)
    pen = torch.zeros(4)
    val, idx = tkk.knn_candidates(T(q), T(t), pen, 6)
    assert val.shape == (10, 6) and idx.dtype == torch.int32
    assert bool((idx[:, 4:] == -1).all()) and bool((val[:, 4:] == tkk.BIG)
                                                   .all())
    assert bool((val[:, 1:] >= val[:, :-1]).all())
    d, _ = tkk.knn(T(q), T(t), k=6, kk=6)
    assert bool(torch.isinf(d[:, 4:]).all())
    with pytest.raises(ValueError, match="kk"):
        tkk.knn_candidates(T(q), T(t), pen, 129)
    with pytest.raises(TypeError):
        tkk.knn_candidates(T(q).double(), T(t), pen, 5)


@pytest.mark.parametrize("n,m,k,masked", [(777, 2500, 5, False),
                                          (33, 4096, 3, True)])
def test_k3_knn_grouped(n, m, k, masked):
    q, t = _clouds(n, m, seed=5)
    valid = np.random.default_rng(6).uniform(size=m) > 0.3 if masked \
        else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else T(valid)
    d1, i1 = pallas_knn.knn_grouped(jnp.asarray(q), jnp.asarray(t), jv, k=k,
                                    groups=8, tq=64, tt=256, interpret=True)
    d2, i2 = tkk.knn_grouped(T(q), T(t), tv, k=k, groups=8)
    assert np.array_equal(np.sort(np.asarray(i1), -1),
                          np.sort(i2.numpy(), -1))
    _assert_f32_dists(d2.numpy(), np.asarray(d1))
    d3, i3 = tkk.knn(T(q), T(t), tv, k=k, kk=k + 3)
    assert torch.equal(i2, i3) and torch.equal(d2, d3)


def test_k3_group_min_twin():
    """Group minima against a direct numpy reduction of the same
    coordinate-wise distances; the last, partial group is padded BIG."""
    q, t = _clouds(50, 300, seed=8)
    valid = np.random.default_rng(9).uniform(size=300) > 0.5
    pen = tkk._penalty(300, T(valid), torch.device("cpu"))
    g = tkk.group_min(T(q), T(t), pen).numpy()
    assert g.shape == (3, 50)
    d = np.zeros((50, 300), np.float32) + np.where(valid, 0.0, 3.0e38
                                                   ).astype(np.float32)
    for c in range(3):
        diff = q[:, c, None] - t[None, :, c]
        d = d + diff * diff
    d = np.minimum(d, np.float32(3.0e38))
    d = np.concatenate([d, np.full((50, 84), np.float32(3.0e38))], 1)
    assert np.array_equal(g, d.reshape(50, 3, 128).min(-1).T)


@pytest.mark.parametrize("masked", [False, True])
def test_f64_knn_and_nn1(masked):
    rng = np.random.default_rng(12)
    q = rng.uniform(-5, 5, (300, 3))
    t = rng.uniform(-5, 5, (900, 3))
    valid = rng.uniform(size=900) > 0.3 if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else T(valid)
    d1, i1 = jknn.knn(jnp.asarray(q), jnp.asarray(t), jv, k=5, chunk=128)
    d2, i2 = tknn.knn(T(q), T(t), tv, k=5, chunk=128)
    assert np.array_equal(np.asarray(i1), i2.numpy())
    np.testing.assert_allclose(d2.numpy(), np.asarray(d1), rtol=1e-12)
    n1, j1 = jknn.nn1(jnp.asarray(q), jnp.asarray(t), jv, chunk=100)
    n2, j2 = tknn.nn1(T(q), T(t), tv, chunk=100)
    assert np.array_equal(np.asarray(j1), j2.numpy())
    np.testing.assert_allclose(n2.numpy(), np.asarray(n1), rtol=1e-12)


def test_extract_and_topk_min_match():
    rng = np.random.default_rng(13)
    d = rng.uniform(0, 10, (40, 300)).astype(np.float32)
    d[:, ::7] = np.inf
    d[:, 5] = d[:, 6]                                   # exact ties
    idx = rng.permutation(300 * 40).reshape(40, 300).astype(np.int32)
    v1, i1 = pallas_knn._extract_k_smallest(jnp.asarray(d), jnp.asarray(idx),
                                            8)
    v2, i2 = tkk._extract_k_smallest(T(d), T(idx), 8)
    assert np.array_equal(np.asarray(v1), v2.numpy())
    assert np.array_equal(np.asarray(i1), i2.numpy())
    d64 = rng.uniform(0, 10, (40, 300))
    d64[:, 3] = d64[:, 200]
    v1, i1 = jknn._topk_min(jnp.asarray(d64), 6)
    v2, i2 = tknn._topk_min(T(d64), 6)
    assert np.array_equal(np.asarray(i1), i2.numpy())
    assert np.array_equal(np.asarray(v1), v2.numpy())


def _scene(n=1500, seed=14):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-5, 5, (n // 2, 2))
    b = rng.uniform(-5, 5, (n - n // 2, 2))
    return np.concatenate([
        np.column_stack([a, 0.02 * rng.normal(size=n // 2)]),
        np.column_stack([b[:, 0], 0.02 * rng.normal(size=n - n // 2) + 2.0,
                         b[:, 1]])])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grid_index_and_grid_knn(dtype):
    pts = _scene().astype(dtype)
    valid = np.random.default_rng(15).uniform(size=len(pts)) > 0.1
    q = pts[::3] + 0.05
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    tdt = getattr(torch, dtype)
    jg = jvg.build_grid_index(pts, 1.0, valid=valid, dtype=jdt)
    tg = tvg.build_grid_index(pts, 1.0, valid=valid, dtype=tdt, device="cpu")
    assert tg.dims == jg.dims and tg.cap == jg.cap
    assert np.array_equal(tg.order.numpy(), np.asarray(jg.order))
    assert np.array_equal(tg.start.numpy(), np.asarray(jg.start))
    d1, i1 = jvg.grid_knn(jg, jnp.asarray(q), k=5)
    d2, i2 = tvg.grid_knn(tg, T(q), k=5)
    d1, i1 = np.asarray(d1), np.asarray(i1)
    fin = np.isfinite(d1)
    assert np.array_equal(fin, np.isfinite(d2.numpy()))
    assert np.array_equal(i1[fin], i2.numpy()[fin])
    if dtype == "float32":
        _assert_f32_dists(d2.numpy(), d1)
    else:
        np.testing.assert_allclose(d2.numpy()[fin], d1[fin], rtol=1e-12)
    # the JAX index, carried over, answers the same
    fields = {f: np.asarray(getattr(jg, f)) for f in
              ("points", "order", "start", "origin")}
    fields.update(dims=jg.dims, voxel_size=jg.voxel_size, cap=jg.cap)
    cg = convert.grid_index_from_arrays(fields, device="cpu")
    d3, i3 = tvg.grid_knn(cg, T(q), k=5)
    assert torch.equal(i3, i2) and torch.equal(d3, d2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_knn(dtype):
    pts = _scene(seed=16)
    spts = pts[jbs.morton_argsort(pts)].astype(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    jb = jbs.build_block_index(spts, dtype=jdt, tb=32)
    tb = tbs.build_block_index(spts, dtype=getattr(torch, dtype), tb=32,
                               device="cpu")
    q = spts + 0.03
    G = jbs.suggest_num_blocks(jb, q, 1.0)
    assert tbs.suggest_num_blocks(tb, q, 1.0) == G
    d1, i1, o1 = jbs.block_knn(jb, jnp.asarray(q), 1.0, k=5, num_blocks=G)
    d2, i2, o2 = tbs.block_knn(tb, T(q), 1.0, k=5, num_blocks=G)
    assert int(o1) == int(o2) == 0
    d1, i1 = np.asarray(d1), np.asarray(i1)
    fin = np.isfinite(d1)
    assert np.array_equal(i1[fin], i2.numpy()[fin])
    if dtype == "float32":
        _assert_f32_dists(d2.numpy(), d1)
    else:
        np.testing.assert_allclose(d2.numpy()[fin], d1[fin], rtol=1e-12)
