"""Port parity: K2's wide candidate lists, 17 <= kk <= 128 (one to four
list slots per lane on the card), against ``pallas_knn.knn`` in
interpret mode, and K2's split and merge at kk > 32.

Stated tolerances:
- ``knn_kernels.knn`` (the plain twin on the CPU) vs
  ``pallas_knn.knn(interpret=True)``: identical neighbour ids, in order;
  distances equal or within 2 ulp (XLA's CPU fusion of the exact
  re-rank's sum of squares).
- f32 ``knn.knn(q, q, k=30, refine=60)``, the O3D normal search, vs
  ``pallas_knn.knn(kk=60)``: identical ids.
- split-then-merge of the plain twin vs the unsplit twin: bit for bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from chip_smoke import synthetic_cylinder
from dcreg_tpu.ops import pallas_knn
from dcreg_tpu_torch.ops import knn as tknn
from dcreg_tpu_torch.ops import knn_kernels as tkk

T = torch.from_numpy


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _clouds(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-5, 5, (n, 3)).astype(np.float32),
            rng.uniform(-5, 5, (m, 3)).astype(np.float32))


@pytest.mark.parametrize("kk", [17, 33, 60, 64, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_k2_wide_twin_matches_pallas(kk, masked):
    q, t = _clouds(150, 700, seed=kk)
    valid = np.random.default_rng(kk + 1).uniform(size=700) > 0.3 \
        if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else T(valid)
    k = kk - 3
    d1, i1 = pallas_knn.knn(jnp.asarray(q), jnp.asarray(t), jv, k=k, kk=kk,
                            tq=64, tt=256, interpret=True)
    d2, i2 = tknn.knn(T(q), T(t), tv, k=k, refine=kk)
    assert np.array_equal(i2.numpy(), np.asarray(i1))
    fin = np.isfinite(np.asarray(d1))
    assert np.array_equal(np.isfinite(d2.numpy()), fin)
    assert _ulps(d2.numpy()[fin], np.asarray(d1)[fin]).max(initial=0) <= 2
    if masked:
        assert bool(valid[i2.numpy()].all())


def test_o3d_normal_search_ids():
    """The O3D engine's normal search: the self query at k 30, refine 60."""
    pts = synthetic_cylinder(21, 600)
    _, i1 = pallas_knn.knn(jnp.asarray(pts), jnp.asarray(pts), k=30, kk=60,
                           tq=64, tt=256, interpret=True)
    _, i2 = tknn.knn(T(pts), T(pts), k=30, refine=60)
    assert np.array_equal(i2.numpy(), np.asarray(i1))


@pytest.mark.parametrize("kk", [33, 60, 64, 100, 128])
@pytest.mark.parametrize("nslices", [2, 8])
def test_wide_sliced_then_merged_equals_plain(kk, nslices):
    """K2's split at two and four list slots: each slice's kk best, merged,
    are the unsplit twin's bits; 30% of the targets invalid, and fewer
    valid targets in a slice than kk."""
    rng = np.random.default_rng(kk * 10 + nslices)
    q = T(rng.uniform(-3, 3, (40, 3)).astype(np.float32))
    t = T(rng.uniform(-3, 3, (1500, 3)).astype(np.float32))
    pen = tkk._penalty(1500, T(rng.uniform(size=1500) > 0.3),
                       torch.device("cpu"))
    want_v, want_i = tkk.knn_candidates_plain(q, t, pen, kk)
    sv, si = tkk.knn_candidates_sliced_plain(q, t, pen, kk, nslices)
    got_v, got_i = tkk.merge_candidate_keys(sv, si, kk)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("kk,slots", [(1, 1), (32, 1), (33, 2), (64, 2),
                                      (65, 4), (128, 4)])
def test_list_slots(kk, slots):
    assert tkk.list_slots(kk) == slots


def test_kk_above_128_raises_everywhere():
    q, t = _clouds(5, 200, seed=3)
    pen = torch.zeros(200)
    val, idx = tkk.knn_candidates(T(q), T(t), pen, 128)
    assert val.shape == idx.shape == (5, 128)
    for fn in (lambda: tkk.knn_candidates(T(q), T(t), pen, 129),
               lambda: tkk.knn_candidates_plain(T(q), T(t), pen, 129),
               lambda: tkk.knn_candidates_sliced_plain(T(q), T(t), pen, 129,
                                                       2),
               lambda: tkk.merge_candidate_keys(val[None], idx[None], 129),
               lambda: tkk.list_slots(0)):
        with pytest.raises(ValueError, match="1..128"):
            fn()
