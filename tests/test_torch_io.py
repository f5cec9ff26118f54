"""Port parity: the TUM trajectory I/O and scores (``io/tum.py``) and the
E57 reader/writer (``io/e57.py``) against dcreg_tpu.

Stated tolerances: TUM files byte-identical; ``load_tum`` equal;
``ate``, ``rpe``, ``registration_recall`` and ``map_accuracy`` within
1e-12; E57 files byte-identical for the same inputs, each package reads
the other's file exactly, ``crc32c`` on the RFC 3720 vectors.
"""
import numpy as np
import pytest
from torch_threads import one_intra_op_thread  # noqa: F401
import torch

from dcreg_tpu.io import e57 as je57
from dcreg_tpu.io import tum as jtum
from dcreg_tpu_torch.io import e57 as te57
from dcreg_tpu_torch.io import tum as ttum
from dcreg_tpu_torch.ops import se3 as tse3


def _trajectories(F=30, seed=4):
    """A ground-truth path and an estimate drifting off it, (F, 4, 4)."""
    rng = np.random.default_rng(seed)
    gt, est = [], []
    T = np.eye(4)
    for _ in range(F):
        gt.append(T.copy())
        step = tse3.pose6d_to_matrix(torch.as_tensor(
            np.r_[rng.normal(0, 0.05, 3), rng.normal(0.5, 0.1, 3)])).numpy()
        T = T @ step
    for k, G in enumerate(gt):
        E = tse3.pose6d_to_matrix(torch.as_tensor(
            np.r_[rng.normal(0, 0.01, 3), rng.normal(0, 0.03 * (1 + k / 10),
                                                      3)])).numpy()
        est.append(G @ E)
    return np.arange(F) * 0.1 + 1e9, np.asarray(gt), np.asarray(est)


def test_save_tum_byte_identical(tmp_path):
    ts, gt, est = _trajectories()
    for name, poses in (("gt", gt), ("est", est)):
        a, b, c = (tmp_path / f"{name}_{s}.tum" for s in "jtc")
        jtum.save_tum(a, ts, poses)
        ttum.save_tum(b, ts, poses)
        ttum.save_tum(c, torch.as_tensor(ts), torch.as_tensor(poses))
        assert a.read_bytes() == b.read_bytes() == c.read_bytes()
        tj, pj = jtum.load_tum(a)
        tt, pt = ttum.load_tum(b)
        assert np.array_equal(tj, tt) and np.array_equal(pj, pt)
        np.testing.assert_allclose(pt, poses, atol=1e-6)


def test_trajectory_scores_match():
    _, gt, est = _trajectories()
    for align in (True, False):
        a, b = jtum.ate(est, gt, align=align), ttum.ate(
            torch.as_tensor(est), gt, align=align)
        for k in ("rmse", "mean", "median", "max"):
            assert abs(a[k] - b[k]) <= 1e-12, (align, k)
        np.testing.assert_allclose(b["errors"], a["errors"], rtol=0,
                                   atol=1e-12)
    for delta in (1, 3):
        for x, y in zip(jtum.rpe(est, gt, delta), ttum.rpe(est, gt, delta)):
            np.testing.assert_allclose(y, x, rtol=0, atol=1e-12)
    ra, oka = jtum.registration_recall(est, gt, rte_thresh_m=0.1)
    rb, okb = ttum.registration_recall(torch.as_tensor(est), gt,
                                       rte_thresh_m=0.1)
    assert 0.0 < ra < 1.0 and ra == rb and np.array_equal(oka, okb)


def test_map_accuracy_matches():
    rng = np.random.default_rng(9)
    _, gt, est = _trajectories(F=5)
    world = rng.uniform(-5, 20, (4000, 3))
    scans = [(world[rng.choice(4000, 300, replace=False)] - T[:3, 3])
             @ T[:3, :3] for T in gt]
    kw = dict(max_dist=0.5, sample=1000, seed=3)
    a = jtum.map_accuracy(scans, est, world, **kw)
    b = ttum.map_accuracy([torch.as_tensor(s) for s in scans],
                          torch.as_tensor(est), torch.as_tensor(world), **kw)
    assert a["points"] == b["points"] == 1000
    for k in ("ac_mean", "ac_rmse", "ac_median", "inlier_frac"):
        assert abs(a[k] - b[k]) <= 1e-12, k


# --------------------------------------------------------------------------
# E57
# --------------------------------------------------------------------------

def test_crc32c_rfc3720_vectors():
    for data, want in ((b"", 0x0), (b"123456789", 0xE3069283),
                       (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43)):
        assert te57.crc32c(data) == want == je57.crc32c(data)


@pytest.mark.parametrize("intensity", [False, True])
def test_e57_bytes_and_cross_read(tmp_path, intensity):
    rng = np.random.default_rng(23)
    xyz = rng.normal(0, 10, (5003, 3))
    inten = rng.uniform(0, 1, 5003) if intensity else None
    pj, pt = str(tmp_path / "j.e57"), str(tmp_path / "t.e57")
    je57.write_e57(pj, xyz, intensity=inten)
    te57.write_e57(pt, xyz, intensity=inten)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for path, reader in ((pj, te57._read_numpy), (pt, je57._read_numpy),
                         (pt, te57.read_e57)):
        out = reader(path)
        assert np.array_equal(out["xyz"], xyz)
        if intensity:
            assert np.array_equal(out["intensity"], inten)


def test_e57_checksum_detection(tmp_path):
    path = str(tmp_path / "c.e57")
    te57.write_e57(path, np.random.default_rng(1).normal(0, 1, (100, 3)))
    raw = bytearray(open(path, "rb").read())
    assert len(raw) % te57.PAGE == 0
    raw[te57.PAGE + 7] ^= 0xFF
    bad = str(tmp_path / "bad.e57")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        te57._read_numpy(bad)
