"""The port's native host runtime (``dcreg_tpu_torch/io/native.py``):
tests/test_native.py's checks on the port's loader, bit-for-bit agreement
with the JAX package's library on the same inputs, ``load_pcd``'s native
path, and a build that writes nothing under ``native/``."""
import os
import pathlib

import numpy as np
import pytest
import torch

from dcreg_tpu.io import native as jnative
from dcreg_tpu_torch import cuda_build
from dcreg_tpu_torch.io import native
from dcreg_tpu_torch.io.pcd import load_pcd, save_pcd
from dcreg_tpu_torch.ops import knn_kernels

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"


@pytest.fixture(autouse=True)
def _library():
    if not native.available():
        pytest.skip("native toolchain unavailable")


def _cloud(n, seed, lo=-10.0, hi=10.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def test_library_lives_in_the_port_build_dir():
    lib = pathlib.Path(native.build()["path"])
    assert lib.parent.parent == cuda_build.BUILD_DIR
    assert lib.name == "libdcreg_native.so"


def test_pcd_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(1234, 3)).astype(np.float32)
    inten = rng.uniform(size=1234).astype(np.float32)
    p = tmp_path / "a.pcd"
    native.pcd_write_native(p, xyz, inten, binary=True)
    d = native.pcd_read_native(p)
    np.testing.assert_array_equal(d["xyz"], xyz)
    np.testing.assert_array_equal(d["intensity"], inten)
    p2 = tmp_path / "b.pcd"
    native.pcd_write_native(p2, xyz[:100], binary=False)
    d2 = native.pcd_read_native(p2)
    np.testing.assert_allclose(d2["xyz"], xyz[:100], rtol=1e-5)
    assert "intensity" not in d2


def test_pcd_native_matches_python_loader(tmp_path):
    """The C++ and the numpy reader give the same arrays, binary and
    ascii, on files the port's writer made."""
    rng = np.random.default_rng(1)
    xyz = _cloud(500, 1)
    inten = rng.uniform(size=500).astype(np.float32)
    for binary in (True, False):
        p = tmp_path / f"c{int(binary)}.pcd"
        save_pcd(str(p), xyz, intensity=inten, binary=binary)
        a = native.pcd_read_native(p)
        b = load_pcd(p, prefer_native=False)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k], np.float32))


def test_load_pcd_prefers_native(tmp_path, monkeypatch):
    p = tmp_path / "d.pcd"
    native.pcd_write_native(p, _cloud(300, 2))
    a, b = load_pcd(p, prefer_native=True), load_pcd(p, prefer_native=False)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    calls = []
    real = native.pcd_read_native
    monkeypatch.setattr(native, "pcd_read_native",
                        lambda path: calls.append(path) or real(path))
    load_pcd(p)
    load_pcd(p, prefer_native=False)
    assert calls == [p]


def test_kdtree_exact_vs_bruteforce():
    pts = _cloud(3000, 1)
    q = _cloud(200, 11)
    d2, idx = native.KDTree(pts).knn(q, k=5)
    diff = q[:, None, :] - pts[None, :, :]
    bf = np.sum(diff * diff, axis=-1)
    bf_idx = np.argsort(bf, axis=1, kind="stable")[:, :5]
    bf_d2 = np.take_along_axis(bf, bf_idx, axis=1)
    np.testing.assert_allclose(d2, bf_d2, rtol=1e-5)
    assert (idx == bf_idx).mean() > 0.99     # ids differ only at ties


def test_kdtree_validates_device_knn():
    """The KD-tree is the exact oracle of the port's f32 k-NN (K2's plain
    twin here): the same ids but at exact ties, distances within 1 ulp
    (both sum ((dx^2) + dy^2) + dz^2 in f32)."""
    rng = np.random.default_rng(2)
    pts = _cloud(5000, 2, -40.0, 40.0)
    q = pts[:300] + rng.normal(0, 0.01, (300, 3)).astype(np.float32)
    d2_t, idx_t = native.KDTree(pts).knn(q, k=5)
    d2_x, idx_x = knn_kernels.knn(torch.from_numpy(q), torch.from_numpy(pts),
                                  k=5, kk=8)
    ulp = np.abs(d2_x.numpy().view(np.int32).astype(np.int64)
                 - d2_t.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
    tied = np.any(np.diff(d2_t, axis=1) == 0, axis=1)
    same = np.all(idx_x.numpy() == idx_t, axis=1)
    assert np.all(same | tied)


def test_voxel_downsample():
    xyz = _cloud(20000, 3, 0.0, 10.0)
    out = native.voxel_downsample_native(xyz, 1.0)
    assert 500 < out.shape[0] < 2000       # ~1000 occupied unit voxels
    assert out.min() >= -0.01 and out.max() <= 10.01


def test_bit_equal_to_the_jax_library():
    """Same source, same flags: the two packages' libraries answer alike
    bit for bit."""
    if not jnative.available():
        pytest.skip("the JAX package's native library did not build")
    pts = _cloud(4000, 4)
    q = _cloud(500, 5)
    for a, b in zip(native.KDTree(pts).knn(q, k=7),
                    jnative.KDTree(pts).knn(q, k=7)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for voxel in (0.5, 2.0):
        a = native.voxel_downsample_native(pts, voxel)
        b = jnative.voxel_downsample_native(pts, voxel)
        assert a.tobytes() == b.tobytes()


def test_build_writes_nothing_under_native(tmp_path):
    """A fresh build of the port's library (into a scratch build dir)
    leaves native/ as it was: same names, sizes and mtimes."""
    jnative.get_lib()          # the JAX package builds its own first

    def listing():
        return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                      for p in NATIVE_DIR.iterdir())

    before = listing()
    out = cuda_build.build_host_library(native.SOURCE, "dcreg_native",
                                        build_dir=tmp_path)
    assert out["seconds"] > 0 and pathlib.Path(out["path"]).is_file()
    assert pathlib.Path(out["path"]).is_relative_to(tmp_path)
    assert listing() == before
    assert os.path.samefile(native.SOURCE, NATIVE_DIR / "dcreg_native.cpp")
