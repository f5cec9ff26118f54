"""ctypes bindings to the native host runtime ``native/dcreg_native.cpp``
(counterpart of ``dcreg_tpu/io/native.py``).

The C++ tier of the host side -- what the reference does with PCL/FLANN
C++: PCD I/O, an exact KD-tree k-NN and voxel downsampling.  The source
is the JAX package's; the port compiles it with g++ on first use into
``dcreg_tpu_torch/_build/<source hash>/libdcreg_native.so``
(``cuda_build.build_host_library``, the flags of ``native/Makefile``) and
writes nothing under ``native/``.  ``get_lib`` returns None where the
build fails, so ``io/pcd.load_pcd`` keeps its numpy reader.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..cuda_build import build_host_library

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dcreg_native.cpp"

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def build() -> dict:
    """Compile the runtime unless its library exists: {"path", "seconds",
    "log"}; raises when the source or g++ is missing or the build fails."""
    return build_host_library(SOURCE, "dcreg_native")


def _load(path):
    lib = ctypes.CDLL(path)
    lib.pcd_read.restype = ctypes.c_void_p
    lib.pcd_read.argtypes = [ctypes.c_char_p]
    lib.pcd_num_points.restype = ctypes.c_int64
    lib.pcd_num_points.argtypes = [ctypes.c_void_p]
    lib.pcd_has_intensity.restype = ctypes.c_int
    lib.pcd_has_intensity.argtypes = [ctypes.c_void_p]
    lib.pcd_copy_xyz.restype = None
    lib.pcd_copy_xyz.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pcd_copy_intensity.restype = None
    lib.pcd_copy_intensity.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.pcd_free.restype = None
    lib.pcd_free.argtypes = [ctypes.c_void_p]
    lib.pcd_write.restype = ctypes.c_int
    lib.pcd_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.kdtree_free.restype = None
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_knn.restype = None
    lib.kdtree_knn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.voxel_downsample.restype = ctypes.c_int64
    lib.voxel_downsample.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_float, ctypes.c_void_p]
    lib.dcreg_last_error.restype = ctypes.c_char_p
    lib.dcreg_last_error.argtypes = []
    return lib


def get_lib():
    """The loaded library, built on the first call; None if it cannot be
    built or loaded."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _load(build()["path"])
            except (OSError, RuntimeError):
                _LIB = None
        return _LIB


def available() -> bool:
    return get_lib() is not None


def _require():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def pcd_read_native(path):
    """Parse a PCD with the C++ reader -> dict(xyz (N, 3) f32,
    intensity?).  Raises RuntimeError (with the C++ error string) on a
    malformed file."""
    lib = _require()
    h = lib.pcd_read(str(path).encode())
    if not h:
        raise RuntimeError(f"pcd_read failed: "
                           f"{lib.dcreg_last_error().decode()}")
    try:
        n = lib.pcd_num_points(h)
        xyz = np.empty((n, 3), np.float32)
        lib.pcd_copy_xyz(h, xyz.ctypes.data_as(ctypes.c_void_p))
        out = {"xyz": xyz}
        if lib.pcd_has_intensity(h):
            inten = np.empty(n, np.float32)
            lib.pcd_copy_intensity(h, inten.ctypes.data_as(ctypes.c_void_p))
            out["intensity"] = inten
        return out
    finally:
        lib.pcd_free(h)


def pcd_write_native(path, xyz, intensity=None, binary=True):
    """Write x y z [intensity] float32 as a binary or ascii PCD."""
    lib = _require()
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32))
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"xyz must be (N, 3), got {xyz.shape}")
    ip = None
    if intensity is not None:
        intensity = np.ascontiguousarray(np.asarray(intensity, np.float32))
        if intensity.shape != (xyz.shape[0],):
            raise ValueError("intensity must be (N,)")
        ip = intensity.ctypes.data_as(ctypes.c_void_p)
    rc = lib.pcd_write(str(path).encode(),
                       xyz.ctypes.data_as(ctypes.c_void_p), ip,
                       xyz.shape[0], 1 if binary else 0)
    if rc != 0:
        raise RuntimeError(f"pcd_write failed: "
                           f"{lib.dcreg_last_error().decode()}")


def _points(a):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {a.shape}")
    return a


class KDTree:
    """Exact host-side KD-tree (the pcl::KdTreeFLANN analogue): the NN
    oracle of the device k-NN and a host-side map tool."""

    def __init__(self, points):
        self._lib = _require()
        self._pts = _points(points)     # the tree reads it: keep it alive
        self._h = self._lib.kdtree_build(
            self._pts.ctypes.data_as(ctypes.c_void_p), self._pts.shape[0])

    def knn(self, queries, k=5):
        """(sq_dists (Q, k) f32 ascending, ids (Q, k) int32); missing
        neighbours are 1e38 and -1."""
        q = _points(queries)
        nq = q.shape[0]
        idx = np.empty((nq, k), np.int32)
        d2 = np.empty((nq, k), np.float32)
        self._lib.kdtree_knn(self._h, q.ctypes.data_as(ctypes.c_void_p),
                             nq, k, idx.ctypes.data_as(ctypes.c_void_p),
                             d2.ctypes.data_as(ctypes.c_void_p))
        return d2, idx

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.kdtree_free(self._h)
            self._h = None


def voxel_downsample_native(xyz, voxel_size):
    """Centroid-per-voxel downsampling (map preparation).  Voxels are
    keyed by a hash of their integer coordinates, so two voxels whose
    keys collide merge into one centroid."""
    lib = _require()
    xyz = _points(xyz)
    out = np.empty_like(xyz)
    m = lib.voxel_downsample(xyz.ctypes.data_as(ctypes.c_void_p),
                             xyz.shape[0], ctypes.c_float(voxel_size),
                             out.ctypes.data_as(ctypes.c_void_p))
    return out[:m].copy()
