"""Minimal PCD (Point Cloud Data) reader/writer (counterpart of
``dcreg_tpu/io/pcd.py``, numpy only).

Supports the subsets the DCReg artifacts use: binary and ascii, fields
x y z [intensity | rgb], float32.  Host-side IO feeding device tensors.
"""
from __future__ import annotations

import io

import numpy as np

_TYPE_MAP = {("F", 4): "<f4", ("F", 8): "<f8",
             ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4",
             ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4"}


def load_pcd(path):
    """Load a PCD file -> dict with 'xyz' (N, 3) float32 plus any extra
    fields by name."""
    with open(path, "rb") as f:
        raw = f.read()
    # parse header line by line
    header = {}
    offset = 0
    stream = io.BytesIO(raw)
    while True:
        line = stream.readline()
        offset += len(line)
        text = line.decode("ascii", errors="replace").strip()
        if text.startswith("#") or not text:
            continue
        key, _, value = text.partition(" ")
        header[key] = value
        if key == "DATA":
            break
    fields = header["FIELDS"].split()
    sizes = [int(s) for s in header["SIZE"].split()]
    types = header["TYPE"].split()
    counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
    n_points = int(header["POINTS"])
    dtype = np.dtype([
        (name, _TYPE_MAP[(t, s)] if count == 1 else (_TYPE_MAP[(t, s)], count))
        for name, s, t, count in zip(fields, sizes, types, counts)
    ])
    mode = header["DATA"]
    if mode == "binary":
        data = np.frombuffer(raw, dtype=dtype, count=n_points, offset=offset)
    elif mode == "ascii":
        text = raw[offset:].decode("ascii")
        rows = np.loadtxt(io.StringIO(text), dtype=np.float64, ndmin=2)
        data = np.zeros(n_points, dtype=dtype)
        col = 0
        for name, count in zip(fields, counts):
            if count == 1:
                data[name] = rows[:n_points, col].astype(dtype[name])
                col += 1
            else:
                data[name] = rows[:n_points, col:col + count].astype(dtype[name].base)
                col += count
    else:
        raise ValueError(f"Unsupported PCD DATA mode: {mode}")
    out = {"xyz": np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float32)}
    for name in fields:
        if name not in ("x", "y", "z"):
            out[name] = np.asarray(data[name])
    return out


def save_pcd(path, xyz, intensity=None, rgb=None, binary=True):
    """Write a PCD v0.7 file with x y z [intensity] or x y z [rgb]."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    if rgb is not None:
        fields, sizes, types = "x y z rgb", "4 4 4 4", "F F F U"
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<u4")])
        rgb = np.asarray(rgb)
        packed = (rgb[:, 0].astype(np.uint32) << 16 | rgb[:, 1].astype(np.uint32) << 8
                  | rgb[:, 2].astype(np.uint32))
        rec["rgb"] = packed
    elif intensity is not None:
        fields, sizes, types = "x y z intensity", "4 4 4 4", "F F F F"
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4")])
        rec["intensity"] = np.asarray(intensity, dtype=np.float32)
    else:
        fields, sizes, types = "x y z", "4 4 4", "F F F"
        rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    counts = " ".join(["1"] * len(fields.split()))
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {fields}\nSIZE {sizes}\nTYPE {types}\nCOUNT {counts}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(str(v) for v in row) + "\n").encode("ascii"))


def jet_color(error, max_threshold):
    """Jet colormap for error clouds (utils.hpp:592-627): blue -> cyan ->
    green -> yellow -> red over [0, max_threshold]."""
    t = np.minimum(np.asarray(error, dtype=np.float64) / max_threshold, 1.0)
    r = np.zeros_like(t)
    g = np.zeros_like(t)
    b = np.zeros_like(t)
    seg0 = t < 0.25
    seg1 = (t >= 0.25) & (t < 0.5)
    seg2 = (t >= 0.5) & (t < 0.75)
    seg3 = t >= 0.75
    g = np.where(seg0, t / 0.25, g)
    b = np.where(seg0, 1.0, b)
    g = np.where(seg1, 1.0, g)
    b = np.where(seg1, 1.0 - (t - 0.25) / 0.25, b)
    r = np.where(seg2, (t - 0.5) / 0.25, r)
    g = np.where(seg2, 1.0, g)
    r = np.where(seg3, 1.0, r)
    g = np.where(seg3, 1.0 - (t - 0.75) / 0.25, g)
    return np.stack([(255 * r), (255 * g), (255 * b)], axis=-1).astype(np.uint8)
