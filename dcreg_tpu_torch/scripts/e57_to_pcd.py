"""E57 -> PCD dataset converter (counterpart of ``scripts/e57_to_pcd.py``):
reads every scan's cartesian points from an E57 file, optionally
voxel-downsamples them (the first point of each voxel) and writes a
binary PCD for the registration pipeline.

Usage:
    python -m dcreg_tpu_torch.scripts.e57_to_pcd input.e57 output.pcd
        [--voxel 0.05]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..io.e57 import read_e57
from ..io.pcd import save_pcd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--voxel", type=float, default=0.0,
                    help="voxel downsample size in meters (0 = off)")
    args = ap.parse_args(argv)

    data = read_e57(args.input)
    xyz = np.asarray(data["xyz"], np.float64)
    print(f"read {xyz.shape[0]} points from {args.input}")
    if args.voxel > 0:
        keys = np.floor(xyz / args.voxel).astype(np.int64)
        _, keep = np.unique(keys, axis=0, return_index=True)
        xyz = xyz[np.sort(keep)]
        print(f"voxel({args.voxel} m) -> {xyz.shape[0]} points")
    save_pcd(args.output, xyz)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
