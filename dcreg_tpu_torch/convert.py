"""Carry state from the JAX package to the port.

An index built by ``dcreg_tpu`` arrives as a dict of numpy arrays plus its
meta fields (for example ``{f.name: np.asarray(getattr(idx, f.name))}``
over the dataclass fields, with a MapIndex's ``block`` given as such a
dict too) and becomes the port's index on a device.  Parameter
NamedTuples arrive as their ``_asdict()`` (nested NamedTuples or dicts).
A sharded registration's result goes the other way, to numpy, from
either package.  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.icp import ICPParams
from .models.odometry import OdometryParams
from .models.pose_graph import PoseGraphEdges
from .ops.block_sparse import BlockIndex, MapIndex
from .ops.correspondence import CorrespondenceParams
from .ops.degeneracy import DegeneracyThresholds
from .ops.voxel_grid import GridIndex, VoxelGrid
from .utils import resolve_device


def _as_dict(x):
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def block_index_from_arrays(fields, device=None) -> BlockIndex:
    """BlockIndex from {blocks, valid, lo, hi, num_blocks, num_points,
    tb}; float arrays keep their dtype."""
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return BlockIndex(blocks=put(fields["blocks"]),
                      valid=put(fields["valid"]).bool(),
                      lo=put(fields["lo"]), hi=put(fields["hi"]),
                      num_blocks=int(fields["num_blocks"]),
                      num_points=int(fields["num_points"]),
                      tb=int(fields["tb"]))


def map_index_from_arrays(fields, device=None) -> MapIndex:
    """MapIndex from {block: <BlockIndex fields>, sup_lo, sup_hi,
    blk_lo_g, blk_hi_g, sb, num_supers}."""
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return MapIndex(block=block_index_from_arrays(fields["block"], dev),
                    sup_lo=put(fields["sup_lo"]),
                    sup_hi=put(fields["sup_hi"]),
                    blk_lo_g=put(fields["blk_lo_g"]),
                    blk_hi_g=put(fields["blk_hi_g"]),
                    sb=int(fields["sb"]),
                    num_supers=int(fields["num_supers"]))


def correspondence_params(d) -> CorrespondenceParams:
    return CorrespondenceParams(**_as_dict(d))


def degeneracy_thresholds(d) -> DegeneracyThresholds:
    return DegeneracyThresholds(**_as_dict(d))


def icp_params(d) -> ICPParams:
    d = _as_dict(d)
    d["corr"] = correspondence_params(d["corr"])
    d["thresholds"] = degeneracy_thresholds(d["thresholds"])
    return ICPParams(**d)


def odometry_params(d) -> OdometryParams:
    d = _as_dict(d)
    d["corr"] = correspondence_params(d["corr"])
    d["thresholds"] = degeneracy_thresholds(d["thresholds"])
    return OdometryParams(**d)


def grid_index_from_arrays(fields, device=None) -> GridIndex:
    """GridIndex from {points, order, start, origin, dims, voxel_size,
    cap}; the points keep their dtype."""
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return GridIndex(points=put(fields["points"]),
                     order=put(fields["order"]).long(),
                     start=put(fields["start"]).long(),
                     origin=put(fields["origin"]),
                     dims=tuple(int(d) for d in fields["dims"]),
                     voxel_size=float(fields["voxel_size"]),
                     cap=int(fields["cap"]))


def voxel_grid_from_arrays(fields, device=None) -> VoxelGrid:
    """VoxelGrid from {points, sorted_idx, voxel_of_sorted, origin,
    inv_size, dims, valid}; ids become int64, the points keep their
    dtype."""
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return VoxelGrid(points=put(fields["points"]),
                     sorted_idx=put(fields["sorted_idx"]).long(),
                     voxel_of_sorted=put(fields["voxel_of_sorted"]).long(),
                     origin=put(fields["origin"]),
                     inv_size=put(fields["inv_size"]),
                     dims=put(fields["dims"]).long(),
                     valid=put(fields["valid"]).bool())


def pose_graph_edges_from_arrays(fields, device=None) -> PoseGraphEdges:
    """PoseGraphEdges from {i, j, Z, info, valid}; indices become int64."""
    dev = resolve_device(device)
    put = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return PoseGraphEdges(i=put(fields["i"]).long(), j=put(fields["j"]).long(),
                          Z=put(fields["Z"]), info=put(fields["info"]),
                          valid=put(fields["valid"]).bool())


def sharded_result_to_numpy(res) -> dict:
    """The fields of a ShardedICPResult -- the port's tensors or the JAX
    package's arrays -- as numpy arrays by field name."""
    return {f: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x)) for f, x in zip(res._fields, res)}
