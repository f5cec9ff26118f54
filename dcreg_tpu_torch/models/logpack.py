"""Flat-packed per-iteration telemetry rows (counterpart of
``dcreg_tpu/models/logpack.py``).

The engines that log inline (XICP, O3D) pack each iteration's log fields
into one flat row of ``ROW_SIZE`` values in the log dtype, written into a
(max_iter, ROW_SIZE) buffer; ``icp.log_from_buffer`` slices the
structured ``IterationLog`` back out.  The layout, the fill values of
unwritten fields and the casts on unpacking are the JAX module's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# field -> (shape, kind); kind "f" float, "i" int, "b" bool, all stored in
# the log dtype and cast back on unpacking
LOG_SPEC: List[Tuple[str, Tuple[int, ...], str]] = [
    ("executed", (), "b"),
    ("effective_points", (), "i"),
    ("corr_num", (), "i"),
    ("rmse", (), "f"),
    ("fitness", (), "f"),
    ("objective", (), "f"),
    ("gradient", (6,), "f"),
    ("dx", (6,), "f"),
    ("transform", (4, 4), "f"),
    ("trans_error", (), "f"),
    ("rot_error_deg", (), "f"),
    ("eigenvalues_full", (6,), "f"),
    ("singular_values", (6,), "f"),
    ("lambda_schur_rot", (3,), "f"),
    ("lambda_schur_trans", (3,), "f"),
    ("V_schur_rot", (3, 3), "f"),
    ("V_schur_trans", (3, 3), "f"),
    ("lambda_diag_rot", (3,), "f"),
    ("lambda_diag_trans", (3,), "f"),
    ("cond_full", (), "f"),
    ("cond_schur_rot", (), "f"),
    ("cond_schur_trans", (), "f"),
    ("cond_diag_rot", (), "f"),
    ("cond_diag_trans", (), "f"),
    ("cond_full_sub_rot", (), "f"),
    ("cond_full_sub_trans", (), "f"),
    ("is_degenerate", (), "b"),
    ("degenerate_mask", (6,), "b"),
    ("pcg_iterations", (), "i"),
    ("pcg_residual", (), "f"),
    ("cond_PH", (), "f"),
    ("P_preconditioner", (6, 6), "f"),
    ("W_adaptive", (6, 6), "f"),
    ("H", (6, 6), "f"),
]

_OFFSETS: Dict[str, Tuple[int, int, Tuple[int, ...], str]] = {}
_off = 0
for _name, _shape, _kind in LOG_SPEC:
    _size = math.prod(_shape)
    _OFFSETS[_name] = (_off, _size, _shape, _kind)
    _off += _size
ROW_SIZE = _off


def _fill(kind):
    """The value of a field no engine wrote: -1 counts, False flags, NaN
    floats."""
    return -1.0 if kind == "i" else (0.0 if kind == "b" else float("nan"))


def pack_row(dtype, device=None, **fields):
    """Pack named field values into one flat (ROW_SIZE,) tensor; fields
    not given take their fill value."""
    parts = []
    for name, shape, kind in LOG_SPEC:
        v = fields.get(name)
        if v is None:
            parts.append(torch.full((math.prod(shape),), _fill(kind),
                                    dtype=dtype, device=device))
        else:
            parts.append(torch.as_tensor(v, dtype=dtype, device=device)
                         .reshape(-1))
    return torch.cat(parts)


def unpack(buffer, field):
    """Slice one field out of the (I, ROW_SIZE) buffer -> (I, *shape)."""
    off, size, shape, kind = _OFFSETS[field]
    v = buffer[:, off:off + size]
    v = v.reshape((buffer.shape[0],) + shape) if shape else v[:, 0]
    if kind == "i":
        return torch.nan_to_num(v, nan=-1.0).to(torch.int32)
    if kind == "b":
        return (v != 0) & ~torch.isnan(v)
    return v


def empty_buffer(I, dtype, device=None):
    """(I, ROW_SIZE): every row unwritten."""
    return pack_row(dtype, device)[None, :].repeat(I, 1)
