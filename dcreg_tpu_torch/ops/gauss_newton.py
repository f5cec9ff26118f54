"""Gauss-Newton system container (counterpart of
``dcreg_tpu/ops/gauss_newton.py``; ``build_system`` belongs to the
pair-mode engine and is not ported yet)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class GNSystem(NamedTuple):
    H: torch.Tensor          # (..., 6, 6) J^T J
    g: torch.Tensor          # (..., 6)  J^T b with b = -s r (H dx = g)
    num_valid: torch.Tensor  # (...,) int: effective correspondences
    rmse: torch.Tensor       # (...,) sqrt(mean raw residual^2 over valid)
    fitness: torch.Tensor    # (...,) fraction of points with 5-NN in radius
    objective: torch.Tensor  # (...,) 0.5 * ||s r||^2
