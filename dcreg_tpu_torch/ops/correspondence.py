"""Correspondence parameters (counterpart of
``dcreg_tpu/ops/correspondence.py``; the pair-mode search and plane fits
are not ported yet)."""
from __future__ import annotations

from typing import NamedTuple


class CorrespondenceParams(NamedTuple):
    search_radius: float = 1.0
    max_plane_thickness: float = 0.2
    weight_slope: float = 0.9
    min_weight: float = 0.1
    k: int = 5
    num_blocks: int = 16
