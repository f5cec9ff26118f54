"""Random streams of a run, each drawn from ``--seed`` and a name."""
from __future__ import annotations

import zlib

import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run ``seed``."""
    return (int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, name))
    return g
