"""Precision guard and device resolution (counterpart of
``dcreg_tpu/utils/__init__.py``).

The JAX package traces every numerically sensitive entry point under
``jax.default_matmul_precision("float32")`` so no matmul runs in bf16
passes.  On the H100 the matching hazard is TF32: a float32 matmul or
convolution may run on the tensor cores with a 10-bit mantissa.  The port
turns both TF32 switches off and asserts them at its entry points, so the
6x6 Hessian products and the SoA tail's einsums stay full f32.
"""
from __future__ import annotations

import torch


def precise() -> None:
    """Disable TF32 for float32 matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_precise() -> None:
    """Raise unless both TF32 switches are off (see ``precise``)."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled; call dcreg_tpu_torch.utils.precise() first "
            "(float32 matmuls must run in full precision)")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  With no GPU and no explicit device this raises -- there is
    no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is unavailable")
    return dev


precise()
