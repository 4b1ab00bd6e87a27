"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def pin_f32_matmul() -> None:
    """Full-f32 products on the card: no TF32 in matmuls or convolutions,
    and bf16 products summed in f32 (the reference's bf16 matmuls
    accumulate in f32).

    TF32 keeps ~3 decimal digits, which moves the ε-normal depth
    differences and breaks parity with the f32 reference.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is meant and absent — never falls back to
    the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        pin_f32_matmul()
    return device
