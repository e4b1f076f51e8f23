"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. A
CUDA entry point that finds no GPU raises; nothing falls back to the CPU on
its own. TF32 is switched off for matmuls and convolutions: the Pallas
kernels and the JAX reference compute in full float32
(``Precision.HIGHEST``). bfloat16 matmuls (``feat_dtype: bfloat16``)
accumulate in float32 and round once, as XLA's do: reduced-precision
reductions are switched off.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on (default ``cuda``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
