"""The precision step below the configuration's float32: TF32 matrix
products (operands rounded to a 10-bit mantissa, float32 accumulation).
The controls of the judge run the reference so; the operands are rounded
explicitly, since the library takes the tensor cores only for some
shapes."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def sqdist(q: torch.Tensor, r: torch.Tensor, tf32_products: bool) -> torch.Tensor:
    """(q, r) squared distances |q|^2 - 2 q.r + |r|^2: in float64 (exact
    to ~1e-16 of the squared norms), or in float32 with the product in
    TF32 (the control)."""
    if not tf32_products:
        q, r = q.double(), r.double()
        prod = q @ r.T
    else:
        q, r = q.float(), r.float()
        with tf32():
            prod = round_tf32(q) @ round_tf32(r).T
    return torch.clamp((q * q).sum(-1)[:, None] - 2.0 * prod + (r * r).sum(-1)[None], min=0.0)
