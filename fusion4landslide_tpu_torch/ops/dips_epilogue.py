"""The DIPs trunks' dense-layer epilogue: eval-mode BatchNorm, then ReLU or
the max-pool over a patch's points, in one pass (``csrc/dips_epilogue.cu``).

Each dense layer of ``models/dips.py``'s trunks is followed by
``EvalBatchNorm``, four broadcast operations each rounded to float32,
``((y - mean) * scale) * inv + bias`` with ``inv = rsqrt(var + eps)``, and
by a ReLU (``bn1``, ``bn2``, ``bn4``, ``bn5``) or the max over the patch's
points (``bn3``). ``bn_relu_`` (in place) and ``bn_max`` do both: for
tensors on the card they launch the kernel, which repeats those operations
in their order and so gives the plain chain's bits; for tensors on the CPU
they run the plain chain (``bn_relu_plain``, ``bn_max_plain``). ``inv``
comes from PyTorch on both paths, so the factor is the same float. The
argument checks run before the device dispatch, on both paths.

Counting: each call adds one to the active tile's ``dips.epilogues``
(``utils.profiling``) on either path, ten per ``PointNetFeature`` call
(two trunks of five layers); ``cuda_build.LAUNCHES["dips_epilogue"]``
counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from fusion4landslide_tpu_torch.ops import cuda_build
from fusion4landslide_tpu_torch.utils import profiling

__all__ = ["batch_norm_plain", "bn_max", "bn_max_plain", "bn_relu_", "bn_relu_plain"]

_FACTORS = ("mean", "scale", "inv", "bias")


def batch_norm_plain(x, mean, scale, inv, bias):
    """Eval-mode BatchNorm's operations in their order, out of place."""
    y = x - mean
    return y.mul_(scale).mul_(inv).add_(bias)


def bn_relu_plain(x, mean, scale, inv, bias):
    """The plain chain of ``bn_relu_``, in place on ``x``."""
    return x.sub_(mean).mul_(scale).mul_(inv).add_(bias).relu_()


def bn_max_plain(x, mean, scale, inv, bias):
    """The plain chain of ``bn_max``: BatchNorm, then the max over dim -2."""
    return batch_norm_plain(x, mean, scale, inv, bias).amax(dim=-2)


def _check(x: torch.Tensor, factors, min_dim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the activation must be float32, got {x.dtype}")
    if x.dim() < min_dim:
        raise ValueError(f"the activation must have at least {min_dim} dims, got {x.dim()}")
    if not x.is_contiguous():
        raise ValueError("the activation must be contiguous")
    c = x.shape[-1]
    if c == 0 or c % 4:
        raise ValueError(f"the channel count must be a positive multiple of 4, got {c}")
    for name, t in zip(_FACTORS, factors):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) vector")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, the activation on {x.device}")


def _count() -> None:
    rec = profiling.record()
    if rec is not None:
        profiling.count(rec, "dips.epilogues", 1)


def _launch(entry: str, args, tensors) -> None:
    """Launch ``entry`` of the library: the kernel writes through raw
    pointers, which autograd does not see, and loads 16 bytes at a time."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("the epilogue kernel records no autograd history: call it under "
                         "torch.no_grad() or torch.inference_mode()")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the epilogue kernel needs 16-byte aligned tensors")
    fn = getattr(cuda_build.load("dips_epilogue"), entry)
    fn.restype = ctypes.c_int
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(tensors[0].device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{entry} CUDA launch failed (cudaError {err})")
    cuda_build.count_launch("dips_epilogue")


def bn_relu_(x: torch.Tensor, mean, scale, inv, bias) -> torch.Tensor:
    """relu(BatchNorm(x)) over the last dim of a contiguous float32 ``x``,
    written in place; returns ``x``."""
    factors = (mean, scale, inv, bias)
    _check(x, factors, 1)
    _count()
    if not x.is_cuda:
        return bn_relu_plain(x, *factors)
    if x.numel() == 0:
        return x
    c = x.shape[-1]
    _launch(
        "dips_bn_relu_launch",
        [ctypes.c_void_p(x.data_ptr()), *(ctypes.c_void_p(t.data_ptr()) for t in factors),
         ctypes.c_longlong(x.numel() // c), ctypes.c_int(c)],
        (x, *factors),
    )
    return x


def bn_max(x: torch.Tensor, mean, scale, inv, bias) -> torch.Tensor:
    """The max over dim -2 of BatchNorm(x) for a contiguous float32
    (..., N, C) ``x``: (..., C). ``x`` is left as it was."""
    factors = (mean, scale, inv, bias)
    _check(x, factors, 2)
    n, c = x.shape[-2], x.shape[-1]
    if n == 0:
        raise ValueError("the max-pool needs at least one point")
    _count()
    if not x.is_cuda:
        return bn_max_plain(x, *factors)
    out = torch.empty((*x.shape[:-2], c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    _launch(
        "dips_bn_max_launch",
        [ctypes.c_void_p(x.data_ptr()), *(ctypes.c_void_p(t.data_ptr()) for t in factors),
         ctypes.c_longlong(out.numel() // c), ctypes.c_int(n), ctypes.c_int(c),
         ctypes.c_void_p(out.data_ptr())],
        (x, *factors, out),
    )
    return out
