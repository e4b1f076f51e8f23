"""Exact brute-force k-NN in feature space: kernel 3 and its plain version.

Port of ``fusion4landslide_tpu.ops.knn_pallas.knn_pallas``, the path the
JAX package's ``ops.knn.knn`` takes on an accelerator for D > 8 and
k <= 128. What it computes is set by the Pallas kernel, not by the XLA
search (``_knn_xla``):

- the selection score is the raw ``|r|^2 - 2 q.r``: no ``|q|^2`` and no
  clamp before selection (``_knn_xla`` clamps ``|q|^2 - 2 q.r + |r|^2`` at
  0 first, so on near-duplicate refs the two pick different neighbours);
- masked refs carry ``|r|^2 = +inf`` and never win;
- ``exclude_self`` drops ref column j for query row i when i == j;
- ties go to the lowest ref index;
- the distance out is ``max(score + |q|^2, 0)``, and the index is 0
  wherever that distance is +inf.

``knn_feature`` computes ``|q|^2`` and ``|r|^2`` once, as sequential sums
over d, and hands the same tensors to the CUDA kernel (``csrc/knn.cu``)
for tensors on the card or to ``knn_plain`` for tensors on the CPU. The
plain version repeats the kernel's operation order (the dot product as
``acc = acc + q[:, d] * r[:, d]``, each operation rounded on its own), so
the two agree bit for bit. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from fusion4landslide_tpu_torch.ops import cuda_build
from fusion4landslide_tpu_torch.ops.cuda_build import LAUNCHES

__all__ = ["MAX_K", "knn_feature", "knn_plain", "sq_norms"]

#: Largest k the kernel takes (the Pallas kernel's limit).
MAX_K = 128
#: Feature width the kernel is compiled for (the DIPs descriptor width);
#: narrower inputs are padded with zero columns, which is exact.
_WIDTH = 64
#: Plain version: query rows and ref columns per score slab.
_QUERY_BLOCK = 2048
_REF_CHUNK = 65536


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(n,) squared row norms, summed over d in order (one rounding per
    product and per sum, as the kernel's dot product)."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for d in range(x.shape[1]):
        acc = acc + x[:, d] * x[:, d]
    return acc


def knn_plain(query, ref, k: int, q2, r2, *, exclude_self: bool = False):
    """Plain PyTorch version of ``csrc/knn.cu``: ((n, k) f32 distances,
    (n, k) int32 indices) from (n, D) queries, (m, D) refs and their
    squared norms ``q2`` (n,) / ``r2`` (m,) (+inf on masked refs)."""
    n, m = query.shape[0], ref.shape[0]
    dev = query.device
    out_d, out_i = [], []
    for q0 in range(0, n, _QUERY_BLOCK):
        q = query[q0:q0 + _QUERY_BLOCK]
        rows = torch.arange(q0, q0 + q.shape[0], device=dev)
        best_d = torch.empty((q.shape[0], 0), dtype=torch.float32, device=dev)
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=dev)
        for r0 in range(0, m, _REF_CHUNK):
            r = ref[r0:r0 + _REF_CHUNK]
            cols = torch.arange(r0, r0 + r.shape[0], device=dev)
            acc = torch.zeros((q.shape[0], r.shape[0]), dtype=torch.float32, device=dev)
            for d in range(query.shape[1]):
                acc = acc + q[:, d, None] * r[None, :, d]
            s = r2[None, r0:r0 + r.shape[0]] - 2.0 * acc
            if exclude_self:
                s = torch.where(rows[:, None] == cols[None, :], torch.inf, s)
            # Earlier columns first, so a stable order keeps ties on the
            # lowest index.
            cat_d = torch.cat([best_d, s], 1)
            cat_i = torch.cat([best_i, cols[None].expand_as(s)], 1)
            if k == 1:
                pos = cat_d.argmin(dim=1, keepdim=True)
            else:
                pos = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
            best_d = torch.gather(cat_d, 1, pos)
            best_i = torch.gather(cat_i, 1, pos)
        if best_d.shape[1] < k:
            fill = (q.shape[0], k - best_d.shape[1])
            best_d = torch.cat([best_d, torch.full(fill, torch.inf, device=dev)], 1)
            best_i = torch.cat([best_i, torch.zeros(fill, dtype=torch.int64, device=dev)], 1)
        d = torch.clamp(best_d + q2[q0:q0 + q.shape[0], None], min=0.0)
        out_d.append(d)
        out_i.append(torch.where(torch.isfinite(d), best_i, 0).to(torch.int32))
    if not out_d:
        return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    return torch.cat(out_d), torch.cat(out_i)


def _knn_cuda(query, ref, k: int, q2, r2, *, exclude_self: bool):
    n, width = query.shape
    m = ref.shape[0]
    if width > _WIDTH:
        raise ValueError(f"knn kernel takes D <= {_WIDTH}, got {width}")
    for name, t in (("query", query), ("ref", ref), ("q2", q2), ("r2", r2)):
        if not t.is_cuda:
            raise ValueError(f"{name} must lie on the card, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != query.device:
            raise ValueError("all tensors must lie on one device")
    if ref.shape[1] != width or q2.shape != (n,) or r2.shape != (m,):
        raise ValueError("query (n, D), ref (m, D), q2 (n,), r2 (m,) expected")
    if width < _WIDTH:
        query = torch.nn.functional.pad(query, (0, _WIDTH - width))
        ref = torch.nn.functional.pad(ref, (0, _WIDTH - width))
    query, ref = query.contiguous(), ref.contiguous()
    q2, r2 = q2.contiguous(), r2.contiguous()
    dev = query.device
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    fn = cuda_build.load("knn").knn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    err = fn(
        query.data_ptr(), q2.data_ptr(), ref.data_ptr(), r2.data_ptr(),
        n, m, k, int(exclude_self), out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn CUDA launch failed (cudaError {err})")
    LAUNCHES["knn"] += 1
    return out_d, out_i


def knn_feature(query, ref, k: int, ref_mask=None, *, exclude_self: bool = False):
    """Exact k nearest refs of each query row, selected as kernel 3
    selects them: ((n, k) squared distances ascending, (n, k) int32
    indices; +inf / 0 where masked or exhausted). The CUDA kernel for
    tensors on the card, the plain version for tensors on the CPU."""
    if k > MAX_K:
        raise ValueError(f"knn kernel supports k <= {MAX_K}, got {k}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if query.dim() != 2 or ref.dim() != 2:
        raise ValueError("knn kernel takes (n, D) queries and (m, D) refs")
    query = query.to(torch.float32)
    ref = ref.to(torch.float32)
    r2 = sq_norms(ref)
    if ref_mask is not None:
        r2 = torch.where(ref_mask.to(torch.bool), r2, torch.inf)
    q2 = sq_norms(query)
    if query.is_cuda:
        return _knn_cuda(query, ref, k, q2, r2, exclude_self=exclude_self)
    return knn_plain(query, ref, k, q2, r2, exclude_self=exclude_self)
