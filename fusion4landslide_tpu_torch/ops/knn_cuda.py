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
the two agree bit for bit. The kernel forms approximate scores on the
tensor cores from a TF32 split of both operands, centred on the mean ref
(``filter_terms``, ``tf32_pack``), and rescores with that exact chain
every candidate whose certified lower bound could still enter a row's top
k; so the exact chain decides every selection. A failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.ops import cuda_build
from fusion4landslide_tpu_torch.ops.cuda_build import count_launch

__all__ = [
    "MARGIN_EPS", "MARGIN_EPS_RAW", "MAX_K", "RESCORED", "FilterTerms",
    "filter_terms", "knn_feature", "knn_plain", "sq_norms", "tf32_pack", "tf32_split",
]

#: Largest k the kernel takes (the Pallas kernel's limit).
MAX_K = 128
#: Feature width the kernel is compiled for (the DIPs descriptor width);
#: narrower inputs are padded with zero columns, which is exact.
_WIDTH = 64
#: Query rows and refs per kernel tile (the wrapper pads both to it).
_TILE = 128
#: int32 mask clearing a float32's low 13 mantissa bits (float32 -> TF32).
_TF32_MASK = -(1 << 13)
#: The kernel's certified filter margins: eps2 on the centred tensor-core
#: terms (|a||b| + |b|^2), eps1 on the exact chain's own rounding
#: (|q||r| + |r|^2); each about twice the derived bound (``csrc/knn.cu``).
MARGIN_EPS = 2.0 ** -13
MARGIN_EPS_RAW = 2.0 ** -16
#: ``filter_terms`` centres on the mean ref when |mean|^2 reaches this
#: fraction of the mean |r|^2, i.e. the centred energy is at most 1/16.
_CENTRE_FRACTION = 15.0 / 16.0
#: The last launch's count of rescored candidates (of whichever tile stream
#: launched last), a () int64 tensor on the
#: card (read it with ``.item()`` off the main path).
RESCORED: list = [None]
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


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x``: ``hi`` is ``x`` with the low 13 mantissa
    bits cleared (a TF32 number), ``lo = x - hi`` (exact in float32, so
    ``hi + lo == x`` bit for bit)."""
    hi = (x.contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)
    return hi, x - hi


def tf32_pack(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, 2 * 64) float32 rows ``[hi | lo]`` of (n, D) ``x``, D <= 64:
    the kernel's operand layout, narrow widths and rows past n zero."""
    n, width = x.shape
    hi, lo = tf32_split(x)
    out = torch.zeros((rows, 2 * _WIDTH), dtype=torch.float32, device=x.device)
    out[:n, :width] = hi
    out[:n, _WIDTH:_WIDTH + width] = lo
    return out


def _padded(x: torch.Tensor, rows: int, fill: float) -> torch.Tensor:
    out = torch.full((rows,) + tuple(x.shape[1:]), fill, dtype=torch.float32, device=x.device)
    out[:x.shape[0]] = x
    return out


class FilterTerms(NamedTuple):
    """Kernel 3's operands and margin terms (``csrc/knn.cu``, "The
    filter"), rows padded to whole tiles."""

    qpack: torch.Tensor  # (n_pad, 128) [hi | lo] of a = q - mu (mu may be 0)
    rpack: torch.Tensor  # (m_pad, 128) [hi | lo] of b = r - mu
    qraw: torch.Tensor  # (n_pad, 64) queries, zero-padded
    rraw: torch.Tensor  # (m_pad, 64) refs, zero-padded
    row_p: torch.Tensor  # (n_pad,) P_i = max(|q_i|, |a_i|); -1: zero row, skipped
    row_b: torch.Tensor  # (n_pad,) B_i = C_i - eps1 (|C_i| + 2 |a_i||mu|)
    ref_r2: torch.Tensor  # (m_pad,) |r_j|^2 as given, +inf masked and padded
    ref_a: torch.Tensor  # (m_pad,) A_j = |b|^2 - eps1 |r|^2 - eps2 |b|^2, NaN masked
    ref_w: torch.Tensor  # (m_pad,) W_j = eps1 |r_j| + eps2 |b_j|, 0 masked


def filter_terms(query, ref, r2) -> FilterTerms:
    """Centre both sides on the mean of the unmasked refs (when they
    cluster; else on 0), split them for 3xTF32 and form the margin terms,
    so that for every pair
    ``s_ij >= A_j - 2 c'_ij - W_j P_i + B_i`` with ``s_ij`` the exact
    fixed-order float32 score and ``c'_ij`` the tensor cores' centred dot
    product (derivation in ``csrc/knn.cu``). Norms and ``C_i`` are formed
    in float64, then rounded to float32."""
    n, m = query.shape[0], ref.shape[0]
    n_pad = -(-max(n, 1) // _TILE) * _TILE
    m_pad = -(-max(m, 1) // _TILE) * _TILE
    live = torch.isfinite(r2)
    count = live.sum().clamp(min=1)
    mu = torch.where(live[:, None], ref, 0.0).sum(0) / count
    # Centre only refs that cluster (sum |r - mu|^2 <= sum |r|^2 / 16):
    # elsewhere the centred terms would not shrink, and the row constant
    # C_i would only widen the margin. A device-side choice (no sync).
    r64 = ref.double()
    mean_r2 = torch.where(live, (r64 * r64).sum(1), 0.0).sum() / count
    mu = torch.where(mu.double() @ mu.double() >= _CENTRE_FRACTION * mean_r2, mu, 0.0)
    a32, b32 = query - mu, ref - mu
    q64, a64, b64, mu64 = (x.double() for x in (query, a32, b32, mu))
    qn, rn, an, bn = (x.norm(dim=1) for x in (q64, r64, a64, b64))
    c = -(mu64 @ mu64) - 2.0 * (a64 @ mu64)
    # A zero query row scores s_ij = |r_j|^2 exactly; the wrapper answers
    # it (``_zero_rows``), and P_i = -1 tells the kernel to skip it.
    p = torch.where(query.any(1), torch.maximum(qn, an), -1.0)
    b = c - MARGIN_EPS_RAW * (c.abs() + 2.0 * an * mu64.norm())
    a_j = bn * bn - MARGIN_EPS_RAW * rn * rn - MARGIN_EPS * bn * bn
    w_j = MARGIN_EPS_RAW * rn + MARGIN_EPS * bn
    a_j = torch.where(live, a_j, torch.nan)
    w_j = torch.where(live, w_j, 0.0)
    pad = (0, _WIDTH - query.shape[1])
    return FilterTerms(
        tf32_pack(a32, n_pad), tf32_pack(b32, m_pad),
        _padded(torch.nn.functional.pad(query, pad), n_pad, 0.0),
        _padded(torch.nn.functional.pad(ref, pad), m_pad, 0.0),
        _padded(p.float(), n_pad, 0.0), _padded(b.float(), n_pad, 0.0),
        _padded(r2, m_pad, torch.inf), _padded(a_j.float(), m_pad, torch.nan),
        _padded(w_j.float(), m_pad, 0.0),
    )


def _zero_rows(n: int, k: int, r2, *, exclude_self: bool):
    """((n, k), (n, k)) the result every row would get if it were all
    zeros: its exact score is |r_j|^2 (the chain adds only zeros), so its
    neighbours are the refs of least |r|^2 in index order, less row i's
    own column with ``exclude_self``."""
    dev = r2.device
    order = torch.sort(r2, stable=True).indices[:k + 1]
    cand = torch.cat([order, order.new_full((k + 1 - order.shape[0],), -1)])
    cand = cand[None].expand(n, k + 1)
    dropped = (cand == torch.arange(n, device=dev)[:, None]) if exclude_self else cand < 0
    keep = torch.sort(dropped.to(torch.int8), dim=1, stable=True).indices[:, :k]
    idx = torch.gather(cand, 1, keep)
    d = torch.where(idx >= 0, r2[idx.clamp(min=0)] if r2.numel() else torch.inf, torch.inf)
    d = torch.clamp(d, min=0.0)
    return d, torch.where(torch.isfinite(d), idx, 0).to(torch.int32)


def _knn_cuda(query, ref, k: int, q2, r2, *, exclude_self: bool):
    """Launch kernel 3. Its TF32 filter admits candidate (i, j) to exact
    rescoring only when a certified lower bound of its exact score
    (``filter_terms``) can still reach row i's current k-th best. The
    launch's rescored-candidate count stays on the card in ``RESCORED[0]``
    (no host sync)."""
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
    dev = query.device
    ft = filter_terms(query, ref, r2)
    # Refs past the last unmasked one are skipped whole tiles at a time.
    live = torch.where(torch.isfinite(r2), torch.arange(1, m + 1, dtype=torch.int32, device=dev), 0)
    m_live = live.amax().reshape(1) if m else torch.zeros(1, dtype=torch.int32, device=dev)
    q2 = q2.contiguous()
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    rescored = torch.zeros((), dtype=torch.int64, device=dev)
    fn = cuda_build.load("knn").knn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    err = fn(
        ft.qpack.data_ptr(), ft.rpack.data_ptr(), ft.qraw.data_ptr(), ft.rraw.data_ptr(),
        q2.data_ptr(), ft.row_p.data_ptr(), ft.row_b.data_ptr(), ft.ref_r2.data_ptr(),
        ft.ref_a.data_ptr(), ft.ref_w.data_ptr(), m_live.data_ptr(), n, ft.qpack.shape[0], k,
        int(exclude_self), out_d.data_ptr(), out_i.data_ptr(), rescored.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn CUDA launch failed (cudaError {err})")
    count_launch("knn")
    RESCORED[0] = rescored
    zero = (ft.row_p[:n] < 0)[:, None]
    zd, zi = _zero_rows(n, k, r2, exclude_self=exclude_self)
    return torch.where(zero, zd, out_d), torch.where(zero, zi, out_i)


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
