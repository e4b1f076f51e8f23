"""Grid-window kernels: window prologue, kernel wrappers, plain versions.

Port of ``fusion4landslide_tpu.ops.hashgrid_pallas``. Queries are sorted by
grid cell and cut into blocks of ``block`` (512); each block scans ONE
contiguous, 128-aligned run of the cell-sorted reference array — the union
of its queries' 27-cell neighbourhoods (the linear cell id is monotone
under componentwise order). Two kernels scan those windows:

- kernel 2, ``csrc/grid_knn.cu`` (replaces ``_grid_knn_kernel``): the k
  nearest references, ``hash_grid_knn_window``;
- kernel 1, ``csrc/radius_sample.cu`` (replaces ``_radius_sample_kernel``):
  a lane-stratified subsample of the in-radius references,
  ``radius_sample_window`` / ``radius_sample_blocks``.

Each wrapper launches its CUDA kernel for tensors on the card (or raises)
and runs the plain PyTorch version, kept beside it, for tensors on the
CPU. ``LAUNCHES`` (``cuda_build.LAUNCHES``) counts kernel launches. Every
window function returns its overflow count: the blocks whose true window
exceeded ``window`` (those results are truncated, as on the TPU, where the
window is a static VMEM shape and the traced callers cannot fall back
either).

A block's window is the run of cells between its queries' componentwise
lowest and highest cells, and the linear cell id puts x first: a block
whose queries cross from one x-slab of cells to the next spans four whole
slabs, so its window grows with the tile's y extent, not only with the
density. Callers that must not truncate ask for a fitted window
(``window_prologue(fit_chunk=...)``, ``hash_grid_knn_window(fit=True)``;
``radius_sample_window`` always fits): the scan window grows,
in whole chunks, to the largest block's true window
(``fitted_window``). Blocks within the default 32 768 positions scan
exactly as before (same positions, same strata, same block centres), so
the results equal the fixed window's wherever that window holds.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.ops import cuda_build
from fusion4landslide_tpu_torch.ops.cuda_build import LAUNCHES, count_launch

__all__ = [
    "LAUNCHES",
    "Window",
    "window_prologue",
    "fitted_window",
    "hash_grid_knn_window",
    "grid_knn_blocks",
    "grid_knn_plain",
    "hash_priority",
    "radius_sample_window",
    "radius_sample_blocks",
    "radius_sample_plain",
]

_LANES = 128

class Window(NamedTuple):
    qorder: torch.Tensor  # (n,) int64 sort permutation of the queries
    qpos: torch.Tensor  # (n_pad, 3) f32 cell-sorted queries (last repeated)
    qrow: torch.Tensor  # (n_pad,) int32 original row, -1 on padding
    wmeta: torch.Tensor  # (2, nb) int32 [128-aligned start; capped length]
    refpack: torch.Tensor  # (4, m_pad) f32 rows [x, y, z, |r|^2 (+inf masked)]
    idxarr: torch.Tensor  # (m_pad,) int32 original ref index per position
    overflow: torch.Tensor  # () int32 blocks with w_len > window
    nb: int
    n_pad: int
    block: int
    window: int


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add a * b + c, rounded once (the product is
    exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def xla_sqnorm(c: torch.Tensor) -> torch.Tensor:
    """Squared norm of (..., 2) or (..., 3) differences in the rounding of
    the JAX package's CPU build, which contracts the sum of squares to
    fma(c2, c2, fma(c0, c0, c1 * c1))."""
    s = _fma(c[..., 0], c[..., 0], c[..., 1] * c[..., 1])
    return _fma(c[..., 2], c[..., 2], s) if c.shape[-1] == 3 else s


def _lin(c: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    return (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]


def fitted_window(w_len_max: int, window: int, chunk: int) -> int:
    """The scan window that holds every block: ``window``, or the largest
    block's true window length rounded up to whole ``chunk``s when that
    is longer."""
    return max(int(window), -(-int(w_len_max) // chunk) * chunk)


def window_prologue(query, grid, block: int = 512, window: int = 32768, *,
                    fit_chunk: int | None = None) -> Window:
    """Sort queries by linear cell id (stable), pad to whole blocks by
    repeating the last sorted query, derive each block's contiguous
    window from its componentwise cell bounds, and pack the cell-sorted
    references (``_window_prologue`` in the JAX package). With
    ``fit_chunk`` the window grows to ``fitted_window(max true window,
    window, fit_chunk)``, so no block overflows (one read-back)."""
    n = query.shape[0]
    m = grid.points.shape[0]
    dev = query.device
    dims = grid.dims
    qcell = torch.floor((query - grid.origin) / grid.cell).to(torch.int32)
    qcell = torch.clamp(qcell, torch.zeros_like(dims), dims - 1)
    qorder = torch.sort(_lin(qcell, dims), stable=True).indices
    q_sorted = query[qorder].to(torch.float32)
    qcell_sorted = qcell[qorder]
    nb = -(-max(n, 1) // block)
    n_pad = nb * block
    pad = n_pad - n
    if pad:
        q_sorted = torch.cat([q_sorted, q_sorted[-1:].expand(pad, 3)])
        qcell_sorted = torch.cat([qcell_sorted, qcell_sorted[-1:].expand(pad, 3)])
    cblk = qcell_sorted.view(nb, block, 3)
    zero = torch.zeros_like(dims)
    cmin = torch.clamp(cblk.min(dim=1).values - 1, zero, dims - 1)
    cmax = torch.clamp(cblk.max(dim=1).values + 1, zero, dims - 1)
    w_lo = grid.starts[_lin(cmin, dims).long()]
    w_hi = grid.starts[_lin(cmax, dims).long() + 1]
    w_lo_al = torch.div(w_lo, _LANES, rounding_mode="floor") * _LANES
    w_len = w_hi - w_lo_al
    if fit_chunk is not None:
        window = fitted_window(int(w_len.max()), window, fit_chunk)
    overflow = (w_len > window).sum().to(torch.int32)

    m_pad = (-(-max(m, 1) // _LANES)) * _LANES + window
    pts = grid.points.to(torch.float32)
    # |r|^2 as XLA's fused reduction forms it: fma(z, z, fma(y, y, x * x)).
    r2 = _fma(pts[:, 2], pts[:, 2], _fma(pts[:, 1], pts[:, 1], pts[:, 0] * pts[:, 0]))
    r2 = torch.where(torch.arange(m, device=dev) < grid.m_valid, r2, torch.inf)
    refpack = torch.zeros((4, m_pad), dtype=torch.float32, device=dev)
    refpack[0:3, :m] = pts.T
    refpack[3, :m] = r2
    refpack[3, m:] = torch.inf
    idxarr = torch.zeros((m_pad,), dtype=torch.int32, device=dev)
    idxarr[:m] = grid.index
    w_lo_al = torch.clamp(w_lo_al, max=m_pad - window)
    wmeta = torch.stack([w_lo_al, torch.clamp(w_len, max=window)]).to(torch.int32)
    qrow = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    qrow[:n] = qorder.to(torch.int32)
    return Window(
        qorder, q_sorted.contiguous(), qrow, wmeta.contiguous(), refpack,
        idxarr, overflow, nb, n_pad, block, window,
    )


def _check_cuda(**tensors):
    dev = None
    for name, (t, dtype) in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must lie on the card, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError("all tensors must lie on one device")


def _check_window(win: Window) -> None:
    nb, n_pad = win.nb, win.n_pad
    if win.qpos.shape != (n_pad, 3) or win.qrow.shape != (n_pad,):
        raise ValueError("queries must be (n_pad, 3) with (n_pad,) rows")
    if win.wmeta.shape != (2, nb) or n_pad != nb * win.block:
        raise ValueError("window metadata must be (2, nb) over whole blocks")
    m_pad = win.refpack.shape[1]
    if win.refpack.shape != (4, m_pad) or win.idxarr.shape != (m_pad,):
        raise ValueError("refpack must be (4, m_pad) with (m_pad,) indices")
    if m_pad < win.window:
        raise ValueError("refpack must hold at least one whole window")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed (cudaError {err})")


def _scan_len(w_len: torch.Tensor, chunk: int, window: int) -> torch.Tensor:
    return torch.clamp(-(-w_len // chunk) * chunk, max=window)


# --------------------------------------------------------------------------
# Kernel 2: grid kNN
# --------------------------------------------------------------------------


def grid_knn_plain(win: Window, k: int, *, chunk: int = 2048,
                   exclude_self: bool = False, blocks=None):
    """Plain PyTorch version of ``csrc/grid_knn.cu`` over the sorted
    rows of ``blocks`` (default all): ((rows, k) f32, (rows, k) int32),
    same arithmetic order as the kernel."""
    blocks = range(win.nb) if blocks is None else blocks
    scans = _scan_len(win.wmeta[1], chunk, win.window).tolist()
    w_los = win.wmeta[0].tolist()
    rp, B = win.refpack, win.block
    out_d, out_i = [], []
    for b in blocks:
        q = win.qpos[b * B:(b + 1) * B]
        pos = torch.arange(w_los[b], w_los[b] + scans[b], device=q.device)
        ci = win.idxarr[pos]
        m2 = -2.0 * q
        s = m2[:, 0:1] * rp[0, pos][None]
        s = _fma(m2[:, 1:2], rp[1, pos][None], s)
        s = _fma(m2[:, 2:3], rp[2, pos][None], s)
        s = s + rp[3, pos][None]
        if exclude_self:
            s = torch.where(ci[None] == win.qrow[b * B:(b + 1) * B, None], torch.inf, s)
        # (score, original index) order: sort by index, then stable by score.
        by_idx = torch.sort(ci, stable=True).indices
        s = s[:, by_idx]
        ci = ci[by_idx]
        kk = min(k, s.shape[1])
        sv, sp = torch.sort(s, dim=1, stable=True)
        sv, sp = sv[:, :kk], sp[:, :kk]
        if kk < k:
            fill = (q.shape[0], k - kk)
            sv = torch.cat([sv, torch.full(fill, torch.inf, device=q.device)], 1)
            sp = torch.cat([sp, torch.zeros(fill, dtype=sp.dtype, device=q.device)], 1)
        q2 = q[:, 0] * q[:, 0]
        q2 = q2 + q[:, 1] * q[:, 1]
        q2 = q2 + q[:, 2] * q[:, 2]
        d = torch.clamp(sv + q2[:, None], min=0.0)
        i = torch.where(torch.isfinite(sv), ci[sp] if ci.numel() else sp, 0)
        out_d.append(d)
        out_i.append(i.to(torch.int32))
    return torch.cat(out_d), torch.cat(out_i)


def _grid_knn_cuda(win: Window, k: int, *, chunk: int, exclude_self: bool):
    if not 1 <= k <= 32:
        raise ValueError(f"grid kNN kernel takes 1 <= k <= 32, got {k}")
    if win.block > 512:
        raise ValueError("grid kNN kernel takes block <= 512")
    if chunk % 4 or win.window % 4:
        raise ValueError("grid kNN kernel stages 16-byte runs: chunk and window % 4 == 0")
    _check_cuda(
        qpos=(win.qpos, torch.float32), qrow=(win.qrow, torch.int32),
        wmeta=(win.wmeta, torch.int32), refpack=(win.refpack, torch.float32),
        idxarr=(win.idxarr, torch.int32),
    )
    _check_window(win)
    if win.refpack.data_ptr() % 16 or win.idxarr.data_ptr() % 16:
        raise ValueError("refpack and idxarr must be 16-byte aligned")
    out_d = torch.empty((win.n_pad, k), dtype=torch.float32, device=win.qpos.device)
    out_i = torch.empty((win.n_pad, k), dtype=torch.int32, device=win.qpos.device)
    lib = cuda_build.load("grid_knn")
    fn = lib.grid_knn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    err = fn(
        win.qpos.data_ptr(), win.qrow.data_ptr(), win.wmeta.data_ptr(),
        win.refpack.data_ptr(), win.idxarr.data_ptr(), win.nb, win.block,
        win.refpack.shape[1], win.window, chunk, k, int(exclude_self),
        out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(win.qpos.device).cuda_stream,
    )
    _raise_on(err, "grid_knn")
    count_launch("grid_knn")
    return out_d, out_i


def grid_knn_blocks(win: Window, k: int, *, chunk: int = 2048,
                    exclude_self: bool = False):
    """Sorted-order (n_pad, k) squared distances and original indices —
    the CUDA kernel on the card, the plain version on the CPU."""
    if win.qpos.is_cuda:
        return _grid_knn_cuda(win, k, chunk=chunk, exclude_self=exclude_self)
    return grid_knn_plain(win, k, chunk=chunk, exclude_self=exclude_self)


def hash_grid_knn_window(query, grid, radius, k: int = 1, *, block: int = 512,
                         window: int = 32768, chunk: int = 2048,
                         exclude_self: bool = False, fit: bool = False):
    """k nearest references within ``radius`` of each query: ((n, k)
    squared distances ascending, +inf past radius; (n, k) original ref
    indices, 0 where invalid; () overflow count). ``fit``: the window
    grows to the largest block's (module docstring), overflow 0."""
    if window % chunk:
        raise ValueError("window must be a multiple of chunk")
    n = query.shape[0]
    win = window_prologue(query, grid, block, window, fit_chunk=chunk if fit else None)
    d, i = grid_knn_blocks(win, k, chunk=chunk, exclude_self=exclude_self)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=query.device)
    bad = d > radius * radius
    d = torch.where(bad, torch.inf, d)
    i = torch.where(bad | ~torch.isfinite(d), 0, i)
    d_out = torch.zeros((n, k), dtype=torch.float32, device=query.device)
    i_out = torch.zeros((n, k), dtype=torch.int32, device=query.device)
    d_out[win.qorder] = d[:n]
    i_out[win.qorder] = i[:n]
    return d_out, i_out, win.overflow


# --------------------------------------------------------------------------
# Kernel 1: lane-stratified radius sampler
# --------------------------------------------------------------------------


def block_centres(win: Window) -> torch.Tensor:
    """(nb, 3) mean of each block's (padded) query positions — the frame
    the sampler's radius and self tests are evaluated in."""
    return win.qpos.view(win.nb, win.block, 3).mean(dim=1).contiguous()


def hash_priority(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """uint32 hash of (index, seed) in int64 masked to 32 bits; top 24
    bits scaled to [0, 1)."""
    mask = 0xFFFFFFFF
    x = (idx.to(torch.int64) & mask) * 2654435761 + (seed & mask)
    x = x & mask
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & mask
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def radius_sample_plain(win: Window, cen, r2, num_points: int, seed: int = 0,
                        priority: str = "random", *, chunk: int = 2048,
                        blocks=None):
    """Plain PyTorch version of ``csrc/radius_sample.cu`` over the sorted
    rows of ``blocks``: ((rows, P) int32 idx, (rows, P) bool valid,
    (rows, P, 3) f32 xyz), same arithmetic order as the kernel."""
    blocks = range(win.nb) if blocks is None else blocks
    layers = num_points // _LANES
    scans = _scan_len(win.wmeta[1], chunk, win.window).tolist()
    w_los = win.wmeta[0].tolist()
    rp, B, dev = win.refpack, win.block, win.qpos.device
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=dev)
    outs_i, outs_v, outs_x = [], [], []
    for b in blocks:
        q = win.qpos[b * B:(b + 1) * B]
        c = cen[b]
        pos = torch.arange(w_los[b], w_los[b] + scans[b], device=dev)
        qc = q - c
        m2 = -2.0 * qc
        qc2 = qc[:, 0] * qc[:, 0]
        qc2 = qc2 + qc[:, 1] * qc[:, 1]
        qc2 = qc2 + qc[:, 2] * qc[:, 2]
        rx, ry, rz = rp[0, pos] - c[0], rp[1, pos] - c[1], rp[2, pos] - c[2]
        r2w = rx * rx
        r2w = r2w + ry * ry
        r2w = r2w + rz * rz
        s = m2[:, 0:1] * rx[None]
        s = s + m2[:, 1:2] * ry[None]
        s = s + m2[:, 2:3] * rz[None]
        s = s + r2w[None]
        d2 = s + qc2[:, None]
        ok = (d2 <= r2) & (d2 > r2 * 1e-6) & (rp[3, pos] < torch.inf)[None]
        ci = win.idxarr[pos]
        if priority == "distance":
            pri = d2
        elif priority == "random":
            pri = hash_priority(ci, seed)[None].expand_as(d2)
        else:
            raise ValueError(f"unknown priority {priority!r}")
        keyed = torch.where(ok, pri, torch.inf)
        # Stratum = position mod 128 (w_lo is 128-aligned, scan a multiple
        # of 128): per (query, lane) keep the `layers` smallest keys, ties
        # to the earlier position (stable sort).
        S = pos.shape[0] // _LANES
        kv = keyed.view(B, S, _LANES)
        if S < layers:
            pad = torch.full((B, layers - S, _LANES), torch.inf, device=dev)
            kv = torch.cat([kv, pad], dim=1)
        sv, sp = torch.sort(kv, dim=1, stable=True)
        sv, sp = sv[:, :layers], sp[:, :layers]  # (B, layers, 128)
        lane = torch.arange(_LANES, device=dev)
        flat = torch.clamp(sp * _LANES + lane, max=max(pos.shape[0] - 1, 0))
        valid = torch.isfinite(sv)
        if pos.shape[0]:
            gi = torch.where(valid, ci[flat], 0)
            gx = torch.stack([rp[d, pos][flat] for d in range(3)], dim=-1)
        else:
            gi = torch.zeros_like(flat, dtype=torch.int32)
            gx = torch.zeros(flat.shape + (3,), device=dev)
        gx = torch.where(valid[..., None], gx, 0.0)
        outs_i.append(gi.reshape(B, num_points).to(torch.int32))
        outs_v.append(valid.reshape(B, num_points))
        outs_x.append(gx.reshape(B, num_points, 3))
    return torch.cat(outs_i), torch.cat(outs_v), torch.cat(outs_x)


def _radius_sample_cuda(win: Window, cen, r2, num_points: int, seed: int,
                        priority: str, *, chunk: int, b0: int, b1: int):
    if num_points // _LANES not in (1, 2, 4):
        raise ValueError("sampler kernel takes num_points in {128, 256, 512}")
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=win.qpos.device).reshape(())
    _check_cuda(
        qpos=(win.qpos, torch.float32), cen=(cen, torch.float32),
        r2=(r2, torch.float32), wmeta=(win.wmeta, torch.int32),
        refpack=(win.refpack, torch.float32), idxarr=(win.idxarr, torch.int32),
    )
    _check_window(win)
    if cen.shape != (win.nb, 3) or not 0 <= b0 <= b1 <= win.nb:
        raise ValueError("block centres must be (nb, 3) and 0 <= b0 <= b1 <= nb")
    rows = (b1 - b0) * win.block
    dev = win.qpos.device
    out_i = torch.empty((rows, num_points), dtype=torch.int32, device=dev)
    out_v = torch.empty((rows, num_points), dtype=torch.int32, device=dev)
    out_x = torch.empty((rows, num_points, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.load("radius_sample")
    fn = lib.radius_sample_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_uint]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    )
    err = fn(
        win.qpos.data_ptr(), cen.data_ptr(), r2.data_ptr(), win.wmeta.data_ptr(),
        win.refpack.data_ptr(), win.idxarr.data_ptr(), win.nb, win.block,
        win.refpack.shape[1], win.window, chunk, num_points,
        seed & 0xFFFFFFFF, int(priority == "distance"), b0, b1,
        out_i.data_ptr(), out_v.data_ptr(), out_x.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "radius_sample")
    count_launch("radius_sample")
    return out_i, out_v.bool(), out_x


def radius_sample_blocks(win: Window, cen, r2, num_points: int = 256,
                         seed: int = 0, priority: str = "random", *,
                         chunk: int = 2048, b0: int = 0, b1: int | None = None):
    """Sorted-order samples of query blocks [b0, b1) — the CUDA kernel on
    the card, the plain version on the CPU. Callers that only need a
    range of blocks at a time (the DIPs sampler) never hold the
    whole-cloud (n, P, 3) output."""
    if priority not in ("random", "distance"):
        raise ValueError(f"unknown priority {priority!r}")
    b1 = win.nb if b1 is None else b1
    if win.qpos.is_cuda:
        return _radius_sample_cuda(
            win, cen, r2, num_points, seed, priority, chunk=chunk, b0=b0, b1=b1
        )
    return radius_sample_plain(
        win, cen, r2, num_points, seed, priority, chunk=chunk,
        blocks=range(b0, b1),
    )


def radius_sample_window(query, grid, radius, num_points: int = 256,
                         seed: int = 0, *, block: int = 512,
                         window: int = 32768, chunk: int = 2048,
                         priority: str = "random"):
    """Up to ``num_points`` in-radius references per query (the query
    point itself excluded): ((n, P) idx, (n, P) bool valid, (n, P, 3)
    xyz, () overflow). ``radius`` is a runtime value. The scan window is
    fitted to the largest block's (module docstring; ``window`` is the
    least it scans), so the overflow count is 0."""
    if num_points % _LANES:
        raise ValueError(f"num_points must be a multiple of {_LANES}")
    if window % chunk:
        raise ValueError("window must be a multiple of chunk")
    n = query.shape[0]
    win = window_prologue(query, grid, block, window, fit_chunk=chunk)
    r2 = torch.as_tensor(radius, dtype=torch.float32, device=query.device) ** 2
    i, v, x = radius_sample_blocks(
        win, block_centres(win), r2, num_points, seed, priority, chunk=chunk
    )
    dev = query.device
    i_out = torch.zeros((n, num_points), dtype=torch.int32, device=dev)
    v_out = torch.zeros((n, num_points), dtype=torch.bool, device=dev)
    x_out = torch.zeros((n, num_points, 3), dtype=torch.float32, device=dev)
    i_out[win.qorder] = i[:n]
    v_out[win.qorder] = v[:n]
    x_out[win.qorder] = x[:n]
    return i_out, v_out, x_out, win.overflow
