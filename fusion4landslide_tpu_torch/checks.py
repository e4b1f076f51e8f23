"""Agreement rules for the grid-window kernels, shared by the parity tests
and ``chip_smoke.py``.

Exact agreement is expected except where rounding can legitimately flip a
decision between two implementations (a different summation order of a
block mean or a dot product): near-ties between neighbouring kNN
distances, and sampler candidates whose squared distance lies within
``rel`` * r^2 of the radius or of the self-exclusion threshold (plus
near-ties of d^2 in ``'distance'`` mode). ``driver_tile_recovery`` reads
the recovery of a planted shift from a driver's written tables;
``partition_differing`` compares two labelings up to relabelling.
"""

from __future__ import annotations

import numpy as np
import torch

from fusion4landslide_tpu_torch.ops.hashgrid_cuda import Window, _scan_len

__all__ = [
    "driver_tile_recovery",
    "partition_differing",
    "knn_agreement",
    "sample_agreement",
    "sampler_borderline_rows",
]

_LANES = 128


def knn_agreement(d_ref, i_ref, d_new, i_new, *, atol: float = 1e-5,
                  rel_gap: float = 1e-5, d_next=None) -> dict:
    """Compare two (n, k) kNN results. ``d_next`` (n,) optionally holds
    the reference's (k+1)-th distance, so a tie at the last slot is
    recognised. Indices must agree wherever the slot's distance is more
    than ``rel_gap * d`` away from its neighbours'."""
    d_ref, d_new = d_ref.double(), d_new.double()
    fin_r, fin_n = torch.isfinite(d_ref), torch.isfinite(d_new)
    both = fin_r & fin_n
    err = (d_ref - d_new).abs()[both]
    inf = torch.full_like(d_ref[:, :1], torch.inf)
    nxt = inf if d_next is None else d_next.double()[:, None]
    ext = torch.cat([-inf, d_ref, nxt], dim=1)
    tol = rel_gap * d_ref.abs()
    amb = ((d_ref - ext[:, :-2]).abs() <= tol) | ((ext[:, 2:] - d_ref).abs() <= tol)
    mism = (i_ref != i_new) & both & ~amb
    return {
        "max_abs_err": float(err.max()) if err.numel() else 0.0,
        "finite_equal": bool((fin_r == fin_n).all()),
        "dist_ok": bool((err <= atol).all()),
        "index_mismatch": int(mism.sum()),
        "ambiguous_slots": int((amb & both).sum()),
    }


def sampler_borderline_rows(win: Window, cen, r2, num_points: int,
                            priority: str, *, chunk: int = 2048,
                            rel: float = 1e-5, blocks=None) -> torch.Tensor:
    """(rows,) bool over the sorted rows of ``blocks``: the query has a
    window candidate whose d^2 lies within ``rel * r^2`` of r^2 or of the
    self threshold 1e-6 r^2; in ``'distance'`` mode also a near-tie
    between consecutive keys among a lane's ``P/128 + 1`` smallest."""
    blocks = range(win.nb) if blocks is None else blocks
    layers = num_points // _LANES
    scans = _scan_len(win.wmeta[1], chunk, win.window).tolist()
    w_los = win.wmeta[0].tolist()
    rp, B, dev = win.refpack, win.block, win.qpos.device
    r2 = torch.as_tensor(r2, dtype=torch.float32, device=dev)
    tol = rel * r2
    out = []
    for b in blocks:
        pos = torch.arange(w_los[b], w_los[b] + scans[b], device=dev)
        q = win.qpos[b * B:(b + 1) * B] - cen[b]
        r = (rp[0:3, pos].T - cen[b])
        d2 = ((q[:, None, :] - r[None]) ** 2).sum(-1)
        live = (rp[3, pos] < torch.inf)[None]
        near = (((d2 - r2).abs() <= tol) | ((d2 - r2 * 1e-6).abs() <= tol)) & live
        flag = near.any(dim=1)
        if priority == "distance" and pos.numel():
            ok = live & (d2 <= r2 + tol) & (d2 > r2 * 1e-6 - tol)
            keyed = torch.where(ok, d2, torch.inf).view(B, -1, _LANES)
            top = torch.sort(keyed, dim=1).values[:, : layers + 1]
            gaps = (top[:, 1:] - top[:, :-1]).abs() <= tol
            flag = flag | (gaps & torch.isfinite(top[:, 1:])).flatten(1).any(1)
        out.append(flag)
    return torch.cat(out)


def sample_agreement(i_ref, v_ref, i_new, v_new, borderline) -> dict:
    """Row-wise comparison of two (rows, P) sampler outputs, slot layout
    included. Rows that differ must be ``borderline``."""
    same = (v_ref == v_new).all(1) & (torch.where(v_ref, i_ref, 0) == torch.where(v_new, i_new, 0)).all(1)
    rows = same.numel()
    return {
        "rows": rows,
        "exact_frac": float(same.double().mean()) if rows else 1.0,
        "unexplained_rows": int((~same & ~borderline).sum()),
    }


def driver_tile_recovery(core_pts: np.ndarray, rows_src: np.ndarray, rows_disp: np.ndarray,
                         moving_y: float, shift: np.ndarray) -> dict:
    """Recovery of a planted shift from one tile's written DVF rows
    (source points ``rows_src``, displacements ``rows_disp``), on the
    tile's core (``core_pts``, its non-overlap points): the fraction of
    the core with a row, of the static core (``y <= moving_y``), the
    median errors on the static (against 0) and the moving (against
    ``shift``) core rows, and the error of each half's median displacement
    vector (``*_vec_err_m``)."""
    lo, hi = core_pts.min(axis=0), core_pts.max(axis=0)
    in_core = np.all((rows_src >= lo) & (rows_src <= hi), axis=1)
    moving = rows_src[:, 1] > moving_y
    err_sta = np.linalg.norm(rows_disp[in_core & ~moving], axis=1)
    err_mov = np.linalg.norm(rows_disp[in_core & moving] - shift, axis=1)
    n_static = int((core_pts[:, 1] <= moving_y).sum())
    sta, mov = rows_disp[in_core & ~moving], rows_disp[in_core & moving]
    return {
        "core_points": int(len(core_pts)),
        "core_assigned": float(in_core.sum()) / max(len(core_pts), 1),
        "static_assigned": float((in_core & ~moving).sum()) / max(n_static, 1),
        "static_err_m": float(np.median(err_sta)) if err_sta.size else None,
        "moving_err_m": float(np.median(err_mov)) if err_mov.size else None,
        "static_vec_err_m": float(np.linalg.norm(np.median(sta, axis=0))) if len(sta) else None,
        "moving_vec_err_m": (float(np.linalg.norm(np.median(mov, axis=0) - shift))
                             if len(mov) else None),
    }


def partition_differing(a: np.ndarray, b: np.ndarray) -> int:
    """Points of two (n,) non-negative labelings outside the majority
    overlap of their regions, the larger of the two counts: 0 iff the
    labelings are equal up to relabelling."""
    pairs, counts = np.unique(np.stack([a, b], 1), axis=0, return_counts=True)
    if len(pairs) == len(np.unique(a)) == len(np.unique(b)):
        return 0
    best_a = np.zeros(int(a.max()) + 1, np.int64)
    np.maximum.at(best_a, pairs[:, 0], counts)
    best_b = np.zeros(int(b.max()) + 1, np.int64)
    np.maximum.at(best_b, pairs[:, 1], counts)
    return int(max(len(a) - best_a.sum(), len(b) - best_b.sum()))
