"""Agreement rules for the grid-window kernels, shared by the parity tests
and ``chip_smoke.py``.

Exact agreement is expected except where rounding can legitimately flip a
decision between two implementations (a different summation order of a
block mean or a dot product): near-ties between neighbouring kNN
distances, and sampler candidates whose squared distance lies within
``rel`` * r^2 of the radius or of the self-exclusion threshold (plus
near-ties of d^2 in ``'distance'`` mode).
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.hashgrid_cuda import Window, _scan_len

__all__ = ["knn_agreement", "sample_agreement", "sampler_borderline_rows"]

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
