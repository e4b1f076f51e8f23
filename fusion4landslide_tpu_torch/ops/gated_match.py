"""Magnitude-gated feature-space 1-NN with spatial banding.

Port of ``fusion4landslide_tpu.ops.gated_match.gated_feature_nn1``: both
clouds are sorted (stable) by a (y-band, x) key with band height >=
``max_magnitude``, so each query block's admissible targets form one
contiguous range of the sorted targets (``searchsorted``); the range is
streamed in fixed-size chunks with a running min. Gate-then-search: a
query gets its best in-gate candidate.
"""

from __future__ import annotations

import torch

__all__ = ["gated_feature_nn1"]


def gated_feature_nn1(query_feat, ref_feat, query_xyz, ref_xyz, max_magnitude,
                      query_valid=None, ref_valid=None, *,
                      query_block: int = 1024, chunk: int = 8192,
                      n_bands: int = 48):
    """Feature-space 1-NN among targets within ``max_magnitude``:
    (sqdist (N,), idx (N,), valid (N,))."""
    f32 = query_xyz.dtype
    dev = query_xyz.device
    N, D = query_feat.shape
    M = ref_feat.shape[0]
    qv = (
        torch.ones((N,), dtype=torch.bool, device=dev)
        if query_valid is None
        else query_valid.to(torch.bool)
    )
    rv = (
        torch.ones((M,), dtype=torch.bool, device=dev)
        if ref_valid is None
        else ref_valid.to(torch.bool)
    )
    mm = torch.as_tensor(max_magnitude, dtype=f32, device=dev)
    mm2 = mm * mm
    chunk = min(chunk, M)
    query_block = min(query_block, N)
    big = torch.tensor(3e38, dtype=f32, device=dev)

    def mmin(v, ok):
        return torch.where(ok, v, big).min()

    def mmax(v, ok):
        return torch.where(ok, v, -big).max()

    ylo = torch.minimum(mmin(query_xyz[:, 1], qv), mmin(ref_xyz[:, 1], rv))
    yhi = torch.maximum(mmax(query_xyz[:, 1], qv), mmax(ref_xyz[:, 1], rv))
    xlo = torch.minimum(mmin(query_xyz[:, 0], qv), mmin(ref_xyz[:, 0], rv))
    xhi = torch.maximum(mmax(query_xyz[:, 0], qv), mmax(ref_xyz[:, 0], rv))
    band_h = torch.maximum(mm, (yhi - ylo) / float(n_bands))
    band_h = torch.clamp(band_h, min=1e-6)
    x_span = (xhi - xlo) + 2.0 * mm + 2.0

    def band_of(y):
        return torch.floor((y - ylo) / band_h)

    def key_of(x, y, valid):
        return torch.where(valid, band_of(y) * x_span + (x - xlo + mm + 1.0), big)

    kr = key_of(ref_xyz[:, 0], ref_xyz[:, 1], rv)
    kr_s, rord = torch.sort(kr, stable=True)
    rf_s, rx_s, rv_s = ref_feat[rord], ref_xyz[rord], rv[rord]
    r2_s = (rf_s * rf_s).sum(-1)
    kq = key_of(query_xyz[:, 0], query_xyz[:, 1], qv)
    qord = torch.sort(kq, stable=True).indices
    qf_s, qx_s, qv_s = query_feat[qord], query_xyz[qord], qv[qord]

    nb = -(-N // query_block)
    pad = nb * query_block - N
    # Per block: admissible range [start, end) of the sorted targets
    # (padded query rows are invalid and never widen it).
    qxb = torch.cat([qx_s, qx_s.new_zeros((pad, 3))]).view(nb, query_block, 3)
    qvb = torch.cat([qv_s, qv_s.new_zeros((pad,))]).view(nb, query_block)
    has = qvb.any(dim=1)
    ymin = torch.where(qvb, qxb[..., 1], big).amin(1)
    ymax = torch.where(qvb, qxb[..., 1], -big).amax(1)
    x_min = torch.where(qvb, qxb[..., 0], big).amin(1) - mm
    x_max = torch.where(qvb, qxb[..., 0], -big).amax(1) + mm
    k_lo = (band_of(ymin) - 1.0) * x_span + (x_min - xlo + mm + 1.0)
    k_hi = (band_of(ymax) + 1.0) * x_span + (x_max - xlo + mm + 1.0)
    starts = torch.searchsorted(kr_s, torch.where(has, k_lo, big)).tolist()
    ends = torch.searchsorted(kr_s, torch.where(has, k_hi, -big), right=True).tolist()

    bd = torch.full((nb * query_block,), torch.inf, dtype=f32, device=dev)
    bi = torch.zeros((nb * query_block,), dtype=torch.int64, device=dev)
    for b in range(nb):
        sl = slice(b * query_block, min((b + 1) * query_block, N))
        qfb, qxb, qvb = qf_s[sl], qx_s[sl], qv_s[sl]
        q2 = (qfb * qfb).sum(-1)
        best_d = torch.full((qfb.shape[0],), torch.inf, dtype=f32, device=dev)
        best_i = torch.zeros((qfb.shape[0],), dtype=torch.int64, device=dev)
        start, end = starts[b], ends[b]
        off = start
        while off < end:
            o = min(max(off, 0), M - chunk)
            rows = slice(o, o + chunk)
            pos = torch.arange(o, o + chunk, device=dev)
            ok = rv_s[rows] & (pos >= start) & (pos < end)
            f2 = q2[:, None] - 2.0 * (qfb @ rf_s[rows].T) + r2_s[rows][None, :]
            c2 = None
            for d in range(3):
                cd = qxb[:, None, d] - rx_s[rows][None, :, d]
                c2 = cd * cd if c2 is None else c2 + cd * cd
            bad = ~ok[None, :] | (c2 > mm2) | ~qvb[:, None]
            dist = torch.where(bad, torch.inf, torch.clamp(f2, min=0.0))
            mnew, anew = dist.min(dim=1)
            upd = mnew < best_d
            best_d = torch.where(upd, mnew, best_d)
            best_i = torch.where(upd, pos[anew], best_i)
            off += chunk
        bd[sl] = best_d
        bi[sl] = best_i
    bd, bi = bd[:N], bi[:N]
    found = torch.isfinite(bd)
    idx_sorted_order = rord[torch.clamp(bi, 0, M - 1)]
    sqd = torch.full((N,), torch.inf, dtype=f32, device=dev)
    sqd[qord] = bd
    idx = torch.zeros((N,), dtype=torch.int32, device=dev)
    idx[qord] = torch.where(found, idx_sorted_order, 0).to(torch.int32)
    valid = torch.zeros((N,), dtype=torch.bool, device=dev)
    valid[qord] = found & qv[qord]
    return sqd, idx, valid
