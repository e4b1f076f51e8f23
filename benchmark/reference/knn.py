"""Nearest-neighbour answers by brute force in blocks: exact, or with the
distance products in TF32 (the control)."""

from __future__ import annotations

import torch

from reference.precision import sqdist


def nearest(q: torch.Tensor, r: torch.Tensor, *, tf32: bool = False, gate=None,
            block: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """((q,) index of each query's nearest reference, (q,) found), where
    ``gate`` (qx, rx, max_magnitude) admits only references within that
    3-d distance of the query."""
    idx, found = [], []
    for i in range(0, q.shape[0], block):
        d = sqdist(q[i:i + block], r, tf32)
        if gate is not None:
            qx, rx, mm = gate
            c2 = sqdist(qx[i:i + block], rx, False)
            d = torch.where(c2 <= float(mm) ** 2, d, torch.inf)
        v, j = d.min(dim=1)
        idx.append(j)
        found.append(torch.isfinite(v))
    return torch.cat(idx), torch.cat(found)


def choice_gap(q: torch.Tensor, r: torch.Tensor, choice: torch.Tensor, chosen: torch.Tensor,
               *, gate=None, block: int = 512) -> torch.Tensor:
    """(q,) how far each query's chosen reference lies above its exact
    nearest one, as a squared distance (>= 0). With a ``gate``, a choice
    outside it, or no choice where a reference lies inside it by more
    than 1e-6 relative, reads inf; a reference within 1e-6 of the gate's
    edge may be taken or left."""
    out = []
    for i in range(0, q.shape[0], block):
        sl = slice(i, i + block)
        d = sqdist(q[sl], r, False)
        ch = choice[sl].long()
        ok = chosen[sl].bool()
        d_ch = ((q[sl].double() - r[ch].double()) ** 2).sum(-1)
        if gate is None:
            out.append(torch.where(ok, torch.clamp(d_ch - d.min(dim=1).values, min=0.0),
                                   torch.inf))
            continue
        qx, rx, mm = gate
        mm2 = float(mm) ** 2
        c2 = sqdist(qx[sl], rx, False)
        best = torch.where(c2 <= mm2 * (1 - 1e-6), d, torch.inf).min(dim=1).values
        c_ch = ((qx[sl].double() - rx[ch].double()) ** 2).sum(-1)
        gap = torch.clamp(d_ch - best, min=0.0)
        gap = torch.where(ok & (c_ch > mm2 * (1 + 1e-6)), torch.inf, gap)
        gap = torch.where(~ok, torch.where(torch.isfinite(best), torch.inf, 0.0), gap)
        out.append(gap)
    return torch.cat(out)


def _gated(fs, cs, vs, ft, ct, vt, mm, tf32, slack):
    d = sqdist(fs, ft, tf32)
    c2 = sqdist(cs, ct, tf32)
    ok = (c2 <= float(mm) ** 2 * (1 + slack)) & vs.bool()[:, None] & vt.bool()[None, :]
    return d, torch.where(ok, d, torch.inf)


def mutual_nearest(fs, cs, vs, ft, ct, vt, mm, *, tf32: bool = False):
    """Superpoint matching: each valid source superpoint's nearest valid
    target by feature distance among those whose centroids lie within
    ``mm``, kept where that target's nearest source is it: ((S,) target,
    (S,) matched)."""
    _, D = _gated(fs, cs, vs, ft, ct, vt, mm, tf32, 0.0)
    best, j = D.min(dim=1)
    back = D.argmin(dim=0)
    return j, torch.isfinite(best) & (back[j] == torch.arange(fs.shape[0], device=fs.device))


def mutual_gap(fs, cs, vs, ft, ct, vt, mm, choice, chosen) -> torch.Tensor:
    """(S,) how far each source superpoint's match lies from the exact
    mutual one, as a squared feature distance. A match: its excess over
    the source's nearest gated target plus its excess over the target's
    nearest gated source (inf where the target is invalid, or outside
    the gate by more than 1e-6 relative). No match where the exact
    nearest pair is mutual: the smaller of the two margins by which that
    pair beats the runners-up (a near tie may go either way). An invalid
    source matched reads inf."""
    d, D = _gated(fs, cs, vs, ft, ct, vt, mm, False, -1e-6)
    _, D_loose = _gated(fs, cs, vs, ft, ct, vt, mm, False, 1e-6)
    S = fs.shape[0]
    ar = torch.arange(S, device=fs.device)
    fwd = torch.topk(D, min(2, D.shape[1]), dim=1, largest=False)
    rev = torch.topk(D, min(2, D.shape[0]), dim=0, largest=False)
    ch = choice.long()
    chosen = chosen.bool()
    d_ch = d[ar, ch]
    hit = torch.clamp(d_ch - fwd.values[:, 0], min=0.0) + torch.clamp(
        d_ch - rev.values[0, ch], min=0.0)
    hit = torch.where(torch.isfinite(D_loose[ar, ch]), hit, torch.inf)

    def margin(v):
        return (v[..., 1] - v[..., 0]) if v.shape[-1] > 1 else torch.full_like(v[..., 0],
                                                                               torch.inf)
    j = fwd.indices[:, 0]
    mutual = torch.isfinite(fwd.values[:, 0]) & (rev.indices[0, j] == ar)
    m_f = margin(fwd.values)
    m_r = margin(rev.values.T)[j]
    miss = torch.where(mutual, torch.minimum(m_f, m_r), 0.0)
    miss = torch.where(torch.isfinite(miss), miss, 1e30)
    gap = torch.where(chosen, hit, miss)
    return torch.where(vs.bool(), gap, torch.where(chosen, torch.inf, 0.0))
