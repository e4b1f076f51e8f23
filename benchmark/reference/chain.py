"""Pixel chaining of 2-D matches to 3-D voxel matches (the fusion method's
``nn_search`` lifting, forward mode ``nn_src_only``), in float64: both
voxel clouds are projected through the pinhole camera (v flipped, as the
dataset stores images); a source voxel takes the pixel match whose
source end lies nearest its projection, then the target voxel whose
projection lies nearest that match's target end among those inside the
image; the chain holds where both hops are shorter than ``pixel_thres``.
"""

from __future__ import annotations

import torch

from reference.precision import round_tf32, sqdist

#: Projections within this many pixels of the image's border may fall on
#: either side of it by rounding: such source voxels are not judged.
EDGE_PX = 0.01


def project(points: torch.Tensor, K, E, image_size, *, tf32: bool = False):
    """((n, 2) pixels, (n,) signed distance in pixels to the image's
    border, positive inside; -inf behind the camera). ``tf32``: the
    products with TF32 operands (the control)."""
    h, w = image_size
    dt = torch.float32 if tf32 else torch.float64
    p, K, E = points.to(dt), K.to(dt), E.to(dt)

    def mul(a, b):
        return (round_tf32(a) @ round_tf32(b)).to(dt) if tf32 else a @ b

    cam = mul(p, E[:3, :3].T) + E[:3, 3]
    pix = mul(cam, K.T)
    z = pix[:, 2]
    u = pix[:, 0] / z
    v = h - pix[:, 1] / z
    edge = torch.minimum(torch.minimum(u, w - u), torch.minimum(v, h - v))
    edge = torch.where(z > 0, edge, -torch.inf)
    return torch.stack([u, v], dim=1).double(), edge.double()


def chain(uv_s, uv_t, edge_t, ends, thr: float, rows, *, tf32: bool = False,
          block: int = 256):
    """The chain of source voxels ``rows``: ((k,) target voxel, (k,)
    valid), every distance formed by ``sqdist`` (TF32 products with
    ``tf32``: the control)."""
    inside = edge_t > 0
    tgt_ids = torch.nonzero(inside).squeeze(1)
    idx, ok = [], []
    for i in range(0, rows.shape[0], block):
        q = uv_s[rows[i:i + block]]
        h1, m = sqdist(q, ends[:, :2], tf32).min(dim=1)
        h2, j = sqdist(ends[m, 2:], uv_t[tgt_ids], tf32).min(dim=1)
        idx.append(tgt_ids[j])
        ok.append((h1 < thr * thr) & (h2 < thr * thr))
    return torch.cat(idx), torch.cat(ok)


def chain_gap(uv_s, edge_s, uv_t, edge_t, ends, thr: float, rows, t_choice, valid,
              *, block: int = 256) -> torch.Tensor:
    """(k,) how far each judged source voxel's chain lies from an exact
    one, in squared pixels. For a chain that holds: the least, over pixel
    matches whose source end lies within ``thr`` + 1 px, of the match's
    excess over the nearest source end plus the chosen target's excess
    over the nearest target to that match's target end, plus whatever of
    either hop reaches past ``thr``^2 (inf where no match is that near, or
    the chosen target lies outside the image). For a chain that does not
    hold: the least, over the same matches, of the excess plus how far
    inside ``thr``^2 both hops through that match would have stayed (0
    where no match is near). A voxel projected outside the image reads 0
    if not chained and inf if chained; one within ``EDGE_PX`` of the
    border reads 0."""
    thr2 = thr * thr
    ring2 = (thr + 1.0) ** 2
    inside_t = edge_t > 0
    uv_in = uv_t[inside_t]
    out = torch.zeros(rows.shape[0], dtype=torch.float64, device=uv_s.device)
    for i in range(0, rows.shape[0], block):
        r = rows[i:i + block]
        h1 = sqdist(uv_s[r], ends[:, :2], False)
        d1 = h1.min(dim=1).values
        bi, mi = torch.nonzero(h1 < ring2, as_tuple=True)
        d2 = torch.cat([sqdist(ends[mi[c:c + 256], 2:], uv_in, False).min(dim=1).values
                        for c in range(0, mi.shape[0], 256)]) if mi.numel() else d1[:0]
        tc = t_choice[i:i + block].long()
        h2 = ((uv_t[tc[bi]] - ends[mi, 2:]) ** 2).sum(-1)
        ex1 = h1[bi, mi] - d1[bi]
        held = valid[i:i + block].bool()
        term = torch.where(
            held[bi],
            ex1 + (h2 - d2) + torch.relu(h1[bi, mi] - thr2) + torch.relu(h2 - thr2),
            ex1 + torch.relu(torch.minimum(thr2 - h1[bi, mi], thr2 - d2)))
        best = torch.full((r.shape[0],), torch.inf, dtype=torch.float64, device=r.device)
        best = best.scatter_reduce(0, bi, term, reduce="amin")
        gap = torch.where(held, best, torch.where(torch.isfinite(best), best, 0.0))
        gap = torch.where(held & (edge_t[tc] < -EDGE_PX), torch.inf, gap)
        outside = edge_s[r] <= 0
        gap = torch.where(outside, torch.where(held, torch.inf, 0.0), gap)
        gap = torch.where(edge_s[r].abs() < EDGE_PX, 0.0, gap)
        out[i:i + block] = gap
    return out
