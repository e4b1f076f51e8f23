"""The median resolution of a cloud: the median, over its points, of the
distance to the nearest other point, in float64 by brute force over the
points in a slab of the x-sorted cloud. The slab's half-width is ten
times the mean spacing of the cloud's bounding box; a point with no
other point that near counts as farther, so the median is exact unless
more than half the points are that isolated (then it reads inf).
``tf32``: the distances formed as |q|^2 - 2 q.r + |r|^2 with the product
in TF32 (the control)."""

from __future__ import annotations

import torch

from reference.precision import sqdist


def median_nn(points: torch.Tensor, *, tf32: bool = False, block: int = 2048) -> float:
    p = points.double()
    n = p.shape[0]
    ext = (p.max(dim=0).values - p.min(dim=0).values).cpu()
    bound = 10.0 * float(torch.sqrt(torch.clamp(ext[0] * ext[1], min=1e-18) / max(n, 1)))
    order = torch.argsort(p[:, 0])
    ps = p[order]
    xs = ps[:, 0].contiguous()
    nn2 = torch.empty(n, dtype=torch.float64, device=p.device)
    for q0 in range(0, n, block):
        q = ps[q0:q0 + block]
        lo = int(torch.searchsorted(xs, q[0, 0] - bound))
        hi = int(torch.searchsorted(xs, q[-1, 0] + bound, right=True))
        if tf32:
            d2 = sqdist(q, ps[lo:hi], True).double()
        else:
            d2 = None
            for d in range(3):
                c = q[:, None, d] - ps[None, lo:hi, d]
                d2 = c * c if d2 is None else d2 + c * c
        own = torch.arange(q0, q0 + q.shape[0], device=p.device)[:, None] - lo
        d2.scatter_(1, own, torch.inf)
        nn2[q0:q0 + q.shape[0]] = d2.min(dim=1).values
    nn2 = torch.where(nn2 <= bound * bound, nn2, torch.inf)
    s = torch.sort(torch.sqrt(nn2)).values
    return float(0.5 * (s[(n - 1) // 2] + s[n // 2]))
