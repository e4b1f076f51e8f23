"""DIPs descriptors of single query points, in float64.

The patch of a query is drawn from the support cloud as the program's
documented sampler draws it: the support points are ordered by a uniform
grid of cell edge ``radius`` (grown by 1.5x until the grid has fewer than
2^21 cells; points sorted stably by linear cell id), each point's lane is
its place in that order modulo 128, and every lane keeps the two points of
smallest hash priority (ties to the earlier place) among the support
points within ``radius`` of the query, the query itself excluded (squared
distance above 1e-6 r^2). Slot ``layer * 128 + lane`` holds them; empty
slots are zero points. The patch is then expressed in the DIP local
reference frame (Poiesi & Boscaini 2021) and fed to the PointNet with a
T-net (3->256->512->1024, max-pool, 1024->512->256->64, L2-normalised).
"""

from __future__ import annotations

import torch

from reference.precision import round_tf32, sqdist

LANES = 128
MAX_CELLS = 1 << 21


def hash_priority(idx: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """24-bit integer priority of each support index (lower is drawn first)."""
    mask = 0xFFFFFFFF
    x = (idx.to(torch.int64) & mask) * 2654435761 + (seed & mask)
    x = x & mask
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & mask
    x = x ^ (x >> 16)
    return x >> 8


def grid_order(support: torch.Tensor, radius32: torch.Tensor) -> torch.Tensor:
    """(m,) int64 place of each support point in the grid order, with the
    cell arithmetic in float32 (cell membership is discrete: it has to be
    the float32 one)."""
    pts = support.to(torch.float32)
    origin = pts.min(dim=0).values
    extent = torch.clamp(pts.max(dim=0).values - origin, min=0.0).cpu()
    cell = radius32.to(torch.float32).cpu()
    while float(torch.prod(torch.floor(extent / cell) + 1.0)) > MAX_CELLS - 1:
        cell = cell * 1.5
    cell = cell.to(pts.device)
    dims = (torch.floor(extent.to(pts.device) / cell) + 1).to(torch.int64)
    cells = torch.floor((pts - origin) / cell).to(torch.int64)
    cells = torch.minimum(torch.clamp(cells, min=0), dims - 1)
    linear = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    order = torch.sort(linear, stable=True).indices
    place = torch.empty_like(order)
    place[order] = torch.arange(order.numel(), device=order.device)
    return place


def sample_patches(queries: torch.Tensor, support: torch.Tensor, radius32: torch.Tensor,
                   num_points: int = 256, block: int = 256):
    """((q, P, 3) float64 neighbour coordinates, (q, P) valid) of each
    query's patch (module docstring)."""
    dev = queries.device
    layers = num_points // LANES
    place = grid_order(support, radius32)
    m = support.shape[0]
    m_pad = max(-(-m // LANES), layers) * LANES
    # Support points laid out by grid place, padded to whole lanes.
    by_place = torch.empty(m, dtype=torch.int64, device=dev)
    by_place[place] = torch.arange(m, device=dev)
    sup64 = support.to(torch.float64)
    pts_p = torch.zeros((m_pad, 3), dtype=torch.float64, device=dev)
    pts_p[:m] = sup64[by_place]
    pri = torch.full((m_pad,), 1 << 40, dtype=torch.int64, device=dev)
    pri[:m] = hash_priority(by_place)
    key0 = pri * (m_pad // LANES + 1) + torch.arange(m_pad, device=dev) // LANES
    r32 = radius32.to(torch.float32)
    r2 = float(r32 * r32)  # squared in float32, as the radius test is
    big = torch.iinfo(torch.int64).max
    outs, oks = [], []
    for q0 in range(0, queries.shape[0], block):
        q = queries[q0:q0 + block].to(torch.float64)
        d2 = sqdist(q, pts_p, False)
        ok = (d2 <= r2) & (d2 > r2 * 1e-6)
        ok[:, m:] = False
        key = torch.where(ok, key0[None], big).view(q.shape[0], m_pad // LANES, LANES)
        kv, kp = torch.topk(key, layers, dim=1, largest=False, sorted=True)  # (b, layers, 128)
        valid = kv < big
        place_sel = kp * LANES + torch.arange(LANES, device=dev)
        xyz = torch.where(valid[..., None], pts_p[place_sel], 0.0)
        outs.append(xyz.reshape(q.shape[0], num_points, 3))
        oks.append(valid.reshape(q.shape[0], num_points))
    return torch.cat(outs), torch.cat(oks)


def lrf_patches(query: torch.Tensor, neigh: torch.Tensor, valid: torch.Tensor,
                radius: float) -> torch.Tensor:
    """(q, P, 3) patches in each query's DIP local reference frame: z the
    covariance's smallest eigenvector, signed towards the neighbours'
    mean direction; x the in-plane direction weighted by (R - d)^2
    times the squared height; points scaled by 1 / R. Patches of at most
    10 points are only scaled."""
    query = query.to(torch.float64)
    diff = neigh - query[:, None, :]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    w = valid.to(torch.float64)[..., None]
    cnt = torch.clamp(w.sum(dim=1), min=1.0)
    dw = diff * w
    cov = torch.einsum("nki,nkj->nij", dw, dw) / cnt[..., None]
    np_hat = torch.linalg.eigh(cov).eigenvectors[..., :, 0]
    s = torch.einsum("ni,nki->n", np_hat, -dw)
    zp = torch.where((s > 0)[:, None], np_hat, -np_hat)
    proj = torch.einsum("nki,ni->nk", diff, zp)
    v = diff - proj[..., None] * zp[:, None, :]
    alpha = torch.where(valid, (radius - dist) ** 2, 0.0)
    xp = torch.einsum("nki,nk->ni", v, alpha * proj**2 * w[..., 0])
    xp = xp / (torch.linalg.norm(xp, dim=-1, keepdim=True) + 1e-6)
    yp = torch.linalg.cross(zp, xp)
    lrf = torch.stack([xp, yp, zp], dim=1)
    local = torch.einsum("nij,nkj->nki", lrf, diff) / radius
    sparse = valid.sum(dim=1) <= 10
    patch = torch.where(sparse[:, None, None], neigh / radius, local)
    return torch.where(valid[..., None], patch, 0.0)


def _dense(raw, name, x, tf32: bool):
    w, b = raw[f"{name}.weight"], raw[f"{name}.bias"]
    if tf32:  # the control: TF32 operands, float32 accumulation
        return (round_tf32(x) @ round_tf32(w).T).to(x.dtype) + b.to(x.dtype)
    return torch.matmul(x, w.to(x.dtype).T) + b.to(x.dtype)


def _bn(raw, name, x):
    g = raw[f"{name}.scale"].to(x.dtype)
    return g * (x - raw[f"{name}.mean"].to(x.dtype)) / torch.sqrt(
        raw[f"{name}.var"].to(x.dtype) + 1e-5) + raw[f"{name}.bias"].to(x.dtype)


def _trunk(raw, p, x, tf32):
    x = torch.relu(_bn(raw, f"{p}.bn1", _dense(raw, f"{p}.conv1", x, tf32)))
    x = torch.relu(_bn(raw, f"{p}.bn2", _dense(raw, f"{p}.conv2", x, tf32)))
    x = _bn(raw, f"{p}.bn3", _dense(raw, f"{p}.conv3", x, tf32)).amax(dim=-2)
    x = torch.relu(_bn(raw, f"{p}.bn4", _dense(raw, f"{p}.fc1", x, tf32)))
    return torch.relu(_bn(raw, f"{p}.bn5", _dense(raw, f"{p}.fc2", x, tf32)))


def pointnet(raw: dict, patches: torch.Tensor, *, tf32: bool = False) -> torch.Tensor:
    """(q, 64) unit descriptors of (q, P, 3) patches. ``tf32``: the dense
    layers in TF32 (the control), else float64 throughout."""
    x = patches.to(torch.float32 if tf32 else torch.float64)
    m = _dense(raw, "stn3d.fc3", _trunk(raw, "stn3d.trunk", x, tf32), tf32)
    trans = m.reshape(*m.shape[:-1], 3, 3) + torch.eye(3, dtype=x.dtype, device=x.device)
    x = torch.einsum("...ij,...nj->...ni", trans, x)
    out = _dense(raw, "fc3", _trunk(raw, "trunk", x, tf32), tf32)
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)


def descriptors(raw: dict, queries: torch.Tensor, support: torch.Tensor, radius: float, *,
                num_points: int = 256, tf32: bool = False, block: int = 128) -> torch.Tensor:
    """(q, 64) float64 DIPs descriptors of ``queries`` with patches from
    ``support`` (the module docstring's sampler, frame and network)."""
    r32 = torch.tensor(radius, dtype=torch.float32)
    neigh, valid = sample_patches(queries, support, r32, num_points, block)
    patches = lrf_patches(queries, neigh, valid, float(r32))
    return torch.cat([pointnet(raw, patches[i:i + block], tf32=tf32)
                      for i in range(0, patches.shape[0], block)]).to(torch.float64)
