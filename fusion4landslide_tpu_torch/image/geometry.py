"""Pinhole camera geometry for the RGB 2D-match channel.

Port of ``fusion4landslide_tpu.image.geometry`` (reference
src/coarse_to_fine_matching_base.py): ``project_points`` (base:1353-1426,
v flipped as ``h - v``), ``rasterize_depth`` (the z-buffer of
base:1436-1443 as a scatter-min), ``lift_pixels_to_world``
(base:664-728) and ``bilinear_depth`` (base:320-384), and the host
fusion tile's ``lift_matches_to_3d`` (depth lookup at both endpoints of
each pixel match) and ``chain_2d_matches_to_3d`` (base:387-470: pixel
matches chained to projected points by exact brute-force 2-d 1-NN, as the
JAX host path searches; the device step chains through kernel 2 in
``pipelines.fusion_device``). Plain tensor code on the inputs' device;
the 3x3 products are written out term by term, so no TF32 matmul path can
touch them.
"""

from __future__ import annotations

import torch

from fusion4landslide_tpu_torch.ops.knn import nn1_xla_rounded

__all__ = [
    "bilinear_depth",
    "chain_2d_matches_to_3d",
    "lift_matches_to_3d",
    "lift_pixels_to_world",
    "project_points",
    "rasterize_depth",
]


def _apply(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(n, 3) rows M p, summed in index order in float32."""
    out = p[:, 0:1] * M[:, 0]
    out = out + p[:, 1:2] * M[:, 1]
    return out + p[:, 2:3] * M[:, 2]


def project_points(points, extrinsic, intrinsic, image_size: tuple[int, int], *,
                   mask=None, v_flip: bool = True):
    """Project (n, 3) world points through a (4, 4) or (3, 4) world->camera
    ``extrinsic`` and (3, 3) ``intrinsic`` into an image of ``image_size``
    = (height, width). Returns ((n, 2) pixel (u, v), (n,) camera z, (n,)
    valid: in front of the camera and strictly inside the image)."""
    h, w = image_size
    points = points.to(torch.float32)
    E = extrinsic.to(torch.float32)
    K = intrinsic.to(torch.float32)
    cam = _apply(E[:3, :3], points) + E[:3, 3]
    pix = _apply(K, cam)
    z = pix[:, 2]
    safe_z = torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))
    u = pix[:, 0] / safe_z
    v = pix[:, 1] / safe_z
    if v_flip:
        v = h - v
    valid = (z > 0) & (u > 0) & (u < w) & (v > 0) & (v < h)
    if mask is not None:
        valid = valid & mask.to(torch.bool)
    return torch.stack([u, v], dim=1), cam[:, 2], valid


def _pixel_index(c: torch.Tensor, size: int) -> torch.Tensor:
    """Truncated int32 pixel index clipped to [0, size - 1] (clamped in
    float first, so a coordinate far outside saturates instead of
    overflowing int32)."""
    c = torch.clamp(c, -1.0, float(size))
    return torch.clamp(c.to(torch.int32), 0, size - 1)


def rasterize_depth(uv, depth, valid, image_size: tuple[int, int]):
    """Z-buffer of projected points: ((h, w) depth map, -1 where empty;
    (h, w) int32 index of the winning point, -1 where empty). A pixel's
    winners are the points whose depth equals its minimum; the largest
    row index among them is kept."""
    h, w = image_size
    dev = uv.device
    flat = (_pixel_index(uv[:, 1], h) * w + _pixel_index(uv[:, 0], w)).long()
    d = torch.where(valid.to(torch.bool), depth, torch.inf)
    dmap = torch.full((h * w,), torch.inf, dtype=depth.dtype, device=dev)
    dmap = dmap.scatter_reduce(0, flat, d, "amin")
    winner = dmap[flat] == d
    rows = torch.arange(uv.shape[0], dtype=torch.int32, device=dev)
    imap = torch.full((h * w,), -1, dtype=torch.int32, device=dev)
    imap = imap.scatter_reduce(
        0, torch.where(winner, flat, h * w - 1), torch.where(winner, rows, -1), "amax"
    )
    dmap = torch.where(torch.isfinite(dmap), dmap, -1.0)
    return dmap.view(h, w), imap.view(h, w)


def lift_pixels_to_world(uv, depth, extrinsic, intrinsic, image_size: tuple[int, int],
                         *, v_flip: bool = True):
    """Back-project pixels with known depth to (n, 3) world coordinates:
    K^-1 (u, v, 1) z, then the inverse of the world->camera extrinsic."""
    h, _ = image_size
    E = extrinsic.to(torch.float32)
    v = h - uv[:, 1] if v_flip else uv[:, 1]
    pix_h = torch.stack([uv[:, 0], v, torch.ones_like(depth)], dim=1) * depth[:, None]
    cam = _apply(torch.linalg.inv(intrinsic.to(torch.float32)), pix_h)
    return _apply(E[:3, :3].T, cam - E[:3, 3])


def bilinear_depth(depth_map, uv, *, bilinear: bool = False):
    """Depth at sub-pixel coordinates: the floor pixel's depth
    (``bilinear=False``, the reference's executed 'single_closest' path)
    or the 4-corner interpolation, valid only where every corner has
    depth. Returns ((n,) depth, (n,) valid)."""
    h, w = depth_map.shape
    u, v = uv[:, 0], uv[:, 1]
    u0 = _pixel_index(torch.floor(u), w).long()
    v0 = _pixel_index(torch.floor(v), h).long()
    if not bilinear:
        d = depth_map[v0, u0]
        return d, d >= 0
    u1 = torch.clamp(u0 + 1, 0, w - 1)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    d00, d10 = depth_map[v0, u0], depth_map[v0, u1]
    d01, d11 = depth_map[v1, u0], depth_map[v1, u1]
    valid = (d00 >= 0) & (d10 >= 0) & (d01 >= 0) & (d11 >= 0)
    du = u - u0
    dv = v - v0
    d = d00 * (1 - du) * (1 - dv) + d10 * du * (1 - dv) + d01 * (1 - du) * dv + d11 * du * dv
    return d, valid


def lift_matches_to_3d(corres_2d, depth_map_src, depth_map_tgt, src_extrinsic, tgt_extrinsic,
                       intrinsic, image_size: tuple[int, int], *, v_flip: bool = True):
    """Lift (M, 4) pixel matches [src_u, src_v, tgt_u, tgt_v] to 3D world
    pairs through each side's depth map (``lift_2d_to_3d_with_interpolation``,
    base:664-728). Returns ((M, 6) [src_xyz tgt_xyz], (M,) valid)."""
    d_src, ok_s = bilinear_depth(depth_map_src, corres_2d[:, :2])
    d_tgt, ok_t = bilinear_depth(depth_map_tgt, corres_2d[:, 2:4])
    src_3d = lift_pixels_to_world(corres_2d[:, :2], d_src, src_extrinsic, intrinsic,
                                  image_size, v_flip=v_flip)
    tgt_3d = lift_pixels_to_world(corres_2d[:, 2:4], d_tgt, tgt_extrinsic, intrinsic,
                                  image_size, v_flip=v_flip)
    return torch.cat([src_3d, tgt_3d], dim=1), ok_s & ok_t


def chain_2d_matches_to_3d(corres_2d, src_proj_uv, tgt_proj_uv, pixel_thres, corres_mask=None,
                           src_valid=None, tgt_valid=None, *, mode: str = "nn_src_only"):
    """3D point correspondences from (M, 4) pixel matches (base:387-470).

    Forward chain, per projected source point: the nearest match's source
    endpoint within ``pixel_thres`` -> that match's target endpoint -> the
    nearest projected target point within ``pixel_thres``. ``mode``
    (``matches_from_2d_type``, base:1599-1620): 'nn_src_only' keeps the
    forward chain; 'nn_mutual' keeps source point n iff the reverse chain
    (per target point, the same two hops backwards) is valid at its
    forward target i and maps i back to n; 'nn_union' keeps it iff
    (forward valid or reverse valid at i) and the reverse chain maps i
    back to n. Returns ((Ns,) target index int32, (Ns,) valid)."""
    if mode not in ("nn_src_only", "nn_mutual", "nn_union"):
        raise ValueError(
            f"unknown matches_from_2d_type mode {mode!r} (nn_src_only | nn_mutual | nn_union)"
        )
    thr2 = torch.as_tensor(pixel_thres, dtype=torch.float32, device=corres_2d.device) ** 2

    def hop(query, ref, ref_mask):
        d, idx = nn1_xla_rounded(query, ref, ref_mask)
        return idx.long(), torch.isfinite(d) & (d < thr2)

    m_idx, hop1 = hop(src_proj_uv, corres_2d[:, :2], corres_mask)
    t_idx, hop2 = hop(corres_2d[m_idx, 2:4], tgt_proj_uv, tgt_valid)
    mask_src = hop1 & hop2
    if src_valid is not None:
        mask_src = mask_src & src_valid.to(torch.bool)
    if mode == "nn_src_only":
        return t_idx.to(torch.int32), mask_src
    m_idx_r, hop1r = hop(tgt_proj_uv, corres_2d[:, 2:4], corres_mask)
    s_idx, hop2r = hop(corres_2d[m_idx_r, :2], src_proj_uv, src_valid)
    mask_tgt = hop1r & hop2r
    if tgt_valid is not None:
        mask_tgt = mask_tgt & tgt_valid.to(torch.bool)
    back = s_idx[t_idx] == torch.arange(src_proj_uv.shape[0], device=s_idx.device)
    if mode == "nn_mutual":
        valid = mask_src & mask_tgt[t_idx] & back
    else:
        valid = (mask_src | mask_tgt[t_idx]) & back
    return t_idx.to(torch.int32), valid
