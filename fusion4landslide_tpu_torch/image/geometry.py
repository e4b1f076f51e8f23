"""Pinhole camera geometry for the RGB 2D-match channel.

Port of ``fusion4landslide_tpu.image.geometry`` (reference
src/coarse_to_fine_matching_base.py): ``project_points`` (base:1353-1426,
v flipped as ``h - v``), ``rasterize_depth`` (the z-buffer of
base:1436-1443 as a scatter-min), ``lift_pixels_to_world``
(base:664-728) and ``bilinear_depth`` (base:320-384). Plain tensor code
on the inputs' device; the 3x3 products are written out term by term, so
no TF32 matmul path can touch them. The host-path helpers
``lift_matches_to_3d`` and ``chain_2d_matches_to_3d`` are not ported (the
device step chains through ``pipelines.fusion_device``).
"""

from __future__ import annotations

import torch

__all__ = ["bilinear_depth", "lift_pixels_to_world", "project_points", "rasterize_depth"]


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
