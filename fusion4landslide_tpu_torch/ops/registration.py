"""Registration solvers beside point-to-point ICP, and the ``icp_type``
dispatch.

Port of ``fusion4landslide_tpu.ops.registration`` (reference
utils/o3d_tools.py):

- ``icp_point2plane``: each iteration solves the linearised 6-DoF normal
  equations of the residual (R p + t - q).n_q (o3d_tools.py:12-71);
- ``icp_generalized``: plane-to-plane ICP (Segal et al.; the reference's
  ``icp_type: generalized_icp``), per-point covariances I - (1 - eps) n n^T
  and one Gauss-Newton step of sum d^T (C_q + R C_p R^T)^-1 d per
  iteration;
- ``colored_icp``: multiscale joint geometric + photometric Gauss-Newton
  (Park et al. 2017, o3d_tools.py:74-128) with tangent-plane colour
  gradients (``color_gradients``);
- ``ransac_registration``: correspondence RANSAC as one batch of 3-point
  hypotheses, the best refitted on its inliers (o3d_tools.py:148-177).
  The drawn ``samples`` are an input; without them they are drawn from a
  ``torch.Generator``, not from JAX's threefry.

The ICP solvers take (B, n, 3) / (B, m, 3) stacks of pairs, as the JAX
functions vmapped over pairs do: a pair that has stopped keeps its state
while the others iterate. The small solves are ``torch.linalg``'s
non-raising ``solve_ex`` / ``inv_ex`` (a singular system gives non-finite
values, which the update rejects, as in the JAX code).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion4landslide_tpu_torch.ops.icp import ICPLoop, ICPResult, icp_point2point, start_pose
from fusion4landslide_tpu_torch.ops.kabsch import transform_points, weighted_kabsch
from fusion4landslide_tpu_torch.ops.knn import knn
from fusion4landslide_tpu_torch.ops.normals import pca_normals

__all__ = [
    "RansacResult",
    "color_gradients",
    "colored_icp",
    "icp_by_type",
    "icp_generalized",
    "icp_point2plane",
    "ransac_registration",
]

#: The reference's ``icp_type`` names (utils/o3d_tools.py:33-56).
_ICP_TYPES = ("point2point", "point2plane", "generalized_icp", "generalized")


def icp_by_type(icp_type: str, src, tgt, max_dist, *, src_mask=None, tgt_mask=None,
                max_iter: int = 30, R_init=None, t_init=None) -> ICPResult:
    """The solver of the reference's ``icp_type`` on (B, n, 3) pairs;
    ``ValueError`` for an unknown name."""
    if icp_type not in _ICP_TYPES:
        raise ValueError(f"unknown icp_type {icp_type!r}; expected one of {_ICP_TYPES}")
    kw = dict(src_mask=src_mask, tgt_mask=tgt_mask, max_iter=max_iter, R_init=R_init,
              t_init=t_init)
    if icp_type == "point2plane":
        return icp_point2plane(src, tgt, max_dist, **kw)
    if icp_type in ("generalized_icp", "generalized"):
        return icp_generalized(src, tgt, max_dist, **kw)
    return icp_point2point(src, tgt, max_dist, **kw)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) cross-product matrices of (..., 3) vectors."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _rodrigues(rx: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) rotation of the (B, 3) axis-angle vectors (the angle
    offset by 1e-12, as the JAX code does)."""
    theta = torch.linalg.norm(rx, dim=-1) + 1e-12
    K = _skew(rx / theta[:, None])
    eye = torch.eye(3, dtype=rx.dtype, device=rx.device)
    return (eye + torch.sin(theta)[:, None, None] * K
            + (1.0 - torch.cos(theta))[:, None, None] * (K @ K))


def _solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, 6) solutions of (B, 6, 6) systems with 1e-6 added on the
    diagonal."""
    A = A + 1e-6 * torch.eye(6, dtype=A.dtype, device=A.device)
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _solve_point2plane(src, tgt, normals, w):
    """One linearised point-to-plane step over (B, n, 3) pairs: minimise
    sum w ((R p + t - q).n)^2 over small rotations (R ~ I + [r]x).
    Returns the update's (R (B, 3, 3), t (B, 3))."""
    J = torch.cat([torch.linalg.cross(src, normals, dim=-1), normals], dim=-1)
    r = ((src - tgt) * normals).sum(-1)
    Jw = J * w[..., None]
    x = _solve6(torch.einsum("bni,bnj->bij", Jw, J), -torch.einsum("bni,bn->bi", Jw, r))
    return _rodrigues(x[:, :3]).to(src.dtype), x[:, 3:].to(src.dtype)


def _finite(R, t):
    """(R, t, ok): an update is taken only where it is finite."""
    return R, t, torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)


def _take(x, idx):
    """Rows ``idx`` (B, n) of (B, m, ...) ``x``."""
    return torch.gather(x, 1, idx.long().reshape(*idx.shape, *([1] * (x.dim() - 2)))
                        .expand(*idx.shape, *x.shape[2:]))


def icp_point2plane(src, tgt, max_dist, src_mask=None, tgt_mask=None, *, tgt_normals=None,
                    max_iter: int = 30, rel_tol: float = 1e-6, normals_k: int = 16,
                    color_weight=None, R_init=None, t_init=None) -> ICPResult:
    """Point-to-plane ICP of (B, n, 3) ``src`` onto (B, m, 3) ``tgt``;
    target normals from their ``normals_k`` nearest neighbours unless
    given. ``color_weight`` (B, m) scales each correspondence's weight by
    its target's value. ``R_init`` / ``t_init`` seed the iteration."""
    loop = ICPLoop(src, tgt, max_dist, src_mask, tgt_mask)
    if tgt_normals is None:
        tgt_normals = pca_normals(tgt, tgt_mask, k=normals_k)

    def step(R, t, idx, inlier):
        w = inlier.to(src.dtype)
        if color_weight is not None:
            w = w * torch.gather(color_weight, 1, idx.long())
        dR, dt = _solve_point2plane(transform_points(src, R, t), _take(tgt, idx),
                                    _take(tgt_normals, idx), w)
        return _finite(dR @ R, torch.einsum("bij,bj->bi", dR, t) + dt)

    return loop.run(step, *start_pose(src, R_init, t_init), max_iter, rel_tol, stop_on_bad=True)


def icp_generalized(src, tgt, max_dist, src_mask=None, tgt_mask=None, *, max_iter: int = 30,
                    rel_tol: float = 1e-6, normals_k: int = 16, epsilon: float = 1e-3,
                    R_init=None, t_init=None) -> ICPResult:
    """Generalized (plane-to-plane) ICP of (B, n, 3) ``src`` onto (B, m,
    3) ``tgt``: covariances I - (1 - ``epsilon``) n n^T from PCA normals
    of ``normals_k`` neighbours; per iteration one Gauss-Newton step over
    (omega, t) of sum d^T (C_q + R C_p R^T)^-1 d."""
    f32 = src.dtype
    eye = torch.eye(3, dtype=f32, device=src.device)
    loop = ICPLoop(src, tgt, max_dist, src_mask, tgt_mask)

    def point_cov(nrm):
        return eye - (1.0 - epsilon) * torch.einsum("...i,...j->...ij", nrm, nrm)

    cov_s = point_cov(pca_normals(src, src_mask, k=normals_k))
    cov_t = point_cov(pca_normals(tgt, tgt_mask, k=normals_k))

    def step(R, t, idx, inlier):
        moved = transform_points(src, R, t)
        RC = torch.einsum("bij,bnjk,blk->bnil", R, cov_s, R)
        M = torch.linalg.inv_ex(_take(cov_t, idx) + RC + 1e-6 * eye)[0]
        M = M * inlier.to(f32)[..., None, None]
        r = moved - _take(tgt, idx)
        Jw = -_skew(moved)  # d r / d omega
        H_ww = torch.einsum("bnij,bnik,bnkl->bjl", Jw, M, Jw)
        H_wt = torch.einsum("bnij,bnik->bjk", Jw, M)
        H_tt = M.sum(1)
        g = torch.cat([torch.einsum("bnij,bnik,bnk->bj", Jw, M, r),
                       torch.einsum("bnik,bnk->bi", M, r)], dim=-1)
        H = torch.cat([torch.cat([H_ww, H_wt], -1),
                       torch.cat([H_wt.transpose(-1, -2), H_tt], -1)], -2)
        x = -_solve6(H, g)
        dR = _rodrigues(x[:, :3])
        return _finite(dR @ R, torch.einsum("bij,bj->bi", dR, t) + x[:, 3:].to(f32))

    return loop.run(step, *start_pose(src, R_init, t_init), max_iter, rel_tol, stop_on_bad=False)


def color_gradients(points, gray, normals, mask=None, *, k: int = 16) -> torch.Tensor:
    """(..., n, 3) in-tangent-plane intensity gradients d with
    C(u) ~ c_q + d.(u - q) near q (Park et al. 2017's precomputation), by
    least squares over the ``k`` nearest other points with the constraint
    row d.n = 0."""
    sqd, idx = knn(points, points, k, mask, exclude_self=True)
    w = torch.isfinite(sqd).to(points.dtype)
    lead = idx.shape[:-2]
    flat = idx.long().reshape(*lead, -1)
    nb = torch.gather(points, -2, flat[..., None].expand(*flat.shape, 3)).reshape(*idx.shape, 3)
    cb = torch.gather(gray, -1, flat).reshape(idx.shape)
    diff = nb - points[..., None, :]
    along = torch.einsum("...ki,...i->...k", diff, normals)
    proj = diff - along[..., None] * normals[..., None, :]
    dc = (cb - gray[..., None]) * w
    A = torch.einsum("...ki,...kj->...ij", proj * w[..., None], proj)
    A = A + torch.einsum("...i,...j->...ij", normals, normals)
    A = A + 1e-6 * torch.eye(3, dtype=points.dtype, device=points.device)
    b = torch.einsum("...ki,...k->...i", proj, dc)
    return torch.linalg.solve_ex(A, b[..., None])[0][..., 0]


def _colored_icp_scale(src, tgt, gray_s, gray_t, max_dist, src_mask, tgt_mask, R0, t0, *,
                       max_iter: int = 30, rel_tol: float = 1e-6,
                       lambda_geometric: float = 0.968, normals_k: int = 16,
                       gradient_k: int = 16) -> ICPResult:
    """One scale of colored ICP on (B, n, 3) pairs: geometric
    (point-to-plane) and photometric (tangent-plane colour) rows in one
    Gauss-Newton step, weighted sqrt(lambda) and sqrt(1 - lambda)."""
    f32 = src.dtype
    loop = ICPLoop(src, tgt, max_dist, src_mask, tgt_mask)
    normals = pca_normals(tgt, tgt_mask, k=normals_k)
    grad = color_gradients(tgt, gray_t, normals, tgt_mask, k=gradient_k)
    sg = torch.sqrt(torch.tensor(lambda_geometric, dtype=f32, device=src.device))
    sc = torch.sqrt(torch.tensor(1.0 - lambda_geometric, dtype=f32, device=src.device))

    def step(R, t, idx, inlier):
        moved = transform_points(src, R, t)
        q, nq, dq = _take(tgt, idx), _take(normals, idx), _take(grad, idx)
        cq = torch.gather(gray_t, 1, idx.long())
        w = inlier.to(f32)
        along = ((moved - q) * nq).sum(-1)
        r_g = along * sg
        Jg = torch.cat([torch.linalg.cross(moved, nq, dim=-1), nq], -1) * sg
        # Photometric rows: p' projected on q's tangent plane, the
        # linearised colour there against the source colour.
        u = moved - along[..., None] * nq
        r_c = (cq + (dq * (u - q)).sum(-1) - gray_s) * sc
        m = dq - (dq * nq).sum(-1)[..., None] * nq
        Jc = torch.cat([torch.linalg.cross(moved, m, dim=-1), m], -1) * sc
        J = torch.cat([Jg, Jc], 1)
        r = torch.cat([r_g, r_c], 1)
        Jw = J * torch.cat([w, w], 1)[..., None]
        x = _solve6(torch.einsum("bni,bnj->bij", Jw, J), -torch.einsum("bni,bn->bi", Jw, r))
        dR = _rodrigues(x[:, :3]).to(f32)
        return _finite(dR @ R, torch.einsum("bij,bj->bi", dR, t) + x[:, 3:].to(f32))

    return loop.run(step, R0, t0, max_iter, rel_tol, stop_on_bad=False)


def colored_icp(src, tgt, src_colors, tgt_colors, *,
                voxel_scales: tuple[float, ...] = (0.04, 0.02, 0.01),
                max_iters: tuple[int, ...] = (50, 30, 14),
                lambda_geometric: float = 0.968) -> ICPResult:
    """Multiscale colored ICP of one (n, 3) ``src`` onto (m, 3) ``tgt``
    with (n, 3) / (m, 3) colours (0..1 or 0..255): coarse to fine over
    voxel scales, each scale refined by ``_colored_icp_scale`` on the voxel
    centroids with their mean grey values. The result has a leading pair
    axis of 1."""
    from fusion4landslide_tpu_torch.ops.voxel import segment_sum, voxel_downsample

    dev, f32 = src.device, src.dtype
    R = torch.eye(3, dtype=f32, device=dev)[None]
    t = torch.zeros((1, 3), dtype=f32, device=dev)
    gray_s = src_colors.to(torch.float32).mean(-1)
    gray_t = tgt_colors.to(torch.float32).mean(-1)
    if float(gray_s.max()) > 1.5:  # 0..255 -> 0..1
        gray_s, gray_t = gray_s / 255.0, gray_t / 255.0
    n, m = src.shape[0], tgt.shape[0]
    result = None
    for scale, iters in zip(voxel_scales, max_iters):
        s_cent, s_p2v, _, s_nv = voxel_downsample(src, scale)
        t_cent, t_p2v, _, t_nv = voxel_downsample(tgt, scale)
        gs = segment_sum(gray_s, s_p2v, n) / torch.clamp(
            segment_sum(torch.ones_like(gray_s), s_p2v, n), min=1)
        gt = segment_sum(gray_t, t_p2v, m) / torch.clamp(
            segment_sum(torch.ones_like(gray_t), t_p2v, m), min=1)
        mask_s = torch.arange(n, device=dev) < s_nv
        mask_t = torch.arange(m, device=dev) < t_nv
        result = _colored_icp_scale(
            s_cent[None], t_cent[None], gs[None], gt[None], scale * 1.4, mask_s[None],
            mask_t[None], R, t, max_iter=int(iters), lambda_geometric=lambda_geometric,
        )
        R, t = result.R, result.t
    return result


class RansacResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (n,) bool
    n_inliers: torch.Tensor  # ()
    best_score: torch.Tensor  # ()


def ransac_registration(src_corr, tgt_corr, samples=None, *,
                        max_correspondence_distance: float = 0.05, num_hypotheses: int = 512,
                        mask=None, generator: torch.Generator | None = None) -> RansacResult:
    """Rigid fit of (n, 3) correspondences by RANSAC: ``num_hypotheses``
    minimal 3-point samples (``samples`` (K, 3) indices, or drawn with
    replacement, uniformly over the ``mask``ed rows, from ``generator``,
    by default one seeded with 0) fitted and scored at once; the best
    (first on ties) refitted on its inliers."""
    n = src_corr.shape[0]
    dev = src_corr.device
    m = (torch.ones((n,), dtype=torch.bool, device=dev) if mask is None
         else mask.to(torch.bool))
    if samples is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        probs = m.to(torch.float32) / torch.clamp(m.sum(), min=1)
        samples = torch.multinomial(probs, num_hypotheses * 3, replacement=True,
                                    generator=generator).reshape(num_hypotheses, 3)
    samples = torch.as_tensor(samples, device=dev).long()
    Rs, ts, _, oks = weighted_kabsch(src_corr[samples], tgt_corr[samples])
    moved = torch.einsum("kij,nj->kni", Rs, src_corr) + ts[:, None, :]
    inl = (torch.linalg.norm(moved - tgt_corr[None], dim=-1) <= max_correspondence_distance)
    inl = inl & m[None, :]
    scores = inl.sum(1) * oks
    best = torch.argmax(scores)
    R, t, _, _ = weighted_kabsch(src_corr, tgt_corr, inl[best].to(src_corr.dtype))
    final = (torch.linalg.norm(transform_points(src_corr, R, t) - tgt_corr, dim=-1)
             <= max_correspondence_distance) & m
    return RansacResult(R=R, t=t, inliers=final, n_inliers=final.sum(), best_score=scores[best])
