"""ICP dispatch on the reference's ``icp_type`` config value.

Port of ``fusion4landslide_tpu.ops.registration.icp_by_type`` for
``point2point``; point-to-plane and generalized ICP are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

from fusion4landslide_tpu_torch.ops.icp import ICPResult, icp_point2point

__all__ = ["icp_by_type"]

_ICP_TYPES = ("point2point", "point2plane", "generalized_icp", "generalized")


def icp_by_type(icp_type: str, src, tgt, max_dist, *, src_mask=None,
                tgt_mask=None, max_iter: int = 30, R_init=None,
                t_init=None) -> ICPResult:
    if icp_type not in _ICP_TYPES:
        raise ValueError(f"unknown icp_type {icp_type!r}; expected one of {_ICP_TYPES}")
    if icp_type != "point2point":
        raise NotImplementedError(
            f"icp_type {icp_type!r} is not ported yet (ROADMAP.md queue 1 item 4)")
    return icp_point2point(
        src, tgt, max_dist, src_mask=src_mask, tgt_mask=tgt_mask,
        max_iter=max_iter, R_init=R_init, t_init=t_init,
    )
