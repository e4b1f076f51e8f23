"""Host-side file I/O: PLY and LAS point clouds, images, DVF tables (the
port's own copy of ``fusion4landslide_tpu.io``)."""

from fusion4landslide_tpu_torch.io.images import load_image
from fusion4landslide_tpu_torch.io.ply import PointCloud, read_ply, write_ply

__all__ = ["PointCloud", "load_image", "read_ply", "read_point_cloud", "write_ply"]


def read_point_cloud(path: str) -> PointCloud:
    """Read a point cloud by extension: .ply or .las. ``.e57`` is not
    ported yet (ROADMAP.md queue 1 item 11)."""
    lower = str(path).lower()
    if lower.endswith(".ply"):
        return read_ply(path)
    if lower.endswith((".las", ".laz")):
        from fusion4landslide_tpu_torch.io.las import read_las

        return read_las(path)
    if lower.endswith(".e57"):
        raise NotImplementedError(
            f"{path}: E57 reading is not ported yet (ROADMAP.md queue 1 item 11)"
        )
    raise ValueError(f"unsupported point-cloud format: {path}")
