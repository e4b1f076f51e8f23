"""Host-side file I/O: PLY, LAS and E57 point clouds, images, DVF tables
(the port's own copy of ``fusion4landslide_tpu.io``)."""

from fusion4landslide_tpu_torch.io.images import load_image
from fusion4landslide_tpu_torch.io.ply import PointCloud, read_ply, write_ply

__all__ = ["PointCloud", "load_image", "read_ply", "read_point_cloud", "write_ply"]


def read_point_cloud(path: str) -> PointCloud:
    """Read a point cloud by extension: .ply, .las/.laz or .e57 (the
    reference reads PLY after an offline conversion; the Rockfall
    Simulator epochs ship as E57, README.md:83)."""
    lower = str(path).lower()
    if lower.endswith(".ply"):
        return read_ply(path)
    if lower.endswith((".las", ".laz")):
        from fusion4landslide_tpu_torch.io.las import read_las

        return read_las(path)
    if lower.endswith(".e57"):
        from fusion4landslide_tpu_torch.io.e57 import read_e57

        return read_e57(path)
    raise ValueError(f"unsupported point-cloud format: {path}")
