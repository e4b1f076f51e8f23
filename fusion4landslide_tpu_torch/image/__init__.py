"""Camera geometry of the RGB channel: projection, depth rasterisation,
2D -> 3D lifting (port of ``fusion4landslide_tpu.image.geometry``)."""

from fusion4landslide_tpu_torch.image.geometry import (
    bilinear_depth,
    lift_pixels_to_world,
    project_points,
    rasterize_depth,
)

__all__ = ["bilinear_depth", "lift_pixels_to_world", "project_points", "rasterize_depth"]
