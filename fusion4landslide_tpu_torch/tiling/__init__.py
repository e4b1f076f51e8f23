"""Spatial tiling of epoch pairs (the port's own copy of
``fusion4landslide_tpu.tiling``): the numpy tiler the drivers run, and
the native C++ tiler in ``tiling.native`` (built from ``cpp/tiler.cpp``)."""

from fusion4landslide_tpu_torch.tiling.bsp import TilePair, tile_epoch_pair, tile_point_clouds

__all__ = ["TilePair", "tile_epoch_pair", "tile_point_clouds"]
