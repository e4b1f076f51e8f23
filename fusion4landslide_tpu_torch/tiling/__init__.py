"""Spatial tiling of epoch pairs (the port's own copy of
``fusion4landslide_tpu.tiling``; the native C++ tiler is not ported)."""

from fusion4landslide_tpu_torch.tiling.bsp import TilePair, tile_epoch_pair, tile_point_clouds

__all__ = ["TilePair", "tile_epoch_pair", "tile_point_clouds"]
