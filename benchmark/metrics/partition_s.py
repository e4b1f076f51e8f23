"""Seconds per tile of the median resolution, the voxel grid and the
supervoxel partition."""


def read(run):
    return run.stage_s("median_resolution", "median_res", "voxel_subsampling", "supervoxels",
                       "partition*")
