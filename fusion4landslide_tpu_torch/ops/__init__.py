"""Geometry and search ops (the port of ``fusion4landslide_tpu.ops``),
exported under the JAX package's names, with one exception: ``ops.knn``
stays the submodule (the function is ``ops.knn.knn``), which the port's
code and tests import by that name. The CUDA kernels live in
``hashgrid_cuda`` and ``knn_cuda``."""

from fusion4landslide_tpu_torch.ops.kabsch import (
    rt_to_transform,
    transform_points,
    transformation_residuals,
    weighted_kabsch,
)
from fusion4landslide_tpu_torch.ops.knn import (
    median_nn_distance,
    nn1,
    pairwise_sqdist,
    radius_neighbors,
)
from fusion4landslide_tpu_torch.ops.voxel import (
    grid_cells,
    group_by_cells,
    segment_mean,
    voxel_downsample,
)
from fusion4landslide_tpu_torch.ops.hashgrid import build_hash_grid, hash_grid_knn
from fusion4landslide_tpu_torch.ops.icp import ICPResult, icp_point2point
from fusion4landslide_tpu_torch.ops.normals import pca_normals
from fusion4landslide_tpu_torch.ops.registration import (
    colored_icp,
    icp_point2plane,
    ransac_registration,
)
from fusion4landslide_tpu_torch.ops.segments import bucket_size, label_members
from fusion4landslide_tpu_torch.ops.supervoxel import (
    supervoxel_segmentation,
    supervoxel_segmentation_pair,
)

__all__ = [
    "weighted_kabsch",
    "transform_points",
    "transformation_residuals",
    "rt_to_transform",
    "nn1",
    "pairwise_sqdist",
    "median_nn_distance",
    "radius_neighbors",
    "grid_cells",
    "group_by_cells",
    "segment_mean",
    "voxel_downsample",
    "build_hash_grid",
    "hash_grid_knn",
    "ICPResult",
    "icp_point2point",
    "icp_point2plane",
    "colored_icp",
    "ransac_registration",
    "pca_normals",
    "supervoxel_segmentation",
    "supervoxel_segmentation_pair",
    "label_members",
    "bucket_size",
]
