"""The port's networks (``fusion4landslide_tpu.models``) and the
reference-checkpoint conversion, exported under the JAX package's names."""

from fusion4landslide_tpu_torch.models.dips import PointNetFeature
from fusion4landslide_tpu_torch.models.filtering import FilteringNetwork, filter_correspondences
from fusion4landslide_tpu_torch.models.aggregation import (
    ClusterFeatureNet,
    aggregate_superpoints,
    gather_superpoint_buckets,
)
from fusion4landslide_tpu_torch.models.convert import load_torch_checkpoint

__all__ = [
    "PointNetFeature",
    "FilteringNetwork",
    "filter_correspondences",
    "ClusterFeatureNet",
    "aggregate_superpoints",
    "gather_superpoint_buckets",
    "load_torch_checkpoint",
]
