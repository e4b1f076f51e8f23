"""PyTorch / CUDA port of ``fusion4landslide_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``pipelines/``, ``parallel/``, ``io/``,
``tiling/``) so each module's counterpart is easy to find. It imports
``torch`` and never ``jax`` nor anything of ``fusion4landslide_tpu``.

Ported so far: the drivers ``main_fusion`` and ``main_f2s3`` (YAML config,
tiling, checkpoints, resume), the fusion tile step, 3D-only or RGB+3D
(``pipelines.fusion_device.fusion3d_tile_step``), and the F2S3 tile step
(``pipelines.f2s3_device.f2s3_tile_step``) with their single-GPU runners
(``parallel.pipeline.run_fusion3d_tiles`` / ``run_f2s3_tiles``), and the
host tiles that the drivers run on one GPU (``pipelines.fusion.
run_fusion3d_tile`` / ``run_fusion_tile``, ``pipelines.f2s3.run_f2s3_tile``).
All three Pallas kernels of the JAX package are written in CUDA C++ for
``sm_90a`` (``csrc/grid_knn.cu``, ``csrc/radius_sample.cu``,
``csrc/knn.cu``).
"""

from fusion4landslide_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
