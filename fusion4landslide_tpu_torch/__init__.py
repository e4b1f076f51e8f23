"""PyTorch / CUDA port of ``fusion4landslide_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``pipelines/``, ``parallel/``, ``io/``,
``tiling/``) so each module's counterpart is easy to find. It imports
``torch`` and never ``jax`` nor anything of ``fusion4landslide_tpu``.

Ported so far: all four methods, each with a driver (``main_fusion``,
``main_f2s3``, ``main_rgb_guided``, ``main_piecewise_icp``: YAML config,
PLY / LAS / E57 epochs, tiling, checkpoints, resume, the F2S3 feature
cache, the figure writers), host tiles and runners with one tile stream
per GPU (``parallel.pipeline``): the fusion tile step, 3D-only or RGB+3D
(``pipelines.fusion_device.fusion3d_tile_step``), the F2S3 tile step
(``pipelines.f2s3_device.f2s3_tile_step``), the RGB-guided tile step
(``pipelines.rgb_guided_device.rgb_guided_tile_step``) and piecewise ICP
(``pipelines.piecewise_icp``), with the ZNCC image matcher
(``image.matching``).
All three Pallas kernels of the JAX package are written in CUDA C++ for
``sm_90a`` (``csrc/grid_knn.cu``, ``csrc/radius_sample.cu``,
``csrc/knn.cu``).
"""

from fusion4landslide_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
