"""PyTorch / CUDA port of ``fusion4landslide_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``pipelines/``, ``parallel/``) so each module's
counterpart is easy to find. It imports ``torch`` and never ``jax`` nor
anything of ``fusion4landslide_tpu``.

Ported so far: the 3D-only fusion tile step
(``pipelines.fusion_device.fusion3d_tile_step``) and its single-GPU runner
(``parallel.pipeline.run_fusion3d_tiles``), with the two Pallas grid
kernels of that path written in CUDA C++ for ``sm_90a``
(``csrc/grid_knn.cu``, ``csrc/radius_sample.cu``).
"""

from fusion4landslide_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
