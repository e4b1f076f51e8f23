"""The DIPs trunks' epilogue wrapper (``ops/dips_epilogue.py``) on the CPU:
equal to the plain chain it replaces (``EvalBatchNorm.forward``, then
``relu_`` or ``amax``), its argument checks, and its counter.

The CUDA kernel itself is held against the plain chain on the card
(``tests/test_torch_kernels.py``'s card tests and ``chip_smoke.py``)."""

import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

import chip_smoke
from fusion4landslide_tpu_torch.models.convert import seeded_models
from fusion4landslide_tpu_torch.models.dips import EvalBatchNorm
from fusion4landslide_tpu_torch.ops import cuda_build
from fusion4landslide_tpu_torch.ops import dips_epilogue as de
from fusion4landslide_tpu_torch.utils import profiling


def _batch_norm(c: int, seed: int) -> EvalBatchNorm:
    bn = EvalBatchNorm(c)
    chip_smoke.randomize_batch_norms(bn, torch.Generator().manual_seed(seed))
    return bn


def _activation(shape, seed: int) -> torch.Tensor:
    """Normal values with +0, -0 and NaN planted."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 2.0
    flat = x.view(-1)
    flat[::7] = 0.0
    flat[3::11] = -0.0
    flat[5::97] = torch.nan
    return x


@pytest.mark.parametrize("shape", [(37, 100, 4), (37, 100, 256), (3, 64, 1024), (5, 4),
                                   (2048, 12)])
def test_bn_relu_on_cpu_equals_batch_norm_then_relu(shape):
    bn = _batch_norm(shape[-1], 1)
    x = _activation(shape, 2)
    want = bn(x).relu_()
    got = de.bn_relu_(x, *bn.factors())
    assert got.data_ptr() == x.data_ptr()
    assert chip_smoke.bits_equal(got, want)


@pytest.mark.parametrize("shape", [(37, 100, 4), (37, 100, 256), (3, 64, 1024), (3, 1, 4),
                                   (100, 12)])
def test_bn_max_on_cpu_equals_batch_norm_then_amax(shape):
    bn = _batch_norm(shape[-1], 3)
    x = _activation(shape, 4)
    before = x.clone()
    got = de.bn_max(x, *bn.factors())
    assert chip_smoke.equal_nan(got, bn(x).amax(dim=-2))
    assert got.shape == (*shape[:-2], shape[-1])
    assert chip_smoke.bits_equal(x, before)


def _bad_inputs():
    ok = torch.randn(4, 8, 16)
    f = _batch_norm(16, 5).factors()
    f6 = _batch_norm(6, 5).factors()
    return {
        "non-contiguous": (ok.transpose(0, 1), f, ValueError),
        "float64": (ok.double(), f, TypeError),
        "channels not a multiple of 4": (torch.randn(4, 8, 6), f6, ValueError),
        "factor of another width": (ok, (f[0][:8], *f[1:]), ValueError),
        "float64 factor": (ok, (f[0], f[1].double(), *f[2:]), TypeError),
    }


@pytest.mark.parametrize("entry", ["bn_relu_", "bn_max"])
@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_checks_raise_before_dispatch(entry, case):
    x, f, err = _bad_inputs()[case]
    launches = dict(cuda_build.LAUNCHES)
    timings: dict = {}
    with pytest.raises(err):
        profiling.tile("t")(lambda timings=None: getattr(de, entry)(x, *f))(timings=timings)
    assert "dips.epilogues" not in timings.get("counters", {})
    assert cuda_build.LAUNCHES == launches


def test_bn_max_needs_points():
    f = _batch_norm(8, 6).factors()
    with pytest.raises(ValueError):
        de.bn_max(torch.randn(8), *f)
    with pytest.raises(ValueError):
        de.bn_max(torch.randn(3, 0, 8), *f)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
def test_pointnet_equals_the_plain_chain_and_counts_ten_epilogues(dtype):
    """``PointNetFeature`` through the wrapper equals the plain chain of
    the parent design, bit for bit; each call adds ten ``dips.epilogues``
    (two trunks x five layers) to a tile's record, and the CPU path
    launches nothing."""
    dips, _ = seeded_models(0, "cpu")
    chip_smoke.randomize_batch_norms(dips, torch.Generator().manual_seed(7))
    patches = torch.randn((40, 128, 3), generator=torch.Generator().manual_seed(8))
    launches = dict(cuda_build.LAUNCHES)
    timings: dict = {}
    with torch.inference_mode():
        got = profiling.tile("t")(
            lambda timings=None: [dips(patches, dtype) for _ in range(2)])(timings=timings)
        with chip_smoke.plain_epilogues():
            want = dips(patches, dtype)
        assert dips(patches[:3], dtype).shape == (3, 64)  # no record: nothing counted
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    assert timings["counters"] == {"dips.epilogues": 20}
    assert cuda_build.LAUNCHES == launches
