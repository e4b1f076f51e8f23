"""Reference-format torch checkpoints: the port's writers
(``*_to_reference_state_dict``) and loaders (``*_from_reference``)
against the JAX package's ``load_torch_checkpoint`` + ``torch_to_*``
(``fusion4landslide_tpu/models/convert.py``): one file per network, its
module outputs through Flax and through the port within 1e-5."""

import numpy as np
import pytest
import torch
import _torch_workers  # noqa: F401 (caps torch threads per xdist worker)

from fusion4landslide_tpu_torch.models.convert import (
    CHECKPOINT_NAMES,
    aggregation_from_reference,
    dips_from_reference,
    filter_from_reference,
    load_torch_checkpoint,
    seeded_filter,
    seeded_models,
    write_reference_checkpoints,
)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    dips, agg = seeded_models(3, "cpu")
    filt = seeded_filter(3, "cpu")
    write_reference_checkpoints(str(root), dips=dips, agg=agg, filt=filt)
    return root


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    patches = rng.normal(size=(4, 128, 3)).astype(np.float32)
    feats = rng.normal(size=(5, 24, 64)).astype(np.float32)
    fmask = rng.random((5, 24)) < 0.8
    fmask[:, 0] = True
    corr = rng.normal(size=(3, 40, 6)).astype(np.float32)
    cmask = rng.random((3, 40)) < 0.9
    return patches, feats, fmask, corr, cmask


def test_reference_checkpoints_match_jax_conversion(checkpoints):
    from fusion4landslide_tpu.models import convert as jc
    from fusion4landslide_tpu.models.aggregation import ClusterFeatureNet
    from fusion4landslide_tpu.models.dips import PointNetFeature
    from fusion4landslide_tpu.models.filtering import FilteringNetwork

    patches, feats, fmask, corr, cmask = _inputs()
    path = {k: str(checkpoints / v) for k, v in CHECKPOINT_NAMES.items()}
    # The DIPs checkpoint keeps the reference's 1x1-conv weights and
    # BatchNorm buffers.
    sd = load_torch_checkpoint(path["dips"])
    assert sd["conv1.0.weight"].shape == (256, 3, 1)
    assert "fc2.2.running_var" in sd and "stn3d.fc2.1.running_var" in sd
    with torch.inference_mode():
        t_dips = dips_from_reference(sd, "cpu")(torch.from_numpy(patches)).numpy()
        t_agg = aggregation_from_reference(load_torch_checkpoint(path["agg"]), "cpu")(
            torch.from_numpy(feats), torch.from_numpy(fmask)).numpy()
        t_filt = filter_from_reference(load_torch_checkpoint(path["filter"]), device="cpu")(
            torch.from_numpy(corr), torch.from_numpy(cmask)).numpy()
    j_dips = PointNetFeature(precision="highest").apply(
        jc.torch_to_dips_params(jc.load_torch_checkpoint(path["dips"])), patches)
    j_agg = ClusterFeatureNet().apply(
        jc.torch_to_aggregation_params(jc.load_torch_checkpoint(path["agg"])), feats, fmask)
    j_filt = FilteringNetwork().apply(
        jc.torch_to_filtering_params(jc.load_torch_checkpoint(path["filter"])), corr, cmask)
    for got, ref in ((t_dips, j_dips), (t_agg, j_agg), (t_filt, j_filt)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    assert np.abs(t_dips).max() > 0.01 and np.abs(t_agg).max() > 0.01


def test_round_trip_and_state_dict_wrapper(tmp_path):
    from fusion4landslide_tpu_torch.models.convert import dips_to_reference_state_dict

    dips, _ = seeded_models(5, "cpu")
    sd = dips_to_reference_state_dict(dips)
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "wrapped.pth")
    back = dips_from_reference(load_torch_checkpoint(str(tmp_path / "wrapped.pth")), "cpu")
    for (ka, va), (kb, vb) in zip(dips.state_dict().items(), back.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["fusion", "f2s3"])
def test_drivers_refuse_missing_checkpoints(tmp_path, method):
    from fusion4landslide_tpu_torch import main_f2s3, main_fusion

    load = (main_fusion if method == "fusion" else main_f2s3).load_model_params
    with pytest.raises(FileNotFoundError, match="DIPs checkpoint"):
        load({"weight_dir": str(tmp_path)}, "cpu")
    dips, agg = seeded_models(0, "cpu")
    write_reference_checkpoints(str(tmp_path), dips=dips)
    with pytest.raises(FileNotFoundError):
        load({"weight_dir": str(tmp_path)}, "cpu")
    write_reference_checkpoints(str(tmp_path), agg=agg, filt=seeded_filter(0, "cpu"))
    models = load({"weight_dir": str(tmp_path)}, "cpu")
    assert all(not m.training for m in models)
