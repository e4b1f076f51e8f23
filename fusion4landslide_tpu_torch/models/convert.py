"""Parameters for the port's networks: the reference's torch checkpoints,
a bridge from the JAX package's Flax parameter trees, and a seeded random
initialisation.

Flax ``Dense`` keeps its kernel as (in, out); ``nn.Linear`` keeps
(out, in), so kernels are transposed. Module paths are identical on both
sides (``stn3d.trunk.conv1``, ``bn1.scale``/``bias``/``mean``/``var``, ...).

The reference's checkpoints (``local_feature_descriptor_best.pth``,
``feat_aggregation_3d.pth``, ``outlier_classifier_best.pt``) use its own
module names; ``*_from_reference`` load them into the port's modules under
the key map of ``fusion4landslide_tpu.models.convert`` (``torch_to_*``),
and ``*_to_reference_state_dict`` write the port's modules back in that
format. Trained checkpoints are not in the repository.
"""

from __future__ import annotations

import math
import os
from collections.abc import Mapping

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.models.aggregation import ClusterFeatureNet
from fusion4landslide_tpu_torch.models.dips import EvalBatchNorm, PointNetFeature
from fusion4landslide_tpu_torch.models.filtering import FilteringNetwork

__all__ = [
    "CHECKPOINT_NAMES",
    "aggregation_from_reference",
    "aggregation_to_reference_state_dict",
    "dips_from_reference",
    "dips_to_reference_state_dict",
    "filter_from_flax",
    "filter_from_reference",
    "filter_to_reference_state_dict",
    "load_torch_checkpoint",
    "params_from_flax",
    "seeded_filter",
    "seeded_models",
    "state_dict_from_flax",
    "write_reference_checkpoints",
]

#: File names the drivers read under ``weight_dir`` (the aggregation
#: checkpoint's name comes from ``pretrained_feature_aggregation_weight``).
CHECKPOINT_NAMES = {
    "dips": "local_feature_descriptor_best.pth",
    "agg": "feat_aggregation_3d.pth",
    "filter": "outlier_classifier_best.pt",
}

_BN_KEYS = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
            ("running_var", "var"))


def _dips_map() -> list[tuple[str, str, str]]:
    """(reference module, port module, kind) of PointNetFeature + STN3d.
    kind: 'bn', 'linear' or 'conv1d'. The main net's fc2 Sequential holds
    a Dropout at index 1, so its BatchNorm sits at index 2; STN3d's at 1
    (local_feature_descriptor.py:21-28, 81-85)."""
    out = []
    for ref, port, fc2_bn in (("stn3d.", "stn3d.trunk.", 1), ("", "trunk.", 2)):
        for i, name in enumerate(("conv1", "conv2", "conv3")):
            out += [(f"{ref}{name}.0", f"{port}{name}", "conv1d"),
                    (f"{ref}{name}.1", f"{port}bn{i + 1}", "bn")]
        out += [(f"{ref}fc1.0", f"{port}fc1", "linear"), (f"{ref}fc1.1", f"{port}bn4", "bn"),
                (f"{ref}fc2.0", f"{port}fc2", "linear"),
                (f"{ref}fc2.{fc2_bn}", f"{port}bn5", "bn")]
    return out + [("stn3d.fc3.0", "stn3d.fc3", "linear"), ("fc3.0", "fc3", "linear")]


def _aggregation_map() -> list[tuple[str, str, str]]:
    """ClusterFeatureNetWithAttention (cluster_feature_net_self_attention.py:5-53)."""
    return [(f"self_attention.{n}", n, "linear") for n in ("query", "key", "value", "fc")] + [
        ("mlp.0", "mlp0", "linear"), ("mlp.2", "mlp1", "linear")]


def _filter_map(num_layers: int) -> list[tuple[str, str, str]]:
    """FilteringNetwork (outlier_classifier.py:32-48; its Instance/Batch
    norms are affine-free and hold no weights)."""
    out = [("l1", "l1", "conv2d")]
    for i in range(num_layers):
        out += [(f"l2.{i}.conv.0", f"block{i}.conv0", "conv2d"),
                (f"l2.{i}.conv.4", f"block{i}.conv1", "conv2d")]
    return out + [("output", "output", "conv2d")]


def _from_reference(sd: Mapping, key_map) -> dict[str, torch.Tensor]:
    out = {}
    for ref, port, kind in key_map:
        if kind == "bn":
            for rk, pk in _BN_KEYS:
                out[f"{port}.{pk}"] = torch.as_tensor(sd[f"{ref}.{rk}"], dtype=torch.float32)
            continue
        w = torch.as_tensor(sd[f"{ref}.weight"], dtype=torch.float32)
        out[f"{port}.weight"] = w.reshape(w.shape[0], w.shape[1])  # 1x1 conv -> Linear
        out[f"{port}.bias"] = torch.as_tensor(sd[f"{ref}.bias"], dtype=torch.float32)
    return out


def _to_reference(module: torch.nn.Module, key_map) -> dict[str, torch.Tensor]:
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    out = {}
    for ref, port, kind in key_map:
        if kind == "bn":
            for rk, pk in _BN_KEYS:
                out[f"{ref}.{rk}"] = sd[f"{port}.{pk}"].clone()
            out[f"{ref}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
            continue
        w = sd[f"{port}.weight"].clone()
        out[f"{ref}.weight"] = w.reshape(*w.shape, *(1,) * {"linear": 0, "conv1d": 1, "conv2d": 2}[kind])
        out[f"{ref}.bias"] = sd[f"{port}.bias"].clone()
    return out


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A reference checkpoint's state dict on the CPU (a bare state dict
    or one under a ``state_dict`` key). Loaded with ``weights_only=True``:
    tensors and plain containers only, never arbitrary pickled objects."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def dips_from_reference(sd: Mapping, device=None) -> PointNetFeature:
    """PointNetFeature (eval) from a reference DIPs state dict (the key map
    of ``torch_to_dips_params``)."""
    net = PointNetFeature()
    net.load_state_dict(_from_reference(sd, _dips_map()))
    return net.eval().to(resolve_device(device))


def aggregation_from_reference(sd: Mapping, device=None) -> ClusterFeatureNet:
    """ClusterFeatureNet (eval) from a reference aggregation state dict
    (the key map of ``torch_to_aggregation_params``)."""
    net = ClusterFeatureNet()
    net.load_state_dict(_from_reference(sd, _aggregation_map()))
    return net.eval().to(resolve_device(device))


def filter_from_reference(sd: Mapping, num_layers: int = 12, device=None) -> FilteringNetwork:
    """FilteringNetwork (eval) of ``num_layers`` blocks from a reference
    outlier-classifier state dict (``torch_to_filtering_params``, whose
    depth defaults to 12 as here)."""
    net = FilteringNetwork(num_layers=num_layers)
    net.load_state_dict(_from_reference(sd, _filter_map(num_layers)))
    return net.eval().to(resolve_device(device))


def dips_to_reference_state_dict(net: PointNetFeature) -> dict[str, torch.Tensor]:
    """The reference-format state dict of a PointNetFeature."""
    return _to_reference(net, _dips_map())


def aggregation_to_reference_state_dict(net: ClusterFeatureNet) -> dict[str, torch.Tensor]:
    """The reference-format state dict of a ClusterFeatureNet."""
    return _to_reference(net, _aggregation_map())


def filter_to_reference_state_dict(net: FilteringNetwork) -> dict[str, torch.Tensor]:
    """The reference-format state dict of a FilteringNetwork."""
    return _to_reference(net, _filter_map(net.num_layers))


def write_reference_checkpoints(weight_dir: str, *, dips=None, agg=None, filt=None) -> None:
    """Write the given modules as reference-format checkpoints under
    ``weight_dir``, named as the drivers read them (``CHECKPOINT_NAMES``)."""
    os.makedirs(weight_dir, exist_ok=True)
    for key, net, to_sd in (("dips", dips, dips_to_reference_state_dict),
                            ("agg", agg, aggregation_to_reference_state_dict),
                            ("filter", filt, filter_to_reference_state_dict)):
        if net is not None:
            torch.save(to_sd(net), os.path.join(weight_dir, CHECKPOINT_NAMES[key]))


def state_dict_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Torch state dict of one Flax parameter tree (numpy leaves; an
    outer ``{'params': ...}`` level is accepted)."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (key,))
                continue
            arr = torch.from_numpy(np.array(val, dtype=np.float32))
            if key == "kernel":
                key, arr = "weight", arr.T.contiguous()
            out[".".join(prefix + (key,))] = arr

    walk(tree, ())
    return out


def params_from_flax(dips_params: Mapping, agg_params: Mapping):
    """(PointNetFeature state dict, ClusterFeatureNet state dict) from the
    JAX package's Flax trees, so both sides compute the same function."""
    return state_dict_from_flax(dips_params), state_dict_from_flax(agg_params)


def filter_from_flax(filt_params: Mapping) -> FilteringNetwork:
    """The FilteringNetwork of a Flax parameter tree, its depth counted
    from the tree's ``block{i}`` entries as the JAX runners count it."""
    sd = state_dict_from_flax(filt_params)
    num_layers = len({k.split(".")[0] for k in sd if k.startswith("block")})
    net = FilteringNetwork(num_layers=num_layers)
    net.load_state_dict(sd)
    return net.eval()


def _seeded_init(module: torch.nn.Module, gen: torch.Generator) -> None:
    """LeCun-normal kernels and zero biases (Flax ``Dense`` defaults);
    identity BatchNorm statistics."""
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, torch.nn.Linear):
                std = 1.0 / math.sqrt(mod.in_features)
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) * std)
                mod.bias.zero_()
            elif isinstance(mod, EvalBatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)


def seeded_models(seed: int = 0, device=None):
    """(PointNetFeature, ClusterFeatureNet) with seeded random weights, in
    eval mode on ``device`` (default ``cuda``; raises without a card)."""
    gen = torch.Generator().manual_seed(seed)
    dips, agg = PointNetFeature(), ClusterFeatureNet()
    _seeded_init(dips, gen)
    _seeded_init(agg, gen)
    dev = resolve_device(device)
    return dips.eval().to(dev), agg.eval().to(dev)


def seeded_filter(seed: int = 0, device=None) -> FilteringNetwork:
    """FilteringNetwork (12 blocks) with seeded random weights from its own
    generator, in eval mode on ``device`` (default ``cuda``; raises without
    a card)."""
    gen = torch.Generator().manual_seed(seed)
    net = FilteringNetwork()
    _seeded_init(net, gen)
    return net.eval().to(resolve_device(device))
