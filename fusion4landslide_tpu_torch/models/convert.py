"""Parameters for the port's networks: a bridge from the JAX package's
Flax parameter trees, and a seeded random initialisation.

Flax ``Dense`` keeps its kernel as (in, out); ``nn.Linear`` keeps
(out, in), so kernels are transposed. Module paths are identical on both
sides (``stn3d.trunk.conv1``, ``bn1.scale``/``bias``/``mean``/``var``, ...).
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch

from fusion4landslide_tpu_torch.device import resolve_device
from fusion4landslide_tpu_torch.models.aggregation import ClusterFeatureNet
from fusion4landslide_tpu_torch.models.dips import EvalBatchNorm, PointNetFeature

__all__ = ["params_from_flax", "seeded_models", "state_dict_from_flax"]


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
