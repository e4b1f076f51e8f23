"""Parameters of the learned image matchers: the JAX package's Flax trees
and its flat ``.npz`` checkpoints (``weights/eloftr_tiny.npz``,
``weights/roma_tiny.npz``) read into torch modules without flax, and
written back in the same format.

A checkpoint holds one array per Flax leaf under its ``/``-joined path
(``params/backbone/stage0_block0/conv/kernel``) and the architecture as
the ``repr`` of the config's ``dataclasses.asdict`` under ``__cfg__``. The
port's modules carry the Flax module names, so a leaf's torch key is its
path joined by ``.``: conv kernels go from HWIO to OIHW, dense kernels
from (in, out) to ``Linear``'s (out, in), norm ``scale`` becomes
``weight``.

``flax_norm`` computes Flax's normalisation statistics (fast variance
E[x^2] - E[x]^2, clipped at 0) and applies them as Flax does;
``seeded_init`` draws numpy-seeded weights at trained-like scales;
``flax_default_init`` draws them from Flax's default initialisers (the
start of a training run, as ``model.init`` starts the JAX trainers).
"""

from __future__ import annotations

import ast
import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

__all__ = [
    "flat_from_tree",
    "flax_default_init",
    "flax_norm",
    "seeded_init",
    "read_flat_npz",
    "state_dict_from_flat",
    "flat_from_module",
    "flat_grads_from_module",
    "write_flat_npz",
]


def flat_from_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """``{'a/b/leaf': array}`` of a nested Flax tree (or a flat dict,
    returned with numpy leaves)."""
    out: dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flat_from_tree(val, path))
        else:
            out[path] = np.asarray(val, np.float32)
    return out


def state_dict_from_flat(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Torch state dict of a flat Flax tree (a leading ``params/`` level is
    dropped)."""
    sd = {}
    for path, val in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        name = parts[-1]
        arr = torch.from_numpy(np.array(val, dtype=np.float32))
        if name == "kernel":
            name = "weight"
            arr = arr.permute(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif name == "scale":
            name = "weight"
        sd[".".join(parts[:-1] + [name])] = arr.contiguous()
    return sd


def _flax_leaf(key: str, arr: np.ndarray, is_norm) -> tuple[str, np.ndarray]:
    """The Flax path and layout of a torch parameter (or gradient)."""
    parts = key.split(".")
    name = parts[-1]
    if name == "weight" and is_norm(key):
        name = "scale"
    elif name == "weight":
        name = "kernel"
        arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
    return "/".join(["params"] + parts[:-1] + [name]), np.ascontiguousarray(arr)


def flat_from_module(module: torch.nn.Module, is_norm) -> dict[str, np.ndarray]:
    """The flat Flax tree (``params/...`` paths) of a port module;
    ``is_norm(torch key)`` names the norm weights that Flax calls
    ``scale``."""
    return dict(_flax_leaf(key, val.detach().cpu().numpy().astype(np.float32), is_norm)
                for key, val in module.state_dict().items())


def flat_grads_from_module(module: torch.nn.Module, is_norm) -> dict[str, np.ndarray]:
    """The parameters' ``.grad`` as a flat Flax tree, in Flax's layouts
    (the gradient ``jax.grad`` gives for the same leaf)."""
    return dict(_flax_leaf(key, p.grad.detach().cpu().numpy().astype(np.float32), is_norm)
                for key, p in module.named_parameters() if p.grad is not None)


def read_flat_npz(path: str, tuple_keys) -> tuple[dict[str, np.ndarray], dict]:
    """(flat leaves, config keyword arguments) of a checkpoint; the config
    literal is parsed with ``ast.literal_eval``, and ``tuple_keys`` become
    tuples."""
    data = np.load(path, allow_pickle=False)
    cfg = ast.literal_eval(bytes(data["__cfg__"]).decode())
    for key in tuple_keys:
        cfg[key] = tuple(cfg[key])
    return {k: np.asarray(v) for k, v in data.items() if k != "__cfg__"}, cfg


def write_flat_npz(path: str, flat: Mapping[str, np.ndarray], cfg) -> None:
    """Write a checkpoint in the JAX package's format."""
    arrays = dict(flat)
    arrays["__cfg__"] = np.frombuffer(repr(dataclasses.asdict(cfg)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def flax_norm(x: torch.Tensor, dims, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """Normalise ``x`` over ``dims`` as Flax's LayerNorm / GroupNorm do:
    var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * (rsqrt(var + eps) *
    weight) + bias; ``weight`` and ``bias`` broadcast against ``x``."""
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * weight) + bias


def seeded_init(module: torch.nn.Module, seed: int, is_norm) -> torch.nn.Module:
    """Overwrite ``module``'s parameters in ``named_parameters`` order with
    numpy draws (``default_rng(seed)``) at trained-like scales:
    Kaiming-normal conv and dense kernels, N(0, 0.05) biases, and for the
    norms (``is_norm(key)``) scales N(1, 0.1) and biases N(0, 0.05)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, p in module.named_parameters():
            shape = tuple(p.shape)
            if is_norm(key):
                mean, std = (1.0, 0.1) if key.endswith("weight") else (0.0, 0.05)
            elif key.endswith("bias"):
                mean, std = 0.0, 0.05
            else:
                mean, std = 0.0, float(np.sqrt(2.0 / int(np.prod(shape[1:]))))
            p.copy_(torch.from_numpy(rng.normal(mean, std, shape).astype(np.float32)))
    return module


def flax_default_init(module: torch.nn.Module, seed: int, is_norm) -> torch.nn.Module:
    """Overwrite ``module``'s conv and dense kernels and biases and its norm
    parameters (``is_norm(key)``) in ``named_parameters`` order with numpy
    draws (``default_rng(seed)``) from Flax's defaults: kernels
    ``lecun_normal`` (a normal truncated at 2 sigma, scaled to variance
    1 / fan_in), biases 0, norm scales 1 and biases 0. Other parameters
    keep their module initialisation."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, p in module.named_parameters():
            shape = tuple(p.shape)
            if is_norm(key):
                val = np.full(shape, 1.0 if key.endswith("weight") else 0.0)
            elif key.endswith("bias"):
                val = np.zeros(shape)
            elif key.endswith("weight") and len(shape) >= 2:
                val = rng.standard_normal(shape)
                while (out := np.abs(val) > 2.0).any():
                    val[out] = rng.standard_normal(int(out.sum()))
                val *= np.sqrt(1.0 / int(np.prod(shape[1:]))) / 0.87962566103423978
            else:
                continue
            p.copy_(torch.from_numpy(val.astype(np.float32)))
    return module
