"""Seeded random weights of the three networks the tiles run, made on the
device in one draw per network, in float32 (the type they are served
in): LeCun-normal kernels, as the port's ``seeded_models`` /
``seeded_filter`` initialise them, and biases and BatchNorm statistics
drawn at ``BIAS_STD`` about their neutral values, so that every term of
the networks is exercised and judged.

The raw tensors are keyed by the port's parameter names, so the same
dict loads into the program's modules and feeds the plain reference."""

from __future__ import annotations

import math

import torch

#: (name, fan_in, fan_out) of every dense layer; BatchNorm layers follow
#: from ``_BN``.
_TRUNK = [("conv1", 3, 256), ("conv2", 256, 512), ("conv3", 512, 1024),
          ("fc1", 1024, 512), ("fc2", 512, 256)]
_BN = [("bn1", 256), ("bn2", 512), ("bn3", 1024), ("bn4", 512), ("bn5", 256)]


def _dips_layers():
    dense = [(f"stn3d.trunk.{n}", i, o) for n, i, o in _TRUNK] + [("stn3d.fc3", 256, 9)]
    dense += [(f"trunk.{n}", i, o) for n, i, o in _TRUNK] + [("fc3", 256, 64)]
    bns = [(f"{p}.{n}", c) for p in ("stn3d.trunk", "trunk") for n, c in _BN]
    return dense, bns


def _agg_layers():
    return [(n, 64, 64) for n in ("query", "key", "value", "fc", "mlp0", "mlp1")], []


def _filter_layers(blocks: int = 12):
    dense = [("l1", 6, 128)]
    dense += [(f"block{b}.conv{c}", 128, 128) for b in range(blocks) for c in range(2)]
    return dense + [("output", 128, 1)], []


LAYERS = {"dips": _dips_layers, "agg": _agg_layers, "filter": _filter_layers}
#: Output rows drawn centred (their weights sum to 0). The filter's
#: residual stream carries an offset shared by every row (each block adds
#: a ReLU of normalised values), which an uncentred random output row
#: turns into one sign for a whole tile: its scores, relu(tanh(.)), would
#: then sit at 0 nearly everywhere and judge nothing.
CENTRED = {"filter": ("output",)}
#: Spread of the biases and of the BatchNorm scale, shift, mean and
#: variance about their neutral values (0, 0, 0; 1 for scale and variance).
BIAS_STD = 0.1


def make_weights(kind: str, seed: int, device) -> dict:
    """Raw float32 weights of network ``kind`` ('dips', 'agg', 'filter')
    from one normal draw of a generator on ``device`` seeded by ``seed``."""
    dense, bns = LAYERS[kind]()
    n = sum(i * o for _, i, o in dense)
    extra = sum(o for _, _, o in dense) + 4 * sum(c for _, c in bns)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    draw = torch.randn(n + extra, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, i, o in dense:
        w = draw[at:at + i * o].view(o, i) / math.sqrt(i)
        if name in CENTRED.get(kind, ()):
            w = w - w.mean(dim=1, keepdim=True)
        out[f"{name}.weight"] = w
        at += i * o
    for name, _, o in dense:
        out[f"{name}.bias"] = draw[at:at + o] * BIAS_STD
        at += o
    for name, c in bns:
        parts = [draw[at + k * c:at + (k + 1) * c] * BIAS_STD for k in range(4)]
        at += 4 * c
        out[f"{name}.scale"] = 1.0 + parts[0]
        out[f"{name}.bias"] = parts[1]
        out[f"{name}.mean"] = parts[2]
        out[f"{name}.var"] = 1.0 + parts[3].abs()
    return {k: v.contiguous() for k, v in out.items()}


def load_into(module: torch.nn.Module, raw: dict) -> torch.nn.Module:
    """The program's ``module`` holding ``raw`` (every key, strictly), in
    eval mode."""
    module.load_state_dict({k: v.clone() for k, v in raw.items()}, strict=True)
    return module.eval()
