"""YAML config loading (port of ``fusion4landslide_tpu.config``; reference
utils/common.py:20-39 ``load_yaml``).

The on-disk schema is the reference's: one YAML per (method, dataset)
pair, whose top-level sections are flattened into one attribute namespace
(``keep_sub_directory=True`` also keeps the sections).
"""

from __future__ import annotations

from typing import Any

import yaml

__all__ = ["Config", "load_yaml"]


class Config(dict):
    """dict with attribute access, recursively wrapping nested dicts."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj


def load_yaml(path: str, keep_sub_directory: bool = False) -> Config:
    """Load a YAML config, its top-level sections flattened into one
    namespace; with ``keep_sub_directory=True`` (the fusion driver) each
    section is also kept under its own name."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    flat: dict[str, Any] = {}
    for key, value in raw.items():
        if isinstance(value, dict):
            flat.update(value)
            if keep_sub_directory:
                flat[key] = value
        else:
            flat[key] = value
    return Config.wrap(flat)
