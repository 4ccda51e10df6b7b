"""YAML config with attribute access (counterpart of
`mm_unet_tpu/utils/config.py`): the schema of `config.yml` (trainer.*,
dataset.<NAME>.*, finetune.*, models.<name>.branch*).

PyYAML is imported inside `load_config` only: where it is missing (the
GPU machine), a config is built as a `ConfigDict` in code.
"""

from __future__ import annotations

from typing import Any


class ConfigDict(dict):
    """dict with recursive attribute access (EasyDict equivalent)."""

    def __init__(self, d: dict | None = None, **kwargs):
        super().__init__()
        for k, v in {**(d or {}), **kwargs}.items():
            self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                ConfigDict(v) if isinstance(v, dict) else v for v in value
            )
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


def load_config(path: str = "config.yml") -> ConfigDict:
    import yaml

    with open(path) as f:
        return ConfigDict(yaml.safe_load(f))
