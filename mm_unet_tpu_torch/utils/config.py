"""YAML config with attribute access (counterpart of
`mm_unet_tpu/utils/config.py`): the schema of `config.yml` (trainer.*,
dataset.<NAME>.*, finetune.*, models.<name>.branch*).

PyYAML is imported inside `load_config` only: where it is missing (the
GPU machine), `load_config` reads the subset of YAML that config.yml uses
(`load_yaml_subset`) and refuses anything else.
"""

from __future__ import annotations

import re
from typing import Any

_INT = re.compile(r"^[-+]?\d+$")
_FLOAT = re.compile(r"^[-+]?(\d*\.\d+|\d+\.\d*)([eE][-+]?\d+)?$")  # YAML 1.1: a dot


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


def _scalar(text: str):
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text.lower() in ("true", "false", "yes", "no", "on", "off") and text in (
            text.lower(), text.capitalize(), text.upper()):  # YAML 1.1's booleans
        return text.lower() in ("true", "yes", "on")
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def load_yaml_subset(text: str) -> dict:
    """The YAML of config.yml, as `yaml.safe_load` reads it: nested
    mappings by indentation, `key: scalar`, inline lists `[a, b]` of
    scalars, and `#` comments. Raises ValueError on anything else."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping) of the open mappings
    for n, line in enumerate(text.splitlines(), start=1):
        body = re.sub(r"(^|\s)#.*$", "", line).rstrip()
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        key, sep, value = body.strip().partition(":")
        if not sep or key.startswith(("-", "[", "{", "'", '"')) or (value and value[0] != " "):
            raise ValueError(f"line {n}: not in the YAML subset load_yaml_subset reads: {line!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        value = value.strip()
        if not value:
            stack[-1][1][key] = child = {}
            stack.append((indent, child))
        elif value.startswith("[") and value.endswith("]"):
            items = value[1:-1].strip()
            stack[-1][1][key] = [_scalar(v.strip()) for v in items.split(",")] if items else []
        elif value[0] in "{|>&*!":
            raise ValueError(f"line {n}: not in the YAML subset load_yaml_subset reads: {line!r}")
        else:
            stack[-1][1][key] = _scalar(value)

    def empty_to_none(d: dict) -> dict:  # `key:` with nothing under it is null
        return {k: (empty_to_none(v) or None) if isinstance(v, dict) else v for k, v in d.items()}

    return empty_to_none(root)


def load_config(path: str = "config.yml") -> ConfigDict:
    """The YAML file at `path`, by PyYAML where it is installed, else by
    `load_yaml_subset`."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return ConfigDict(load_yaml_subset(text))
    return ConfigDict(yaml.safe_load(text))
