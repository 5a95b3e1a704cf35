"""YAML config system with dot-access namespaces.

Reads the repository's ``configs/*.yaml`` unchanged: sections and flags load
into a dict subclass with attribute access, as in the reference's
``utils/yaml_configs.py``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Mapping

import yaml


class Config(dict):
    """A dict with attribute access, recursively applied."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for key, value in data.items():
            self[key] = value

    def __setitem__(self, key, value):
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        elif isinstance(value, list):
            value = [Config(v) if isinstance(v, Mapping) else v for v in value]
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            if isinstance(value, Config):
                out[key] = value.to_dict()
            elif isinstance(value, list):
                out[key] = [v.to_dict() if isinstance(v, Config) else v for v in value]
            else:
                out[key] = value
        return out


def load_yaml(path: str) -> Config:
    """Load a YAML config file into a dot-access namespace."""
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    return Config(data or {})


def save_yaml(config: Config, path: str | None = None) -> str:
    """Write ``config`` as YAML to ``path``, by default
    ``{SETTINGS.log_path or "."}/{SETTINGS.name or "run"}.yaml`` (the
    directory made if missing). Returns the path."""
    if path is None:
        settings = config.get("SETTINGS", {})
        log_path = settings.get("log_path") or "."
        os.makedirs(log_path, exist_ok=True)
        path = os.path.join(log_path, f"{settings.get('name', 'run')}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config.to_dict(), f, sort_keys=False)
    return path


def default_config_path() -> str:
    """Path of the shipped default config, ``configs/config.yaml``."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "configs", "config.yaml")


def apply_overrides(config: Config, items) -> Config:
    """Apply ``SECTION.key=value`` settings (``value`` read as YAML)."""
    for item in items:
        key, value = item.split("=", 1)
        section, flag = key.split(".")
        config[section][flag] = yaml.safe_load(value)
    return config


def arguments(argv=None) -> dict:
    """CLI of the apps: ``--config_path``, ``--name``, ``--data_path`` and
    ``--set SECTION.key=value`` (repeatable, applied last)."""
    parser = argparse.ArgumentParser(description="e2eslam_tpu_torch")
    parser.add_argument("--config_path", type=str, default=default_config_path())
    parser.add_argument("--name", type=str, default="run")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--set", action="append", default=[], metavar="SECTION.key=value")
    return vars(parser.parse_args(argv))


def load_config(argv=None) -> Config:
    """Parse CLI args and return the loaded config with SETTINGS.name set."""
    args = arguments(argv)
    config = load_yaml(args["config_path"])
    config.SETTINGS.name = args["name"]
    if args.get("data_path"):
        config.DATA.data_path = args["data_path"]
    return apply_overrides(config, args["set"])
