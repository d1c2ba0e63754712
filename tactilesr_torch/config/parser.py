"""YAML-over-argparse config parsing (the port's copy of
``tactilesr_tpu/config/parser.py``).

An ``argparse.ArgumentParser`` whose defaults a ``-c/--config`` YAML file
can override (CLI flags still win), and one flag per scalar config key.
``yaml`` is imported only when a file is read.
"""

from __future__ import annotations

import argparse

__all__ = ["ConfigArgumentParser", "add_config_args", "apply_overrides"]


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse with YAML-file defaults injection via ``-c/--config``."""

    def __init__(self, *args, **kwargs):
        self.config_parser = argparse.ArgumentParser(add_help=False)
        self.config_parser.add_argument(
            "-c", "--config", default=None, metavar="FILE",
            help="where to load YAML configuration",
        )
        self.option_names = []
        super().__init__(*args, parents=[self.config_parser], **kwargs)

    def add_argument(self, *args, **kwargs):
        arg = super().add_argument(*args, **kwargs)
        self.option_names.append(arg.dest)
        return arg

    def parse_args(self, args=None):
        res, remaining = self.config_parser.parse_known_args(args)
        if res.config is not None:
            import yaml

            with open(res.config) as f:
                config_vars = yaml.safe_load(f) or {}
            unknown = set(config_vars) - set(self.option_names)
            if unknown:
                self.error(f"unknown keys in config file: {sorted(unknown)}")
            self.set_defaults(**config_vars)
        return super().parse_args(remaining)


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def add_config_args(parser: argparse.ArgumentParser, config: dict) -> None:
    """Declare one CLI flag per scalar config key (so both ``--key value``
    and ``-c overrides.yaml`` can override the defaults)."""
    for key, val in config.items():
        if isinstance(val, bool):
            parser.add_argument(f"--{key}", type=_parse_bool, default=None)
        elif isinstance(val, (int, float, str)):
            parser.add_argument(f"--{key}", type=type(val), default=None)


def apply_overrides(config: dict, args: argparse.Namespace) -> dict:
    """Overlay non-None parsed flags onto a config dict copy."""
    out = dict(config)
    for key in out:
        override = getattr(args, key, None)
        if override is not None:
            out[key] = override
    return out
