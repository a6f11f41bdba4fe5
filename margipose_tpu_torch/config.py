"""Minimal sacred-style experiment configuration.

A copy of ``margipose_tpu/config.py``.

Reproduces the reference's config UX (reference:
src/margipose/bin/train_3d.py:229-264, README.md:84-91): defaults + composable
named configs + CLI overrides, invoked as

    margipose train with margipose_model mpi3d quick epochs=5 "key={...}"

Values after ``with`` are named-config names or ``key=value`` overrides
(values parsed as Python literals, falling back to strings).
"""

from __future__ import annotations

import ast
import copy


class Experiment:
    def __init__(self, defaults: dict | None = None):
        self.defaults = dict(defaults or {})
        self.named_configs: dict[str, dict] = {}

    def add_config(self, **kwargs):
        self.defaults.update(kwargs)

    def add_named_config(self, name: str, **kwargs):
        self.named_configs[name] = kwargs

    def parse(self, argv: list[str]) -> dict:
        """Parse ``[with name... key=value...]`` into a config dict.

        Dict-valued overrides and named-config entries deep-merge into the
        existing value, sacred-style (reference:
        src/margipose/bin/train_3d.py:229-264 + README.md:84-91 — e.g.
        ``"model_desc={'settings': {'pixelwise_loss': None}}"`` updates just
        that key, keeping the named config's type/version/settings intact).
        """
        config = copy.deepcopy(self.defaults)
        args = list(argv)
        if args and args[0] == 'with':
            args = args[1:]
        for arg in args:
            if '=' in arg:
                key, _, raw = arg.partition('=')
                try:
                    value = ast.literal_eval(raw)
                except (ValueError, SyntaxError):
                    value = raw
                _set_dotted(config, key.strip(), value)
            elif arg in self.named_configs:
                _deep_merge(config, copy.deepcopy(self.named_configs[arg]))
            else:
                raise SystemExit(
                    f"unknown named config or override: {arg!r} "
                    f"(available: {sorted(self.named_configs)})"
                )
        return config


def _deep_merge(dst: dict, src: dict) -> dict:
    """Recursively merge ``src`` into ``dst`` (in place): dicts merge,
    everything else overwrites."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _set_dotted(config: dict, key: str, value):
    parts = key.split('.')
    node = config
    for p in parts[:-1]:
        existing = node.get(p)
        if existing is None:
            existing = node[p] = {}
        elif not isinstance(existing, dict):
            # fail loudly: `with epochs.max=5` must not silently discard the
            # existing scalar `epochs` value
            raise TypeError(
                f"cannot set '{key}': '{p}' holds a non-dict value "
                f"({existing!r})")
        node = existing
    last = parts[-1]
    if isinstance(value, dict) and isinstance(node.get(last), dict):
        _deep_merge(node[last], value)
    else:
        node[last] = value
