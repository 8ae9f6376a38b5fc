"""Layered YAML configuration with ``${a.b}`` interpolation — the port's own
copy of ``gpt2_image_captioning_tpu/core/config.py`` (the port imports
nothing of the JAX package).

``config.yml`` + ``automation_config.yml`` overrides are merged with a
recursive update and resolved with OmegaConf-style interpolation:

- :class:`Config` — a nested mapping with attribute *and* item access.
- ``${dotted.path}`` string interpolation, resolved lazily against the root,
  so overrides applied after loading are picked up.
- :func:`update_cfg` — the recursive partial-override merge of the sweep.

The schema is the JAX package's, ``tpu:`` block included: the port reads
``tpu.compute_dtype``, ``remat``, ``grad_accum_steps``, ``mesh``, ``decode``
and ``beam_size`` as they stand.
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Iterator, Mapping

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class InterpolationError(Exception):
    """A ``${dotted.path}`` reference points at a missing config key."""


class Config(Mapping):
    """Nested dict with attribute access and lazy ``${path}`` interpolation."""

    def __init__(self, data: dict[str, Any] | None = None, _root: "Config | None" = None):
        object.__setattr__(self, "_data", dict(data or {}))
        object.__setattr__(self, "_root", _root)

    # -- helpers ---------------------------------------------------------
    def _resolve(self, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, _root=self._root_cfg())
        if isinstance(value, str) and "${" in value:
            root = self._root_cfg()

            def repl(m: re.Match) -> str:
                target: Any = root
                for part in m.group(1).split("."):
                    try:
                        target = target[part]
                    except (KeyError, TypeError) as e:
                        raise InterpolationError(
                            f"config interpolation '${{{m.group(1)}}}' cannot be resolved"
                        ) from e
                return str(target)

            return _INTERP_RE.sub(repl, value)
        return value

    def _root_cfg(self) -> "Config":
        return self._root if self._root is not None else self

    # -- mapping protocol --------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._resolve(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value.to_dict() if isinstance(value, Config) else value

    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self[k]) for k in self._data]

    def values(self):
        return [self[k] for k in self._data]

    # -- conversion --------------------------------------------------------
    def to_dict(self, resolve: bool = False) -> dict[str, Any]:
        """Plain-dict view. With ``resolve=True`` interpolations are expanded."""
        if not resolve:
            return copy.deepcopy(self._data)
        out: dict[str, Any] = {}
        for k in self._data:
            v = self[k]
            out[k] = v.to_dict(resolve=True) if isinstance(v, Config) else v
        return out

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, dict):
            return self.to_dict(resolve=True) == other
        return NotImplemented

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(resolve=True), f, indent=2)


def load_config(path: str = "config.yml") -> Config:
    """Load a YAML config file; ``${...}`` interpolations resolve on access."""
    with open(path, "r") as f:
        return Config(yaml.safe_load(f))


def update_cfg(cfg: Config | dict, updates: Mapping | None) -> Config:
    """Recursively merge partial-override dicts into ``cfg``.

    Nested dicts merge key-by-key, scalars/lists replace.  Returns a new
    :class:`Config`; inputs are not mutated.
    """
    base = cfg.to_dict() if isinstance(cfg, Config) else copy.deepcopy(dict(cfg))

    def merge(dst: dict, src: Mapping) -> dict:
        for k, v in src.items():
            if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return dst

    if updates:
        merge(base, updates)
    return Config(base)
