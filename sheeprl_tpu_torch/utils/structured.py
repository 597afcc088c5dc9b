"""Attribute-access config containers.

The reference resolves every Hydra config to a plain ``dotdict`` before any
algorithm code runs (reference: sheeprl/utils/utils.py:34-60), so that train
loops are config-framework-free.  We keep the same boundary: the compose
engine (sheeprl_tpu_torch/config/compose.py) produces a ``dotdict`` tree and nothing
below the CLI ever sees YAML machinery.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping


class dotdict(dict):
    """A dict with attribute access, recursively converting nested mappings.

    Lists of mappings are converted element-wise.  Unknown attribute reads
    raise ``AttributeError`` (not ``KeyError``) so ``getattr(cfg, "x", None)``
    works as expected.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        src: Dict[str, Any] = dict(*args, **kwargs)
        for k, v in src.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dotdict):
            return value
        if isinstance(value, Mapping):
            return dotdict(value)
        if isinstance(value, (list, tuple)):
            wrapped = [dotdict._wrap(v) for v in value]
            return type(value)(wrapped) if isinstance(value, tuple) else wrapped
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, dotdict._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self:
            self[key] = default
        return self[key]

    def as_dict(self) -> Dict[str, Any]:
        """Deep-convert back to plain builtins (for YAML/pickle dumps)."""

        def unwrap(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def copy(self) -> "dotdict":
        return dotdict(self.as_dict())


def get_by_path(tree: Mapping[str, Any], path: str) -> Any:
    """Fetch ``tree[a][b][c]`` for ``path == "a.b.c"``."""
    node: Any = tree
    for part in path.split("."):
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(path)
        node = node[part]
    return node


def set_by_path(tree: Dict[str, Any], path: str, value: Any) -> None:
    """Set ``tree[a][b][c] = value`` for ``path == "a.b.c"``, creating nodes."""
    parts = path.split(".")
    node: Dict[str, Any] = tree
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = dotdict() if isinstance(node, dotdict) else {}
            node[part] = nxt
        node = node[part]
    node[parts[-1]] = value


def deep_merge(base: Dict[str, Any], overlay: Mapping[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``overlay`` into ``base`` (mutates and returns base).

    Dicts merge key-wise; everything else (including lists) is replaced.
    """
    for k, v in overlay.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), dict):
            deep_merge(base[k], v)
        else:
            base[k] = v
    return base
