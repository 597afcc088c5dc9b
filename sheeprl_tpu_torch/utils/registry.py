"""The algorithm and evaluation registries (from ``sheeprl_tpu/utils/registry.py``).

Decorator-driven name -> (module, entrypoint, decoupled) maps: algorithms
self-register at import time and ``cli.run`` dispatches by ``cfg.algo.name``;
``cli.evaluation`` dispatches a snapshot to the evaluation registered for its
algorithm.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

# name -> list of entries (a name may expose both coupled and decoupled forms
# under different registered entrypoints, like the reference's ppo/ppo_decoupled)
algorithm_registry: Dict[str, List["AlgorithmEntry"]] = {}
# algorithm name -> evaluation function (fabric, cfg, state) -> cumulative reward
evaluation_registry: Dict[str, Callable] = {}


@dataclass
class AlgorithmEntry:
    name: str
    module: str
    entrypoint: str
    decoupled: bool = False


def register_algorithm(decoupled: bool = False, name: Optional[str] = None) -> Callable:
    """Class-free registration: decorate the algorithm's ``main`` function.

    The registered name defaults to the leaf module name (``...algos.ppo.ppo``
    registers ``ppo``), matching how users select algorithms via
    ``algo=<name>`` / ``cfg.algo.name``.
    """

    def decorator(fn: Callable) -> Callable:
        module = fn.__module__
        algo_name = name or module.rsplit(".", 1)[-1]
        entry = AlgorithmEntry(algo_name, module, fn.__name__, decoupled)
        entries = algorithm_registry.setdefault(algo_name, [])
        if not any(e.module == module and e.entrypoint == entry.entrypoint for e in entries):
            entries.append(entry)
        return fn

    return decorator


def resolve_algorithm(name: str, decoupled: Optional[bool] = None) -> AlgorithmEntry:
    entries = algorithm_registry.get(name)
    if not entries:
        available = ", ".join(sorted(algorithm_registry))
        raise ValueError(f"Unknown algorithm '{name}'. Registered: {available}")
    if decoupled is None:
        return entries[0]
    for e in entries:
        if e.decoupled == decoupled:
            return e
    return entries[0]


def resolve_entrypoint(entry: AlgorithmEntry) -> Callable:
    module = sys.modules.get(entry.module)
    if module is None:
        import importlib

        module = importlib.import_module(entry.module)
    return getattr(module, entry.entrypoint)


def register_evaluation(algorithms: Union[str, Sequence[str]]) -> Callable:
    """Register ``fn(fabric, cfg, state) -> cumulative reward`` as the
    evaluation of the snapshots of ``algorithms``."""

    def decorator(fn: Callable) -> Callable:
        for name in [algorithms] if isinstance(algorithms, str) else algorithms:
            evaluation_registry[name] = fn
        return fn

    return decorator


def import_extra_modules(cfg: Any) -> None:
    """Import the packages of ``algo.extra_modules``, so that their
    ``@register_algorithm`` / ``@register_evaluation`` (and
    ``register_player``) decorators run: the extension point of
    ``howto/register_external_algorithm.md``.  Called by ``cli.run``,
    ``cli.evaluation``, ``cli.registration`` and, through
    ``serve.loader.load_policy``, by serving."""
    import importlib

    for mod in (cfg.get("algo") or {}).get("extra_modules") or []:
        importlib.import_module(mod)
