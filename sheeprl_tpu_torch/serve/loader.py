"""Checkpoint discovery + player rebuild: the port's snapshot-reconstruction
path of serving, whose discovery and run config ``cli.evaluation`` shares
(counterpart of ``sheeprl_tpu/serve/loader.py``).

Discovery accepts a committed ``step_*`` snapshot directory, a
``<run>/version_*/checkpoint`` root or a run directory (→ the newest
committed snapshot), and a single-file checkpoint (a legacy ``ckpt_*.ckpt``).
The run's ``config.yaml`` is found by walking up from the checkpoint, merged
under CLI overrides, and the player is rebuilt by the builder registered in
:mod:`sheeprl_tpu_torch.serve.players`.

A run the JAX package wrote is read the same way: its ``shard_r*.pkl``
shards or ``.ckpt`` pickle through the restricted unpickler of
``checkpoint/serialize.py`` (no JAX needed), its ``agent`` tree carried to
the port's modules by ``convert.state_from_jax`` (:func:`load_state`).
"""

from __future__ import annotations

import pathlib
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import yaml

from sheeprl_tpu_torch.checkpoint.protocol import (
    checkpoint_step,
    is_committed,
    list_checkpoints,
    verify_checkpoint,
    verify_or_quarantine,
)
from sheeprl_tpu_torch.config.compose import (
    ConfigError,
    _find_config_file,
    _load_yaml,
    _search_dirs,
    apply_cli_overrides,
)
from sheeprl_tpu_torch.utils.registry import import_extra_modules
from sheeprl_tpu_torch.utils.structured import deep_merge, dotdict


def resolve_checkpoint(path: Any, verify: bool = True) -> pathlib.Path:
    """Resolve a checkpoint spelling to a committed ``step_*`` directory.

    With ``verify``, shards are CRC-checked against the manifest first: a
    damaged snapshot found under a root is quarantined and the next newest
    committed one is used; an explicitly named damaged or torn ``step_*``
    directory raises."""
    p = pathlib.Path(path)
    if p.is_file():  # a single-file checkpoint
        return p
    if not p.exists():
        raise ConfigError(f"checkpoint path does not exist: {p}")
    if checkpoint_step(p) >= 0:
        if not is_committed(p):
            raise ConfigError(
                f"{p} is an uncommitted (torn) snapshot — it has no COMMIT marker and cannot be served"
            )
        if verify:
            problems = verify_checkpoint(p)
            if problems:
                raise ConfigError(f"{p} is a damaged snapshot ({'; '.join(problems)}) and cannot be served")
        return p
    candidates = [p / "checkpoint", p]
    candidates += sorted(
        p.glob("version_*/checkpoint"), key=lambda d: int(d.parent.name.rsplit("_", 1)[-1]), reverse=True
    )
    for root in candidates:
        if not root.is_dir():
            continue
        for candidate in reversed(list_checkpoints(root)):
            if not verify or not verify_or_quarantine(candidate):
                return candidate
            warnings.warn(f"skipping damaged snapshot {candidate} (quarantined)", RuntimeWarning)
    for root in candidates:  # the legacy flat layout
        ckpts = sorted(root.glob("ckpt_*.ckpt"), key=lambda f: f.stat().st_mtime) if root.is_dir() else []
        if ckpts:
            return ckpts[-1]
    raise ConfigError(f"no committed checkpoint found under {p}")


def checkpoint_root(ckpt: Any) -> pathlib.Path:
    """The directory a commit watcher polls for newer snapshots: the parent
    of a resolved ``step_*`` directory."""
    return pathlib.Path(ckpt).parent


def load_state(ckpt: Any, cfg: dotdict, device: Any) -> Dict[str, Any]:
    """A resolved snapshot's state with its tensors on ``device``: the
    port's as written, a JAX-written one with its ``agent`` converted for
    ``cfg.algo.name`` (``convert.state_from_jax``)."""
    from sheeprl_tpu_torch.checkpoint.serialize import is_jax_checkpoint, load_checkpoint

    if not is_jax_checkpoint(ckpt):
        return load_checkpoint(ckpt, map_location=device)
    from sheeprl_tpu_torch.convert import state_from_jax

    def to_device(tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: to_device(v) for k, v in tree.items()}
        return tree.to(device) if isinstance(tree, torch.Tensor) else tree

    return to_device(state_from_jax(load_checkpoint(ckpt), cfg))


def load_run_config(ckpt: Any, overrides: Sequence[str] = ()) -> dotdict:
    """The run's saved ``config.yaml`` (next to the checkpoint dir), with
    ``overrides`` applied on top."""
    ckpt = pathlib.Path(ckpt)
    for parent in ckpt.parents:
        cfg_path = parent / "config.yaml"
        if cfg_path.is_file():
            with open(cfg_path) as f:
                cfg = dotdict(yaml.safe_load(f))
            if overrides:
                apply_cli_overrides(cfg, list(overrides))
            return cfg
    raise ConfigError(f"cannot find the run config next to the checkpoint: {ckpt}")


def write_run_config(run_dir: Any, cfg: dotdict) -> pathlib.Path:
    """Save ``cfg`` as ``<run_dir>/config.yaml``, where :func:`load_run_config` finds it."""
    path = pathlib.Path(run_dir) / "config.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg)))
    return path


def serve_defaults() -> Dict[str, Any]:
    """The ``serve`` config group's defaults (run configs saved before the
    serving layer existed have no ``serve`` section)."""
    path = _find_config_file("serve/default", _search_dirs())
    return _load_yaml(path) if path is not None else {}


def ensure_serve_config(cfg: dotdict) -> dotdict:
    """Merge the serve defaults UNDER whatever the run config/overrides set."""
    merged = deep_merge({"serve": serve_defaults()}, cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
    return dotdict(merged)


def probe_spaces(cfg: dotdict) -> Tuple[Any, Any]:
    """Observation/action spaces from one probe env instance."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0)()
    obs_space, action_space = env.observation_space, env.action_space
    env.close()
    return obs_space, action_space


def build_player(fabric: Any, cfg: dotdict, state: Dict[str, Any]) -> Any:
    """Rebuild the serving player for ``cfg.algo.name`` from a loaded state."""
    from sheeprl_tpu_torch.serve.players import PLAYER_BUILDERS

    builder = PLAYER_BUILDERS.get(cfg.algo.name)
    if builder is None:
        raise ConfigError(
            f"no serving player registered for algorithm '{cfg.algo.name}' "
            f"(available: {', '.join(sorted(PLAYER_BUILDERS))})"
        )
    obs_space, action_space = probe_spaces(cfg)
    return builder(fabric, cfg, state, obs_space, action_space)


def load_policy(
    checkpoint_path: Any,
    overrides: Sequence[str] = (),
    fabric: Optional[Any] = None,
    cfg: Optional[dotdict] = None,
) -> Tuple[Any, dotdict, Dict[str, Any], Any]:
    """Snapshot → ``(fabric, cfg, state, player)``.  Serving is one device,
    one env: the run config is forced to ``fabric.devices=1`` and
    ``env.num_envs=1`` after the overrides."""
    from sheeprl_tpu_torch.fabric import build_fabric

    ckpt = resolve_checkpoint(checkpoint_path)
    if cfg is None:
        cfg = load_run_config(ckpt, overrides)
    import_extra_modules(cfg)  # an external algorithm's player registers at import
    cfg.fabric.devices = 1
    cfg.env.num_envs = 1
    cfg.env.capture_video = cfg.env.get("capture_video", False)
    cfg = ensure_serve_config(cfg)
    if fabric is None:
        fabric = build_fabric(cfg)
    state = load_state(ckpt, cfg, fabric.device)
    player = build_player(fabric, cfg, state)
    player.checkpoint_step = checkpoint_step(ckpt)
    return fabric, cfg, state, player
