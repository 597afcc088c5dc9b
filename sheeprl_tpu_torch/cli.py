"""Command-line entry points of the port: ``run`` (training), ``evaluation``,
``serve``, ``serve_fleet``, ``registration`` (model export) and
``available_agents`` (counterparts of ``sheeprl_tpu/cli.py``'s).

Usage:
    python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy [overrides...]
    python -m sheeprl_tpu_torch eval checkpoint_path=<ckpt-or-run-dir> [overrides...]
    python -m sheeprl_tpu_torch serve checkpoint_path=<ckpt-or-run-dir> [overrides...]
    python -m sheeprl_tpu_torch register-model checkpoint_path=<ckpt-or-run-dir> [overrides...]
    python -m sheeprl_tpu_torch agents
"""

from __future__ import annotations

import pathlib
import sys
import warnings
from typing import List, Optional, Tuple

import yaml

from sheeprl_tpu_torch.config.compose import ConfigError, compose
from sheeprl_tpu_torch.utils.registry import (
    algorithm_registry,
    import_extra_modules,
    resolve_algorithm,
    resolve_entrypoint,
)
from sheeprl_tpu_torch.utils.structured import deep_merge, dotdict

#: modules whose import registers the port's algorithms and their evaluations
ALGORITHM_MODULES = (
    "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
    "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
    "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning",
    "sheeprl_tpu_torch.algos.ppo.ppo",
    "sheeprl_tpu_torch.algos.ppo.ppo_decoupled",
    "sheeprl_tpu_torch.algos.ppo.evaluate",
    "sheeprl_tpu_torch.algos.a2c.a2c",
    "sheeprl_tpu_torch.algos.a2c.evaluate",
    "sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent",
    "sheeprl_tpu_torch.algos.ppo_recurrent.evaluate",
    "sheeprl_tpu_torch.algos.sac.sac",
    "sheeprl_tpu_torch.algos.sac.sac_decoupled",
    "sheeprl_tpu_torch.algos.sac.evaluate",
    "sheeprl_tpu_torch.algos.droq.droq",
    "sheeprl_tpu_torch.algos.droq.evaluate",
    "sheeprl_tpu_torch.algos.sac_ae.sac_ae",
    "sheeprl_tpu_torch.algos.sac_ae.evaluate",
)


def register_all_algorithms() -> None:
    import importlib

    for name in ALGORITHM_MODULES:
        importlib.import_module(name)


def check_configs(cfg: dotdict) -> None:
    """Config sanity checks before dispatch."""
    if "algo" not in cfg or cfg.algo.get("name") in (None, "???"):
        raise ConfigError(
            "No algorithm specified: pass exp=<experiment> or algo=<name> "
            f"(registered: {', '.join(sorted(algorithm_registry))})"
        )
    if cfg.algo.name not in algorithm_registry:
        raise ConfigError(
            f"Algorithm '{cfg.algo.name}' is not ported to sheeprl_tpu_torch yet. "
            f"Registered: {', '.join(sorted(algorithm_registry))}"
        )
    if "env" not in cfg or cfg.env.get("id") in (None, "???"):
        raise ConfigError("No environment specified: set env=<group> / env.id=<id>")
    for field in ("total_steps", "per_rank_batch_size"):
        if cfg.algo.get(field) in (None, "???"):
            raise ConfigError(f"algo.{field} must be set")


def resume_from_checkpoint(cfg: dotdict) -> dotdict:
    """Merge the previous run's saved config under the new one, keeping the
    caller's ``total_steps`` / ``learning_starts``."""
    ckpt_path = pathlib.Path(cfg.checkpoint.resume_from)
    old_cfg_path = ckpt_path.parent.parent / "config.yaml"
    if not old_cfg_path.is_file():
        return cfg
    with open(old_cfg_path) as f:
        old = yaml.safe_load(f)
    keep = {"total_steps": cfg.algo.get("total_steps"), "learning_starts": cfg.algo.get("learning_starts")}
    out = dotdict(deep_merge(old, cfg.as_dict()))
    for k, v in keep.items():
        if v is not None:
            out.algo[k] = v
    out.checkpoint.resume_from = str(ckpt_path)
    return out


def resolve_resume_target(cfg: dotdict) -> dotdict:
    """``checkpoint.resume_from=auto`` → the newest committed snapshot of this
    experiment, or a fresh start (with a warning) when there is none."""
    if cfg.checkpoint.get("resume_from") != "auto":
        return cfg
    from sheeprl_tpu_torch.checkpoint.manager import resolve_auto_resume
    from sheeprl_tpu_torch.checkpoint.protocol import verify_or_quarantine

    damaged: set = set()
    target = resolve_auto_resume(cfg.get("log_dir", "logs/runs"), cfg.root_dir)
    while target is not None and cfg.checkpoint.get("verify_on_resume", True) and verify_or_quarantine(target):
        damaged.add(target)
        target = resolve_auto_resume(cfg.get("log_dir", "logs/runs"), cfg.root_dir, exclude=damaged)
    if target is None:
        warnings.warn("checkpoint.resume_from=auto: no committed checkpoint found; starting fresh", UserWarning)
        cfg.checkpoint.resume_from = None
    else:
        print(f"checkpoint.resume_from=auto -> {target}")
        cfg.checkpoint.resume_from = str(target)
    return cfg


def run(argv: Optional[List[str]] = None) -> None:
    """Compose the config, check it, and run the registered algorithm on the
    fabric's device."""
    from sheeprl_tpu_torch import telemetry
    from sheeprl_tpu_torch.checkpoint.preemption import PREEMPTION_GUARD
    from sheeprl_tpu_torch.fabric import apply_matmul_precision, build_fabric
    from sheeprl_tpu_torch.resilience.faults import install_from_config

    argv = list(sys.argv[1:] if argv is None else argv)
    # a preemption latched during an earlier run in this interpreter was
    # honoured by that run's final save: this run starts un-preempted
    PREEMPTION_GUARD.clear_latch()
    # the same for the hub and the flight recorder: an earlier run's logger
    # and step must not take this run's final flush, a postmortem of this
    # run holds this run's events, and a crashed loop's run-scoped sources go
    telemetry.HUB.reset()
    telemetry.HUB.unregister("health")
    telemetry.HUB.unregister("population")
    telemetry.RECORDER.clear()
    cfg = compose(argv)
    # arm (or clear) the fault plan before anything touches envs or
    # checkpoints; SHEEPRL_FAULT_PLAN wins over the config group
    install_from_config(cfg)
    cfg = resolve_resume_target(cfg)
    if cfg.checkpoint.get("resume_from"):
        cfg = resume_from_checkpoint(cfg)
    register_all_algorithms()
    import_extra_modules(cfg)
    check_configs(cfg)
    entry = resolve_algorithm(cfg.algo.name, decoupled=cfg.fabric.get("decoupled"))
    fabric = build_fabric(cfg)
    apply_matmul_precision(cfg.get("matmul_precision"), fabric.device)
    try:
        resolve_entrypoint(entry)(fabric, cfg)
        _maybe_register_models(cfg)
    except BaseException as e:
        # every abnormal exit leaves evidence: the recorder's ring (faults,
        # stalls, restarts, span edges, the crash) as postmortem.json
        # keeps the reason of a postmortem the failure already wrote (a
        # watchdog's give-up), with the crash event added
        telemetry.RECORDER.record("crash", error=f"{type(e).__name__}: {e}")
        telemetry.RECORDER.dump(telemetry.RECORDER.last_reason or "exception")
        raise
    finally:
        # a preempted loop has committed its final save by now, so the dump
        # adds nothing to the signal-to-commit time
        if PREEMPTION_GUARD.requested():
            telemetry.RECORDER.record("preemption", signal=PREEMPTION_GUARD.signal_name)
            telemetry.RECORDER.dump("preemption")
        # the monitors' counters since the last metric interval land through
        # the attached logger, then trace windows and the introspection
        # server stop; telemetry never masks the real exception
        telemetry.HUB.final_flush()
        telemetry.HUB.unregister("population")
        telemetry.shutdown_run()


def _maybe_register_models(cfg: dotdict) -> None:
    """With ``model_manager.disabled=False``, register the sub-models of the
    snapshot this run committed last.  Only the newest ``version_*``
    directory of the run is read: an older run's weights are never
    registered in place of a run that saved nothing.  The port runs one
    process, which is rank zero."""
    if (cfg.get("model_manager") or {}).get("disabled", True):
        return
    from sheeprl_tpu_torch.checkpoint.serialize import load_checkpoint
    from sheeprl_tpu_torch.utils.model_manager import last_checkpoint, register_model_from_checkpoint

    root = pathlib.Path(cfg.get("log_dir", "logs/runs")) / str(cfg.get("root_dir")) / str(cfg.get("run_name"))
    versions = sorted(root.glob("version_*"), key=lambda p: int(p.name.rsplit("_", 1)[-1]))
    newest = last_checkpoint(versions[-1]) if versions else None
    if newest is None:
        warnings.warn("model_manager.disabled=False but the run saved no checkpoint; nothing registered", UserWarning)
        return
    out = register_model_from_checkpoint(None, cfg, load_checkpoint(newest, map_location="cpu"))
    if out:
        print(f"Registered models from {newest}: {out}", flush=True)


def _split_checkpoint_arg(argv: Optional[List[str]], command: str) -> Tuple[str, List[str]]:
    argv = list(sys.argv[1:] if argv is None else argv)
    ckpt = [a for a in argv if a.startswith("checkpoint_path=")]
    if not ckpt:
        raise ConfigError(f"{command} requires checkpoint_path=<ckpt-or-run-dir>")
    return ckpt[0].split("=", 1)[1], [a for a in argv if not a.startswith("checkpoint_path=")]


def serve(argv: Optional[List[str]] = None) -> None:
    """Serve a committed snapshot as a continuous-batching policy server.

    Usage:
        python -m sheeprl_tpu_torch.serve checkpoint_path=<ckpt-or-run-dir> \\
            [fabric.accelerator=gpu] [serve.port=7455] [overrides...]

    The service runs every batch-ladder rung once before the socket is bound.
    """
    from sheeprl_tpu_torch.resilience.faults import install_from_config, install_from_env
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService

    checkpoint_path, rest = _split_checkpoint_arg(argv, "serve")
    # a SHEEPRL_FAULT_PLAN plan covers the load too; a config-group plan is
    # known only once the run's config is loaded beside the checkpoint
    install_from_env()
    service = PolicyService.from_checkpoint(checkpoint_path, rest)
    install_from_config(service.cfg)
    serve_cfg = service.cfg.get("serve") or {}
    server = PolicyServer(
        service, host=str(serve_cfg.get("host", "127.0.0.1")), port=int(serve_cfg.get("port", 7455))
    )
    print(
        f"serving {service.player.algo} (checkpoint step {service.store.step}) on {server.url} "
        f"({service.player.device}) — batch ladder {list(service.ladder)}",
        flush=True,
    )
    server.serve_forever()


def evaluation(argv: Optional[List[str]] = None) -> float:
    """Play one greedy episode with a committed snapshot and print its
    cumulative reward, through the evaluation registered for its algorithm:
    the latent player of a Dreamer family member (with the actor
    ``algo.player.actor_type`` chooses), the PPO, A2C or recurrent PPO
    agent, or the SAC, DroQ or SAC-AE actor.

    Usage:
        python -c "from sheeprl_tpu_torch.cli import evaluation; evaluation()" \
            checkpoint_path=<ckpt-or-run-dir> [fabric.accelerator=cpu] [overrides...]
    """
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import load_run_config, load_state, resolve_checkpoint
    from sheeprl_tpu_torch.utils.registry import evaluation_registry

    checkpoint_path, rest = _split_checkpoint_arg(argv, "evaluation")
    ckpt = resolve_checkpoint(checkpoint_path)
    cfg = load_run_config(ckpt, rest)
    cfg.fabric.devices = 1
    cfg.env.num_envs = 1
    register_all_algorithms()
    import_extra_modules(cfg)
    if cfg.algo.name not in evaluation_registry:
        raise ConfigError(
            f"no evaluation registered for algorithm '{cfg.algo.name}' "
            f"(available: {', '.join(sorted(evaluation_registry))})"
        )
    fabric = build_fabric(cfg)
    reward = evaluation_registry[cfg.algo.name](fabric, cfg, load_state(ckpt, cfg, fabric.device))
    print(f"Test/cumulative_reward: {reward}", flush=True)
    return reward


def serve_fleet(argv: Optional[List[str]] = None) -> None:
    """Serve a committed snapshot through the fleet: N replica processes
    (``python -m sheeprl_tpu_torch.serve``, each on the run's device) behind
    one health-checked router.

    Usage:
        python -m sheeprl_tpu_torch.serve.fleet checkpoint_path=<run-dir> \\
            [fabric.accelerator=gpu] [serve.fleet.replicas=2] [serve.fleet.port=7456] [overrides...]

    Prefer a run or version directory to a pinned ``step_*`` snapshot: a
    respawned replica resolves ``checkpoint_path`` again, and a pinned step
    would come back serving stale parameters after a rolling reload.
    """
    import signal

    from sheeprl_tpu_torch.fabric import run_device
    from sheeprl_tpu_torch.resilience.faults import install_from_config, install_from_env
    from sheeprl_tpu_torch.serve.fleet import FleetRouter, FleetServer, LocalFleet
    from sheeprl_tpu_torch.serve.loader import checkpoint_root, ensure_serve_config, load_run_config, resolve_checkpoint

    checkpoint_path, rest = _split_checkpoint_arg(argv, "serve_fleet")
    install_from_env()
    ckpt = resolve_checkpoint(checkpoint_path)
    cfg = ensure_serve_config(load_run_config(ckpt, rest))
    install_from_config(cfg)
    fleet_cfg = (cfg.get("serve") or {}).get("fleet") or {}
    fleet = LocalFleet(
        checkpoint_path,
        overrides=rest,
        replicas=int(fleet_cfg.get("replicas", 2)),
        respawn_max=int(fleet_cfg.get("respawn_max", 10)),
        backoff_base_s=float(fleet_cfg.get("respawn_backoff_base_s", 0.5)),
        backoff_max_s=float(fleet_cfg.get("respawn_backoff_max_s", 30.0)),
        seed=int(cfg.get("seed", 0) or 0),
        # a replica that cannot start on the run's device is a failure
        device=run_device(cfg).type,
    )
    # the replicas are this process's children: SIGTERM's default action
    # would end it before the ``finally`` reaps them, leaving servers bound
    # to their ports; routed through SystemExit, ``fleet.stop()`` runs
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(0))
    fleet.start()
    try:
        rolling = bool(fleet_cfg.get("rolling_reload", True))
        root = checkpoint_root(ckpt) if ckpt.is_dir() and rolling else None
        router = FleetRouter(fleet.addresses(), cfg, ckpt_root=root)
        fleet.attach(router)
        server = FleetServer(router, host=str(fleet_cfg.get("host", "127.0.0.1")), port=int(fleet_cfg.get("port", 7456)))
        print(
            f"fleet router over {fleet.n} replicas on {server.url} — rolling reload "
            f"{'on' if router.ckpt_root is not None else 'off'}, replicas: "
            + ", ".join(f"{rid}={url}" for rid, url in sorted(fleet.addresses().items())),
            flush=True,
        )
        server.serve_forever()
    finally:
        fleet.stop()


def registration(argv: Optional[List[str]] = None) -> dict:
    """Register a snapshot's sub-models with the model registry
    (``model_manager.*``): the ``MODELS_TO_REGISTER`` of the algorithm's
    ``utils`` module, else every entry of ``model_manager.models``.  A
    snapshot the JAX package wrote is converted first.  Returns
    ``{sub-model: version}``.

    Usage:
        python -m sheeprl_tpu_torch register-model checkpoint_path=<ckpt-or-run-dir> [overrides...]
    """
    import importlib

    from sheeprl_tpu_torch.serve.loader import load_run_config, load_state, resolve_checkpoint
    from sheeprl_tpu_torch.utils.model_manager import register_model_from_checkpoint

    checkpoint_path, rest = _split_checkpoint_arg(argv, "registration")
    ckpt = resolve_checkpoint(checkpoint_path)
    cfg = load_run_config(ckpt, rest)
    register_all_algorithms()
    import_extra_modules(cfg)
    entry = resolve_algorithm(cfg.algo.name)
    try:
        utils_mod = importlib.import_module(entry.module.rsplit(".", 1)[0] + ".utils")
    except ModuleNotFoundError:
        utils_mod = None
    state = load_state(ckpt, cfg, "cpu")  # the registry keeps CPU tensors
    log_models = getattr(utils_mod, "log_models_from_checkpoint", None)
    if log_models is not None:
        return log_models(None, cfg, state)
    versions = register_model_from_checkpoint(None, cfg, state, getattr(utils_mod, "MODELS_TO_REGISTER", None))
    print(f"Registered models: {versions}", flush=True)
    return versions


def available_agents() -> None:
    """Print every registered algorithm: name, module, entry point, decoupled."""
    register_all_algorithms()
    rows = [(name, e.module, e.entrypoint, str(e.decoupled))
            for name, entries in sorted(algorithm_registry.items()) for e in entries]
    try:
        from rich.console import Console
        from rich.table import Table
    except ImportError:
        for row in rows:
            print("\t".join(row))
        return
    table = Table(title="sheeprl-tpu-torch agents")
    for column in ("Algorithm", "Module", "Entrypoint", "Decoupled"):
        table.add_column(column)
    for row in rows:
        table.add_row(*row)
    Console().print(table)
