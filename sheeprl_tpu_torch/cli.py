"""Command-line entry points of the port: ``run`` (training), ``serve`` and
``evaluation`` (counterparts of ``sheeprl_tpu/cli.py``'s).

Usage:
    python -m sheeprl_tpu_torch exp=dreamer_v3 env=dummy [overrides...]
"""

from __future__ import annotations

import pathlib
import sys
import warnings
from typing import List, Optional, Tuple

import yaml

from sheeprl_tpu_torch.config.compose import ConfigError, compose
from sheeprl_tpu_torch.utils.registry import algorithm_registry, resolve_algorithm, resolve_entrypoint
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
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.resilience.faults import install_from_config

    argv = list(sys.argv[1:] if argv is None else argv)
    # a preemption latched during an earlier run in this interpreter was
    # honoured by that run's final save: this run starts un-preempted
    PREEMPTION_GUARD.clear_latch()
    # the same for the hub and the flight recorder: an earlier run's logger
    # and step must not take this run's final flush, a postmortem of this
    # run holds this run's events, and a crashed loop's health source goes
    telemetry.HUB.reset()
    telemetry.HUB.unregister("health")
    telemetry.RECORDER.clear()
    cfg = compose(argv)
    # arm (or clear) the fault plan before anything touches envs or
    # checkpoints; SHEEPRL_FAULT_PLAN wins over the config group
    install_from_config(cfg)
    cfg = resolve_resume_target(cfg)
    if cfg.checkpoint.get("resume_from"):
        cfg = resume_from_checkpoint(cfg)
    register_all_algorithms()
    check_configs(cfg)
    entry = resolve_algorithm(cfg.algo.name, decoupled=cfg.fabric.get("decoupled"))
    fabric = build_fabric(cfg)
    try:
        resolve_entrypoint(entry)(fabric, cfg)
    except BaseException as e:
        # every abnormal exit leaves evidence: the recorder's ring (faults,
        # stalls, restarts, span edges, the crash) as postmortem.json
        telemetry.RECORDER.record("crash", error=f"{type(e).__name__}: {e}")
        telemetry.RECORDER.dump("exception")
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
        telemetry.shutdown_run()


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
    from sheeprl_tpu_torch.serve.loader import load_run_config, resolve_checkpoint
    from sheeprl_tpu_torch.utils.registry import evaluation_registry

    checkpoint_path, rest = _split_checkpoint_arg(argv, "evaluation")
    ckpt = resolve_checkpoint(checkpoint_path)
    cfg = load_run_config(ckpt, rest)
    cfg.fabric.devices = 1
    cfg.env.num_envs = 1
    register_all_algorithms()
    if cfg.algo.name not in evaluation_registry:
        raise ConfigError(
            f"no evaluation registered for algorithm '{cfg.algo.name}' "
            f"(available: {', '.join(sorted(evaluation_registry))})"
        )
    fabric = build_fabric(cfg)
    reward = evaluation_registry[cfg.algo.name](fabric, cfg, fabric.load(ckpt))
    print(f"Test/cumulative_reward: {reward}", flush=True)
    return reward
