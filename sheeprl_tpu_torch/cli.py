"""Command-line entry points of the port: ``serve`` and ``evaluation``
(counterparts of ``sheeprl_tpu/cli.py``'s, for algorithms with a serving
player)."""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

from sheeprl_tpu_torch.config.compose import ConfigError


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
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService

    checkpoint_path, rest = _split_checkpoint_arg(argv, "serve")
    service = PolicyService.from_checkpoint(checkpoint_path, rest)
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


def evaluation(argv: Optional[List[str]] = None) -> None:
    """Play one greedy episode with a committed snapshot through the serving
    player and print its cumulative reward."""
    from sheeprl_tpu_torch.serve.loader import evaluate_player, load_policy

    checkpoint_path, rest = _split_checkpoint_arg(argv, "evaluation")
    _, cfg, _, player = load_policy(checkpoint_path, rest)
    print(f"Test/cumulative_reward: {evaluate_player(cfg, player)}", flush=True)
