"""Policy-as-a-service for the port: loader, players, batcher, service and
a stdlib HTTP server/client (see ``sheeprl_tpu/serve`` for the reference)."""

from sheeprl_tpu_torch.serve.batcher import AdmissionQueue, QueueFull, pick_ladder_size
from sheeprl_tpu_torch.serve.loader import (
    build_player,
    load_policy,
    load_run_config,
    resolve_checkpoint,
)
from sheeprl_tpu_torch.serve.players import PLAYER_BUILDERS, PolicyPlayer, register_player
from sheeprl_tpu_torch.serve.service import PolicyService

__all__ = [
    "AdmissionQueue",
    "PLAYER_BUILDERS",
    "PolicyPlayer",
    "PolicyService",
    "QueueFull",
    "build_player",
    "load_policy",
    "load_run_config",
    "pick_ladder_size",
    "register_player",
    "resolve_checkpoint",
]
