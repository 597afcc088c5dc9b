"""DroQ agent (counterpart of ``sheeprl_tpu/algos/droq/agent.py``): SAC's
actor and temperature with :class:`DroQCriticEnsemble`, whose N Q-functions
each run Dense → Dropout → LayerNorm → ReLU twice, then a fp32 head.

Dropout is an argument of the call, as in JAX (``train=True`` with the keep
``masks``, one (N, B, hidden) bool tensor per layer, drawn by
:meth:`DroQCriticEnsemble.dropout_masks` or handed in by a test), not a
module mode: the DroQ update runs it in all three critic calls (the
target, the critic loss and the actor's Q).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent, place_agent
from sheeprl_tpu_torch.models.models import StackedLayerNorm, StackedLinear


class DroQCriticEnsemble(nn.Module):
    """``q_ensemble.{dense_0, ln_0, dense_1, ln_1, head}`` of stacked weights
    (the LayerNorm is the repo's fp32 wrapper, eps 1e-5); output (N, B).  The
    layers compute in ``dtype``, the head in fp32, as in JAX."""

    def __init__(self, in_dim: int, n_critics: int = 2, hidden_size: int = 256, dropout: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n, self.hidden, self.dropout = int(n_critics), int(hidden_size), float(dropout)
        self.q_ensemble = nn.Module()
        d = in_dim
        for i in range(2):
            self.q_ensemble.add_module(f"dense_{i}", StackedLinear(self.n, d, self.hidden, dtype))
            self.q_ensemble.add_module(f"ln_{i}", StackedLayerNorm(self.n, self.hidden, eps=1e-5, dtype=dtype))
            d = self.hidden
        self.q_ensemble.add_module("head", StackedLinear(self.n, d, 1))

    def dropout_masks(self, batch: int, generator: torch.Generator) -> Optional[List[torch.Tensor]]:
        """The keep masks of one training call, drawn on the generator's device
        (None without dropout)."""
        if self.dropout <= 0:
            return None
        return [torch.rand((self.n, batch, self.hidden), generator=generator, device=generator.device)
                >= self.dropout for _ in range(2)]

    def forward(self, obs: torch.Tensor, action: torch.Tensor, train: bool = False,
                masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        drop = train and self.dropout > 0
        if drop and masks is None:
            raise ValueError("a training call of the dropout critic needs its keep masks")
        for i in range(2):
            x = getattr(self.q_ensemble, f"dense_{i}")(x)
            if drop:
                x = torch.where(masks[i], x / (1.0 - self.dropout), torch.zeros_like(x))
            x = torch.relu(getattr(self.q_ensemble, f"ln_{i}")(x))
        return self.q_ensemble.head(x)[..., 0]

    def init_weights(self, generator: torch.Generator) -> None:
        for i in range(2):
            getattr(self.q_ensemble, f"dense_{i}").init_weights(generator)
            ln = getattr(self.q_ensemble, f"ln_{i}")
            with torch.no_grad():
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.q_ensemble.head.init_weights(generator)


def build_agent(fabric: Any, act_dim: int, cfg: Any, obs_dim: int,
                state: Optional[Dict[str, torch.Tensor]] = None) -> SACAgent:
    a = cfg.algo
    dtype = fabric.precision.compute_dtype
    with torch.device("meta" if state is not None else fabric.device):
        agent = SACAgent(SACActor(obs_dim, act_dim, int(a.actor.hidden_size), dtype=dtype),
                         DroQCriticEnsemble(obs_dim + act_dim, int(a.critic.n), int(a.critic.hidden_size),
                                            float(a.critic.dropout), dtype),
                         float(a.alpha.alpha))
    return place_agent(agent, state, fabric.device, int(cfg.seed))
