"""SAC agent (counterpart of ``sheeprl_tpu/algos/sac/agent.py``).

:class:`SACActor` is a ReLU MLP ``trunk`` with two ``mean`` and ``log_std``
heads (the log-std clipped to [-5, 2]) parameterising a
:class:`~sheeprl_tpu_torch.utils.distribution.TanhNormal`.
:class:`SACCriticEnsemble` holds N Q-networks as one module of stacked
``(N, in, out)`` weights, the layout of the JAX package's params-vmapped
``q_ensemble``: every layer of all N members is one batched product, and
the output is (N, B).  :class:`SACAgent` carries the actor, the critic, its
target copy and the learnable temperature ``log_alpha`` as one module, so
one ``state_dict`` is the agent's checkpoint.

Sampling takes a ``torch.Generator`` or the standard-normal noise itself,
so a test can hand the port the draws JAX's keys make.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from sheeprl_tpu_torch.models.models import MLP, Dense, StackedLinear, lecun_init_
from sheeprl_tpu_torch.utils.distribution import TanhNormal

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0

Noise = Union[torch.Generator, torch.Tensor, None]


class SACActor(nn.Module):
    """A ReLU trunk in ``dtype``, then fp32 ``mean`` and ``log_std`` heads."""

    def __init__(self, obs_dim: int, act_dim: int, hidden_size: int = 256, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = MLP(obs_dim, (hidden_size,) * num_layers, activation="relu", dtype=dtype)
        self.mean = Dense(hidden_size, act_dim)
        self.log_std = Dense(hidden_size, act_dim)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.trunk(obs)
        return self.mean(x), torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX)

    def init_weights(self, generator: torch.Generator) -> None:
        self.trunk.init_weights(generator)
        lecun_init_(self.mean, generator)
        lecun_init_(self.log_std, generator)


class SACCriticEnsemble(nn.Module):
    """N ReLU MLP Q-functions on ``[obs, action]``: ``q_ensemble.dense_{i}``
    and ``q_ensemble.head`` of stacked weights; output (N, B).  ``train`` and
    ``masks`` are the dropout critic's (:class:`~sheeprl_tpu_torch.algos.droq.agent.DroQCriticEnsemble`)
    and change nothing here.  Every layer, the head too, computes in
    ``dtype``, as the JAX ensemble's MLP does."""

    def __init__(self, in_dim: int, n_critics: int = 2, hidden_size: int = 256, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = num_layers
        self.q_ensemble = nn.Module()
        d = in_dim
        for i in range(num_layers):
            self.q_ensemble.add_module(f"dense_{i}", StackedLinear(n_critics, d, hidden_size, dtype))
            d = hidden_size
        self.q_ensemble.add_module("head", StackedLinear(n_critics, d, 1, dtype))

    def forward(self, obs: torch.Tensor, action: torch.Tensor, train: bool = False,
                masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        x = torch.cat([obs, action], dim=-1)
        for i in range(self.n_layers):
            x = torch.relu(getattr(self.q_ensemble, f"dense_{i}")(x))
        return self.q_ensemble.head(x)[..., 0]

    def dropout_masks(self, batch: int, generator: torch.Generator) -> Optional[List[torch.Tensor]]:
        return None

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.q_ensemble.children():
            m.init_weights(generator)


class SACAgent(nn.Module):
    """``actor``, ``critic``, ``target_critic`` (a copy of the critic, never
    trained by a gradient) and ``log_alpha`` (0-d)."""

    def __init__(self, actor: nn.Module, critic: nn.Module, alpha: float):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.target_critic = copy.deepcopy(critic)
        self.log_alpha = nn.Parameter(torch.tensor(math.log(alpha), dtype=torch.float32))
        self.alpha = float(alpha)

    def init_weights(self, generator: torch.Generator) -> None:
        self.actor.init_weights(generator)
        self.critic.init_weights(generator)
        self.target_critic.load_state_dict(self.critic.state_dict())
        with torch.no_grad():
            self.log_alpha.fill_(math.log(self.alpha))


def sample_action(actor: nn.Module, obs: torch.Tensor, noise: Noise = None,
                  greedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(action, log_prob)`` in the actor's tanh space [-1, 1]: greedy gives
    the mode and a zero log-prob; otherwise a sample from ``noise`` (a
    generator, or the standard-normal draws (B, act_dim))."""
    mean, log_std = actor(obs)
    dist = TanhNormal(mean, torch.exp(log_std))
    if greedy:
        return dist.mode(), torch.zeros(mean.shape[:-1], device=mean.device)
    if isinstance(noise, torch.Generator):
        return dist.sample_and_log_prob(noise)
    return dist.sample_and_log_prob_from_noise(noise)


@torch.no_grad()
def ema_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """Polyak averaging in place: ``t = (1 - tau) * t + tau * o``."""
    t = [p for p in target.parameters()]
    torch._foreach_mul_(t, 1.0 - tau)
    torch._foreach_add_(t, [p for p in online.parameters()], alpha=tau)


def place_agent(agent: nn.Module, state: Optional[Dict[str, torch.Tensor]], device: Any, seed: int) -> nn.Module:
    """``agent`` (built on the meta device when ``state`` is given) loaded
    from ``state``, or initialised from ``seed``, on ``device``; the target
    networks take no gradient."""
    if state is not None:
        agent.load_state_dict(state, strict=True, assign=True)
    else:
        agent.init_weights(torch.Generator(device).manual_seed(int(seed)))
    agent = agent.to(device)
    for name, module in agent.named_children():
        if name.startswith("target_"):
            module.requires_grad_(False)
    return agent


def build_agent(fabric: Any, act_dim: int, cfg: Any, obs_dim: int,
                state: Optional[Dict[str, torch.Tensor]] = None) -> SACAgent:
    """The agent on ``fabric.device``, from ``state`` (its ``state_dict``) or
    initialised like flax from ``cfg.seed``; ``log_alpha = log(alpha.alpha)``.
    The modules compute in ``fabric.precision.compute_dtype``."""
    a = cfg.algo
    dtype = fabric.precision.compute_dtype
    with torch.device("meta" if state is not None else fabric.device):
        agent = SACAgent(SACActor(obs_dim, act_dim, int(a.actor.hidden_size), dtype=dtype),
                         SACCriticEnsemble(obs_dim + act_dim, int(a.critic.n), int(a.critic.hidden_size), dtype=dtype),
                         float(a.alpha.alpha))
    return place_agent(agent, state, fabric.device, int(cfg.seed))
