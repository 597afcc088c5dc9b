"""Recurrent PPO agent (counterpart of ``sheeprl_tpu/algos/ppo_recurrent/agent.py``).

A feature MLP over the observations concatenated with the one-hot previous
actions, optional pre- and post-RNN MLPs, an LSTM cell whose carry crosses
steps (zeroed where ``is_first``), and actor and critic heads on its output.
The LSTM is ``torch.nn.LSTMCell``: flax's ``OptimizedLSTMCell`` computes the
same gates in the same ``i, f, g, o`` order, and ``convert.py`` stacks its
per-gate kernels into the cell's ``weight_ih`` / ``weight_hh``.  The carry is
``(c, h)``, as in flax.  The time loop is a Python loop over T.

The MLPs compute in the compute ``dtype``; the LSTM stays fp32 under every
policy, as flax's cell does (it takes no ``dtype``, so its bf16 input is
promoted to its fp32 kernels), and the heads' outputs come back fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sheeprl_tpu_torch.algos.ppo.agent import place_agent
from sheeprl_tpu_torch.models.models import MLP, variance_scaling_

Carry = Tuple[torch.Tensor, torch.Tensor]


class RecurrentPPOAgent(nn.Module):
    def __init__(self, actions_dim: Sequence[int], is_continuous: bool, mlp_keys: Sequence[str], obs_dim: int,
                 encoder_units: int, mlp_layers: int, dense_act: str, layer_norm: bool, lstm_size: int,
                 pre_rnn: Dict[str, Any], post_rnn: Dict[str, Any], actor_cfg: Dict[str, Any],
                 critic_cfg: Dict[str, Any], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp_keys = tuple(mlp_keys)
        self.lstm_size = lstm_size
        self.encoder = MLP(obs_dim + int(sum(actions_dim)), (encoder_units,) * mlp_layers, activation=dense_act,
                           layer_norm=layer_norm, dtype=dtype)
        d = self.encoder.out_features
        self.pre_rnn_mlp = self.post_rnn_mlp = None
        if pre_rnn.get("apply"):
            self.pre_rnn_mlp = MLP(d, (pre_rnn["dense_units"],), activation=pre_rnn.get("activation", "relu"),
                                   layer_norm=pre_rnn.get("layer_norm", False), dtype=dtype)
            d = self.pre_rnn_mlp.out_features
        self.lstm = nn.LSTMCell(d, lstm_size)
        # flax's input kernels have no bias: bias_ih stays zero and untrained
        self.lstm.bias_ih.requires_grad_(False)
        d = lstm_size
        if post_rnn.get("apply"):
            self.post_rnn_mlp = MLP(d, (post_rnn["dense_units"],), activation=post_rnn.get("activation", "relu"),
                                    layer_norm=post_rnn.get("layer_norm", False), dtype=dtype)
            d = self.post_rnn_mlp.out_features
        self.actor = _head(d, actor_cfg, int(sum(actions_dim)) * (2 if is_continuous else 1), dtype)
        self.critic = _head(d, critic_cfg, 1, dtype)

    def step(self, carry: Carry, obs: Dict[str, torch.Tensor], prev_actions: torch.Tensor,
             is_first: torch.Tensor) -> Tuple[Carry, Tuple[torch.Tensor, torch.Tensor]]:
        """One step of a ``(B, ...)`` batch; ``is_first`` (B, 1) zeroes the carry
        first.  Returns the new carry and ``(actor_out, value)``."""
        mask = 1.0 - is_first
        c, h = carry[0] * mask, carry[1] * mask
        x = self.encoder(torch.cat([obs[k] for k in self.mlp_keys] + [prev_actions], dim=-1))
        if self.pre_rnn_mlp is not None:
            x = self.pre_rnn_mlp(x)
        h, c = self.lstm(x.float(), (h, c))
        out = self.post_rnn_mlp(h) if self.post_rnn_mlp is not None else h
        return (c, h), (self.actor(out).float(), self.critic(out).float())

    def forward(self, obs_seq: Dict[str, torch.Tensor], prev_actions_seq: torch.Tensor, is_first_seq: torch.Tensor,
                initial_state: Carry) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step over a ``(T, B, ...)`` sequence from ``initial_state``;
        returns ``(actor_out, values)``, each ``(T, B, ·)``."""
        carry, actor_out, values = initial_state, [], []
        for t in range(prev_actions_seq.shape[0]):
            carry, (a, v) = self.step(carry, {k: obs_seq[k][t] for k in self.mlp_keys}, prev_actions_seq[t],
                                      is_first_seq[t])
            actor_out.append(a)
            values.append(v)
        return torch.stack(actor_out), torch.stack(values)

    def initial_state(self, batch: int, device: Any = None) -> Carry:
        return (torch.zeros(batch, self.lstm_size, device=device), torch.zeros(batch, self.lstm_size, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init: the MLPs ``lecun_normal``; the LSTM's input kernels
        ``lecun_normal`` and recurrent kernels orthogonal, gate by gate, with
        zero biases."""
        for mlp in (self.encoder, self.pre_rnn_mlp, self.post_rnn_mlp, self.actor, self.critic):
            if mlp is not None:
                mlp.init_weights(generator)
        H, d_in = self.lstm_size, self.lstm.input_size
        with torch.no_grad():
            for gate in range(4):
                rows = slice(gate * H, (gate + 1) * H)
                variance_scaling_(self.lstm.weight_ih[rows], d_in, H, "fan_in", generator)
                nn.init.orthogonal_(self.lstm.weight_hh[rows], generator=generator)
            self.lstm.bias_ih.zero_()
            self.lstm.bias_hh.zero_()


def _head(input_dim: int, cfg: Dict[str, Any], output_dim: int, dtype: torch.dtype = torch.float32) -> MLP:
    return MLP(input_dim, (cfg.get("dense_units", 64),) * cfg.get("mlp_layers", 1), output_dim,
               activation=cfg.get("dense_act", "relu"), layer_norm=cfg.get("layer_norm", False), dtype=dtype)


def one_hot_actions(actions: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool) -> torch.Tensor:
    """Stored actions as the next step's input: one-hot per discrete branch,
    the values themselves for continuous actions."""
    if is_continuous:
        return actions
    return torch.cat([F.one_hot(actions[..., i].long(), d).to(torch.float32) for i, d in enumerate(actions_dim)],
                     dim=-1)


def build_agent(fabric: Any, actions_dim: Sequence[int], is_continuous: bool, cfg: Any, obs_space: Any,
                agent_state: Optional[Dict[str, torch.Tensor]] = None) -> RecurrentPPOAgent:
    """The agent on ``fabric.device``, from ``agent_state`` or initialised
    like flax from ``cfg.seed``."""
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    a = cfg.algo
    with torch.device("meta" if agent_state is not None else fabric.device):
        agent = RecurrentPPOAgent(
            tuple(actions_dim), is_continuous, mlp_keys,
            obs_dim=sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys),
            encoder_units=a.encoder.dense_units, mlp_layers=a.mlp_layers, dense_act=a.dense_act,
            layer_norm=a.layer_norm, lstm_size=a.rnn.lstm.hidden_size, pre_rnn=dict(a.rnn.pre_rnn_mlp),
            post_rnn=dict(a.rnn.post_rnn_mlp), actor_cfg=dict(a.actor), critic_cfg=dict(a.critic),
            dtype=fabric.precision.compute_dtype,
        )
    return place_agent(agent, agent_state, fabric.device, int(cfg.seed))
