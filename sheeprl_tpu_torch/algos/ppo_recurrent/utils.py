"""Recurrent PPO utilities (counterparts of ``sheeprl_tpu/algos/ppo_recurrent/utils.py``)."""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from sheeprl_tpu_torch.algos.ppo.utils import AGGREGATOR_KEYS  # noqa: F401


def flat_obs(obs: Dict[str, np.ndarray], mlp_keys: Sequence[str], device: Any) -> Dict[str, torch.Tensor]:
    """A step batch of vector observations as ``(B, width)`` float tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(obs[k], np.float32).reshape(len(obs[k]), -1)).to(device)
            for k in mlp_keys}


def test(agent: Any, cfg: Any, log_dir: str, logger: Any = None, greedy: bool = True) -> float:
    """One evaluation episode with the recurrent agent on its own device
    (greedy by default); returns the cumulative reward."""
    from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, spaces_to_dims
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import one_hot_actions
    from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import _sample
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, run_name=log_dir, prefix="test")()
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous = spaces_to_dims(env.action_space)
    device = next(agent.parameters()).device
    gen = torch.Generator(device).manual_seed(int(cfg.seed))
    obs, _ = env.reset(seed=cfg.seed)
    carry = agent.initial_state(1, device)
    prev_a = torch.zeros(1, int(sum(actions_dim)), device=device)
    first = torch.ones(1, 1, device=device)
    done, cum_reward = False, 0.0
    while not done:
        with torch.no_grad():
            carry, (actor_out, _) = agent.step(carry, flat_obs({k: np.asarray(obs[k])[None] for k in mlp_keys},
                                                               mlp_keys, device), prev_a, first)
            a, _ = _sample(actor_out, actions_dim, is_continuous, gen, greedy=greedy)
        obs, reward, terminated, truncated, _ = env.step(actions_for_env(a.cpu().numpy(), env.action_space)[0])
        done = bool(terminated or truncated)
        prev_a = one_hot_actions(a, actions_dim, is_continuous)
        first = torch.zeros(1, 1, device=device)
        cum_reward += float(reward)
    env.close()
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cum_reward}, 0)
    return cum_reward
