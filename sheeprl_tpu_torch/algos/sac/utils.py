"""SAC support utilities (counterparts of ``sheeprl_tpu/algos/sac/utils.py``):
the vector observation layout, the action maps between the actor's tanh
space and the env's bounds, and the test episode."""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/alpha_loss",
}
MODELS_TO_REGISTER = {"agent"}


def prepare_obs(obs: Dict[str, np.ndarray], mlp_keys: Sequence[str]) -> np.ndarray:
    """The vector observation keys of a ``(B, ...)`` batch concatenated into
    one float32 ``(B, obs_dim)`` matrix (SAC and DroQ read vectors only)."""
    parts = [np.asarray(obs[k], np.float32).reshape(np.asarray(obs[k]).shape[0], -1) for k in mlp_keys]
    return np.concatenate(parts, axis=-1)


def to_env_actions(actions: np.ndarray, action_space: Any) -> np.ndarray:
    """Actions in the actor's tanh space [-1, 1] → the env's bounds."""
    low = np.asarray(action_space.low, np.float32)
    high = np.asarray(action_space.high, np.float32)
    return low + (actions + 1.0) * 0.5 * (high - low)


def to_tanh_space(env_actions: np.ndarray, action_space: Any) -> np.ndarray:
    """Env actions (the prefill's ``action_space.sample()``) → the actor's
    tanh space, clipped to [-1, 1]."""
    low = np.asarray(action_space.low, np.float32)
    high = np.asarray(action_space.high, np.float32)
    span = high - low
    return np.clip(2.0 * (env_actions - low) / np.where(span == 0, 1, span) - 1.0, -1, 1)


def test(act: Callable[[Dict[str, np.ndarray], bool], np.ndarray], cfg: Any, log_dir: str, logger: Any = None,
         greedy: bool = True) -> float:
    """One evaluation episode; ``act(batched raw obs, greedy)`` gives the
    (1, act_dim) action in tanh space, rescaled here to the env's bounds.
    Returns the cumulative reward."""
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, run_name=log_dir, prefix="test")()
    obs, _ = env.reset(seed=cfg.seed)
    done, cum_reward = False, 0.0
    while not done:
        action = act({k: np.asarray(v)[None] for k, v in obs.items()}, greedy)[0]
        obs, reward, terminated, truncated, _ = env.step(to_env_actions(action, env.action_space))
        done = bool(terminated or truncated)
        cum_reward += float(reward)
    env.close()
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cum_reward}, 0)
    return cum_reward

