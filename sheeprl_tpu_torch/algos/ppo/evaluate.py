"""PPO evaluation (counterpart of ``sheeprl_tpu/algos/ppo/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Dict

from sheeprl_tpu_torch.algos.ppo.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims, test
from sheeprl_tpu_torch.utils.env import make_env
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.registry import register_evaluation


@register_evaluation(algorithms=["ppo", "ppo_decoupled"])
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    """One greedy test episode of a PPO (decoupled or not; or A2C: the same agent) snapshot;
    returns the cumulative reward."""
    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous = spaces_to_dims(env.action_space)
    obs_space = env.observation_space
    env.close()
    agent = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state["agent"])
    reward = test(agent, cfg, log_dir, logger)
    if logger is not None:
        logger.close()
    return reward
