"""PPO support utilities (counterparts of ``sheeprl_tpu/algos/ppo/utils.py``):
the action-space helpers every player shares, the observation layout of the
on-policy agents, the encoder-key check and the greedy test episode."""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.utils.utils import merge_framestack

AGGREGATOR_KEYS = {
    "Rewards/rew_avg",
    "Game/ep_len_avg",
    "Loss/value_loss",
    "Loss/policy_loss",
    "Loss/entropy_loss",
}


def actions_for_env(actions: np.ndarray, action_space: spaces.Space) -> np.ndarray:
    """Stored float actions → what the env expects."""
    if isinstance(action_space, spaces.Discrete):
        return actions.astype(np.int64).reshape(-1)
    if isinstance(action_space, spaces.MultiDiscrete):
        return actions.astype(np.int64)
    low = np.asarray(action_space.low, np.float32)
    high = np.asarray(action_space.high, np.float32)
    return np.clip(actions.astype(np.float32), low, high)


def spaces_to_dims(action_space: spaces.Space) -> Tuple[Tuple[int, ...], bool]:
    """Action-space → (per-branch dims, is_continuous)."""
    if isinstance(action_space, spaces.Discrete):
        return (int(action_space.n),), False
    if isinstance(action_space, spaces.MultiDiscrete):
        return tuple(int(n) for n in action_space.nvec), False
    if isinstance(action_space, spaces.Box):
        return (int(np.prod(action_space.shape)),), True
    raise ValueError(f"Unsupported action space {type(action_space)}")


def obs_to_np(x: np.ndarray, is_image: bool, rollout: bool = False) -> np.ndarray:
    """Host-side layout of one observation key: images (frame stacks merged
    into channels) → float32 ``/ 255``, vectors → float32.  ``rollout``
    reads a 5-D image array as ``(T, B, H, W, C)`` (a stacked rollout is
    6-D) instead of a stacked ``(B, S, H, W, C)`` step batch."""
    if is_image:
        return np.asarray(merge_image_stack(x, rollout), np.float32) / 255.0
    return np.asarray(x, np.float32)


def merge_image_stack(x: np.ndarray, rollout: bool = False) -> np.ndarray:
    """A step batch ``(B, S, H, W, C)`` or a rollout ``(T, B, S, H, W, C)`` of
    frame-stacked images → ``(..., H, W, S·C)``; unstacked images as they are."""
    x = np.asarray(x)
    return merge_framestack(x) if x.ndim == (6 if rollout else 5) else x


def prepare_obs(obs: Dict[str, np.ndarray], cnn_keys: Sequence[str] = (), mlp_keys: Sequence[str] = (),
                device: Any = "cpu", rollout: bool = False) -> Dict[str, torch.Tensor]:
    """Host observations → float tensors on ``device``, laid out as
    :func:`obs_to_np` lays them out; images move as uint8 and are scaled on
    ``device`` (the same numbers, a quarter of the bytes on the way)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(merge_image_stack(obs[k], rollout))).to(device) for k in cnn_keys}
    out = {k: v.to(torch.float32) / 255.0 for k, v in out.items()}
    out.update({k: torch.from_numpy(np.asarray(obs[k], np.float32)).to(device) for k in mlp_keys})
    return out


def normalize_obs_keys(cfg: Any, obs_space: spaces.Dict) -> None:
    """Check the configured encoder keys against the env's observation space."""
    for group in ("cnn_keys", "mlp_keys"):
        keys = cfg.algo[group].encoder
        missing = [k for k in keys if k not in obs_space.spaces]
        if missing:
            raise ValueError(
                f"Configured {group}.encoder={list(keys)} but {missing} not in "
                f"observation space keys {list(obs_space.spaces)}"
            )
    if not cfg.algo.cnn_keys.encoder and not cfg.algo.mlp_keys.encoder:
        raise ValueError("At least one of algo.cnn_keys.encoder / algo.mlp_keys.encoder must be set")


def test(agent: Any, cfg: Any, log_dir: str, logger: Any = None, greedy: bool = True) -> float:
    """One evaluation episode of a PPO or A2C agent on its own device
    (greedy by default, else sampled from a generator seeded with
    ``cfg.seed``); returns the cumulative reward."""
    from sheeprl_tpu_torch.algos.ppo.agent import sample_actions
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, run_name=log_dir, prefix="test")()
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous = spaces_to_dims(env.action_space)
    dist_type = cfg.get("distribution", {}).get("type", "auto")
    device = next(agent.parameters()).device
    gen = torch.Generator(device).manual_seed(int(cfg.seed))
    obs, _ = env.reset(seed=cfg.seed)
    done, cum_reward = False, 0.0
    while not done:
        batched = {k: np.asarray(v)[None] for k, v in obs.items()}
        with torch.inference_mode():
            out, _ = agent(prepare_obs(batched, cnn_keys, mlp_keys, device))
            action, _, _ = sample_actions(out, actions_dim, is_continuous, gen, greedy=greedy, dist_type=dist_type)
        obs, reward, terminated, truncated, _ = env.step(actions_for_env(action.cpu().numpy(), env.action_space)[0])
        done = bool(terminated or truncated)
        cum_reward += float(reward)
    env.close()
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cum_reward}, 0)
    return cum_reward
