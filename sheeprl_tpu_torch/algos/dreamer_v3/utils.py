"""DreamerV3 support utilities (counterparts of ``sheeprl_tpu/algos/dreamer_v3/utils.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.utils.utils import merge_framestack

#: the sub-models of a snapshot that ``cli.registration`` registers
MODELS_TO_REGISTER = {"world_model", "actor", "critic", "target_critic", "moments"}

def moments_update(
    moments: Dict[str, torch.Tensor],
    x: torch.Tensor,
    decay: float = 0.99,
    max_: float = 1.0,
    plow: float = 0.05,
    phigh: float = 0.95,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Return-percentile normaliser.  Returns (new_moments, offset, invscale).

    The quantiles interpolate linearly, as ``jnp.quantile`` does
    (``torch.quantile`` takes at most 2**24 elements)."""
    x = x.detach().float().reshape(-1)
    # the percentiles made on the device by fills: a tensor from host data
    # would be a blocking copy inside a guarded window
    at = torch.stack([torch.full((), p, device=x.device, dtype=x.dtype) for p in (plow, phigh)])
    q = torch.quantile(x, at)
    new_low = decay * moments["low"] + (1 - decay) * q[0]
    new_high = decay * moments["high"] + (1 - decay) * q[1]
    invscale = torch.clamp(new_high - new_low, min=1.0 / max_)
    return {"low": new_low, "high": new_high}, new_low, invscale


def compute_lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """TD(λ) over imagined steps: ``out[t] = r[t] + c[t]·((1-λ)·v[t] +
    λ·out[t+1])``, bootstrapped with ``v[-1]``; ``continues`` folds in γ."""
    next_ret = values[-1]
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        next_ret = rewards[t] + continues[t] * ((1 - lmbda) * values[t] + lmbda * next_ret)
        out.append(next_ret)
    return torch.stack(out[::-1], dim=0)


def prepare_obs(
    obs: Dict[str, np.ndarray],
    cnn_keys: Sequence[str] = (),
    mlp_keys: Sequence[str] = (),
    device: Any = "cpu",
) -> Dict[str, torch.Tensor]:
    """uint8 images → [-0.5, 0.5] floats; vectors → float32 (the symlog is
    inside the encoder), as tensors on ``device``."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        x = np.asarray(obs[k])
        if x.ndim == 5:  # (B, S, H, W, C) frame stack → channels
            x = merge_framestack(x)
        out[k] = torch.from_numpy(np.ascontiguousarray(x)).to(device).float() / 255.0 - 0.5
    for k in mlp_keys:
        x = np.asarray(obs[k], np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(x.reshape(x.shape[0], -1))).to(device)
    return out


def normalize_obs_block(data: Dict[str, torch.Tensor], cnn_keys, obs_keys, offset: float = 0.5):
    """Observation normalisation of a uint8-shipped replay block: images →
    float/255 − offset, vectors → float (the block twin of :func:`prepare_obs`)."""
    return {
        k: (data[k].float() / 255.0 - offset) if k in cnn_keys else data[k].float()
        for k in obs_keys
    }


def test(
    player_step_fn: Callable,
    cfg: Any,
    log_dir: str,
    logger: Any = None,
    greedy: bool = True,
) -> float:
    """One greedy evaluation episode with the latent-state player.
    ``player_step_fn(carry, obs, greedy) -> (carry, env_action)``, with
    ``carry=None`` at the start of the episode."""
    from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env(cfg, cfg.seed, 0, run_name=log_dir, prefix="test")()
    obs, _ = env.reset(seed=cfg.seed)
    carry = None
    done, cum_reward = False, 0.0
    while not done:
        batched = {k: np.asarray(v)[None] for k, v in obs.items()}
        carry, env_action = player_step_fn(carry, batched, greedy)
        obs, reward, terminated, truncated, _ = env.step(actions_for_env(np.asarray(env_action), env.action_space)[0])
        done = bool(terminated or truncated)
        cum_reward += float(reward)
    env.close()
    if logger is not None:
        logger.log_metrics({"Test/cumulative_reward": cum_reward}, 0)
    return cum_reward
