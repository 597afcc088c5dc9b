"""Anakin rollouts: the env stepped on the device inside the on-policy update
(counterpart of ``sheeprl_tpu/envs/jax/anakin.py``).

The JAX package scans {observe → policy forward → sample → env step →
truncation bootstrap → episode accounting} inside one compiled program.
Here the rollout is a Python loop of ``T`` steps over device tensors: every
step enqueues its launches and none of them waits for the device, so the
host runs ahead of the card for the whole rollout and the env's state never
leaves it (:func:`compile_rollout` captures the whole loop as one CUDA
graph on the card).  Nothing in the loop may synchronise: no ``.item()``, no
Python ``if`` on a tensor, no ``nonzero`` or boolean-mask indexing, no copy
to the host.  Autoreset is ``torch.where`` over every leaf
(:class:`~sheeprl_tpu_torch.envs.device.core.VectorDeviceEnv`), and the
episode statistics stay on the device until :func:`episode_stats_from_device`
pulls them once per rollout.

The rollout's layout is what the trainers' ``train_phase`` takes from the
host loop: ``(T, B, ...)`` observations pre-normalised (uint8 images →
fp32 / 255), actions in their stored float layout, truncation-bootstrapped
rewards ``r + γ·V(final_obs)`` (the value of the true last observation under
the current weights, computed for every row on every step as JAX does) and
float dones.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.device.core import VectorDeviceEnv

Noise = Union[torch.Generator, Sequence[Any]]


def prep_obs_fn(cnn_keys: Sequence[str], mlp_keys: Sequence[str]) -> Callable:
    """The device-side observation layout of the on-policy agents: images
    fp32 / 255, vectors fp32 (device envs do not stack frames)."""

    def prep(obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {k: obs[k].to(torch.float32) / 255.0 for k in cnn_keys}
        out.update({k: obs[k].to(torch.float32) for k in mlp_keys})
        return out

    return prep


def env_actions_fn(action_space: spaces.Space, device: Any) -> Callable:
    """Stored float actions → what the env's ``step`` takes."""
    if isinstance(action_space, spaces.Discrete):
        return lambda a: a[..., 0].long()
    if isinstance(action_space, spaces.MultiDiscrete):
        return lambda a: a.long()
    low = torch.as_tensor(np.asarray(action_space.low, np.float32), device=device)
    high = torch.as_tensor(np.asarray(action_space.high, np.float32), device=device)
    return lambda a: torch.clamp(a.to(torch.float32), low, high)


def init_actor_state(venv: VectorDeviceEnv, start_update: int,
                     extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Reset the envs and make the actor carry: the env state, the running
    episode returns and lengths, ``extra`` leaves (the recurrent loop's LSTM
    state, previous actions and episode-start mask) and the update counter."""
    env_state, _ = venv.reset()
    return {
        "env": env_state,
        "ep_ret": torch.zeros(venv.num_envs, dtype=torch.float32, device=venv.device),
        "ep_len": torch.zeros(venv.num_envs, dtype=torch.int32, device=venv.device),
        **(extra or {}),
        "update": int(start_update),
    }


def _noise_at(noise: Noise, t: int) -> Any:
    return noise if isinstance(noise, torch.Generator) else noise[t]


def _stack(steps: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-step dicts of ``(B, ...)`` tensors as ``(T, B, ...)`` tensors."""
    return {k: torch.stack([step[k] for step in steps]) for k in steps[0]}


def _episode_step(ep_ret, ep_len, reward, done):
    """One step's episode accounting: the step's record and the running
    sums, restarted on done rows."""
    ep_ret = ep_ret + reward
    ep_len = ep_len + 1
    record = {"ep_done": done, "ep_ret": ep_ret, "ep_len": ep_len}
    return record, torch.where(done, 0.0, ep_ret), torch.where(done, 0, ep_len)


def make_rollout_fn(venv: VectorDeviceEnv, agent: Callable, sample_fn: Callable, *, cnn_keys: Sequence[str],
                    mlp_keys: Sequence[str], action_space: spaces.Space, gamma: float, rollout_steps: int,
                    store_logprobs: bool = True) -> Callable:
    """Build ``rollout(actor, noise, reset_draws=None) -> (actor', rollout,
    last_obs, stats)``.

    ``agent(obs) -> (actor_out, value)``; ``sample_fn(actor_out, noise) ->
    (actions, logprobs, ...)`` with ``noise`` the player's generator or, when
    a sequence is given, its ``t``-th entry; ``reset_draws`` hands each step's
    reset draws to the env.  ``stats`` holds ``(T, B)`` episode-completion
    tensors, left on the device."""
    prep = prep_obs_fn(cnn_keys, mlp_keys)
    to_env = env_actions_fn(action_space, venv.device)
    obs_keys = tuple(cnn_keys) + tuple(mlp_keys)

    @torch.no_grad()
    def rollout(actor: Dict[str, Any], noise: Noise, reset_draws: Optional[Sequence[Dict]] = None):
        env_state, ep_ret, ep_len = actor["env"], actor["ep_ret"], actor["ep_len"]
        traj, stats = [], []
        for t in range(rollout_steps):
            pobs = prep(venv.observe(env_state))
            out, _ = agent(pobs)
            actions, logprobs = sample_fn(out, _noise_at(noise, t))[:2]
            env_state, _, reward, term, trunc, final_obs = venv.step(
                env_state, to_env(actions), None if reset_draws is None else reset_draws[t])
            _, v_final = agent(prep(final_obs))
            done = term | trunc
            step = {**{k: pobs[k] for k in obs_keys}, "actions": actions,
                    "rewards": reward + gamma * v_final[..., 0] * trunc.to(torch.float32),
                    "dones": done.to(torch.float32)}
            if store_logprobs:
                step["logprobs"] = logprobs
            traj.append(step)
            record, ep_ret, ep_len = _episode_step(ep_ret, ep_len, reward, done)
            stats.append(record)
        last_obs = prep(venv.observe(env_state))
        new_actor = {"env": env_state, "ep_ret": ep_ret, "ep_len": ep_len, "update": actor["update"] + 1}
        return new_actor, _stack(traj), last_obs, _stack(stats)

    return rollout


def make_recurrent_rollout_fn(venv: VectorDeviceEnv, step_fn: Callable, sample_fn: Callable,
                              encode_prev_actions: Callable, *, mlp_keys: Sequence[str],
                              action_space: spaces.Space, gamma: float, rollout_steps: int) -> Callable:
    """The recurrent twin of :func:`make_rollout_fn` for ``ppo_recurrent``:
    the LSTM state, the previous-action encoding and the episode-start mask
    live in the actor carry.

    ``step_fn(carry, obs, prev_actions, is_first) -> (carry', (actor_out,
    value))`` is the agent's single step; ``encode_prev_actions(actions)`` the
    next step's action input.  Returns ``rollout(actor, noise,
    reset_draws=None) -> (actor', rollout, init_carry, last_values, stats)``,
    the rollout with the ``prev_actions`` and ``is_first`` sequences the
    recurrent train phase takes.  The truncation bootstrap runs the post-step
    recurrent state on the true final observation."""
    prep = prep_obs_fn((), mlp_keys)
    to_env = env_actions_fn(action_space, venv.device)
    n = venv.num_envs

    def flat(obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.reshape(n, -1) for k, v in prep(obs).items()}

    @torch.no_grad()
    def rollout(actor: Dict[str, Any], noise: Noise, reset_draws: Optional[Sequence[Dict]] = None):
        env_state, carry = actor["env"], actor["carry"]
        prev_actions, is_first = actor["prev_actions"], actor["is_first"]
        ep_ret, ep_len = actor["ep_ret"], actor["ep_len"]
        not_first = torch.zeros_like(is_first)
        traj, stats = [], []
        for t in range(rollout_steps):
            pobs = flat(venv.observe(env_state))
            carry2, (actor_out, _) = step_fn(carry, pobs, prev_actions, is_first)
            actions, logprobs = sample_fn(actor_out, _noise_at(noise, t))[:2]
            env_state, _, reward, term, trunc, final_obs = venv.step(
                env_state, to_env(actions), None if reset_draws is None else reset_draws[t])
            prev_next = encode_prev_actions(actions)
            _, (_, v_final) = step_fn(carry2, flat(final_obs), prev_next, not_first)
            done = term | trunc
            done_f = done.to(torch.float32)
            traj.append({**pobs, "actions": actions, "logprobs": logprobs,
                         "rewards": reward + gamma * v_final[..., 0] * trunc.to(torch.float32), "dones": done_f,
                         "is_first": is_first, "prev_actions": prev_actions})
            record, ep_ret, ep_len = _episode_step(ep_ret, ep_len, reward, done)
            stats.append(record)
            # an episode boundary resets the next step's recurrent inputs
            carry, prev_actions, is_first = carry2, prev_next * (1.0 - done_f[:, None]), done_f[:, None]
        _, (_, last_v) = step_fn(carry, flat(venv.observe(env_state)), prev_actions, is_first)
        new_actor = {"env": env_state, "carry": carry, "prev_actions": prev_actions, "is_first": is_first,
                     "ep_ret": ep_ret, "ep_len": ep_len, "update": actor["update"] + 1}
        return new_actor, _stack(traj), actor["carry"], last_v[..., 0], _stack(stats)

    return rollout


def compile_rollout(fabric: Any, rollout: Callable, noise_generator: torch.Generator,
                    env_generator: torch.Generator, *, name: str, max_recompiles: Optional[int] = None,
                    eager_reason: Optional[str] = None) -> Callable:
    """``rollout`` (:func:`make_rollout_fn` or :func:`make_recurrent_rollout_fn`)
    through ``fabric.compile``: on the card the whole rollout of ``T`` steps
    is one captured CUDA graph (every step's observe, forward, sample, env
    step, autoreset, bootstrap forward and episode accounting), replayed
    each iteration.  The player's and the env's generators are registered
    with it, so a replay draws the actions and resets eager execution would;
    handed-in noise and ``reset_draws`` are inputs like the env state.  The
    actor's ``update`` counter stays a host int outside the graph.  Returns
    a callable with ``rollout``'s signature; ``.compiled`` is the
    :class:`~sheeprl_tpu_torch.parallel.compile.GraphFunction`.

    The JAX package compiles the rollout, GAE and the update epochs as one
    program; the port captures the rollout alone so far (the update and GAE
    are ROADMAP.md, queue A item 3(a))."""

    def run(carry: Dict[str, Any], noise: Any, reset_draws: Any):
        actor, *rest = rollout({**carry, "update": 0}, noise_generator if noise is None else noise, reset_draws)
        return ({k: v for k, v in actor.items() if k != "update"}, *rest)

    compiled = fabric.compile(run, name=name, max_recompiles=max_recompiles,
                              generators=(noise_generator, env_generator), eager_reason=eager_reason)

    def call(actor: Dict[str, Any], noise: Noise, reset_draws: Optional[Sequence[Dict]] = None):
        if isinstance(noise, torch.Generator) and noise is not noise_generator:
            raise ValueError(f"{name}: draws from the generator it was compiled with, not another")
        carry = {k: v for k, v in actor.items() if k != "update"}
        new, *rest = compiled(carry, None if isinstance(noise, torch.Generator) else noise, reset_draws)
        return ({**new, "update": actor["update"] + 1}, *rest)

    call.compiled = compiled
    return call


def episode_stats_from_device(stats: Dict[str, torch.Tensor]) -> Tuple[np.ndarray, np.ndarray]:
    """The finished episodes' ``(returns, lengths)``, pulled to the host once."""
    done = stats["ep_done"].cpu().numpy().reshape(-1)
    return stats["ep_ret"].cpu().numpy().reshape(-1)[done], stats["ep_len"].cpu().numpy().reshape(-1)[done]
