"""Batched environments on the device: the env contract (counterpart of
``sheeprl_tpu/envs/jax/core.py``).

An env of this package steps every instance of a batch at once, as tensors
on one device, with no host round trip: the Anakin rollout
(:mod:`~sheeprl_tpu_torch.envs.device.anakin`) runs it inside the on-policy
update, and :class:`~sheeprl_tpu_torch.envs.device.adapter.DeviceEnvAdapter`
puts one instance behind the port's ``Env`` API for the host loops.

The contract:

* **State is a ``NamedTuple`` of tensors** with a leading ``num_envs`` axis
  on every leaf.  It carries everything the env needs between steps, the
  difficulty ``level`` among them where the env has a traced one.  It holds
  no random stream: the per-instance JAX keys become one
  ``torch.Generator`` per vector env, on the env's device.
* ``draw_reset(n, generator, device)`` makes the random draws of ``n``
  resets (a dict of tensors) and ``reset_from(draws)`` builds the states
  from them; ``reset(n, generator, device)`` is the two in turn.  Tests hand
  ``reset_from`` the draws a JAX key makes, so a reset can be held to the
  JAX env's exactly.
* ``step(state, action) -> (state, obs, reward, terminated, truncated)``
  over the whole batch; truncation at ``max_episode_steps`` is the env's
  own job, as in JAX.
* ``observe(state) -> obs``: a row-wise map, ``{"state": float32}`` or
  ``{"rgb": uint8 (n, H, W, C)}``.

Every operation is branch-free tensor arithmetic: no Python ``if`` on a
tensor, no ``.item()``, no boolean-mask indexing, nothing that makes the
host wait for the device.

:class:`VectorDeviceEnv` adds gymnasium's same-step autoreset over a batch.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

Obs = Dict[str, torch.Tensor]


class DeviceEnv:
    """Base class of the batched device envs: single-instance spaces, the
    episode limit and the functions of the contract above."""

    observation_space: Any
    action_space: Any
    #: per-episode step limit driving the ``truncated`` flag
    max_episode_steps: Optional[int] = None
    #: the env's constant tables, name → (values, dtype)
    CONSTANTS: Dict[str, Tuple[Any, torch.dtype]] = {}

    def const(self, name: str, device: Any) -> torch.Tensor:
        """A constant table on ``device``, made the first time it is asked
        for: a tensor made from host data is a host-to-device copy, which
        waits for the device, so :class:`VectorDeviceEnv` makes them all
        before the first step."""
        cache = self.__dict__.setdefault("_constants", {})
        key = (name, torch.device(device))
        if key not in cache:
            values, dtype = self.CONSTANTS[name]
            cache[key] = torch.tensor(values, dtype=dtype, device=device)
        return cache[key]

    def draw_reset(self, n: int, generator: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def reset_from(self, draws: Dict[str, torch.Tensor]) -> NamedTuple:
        raise NotImplementedError

    def reset(self, n: int, generator: torch.Generator, device: torch.device) -> Tuple[NamedTuple, Obs]:
        state = self.reset_from(self.draw_reset(n, generator, device))
        return state, self.observe(state)

    def step(self, state: NamedTuple, action: torch.Tensor):
        raise NotImplementedError

    def observe(self, state: NamedTuple) -> Obs:
        raise NotImplementedError


def where_rows(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` on the rows where ``done``, else ``b`` (``done`` is ``(n,)``)."""
    return torch.where(done.reshape(done.shape + (1,) * (a.dim() - 1)), a, b)


class VectorDeviceEnv:
    """``num_envs`` instances of a :class:`DeviceEnv` on ``device``, with
    same-step autoreset.

    ``step`` returns ``(state, obs, reward, terminated, truncated,
    final_obs)``: a finished row comes back already reset, its true last
    observation in ``final_obs`` (the truncation bootstrap needs it).  Reset
    draws are made for every row on every step, whether or not it finished,
    so the step is branch-free; the ``level`` rides the carry across the
    reset, as ``VectorJaxEnv`` keeps it (a reset knows only the default).
    """

    def __init__(self, env: DeviceEnv, num_envs: int, device: Any, generator: torch.Generator):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = torch.device(device)
        if generator.device.type != self.device.type:
            raise ValueError(f"the env generator is on {generator.device}, the envs on {self.device}")
        self.generator = generator
        for name in env.CONSTANTS:
            env.const(name, self.device)
        self.single_observation_space = env.observation_space
        self.single_action_space = env.action_space

    def reset(self) -> Tuple[NamedTuple, Obs]:
        return self.env.reset(self.num_envs, self.generator, self.device)

    def observe(self, state: NamedTuple) -> Obs:
        return self.env.observe(state)

    def step(self, state: NamedTuple, actions: torch.Tensor, reset_draws: Optional[Dict[str, torch.Tensor]] = None):
        """One step of every row; ``reset_draws`` (the draws of
        :meth:`DeviceEnv.draw_reset` for all rows) replaces this step's own."""
        env = self.env
        s1, final_obs, reward, terminated, truncated = env.step(state, actions)
        done = terminated | truncated
        if reset_draws is None:
            reset_draws = env.draw_reset(self.num_envs, self.generator, self.device)
        s_reset = env.reset_from(reset_draws)
        if "level" in s_reset._fields:
            s_reset = s_reset._replace(level=s1.level)
        s2 = type(s1)(*(where_rows(done, a, b) for a, b in zip(s_reset, s1)))
        # observe is row-wise, so observing the merged state is the reset
        # observation on finished rows and the stepped one elsewhere
        return s2, env.observe(s2), reward, terminated, truncated, final_obs
