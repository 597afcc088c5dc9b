"""Per-algorithm policy players for serving (counterpart of
``sheeprl_tpu/serve/players.py``: the DreamerV3, PPO and SAC players).

A :class:`PolicyPlayer` is the serving-side view of a trained agent: the
player's modules, a host-side observation ``prepare``, one ``step``
``(params, carry, obs, seed, greedy) -> (carry, actions)`` on torch tensors
on the player's device, and a host-side ``postprocess``.

* ``greedy`` is a per-row bool tensor: a coalesced batch may mix greedy and
  sampling requests; both arms are computed and selected row by row.
* ``seed`` seeds a ``torch.Generator`` on the device for this dispatch, the
  counterpart of ``jax.random.PRNGKey(seed)``.  It cannot give JAX's bits,
  so the DreamerV3 step also takes the posterior's Gumbel noise explicitly,
  and the PPO and SAC steps their actions' noise.
* :meth:`PolicyPlayer.step_batch` dispatches through ``dispatch``, built by
  ``fabric.compile``: the DreamerV3 step is one captured CUDA graph per
  ladder rung on the card, drawing from one generator registered with the
  graphs and reseeded per dispatch (so a seed gives the action and carry
  that ``step`` gives eagerly); the PPO and SAC steps run eagerly under the
  same recompile audit.
* ``carry`` is ``()`` for stateless players (ppo, sac) and the latent-state tuple
  ``(h, z, a)`` for dreamer_v3; the service keeps per-session carries on the
  host.
* ``extract`` maps a snapshot's ``agent`` state to the ``state_dict`` of each
  of the player's modules: what a hot reload copies into the served
  parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

PLAYER_BUILDERS: Dict[str, Callable] = {}


def register_player(*algo_names: str) -> Callable:
    """Register a builder ``(fabric, cfg, state, obs_space, action_space) ->
    PolicyPlayer`` for the given algorithm names."""

    def deco(fn: Callable) -> Callable:
        for name in algo_names:
            PLAYER_BUILDERS[name] = fn
        return fn

    return deco


@dataclass
class PolicyPlayer:
    """Serving-side policy: prepare → step → postprocess."""

    algo: str
    params: Any  # the player's modules, e.g. {"world_model": ..., "actor": ...}
    step: Callable
    prepare: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]
    postprocess: Callable[[np.ndarray], np.ndarray]
    obs_spec: Dict[str, Tuple[Tuple[int, ...], str]]  # raw per-request spec
    action_shape: Tuple[int, ...]
    is_continuous: bool
    actions_dim: Tuple[int, ...]
    device: torch.device
    stateful: bool = False
    carry_spec: Tuple[Tuple[Tuple[int, ...], str], ...] = ()
    checkpoint_step: int = -1
    #: ``(carry, obs, seed, greedy) -> (carry, actions)`` on the player's own
    #: ``params``, through ``fabric.compile`` (``compiled``)
    dispatch: Optional[Callable] = None
    compiled: Any = None
    #: snapshot ``agent`` state → ``{module name: state_dict}`` of ``params``
    extract: Optional[Callable[[Dict[str, Any]], Dict[str, Dict[str, torch.Tensor]]]] = None
    _prep_spec: Dict[str, Tuple[Tuple[int, ...], str]] = field(default_factory=dict)

    def zero_carry(self, batch: int) -> Tuple[np.ndarray, ...]:
        return tuple(np.zeros((batch, *shape), dtype=np.dtype(dt)) for shape, dt in self.carry_spec)

    def zero_carry_row(self) -> Tuple[np.ndarray, ...]:
        return self.zero_carry(1)

    def step_batch(
        self,
        params: Any,
        carry: Tuple[np.ndarray, ...],
        obs: Dict[str, np.ndarray],
        seed: int,
        greedy: np.ndarray,
    ) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        """One batched policy step on host arrays (``obs`` already prepared
        and padded to a ladder size); returns host arrays."""
        dev = self.device
        with torch.inference_mode():
            carry_t = tuple(torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in carry)
            obs_t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in obs.items()}
            greedy_t = torch.from_numpy(np.asarray(greedy, bool)).to(dev)
            if self.dispatch is not None and params is self.params:
                new_carry, actions = self.dispatch(carry_t, obs_t, int(seed), greedy_t)
            else:
                new_carry, actions = self.step(params, carry_t, obs_t, int(seed), greedy_t)
            return tuple(c.cpu().numpy() for c in new_carry), actions.cpu().numpy()

    def batch_specs(self, batch: int) -> Tuple[Any, ...]:
        """Zero ``(params, carry, obs, seed, greedy)`` arguments at ladder size ``batch``."""
        obs = {k: np.zeros((batch, *shape), np.dtype(dt)) for k, (shape, dt) in self._prep_spec.items()}
        return self.params, self.zero_carry(batch), obs, 0, np.zeros((batch,), bool)

    def finalize(self) -> "PolicyPlayer":
        """Derive the prepared-observation spec from a size-1 zero batch."""
        probe = {k: np.zeros((1, *shape), dtype=np.dtype(dt)) for k, (shape, dt) in self.obs_spec.items()}
        self._prep_spec = {
            k: (tuple(np.asarray(v).shape[1:]), str(np.asarray(v).dtype)) for k, v in self.prepare(probe).items()
        }
        return self


def _split_branches(a: np.ndarray, actions_dim: Sequence[int]) -> np.ndarray:
    """One-hot concat (B, sum(dims)) → float branch indices (B, n_branches)."""
    idx, start = [], 0
    for d in actions_dim:
        idx.append(np.argmax(a[..., start : start + d], axis=-1))
        start += d
    return np.stack(idx, axis=-1).astype(np.float32)


def _obs_spec_from_space(obs_space: Any, keys: Sequence[str]) -> Dict[str, Any]:
    return {k: (tuple(obs_space[k].shape), str(obs_space[k].dtype)) for k in keys}


@register_player("dreamer_v3")
def build_dreamer_v3_player(fabric: Any, cfg: Any, state: Dict[str, Any], obs_space: Any, action_space: Any) -> PolicyPlayer:
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, spaces_to_dims
    from sheeprl_tpu_torch.utils.utils import merge_framestack

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous = spaces_to_dims(action_space)
    fabric.warm_kernels(cfg)
    modules = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state["agent"])
    world_model, actor = modules["world_model"], modules["actor"]
    params = {"world_model": world_model, "actor": actor}
    act_width = int(sum(actions_dim))
    rec_size = int(cfg.algo.world_model.recurrent_model.recurrent_state_size)

    def _step(p, carry, obs, seed: int, greedy, post_noise: Optional[torch.Tensor] = None):
        """One step: encode → posterior RSSM step → actor.  The posterior
        sample draws ``post_noise`` (Gumbel, (B, stoch, discrete)) when given,
        else noise from the dispatch generator; it is sampled even on greedy
        rows, and only the actor arm is greedy."""
        return _forward(p, carry, obs, torch.Generator(fabric.device).manual_seed(int(seed)), greedy, post_noise)

    def _forward(p, carry, obs, gen: torch.Generator, greedy, post_noise: Optional[torch.Tensor] = None):
        wm, act = p["world_model"], p["actor"]
        h, z, prev_a = carry
        if post_noise is None:
            post_noise = wm.posterior_noise(h.shape[0], gen)
        embed = wm.encode(obs)
        is_first = torch.zeros((h.shape[0], 1), device=h.device)
        h, z, _, _ = wm.dynamic_noise(h, z, prev_a, embed, is_first, post_noise)
        out = act(torch.cat([z, h], dim=-1))
        a = torch.where(greedy[:, None], act.sample(out, gen, greedy=True), act.sample(out, gen, greedy=False))
        return (h, z, a), a

    # one generator for every dispatch, registered with each rung's graph and
    # reseeded per dispatch: the draws of a fresh generator with that seed
    dispatch_gen = torch.Generator(fabric.device)
    compiled = fabric.compile(lambda carry, obs, greedy: _forward(params, carry, obs, dispatch_gen, greedy),
                              name=f"serve_step:{cfg.algo.name}", generators=(dispatch_gen,))

    def dispatch(carry, obs, seed: int, greedy):
        dispatch_gen.manual_seed(int(seed))
        return compiled(carry, obs, greedy)

    def prepare(obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for k in cnn_keys:
            x = np.asarray(obs[k])
            if x.ndim == 5:  # (B, S, H, W, C) frame stack → channels
                x = merge_framestack(x)
            out[k] = np.asarray(x, np.float32) / 255.0 - 0.5
        for k in mlp_keys:
            x = np.asarray(obs[k], np.float32)
            out[k] = x.reshape(x.shape[0], -1)
        return out

    def postprocess(a: np.ndarray) -> np.ndarray:
        if not is_continuous:
            a = _split_branches(a, actions_dim)
        return actions_for_env(a, action_space)

    return PolicyPlayer(
        algo=cfg.algo.name,
        params=params,
        step=_step,
        dispatch=dispatch,
        compiled=compiled,
        prepare=prepare,
        postprocess=postprocess,
        obs_spec=_obs_spec_from_space(obs_space, cnn_keys + mlp_keys),
        action_shape=tuple(np.shape(action_space.sample())),
        is_continuous=is_continuous,
        actions_dim=tuple(actions_dim),
        device=fabric.device,
        extract=lambda agent: {"world_model": agent["world_model"], "actor": agent["actor"]},
        stateful=True,
        carry_spec=(
            ((rec_size,), "float32"),
            ((world_model.stoch_flat,), "float32"),
            ((act_width,), "float32"),
        ),
    ).finalize()


@register_player("ppo")
def build_ppo_player(fabric: Any, cfg: Any, state: Dict[str, Any], obs_space: Any, action_space: Any) -> PolicyPlayer:
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent, sample_actions
    from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, obs_to_np, spaces_to_dims

    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    actions_dim, is_continuous = spaces_to_dims(action_space)
    agent = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space, state["agent"]).eval()
    dist_type = cfg.get("distribution", {}).get("type", "auto")

    def _step(p, carry, obs, seed: int, greedy, noise: Optional[Sequence[torch.Tensor]] = None):
        """Stateless: both arms are computed and chosen row by row, the
        sampled arm drawing ``noise`` when given, else from the dispatch
        generator."""
        out, _ = p["agent"](obs)
        a_sample, _, _ = sample_actions(out, actions_dim, is_continuous,
                                        noise if noise is not None else torch.Generator(fabric.device).manual_seed(
                                            int(seed)), dist_type=dist_type)
        a_greedy, _, _ = sample_actions(out, actions_dim, is_continuous, greedy=True, dist_type=dist_type)
        return carry, torch.where(greedy[:, None], a_greedy, a_sample)

    params = {"agent": agent}
    compiled = fabric.compile(lambda carry, obs, seed, greedy: _step(params, carry, obs, seed, greedy),
                              name=f"serve_step:{cfg.algo.name}",
                              eager_reason="a fresh generator per dispatch; the PPO player is captured later "
                                           "(ROADMAP.md, queue A item 3)")

    def prepare(obs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: obs_to_np(obs[k], is_image=True) for k in cnn_keys}
        out.update({k: obs_to_np(obs[k], is_image=False) for k in mlp_keys})
        return out

    return PolicyPlayer(
        algo=cfg.algo.name,
        params=params,
        step=_step,
        dispatch=compiled,
        compiled=compiled,
        prepare=prepare,
        postprocess=lambda a: actions_for_env(a, action_space),
        obs_spec=_obs_spec_from_space(obs_space, cnn_keys + mlp_keys),
        action_shape=tuple(np.shape(action_space.sample())),
        is_continuous=is_continuous,
        actions_dim=tuple(actions_dim),
        device=fabric.device,
        extract=lambda agent: {"agent": agent},
    ).finalize()


@register_player("sac")
def build_sac_player(fabric: Any, cfg: Any, state: Dict[str, Any], obs_space: Any, action_space: Any) -> PolicyPlayer:
    """The SAC actor alone (the critics are not loaded): greedy rows take the
    squashed mean, sampled rows a tanh-Gaussian sample; actions are rescaled
    from [-1, 1] to the action space's bounds."""
    from sheeprl_tpu_torch.algos.sac.agent import SACActor, place_agent, sample_action
    from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, to_env_actions

    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    obs_dim = int(sum(np.prod(obs_space[k].shape) for k in mlp_keys))
    act_dim = int(np.prod(action_space.shape))
    actor_state = {k[len("actor."):]: v for k, v in state["agent"].items() if k.startswith("actor.")}
    with torch.device("meta"):
        actor = SACActor(obs_dim, act_dim, int(cfg.algo.actor.hidden_size), dtype=fabric.precision.compute_dtype)
    actor = place_agent(actor, actor_state, fabric.device, int(cfg.seed)).eval()

    def _step(p, carry, obs, seed: int, greedy, noise: Optional[torch.Tensor] = None):
        """Stateless: both arms are computed and chosen row by row, the
        sampled arm drawing ``noise`` (standard normal, (B, act_dim)) when
        given, else from the dispatch generator."""
        x = obs["__sac_obs__"]
        sampled, _ = sample_action(p["actor"], x, noise if noise is not None else
                                   torch.Generator(fabric.device).manual_seed(int(seed)))
        mode, _ = sample_action(p["actor"], x, greedy=True)
        return carry, torch.where(greedy[:, None], mode, sampled)

    params = {"actor": actor}
    compiled = fabric.compile(lambda carry, obs, seed, greedy: _step(params, carry, obs, seed, greedy),
                              name=f"serve_step:{cfg.algo.name}",
                              eager_reason="a fresh generator per dispatch; the SAC player is captured with the "
                                           "SAC update (ROADMAP.md, queue A item 3(e))")

    return PolicyPlayer(
        algo=cfg.algo.name,
        params=params,
        step=_step,
        dispatch=compiled,
        compiled=compiled,
        prepare=lambda obs: {"__sac_obs__": prepare_obs(obs, mlp_keys)},
        postprocess=lambda a: to_env_actions(np.asarray(a, np.float32), action_space),
        obs_spec=_obs_spec_from_space(obs_space, mlp_keys),
        action_shape=tuple(action_space.shape),
        is_continuous=True,
        actions_dim=(act_dim,),
        device=fabric.device,
        extract=lambda agent: {"actor": {k[len("actor."):]: v for k, v in agent.items() if k.startswith("actor.")}},
    ).finalize()
