"""Population training for PPO and A2C on the Anakin path (counterpart of
the population blocks of ``sheeprl_tpu/algos/{ppo,a2c}/*.py``).

With ``population.size = P > 1`` :func:`~sheeprl_tpu_torch.algos.ppo.ppo.on_policy_loop`
trains ``P`` whole agents at once: every member's parameters and optimizer
state stacked on a leading axis (:mod:`~sheeprl_tpu_torch.population.members`),
its own shard of ``env.num_envs`` device envs (one vector env of ``P·B``
rows), and its own ``lr``, ``ent_coef`` and (PPO) ``clip_coef`` as ``(P,)``
tensors.  One population phase is every member's Anakin rollout, GAE and
update, then the fitness EMA and the gated PBT step
(:func:`~sheeprl_tpu_torch.population.core.make_population_phase`); it goes
through ``fabric.compile`` and is one captured CUDA graph on the card, its
state updated in place.  PBT takes the place of the annealing schedules, so
``algo.anneal_*`` is inert here, as in JAX.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence

import torch
from torch.func import vmap

from sheeprl_tpu_torch.algos.ppo.agent import build_agent, sample_actions
from sheeprl_tpu_torch.envs.device.anakin import make_rollout_fn
from sheeprl_tpu_torch.envs.device.core import VectorDeviceEnv
from sheeprl_tpu_torch.population import (
    PBTConfig,
    PopulationMonitor,
    init_population_state,
    make_population_phase,
    write_population_summary,
)
from sheeprl_tpu_torch.population.members import StackedAgent, StackedOptimizer, member_permutations
from sheeprl_tpu_torch.utils.utils import gae

NO_ANAKIN = ("population.size>1 rides the Anakin axis: it needs a pure-JAX env "
             "(env=jax_*), algo.anakin != False, and a single-process run")


def population_size(cfg: Any) -> int:
    return int((cfg.get("population") or {}).get("size", 0) or 0)


class PopulationTrainer:
    """An on-policy update (``PPOTrainer`` or ``A2CTrainer``) for every
    member at once.

    ``single`` is the one-member trainer built on the template module: its
    ``loss`` runs under ``vmap`` with each member's parameters, and its
    ``update_epochs`` / ``batch_size`` / ``num_minibatches`` (PPO) set the
    minibatch steps; a trainer without them (A2C) takes one step on the whole
    rollout.  Rollouts come as ``(T, P·B, ...)``."""

    def __init__(self, single: Any, agent: StackedAgent, optimizer: StackedOptimizer):
        self.single, self.agent, self.optimizer = single, agent, optimizer
        self.size = agent.size
        self.T, self.B = single.T, single.B
        self.minibatches = hasattr(single, "num_minibatches")

    def _member_loss(self, params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor], clip: torch.Tensor,
                     ent: torch.Tensor):
        return self.single.loss(batch, clip, ent, agent=lambda obs: self.agent.one(params, obs))

    def flat_rollout(self, rollout: Dict[str, torch.Tensor], last_obs: Dict[str, torch.Tensor]):
        """Each member's rollout as ``(P, T·B, ...)`` rows (member-major, then
        ``t·B + b`` as one member's flat rollout) with the values of its
        current weights, the returns and the advantages."""
        P, T, B = self.size, self.T, self.B

        def per_member(x: torch.Tensor) -> torch.Tensor:  # (T, P·B, ...) -> (P, T·B, ...)
            x = x.reshape(T, P, B, *x.shape[2:]).transpose(0, 1)
            return x.reshape(P, T * B, *x.shape[3:])

        flat = {k: per_member(rollout[k]) for k in self.single.obs_keys}
        with torch.no_grad():
            values = self.agent(flat)[1][..., 0]  # (P, T·B)
            last = self.agent({k: v.reshape(P, B, *v.shape[1:]) for k, v in last_obs.items()})[1][..., 0]
        by_step = values.reshape(P, T, B).transpose(0, 1)  # (T, P, B)
        returns, advantages = gae(rollout["rewards"].reshape(T, P, B), by_step, rollout["dones"].reshape(T, P, B),
                                  last, self.single.gamma, self.single.gae_lambda)
        flat.update(actions=per_member(rollout["actions"]), values=values,
                    returns=returns.transpose(0, 1).reshape(P, T * B),
                    advantages=advantages.transpose(0, 1).reshape(P, T * B))
        if "logprobs" in rollout:
            flat["logprobs"] = per_member(rollout["logprobs"])
        return flat

    def train_phase(self, rollout: Dict[str, torch.Tensor], last_obs: Dict[str, torch.Tensor], perms: Any,
                    hp: Dict[str, torch.Tensor]) -> torch.Tensor:
        """GAE and every member's update.  ``perms`` is the train generator or
        the members' sample orders, ``(P, update_epochs, num_minibatches ·
        batch_size)``; ``hp`` the ``(P,)`` hyperparameters.  Returns the last
        step's (policy, value, entropy) losses, ``(P, 3)``."""
        flat = self.flat_rollout(rollout, last_obs)
        params = self.agent.params
        clip = hp.get("clip_coef", torch.zeros_like(hp["lr"]))
        loss_fn = vmap(self._member_loss)
        rows = torch.arange(self.size, device=hp["lr"].device)[:, None]
        epochs = self.single.update_epochs if self.minibatches else 1
        parts = None
        for epoch in range(epochs):
            if not self.minibatches:
                batches = [flat]
            else:
                bs, n = self.single.batch_size, self.single.num_minibatches
                perm = (member_permutations(perms, self.size, self.T * self.B, n * bs)
                        if isinstance(perms, torch.Generator) else perms[:, epoch])
                batches = ({k: v[rows, perm[:, i * bs:(i + 1) * bs]] for k, v in flat.items()} for i in range(n))
            for batch in batches:
                loss, parts = loss_fn(params, batch, clip, hp["ent_coef"])
                grads = torch.autograd.grad(loss.sum(), list(params.values()))
                self.optimizer.step(grads, hp["lr"])
        return torch.stack([x.detach() for x in parts], dim=-1)


class PopulationRoute:
    """The population route of the on-policy loop: the stacked members, their
    envs and hyperparameters, the PBT carry and the compiled population
    phase, restored from ``state`` (a population checkpoint) when given.

    ``step(draws=None) -> (losses (P, 3), stats)`` runs one population phase
    through ``fabric.compile``; ``draws`` hands in what the generators would
    draw (``{"members": {"noise", "reset", "perms"}, "factors"}``)."""

    def __init__(self, fabric: Any, cfg: Any, trainer_cls: Any, env: Any, obs_space: Any, act_space: Any,
                 actions_dim: Sequence[int], is_continuous: bool, generators: Dict[str, torch.Generator],
                 state: Dict[str, Any], start_iter: int, max_recompiles: Optional[int] = None):
        a = cfg.algo
        self.size, self.num_envs, T = population_size(cfg), int(cfg.env.num_envs), int(a.rollout_steps)
        base = {"lr": float(a.optimizer.lr), "ent_coef": float(a.ent_coef)}
        if "clip_coef" in trainer_cls.SCHEDULES:
            base["clip_coef"] = float(a.clip_coef)
        self.pbt = PBTConfig.from_cfg(cfg, base=base)
        inert = [f"algo.anneal_{n}" for n in ("lr", "clip_coef", "ent_coef") if a.get(f"anneal_{n}", False)]
        if inert:
            warnings.warn(f"{', '.join(inert)} {'is' if len(inert) == 1 else 'are'} inert in population mode: "
                          "PBT explores the hyperparameters instead", UserWarning)
        cnn_keys, mlp_keys = tuple(a.cnn_keys.encoder), tuple(a.mlp_keys.encoder)
        template = build_agent(fabric, actions_dim, is_continuous, cfg, obs_space)
        self.agent = StackedAgent(template, self.size, state.get("agent"))
        self.optimizer = StackedOptimizer(self.agent.params, a.optimizer, a.max_grad_norm)
        if state.get("opt_state") is not None:
            self.optimizer.load_state_dict(state["opt_state"])
        single = trainer_cls(cfg, template, None, cnn_keys + mlp_keys, actions_dim, is_continuous, T, self.num_envs)
        self.trainer = PopulationTrainer(single, self.agent, self.optimizer)
        self.venv = VectorDeviceEnv(env, self.size * self.num_envs, fabric.device, generators["env"])
        dist_type = cfg.get("distribution", {}).get("type", "auto")
        rollout_fn = make_rollout_fn(
            self.venv, self.agent.flat,
            lambda out, noise: sample_actions(out, actions_dim, is_continuous, noise, dist_type=dist_type),
            cnn_keys=cnn_keys, mlp_keys=mlp_keys, action_space=act_space, gamma=float(a.gamma),
            rollout_steps=T, store_logprobs=trainer_cls.STORES_LOGPROBS)
        env_state, _ = self.venv.reset()
        n, dev = self.venv.num_envs, fabric.device
        members = {"env": env_state, "ep_ret": torch.zeros(n, dtype=torch.float32, device=dev),
                   "ep_len": torch.zeros(n, dtype=torch.int32, device=dev),
                   "update": torch.full((self.size,), start_iter - 1, dtype=torch.int32, device=dev)}
        self.pop = init_population_state(members, self.pbt, self.num_envs)
        saved = state.get("population")
        if saved:
            for k in ("fitness", "ep_count", "exploits"):
                self.pop[k].copy_(saved[k])
            self.hp = {k: torch.as_tensor(v).to(dev, torch.float32).clone() for k, v in saved["hp"].items()}
        else:
            self.hp = self.pbt.init_hyperparams(generators["train"])
        player_gen, train_gen = generators["player"], generators["train"]

        def member_phase(members: Dict[str, Any], hp: Dict[str, torch.Tensor], draws: Optional[Dict[str, Any]]):
            draws = draws or {}
            actor, rollout, last_obs, stats = rollout_fn(members, draws.get("noise", player_gen), draws.get("reset"))
            losses = self.trainer.train_phase(rollout, last_obs, draws.get("perms", train_gen), hp)
            return actor, losses, stats

        phase = make_population_phase(member_phase, self.pbt, self.pop, self.hp, self.agent.tensors(),
                                      self.optimizer.tensors, train_gen)
        # every member's rollout, update and the PBT step: one captured CUDA
        # graph on the card (the hyperparameters and the update counter are
        # tensors on the device, the state is updated in place)
        self.step = fabric.compile(phase, name=f"{a.name}.population_phase", max_recompiles=max_recompiles,
                                   generators=(player_gen, generators["env"], train_gen))
        self.monitor = PopulationMonitor()

    def observe(self) -> None:
        """Feed the ``Population/*`` source (host reads: the logging cadence)."""
        self.monitor.observe(self.pop["fitness"], self.hp, self.pop["exploits"])

    def checkpoint_state(self) -> Dict[str, Any]:
        """The stacked parameters and optimizer state, and the PBT carry."""
        return {"agent": self.agent.state_dict(), "opt_state": self.optimizer.state_dict(),
                "population": {"fitness": self.pop["fitness"], "ep_count": self.pop["ep_count"],
                               "exploits": self.pop["exploits"], "hp": dict(self.hp)}}

    def best_agent(self) -> torch.nn.Module:
        """The template module holding the fittest member's parameters."""
        best = int(self.pop["fitness"].argmax())
        module = self.agent.module
        module.load_state_dict(self.agent.member(best))
        return module

    def write_summary(self, log_dir: str, policy_step: int) -> str:
        return write_population_summary(log_dir, self.pop, self.hp, policy_step)


