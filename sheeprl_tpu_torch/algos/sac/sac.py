"""SAC on one device (counterpart of ``sheeprl_tpu/algos/sac/sac.py``, its
host-ring path), and the off-policy loop SAC, DroQ and SAC-AE share.

:class:`SACTrainer` is ``make_sac_train_fns``' train phase: ``U`` updates
over a ``(U, batch, ...)`` block, each in this order —

* the critic step, on the target ``min_N Q_target(s', a') − α·logπ(a'|s')``
  bootstrapped through ``1 − terminated`` (a truncated episode still
  bootstraps);
* the actor step, on the critic as just updated, with α taken before this
  update's temperature step;
* the temperature step on ``log_alpha``, reusing the actor pass's log-prob;
* the target EMA, when the global gradient-step counter is a multiple of
  ``critic.target_network_frequency``.

DroQ is the same update with a dropout critic, whose masks are part of the
update's noise.  Every draw of an update comes from the train generator
(:meth:`SACTrainer.draw_noise`) or is handed in, so a test can give the port
the draws JAX's keys make.

:func:`off_policy_loop` steps the envs with the player on
``algo.player.device``: random actions mapped into tanh space during the
``learning_starts`` prefill, then the actor's samples mapped back to the
env's bounds.  A done env's stored next observation is its real final one.
``Ratio`` (accrued over ``algo.train_window_iters`` iterations by
``TrainWindow``) decides the updates of each iteration.  With
``buffer.device`` on (``auto``: the run's device is CUDA) the replay ring
lives on the device and each window is drawn, gathered and trained there in
power-of-two chunks (``data/device_replay.fused_uniform_train``, the
layout's ``prep``); otherwise a host ring is sampled with numpy.  The health
guard inside the window skips a chunk whose losses or weights are not
finite (``resilience/health.py``), and with
``health.divergence.action=rollback`` a diverged run reloads its newest
committed snapshot in the loop, keeping its replay, at most
``health.divergence.max_rollbacks`` times; checkpoints carry the replay
buffer when ``buffer.checkpoint``, so a resumed run continues; a preempted
run exits after its final committed save; the test episode runs last.

Decoupled SAC (``exp=sac_decoupled``,
:mod:`~sheeprl_tpu_torch.algos.sac.sac_decoupled`) is this loop under
``algo.player.sync_every``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
    _clone,
    _rb_state_from_checkpoint,
)
from sheeprl_tpu_torch.algos.sac.agent import build_agent, ema_update, sample_action
from sheeprl_tpu_torch.algos.sac.loss import actor_loss, alpha_loss, critic_loss
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test, to_env_actions, to_tanh_space
from sheeprl_tpu_torch.checkpoint.rollback import rollback_state
from sheeprl_tpu_torch.convert import load_resume_state, restore_generators
from sheeprl_tpu_torch.data.buffers import ReplayBuffer
from sheeprl_tpu_torch.data.device_replay import (
    build_device_replay,
    estimate_step_bytes,
    fused_uniform_train,
    resolve_device_replay,
    steady_guard,
    update_chunks,
)
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.fabric import PlayerSync
from sheeprl_tpu_torch.resilience.health import DivergenceError, HealthSentinel
from sheeprl_tpu_torch.utils.distribution import Normal
from sheeprl_tpu_torch.utils.env import episode_stats, final_obs_rows, make_env, vectorize
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, flush_metrics
from sheeprl_tpu_torch.utils.profiler import ProfilerGate
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer, build_optimizer, optimizer_state_tensors
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import Ratio, TrainWindow, save_configs

Batch = Dict[str, torch.Tensor]
UpdateNoise = Dict[str, Any]


def _optimizer(params, group: Any) -> ClippedOptimizer:
    # the JAX package builds the off-policy optimizers without a gradient clip
    return build_optimizer(params, group.optimizer)


class SACTrainer:
    """The SAC (and DroQ) update of one replay window.

    ``batches`` hold ``(U, B, ...)`` tensors on the agent's device: ``obs``
    and ``next_obs`` (B, obs_dim), ``actions`` (B, act_dim) in tanh space,
    ``rewards`` and ``terminated`` (B,)."""

    LOSS_NAMES: Tuple[str, ...] = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")
    #: sample and run a long window in power-of-two chunks (SAC-AE's loop does)
    CHUNKED = False
    #: the non-finite guard around each window (the JAX SAC loop's sentinel)
    HEALTH = True

    def __init__(self, cfg: Any, agent: torch.nn.Module, optimizers: Dict[str, ClippedOptimizer], act_dim: int):
        a = cfg.algo
        self.agent, self.optimizers = agent, optimizers
        self.actor, self.critic, self.target_critic = agent.actor, agent.critic, agent.target_critic
        self.act_dim = int(act_dim)
        self.gamma, self.tau = float(a.gamma), float(a.tau)
        self.target_entropy = -float(act_dim)
        self.target_freq = int(a.critic.get("target_network_frequency", 1))

    @staticmethod
    def build_optimizers(cfg: Any, agent: torch.nn.Module,
                         saved: Optional[Dict[str, Any]] = None) -> Dict[str, ClippedOptimizer]:
        """One Adam per group, each with its own config group's betas and eps."""
        a = cfg.algo
        opts = {"actor": _optimizer(agent.actor.named_parameters(), a.actor),
                "critic": _optimizer(agent.critic.named_parameters(), a.critic),
                "alpha": _optimizer([("log_alpha", agent.log_alpha)], a.alpha)}
        for name, opt in opts.items():
            if saved and name in saved:
                opt.load_state_dict(saved[name])
        return opts

    # -- the player ------------------------------------------------------------
    @staticmethod
    def player_modules(agent: torch.nn.Module) -> Dict[str, torch.nn.Module]:
        """The modules the env player acts with."""
        return {"actor": agent.actor}

    @staticmethod
    def act(modules: Dict[str, torch.nn.Module], obs: torch.Tensor, generator: torch.Generator,
            greedy: bool = False) -> torch.Tensor:
        return sample_action(modules["actor"], obs, generator, greedy=greedy)[0]

    # -- state -------------------------------------------------------------------
    def opt_state(self) -> Dict[str, Any]:
        return {name: opt.state_dict() for name, opt in self.optimizers.items()}

    def tensors(self) -> List[torch.Tensor]:
        """Every trained tensor: the parameters and the target networks."""
        return list(self.agent.state_dict().values())

    def guarded_state(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """What the health guard covers: :meth:`tensors` and the optimizers' state."""
        return self.tensors(), optimizer_state_tensors(self.optimizers)

    def snapshot(self) -> Dict[str, Any]:
        """A device copy of the agent and the optimizers."""
        return _clone({"agent": self.agent.state_dict(), "opt": self.opt_state()})

    def restore(self, snap: Dict[str, Any]) -> None:
        """Load ``snap`` (a :meth:`snapshot`, or a checkpoint's ``agent`` and
        ``opt_state`` as ``{"agent", "opt"}``) by copying into the live
        tensors, so the guard's backup and the player keep theirs; ``snap``
        stays intact."""
        with torch.no_grad():
            self.agent.load_state_dict(snap["agent"])
        for name, opt in self.optimizers.items():
            opt.copy_state_(snap["opt"][name])

    # -- one update --------------------------------------------------------------
    def draw_noise(self, batch_size: int, generator: torch.Generator) -> UpdateNoise:
        """One update's draws: the standard-normal noise of the next actions
        and of the actor's actions (B, act_dim), and the dropout critic's
        keep masks of its three calls (None without dropout)."""
        shape = (batch_size, self.act_dim)
        dev = generator.device
        return {"next": Normal.sample_noise(shape, generator, dev), "pi": Normal.sample_noise(shape, generator, dev),
                "masks": {call: self.critic.dropout_masks(batch_size, generator)
                          for call in ("target", "critic", "actor")}}

    @staticmethod
    def _q(critic: torch.nn.Module, obs: torch.Tensor, action: torch.Tensor, noise: UpdateNoise,
           call: str) -> torch.Tensor:
        """``critic``'s Q, in train mode with ``call``'s dropout masks when the noise has them."""
        masks = (noise.get("masks") or {}).get(call)
        return critic(obs, action, train=masks is not None, masks=masks)

    def _step(self, loss: torch.Tensor, *groups: str) -> None:
        """Gradients of ``loss`` for the parameters of the named optimizer
        groups only, then each group's step."""
        params = [p for name in groups for p in self.optimizers[name].params]
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        for name in groups:
            self.optimizers[name].step()
            self.optimizers[name].zero_grad()

    def target(self, batch: Batch, next_obs: torch.Tensor, noise: UpdateNoise, alpha: torch.Tensor) -> torch.Tensor:
        """The critic's regression target (no gradient)."""
        with torch.no_grad():
            next_a, next_lp = sample_action(self.actor, next_obs, noise["next"])
            target_qs = self._q(self.target_critic, next_obs, next_a, noise, "target")
            target_v = torch.min(target_qs, dim=0).values - alpha * next_lp
            return batch["rewards"] + self.gamma * (1.0 - batch["terminated"]) * target_v

    def critic_step(self, batch: Batch, noise: UpdateNoise, alpha: torch.Tensor) -> torch.Tensor:
        y = self.target(batch, batch["next_obs"], noise, alpha)
        vl = critic_loss(self._q(self.critic, batch["obs"], batch["actions"], noise, "critic"), y)
        self._step(vl, "critic")
        return vl

    def actor_step(self, obs: torch.Tensor, noise: UpdateNoise, alpha: torch.Tensor,
                   critic: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
        """The actor loss on ``critic``'s Q of fresh actions; returns the loss
        and the actions' log-prob."""
        a, lp = sample_action(self.actor, obs, noise["pi"])
        qs = self._q(critic, obs, a, noise, "actor")
        pl = actor_loss(alpha, lp, torch.min(qs, dim=0).values)
        self._step(pl, "actor")
        return pl, lp.detach()

    def alpha_step(self, log_prob: torch.Tensor) -> torch.Tensor:
        al = alpha_loss(self.agent.log_alpha, log_prob, self.target_entropy)
        self._step(al, "alpha")
        return al

    def update(self, batch: Batch, noise: UpdateNoise, step_idx: int) -> Tuple[torch.Tensor, ...]:
        alpha = torch.exp(self.agent.log_alpha.detach())
        vl = self.critic_step(batch, noise, alpha)
        pl, lp = self.actor_step(batch["obs"], noise, alpha, self.critic)
        al = self.alpha_step(lp)
        if step_idx % self.target_freq == 0:
            ema_update(self.target_critic, self.critic, self.tau)
        return vl.detach(), pl.detach(), al.detach()

    def train_phase(self, batches: Batch, noise: Union[torch.Generator, Sequence[UpdateNoise]],
                    step0: int) -> Tuple[torch.Tensor, ...]:
        """``U`` updates over ``batches`` (U, B, ...), the first at global
        gradient step ``step0``; ``noise`` is the train generator (each update
        draws its own) or one :meth:`draw_noise` dict per update.  Returns
        each loss's mean over the U updates."""
        U, B = batches["rewards"].shape[:2]
        losses = []
        for u in range(U):
            nz = self.draw_noise(B, noise) if isinstance(noise, torch.Generator) else noise[u]
            losses.append(self.update({k: v[u] for k, v in batches.items()}, nz, step0 + u))
        return tuple(torch.stack(x).mean() for x in zip(*losses))


class VectorLayout:
    """How SAC and DroQ read observations: the ``mlp_keys`` vectors
    concatenated (:func:`prepare_obs`), stored as ``obs`` and ``next_obs``."""

    def __init__(self, cfg: Any, obs_space: Any):
        self.mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
        self.obs_keys = self.mlp_keys
        for k in self.mlp_keys:
            if k not in obs_space.spaces:
                raise ValueError(f"mlp key '{k}' not in observation space {list(obs_space.spaces)}")
        #: what the algorithm's ``build_agent`` takes to size its input
        self.agent_input = int(sum(np.prod(obs_space[k].shape) for k in self.mlp_keys))

    def player_obs(self, obs: Dict[str, np.ndarray], device: Any) -> torch.Tensor:
        return torch.from_numpy(prepare_obs(obs, self.mlp_keys)).to(device)

    def rows(self, obs: Dict[str, np.ndarray], real_next: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"obs": prepare_obs(obs, self.mlp_keys)[None], "next_obs": prepare_obs(real_next, self.mlp_keys)[None]}

    def batches(self, sample: Dict[str, np.ndarray], device: Any) -> Batch:
        out = {k: torch.from_numpy(np.ascontiguousarray(sample[k])).to(device) for k in ("obs", "next_obs", "actions")}
        for k in ("rewards", "terminated"):
            out[k] = torch.from_numpy(np.ascontiguousarray(sample[k][..., 0])).to(device)
        return out

    def prep(self, b: Batch) -> Batch:
        """A batch gathered from the device ring, as :meth:`batches` lays out a host sample."""
        out = {k: b[k] for k in ("obs", "next_obs", "actions")}
        for k in ("rewards", "terminated"):
            out[k] = b[k][..., 0]
        return out


def off_policy_loop(fabric: Any, cfg: Any, build_agent_fn: Any = build_agent, trainer_cls: Any = SACTrainer,
                    layout_cls: Any = VectorLayout) -> None:
    """The env / replay / train loop of SAC, DroQ and SAC-AE on one device:
    ``build_agent_fn(fabric, act_dim, cfg, layout.agent_input, agent_state)``
    builds the agent, ``trainer_cls(cfg, agent, optimizers, act_dim)`` is its
    update, and ``layout_cls(cfg, obs_space)`` says how observations are
    stored, sampled and shown to the player."""
    player_device = fabric.player_device(cfg)
    train_gen, player_gen = fabric.seed_everything(int(cfg.seed), player_device)

    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    ckpt_mgr = fabric.get_checkpoint_manager(cfg, log_dir)
    save_configs(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    envs = vectorize(cfg, [make_env(cfg, cfg.seed + i, 0, run_name=log_dir, vector_env_idx=i)
                           for i in range(num_envs)])
    act_space = envs.single_action_space
    if not isinstance(act_space, spaces.Box):
        raise ValueError(f"{cfg.algo.name} supports continuous (Box) action spaces only, like the reference")
    obs_space = envs.single_observation_space
    layout = layout_cls(cfg, obs_space)
    act_dim = int(np.prod(act_space.shape))

    state: Dict[str, Any] = {}
    if cfg.checkpoint.get("resume_from"):
        state = load_resume_state(cfg.checkpoint.resume_from, cfg)
    restore_generators(state, {"train": train_gen, "player": player_gen})
    agent = build_agent_fn(fabric, act_dim, cfg, layout.agent_input, state.get("agent"))
    trainer = trainer_cls(cfg, agent, trainer_cls.build_optimizers(cfg, agent, state.get("opt_state")), act_dim)
    sentinel = HealthSentinel.from_config(cfg) if trainer_cls.HEALTH else None
    if sentinel is not None:
        sentinel.register()

    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)
    psync = PlayerSync(cfg, player_device, lambda: trainer_cls.player_modules(agent))
    psync.init()

    total_iters = 1 if cfg.dry_run else max(int(cfg.algo.total_steps) // num_envs, 1)
    learning_starts = int(cfg.algo.learning_starts) // num_envs if not cfg.dry_run else 0
    start_iter = int(state.get("update", 0)) + 1 if state else 1
    policy_step = int(state.get("policy_step", 0))
    last_log = int(state.get("last_log", 0))
    last_checkpoint = int(state.get("last_checkpoint", 0))
    grad_step_counter = int(state.get("grad_steps", 0))
    if state:
        learning_starts += start_iter
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if "ratio" in state:
        ratio.load_state_dict(state["ratio"])
    window = TrainWindow(cfg.algo.get("train_window_iters", 1), pending=int(state.get("pending_gradient_steps", 0)))
    if "psync" in state:
        psync.load_state_dict(state["psync"])

    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None
    capacity = int(cfg.buffer.size) // num_envs
    use_device_replay = resolve_device_replay(cfg, fabric.device)
    rb: Any
    if use_device_replay:
        # the ring on the device, each row with its next observation; capacity
        # beyond the byte budget's window lives in the host spill tier
        rb = build_device_replay(
            cfg, capacity, num_envs, fabric.device,
            estimate_step_bytes(obs_space, layout.obs_keys, extra_bytes=4 * (act_dim + 2), copies_per_key=2),
            sequential=False, memmap_dir=memmap_dir)
        where = rb.describe()
    else:
        rb = ReplayBuffer(capacity, num_envs, memmap=cfg.buffer.memmap, memmap_dir=memmap_dir)
        where = "a host ring"
    guard_on = bool(cfg.buffer.get("transfer_guard", False)) and use_device_replay
    print(f"{cfg.algo.name} on {fabric.device}: player on {player_device}, replay in {where}, "
          f"{envs.describe()}", flush=True)
    if state.get("rb") is not None:
        rb.load_state_dict(_rb_state_from_checkpoint(state["rb"]))
    batch_size = int(cfg.algo.per_rank_batch_size)

    # every route through the compile-once audit; all run eagerly so far.
    # Both windows return (the gradient-step count after them, the losses)
    max_recompiles = cfg.algo.get("max_recompiles")
    eager = "the off-policy update is captured later (ROADMAP.md, queue A item 3(e))"
    if use_device_replay:
        def window_fn(n, counter):
            return fused_uniform_train(trainer, rb, train_gen, batch_size, n, layout.prep, counter)
    else:
        def window_fn(batches, counter):
            return counter + batches["rewards"].shape[0], trainer.train_phase(batches, train_gen, counter)
    if sentinel is not None:
        window_fn = sentinel.wrap(window_fn, trainer.guarded_state, fabric.device)
    train_window = fabric.compile(
        window_fn, name=f"{cfg.algo.name}.train_phase" + ("_device" if use_device_replay else ""),
        static_argnums=(0,) if use_device_replay else (), max_recompiles=max_recompiles, eager_reason=eager)
    player_step = fabric.compile(lambda o: trainer.act(psync.modules, o, player_gen),
                                 name=f"{cfg.algo.name}.player_step", device=player_device,
                                 max_recompiles=max_recompiles,
                                 eager_reason="the host loop copies every step's actions to the env")

    obs, _ = envs.reset(seed=int(cfg.seed))
    last_losses = None
    train_windows = 0  # the guard arms past the first window
    profiler = ProfilerGate(cfg, log_dir)
    for update in range(start_iter, total_iters + 1):
        profiler.step(update)
        policy_step += num_envs
        with timer("Time/env_interaction_time"):
            if update <= learning_starts and not state:
                env_actions = np.stack([act_space.sample() for _ in range(num_envs)])
                actions = to_tanh_space(env_actions, act_space)
            else:
                with torch.inference_mode():
                    actions = player_step(layout.player_obs(obs, player_device))
                actions = actions.cpu().numpy()
                env_actions = to_env_actions(actions, act_space)
            next_obs, rewards, terminated, truncated, info = envs.step(env_actions)
            dones = np.logical_or(terminated, truncated)

            # a done env's next observation is its real final one (autoreset replaced it)
            real_next = {k: np.asarray(next_obs[k]).copy() for k in layout.obs_keys}
            done_idx = np.nonzero(dones)[0]
            if done_idx.size:
                final = final_obs_rows(info, done_idx, layout.obs_keys)
                if final is not None:
                    for k in layout.obs_keys:
                        real_next[k][done_idx] = final[k]
            step = layout.rows(obs, real_next)
            step["actions"] = actions[None].astype(np.float32)
            step["rewards"] = np.asarray(rewards, np.float32)[None, :, None]
            step["terminated"] = np.asarray(terminated, np.float32)[None, :, None]
            rb.add(step)
            obs = next_obs
            for ep_ret, ep_len in episode_stats(info):
                aggregator.update("Rewards/rew_avg", ep_ret)
                aggregator.update("Game/ep_len_avg", ep_len)

        # ---------------- training ---------------------------------------------
        if update >= learning_starts:
            due = window.push(ratio(policy_step), update, learning_starts, total_iters)
            if due > 0:
                with timer("Time/train_time"):
                    psync.before_dispatch()
                    # on the device ring each chunk draws and gathers its
                    # batches there (power-of-two chunks, as JAX's); the
                    # health guard inside the chunk reads nothing back
                    if use_device_replay:
                        chunks = update_chunks(due, bytes_per_update=rb.sampled_bytes_per_update(batch_size))
                    else:
                        chunks = update_chunks(due) if trainer_cls.CHUNKED else (due,)
                    for u in chunks:
                        if use_device_replay:
                            with steady_guard(guard_on and train_windows > 0):
                                grad_step_counter, last_losses = train_window(u, grad_step_counter)
                        else:
                            batches = layout.batches(rb.sample(batch_size, n_samples=u), fabric.device)
                            grad_step_counter, last_losses = train_window(batches, grad_step_counter)
                            del batches
                    train_windows += 1
                    psync.after_dispatch()

        # ---------------- training-health sentinel -------------------------------
        # the guard's state is read every health.poll_every_updates
        # iterations; a diverged run rolls back to its newest committed
        # snapshot in the loop (JAX's sac.py), keeping the replay: what the
        # diverged policy collected is still valid off-policy data
        if (sentinel is not None and train_windows and sentinel.should_poll(update, total_iters)
                and sentinel.poll(policy_step) == "rollback"):
            sentinel.begin_rollback(policy_step)  # raises past the budget
            rb_state, rb_dir = rollback_state(ckpt_mgr, fabric)
            if rb_state is None:
                raise DivergenceError(
                    f"training diverged at step {policy_step} with no committed checkpoint to roll back to")
            trainer.restore({"agent": rb_state["agent"], "opt": rb_state["opt_state"]})
            for name, gen in (("train", train_gen), ("player", player_gen)):
                gen.set_state(rb_state["generators"][name].cpu())
            grad_step_counter = int(rb_state.get("grad_steps", grad_step_counter))
            sentinel.reseed_state()
            psync.init()
            last_losses = None
            print(f"health: diverged at step {policy_step} — rolled back to committed snapshot {rb_dir}",
                  flush=True)
            sentinel.rolled_back(policy_step, rb_dir)

        # ---------------- logging ------------------------------------------------
        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or update == total_iters or cfg.dry_run
        ):
            if last_losses is not None:
                for name, value in zip(trainer_cls.LOSS_NAMES, last_losses):
                    aggregator.update(name, float(value))
            extra = {"Params/replay_ratio": grad_step_counter / max(policy_step, 1), **psync.metrics()}
            last_log = flush_metrics(aggregator, timer, logger, policy_step, last_log, extra_metrics=extra)

        # ---------------- checkpoint ---------------------------------------------
        if ckpt_mgr.should_save(policy_step, last_checkpoint, final=update == total_iters):
            if sentinel is not None:
                sentinel.settle()  # the last window's host-resident select, before its state is saved
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": agent.state_dict(),
                "opt_state": trainer.opt_state(),
                "generators": {"train": train_gen.get_state(), "player": player_gen.get_state()},
                "update": update,
                "policy_step": policy_step,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "ratio": ratio.state_dict(),
                "psync": psync.state_dict(),
                "grad_steps": grad_step_counter,
                "pending_gradient_steps": window.pending,
            }
            if cfg.buffer.checkpoint:
                ckpt_state["rb"] = rb.state_dict()
            ckpt_mgr.save(policy_step, ckpt_state)
            if ckpt_mgr.preempted:
                print(f"Preemption: committed checkpoint at step {policy_step}, exiting", flush=True)
                break

    profiler.close()
    envs.close()
    if sentinel is not None:
        sentinel.close()
    if getattr(rb, "spill", None) is not None:
        rb.spill.close()
    ckpt_mgr.finalize()
    if cfg.algo.run_test and not ckpt_mgr.preempted:
        # the deferred-sync player may be a window behind: sync once more
        modules = psync.init()
        test(test_actor(trainer_cls, modules, layout, player_device, int(cfg.seed)), cfg, log_dir, logger)
    if logger is not None:
        logger.close()


def test_actor(trainer_cls: Any, modules: Dict[str, torch.nn.Module], layout: Any, device: Any, seed: int):
    """``act(batched raw obs, greedy)`` of the test episode: the player's
    modules on ``device``, sampling (when not greedy) from a generator
    seeded with ``seed``."""
    generator = torch.Generator(device).manual_seed(seed)

    def act(obs: Dict[str, np.ndarray], greedy: bool) -> np.ndarray:
        with torch.inference_mode():
            return trainer_cls.act(modules, layout.player_obs(obs, device), generator, greedy=greedy).cpu().numpy()

    return act


def evaluate_agent(fabric: Any, cfg: Any, state: Dict[str, Any], build_agent_fn: Any, trainer_cls: Any = SACTrainer,
                   layout_cls: Any = VectorLayout) -> float:
    """One greedy test episode of an off-policy snapshot on ``fabric.device``;
    returns the cumulative reward."""
    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    env = make_env(cfg, cfg.seed, 0)()
    layout = layout_cls(cfg, env.observation_space)
    act_dim = int(np.prod(env.action_space.shape))
    env.close()
    agent = build_agent_fn(fabric, act_dim, cfg, layout.agent_input, state["agent"])
    modules = trainer_cls.player_modules(agent)
    reward = test(test_actor(trainer_cls, modules, layout, fabric.device, int(cfg.seed)), cfg, log_dir, logger)
    if logger is not None:
        logger.close()
    return reward


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    off_policy_loop(fabric, cfg, build_agent, SACTrainer)
