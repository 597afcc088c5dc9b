"""DreamerV3 training on one device (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``).

One update (:meth:`DV3Trainer.train_step`) follows the JAX
``single_update``:

* the world model: encoder → posterior scan over the sequence
  (``WorldModel.dynamic_noise``, one recurrent step per time step) →
  decoder, reward and continue heads → ``world_model_loss``; Adam step;
* the behaviour: an imagination scan of ``horizon + 1`` steps from every
  posterior latent with the updated world model, λ-returns, the Moments
  percentile normaliser, the actor loss, then the critic's two-hot NLL plus
  the target regulariser;
* the target-critic EMA when ``counter % target_freq == 0``.

The scans are Python loops over time.  Every random draw of an update comes
in as a tensor (:func:`draw_noise`), so a test can hand the port the draws
the JAX keys make; the loop has each update draw its own from the training
generator, so a window's noise never outgrows one update's.  The actor's gradient reaches only the actor: the world
model and the critic are frozen while its loss is built, and for discrete
actions (whose objective stops the gradient at the advantage) the
imagination runs without a graph.  With ``fused_pallas`` every recurrent
step is the CUDA kernel of ``ops/rssm.py``; its backward differentiates the
plain version, as the JAX ``custom_vjp`` does.

:func:`dreamer_family_loop` is the env/replay/train loop: random prefill up
to ``learning_starts``, the latent player, replay adds with reset rows,
``Ratio``-governed train windows of ``(U, L, B, *)`` blocks from the host
ring (sampled and moved to the device in chunks, :func:`window_chunks`),
metrics, checkpoints, resume, ``dry_run`` and the final test episode.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Critic, WorldModel, build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.loss import world_model_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import (
    compute_lambda_values,
    moments_update,
    normalize_obs_block,
    prepare_obs,
    test,
)
from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, spaces_to_dims
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.fabric import PlayerSync
from sheeprl_tpu_torch.resilience.health import HealthSentinel
from sheeprl_tpu_torch.utils.distribution import (
    Bernoulli,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TwoHotEncodingDistribution,
)
from sheeprl_tpu_torch.utils.env import episode_stats, final_obs_rows, make_env, vectorize
from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
from sheeprl_tpu_torch.utils.metric import MetricAggregator, flush_metrics
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer, build_optimizer
from sheeprl_tpu_torch.utils.registry import register_algorithm
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import Ratio, merge_framestack, save_configs

METRIC_NAMES = (
    "Loss/world_model_loss",
    "Loss/observation_loss",
    "Loss/reward_loss",
    "Loss/state_loss",
    "Loss/continue_loss",
    "State/kl",
    "Loss/policy_loss",
    "Loss/value_loss",
    "State/post_entropy",
    "State/prior_entropy",
)

#: Bytes of sampled replay a train window may hold on the device at once
#: (the JAX package's knob of the same name and default, 2 GiB); a longer
#: window is sampled and moved in chunks.
WINDOW_BYTES_ENV = "SHEEPRL_MAX_HBM_WINDOW_BYTES"
WINDOW_BYTES_DEFAULT = 2 << 30


def check_supported(cfg: Any) -> None:
    """Raise for the settings the port does not implement yet, naming the ROADMAP
    item that will."""
    pipe = cfg.get("pipeline") or {}
    deferred = {
        "pipeline.stages > 1": int(pipe.get("stages", 1)) > 1,
        "pipeline.microbatches > 1": int(pipe.get("microbatches", 1)) > 1,
        "pipeline.imagination_microbatches > 1": int(pipe.get("imagination_microbatches", 1)) > 1,
        "algo.remat=True": bool(cfg.algo.get("remat", False)),
        "buffer.device=True": cfg.buffer.get("device", "auto") is True,
    }
    for name, on in deferred.items():
        if on:
            raise NotImplementedError(
                f"{name} is not ported yet: the scale layer comes later (ROADMAP.md, queue A item 6)"
            )
    if bool(cfg.algo.world_model.get("decoupled_rssm", False)):
        raise NotImplementedError(
            "algo.world_model.decoupled_rssm=True is not ported yet (ROADMAP.md, queue A item 3)"
        )
    if cfg.buffer.get("type", "sequential") != "sequential":
        raise NotImplementedError(
            f"buffer.type={cfg.buffer.type}: the port has the sequential host ring only "
            "(the EpisodeBuffer comes with the rest of the Dreamer family, ROADMAP.md, queue A item 3)"
        )


def unacted_settings(cfg: Any) -> List[str]:
    """The settings that are on but that the port does not act on yet
    (ROADMAP.md, queue A item 7); the loop warns of them once at its start."""
    tel = cfg.get("telemetry") or {}
    on = {
        "checkpoint.save_on_preemption": bool(cfg.checkpoint.get("save_on_preemption", False)),
        "telemetry.spans.enabled": bool((tel.get("spans") or {}).get("enabled", False)),
        "telemetry.recorder.enabled": bool((tel.get("recorder") or {}).get("enabled", False)),
        "telemetry.introspect.port": (tel.get("introspect") or {}).get("port") is not None,
        "telemetry.trace_at": bool(tel.get("trace_at")),
        "metric.profiler": bool((cfg.metric.get("profiler") or {}).get("enabled", False)),
    }
    return [name for name, value in on.items() if value]


@contextlib.contextmanager
def frozen(*modules: torch.nn.Module) -> Iterator[None]:
    """Parameters of ``modules`` need no gradient inside the block."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def build_dv3_optimizers(cfg: Any, world_model: WorldModel, actor: Actor, critic: Critic,
                         saved: Optional[Dict[str, Any]] = None) -> Dict[str, ClippedOptimizer]:
    """The three parameter groups' optimizers, with their saved state when given."""
    algo = cfg.algo
    opts = {
        "world_model": build_optimizer(world_model.parameters(), algo.world_model.optimizer,
                                       algo.world_model.clip_gradients),
        "actor": build_optimizer(actor.parameters(), algo.actor.optimizer, algo.actor.clip_gradients),
        "critic": build_optimizer(critic.parameters(), algo.critic.optimizer, algo.critic.clip_gradients),
    }
    if saved:
        for name, opt in opts.items():
            opt.load_state_dict(saved[name])
    return opts


def draw_noise(world_model: WorldModel, actor: Actor, U: int, L: int, B: int, horizon: int,
               generator: torch.Generator) -> Dict[str, Any]:
    """Every random draw of ``U`` updates on ``(L, B)`` blocks:
    ``posterior`` Gumbel (U, L, B, S, D); ``actions``, per action branch, a
    Gumbel (U, H+1, L*B, d) or, for continuous actions, one normal
    (U, H+1, L*B, A); ``imagination`` Gumbel (U, H+1, L*B, S, D)."""
    S, D = world_model.stochastic_size, world_model.discrete_size
    n = L * B
    post = OneHotCategorical.sample_noise((U, L, B, S, D), generator, generator.device)
    actions = actor.sample_noise((U, horizon + 1, n), generator)
    imag = OneHotCategorical.sample_noise((U, horizon + 1, n, S, D), generator, generator.device)
    return {"posterior": post, "actions": actions, "imagination": imag}


def noise_slice(noise: Dict[str, Any], u: int) -> Dict[str, Any]:
    return {"posterior": noise["posterior"][u], "actions": [a[u] for a in noise["actions"]],
            "imagination": noise["imagination"][u]}


def window_chunks(n_updates: int, bytes_per_update: int, budget: Optional[int] = None) -> List[int]:
    """Split a window of ``n_updates`` into chunks whose sampled ``(U, L, B, *)``
    blocks hold at most ``budget`` bytes (default: ``$SHEEPRL_MAX_HBM_WINDOW_BYTES``,
    else 2 GiB); a chunk holds at least one update."""
    if budget is None:
        budget = int(os.environ.get(WINDOW_BYTES_ENV, WINDOW_BYTES_DEFAULT))
    cap = max(1, budget // max(1, bytes_per_update))
    return [min(cap, n_updates - i) for i in range(0, n_updates, cap)]


class DV3Trainer:
    """The modules, Moments state and optimizers of one DreamerV3 run, and
    its update."""

    def __init__(self, cfg: Any, world_model: WorldModel, actor: Actor, critic: Critic,
                 target_critic: Critic, cnn_keys: Sequence[str], mlp_keys: Sequence[str], is_continuous: bool,
                 agent_state: Optional[Dict[str, Any]] = None, opt_state: Optional[Dict[str, Any]] = None):
        self.cfg = cfg
        self.world_model, self.actor, self.critic, self.target_critic = world_model, actor, critic, target_critic
        self.target_critic.requires_grad_(False)
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.obs_keys = self.cnn_keys + self.mlp_keys
        self.is_continuous = is_continuous
        self.device = next(world_model.parameters()).device
        algo = cfg.algo
        self.horizon = int(algo.horizon)
        self.gamma = float(algo.gamma)
        self.lmbda = float(algo.lmbda)
        self.tau = float(algo.critic.tau)
        self.target_freq = int(algo.critic.per_rank_target_network_update_freq)
        self.ent_coef = float(algo.actor.ent_coef)
        self.bins = int(algo.critic.bins)
        m = algo.actor.moments
        self.moments_cfg = dict(decay=float(m.decay), max_=float(m.max), plow=float(m.percentile.low),
                                phigh=float(m.percentile.high))
        wm = algo.world_model
        self.wm_loss_cfg = dict(
            kl_dynamic=float(wm.kl_dynamic), kl_representation=float(wm.kl_representation),
            kl_free_nats=float(wm.kl_free_nats), kl_regularizer=float(wm.kl_regularizer),
            continue_scale_factor=float(wm.continue_scale_factor),
        )
        saved_moments = (agent_state or {}).get("moments")
        self.moments = {
            k: (saved_moments[k].to(self.device).float().clone() if saved_moments else
                torch.zeros((), device=self.device))
            for k in ("low", "high")
        }
        self.optimizers = build_dv3_optimizers(cfg, world_model, actor, critic, opt_state)
        self.last_wm_grad_norm: Optional[torch.Tensor] = None

    # -- state ---------------------------------------------------------------
    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"world_model": self.world_model, "actor": self.actor, "critic": self.critic,
                "target_critic": self.target_critic}

    def agent_state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {name: m.state_dict() for name, m in self.modules().items()}
        out["moments"] = dict(self.moments)
        return out

    def opt_state(self) -> Dict[str, Any]:
        return {name: opt.state_dict() for name, opt in self.optimizers.items()}

    def tensors(self) -> List[torch.Tensor]:
        """Every trained tensor: parameters, target critic and Moments."""
        out = [p for m in self.modules().values() for p in m.parameters()]
        return out + list(self.moments.values())

    def snapshot(self) -> Dict[str, Any]:
        """A device copy of the whole trained state (for the health guard)."""
        return _clone({"agent": self.agent_state(), "opt": self.opt_state()})

    def restore(self, snap: Dict[str, Any]) -> None:
        """Load ``snap``; it stays intact (``Optimizer.load_state_dict`` keeps
        the tensors it is given, so it gets copies)."""
        with torch.no_grad():
            for name, m in self.modules().items():
                m.load_state_dict(snap["agent"][name])
            for k in self.moments:
                self.moments[k].copy_(snap["agent"]["moments"][k])
        for name, opt in self.optimizers.items():
            opt.load_state_dict(_clone(snap["opt"][name]))

    # -- update ----------------------------------------------------------------
    def wm_forward(self, data: Dict[str, torch.Tensor], post_noise: torch.Tensor):
        """Encoder + posterior scan + heads → (loss, aux with latents and logits)."""
        wm = self.world_model
        L, B = data["rewards"].shape
        obs = normalize_obs_block(data, self.cnn_keys, self.obs_keys)
        embed = wm.encode({k: v.reshape(L * B, *v.shape[2:]) for k, v in obs.items()}).reshape(L, B, -1)
        # shifted actions: h_t consumes a_{t-1}; every sequence starts an episode
        actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], dim=0)
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        is_first = is_first[..., None]
        h = torch.zeros(B, wm.recurrent_size, device=self.device)
        z = torch.zeros(B, wm.stoch_flat, device=self.device)
        hs, zs, posts, priors = [], [], [], []
        for t in range(L):
            h, z, post, prior = wm.dynamic_noise(h, z, actions[t], embed[t], is_first[t], post_noise[t])
            hs.append(h)
            zs.append(z)
            posts.append(post)
            priors.append(prior)
        latents = torch.cat([torch.stack(zs), torch.stack(hs)], dim=-1)
        post_logits, prior_logits = torch.stack(posts), torch.stack(priors)

        flat = latents.reshape(L * B, -1)
        recon = wm.decode(flat)
        obs_log_probs = {}
        for k in self.cnn_keys:
            obs_log_probs[k] = MSEDistribution(recon[k].reshape(obs[k].shape), event_dims=3).log_prob(obs[k])
        for k in self.mlp_keys:
            obs_log_probs[k] = SymlogDistribution(recon[k].reshape(L, B, -1), event_dims=1).log_prob(obs[k])
        reward_lp = TwoHotEncodingDistribution(wm.reward_logits(flat).reshape(L, B, -1), dims=1).log_prob(
            data["rewards"][..., None]
        )
        cont_lp = Bernoulli(wm.continue_logits(flat).reshape(L, B), event_dims=0).log_prob(1.0 - data["terminated"])
        loss, aux = world_model_loss(obs_log_probs, reward_lp, cont_lp, post_logits, prior_logits,
                                     **self.wm_loss_cfg)
        aux.update(latents=latents, post_logits=post_logits, prior_logits=prior_logits)
        return loss, aux

    def _imagine(self, start: torch.Tensor, action_noise: Sequence[torch.Tensor], imag_noise: torch.Tensor):
        """``horizon + 1`` prior steps from ``start`` latents: the latents
        before each action (the trajectory) and the actions."""
        wm, actor = self.world_model, self.actor
        z = start[:, : wm.stoch_flat].contiguous()
        h = start[:, wm.stoch_flat :].contiguous()
        traj, actions = [], []
        for t in range(self.horizon + 1):
            latent = torch.cat([z, h], dim=-1)
            action = actor.sample_from_noise(actor(latent.detach()), [n[t] for n in action_noise])
            traj.append(latent)
            actions.append(action)
            h, z = wm.imagination_noise(h, z, action, imag_noise[t])
        return torch.stack(traj), torch.stack(actions)

    def behavior_update(self, latents: torch.Tensor, terminated: torch.Tensor, noise: Dict[str, Any]):
        """Imagination, λ-returns, Moments, the actor and the critic steps."""
        wm, actor, critic = self.world_model, self.actor, self.critic
        H = self.horizon
        L, B = terminated.shape
        n = L * B
        start = latents.detach().reshape(n, -1)

        with frozen(wm, critic):
            # discrete actions: the objective stops the gradient at the
            # advantage, so nothing flows back through the imagination
            with torch.enable_grad() if self.is_continuous else torch.no_grad():
                traj, actions_seq = self._imagine(start, noise["actions"], noise["imagination"])
                flat = traj.reshape((H + 1) * n, -1)
                rewards = TwoHotEncodingDistribution(wm.reward_logits(flat).reshape(H + 1, n, -1), dims=1).mean[..., 0]
                values = TwoHotEncodingDistribution(critic(flat).reshape(H + 1, n, -1), dims=1).mean[..., 0]
                continues = Bernoulli(wm.continue_logits(flat).reshape(H + 1, n)).mode()
                continues = torch.cat([(1.0 - terminated).reshape(1, n), continues[1:]], dim=0)
                lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * self.gamma, self.lmbda)
                discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()
            new_moments, offset, invscale = moments_update(self.moments, lambda_values, **self.moments_cfg)
            advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
            heads = actor(traj.detach())
            if self.is_continuous:
                objective = advantage
            else:
                objective = actor.log_prob(heads[:-1], actions_seq[:-1].detach()) * advantage.detach()
            entropy = actor.entropy(heads[:-1])
            policy_loss = -torch.mean(discount[:-1] * (objective + self.ent_coef * entropy))
            self.optimizers["actor"].zero_grad()
            policy_loss.backward()
        self.optimizers["actor"].step()
        self.moments = new_moments

        # critic: two-hot NLL of the λ-returns plus the target regulariser
        flat_sg = traj[:-1].detach().reshape(H * n, -1)
        lambda_sg = lambda_values.detach()
        with torch.no_grad():
            target_mean = TwoHotEncodingDistribution(
                self.target_critic(flat_sg).reshape(H, n, self.bins), dims=1
            ).mean
        qv = TwoHotEncodingDistribution(critic(flat_sg).reshape(H, n, self.bins), dims=1)
        value_loss = torch.mean((-qv.log_prob(lambda_sg[..., None]) - qv.log_prob(target_mean)) * discount[:-1])
        self.optimizers["critic"].zero_grad()
        value_loss.backward()
        self.optimizers["critic"].step()
        return policy_loss.detach(), value_loss.detach()

    def train_step(self, data: Dict[str, torch.Tensor], noise: Dict[str, Any], counter: int) -> Tuple[torch.Tensor, ...]:
        """One update on an ``(L, B, *)`` block; returns the ten metrics."""
        opt = self.optimizers["world_model"]
        opt.zero_grad()
        wm_loss, aux = self.wm_forward(data, noise["posterior"])
        wm_loss.backward()
        self.last_wm_grad_norm = opt.step()
        policy_loss, value_loss = self.behavior_update(aux["latents"], data["terminated"], noise)
        if counter % self.target_freq == 0:
            with torch.no_grad():
                for t, o in zip(self.target_critic.parameters(), self.critic.parameters()):
                    t.copy_((1 - self.tau) * t + self.tau * o)
        with torch.no_grad():
            post_ent = OneHotCategorical(aux["post_logits"].detach()).entropy().sum(-1).mean()
            prior_ent = OneHotCategorical(aux["prior_logits"].detach()).entropy().sum(-1).mean()
        return (
            wm_loss.detach(), aux["observation_loss"].detach(), aux["reward_loss"].detach(),
            aux["kl_loss"].detach(), aux["continue_loss"].detach(), aux["kl"].detach(),
            policy_loss, value_loss, post_ent, prior_ent,
        )

    def train_phase(self, blocks: Dict[str, torch.Tensor], noise: Union[Dict[str, Any], torch.Generator],
                    counter0: int):
        """``U`` updates in order over ``(U, L, B, *)`` blocks; returns the
        mean of each of the ten metrics over the window.  ``noise`` is every
        draw of the ``U`` updates (:func:`draw_noise`), or a generator from
        which each update draws its own just before it runs."""
        U, L, B = blocks["rewards"].shape
        metrics = []
        for u in range(U):
            if isinstance(noise, torch.Generator):
                step_noise = noise_slice(draw_noise(self.world_model, self.actor, 1, L, B, self.horizon, noise), 0)
            else:
                step_noise = noise_slice(noise, u)
            metrics.append(self.train_step({k: v[u] for k, v in blocks.items()}, step_noise, counter0 + u))
        return tuple(torch.stack(m).mean() for m in zip(*metrics))


def _clone(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def blocks_to_device(sample: Dict[str, np.ndarray], cnn_keys, mlp_keys, device) -> Dict[str, torch.Tensor]:
    """A sampled ``(U, L, B, *)`` numpy window as tensors: images stay uint8
    (normalised by the update), vectors float32 flattened to (U, L, B, -1),
    ``rewards``/``terminated``/``is_first`` (U, L, B)."""
    out: Dict[str, torch.Tensor] = {}

    def put(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    for k in cnn_keys:
        x = np.asarray(sample[k])
        if x.ndim == 7:  # (U, L, B, S, H, W, C) frame stack
            x = merge_framestack(x)
        out[k] = put(x)
    for k in mlp_keys:
        x = np.asarray(sample[k], np.float32)
        out[k] = put(x.reshape(*x.shape[:3], -1))
    out["actions"] = put(np.asarray(sample["actions"], np.float32))
    for k in ("rewards", "terminated", "is_first"):
        out[k] = put(np.asarray(sample[k], np.float32)[..., 0])
    return out


def sampled_bytes_per_update(obs_space: Any, cnn_keys, mlp_keys, act_width: int, L: int, B: int) -> int:
    """Bytes of one update's ``(L, B, *)`` block on the device, as
    :func:`blocks_to_device` lays it out."""
    row = sum(int(np.prod(obs_space[k].shape)) for k in cnn_keys)  # uint8
    row += 4 * sum(int(np.prod(obs_space[k].shape)) for k in mlp_keys)
    row += 4 * (act_width + 3)  # actions, rewards, terminated, is_first
    return row * L * B


def _rb_state_from_checkpoint(tree: Any) -> Any:
    """Replay-buffer state as saved (tensors) → numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _rb_state_from_checkpoint(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rb_state_from_checkpoint(v) for v in tree]
    return tree


@register_algorithm()
def main(fabric: Any, cfg: Any) -> None:
    dreamer_family_loop(fabric, cfg)


def dreamer_family_loop(fabric: Any, cfg: Any) -> None:
    """The env / replay / train loop of DreamerV3 on one device."""
    check_supported(cfg)
    unacted = unacted_settings(cfg)
    if unacted:
        warnings.warn(
            f"{', '.join(unacted)}: set, but not acted on by the port yet (preemption signals, the telemetry "
            "hub and the profiler come with the runtime services, ROADMAP.md, queue A item 7)",
            UserWarning,
        )
    player_device = fabric.player_device(cfg)
    train_gen, player_gen = fabric.seed_everything(int(cfg.seed), player_device)

    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    ckpt_mgr = fabric.get_checkpoint_manager(cfg, log_dir)
    save_configs(cfg, log_dir)

    num_envs = int(cfg.env.num_envs)
    envs = vectorize(cfg, [make_env(cfg, cfg.seed + i, 0, run_name=log_dir, vector_env_idx=i) for i in range(num_envs)])
    obs_space = envs.single_observation_space
    act_space = envs.single_action_space
    actions_dim, is_continuous = spaces_to_dims(act_space)
    act_width = int(sum(actions_dim))
    cnn_keys = tuple(cfg.algo.cnn_keys.encoder)
    mlp_keys = tuple(cfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    print(
        f"dreamer_v3 on {fabric.device}: player on {player_device}, replay in a host ring "
        f"(buffer.device={cfg.buffer.get('device', 'auto')} resolves to the host ring in this port), "
        f"{num_envs} env(s) stepped synchronously",
        flush=True,
    )

    state: Dict[str, Any] = {}
    if cfg.checkpoint.get("resume_from"):
        # on the host: the modules, optimizers and Moments move their own
        # tensors to the device, the replay ring stays in host memory
        state = load_step_dir(cfg.checkpoint.resume_from, map_location="cpu")
        for name, gen in (("train", train_gen), ("player", player_gen)):
            gen.set_state(state["generators"][name].cpu())
    world_model, actor, critic, target_critic = build_agent(
        fabric, actions_dim, is_continuous, cfg, obs_space, state.get("agent")
    )
    trainer = DV3Trainer(cfg, world_model, actor, critic, target_critic, cnn_keys, mlp_keys, is_continuous,
                         agent_state=state.get("agent"), opt_state=state.get("opt_state"))
    sentinel = HealthSentinel.from_config(cfg)

    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)

    psync = PlayerSync(cfg, player_device, lambda: {"world_model": world_model, "actor": actor})
    rec_size = world_model.recurrent_size
    stoch_flat = world_model.stoch_flat

    def player_step(carry, obs, greedy: bool = False):
        """Encoder → one posterior step → actor on the player's modules."""
        wm, act = psync.modules["world_model"], psync.modules["actor"]
        h, z, prev_a = carry
        embed = wm.encode(obs)
        is_first = torch.zeros((h.shape[0], 1), device=player_device)
        h, z, _, _ = wm.dynamic_noise(h, z, prev_a, embed, is_first, wm.posterior_noise(h.shape[0], player_gen))
        action = act.sample(act(torch.cat([z, h], dim=-1)), player_gen, greedy=greedy)
        return (h, z, action), action

    def init_player_carry(batch: int):
        return (torch.zeros(batch, rec_size, device=player_device),
                torch.zeros(batch, stoch_flat, device=player_device),
                torch.zeros(batch, act_width, device=player_device))

    def to_env_actions(actions: np.ndarray) -> np.ndarray:
        if is_continuous:
            return actions
        idx, start = [], 0
        for d in actions_dim:
            idx.append(actions[..., start : start + d].argmax(-1))
            start += d
        return np.stack(idx, -1).astype(np.float32)

    psync.init()
    player_carry = init_player_carry(num_envs)

    seq_len = int(cfg.algo.per_rank_sequence_length)
    batch_size = int(cfg.algo.per_rank_batch_size)
    bytes_per_update = sampled_bytes_per_update(obs_space, cnn_keys, mlp_keys, act_width, seq_len, batch_size)
    capacity = max(int(cfg.buffer.size) // num_envs, seq_len * 2)
    rb = EnvIndependentReplayBuffer(
        capacity, n_envs=num_envs, buffer_cls=SequentialReplayBuffer, memmap=cfg.buffer.memmap,
        memmap_dir=os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None,
    )
    if state.get("rb") is not None:
        rb.load_state_dict(_rb_state_from_checkpoint(state["rb"]))

    policy_steps_per_iter = num_envs * int(cfg.env.action_repeat)
    total_iters = max(int(cfg.algo.total_steps) // policy_steps_per_iter, 1)
    if cfg.dry_run:
        # enough for one sequence sample, then one update
        total_iters = 2 * seq_len + 4
    learning_starts = int(cfg.algo.learning_starts) // policy_steps_per_iter if not cfg.dry_run else 0
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
    if "psync" in state:
        psync.load_state_dict(state["psync"])

    obs, _ = envs.reset(seed=int(cfg.seed))
    step_data: Dict[str, np.ndarray] = {k: np.asarray(obs[k])[None] for k in obs_keys}
    for k in ("rewards", "terminated", "truncated"):
        step_data[k] = np.zeros((1, num_envs), np.float32)
    step_data["is_first"] = np.ones((1, num_envs), np.float32)
    last_metrics = None

    for update in range(start_iter, total_iters + 1):
        policy_step += policy_steps_per_iter
        with timer("Time/env_interaction_time"):
            if update <= learning_starts and not state:
                sampled = np.stack([act_space.sample() for _ in range(num_envs)])
                if is_continuous:
                    actions = np.asarray(sampled, np.float32).reshape(num_envs, -1)
                else:
                    idx = sampled.reshape(num_envs, -1)
                    actions = np.concatenate(
                        [np.eye(d, dtype=np.float32)[idx[:, b]] for b, d in enumerate(actions_dim)], -1
                    )
            else:
                with torch.inference_mode():
                    player_carry, action = player_step(player_carry, prepare_obs(obs, cnn_keys, mlp_keys, player_device))
                actions = action.cpu().numpy().astype(np.float32)
            env_actions = to_env_actions(actions)

            step_data["actions"] = actions[None]
            rb.add({k: (v[..., None] if v.ndim == 2 else v) for k, v in step_data.items()})

            next_obs, rewards, terminated, truncated, info = envs.step(actions_for_env(env_actions, act_space))
            dones = np.logical_or(terminated, truncated)
            step_data["is_first"] = np.zeros((1, num_envs), np.float32)

            # a crashed and restarted env broke its stream: the next stored
            # step starts a new episode and the buffer truncates the old one
            roe = info.get("restart_on_exception")
            if roe is not None:
                for i in np.nonzero(np.asarray(roe, bool) & np.asarray(info["_restart_on_exception"]))[0]:
                    if dones[i]:
                        continue
                    step_data["is_first"][:, i] = 1.0
                    rb.repair_tail(i)

            for ep_ret, ep_len in episode_stats(info):
                aggregator.update("Rewards/rew_avg", ep_ret)
                aggregator.update("Game/ep_len_avg", ep_len)

            real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in obs_keys}
            done_idx = np.nonzero(dones)[0]
            if done_idx.size:
                final = final_obs_rows(info, done_idx, obs_keys)
                if final is not None:
                    for k in obs_keys:
                        real_next_obs[k][done_idx] = final[k]

            for k in obs_keys:
                step_data[k] = np.asarray(next_obs[k])[None]
            obs = next_obs
            rewards = np.asarray(rewards, np.float32)
            if cfg.env.clip_rewards:
                rewards = np.tanh(rewards)
            step_data["rewards"] = rewards[None]
            step_data["terminated"] = terminated.astype(np.float32)[None]
            step_data["truncated"] = truncated.astype(np.float32)[None]

            if done_idx.size:
                # the final transition row of each finished episode
                reset_data: Dict[str, np.ndarray] = {k: real_next_obs[k][done_idx][None] for k in obs_keys}
                reset_data["terminated"] = step_data["terminated"][:, done_idx, None]
                reset_data["truncated"] = step_data["truncated"][:, done_idx, None]
                reset_data["actions"] = np.zeros((1, done_idx.size, act_width), np.float32)
                reset_data["rewards"] = step_data["rewards"][:, done_idx, None]
                reset_data["is_first"] = np.zeros_like(reset_data["terminated"])
                rb.add(reset_data, indices=done_idx.tolist())
                step_data["rewards"][:, done_idx] = 0.0
                step_data["terminated"][:, done_idx] = 0.0
                step_data["truncated"][:, done_idx] = 0.0
                step_data["is_first"][:, done_idx] = 1.0
                rows = torch.from_numpy(done_idx).to(player_device)
                with torch.inference_mode():
                    for c in player_carry:
                        c[rows] = 0.0

        # ---------------- training ---------------------------------------------
        if update >= learning_starts and any(len(b) > seq_len for b in rb.buffer):
            per_rank_gradient_steps = ratio(policy_step)
            if cfg.dry_run:
                per_rank_gradient_steps = 1 if update == total_iters else 0
            if per_rank_gradient_steps > 0:
                with timer("Time/train_time"):
                    psync.before_dispatch()
                    # a long window (the first one repays every prefill step)
                    # is sampled, moved and guarded chunk by chunk, as the
                    # JAX loop dispatches it
                    for u in window_chunks(per_rank_gradient_steps, bytes_per_update):
                        sample = rb.sample(batch_size, n_samples=u, sequence_length=seq_len)
                        blocks = blocks_to_device(sample, cnn_keys, mlp_keys, fabric.device)
                        del sample
                        backup = trainer.snapshot() if sentinel is not None else None
                        last_metrics = trainer.train_phase(blocks, train_gen, grad_step_counter)
                        if sentinel is not None and not sentinel.check(last_metrics, trainer.tensors(), policy_step):
                            trainer.restore(backup)
                        del backup, blocks
                        grad_step_counter += u
                    psync.after_dispatch()

        # ---------------- logging ------------------------------------------------
        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or update == total_iters or cfg.dry_run
        ):
            if last_metrics is not None:
                for name, value in zip(METRIC_NAMES, last_metrics):
                    aggregator.update(name, value)
            extra = {"Params/replay_ratio": grad_step_counter / max(policy_step, 1), **psync.metrics()}
            if sentinel is not None:
                extra.update(sentinel.metrics())
            last_log = flush_metrics(aggregator, timer, logger, policy_step, last_log, extra_metrics=extra)

        # ---------------- checkpoint ---------------------------------------------
        if ckpt_mgr.should_save(policy_step, last_checkpoint, final=update == total_iters):
            last_checkpoint = policy_step
            ckpt_state = {
                "agent": trainer.agent_state(),
                "opt_state": trainer.opt_state(),
                "generators": {"train": train_gen.get_state(), "player": player_gen.get_state()},
                "update": update,
                "policy_step": policy_step,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "ratio": ratio.state_dict(),
                "psync": psync.state_dict(),
                "grad_steps": grad_step_counter,
            }
            if cfg.buffer.checkpoint:
                ckpt_state["rb"] = rb.state_dict()
            ckpt_mgr.save(policy_step, ckpt_state)

    envs.close()
    ckpt_mgr.finalize()
    if cfg.algo.run_test:
        # the deferred-sync player may be a window behind: sync once more
        psync.init()

        def test_step(carry, raw_obs, greedy):
            with torch.inference_mode():
                carry, action = player_step(carry if carry is not None else init_player_carry(1),
                                            prepare_obs(raw_obs, cnn_keys, mlp_keys, player_device), greedy)
            return carry, to_env_actions(action.cpu().numpy())

        test(test_step, cfg, log_dir, logger)
    if logger is not None:
        logger.close()
