"""DreamerV3 training on one device (counterpart of
``sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py``), and what the whole Dreamer
family shares: the trainer base, the env/replay/train loop and evaluation.

One update (:meth:`DV3Trainer.train_step`) follows the JAX
``single_update``:

* the world model: encoder → posterior scan over the sequence
  (``WorldModel.dynamic_noise``, one recurrent step per time step; with
  ``decoupled_rssm`` every posterior in one batched pass and only
  ``WorldModel.recurrent_prior`` in the scan) → decoder, reward and continue
  heads → ``world_model_loss``; Adam step;
* the behaviour: an imagination scan of ``horizon + 1`` steps from every
  posterior latent with the updated world model, λ-returns, the Moments
  percentile normaliser, the actor loss, then the critic's two-hot NLL plus
  the target regulariser;
* the target-critic EMA where ``counter % target_freq == 0``, in the
  device-side form of JAX's ``do_ema`` (a ``torch.where`` blend), so one
  captured graph serves every counter.

The one-device scale layer (``parallel/pipeline.py``): with
``pipeline.microbatches`` M > 1 the world model's loss and gradient run over
M row slices of the batch through its stage chain (encoder | RSSM | heads,
fused to ``pipeline.stages`` of 1-3) in 1F1B order, the full-batch posterior
noise sliced with them, and one clipped step takes the mean gradient;
``pipeline.imagination_microbatches`` evaluates the imagination's reward,
value and continue heads in row chunks; ``algo.remat`` re-computes each scan
step in the backward (``torch.utils.checkpoint``) instead of keeping its
activations, in every member of the family.

The scans are Python loops over time.  Every random draw of an update comes
in as a tensor (:func:`draw_noise`), so a test can hand the port the draws
the JAX keys make; the loop has each update draw its own from the training
generator, so a window's noise never outgrows one update's.  The actor's gradient reaches only the actor: the world
model and the critic are frozen while its loss is built, and for discrete
actions (whose objective stops the gradient at the advantage) the
imagination runs without a graph.  With ``fused_pallas`` every recurrent
step is the CUDA kernel of ``ops/rssm.py``; its backward differentiates the
plain version, as the JAX ``custom_vjp`` does.

:func:`dreamer_family_loop` is the env/replay/train loop of every Dreamer
(V1, V2, V3 and their Plan2Explore phases, which differ in modules and
update, not in the loop): random prefill up to ``learning_starts``, the
latent player, replay adds with reset rows, ``Ratio``-governed train windows
of ``(U, L, B, *)`` blocks, metrics, checkpoints, resume, ``dry_run`` and the
final test episode.  The replay is the device-resident ring of
``data/device_replay.py`` when ``buffer.device`` resolves on (``auto``: the
run's device is CUDA), each window sampled on the device inside
:func:`~sheeprl_tpu_torch.data.device_replay.fused_sequence_train` in
power-of-two chunks; otherwise a sequential host ring, or the
``EpisodeBuffer`` with ``buffer.type=episode``, sampled with numpy and moved
to the device in chunks (:func:`window_chunks`).

The loop's train window and its player step go through ``fabric.compile``
(``parallel/compile.py``): on the card DreamerV3's window is one captured
CUDA graph per chunk size (:data:`GRAPH_WINDOW_UPDATES` updates at most,
the RSSM kernel inside) and its player one graph per batch, replayed after
their first call; the other members of the family, and a player on the
host, run eagerly under the same recompile audit.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, Critic, build_agent
from sheeprl_tpu_torch.convert import load_resume_state, restore_generators
from sheeprl_tpu_torch.envs.minedojo import MASK_KEYS
from sheeprl_tpu_torch.algos.dreamer_v3.loss import world_model_loss
from sheeprl_tpu_torch.algos.dreamer_v3.utils import (
    compute_lambda_values,
    moments_update,
    normalize_obs_block,
    prepare_obs,
    test,
)
from sheeprl_tpu_torch.algos.p2e_utils import choose_actor
from sheeprl_tpu_torch.algos.ppo.utils import actions_for_env, spaces_to_dims
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, EpisodeBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.data.device_replay import (
    build_device_replay,
    estimate_step_bytes,
    fused_sequence_train,
    resolve_device_replay,
    steady_guard,
    update_chunks,
)
from sheeprl_tpu_torch.fabric import PlayerSync
from sheeprl_tpu_torch.parallel.pipeline import (
    PIPELINE_AXIS,
    PipelineSpec,
    chunked_rows,
    merge_microbatches,
    pipeline_value_and_grad,
    register_pipeline_metrics,
    resolve_pipeline,
    split_microbatches,
)
from sheeprl_tpu_torch.resilience.health import DivergenceError, HealthSentinel
from sheeprl_tpu_torch.utils.callback import replay_state
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
from sheeprl_tpu_torch.utils.profiler import ProfilerGate
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer, build_group_optimizers, optimizer_state_tensors
from sheeprl_tpu_torch.utils.registry import register_algorithm, register_evaluation
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
#: The world model's aux entries that are batch-shaped (merged back from
#: the microbatches); the others are means over a microbatch
BATCH_AUX = ("latents", "post_logits", "prior_logits")
#: Updates in one captured window graph at most: a longer window replays a
#: chunk's graph several times.  A graph holds every launch of its updates
#: (≈ 18 k per DreamerV3-XL update), so capturing the first window's 1,024
#: updates whole would build a graph of millions of nodes.
GRAPH_WINDOW_UPDATES = 4


def check_supported(cfg: Any) -> PipelineSpec:
    """Raise for the settings the port does not implement yet, naming the
    ROADMAP item that will; return the run's validated ``pipeline`` group
    (its algorithm checked as the JAX loop checks it)."""
    mesh = (cfg.get("fabric") or {}).get("mesh_shape") or {}
    if int(mesh.get(PIPELINE_AXIS, 1) or 1) > 1:
        raise NotImplementedError(
            "a 'pipeline' mesh axis (fabric.mesh_shape) places the stages on device groups, which is not ported "
            "yet: the scale layer above one device comes later (ROADMAP.md, queue A item 5(b)); on one device "
            "pipeline.stages and pipeline.microbatches run without it"
        )
    if int((cfg.get("fabric") or {}).get("devices", 1) or 1) > 1:
        raise NotImplementedError(
            "fabric.devices > 1 is not ported yet: the scale layer above one device comes later "
            "(ROADMAP.md, queue A item 5(b))"
        )
    pipe = resolve_pipeline(cfg)
    pipe.check_algo(cfg.algo.name)
    return pipe


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


def build_dv3_optimizers(cfg: Any, modules: Dict[str, torch.nn.Module], saved: Optional[Dict[str, Any]] = None,
                         capturable: bool = False) -> Dict[str, ClippedOptimizer]:
    """The world model's, actor's and critic's optimizers, with their saved
    state when given; ``capturable`` for a window captured as a CUDA graph."""
    algo = cfg.algo
    groups = {"world_model": algo.world_model, "actor": algo.actor, "critic": algo.critic}
    return build_group_optimizers(modules, groups, saved, capturable=capturable)


def draw_noise(world_model: Any, actor: Actor, U: int, L: int, B: int, horizon: int,
               generator: torch.Generator, task_rollout: bool = False) -> Dict[str, Any]:
    """Every random draw of ``U`` updates on ``(L, B)`` blocks:
    ``posterior`` (U, L, B, *latent) — a Gumbel (S, D) for categorical
    latents, a normal (stoch,) for Gaussian ones; ``actions``, per action
    branch, a Gumbel (U, H+1, L*B, d) or, for continuous actions, one normal
    (U, H+1, L*B, A); ``imagination`` (U, H+1, L*B, *latent).  With
    ``task_rollout`` a second rollout's ``actions_task`` and
    ``imagination_task`` follow (the task actor of Plan2Explore)."""
    n = L * B
    noise = {"posterior": world_model.latent_noise((U, L, B), generator)}
    for suffix in ("", "_task") if task_rollout else ("",):
        noise["actions" + suffix] = actor.sample_noise((U, horizon + 1, n), generator)
        noise["imagination" + suffix] = world_model.latent_noise((U, horizon + 1, n), generator)
    return noise


def noise_slice(noise: Dict[str, Any], u: int) -> Dict[str, Any]:
    return {k: [a[u] for a in v] if isinstance(v, list) else v[u] for k, v in noise.items()}


def window_chunks(n_updates: int, bytes_per_update: int, budget: Optional[int] = None) -> List[int]:
    """Split a window of ``n_updates`` into chunks whose sampled ``(U, L, B, *)``
    blocks hold at most ``budget`` bytes (default: ``$SHEEPRL_MAX_HBM_WINDOW_BYTES``,
    else 2 GiB); a chunk holds at least one update."""
    if budget is None:
        budget = int(os.environ.get(WINDOW_BYTES_ENV, WINDOW_BYTES_DEFAULT))
    cap = max(1, budget // max(1, bytes_per_update))
    return [min(cap, n_updates - i) for i in range(0, n_updates, cap)]


def zero_moments(saved: Optional[Dict[str, torch.Tensor]], device: torch.device) -> Dict[str, torch.Tensor]:
    """A Moments state ``{low, high}``: the saved one on ``device``, else zeros."""
    return {k: (saved[k].to(device).float().clone() if saved else torch.zeros((), device=device))
            for k in ("low", "high")}


def _tree_state(tree: Any) -> Any:
    if isinstance(tree, torch.nn.Module):
        return tree.state_dict()
    if isinstance(tree, torch.Tensor):
        return tree
    return {k: _tree_state(v) for k, v in tree.items()}


def _tree_load(tree: Dict[str, Any], state: Dict[str, Any]) -> None:
    """Load ``state`` into ``tree`` in place: modules by ``load_state_dict``,
    a tensor entry (Moments) by a copy into it."""
    for k, v in tree.items():
        if isinstance(v, torch.nn.Module):
            v.load_state_dict(state[k])
        elif isinstance(v, torch.Tensor):
            v.copy_(state[k])
        else:
            _tree_load(v, state[k])


def _tree_tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree.values() for t in _tree_tensors(v)]


class DreamerTrainer:
    """What the Dreamer family's trainers share: the modules (``agent``, the
    dict the loop's ``build_agent_fn`` returns), the extra state (Moments)
    and the optimizers of a run, as one tree (:meth:`state_tree`) that the
    checkpoint and the health guard walk; the window
    of updates (:meth:`train_phase`); and the imagination scan.  A subclass
    gives :meth:`train_step` (one update on an ``(L, B, *)`` block returning
    the ten metrics of :data:`METRIC_NAMES`) and adds its extra state to
    :meth:`state_tree`."""

    #: whether each update imagines a second rollout, for a task actor
    task_rollout = False
    #: why the loop runs this trainer's window eagerly on the card (None:
    #: captured as a CUDA graph per chunk size)
    graph_eager_reason: Optional[str] = "its window is not captured yet (ROADMAP.md, queue A item 3)"

    def __init__(self, cfg: Any, modules: Dict[str, Any], optimizers: Dict[str, ClippedOptimizer],
                 cnn_keys: Sequence[str], mlp_keys: Sequence[str], is_continuous: bool):
        self.cfg = cfg
        self.agent = dict(modules)
        self.world_model, self.actor = modules["world_model"], modules["actor"]
        self.optimizers = optimizers
        self.cnn_keys, self.mlp_keys = tuple(cnn_keys), tuple(mlp_keys)
        self.obs_keys = self.cnn_keys + self.mlp_keys
        self.is_continuous = is_continuous
        self.device = next(self.world_model.parameters()).device
        algo = cfg.algo
        self.horizon = int(algo.horizon)
        self.gamma = float(algo.gamma)
        self.lmbda = float(algo.lmbda)
        #: ``algo.remat``: the scan steps are re-computed in the backward (:meth:`scan_step`)
        self.remat = bool(algo.get("remat", False))
        self.last_wm_grad_norm: Optional[torch.Tensor] = None
        #: the mean intrinsic reward of the last update's exploration rollout
        #: (Plan2Explore; None without ensembles)
        self.last_intrinsic: Optional[torch.Tensor] = None

    # -- state ---------------------------------------------------------------
    def state_tree(self) -> Dict[str, Any]:
        return dict(self.agent)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {k: v for k, v in self.state_tree().items() if isinstance(v, torch.nn.Module)}

    def agent_state(self) -> Dict[str, Any]:
        return _tree_state(self.state_tree())

    def opt_state(self) -> Dict[str, Any]:
        return {name: opt.state_dict() for name, opt in self.optimizers.items()}

    def tensors(self) -> List[torch.Tensor]:
        """Every trained tensor: parameters, target networks and Moments."""
        return _tree_tensors(self.state_tree())

    def guarded_state(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """What the health guard covers: :meth:`tensors` and the optimizers' state."""
        return self.tensors(), optimizer_state_tensors(self.optimizers)

    def snapshot(self) -> Dict[str, Any]:
        """A device copy of the whole trained state."""
        return _clone({"agent": self.agent_state(), "opt": self.opt_state()})

    def restore(self, snap: Dict[str, Any]) -> None:
        """Load ``snap`` by copying into the state's own tensors (a captured
        window keeps the addresses it saw); ``snap`` stays intact."""
        with torch.no_grad():
            _tree_load(self.state_tree(), snap["agent"])
        for name, opt in self.optimizers.items():
            opt.copy_state_(snap["opt"][name])

    # -- update pieces -------------------------------------------------------
    def encode(self, data: Dict[str, torch.Tensor]):
        """Normalised observations and their embeddings (L, B, E)."""
        L, B = data["rewards"].shape
        obs = normalize_obs_block(data, self.cnn_keys, self.obs_keys)
        embed = self.world_model.encode({k: v.reshape(L * B, *v.shape[2:]) for k, v in obs.items()}).reshape(L, B, -1)
        return obs, embed

    @staticmethod
    def rssm_inputs(data: Dict[str, torch.Tensor]):
        """The shifted actions (h_t consumes a_{t-1}) and ``is_first``
        (L, B, 1) with every sequence starting an episode."""
        actions = torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], dim=0)
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        return actions, is_first[..., None]

    def encode_block(self, data: Dict[str, torch.Tensor]):
        """:meth:`encode` and :meth:`rssm_inputs`: observations, embeddings,
        shifted actions and ``is_first``."""
        obs, embed = self.encode(data)
        return (obs, embed, *self.rssm_inputs(data))

    def scan_step(self, fn, *args):
        """One step of a sequential scan, ``fn(*args)``; under ``algo.remat``
        (JAX's ``jax.checkpoint`` on the scan body) its activations are not
        kept but computed again in the backward.  The noise is an input, so
        the re-computation needs no RNG state (which a CUDA graph capture
        could not read); it runs under the autocast state of the forward."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def posterior_scan(self, embed, actions, is_first, post_noise):
        """One posterior step per time step: (hs, zs, posterior, prior) stacked over L."""
        wm = self.world_model
        B = embed.shape[1]
        h = torch.zeros(B, wm.recurrent_size, device=self.device)
        z = torch.zeros(B, wm.stoch_flat, device=self.device)
        hs, zs, posts, priors = [], [], [], []
        for t in range(embed.shape[0]):
            h, z, post, prior = self.scan_step(wm.dynamic_noise, h, z, actions[t], embed[t], is_first[t],
                                               post_noise[t])
            hs.append(h)
            zs.append(z)
            posts.append(post)
            priors.append(prior)
        return torch.stack(hs), torch.stack(zs), torch.stack(posts), torch.stack(priors)

    def imagine(self, actor: Actor, start: torch.Tensor, action_noise: Sequence[torch.Tensor],
                imag_noise: torch.Tensor, detach_actor_input: bool = True):
        """``horizon + 1`` prior steps from ``start`` latents: the latents
        before each action (the trajectory) and the actions."""
        wm = self.world_model

        def step(h, z, noise_z, *noise_a):
            latent = torch.cat([z, h], dim=-1)
            head = actor(latent.detach() if detach_actor_input else latent)
            action = actor.sample_from_noise(head, noise_a)
            h, z = wm.imagination_noise(h, z, action, noise_z)
            return latent, action, h, z

        z = start[:, : wm.stoch_flat].contiguous()
        h = start[:, wm.stoch_flat :].contiguous()
        traj, actions = [], []
        for t in range(self.horizon + 1):
            latent, action, h, z = self.scan_step(step, h, z, imag_noise[t], *[n[t] for n in action_noise])
            traj.append(latent)
            actions.append(action)
        return torch.stack(traj), torch.stack(actions)

    def metrics(self, wm_loss, aux, policy_loss, value_loss) -> Tuple[torch.Tensor, ...]:
        """The ten metrics of :data:`METRIC_NAMES`; the latent entropies are
        those of categorical posterior and prior logits, zero for the
        Gaussian latents (whose ``aux`` has no logits)."""
        with torch.no_grad():
            if "post_logits" in aux:
                post_ent = OneHotCategorical(aux["post_logits"].detach()).entropy().sum(-1).mean()
                prior_ent = OneHotCategorical(aux["prior_logits"].detach()).entropy().sum(-1).mean()
            else:
                post_ent = prior_ent = torch.zeros((), device=self.device)
        return (
            wm_loss.detach(), aux["observation_loss"].detach(), aux["reward_loss"].detach(),
            aux["kl_loss"].detach(), aux["continue_loss"].detach(), aux["kl"].detach(),
            policy_loss, value_loss, post_ent, prior_ent,
        )

    def step_optimizer(self, name: str, loss: torch.Tensor) -> Optional[torch.Tensor]:
        opt = self.optimizers[name]
        opt.zero_grad()
        loss.backward()
        return opt.step()

    # -- update ----------------------------------------------------------------
    def train_step(self, data: Dict[str, torch.Tensor], noise: Dict[str, Any], counter: int) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def train_phase(self, blocks: Dict[str, torch.Tensor], noise: Union[Dict[str, Any], torch.Generator],
                    counter0: Union[int, torch.Tensor]):
        """``U`` updates in order over ``(U, L, B, *)`` blocks; returns the
        mean of each of the ten metrics over the window.  ``noise`` is every
        draw of the ``U`` updates (:func:`draw_noise`), or a generator from
        which each update draws its own just before it runs.  ``counter0`` is
        the gradient-step count before the window: an int, or a 0-d tensor
        on the device (what a captured window takes)."""
        U, L, B = blocks["rewards"].shape
        metrics = []
        for u in range(U):
            if isinstance(noise, torch.Generator):
                step_noise = noise_slice(draw_noise(self.world_model, self.actor, 1, L, B, self.horizon, noise,
                                                    self.task_rollout), 0)
            else:
                step_noise = noise_slice(noise, u)
            metrics.append(self.train_step({k: v[u] for k, v in blocks.items()}, step_noise, counter0 + u))
        return tuple(torch.stack(m).mean() for m in zip(*metrics))


class DV3Trainer(DreamerTrainer):
    """The modules, Moments state and optimizers of one DreamerV3 run, and
    its update."""

    graph_eager_reason = None

    def __init__(self, cfg: Any, modules: Dict[str, Any], optimizers: Dict[str, ClippedOptimizer],
                 cnn_keys: Sequence[str], mlp_keys: Sequence[str], is_continuous: bool,
                 agent_state: Optional[Dict[str, Any]] = None):
        super().__init__(cfg, modules, optimizers, cnn_keys, mlp_keys, is_continuous)
        self.critic, self.target_critic = modules["critic"], modules["target_critic"]
        self.target_critic.requires_grad_(False)
        algo = cfg.algo
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
        self.moments = zero_moments((agent_state or {}).get("moments"), self.device)
        #: the ``pipeline`` group: the world model's 1F1B microbatches and the imagination's row chunks
        self.pipe = resolve_pipeline(cfg)
        if self.pipe.enabled:
            self.stage_fns, self.stage_names = self.wm_stages()

    def state_tree(self) -> Dict[str, Any]:
        return {**self.agent, "moments": self.moments}

    # -- update ----------------------------------------------------------------
    def rssm(self, embed: torch.Tensor, actions: torch.Tensor, is_first: torch.Tensor, post_noise: torch.Tensor):
        """The RSSM over the sequence: (latents (L, B, stoch+rec), posterior
        logits, prior logits), sampled with the drawn posterior noise."""
        wm = self.world_model
        L, B = embed.shape[:2]
        if wm.decoupled_rssm:
            # every posterior from its embedding in one pass, sampled with the
            # per-step draws; only the recurrent step and the prior stay in the scan
            post_logits = wm.posterior_decoupled(embed.reshape(L * B, -1)).reshape(
                L, B, wm.stochastic_size, wm.discrete_size)
            zs = OneHotCategorical(post_logits, unimix=wm.unimix).rsample_from_noise(post_noise).reshape(L, B, -1)
            prev_zs = torch.cat([torch.zeros_like(zs[:1]), zs[:-1]], dim=0)
            h = torch.zeros(B, wm.recurrent_size, device=self.device)
            hs, priors = [], []
            for t in range(L):
                h, prior = self.scan_step(wm.recurrent_prior, h, prev_zs[t], actions[t], is_first[t])
                hs.append(h)
                priors.append(prior)
            hs, prior_logits = torch.stack(hs), torch.stack(priors)
        else:
            hs, zs, post_logits, prior_logits = self.posterior_scan(embed, actions, is_first, post_noise)
        return torch.cat([zs, hs], dim=-1), post_logits, prior_logits

    def heads_losses(self, data: Dict[str, torch.Tensor], obs: Dict[str, torch.Tensor], latents: torch.Tensor,
                     post_logits: torch.Tensor, prior_logits: torch.Tensor):
        """Decoder, reward and continue heads on the latents → (loss, aux with
        latents and logits)."""
        wm = self.world_model
        L, B = data["rewards"].shape
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

    def wm_forward(self, data: Dict[str, torch.Tensor], post_noise: torch.Tensor):
        """Encoder + RSSM + heads → (loss, aux with latents and logits)."""
        obs, embed = self.encode(data)
        actions, is_first = self.rssm_inputs(data)
        return self.heads_losses(data, obs, *self.rssm(embed, actions, is_first, post_noise))

    def wm_stages(self) -> Tuple[Tuple[Any, ...], Tuple[str, ...]]:
        """The world model's stage chain for :func:`pipeline_value_and_grad`
        and the stages' names (JAX's ``make_wm_stages``): encoder | rssm |
        heads at ``pipeline.stages`` 3, encoder+rssm | heads at 2, the world
        model alone at 1.  A stage's constant is ``{"data": (L, b, *),
        "noise": (L, b, *latent)}``; the heads stage normalises the
        observations again from it, so no encoder output outlives its stage."""
        def enc(_carry, const):
            return self.encode(const["data"])[1]

        def rssm(embed, const):
            return self.rssm(embed, *self.rssm_inputs(const["data"]), const["noise"])

        def heads(carry, const):
            data = const["data"]
            return self.heads_losses(data, normalize_obs_block(data, self.cnn_keys, self.obs_keys), *carry)

        stages = self.pipe.stages
        if stages >= 3:
            if stages > 3:
                raise ValueError(
                    f"pipeline.stages={stages}: the dreamer_v3 stage map has "
                    "3 units (encoder, rssm, heads) — use stages in {1, 2, 3}"
                )
            return (enc, rssm, heads), ("encoder", "rssm", "heads")
        if stages == 2:
            return (lambda _carry, const: rssm(enc(None, const), const), heads), ("encoder_rssm", "heads")
        return (lambda _carry, const: heads(rssm(enc(None, const), const), const),), ("world_model",)

    def world_model_update(self, data: Dict[str, torch.Tensor], post_noise: torch.Tensor):
        """The world model's loss and step; with the pipeline on, over
        ``pipeline.microbatches`` row slices of the batch in 1F1B order, the
        full-batch noise sliced with them, then one clipped step on the mean
        gradient."""
        if not self.pipe.enabled:
            wm_loss, aux = self.wm_forward(data, post_noise)
            self.last_wm_grad_norm = self.step_optimizer("world_model", wm_loss)
            return wm_loss, aux
        opt = self.optimizers["world_model"]
        opt.zero_grad()
        M = self.pipe.microbatches
        consts = split_microbatches({"data": data, "noise": post_noise}, M, axis=1)
        wm_loss, aux_m, _ = pipeline_value_and_grad(self.stage_fns, opt.params, consts, microbatches=M,
                                                    stage_names=self.stage_names)
        # the batch-shaped aux back to (L, B, *), the microbatch means to the batch mean
        aux = {k: merge_microbatches(v, axis=1) if k in BATCH_AUX else v.mean(0) for k, v in aux_m.items()}
        self.last_wm_grad_norm = opt.step()
        return wm_loss, aux

    def head_chunks(self, fn, flat: torch.Tensor) -> torch.Tensor:
        """A head over the imagination rows, in ``pipeline.imagination_microbatches`` row chunks."""
        return chunked_rows(fn, flat, self.pipe.imagination_microbatches)

    def critic_mean(self, critic: Critic, flat: torch.Tensor) -> torch.Tensor:
        """The two-hot mean of ``critic`` on (H+1)·n rows, as (H+1, n)."""
        logits = self.head_chunks(critic, flat).reshape(self.horizon + 1, -1, self.bins)
        return TwoHotEncodingDistribution(logits, dims=1).mean[..., 0]

    def critic_regression(self, critic: Critic, target: Critic, traj: torch.Tensor, lambda_values: torch.Tensor,
                          discount: torch.Tensor, opt_name: str) -> torch.Tensor:
        """The critic's two-hot NLL of the λ-returns plus the target
        regulariser, over the trajectory without its last step; one step."""
        H = self.horizon
        flat_sg = traj[:-1].detach().reshape(H * traj.shape[1], -1)
        with torch.no_grad():
            target_mean = TwoHotEncodingDistribution(
                self.head_chunks(target, flat_sg).reshape(H, -1, self.bins), dims=1).mean
        qv = TwoHotEncodingDistribution(self.head_chunks(critic, flat_sg).reshape(H, -1, self.bins), dims=1)
        value_loss = torch.mean((-qv.log_prob(lambda_values.detach()[..., None]) - qv.log_prob(target_mean))
                                * discount[:-1])
        self.step_optimizer(opt_name, value_loss)
        return value_loss.detach()

    def actor_objective(self, actor: Actor, traj: torch.Tensor, actions_seq: torch.Tensor,
                        advantage: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
        """The policy loss: the advantage itself for continuous actions
        (dynamics backprop), REINFORCE with the advantage stopped for
        discrete ones, plus the entropy bonus."""
        heads = actor(traj.detach())
        if self.is_continuous:
            objective = advantage
        else:
            objective = actor.log_prob(heads[:-1], actions_seq[:-1].detach()) * advantage.detach()
        entropy = actor.entropy(heads[:-1])
        return -torch.mean(discount[:-1] * (objective + self.ent_coef * entropy))

    def imagined_continues(self, flat: torch.Tensor, terminated: torch.Tensor) -> torch.Tensor:
        """The continue head's mode on the trajectory, the true continue first."""
        n = terminated.numel()
        logits = self.head_chunks(self.world_model.continue_logits, flat).reshape(self.horizon + 1, n)
        continues = Bernoulli(logits).mode()
        return torch.cat([(1.0 - terminated).reshape(1, n), continues[1:]], dim=0)

    def behavior(self, actor: Actor, critic: Critic, target_critic: Critic, moments: Dict[str, torch.Tensor],
                 latents: torch.Tensor, terminated: torch.Tensor, action_noise, imag_noise,
                 actor_opt: str = "actor", critic_opt: str = "critic"):
        """Imagination, λ-returns, Moments (updated in place), the actor and
        the critic steps on the extrinsic reward."""
        wm = self.world_model
        H = self.horizon
        n = terminated.numel()
        start = latents.detach().reshape(n, -1)
        with frozen(wm, critic):
            # discrete actions: the objective stops the gradient at the
            # advantage, so nothing flows back through the imagination
            with torch.enable_grad() if self.is_continuous else torch.no_grad():
                traj, actions_seq = self.imagine(actor, start, action_noise, imag_noise)
                flat = traj.reshape((H + 1) * n, -1)
                reward_logits = self.head_chunks(wm.reward_logits, flat).reshape(H + 1, n, -1)
                rewards = TwoHotEncodingDistribution(reward_logits, dims=1).mean[..., 0]
                values = self.critic_mean(critic, flat)
                continues = self.imagined_continues(flat, terminated)
                lambda_values = compute_lambda_values(rewards[1:], values[1:], continues[1:] * self.gamma, self.lmbda)
                discount = (torch.cumprod(continues * self.gamma, dim=0) / self.gamma).detach()
            new_moments, offset, invscale = moments_update(moments, lambda_values, **self.moments_cfg)
            advantage = (lambda_values - offset) / invscale - (values[:-1] - offset) / invscale
            policy_loss = self.actor_objective(actor, traj, actions_seq, advantage, discount)
            self.step_optimizer(actor_opt, policy_loss)
        with torch.no_grad():
            for k, v in new_moments.items():
                moments[k].copy_(v)  # in place: a captured window keeps the address
        value_loss = self.critic_regression(critic, target_critic, traj, lambda_values, discount, critic_opt)
        return policy_loss.detach(), value_loss

    def behavior_update(self, latents: torch.Tensor, terminated: torch.Tensor, noise: Dict[str, Any]):
        """Imagination, λ-returns, Moments, the actor and the critic steps."""
        return self.behavior(self.actor, self.critic, self.target_critic, self.moments, latents, terminated,
                             noise["actions"], noise["imagination"])

    def target_update(self, counter: Union[int, torch.Tensor]) -> None:
        """The target critic's EMA where ``counter % target_freq == 0`` — JAX's
        ``do_ema`` on the device: the blend is computed every update and kept
        by ``torch.where``, so no Python branch reads the counter and one
        captured graph serves every counter."""
        do = counter % self.target_freq == 0
        if not isinstance(do, torch.Tensor):
            do = torch.full((), bool(do), dtype=torch.bool, device=self.device)
        ema_where_(self.target_critic, self.critic, self.tau, do)

    def train_step(self, data: Dict[str, torch.Tensor], noise: Dict[str, Any], counter: int) -> Tuple[torch.Tensor, ...]:
        """One update on an ``(L, B, *)`` block; returns the ten metrics."""
        wm_loss, aux = self.world_model_update(data, noise["posterior"])
        policy_loss, value_loss = self.behavior_update(aux["latents"], data["terminated"], noise)
        self.target_update(counter)
        return self.metrics(wm_loss, aux, policy_loss, value_loss)


def ema_(target: torch.nn.Module, online: torch.nn.Module, tau: float) -> None:
    """``target ← (1 - tau) · target + tau · online``, parameter by parameter."""
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_((1 - tau) * t + tau * o)


def ema_where_(target: torch.nn.Module, online: torch.nn.Module, tau: float, do: torch.Tensor) -> None:
    """:func:`ema_` where the 0-d bool ``do`` holds, else ``target`` as it is."""
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.copy_(torch.where(do, (1 - tau) * t + tau * o, t))


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


def prep_blocks(b: Dict[str, torch.Tensor], cnn_keys, mlp_keys) -> Dict[str, torch.Tensor]:
    """Blocks gathered from the device ring, laid out as
    :func:`blocks_to_device` lays out a host sample (bit for bit): images
    uint8 (frame stacks merged into channels), vectors float32 flattened to
    (U, L, B, -1), ``rewards``/``terminated``/``is_first`` (U, L, B)."""
    out: Dict[str, torch.Tensor] = {}
    for k in cnn_keys:
        x = b[k]
        out[k] = merge_framestack(x) if x.ndim == 7 else x
    for k in mlp_keys:
        x = b[k].to(torch.float32)
        out[k] = x.reshape(*x.shape[:3], -1)
    out["actions"] = b["actions"].to(torch.float32)
    for k in ("rewards", "terminated", "is_first"):
        out[k] = b[k][..., 0].to(torch.float32)
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
    dreamer_family_loop(fabric, cfg, build_agent, DV3Trainer)


@register_evaluation(algorithms="dreamer_v3")
def evaluate(fabric: Any, cfg: Any, state: Dict[str, Any]) -> float:
    return evaluate_dreamer(fabric, cfg, state, build_agent)


def evaluate_dreamer(fabric: Any, cfg: Any, state: Dict[str, Any], build_agent_fn: Any) -> float:
    """One greedy test episode of a family snapshot with the latent player
    (the JAX package's ``_evaluate_dreamer``): the agent is rebuilt by
    ``build_agent_fn`` from ``state["agent"]``, whose ``actor`` is the task
    or exploration policy as ``algo.player.actor_type`` chooses when the
    snapshot holds both.  Returns the cumulative reward."""
    log_dir = get_log_dir(cfg.root_dir, cfg.run_name, base=cfg.get("log_dir", "logs/runs"))
    logger = get_logger(cfg, log_dir)
    env = make_env(cfg, cfg.seed, 0)()
    actions_dim, is_continuous = spaces_to_dims(env.action_space)
    obs_space = env.observation_space
    env.close()
    modules = build_agent_fn(fabric, actions_dim, is_continuous, cfg, obs_space, choose_actor(state["agent"], cfg))
    wm, actor = modules["world_model"], modules["actor"]
    cnn_keys, mlp_keys = tuple(cfg.algo.cnn_keys.encoder), tuple(cfg.algo.mlp_keys.encoder)
    gen = torch.Generator(fabric.device).manual_seed(int(cfg.seed))
    action_masks = use_action_masks(cfg)

    def test_step(carry, raw_obs, greedy):
        if carry is None:
            carry = (torch.zeros(1, wm.recurrent_size, device=fabric.device),
                     torch.zeros(1, wm.stoch_flat, device=fabric.device),
                     torch.zeros(1, int(sum(actions_dim)), device=fabric.device))
        with torch.inference_mode():
            carry, action = latent_player_step(wm, actor, carry, prepare_obs(raw_obs, cnn_keys, mlp_keys,
                                                                             fabric.device), gen, greedy,
                                               action_masks=action_masks)
        return carry, one_hot_to_env(action.cpu().numpy(), actions_dim, is_continuous)

    reward = test(test_step, cfg, log_dir, logger)
    if logger is not None:
        logger.close()
    return reward


def latent_player_step(world_model: Any, actor: Actor, carry, obs: Dict[str, torch.Tensor],
                       generator: torch.Generator, greedy: bool = False, action_masks: bool = False):
    """The latent player's step: encoder → one posterior step → actor.
    ``carry`` is (h, z, previous action); returns the new carry and the action.
    With ``action_masks`` (``algo.actor.action_masks``) the actor samples
    through the MineDojo mask observations of ``obs``
    (:meth:`Actor.sample_masked`)."""
    h, z, prev_a = carry
    embed = world_model.encode(obs)
    is_first = torch.zeros((h.shape[0], 1), device=h.device)
    h, z, _, _ = world_model.dynamic_noise(h, z, prev_a, embed, is_first,
                                           world_model.posterior_noise(h.shape[0], generator))
    head = actor(torch.cat([z, h], dim=-1))
    if action_masks:
        action = actor.sample_masked(head, generator, {k: obs[k] for k in MASK_KEYS}, greedy=greedy)
    else:
        action = actor.sample(head, generator, greedy=greedy)
    return (h, z, action), action


def use_action_masks(cfg: Any) -> bool:
    """``algo.actor.action_masks``: the player samples through the MineDojo
    mask observations, which must be among the encoder's mlp keys."""
    if not bool((cfg.algo.get("actor") or {}).get("action_masks", False)):
        return False
    missing = [k for k in MASK_KEYS if k not in cfg.algo.mlp_keys.encoder]
    if missing:
        raise ValueError(f"algo.actor.action_masks=True needs the mask observations {missing} in "
                         "algo.mlp_keys.encoder")
    return True


def one_hot_to_env(actions: np.ndarray, actions_dim: Sequence[int], is_continuous: bool) -> np.ndarray:
    """Player actions (one-hot branches, or continuous values) → what the env
    steps with: the branch indices as floats, or the values."""
    if is_continuous:
        return actions
    idx, start = [], 0
    for d in actions_dim:
        idx.append(actions[..., start : start + d].argmax(-1))
        start += d
    return np.stack(idx, -1).astype(np.float32)


def dreamer_family_loop(fabric: Any, cfg: Any, build_agent_fn: Any = build_agent,
                        make_trainer_fn: Any = DV3Trainer, optimizer_builder: Any = None,
                        initial_state: Optional[Dict[str, Any]] = None) -> None:
    """The env / replay / train loop of the Dreamer family on one device
    (the JAX loop's parameters):

    * ``build_agent_fn(fabric, actions_dim, is_continuous, cfg, obs_space,
      agent_state)`` → the agent's named modules (``world_model`` and
      ``actor`` drive the player);
    * ``make_trainer_fn(cfg, modules, optimizers, cnn_keys, mlp_keys,
      is_continuous, agent_state)`` → a :class:`DreamerTrainer` (a trainer
      class);
    * ``optimizer_builder(cfg, modules, saved)`` → the named optimizers
      (default: :func:`build_dv3_optimizers`);
    * ``initial_state``: a state to start from when not resuming (the
      projected exploration snapshot of a finetuning run); like a resumed
      one, it skips the random prefill."""
    pipe = check_supported(cfg)
    if pipe.enabled:
        register_pipeline_metrics(pipe)
    fabric.warm_kernels(cfg)
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
    episodic = cfg.buffer.get("type", "sequential") == "episode"
    # the EpisodeBuffer layout has no ring: it keeps the host path, as in JAX
    use_device_replay = not episodic and resolve_device_replay(cfg, fabric.device)

    state: Dict[str, Any] = dict(initial_state or {})
    if cfg.checkpoint.get("resume_from"):
        # on the host: the modules, optimizers and Moments move their own
        # tensors to the device, the replay ring stays in host memory
        state = load_resume_state(cfg.checkpoint.resume_from, cfg)
    restore_generators(state, {"train": train_gen, "player": player_gen})
    modules = build_agent_fn(fabric, actions_dim, is_continuous, cfg, obs_space, state.get("agent"))
    if optimizer_builder is None:
        # a window captured on the card needs Adam's step count on the card
        capturable = fabric.device.type == "cuda" and make_trainer_fn.graph_eager_reason is None
        optimizers = build_dv3_optimizers(cfg, modules, state.get("opt_state"), capturable=capturable)
    else:
        optimizers = optimizer_builder(cfg, modules, state.get("opt_state"))
    trainer = make_trainer_fn(cfg, modules, optimizers, cnn_keys, mlp_keys, is_continuous, state.get("agent"))
    sentinel = HealthSentinel.from_config(cfg)
    if sentinel is not None:
        sentinel.register()

    aggregator = MetricAggregator(cfg.metric.aggregator.metrics if cfg.metric.log_level > 0 else {})
    timer.configure(cfg.metric)

    psync = PlayerSync(cfg, player_device, lambda: {"world_model": trainer.world_model, "actor": trainer.actor})
    rec_size = trainer.world_model.recurrent_size
    stoch_flat = trainer.world_model.stoch_flat

    action_masks = use_action_masks(cfg)

    def player_step_fn(carry, obs, greedy: bool = False):
        return latent_player_step(psync.modules["world_model"], psync.modules["actor"], carry, obs, player_gen,
                                  greedy, action_masks=action_masks)

    max_recompiles = cfg.algo.get("max_recompiles")
    # one graph per (batch, greedy) on a card player; a host player runs eagerly
    player_step = fabric.compile(player_step_fn, name=f"{cfg.algo.name}.player_step", static_argnames=("greedy",),
                                 max_recompiles=max_recompiles, device=player_device, generators=(player_gen,),
                                 eager_reason=trainer.graph_eager_reason)

    def init_player_carry(batch: int):
        return (torch.zeros(batch, rec_size, device=player_device),
                torch.zeros(batch, stoch_flat, device=player_device),
                torch.zeros(batch, act_width, device=player_device))

    psync.init()
    player_carry = init_player_carry(num_envs)

    seq_len = int(cfg.algo.per_rank_sequence_length)
    batch_size = int(cfg.algo.per_rank_batch_size)
    # every member of the family samples the same (L, B, *) block per update
    bytes_per_update = sampled_bytes_per_update(obs_space, cnn_keys, mlp_keys, act_width, seq_len, batch_size)
    memmap_dir = os.path.join(log_dir, "memmap_buffer", "rank_0") if cfg.buffer.memmap else None
    rb: Any
    if episodic:
        rb = EpisodeBuffer(max(int(cfg.buffer.size), seq_len * 4), sequence_length=seq_len, n_envs=num_envs,
                           prioritize_ends=bool(cfg.buffer.get("prioritize_ends", False)),
                           memmap=cfg.buffer.memmap, memmap_dir=memmap_dir)
        where = "an EpisodeBuffer on the host"
    elif use_device_replay:
        # the whole ring on the device, sampled inside the update; capacity
        # beyond the byte budget's window lives in the host spill tier
        rb = build_device_replay(cfg, max(int(cfg.buffer.size) // num_envs, seq_len * 2), num_envs, fabric.device,
                                 estimate_step_bytes(obs_space, obs_keys, extra_bytes=4 * (act_width + 4)),
                                 sequential=True, memmap_dir=memmap_dir)
        where = rb.describe()
    else:
        capacity = max(int(cfg.buffer.size) // num_envs, seq_len * 2)
        rb = EnvIndependentReplayBuffer(capacity, n_envs=num_envs, buffer_cls=SequentialReplayBuffer,
                                        memmap=cfg.buffer.memmap, memmap_dir=memmap_dir)
        where = "a host ring"
    guard_on = bool(cfg.buffer.get("transfer_guard", False)) and use_device_replay

    # the train window: on the device ring the whole chunk (draw, gather,
    # prep, updates) is one function; on the host ring the updates on blocks
    # sampled and moved by the loop.  Both take the gradient-step count
    # before the chunk and return it after.
    def prep(b):
        return prep_blocks(b, cnn_keys, mlp_keys)

    def device_window(n_updates, counter):
        return fused_sequence_train(trainer, rb, train_gen, batch_size, seq_len, n_updates, prep, counter)

    def host_window(n_updates, blocks, counter):
        return counter + n_updates, trainer.train_phase(blocks, train_gen, counter)

    window_fn = device_window if use_device_replay else host_window
    if sentinel is not None:
        # the health guard inside the window: backup, chunk, select, detector
        window_fn = sentinel.wrap(window_fn, trainer.guarded_state, fabric.device)
    train_window = fabric.compile(window_fn,
                                  name=f"{cfg.algo.name}.train_phase" + ("_device" if use_device_replay else ""),
                                  static_argnums=(0,), max_recompiles=max_recompiles, generators=(train_gen,),
                                  eager_reason=trainer.graph_eager_reason)
    captured = train_window.graphs
    print(f"{cfg.algo.name} on {fabric.device}: player on {player_device}, replay in {where}, "
          f"{envs.describe()}, train window "
          f"{'captured as CUDA graphs' if captured else 'eager'}, precision {fabric.precision.name}", flush=True)
    # present only when saved with buffer.checkpoint, or carried over by a
    # finetuning run's buffer.load_from_exploration
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
    train_windows = 0  # the guard arms past the first window
    # a captured window reads the count from the card (a fill, no copy)
    counter = (torch.full((), grad_step_counter, dtype=torch.int64, device=fabric.device) if captured
               else grad_step_counter)

    profiler = ProfilerGate(cfg, log_dir)
    for update in range(start_iter, total_iters + 1):
        profiler.step(update)
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
            env_actions = one_hot_to_env(actions, actions_dim, is_continuous)

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
        if episodic:
            can_sample = len(rb) > seq_len and len(rb.buffer) > 0
        elif use_device_replay:
            can_sample = rb.can_sample_sequences(seq_len)
        else:
            can_sample = any(len(b) > seq_len for b in rb.buffer)
        if update >= learning_starts and can_sample:
            per_rank_gradient_steps = ratio(policy_step)
            if cfg.dry_run:
                per_rank_gradient_steps = 1 if update == total_iters else 0
            if per_rank_gradient_steps > 0:
                with timer("Time/train_time"):
                    psync.before_dispatch()
                    # a long window (the first one repays every prefill step)
                    # is sampled, moved and guarded chunk by chunk, as the
                    # JAX loop dispatches it.  On the device ring each chunk
                    # draws and gathers its sequences there: nothing is copied
                    # from the host, and with buffer.transfer_guard a chunk
                    # after the first window that waits on the host raises (the
                    # health guard inside the chunk reads nothing back); a
                    # captured window runs in power-of-two chunks of at most
                    # GRAPH_WINDOW_UPDATES updates, one graph per chunk size
                    cap = GRAPH_WINDOW_UPDATES if captured else None
                    if use_device_replay:
                        chunks = update_chunks(per_rank_gradient_steps, cap=cap,
                                               bytes_per_update=rb.sampled_bytes_per_update(batch_size, seq_len))
                    elif captured:
                        chunks = update_chunks(per_rank_gradient_steps, cap=cap, bytes_per_update=bytes_per_update)
                    else:
                        chunks = window_chunks(per_rank_gradient_steps, bytes_per_update)
                    for u in chunks:
                        if use_device_replay:
                            with steady_guard(guard_on and train_windows > 0):
                                counter, last_metrics = train_window(u, counter)
                        else:
                            sample = rb.sample(batch_size, n_samples=u, sequence_length=seq_len)
                            blocks = blocks_to_device(sample, cnn_keys, mlp_keys, fabric.device)
                            del sample
                            counter, last_metrics = train_window(u, blocks, counter)
                            del blocks
                        grad_step_counter += u
                    train_windows += 1
                    psync.after_dispatch()

        # ---------------- training-health sentinel -------------------------------
        # the guard's state is read every health.poll_every_updates
        # iterations; the family rolls back through the process boundary, as
        # in JAX: a relaunch with checkpoint.resume_from=auto
        if (sentinel is not None and train_windows and sentinel.should_poll(update, total_iters)
                and sentinel.poll(policy_step) == "rollback"):
            raise DivergenceError(
                f"training diverged at step {policy_step}; relaunch with checkpoint.resume_from=auto to roll back "
                "to the last committed snapshot"
            )

        # ---------------- logging ------------------------------------------------
        if cfg.metric.log_level > 0 and (
            policy_step - last_log >= cfg.metric.log_every or update == total_iters or cfg.dry_run
        ):
            if last_metrics is not None:
                for name, value in zip(METRIC_NAMES, last_metrics):
                    aggregator.update(name, value)
            extra = {"Params/replay_ratio": grad_step_counter / max(policy_step, 1), **psync.metrics()}
            last_log = flush_metrics(aggregator, timer, logger, policy_step, last_log, extra_metrics=extra)

        # ---------------- checkpoint ---------------------------------------------
        if ckpt_mgr.should_save(policy_step, last_checkpoint, final=update == total_iters):
            if sentinel is not None:
                sentinel.settle()  # the last window's host-resident select, before its state is saved
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
                ckpt_state["rb"] = replay_state(rb)
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
        psync.init()

        def test_step(carry, raw_obs, greedy):
            with torch.inference_mode():
                carry, action = player_step(carry if carry is not None else init_player_carry(1),
                                            prepare_obs(raw_obs, cnn_keys, mlp_keys, player_device), greedy)
            return carry, one_hot_to_env(action.cpu().numpy(), actions_dim, is_continuous)

        test(test_step, cfg, log_dir, logger)
    if logger is not None:
        logger.close()
