"""Shared Plan2Explore state plumbing (after ``sheeprl_tpu/algos/p2e_utils.py``).

Every P2E variant stores two policies in its exploration snapshot: the
exploration actor under ``"actor"`` (the one the player acts with during
exploration) and the task policy under ``"actor_task"``.  Evaluation and
finetuning pick between them by ``algo.player.actor_type``.  Also what the
variants share beyond the JAX module: the ensembles' intrinsic reward and
training loss, the extra modules of P2E-DV1/DV2, the optimizers of every
variant and the finetuning start from an exploration snapshot.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from sheeprl_tpu_torch.algos.dreamer_v3.agent import Ensembles, place_modules
from sheeprl_tpu_torch.config.compose import ConfigError
from sheeprl_tpu_torch.utils.optim import ClippedOptimizer, build_group_optimizers


def actor_type_from_cfg(cfg: Any) -> str:
    return cfg.algo.get("player", {}).get("actor_type", "task")


def choose_actor(agent: Dict[str, Any], cfg: Any) -> Dict[str, Any]:
    """Swap the task actor into the ``"actor"`` slot when configured (and
    available: snapshots of a single policy carry only ``"actor"``)."""
    if "actor_task" in agent and actor_type_from_cfg(cfg) == "task":
        return {**agent, "actor": agent["actor_task"]}
    return agent


def project_exploration_state(
    state: Dict[str, Any],
    actor_type: str,
    keep_keys: Sequence[str],
    defaults: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Project an exploration snapshot onto a base-Dreamer state layout:
    keep ``keep_keys`` (world model, task critic and target, ...), select the
    actor by ``actor_type``, and fill ``defaults`` for keys the snapshot may
    lack."""
    agent = dict(state.get("agent", {}))
    chosen_actor = agent.get("actor_task") if actor_type == "task" else agent.get("actor")
    projected = {k: agent[k] for k in keep_keys if k in agent}
    for k, v in (defaults or {}).items():
        projected.setdefault(k, agent.get(k, v))
    projected["actor"] = chosen_actor if chosen_actor is not None else agent["actor"]
    out = {"agent": projected}
    if "rb" in state:
        out["rb"] = state["rb"]
    return out


def ensemble_disagreement(preds, multiplier: float):
    """Plan2Explore intrinsic reward: the unbiased variance (N - 1 divisor,
    as torch's ``var``) of the ensemble's next-state predictions over the
    members, averaged over the feature axis, times ``multiplier``.

    ``preds``: (n_ensembles, ..., feature_dim)."""
    return preds.var(0, unbiased=True).mean(-1) * multiplier


def ensemble_loss(ensembles, latents, actions, stoch_flat: int):
    """The forward models' MSE: every member predicts the next posterior
    state z_{t+1} from (latent_t ⊕ a_t) over an (L, B) block, inputs and
    targets without gradient."""
    L, B = latents.shape[:2]
    inp = torch.cat([latents.detach(), actions.detach()], dim=-1)[:-1].reshape((L - 1) * B, -1)
    target = latents[1:, :, :stoch_flat].detach().reshape(1, (L - 1) * B, -1)
    return torch.mean((ensembles(inp) - target) ** 2)


def exploration_initial_state(cfg: Any, project: Callable[[Dict[str, Any], str], Dict[str, Any]]
                              ) -> Optional[Dict[str, Any]]:
    """The exploration snapshot of ``checkpoint.exploration_ckpt_path`` (the
    port's, or one the JAX package wrote) projected by ``project`` (on the host, without its replay buffer unless
    ``buffer.load_from_exploration``), or None on a finetuning restart
    (``checkpoint.resume_from``); raises ``ConfigError`` when neither is given."""
    from sheeprl_tpu_torch.convert import load_resume_state
    from sheeprl_tpu_torch.serve.loader import resolve_checkpoint

    path = cfg.checkpoint.get("exploration_ckpt_path")
    if path in (None, "", "???"):
        if cfg.checkpoint.get("resume_from"):
            return None
        raise ConfigError(
            "p2e finetuning needs checkpoint.exploration_ckpt_path "
            "(or checkpoint.resume_from for a finetuning restart)"
        )
    ckpt = resolve_checkpoint(path)
    # a JAX-written exploration snapshot is converted first (its optimizer
    # states are not carried over, as the projection carries none)
    state = project(load_resume_state(ckpt, cfg), actor_type_from_cfg(cfg))
    if not cfg.buffer.get("load_from_exploration", False):
        state.pop("rb", None)
    return state


def add_exploration_modules(fabric: Any, cfg: Any, modules: Dict[str, torch.nn.Module],
                            actions_dim: Sequence[int], is_continuous: bool, state: Optional[Dict[str, Any]],
                            new_actor: Callable[..., torch.nn.Module], new_critic: Callable[..., torch.nn.Module],
                            target_critic: bool) -> Dict[str, torch.nn.Module]:
    """The base agent ``modules`` plus what P2E-DV1/DV2 add: the ensembles
    (no LayerNorm) over latent ⊕ action, the task actor, the exploration
    critic and, with ``target_critic``, its target.  Without ``state`` they
    are initialised from ``cfg.seed + 1``, in that order."""
    ens = cfg.algo.ensembles
    wm = modules["world_model"]
    dtype = fabric.precision.compute_dtype
    with torch.device("meta" if state is not None else fabric.device):
        extra = {
            "ensembles": Ensembles(int(ens.n), wm.stoch_flat + wm.recurrent_size + int(sum(actions_dim)),
                                   int(ens.dense_units), int(ens.mlp_layers), wm.stoch_flat, act=cfg.algo.dense_act,
                                   layer_norm=False),  # fp32 whatever the policy, as in JAX
            "actor_task": new_actor(cfg, actions_dim, is_continuous, dtype),
            "critic_exploration": new_critic(cfg, dtype),
        }
        if target_critic:
            extra["target_critic_exploration"] = new_critic(cfg, dtype)
    place_modules(extra, state, fabric.device, int(cfg.seed) + 1, {"target_critic_exploration": "critic_exploration"})
    return {**modules, **extra}


def p2e_optimizers(cfg: Any, modules: Dict[str, Any],
                   saved: Optional[Dict[str, Any]] = None) -> Dict[str, ClippedOptimizer]:
    """One optimizer for every optimized module present: the world model,
    both actors (the actor's settings), the task critic and the exploration
    critic (``critic_exploration`` of P2E-DV1/DV2) or critics
    (``critics_exploration.<name>`` of P2E-DV3, the critic's settings), and
    the ensembles."""
    algo = cfg.algo
    sections = {"world_model": algo.world_model, "actor": algo.actor, "actor_task": algo.actor,
                "critic": algo.critic, "critic_exploration": algo.critic, "ensembles": algo.ensembles}
    flat = {name: modules[name] for name in sections if name in modules}
    groups = {name: sections[name] for name in flat}
    for name, pair in modules.get("critics_exploration", {}).items():
        flat[f"critics_exploration.{name}"] = pair["critic"]
        groups[f"critics_exploration.{name}"] = algo.critic
    return build_group_optimizers(flat, groups, saved)
