"""Population training with in-trace PBT on the Anakin axis (counterpart of
``sheeprl_tpu/population/core.py``).

The JAX package vmaps whole agents over a population axis inside its one
Anakin executable: parameters, optimizer state, each member's env shard,
and the hyperparameters ``lr`` / ``ent_coef`` / ``clip_coef`` as ``(P,)``
data.  The port keeps the same layout on one device:

* **members on a leading ``P`` axis** — every parameter and optimizer
  tensor is stacked ``(P, ...)`` (:mod:`~sheeprl_tpu_torch.population.members`
  runs the single-member agent through ``torch.func.functional_call`` under
  ``torch.func.vmap``); the members' env shards are one vector env of
  ``P·B`` rows, member ``m`` owning rows ``[m·B, (m+1)·B)``;
* **hyperparameters as tensors** — a ``(P,)`` learning rate goes into the
  stacked optimizer, ``clip_coef`` / ``ent_coef`` into the loss, so a
  captured phase never freezes them;
* **fitness from the rollout** — an EMA over each member's finished-episode
  mean return, computed on the device from the rollout's episode records;
* **exploit / explore without a branch** — truncation selection by
  ``argsort``, one source index that gathers parameters AND optimizer state,
  ``torch.where`` gates everything on the update counter on the device, so
  the phase stays one captured CUDA graph whether or not it exploits.

Draws are made by generators or handed in: :func:`perturbation_factors`
makes the explore factors, and tests hand the port the factors a JAX key
draws.  State is updated in place (a captured graph reads and writes the
addresses it saw at capture).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PBTConfig:
    """Validated snapshot of the ``population`` config group (plus the
    algo's base hyperparameter values the run would use at population=1)."""

    size: int
    exploit_every: int
    warmup: int
    frac: float
    perturb_min: float
    perturb_max: float
    init_min: float
    init_max: float
    bound_min: float
    bound_max: float
    fitness_alpha: float
    levels: Optional[List[float]]
    base: Dict[str, float]

    @classmethod
    def from_cfg(cls, cfg: Any, base: Dict[str, float]) -> "PBTConfig":
        pop = cfg.population
        levels = pop.get("levels")
        self = cls(
            size=int(pop.size),
            exploit_every=int(pop.exploit_every),
            warmup=int(pop.warmup),
            frac=float(pop.frac),
            perturb_min=float(pop.perturb_min),
            perturb_max=float(pop.perturb_max),
            init_min=float(pop.init_min),
            init_max=float(pop.init_max),
            bound_min=float(pop.bound_min),
            bound_max=float(pop.bound_max),
            fitness_alpha=float(pop.fitness_alpha),
            levels=[float(x) for x in levels] if levels else None,
            base={k: float(v) for k, v in base.items()},
        )
        if self.size < 2:
            raise ValueError(f"population.size must be >= 2 to train a population (got {self.size})")
        if not 0.0 < self.frac <= 0.5:
            raise ValueError(f"population.frac must be in (0, 0.5] (got {self.frac})")
        if not 0.0 < self.perturb_min <= self.perturb_max:
            raise ValueError("population.perturb_min/max must satisfy 0 < min <= max")
        if not 0.0 < self.init_min <= self.init_max:
            raise ValueError("population.init_min/max must satisfy 0 < min <= max")
        if not 0.0 < self.bound_min <= self.bound_max:
            raise ValueError("population.bound_min/max must satisfy 0 < min <= max")
        if not 0.0 < self.fitness_alpha <= 1.0:
            raise ValueError("population.fitness_alpha must be in (0, 1]")
        return self

    @property
    def n_select(self) -> int:
        """Truncation width: how many bottom members copy from the top,
        clamped to ``[1, size // 2]``."""
        return max(1, min(self.size // 2, int(round(self.frac * self.size))))

    def clip(self, name: str, values: torch.Tensor) -> torch.Tensor:
        """``values`` clipped to ``base × [bound_min, bound_max]``."""
        base = self.base[name]
        return torch.clamp(values, base * self.bound_min, base * self.bound_max)

    def init_hyperparams(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Per-member ``(P,)`` tensors: base value × a log-uniform factor in
        ``[init_min, init_max]``, clipped to the exploration bounds.  The
        factors are drawn positionally over the sorted names, so the spread
        is reproducible per seed."""
        factors = _log_uniform(generator, self.size, self.init_min, self.init_max, sorted(self.base))
        return {name: self.clip(name, torch.tensor(self.base[name], dtype=torch.float32,
                                                    device=f.device) * f)
                for name, f in factors.items()}


def _log_uniform(generator: torch.Generator, size: int, low: float, high: float,
                 names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """One ``(size,)`` factor ``exp(U(log low, log high))`` per name, in order."""
    out = {}
    for name in names:
        u = torch.rand((size,), generator=generator, device=generator.device)
        out[name] = torch.exp(math.log(low) + u * (math.log(high) - math.log(low)))
    return out


def perturbation_factors(pbt: PBTConfig, names: Sequence[str], generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The explore step's log-uniform factors in ``[perturb_min,
    perturb_max]``, one ``(P,)`` tensor per hyperparameter, drawn in sorted
    order.  They are drawn every phase, whether or not it exploits, so the
    draws do not depend on the gate."""
    return _log_uniform(generator, pbt.size, pbt.perturb_min, pbt.perturb_max, sorted(names))


def tile_stack(tree: Any, size: int) -> Any:
    """Stack ``size`` copies of every tensor of ``tree`` (a dict, list or
    tuple of tensors) along a new leading population axis: all members
    start at the same init, and the hyperparameter spread diversifies them."""
    if isinstance(tree, dict):
        return {k: tile_stack(v, size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tile_stack(v, size) for v in tree)
    return torch.stack([tree] * size)


def apply_level_curriculum(env_state: Any, levels: List[float], size: int, num_envs: int) -> Any:
    """Pin per-member difficulty levels onto the population's env state
    (``size · num_envs`` rows, member ``m`` owning rows ``[m·num_envs,
    (m+1)·num_envs)``).

    Member ``m`` trains at ``levels[m % len(levels)]``; the envs carry the
    level as a state leaf and the autoreset keeps the carried level
    (:class:`~sheeprl_tpu_torch.envs.device.core.VectorDeviceEnv`), so the
    override holds for the whole run.  Raises for an env state with no
    level leaf (forage, whose level is a shape) rather than training a flat
    population."""
    if not hasattr(env_state, "level"):
        raise ValueError(
            "population.levels needs an env whose state carries a traced 'level' "
            "leaf (cartpole/pendulum/multiroom); static-level envs (forage) scale "
            "difficulty at construction via env.level instead"
        )
    per_member = torch.tensor([levels[m % len(levels)] for m in range(size)], dtype=torch.float32)
    level = per_member.repeat_interleave(num_envs).to(env_state.level.device)
    return env_state._replace(level=level)


@torch.no_grad()
def pbt_exploit_explore(params: Sequence[torch.Tensor], opt_state: Sequence[torch.Tensor],
                        hp: Dict[str, torch.Tensor], fitness: torch.Tensor, do_exploit: torch.Tensor,
                        factors: Dict[str, torch.Tensor], pbt: PBTConfig) -> torch.Tensor:
    """One gated truncation-selection and perturbation step, in place and
    branch-free.

    ``do_exploit`` is a 0-d bool tensor on the device; everything below is
    ``argsort`` / ``index_select`` / ``where``, with no host read, so a
    captured phase holds the same graph whether or not this call exploits.

    * exploit: the ``n_select`` worst members' source index points at the
      ``n_select`` best (worst ← best, 2nd-worst ← 2nd-best, …); everyone
      else points at themselves.  ``params`` and ``opt_state`` (stacked
      ``(P, ...)`` tensors) gather through the SAME index, so a copied member
      gets a coherent pair of weights and optimizer moments, and it inherits
      its source's fitness.
    * explore: copied members scale every hyperparameter by its factor of
      ``factors`` (:func:`perturbation_factors`), clipped to ``base ×
      [bound_min, bound_max]``; the others keep theirs (clipped alike).

    Returns the number of members overwritten, a 0-d int32 tensor (0 when
    the gate is closed)."""
    size, n = pbt.size, pbt.n_select
    idx = torch.arange(size, device=fitness.device)
    order = torch.argsort(fitness, stable=True)  # ascending: worst first, best last
    src = idx.scatter(0, order[:n], order[size - n:].flip(0))
    src = torch.where(do_exploit, src, idx)
    for t in (*params, *opt_state):
        t.copy_(t.index_select(0, src))
    fitness.copy_(fitness.index_select(0, src))
    copied = src != idx
    for name in sorted(hp):
        v = hp[name].index_select(0, src) * torch.where(copied, factors[name], torch.ones_like(factors[name]))
        hp[name].copy_(pbt.clip(name, v))
    return torch.where(do_exploit, n, 0).to(torch.int32)


def init_population_state(members: Dict[str, Any], pbt: PBTConfig, num_envs: int) -> Dict[str, Any]:
    """The population carry around the members: EMA fitness, the
    finished-episode count that gates the EMA's first observation, and the
    running exploit-event count."""
    device = members["ep_ret"].device
    if pbt.levels:
        members = dict(members)
        members["env"] = apply_level_curriculum(members["env"], pbt.levels, pbt.size, num_envs)
    return {
        "members": members,
        "fitness": torch.zeros((pbt.size,), dtype=torch.float32, device=device),
        "ep_count": torch.zeros((pbt.size,), dtype=torch.int32, device=device),
        "exploits": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_population_phase(member_phase: Callable, pbt: PBTConfig, pop: Dict[str, Any],
                          hp: Dict[str, torch.Tensor], params: Sequence[torch.Tensor],
                          opt_state: Callable[[], List[torch.Tensor]],
                          generator: Optional[torch.Generator] = None) -> Callable:
    """Wrap the members' batched phase into the population phase.

    ``member_phase(members, hp, draws) -> (members', losses, stats)`` is the
    algo's Anakin rollout and update for every member at once (the members'
    parameters and optimizer state stacked and updated in place), with the
    hyperparameters as ``(P,)`` tensors; ``stats`` holds the ``(T, P·B)``
    episode records.  The wrapper copies the new member carry into ``pop``,
    folds the window's finished episodes into the fitness EMA, counts them,
    and applies the gated PBT step to ``params`` and ``opt_state()``.

    Returns ``population_phase(draws=None) -> (losses, stats)``, ``losses``
    ``(P, 3)``.  Everything it updates is in ``pop``, ``hp``, ``params`` and
    the optimizer state, in place.  ``draws`` hands in what the generators
    would draw: ``draws["members"]`` to ``member_phase``, ``draws["factors"]``
    the explore factors (else drawn from ``generator``)."""
    size = pbt.size

    def population_phase(draws: Optional[Dict[str, Any]] = None):
        draws = draws or {}
        members = pop["members"]
        new_members, losses, stats = member_phase(members, hp, draws.get("members"))
        with torch.no_grad():
            _copy_tree_(members, new_members)
            # fitness: an EMA over each member's finished-episode mean return
            done = stats["ep_done"].to(torch.float32).reshape(stats["ep_done"].shape[0], size, -1)
            rets = stats["ep_ret"].reshape(done.shape)
            n_done = done.sum(dim=(0, 2))
            mean_ret = (rets * done).sum(dim=(0, 2)) / torch.clamp_min(n_done, 1.0)
            fitness = pop["fitness"]
            ema = pbt.fitness_alpha * mean_ret + (1.0 - pbt.fitness_alpha) * fitness
            # a member's first finished episodes seed the score directly; a
            # window with none leaves it unchanged
            seeded = torch.where(pop["ep_count"] > 0, ema, mean_ret)
            fitness.copy_(torch.where(n_done > 0, seeded, fitness))
            pop["ep_count"].add_(n_done.to(torch.int32))
            if pbt.exploit_every > 0:  # exploit_every=0 removes PBT from the phase
                update = members["update"][0]  # members advance in lockstep
                do_exploit = (update > pbt.warmup) & (update % pbt.exploit_every == 0)
                factors = draws.get("factors")
                if factors is None:
                    factors = perturbation_factors(pbt, hp, generator)
                n_copied = pbt_exploit_explore(params, opt_state(), hp, fitness, do_exploit, factors, pbt)
                pop["exploits"].add_(n_copied)
        return losses, stats

    return population_phase


def _copy_tree_(dst: Any, src: Any) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place of ``dst``."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_tree_(d, s)
    else:
        dst.copy_(src)


class PopulationMonitor:
    """``Population/*`` telemetry-hub source.

    The loop feeds it host copies of the fitness vector, hyperparameters and
    exploit counter on its logging cadence; a flush reports the members'
    fitness spread, the exploit events so far and the quantiles of the
    hyperparameters the run is exploring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fitness: Optional[np.ndarray] = None
        self._hp: Dict[str, np.ndarray] = {}
        self._exploits = 0

    def observe(self, fitness: Any, hp: Dict[str, Any], exploits: Any) -> None:
        with self._lock:
            self._fitness = _numpy(fitness)
            self._hp = {k: _numpy(v) for k, v in hp.items()}
            self._exploits = int(_numpy(exploits))

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            fitness, hp, exploits = self._fitness, self._hp, self._exploits
        if fitness is None:
            return {}
        out = {
            "Population/fitness_best": float(fitness.max()),
            "Population/fitness_worst": float(fitness.min()),
            "Population/fitness_spread": float(fitness.max() - fitness.min()),
            "Population/exploit_events": float(exploits),
        }
        for name, values in hp.items():
            out[f"Population/{name}_p10"] = float(np.quantile(values, 0.10))
            out[f"Population/{name}_p50"] = float(np.quantile(values, 0.50))
            out[f"Population/{name}_p90"] = float(np.quantile(values, 0.90))
        return out


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def write_population_summary(log_dir: str, pop: Dict[str, Any], hp: Dict[str, Any], policy_step: int) -> str:
    """Write the run's final population as ``<log_dir>/population_summary.json``
    (the JAX package's keys) and return its path."""
    fitness = _numpy(pop["fitness"])
    summary = {
        "policy_step": int(policy_step),
        "fitness": [float(x) for x in fitness],
        "best_member": int(fitness.argmax()),
        "worst_member": int(fitness.argmin()),
        "best_fitness": float(fitness.max()),
        "worst_fitness": float(fitness.min()),
        "episodes_per_member": [int(x) for x in _numpy(pop["ep_count"])],
        "exploit_events": int(_numpy(pop["exploits"])),
        "hyperparams": {k: [float(x) for x in _numpy(v)] for k, v in sorted(hp.items())},
    }
    path = os.path.join(log_dir, "population_summary.json")
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=2)
    return path
