"""Carry weights from the JAX package's parameter trees to the port.

:func:`policy_state_from_jax` takes the flax variables of a PPO, A2C or
recurrent PPO agent and gives the agent's ``state_dict``; flax's
``OptimizedLSTMCell`` (``lstm``: input kernels ``ii/if/ig/io`` without bias,
recurrent kernels ``hi/hf/hg/ho`` with bias) becomes ``torch.nn.LSTMCell``'s
``weight_ih`` / ``weight_hh`` (the four kernels transposed and stacked in
``i, f, g, o`` order), ``bias_hh`` (the recurrent biases) and a zero
``bias_ih``.

:func:`agent_state_from_jax` takes the tree a ``sheeprl_tpu`` ``build_agent``
returns (as numpy arrays) — DreamerV3, V2 or V1, or a Plan2Explore
exploration agent of any of them — and gives the port's ``state_dict``s
under the same names.  The port's modules carry the flax names, so each flax
path maps to a key by rule:

* ``.../LayerNorm_0/{scale,bias}`` (the fp32 LayerNorm wrapper) → ``.../{weight,bias}``;
* a Dense ``kernel`` (in, out) → ``Linear.weight`` (out, in);
* a Conv ``kernel`` HWIO → ``Conv2d.weight`` OIHW;
* a ConvTranspose ``kernel`` (the decoder's ``deconv_*``, flax's
  ``transpose_kernel=False``) → ``ConvTranspose2d.weight`` (in, out, kH, kW),
  flipped spatially, because torch's transposed convolution flips its kernel
  and flax's does not;
* the kernel-flag parameters (``fused_kernel``, ``in_kernel``,
  ``gru_kernel``, ``ln_scale``, ...) and ``initial_recurrent`` keep their
  name and their (in, out) layout;
* the Plan2Explore ensembles' params-vmapped tree keeps its member axis
  first: ``kernel`` (n, in, out) and ``bias`` (n, out) as they are;
* a Moments state ``moments/{low,high}`` becomes two 0-d tensors, also
  under each ``critics_exploration/<name>`` with that critic's
  ``critic`` and ``target`` networks.

:func:`sac_state_from_jax` takes the tree of a SAC, DroQ or SAC-AE
``build_agent`` and gives the port agent's flat ``state_dict`` by the same
rules.

:func:`env_state_from_jax` takes a batched state of a JAX env and gives the
state of the port's device env of the same name.

:func:`resume_state_from_jax` gives what a loop resumes from, the optax
states among it; a PPO or A2C population snapshot (its agent and vmapped
optax state stacked on a leading member axis) is converted member by member
by :func:`population_state_from_jax`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert_leaf(path: Tuple[str, ...], value: Any, stacked: bool = False) -> Tuple[str, torch.Tensor]:
    path = tuple(p for p in path if p != "LayerNorm_0")
    *parents, leaf = path
    arr = np.asarray(value, dtype=np.float32)
    if leaf == "kernel" and stacked:
        pass  # (n, in, out), the port's stacked layout
    elif leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4 and parents and parents[-1].startswith("deconv"):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected {arr.ndim}-d kernel at {'/'.join(path)}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*parents, leaf]), torch.from_numpy(np.array(arr, order="C"))


def module_state_from_flax(variables: Mapping[str, Any], stacked: bool = False) -> Dict[str, torch.Tensor]:
    """One flax module's ``{"params": ...}`` variables → a torch ``state_dict``
    (``stacked``: a params-vmapped module, member axis first)."""
    params = variables.get("params", variables)
    return dict(_convert_leaf(path, value, stacked) for path, value in _leaves(params))


def _moments(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(tree[k], np.float32)) for k in ("low", "high")}


#: the agent's modules, as the JAX trees name them (those present are carried)
MODULES = ("world_model", "actor", "critic", "target_critic", "actor_task", "critic_exploration",
           "target_critic_exploration")


def _check_mirror(out: Dict[str, Any], online: str, target: str) -> None:
    online_shapes = {k: tuple(v.shape) for k, v in out[online].items()}
    target_shapes = {k: tuple(v.shape) for k, v in out[target].items()}
    if online_shapes != target_shapes:
        raise ValueError(f"{target} {target_shapes} does not mirror {online} {online_shapes}")


def agent_state_from_jax(params: Mapping[str, Any], cfg: Any) -> Dict[str, Any]:
    """The port's agent state (module ``state_dict``s, ``moments``, the
    ensembles and ``critics_exploration`` when the tree has them) from a JAX
    ``build_agent`` tree of any Dreamer.

    ``cfg`` must select the same recurrent layout the tree was built with:
    the kernel flags change the parameter names, and loading the result into
    a port agent built from ``cfg`` checks every name and shape.  A target
    network must have its online network's parameters, name for name and
    shape for shape."""
    missing = [name for name in ("world_model", "actor", "critic") if name not in params]
    if missing:
        raise ValueError(f"the parameter tree has no {missing}")
    out: Dict[str, Any] = {name: module_state_from_flax(params[name]) for name in MODULES if name in params}
    for online, target in (("critic", "target_critic"), ("critic_exploration", "target_critic_exploration")):
        if target in out:
            _check_mirror(out, online, target)
    if "moments" in params:
        out["moments"] = _moments(params["moments"])
    if "ensembles" in params:
        out["ensembles"] = module_state_from_flax(params["ensembles"], stacked=True)
    if "critics_exploration" in params:
        out["critics_exploration"] = {}
        for name, c in params["critics_exploration"].items():
            entry = {"critic": module_state_from_flax(c["critic"]), "target": module_state_from_flax(c["target"])}
            _check_mirror(entry, "critic", "target")
            out["critics_exploration"][name] = {**entry, "moments": _moments(c["moments"])}
    rm = cfg.algo.world_model.recurrent_model
    fused = bool(rm.get("fused_pallas", False))
    if fused != ("recurrent_model.in_kernel" in out["world_model"]):
        raise ValueError(
            f"cfg has fused_pallas={fused} but the parameter tree was built with the other layout"
        )
    return out


LSTM_GATES = ("i", "f", "g", "o")


def lstm_state_from_flax(lstm: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``OptimizedLSTMCell`` params → ``torch.nn.LSTMCell`` ``state_dict``."""
    def stacked(prefix: str) -> torch.Tensor:
        return torch.from_numpy(np.concatenate(
            [np.asarray(lstm[prefix + g]["kernel"], np.float32).T for g in LSTM_GATES], axis=0))

    bias_hh = torch.from_numpy(np.concatenate([np.asarray(lstm["h" + g]["bias"], np.float32) for g in LSTM_GATES]))
    return {"weight_ih": stacked("i"), "weight_hh": stacked("h"), "bias_ih": torch.zeros_like(bias_hh),
            "bias_hh": bias_hh}


def policy_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A PPO / A2C / recurrent PPO agent's flax variables → the port agent's
    ``state_dict`` (the module names are flax's, so every other path maps by
    rule; an ``lstm`` subtree is restacked by :func:`lstm_state_from_flax`)."""
    params = dict(variables.get("params", variables))
    lstm = params.pop("lstm", None)
    out = module_state_from_flax(params)
    if lstm is not None:
        out.update({f"lstm.{k}": v for k, v in lstm_state_from_flax(lstm).items()})
    return out


#: the off-policy agents' trees: module → whether it is a params-vmapped ensemble
OFF_POLICY_MODULES = {"actor": False, "critic": True, "target_critic": True, "encoder": False, "decoder": False,
                      "target_encoder": False}


def sac_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's SAC, DroQ or SAC-AE agent from the
    tree the JAX ``build_agent`` returns (``actor``, ``critic``,
    ``target_critic``, ``log_alpha``, and for SAC-AE ``encoder``,
    ``decoder`` and ``target_encoder``).  The vmapped ``q_ensemble`` keeps
    its member axis first (``kernel`` (n, in, out)); DroQ's ``ln_i`` and
    SAC-AE's flax ``LayerNorm`` map by rule, the decoder's ``deconv_*``
    kernels are flipped; ``log_alpha`` becomes a 0-d tensor."""
    out: Dict[str, torch.Tensor] = {}
    for name, stacked in OFF_POLICY_MODULES.items():
        if name in params:
            out.update({f"{name}.{k}": v for k, v in module_state_from_flax(params[name], stacked).items()})
    for online, target in (("critic", "target_critic"), ("encoder", "target_encoder")):
        if online in params and target in params:
            _check_mirror({m: {k.split(".", 1)[1]: v for k, v in out.items() if k.startswith(m + ".")}
                           for m in (online, target)}, online, target)
    out["log_alpha"] = torch.tensor(np.asarray(params["log_alpha"], np.float32))
    return out


def env_state_from_jax(state: Any, state_cls: type, device: Any = "cpu") -> Any:
    """A batched JAX env state (a ``NamedTuple`` of arrays with a leading
    ``num_envs`` axis, from ``sheeprl_tpu/envs/jax/``) as the port's
    ``state_cls``: the fields of the same names, dtypes kept; the JAX
    per-instance ``key`` has no counterpart (the port's vector env holds one
    generator)."""
    return state_cls(**{f: torch.as_tensor(np.array(getattr(state, f)), device=device) for f in state_cls._fields})


#: algorithm families → the converter of their agent trees
POLICY_ALGOS = ("ppo", "ppo_decoupled", "a2c", "ppo_recurrent")
OFF_POLICY_ALGOS = ("sac", "sac_decoupled", "droq", "sac_ae")


def agent_from_jax(agent: Mapping[str, Any], cfg: Any) -> Dict[str, Any]:
    """The port's ``agent`` state from the ``agent`` tree of a snapshot the
    JAX package wrote, by ``cfg.algo.name``: :func:`agent_state_from_jax`
    for the Dreamer family, :func:`policy_state_from_jax` for PPO, A2C and
    recurrent PPO, :func:`sac_state_from_jax` for SAC, DroQ and SAC-AE."""
    name = str(cfg.algo.name)
    if name.startswith(("dreamer_", "p2e_")):
        return agent_state_from_jax(agent, cfg)
    if name in POLICY_ALGOS:
        return policy_state_from_jax(agent)
    if name in OFF_POLICY_ALGOS:
        return sac_state_from_jax(agent)
    raise ValueError(f"no converter from a JAX snapshot of algorithm '{name}'")


def state_from_jax(state: Mapping[str, Any], cfg: Any) -> Dict[str, Any]:
    """A JAX-written snapshot's state as the port reads it to serve,
    evaluate or register: the converted ``agent`` and the plain counters
    (``policy_step``, ``update``, ...).  A training run resumes through
    :func:`resume_state_from_jax`, which adds the optimizer states, the
    generators and the replay buffer."""
    out: Dict[str, Any] = {k: v for k, v in state.items() if isinstance(v, (int, float)) and not isinstance(v, bool)}
    out["agent"] = agent_from_jax(state["agent"], cfg)
    return out


# -- resuming training ------------------------------------------------------------

def _named(tree: Any) -> Dict[str, Any]:
    """An optax state's fields (a namedtuple stand-in of
    ``checkpoint/serialize.py``) by name; a plain dict as it is."""
    return dict(tree._asdict()) if hasattr(tree, "_asdict") else dict(tree)


def _optax_parts(opt_state: Any) -> Tuple[Any, list]:
    """The injected learning rate and the states of the transforms under it,
    in chain order, from the chain the JAX package builds
    (``sheeprl_tpu/utils/optim.py``): an optional ``clip_by_global_norm``
    (an ``EmptyState``), then ``inject_hyperparams`` of the base optimizer
    over its own chain."""
    lr, parts = None, []

    def walk(node: Any) -> None:
        nonlocal lr
        name = type(node).__name__
        if name in ("InjectStatefulHyperparamsState", "InjectHyperparamsState"):
            lr = _named(node)["hyperparams"].get("learning_rate")
            walk(node.inner_state)
        elif name == "EmptyState" or node is None:
            return
        elif hasattr(node, "_asdict") or (isinstance(node, Mapping) and {"nu", "mom", "mg"} >= set(node)):
            parts.append(node)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        else:
            raise ValueError(f"unexpected optax state {name}")

    walk(opt_state)
    return lr, parts


def _moments_by_name(opt_state: Any, names: Sequence[str], convert: Callable[[Any], Dict[Any, torch.Tensor]],
                     rmsprop: bool, tf_style: bool) -> Tuple[Any, Dict[str, Dict[str, torch.Tensor]]]:
    """The injected learning rate and, per parameter name, the port's state
    tensors (``step``, ``exp_avg``, ``square_avg``, ...) of one optax state
    (see :func:`optimizer_state_from_optax`).  ``rmsprop``: the port's
    optimizer is an RMSprop (optax's ``rmsprop`` traces signed steps);
    ``tf_style``: its ``rmsprop_tf`` flavour (momentum of unscaled steps)."""
    lr, parts = _optax_parts(opt_state)
    per_param: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in names}

    def put(key: str, tree: Any, scale: float = 1.0) -> None:
        converted = convert(tree)
        if set(converted) == {None}:
            if len(names) != 1:
                raise ValueError(f"a bare optax leaf for {len(names)} parameters")
            converted = {names[0]: converted[None]}
        if set(converted) != set(names):
            raise ValueError(f"the optax state's {key} covers {sorted(set(converted) ^ set(names))} "
                             "where the port optimizer's parameters differ")
        for n, t in converted.items():
            per_param[n][key] = t * scale if scale != 1.0 else t

    for part in parts:
        kind = type(part).__name__
        fields = _named(part)
        if kind == "ScaleByAdamState":
            for n in names:
                per_param[n]["step"] = torch.tensor(float(np.asarray(fields["count"])), dtype=torch.float32)
            put("exp_avg", fields["mu"])
            put("exp_avg_sq", fields["nu"])
        elif kind in ("ScaleByRmsState", "ScaleByRStdDevState"):
            put("square_avg", fields["nu"])
            if "mu" in fields:
                put("grad_avg", fields["mu"])
        elif kind == "TraceState":
            # SGD traces the raw gradients; optax's rmsprop the signed steps
            put("momentum_buffer", fields["trace"], -1.0 if rmsprop else 1.0)
        elif isinstance(part, Mapping):
            # the JAX package's own RMSprops: {"nu", "mom", "mg"}
            put("square_avg", fields["nu"])
            if fields.get("mg") is not None:
                put("grad_avg", fields["mg"])
            if fields.get("mom") is not None:
                put("momentum_buffer", fields["mom"], 1.0 if tf_style else float(np.asarray(lr)))
        else:
            raise ValueError(f"no port counterpart for the optax state {kind}")
    return lr, per_param


def optimizer_state_from_optax(opt_state: Any, optimizer: torch.optim.Optimizer, names: Sequence[str],
                               convert: Callable[[Any], Dict[Any, torch.Tensor]]) -> Dict[str, Any]:
    """``optimizer.state_dict()`` of the port optimizer over the parameters
    ``names`` (in its order) from the optax state the JAX package saved for
    the same parameters.

    ``convert`` maps one moment tree (a tree shaped as the parameters) to
    tensors by port name — the converter of the parameters themselves, so a
    flax kernel's transpose applies to its ``mu`` and ``nu`` too; a bare
    array (SAC's ``log_alpha``) comes back under the key None.  Adam's and
    AdamW's ``count`` becomes torch's ``step`` (placed on the card by torch
    when the optimizer is ``capturable``), ``mu`` / ``nu`` its ``exp_avg`` /
    ``exp_avg_sq``; the RMSprops' ``nu`` its ``square_avg``, the centred
    mean its ``grad_avg``, the momentum its ``momentum_buffer`` (optax's
    ``rmsprop`` traces the steps after the learning rate's sign flip, the
    port the positive steps; ``rmsprop_tf`` traces unscaled steps in both);
    SGD's momentum trace its ``momentum_buffer``.  The learning rate is the
    injected hyperparameter, not the config's."""
    from sheeprl_tpu_torch.utils.optim import RMSprop

    group = optimizer.param_groups[0]
    lr, per_param = _moments_by_name(opt_state, names, convert, isinstance(optimizer, RMSprop),
                                     bool(group.get("tf_style", False)))
    template = optimizer.state_dict()
    groups = [dict(g) for g in template["param_groups"]]
    if lr is not None:
        for g in groups:
            g["lr"] = float(np.asarray(lr))
    return {"state": {i: per_param[n] for i, n in enumerate(names) if per_param[n]}, "param_groups": groups}


def _member(tree: Any, m: int) -> Any:
    """Member ``m`` of a tree whose array leaves are stacked on a leading
    population axis (a vmapped optax state, a stacked parameter tree)."""
    if isinstance(tree, Mapping):
        return {k: _member(v, m) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_member(v, m) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_member(v, m) for v in tree)
    if tree is None or np.ndim(tree) == 0:
        return tree
    return np.asarray(tree)[m]


def population_state_from_jax(state: Mapping[str, Any], cfg: Any) -> Dict[str, Any]:
    """A PPO or A2C population snapshot of the JAX package
    (``population.size`` = P) in the layout of the port's
    :class:`~sheeprl_tpu_torch.algos.ppo.population.PopulationRoute`:

    * ``agent``: each member's parameters converted as one agent's
      (:func:`policy_state_from_jax`), stacked ``(P, ...)``;
    * ``opt_state``: the vmapped optax state as a
      :class:`~sheeprl_tpu_torch.population.members.StackedOptimizer`
      state: each member's moments mapped as :func:`optimizer_state_from_optax`
      maps one agent's, stacked, and the ``(P,)`` Adam ``count`` (the
      RMSprops and SGD keep no count: their steps do not read it);
    * ``population``: ``fitness``, ``ep_count``, ``exploits`` and the
      per-member hyperparameters ``hp``, as tensors."""
    name = str(cfg.algo.optimizer.get("name", "adam"))
    pop = state["population"]
    size = int(np.shape(pop["fitness"])[0])
    members = [policy_state_from_jax(_member(state["agent"], m)) for m in range(size)]
    out: Dict[str, Any] = {"agent": {k: torch.stack([mm[k] for mm in members]) for k in members[0]}}
    names = list(members[0])
    if state.get("opt_state") is not None:
        convert = _moments_converter(policy=True)
        moments = [_moments_by_name(_member(state["opt_state"], m), names, convert, name.startswith("rmsprop"),
                                    name == "rmsprop_tf")[1] for m in range(size)]
        first = moments[0][names[0]]
        count = (torch.stack([mm[names[0]]["step"] for mm in moments]) if "step" in first
                 else torch.zeros(size, dtype=torch.float32))
        out["opt_state"] = {"name": name, "count": count,
                            "state": {n: {k: torch.stack([mm[n][k] for mm in moments]) for k in moments[0][n]
                                          if k != "step"} for n in names}}
    out["population"] = {k: torch.as_tensor(np.asarray(pop[k])) for k in ("fitness", "ep_count", "exploits")}
    out["population"]["hp"] = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in dict(pop["hp"]).items()}
    return out


class OptaxState:
    """An optimizer state of a JAX-written snapshot, waiting for the port
    optimizer it loads into: :meth:`ClippedOptimizer.load_state_dict
    <sheeprl_tpu_torch.utils.optim.ClippedOptimizer.load_state_dict>` calls
    :meth:`state_dict_for` with the optimizer and its parameters' names."""

    def __init__(self, opt_state: Any, convert: Callable[[Any], Dict[Any, torch.Tensor]]):
        self.opt_state, self.convert = opt_state, convert

    def state_dict_for(self, optimizer: torch.optim.Optimizer, names: Optional[Sequence[str]]) -> Dict[str, Any]:
        if names is None:
            raise ValueError("a JAX optimizer state loads only into an optimizer built over named parameters")
        return optimizer_state_from_optax(self.opt_state, optimizer, names, self.convert)


def _moments_converter(stacked: bool = False, policy: bool = False) -> Callable[[Any], Dict[Any, torch.Tensor]]:
    def convert(tree: Any) -> Dict[Any, torch.Tensor]:
        if not isinstance(tree, Mapping):
            return {None: torch.tensor(np.asarray(tree, np.float32))}
        return policy_state_from_jax(tree) if policy else module_state_from_flax(tree, stacked)

    return convert


def _seed_from_key(key: Any) -> int:
    """A 64-bit seed from the words of a JAX PRNG key (raw ``uint32[2]`` or
    a typed key's data)."""
    data = np.asarray(getattr(key, "data", key), np.uint32).reshape(-1)
    seed = 0
    for w in data[-2:]:
        seed = (seed << 32) | int(w)
    return seed


#: the counters a loop's resume reads, carried as they are
COUNTERS = ("policy_step", "update", "last_log", "last_checkpoint", "grad_steps", "pending_gradient_steps")


def resume_state_from_jax(state: Mapping[str, Any], cfg: Any) -> Dict[str, Any]:
    """What a port loop loads to continue training from a snapshot the JAX
    package wrote, in the layout of the port's own snapshots:

    * ``agent``: :func:`agent_from_jax` — with the Moments, the target
      networks and SAC's ``log_alpha``;
    * ``opt_state``: each optimizer's optax state as an :class:`OptaxState`,
      under the port's optimizer names (P2E-DV3's
      ``critics_exploration.<name>``; one state for PPO, A2C and recurrent
      PPO); it becomes that optimizer's ``state_dict`` when the loop builds
      the optimizer over its named parameters;
    * the counters of :data:`COUNTERS`, ``ratio`` and ``psync``;
    * ``rb``, where the JAX run saved its replay buffer
      (``buffer.checkpoint=True``);
    * ``generator_seeds``: no ``torch.Generator`` reproduces threefry, so
      the train and player generators are seeded from the words of ``key``
      and ``player_key``.  These are new draws: the resumed run does not
      draw what the JAX run would have drawn, but two resumes of one
      snapshot draw alike.

    A population snapshot (``population``) gives the stacked agent, the
    stacked optimizer state and the PBT carry of
    :func:`population_state_from_jax`."""
    name = str(cfg.algo.name)
    out: Dict[str, Any] = {k: int(state[k]) for k in COUNTERS if state.get(k) is not None}
    for k in ("ratio", "psync"):
        if state.get(k) is not None:
            out[k] = {kk: (v.item() if isinstance(v, np.ndarray) else v) for kk, v in dict(state[k]).items()}
    opt = state.get("opt_state")
    if "population" in state:
        out.update(population_state_from_jax(state, cfg))
    else:
        out["agent"] = agent_from_jax(state["agent"], cfg)
        if opt is not None and name in POLICY_ALGOS:
            out["opt_state"] = OptaxState(opt, _moments_converter(policy=True))
        elif opt is not None:
            stacked = {"ensembles"} | ({"critic"} if name in OFF_POLICY_ALGOS else set())
            flat: Dict[str, Any] = {}
            for k, v in dict(opt).items():
                if isinstance(v, Mapping):  # P2E-DV3's critics_exploration: {name: state}
                    flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
                else:
                    flat[k] = v
            out["opt_state"] = {k: OptaxState(v, _moments_converter(stacked=k in stacked)) for k, v in flat.items()}
    seeds = {gen: _seed_from_key(state[key]) for gen, key in (("train", "key"), ("player", "player_key"))
             if state.get(key) is not None}
    if seeds:
        out["generator_seeds"] = seeds
    if state.get("rb") is not None:
        out["rb"] = state["rb"]
    return out


def load_resume_state(path: Any, cfg: Any) -> Dict[str, Any]:
    """The state a loop resumes from at ``path`` (a committed step
    directory): the port's own as it was saved, on the host; a JAX-written
    one through :func:`resume_state_from_jax`."""
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.checkpoint.serialize import is_jax_checkpoint

    state = load_step_dir(path, map_location="cpu")
    return resume_state_from_jax(state, cfg) if is_jax_checkpoint(path) else state


def restore_generators(state: Mapping[str, Any], generators: Mapping[str, torch.Generator]) -> None:
    """Set the loop's named generators from a resumed state: the states a
    port snapshot saved, or the seeds :func:`resume_state_from_jax` took
    from a JAX key."""
    for name, gen in generators.items():
        if name in state.get("generators", {}):
            gen.set_state(state["generators"][name].cpu())
        elif name in state.get("generator_seeds", {}):
            gen.manual_seed(int(state["generator_seeds"][name]))
