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
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

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
