"""Carry DreamerV3 weights from the JAX package's parameter tree to the port.

:func:`agent_state_from_jax` takes the tree ``sheeprl_tpu``'s ``build_agent``
returns (as numpy arrays) and gives the ``state_dict``s of the port's
``world_model``, ``actor``, ``critic`` and ``target_critic``.  The port's
modules carry the flax names, so each flax path maps to a key by rule:

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
* the Moments state ``moments/{low,high}`` becomes two 0-d tensors.
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


def _convert_leaf(path: Tuple[str, ...], value: Any) -> Tuple[str, torch.Tensor]:
    path = tuple(p for p in path if p != "LayerNorm_0")
    *parents, leaf = path
    arr = np.asarray(value, dtype=np.float32)
    if leaf == "kernel":
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


def module_state_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """One flax module's ``{"params": ...}`` variables → a torch ``state_dict``."""
    params = variables.get("params", variables)
    return dict(_convert_leaf(path, value) for path, value in _leaves(params))


def agent_state_from_jax(params: Mapping[str, Any], cfg: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's DreamerV3 ``state_dict``s (and ``moments``, when the tree
    has them) from a JAX ``build_agent`` tree.

    ``cfg`` must select the same recurrent layout the tree was built with:
    the kernel flags change the parameter names, and loading the result into
    a port agent built from ``cfg`` checks every name and shape.  The target
    critic must have the critic's parameters, name for name and shape for
    shape."""
    missing = [name for name in ("world_model", "actor", "critic", "target_critic") if name not in params]
    if missing:
        raise ValueError(f"the parameter tree has no {missing}")
    out = {name: module_state_from_flax(params[name]) for name in ("world_model", "actor", "critic", "target_critic")}
    critic_shapes = {k: tuple(v.shape) for k, v in out["critic"].items()}
    target_shapes = {k: tuple(v.shape) for k, v in out["target_critic"].items()}
    if critic_shapes != target_shapes:
        raise ValueError(f"target_critic {target_shapes} does not mirror critic {critic_shapes}")
    if "moments" in params:
        out["moments"] = {k: torch.tensor(np.asarray(params["moments"][k], np.float32)) for k in ("low", "high")}
    rm = cfg.algo.world_model.recurrent_model
    fused = bool(rm.get("fused_pallas", False))
    if fused != ("recurrent_model.in_kernel" in out["world_model"]):
        raise ValueError(
            f"cfg has fused_pallas={fused} but the parameter tree was built with the other layout"
        )
    return out
