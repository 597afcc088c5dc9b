"""Snapshots outside the port's own protocol: the legacy single file, and
what the JAX package wrote (counterpart of
``sheeprl_tpu/checkpoint/serialize.py``).

* :func:`durable_write` is the only way checkpoint bytes reach disk (tmp
  file, fsync, rename, fsync of the directory; ``protocol.py``).
* :func:`save_checkpoint` writes one state as a single durable file with
  ``torch.save``; :func:`load_checkpoint` reads a committed step directory
  (the port's ``shard_r*.pt`` or the JAX package's ``shard_r*.pkl``) or a
  single file (the port's, or a legacy JAX ``.ckpt`` pickle).

**Reading what the JAX package wrote, with no JAX.**  The JAX package
pickles host trees of numpy arrays, and its pickles name classes of the
JAX package and of its libraries: optax's optimizer-state namedtuples, and
``sheeprl_tpu.checkpoint.serialize.KeyArrayRef`` for a typed PRNG key.
:class:`JaxUnpickler` maps each such global to a stand-in of the port's own
(:data:`JAX_GLOBALS`) and never imports the module it names; a global that
is not on the list is refused, so a snapshot cannot run code.  The list is
what real JAX snapshots of every family hold (``tools/write_jax_fixture.py
--scan`` prints them; ``tests/test_torch_jax_snapshots.py`` fails when the
JAX package writes one that is missing).
"""

from __future__ import annotations

import collections
import io
import os
import pickle
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from sheeprl_tpu_torch.checkpoint.protocol import durable_write, load_step_dir

PathLike = Union[str, os.PathLike]

__all__ = ["JAX_GLOBALS", "JaxUnpickler", "KeyArrayRef", "durable_write", "is_jax_checkpoint", "load_checkpoint",
           "load_jax_pickle", "save_checkpoint"]


@dataclass
class KeyArrayRef:
    """Stand-in for the JAX package's typed PRNG key: its ``impl`` name
    (``threefry2x32``, ...) and the uint32 key data."""

    impl: str
    data: np.ndarray


def _record(name: str, fields: str) -> type:
    """A namedtuple stand-in for one optax state (pickled as its class and
    its fields in order)."""
    return collections.namedtuple(name, fields)


EmptyState = _record("EmptyState", "")
ScaleByAdamState = _record("ScaleByAdamState", "count mu nu")
ScaleByRmsState = _record("ScaleByRmsState", "nu")
ScaleByRStdDevState = _record("ScaleByRStdDevState", "mu nu")
TraceState = _record("TraceState", "trace")
InjectHyperparamsState = _record("InjectHyperparamsState", "count hyperparams inner_state")
InjectStatefulHyperparamsState = _record("InjectStatefulHyperparamsState",
                                         "count hyperparams hyperparams_states inner_state")


def _frombuffer(buf: Any, dtype: Any, shape: Any, order: str) -> np.ndarray:
    """numpy's own ``_frombuffer`` (an array pickled with protocol 5)."""
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order=order)


# numpy's array and scalar reconstructors, taken from the installed numpy
# (their module is ``numpy.core`` before numpy 2, ``numpy._core`` after)
_RECONSTRUCT = np.ndarray((0,)).__reduce__()[0]
_SCALAR = np.float32(0).__reduce__()[0]

#: every global a JAX snapshot may name → the port's stand-in: numpy's array
#: reconstructors (under numpy 1's and 2's module names), the typed-key
#: reference, and the optax states of the JAX package's optimizers (adam,
#: adamw, sgd, rmsprop and the TF RMSprop, under ``inject_hyperparams`` and
#: ``clip_by_global_norm``), under this optax's module names and the older
#: ones
JAX_GLOBALS: Dict[tuple, Any] = {
    ("numpy", "dtype"): np.dtype,
    ("numpy", "ndarray"): np.ndarray,
    **{(f"numpy.{core}.numeric", "_frombuffer"): _frombuffer for core in ("core", "_core")},
    **{(f"numpy.{core}.multiarray", "_reconstruct"): _RECONSTRUCT for core in ("core", "_core")},
    **{(f"numpy.{core}.multiarray", "scalar"): _SCALAR for core in ("core", "_core")},
    ("sheeprl_tpu.checkpoint.serialize", "KeyArrayRef"): KeyArrayRef,
    ("optax._src.base", "EmptyState"): EmptyState,
    ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
    ("optax._src.transform", "ScaleByRmsState"): ScaleByRmsState,
    ("optax._src.transform", "ScaleByRStdDevState"): ScaleByRStdDevState,
    ("optax._src.transform", "TraceState"): TraceState,
    ("optax.transforms._accumulation", "TraceState"): TraceState,
    ("optax._src.schedule", "InjectHyperparamsState"): InjectHyperparamsState,
    ("optax.schedules._inject", "InjectHyperparamsState"): InjectHyperparamsState,
    ("optax.schedules._inject", "InjectStatefulHyperparamsState"): InjectStatefulHyperparamsState,
}


class JaxUnpickler(pickle.Unpickler):
    """Unpickler of JAX-written snapshots: each global on
    :data:`JAX_GLOBALS` becomes its stand-in, any other is refused."""

    def find_class(self, module: str, name: str) -> Any:
        try:
            return JAX_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"refusing global {module}.{name}: a JAX snapshot holds numpy arrays, optax states and PRNG keys "
                "only (sheeprl_tpu_torch.checkpoint.serialize.JAX_GLOBALS)"
            ) from None


def load_jax_pickle(data: Union[bytes, PathLike]) -> Any:
    """A JAX-written pickle (bytes or a file) as a host tree of numpy arrays,
    with the stand-ins of :data:`JAX_GLOBALS`."""
    if not isinstance(data, (bytes, bytearray)):
        data = Path(data).read_bytes()
    return JaxUnpickler(io.BytesIO(data)).load()


def is_jax_checkpoint(path: PathLike) -> bool:
    """Whether ``path`` is a snapshot the JAX package wrote: a step directory
    of ``shard_r*.pkl`` shards, or a single file that is a plain pickle (the
    port's single files are ``torch.save`` zip archives)."""
    path = Path(path)
    if path.is_dir():
        return any(path.glob("shard_r*.pkl"))
    return path.is_file() and not zipfile.is_zipfile(path)


def save_checkpoint(path: PathLike, state: Dict[str, Any]) -> int:
    """Single-file save: the state on the host, ``torch.save``d and written
    durably.  Returns the bytes written."""
    from sheeprl_tpu_torch.checkpoint.manager import to_host

    buf = io.BytesIO()
    torch.save(to_host(state), buf)
    payload = buf.getvalue()
    durable_write(path, payload)
    return len(payload)


def load_checkpoint(path: PathLike, rank: int = 0, map_location: Any = None) -> Dict[str, Any]:
    """A snapshot's state: a committed step directory (``rank``'s shard) or a
    single file.  What the port wrote comes back as tensors placed by
    ``map_location``; what the JAX package wrote as its numpy tree."""
    path = Path(path)
    if path.is_dir():
        return load_step_dir(path, rank=rank, map_location=map_location)
    if is_jax_checkpoint(path):
        return load_jax_pickle(path)
    return torch.load(path, map_location=map_location, weights_only=True)
