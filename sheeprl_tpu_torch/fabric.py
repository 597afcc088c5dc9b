"""Device and precision for the port (a small counterpart of
``sheeprl_tpu/parallel/fabric.py``: one device, no mesh).

``fabric.accelerator`` ``auto`` or ``gpu``/``cuda`` means ``cuda:0`` and
raises when no GPU is present; only ``cpu`` gives the CPU.
``fabric.precision`` is the :class:`Precision` policy of the JAX fabric:
``32-true`` is full fp32 (TF32 off for matrix products and for cuDNN's
convolutions); ``bf16-mixed`` and ``bf16-true`` compute in bf16 with fp32
accumulation.  ``matmul_precision`` (:func:`apply_matmul_precision`, acted
on by ``cli.run`` as the JAX ``cli`` does) may then allow TF32 on the card.
:meth:`Fabric.compile` is the compile-once entry point
(``parallel/compile.py``: one captured CUDA graph per signature on the
card).  :class:`PlayerSync` keeps the env player's own copy of the weights
it acts with, refreshed after train windows.
"""

from __future__ import annotations

import copy
import os
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch.resilience.faults import fault_point


@dataclass(frozen=True)
class Precision:
    """The JAX fabric's table of Lightning precision names: ``param_dtype``
    (what parameters are stored in) and ``compute_dtype`` (what the modules
    cast their inputs and weights to at call time).

    The JAX package reads only ``compute_dtype``: every module declares fp32
    parameters, so under ``bf16-true`` parameters and optimizer state stay
    fp32 and a run computes as under ``bf16-mixed``.  The port does the same.
    """

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype

    @staticmethod
    def from_string(precision: str) -> "Precision":
        table = {
            "32-true": (torch.float32, torch.float32),
            "bf16-mixed": (torch.float32, torch.bfloat16),
            "bf16-true": (torch.bfloat16, torch.bfloat16),
        }
        if precision not in table:
            raise ValueError(f"Unknown precision '{precision}'; choose from {list(table)}")
        param, compute = table[precision]
        return Precision(precision, param, compute)


@dataclass(frozen=True)
class Fabric:
    device: torch.device
    precision: Precision = field(default_factory=lambda: Precision.from_string("32-true"))

    def load(self, path: Union[str, os.PathLike]) -> Dict[str, Any]:
        """State of a committed snapshot directory, tensors on this device."""
        from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir

        return load_step_dir(path, rank=0, map_location=self.device)

    def seed_everything(self, seed: int, player_device: torch.device) -> Tuple[torch.Generator, torch.Generator]:
        """Seed Python's, numpy's and torch's global generators (the env
        action sampling and the replay sampling draw from numpy's) and
        return the two explicit generators of a run: the train draws on
        this device and the player's draws on ``player_device``."""
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
        train = torch.Generator(self.device).manual_seed(int(seed))
        player = torch.Generator(player_device).manual_seed(int(seed) + 1)
        return train, player

    def player_device(self, cfg: Any) -> torch.device:
        """``algo.player.device``: ``accelerator`` is this fabric's device,
        ``host`` the CPU."""
        where = str((cfg.algo.get("player") or {}).get("device", "accelerator"))
        if where == "accelerator":
            return self.device
        if where == "host":
            return torch.device("cpu")
        raise ValueError(f"algo.player.device={where}: choose accelerator or host")

    def compile(
        self,
        fn: Callable,
        *,
        name: Optional[str] = None,
        max_recompiles: Optional[int] = None,
        static_argnums: Tuple[int, ...] = (),
        static_argnames: Tuple[str, ...] = (),
        device: Any = None,
        generators: Sequence[torch.Generator] = (),
        eager_reason: Optional[str] = None,
    ) -> Any:
        """The compile-once entry point (``sheeprl_tpu/parallel/fabric.py``'s
        ``compile``): a :class:`~sheeprl_tpu_torch.parallel.compile.GraphFunction`
        that captures one CUDA graph per signature when ``device`` (this
        fabric's by default) is the card, and runs eagerly on the CPU or for
        a route marked ``eager_reason``, counted in the recompile audit either
        way.  ``generators`` are the generators ``fn`` draws from."""
        from sheeprl_tpu_torch.parallel.compile import compile_once

        return compile_once(fn, name=name, static_argnums=static_argnums, static_argnames=static_argnames,
                            max_recompiles=max_recompiles, device=self.device if device is None else device,
                            generators=generators, eager_reason=eager_reason)

    @property
    def compile_pool(self) -> Any:
        """The process-wide warm-up pool (created at first use)."""
        from sheeprl_tpu_torch.parallel.compile import get_compile_pool

        return get_compile_pool()

    def warm_kernels(self, cfg: Any) -> None:
        """With ``algo.compile_warmup`` on a CUDA run, submit the ``nvcc``
        builds of the kernels the model's config asks for to
        :attr:`compile_pool`, so they overlap the env and ring set-up (the
        JAX loops submit their player compile there)."""
        if self.device.type != "cuda" or not bool(cfg.algo.get("compile_warmup", True)):
            return
        from sheeprl_tpu_torch.ops import _build

        rec = ((cfg.algo.get("world_model") or {}).get("recurrent_model") or {})
        names = [n for n, flag in (("rssm", "fused_pallas"), ("gru", "use_pallas")) if rec.get(flag)]
        if names:
            self.compile_pool.submit_fn(_build.build, names)

    def get_checkpoint_manager(self, cfg: Any, log_dir: Union[str, os.PathLike]):
        from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager

        return CheckpointManager(cfg, log_dir)


def _device(accelerator: str) -> torch.device:
    accelerator = str(accelerator or "auto").lower()
    if accelerator == "cpu":
        return torch.device("cpu")
    if accelerator in ("auto", "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"fabric.accelerator={accelerator} needs a CUDA GPU and none is available; "
                "pass fabric.accelerator=cpu to run on the CPU"
            )
        return torch.device("cuda", 0)
    raise ValueError(f"fabric.accelerator={accelerator}: choose auto, gpu or cpu")


def run_device(cfg: Any) -> torch.device:
    """The device of a run with this config (``fabric.accelerator``)."""
    return _device((cfg.get("fabric") or {}).get("accelerator", "auto"))


def build_fabric(cfg: Any) -> Fabric:
    fabric_cfg = cfg.get("fabric") or {}
    if int(fabric_cfg.get("devices", 1) or 1) != 1 or int(fabric_cfg.get("num_nodes", 1) or 1) != 1:
        raise NotImplementedError("sheeprl_tpu_torch runs on one device (fabric.devices=1, num_nodes=1): the scale "
                                  "layer above one device comes later (ROADMAP.md, queue A item 5(b))")
    precision = Precision.from_string(str(fabric_cfg.get("precision", "32-true")))
    device = run_device(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if precision.compute_dtype == torch.bfloat16:
        # cuBLAS may otherwise reduce split-K bf16 products in bf16; XLA
        # accumulates bf16 dots in fp32
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return Fabric(device=device, precision=precision)


#: ``matmul_precision`` values (the names JAX's ``jax_default_matmul_precision``
#: takes) → whether products and convolutions on the card may use TF32.  On a
#: TPU ``default`` means bf16 passes; the port keeps fp32 for it, because every
#: card-vs-CPU check and parity test is built on fp32 products.
MATMUL_PRECISIONS = {"default": False, "highest": False, "float32": False, "high": True, "tensorfloat32": True}


def apply_matmul_precision(value: Any, device: torch.device) -> None:
    """Act on ``matmul_precision`` for a run on ``device``: ``high`` /
    ``tensorfloat32`` let cuBLAS and cuDNN use TF32 (and set PyTorch's
    float32 matmul precision to ``high``), the others keep fp32 products.
    Only the CUDA backends change: on the CPU the value is checked and the
    CPU's math is left alone.  The hand-written kernels ignore these flags
    (their 3xTF32 products are their own)."""
    name = str(value or "default")
    if name not in MATMUL_PRECISIONS:
        from sheeprl_tpu_torch.config.compose import ConfigError

        raise ConfigError(
            f"matmul_precision {value!r} is not one the port takes ({', '.join(MATMUL_PRECISIONS)}); for bf16 "
            "products (the JAX package's 'bfloat16') set fabric.precision=bf16-mixed"
        )
    if device.type != "cuda":
        return
    tf32 = MATMUL_PRECISIONS[name]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


class PlayerSync:
    """The env player's own copy of the modules it acts with, and when it is
    refreshed from the trained ones (the staleness semantics of the JAX
    package's ``PlayerSync``).

    After every ``algo.player.sync_every``-th train window the trained
    weights are taken; with ``algo.player.deferred_sync`` (the default) they
    reach the player only at the start of the next window, so the player
    acts on weights one window old, as the JAX player does while the device
    trains the next window.  ``Player/*`` metrics report the staleness in
    windows."""

    def __init__(self, cfg: Any, device: torch.device, extract: Callable[[], Dict[str, torch.nn.Module]]):
        player_cfg = cfg.algo.get("player", {}) or {}
        self.device = device
        self.extract = extract
        self.deferred = bool(player_cfg.get("deferred_sync", True))
        self.sync_every = max(1, int(player_cfg.get("sync_every", 1)))
        self.modules: Dict[str, torch.nn.Module] = {}
        self._pending: Union[Dict[str, Dict[str, torch.Tensor]], None] = None
        self._windows = 0
        self._player_version = 0
        self._pending_version = 0
        self.staleness_max = 0

    def init(self) -> Dict[str, torch.nn.Module]:
        """The player's modules, copies of the current trained ones.  Called
        again, it loads the trained weights into the same modules, so a
        graph captured on them stays valid."""
        self._player_version = self._windows
        self._pending = None
        if self.modules:
            self._load({name: m.state_dict() for name, m in self.extract().items()})
            return self.modules
        fault_point("fabric.copy_to")
        for name, module in self.extract().items():
            player = copy.deepcopy(module).to(self.device)
            player.requires_grad_(False)
            self.modules[name] = player.eval()
        return self.modules

    def _load(self, states: Dict[str, Dict[str, torch.Tensor]]) -> None:
        # fault site (JAX's Fabric.copy_to, which moves the player's weights):
        # raise is a link dropped mid-copy, latency a congested one
        fault_point("fabric.copy_to")
        with torch.no_grad():
            for name, state in states.items():
                self.modules[name].load_state_dict(state)

    @property
    def staleness(self) -> int:
        return self._windows - self._player_version

    def _observe(self) -> None:
        self.staleness_max = max(self.staleness_max, self.staleness)

    def metrics(self) -> Dict[str, float]:
        return {
            "Player/param_staleness_windows": float(self.staleness),
            "Player/param_staleness_max": float(self.staleness_max),
        }

    def before_dispatch(self) -> None:
        """Hand the player the weights taken after the previous window."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._player_version = self._pending_version
            self._load(pending)
        self._observe()

    def after_dispatch(self) -> None:
        self._windows += 1
        if self._windows % self.sync_every != 0:
            self._observe()
            return
        current = {name: m.state_dict() for name, m in self.extract().items()}
        if self.deferred:
            # the trained tensors change in place in the next window
            self._pending = {name: {k: v.detach().clone() for k, v in sd.items()} for name, sd in current.items()}
            self._pending_version = self._windows
        else:
            self._player_version = self._windows
            self._load(current)
        self._observe()

    def state_dict(self) -> Dict[str, int]:
        """The refresh cadence; a resumed player starts from the saved weights."""
        return {"windows": self._windows}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._windows = int(state.get("windows", 0))
        self._player_version = self._windows
        self._pending = None
