"""Optimizer factory (counterpart of ``sheeprl_tpu/utils/optim.py``).

The same config surface (``configs/optim/*``) builds a ``torch.optim``
optimizer behind optax's global-norm clip: :class:`ClippedOptimizer` scales
the group's gradients by ``max_norm / norm`` only when ``norm >= max_norm``
and adds no epsilon (``optax.clip_by_global_norm``), unlike
``torch.nn.utils.clip_grad_norm_``.  ``torch.optim.Adam`` is optax's Adam:
the same bias correction, eps outside the square root.  For an update
that is captured as a CUDA graph (``parallel/compile.py``) Adam and AdamW
are built ``capturable``: the step counter lives on the card and the bias
correction is computed there in fp32, where the eager optimizer takes
float64 host scalars; it is off on the CPU and for every update that runs
eagerly.  Both RMSprops are
:class:`RMSprop`, written out because optax's differ from
``torch.optim.RMSprop`` where a momentum buffer meets a changing learning
rate.  :func:`set_learning_rate` / :func:`get_learning_rate` are the
annealing schedules' handle on the wrapped optimizer.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Optional

import torch

__all__ = ["ClippedOptimizer", "RMSprop", "build_optimizer", "clip_by_global_norm_", "get_learning_rate",
           "optimizer_state_tensors", "set_learning_rate"]


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global L2
    norm is at least ``max_norm``; returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class RMSprop(torch.optim.Optimizer):
    """The JAX package's two RMSprops.

    ``tf_style=False`` is ``rmsprop`` (optax's ``rmsprop(eps_in_sqrt=False)``):
    the square average starts at zero, ``g / (sqrt(v) + eps)``, and a momentum
    buffer accumulates the learning-rate-scaled steps.  ``tf_style=True`` is
    ``rmsprop_tf``: the square average starts at one, ``g / sqrt(v + eps)``,
    and the momentum buffer accumulates the unscaled steps, scaled by the
    learning rate when applied.  ``centered`` subtracts the squared running
    mean of the gradients from ``v`` in both."""

    def __init__(self, params, lr: float = 1e-3, alpha: float = 0.99, eps: float = 1e-8, momentum: float = 0.0,
                 centered: bool = False, tf_style: bool = False):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum, centered=centered,
                                      tf_style=tf_style))

    def init_param_state(self, p: torch.Tensor, group: Dict[str, Any]) -> None:
        """The state ``p`` starts from (its first step makes it)."""
        state = self.state[p]
        state["square_avg"] = torch.ones_like(p) if group["tf_style"] else torch.zeros_like(p)
        if group["centered"]:
            state["grad_avg"] = torch.zeros_like(p)
        if group["momentum"] > 0:
            state["momentum_buffer"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, alpha, eps, momentum = group["lr"], group["alpha"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    self.init_param_state(p, group)
                v = state["square_avg"].mul_(alpha).addcmul_(g, g, value=1 - alpha)
                if group["centered"]:
                    m = state["grad_avg"].mul_(alpha).add_(g, alpha=1 - alpha)
                    v = v - m * m
                denom = (v + eps).sqrt() if group["tf_style"] else v.sqrt().add_(eps)
                update = g / denom
                if momentum > 0:
                    buf = state["momentum_buffer"].mul_(momentum)
                    if group["tf_style"]:
                        p.add_(buf.add_(update), alpha=-lr)
                    else:
                        p.sub_(buf.add_(update, alpha=lr))
                else:
                    p.add_(update, alpha=-lr)


class ClippedOptimizer:
    """One parameter group's optimizer: optax's global-norm clip, then the
    ``torch.optim`` step."""

    def __init__(self, params: Iterable[torch.nn.Parameter], optimizer: torch.optim.Optimizer,
                 max_grad_norm: Optional[float]):
        self.params = list(params)
        self.optimizer = optimizer
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else None

    def step(self) -> Optional[torch.Tensor]:
        """Clip the gradients held in ``.grad`` and apply them; returns the
        global norm before clipping (None without clipping)."""
        norm = None
        if self.max_grad_norm is not None:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = clip_by_global_norm_(grads, self.max_grad_norm)
        self.optimizer.step()
        return norm

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def init_state_(self) -> None:
        """Make the state of every parameter that has none yet, as its first
        step would, without stepping, so the health guard's backup covers a
        fixed set of tensors from the first window on: Adam's and AdamW's
        zero moments and zero step, the RMSprops' start, SGD's zero momentum
        buffer (where the first step's ``buf = grad`` and ``buf = 0 *
        momentum + grad`` agree: no dampening).  Idempotent."""
        opt = self.optimizer
        for group in opt.param_groups:
            for p in group["params"]:
                if opt.state.get(p):
                    continue
                if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
                    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
                    on_device = group["capturable"] or group.get("fused")
                    state = opt.state[p]
                    state["step"] = (torch.zeros((), dtype=scalar, device=p.device) if on_device
                                     else torch.tensor(0.0, dtype=scalar))
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    if group["amsgrad"]:
                        state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                elif isinstance(opt, RMSprop):
                    opt.init_param_state(p, group)
                elif isinstance(opt, torch.optim.SGD) and not group["dampening"]:
                    if group["momentum"]:
                        opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
                else:
                    raise NotImplementedError(
                        f"the health guard cannot make the first state of {type(opt).__name__} "
                        f"({ {k: v for k, v in group.items() if k != 'params'} }) before its first step")

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the optimizer's state, parameter by parameter."""
        return [t for p in self.params for t in self.optimizer.state.get(p, {}).values()
                if isinstance(t, torch.Tensor)]

    def state_dict(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)

    def copy_state_(self, state: Dict[str, Any]) -> None:
        """Load ``state`` (a ``state_dict`` of this optimizer) by copying into
        the state tensors it already has, so a graph that captured them
        stays valid; a parameter the saved state has no entry for gets zeros
        (Adam's state before its first step).  An optimizer with no state
        yet, or another optimizer missing an entry, loads a copy as usual."""
        fresh_is_zero = isinstance(self.optimizer, (torch.optim.Adam, torch.optim.AdamW))
        missing = any(i not in state["state"] for i, p in enumerate(self.params) if self.optimizer.state.get(p))
        if not self.optimizer.state or (missing and not fresh_is_zero):
            self.load_state_dict(copy.deepcopy(state))
            return
        with torch.no_grad():
            for i, p in enumerate(self.params):
                saved = state["state"].get(i)
                for k, t in self.optimizer.state[p].items():
                    if not isinstance(t, torch.Tensor):
                        self.optimizer.state[p][k] = saved[k] if saved else t
                    elif saved:
                        t.copy_(saved[k])
                    else:
                        t.zero_()  # a state saved before this parameter's first step


def optimizer_state_tensors(optimizers: Dict[str, ClippedOptimizer]) -> List[torch.Tensor]:
    """Every tensor of the optimizers' state, made first where a parameter
    has none yet (:meth:`ClippedOptimizer.init_state_`): what the health
    guard backs up and selects besides the parameters."""
    for opt in optimizers.values():
        opt.init_state_()
    return [t for opt in optimizers.values() for t in opt.state_tensors()]


def build_optimizer(
    params: Iterable[torch.nn.Parameter], optim_cfg: Any, max_grad_norm: Optional[float] = None,
    capturable: bool = False,
) -> ClippedOptimizer:
    """Build from an ``optim`` config group entry: {name, lr, eps, ...}.
    ``capturable`` (an update captured as a CUDA graph, parameters on the
    card) builds Adam and AdamW with their step on the card; the other
    optimizers need nothing for a capture."""
    params = list(params)
    name = optim_cfg.get("name", "adam")
    lr = float(optim_cfg.get("lr", 1e-3))
    capturable = capturable and bool(params) and all(p.device.type == "cuda" for p in params)
    if name == "adam":
        betas = optim_cfg.get("betas", [0.9, 0.999])
        opt = torch.optim.Adam(params, lr=lr, betas=(float(betas[0]), float(betas[1])),
                               eps=float(optim_cfg.get("eps", 1e-8)), capturable=capturable)
    elif name == "adamw":
        # optax.adamw keeps its default betas; the config sets lr, eps, decay
        opt = torch.optim.AdamW(params, lr=lr, eps=float(optim_cfg.get("eps", 1e-8)),
                                weight_decay=float(optim_cfg.get("weight_decay", 1e-2)), capturable=capturable)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=float(optim_cfg.get("momentum", 0.0)))
    elif name in ("rmsprop", "rmsprop_tf"):
        tf_style = name == "rmsprop_tf"
        opt = RMSprop(params, lr=lr, alpha=float(optim_cfg.get("alpha", 0.9 if tf_style else 0.99)),
                      eps=float(optim_cfg.get("eps", 1e-10 if tf_style else 1e-8)),
                      momentum=float(optim_cfg.get("momentum", 0.0)), centered=bool(optim_cfg.get("centered", False)),
                      tf_style=tf_style)
    else:
        raise ValueError(f"Unknown optimizer '{name}'")
    clip = float(max_grad_norm) if max_grad_norm is not None and max_grad_norm > 0 else None
    return ClippedOptimizer(params, opt, clip)


def set_learning_rate(optimizer: ClippedOptimizer, lr: float) -> None:
    """Set the learning rate of every parameter group of the wrapped optimizer."""
    for group in optimizer.optimizer.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(optimizer: ClippedOptimizer) -> float:
    return float(optimizer.optimizer.param_groups[0]["lr"])


def build_group_optimizers(modules: Dict[str, torch.nn.Module], groups: Dict[str, Any],
                           saved: Optional[Dict[str, Any]] = None,
                           capturable: bool = False) -> Dict[str, ClippedOptimizer]:
    """One optimizer per named module, from the config section that carries
    its ``optimizer`` and ``clip_gradients``; a saved state is loaded where
    ``saved`` has one for that name."""
    opts = {name: build_optimizer(modules[name].parameters(), section.optimizer, section.get("clip_gradients"),
                                  capturable=capturable)
            for name, section in groups.items()}
    for name, opt in opts.items():
        if saved and name in saved:
            opt.load_state_dict(saved[name])
    return opts
