"""Optimizer factory (counterpart of ``sheeprl_tpu/utils/optim.py``).

The same config surface (``configs/optim/*``) builds a ``torch.optim``
optimizer behind optax's global-norm clip: :class:`ClippedOptimizer` scales
the group's gradients by ``max_norm / norm`` only when ``norm >= max_norm``
and adds no epsilon (``optax.clip_by_global_norm``), unlike
``torch.nn.utils.clip_grad_norm_``.  ``torch.optim.Adam`` is optax's Adam:
the same bias correction, eps outside the square root.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

__all__ = ["ClippedOptimizer", "build_optimizer", "clip_by_global_norm_"]


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` where their global L2
    norm is at least ``max_norm``; returns the norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


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

    def state_dict(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)


def build_optimizer(
    params: Iterable[torch.nn.Parameter], optim_cfg: Any, max_grad_norm: Optional[float] = None
) -> ClippedOptimizer:
    """Build from an ``optim`` config group entry: {name, lr, eps, ...}."""
    params = list(params)
    name = optim_cfg.get("name", "adam")
    lr = float(optim_cfg.get("lr", 1e-3))
    if name == "adam":
        betas = optim_cfg.get("betas", [0.9, 0.999])
        opt = torch.optim.Adam(params, lr=lr, betas=(float(betas[0]), float(betas[1])),
                               eps=float(optim_cfg.get("eps", 1e-8)))
    elif name == "adamw":
        # optax.adamw keeps its default betas; the config sets lr, eps, decay
        opt = torch.optim.AdamW(params, lr=lr, eps=float(optim_cfg.get("eps", 1e-8)),
                                weight_decay=float(optim_cfg.get("weight_decay", 1e-2)))
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=float(optim_cfg.get("momentum", 0.0)))
    elif name in ("rmsprop", "rmsprop_tf"):
        raise NotImplementedError(
            f"optimizer '{name}' is not ported yet: it comes with A2C and the on-policy algorithms "
            "(ROADMAP.md, queue A item 4)"
        )
    else:
        raise ValueError(f"Unknown optimizer '{name}'")
    clip = float(max_grad_norm) if max_grad_norm is not None and max_grad_norm > 0 else None
    return ClippedOptimizer(params, opt, clip)


def build_group_optimizers(modules: Dict[str, torch.nn.Module], groups: Dict[str, Any],
                           saved: Optional[Dict[str, Any]] = None) -> Dict[str, ClippedOptimizer]:
    """One optimizer per named module, from the config section that carries
    its ``optimizer`` and ``clip_gradients``; a saved state is loaded where
    ``saved`` has one for that name."""
    opts = {name: build_optimizer(modules[name].parameters(), section.optimizer, section.get("clip_gradients"))
            for name, section in groups.items()}
    for name, opt in opts.items():
        if saved and name in saved:
            opt.load_state_dict(saved[name])
    return opts
