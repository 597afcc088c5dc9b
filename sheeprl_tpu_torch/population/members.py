"""The members of a population on one leading ``P`` axis: stacked
parameters run through one agent module, and a stacked optimizer.

The JAX package gets its members from ``jax.vmap`` over a whole agent.
Here :class:`StackedAgent` keeps every parameter of one agent module as a
``(P, ...)`` leaf tensor and runs the module through
``torch.func.functional_call`` under ``torch.func.vmap``: one batched launch
per operation whatever ``P`` is, never a Python loop over members.  A loss
summed over the members differentiates to each member's own gradient (the
members share no parameter), so one ``autograd.grad`` serves them all.

:class:`StackedOptimizer` is the optimizer factory's optimizers
(``utils/optim.py``: optax's Adam and AdamW, SGD, both RMSprops) over the
stacked tensors, with a ``(P,)`` learning rate and optax's global-norm clip
taken per member: JAX clips inside its ``vmap``, so each member is scaled
by its own norm.  The RMSprops take ``utils/optim.py``'s own step
(:func:`~sheeprl_tpu_torch.utils.optim.rmsprop_step_`); Adam, AdamW and
SGD are written here, because ``torch.optim`` takes one float learning
rate per parameter group.  Its state is made up front, so a
captured phase updates fixed tensors in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call, vmap

from sheeprl_tpu_torch.population.core import tile_stack
from sheeprl_tpu_torch.utils.optim import rmsprop_state, rmsprop_step_

OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop", "rmsprop_tf")


class StackedAgent:
    """``size`` members of ``module``: its parameters stacked ``(size, ...)``
    as leaf tensors that require grad.  ``state`` (a ``state_dict`` of
    stacked tensors) loads them; otherwise every member starts from the
    module's own parameters."""

    def __init__(self, module: torch.nn.Module, size: int, state: Optional[Dict[str, torch.Tensor]] = None):
        self.module, self.size = module, int(size)
        if list(module.buffers()):
            raise NotImplementedError("a population of an agent with buffers is not supported")
        own = dict(module.named_parameters())
        self.params: Dict[str, torch.Tensor] = {}
        for name, p in own.items():
            src = state[name] if state is not None else tile_stack(p.detach(), self.size)
            if tuple(src.shape) != (self.size, *p.shape):
                raise ValueError(f"{name}: a stacked parameter of {tuple(src.shape)} for {self.size} members of "
                                 f"{tuple(p.shape)}")
            self.params[name] = src.to(device=p.device, dtype=p.dtype).clone().requires_grad_(True)

    def one(self, params: Dict[str, torch.Tensor], obs: Dict[str, torch.Tensor]):
        """One member's outputs: the module run with ``params``."""
        return functional_call(self.module, params, (obs,))

    def __call__(self, obs: Dict[str, torch.Tensor]):
        """Every member's outputs on its own ``(P, N, ...)`` observations."""
        return vmap(self.one)(self.params, obs)

    def flat(self, obs: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The members' outputs on ``(P·N, ...)`` rows, member ``m`` owning
        rows ``[m·N, (m+1)·N)``: what an env of ``P·N`` rows observes."""
        out = self({k: v.reshape(self.size, -1, *v.shape[1:]) for k, v in obs.items()})
        return tuple(x.reshape(-1, *x.shape[2:]) for x in out)

    def tensors(self) -> List[torch.Tensor]:
        return list(self.params.values())

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach() for k, v in self.params.items()}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        for k, v in self.params.items():
            v.copy_(state[k])

    def member(self, m: int) -> Dict[str, torch.Tensor]:
        """Member ``m``'s parameters as the module's ``state_dict``."""
        return {k: v[m].detach().clone() for k, v in self.params.items()}


def _per_member(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``(P,)`` tensor shaped to broadcast against a stacked ``(P, ...)`` one."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


class StackedOptimizer:
    """One optimizer per member over stacked parameters (see the module
    docstring).  ``step(grads, lr)`` clips each member's gradients by its
    own global norm (``max_grad_norm``; none when 0 or None), then updates
    the parameters in place at the ``(P,)`` learning rate ``lr``."""

    def __init__(self, params: Dict[str, torch.Tensor], optim_cfg: Any, max_grad_norm: Optional[float] = None):
        self.params = params
        self.name = str(optim_cfg.get("name", "adam"))
        if self.name not in OPTIMIZERS:
            raise ValueError(f"Unknown optimizer '{self.name}'")
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else None
        self.tf_style = self.name == "rmsprop_tf"
        betas = optim_cfg.get("betas", [0.9, 0.999])
        self.b1, self.b2 = ((float(betas[0]), float(betas[1])) if self.name == "adam" else (0.9, 0.999))
        default_eps = {"rmsprop_tf": 1e-10}.get(self.name, 1e-8)
        self.eps = float(optim_cfg.get("eps", default_eps))
        self.weight_decay = float(optim_cfg.get("weight_decay", 1e-2)) if self.name == "adamw" else 0.0
        self.momentum = float(optim_cfg.get("momentum", 0.0)) if self.name in ("sgd", "rmsprop", "rmsprop_tf") \
            else 0.0
        self.alpha = float(optim_cfg.get("alpha", 0.9 if self.tf_style else 0.99))
        self.centered = bool(optim_cfg.get("centered", False)) and self.name.startswith("rmsprop")
        any_p = next(iter(params.values()))
        size = any_p.shape[0]
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, p in params.items():
            if self.name.startswith("rmsprop"):
                s = rmsprop_state(p, self.tf_style, self.centered, self.momentum)
            elif self.name == "sgd":
                s = {"momentum_buffer": torch.zeros_like(p)} if self.momentum > 0 else {}
            else:
                s = {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
            self.state[k] = {n: t.detach() for n, t in s.items()}
        # the members' step counts (optax keeps one per member's state)
        self.count = torch.zeros((size,), dtype=torch.float32, device=any_p.device)

    def tensors(self) -> List[torch.Tensor]:
        """Every state tensor, stacked ``(P, ...)``, in a fixed order."""
        return [self.count, *(t for s in self.state.values() for t in s.values())]

    def state_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "count": self.count,
                "state": {k: dict(s) for k, s in self.state.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if state.get("name") != self.name:
            raise ValueError(f"a saved {state.get('name')!r} optimizer state for a {self.name!r} optimizer")
        self.count.copy_(state["count"])
        for k, s in self.state.items():
            for n, t in s.items():
                t.copy_(state["state"][k][n])

    def clip_(self, grads: Sequence[torch.Tensor]) -> None:
        """Scale each member's gradients in place by ``max_norm / norm`` where
        its own global norm is at least ``max_norm``."""
        if self.max_grad_norm is None:
            return
        norm = torch.sqrt(sum(g.reshape(g.shape[0], -1).square().sum(dim=1) for g in grads))
        scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
        for g in grads:
            g.mul_(_per_member(scale, g))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: torch.Tensor) -> None:
        grads = [g.clone() for g in grads]
        self.clip_(grads)
        self.count.add_(1.0)
        if self.name in ("adam", "adamw"):
            bc1 = 1.0 - torch.pow(self.b1, self.count)
            bc2 = 1.0 - torch.pow(self.b2, self.count)
        for (k, p), g in zip(self.params.items(), grads):
            s, r = self.state[k], _per_member(lr, p)
            if self.name in ("adam", "adamw"):
                m = s["exp_avg"].mul_(self.b1).add_(g, alpha=1 - self.b1)
                v = s["exp_avg_sq"].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                update = (m / _per_member(bc1, p)) / (torch.sqrt(v / _per_member(bc2, p)) + self.eps)
                if self.weight_decay:
                    update = update + self.weight_decay * p
                p.sub_(r * update)
            elif self.name == "sgd":
                if self.momentum > 0:
                    g = s["momentum_buffer"].mul_(self.momentum).add_(g)
                p.sub_(r * g)
            else:
                rmsprop_step_(p, g, s, r, self.alpha, self.eps, self.momentum, self.centered, self.tf_style)


def member_permutations(generator: torch.Generator, size: int, n: int, total: int) -> torch.Tensor:
    """``(size, total)`` sample orders: one permutation of ``n`` rows per
    member (an ``argsort`` of uniform draws: one batched launch, no host
    wait), padded by wrap-around to ``total`` entries."""
    perm = torch.argsort(torch.rand((size, n), generator=generator, device=generator.device), dim=1)
    pad = total - n
    return torch.cat([perm, perm[:, :pad]], dim=1) if pad > 0 else perm


