"""The distributions the serving path samples from (counterparts of
``sheeprl_tpu/utils/distribution.py``: :class:`OneHotCategorical` with
unimix and the straight-through rsample, and :class:`Normal`).

Randomness comes from an explicit ``torch.Generator``, or as pre-drawn
noise: ``sample(generator)`` is ``sample_from_noise(sample_noise(...))``,
so a test can hand both packages the same numpy noise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _sum_event(x: torch.Tensor, event_dims: int) -> torch.Tensor:
    if event_dims <= 0:
        return x
    return x.sum(dim=tuple(range(-event_dims, 0)))


def gumbel_noise(shape: Sequence[int], generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise, drawn as ``jax.random.gumbel`` draws it:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    u = torch.rand(tuple(shape), generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class OneHotCategorical:
    """One-hot-valued categorical over the last axis of ``logits``."""

    def __init__(self, logits: torch.Tensor, unimix: float = 0.0):
        if unimix > 0.0:
            probs = F.softmax(logits, dim=-1)
            probs = (1.0 - unimix) * probs + unimix / logits.shape[-1]
            logits = torch.log(probs)
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.exp(self.logits)

    @property
    def num_classes(self) -> int:
        return self.logits.shape[-1]

    def _one_hot(self, idx: torch.Tensor) -> torch.Tensor:
        return F.one_hot(idx, self.num_classes).to(self.logits.dtype)

    @staticmethod
    def sample_noise(shape: Sequence[int], generator: torch.Generator, device: torch.device) -> torch.Tensor:
        """The noise :meth:`sample` consumes for logits of this shape."""
        return gumbel_noise(shape, generator, device)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample_from_noise(self.sample_noise(self.logits.shape, generator, self.logits.device))

    def rsample(self, generator: torch.Generator) -> torch.Tensor:
        return self.rsample_from_noise(self.sample_noise(self.logits.shape, generator, self.logits.device))

    def sample_from_noise(self, noise: torch.Tensor) -> torch.Tensor:
        return self._one_hot(torch.argmax(self.logits + noise, dim=-1))

    def rsample_from_noise(self, noise: torch.Tensor) -> torch.Tensor:
        """Straight-through sample: the value of the one-hot draw, the
        gradient of the probabilities."""
        sample = self.sample_from_noise(noise)
        probs = self.probs
        return sample + probs - probs.detach()

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.sum(value * self.logits, dim=-1)

    def entropy(self) -> torch.Tensor:
        return -torch.sum(self.probs * self.logits, dim=-1)

    def mode(self) -> torch.Tensor:
        return self._one_hot(torch.argmax(self.logits, dim=-1))


class Normal:
    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, event_dims: int = 0):
        self.loc = loc
        self.scale = scale
        self.event_dims = event_dims

    def sample_from_noise(self, noise: torch.Tensor) -> torch.Tensor:
        return self.loc + self.scale * noise

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(self.loc.shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        return self.sample_from_noise(noise)

    rsample = sample  # reparameterized by construction

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        lp = -0.5 * z**2 - torch.log(self.scale) - _HALF_LOG_2PI
        return _sum_event(lp, self.event_dims)

    def entropy(self) -> torch.Tensor:
        ent = 0.5 + _HALF_LOG_2PI + torch.log(self.scale)
        return _sum_event(ent, self.event_dims)

    def mode(self) -> torch.Tensor:
        return self.loc
