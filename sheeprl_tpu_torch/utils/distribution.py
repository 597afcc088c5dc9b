"""Distributions (counterparts of ``sheeprl_tpu/utils/distribution.py``):
:class:`OneHotCategorical` with unimix and the straight-through rsample,
the index-valued :class:`Categorical` and :class:`MultiCategorical` of the
on-policy agents, :class:`Normal`, :class:`TanhNormal`,
:class:`TruncatedNormal`, :class:`Bernoulli`, the KLs :func:`kl_categorical`
and :func:`kl_normal`, and the regression heads
:class:`MSEDistribution`, :class:`SymlogDistribution` and
:class:`TwoHotEncodingDistribution`.

Randomness comes from an explicit ``torch.Generator``, or as pre-drawn
noise: ``sample(generator)`` is ``sample_from_noise(sample_noise(...))``
for every distribution that samples, so a test can hand both packages the
same numpy noise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from sheeprl_tpu_torch.utils.utils import symexp, symlog, two_hot_buckets

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


class Categorical:
    """Categorical over the last axis of ``logits``, valued in indices.
    Sampling is the Gumbel-max ``argmax(logits + gumbel)``, as
    ``jax.random.categorical`` draws it."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)

    @property
    def probs(self) -> torch.Tensor:
        return torch.exp(self.logits)

    @staticmethod
    def sample_noise(shape: Sequence[int], generator: torch.Generator, device: torch.device) -> torch.Tensor:
        return gumbel_noise(shape, generator, device)

    def sample_from_noise(self, noise: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits + noise, dim=-1)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample_from_noise(self.sample_noise(self.logits.shape, generator, self.logits.device))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.gather(self.logits, -1, value.long()[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        return -torch.sum(self.probs * self.logits, dim=-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)


class MultiCategorical:
    """Independent categoricals, one per discrete action branch; values are
    ``(..., n_branches)`` indices and each branch samples from its own noise."""

    def __init__(self, logits: Sequence[torch.Tensor]):
        self.dists = [Categorical(lg) for lg in logits]

    def sample_from_noise(self, noise: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.stack([d.sample_from_noise(n) for d, n in zip(self.dists, noise)], dim=-1)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample_from_noise([d.sample_noise(d.logits.shape, generator, d.logits.device)
                                       for d in self.dists])

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return sum(d.log_prob(value[..., i]) for i, d in enumerate(self.dists))

    def entropy(self) -> torch.Tensor:
        return sum(d.entropy() for d in self.dists)

    def mode(self) -> torch.Tensor:
        return torch.stack([d.mode() for d in self.dists], dim=-1)


def kl_categorical(p: OneHotCategorical, q: OneHotCategorical) -> torch.Tensor:
    """KL(p‖q) summed over the categorical axis."""
    return torch.sum(p.probs * (p.logits - q.logits), dim=-1)


class Normal:
    def __init__(self, loc: torch.Tensor, scale, event_dims: int = 0):
        self.loc = loc
        # a number becomes a fill on the device, not a copy from the host
        self.scale = scale if isinstance(scale, torch.Tensor) else torch.full((), float(scale), dtype=loc.dtype,
                                                                              device=loc.device)
        self.event_dims = event_dims

    @staticmethod
    def sample_noise(shape: Sequence[int], generator: torch.Generator, device: torch.device) -> torch.Tensor:
        """Standard normal noise, the draw :meth:`sample` consumes."""
        return torch.randn(tuple(shape), generator=generator, device=device)

    def sample_from_noise(self, noise: torch.Tensor) -> torch.Tensor:
        return self.loc + self.scale * noise

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.sample_from_noise(self.sample_noise(self.loc.shape, generator, self.loc.device))

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

    @property
    def mean(self) -> torch.Tensor:
        return self.loc


def kl_normal(p: Normal, q: Normal) -> torch.Tensor:
    """KL(p‖q) of two diagonal normals, summed over the larger event rank."""
    var_ratio = (p.scale / q.scale) ** 2
    t1 = ((p.loc - q.loc) / q.scale) ** 2
    kl = 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
    return _sum_event(kl, max(p.event_dims, q.event_dims))


class TanhNormal:
    """Tanh-squashed Gaussian with the exact log-det correction
    ``2 (log 2 - x - softplus(-2x))``; ``event_dims`` trailing axes are
    summed in the log-prob."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, event_dims: int = 1):
        self.base = Normal(loc, scale, event_dims=0)
        self.event_dims = event_dims

    sample_noise = staticmethod(Normal.sample_noise)

    def sample_and_log_prob_from_noise(self, noise: torch.Tensor):
        pre = self.base.sample_from_noise(noise)
        log_det = 2.0 * (math.log(2.0) - pre - F.softplus(-2.0 * pre))
        return torch.tanh(pre), _sum_event(self.base.log_prob(pre) - log_det, self.event_dims)

    def sample_and_log_prob(self, generator: torch.Generator):
        loc = self.base.loc
        return self.sample_and_log_prob_from_noise(self.sample_noise(loc.shape, generator, loc.device))

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.base.loc)


def _norm_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x**2 - _HALF_LOG_2PI)


class TruncatedNormal:
    """Normal truncated to ``[low, high]``; inverse-CDF sampling from a
    uniform draw in ``[1e-6, 1 - 1e-6)``."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, low: float = -1.0, high: float = 1.0,
                 event_dims: int = 0):
        self.loc = loc
        self.scale = scale
        self.low = low
        self.high = high
        self.event_dims = event_dims
        self._a = (low - loc) / scale
        self._b = (high - loc) / scale
        self._cdf_a = torch.special.ndtr(self._a)
        self._z = torch.clamp(torch.special.ndtr(self._b) - self._cdf_a, min=1e-8)

    @staticmethod
    def sample_noise(shape: Sequence[int], generator: torch.Generator, device: torch.device) -> torch.Tensor:
        return 1e-6 + (1.0 - 2e-6) * torch.rand(tuple(shape), generator=generator, device=device)

    def sample_from_noise(self, u: torch.Tensor) -> torch.Tensor:
        p = self._cdf_a + u * self._z
        x = self.loc + self.scale * torch.special.ndtri(torch.clamp(p, 1e-7, 1 - 1e-7))
        return torch.clamp(x, self.low, self.high)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample_from_noise(self.sample_noise(self.loc.shape, generator, self.loc.device))

    rsample = sample

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        lp = -0.5 * z**2 - torch.log(self.scale) - _HALF_LOG_2PI - torch.log(self._z)
        return _sum_event(lp, self.event_dims)

    def entropy(self) -> torch.Tensor:
        frac = (self._a * _norm_pdf(self._a) - self._b * _norm_pdf(self._b)) / self._z
        ent = 0.5 + _HALF_LOG_2PI + torch.log(self.scale * self._z) + 0.5 * frac
        return _sum_event(ent, self.event_dims)

    def mode(self) -> torch.Tensor:
        return torch.clamp(self.loc, self.low, self.high)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc + self.scale * (_norm_pdf(self._a) - _norm_pdf(self._b)) / self._z


class MSEDistribution:
    """Deterministic prediction scored with -MSE."""

    def __init__(self, mode: torch.Tensor, event_dims: int = 0):
        self._mode = mode
        self.event_dims = event_dims

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return _sum_event(-((self._mode - value) ** 2), self.event_dims)

    def mode(self) -> torch.Tensor:
        return self._mode

    @property
    def mean(self) -> torch.Tensor:
        return self._mode


class SymlogDistribution:
    """MSE in symlog space; mode and mean decode with symexp."""

    def __init__(self, mode: torch.Tensor, event_dims: int = 1):
        self._mode = mode
        self.event_dims = event_dims

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return _sum_event(-((self._mode - symlog(value)) ** 2), self.event_dims)

    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    @property
    def mean(self) -> torch.Tensor:
        return symexp(self._mode)


class TwoHotEncodingDistribution:
    """Symlog two-hot categorical over ``logits.shape[-1]`` evenly spaced
    bins in ``[low, high]``: ``log_prob(x)`` = two-hot(symlog x) ·
    log-softmax(logits), ``mean`` = symexp of the expected bin."""

    def __init__(self, logits: torch.Tensor, dims: int = 1, low: float = -20.0, high: float = 20.0):
        self.logits = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
        self.event_dims = dims
        self.low, self.high = float(low), float(high)
        self.bins = torch.linspace(low, high, logits.shape[-1], dtype=torch.float32, device=logits.device)

    @property
    def probs(self) -> torch.Tensor:
        return torch.exp(self.logits)

    @property
    def mean(self) -> torch.Tensor:
        return symexp(torch.sum(self.probs * self.bins, dim=-1, keepdim=True))

    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` (..., 1) → (...) after the event reduction."""
        x = symlog(value).clamp(self.low, self.high)
        target = two_hot_buckets(x, self.bins)
        lp = torch.sum(target * self.logits, dim=-1, keepdim=True)
        return _sum_event(lp, self.event_dims)


class Bernoulli:
    """Bernoulli over logits with a mode that is never NaN."""

    def __init__(self, logits: torch.Tensor, event_dims: int = 0):
        self.logits = logits
        self.event_dims = event_dims

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def log_prob(self, value) -> torch.Tensor:
        lp = -F.softplus(-self.logits) * value - F.softplus(self.logits) * (1.0 - value)
        return _sum_event(lp, self.event_dims)

    @staticmethod
    def sample_noise(shape: Sequence[int], generator: torch.Generator, device: torch.device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=generator, device=device)

    def sample_from_noise(self, u: torch.Tensor) -> torch.Tensor:
        return (u < self.probs).to(torch.float32)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample_from_noise(self.sample_noise(self.logits.shape, generator, self.logits.device))

    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(torch.float32)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs
