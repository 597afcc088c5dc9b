"""DroQ of the port against the JAX package's, on the CPU.

DroQ's critic runs dropout in all three critic calls of an update (the
target, the critic loss and the actor's Q; ``dropout_apply`` in
``sheeprl_tpu/algos/droq/droq.py``).  The port takes the keep masks as
tensors.  JAX's masks are recovered by :class:`_MaskProbe`, a copy of the
JAX ``DroQCriticEnsemble`` whose dropout layers (under the names flax gives
them, so the same key draws the same bits) also return their masks; each
test first holds the probe's output to the JAX module's own train-mode
output, bit for bit.

Cases: the eval-mode and train-mode forwards at the recipe's dropout 0.01
(1e-5); the whole train phase against the live JAX phase
(``make_sac_train_fns`` with JAX's dropout critic apply), 3 updates with
``target_network_frequency`` 2 and ``tau`` 0.5, at ``critic.dropout=0``
(the LayerNorm Q and the engine) and at 0.01 with every call's masks handed
in: every parameter within 1e-5 absolute, the losses' means within 1e-5
relative.
"""

from typing import Any

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.droq.agent import DroQCriticEnsemble as JaxDroQCritic
from sheeprl_tpu.algos.droq.agent import build_agent as jax_build_agent
from sheeprl_tpu.models.models import LayerNorm as JaxLayerNorm
from sheeprl_tpu_torch.algos.droq.agent import build_agent as pt_build_agent
from tests.test_torch_sac import (
    ACT_DIM,
    LOSS_RTOL,
    OBS_DIM,
    TOL,
    _t,
    assert_agent_matches,
    run_both,
    setup,
)

DROQ = ["exp=droq", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "fabric.accelerator=cpu", "algo.hidden_size=32",
        "algo.critic.target_network_frequency=2", "algo.tau=0.5"]


def dropout_apply(critic, cp, o, a, k):
    """The JAX DroQ main's critic apply: dropout on in every call."""
    return critic.apply(cp, o, a, train=True, rngs={"dropout": k})


class _KeepDropout(nn.Module):
    """``nn.Dropout``'s draw, also returning the keep mask."""

    rate: float

    @nn.compact
    def __call__(self, x):
        keep = jax.random.bernoulli(self.make_rng("dropout"), 1.0 - self.rate, x.shape)
        return jax.lax.select(keep, x / (1.0 - self.rate), jnp.zeros_like(x)), keep


class _OneQ(nn.Module):
    hidden: int
    dropout: float
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        keeps = []
        for i in range(2):
            x = nn.Dense(self.hidden, dtype=self.dtype, name=f"dense_{i}")(x)
            x, keep = _KeepDropout(self.dropout, name=f"Dropout_{i}")(x)
            keeps.append(keep)
            x = nn.relu(JaxLayerNorm(dtype=self.dtype, name=f"ln_{i}")(x))
        return nn.Dense(1, dtype=jnp.float32, name="head")(x), keeps


class _MaskProbe(nn.Module):
    n: int
    hidden: int
    dropout: float
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, obs, action):
        q_net = nn.vmap(_OneQ, in_axes=None, out_axes=0, axis_size=self.n, variable_axes={"params": 0},
                        split_rngs={"params": True, "dropout": True})
        q, keeps = q_net(self.hidden, self.dropout, self.dtype, name="q_ensemble")(jnp.concatenate([obs, action], -1))
        return q[..., 0], keeps


def jax_masks(critic, variables, key, obs, act):
    """The keep masks JAX's train-mode ``critic`` draws from ``key`` (they
    depend on the key and the shapes only), checked against its own output
    (the probe computes in the critic's dtype)."""
    probe = _MaskProbe(critic.n_critics, critic.hidden_size, critic.dropout, critic.dtype)
    q, keeps = probe.apply(variables, obs, act, rngs={"dropout": key})
    np.testing.assert_array_equal(np.asarray(q), np.asarray(dropout_apply(critic, variables, obs, act, key)))
    return [_t(k) for k in keeps]


def masks_of(critic, params, key, B):
    rng = np.random.default_rng(0)
    obs = jnp.asarray(rng.standard_normal((B, OBS_DIM)), jnp.float32)
    act = jnp.asarray(rng.uniform(-1, 1, (B, ACT_DIM)), jnp.float32)
    return jax_masks(critic, params["critic"], key, obs, act)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_critic_forward_matches_jax(train):
    _, _, _, critic, params, agent = setup(DROQ, jax_build_agent, pt_build_agent)
    assert isinstance(critic, JaxDroQCritic) and critic.dropout == 0.01
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((64, OBS_DIM)).astype(np.float32)
    act = rng.uniform(-1, 1, (64, ACT_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    if train:
        want = dropout_apply(critic, params["critic"], jnp.asarray(obs), jnp.asarray(act), key)
        masks = jax_masks(critic, params["critic"], key, jnp.asarray(obs), jnp.asarray(act))
        assert 0 < sum(int((~m).sum()) for m in masks)  # some units dropped at 0.01
        got = agent.critic(_t(obs), _t(act), train=True, masks=masks)
        with pytest.raises(ValueError, match="keep masks"):
            agent.critic(_t(obs), _t(act), train=True)
    else:
        want = critic.apply(params["critic"], jnp.asarray(obs), jnp.asarray(act))
        got = agent.critic(_t(obs), _t(act))
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_dropout_masks_are_drawn_per_member_on_the_generator():
    _, _, _, _, _, agent = setup(DROQ, jax_build_agent, pt_build_agent)
    masks = agent.critic.dropout_masks(4096, torch.Generator().manual_seed(0))
    assert len(masks) == 2 and masks[0].shape == (2, 4096, 32) and masks[0].dtype == torch.bool
    assert not torch.equal(masks[0][0], masks[0][1]) and not torch.equal(masks[0], masks[1])
    assert abs(float((~masks[0]).float().mean()) - 0.01) < 0.002


@pytest.mark.parametrize("dropout", [0.0, 0.01])
def test_train_phase_matches_jax(dropout):
    overrides = [*DROQ, f"algo.critic.dropout={dropout}"]
    agent, got, want_params, want = run_both(overrides, dropout_apply, masks_of if dropout else None, B=16,
                                             jax_build=jax_build_agent, pt_build=pt_build_agent)
    assert_agent_matches(agent, want_params)
    np.testing.assert_allclose([float(x) for x in got], want, rtol=LOSS_RTOL, atol=1e-7)
