"""DreamerV2 and Plan2Explore over it in the port against the JAX package.

* One update against ``dreamer_v2.make_train_phase`` and
  ``p2e_dv2_exploration.make_train_phase`` on the harness of
  ``tests/test_torch_train_step.py`` (split chain ``k_wm, k_beh, k_task =
  split(k_u, 3)``: the behaviour (exploration) rollout from ``k_beh``, the
  task rollout from ``k_task``), with the tolerances stated there.  The
  cases cover REINFORCE alone (``objective_mix=1``) and mixed with dynamics
  backprop, the continue head, LayerNorm stages and the hard target copy
  (U = 2 from ``counter0 = 1`` with a period of 2).
* The α-balanced KL loss against the JAX ``reconstruction_loss``.
* Exploration, finetuning and evaluation through the port's CLI.
"""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v2 import dreamer_v2 as jax_dv2
from sheeprl_tpu.algos.dreamer_v2.loss import reconstruction_loss as jax_reconstruction_loss
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_build_opts
from sheeprl_tpu.algos.p2e_dv2 import p2e_dv2_exploration as jax_p2e
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer, build_agent
from sheeprl_tpu_torch.algos.dreamer_v2.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers
from sheeprl_tpu_torch.algos.p2e_dv2 import p2e_dv2_exploration as p2e
from sheeprl_tpu_torch.algos.p2e_utils import p2e_optimizers
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import evaluation, run
from tests.test_torch_train_step import B, H, L, family_parity, sgd_overrides

TINY = (
    "env=dummy",
    "fabric.accelerator=cpu",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=5",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={L}",
    f"algo.horizon={H}",
)
MIX = ("algo.actor.objective_mix=0.5", "algo.world_model.use_continues=True")
HARD_COPY = ("algo.critic.target_network_update_freq=2", "algo.layer_norm=True")

CASES = {
    # id: (env, pixels, extra, U, counter0, adam)
    "discrete-pixels": ("discrete_dummy", True, (), 1, 0, False),
    "continuous-vector-mix-continues": ("continuous_dummy", False, MIX, 1, 0, False),
    "multidiscrete-layernorm-hard-copy-U2": ("multidiscrete_dummy", False, HARD_COPY, 2, 1, False),
    "discrete-vector-mix-adam": ("discrete_dummy", False, MIX, 1, 0, True),
}


def overrides(exp, env_id, pixels, extra=(), sgd_groups=("world_model", "actor", "critic"), adam=False):
    keys = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"] if pixels else [
        "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]
    return [f"exp={exp}", *TINY, f"env.id={env_id}", *keys, *(() if adam else sgd_overrides(sgd_groups)), *extra]


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax_train_phase(case):
    env_id, pixels, extra, U, counter0, adam = CASES[case]
    family_parity(jax_dv2, jax_dv2.make_train_phase, jax_build_opts, build_agent, DV2Trainer,
                  build_dv3_optimizers, overrides("dreamer_v2", env_id, pixels, extra, adam=adam), pixels, U,
                  counter0, n_split=3, rollouts=(1,), adam=adam)


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][5]])
def test_p2e_exploration_update_matches_jax_train_phase(case):
    env_id, pixels, extra, U, counter0, _ = CASES[case]
    groups = ("world_model", "actor", "critic", "ensembles")
    trainer = family_parity(jax_p2e, jax_p2e.make_train_phase, jax_p2e.build_optimizers, p2e.build_agent,
                            DV2Trainer, p2e_optimizers,
                            overrides("p2e_dv2_exploration", env_id, pixels, extra, groups), pixels, U, counter0,
                            n_split=3, rollouts=(1, 2))
    assert torch.isfinite(trainer.last_intrinsic)


@pytest.mark.parametrize("alpha,free_nats,with_continue", [(0.8, 1.0, False), (0.3, 0.0, True)])
def test_balanced_kl_loss_matches_jax(alpha, free_nats, with_continue):
    rng = np.random.default_rng(0)
    obs, rew, cont = (rng.random((L, B)).astype(np.float32) for _ in range(3))
    post, prior = (rng.standard_normal((L, B, 4, 5)).astype(np.float32) for _ in range(2))
    kw = dict(kl_balancing_alpha=alpha, kl_free_nats=free_nats, kl_regularizer=1.5)
    t = torch.from_numpy
    post_t, prior_t = t(post).requires_grad_(), t(prior).requires_grad_()
    total, aux = reconstruction_loss(t(obs), t(rew), t(cont) if with_continue else None, post_t, prior_t, **kw)
    j_total, j_aux = jax_reconstruction_loss(jnp.asarray(obs), jnp.asarray(rew),
                                             jnp.asarray(cont) if with_continue else None, jnp.asarray(post),
                                             jnp.asarray(prior), **kw)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=2e-6)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=2e-6, atol=1e-7, err_msg=k)
    # the balance: the prior learns alpha of the KL gradient, the posterior the rest
    total.backward()
    import jax

    g_post, g_prior = jax.grad(lambda p, q: jax_reconstruction_loss(
        jnp.asarray(obs), jnp.asarray(rew), None, p, q, **kw)[0], argnums=(0, 1))(jnp.asarray(post), jnp.asarray(prior))
    np.testing.assert_allclose(post_t.grad.numpy(), np.asarray(g_post), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(prior_t.grad.numpy(), np.asarray(g_prior), rtol=1e-4, atol=1e-7)


CLI = [
    "env.id=discrete_dummy", "env.num_envs=2", "env.capture_video=False", "metric.log_level=1",
    "metric.log_every=1", "metric/logger=csv", "buffer.memmap=False", "buffer.checkpoint=True",
    "checkpoint.every=1000000", "checkpoint.async_save=False", "algo.learning_starts=0",
    "algo.per_rank_pretrain_steps=0", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
    "env.max_episode_steps=20", "buffer.size=200", "dry_run=True", "algo.run_test=False",
]


def test_cli_dreamer_v2_and_p2e_exploration_finetuning_evaluation(tmp_path):
    snapshots = {}
    for exp, extra in (("dreamer_v2", ["buffer.type=episode", "buffer.prioritize_ends=True"]),
                       ("p2e_dv2_exploration", [])):
        run([f"exp={exp}", *TINY, *CLI, *extra, f"log_dir={tmp_path / exp}"])
        (snapshots[exp],) = glob.glob(f"{tmp_path / exp}/**/checkpoint/step_*", recursive=True)
        assert load_step_dir(snapshots[exp])["grad_steps"] == 1
    explored = load_step_dir(snapshots["p2e_dv2_exploration"])["agent"]
    assert {"ensembles", "actor_task", "critic_exploration", "target_critic_exploration"} <= set(explored)
    run(["exp=p2e_dv2_finetuning", *TINY, *CLI, f"log_dir={tmp_path / 'finetune'}",
         f"checkpoint.exploration_ckpt_path={snapshots['p2e_dv2_exploration']}"])
    (tuned,) = glob.glob(f"{tmp_path / 'finetune'}/**/checkpoint/step_*", recursive=True)
    assert set(load_step_dir(tuned)["agent"]) == {"world_model", "actor", "critic", "target_critic"}
    for snapshot in (*snapshots.values(), tuned):
        assert np.isfinite(evaluation([f"checkpoint_path={snapshot}", "fabric.accelerator=cpu"]))
