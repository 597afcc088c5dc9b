"""DreamerV1 and Plan2Explore over it in the port against the JAX package.

* One update against ``dreamer_v1.make_train_phase`` and
  ``p2e_dv1_exploration.make_train_phase`` on the harness of
  ``tests/test_torch_train_step.py`` with Gaussian latents (normal draws:
  the posterior from ``split(k_wm, L)``, the behaviour (exploration) rollout
  from ``k_beh`` and the task rollout from ``k_task`` of ``split(k_u, 3)``),
  with the tolerances stated there.  The actor's gradient flows through
  every imagination step (dynamics backprop).
* ``kl_normal`` and the V1 world-model loss against the JAX functions.
* Exploration, finetuning and evaluation through the port's CLI.
"""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v1 import agent as jax_dv1_agent
from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import make_train_phase as jax_make_train_phase
from sheeprl_tpu.algos.dreamer_v1.loss import reconstruction_loss as jax_reconstruction_loss
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_build_opts
from sheeprl_tpu.algos.p2e_dv1 import p2e_dv1_exploration as jax_p2e
from sheeprl_tpu.utils import distribution as jd
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
from sheeprl_tpu_torch.algos.dreamer_v1.loss import reconstruction_loss
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers
from sheeprl_tpu_torch.algos.p2e_dv1 import p2e_dv1_exploration as p2e
from sheeprl_tpu_torch.algos.p2e_utils import p2e_optimizers
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.utils import distribution as pd
from tests.test_torch_dreamer_v2 import CLI
from tests.test_torch_train_step import B, H, L, family_parity, sgd_overrides

TINY = (
    "env=dummy", "env.sync_env=True",
    "fabric.accelerator=cpu",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.stochastic_size=6",
    f"algo.per_rank_batch_size={B}",
    f"algo.per_rank_sequence_length={L}",
    f"algo.horizon={H}",
)
CONTINUES = ("algo.world_model.use_continues=True",)

CASES = {
    # id: (env, pixels, extra, U, adam)
    "discrete-pixels": ("discrete_dummy", True, (), 1, False),
    "continuous-vector-continues": ("continuous_dummy", False, CONTINUES, 1, False),
    "multidiscrete-vector-U2": ("multidiscrete_dummy", False, (), 2, False),
    "continuous-vector-adam": ("continuous_dummy", False, (), 1, True),
}


def overrides(exp, env_id, pixels, extra=(), sgd_groups=("world_model", "actor", "critic"), adam=False):
    keys = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"] if pixels else [
        "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]
    return [f"exp={exp}", *TINY, f"env.id={env_id}", *keys, *(() if adam else sgd_overrides(sgd_groups)), *extra]


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax_train_phase(case):
    env_id, pixels, extra, U, adam = CASES[case]
    family_parity(jax_dv1_agent, jax_make_train_phase, jax_build_opts, build_agent, DV1Trainer,
                  build_dv3_optimizers, overrides("dreamer_v1", env_id, pixels, extra, adam=adam), pixels, U, 0,
                  n_split=3, rollouts=(1,), adam=adam, gaussian=True)


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][4]])
def test_p2e_exploration_update_matches_jax_train_phase(case):
    env_id, pixels, extra, U, _ = CASES[case]
    groups = ("world_model", "actor", "critic", "ensembles")
    trainer = family_parity(jax_p2e, jax_p2e.make_train_phase, jax_p2e.build_optimizers, p2e.build_agent,
                            DV1Trainer, p2e_optimizers,
                            overrides("p2e_dv1_exploration", env_id, pixels, extra, groups), pixels, U, 0, n_split=3,
                            rollouts=(1, 2), gaussian=True)
    assert torch.isfinite(trainer.last_intrinsic)


def test_kl_normal_and_world_model_loss_match_jax():
    rng = np.random.default_rng(0)
    pm, qm = (rng.standard_normal((L, B, 6)).astype(np.float32) for _ in range(2))
    ps, qs = (np.exp(0.3 * rng.standard_normal((L, B, 6))).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    for dims in (0, 1):
        np.testing.assert_allclose(
            pd.kl_normal(pd.Normal(t(pm), t(ps), dims), pd.Normal(t(qm), t(qs), dims)).numpy(),
            np.asarray(jd.kl_normal(jd.Normal(jnp.asarray(pm), jnp.asarray(ps), dims),
                                    jd.Normal(jnp.asarray(qm), jnp.asarray(qs), dims))), rtol=1e-5, atol=1e-6)
    obs, rew, cont = (rng.random((L, B)).astype(np.float32) for _ in range(3))
    for free_nats, c in ((3.0, None), (0.0, cont)):
        total, aux = reconstruction_loss(t(obs), t(rew), None if c is None else t(c), t(pm), t(ps), t(qm), t(qs),
                                         kl_free_nats=free_nats, kl_regularizer=0.7)
        j_total, j_aux = jax_reconstruction_loss(jnp.asarray(obs), jnp.asarray(rew), None if c is None else
                                                 jnp.asarray(c), *(jnp.asarray(x) for x in (pm, ps, qm, qs)),
                                                 kl_free_nats=free_nats, kl_regularizer=0.7)
        np.testing.assert_allclose(float(total), float(j_total), rtol=2e-6)
        for k in j_aux:
            np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=2e-6, atol=1e-7, err_msg=k)


def test_cli_dreamer_v1_and_p2e_exploration_finetuning_evaluation(tmp_path):
    snapshots = {}
    for exp, extra in (("dreamer_v1", ["env.id=continuous_dummy"]), ("p2e_dv1_exploration", ["buffer.type=episode"])):
        run([f"exp={exp}", *TINY, *CLI, *extra, f"log_dir={tmp_path / exp}"])
        (snapshots[exp],) = glob.glob(f"{tmp_path / exp}/**/checkpoint/step_*", recursive=True)
        assert load_step_dir(snapshots[exp])["grad_steps"] == 1
    explored = load_step_dir(snapshots["p2e_dv1_exploration"])["agent"]
    assert set(explored) == {"world_model", "actor", "critic", "ensembles", "actor_task", "critic_exploration"}
    run(["exp=p2e_dv1_finetuning", *TINY, *CLI, f"log_dir={tmp_path / 'finetune'}",
         f"checkpoint.exploration_ckpt_path={snapshots['p2e_dv1_exploration']}"])
    (tuned,) = glob.glob(f"{tmp_path / 'finetune'}/**/checkpoint/step_*", recursive=True)
    tuned_agent = load_step_dir(tuned)["agent"]
    assert set(tuned_agent) == {"world_model", "actor", "critic"}
    for snapshot in (*snapshots.values(), tuned):
        assert np.isfinite(evaluation([f"checkpoint_path={snapshot}", "fabric.accelerator=cpu"]))
