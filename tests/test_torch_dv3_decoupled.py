"""DreamerV3 with the DecoupledRSSM in the port against the JAX package: one
update against ``dreamer_v3.make_train_phase`` with
``algo.world_model.decoupled_rssm=True`` (every posterior from its embedding
in one batched pass, sampled with the per-step draws of ``split(k_wm, L)``;
only ``recurrent_prior`` in the scan), with the kernel flags off,
``fused_pallas`` and ``use_pallas``, on the harness and tolerances of
``tests/test_torch_train_step.py``; and a tiny run through the CLI."""

import glob

import pytest

from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_build_opts
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_phase as jax_make_train_phase
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import run
from tests.test_torch_train_cli import TINY as CLI_TINY
from tests.test_torch_train_step import SGD, _overrides, family_parity

CASES = {
    # id: (env, pixels, kernel flag, optimizer overrides, U, counter0)
    "discrete-pixels-flags-off": ("discrete_dummy", True, None, SGD, 1, 0),
    "continuous-vector-fused": ("continuous_dummy", False, "fused_pallas", SGD, 1, 0),
    "multidiscrete-use_pallas-U2": ("multidiscrete_dummy", False, "use_pallas", SGD, 2, 1),
    "discrete-vector-fused-adam": ("discrete_dummy", False, "fused_pallas", (), 1, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decoupled_update_matches_jax_train_phase(case):
    env_id, pixels, flag, opt, U, counter0 = CASES[case]
    overrides = _overrides(env_id, pixels, flag, opt, ("algo.world_model.decoupled_rssm=True",))
    trainer = family_parity(jax_agent, jax_make_train_phase, jax_build_opts, build_agent, DV3Trainer,
                            build_dv3_optimizers, overrides, pixels, U, counter0, n_split=2, rollouts=(1,),
                            adam=not opt)
    assert trainer.world_model.decoupled_rssm


def test_decoupled_trains_through_the_cli(tmp_path):
    run([*CLI_TINY, "dry_run=True", "algo.run_test=False", "algo.world_model.decoupled_rssm=True",
         f"log_dir={tmp_path}"])
    (snapshot,) = glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True)
    state = load_step_dir(snapshot)
    assert state["grad_steps"] == 1
    # the posterior sees the embedding alone
    n_in = state["agent"]["world_model"]["representation_model.dense_0.weight"].shape[1]
    assert n_in == state["agent"]["world_model"]["encoder.mlp_encoder.dense_0.weight"].shape[0] + 4 * 4 * 4 * 8
