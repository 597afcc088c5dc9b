"""Plan2Explore over DreamerV3 in the port against the JAX package.

* One exploration update against ``p2e_dv3_exploration.make_train_phase``
  (the harness of ``tests/test_torch_train_step.py``: one numpy-drawn tree
  carried across by ``convert.py``, the same block, the draws of the JAX
  keys along the P2E split chain ``k_wm, k_ens, k_expl, k_task =
  split(k_u, 4)``, the exploration rollout from ``k_expl`` and the task
  rollout from ``k_task``), for discrete, continuous and multi-discrete
  actions, with the kernel flags off, ``fused_pallas`` and ``use_pallas``.
  Tolerances: the ten metrics 1e-5 relative (2e-5 absolute); after ``sgd``
  each parameter's change to 1e-3 of the largest change of its tensor plus
  1e-4 relative (the gradient tier of ``tests/test_regression/DRIFT.md``);
  after Adam half the learning rate; Moments 1e-5 relative.
* ``ensemble_disagreement`` (1e-6 relative) and ``exploration_state_to_dv3``
  (exact) against the JAX functions.
* Exploration, then finetuning from its snapshot, then ``cli.evaluation``,
  through the port's CLI at a tiny size; a long first exploration window
  sampled in chunks, each update drawing its own noise.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.p2e_dv3 import p2e_dv3_exploration as jax_p2e
from sheeprl_tpu.algos.p2e_dv3.p2e_dv3_finetuning import exploration_state_to_dv3 as jax_project
from sheeprl_tpu.algos.p2e_utils import ensemble_disagreement as jax_disagreement
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import P2EDV3Trainer, build_agent
from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning import exploration_state_to_dv3
from sheeprl_tpu_torch.algos.p2e_utils import ensemble_disagreement, p2e_optimizers
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.config.compose import ConfigError
from sheeprl_tpu_torch.convert import agent_state_from_jax
from tests.test_torch_train_step import B, H, L, family_params, family_parity, sgd_overrides

TINY = (
    "exp=p2e_dv3_exploration",
    "env=dummy", "env.sync_env=True",
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
SGD = sgd_overrides(("world_model", "actor", "critic", "ensembles"))

CASES = {
    # id: (env, pixels, kernel flag, optimizer overrides, U, counter0, extra)
    "discrete-pixels-fused": ("discrete_dummy", True, "fused_pallas", SGD, 1, 0, ()),
    "continuous-vector-flags-off": ("continuous_dummy", False, None, SGD, 1, 0, ()),
    "continuous-vector-fused": ("continuous_dummy", False, "fused_pallas", SGD, 1, 0, ()),
    "multidiscrete-use_pallas-U2": ("multidiscrete_dummy", False, "use_pallas", SGD, 2, 1,
                                    ("algo.critic.per_rank_target_network_update_freq=2",)),
    "discrete-vector-adam": ("discrete_dummy", False, None, (), 1, 0, ()),
}


def overrides(env_id, pixels, flag, opt=(), extra=()):
    keys = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"] if pixels else [
        "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]
    flags = [f"algo.world_model.recurrent_model.{flag}=True"] if flag else []
    return [*TINY, f"env.id={env_id}", *keys, *flags, *opt, *extra]


@pytest.mark.parametrize("case", list(CASES))
def test_exploration_update_matches_jax_train_phase(case):
    env_id, pixels, flag, opt, U, counter0, extra = CASES[case]
    trainer = family_parity(jax_p2e, jax_p2e.make_train_phase, jax_p2e.build_p2e_optimizers, build_agent,
                            P2EDV3Trainer, p2e_optimizers,
                            overrides(env_id, pixels, flag, opt, extra), pixels, U, counter0,
                            n_split=4, rollouts=(2, 3), adam=not opt)
    assert torch.isfinite(trainer.last_intrinsic)


def test_ensemble_disagreement_matches_jax():
    preds = np.random.default_rng(0).standard_normal((8, 5, 6, 7)).astype(np.float32)
    np.testing.assert_allclose(ensemble_disagreement(torch.from_numpy(preds), 2.5).numpy(),
                               np.asarray(jax_disagreement(jnp.asarray(preds), 2.5)), rtol=1e-6, atol=1e-7)


def _tree(cfg):
    jcfg = jax_compose(cfg)
    obs_space, action_space = jax_probe_spaces(jcfg)
    return jcfg, family_params(jax_p2e.build_agent, jcfg, jax_build_fabric(jcfg), obs_space, action_space)


@pytest.mark.parametrize("actor_type", ["task", "exploration"])
def test_exploration_state_to_dv3_matches_jax(actor_type):
    cfg = overrides("discrete_dummy", False, None)
    jcfg, tree = _tree(cfg)
    tree = jax.tree.map(np.array, tree)
    from sheeprl_tpu_torch.config.compose import compose

    pcfg = compose(cfg)
    port = exploration_state_to_dv3({"agent": agent_state_from_jax(tree, pcfg), "rb": "kept"}, actor_type)
    ref = jax_project({"agent": tree, "rb": "kept"}, actor_type)
    assert set(port) == set(ref) == {"agent", "rb"} and port["rb"] == "kept"
    expected = agent_state_from_jax(ref["agent"], pcfg)
    assert set(port["agent"]) == set(expected) == {"world_model", "actor", "critic", "target_critic", "moments"}
    for name, sd in expected.items():
        for k, v in sd.items():
            assert torch.equal(port["agent"][name][k], v), f"{name}.{k}"
    chosen = "actor_task" if actor_type == "task" else "actor"
    for k, v in agent_state_from_jax({**tree, "actor": tree[chosen]}, pcfg)["actor"].items():
        assert torch.equal(port["agent"]["actor"][k], v)
    # a snapshot without Moments gets the zero default
    no_moments = {k: v for k, v in tree.items() if k != "moments"}
    projected = exploration_state_to_dv3({"agent": agent_state_from_jax(no_moments, pcfg)}, actor_type)
    assert float(projected["agent"]["moments"]["low"]) == float(jax_project({"agent": no_moments})["agent"]["moments"]["low"]) == 0.0


CLI = [
    "env.id=discrete_dummy", "env.num_envs=2", "env.capture_video=False", "metric.log_level=1",
    "metric.log_every=1", "metric/logger=csv", "buffer.memmap=False", "buffer.checkpoint=True",
    "checkpoint.every=1000000", "checkpoint.async_save=False", "algo.learning_starts=0",
    "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "algo.world_model.discrete_size=4",
    "algo.world_model.recurrent_model.fused_pallas=True", "env.max_episode_steps=20", "buffer.size=200",
    "dry_run=True", "algo.run_test=False",
]


def test_cli_exploration_then_finetuning_then_evaluation(tmp_path, monkeypatch, capsys):
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    tiny = [c for c in TINY if not c.startswith("algo.world_model.discrete_size")]
    run([*tiny, *CLI, f"log_dir={tmp_path / 'explore'}"])
    (explore,) = glob.glob(f"{tmp_path / 'explore'}/**/checkpoint/step_*", recursive=True)
    state = load_step_dir(explore)
    assert state["grad_steps"] == 1
    agent = state["agent"]
    assert set(agent) == {"world_model", "actor", "critic", "target_critic", "moments", "actor_task", "ensembles",
                          "critics_exploration"}
    assert list(agent["critics_exploration"]) == ["intrinsic", "extrinsic"]
    assert agent["ensembles"]["ens.dense_0.kernel"].shape[0] == 8
    assert set(state["opt_state"]) == {"world_model", "actor", "actor_task", "critic", "ensembles",
                                       "critics_exploration.intrinsic", "critics_exploration.extrinsic"}

    # a resumed exploration run counts on from the saved state, the
    # exploration critics' Moments and optimizers included
    run([*tiny, *[c for c in CLI if c != "dry_run=True"], "algo.total_steps=48", f"log_dir={tmp_path / 'resume'}",
         f"checkpoint.resume_from={explore}"])
    (resumed,) = glob.glob(f"{tmp_path / 'resume'}/**/checkpoint/step_*", recursive=True)
    resumed = load_step_dir(resumed)
    assert resumed["grad_steps"] > state["grad_steps"]
    for name in state["opt_state"]:
        assert resumed["opt_state"][name]["state"][0]["step"].item() == resumed["grad_steps"], name
    for name, saved in agent["critics_exploration"].items():
        assert not torch.equal(resumed["agent"]["critics_exploration"][name]["moments"]["high"], saved["moments"]["high"])

    seen = {}
    init = dreamer_v3.DV3Trainer.__init__

    def spy(self, cfg, modules, *args, **kwargs):
        seen["actor"] = {k: v.clone() for k, v in modules["actor"].state_dict().items()}
        init(self, cfg, modules, *args, **kwargs)

    monkeypatch.setattr(dreamer_v3.DV3Trainer, "__init__", spy)
    finetune_cfg = [c.replace("p2e_dv3_exploration", "p2e_dv3_finetuning") for c in tiny]
    run([*finetune_cfg, *CLI, f"log_dir={tmp_path / 'finetune'}", f"checkpoint.exploration_ckpt_path={explore}",
         "buffer.load_from_exploration=True"])
    monkeypatch.undo()
    for k, v in agent["actor_task"].items():
        assert torch.equal(seen["actor"][k], v), k
    (finetune,) = glob.glob(f"{tmp_path / 'finetune'}/**/checkpoint/step_*", recursive=True)
    tuned = load_step_dir(finetune)
    assert set(tuned["agent"]) == {"world_model", "actor", "critic", "target_critic", "moments"}
    # the exploration buffer was carried over: its rows are in front of the new ones
    for old, new in zip(state["rb"]["buffers"], tuned["rb"]["buffers"]):
        pos = int(old["pos"])
        assert int(new["pos"]) > pos
        for key, rows in old["buffer"].items():
            assert torch.equal(new["buffer"][key][:pos], rows[:pos]), key

    for snapshot in (explore, finetune):
        reward = evaluation([f"checkpoint_path={snapshot}", "fabric.accelerator=cpu"])
        assert np.isfinite(reward)
    assert capsys.readouterr().out.count("Test/cumulative_reward:") == 2

    with pytest.raises(ConfigError, match="exploration_ckpt_path"):
        run([*finetune_cfg, *CLI, f"log_dir={tmp_path / 'none'}"])


def test_p2e_first_window_is_chunked_and_draws_per_update(tmp_path, monkeypatch):
    """The family loop chunks a long P2E window under the byte budget as it
    does DreamerV3's (the sampled block per update is the same), and each
    update draws its own noise, both rollouts' included."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    tiny = [c for c in TINY if not c.startswith("algo.world_model.discrete_size")]
    cli = [c for c in CLI if c not in ("dry_run=True", "algo.world_model.recurrent_model.fused_pallas=True")]
    per_update = (64 * 64 * 3 + 4 * 4 + 4 * (4 + 3)) * L * B  # rgb, state, actions, 3 scalars
    monkeypatch.setenv(dreamer_v3.WINDOW_BYTES_ENV, str(4 * per_update + 1))
    chunks, draws = [], []
    to_device, draw = dreamer_v3.blocks_to_device, dreamer_v3.draw_noise

    def spy_blocks(sample, *args):
        chunks.append(int(np.asarray(sample["rewards"]).shape[0]))
        return to_device(sample, *args)

    def spy_noise(*args):
        noise = draw(*args)
        draws.append(noise)
        return noise

    monkeypatch.setattr(dreamer_v3, "blocks_to_device", spy_blocks)
    monkeypatch.setattr(dreamer_v3, "draw_noise", spy_noise)
    run([*tiny, *cli, "algo.total_steps=20", "algo.replay_ratio=0.5", f"log_dir={tmp_path}"])
    # sequences of 8 can be sampled from policy step 18: 9 updates, then 1
    assert chunks == [4, 4, 1, 1]
    assert len(draws) == 10
    assert all(set(n) == {"posterior", "actions", "imagination", "actions_task", "imagination_task"}
               and n["posterior"].shape[0] == 1 and n["imagination_task"].shape[:2] == (1, H + 1) for n in draws)
