"""DreamerV3 training through the port's entry point, on the CPU: a dry run
through ``sheeprl_tpu_torch.cli.run`` on the tiny recipe of
``tests/test_algos/test_algos.py``, a resume from its snapshot, the snapshot
served by ``load_policy``, and the settings the port does not implement yet."""

import csv
import glob
import math

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.checkpoint.protocol import latest_checkpoint, load_step_dir
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.serve.loader import load_policy

TINY = [
    "exp=dreamer_v3",
    "env=dummy",
    "env.id=discrete_dummy",
    "algo=dreamer_v3_XS",
    "env.num_envs=2",
    "env.capture_video=False",
    "fabric.accelerator=cpu",
    "metric.log_level=1",
    "metric.log_every=1",
    "metric/logger=csv",
    "buffer.memmap=False",
    "buffer.checkpoint=True",
    "checkpoint.every=1000000",
    "checkpoint.async_save=False",
    "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=8",
    "algo.learning_starts=0",
    "algo.horizon=4",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "algo.world_model.encoder.cnn_channels_multiplier=4",
    "algo.dense_units=16",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.replay_ratio=1",
    "algo.world_model.discrete_size=4",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.recurrent_model.fused_pallas=True",
    "env.max_episode_steps=20",
    "buffer.size=200",
]
LOSSES = ("Loss/world_model_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
          "Loss/continue_loss", "State/kl", "Loss/policy_loss", "Loss/value_loss", "State/post_entropy",
          "State/prior_entropy")


def _snapshots(log_dir):
    return sorted(glob.glob(f"{log_dir}/**/checkpoint/step_*", recursive=True))


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """One dry run: 20 iterations of 2 envs, then one update; a committed snapshot."""
    log_dir = tmp_path_factory.mktemp("train") / "logs"
    run([*TINY, "dry_run=True", "algo.run_test=True", f"log_dir={log_dir}"])
    (snapshot,) = _snapshots(log_dir)
    return log_dir, snapshot


def test_dry_run_trains_logs_and_commits(dry_run):
    log_dir, snapshot = dry_run
    assert snapshot.endswith("step_000000000040")
    state = load_step_dir(snapshot)
    assert state["update"] == 20 and state["policy_step"] == 40 and state["grad_steps"] == 1
    assert set(state["agent"]) == {"world_model", "actor", "critic", "target_critic", "moments"}
    assert state["opt_state"]["world_model"]["state"][0]["step"].item() == 1
    with open(glob.glob(f"{log_dir}/**/metrics.csv", recursive=True)[0]) as f:
        rows = {name: float(value) for step, name, value in list(csv.reader(f))[1:]}
    assert all(math.isfinite(rows[name]) for name in LOSSES)
    assert rows["Health/skipped"] == 0.0


def test_resume_restores_counters_ratio_buffer_and_optimizer(dry_run, tmp_path):
    _, snapshot = dry_run
    saved = load_step_dir(snapshot)
    log_dir = tmp_path / "logs"
    run([*TINY, "dry_run=False", "algo.run_test=False", "algo.total_steps=48", f"log_dir={log_dir}",
         f"checkpoint.resume_from={snapshot}"])
    (resumed,) = _snapshots(log_dir)
    state = load_step_dir(resumed)
    # the loop went on from update 21 at policy step 42, with the saved Ratio
    assert state["update"] == 24 and state["policy_step"] == 48
    new_steps = state["grad_steps"] - saved["grad_steps"]
    assert new_steps == 48 - saved["ratio"]["prev"] and state["ratio"]["prev"] == 48
    assert state["psync"]["windows"] == saved["psync"]["windows"] + 4
    # the optimizers counted on from the saved state
    for name in ("world_model", "actor", "critic"):
        assert state["opt_state"][name]["state"][0]["step"].item() == saved["grad_steps"] + new_steps
    # the saved replay rows came back in front of the new ones
    for old, new in zip(saved["rb"]["buffers"], state["rb"]["buffers"]):
        pos = int(old["pos"])
        for key, rows in old["buffer"].items():
            assert torch.equal(new["buffer"][key][:pos], rows[:pos]), key
        assert int(new["pos"]) > pos


def test_committed_snapshot_serves_one_step(dry_run):
    _, snapshot = dry_run
    _, cfg, _, player = load_policy(snapshot, ["fabric.accelerator=cpu"])
    assert player.device.type == "cpu" and player.checkpoint_step == 40
    obs = player.prepare({"rgb": np.zeros((1, 64, 64, 3), np.uint8), "state": np.zeros((1, 4), np.float32)})
    carry, actions = player.step_batch(player.params, player.zero_carry(1), obs, 0, np.array([True]))
    assert np.isfinite(carry[0]).all()
    action = player.postprocess(actions)
    assert action.shape == (1,) and 0 <= int(action[0]) < 4


def test_committed_snapshot_evaluates_through_the_cli(dry_run, monkeypatch, capsys):
    """``cli.evaluation`` plays a DreamerV3 snapshot with the latent player
    of the whole Dreamer family (one greedy episode)."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    _, snapshot = dry_run
    steps, step = [], dreamer_v3.latent_player_step

    def spy(*args, **kwargs):
        steps.append(kwargs.get("greedy", args[-1] if len(args) > 5 else False))
        return step(*args, **kwargs)

    monkeypatch.setattr(dreamer_v3, "latent_player_step", spy)
    reward = evaluation([f"checkpoint_path={snapshot}", "fabric.accelerator=cpu"])
    assert np.isfinite(reward)
    assert f"Test/cumulative_reward: {reward}" in capsys.readouterr().out
    # the dummy env's episode is max_episode_steps long, every step greedy
    assert len(steps) == 20 and all(steps)


@pytest.mark.parametrize(
    "override,item",
    [
        ("pipeline.stages=2", "queue A item 5"),
        ("algo.remat=True", "queue A item 5"),
        ("pipeline.imagination_microbatches=2", "queue A item 5"),
    ],
)
def test_unported_settings_raise_naming_the_roadmap_item(tmp_path, override, item):
    extra = ["pipeline.microbatches=2"] if override.startswith("pipeline.stages") else []
    with pytest.raises(NotImplementedError, match=item):
        run([*TINY, "dry_run=True", f"log_dir={tmp_path}", override, *extra])
    assert latest_checkpoint(tmp_path) is None


def _tiny_trainer():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    cfg = compose(TINY)
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    modules = build_agent(fabric, dims, cont, cfg, obs_space)
    return cfg, DV3Trainer(cfg, modules, build_dv3_optimizers(cfg, modules), ("rgb",), ("state",), cont), dims


def _tiny_window(trainer, dims, U=1, L=8, B=2, nan_reward=False):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import blocks_to_device, draw_noise

    rng = np.random.default_rng(0)
    block = {
        "rgb": rng.integers(0, 256, (U, L, B, 64, 64, 3), dtype=np.uint8),
        "state": rng.standard_normal((U, L, B, 4)).astype(np.float32),
        "actions": np.eye(dims[0], dtype=np.float32)[rng.integers(0, dims[0], (U, L, B))],
        "rewards": rng.standard_normal((U, L, B, 1)).astype(np.float32),
        "terminated": np.zeros((U, L, B, 1), np.float32),
        "is_first": np.zeros((U, L, B, 1), np.float32),
    }
    if nan_reward:
        block["rewards"][0, 3, 1] = np.nan
    noise = draw_noise(trainer.world_model, trainer.actor, U, L, B, trainer.horizon, torch.Generator().manual_seed(0))
    return blocks_to_device(block, ("rgb",), ("state",), "cpu"), noise


def test_restore_leaves_the_snapshot_intact():
    """Two updates from one restored snapshot are identical (the optimizer
    must not keep, and then advance, the snapshot's own tensors)."""
    _, trainer, dims = _tiny_trainer()
    blocks, noise = _tiny_window(trainer, dims)
    start = trainer.snapshot()
    runs = []
    for _ in range(3):
        trainer.restore(start)
        runs.append(torch.stack(trainer.train_phase(blocks, noise, 0)))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[1], runs[2])


def test_health_guard_undoes_a_non_finite_window():
    """The guard inside the window skips a window whose loss is not finite:
    the trained tensors and the optimizers' state stay bit for bit as they
    were; the next, finite window stands."""
    from sheeprl_tpu_torch.resilience.health import HealthSentinel

    cfg, trainer, dims = _tiny_trainer()
    sentinel = HealthSentinel.from_config(cfg)
    window = sentinel.wrap(lambda blocks, noise, c: (c + 1, trainer.train_phase(blocks, noise, c)),
                           trainer.guarded_state, "cpu")
    trainer.guarded_state()
    before = trainer.snapshot()
    blocks, noise = _tiny_window(trainer, dims, nan_reward=True)
    window(blocks, noise, 0)
    for name, module in trainer.modules().items():
        for k, v in module.state_dict().items():
            assert torch.equal(v, before["agent"][name][k]), f"{name}.{k}"
    for name, opt in trainer.optimizers.items():
        for i, st in opt.state_dict()["state"].items():
            assert all(torch.equal(v, before["opt"][name]["state"][i][k]) for k, v in st.items()), f"{name}[{i}]"
    blocks, noise = _tiny_window(trainer, dims)
    window(blocks, noise, 1)
    assert sentinel.poll(0) == "none"
    assert sentinel.metrics()["Health/skipped"] == 1.0 and sentinel.metrics()["Health/applied"] == 1.0
    assert not torch.equal(trainer.world_model.state_dict()[next(iter(before["agent"]["world_model"]))],
                           next(iter(before["agent"]["world_model"].values())))


def test_divergence_rollback_is_not_ported_yet():
    """Rollback is ported now: ``health.divergence.action=rollback`` builds,
    and a diverged window makes ``poll`` ask for the rollback (the loops'
    side is in ``tests/test_torch_health.py``)."""
    from sheeprl_tpu_torch.resilience.health import HealthSentinel

    sentinel = HealthSentinel({"divergence": {"action": "rollback"}, "min_windows": 1, "patience": 1})
    window = sentinel.wrap(lambda loss: (None, [torch.tensor(loss)]), lambda: ([], []), "cpu")
    for loss in (1.0, 1.0, 1e6):
        window(loss)
    assert sentinel.poll(0) == "rollback"
    with pytest.raises(ValueError, match="none|rollback"):
        HealthSentinel({"divergence": {"action": "restart"}})


def _noise_bytes(noise):
    return sum(t.numel() * t.element_size() for t in (noise["posterior"], noise["imagination"], *noise["actions"]))


@pytest.mark.parametrize("U", [1, 5])
def test_each_update_draws_its_own_noise(monkeypatch, U):
    """Given a generator, the window draws one update's noise at a time (so
    the noise held at once does not grow with U), and the result is the
    window run on the same draws handed in whole."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    _, trainer, dims = _tiny_trainer()
    blocks, _ = _tiny_window(trainer, dims, U=U)
    L, B = blocks["rewards"].shape[1:]
    one = dreamer_v3.draw_noise(trainer.world_model, trainer.actor, 1, L, B, trainer.horizon,
                                torch.Generator().manual_seed(3))
    drawn = []
    draw = dreamer_v3.draw_noise

    def spy(*args):
        noise = draw(*args)
        drawn.append(noise)
        return noise

    monkeypatch.setattr(dreamer_v3, "draw_noise", spy)
    start = trainer.snapshot()
    by_update = torch.stack(trainer.train_phase(blocks, torch.Generator().manual_seed(3), 0))
    monkeypatch.undo()
    assert len(drawn) == U
    assert all(n["posterior"].shape[0] == 1 and _noise_bytes(n) == _noise_bytes(one) for n in drawn)
    whole = {"posterior": torch.cat([n["posterior"] for n in drawn]),
             "actions": [torch.cat(a) for a in zip(*(n["actions"] for n in drawn))],
             "imagination": torch.cat([n["imagination"] for n in drawn])}
    trainer.restore(start)
    assert torch.equal(torch.stack(trainer.train_phase(blocks, whole, 0)), by_update)


@pytest.mark.parametrize(
    "n,per_update,budget,chunks",
    [
        (1024, 12 << 20, 2 << 30, [170] * 6 + [4]),  # an XL first window: 12 MiB a block
        (18, 100, 500, [5, 5, 5, 3]),
        (3, 100, 10_000, [3]),
        (4, 100, 50, [1, 1, 1, 1]),  # a block larger than the budget still runs, alone
        (0, 100, 500, []),
    ],
)
def test_window_chunks(n, per_update, budget, chunks):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import window_chunks

    assert window_chunks(n, per_update, budget) == chunks


def test_long_first_window_is_sampled_in_chunks(monkeypatch, tmp_path):
    """The first window repays every prefill step at once (9 updates here);
    the loop samples, moves and guards it in chunks under the byte budget,
    and every update draws its own noise.  The run also warns of the
    settings it does not act on."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    per_update = (64 * 64 * 3 + 4 * 4 + 4 * (4 + 3)) * 8 * 2  # rgb, state, actions, 3 scalars; L 8, B 2
    monkeypatch.setenv(dreamer_v3.WINDOW_BYTES_ENV, str(4 * per_update + 1))
    chunks, noise_u = [], []
    to_device, draw = dreamer_v3.blocks_to_device, dreamer_v3.draw_noise

    def spy_blocks(sample, *args):
        chunks.append(int(np.asarray(sample["rewards"]).shape[0]))
        return to_device(sample, *args)

    def spy_noise(wm, actor, U, *args):
        noise_u.append(U)
        return draw(wm, actor, U, *args)

    monkeypatch.setattr(dreamer_v3, "blocks_to_device", spy_blocks)
    monkeypatch.setattr(dreamer_v3, "draw_noise", spy_noise)
    with pytest.warns(UserWarning, match="model_manager.disabled=False.*queue A item 6"):
        run([*TINY, "algo.run_test=False", "algo.total_steps=20", "algo.replay_ratio=0.5",
             "model_manager.disabled=False", f"log_dir={tmp_path}"])
    # sequences of 8 can be sampled from policy step 18: 9 updates, then 1
    assert chunks == [4, 4, 1, 1]
    assert noise_u == [1] * 10
    state = load_step_dir(_snapshots(tmp_path)[-1])
    assert state["grad_steps"] == 10 and state["psync"]["windows"] == 2


# -- the on-policy algorithms through the same entry points -----------------------
ON_POLICY_COMMON = ["env=dummy", "fabric.accelerator=cpu", "metric.log_level=1", "metric.log_every=1",
                    "metric/logger=csv", "buffer.memmap=False", "checkpoint.every=1000000",
                    "checkpoint.async_save=False", "env.num_envs=2", "env.max_episode_steps=12",
                    "algo.rollout_steps=8", "algo.per_rank_batch_size=6", "algo.dense_units=8", "algo.mlp_layers=1"]
ON_POLICY = {
    "ppo": ["exp=ppo", "env.id=discrete_dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
            "algo.encoder.cnn_features_dim=16", "algo.update_epochs=2", "algo.anneal_lr=True",
            "algo.anneal_clip_coef=True", "algo.anneal_ent_coef=True", "algo.ent_coef=0.01"],
    "a2c": ["exp=a2c", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]", "algo.anneal_lr=True"],
    "ppo_recurrent": ["exp=ppo_recurrent", "env.id=multidiscrete_dummy", "env.mask_velocities=False",
                      "algo.mlp_keys.encoder=[state]", "algo.rnn.lstm.hidden_size=8", "algo.update_epochs=2",
                      "algo.anneal_lr=True"],
}
ON_POLICY_LOSSES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")


@pytest.mark.parametrize("exp", list(ON_POLICY))
def test_on_policy_run_commits_resumes_and_evaluates(exp, tmp_path, capsys):
    """A dry run (one iteration of 8 steps x 2 envs), a resume from its
    snapshot for two more iterations with the schedules annealing, and
    ``cli.evaluation`` of the result."""
    first = tmp_path / "first"
    run([f"exp={exp}", *ON_POLICY_COMMON, *ON_POLICY[exp][1:], "dry_run=True", "algo.run_test=True",
         f"log_dir={first}"])
    (snapshot,) = _snapshots(first)
    state = load_step_dir(snapshot)
    assert state["update"] == 1 and state["policy_step"] == 16
    assert set(state["generators"]) == {"train", "player"}
    with open(glob.glob(f"{first}/**/metrics.csv", recursive=True)[0]) as f:
        rows = {name: float(value) for step, name, value in list(csv.reader(f))[1:]}
    assert all(math.isfinite(rows[name]) for name in ON_POLICY_LOSSES) and "Test/cumulative_reward" in rows
    # optimizer steps per update: epochs x minibatches (PPO: 16 rows in 3 of 6, the
    # recurrent one: 2 env columns one at a time); A2C's RMSprop counts none
    steps_per_update = {"ppo": 2 * 3, "a2c": None, "ppo_recurrent": 2 * 2}[exp]
    if steps_per_update:
        assert state["opt_state"]["state"][0]["step"].item() == steps_per_update
    else:
        assert set(state["opt_state"]["state"][0]) == {"square_avg"}

    resumed_dir = tmp_path / "resumed"
    run([f"exp={exp}", *ON_POLICY_COMMON, *ON_POLICY[exp][1:], "algo.total_steps=48", "algo.run_test=False",
         f"checkpoint.resume_from={snapshot}", f"log_dir={resumed_dir}"])
    (resumed,) = _snapshots(resumed_dir)
    after = load_step_dir(resumed)
    assert after["update"] == 3 and after["policy_step"] == 48
    if steps_per_update:
        assert after["opt_state"]["state"][0]["step"].item() == 3 * steps_per_update
    # anneal_lr: polynomial decay to 0 at the last of 3 iterations
    assert after["opt_state"]["param_groups"][0]["lr"] == 0.0
    assert not torch.equal(after["generators"]["player"], state["generators"]["player"])

    reward = evaluation([f"checkpoint_path={resumed}", "fabric.accelerator=cpu"])
    assert math.isfinite(reward) and f"Test/cumulative_reward: {reward}" in capsys.readouterr().out


def test_ppo_snapshot_is_served_by_policy_service(tmp_path):
    import threading

    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.server import PolicyServer
    from sheeprl_tpu_torch.serve.service import PolicyService

    run([*ON_POLICY["ppo"][:1], *ON_POLICY_COMMON, *ON_POLICY["ppo"][1:], "dry_run=True", "algo.run_test=False",
         f"log_dir={tmp_path}"])
    service = PolicyService.from_checkpoint(_snapshots(tmp_path)[0], ["serve.batch_ladder=[1,4]", "serve.max_wait_ms=2",
                                                       "fabric.accelerator=cpu"])
    assert service.player.algo == "ppo" and not service.player.stateful
    with PolicyServer(service, port=0) as server:
        client = PolicyClient(server.url, packed=True)
        assert not client.health()["stateful"]
        errors = []

        def play(i):
            rng = np.random.default_rng(i)
            try:
                for step in range(3):
                    obs = {"rgb": rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
                           "state": rng.standard_normal(4).astype(np.float32)}
                    action = client.act(obs, session=f"s{i}", greedy=(i + step) % 2 == 0)
                    assert action.shape == () and 0 <= int(action) < 4
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=play, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors and not any(t.is_alive() for t in threads)
        assert client.stats()["served"] == 12


@pytest.mark.parametrize("override,error,match", [
    # the Anakin path is ported: forcing it on a host env raises as in JAX
    ("algo.anakin=True", ValueError, "algo.anakin=True requires a device env"),
    ("population.size=2", NotImplementedError, "queue A item 6"),
], ids=["algo.anakin=True", "population.size=2"])
def test_on_policy_unported_paths_raise_naming_the_roadmap_item(tmp_path, override, error, match):
    with pytest.raises(error, match=match):
        run([*ON_POLICY["ppo"][:1], *ON_POLICY_COMMON, *ON_POLICY["ppo"][1:], "dry_run=True",
             f"log_dir={tmp_path}", override])
    assert latest_checkpoint(tmp_path) is None


@pytest.mark.parametrize("exp,checks", [
    ("ppo", {"rollout_steps": 128, "per_rank_batch_size": 64, "optimizer.name": "adam"}),
    ("ppo_atari", {"rollout_steps": 1024, "per_rank_batch_size": 256, "update_epochs": 3, "dense_units": 512,
                   "optimizer.name": "adam", "parameters": 4_597_925}),
    ("a2c", {"rollout_steps": 128, "optimizer.name": "rmsprop"}),
    ("a2c_atari", {"rollout_steps": 40, "optimizer.name": "rmsprop", "parameters": 4_597_925}),
    ("ppo_recurrent", {"rollout_steps": 128, "optimizer.name": "adamw"}),
])
def test_on_policy_recipes_compose_with_the_dummy_env(exp, checks):
    """Each recipe composes with ``env=dummy`` (84x84 frames stacked 4 times
    for the Atari ones) and builds its agent; the Atari-width agent has the
    parameter count the card runs."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent as build_recurrent
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    extra = {"ppo": ["algo.mlp_keys.encoder=[state]"], "a2c": ["algo.mlp_keys.encoder=[state]"],
             "ppo_recurrent": ["env.mask_velocities=False"]}.get(exp, ["env.screen_size=84",
                                                                      "env.wrapper.image_size=[84,84,3]"])
    cfg = compose([f"exp={exp}", "env=dummy", "fabric.accelerator=cpu", *extra])
    obs_space, act_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(act_space)
    agent = (build_recurrent if exp == "ppo_recurrent" else build_agent)(build_fabric(cfg), dims, cont, cfg, obs_space)
    got = {**{k: cfg.algo.get(k) for k in checks}, "parameters": sum(p.numel() for p in agent.parameters()),
           "optimizer.name": cfg.algo.optimizer.name}
    assert {k: got[k] for k in checks} == checks
    if exp.endswith("atari"):
        assert obs_space["rgb"].shape == (4, 84, 84, 3) and cfg.algo.cnn_keys.encoder == ["rgb"]


# -- the off-policy algorithms through the same entry points ----------------------
OFF_POLICY_COMMON = ["env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "metric.log_level=1",
                     "metric.log_every=1", "metric/logger=csv", "buffer.memmap=False", "buffer.size=64",
                     "checkpoint.every=1000000", "checkpoint.async_save=False", "env.num_envs=2",
                     "env.max_episode_steps=5", "algo.per_rank_batch_size=4", "algo.hidden_size=8",
                     "algo.learning_starts=8"]
OFF_POLICY = {
    # exp: (overrides, replay ratio, loss names)
    "sac": (["algo.mlp_keys.encoder=[state]"], 1, 3),
    "droq": (["algo.mlp_keys.encoder=[state]", "algo.replay_ratio=3"], 3, 3),
    "sac_ae": (["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]", "env.screen_size=16",
                "env.wrapper.image_size=[16,16,3]", "algo.encoder.features_dim=4", "algo.cnn_channels_multiplier=2",
                "algo.dense_units=4"], 1, 4),
}


@pytest.mark.parametrize("exp", list(OFF_POLICY))
def test_off_policy_run_commits_resumes_with_its_buffer_and_evaluates(exp, tmp_path, capsys):
    """8 iterations of 2 envs (a random prefill of 4, then the Ratio's
    updates), a snapshot with the replay buffer; a resume from it for 8
    more iterations that continues the buffer, the counters and the
    optimizers (as in JAX, the resumed run plays ``learning_starts``
    iterations with its actor before it trains again, and the Ratio then
    repays them); ``cli.evaluation`` of the result."""
    overrides, ratio, n_losses = OFF_POLICY[exp]
    first = tmp_path / "first"
    run([f"exp={exp}", *OFF_POLICY_COMMON, *overrides, "algo.total_steps=16", "algo.run_test=True",
         f"log_dir={first}"])
    (snapshot,) = _snapshots(first)
    state = load_step_dir(snapshot)
    assert state["update"] == 8 and state["policy_step"] == 16 and state["grad_steps"] == 16 * ratio
    assert state["rb"]["pos"] == 8 and state["pending_gradient_steps"] == 0
    assert set(state["generators"]) == {"train", "player"} and state["psync"]["windows"] == 5
    assert state["opt_state"]["critic"]["state"][0]["step"].item() == 16 * ratio
    with open(glob.glob(f"{first}/**/metrics.csv", recursive=True)[0]) as f:
        rows = {name: float(value) for step, name, value in list(csv.reader(f))[1:]}
    losses = [n for n in rows if n.startswith("Loss/")]
    assert len(losses) == n_losses and all(math.isfinite(rows[n]) for n in losses)
    assert "Test/cumulative_reward" in rows

    resumed_dir = tmp_path / "resumed"
    run([f"exp={exp}", *OFF_POLICY_COMMON, *overrides, "algo.total_steps=32", "algo.run_test=False",
         f"checkpoint.resume_from={snapshot}", f"log_dir={resumed_dir}"])
    (resumed,) = _snapshots(resumed_dir)
    after = load_step_dir(resumed)
    # the buffer continued: 16 steps written, not 8 after an empty start
    assert after["update"] == 16 and after["policy_step"] == 32 and after["rb"]["pos"] == 16
    assert after["grad_steps"] == 32 * ratio
    assert after["opt_state"]["critic"]["state"][0]["step"].item() == 32 * ratio
    assert not torch.equal(after["generators"]["train"], state["generators"]["train"])

    reward = evaluation([f"checkpoint_path={resumed}", "fabric.accelerator=cpu"])
    assert math.isfinite(reward) and f"Test/cumulative_reward: {reward}" in capsys.readouterr().out


@pytest.mark.parametrize("exp,override,item", [
    ("sac", "fabric.decoupled=True", "queue A item 5"),
    ("sac_decoupled", None, "queue A item 5"),
])
def test_off_policy_unported_paths_raise_naming_the_roadmap_item(tmp_path, exp, override, item):
    with pytest.raises(NotImplementedError, match=item):
        run([f"exp={exp}", *OFF_POLICY_COMMON, "dry_run=True", f"log_dir={tmp_path}", *([override] if override else [])])
    assert latest_checkpoint(tmp_path) is None


@pytest.mark.parametrize("exp,checks", [
    ("sac", {"per_rank_batch_size": 256, "replay_ratio": 1.0, "critic.n": 2, "parameters": 203_783}),
    ("droq", {"per_rank_batch_size": 256, "replay_ratio": 20.0, "critic.dropout": 0.01, "parameters": 205_831}),
    ("sac_ae", {"per_rank_batch_size": 128, "hidden_size": 1024, "actor.per_rank_update_freq": 2,
                "decoder.per_rank_update_freq": 1, "learning_starts": 1000}),
])
def test_off_policy_recipes_compose_with_the_dummy_env(exp, checks):
    """Each recipe composes with ``env=dummy`` on ``continuous_dummy`` and
    builds its agent at the recipe's widths."""
    from sheeprl_tpu_torch.algos.droq.agent import build_agent as droq_agent
    from sheeprl_tpu_torch.algos.sac.agent import build_agent as sac_agent
    from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent as sac_ae_agent
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    cfg = compose([f"exp={exp}", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu"])
    obs_space, act_space = probe_spaces(cfg)
    fabric = build_fabric(cfg)
    if exp == "sac_ae":
        agent = sac_ae_agent(fabric, 2, cfg, obs_space)
        assert obs_space["rgb"].shape == (64, 64, 3) and agent.decoder.stem == (8, 8, 64)
    else:
        agent = {"sac": sac_agent, "droq": droq_agent}[exp](fabric, 2, cfg, 4)
    trained = sum(p.numel() for n, p in agent.named_parameters() if not n.startswith("target_"))
    got = {k: cfg.algo[k.split(".")[0]][k.split(".")[1]] if "." in k else cfg.algo.get(k) for k in checks}
    got["parameters"] = trained
    assert {k: got[k] for k in checks} == checks


# -- the device envs (env=jax_*) through the same entry points ---------------------
DEVICE_ENV_COMMON = ["fabric.accelerator=cpu", "metric.log_level=1", "metric.log_every=1", "metric/logger=csv",
                     "buffer.memmap=False", "checkpoint.every=1000000", "checkpoint.async_save=False",
                     "env.num_envs=2", "algo.run_test=True"]
DEVICE_ENV_RUNS = {
    # id: (overrides, the path the banner names)
    # under the strict compile-once budget: one rollout and one update signature
    "ppo-cartpole": (["exp=ppo", "env=jax_cartpole", "algo.rollout_steps=8", "algo.per_rank_batch_size=8",
                      "algo.dense_units=8", "algo.mlp_layers=1", "env.max_episode_steps=6", "algo.total_steps=32",
                      "algo.anneal_lr=True", "algo.anneal_ent_coef=True", "algo.ent_coef=0.01",
                      "algo.max_recompiles=0"], "Anakin"),
    "a2c-cartpole": (["exp=a2c", "env=jax_cartpole", "algo.rollout_steps=8", "algo.dense_units=8",
                      "algo.mlp_layers=1", "env.max_episode_steps=6", "algo.total_steps=32"], "Anakin"),
    "ppo_recurrent-cartpole": (["exp=ppo_recurrent", "env=jax_cartpole", "env.mask_velocities=False",
                                "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.dense_units=8",
                                "algo.rnn.lstm.hidden_size=8", "env.max_episode_steps=6", "algo.total_steps=32"],
                               "Anakin"),
    "ppo-forage-adapter": (["exp=ppo", "env=jax_forage", "algo.anakin=False", "algo.rollout_steps=4",
                            "algo.per_rank_batch_size=8", "algo.dense_units=8", "algo.mlp_layers=1",
                            "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]",
                            "algo.encoder.cnn_features_dim=16", "env.max_episode_steps=6", "algo.total_steps=16"],
                           "stepped synchronously"),
    "dreamer_v3-forage": ([*[o for o in TINY if not o.startswith(("env", "algo.mlp_keys"))], "env=jax_forage",
                           "env.num_envs=2", "algo.mlp_keys.encoder=[]", "env.max_episode_steps=20", "dry_run=True"],
                          "replay"),
    "sac-pendulum": (["exp=sac", "env=jax_pendulum", "buffer.size=32", "algo.total_steps=16",
                      "algo.learning_starts=4", "algo.per_rank_batch_size=4", "algo.hidden_size=8",
                      "env.max_episode_steps=6"], "replay"),
}


@pytest.mark.parametrize("case", list(DEVICE_ENV_RUNS))
def test_device_env_run_commits_and_evaluates(case, tmp_path, capsys):
    """The device envs train through ``cli.run``: PPO, A2C and recurrent PPO
    on the Anakin rollout (auto on ``env=jax_*``), PPO with ``algo.anakin=False``,
    DreamerV3 (the fused RSSM layout; its encoder on the ``rgb`` key alone) and
    SAC through the adapter; the losses are finite, a test episode ran, an
    Anakin run resumes from its snapshot, and ``cli.evaluation`` plays the
    snapshot."""
    overrides, path = DEVICE_ENV_RUNS[case]
    run([*DEVICE_ENV_COMMON, *overrides, f"log_dir={tmp_path}"])
    banner = capsys.readouterr().out
    assert path in banner, banner
    (snapshot,) = _snapshots(tmp_path)
    with open(glob.glob(f"{tmp_path}/**/metrics.csv", recursive=True)[0]) as f:
        rows = {name: float(value) for step, name, value in list(csv.reader(f))[1:]}
    losses = [n for n in rows if n.startswith("Loss/")]
    assert losses and all(math.isfinite(rows[n]) for n in losses)
    assert "Test/cumulative_reward" in rows
    if path == "Anakin":
        # a resume goes on with the update counter and all three generators (the envs' among them)
        state = load_step_dir(snapshot)
        assert "Rewards/rew_avg" in rows and state["policy_step"] == 32 and state["update"] == 2
        assert set(state["generators"]) == {"train", "player", "env"}
        run([*DEVICE_ENV_COMMON, *overrides, "algo.total_steps=64", "algo.run_test=False",
             f"checkpoint.resume_from={snapshot}", f"log_dir={tmp_path / 'resumed'}"])
        (snapshot,) = _snapshots(tmp_path / "resumed")
        after = load_step_dir(snapshot)
        assert after["update"] == 4 and after["policy_step"] == 64
        assert not torch.equal(after["generators"]["env"], state["generators"]["env"])
    reward = evaluation([f"checkpoint_path={snapshot}", "fabric.accelerator=cpu"])
    assert math.isfinite(reward)


@pytest.mark.parametrize("overrides,setting", [
    # the recurrent recipe masks velocities by default: on the Anakin rollout that raises
    (["exp=ppo_recurrent", "env=jax_cartpole"], "env.mask_velocities"),
    (["exp=ppo", "env=jax_cartpole", "env.clip_rewards=True"], "env.clip_rewards"),
    (["exp=a2c", "env=jax_cartpole", "env.action_repeat=2"], "env.action_repeat"),
    (["exp=ppo", "env=jax_cartpole", "env.reward_as_observation=True"], "env.reward_as_observation"),
    (["exp=ppo", "env=jax_cartpole", "env.actions_as_observation.num_stack=2"], "env.actions_as_observation"),
    (["exp=ppo_atari", "env=jax_forage"], "env.frame_stack"),
    (["exp=ppo", "env=jax_forage", "env.screen_size=84"], "env.screen_size"),
    (["exp=ppo", "env=jax_forage", "env.grayscale=True"], "env.grayscale"),
], ids=["recurrent-mask_velocities", "clip_rewards", "action_repeat", "reward_as_observation",
        "actions_as_observation", "frame_stack", "screen_size", "grayscale"])
def test_anakin_refuses_the_wrapper_settings_it_does_not_apply(tmp_path, overrides, setting):
    """The Anakin rollout steps the bare device env: a wrapper setting that
    would change it raises, naming the setting, before the run writes a
    snapshot."""
    with pytest.raises(NotImplementedError, match=setting):
        run([*DEVICE_ENV_COMMON, *overrides, "dry_run=True", f"log_dir={tmp_path}"])
    assert latest_checkpoint(tmp_path) is None

def test_ppo_atari_recipe_sees_four_gray_channels():
    """``exp=ppo_atari`` on forage resized to 84x84, gray and stacked 4 times:
    the CNN's first convolution takes Atari's 4 channels of 84x84."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    cfg = compose(["exp=ppo_atari", "env=jax_forage", "env.screen_size=84", "env.grayscale=True",
                   "env.frame_stack=4", "algo.anakin=False", "fabric.accelerator=cpu"])
    obs_space, act_space = probe_spaces(cfg)
    assert obs_space["rgb"].shape == (4, 84, 84, 1)
    agent = build_agent(build_fabric(cfg), *spaces_to_dims(act_space), cfg, obs_space)
    first = next(m for m in agent.modules() if isinstance(m, torch.nn.Conv2d))
    assert first.in_channels == 4
    with torch.no_grad():
        out, value = agent({"rgb": torch.zeros(2, 84, 84, 4)})
    assert out.shape == (2, 5) and value.shape == (2, 1)
