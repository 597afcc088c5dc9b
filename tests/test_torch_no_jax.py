"""The port runs with JAX absent: in a fresh interpreter whose import system
refuses ``jax``, ``flax``, ``optax`` and ``sheeprl_tpu``, every module of
``sheeprl_tpu_torch`` imports (every algorithm of the Dreamer family among
them, and PPO, A2C and recurrent PPO, the compile-once layer:
``parallel/compile.py``, ``telemetry/monitors.py``, ``utils/profiler.py``,
whose ``GraphFunction`` audits a probe on the CPU, and the runtime services:
``checkpoint/{preemption,rollback}.py``, ``resilience/{retry,faults,health}.py``,
and the telemetry subsystem and hot reload: ``telemetry/{hub,recorder,spans,
tracer,introspect}.py``, ``serve/reload.py``), a DreamerV3 player takes one CPU
step, a tiny dry run through ``cli.run`` (introspection endpoint armed) trains
one update, logs ``Phase/*`` and commits a snapshot, one Plan2Explore-DreamerV3 update steps, PPO, A2C and recurrent
PPO each train one iteration through ``cli.run`` and commit a snapshot that
``cli.evaluation`` plays and, for PPO, a player serves, and SAC, DroQ and
SAC-AE each train through ``cli.run`` and commit a snapshot that
``cli.evaluation`` plays and, for SAC, a player serves, PPO trains one
Anakin iteration on the device cartpole, the other device envs step, and
SAC and DreamerV3 train from the device-resident replay (forced on, the
guard armed) whose spill tier round-trips a checkpoint.

A subprocess, because the test session has imported JAX already.
"""

import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys
    sys.path.insert(0, {root!r})

    BLOCKED = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked: the port must not import it")
            return None

    sys.meta_path.insert(0, Refuse())

    import numpy as np
    import sheeprl_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    for name in ("parallel.compile", "telemetry.monitors", "utils.profiler", "checkpoint.preemption",
                 "checkpoint.rollback", "resilience.retry", "resilience.faults", "resilience.health",
                 "telemetry.hub", "telemetry.recorder", "telemetry.spans", "telemetry.tracer",
                 "telemetry.introspect", "serve.reload"):
        assert "sheeprl_tpu_torch." + name in names, name

    import torch
    from sheeprl_tpu_torch.parallel.compile import GraphFunction
    from sheeprl_tpu_torch.utils.profiler import COMPILE_MONITOR, RecompileLimitExceeded
    probe = GraphFunction(lambda x: x + 1, name="no_jax.probe", max_recompiles=0)
    assert torch.equal(probe(torch.zeros(2)), torch.ones(2))
    try:
        probe(torch.zeros(3))
        raise AssertionError("a second shape under max_recompiles=0 must raise")
    except RecompileLimitExceeded:
        pass
    assert COMPILE_MONITOR.count("no_jax.probe") == 1

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from sheeprl_tpu_torch.serve.players import build_dreamer_v3_player

    cfg = compose(["exp=dreamer_v3", "env=dummy", "algo=dreamer_v3_XS", "fabric.accelerator=cpu",
                   "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
                   "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.dense_units=8",
                   "algo.world_model.recurrent_model.recurrent_state_size=8",
                   "algo.world_model.transition_model.hidden_size=8",
                   "algo.world_model.representation_model.hidden_size=8",
                   "algo.world_model.recurrent_model.fused_pallas=True"])
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    modules = build_agent(fabric, dims, cont, cfg, obs_space)
    state = {{"agent": {{name: m.state_dict() for name, m in modules.items()}}}}
    player = build_dreamer_v3_player(fabric, cfg, state, obs_space, action_space)
    obs = player.prepare({{"rgb": np.zeros((2, 64, 64, 3), np.uint8), "state": np.zeros((2, 4), np.float32)}})
    carry, actions = player.step_batch(player.params, player.zero_carry(2), obs, 0, np.array([True, False]))
    assert actions.shape == (2, 4) and np.isfinite(carry[0]).all()

    import glob, tempfile
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.cli import run
    with tempfile.TemporaryDirectory() as tmp:
        run(["exp=dreamer_v3", "env=dummy", "algo=dreamer_v3_XS", "dry_run=True", "env.num_envs=2",
             "fabric.accelerator=cpu", "metric/logger=csv", "buffer.memmap=False", f"log_dir={{tmp}}",
             "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=4",
             "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
             "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.dense_units=8",
             "algo.world_model.recurrent_model.recurrent_state_size=8",
             "algo.world_model.transition_model.hidden_size=8",
             "algo.world_model.representation_model.hidden_size=8",
             "algo.world_model.recurrent_model.fused_pallas=True", "algo.run_test=False",
             "telemetry.introspect.port=0"])
        (snapshot,) = glob.glob(f"{{tmp}}/**/checkpoint/step_*", recursive=True)
        assert load_step_dir(snapshot)["grad_steps"] == 1
        (metrics_csv,) = glob.glob(f"{{tmp}}/**/metrics.csv", recursive=True)
        assert ",Phase/update.dispatch," in open(metrics_csv).read()
    # one Plan2Explore-DreamerV3 update (fused RSSM layout, plain version on the CPU)
    import torch
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import blocks_to_device
    from sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration import P2EDV3Trainer, build_agent as p2e_agent
    from sheeprl_tpu_torch.algos.p2e_utils import p2e_optimizers

    p2e_cfg = compose(["exp=p2e_dv3_exploration", "env=dummy", "fabric.accelerator=cpu",
                       "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "algo.dense_units=8",
                       "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=8",
                       "algo.world_model.transition_model.hidden_size=8",
                       "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
                       "algo.world_model.discrete_size=4", "algo.horizon=3",
                       "algo.world_model.recurrent_model.fused_pallas=True"])
    p2e_modules = p2e_agent(fabric, dims, cont, p2e_cfg, obs_space)
    trainer = P2EDV3Trainer(p2e_cfg, p2e_modules, p2e_optimizers(p2e_cfg, p2e_modules),
                                         (), ("state",), cont)
    rng = np.random.default_rng(0)
    block = {{"state": rng.standard_normal((1, 6, 2, 4)).astype(np.float32),
             "actions": np.eye(dims[0], dtype=np.float32)[rng.integers(0, dims[0], (1, 6, 2))],
             "rewards": rng.standard_normal((1, 6, 2, 1)).astype(np.float32),
             "terminated": np.zeros((1, 6, 2, 1), np.float32), "is_first": np.zeros((1, 6, 2, 1), np.float32)}}
    metrics = trainer.train_phase(blocks_to_device(block, (), ("state",), "cpu"), torch.Generator().manual_seed(0), 0)
    assert len(metrics) == 10 and all(bool(torch.isfinite(m)) for m in metrics)
    assert bool(torch.isfinite(trainer.last_intrinsic))

    # the on-policy algorithms: one iteration each, evaluated; the PPO snapshot served
    from sheeprl_tpu_torch.cli import evaluation
    from sheeprl_tpu_torch.serve.loader import load_policy
    for exp, extra in (("ppo", ["env.id=discrete_dummy", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
                                "algo.encoder.cnn_features_dim=8", "algo.update_epochs=1"]),
                       ("a2c", ["env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]", "algo.optimizer.name=rmsprop_tf"]),
                       ("ppo_recurrent", ["env.id=multidiscrete_dummy", "env.mask_velocities=False",
                                          "algo.mlp_keys.encoder=[state]", "algo.rnn.lstm.hidden_size=4"])):
        with tempfile.TemporaryDirectory() as tmp:
            run([f"exp={{exp}}", "env=dummy", *extra, "dry_run=True", "env.num_envs=2", "fabric.accelerator=cpu",
                 "metric/logger=csv", "buffer.memmap=False", "algo.rollout_steps=4", "algo.per_rank_batch_size=4",
                 "algo.dense_units=4", "algo.mlp_layers=1", "env.max_episode_steps=6", f"log_dir={{tmp}}"])
            (snapshot,) = glob.glob(f"{{tmp}}/**/checkpoint/step_*", recursive=True)
            assert load_step_dir(snapshot)["policy_step"] == 8
            assert np.isfinite(evaluation([f"checkpoint_path={{snapshot}}", "fabric.accelerator=cpu"]))
            if exp == "ppo":
                _, _, _, ppo_player = load_policy(snapshot, ["fabric.accelerator=cpu"])
                obs = ppo_player.prepare({{"rgb": np.zeros((2, 64, 64, 3), np.uint8),
                                          "state": np.zeros((2, 4), np.float32)}})
                _, acts = ppo_player.step_batch(ppo_player.params, (), obs, 0, np.array([True, False]))
                assert acts.shape == (2, 1)

    # one Anakin PPO iteration on the device cartpole (the env stepped inside the iteration)
    import io, contextlib
    from sheeprl_tpu_torch.envs.device import VectorDeviceEnv, make_device_env
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run(["exp=ppo", "env=jax_cartpole", "dry_run=True", "env.num_envs=4", "fabric.accelerator=cpu",
                 "metric/logger=csv", "algo.rollout_steps=8", "algo.per_rank_batch_size=16", "algo.dense_units=4",
                 "algo.mlp_layers=1", f"log_dir={{tmp}}"])
        assert "an Anakin rollout of 4 env(s) on cpu" in out.getvalue(), out.getvalue()
        (snapshot,) = glob.glob(f"{{tmp}}/**/checkpoint/step_*", recursive=True)
        assert load_step_dir(snapshot)["policy_step"] == 32
    for name in ("forage", "multiroom", "pendulum"):
        venv = VectorDeviceEnv(make_device_env(name), 2, "cpu", torch.Generator().manual_seed(0))
        state, obs = venv.reset()
        venv.step(state, torch.zeros((2, 1)) if name == "pendulum" else torch.zeros(2, dtype=torch.long))

    # the off-policy algorithms: a prefill and a few updates each, evaluated; the SAC snapshot served
    for exp, extra in (("sac", ["algo.mlp_keys.encoder=[state]"]), ("droq", ["algo.mlp_keys.encoder=[state]"]),
                       ("sac_ae", ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]", "env.screen_size=16",
                                   "env.wrapper.image_size=[16,16,3]", "algo.encoder.features_dim=4",
                                   "algo.cnn_channels_multiplier=2"])):
        with tempfile.TemporaryDirectory() as tmp:
            run([f"exp={{exp}}", "env=dummy", "env.id=continuous_dummy", *extra, "env.num_envs=2",
                 "fabric.accelerator=cpu", "metric/logger=csv", "buffer.memmap=False", "buffer.size=32",
                 "algo.total_steps=8", "algo.learning_starts=4", "algo.per_rank_batch_size=2", "algo.hidden_size=4",
                 "env.max_episode_steps=6", f"log_dir={{tmp}}"])
            (snapshot,) = glob.glob(f"{{tmp}}/**/checkpoint/step_*", recursive=True)
            assert load_step_dir(snapshot)["grad_steps"] > 0
            assert np.isfinite(evaluation([f"checkpoint_path={{snapshot}}", "fabric.accelerator=cpu"]))
            if exp == "sac":
                _, _, _, sac_player = load_policy(snapshot, ["fabric.accelerator=cpu"])
                obs = sac_player.prepare({{"state": np.zeros((2, 4), np.float32)}})
                _, acts = sac_player.step_batch(sac_player.params, (), obs, 0, np.array([True, False]))
                assert acts.shape == (2, 2)

    # the device-resident replay, forced on the CPU: SAC and DreamerV3 train from it, a spill round-trips
    from sheeprl_tpu_torch.data.device_replay import DeviceReplay, HostSpill
    with tempfile.TemporaryDirectory() as tmp:
        run(["exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]", "env.num_envs=2",
             "fabric.accelerator=cpu", "metric/logger=csv", "buffer.memmap=False", "buffer.size=32",
             "algo.total_steps=12", "algo.learning_starts=4", "algo.per_rank_batch_size=2", "algo.hidden_size=4",
             "buffer.device=True", "buffer.transfer_guard=True", f"log_dir={{tmp}}"])
        (snapshot,) = glob.glob(f"{{tmp}}/**/checkpoint/step_*", recursive=True)
        state = load_step_dir(snapshot)
        assert state["grad_steps"] == 12 and state["rb"]["device_replay"]["from_spill"] is False
    with tempfile.TemporaryDirectory() as tmp:
        run(["exp=dreamer_v3", "env=dummy", "algo=dreamer_v3_XS", "dry_run=True", "env.num_envs=2",
             "fabric.accelerator=cpu", "metric/logger=csv", "buffer.memmap=False", f"log_dir={{tmp}}",
             "algo.per_rank_batch_size=2", "algo.per_rank_sequence_length=8", "algo.horizon=4",
             "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "algo.dense_units=8",
             "algo.world_model.recurrent_model.recurrent_state_size=8",
             "algo.world_model.transition_model.hidden_size=8",
             "algo.world_model.representation_model.hidden_size=8", "algo.run_test=False",
             "buffer.device=True", "buffer.transfer_guard=True"])
        (snapshot,) = glob.glob(f"{{tmp}}/**/checkpoint/step_*", recursive=True)
        assert load_step_dir(snapshot)["grad_steps"] == 1
    rb = DeviceReplay(4, 2, "cpu", spill=HostSpill(8, 2, sequential=True))
    for t in range(6):
        rb.add({{"x": np.full((1, 2, 1), t, np.float32)}})
    again = DeviceReplay(4, 2, "cpu", spill=HostSpill(8, 2, sequential=True)).load_state_dict(rb.state_dict())
    assert torch.equal(again.buffers["x"], rb.buffers["x"])
    rb.spill.close(); again.spill.close()

    leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not leaked, leaked
    print("ok", len(names))
    """
)


def test_port_imports_and_steps_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("ok"), proc.stdout
    assert int(proc.stdout.split()[-1]) >= 80  # every module of the port was imported
