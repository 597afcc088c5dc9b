"""The port's training loops on the device-resident replay, on the CPU
(twins of ``tests/test_data/test_device_replay_e2e.py``).

``buffer.device=auto`` resolves to the host ring on the CPU, so these force
``True`` to run the device path end to end, with ``buffer.transfer_guard``
on and the loops' ``steady_guard`` replaced by its CPU stand-in
(``tests/test_torch_device_replay.py::guard_spy``): every window after the
first must be armed, and inside it nothing may read a tensor back, test one
for truth or make one from host data.

One fused window of DreamerV3 and one of SAC are held against JAX's
``fused_sequence_train`` and ``fused_uniform_train`` on the same parameters
(``convert.py``), the same ring, JAX's index draws and JAX's update noise,
to the tolerances of the update parity tests they build on
(``tests/test_torch_train_step.py``: the ten metrics 1e-5 relative, 2e-5
absolute; with SGD every parameter's change to 1e-3 of its tensor's largest
change plus 1e-4 relative.  ``tests/test_torch_sac.py``: the parameters
1e-5 absolute after three Adam steps, the losses 1e-5 relative).
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
from sheeprl_tpu_torch.algos.ppo import ppo
from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent
from sheeprl_tpu_torch.algos.sac import sac
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.data import device_replay as pdr
from tests.test_torch_device_replay import guard_spy
from tests.test_torch_train_cli import OFF_POLICY, OFF_POLICY_COMMON, ON_POLICY, ON_POLICY_COMMON, TINY

DEVICE = ["buffer.device=True", "buffer.transfer_guard=True"]


@pytest.fixture()
def armed(monkeypatch):
    """The windows' guard flags, in order, with the CPU stand-in armed."""
    flags = []
    for module in (dreamer_v3, sac, ppo, ppo_recurrent):
        monkeypatch.setattr(module, "steady_guard", guard_spy(flags))
    return flags


def _snapshots(root):
    return sorted(glob.glob(f"{root}/**/checkpoint/step_*", recursive=True))


def _armed_past_the_first_window(armed):
    """The first window's chunks unguarded, every later one guarded."""
    return armed[0] is False and armed == sorted(armed) and armed.count(True) >= 3


def _rings_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- the loops on the device ring, guard armed ------------------------------------
@pytest.mark.parametrize("exp", list(OFF_POLICY))
def test_off_policy_trains_multi_window_on_the_device_ring(exp, tmp_path, armed, capsys):
    run([f"exp={exp}", *OFF_POLICY_COMMON, *OFF_POLICY[exp][0], "algo.total_steps=24", f"log_dir={tmp_path}",
         *DEVICE])
    assert "replay in a device ring on cpu (32 steps/env)" in capsys.readouterr().out
    assert _armed_past_the_first_window(armed)
    (snapshot,) = _snapshots(tmp_path)
    state = load_step_dir(snapshot)
    # the replay ratio over the run's 24 policy steps (the first window repays the prefill)
    assert state["grad_steps"] == OFF_POLICY[exp][1] * 24
    assert state["rb"]["device_replay"] == {"from_spill": False}


def test_dreamer_v3_dry_run_and_windows_on_the_device_ring(tmp_path, armed, capsys):
    run([*TINY, "dry_run=True", f"log_dir={tmp_path / 'dry'}", *DEVICE])
    assert "replay in a device ring on cpu (100 steps/env)" in capsys.readouterr().out
    assert armed == [False]
    (snapshot,) = _snapshots(tmp_path / "dry")
    assert load_step_dir(snapshot)["grad_steps"] == 1
    armed.clear()
    run([*TINY, "algo.total_steps=40", "algo.learning_starts=20", "algo.replay_ratio=0.25",
         f"log_dir={tmp_path / 'windows'}", *DEVICE])
    assert _armed_past_the_first_window(armed)


@pytest.mark.parametrize("exp", ["p2e_dv3_exploration", "dreamer_v2", "p2e_dv2_exploration", "dreamer_v1",
                                 "p2e_dv1_exploration"])
def test_dreamer_family_trains_guarded_on_the_device_ring(exp, tmp_path, armed, capsys):
    """The rest of the family rides the same loop: its updates read nothing
    back inside a guarded window either (on the vector key alone; the
    pixel path is DreamerV3's test above)."""
    tiny = [o for o in TINY if not o.startswith(("exp=", "algo=", "algo.world_model.recurrent_model.fused",
                                                 "algo.cnn_keys"))]
    run([f"exp={exp}", *tiny, "algo.cnn_keys.encoder=[]", "algo.total_steps=40", "algo.learning_starts=20", "algo.replay_ratio=0.25",
         "algo.mlp_layers=1", "algo.horizon=3", "algo.per_rank_pretrain_steps=0", f"log_dir={tmp_path}", *DEVICE])
    assert "replay in a device ring" in capsys.readouterr().out
    assert _armed_past_the_first_window(armed)
    # a quarter of the 40 policy steps
    assert load_step_dir(_snapshots(tmp_path)[-1])["grad_steps"] == 10


def test_episode_buffer_keeps_the_host_path(tmp_path, armed, capsys):
    run([*TINY, "dry_run=True", "buffer.type=episode", f"log_dir={tmp_path}", *DEVICE])
    assert "replay in an EpisodeBuffer on the host" in capsys.readouterr().out
    assert armed == []


@pytest.mark.parametrize("mode,device,on", [("auto", "cpu", False), ("auto", "cuda", True), ("True", "cpu", True),
                                             ("False", "cuda", False)])
def test_resolve_device_replay(mode, device, on):
    """``auto`` is the card whenever the run's device is CUDA; the decision
    needs no card."""
    cfg = compose(["exp=sac", "env=dummy", "env.sync_env=True", f"buffer.device={mode}"])
    assert pdr.resolve_device_replay(cfg, torch.device(device)) is on


def test_auto_on_the_cpu_keeps_the_host_ring(tmp_path, capsys):
    run([*TINY, "dry_run=True", f"log_dir={tmp_path}"])
    assert "replay in a host ring" in capsys.readouterr().out


# -- checkpoints -------------------------------------------------------------------
def _capture_loads(monkeypatch):
    loaded = []
    load = pdr.DeviceReplay.load_state_dict

    def spy(self, state):
        out = load(self, state)
        loaded.append({k: v.clone() for k, v in self.buffers.items()})
        return out

    monkeypatch.setattr(pdr.DeviceReplay, "load_state_dict", spy)
    return loaded


def test_sac_checkpoint_round_trip_on_the_device_ring(tmp_path, armed, monkeypatch):
    common = [f"exp=sac", *OFF_POLICY_COMMON, *OFF_POLICY["sac"][0], "buffer.checkpoint=True", *DEVICE]
    run([*common, "algo.total_steps=24", f"log_dir={tmp_path / 'a'}"])
    (snapshot,) = _snapshots(tmp_path / "a")
    saved = load_step_dir(snapshot)
    loaded = _capture_loads(monkeypatch)
    run([*common, "algo.total_steps=40", f"checkpoint.resume_from={snapshot}", f"log_dir={tmp_path / 'b'}"])
    (ring,) = loaded
    _rings_equal(ring, {k: v for k, v in saved["rb"]["buffer"].items()})
    resumed = load_step_dir(_snapshots(tmp_path / "b")[-1])
    assert resumed["grad_steps"] > saved["grad_steps"]
    np.testing.assert_array_equal(resumed["rb"]["pos"].numpy(), [20, 20])


def test_dreamer_v3_resumes_from_a_spill_checkpoint(tmp_path, armed, monkeypatch, capsys):
    """A byte budget below the ring arms the spill: the checkpoint comes from
    it, and the resumed window is rebuilt from it at the saved cursors."""
    monkeypatch.setenv("SHEEPRL_REPLAY_BUDGET_BYTES", str(40 * 2 * 12400))  # ~40 of a step's ~12.3 KB per env
    common = [*TINY, "algo.learning_starts=20", "algo.replay_ratio=0.25", *DEVICE]
    at_save = []
    save = pdr.DeviceReplay.state_dict

    def save_spy(self):
        at_save.append(({k: v.clone() for k, v in self.buffers.items()}, self._pos_h.copy()))
        return save(self)

    monkeypatch.setattr(pdr.DeviceReplay, "state_dict", save_spy)
    run([*common, "algo.total_steps=40", f"log_dir={tmp_path / 'a'}"])
    assert "window shrunk 100 -> " in capsys.readouterr().out
    snapshot = _snapshots(tmp_path / "a")[-1]
    saved = load_step_dir(snapshot)
    assert saved["rb"]["device_replay"]["from_spill"]
    assert len(saved["rb"]["buffers"]) == 2
    saved_ring, pos = at_save[-1]
    loaded = _capture_loads(monkeypatch)
    # a resume re-waits learning_starts (10 iterations) before it trains again
    run([*common, "algo.total_steps=72", f"checkpoint.resume_from={snapshot}", f"log_dir={tmp_path / 'b'}"])
    (ring,) = loaded
    # the window is rebuilt from the spill as it stood; only the write-head
    # rows carry the checkpoint's truncation mark
    tail = (pos - 1) % ring["truncated"].shape[0]
    saved_ring["truncated"][tail, np.arange(2)] = 1.0
    _rings_equal(ring, saved_ring)
    resumed = load_step_dir(_snapshots(tmp_path / "b")[-1])
    assert resumed["grad_steps"] > saved["grad_steps"]


def test_p2e_finetuning_carries_the_exploration_device_ring(tmp_path, armed, monkeypatch):
    tiny = [o for o in TINY if not o.startswith(("exp=", "algo="))]
    explore = ["exp=p2e_dv3_exploration", *tiny, "algo.mlp_layers=1", "algo.horizon=3", *DEVICE]
    run([*explore, "dry_run=True", "buffer.checkpoint=True", f"log_dir={tmp_path / 'x'}"])
    (snapshot,) = _snapshots(tmp_path / "x")
    saved = load_step_dir(snapshot)["rb"]
    loaded = _capture_loads(monkeypatch)
    run(["exp=p2e_dv3_finetuning", *tiny, "algo.mlp_layers=1", "algo.horizon=3", *DEVICE, "dry_run=True",
         f"checkpoint.exploration_ckpt_path={snapshot}", "buffer.load_from_exploration=True",
         f"log_dir={tmp_path / 'f'}"])
    (ring,) = loaded
    _rings_equal(ring, dict(saved["buffer"]))


# -- the on-policy loops: the guard is armed past the first update ------------------
ANAKIN = {
    "ppo": ["exp=ppo", "env=jax_cartpole"],
    "a2c": ["exp=a2c", "env=jax_cartpole"],
    "ppo_recurrent": ["exp=ppo_recurrent", "env=jax_cartpole", "env.mask_velocities=False",
                      "algo.rnn.lstm.hidden_size=8"],
}


@pytest.mark.parametrize("exp", list(ON_POLICY))
def test_on_policy_guard_is_armed_past_the_first_update(exp, tmp_path, armed):
    run([f"exp={exp}", *ON_POLICY_COMMON, *ON_POLICY[exp][1:], "algo.total_steps=48", "buffer.transfer_guard=True",
         f"log_dir={tmp_path}"])
    assert armed == [False, True, True]


@pytest.mark.parametrize("exp", list(ANAKIN))
def test_anakin_guard_is_armed_past_the_first_iteration(exp, tmp_path, armed):
    run([*ANAKIN[exp], "fabric.accelerator=cpu", "metric/logger=csv", "buffer.transfer_guard=True", "env.num_envs=4",
         "algo.rollout_steps=8", "algo.per_rank_batch_size=16", "algo.dense_units=4", "algo.mlp_layers=1",
         "algo.update_epochs=1", "algo.total_steps=96", f"log_dir={tmp_path}"])
    assert armed == [False, True, True]


def test_on_policy_guard_off_by_default(tmp_path, armed):
    run(["exp=a2c", *ON_POLICY_COMMON, *ON_POLICY["a2c"][1:], "algo.total_steps=48", f"log_dir={tmp_path}"])
    assert armed == [False, False, False]


# -- one fused window against JAX's ---------------------------------------------------
def _ring_pair(cap, n_envs, steps, make_rows, seed=0):
    from sheeprl_tpu.data.device_replay import DeviceReplay as JaxDeviceReplay

    rng = np.random.default_rng(seed)
    j, p = JaxDeviceReplay(cap, n_envs), pdr.DeviceReplay(cap, n_envs)
    for _ in range(steps):
        rows = make_rows(rng)
        j.add(rows)
        p.add(rows)
    return j, p


def test_fused_dreamer_v3_window_matches_jax():
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_build_opts
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_phase as jax_make_train_phase
    from sheeprl_tpu.config.compose import compose as jax_compose
    from sheeprl_tpu.data.device_replay import fused_sequence_train as jax_fused
    from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
    from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers, prep_blocks
    from sheeprl_tpu_torch.convert import agent_state_from_jax
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from tests.test_torch_device_replay import jax_sequence_draws
    from tests.test_torch_serve import _jax_params
    from tests.test_torch_train_step import SGD, B, L, _noise_from_keys, _overrides

    U, E = 2, 2
    overrides = _overrides("discrete_dummy", True, "fused_pallas", SGD, ())
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jfabric = jax_build_fabric(jcfg)
    obs_space, action_space = jax_probe_spaces(jcfg)
    actions_dim, is_cont = jax_spaces_to_dims(action_space)
    act_width = int(sum(actions_dim))
    params = _jax_params(jcfg, jfabric, obs_space, action_space, seed=1)
    before = jax.tree.map(np.array, params)

    def rows(rng):
        return {"rgb": rng.integers(0, 256, (1, E, 64, 64, 3), dtype=np.uint8),
                "state": rng.standard_normal((1, E, 4)).astype(np.float32),
                "actions": np.eye(act_width, dtype=np.float32)[rng.integers(0, act_width, (1, E))],
                "rewards": rng.standard_normal((1, E, 1)).astype(np.float32),
                "terminated": (rng.random((1, E, 1)) < 0.1).astype(np.float32),
                "truncated": np.zeros((1, E, 1), np.float32),
                "is_first": (rng.random((1, E, 1)) < 0.1).astype(np.float32)}

    jring, pring = _ring_pair(24, E, 30, rows)
    key = jax.random.PRNGKey(11)
    k_sample, k_train = jax.random.split(key)
    S, D = pcfg.algo.world_model.stochastic_size, pcfg.algo.world_model.discrete_size

    # -- the port ----------------------------------------------------------------------
    p_obs_space, _ = probe_spaces(pcfg)
    state = agent_state_from_jax(before, pcfg)
    modules = build_agent(build_fabric(pcfg), actions_dim, is_cont, pcfg, p_obs_space, state)
    trainer = DV3Trainer(pcfg, modules, build_dv3_optimizers(pcfg, modules), ("rgb",), ("state",), is_cont, state)
    indices = pring.sequence_indices_from(*jax_sequence_draws(jring, k_sample, U * B, L), L)
    counter, p_metrics = pdr.fused_sequence_train(
        trainer, pring, None, B, L, U, lambda b: prep_blocks(b, ("rgb",), ("state",)), 3, indices=indices,
        noise=_noise_from_keys(k_train, U, actions_dim, is_cont, S, D))
    assert counter == 5

    # -- JAX ---------------------------------------------------------------------------
    def jax_prep(b):
        out = {"rgb": b["rgb"], "state": b["state"].astype(jnp.float32).reshape(*b["state"].shape[:3], -1),
               "actions": b["actions"].astype(jnp.float32)}
        for k in ("rewards", "terminated", "is_first"):
            out[k] = b[k][..., 0].astype(jnp.float32)
        return out

    world_model, actor, critic, params = jax_build_agent(jfabric, actions_dim, is_cont, jcfg, obs_space, params)
    wm_opt, actor_opt, critic_opt, opt_state = jax_build_opts(jfabric, jcfg, params)
    phase = jax_make_train_phase(jfabric, jcfg, world_model, actor, critic, wm_opt, actor_opt, critic_opt,
                                 cnn_keys=("rgb",), mlp_keys=("state",), is_continuous=is_cont)
    fused = jax_fused(jfabric, phase, jring, B, L, jax_prep, name="test.dv3_fused")
    new_params, _, j_counter, j_metrics = fused(params, opt_state, jring.buffers, jring.cursor, key, jnp.int32(3),
                                                n_samples=U)
    assert int(j_counter) == counter

    j_metrics = np.array([float(m) for m in j_metrics])
    p_metrics = np.array([float(m) for m in p_metrics])
    assert np.isfinite(p_metrics).all()
    np.testing.assert_allclose(p_metrics, j_metrics, rtol=1e-5, atol=2e-5)
    after = agent_state_from_jax(jax.tree.map(np.array, new_params), pcfg)
    start = agent_state_from_jax(before, pcfg)
    for name, module in trainer.modules().items():
        p_state = module.state_dict()
        for k, j_after in after[name].items():
            j_delta = (j_after - start[name][k]).numpy()
            p_delta = (p_state[k].detach() - start[name][k]).numpy()
            scale = max(np.abs(j_delta).max(), 1e-12)
            np.testing.assert_allclose(p_delta, j_delta, rtol=1e-4, atol=1e-3 * scale, err_msg=f"{name}.{k}")


def test_fused_sac_window_matches_jax():
    from sheeprl_tpu.algos.sac.sac import make_sac_train_fns
    from sheeprl_tpu.data.device_replay import fused_uniform_train as jax_fused
    from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, VectorLayout
    from sheeprl_tpu_torch.envs import spaces
    from tests.test_torch_device_replay import jax_uniform_draws
    from tests.test_torch_sac import (ACT_DIM, LOSS_RTOL, OBS_DIM, SAC, action_noise, assert_agent_matches,
                                      jax_optimizers, jax_update_keys, plain_apply, setup)

    U, B, E = 3, 8, 2
    jcfg, cfg, actor, critic, params, agent = setup(SAC)
    opts, o_state = jax_optimizers(jcfg, params)
    _, train_phase = make_sac_train_fns(actor, critic, plain_apply, *opts, jcfg, ACT_DIM)

    def rows(rng):
        return {"obs": rng.standard_normal((1, E, OBS_DIM)).astype(np.float32),
                "next_obs": rng.standard_normal((1, E, OBS_DIM)).astype(np.float32),
                "actions": rng.uniform(-0.99, 0.99, (1, E, ACT_DIM)).astype(np.float32),
                "rewards": rng.standard_normal((1, E, 1)).astype(np.float32),
                "terminated": (rng.random((1, E, 1)) < 0.4).astype(np.float32)}

    jring, pring = _ring_pair(16, E, 21, rows)
    key = jax.random.PRNGKey(3)
    k_sample, k_train = jax.random.split(key)
    noise = [{"next": action_noise(k_next, B), "pi": action_noise(k_pi, B)}
             for k_next, k_pi, *_ in jax_update_keys(k_train, U)]
    layout = VectorLayout(compose([*SAC, "algo.mlp_keys.encoder=[state]"]),
                          spaces.Dict({"state": spaces.Box(-1, 1, (OBS_DIM,), np.float32)}))
    trainer = SACTrainer(cfg, agent, SACTrainer.build_optimizers(cfg, agent), ACT_DIM)
    indices = pring.uniform_indices_from(*jax_uniform_draws(jring, k_sample, U * B, False))
    counter, got = pdr.fused_uniform_train(trainer, pring, None, B, U, layout.prep, 0, indices=indices, noise=noise)

    def jax_prep(b):
        return {"obs": b["obs"], "next_obs": b["next_obs"], "actions": b["actions"],
                "rewards": b["rewards"][..., 0], "terminated": b["terminated"][..., 0]}

    fused = jax_fused(jax_build_fabric(jcfg), train_phase, jring, B, jax_prep, name="test.sac_fused")
    new_params, _, j_counter, want = fused(params, o_state, jring.buffers, jring.cursor, key, jnp.int32(0),
                                           n_samples=U)
    assert counter == int(j_counter) == U
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=LOSS_RTOL)
    assert_agent_matches(agent, jax.device_get(new_params))
