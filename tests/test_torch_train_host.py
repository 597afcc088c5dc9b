"""The port's host substrate of training against the JAX package's: the
synchronous vector env against gymnasium's (through ``sheeprl_tpu``'s
``vectorize``), and the replay buffers, whose sampling draws from numpy's
global generator in the same order as the JAX package's, so one seed gives
the same blocks."""

import numpy as np
import pytest

from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.data.buffers import EnvIndependentReplayBuffer as JaxEnvIndependent
from sheeprl_tpu.data.buffers import SequentialReplayBuffer as JaxSequential
from sheeprl_tpu.utils import env as jax_env
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, SequentialReplayBuffer
from sheeprl_tpu_torch.utils import env as port_env


@pytest.mark.parametrize("env_id", ["discrete_dummy", "multidiscrete_dummy", "continuous_dummy"])
def test_vector_env_matches_gymnasium(env_id):
    overrides = ["exp=dreamer_v3", "env=dummy", "env.sync_env=True", f"env.id={env_id}", "env.num_envs=3", "env.sync_env=True",
                 "env.max_episode_steps=5", "env.capture_video=False"]
    envs = []
    for mod, cfg in ((jax_env, jax_compose(overrides)), (port_env, compose(overrides))):
        envs.append(mod.vectorize(cfg, [mod.make_env(cfg, 3 + i, 0, vector_env_idx=i) for i in range(3)]))
    (j_obs, _), (p_obs, _) = (e.reset(seed=3) for e in envs)
    space = envs[1].single_action_space
    for step in range(12):
        for k in ("rgb", "state"):
            np.testing.assert_array_equal(p_obs[k], j_obs[k], err_msg=f"{k} at step {step}")
        actions = np.stack([space.sample() for _ in range(3)])
        j_obs, j_r, j_te, j_tr, j_info = envs[0].step(actions)
        p_obs, p_r, p_te, p_tr, p_info = envs[1].step(actions)
        np.testing.assert_array_equal(p_r, j_r)
        np.testing.assert_array_equal(p_te, j_te)
        np.testing.assert_array_equal(p_tr, j_tr)
        assert port_env.episode_stats(p_info) == jax_env.episode_stats(j_info)
        done = np.nonzero(np.logical_or(p_te, p_tr))[0]
        if done.size:
            p_final = port_env.final_obs_rows(p_info, done, ("rgb", "state"))
            j_final = jax_env.final_obs_rows(j_info, done, ("rgb", "state"))
            for k in ("rgb", "state"):
                np.testing.assert_array_equal(p_final[k], j_final[k])
    for e in envs:
        e.close()


def _fill(buffers, rng, steps=40, n_envs=3):
    """The same stream of steps, with reset rows for two envs mid-way, into every buffer."""
    for t in range(steps):
        data = {
            "rgb": rng.integers(0, 256, (1, n_envs, 8, 8, 3), dtype=np.uint8),
            "state": rng.standard_normal((1, n_envs, 4)).astype(np.float32),
            "actions": rng.standard_normal((1, n_envs, 2)).astype(np.float32),
            "rewards": rng.standard_normal((1, n_envs, 1)).astype(np.float32),
            "terminated": (rng.random((1, n_envs, 1)) < 0.1).astype(np.float32),
            "truncated": np.zeros((1, n_envs, 1), np.float32),
            "is_first": (rng.random((1, n_envs, 1)) < 0.1).astype(np.float32),
        }
        for b in buffers:
            b.add(data)
        if t % 11 == 10:
            reset = {k: v[:, :2] for k, v in data.items()}
            for b in buffers:
                b.add(reset, indices=[0, 2])


@pytest.mark.parametrize("capacity", [16, 64])  # a ring that wrapped, and one that did not
def test_sequence_sampling_matches_jax_and_survives_state_dict(capacity):
    port = EnvIndependentReplayBuffer(capacity, n_envs=3, buffer_cls=SequentialReplayBuffer)
    ref = JaxEnvIndependent(capacity, n_envs=3, buffer_cls=JaxSequential)
    _fill([port, ref], np.random.default_rng(0))
    restored = EnvIndependentReplayBuffer(capacity, n_envs=3, buffer_cls=SequentialReplayBuffer)
    restored.load_state_dict(port.state_dict())
    for b in (port, ref):
        assert [len(s) for s in b.buffer] == [len(s) for s in ref.buffer]
    samples = []
    for b in (port, ref, restored):
        np.random.seed(5)
        samples.append(b.sample(4, n_samples=3, sequence_length=8))
    for k, v in samples[1].items():
        assert samples[0][k].shape == v.shape == (3, 8, 4, *v.shape[3:])
        np.testing.assert_array_equal(samples[0][k], v, err_msg=k)
        np.testing.assert_array_equal(samples[2][k], v, err_msg=k)
    for b in (port, ref):  # a broken stream truncates the newest row of its env
        b.repair_tail(1)
    for k in ("terminated", "truncated", "is_first"):
        np.testing.assert_array_equal(port.buffer[1][k], ref.buffer[1][k], err_msg=k)


@pytest.mark.parametrize("deferred,sync_every", [(True, 1), (False, 1), (True, 2), (False, 3)])
def test_player_sync_staleness_matches_jax(deferred, sync_every):
    """The player acts on the weights of the same train window as the JAX
    player, window after window; the trained weight holds its window's number."""
    import torch

    from sheeprl_tpu.parallel.fabric import PlayerSync as JaxPlayerSync
    from sheeprl_tpu_torch.fabric import PlayerSync
    from sheeprl_tpu_torch.utils.structured import dotdict

    cfg = dotdict({"algo": {"player": {"deferred_sync": deferred, "sync_every": sync_every}}})

    class _Fabric:  # the JAX PlayerSync's view of a fabric: copies are the identity here
        def player_device(self, cfg):
            return None

        def copy_to(self, tree, device):
            return tree

    trained = torch.nn.Linear(1, 1, bias=False)
    with torch.no_grad():
        trained.weight.fill_(0)
    port = PlayerSync(cfg, torch.device("cpu"), lambda: {"actor": trained})
    ref = JaxPlayerSync(_Fabric(), cfg, extract=lambda p: p)
    port.init()
    j_player = ref.init(0)
    for window in range(1, 9):
        port.before_dispatch()
        j_player = ref.before_dispatch(j_player)
        assert port.modules["actor"].weight.item() == j_player, f"window {window}"
        with torch.no_grad():
            trained.weight.fill_(window)
        port.after_dispatch()
        j_player = ref.after_dispatch(window, j_player)
        assert port.modules["actor"].weight.item() == j_player, f"after window {window}"
        assert port.metrics() == ref.metrics()
