"""The port's vector env in worker processes and its step-deadline watchdog
(``sheeprl_tpu_torch/utils/env.py``: ``AsyncVectorEnv``,
``StepDeadlineVectorEnv``, ``vectorize``) against the JAX package's.

* the five cases of ``tests/test_resilience/test_vecenv_watchdog.py``:
  pass-through, a hang torn down and flagged (``restart_on_exception`` and
  its mask), the restart budget's give-up, the reset deadline, ``vectorize``
  wired from the config;
* the async vector env equals the sync one bit for bit over a scripted
  action stream with autoresets (observations, rewards, flags,
  ``final_obs``, episodes, per-key info masks), for every dummy env, and a
  device env under ``sync_env=False`` steps on the CPU in its workers;
* the port's async vector env against JAX's ``vectorize`` (gymnasium's
  ``AsyncVectorEnv``, SAME_STEP) on the same dummy-env streams;
* a worker's exception is raised again with its traceback, workers ignore
  SIGINT and SIGTERM, the active fault plan reaches the workers,
  ``close(terminate=True)`` leaves no process;
* the counterpart of ``tests/test_resilience/test_chaos_train.py``: a tiny
  DreamerV3 run through ``cli.run`` under a crash-and-hang storm completes,
  its replay repaired.

The worker processes import this module to build the helper envs, so JAX
is imported only inside the tests that compare with it.
"""

import functools
import json
import os
import signal
import time

import numpy as np
import pytest

from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs.dummy import Env
from sheeprl_tpu_torch.resilience import faults
from sheeprl_tpu_torch.utils.env import (
    AsyncVectorEnv,
    RemoteTraceback,
    StepDeadlineVectorEnv,
    SyncVectorEnv,
    make_env,
    vectorize,
)


class SometimesHangs(Env):
    """Hangs at its ``hang_at``-th step (the JAX test's env; the step is an
    argument, which pickles into the worker)."""

    observation_space = spaces.Box(-1, 1, (3,), np.float32)
    action_space = spaces.Discrete(2)

    def __init__(self, hang_at=-1):
        self.t, self.hang_at = 0, hang_at

    def reset(self, *, seed=None, options=None):
        return np.zeros(3, np.float32), {}

    def step(self, action):
        self.t += 1
        if self.t == self.hang_at:
            time.sleep(60.0)
        return np.full(3, self.t, np.float32), 1.0, False, False, {}


class Fails(SometimesHangs):
    def step(self, action):
        raise ValueError("the env broke in its worker")


def _make(n=2, hang_at=-1):
    return AsyncVectorEnv([functools.partial(SometimesHangs, hang_at) for _ in range(n)])


def test_normal_stepping_passes_through():
    env = StepDeadlineVectorEnv(_make, deadline_s=5.0)
    try:
        env.reset()
        for i in range(3):
            obs, r, term, trunc, info = env.step(np.zeros(2, np.int64))
            assert "restart_on_exception" not in info
            assert np.allclose(obs[:, 0], i + 1)
        assert env.num_envs == 2
        assert env.single_observation_space.shape == (3,)
    finally:
        env.close()


def test_hang_detected_torn_down_and_flagged():
    hang = [2]
    env = StepDeadlineVectorEnv(lambda: _make(hang_at=hang[0]), deadline_s=2.0, max_restarts=1, window_s=60.0)
    try:
        env.reset()
        env.step(np.zeros(2, np.int64))  # t=1: fine
        hang[0] = -1  # the recreated workers behave
        stuck = env.unwrapped.processes
        with pytest.warns(RuntimeWarning, match="vector env watchdog"):
            obs, r, term, trunc, info = env.step(np.zeros(2, np.int64))  # t=2 hangs
        # reported as a restart, with its mask, so the replay repairs its tails
        assert np.all(info["restart_on_exception"]) and np.all(info["_restart_on_exception"])
        assert not term.any() and not trunc.any() and obs.shape == (2, 3)
        assert not any(p.is_alive() for p in stuck)  # the wedged workers are gone
        obs, *_ = env.step(np.zeros(2, np.int64))
        assert np.allclose(obs[:, 0], 1.0)  # fresh envs, t restarted
    finally:
        env.close()


def test_restart_budget_exhaustion_raises(tmp_path):
    from sheeprl_tpu_torch.telemetry.recorder import RECORDER

    RECORDER.clear()
    RECORDER.configure(run_dir=str(tmp_path))
    env = StepDeadlineVectorEnv(lambda: _make(hang_at=1), deadline_s=0.5, max_restarts=1, window_s=600.0)
    try:
        env.reset()
        with pytest.warns(RuntimeWarning, match="vector env watchdog"):
            env.step(np.zeros(2, np.int64))  # restart 1: allowed
        with pytest.raises(RuntimeError, match="giving up"):
            env.step(np.zeros(2, np.int64))  # restart 2: the budget is spent
    finally:
        env.close(terminate=True)
    doc = json.loads((tmp_path / "postmortem.json").read_text())
    assert doc["reason"] == "watchdog"
    # the first teardown's stall and restart, then the give-up
    assert [e["kind"] for e in doc["events"]] == ["watchdog.stall", "env.restart", "watchdog.giveup"]


def test_reset_deadline_also_guarded():
    env = StepDeadlineVectorEnv(_make, deadline_s=5.0)
    try:
        obs, info = env.reset()
        assert obs.shape == (2, 3)
    finally:
        env.close()


def test_vectorize_wires_watchdog_from_config():
    cfg = compose(["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=False",
                   "env.capture_video=False", "env.step_deadline_s=7.5", "env.max_vecenv_restarts=2",
                   "env.vecenv_restart_window_s=30", "metric.log_level=0"])
    envs = vectorize(cfg, [make_env(cfg, 0, 0) for _ in range(2)])
    try:
        assert isinstance(envs, StepDeadlineVectorEnv) and isinstance(envs.unwrapped, AsyncVectorEnv)
        assert (envs._deadline, envs._max_restarts, envs._window) == (7.5, 2, 30.0)
        envs.reset()
        envs.step(np.zeros(2, np.int64))
        assert "worker processes" in envs.describe()
    finally:
        envs.close()
    cfg.env.step_deadline_s = 0  # no watchdog: the bare async vector env
    bare = vectorize(cfg, [make_env(cfg, 0, 0) for _ in range(2)])
    bare.close()
    assert isinstance(bare, AsyncVectorEnv)
    # the sync path: no watchdog (a hang there is the caller's own thread)
    cfg.env.sync_env = True
    sync_envs = vectorize(cfg, [make_env(cfg, 0, 0) for _ in range(2)])
    try:
        assert isinstance(sync_envs, SyncVectorEnv)
    finally:
        sync_envs.close()


# -- the streams --------------------------------------------------------------------
STREAM_ENVS = {
    "discrete_dummy": ["env.id=discrete_dummy", "env.max_episode_steps=7"],
    "multidiscrete_dummy": ["env.id=multidiscrete_dummy", "env.max_episode_steps=5"],
    "continuous_dummy": ["env.id=continuous_dummy", "env.max_episode_steps=6", "env.wrapper.random_start=True"],
    "pixel_grid_dummy": ["env.id=pixel_grid_dummy", "env.max_episode_steps=9"],
}


def _cfg(extra, sync):
    return compose(["exp=ppo", "env=dummy", "env.num_envs=3", f"env.sync_env={sync}", "env.capture_video=False",
                    "fabric.accelerator=cpu", *extra])


def _actions(space, n, T, seed):
    space.seed(seed)
    return [np.stack([space.sample() for _ in range(n)]) for _ in range(T)]


def _assert_same_step(a, b, t):
    for x, y in zip(a[:4], b[:4]):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"step {t}: {k}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"step {t}")
    ia, ib = a[4], b[4]
    assert ia.keys() == ib.keys(), (t, ia.keys(), ib.keys())
    for k in ia:
        if k == "final_obs":
            for i in np.nonzero(ia["_final_obs"])[0]:
                for kk in ia[k][i]:
                    np.testing.assert_array_equal(ia[k][i][kk], ib[k][i][kk])
        elif k == "episode":
            for kk in ("r", "l"):
                np.testing.assert_array_equal(ia[k][kk], ib[k][kk])
        else:
            np.testing.assert_array_equal(ia[k], ib[k], err_msg=f"step {t}: info {k}")


@pytest.mark.parametrize("env_id", list(STREAM_ENVS))
def test_async_equals_sync_bit_for_bit(env_id):
    streams = {}
    for sync in (True, False):
        cfg = _cfg(STREAM_ENVS[env_id], sync)
        envs = vectorize(cfg, [make_env(cfg, 5 + i, 0, vector_env_idx=i) for i in range(3)])
        try:
            out = [envs.reset(seed=5)]
            for a in _actions(envs.single_action_space, 3, 24, 0):
                out.append(envs.step(a))
        finally:
            envs.close()
        streams[sync] = out
    np.testing.assert_array_equal(streams[True][0][0]["state"], streams[False][0][0]["state"])
    episodes = 0
    for t, (a, b) in enumerate(zip(streams[True][1:], streams[False][1:])):
        _assert_same_step(a, b, t)
        episodes += int(a[4].get("_episode", np.zeros(1)).sum())
    assert episodes >= 3  # the stream crossed autoresets


def test_device_env_under_async_steps_on_the_cpu_in_its_workers():
    """A device env in a worker never touches a card: it steps on the CPU
    there, and the stream equals the in-process one's."""
    streams = {}
    for sync in (True, False):
        cfg = compose(["exp=ppo", "env=jax_cartpole", f"env.sync_env={sync}", "fabric.accelerator=cpu",
                       "env.max_episode_steps=4"])
        envs = vectorize(cfg, [make_env(cfg, i, 0, vector_env_idx=i) for i in range(2)])
        try:
            out = [envs.reset(seed=1)]
            for t in range(10):
                out.append(envs.step(np.array([t % 2, (t + 1) % 2])))
        finally:
            envs.close()
        streams[sync] = out
    for t, (a, b) in enumerate(zip(streams[True][1:], streams[False][1:])):
        _assert_same_step(a, b, t)


@pytest.mark.parametrize("env_id", ["discrete_dummy", "multidiscrete_dummy", "continuous_dummy"])
def test_async_matches_jax_vectorize(env_id):
    """JAX's ``vectorize`` (gymnasium's ``AsyncVectorEnv``, SAME_STEP) and
    the port's on the same env streams: observations, rewards, flags and the
    final observations of finished episodes."""
    from sheeprl_tpu.config.compose import compose as jax_compose
    from sheeprl_tpu.utils.env import make_env as jax_make_env
    from sheeprl_tpu.utils.env import vectorize as jax_vectorize

    over = ["exp=ppo", "env=dummy", "env.num_envs=3", "env.sync_env=False", "env.capture_video=False",
            "fabric.accelerator=cpu", "metric.log_level=0", *STREAM_ENVS[env_id]]
    cfg, jcfg = compose(over), jax_compose(over)
    port = vectorize(cfg, [make_env(cfg, 5 + i, 0, vector_env_idx=i) for i in range(3)])
    ref = jax_vectorize(jcfg, [jax_make_env(jcfg, 5 + i, 0, vector_env_idx=i) for i in range(3)])
    try:
        po, _ = port.reset(seed=5)
        jo, _ = ref.reset(seed=5)
        for k in po:
            np.testing.assert_array_equal(po[k], jo[k])
        finals = 0
        for t, a in enumerate(_actions(port.single_action_space, 3, 20, 1)):
            p, j = port.step(a), ref.step(a)
            for k in p[0]:
                np.testing.assert_array_equal(p[0][k], j[0][k], err_msg=f"step {t}: {k}")
            for x, y in zip(p[1:4], j[1:4]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"step {t}")
            assert ("final_obs" in p[4]) == ("final_obs" in j[4])
            if "final_obs" in p[4]:
                np.testing.assert_array_equal(p[4]["_final_obs"], j[4]["_final_obs"])
                for i in np.nonzero(p[4]["_final_obs"])[0]:
                    finals += 1
                    for k in p[4]["final_obs"][i]:
                        np.testing.assert_array_equal(p[4]["final_obs"][i][k], j[4]["final_obs"][i][k])
        assert finals >= 3
    finally:
        port.close()
        ref.close()


# -- the worker processes -------------------------------------------------------------
def test_a_worker_exception_is_raised_with_its_traceback():
    env = AsyncVectorEnv([SometimesHangs, Fails])
    env.reset()
    with pytest.raises(ValueError, match="the env broke in its worker") as err:
        env.step(np.zeros(2, np.int64))
    cause = err.value.__cause__
    assert isinstance(cause, RemoteTraceback) and "in vector env worker 1" in str(cause)
    assert "Fails.step" in str(cause) or "def step" in str(cause) or "test_torch_vecenv.py" in str(cause)
    assert env.closed and not any(p.is_alive() for p in env.processes)


def test_workers_ignore_sigint_and_sigterm():
    env = AsyncVectorEnv([SometimesHangs, SometimesHangs])
    try:
        env.reset()
        for proc in env.processes:
            os.kill(proc.pid, signal.SIGINT)
            os.kill(proc.pid, signal.SIGTERM)
        time.sleep(0.3)
        obs, *_ = env.step(np.zeros(2, np.int64))
        assert np.allclose(obs[:, 0], 1.0) and all(p.is_alive() for p in env.processes)
    finally:
        env.close()
    assert not any(p.is_alive() for p in env.processes)


def test_close_terminate_leaves_no_process():
    env = _make(3, hang_at=1)
    env.reset()
    env.step_async(np.zeros(3, np.int64))  # every worker wedges in its step
    pids = [p.pid for p in env.processes]
    env.close(terminate=True)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("restart", [False, True])
def test_the_fault_plan_reaches_the_workers(restart):
    """A plan installed in the parent fires inside the workers: a raise at
    each worker's second step crashes the run, or is caught by the worker's
    ``RestartOnException``, which flags it through the info contract."""
    cfg = compose(["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=False",
                   "env.capture_video=False", f"env.restart_on_exception={restart}"])
    faults.install_plan(faults.FaultPlan.from_specs([{"site": "env.step", "kind": "raise", "at": 2}]))
    try:
        envs = vectorize(cfg, [make_env(cfg, i, 0, vector_env_idx=i) for i in range(2)])
    finally:
        faults.clear_plan()  # the workers hold their own copy
    try:
        envs.reset()
        envs.step(np.zeros(2, np.int64))
        if restart:
            *_, info = envs.step(np.zeros(2, np.int64))
            assert info["restart_on_exception"].all() and info["_restart_on_exception"].all()
        else:
            with pytest.raises(faults.InjectedFault) as err:
                envs.step(np.zeros(2, np.int64))
            assert "fault_point" in str(err.value.__cause__)
    finally:
        envs.close()


# -- a run under a crash-and-hang storm ------------------------------------------------
STORM_PLAN = json.dumps({"seed": 11, "plan": [
    {"site": "env.step", "kind": "raise", "every": 10, "max_fires": 3},
    {"site": "env.step", "kind": "hang", "at": 25, "seconds": 30.0, "max_fires": 1},
]})


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_env_crash_and_hang_storm_completes_training(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.data import buffers
    from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR

    monkeypatch.setenv(faults.ENV_VAR, STORM_PLAN)
    repairs = []
    orig_repair = buffers.EnvIndependentReplayBuffer.repair_tail

    def counting_repair(self, env):
        repairs.append(env)
        return orig_repair(self, env)

    monkeypatch.setattr(buffers.EnvIndependentReplayBuffer, "repair_tail", counting_repair)
    before = RESILIENCE_MONITOR.totals()
    try:
        run(["exp=dreamer_v3", "algo=dreamer_v3_XS", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2",
             "env.sync_env=False", "env.restart_on_exception=True", "env.step_deadline_s=2.0",
             "env.max_vecenv_restarts=2", "env.capture_video=False", "algo.per_rank_batch_size=2",
             "algo.per_rank_sequence_length=8", "algo.horizon=4", "algo.cnn_keys.encoder=[rgb]",
             "algo.mlp_keys.encoder=[state]", "algo.world_model.encoder.cnn_channels_multiplier=4",
             "algo.dense_units=16", "algo.world_model.recurrent_model.recurrent_state_size=16",
             "algo.world_model.transition_model.hidden_size=16",
             "algo.world_model.representation_model.hidden_size=16", "algo.learning_starts=8",
             "algo.total_steps=64", "algo.replay_ratio=0.1", "algo.run_test=False", "fabric.accelerator=cpu",
             "checkpoint.every=0", "checkpoint.save_last=False", "buffer.memmap=False", "metric.log_level=0",
             f"log_dir={tmp_path}/logs"])
    finally:
        faults.clear_plan()
    after = RESILIENCE_MONITOR.totals()
    # the hang tripped the watchdog (teardown and recreation) ...
    assert after["stalls"] > before["stalls"] and after["env_restarts"] > before["env_restarts"]
    # ... and the broken streams were repaired in the replay
    assert len(repairs) > 0


def test_a_worker_restart_give_up_leaves_its_postmortem(tmp_path):
    """``RestartOnException`` giving up inside a worker: the parent records
    the give-up (reason ``env crashed``) and dumps ``watchdog`` where the run
    directory is known, then raises the worker's ``RuntimeError``."""
    from sheeprl_tpu_torch.telemetry.recorder import RECORDER

    RECORDER.clear()
    RECORDER.configure(run_dir=str(tmp_path))
    cfg = compose(["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=1", "env.sync_env=False",
                   "env.capture_video=False", "env.restart_on_exception=True", "env.step_deadline_s=0"])
    faults.install_plan(faults.FaultPlan.from_specs([{"site": "env.step", "kind": "raise", "every": 1}]))
    try:
        envs = vectorize(cfg, [make_env(cfg, 0, 0)])
    finally:
        faults.clear_plan()
    try:
        envs.reset()
        with pytest.raises(RuntimeError, match="Environment crashed 5 times"):
            for _ in range(7):
                envs.step(np.zeros(1, np.int64))
    finally:
        envs.close(terminate=True)
    doc = json.loads((tmp_path / "postmortem.json").read_text())
    assert doc["reason"] == "watchdog" and doc["events"][-1] == {**doc["events"][-1], "kind": "watchdog.giveup",
                                                                 "reason": "env crashed", "restarts": 5}


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_a_run_whose_envs_stay_wedged_gives_up_with_a_watchdog_postmortem(tmp_path, monkeypatch):
    """Through ``cli.run``: a hang at every step spends the teardown budget
    (``env.max_vecenv_restarts=1``); the run raises and its postmortem keeps
    the watchdog's reason, the crash event added."""
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv(faults.ENV_VAR, json.dumps({"plan": [{"site": "env.step", "kind": "hang", "every": 1,
                                                             "seconds": 30.0}]}))
    try:
        with pytest.raises(RuntimeError, match="giving up"):
            run(["exp=ppo", "env=dummy", "env.id=discrete_dummy", "env.num_envs=1", "env.sync_env=False",
                 "env.capture_video=False", "env.step_deadline_s=1.0", "env.max_vecenv_restarts=1",
                 "algo.rollout_steps=4", "algo.per_rank_batch_size=4", "algo.mlp_keys.encoder=[state]",
                 "algo.cnn_keys.encoder=[]", "algo.total_steps=8", "fabric.accelerator=cpu", "metric.log_level=0",
                 f"log_dir={tmp_path}"])
    finally:
        faults.clear_plan()
    (post,) = tmp_path.glob("**/postmortem.json")
    doc = json.loads(post.read_text())
    kinds = [e["kind"] for e in doc["events"]]
    assert doc["reason"] == "watchdog" and "watchdog.giveup" in kinds and kinds[-1] == "crash"
