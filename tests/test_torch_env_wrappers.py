"""The port's env wrappers and ``make_env`` against the JAX package's, on the CPU.

Each wrapper is held to its JAX counterpart around the same scripted env
(one per package, emitting the same observations and rewards), and the whole
``make_env`` pipeline to the JAX one on the same env and seed: the pixel
dummy env through resize, grayscale, frame stack, actions and reward as
observation, reward clipping and the time limit; gymnasium's ``CartPole-v1``
with its velocities masked; the DMC ``cartpole_balance`` task rendered.
gymnasium and ``dm_control`` are installed here (the H100 machine has
neither).  Everything agrees exactly: both sides run the same numpy and cv2
code on the same inputs.  The device-env adapter is held to the JAX
adapter's step from the same state, and to the gymnasium seeding contract.
"""

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.envs import wrappers as jax_wrappers
from sheeprl_tpu.envs.jax.adapter import JaxToGymAdapter
from sheeprl_tpu.envs.jax.registry import make_jax_env
from sheeprl_tpu.utils import env as jax_env_utils
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import env_state_from_jax
from sheeprl_tpu_torch.envs import spaces, wrappers
from sheeprl_tpu_torch.envs.device import make_device_env
from sheeprl_tpu_torch.envs.device.adapter import DeviceEnvAdapter
from sheeprl_tpu_torch.envs.dummy import Env
from sheeprl_tpu_torch.utils import env as env_utils
from sheeprl_tpu_torch.utils.env import make_env, vectorize


def scripted(package, obs, rewards, action_space, observation_space):
    """An env of ``package`` ("jax" or "port") that returns ``obs[k]`` and
    ``rewards[k]`` at its k-th step (``obs[0]`` on reset)."""

    class Scripted(gym.Env if package == "jax" else Env):
        def __init__(self):
            self.observation_space, self.action_space, self.k = observation_space, action_space, 0

        def reset(self, *, seed=None, options=None):
            self.k = 0
            return obs[0], {}

        def step(self, action):
            self.k += 1
            return obs[self.k], rewards[self.k], False, False, {}

    return Scripted()


def both(obs, rewards, space_args, obs_shape, dtype):
    """The JAX and port scripted envs over one script, with the matching spaces."""
    kind, arg = space_args
    gym_act = {"discrete": gym.spaces.Discrete, "multidiscrete": gym.spaces.MultiDiscrete,
               "box": lambda a: gym.spaces.Box(-1.0, 1.0, (a,), np.float32)}[kind](arg)
    pt_act = {"discrete": spaces.Discrete, "multidiscrete": spaces.MultiDiscrete,
              "box": lambda a: spaces.Box(-1.0, 1.0, (a,), np.float32)}[kind](arg)
    lo, hi = (0, 255) if dtype == np.uint8 else (-np.inf, np.inf)
    return (scripted("jax", obs, rewards, gym_act, gym.spaces.Box(lo, hi, obs_shape, dtype)),
            scripted("port", obs, rewards, pt_act, spaces.Box(lo, hi, obs_shape, dtype)))


def assert_same(a, b, what=""):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=what)


def run_both(jenv, penv, actions, seed=None):
    """Reset and step both envs with the same actions; every output equal."""
    assert_same(jenv.reset(seed=seed)[0], penv.reset(seed=seed)[0], "reset")
    for t, a in enumerate(actions):
        j_out, p_out = jenv.step(a), penv.step(a)
        assert_same(j_out[0], p_out[0], f"step {t} obs")
        assert float(j_out[1]) == float(p_out[1]) and bool(j_out[2]) == bool(p_out[2]) \
            and bool(j_out[3]) == bool(p_out[3]), f"step {t}: {j_out[1:4]} vs {p_out[1:4]}"


def assert_spaces_match(jspace, pspace):
    assert set(jspace.spaces) == set(pspace.spaces)
    for k, sp in pspace.spaces.items():
        assert sp.shape == jspace[k].shape and sp.dtype == jspace[k].dtype, k


IMAGES = {
    # id: (frame shape, screen size, grayscale)
    "rgb-84-to-64-gray": ((84, 84, 3), 64, True),
    "rgb-64-to-84": ((64, 64, 3), 84, False),
    "chw-32-to-16-gray": ((3, 32, 32), 16, True),
    "gray-2d-48-to-rgb": ((48, 48), 48, False),
    "rgb-64-to-84-gray": ((64, 64, 3), 84, True),
}


@pytest.mark.parametrize("case", list(IMAGES))
def test_image_transform_matches_jax(case):
    shape, screen, gray = IMAGES[case]
    rng = np.random.default_rng(0)
    frames = [{"rgb": rng.integers(0, 256, shape, dtype=np.uint8)} for _ in range(4)]
    jbase, pbase = both(frames, [0.0] * 4, ("discrete", 3), shape, np.uint8)
    jbase.observation_space = gym.spaces.Dict({"rgb": jbase.observation_space})
    pbase.observation_space = spaces.Dict({"rgb": pbase.observation_space})
    jenv = jax_env_utils._ImageTransform(jbase, ["rgb"], screen, gray)
    penv = env_utils._ImageTransform(pbase, ["rgb"], screen, gray)
    assert_spaces_match(jenv.observation_space, penv.observation_space)
    run_both(jenv, penv, [0, 1, 2])


@pytest.mark.parametrize("shape,dtype", [((4,), np.float32), ((16, 16, 3), np.uint8)], ids=["vector", "image"])
def test_dict_obs_matches_jax(shape, dtype):
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, shape).astype(dtype) for _ in range(3)]
    jbase, pbase = both(frames, [0.0] * 3, ("discrete", 2), shape, dtype)
    jenv, penv = jax_env_utils._DictObs(jbase), env_utils._DictObs(pbase)
    assert_spaces_match(jenv.observation_space, penv.observation_space)
    run_both(jenv, penv, [0, 1])


ACTION_SPACES = {
    # id: ((kind, arg), actions, noop, num_stack, dilation)
    "discrete": (("discrete", 4), [1, 3, 0, 2, 2], 0, 3, 1),
    "multidiscrete-dilated": (("multidiscrete", [3, 2]), [[0, 1], [2, 0], [1, 1], [2, 1], [0, 0]], [0, 0], 2, 2),
    "box": (("box", 2), [[0.5, -0.5], [0.1, 0.2], [-1.0, 1.0], [0.0, 0.3], [0.7, 0.7]], [0.0, 0.0], 2, 1),
}


@pytest.mark.parametrize("case", list(ACTION_SPACES))
def test_actions_reward_as_observation_and_clipping_match_jax(case):
    space_args, actions, noop, num_stack, dilation = ACTION_SPACES[case]
    rng = np.random.default_rng(2)
    frames = [{"state": rng.standard_normal(4).astype(np.float32)} for _ in range(6)]
    rewards = [0.0, 2.5, -0.3, 0.0, -4.0, 0.7]
    jbase, pbase = both(frames, rewards, space_args, (4,), np.float32)
    jbase.observation_space = gym.spaces.Dict({"state": jbase.observation_space})
    pbase.observation_space = spaces.Dict({"state": pbase.observation_space})
    jenv = jax_wrappers.ActionsAsObservationWrapper(jbase, num_stack, noop, dilation)
    penv = wrappers.ActionsAsObservationWrapper(pbase, num_stack, noop, dilation)
    jenv = gym.wrappers.TransformReward(jax_wrappers.RewardAsObservationWrapper(jenv), lambda r: float(np.tanh(r)))
    penv = wrappers.TransformReward(wrappers.RewardAsObservationWrapper(penv), lambda r: float(np.tanh(r)))
    assert_spaces_match(jenv.observation_space, penv.observation_space)
    run_both(jenv, penv, [np.asarray(a) for a in actions])


# the make_env pipelines of both packages on one config, seed and action sequence
PIPELINES = {
    "pixel-dummy-gray-stack-aao-rao-clip": (
        ["env=dummy", "env.id=pixel_grid_dummy", "env.screen_size=84", "env.grayscale=True", "env.frame_stack=4",
         "env.frame_stack_dilation=2", "env.actions_as_observation.num_stack=2",
         "env.actions_as_observation.noop=0", "env.reward_as_observation=True", "env.clip_rewards=True",
         "env.max_episode_steps=10"], 14),
    "cartpole-mask-velocities": (["env=gym", "env.id=CartPole-v1", "env.mask_velocities=True"], 30),
    "dmc-cartpole-balance": (["env=dmc", "env.id=cartpole_balance", "env.wrapper.from_vectors=True",
                              "env.max_episode_steps=6"], 8),
}


@pytest.mark.parametrize("case", list(PIPELINES))
def test_make_env_pipeline_matches_jax(case):
    overrides, steps = PIPELINES[case]
    args = ["exp=ppo", "fabric.accelerator=cpu", "env.capture_video=False", *overrides]
    jenv = jax_env_utils.make_env(jax_compose(args), 5)()
    penv = make_env(compose(args), 5)()
    assert_spaces_match(jenv.observation_space, penv.observation_space)
    rng = np.random.default_rng(3)
    space = penv.action_space
    if isinstance(space, spaces.Discrete):
        actions = [int(a) for a in rng.integers(0, space.n, steps)]
    else:
        actions = list(rng.uniform(space.low, space.high, (steps, *space.shape)).astype(np.float32))
    run_both(jenv, penv, actions, seed=11)


def test_mask_velocities_needs_a_gymnasium_id():
    with pytest.raises(NotImplementedError, match="Velocity masking"):
        make_env(compose(["exp=ppo", "env=jax_cartpole", "fabric.accelerator=cpu", "env.mask_velocities=True"]), 0)()


@pytest.mark.parametrize("group", ["atari", "crafter", "minerl", "minedojo", "diambra", "super_mario_bros"])
def test_unported_suites_raise_naming_the_roadmap_item(group):
    cfg = compose(["exp=ppo", f"env={group}", "fabric.accelerator=cpu", "env.capture_video=False"])
    with pytest.raises(NotImplementedError, match="queue A item 2"):
        make_env(cfg, 0)()


@pytest.mark.parametrize("override", ["env.capture_video=True", "fault_injection=chaos_env"])
def test_unported_runtime_settings_raise_naming_the_roadmap_item(tmp_path, override):
    """``env.capture_video`` still raises, naming its item.  The env fault
    sites are ported now: ``fault_injection=chaos_env``, installed as
    ``cli.run`` installs it, wraps the env, and its 40th step crashes into
    ``RestartOnException``."""
    from sheeprl_tpu_torch.resilience.faults import clear_plan, install_from_config

    cfg = compose(["exp=ppo", "env=dummy", "fabric.accelerator=cpu", "env.capture_video=False", override])
    if override == "env.capture_video=True":
        with pytest.raises(NotImplementedError, match="queue A item 6"):
            make_env(cfg, 0, run_name=str(tmp_path))
        return
    install_from_config(cfg)
    try:
        cfg.env.restart_on_exception = True
        env = make_env(cfg, 0, run_name=str(tmp_path))()
        restarts = [i for i in range(40) if env.step(env.action_space.sample())[-1].get("restart_on_exception")]
    finally:
        clear_plan()
    assert restarts == [39]


@pytest.mark.parametrize("name", ["cartpole", "pendulum", "forage", "multiroom"])
def test_device_adapter_steps_as_the_jax_adapter(name):
    """From one state (the JAX adapter's, converted), both adapters step alike."""
    jad = JaxToGymAdapter(make_jax_env(name, max_episode_steps=6), seed=0)
    pad = DeviceEnvAdapter(make_device_env(name, max_episode_steps=6), "cpu", seed=0)
    jad.reset(seed=4)
    pad.reset(seed=4)
    state_cls = type(pad._state)
    rng = np.random.default_rng(4)
    truncated = False
    for t in range(8):
        pad._state = env_state_from_jax(jax.tree.map(lambda x: np.asarray(x)[None], jad._state), state_cls)
        a = pad.action_space.sample() if name == "pendulum" else int(rng.integers(pad.action_space.n))
        j_out, p_out = jad.step(a), pad.step(a)
        for k in j_out[0]:
            if j_out[0][k].dtype == np.uint8:
                np.testing.assert_array_equal(p_out[0][k], j_out[0][k])
            else:
                np.testing.assert_allclose(p_out[0][k], j_out[0][k], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p_out[1], j_out[1], rtol=1e-5, atol=1e-5)
        assert p_out[2:4] == j_out[2:4], f"step {t}"
        truncated = truncated or j_out[3]
    assert truncated or name == "forage" and j_out[2]  # the in-env limit (or the last food) ended the episode


def test_device_adapter_follows_the_seeding_contract():
    env = DeviceEnvAdapter(make_device_env("forage"), "cpu")
    first = env.reset(seed=3)[0]["rgb"]
    assert np.array_equal(env.reset(seed=3)[0]["rgb"], first)
    later = [env.reset()[0]["rgb"] for _ in range(3)]
    assert not all(np.array_equal(x, first) for x in later)  # unseeded resets go on with the stream
    unseeded = DeviceEnvAdapter(make_device_env("forage"), "cpu")
    unseeded.reset()  # seeded from np_random


def test_device_env_through_make_env_and_vectorize():
    """A device env in the host loops' vector env: the run's device (the CPU
    here), same-step autoreset with the real final observation."""
    cfg = compose(["exp=ppo", "env=jax_cartpole", "fabric.accelerator=cpu", "env.max_episode_steps=3"])
    envs = vectorize(cfg, [make_env(cfg, 0 + i, 0, vector_env_idx=i) for i in range(2)])
    inner = envs.envs[0]
    while not isinstance(inner, DeviceEnvAdapter):
        inner = inner.env
    assert inner.device == torch.device("cpu")
    envs.reset(seed=0)
    for t in range(3):
        obs, rewards, terminated, truncated, info = envs.step(np.array([0, 1]))
    assert truncated.all() and "final_obs" in info and info["final_obs"][0]["state"].shape == (4,)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_env(compose(["exp=ppo", "env=jax_cartpole", "fabric.accelerator=gpu"]), 0)()
