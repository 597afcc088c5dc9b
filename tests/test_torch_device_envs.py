"""The port's device envs against the JAX package's pure-JAX envs, on the CPU.

Every case draws its actions from a numpy seed.  The JAX envs run vmapped on
the CPU; their batched states go to the port through
``sheeprl_tpu_torch.convert.env_state_from_jax``, and the port is handed the
draws the JAX keys make (a reset's uniform init, its cell permutation, or
multiroom's seven draws), since a ``torch.Generator`` cannot replay a JAX key.

* **Transitions**: 64 steps, teacher-forced (each step of the port starts
  from the JAX state of that step, so one ulp cannot derail the rest).
  Integer and boolean leaves, uint8 frames and the flags agree exactly;
  float leaves, observations and rewards within 1e-5 absolute and relative
  (the fp32 tier of ``tests/test_regression/DRIFT.md``: ``sin``/``cos``
  differ between the two CPU libraries by ulps).  A flag may differ only on
  a row whose JAX state lies within that tolerance of its threshold.
* **Resets**: the JAX reset's draws rebuild the JAX state and observation
  exactly.
* **Autoreset**: ``VectorDeviceEnv`` against ``VectorJaxEnv`` over windows
  with terminations and truncations, teacher-forced: the merged state, the
  returned observation and ``final_obs`` as above, and the reset rows keep
  their traced ``level``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.jax.cartpole import JaxCartPole
from sheeprl_tpu.envs.jax.core import VectorJaxEnv
from sheeprl_tpu.envs.jax.forage import JaxForage
from sheeprl_tpu.envs.jax.multiroom import JaxMultiRoom
from sheeprl_tpu.envs.jax.pendulum import JaxPendulum
from sheeprl_tpu.envs.jax.registry import jax_env_from_cfg
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import env_state_from_jax
from sheeprl_tpu_torch.envs.device import VectorDeviceEnv, anakin_enabled, env_from_cfg, make_device_env
from sheeprl_tpu_torch.envs.device.cartpole import CartPole, CartPoleState
from sheeprl_tpu_torch.envs.device.forage import Forage, ForageState
from sheeprl_tpu_torch.envs.device.multiroom import MultiRoom, MultiRoomState
from sheeprl_tpu_torch.envs.device.pendulum import Pendulum, PendulumState

TOL = dict(rtol=1e-5, atol=1e-5)

# id: (JAX env, port env, port state, the JAX env's thresholds on a float leaf)
ENVS = {
    "cartpole": (lambda: JaxCartPole(), lambda: CartPole(), CartPoleState,
                 {"x": JaxCartPole.X_THRESHOLD, "theta": JaxCartPole.THETA_THRESHOLD}),
    "cartpole-level": (lambda: JaxCartPole(max_episode_steps=40, level=0.7),
                       lambda: CartPole(max_episode_steps=40, level=0.7), CartPoleState,
                       {"x": JaxCartPole.X_THRESHOLD, "theta": JaxCartPole.THETA_THRESHOLD}),
    "pendulum": (lambda: JaxPendulum(max_episode_steps=50, level=0.5), lambda: Pendulum(max_episode_steps=50, level=0.5),
                 PendulumState, {}),
    "forage": (lambda: JaxForage(), lambda: Forage(), ForageState, {}),
    "forage-small": (lambda: JaxForage(grid=4, n_food=2, image_hw=16, max_episode_steps=20),
                     lambda: Forage(grid=4, n_food=2, image_hw=16, max_episode_steps=20), ForageState, {}),
    "forage-level": (lambda: JaxForage(level=1.0), lambda: Forage(level=1.0), ForageState, {}),
    "multiroom": (lambda: JaxMultiRoom(max_episode_steps=48), lambda: MultiRoom(max_episode_steps=48),
                  MultiRoomState, {}),
}
N = 6


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_reset_draws(env, key):
    """The draws a JAX env's ``reset(key)`` makes, under the port's names."""
    if isinstance(env, JaxForage):
        k_place, _ = jax.random.split(key)
        return {"cells": jax.random.permutation(k_place, env.grid * env.grid)}
    if isinstance(env, JaxMultiRoom):
        g = env.grid
        k_door, k_start, k_goal, k_krow, k_kcol, k_frow, k_fcol, _ = jax.random.split(key, 8)
        return {
            "door_row": jax.random.randint(k_door, (3,), 0, g),
            "start_row": jax.random.randint(k_start, (), 0, g),
            "goal_row": jax.random.randint(k_goal, (), 0, g),
            "key_row": jax.random.randint(k_krow, (3,), 0, g),
            "key_col": jax.random.randint(k_kcol, (3,), 0, jnp.asarray(env.wall_cols)),
            "food_row": jax.random.randint(k_frow, (env.n_food,), 0, g),
            "food_col": jax.random.randint(k_fcol, (env.n_food,), 0, g),
        }
    k_init, _ = jax.random.split(key)
    if isinstance(env, JaxPendulum):
        return {"init": jax.random.uniform(k_init, (2,), minval=jnp.array([-np.pi, -1.0]),
                                           maxval=jnp.array([np.pi, 1.0]), dtype=jnp.float32)}
    return {"init": jax.random.uniform(k_init, (4,), minval=-0.05, maxval=0.05, dtype=jnp.float32)}


def batch_reset_draws(env, keys):
    """The draws of one JAX reset per key, as the port's batched tensors."""
    draws = jax.vmap(lambda k: jax_reset_draws(env, k))(keys)
    return {k: _t(v) for k, v in draws.items()}


def autoreset_draws(env, state_keys):
    """The reset draws ``VectorJaxEnv.step`` makes from each row's state key."""
    return batch_reset_draws(env, jax.vmap(lambda k: jax.random.split(k)[0])(state_keys))


def draw_actions(rng, port_env, n):
    space = port_env.action_space
    if hasattr(space, "n"):
        return rng.integers(0, space.n, n).astype(np.int32)
    return rng.uniform(-1.25 * space.high, 1.25 * space.high, (n, *space.shape)).astype(np.float32)


def assert_leaves_match(got, want, what):
    """A port state / observation dict against the JAX one: exact for
    integers, booleans and uint8, within ``TOL`` for floats."""
    for name, g in got.items():
        w = np.asarray(want[name])
        g = g.numpy()
        assert g.shape == w.shape, f"{what}.{name}: {g.shape} vs {w.shape}"
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=f"{what}.{name}", **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


def assert_flags_match(got, want, jax_state, thresholds, what):
    """Flags agree exactly, except on a row whose state lies within ``TOL``
    of a termination threshold (where one ulp may flip it)."""
    got, want = got.numpy(), np.asarray(want)
    near = np.zeros(got.shape, bool)
    for leaf, limit in thresholds.items():
        near |= np.abs(np.abs(np.asarray(getattr(jax_state, leaf))) - limit) < TOL["atol"]
    np.testing.assert_array_equal(got[~near], want[~near], err_msg=what)


def state_dict(state):
    return state._asdict()


@pytest.mark.parametrize("case", list(ENVS))
def test_resets_rebuild_the_jax_state(case):
    jax_ctor, port_ctor, state_cls, _ = ENVS[case]
    jenv, penv = jax_ctor(), port_ctor()
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    j_state, j_obs = jax.vmap(jenv.reset)(keys)
    p_state = penv.reset_from(batch_reset_draws(jenv, keys))
    assert isinstance(p_state, state_cls)
    want = {f: getattr(j_state, f) for f in state_cls._fields}
    for name, g in state_dict(p_state).items():
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[name]), err_msg=name)
        assert g.dtype == torch.from_numpy(np.array(want[name])).dtype, name
    for k, v in penv.observe(p_state).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_obs[k]), err_msg=k)


def _multiroom_start(jenv, j_state):
    """Rows that reach a key, a door and the goal within a few steps: row 0
    stands left of the goal with every door open, row 1 on the cell left of
    its first key, rows 2-5 at levels 0, 1, 2 and 2.5 (two to four rooms)."""
    g = jenv.grid
    pos = np.array(j_state.pos)
    pos[0] = np.array(j_state.goal)[0] - np.array([0, 1])
    key0 = np.array(j_state.key_pos)[1, 0]
    pos[1] = [key0[0], max(key0[1] - 1, 0)]
    door_open = np.array(j_state.door_open)
    door_open[0] = True
    level = np.array([0.0, 0.0, 0.0, 1.0, 2.0, 2.5], np.float32)
    assert pos.max() < g
    return j_state._replace(pos=jnp.asarray(pos), door_open=jnp.asarray(door_open), level=jnp.asarray(level))


@pytest.mark.parametrize("case", list(ENVS))
def test_transitions_match_jax(case):
    jax_ctor, port_ctor, state_cls, thresholds = ENVS[case]
    jenv, penv = jax_ctor(), port_ctor()
    rng = np.random.default_rng(7)
    j_state, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), N))
    if isinstance(jenv, JaxMultiRoom):
        j_state = _multiroom_start(jenv, j_state)
    step = jax.jit(jax.vmap(jenv.step))
    seen = {"terminated": 0, "truncated": 0, "reward": 0}
    for t in range(64):
        actions = draw_actions(rng, penv, N)
        if isinstance(jenv, JaxMultiRoom) and t < 3:
            actions[:2] = 4  # rows 0 and 1 walk right: onto the goal, onto the key
        j_next, j_obs, j_rew, j_term, j_trunc = step(j_state, jnp.asarray(actions))
        p_next, p_obs, p_rew, p_term, p_trunc = penv.step(env_state_from_jax(j_state, state_cls), _t(actions))
        what = f"{case} step {t}"
        assert_leaves_match(state_dict(p_next), {f: getattr(j_next, f) for f in state_cls._fields}, what)
        assert_leaves_match(p_obs, j_obs, what)
        np.testing.assert_allclose(p_rew.numpy(), np.asarray(j_rew), err_msg=what, **TOL)
        assert_flags_match(p_term, j_term, j_next, thresholds, what + " terminated")
        assert_flags_match(p_trunc, j_trunc, j_next, thresholds, what + " truncated")
        seen["terminated"] += int(np.asarray(j_term).sum())
        seen["truncated"] += int(np.asarray(j_trunc).sum())
        seen["reward"] += int((np.asarray(j_rew) != 0).sum())
        j_state = j_next
    assert seen["reward"] > 0
    if case in ("forage-small", "multiroom"):
        assert seen["terminated"] > 0 and seen["truncated"] > 0
    if case == "multiroom":
        assert np.asarray(j_state.key_taken).any() and np.asarray(j_state.door_open)[1:].any()


# id: (case of ENVS, steps in the window)
AUTORESET = {
    "cartpole": ("cartpole-level", 48),
    "pendulum": ("pendulum", 56),
    "forage-small": ("forage-small", 48),
    "multiroom": ("multiroom", 56),
}


@pytest.mark.parametrize("case", list(AUTORESET))
def test_autoreset_matches_vector_jax_env(case):
    env_case, steps = AUTORESET[case]
    jax_ctor, port_ctor, state_cls, _ = ENVS[env_case]
    jenv, penv = jax_ctor(), port_ctor()
    jvec = VectorJaxEnv(jenv, N)
    pvec = VectorDeviceEnv(penv, N, "cpu", torch.Generator().manual_seed(0))
    j_state, _ = jvec.reset(jax.random.PRNGKey(5))
    if env_case == "multiroom":
        j_state = _multiroom_start(jenv, j_state)
    elif "level" in state_cls._fields:
        j_state = j_state._replace(level=jnp.asarray(np.linspace(0.0, 0.5, N).astype(np.float32)))
    levels = np.asarray(j_state.level) if "level" in state_cls._fields else None
    if env_case == "cartpole-level":
        # row 0 speeds towards the edge: a termination inside the window
        j_state = j_state._replace(x=j_state.x.at[0].set(2.0), x_dot=j_state.x_dot.at[0].set(2.5))
    step = jax.jit(jvec.step)
    rng = np.random.default_rng(2)
    ends = {"terminated": 0, "truncated": 0}
    for t in range(steps):
        actions = draw_actions(rng, penv, N)
        if env_case == "multiroom" and t < 3:
            actions[:2] = 4  # rows 0 and 1 walk right: onto the goal, onto the key
        draws = autoreset_draws(jenv, j_state.key)
        j_next, j_obs, j_rew, j_term, j_trunc, j_final = step(j_state, jnp.asarray(actions))
        p_next, p_obs, p_rew, p_term, p_trunc, p_final = pvec.step(env_state_from_jax(j_state, state_cls),
                                                                   _t(actions), draws)
        what = f"{case} step {t}"
        np.testing.assert_array_equal(p_term.numpy(), np.asarray(j_term), err_msg=what)
        np.testing.assert_array_equal(p_trunc.numpy(), np.asarray(j_trunc), err_msg=what)
        assert_leaves_match(state_dict(p_next), {f: getattr(j_next, f) for f in state_cls._fields}, what)
        assert_leaves_match(p_obs, j_obs, what + " obs")
        assert_leaves_match(p_final, j_final, what + " final_obs")
        np.testing.assert_allclose(p_rew.numpy(), np.asarray(j_rew), err_msg=what, **TOL)
        done = np.asarray(j_term) | np.asarray(j_trunc)
        if "level" in state_cls._fields:
            np.testing.assert_array_equal(p_next.level.numpy(), levels)  # the reset rows kept theirs
        if done.any():
            assert (p_next.t.numpy()[done] == 0).all()
        ends["terminated"] += int(np.asarray(j_term).sum())
        ends["truncated"] += int(np.asarray(j_trunc).sum())
        j_state = j_next
    assert ends["truncated"] > 0
    if case != "pendulum":  # the pendulum never terminates
        assert ends["terminated"] > 0


def test_vector_env_draws_its_own_resets_on_its_device():
    """Without handed-in draws, the vector env resets finished rows from its
    generator; two envs seeded alike step alike."""
    runs = []
    for _ in range(2):
        vec = VectorDeviceEnv(Forage(grid=4, n_food=1, image_hw=16, max_episode_steps=5), 8, "cpu",
                              torch.Generator().manual_seed(9))
        state, obs = vec.reset()
        frames = [obs["rgb"]]
        for t in range(12):
            state, obs, *_ = vec.step(state, torch.full((8,), t % 5))
            frames.append(obs["rgb"])
        runs.append(torch.stack(frames))
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="generator"):
        VectorDeviceEnv(Forage(), 2, "meta", torch.Generator())


@pytest.mark.parametrize("group,overrides", [
    ("jax_cartpole", ["env.level=0.5", "env.max_episode_steps=77"]),
    ("jax_pendulum", []),
    ("jax_forage", ["env.level=1.0"]),
    ("jax_multiroom", ["env.level=2.0", "env.wrapper.n_food=3"]),
])
def test_env_from_cfg_matches_jax_plumbing(group, overrides):
    args = ["exp=ppo", f"env={group}", *overrides]
    jenv, penv = jax_env_from_cfg(jax_compose(args)), env_from_cfg(compose(args))
    assert type(penv).__name__ == type(jenv).__name__[3:]
    assert penv.max_episode_steps == jenv.max_episode_steps
    for attr in ("level", "grid", "n_food", "image_hw", "cell"):
        assert getattr(penv, attr, None) == getattr(jenv, attr, None), attr
    assert penv.observation_space.spaces.keys() == jenv.observation_space.spaces.keys()
    for k, sp in penv.observation_space.spaces.items():
        assert sp.shape == jenv.observation_space[k].shape and sp.dtype == jenv.observation_space[k].dtype


def test_registry_takes_both_spellings():
    assert type(make_device_env("cartpole")) is type(make_device_env("jax_cartpole")) is CartPole
    with pytest.raises(ValueError, match="Unknown device env"):
        make_device_env("jax_nothing")


# the mode resolution of tests/test_algos/test_anakin.py::TestModeResolution
@pytest.mark.parametrize("overrides,want", [
    (["env=jax_cartpole"], True),
    (["env=gym"], False),
    (["env=jax_cartpole", "algo.anakin=False"], False),
    (["env=jax_forage", "algo.anakin=True"], True),
])
def test_anakin_mode_resolution(overrides, want):
    assert anakin_enabled(compose(["exp=ppo", "algo.mlp_keys.encoder=[state]", *overrides])) is want


def test_anakin_forced_on_a_non_device_env_raises():
    with pytest.raises(ValueError, match="anakin"):
        anakin_enabled(compose(["exp=ppo", "env=gym", "algo.anakin=True"]))
