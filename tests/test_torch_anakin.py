"""The port's Anakin rollouts against the JAX package's, on the CPU.

The JAX side is the package's own: ``make_rollout_fn`` and
``make_recurrent_rollout_fn`` of ``sheeprl_tpu/envs/jax/anakin.py`` with the
real PPO and recurrent PPO agents, and the live ``anakin_phase`` closures of
``sheeprl_tpu/algos/{ppo,a2c}``'s ``main``, captured where ``main`` hands
them to ``fabric.compile`` (as ``tests/test_torch_ppo.py`` captures the
train phases).  Both sides start from one numpy-drawn parameter tree and one
JAX env state (carried across by ``sheeprl_tpu_torch.convert``).  The port is
handed what the JAX keys draw: each step's sampling noise (the Gumbel or
normal draws of the step key) and each step's reset draws (from the rows'
env keys along the JAX trajectory), and the train phase's minibatch orders.
The windows are short (4 envs x 8 steps) and the episode limit 5 steps, so
every window truncates and resets; on cartpole one row also terminates;
forage runs the CNN.

Tolerances: the rollout leaves, values and returns 1e-5 (1e-4 through the
convolutions), discrete actions, dones, flags and episode lengths exactly:
the tiers of ``tests/test_regression/DRIFT.md``.  After a whole phase the
parameters 1e-5 absolute and the losses 1e-5 relative, the train-phase
tolerances (``tests/test_torch_ppo.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.a2c.a2c import main as jax_a2c_main
from sheeprl_tpu.algos.ppo import agent as jax_ppo_agent
from sheeprl_tpu.algos.ppo.ppo import epoch_permutation as jax_epoch_permutation
from sheeprl_tpu.algos.ppo.ppo import main as jax_ppo_main
from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
from sheeprl_tpu.algos.ppo_recurrent import agent as jax_rec_agent
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import _sample as jax_rec_sample
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.envs.jax import anakin as jax_anakin
from sheeprl_tpu.envs.jax.core import VectorJaxEnv
from sheeprl_tpu.envs.jax.registry import jax_env_from_cfg
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
from sheeprl_tpu_torch.algos.ppo.agent import build_agent, sample_actions
from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
from sheeprl_tpu_torch.algos.ppo_recurrent import agent as pt_rec_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import _sample as pt_rec_sample
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import env_state_from_jax, policy_state_from_jax
from sheeprl_tpu_torch.envs.device import VectorDeviceEnv, env_from_cfg
from sheeprl_tpu_torch.envs.device.anakin import (
    episode_stats_from_device,
    init_actor_state,
    make_recurrent_rollout_fn,
    make_rollout_fn,
)
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.utils.optim import set_learning_rate
from sheeprl_tpu_torch.utils.utils import polynomial_decay
from tests.test_torch_device_envs import autoreset_draws
from tests.test_torch_ppo import (
    LOSS_RTOL,
    PARAM_TOL,
    _Captured,
    assert_losses_match,
    assert_params_match,
    draw_params,
    jax_action_noise,
    port_trainer,
)

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
T, B = 8, 4
COMMON = ("fabric.accelerator=cpu", f"env.num_envs={B}", f"algo.rollout_steps={T}", "env.max_episode_steps=5",
          "algo.dense_units=8", "algo.mlp_layers=1")
ENVS = {
    # id: overrides
    "cartpole": ("env=jax_cartpole", "algo.mlp_keys.encoder=[state]", "algo.encoder.mlp_features_dim=6"),
    "pendulum": ("env=jax_pendulum", "algo.mlp_keys.encoder=[state]", "algo.encoder.mlp_features_dim=6"),
    "forage": ("env=jax_forage", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]",
               "algo.encoder.cnn_features_dim=16"),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def capture_jax_anakin_phase(jax_main, overrides, tmp_path, monkeypatch):
    """The raw ``anakin_phase`` closure of a JAX on-policy ``main``, taken
    where ``main`` hands it to ``fabric.compile`` (``main`` stops there)."""
    monkeypatch.chdir(tmp_path)
    cfg = jax_compose([*overrides, "metric.log_level=0", f"log_dir={tmp_path}/jax"])
    fabric = jax_build_fabric(cfg)
    compile_ = type(fabric).compile
    captured = {}

    def spy(self, fn, *, name=None, **kwargs):
        if name is not None and name.endswith(".anakin_phase"):
            captured["fn"] = jax.jit(fn)
            raise _Captured
        return compile_(self, fn, name=name, **kwargs)

    monkeypatch.setattr(type(fabric), "compile", spy)
    with pytest.raises(_Captured):
        jax_main(fabric, cfg)
    monkeypatch.undo()
    return captured["fn"], cfg, fabric


class Side:
    """One env config on both sides: the JAX vector env and a start state,
    the port's vector env and the converted state."""

    def __init__(self, overrides):
        self.jcfg, self.cfg = jax_compose(list(overrides)), compose(list(overrides))
        self.jvenv = VectorJaxEnv(jax_env_from_cfg(self.jcfg), B)
        self.penv = env_from_cfg(self.cfg)
        self.pvenv = VectorDeviceEnv(self.penv, B, "cpu", torch.Generator().manual_seed(0))
        self.state_cls = type(self.penv.reset(1, torch.Generator(), "cpu")[0])
        self.obs_space, self.act_space = self.jvenv.single_observation_space, self.jvenv.single_action_space
        self.p_act_space = self.penv.action_space
        self.actions_dim, self.cont = jax_spaces_to_dims(self.act_space)

    def jax_actor(self, key, update=0, extra=None):
        """The JAX actor after a reset; on cartpole row 0 speeds towards
        the edge, so the window has a termination besides its truncations."""
        env_state, _ = self.jvenv.reset(key)
        if hasattr(env_state, "x_dot"):
            env_state = env_state._replace(x=env_state.x.at[0].set(2.3), x_dot=env_state.x_dot.at[0].set(2.5))
        return {"env": env_state, "ep_ret": jnp.zeros((B,), jnp.float32), "ep_len": jnp.zeros((B,), jnp.int32),
                **(extra or {}), "update": jnp.asarray(update, jnp.int32)}

    def port_actor(self, jactor, extra=None):
        return {"env": env_state_from_jax(jactor["env"], self.state_cls), "ep_ret": _t(jactor["ep_ret"]),
                "ep_len": _t(jactor["ep_len"]), **(extra or {}), "update": int(jactor["update"])}

    def noise(self, key):
        return [[_t(x) for x in jax_action_noise(k, B, self.actions_dim, self.cont, "auto")]
                for k in jax.random.split(key, T)]

    def reset_draws(self, env_state, actions):
        """The reset draws of each step along the JAX trajectory the stored
        ``actions`` make (they depend on the rows' keys, which a reset reseeds)."""
        to_env = jax_anakin.env_actions_fn(self.act_space)
        step = jax.jit(self.jvenv.step)
        draws = []
        for t in range(T):
            draws.append(autoreset_draws(self.jvenv.env, env_state.key))
            env_state = step(env_state, to_env(jnp.asarray(actions[t])))[0]
        return draws


def assert_rollouts_match(got, want, tol, what, exact=("dones", "actions")):
    """Leaf by leaf; the ``exact`` keys (discrete actions, dones) exactly."""
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, f"{what}.{k}: {g.shape} vs {w.shape}"
        if np.issubdtype(w.dtype, np.floating) and k not in exact:
            np.testing.assert_allclose(g, w, err_msg=f"{what}.{k}", **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{k}")


def assert_stats_match(got, want):
    for k in ("ep_done", "ep_len"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["ep_ret"].numpy(), np.asarray(want["ep_ret"]), **TOL)
    rets, lens = episode_stats_from_device(got)
    j_rets, j_lens = jax_anakin.episode_stats_from_device(want)
    np.testing.assert_array_equal(lens, j_lens)
    np.testing.assert_allclose(rets, j_rets, **TOL)
    assert len(lens) > 0  # every window finishes episodes


def assert_env_states_match(got, want, state_cls):
    for f in state_cls._fields:
        w = np.asarray(getattr(want, f))
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(getattr(got, f).numpy(), w, err_msg=f, **TOL)
        else:
            np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)


@pytest.mark.parametrize("env", list(ENVS))
def test_rollout_matches_jax(env):
    side = Side(("exp=ppo", *COMMON, *ENVS[env]))
    jagent, init = jax_ppo_agent.build_agent(jax_build_fabric(side.jcfg), side.actions_dim, side.cont, side.jcfg,
                                             side.obs_space)
    params = draw_params(init, seed=4)
    cnn_keys, mlp_keys = tuple(side.cfg.algo.cnn_keys.encoder), tuple(side.cfg.algo.mlp_keys.encoder)
    jroll = jax.jit(jax_anakin.make_rollout_fn(
        side.jvenv, jagent.apply, lambda out, k: jax_ppo_agent.sample_actions(out, side.actions_dim, side.cont, k),
        cnn_keys=cnn_keys, mlp_keys=mlp_keys, action_space=side.act_space, gamma=0.9, rollout_steps=T))
    jactor = side.jax_actor(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    j_actor2, j_traj, j_last, j_stats = jroll(params, jactor, key)

    agent = build_agent(build_fabric(side.cfg), side.actions_dim, side.cont, side.cfg, side.obs_space,
                        policy_state_from_jax(jax.device_get(params)))
    proll = make_rollout_fn(side.pvenv, agent,
                            lambda out, noise: sample_actions(out, side.actions_dim, side.cont, noise),
                            cnn_keys=cnn_keys, mlp_keys=mlp_keys, action_space=side.p_act_space, gamma=0.9,
                            rollout_steps=T)
    p_actor2, p_traj, p_last, p_stats = proll(side.port_actor(jactor), side.noise(key),
                                              side.reset_draws(jactor["env"], j_traj["actions"]))
    tol = CONV_TOL if cnn_keys else TOL
    assert set(p_traj) == set(j_traj)
    assert_rollouts_match(p_traj, j_traj, tol, env, exact=("dones",) if side.cont else ("dones", "actions"))
    assert_rollouts_match(p_last, j_last, tol, env + " last_obs")
    assert_stats_match(p_stats, j_stats)
    assert_env_states_match(p_actor2["env"], j_actor2["env"], side.state_cls)
    assert p_actor2["update"] == int(j_actor2["update"]) == 1
    dones = np.asarray(j_traj["dones"]).astype(bool)
    assert dones.any()
    if env == "cartpole":
        # a terminated step keeps the env's reward of 1, a truncated one takes the bootstrap
        rewards = np.asarray(j_traj["rewards"])[dones]
        assert (rewards == 1.0).any() and (rewards != 1.0).any()


def test_recurrent_rollout_matches_jax(tmp_path, monkeypatch):
    overrides = ("exp=ppo_recurrent", *COMMON, "env=jax_cartpole", "env.mask_velocities=False",
                 "algo.mlp_keys.encoder=[state]", "algo.rnn.lstm.hidden_size=6")
    side = Side(overrides)
    jagent, init = jax_rec_agent.build_agent(jax_build_fabric(side.jcfg), side.actions_dim, side.cont, side.jcfg,
                                             side.obs_space)
    params = draw_params(init, seed=2)
    dims, cont = side.actions_dim, side.cont

    def step_apply(p, carry, obs, prev_a, first):
        return jagent.apply(p, method=jax_rec_agent.RecurrentPPOAgent.step, carry=carry, obs=obs,
                            prev_actions=prev_a, is_first=first)

    jroll = jax.jit(jax_anakin.make_recurrent_rollout_fn(
        side.jvenv, step_apply, lambda out, k: jax_rec_sample(out, dims, cont, k),
        lambda a: jax_rec_agent.one_hot_actions(a, dims, cont), mlp_keys=("state",), action_space=side.act_space,
        gamma=0.9, rollout_steps=T))
    rng = np.random.default_rng(3)
    carry = tuple(np.tanh(rng.standard_normal((B, 6))).astype(np.float32) for _ in range(2))
    extra = {"carry": carry, "prev_actions": np.zeros((B, 2), np.float32), "is_first": np.ones((B, 1), np.float32)}
    jactor = side.jax_actor(jax.random.PRNGKey(5), update=2, extra=jax.tree.map(jnp.asarray, extra))
    key = jax.random.PRNGKey(6)
    j_actor2, j_traj, j_init, j_last_v, j_stats = jroll(params, jactor, key)

    port = pt_rec_agent.build_agent(build_fabric(side.cfg), dims, cont, side.cfg, side.obs_space,
                                    policy_state_from_jax(jax.device_get(params)))
    proll = make_recurrent_rollout_fn(
        side.pvenv, port.step, lambda out, noise: pt_rec_sample(out, dims, cont, noise),
        lambda a: pt_rec_agent.one_hot_actions(a, dims, cont), mlp_keys=("state",), action_space=side.p_act_space,
        gamma=0.9, rollout_steps=T)
    p_extra = {"carry": tuple(_t(c) for c in carry), "prev_actions": _t(extra["prev_actions"]),
               "is_first": _t(extra["is_first"])}
    p_actor2, p_traj, p_init, p_last_v, p_stats = proll(side.port_actor(jactor, p_extra), side.noise(key),
                                                        side.reset_draws(jactor["env"], j_traj["actions"]))
    assert set(p_traj) == set(j_traj)
    assert_rollouts_match(p_traj, j_traj, TOL, "recurrent")
    np.testing.assert_allclose(p_last_v.numpy(), np.asarray(j_last_v), **TOL)
    for got, want in zip((*p_init, *p_actor2["carry"]), (*j_init, *j_actor2["carry"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("prev_actions", "is_first"):
        np.testing.assert_array_equal(p_actor2[k].numpy(), np.asarray(j_actor2[k]), err_msg=k)
    assert_stats_match(p_stats, j_stats)
    assert_env_states_match(p_actor2["env"], j_actor2["env"], side.state_cls)
    assert np.asarray(j_traj["is_first"])[1:].any()  # an episode restarted inside the window


PHASES = {
    # id: (JAX main, port trainer, overrides)
    "ppo-cartpole": (jax_ppo_main, PPOTrainer, ("exp=ppo", *ENVS["cartpole"], "algo.per_rank_batch_size=12",
                                                "algo.update_epochs=2", "algo.ent_coef=0.01", "algo.anneal_lr=True",
                                                "algo.anneal_clip_coef=True", "algo.anneal_ent_coef=True",
                                                "algo.total_steps=320")),
    "ppo-pendulum": (jax_ppo_main, PPOTrainer, ("exp=ppo", *ENVS["pendulum"], "algo.per_rank_batch_size=16",
                                                "algo.update_epochs=2", "algo.clip_vloss=True",
                                                "algo.normalize_advantages=True")),
    "a2c-cartpole": (jax_a2c_main, A2CTrainer, ("exp=a2c", *ENVS["cartpole"], "algo.optimizer.eps=0.1",
                                                "algo.ent_coef=0.01", "algo.anneal_lr=True", "algo.total_steps=320")),
}


@pytest.mark.parametrize("case", list(PHASES))
def test_anakin_phase_matches_jax(case, tmp_path, monkeypatch):
    """One whole phase, rollout and update, from the actor at update 3 (the
    annealed coefficients read the counter): the parameters, the losses, the
    episode statistics and the env state after it."""
    jax_main, trainer_cls, extra = PHASES[case]
    overrides = (*COMMON, *extra)
    jfn, jcfg, jfabric = capture_jax_anakin_phase(jax_main, overrides, tmp_path, monkeypatch)
    side = Side(overrides)
    dims, cont = side.actions_dim, side.cont
    jagent, init = jax_ppo_agent.build_agent(jfabric, dims, cont, jcfg, side.obs_space)
    params = draw_params(init, seed=5)
    optimizer = jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    jactor = side.jax_actor(jax.random.PRNGKey(7), update=3)
    key = jax.random.PRNGKey(8)
    new_params, _, j_actor2, _, j_losses, j_stats = jfn(params, optimizer.init(params), jactor, key)

    is_ppo = trainer_cls is PPOTrainer
    k_roll, k_train = jax.random.split(key, 3 if is_ppo else 2)[:2]
    mlp_keys = tuple(jcfg.algo.mlp_keys.encoder)
    jroll = jax.jit(jax_anakin.make_rollout_fn(
        side.jvenv, jagent.apply, lambda out, k: jax_ppo_agent.sample_actions(out, dims, cont, k),
        cnn_keys=(), mlp_keys=mlp_keys, action_space=side.act_space, gamma=float(jcfg.algo.gamma), rollout_steps=T))
    j_actions = jroll(params, jactor, k_roll)[1]["actions"]

    trainer, cfg = port_trainer(overrides, params, trainer_cls, dims, cont, side.obs_space, T, B)
    total_iters = int(cfg.algo.total_steps) // (B * T)
    a = cfg.algo
    coef = {"clip_coef": float(a.get("clip_coef", 0.0)), "ent_coef": float(a.ent_coef)}
    for name in ("clip_coef", "ent_coef"):
        if a.get(f"anneal_{name}", False) and name in trainer.SCHEDULES:
            coef[name] = polynomial_decay(3, initial=coef[name], max_decay_steps=total_iters)
    if a.anneal_lr:
        set_learning_rate(trainer.optimizer, polynomial_decay(3, initial=float(a.optimizer.lr),
                                                              max_decay_steps=total_iters))
    proll = make_rollout_fn(side.pvenv, trainer.agent, lambda out, noise: sample_actions(out, dims, cont, noise),
                            cnn_keys=(), mlp_keys=mlp_keys, action_space=side.p_act_space, gamma=float(a.gamma),
                            rollout_steps=T, store_logprobs=trainer_cls.STORES_LOGPROBS)
    p_actor2, rollout, last_obs, p_stats = proll(side.port_actor(jactor), side.noise(k_roll),
                                                 side.reset_draws(jactor["env"], j_actions))
    perms = None
    if is_ppo:
        assert trainer.num_minibatches > 1
        perms = [_t(np.asarray(jax_epoch_permutation(k, T, B, trainer.batch_size, trainer.num_minibatches,
                                                     bool(jcfg.buffer.share_data), 1)))
                 for k in jax.random.split(k_train, trainer.update_epochs)]
    losses = trainer.train_phase(rollout, last_obs, perms, coef["clip_coef"], coef["ent_coef"])
    assert_losses_match(losses, j_losses, rtol=LOSS_RTOL)
    assert_params_match(trainer.agent, new_params, **PARAM_TOL)
    assert_stats_match(p_stats, j_stats)
    assert_env_states_match(p_actor2["env"], j_actor2["env"], side.state_cls)
    assert p_actor2["update"] == int(j_actor2["update"]) == 4


def test_rollout_makes_no_host_round_trip(monkeypatch):
    """The CPU's stand-in for the card's sync gate: inside the rollout every
    call that would make the host wait for the device (a tensor read back,
    tested for truth, or made from host data) raises."""
    side = Side(("exp=ppo", *COMMON, *ENVS["forage"]))
    agent = build_agent(build_fabric(side.cfg), side.actions_dim, side.cont, side.cfg, side.obs_space)
    gen = torch.Generator().manual_seed(0)
    proll = make_rollout_fn(side.pvenv, agent, lambda out, noise: sample_actions(out, side.actions_dim, False, noise),
                            cnn_keys=("rgb",), mlp_keys=(), action_space=side.p_act_space, gamma=0.9,
                            rollout_steps=T)
    actor = init_actor_state(side.pvenv, 0)

    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"{name} inside the rollout")
        return raiser

    for name in ("item", "tolist", "numpy", "cpu", "nonzero", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    for name in ("tensor", "as_tensor", "from_numpy", "nonzero", "masked_select"):
        monkeypatch.setattr(torch, name, refuse(f"torch.{name}"))
    actor, traj, last_obs, stats = proll(actor, gen)
    monkeypatch.undo()
    assert traj["rgb"].shape == (T, B, 64, 64, 3) and traj["rgb"].dtype == torch.float32
    assert stats["ep_done"].any()
