"""PPO of the port against the JAX package's, on the CPU.

Every case draws its inputs from a numpy seed and hands the port the draws
the JAX keys make.  The whole train phase is the live JAX ``train_phase``
closure of ``sheeprl_tpu/algos/ppo/ppo.py::main``, captured where ``main``
hands it to ``fabric.compile`` (:func:`capture_jax_train_phase`): both start
from one numpy-drawn parameter tree (carried across by
``sheeprl_tpu_torch.convert``), take the same rollout and the minibatch
orders JAX draws from its key, and run 2 epochs of 2 minibatches.

Tolerances: actions, log-probs, entropies, losses and GAE 1e-5 (1e-4 through
convolutions, the tiers of ``tests/test_regression/DRIFT.md``); discrete
actions exactly.  After the train phase (four Adam steps of lr 1e-3, eps
1e-4, which move the parameters by up to 4e-3) every parameter agrees within
1e-5 absolute and the last losses within 1e-5 relative: the differences seen
are 1.3e-6 through the convolutions and 6e-8 without them, fp32 summation
order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo import agent as jax_agent
from sheeprl_tpu.algos.ppo import loss as jax_loss
from sheeprl_tpu.algos.ppo.ppo import epoch_permutation as jax_epoch_permutation
from sheeprl_tpu.algos.ppo.ppo import main as jax_ppo_main
from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu.utils.utils import gae as jax_gae
from sheeprl_tpu_torch.algos.ppo import agent as pt_agent
from sheeprl_tpu_torch.algos.ppo import loss as pt_loss
from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer, epoch_permutation, pad_permutation
from sheeprl_tpu_torch.algos.ppo.utils import obs_to_np
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import policy_state_from_jax
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.utils.optim import build_optimizer
from sheeprl_tpu_torch.utils.utils import gae

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=0.0, atol=1e-5)
LOSS_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# -- shared harness (the A2C and recurrent PPO tests use it too) --------------
def draw_params(shapes, seed=0):
    """A flax parameter tree with numpy-drawn values of the given shapes:
    kernels ~ N(0, 1/fan_in), LayerNorm scales near one, the rest small."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("kernel"):
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * noise if name.endswith("scale") else 0.1 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


class _Captured(Exception):
    pass


def capture_jax_train_phase(jax_main, overrides, tmp_path, monkeypatch):
    """The raw ``train_phase`` closure of a JAX on-policy ``main``, taken
    where ``main`` hands it to ``fabric.compile`` (``main`` stops there),
    jitted with the static arguments ``main`` declares; with the JAX config,
    fabric and spaces."""
    monkeypatch.chdir(tmp_path)
    cfg = jax_compose([*overrides, "env.sync_env=True", "metric.log_level=0", f"log_dir={tmp_path}/jax"])
    fabric = jax_build_fabric(cfg)
    compile_ = type(fabric).compile
    captured = {}

    def spy(self, fn, *, name=None, static_argnames=(), **kwargs):
        if name is not None and name.endswith(".train_phase"):
            captured["fn"] = jax.jit(fn, static_argnames=static_argnames)
            raise _Captured
        return compile_(self, fn, name=name, static_argnames=static_argnames, **kwargs)

    monkeypatch.setattr(type(fabric), "compile", spy)
    with pytest.raises(_Captured):
        jax_main(fabric, cfg)
    monkeypatch.undo()
    obs_space, act_space = jax_probe_spaces(cfg)
    return captured["fn"], cfg, fabric, obs_space, act_space


def assert_params_match(port_module, jax_params, **tol):
    want = policy_state_from_jax(jax.device_get(jax_params))
    got = port_module.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), err_msg=k, **tol)


def assert_losses_match(got, want, rtol=LOSS_RTOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=rtol, atol=rtol * 0.1)


# -- sampling and evaluation -----------------------------------------------------
SAMPLING = {
    # id: (actions_dim, is_continuous, distribution.type)
    "discrete": ((4,), False, "auto"),
    "multidiscrete": ((3, 2), False, "auto"),
    "continuous-auto": ((3,), True, "auto"),
    "continuous-trunc_normal": ((3,), True, "trunc_normal"),
    "continuous-tanh_normal": ((3,), True, "tanh_normal"),
}


def jax_action_noise(key, n, actions_dim, is_continuous, dist_type):
    """The draws JAX's ``sample_actions`` makes from ``key`` for ``n`` rows."""
    if not is_continuous:
        return [np.asarray(jax.random.gumbel(k, (n, d))) for k, d in
                zip(jax.random.split(key, len(actions_dim)), actions_dim)]
    if dist_type == "trunc_normal":
        return [np.asarray(jax.random.uniform(key, (n, actions_dim[0]), jnp.float32, 1e-6, 1.0 - 1e-6))]
    return [np.asarray(jax.random.normal(key, (n, actions_dim[0])))]


@pytest.mark.parametrize("case", list(SAMPLING))
@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
def test_sample_and_evaluate_actions(case, greedy):
    actions_dim, cont, dist_type = SAMPLING[case]
    rng = np.random.default_rng(0)
    n = 6
    out = rng.standard_normal((n, sum(actions_dim) * (2 if cont else 1))).astype(np.float32) * 1.5
    key = jax.random.PRNGKey(5)
    ja, jlp, jent = jax_agent.sample_actions(jnp.asarray(out), actions_dim, cont, key, greedy=greedy,
                                             dist_type=dist_type)
    noise = None if greedy else [_t(x) for x in jax_action_noise(key, n, actions_dim, cont, dist_type)]
    pa, plp, pent = pt_agent.sample_actions(_t(out), actions_dim, cont, noise, greedy=greedy, dist_type=dist_type)
    if cont:
        np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **TOL)
    else:
        assert pa.dtype == torch.float32 and pa.shape == (n, len(actions_dim))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), **TOL)
    np.testing.assert_allclose(pent.numpy(), np.asarray(jent), **TOL)
    jlp2, jent2 = jax_agent.evaluate_actions(jnp.asarray(out), ja, actions_dim, cont, dist_type=dist_type)
    plp2, pent2 = pt_agent.evaluate_actions(_t(out), _t(ja), actions_dim, cont, dist_type=dist_type)
    np.testing.assert_allclose(plp2.numpy(), np.asarray(jlp2), **TOL)
    np.testing.assert_allclose(pent2.numpy(), np.asarray(jent2), **TOL)


def test_sampling_from_a_generator_draws_the_noise_it_documents():
    out = torch.randn(5, 6, generator=torch.Generator().manual_seed(1))
    for dims, cont, dist_type in SAMPLING.values():
        head = out[:, :sum(dims) * (2 if cont else 1)]
        from_gen = pt_agent.sample_actions(head, dims, cont, torch.Generator().manual_seed(3), dist_type=dist_type)
        noise = pt_agent.action_noise(head, dims, cont, dist_type, torch.Generator().manual_seed(3))
        from_noise = pt_agent.sample_actions(head, dims, cont, noise, dist_type=dist_type)
        for a, b in zip(from_gen, from_noise):
            assert torch.equal(a, b)


# -- losses, GAE, permutations -----------------------------------------------------
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("clip_vloss", [False, True], ids=["plain", "clip_vloss"])
def test_losses(reduction, clip_vloss):
    rng = np.random.default_rng(1)
    new_lp, old_lp, adv, new_v, old_v, ret, ent = (rng.standard_normal(10).astype(np.float32) for _ in range(7))
    pairs = [
        (pt_loss.policy_loss(_t(new_lp), _t(old_lp), _t(adv), 0.2, reduction),
         jax_loss.policy_loss(new_lp, old_lp, adv, 0.2, reduction)),
        (pt_loss.value_loss(_t(new_v), _t(old_v), _t(ret), 0.2, clip_vloss, reduction),
         jax_loss.value_loss(new_v, old_v, ret, 0.2, clip_vloss, reduction)),
        (pt_loss.entropy_loss(_t(ent), reduction), jax_loss.entropy_loss(ent, reduction)),
    ]
    for got, want in pairs:
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gae():
    rng = np.random.default_rng(2)
    T, B = 9, 3
    rewards, values = rng.standard_normal((T, B)).astype(np.float32), rng.standard_normal((T, B)).astype(np.float32)
    dones = (rng.random((T, B)) < 0.25).astype(np.float32)
    next_value = rng.standard_normal(B).astype(np.float32)
    want = jax_gae(rewards, values, dones, next_value, 0.99, 0.95)
    got = gae(_t(rewards), _t(values), _t(dones), _t(next_value), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("T,B,bs", [(7, 2, 8), (8, 2, 8), (5, 3, 4)])
def test_epoch_permutation_pads_by_wrap_around(T, B, bs):
    nmb = -(-T * B // bs)
    key = jax.random.PRNGKey(T)
    want = np.asarray(jax_epoch_permutation(key, T, B, bs, nmb, share_data=True, n_shards=1))
    perm = _t(np.asarray(jax.random.permutation(key, T * B)))
    np.testing.assert_array_equal(pad_permutation(perm, nmb * bs).numpy(), want)
    got = epoch_permutation(torch.Generator().manual_seed(0), T, B, bs, nmb)
    assert got.shape == (nmb * bs,) and sorted(got[:T * B].tolist()) == list(range(T * B))
    assert torch.equal(got[T * B:], got[:nmb * bs - T * B])


# -- one whole train phase against JAX's -------------------------------------------
T, B = 7, 2  # 14 rows in minibatches of 8: the second is padded by wrap-around
BASE = ("env=dummy", "env.sync_env=True", "fabric.accelerator=cpu", "env.num_envs=2", f"algo.rollout_steps={T}",
        "algo.per_rank_batch_size=8", "algo.update_epochs=2", "algo.dense_units=8", "algo.mlp_layers=1",
        "algo.encoder.mlp_features_dim=6", "algo.encoder.cnn_features_dim=16", "algo.ent_coef=0.01")
TRAIN_CASES = {
    # id: overrides
    "pixels-vector": ("exp=ppo", "env.id=discrete_dummy", "env.wrapper.image_size=[84,84,3]", "env.screen_size=84",
                      "env.frame_stack=2", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"),
    "continuous": ("exp=ppo", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]"),
    "continuous-tanh_normal": ("exp=ppo", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]",
                               "distribution.type=tanh_normal", "algo.layer_norm=True"),
    "multidiscrete-normalized-clipped": ("exp=ppo", "env.id=multidiscrete_dummy", "algo.mlp_keys.encoder=[state]",
                                         "algo.normalize_advantages=True", "algo.clip_vloss=True",
                                         "algo.max_grad_norm=0.05", "algo.loss_reduction=sum"),
}


def rollout_from_seed(seed, obs_space, obs_keys, cnn_keys, actions_dim, cont, T, B):
    """A ``(T, B, ...)`` rollout as the loop stages it (images merged and
    scaled), and the ``(B, ...)`` observations after it."""
    rng = np.random.default_rng(seed)

    def obs(lead):
        out = {}
        for k in obs_keys:
            shape = obs_space[k].shape
            if k in cnn_keys:
                out[k] = obs_to_np(rng.integers(0, 256, (*lead, *shape), dtype=np.uint8), True, rollout=len(lead) == 2)
            else:
                out[k] = rng.standard_normal((*lead, *shape)).astype(np.float32)
        return out

    rollout = obs((T, B))
    if cont:
        rollout["actions"] = rng.uniform(-0.95, 0.95, (T, B, actions_dim[0])).astype(np.float32)
    else:
        rollout["actions"] = np.stack([rng.integers(0, d, (T, B)) for d in actions_dim], -1).astype(np.float32)
    rollout["rewards"] = rng.standard_normal((T, B)).astype(np.float32)
    rollout["dones"] = (rng.random((T, B)) < 0.2).astype(np.float32)
    return rollout, obs((B,)), rng


def port_trainer(overrides, jax_params, trainer_cls, actions_dim, cont, obs_space, T, B):
    """The port's agent from the JAX tree, its optimizer and ``trainer_cls``."""
    cfg = compose(list(overrides))
    fabric = build_fabric(cfg)
    agent = pt_agent.build_agent(fabric, actions_dim, cont, cfg, obs_space,
                                 policy_state_from_jax(jax.device_get(jax_params)))
    optimizer = build_optimizer(agent.parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)
    keys = tuple(cfg.algo.cnn_keys.encoder) + tuple(cfg.algo.mlp_keys.encoder)
    return trainer_cls(cfg, agent, optimizer, keys, actions_dim, cont, T, B), cfg


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_phase_matches_jax(case, tmp_path, monkeypatch):
    overrides = (*BASE, *TRAIN_CASES[case])
    jfn, jcfg, jfabric, obs_space, act_space = capture_jax_train_phase(jax_ppo_main, overrides, tmp_path,
                                                                       monkeypatch)
    actions_dim, cont = jax_spaces_to_dims(act_space)
    cnn_keys, mlp_keys = tuple(jcfg.algo.cnn_keys.encoder), tuple(jcfg.algo.mlp_keys.encoder)
    obs_keys = cnn_keys + mlp_keys
    agent, init = jax_agent.build_agent(jfabric, actions_dim, cont, jcfg, obs_space)
    params = draw_params(init)
    rollout, last_obs, rng = rollout_from_seed(3, obs_space, obs_keys, cnn_keys, actions_dim, cont, T, B)
    # stored log-probs near the current policy's, so the ratio clip is reached but not everywhere
    dist_type = jcfg.get("distribution", {}).get("type", "auto")
    out, _ = jax.jit(agent.apply)(params, {k: rollout[k].reshape(T * B, *rollout[k].shape[2:]) for k in obs_keys})
    lp, _ = jax_agent.evaluate_actions(out, rollout["actions"].reshape(T * B, -1), actions_dim, cont, dist_type)
    rollout["logprobs"] = (np.asarray(lp).reshape(T, B) + 0.3 * rng.standard_normal((T, B))).astype(np.float32)

    bs, nmb = 8, 2
    key = jax.random.PRNGKey(11)
    optimizer = jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    new_params, _, jax_losses = jfn(params, optimizer.init(params), rollout, last_obs, key, jnp.float32(0.2),
                                    jnp.float32(0.01), batch_size=bs, num_minibatches=nmb)
    perms = [_t(np.asarray(jax_epoch_permutation(k, T, B, bs, nmb, False, 1)))
             for k in jax.random.split(key, int(jcfg.algo.update_epochs))]

    trainer, _ = port_trainer(overrides, params, PPOTrainer, actions_dim, cont, obs_space, T, B)
    assert (trainer.batch_size, trainer.num_minibatches) == (bs, nmb)
    before = {k: v.clone() for k, v in trainer.agent.state_dict().items()}
    losses = trainer.train_phase({k: _t(v) for k, v in rollout.items()}, {k: _t(v) for k, v in last_obs.items()},
                                 perms, 0.2, 0.01)
    assert_losses_match(losses, jax_losses)
    assert_params_match(trainer.agent, new_params, **PARAM_TOL)
    moved = [k for k, v in trainer.agent.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)  # every parameter took the update


# -- the serving player --------------------------------------------------------------
@pytest.mark.parametrize("env_id", ["discrete_dummy", "continuous_dummy"])
def test_ppo_player_matches_jax_player(env_id):
    """Both PPO players on one parameter tree: a batch of mixed greedy and
    sampled rows, the port handed the draws the JAX step makes from its seed."""
    from sheeprl_tpu.serve.players import build_ppo_player as jax_player
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from sheeprl_tpu_torch.serve.players import build_ppo_player

    overrides = ["exp=ppo", "env=dummy", "env.sync_env=True", f"env.id={env_id}", "fabric.accelerator=cpu", "algo.cnn_keys.encoder=[rgb]",
                 "algo.mlp_keys.encoder=[state]", "algo.dense_units=8", "algo.mlp_layers=1",
                 "algo.encoder.cnn_features_dim=16", "algo.encoder.mlp_features_dim=6"]
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jfabric = jax_build_fabric(jcfg)
    obs_space, act_space = jax_probe_spaces(jcfg)
    actions_dim, cont = jax_spaces_to_dims(act_space)
    params = draw_params(jax_agent.build_agent(jfabric, actions_dim, cont, jcfg, obs_space)[1])
    jp = jax_player(jfabric, jcfg, {"agent": params}, obs_space, act_space)
    p_obs, p_act = probe_spaces(pcfg)
    pp = build_ppo_player(build_fabric(pcfg), pcfg, {"agent": policy_state_from_jax(jax.device_get(params))},
                          p_obs, p_act)
    assert not pp.stateful and pp.carry_spec == () and pp.obs_spec == jp.obs_spec

    rng, n, seed = np.random.default_rng(6), 4, 21
    raw = {"rgb": rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8),
           "state": rng.standard_normal((n, 4)).astype(np.float32)}
    greedy = np.array([True, False, False, True])
    _, j_actions = jp.step_batch(jp.params, (), jp.prepare(raw), seed, greedy)
    noise = [_t(x) for x in jax_action_noise(jax.random.PRNGKey(seed), n, actions_dim, cont, "auto")]
    obs = {k: _t(v) for k, v in pp.prepare(raw).items()}
    with torch.no_grad():
        _, p_actions = pp.step(pp.params, (), obs, seed, torch.from_numpy(greedy), noise=noise)
    np.testing.assert_allclose(p_actions.numpy(), np.asarray(j_actions), **CONV_TOL)
    np.testing.assert_allclose(pp.postprocess(p_actions.numpy()), jp.postprocess(np.asarray(j_actions)), **CONV_TOL)


def test_rollout_bootstraps_truncated_episodes(tmp_path, monkeypatch):
    """A rollout through ``cli.run`` whose episodes are cut by the time
    limit: each truncated step's reward is the env's 1.0 plus γ·V(final
    observation) under the weights that collected it (the dummy env's
    observation is a function of its step count, so the final one is known),
    and ``dones`` marks it."""
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.algos.ppo.utils import prepare_obs
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv

    seen = {}
    train_phase = ppo.PPOTrainer.train_phase

    def spy(self, rollout, *args):
        seen.update(rollout={k: v.clone() for k, v in rollout.items()}, agent=self.agent.state_dict())
        seen["agent"] = {k: v.clone() for k, v in seen["agent"].items()}
        return train_phase(self, rollout, *args)

    monkeypatch.setattr(ppo.PPOTrainer, "train_phase", spy)
    run(["exp=ppo", "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "fabric.accelerator=cpu", "metric.log_level=0",
         "buffer.memmap=False", "env.num_envs=2", "env.max_episode_steps=3", "algo.rollout_steps=7",
         "algo.per_rank_batch_size=7", "algo.update_epochs=1", "algo.dense_units=8", "algo.mlp_layers=1",
         "algo.mlp_keys.encoder=[state]", "algo.run_test=False", "dry_run=True", f"log_dir={tmp_path}"])
    rollout = seen["rollout"]
    truncated = torch.zeros(7, 2, dtype=torch.bool)
    truncated[2] = truncated[5] = True  # steps 3 and 6 of each env end at the limit of 3
    assert torch.equal(rollout["dones"].bool(), truncated)
    cfg = compose(["exp=ppo", "env=dummy", "env.sync_env=True", "fabric.accelerator=cpu", "algo.dense_units=8", "algo.mlp_layers=1",
                   "algo.mlp_keys.encoder=[state]"])
    agent = pt_agent.build_agent(build_fabric(cfg), (4,), False, cfg, DiscreteDummyEnv().observation_space,
                                 seen["agent"])
    env = DiscreteDummyEnv()
    env.reset()
    for _ in range(3):
        final, *_ = env.step(0)
    with torch.no_grad():
        v_final = agent(prepare_obs({"state": final["state"][None]}, (), ("state",)))[1][0, 0]
    want = torch.where(truncated, 1.0 + 0.99 * v_final, torch.ones(7, 2))
    torch.testing.assert_close(rollout["rewards"], want, rtol=1e-6, atol=1e-6)
