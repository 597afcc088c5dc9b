"""One DreamerV3 update of the port against the JAX package's ``make_train_phase``.

Both start from one parameter tree (numpy-drawn, carried across by
``sheeprl_tpu_torch.convert``), take the same ``(U, L, B, *)`` replay block,
and the port is handed the draws the JAX keys make along the JAX split chain:
``split(k, U)`` per update, ``k_wm, k_beh = split(k_u)``, one posterior
Gumbel per time step from ``split(k_wm, L)``, and per imagination step
``k_a, k_z = split(split(k_beh, H + 1)[t])`` — one Gumbel per action branch
from ``split(k_a, n_branches)`` (or ``normal(k_a)`` for continuous actions)
and the prior's Gumbel from ``k_z``.

Tolerances:

* the ten metrics of the window: 1e-5 relative (2e-5 absolute for the
  near-zero policy loss), fp32 summation order only;
* with ``sgd`` (no momentum) a parameter's change is lr x its clipped
  gradient: the change of every parameter agrees to 1e-3 of the largest
  change of its group plus 1e-4 relative (the gradient tier of
  ``tests/test_regression/DRIFT.md`` — gradients through 8-step scans);
* with the default Adam the first step is about lr·sign(g): where |g| is
  near eps the sign, and so the step, can flip on a rounding difference, so
  the parameters after one update are held to an absolute tolerance of half
  the learning rate, which any wrong gradient sign or scale of more than a
  few elements would exceed.

On the card Adam is built ``capturable`` (its step count on the device, so a
window can be captured as a CUDA graph); on the CPU, where these tests run,
the flag is off and the optimizer is the one they held before it existed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_build_opts
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_phase as jax_make_train_phase
from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu.utils.distribution import OneHotCategorical as JaxOneHot
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, blocks_to_device, build_dv3_optimizers
from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import agent_state_from_jax
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.serve.loader import probe_spaces
from tests.test_torch_serve import _jax_params

L, B, H = 8, 2, 4
BASE = (
    "exp=dreamer_v3",
    "env=dummy", "env.sync_env=True",
    "algo=dreamer_v3_XS",
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
SGD = tuple(f"algo.{g}.optimizer.{k}={v}" for g in ("world_model", "actor", "critic")
            for k, v in (("name", "sgd"), ("lr", 0.05), ("momentum", 0.0)))

CASES = {
    # id: (env, pixels, kernel flag, optimizer overrides, U, counter0, extra)
    "discrete-pixels-fused": ("discrete_dummy", True, "fused_pallas", SGD, 1, 0, ()),
    "continuous-vector-flags-off": ("continuous_dummy", False, None, SGD, 1, 0, ()),
    "multidiscrete-use_pallas-U2": ("multidiscrete_dummy", False, "use_pallas", SGD, 2, 1,
                                    ("algo.critic.per_rank_target_network_update_freq=2",)),
    "discrete-pixels-adam": ("discrete_dummy", True, None, (), 1, 0, ()),
    # the target critic's EMA on the device (a counter tensor and a
    # torch.where blend, as a captured window runs it): updates 0, 2 and 4 of
    # five blend, 1 and 3 do not
    "discrete-vector-ema-U5-counter-tensor": ("discrete_dummy", False, None, SGD, 5, 0,
                                              ("algo.critic.per_rank_target_network_update_freq=2",)),
}


def _overrides(env_id, pixels, flag, opt, extra):
    keys = ["algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]"] if pixels else [
        "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]"]
    flags = [f"algo.world_model.recurrent_model.{flag}=True"] if flag else []
    return [*BASE, f"env.id={env_id}", *keys, *flags, *opt, *extra]


def _block(rng, U, pixels, actions_dim, is_cont):
    """A (U, L, B, *) replay block as the loop samples it."""
    block = {"state": rng.standard_normal((U, L, B, 4)).astype(np.float32)}
    if pixels:
        block["rgb"] = rng.integers(0, 256, (U, L, B, 64, 64, 3), dtype=np.uint8)
    if is_cont:
        block["actions"] = rng.uniform(-1, 1, (U, L, B, actions_dim[0])).astype(np.float32)
    else:
        block["actions"] = np.concatenate(
            [np.eye(d, dtype=np.float32)[rng.integers(0, d, (U, L, B))] for d in actions_dim], -1)
    block["rewards"] = rng.standard_normal((U, L, B, 1)).astype(np.float32)
    block["terminated"] = (rng.random((U, L, B, 1)) < 0.1).astype(np.float32)
    block["is_first"] = (rng.random((U, L, B, 1)) < 0.1).astype(np.float32)
    return block


def _noise_from_keys(key, U, actions_dim, is_cont, S, D):
    """The draws JAX's train phase makes from ``key``, as the port's noise dict."""
    n = L * B
    post, acts, imag = [], [[] for _ in (actions_dim[:1] if is_cont else actions_dim)], []
    for k_u in jax.random.split(key, U):
        k_wm, k_beh = jax.random.split(k_u)
        post.append([JaxOneHot.sample_noise(k, (B, S, D)) for k in jax.random.split(k_wm, L)])
        per_t = [[] for _ in acts]
        imag_t = []
        for k_t in jax.random.split(k_beh, H + 1):
            k_a, k_z = jax.random.split(k_t)
            if is_cont:
                per_t[0].append(jax.random.normal(k_a, (n, actions_dim[0])))
            else:
                for b, (k_b, d) in enumerate(zip(jax.random.split(k_a, len(actions_dim)), actions_dim)):
                    per_t[b].append(JaxOneHot.sample_noise(k_b, (n, d)))
            imag_t.append(JaxOneHot.sample_noise(k_z, (n, S, D)))
        for b, draws in enumerate(per_t):
            acts[b].append(draws)
        imag.append(imag_t)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    return {"posterior": t(post), "actions": [t(a) for a in acts], "imagination": t(imag)}


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax_train_phase(case):
    env_id, pixels, flag, opt, U, counter0, extra = CASES[case]
    overrides = _overrides(env_id, pixels, flag, opt, extra)
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jfabric, pfabric = jax_build_fabric(jcfg), build_fabric(pcfg)
    obs_space, action_space = jax_probe_spaces(jcfg)
    actions_dim, is_cont = jax_spaces_to_dims(action_space)
    params = _jax_params(jcfg, jfabric, obs_space, action_space, seed=1)
    before = jax.tree.map(np.array, params)
    cnn_keys = ("rgb",) if pixels else ()
    mlp_keys = ("state",)

    # -- the port, from the same tree -------------------------------------------
    p_obs_space, p_action_space = probe_spaces(pcfg)
    assert spaces_to_dims(p_action_space) == (tuple(actions_dim), is_cont)
    state = agent_state_from_jax(before, pcfg)
    modules = build_agent(pfabric, actions_dim, is_cont, pcfg, p_obs_space, state)
    trainer = DV3Trainer(pcfg, modules, build_dv3_optimizers(pcfg, modules), cnn_keys, mlp_keys, is_cont, state)

    rng = np.random.default_rng(7)
    block = _block(rng, U, pixels, actions_dim, is_cont)
    key = jax.random.PRNGKey(11)
    S, D = pcfg.algo.world_model.stochastic_size, pcfg.algo.world_model.discrete_size
    noise = _noise_from_keys(key, U, actions_dim, is_cont, S, D)
    counter = torch.tensor(counter0) if case.endswith("counter-tensor") else counter0
    p_metrics = trainer.train_phase(blocks_to_device(block, cnn_keys, mlp_keys, "cpu"), noise, counter)
    assert all(not o.optimizer.defaults.get("capturable", False) for o in trainer.optimizers.values())

    # -- JAX -----------------------------------------------------------------------
    world_model, actor, critic, params = jax_build_agent(jfabric, actions_dim, is_cont, jcfg, obs_space, params)
    wm_opt, actor_opt, critic_opt, opt_state = jax_build_opts(jfabric, jcfg, params)
    phase = jax_make_train_phase(jfabric, jcfg, world_model, actor, critic, wm_opt, actor_opt, critic_opt,
                                 cnn_keys=cnn_keys, mlp_keys=mlp_keys, is_continuous=is_cont)
    j_blocks = {k: jnp.asarray(v.numpy()) for k, v in blocks_to_device(block, cnn_keys, mlp_keys, "cpu").items()}
    new_params, _, j_metrics = phase(params, opt_state, j_blocks, key, jnp.int32(counter0))

    j_metrics = np.array([float(m) for m in j_metrics])
    p_metrics = np.array([float(m) for m in p_metrics])
    assert np.isfinite(p_metrics).all()
    np.testing.assert_allclose(p_metrics, j_metrics, rtol=1e-5, atol=2e-5)

    after = agent_state_from_jax(jax.tree.map(np.array, new_params), pcfg)
    start = agent_state_from_jax(before, pcfg)
    adam = not opt
    for name, module in trainer.modules().items():
        lr = float(pcfg.algo["critic" if name == "target_critic" else name].optimizer.lr)
        p_state = module.state_dict()
        for k, j_after in after[name].items():
            p_after = p_state[k].detach()
            if adam:
                np.testing.assert_allclose(p_after.numpy(), j_after.numpy(), rtol=0, atol=lr / 2, err_msg=f"{name}.{k}")
                continue
            j_delta = (j_after - start[name][k]).numpy()
            p_delta = (p_after - start[name][k]).numpy()
            scale = max(np.abs(j_delta).max(), 1e-12)
            np.testing.assert_allclose(p_delta, j_delta, rtol=1e-4, atol=1e-3 * scale, err_msg=f"{name}.{k}")
    for k in ("low", "high"):
        np.testing.assert_allclose(float(trainer.moments[k]), float(after["moments"][k]), rtol=1e-5, atol=1e-6)


# -- the family harness (Plan2Explore, decoupled RSSM, DreamerV2 and V1) ----------
def sgd_overrides(groups=("world_model", "actor", "critic")):
    return tuple(f"algo.{g}.optimizer.{k}={v}" for g in groups
                 for k, v in (("name", "sgd"), ("lr", 0.05), ("momentum", 0.0)))


def family_params(build_agent_fn, cfg, fabric, obs_space, action_space, seed=1):
    """A JAX family agent's parameter tree (built at its tiny size) with
    numpy-drawn values, as :func:`tests.test_torch_serve._jax_params` draws them."""
    actions_dim, is_cont = jax_spaces_to_dims(action_space)
    # the shapes alone (no initialisation is compiled): every value is drawn below
    tree = jax.eval_shape(lambda: build_agent_fn(fabric, actions_dim, is_cont, cfg, obs_space)[3])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(leaf)
        noise = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("kernel"):
            # fan in: H*W*I of a conv, in of a dense, in of a stacked (n, in, out) one
            return noise / np.sqrt(shape[-2] if len(shape) == 3 else np.prod(shape[:-1]))
        return 1.0 + 0.1 * noise if name.endswith("scale") else 0.1 * noise

    return jax.tree_util.tree_map_with_path(draw, tree)


def family_noise(key, U, actions_dim, is_cont, latent_shape, n_split, rollouts, gaussian=False):
    """The draws a JAX family train phase makes from ``key``: per update
    ``split(k_u, n_split)``; the posterior from the first subkey, one draw
    per time step from ``split(k, L)``; each imagination rollout from the
    subkey ``rollouts[i]`` (the port's ``""`` then ``"_task"`` rollout),
    ``k_a, k_z = split(split(k, H + 1)[t])``.  Latents draw Gumbels, or
    normals with ``gaussian``."""
    n = L * B

    def latent(k, shape):
        return jax.random.normal(k, shape) if gaussian else JaxOneHot.sample_noise(k, shape)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    branches = actions_dim[:1] if is_cont else actions_dim
    post = []
    rolls = [{"actions": [[] for _ in branches], "imagination": []} for _ in rollouts]
    for k_u in jax.random.split(key, U):
        ks = jax.random.split(k_u, n_split)
        post.append([latent(k, (B, *latent_shape)) for k in jax.random.split(ks[0], L)])
        for r, idx in zip(rolls, rollouts):
            per_t, imag_t = [[] for _ in branches], []
            for k_t in jax.random.split(ks[idx], H + 1):
                k_a, k_z = jax.random.split(k_t)
                if is_cont:
                    per_t[0].append(jax.random.normal(k_a, (n, actions_dim[0])))
                else:
                    for b, (k_b, d) in enumerate(zip(jax.random.split(k_a, len(actions_dim)), actions_dim)):
                        per_t[b].append(JaxOneHot.sample_noise(k_b, (n, d)))
                imag_t.append(latent(k_z, (n, *latent_shape)))
            for b, draws in enumerate(per_t):
                r["actions"][b].append(draws)
            r["imagination"].append(imag_t)
    noise = {"posterior": t(post)}
    for suffix, r in zip(("", "_task"), rolls):
        noise["actions" + suffix] = [t(a) for a in r["actions"]]
        noise["imagination" + suffix] = t(r["imagination"])
    return noise


def _flat_states(tree, prefix=""):
    """(path, tensor) of every tensor of a nested agent state."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_states(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _group_lr(cfg, path):
    top = path.split("/", 1)[0]
    group = {"target_critic": "critic", "actor_task": "actor", "critic_exploration": "critic",
             "target_critic_exploration": "critic", "critics_exploration": "critic"}.get(top, top)
    return float(cfg.algo[group].optimizer.lr)


def family_run(jax_agent_mod, jax_phase_fn, jax_opts_fn, port_build, port_trainer, port_opts_fn, overrides,
               pixels, U, counter0, n_split, rollouts, gaussian=False):
    """One window of the port's trainer and of the JAX train phase on the
    same parameter tree, block and draws: ``(trainer, pcfg, j_metrics,
    p_metrics, start, after)`` with ``start`` / ``after`` the JAX tree before
    and after as flat port states."""
    jcfg, pcfg = jax_compose(list(overrides)), compose(list(overrides))
    jfabric, pfabric = jax_build_fabric(jcfg), build_fabric(pcfg)
    obs_space, action_space = jax_probe_spaces(jcfg)
    actions_dim, is_cont = jax_spaces_to_dims(action_space)
    params = family_params(jax_agent_mod.build_agent, jcfg, jfabric, obs_space, action_space)
    before = jax.tree.map(np.array, params)
    cnn_keys = ("rgb",) if pixels else ()
    mlp_keys = ("state",)

    p_obs_space, _ = probe_spaces(pcfg)
    state = agent_state_from_jax(before, pcfg)
    modules = port_build(pfabric, actions_dim, is_cont, pcfg, p_obs_space, state)
    trainer = port_trainer(pcfg, modules, port_opts_fn(pcfg, modules, None), cnn_keys, mlp_keys, is_cont, state)

    rng = np.random.default_rng(7)
    block = _block(rng, U, pixels, actions_dim, is_cont)
    key = jax.random.PRNGKey(11)
    wm_cfg = pcfg.algo.world_model
    latent_shape = (wm_cfg.stochastic_size,) if gaussian else (wm_cfg.stochastic_size, wm_cfg.discrete_size)
    noise = family_noise(key, U, actions_dim, is_cont, latent_shape, n_split, rollouts, gaussian)
    p_metrics = trainer.train_phase(blocks_to_device(block, cnn_keys, mlp_keys, "cpu"), noise, counter0)

    world_model, actor, critic, params = jax_agent_mod.build_agent(jfabric, actions_dim, is_cont, jcfg, obs_space,
                                                                   params)
    wm_opt, actor_opt, critic_opt, opt_state = jax_opts_fn(jfabric, jcfg, params)
    phase = jax_phase_fn(jfabric, jcfg, world_model, actor, critic, wm_opt, actor_opt, critic_opt,
                         cnn_keys=cnn_keys, mlp_keys=mlp_keys, is_continuous=is_cont)
    j_blocks = {k: jnp.asarray(v.numpy()) for k, v in blocks_to_device(block, cnn_keys, mlp_keys, "cpu").items()}
    new_params, _, j_metrics = phase(params, opt_state, j_blocks, key, jnp.int32(counter0))

    after = dict(_flat_states(agent_state_from_jax(jax.tree.map(np.array, new_params), pcfg)))
    start = dict(_flat_states(agent_state_from_jax(before, pcfg)))
    return (trainer, pcfg, np.array([float(m) for m in j_metrics]), np.array([float(m) for m in p_metrics]), start,
            after)


def family_parity(jax_agent_mod, jax_phase_fn, jax_opts_fn, port_build, port_trainer, port_opts_fn, overrides,
                  pixels, U, counter0, n_split, rollouts, adam=False, gaussian=False):
    """One window of the port's trainer against the JAX train phase on the
    same parameter tree, block and draws (:func:`family_run`); the ten
    metrics to 1e-5 relative (2e-5 absolute), and every trained tensor after
    it: with ``sgd`` each change to 1e-3 of the largest change of its tensor
    plus 1e-4 relative, with Adam to half the learning rate."""
    trainer, pcfg, j_metrics, p_metrics, start, after = family_run(
        jax_agent_mod, jax_phase_fn, jax_opts_fn, port_build, port_trainer, port_opts_fn, overrides, pixels, U,
        counter0, n_split, rollouts, gaussian)
    assert np.isfinite(p_metrics).all()
    np.testing.assert_allclose(p_metrics, j_metrics, rtol=1e-5, atol=2e-5)
    ported = dict(_flat_states(trainer.agent_state()))
    assert set(ported) == set(after)
    for path, j_after in after.items():
        p_after = ported[path].detach()
        if "moments" in path:
            np.testing.assert_allclose(float(p_after), float(j_after), rtol=1e-5, atol=1e-6, err_msg=path)
        elif adam:
            lr = _group_lr(pcfg, path)
            np.testing.assert_allclose(p_after.numpy(), j_after.numpy(), rtol=0, atol=lr / 2, err_msg=path)
        else:
            j_delta = (j_after - start[path]).numpy()
            p_delta = (p_after - start[path]).numpy()
            scale = max(np.abs(j_delta).max(), 1e-12)
            np.testing.assert_allclose(p_delta, j_delta, rtol=1e-4, atol=1e-3 * scale, err_msg=path)
    return trainer
