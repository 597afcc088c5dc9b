"""Recurrent PPO of the port against the JAX package's, on the CPU: flax's
``OptimizedLSTMCell`` against ``torch.nn.LSTMCell`` under the weights
``convert.py`` restacks, the agent's ``(T, B)`` scan with episode starts in
mid-sequence, and one update of the live JAX ``train_phase`` closure of
``sheeprl_tpu/algos/ppo_recurrent/ppo_recurrent.py::main`` (captured as in
``tests/test_torch_ppo.py``) with env-column minibatches, the column
permutation padded by wrap-around.

Tolerances: the cell and the scan 1e-5; after the update (2 epochs x 2
minibatches of AdamW, lr 3e-4, moving the parameters by up to 1.2e-3) the
parameters 2e-6 absolute (the differences seen are 4.8e-7, four ulps at the
LayerNorm scales' magnitude) and the losses 1e-5 relative.  AdamW's eps is
raised from 1e-8 to 1e-4, so that a step follows its gradient's size rather
than only its sign and the parameters can show a wrong gradient.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
from sheeprl_tpu.algos.ppo_recurrent import agent as jax_agent
from sheeprl_tpu.algos.ppo_recurrent.ppo_recurrent import main as jax_main
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.algos.ppo_recurrent import agent as pt_agent
from sheeprl_tpu_torch.algos.ppo_recurrent.ppo_recurrent import RecurrentPPOTrainer
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import lstm_state_from_flax, policy_state_from_jax
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.utils.optim import build_optimizer
from tests.test_torch_ppo import assert_losses_match, assert_params_match, capture_jax_train_phase, draw_params

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0.0, atol=2e-6)
T, B = 5, 3
BASE = ("exp=ppo_recurrent", "env=dummy", "env.mask_velocities=False", "fabric.accelerator=cpu",
        f"env.num_envs={B}", f"algo.rollout_steps={T}", "algo.per_rank_batch_size=10", "algo.update_epochs=2",
        "algo.dense_units=8", "algo.rnn.lstm.hidden_size=6", "algo.mlp_keys.encoder=[state]",
        "algo.optimizer.eps=1e-4")
CASES = {
    "discrete": ("env.id=discrete_dummy",),
    "continuous-pre-post-mlp": ("env.id=continuous_dummy", "algo.rnn.pre_rnn_mlp.apply=True",
                                "algo.rnn.post_rnn_mlp.apply=True", "algo.normalize_advantages=True",
                                "algo.clip_vloss=True", "algo.ent_coef=0.01"),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_lstm_cell_matches_flax_optimized_lstm():
    rng = np.random.default_rng(0)
    x, c, h = (rng.standard_normal((4, n)).astype(np.float32) for n in (7, 5, 5))
    cell = flax_nn.OptimizedLSTMCell(5)
    params = draw_params(jax.eval_shape(cell.init, jax.random.PRNGKey(0), (c, h), x))
    assert set(params["params"]) == {f"{p}{g}" for p in "ih" for g in "ifgo"}
    (c_new, h_new), out = jax.jit(cell.apply)(params, (c, h), x)
    port = torch.nn.LSTMCell(7, 5)
    port.load_state_dict(lstm_state_from_flax(params["params"]))
    with torch.no_grad():
        ph, pc = port(_t(x), (_t(h), _t(c)))
    np.testing.assert_allclose(pc.numpy(), np.asarray(c_new), **TOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(h_new), **TOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(out), **TOL)


def _agents(overrides, tmp_path, monkeypatch):
    jfn, jcfg, jfabric, obs_space, act_space = capture_jax_train_phase(jax_main, overrides, tmp_path, monkeypatch)
    actions_dim, cont = jax_spaces_to_dims(act_space)
    jagent, init = jax_agent.build_agent(jfabric, actions_dim, cont, jcfg, obs_space)
    params = draw_params(init, seed=2)
    cfg = compose(list(overrides))
    port = pt_agent.build_agent(build_fabric(cfg), actions_dim, cont, cfg, obs_space,
                                policy_state_from_jax(jax.device_get(params)))
    return jfn, jcfg, jagent, params, port, cfg, actions_dim, cont


def _sequence(seed, actions_dim, cont):
    """A ``(T, B)`` rollout with episode starts in mid-sequence, and the carry it started from."""
    rng = np.random.default_rng(seed)
    act_width = int(sum(actions_dim))
    if cont:
        actions = rng.uniform(-1, 1, (T, B, act_width)).astype(np.float32)
        prev = actions
    else:
        actions = np.stack([rng.integers(0, d, (T, B)) for d in actions_dim], -1).astype(np.float32)
        prev = np.concatenate([np.eye(d, dtype=np.float32)[actions[..., i].astype(int)]
                               for i, d in enumerate(actions_dim)], -1)
    dones = np.zeros((T, B), np.float32)
    dones[1, 0] = dones[3, 2] = dones[2, 1] = 1.0
    is_first = np.concatenate([np.zeros((1, B)), dones[:-1]], 0).astype(np.float32)[..., None]
    prev_actions = np.concatenate([np.zeros((1, B, act_width), np.float32), prev[:-1]], 0) * (1.0 - is_first)
    rollout = {"state": rng.standard_normal((T, B, 4)).astype(np.float32), "actions": actions,
               "prev_actions": prev_actions.astype(np.float32), "is_first": is_first,
               "rewards": rng.standard_normal((T, B)).astype(np.float32), "dones": dones,
               "logprobs": (rng.standard_normal((T, B)) * 0.5 - 1.5).astype(np.float32)}
    carry = tuple(np.tanh(rng.standard_normal((B, 6))).astype(np.float32) for _ in range(2))
    return rollout, carry, rng


@pytest.mark.parametrize("case", list(CASES))
def test_scan_with_resets_matches_flax(case, tmp_path, monkeypatch):
    _, _, jagent, params, port, _, actions_dim, cont = _agents((*BASE, *CASES[case]), tmp_path, monkeypatch)
    rollout, carry, _ = _sequence(1, actions_dim, cont)
    want_out, want_v = jax.jit(jagent.apply)(params, {"state": rollout["state"]}, rollout["prev_actions"],
                                             rollout["is_first"], carry)
    with torch.no_grad():
        out, v = port({"state": _t(rollout["state"])}, _t(rollout["prev_actions"]), _t(rollout["is_first"]),
                      tuple(_t(c) for c in carry))
        (c1, h1), (a1, v1) = port.step(tuple(_t(c) for c in carry), {"state": _t(rollout["state"][0])},
                                       _t(rollout["prev_actions"][0]), _t(np.ones((B, 1), np.float32)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), **TOL)
    (jc, jh), (ja, jv) = jax.jit(lambda p, *a: jagent.apply(p, *a, method=jax_agent.RecurrentPPOAgent.step))(
        params, carry, {"state": rollout["state"][0]}, rollout["prev_actions"][0], np.ones((B, 1), np.float32))
    for got, want in ((c1, jc), (h1, jh), (a1, ja), (v1, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_update_with_env_column_minibatches_matches_jax(case, tmp_path, monkeypatch):
    overrides = (*BASE, *CASES[case])
    jfn, jcfg, _, params, port, cfg, actions_dim, cont = _agents(overrides, tmp_path, monkeypatch)
    rollout, carry, rng = _sequence(2, actions_dim, cont)
    last_values = rng.standard_normal(B).astype(np.float32)
    env_bs, nmb = 2, 2  # min(B, 10 // T) columns; 3 columns padded to 4
    key = jax.random.PRNGKey(4)
    optimizer = jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    new_params, _, jax_losses = jfn(params, optimizer.init(params), rollout, carry, last_values, key,
                                    jnp.float32(jcfg.algo.ent_coef), env_bs=env_bs, num_minibatches=nmb)
    perms = []
    for k in jax.random.split(key, int(jcfg.algo.update_epochs)):
        perm = np.asarray(jax.random.permutation(k, B))
        perms.append(_t(np.concatenate([perm, perm[:nmb * env_bs - B]])))

    trainer = RecurrentPPOTrainer(cfg, port, build_optimizer(port.parameters(), cfg.algo.optimizer,
                                                             cfg.algo.max_grad_norm), actions_dim, cont, T, B)
    assert (trainer.env_bs, trainer.num_minibatches) == (env_bs, nmb)
    losses = trainer.train_phase({k: _t(v) for k, v in rollout.items()}, tuple(_t(c) for c in carry),
                                 _t(last_values), perms, float(cfg.algo.ent_coef))
    assert_losses_match(losses, jax_losses, rtol=1e-5)
    assert_params_match(port, new_params, **PARAM_TOL)


def test_rollout_carries_the_lstm_state_and_bootstraps_truncations(tmp_path, monkeypatch):
    """A recurrent rollout through ``cli.run`` whose episodes are cut by the
    time limit, replayed step by step from the stored inputs with the
    weights that collected it: the update's starting carry is zero, each
    truncated step's reward is 1.0 + γ·V(final observation) from the
    post-step carry with the step's own action as the previous action, and
    the bootstrap values after the rollout come from the carry it ended in."""
    from sheeprl_tpu_torch.algos.ppo_recurrent import ppo_recurrent
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.envs.dummy import DiscreteDummyEnv

    seen = {}
    train_phase = RecurrentPPOTrainer.train_phase

    def spy(self, rollout, init_carry, last_values, *args):
        seen.update(rollout={k: v.clone() for k, v in rollout.items()}, carry=[c.clone() for c in init_carry],
                    last_values=last_values.clone(),
                    agent={k: v.clone() for k, v in self.agent.state_dict().items()})
        return train_phase(self, rollout, init_carry, last_values, *args)

    monkeypatch.setattr(ppo_recurrent.RecurrentPPOTrainer, "train_phase", spy)
    overrides = ["exp=ppo_recurrent", "env=dummy", "env.id=discrete_dummy", "env.mask_velocities=False",
                 "fabric.accelerator=cpu", "env.num_envs=2", "algo.dense_units=8", "algo.rnn.lstm.hidden_size=6",
                 "algo.mlp_keys.encoder=[state]"]
    run([*overrides, "metric.log_level=0", "buffer.memmap=False", "env.max_episode_steps=3",
         "algo.rollout_steps=7", "algo.per_rank_batch_size=14", "algo.update_epochs=1", "algo.run_test=False",
         "dry_run=True", f"log_dir={tmp_path}"])
    r = seen["rollout"]
    cfg = compose(overrides)
    agent = pt_agent.build_agent(build_fabric(cfg), (4,), False, cfg, DiscreteDummyEnv().observation_space,
                                 seen["agent"])
    assert all(not c.any() for c in seen["carry"])
    truncated = torch.zeros(7, 2, dtype=torch.bool)
    truncated[2] = truncated[5] = True
    assert torch.equal(r["dones"].bool(), truncated)
    # the previous action is the last step's one-hot, zero where an episode starts
    first = torch.cat([torch.ones(1, 2), r["dones"][:-1]])
    assert torch.equal(r["is_first"][..., 0], first)
    prev = torch.cat([torch.zeros(1, 2, 4), pt_agent.one_hot_actions(r["actions"][:-1], (4,), False)])
    assert torch.equal(r["prev_actions"], prev * (1.0 - first[..., None]))
    carry, want = tuple(seen["carry"]), torch.ones(7, 2)
    with torch.no_grad():
        for t in range(7):
            carry, _ = agent.step(carry, {"state": r["state"][t]}, r["prev_actions"][t], r["is_first"][t])
            if truncated[t].any():
                one_hot = pt_agent.one_hot_actions(r["actions"][t], (4,), False)
                final = {"state": torch.full((2, 4), 3.0)}
                _, (_, v) = agent.step(carry, final, one_hot, torch.zeros(2, 1))
                want[t] = 1.0 + 0.99 * v[:, 0]
        # after the last step (an episode's first step): the reset observation
        last_first = r["dones"][-1:].T
        prev = pt_agent.one_hot_actions(r["actions"][-1], (4,), False) * (1.0 - last_first)
        _, (_, v_last) = agent.step(carry, {"state": torch.full((2, 4), 1.0)}, prev, last_first)
    torch.testing.assert_close(r["rewards"], want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(seen["last_values"], v_last[:, 0], rtol=1e-6, atol=1e-6)
