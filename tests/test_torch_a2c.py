"""A2C of the port against the JAX package's, on the CPU: two updates of the
live JAX ``train_phase`` closure of ``sheeprl_tpu/algos/a2c/a2c.py::main``
(captured as in ``tests/test_torch_ppo.py``) under each RMSprop, with the
``anneal_lr`` schedule stepping the learning rate between them, and the
RMSprops themselves against optax's.

The eps of each case is raised from the config's (1e-4, 1e-10) to 0.1 so
that where it sits (inside or outside the square root) moves the update by
more than the tolerance.  Tolerances: parameters 1e-6 absolute after two
steps that move them by 3e-3 to 2e-2 (the differences seen are 6e-8),
losses 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.a2c.a2c import main as jax_a2c_main
from sheeprl_tpu.algos.ppo import agent as jax_agent
from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu.utils.optim import get_learning_rate as jax_get_lr
from sheeprl_tpu.utils.optim import set_learning_rate as jax_set_lr
from sheeprl_tpu.utils.utils import polynomial_decay as jax_polynomial_decay
from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
from sheeprl_tpu_torch.utils.optim import build_optimizer, get_learning_rate, set_learning_rate
from sheeprl_tpu_torch.utils.structured import dotdict
from sheeprl_tpu_torch.utils.utils import polynomial_decay
from tests.test_torch_ppo import (
    assert_losses_match,
    assert_params_match,
    capture_jax_train_phase,
    draw_params,
    port_trainer,
    rollout_from_seed,
)

T, B = 7, 2
PARAM_TOL = dict(rtol=0.0, atol=1e-6)
BASE = ("exp=a2c", "env=dummy", "env.sync_env=True", "fabric.accelerator=cpu", "env.num_envs=2", f"algo.rollout_steps={T}",
        "algo.dense_units=8", "algo.mlp_layers=1", "algo.encoder.mlp_features_dim=6", "algo.ent_coef=0.01",
        "algo.anneal_lr=True", "algo.total_steps=42")
OPTIMIZERS = {
    "rmsprop": ("algo.optimizer.name=rmsprop", "algo.optimizer.eps=0.1"),
    "rmsprop-momentum-centered": ("algo.optimizer.name=rmsprop", "algo.optimizer.eps=0.1",
                                  "algo.optimizer.momentum=0.9", "algo.optimizer.centered=True"),
    "rmsprop_tf": ("algo.optimizer.name=rmsprop_tf", "algo.optimizer.alpha=0.9", "algo.optimizer.eps=0.1"),
    "rmsprop_tf-momentum-centered": ("algo.optimizer.name=rmsprop_tf", "algo.optimizer.alpha=0.9",
                                     "algo.optimizer.eps=0.1", "algo.optimizer.momentum=0.9",
                                     "algo.optimizer.centered=True"),
}
ENVS = {
    "discrete-pixels": ("env.id=discrete_dummy", "env.wrapper.image_size=[84,84,3]", "env.screen_size=84",
                        "env.frame_stack=2", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[]",
                        "algo.encoder.cnn_features_dim=16"),
    "continuous": ("env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]"),
}
CASES = [("rmsprop", "discrete-pixels"), ("rmsprop_tf", "discrete-pixels"),
         ("rmsprop-momentum-centered", "continuous"), ("rmsprop_tf-momentum-centered", "continuous")]


@pytest.mark.parametrize("opt,env", CASES, ids=[f"{o}-{e}" for o, e in CASES])
def test_two_a2c_updates_with_anneal_lr_match_jax(opt, env, tmp_path, monkeypatch):
    overrides = (*BASE, *OPTIMIZERS[opt], *ENVS[env])
    jfn, jcfg, jfabric, obs_space, act_space = capture_jax_train_phase(jax_a2c_main, overrides, tmp_path,
                                                                       monkeypatch)
    actions_dim, cont = jax_spaces_to_dims(act_space)
    cnn_keys, mlp_keys = tuple(jcfg.algo.cnn_keys.encoder), tuple(jcfg.algo.mlp_keys.encoder)
    _, init = jax_agent.build_agent(jfabric, actions_dim, cont, jcfg, obs_space)
    params = draw_params(init, seed=1)
    optimizer = jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    trainer, cfg = port_trainer(overrides, params, A2CTrainer, actions_dim, cont, obs_space, T, B)

    p, o_state = params, optimizer.init(params)
    total_iters = int(jcfg.algo.total_steps) // (T * B)
    for update in (1, 2):
        rollout, last_obs, _ = rollout_from_seed(10 + update, obs_space, cnn_keys + mlp_keys, cnn_keys,
                                                 actions_dim, cont, T, B)
        p, o_state, jax_losses = jfn(p, o_state, rollout, last_obs)
        losses = trainer.train_phase({k: torch.from_numpy(v) for k, v in rollout.items()},
                                     {k: torch.from_numpy(v) for k, v in last_obs.items()}, None, 0.0, 0.01)
        assert_losses_match(losses, jax_losses, rtol=1e-5)
        assert float(losses[2]) > 0  # the logged entropy is the positive mean
        assert_params_match(trainer.agent, p, **PARAM_TOL)
        # the loop's anneal_lr schedule, between the updates
        lr = polynomial_decay(update, initial=float(cfg.algo.optimizer.lr), final=0.0, max_decay_steps=total_iters)
        assert lr == jax_polynomial_decay(update, initial=float(jcfg.algo.optimizer.lr), final=0.0,
                                          max_decay_steps=total_iters)
        o_state = jax_set_lr(o_state, lr)
        set_learning_rate(trainer.optimizer, lr)
        np.testing.assert_allclose(get_learning_rate(trainer.optimizer), jax_get_lr(o_state), rtol=1e-7)


@pytest.mark.parametrize("name,extra", [
    ("rmsprop", {}), ("rmsprop", {"momentum": 0.9}), ("rmsprop", {"momentum": 0.5, "centered": True}),
    ("rmsprop_tf", {}), ("rmsprop_tf", {"momentum": 0.9}), ("rmsprop_tf", {"momentum": 0.5, "centered": True}),
])
def test_rmsprop_steps_match_optax_under_a_changing_learning_rate(name, extra):
    """Four steps of the optimizer alone on numpy gradients, the learning
    rate changed before each, against the JAX package's optax chain."""
    cfg = dotdict({"name": name, "lr": 0.05, "alpha": 0.9, "eps": 0.1, **extra})
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = [rng.standard_normal((3, 5)).astype(np.float32) * s for s in (1.0, 0.1, 3.0, 0.5)]
    tx = jax_build_optimizer(cfg)
    p = {"w": jnp.asarray(w0)}
    state = tx.init(p)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = build_optimizer([w], cfg)
    for i, g in enumerate(grads):
        lr = 0.05 / (i + 1)
        state = jax_set_lr(state, lr)
        set_learning_rate(opt, lr)
        updates, state = tx.update({"w": jnp.asarray(g)}, state, p)
        p = {"w": p["w"] + updates["w"]}
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]), rtol=0, atol=2e-6)
