"""SAC-AE of the port against the JAX package's, on the CPU.

The whole train phase is the live JAX closure that
``sheeprl_tpu/algos/sac_ae/sac_ae.py::main`` hands to ``fabric.compile``
(captured as the PPO tests capture theirs): both sides start from the
parameters the JAX ``build_agent`` draws from the seed, take the same
batches (32x32 rgb frames and a 4-wide state, with their ``next_`` rows)
and the noise JAX's keys draw, the dither of the decoder's target among
it.  4 updates from global step 0 at the recipe's cadences (the actor and
the targets every 2 updates, the decoder every update) run the actor and
EMA branches at steps 0 and 2 and skip them at 1 and 3.

Tolerances: the encoder's features 1e-4 (convolutions); after the train
phase (four Adam steps of lr 1e-3 on the critic, encoder and decoder, two
on the actor and the temperature) every parameter within 1e-5 absolute and
the losses' means within 1e-5 relative.  The decoder's target holds to
``reference_fixture.json`` (``sac_ae``) with the dither zeroed.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac_ae.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.sac_ae.sac_ae import main as jax_sac_ae_main
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.algos.sac_ae.agent import build_agent
from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer, pixel_target
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import sac_state_from_jax
from sheeprl_tpu_torch.fabric import build_fabric
from tests.test_torch_ppo import capture_jax_train_phase

PARAM_TOL = dict(rtol=0.0, atol=1e-5)
CONV_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
FIXTURE = pathlib.Path(__file__).parent / "test_regression" / "reference_fixture.json"
SAC_AE = ["exp=sac_ae", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "fabric.accelerator=cpu", "env.screen_size=32",
          "env.wrapper.image_size=[32,32,3]", "algo.cnn_keys.encoder=[rgb]", "algo.mlp_keys.encoder=[state]",
          "algo.hidden_size=16", "algo.encoder.features_dim=8", "algo.cnn_channels_multiplier=2",
          "algo.dense_units=8", "algo.per_rank_batch_size=4"]
GROUPS = ("actor", "critic", "alpha", "encoder", "decoder")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """The JAX train phase, config, parameters and optimizer states, and
    the port agent built from the same parameters."""
    mp = pytest.MonkeyPatch()
    try:
        train_phase, jcfg, fabric, obs_space, act_space = capture_jax_train_phase(
            jax_sac_ae_main, SAC_AE, tmp_path_factory.mktemp("sac_ae"), mp)
    finally:
        mp.undo()
    act_dim = int(np.prod(act_space.shape))
    encoder, decoder, actor, critic, params = jax_build_agent(fabric, act_dim, jcfg, obs_space)
    params = jax.device_get(params)
    opts = {g: jax_build_optimizer(jcfg.algo[g].optimizer) for g in GROUPS}
    o_state = {g: opts[g].init(params["log_alpha" if g == "alpha" else g]) for g in GROUPS}
    cfg = compose(SAC_AE)
    agent = build_agent(build_fabric(cfg), act_dim, cfg, obs_space, sac_state_from_jax(params))
    return dict(train_phase=train_phase, cfg=cfg, params=params, o_state=o_state, agent=agent, act_dim=act_dim,
                encoder=encoder)


def draw_batches(U, B, act_dim, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for k in ("rgb", "next_rgb"):
        out[k] = rng.integers(0, 256, (U, B, 32, 32, 3), dtype=np.uint8)
    for k in ("state", "next_state"):
        out[k] = rng.standard_normal((U, B, 4)).astype(np.float32)
    out["actions"] = rng.uniform(-0.99, 0.99, (U, B, act_dim)).astype(np.float32)
    out["rewards"] = rng.standard_normal((U, B)).astype(np.float32)
    out["terminated"] = (rng.random((U, B)) < 0.4).astype(np.float32)
    return out


def jax_noise(k, U, B, act_dim):
    """Each update's draws as the JAX phase makes them: ``k_next``, ``k_pi``
    and ``k_dec`` from its key, the rgb dither from ``fold_in(k_dec, 0)``
    (rgb is observation key 0)."""
    noise = []
    for ku in jax.random.split(k, U):
        k_next, k_pi, k_dec = jax.random.split(ku, 3)
        noise.append({"next": _t(jax.random.normal(k_next, (B, act_dim))),
                      "pi": _t(jax.random.normal(k_pi, (B, act_dim))),
                      "dither": {"rgb": _t(jax.random.uniform(jax.random.fold_in(k_dec, 0), (B, 32, 32, 3)))}})
    return noise


def test_encoder_features_match_jax(captured):
    rng = np.random.default_rng(1)
    obs = {"rgb": rng.integers(0, 256, (3, 32, 32, 3)).astype(np.float32) / 255.0,
           "state": rng.standard_normal((3, 4)).astype(np.float32)}
    want = captured["encoder"].apply(captured["params"]["encoder"], {k: jnp.asarray(v) for k, v in obs.items()})
    agent = captured["agent"]
    got = agent.encoder({k: _t(v) for k, v in obs.items()})
    assert got.shape == (3, 8) and agent.encoder.ln.eps == 1e-6
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **CONV_TOL)


def test_decoder_target_matches_the_reference_fixture():
    sec = json.loads(FIXTURE.read_text())["sac_ae"]
    raw = torch.tensor(np.asarray(sec["inputs"]["raw"], np.float32))
    got = pixel_target(raw / 255.0, torch.zeros_like(raw))
    np.testing.assert_allclose(got.numpy(), np.asarray(sec["expected"]["target"], np.float32), rtol=1e-6, atol=1e-6)


def test_train_phase_matches_jax(captured):
    c = captured
    U, B = 4, 4
    host = draw_batches(U, B, c["act_dim"])
    k = jax.random.PRNGKey(5)
    agent = c["agent"]
    trainer = SACAETrainer(c["cfg"], agent, SACAETrainer.build_optimizers(c["cfg"], agent), c["act_dim"])
    assert (trainer.actor_freq, trainer.target_freq, trainer.decoder_freq) == (2, 2, 1)
    got = trainer.train_phase({name: _t(v) for name, v in host.items()}, jax_noise(k, U, B, c["act_dim"]), 0)
    new_params, _, want = c["train_phase"](c["params"], c["o_state"], {n: jnp.asarray(v) for n, v in host.items()},
                                           k, jnp.int32(0))
    want_state = sac_state_from_jax(jax.device_get(new_params))
    got_state = agent.state_dict()
    assert set(got_state) == set(want_state)
    for name, v in want_state.items():
        np.testing.assert_allclose(got_state[name].detach().numpy(), v.numpy(), err_msg=name, **PARAM_TOL)
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=LOSS_RTOL, atol=1e-7)
    # the decoder's weight_decay sits under name: adam and is not read, as in JAX
    assert "weight_decay" not in trainer.optimizers["decoder"].optimizer.defaults or \
        trainer.optimizers["decoder"].optimizer.defaults["weight_decay"] == 0
