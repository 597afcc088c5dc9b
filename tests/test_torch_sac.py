"""SAC of the port against the JAX package's, on the CPU.

Both sides start from the parameters the JAX ``build_agent`` draws from the
seed (carried across by ``sheeprl_tpu_torch.convert.sac_state_from_jax``),
take the same numpy-drawn inputs, and the port takes the noise JAX's keys
draw.  The whole train phase is the live JAX ``make_sac_train_fns`` phase:
3 updates of batch 8 from global step 0 with ``target_network_frequency``
2 (the target EMA fires at steps 0 and 2 and skips step 1) and ``tau`` 0.5
(at the recipe's 0.005 an EMA moves the target by less than the
tolerance), terminated and running rows mixed.

Tolerances (the tiers of ``tests/test_regression/DRIFT.md``): forwards,
samples, log-probs and losses 1e-5; after the train phase (three Adam steps
of lr 3e-4 on each group) every parameter within 1e-5 absolute of JAX's and
the losses' means within 1e-5 relative.  The loop's stored transitions are
checked on a real rollout: a time-limit truncation keeps ``terminated`` 0
(so the update bootstraps through it) and stores the real final
observation as the next one.
"""

import glob
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.sac import agent as jax_agent
from sheeprl_tpu.algos.sac import loss as jax_loss
from sheeprl_tpu.algos.sac.sac import make_sac_train_fns
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.algos.sac import agent as pt_agent
from sheeprl_tpu_torch.algos.sac import loss as pt_loss
from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import sac_state_from_jax
from sheeprl_tpu_torch.fabric import build_fabric

TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0.0, atol=1e-5)
LOSS_RTOL = 1e-5
OBS_DIM, ACT_DIM = 4, 2
FIXTURE = pathlib.Path(__file__).parent / "test_regression" / "reference_fixture.json"
SAC = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu", "algo.hidden_size=16",
       "algo.critic.target_network_frequency=2", "algo.tau=0.5"]


def _t(a):
    return torch.from_numpy(np.array(a))


# -- shared harness (the DroQ tests use it too) -------------------------------
def setup(overrides, jax_build=jax_agent.build_agent, pt_build=pt_agent.build_agent, obs_dim=OBS_DIM):
    """The JAX modules and parameters, and the port agent on the CPU built
    from the same parameters; with both configs."""
    jcfg = jax_compose(list(overrides))
    cfg = compose(list(overrides))
    actor, critic, params = jax_build(jax_build_fabric(jcfg), ACT_DIM, jcfg, obs_dim)
    params = jax.device_get(params)
    agent = pt_build(build_fabric(cfg), ACT_DIM, cfg, obs_dim, sac_state_from_jax(params))
    return jcfg, cfg, actor, critic, params, agent


def draw_batches(U, B, seed=0, obs_dim=OBS_DIM):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((U, B, obs_dim)).astype(np.float32),
            "next_obs": rng.standard_normal((U, B, obs_dim)).astype(np.float32),
            "actions": rng.uniform(-0.99, 0.99, (U, B, ACT_DIM)).astype(np.float32),
            "rewards": rng.standard_normal((U, B)).astype(np.float32),
            "terminated": (rng.random((U, B)) < 0.4).astype(np.float32)}


def jax_update_keys(k, U):
    """Each update's ``(k_next, k_pi, k_d1, k_d2, k_d3)``, as the JAX phase splits them."""
    return [jax.random.split(ku, 5) for ku in jax.random.split(k, U)]


def action_noise(key, B):
    return _t(jax.random.normal(key, (B, ACT_DIM)))


def jax_optimizers(jcfg, params):
    opts = [jax_build_optimizer(jcfg.algo[g].optimizer) for g in ("actor", "critic", "alpha")]
    o_state = {"actor": opts[0].init(params["actor"]), "critic": opts[1].init(params["critic"]),
               "alpha": opts[2].init(params["log_alpha"])}
    return opts, o_state


def run_both(overrides, critic_apply, masks_of=None, U=3, B=8, step0=0, jax_build=jax_agent.build_agent,
             pt_build=pt_agent.build_agent):
    """One train phase on each side from the same parameters and batches;
    ``masks_of(critic, params, k, obs_shape_like)`` gives the port the
    dropout masks JAX draws from key ``k``.  Returns the port agent and
    losses and JAX's parameters and losses."""
    jcfg, cfg, actor, critic, params, agent = setup(overrides, jax_build, pt_build)
    opts, o_state = jax_optimizers(jcfg, params)
    _, train_phase = make_sac_train_fns(actor, critic, critic_apply, *opts, jcfg, ACT_DIM)
    host = draw_batches(U, B)
    k = jax.random.PRNGKey(3)
    noise = []
    for k_next, k_pi, *k_d in jax_update_keys(k, U):
        nz = {"next": action_noise(k_next, B), "pi": action_noise(k_pi, B)}
        if masks_of is not None:
            nz["masks"] = {call: masks_of(critic, params, kd, B) for call, kd in zip(("target", "critic", "actor"), k_d)}
        noise.append(nz)
    trainer = SACTrainer(cfg, agent, SACTrainer.build_optimizers(cfg, agent), ACT_DIM)
    got = trainer.train_phase({k_: _t(v) for k_, v in host.items()}, noise, step0)
    new_params, _, want = train_phase(params, o_state, {k_: jnp.asarray(v) for k_, v in host.items()}, k,
                                      jnp.int32(step0))
    return agent, got, jax.device_get(new_params), [float(x) for x in want]


def assert_agent_matches(agent, jax_params, **tol):
    want = sac_state_from_jax(jax_params)
    got = agent.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), err_msg=k, **(tol or PARAM_TOL))


def plain_apply(critic, cp, o, a, k):
    return critic.apply(cp, o, a)


# -- the modules ---------------------------------------------------------------
def test_actor_and_critic_ensemble_match_jax():
    _, _, actor, critic, params, agent = setup(SAC)
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((6, OBS_DIM)).astype(np.float32)
    act = rng.uniform(-1, 1, (6, ACT_DIM)).astype(np.float32)
    mean, log_std = actor.apply(params["actor"], jnp.asarray(obs))
    got_mean, got_log_std = agent.actor(_t(obs))
    np.testing.assert_allclose(got_mean.detach().numpy(), np.asarray(mean), **TOL)
    np.testing.assert_allclose(got_log_std.detach().numpy(), np.asarray(log_std), **TOL)
    qs = critic.apply(params["critic"], jnp.asarray(obs), jnp.asarray(act))
    got_qs = agent.critic(_t(obs), _t(act))
    assert got_qs.shape == (2, 6)
    np.testing.assert_allclose(got_qs.detach().numpy(), np.asarray(qs), **TOL)
    # the ensemble is stacked weights, one batched product per layer
    assert agent.critic.q_ensemble.dense_0.kernel.shape == (2, OBS_DIM + ACT_DIM, 16)
    assert float(agent.log_alpha.detach()) == pytest.approx(float(params["log_alpha"]))
    assert all(not p.requires_grad for p in agent.target_critic.parameters())


@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
def test_sample_action_matches_jax(greedy):
    _, _, actor, _, params, agent = setup(SAC)
    obs = np.random.default_rng(2).standard_normal((5, OBS_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    a, lp = jax_agent.sample_action(actor, params["actor"], jnp.asarray(obs), key, greedy=greedy)
    got_a, got_lp = pt_agent.sample_action(agent.actor, _t(obs), None if greedy else action_noise(key, 5), greedy)
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(got_lp.detach().numpy(), np.asarray(lp), **TOL)


def test_losses_match_jax_and_the_reference_fixture():
    rng = np.random.default_rng(3)
    qs, target = rng.standard_normal((2, 7)).astype(np.float32), rng.standard_normal(7).astype(np.float32)
    lp, min_q = rng.standard_normal(7).astype(np.float32), rng.standard_normal(7).astype(np.float32)
    pairs = [(pt_loss.critic_loss(_t(qs), _t(target)), jax_loss.critic_loss(jnp.asarray(qs), jnp.asarray(target))),
             (pt_loss.actor_loss(torch.tensor(0.3), _t(lp), _t(min_q)),
              jax_loss.actor_loss(0.3, jnp.asarray(lp), jnp.asarray(min_q))),
             (pt_loss.alpha_loss(torch.tensor(-0.7), _t(lp), -2.0),
              jax_loss.alpha_loss(jnp.asarray(-0.7), jnp.asarray(lp), -2.0))]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    # the temperature's gradient reaches log_alpha only
    log_alpha, lp_t = torch.tensor(-0.7, requires_grad=True), _t(lp).requires_grad_(True)
    pt_loss.alpha_loss(log_alpha, lp_t, -2.0).backward()
    assert lp_t.grad is None and float(log_alpha.grad) == pytest.approx(-float(np.mean(lp - 2.0)), rel=1e-6)

    sec = json.loads(FIXTURE.read_text())["sac"]
    inp = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sec["inputs"].items()}
    got = {"critic_loss": pt_loss.critic_loss(inp["qf_values"].T, inp["next_qf_value"][:, 0]),
           "policy_loss": pt_loss.actor_loss(torch.tensor(sec["alpha"]), inp["logprobs"][:, 0], inp["min_q"][:, 0]),
           "entropy_loss": pt_loss.alpha_loss(torch.tensor(sec["log_alpha"]), inp["logprobs"][:, 0],
                                              sec["target_entropy"])}
    for name, want in sec["expected"].items():
        assert float(got[name]) == pytest.approx(want, rel=1e-5, abs=1e-6), name


def test_ema_update_matches_jax():
    _, _, _, _, params, agent = setup(SAC)
    rng = np.random.default_rng(4)
    online = jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(np.float32), params["critic"])
    want = jax_agent.ema_update(params["target_critic"], online, 0.005)
    agent.critic.load_state_dict({k.split(".", 1)[1]: v for k, v in sac_state_from_jax(
        {"critic": online, "log_alpha": params["log_alpha"]}).items() if k.startswith("critic.")})
    pt_agent.ema_update(agent.target_critic, agent.critic, 0.005)
    full = sac_state_from_jax({"critic": want, "target_critic": want, "log_alpha": params["log_alpha"]})
    for k, v in agent.target_critic.state_dict().items():
        np.testing.assert_allclose(v.numpy(), full[f"target_critic.{k}"].numpy(), rtol=0, atol=1e-7, err_msg=k)


# -- the train phase ---------------------------------------------------------------
def test_train_phase_matches_jax():
    agent, got, want_params, want = run_both(SAC, plain_apply)
    assert_agent_matches(agent, want_params)
    np.testing.assert_allclose([float(x) for x in got], want, rtol=LOSS_RTOL, atol=1e-7)


def test_train_phase_draws_its_noise_from_the_generator():
    """With a generator, each update draws its own next-action and actor
    noise: the same generator state twice gives the same phase."""
    cfg = compose(SAC)
    results = []
    for _ in range(2):
        agent = pt_agent.build_agent(build_fabric(cfg), ACT_DIM, cfg, OBS_DIM)
        trainer = SACTrainer(cfg, agent, SACTrainer.build_optimizers(cfg, agent), ACT_DIM)
        losses = trainer.train_phase({k: _t(v) for k, v in draw_batches(2, 8).items()},
                                     torch.Generator().manual_seed(5), 0)
        results.append((losses, agent.state_dict()))
    assert all(torch.isfinite(x) for x in results[0][0])
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


# -- the loop ------------------------------------------------------------------------
LOOP = [*SAC, "metric/logger=csv", "buffer.memmap=False", "checkpoint.async_save=False", "env.num_envs=2",
        "algo.per_rank_batch_size=4", "algo.run_test=False", "checkpoint.every=1000000", "buffer.size=64"]


def test_stored_transitions_bootstrap_through_truncation(tmp_path):
    """A real rollout whose episodes end by the time limit (6 steps, before
    the dummy env's own end): the stored ``terminated`` stays 0, so the
    target bootstraps through the truncation, and the stored next
    observation of the last step is the real final one (state 6), not the
    reset that replaced it."""
    run([*LOOP, "env.max_episode_steps=6", "algo.total_steps=28", "algo.learning_starts=100",
         f"log_dir={tmp_path}"])
    (snapshot,) = glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True)
    rb = load_step_dir(snapshot)["rb"]["buffer"]
    obs, next_obs = np.asarray(rb["obs"]), np.asarray(rb["next_obs"])
    assert obs.shape == (32, 2, OBS_DIM) and np.asarray(rb["terminated"])[:14].sum() == 0
    steps = obs[:14, :, 0]  # the dummy env's state is its step count
    np.testing.assert_array_equal(steps[:, 0], np.tile(np.arange(6), 3)[:14])
    assert (next_obs[5, :, 0] == 6).all() and (obs[6, :, 0] == 0).all()
    np.testing.assert_array_equal(next_obs[:14, 0, 0][steps[:, 0] < 5], steps[:, 0][steps[:, 0] < 5] + 1)


@pytest.mark.parametrize("window_iters", [1, 3])
def test_train_window_and_update_chunks_match_jax(window_iters):
    """``TrainWindow`` releases the steps ``Ratio`` grants as the JAX one
    does (K = 1 every iteration; K = 3 every third and at the last), and a
    SAC-AE window splits into the JAX host path's power-of-two chunks."""
    from sheeprl_tpu.data.device_replay import update_chunks as jax_update_chunks
    from sheeprl_tpu.utils.utils import TrainWindow as JaxTrainWindow
    from sheeprl_tpu_torch.algos.sac.sac import update_chunks
    from sheeprl_tpu_torch.utils.utils import TrainWindow

    port, ref = TrainWindow(window_iters, pending=2), JaxTrainWindow(window_iters, pending=2)
    granted = np.random.default_rng(0).integers(0, 5, 20)
    got = [port.push(int(g), u, 4, 23) for u, g in zip(range(4, 24), granted)]
    assert got == [ref.push(int(g), u, 4, 23) for u, g in zip(range(4, 24), granted)]
    assert sum(got) == 2 + int(granted.sum()) and port.pending == 0
    for n in (1, 3, 7, 1024, 1500, 4097):
        assert update_chunks(n) == jax_update_chunks(n)
