"""The port's serving path on the CPU: the DreamerV3 player against the JAX
package's player, snapshot discovery, the HTTP surface, and the fabric.

Player parity: one JAX parameter tree, carried across by
``sheeprl_tpu_torch.convert``; both players run three chained steps on the
same observations, and the port is handed the posterior Gumbel noise the JAX
step draws from its dispatch seed.  ``h`` must agree within 1e-4 and the
posterior samples and greedy actions exactly (argmax indices).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu.serve.players import build_dreamer_v3_player as jax_player
from sheeprl_tpu.utils.distribution import OneHotCategorical as JaxOneHot
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
from sheeprl_tpu_torch.checkpoint.protocol import COMMIT_FILE, shard_name, verify_checkpoint, write_snapshot
from sheeprl_tpu_torch.config.compose import ConfigError, compose
from sheeprl_tpu_torch.convert import agent_state_from_jax
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.serve.client import PolicyClient, ServeRequestError
from sheeprl_tpu_torch.serve.loader import load_policy, probe_spaces, resolve_checkpoint, write_run_config
from sheeprl_tpu_torch.serve.players import build_dreamer_v3_player
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.serve.service import PolicyService

TINY = (
    "exp=dreamer_v3",
    "env=dummy", "env.sync_env=True",
    "algo=dreamer_v3_XS",
    "fabric.accelerator=cpu",
    "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]",
    "algo.world_model.encoder.cnn_channels_multiplier=2",
    "algo.dense_units=16",
    "algo.mlp_layers=1",
    "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.transition_model.hidden_size=16",
    "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.stochastic_size=4",
    "algo.world_model.discrete_size=5",
)


def _jax_params(cfg, fabric, obs_space, action_space, seed=0):
    """The JAX agent's parameter tree with numpy-drawn values (shapes from
    ``eval_shape``): kernels ~ N(0, 1/fan_in), LN scales near one, the rest
    small, so no weight sits at an init value that would hide a layout error."""
    actions_dim, is_cont = jax_spaces_to_dims(action_space)
    shapes = jax.eval_shape(lambda: jax_build_agent(fabric, actions_dim, is_cont, cfg, obs_space)[3])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("kernel"):
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * noise if name.endswith("scale") else 0.1 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("flags", [(), ("algo.world_model.recurrent_model.fused_pallas=True",)],
                         ids=["flags-off", "fused_pallas"])
def test_player_step_parity_with_jax(flags):
    overrides = [*TINY, *flags]
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jfabric, pfabric = jax_build_fabric(jcfg), build_fabric(pcfg)
    obs_space, action_space = jax_probe_spaces(jcfg)
    params = _jax_params(jcfg, jfabric, obs_space, action_space)
    jp = jax_player(jfabric, jcfg, {"agent": params}, obs_space, action_space)
    p_obs_space, p_action_space = probe_spaces(pcfg)
    pp = build_dreamer_v3_player(
        pfabric, pcfg, {"agent": agent_state_from_jax(params, pcfg)}, p_obs_space, p_action_space
    )
    assert pp.obs_spec == jp.obs_spec and pp.carry_spec == jp.carry_spec

    B, rng = 3, np.random.default_rng(0)
    greedy = np.ones((B,), bool)
    j_carry, p_carry = jp.zero_carry(B), tuple(torch.zeros(B, *s) for s, _ in pp.carry_spec)
    stoch, discrete = pcfg.algo.world_model.stochastic_size, pcfg.algo.world_model.discrete_size
    for step in range(3):
        raw = {
            "rgb": rng.integers(0, 256, (B, 64, 64, 3), dtype=np.uint8),
            "state": rng.standard_normal((B, 4)).astype(np.float32),
        }
        seed = 100 + step
        j_carry, j_actions = jp.step_batch(jp.params, j_carry, jp.prepare(raw), seed, greedy)
        # the noise the JAX step's posterior sample draws (categorical = argmax(logits + gumbel))
        k_repr, _ = jax.random.split(jax.random.PRNGKey(seed))
        noise = torch.from_numpy(np.array(JaxOneHot.sample_noise(k_repr, (B, stoch, discrete))))
        obs = {k: torch.from_numpy(v) for k, v in pp.prepare(raw).items()}
        with torch.no_grad():
            p_carry, p_actions = pp.step(pp.params, p_carry, obs, seed, torch.from_numpy(greedy), post_noise=noise)
        np.testing.assert_allclose(p_carry[0].numpy(), j_carry[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(
            p_carry[1].numpy().reshape(B, stoch, discrete).argmax(-1), j_carry[1].reshape(B, stoch, discrete).argmax(-1)
        )
        np.testing.assert_array_equal(pp.postprocess(p_actions.numpy()), jp.postprocess(j_actions))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A run directory holding config.yaml and one committed port snapshot."""
    cfg = compose([*TINY, "algo.world_model.recurrent_model.fused_pallas=True", "seed=3"])
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    actions_dim, is_cont = spaces_to_dims(action_space)
    modules = build_agent(fabric, actions_dim, is_cont, cfg, obs_space)
    run = tmp_path_factory.mktemp("torch_run")
    write_run_config(run, cfg)
    write_snapshot(run / "checkpoint", 8, {"agent": {n: m.state_dict() for n, m in modules.items()}})
    return run


def test_snapshot_round_trip_and_torn_snapshot(tiny_run, tmp_path):
    step_dir = resolve_checkpoint(tiny_run)
    assert step_dir.name == "step_000000000008" and verify_checkpoint(step_dir) == []
    fabric, cfg, state, player = load_policy(tiny_run)
    assert player.checkpoint_step == 8 and fabric.device.type == "cpu"
    wm = player.params["world_model"]
    assert torch.equal(wm.recurrent_model.gru_kernel, state["agent"]["world_model"]["recurrent_model.gru_kernel"])

    torn = tmp_path / "run" / "checkpoint"
    write_snapshot(torn, 9, {"agent": {}})
    (torn / "step_000000000009" / COMMIT_FILE).unlink()
    with pytest.raises(ConfigError, match="torn"):
        resolve_checkpoint(torn / "step_000000000009")
    with pytest.raises(ConfigError, match="no committed checkpoint"):
        resolve_checkpoint(tmp_path / "run")

    damaged = tmp_path / "damaged"
    step = write_snapshot(damaged, 10, {"agent": {}})
    shard = step / shard_name(0)
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    assert verify_checkpoint(step) and "CRC" in verify_checkpoint(step)[0]
    with pytest.raises(ConfigError, match="damaged"):
        resolve_checkpoint(step)


def test_http_server_serves_sessions(tiny_run):
    service = PolicyService.from_checkpoint(tiny_run, ["serve.batch_ladder=[1,8]", "serve.max_wait_ms=2"])
    with PolicyServer(service, port=0) as server:
        client = PolicyClient(server.url, packed=True)
        health = client.health()
        assert health["ok"] and health["stateful"] and health["obs_spec"]["rgb"] == [[64, 64, 3], "uint8"]
        sessions, steps, errors = 4, 3, []

        def play(i):
            rng = np.random.default_rng(i)
            try:
                for _ in range(steps):
                    obs = {"rgb": rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
                           "state": rng.standard_normal(4).astype(np.float32)}
                    action = client.act(obs, session=f"s{i}", greedy=i % 2 == 0)
                    assert action.shape == () and 0 <= int(action) < 4
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=play, args=(i,)) for i in range(sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors and not any(t.is_alive() for t in threads)
        stats = client.stats()
        assert stats["served"] == sessions * steps and stats["errors"] == 0 and stats["sessions"] == sessions
        client.reset("s0")
        assert client.stats()["sessions"] == sessions - 1
        with pytest.raises(ServeRequestError) as err:
            client.act({"rgb": np.zeros((64, 64, 3), np.uint8)})
        assert err.value.status == 400


def test_build_fabric_refuses_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for accelerator in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            build_fabric(compose([*TINY, f"fabric.accelerator={accelerator}"]))
    assert build_fabric(compose(list(TINY))).device.type == "cpu"
    # the precision policy is JAX's table, in torch dtypes
    from sheeprl_tpu.parallel.fabric import Precision as JaxPrecision

    for name in ("32-true", "bf16-mixed", "bf16-true"):
        policy = build_fabric(compose([*TINY, f"fabric.precision={name}"])).precision
        ref = JaxPrecision.from_string(name)
        assert policy.name == name
        assert (str(policy.param_dtype), str(policy.compute_dtype)) == (
            f"torch.{np.dtype(ref.param_dtype).name}", f"torch.{np.dtype(ref.compute_dtype).name}")
    with pytest.raises(ValueError, match="Unknown precision"):
        build_fabric(compose([*TINY, "fabric.precision=16-mixed"]))


# -- the sac player --------------------------------------------------------------
def test_sac_player_matches_jax_player():
    """Both SAC players on one parameter tree, with an action space whose
    bounds are not [-1, 1]: a batch of mixed greedy and sampled rows, the
    port handed the standard-normal draws the JAX step makes from its seed;
    the actions and their rescaling to the bounds agree within 1e-5."""
    import gymnasium

    from sheeprl_tpu.algos.sac.agent import build_agent as jax_sac_agent
    from sheeprl_tpu.serve.players import build_sac_player as jax_sac_player
    from sheeprl_tpu_torch.convert import sac_state_from_jax
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.serve.players import PLAYER_BUILDERS, build_sac_player

    overrides = ["exp=sac", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "fabric.accelerator=cpu", "algo.hidden_size=16"]
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    jfabric = jax_build_fabric(jcfg)
    obs_space, _ = jax_probe_spaces(jcfg)
    low, high = np.array([-2.0, 0.0], np.float32), np.array([3.0, 1.0], np.float32)
    params = jax.device_get(jax_sac_agent(jfabric, 2, jcfg, 4)[2])
    jp = jax_sac_player(jfabric, jcfg, {"agent": params}, obs_space, gymnasium.spaces.Box(low, high))
    p_obs, _ = probe_spaces(pcfg)
    pp = build_sac_player(build_fabric(pcfg), pcfg, {"agent": sac_state_from_jax(params)}, p_obs,
                          spaces.Box(low, high, (2,), np.float32))
    assert "sac_decoupled" not in PLAYER_BUILDERS
    assert set(pp.params) == {"actor"} and not pp.stateful and pp.obs_spec == jp.obs_spec

    rng, n, seed = np.random.default_rng(6), 4, 21
    raw = {"rgb": rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8),
           "state": rng.standard_normal((n, 4)).astype(np.float32)}
    greedy = np.array([True, False, False, True])
    _, j_actions = jp.step_batch(jp.params, (), jp.prepare(raw), seed, greedy)
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, 2))))
    obs = {k: torch.from_numpy(v) for k, v in pp.prepare(raw).items()}
    with torch.no_grad():
        _, p_actions = pp.step(pp.params, (), obs, seed, torch.from_numpy(greedy), noise=noise)
    np.testing.assert_allclose(p_actions.numpy(), np.asarray(j_actions), rtol=1e-5, atol=1e-5)
    scaled = pp.postprocess(p_actions.numpy())
    np.testing.assert_allclose(scaled, jp.postprocess(np.asarray(j_actions)), rtol=1e-5, atol=1e-5)
    assert ((scaled >= low) & (scaled <= high)).all()


@pytest.mark.parametrize("exp", ["sac", "droq", "sac_ae"])
def test_off_policy_training_refuses_to_fall_back_to_cpu(monkeypatch, tmp_path, exp):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        run([f"exp={exp}", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "dry_run=True", f"log_dir={tmp_path}"])
