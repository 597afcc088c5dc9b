"""Hot reload of the port's policy service against the JAX player, on the CPU.

Two JAX parameter trees (seeds 0 and 1) are carried across with
``sheeprl_tpu_torch.convert`` and written as two committed port snapshots.
A service loaded from the first installs the second on ``poll_once``: its
player then steps as the JAX player built on the second tree (the posterior
noise handed over as ``test_torch_serve.py`` does, ``h`` within 1e-4, the
samples and greedy actions exact), and a dispatched action equals a fresh
service's on the second snapshot bit for bit.  A corrupt snapshot is
quarantined after ``reload_failure_threshold`` failed loads while the old
generation keeps serving; a session's carry makes the round trip through
``/v1/session_carry`` and a tampered one is refused; ``/metrics`` carries
``Serve/generation``.
"""

import urllib.request

import jax
import numpy as np
import pytest
import torch

from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu.serve.players import build_dreamer_v3_player as jax_player
from sheeprl_tpu.utils.distribution import OneHotCategorical as JaxOneHot
from sheeprl_tpu_torch.checkpoint.protocol import CORRUPT_SUFFIX, shard_name, write_snapshot
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import agent_state_from_jax
from sheeprl_tpu_torch.serve.client import PolicyClient, ServeRequestError
from sheeprl_tpu_torch.serve.loader import write_run_config
from sheeprl_tpu_torch.serve.server import PolicyServer
from sheeprl_tpu_torch.serve.service import PolicyService

from tests.test_torch_serve import TINY, _jax_params

SERVE = ["serve.batch_ladder=[1,4]", "serve.max_wait_ms=1", "serve.watch_commits=False",
         "serve.reload_failure_threshold=2", "serve.reload_breaker_reset_s=0.0"]


@pytest.fixture(scope="module")
def trees():
    """The JAX trees of seeds 0 and 1 and the JAX setup to build players from."""
    jcfg, pcfg = jax_compose(list(TINY)), compose(list(TINY))
    jfabric = jax_build_fabric(jcfg)
    obs_space, action_space = jax_probe_spaces(jcfg)
    return [_jax_params(jcfg, jfabric, obs_space, action_space, seed=s) for s in (0, 1)], (
        jcfg, jfabric, obs_space, action_space), pcfg


@pytest.fixture
def two_trees(trees, tmp_path):
    """A run directory of its own holding the seed-0 snapshot at step 8."""
    run = tmp_path / "reload_run"
    write_run_config(run, trees[2])
    write_snapshot(run / "checkpoint", 8, {"agent": agent_state_from_jax(trees[0][0], trees[2])})
    return (run, *trees)


def _obs(rng, batch=None):
    lead = () if batch is None else (batch,)
    return {"rgb": rng.integers(0, 256, (*lead, 64, 64, 3), dtype=np.uint8),
            "state": rng.standard_normal((*lead, 4)).astype(np.float32)}


def _served(service, seed, obs):
    service._seed = seed  # the dispatch seed is the next one
    return service.act(obs, greedy=False, timeout=60)


def test_poll_once_installs_the_newer_snapshot_and_serves_it(two_trees):
    run, trees, (jcfg, jfabric, obs_space, action_space), pcfg = two_trees
    service = PolicyService.from_checkpoint(run / "checkpoint" / "step_000000000008", SERVE).start()
    try:
        live = next(service.player.params["world_model"].recurrent_model.parameters())
        ptr = live.data_ptr()
        assert service.watcher.poll_once() is None  # nothing newer yet
        rng = np.random.default_rng(7)
        before = _served(service, 40, _obs(rng))
        write_snapshot(run / "checkpoint", 16, {"agent": agent_state_from_jax(trees[1], pcfg)})
        assert service.watcher.poll_once() == 1
        assert service.store.step == 16 and service.store.generation == 1 and service.watcher.reloads == 1
        assert live.data_ptr() == ptr  # installed in place: the captured step reads these addresses

        # the reloaded player steps as the JAX player on seed 1's tree
        jp = jax_player(jfabric, jcfg, {"agent": trees[1]}, obs_space, action_space)
        pp = service.player
        B, greedy = 3, np.ones((3,), bool)
        j_carry, p_carry = jp.zero_carry(B), tuple(torch.zeros(B, *s) for s, _ in pp.carry_spec)
        stoch, discrete = pcfg.algo.world_model.stochastic_size, pcfg.algo.world_model.discrete_size
        for step in range(2):
            raw, seed = _obs(rng, B), 200 + step
            j_carry, j_actions = jp.step_batch(jp.params, j_carry, jp.prepare(raw), seed, greedy)
            k_repr, _ = jax.random.split(jax.random.PRNGKey(seed))
            noise = torch.from_numpy(np.array(JaxOneHot.sample_noise(k_repr, (B, stoch, discrete))))
            obs = {k: torch.from_numpy(v) for k, v in pp.prepare(raw).items()}
            with torch.no_grad():
                p_carry, p_actions = pp.step(pp.params, p_carry, obs, seed, torch.from_numpy(greedy),
                                             post_noise=noise)
            np.testing.assert_allclose(p_carry[0].numpy(), j_carry[0], rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(p_carry[1].numpy().reshape(B, stoch, discrete).argmax(-1),
                                          j_carry[1].reshape(B, stoch, discrete).argmax(-1))
            np.testing.assert_array_equal(pp.postprocess(p_actions.numpy()), jp.postprocess(j_actions))

        # a dispatched action equals a fresh service's on the new snapshot, bit for bit
        obs = _obs(np.random.default_rng(3))
        fresh = PolicyService.from_checkpoint(run / "checkpoint" / "step_000000000016", SERVE).start()
        try:
            assert np.array_equal(_served(service, 40, obs), _served(fresh, 40, obs))
            assert fresh.store.step == 16 and fresh.store.generation == 0
        finally:
            fresh.stop()
        assert before.shape == ()
    finally:
        service.stop()


def test_corrupt_snapshot_is_quarantined_while_the_old_generation_serves(two_trees):
    run, trees, _, pcfg = two_trees
    service = PolicyService.from_checkpoint(run / "checkpoint" / "step_000000000008", SERVE).start()
    try:
        obs = _obs(np.random.default_rng(11))
        expected = _served(service, 5, obs)
        bad = write_snapshot(run / "checkpoint", 24, {"agent": agent_state_from_jax(trees[1], pcfg)})
        shard = bad / shard_name(0)
        data = bytearray(shard.read_bytes())
        data[len(data) // 2] ^= 0xFF
        shard.write_bytes(bytes(data))
        assert service.watcher.poll_once() is None and service.watcher.quarantined == 0
        assert service.watcher.poll_once() is None
        assert service.watcher.quarantined == 1 and "CRC" in service.watcher.last_error
        assert not bad.exists() and bad.with_name(bad.name + CORRUPT_SUFFIX).exists()
        assert service.store.step == 8 and service.store.generation == 0
        assert np.array_equal(_served(service, 5, obs), expected)
        stats = service.stats()
        assert stats["quarantined"] == 1 and stats["errors"] == 0 and stats["reload_breaker"]["state"] in (
            "open", "half_open")
    finally:
        service.stop()


def test_session_carry_round_trip_and_metrics_over_http(two_trees):
    run, *_ = two_trees
    service = PolicyService.from_checkpoint(run / "checkpoint" / "step_000000000008", SERVE)
    with PolicyServer(service, port=0) as server:
        client = PolicyClient(server.url, packed=True)
        rng = np.random.default_rng(5)
        for _ in range(2):
            client.act(_obs(rng), session="a")
        assert client.session_carry("nobody") is None
        snap = client.session_carry("a")
        assert snap["algo"] == "dreamer_v3" and len(snap["carry"]) == 3
        assert client.restore_session_carry("b", snap) == {"ok": True, "session": "b"}
        a, b = service._sessions["a"], service._sessions["b"]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        tampered = dict(snap, crc=(int(snap["crc"]) + 1) % 2**32)
        with pytest.raises(ServeRequestError) as err:
            client.restore_session_carry("c", tampered)
        assert err.value.status == 400 and "CRC" in str(err.value)
        with pytest.raises(ValueError, match="CRC"):
            service.restore_session_carry("c", tampered)
        assert "c" not in service._sessions

        health = client.health()
        assert health["degraded"] is False and health["reload_breaker"]["state"] == "closed"
        assert client.reload() == {"reloaded": False, "generation": 0, "checkpoint_step": 8}
        with urllib.request.urlopen(f"{server.url}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "sheeprl_serve_generation 0.0" in text and "sheeprl_serve_served 2.0" in text


def test_carry_crc_matches_jax():
    """The CRC stamp on a migrated carry is JAX's, so a carry snapshot moves
    between the two packages' servers."""
    from sheeprl_tpu.serve.service import _carry_crc as jax_crc
    from sheeprl_tpu_torch.serve.service import _carry_crc

    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((1, 16)).astype(np.float32), np.eye(4, dtype=np.float32)[None, 1]]
    assert _carry_crc(leaves) == jax_crc(leaves)
    assert _carry_crc(leaves[:1]) != _carry_crc(leaves)
