"""The port's serving fleet on the CPU: ``serve/fleet/router.py`` against the
stub replicas of ``tests/test_serve/test_fleet.py`` (churn, least-loaded
dispatch, sticky sessions, failover, carry migration, breaker eject and
readmit, rolling reload halting on poison, the watcher refusing a poisoned
commit), ``assign_replica`` equal to JAX's, fault plans at ``serve.router``
and ``serve.replica``, a session whose slot respawned migrated onto the new
process, and one fleet of two real port replicas through a SIGKILL."""

import json
import sys
import threading
import time

import numpy as np
import pytest

from sheeprl_tpu.serve.fleet.router import assign_replica as jax_assign_replica
from sheeprl_tpu_torch.resilience import faults
from sheeprl_tpu_torch.serve.fleet.router import FleetRouter, FleetServer, assign_replica
from tests.test_serve.test_fleet import StubReplica, _cfg


def _close(stubs):
    """Shut the stubs down together (each waits out its server's poll)."""
    threads = [threading.Thread(target=s.close) for s in stubs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)


@pytest.fixture
def stub_fleet():
    """Three probed stub replicas behind an (unstarted) router."""
    stubs = [StubReplica() for _ in range(3)]
    router = FleetRouter({f"r{i}": s.url for i, s in enumerate(stubs)}, _cfg())
    for rep in router.replica_list():
        assert router._probe(rep)
    yield router, stubs
    _close(stubs)


def _act(router, session=None):
    body = {"obs": {"state": [0.0, 0.0, 0.0, 0.0]}}
    if session is not None:
        body["session"] = session
    return router.act(json.dumps(body).encode())


@pytest.mark.parametrize("rids", [["r0", "r1"], ["r0", "r1", "r2"], ["r2", "r5", "r7", "r11"]],
                         ids=["two", "three", "four"])
def test_assign_replica_equals_jax(rids):
    """Clients and replicas of either package agree on every session."""
    sessions = [f"session-{i}" for i in range(1000)]
    assert [assign_replica(s, rids) for s in sessions] == [jax_assign_replica(s, rids) for s in sessions]
    assert assign_replica("x", list(reversed(rids))) == assign_replica("x", rids)


def test_assign_replica_stable_under_churn():
    rids = ["r0", "r1", "r2"]
    sessions = [f"sess-{i}" for i in range(300)]
    before = {s: assign_replica(s, rids) for s in sessions}
    for rid in rids:
        assert 0.15 < sum(v == rid for v in before.values()) / len(sessions) < 0.55
    after_removal = {s: assign_replica(s, ["r0", "r2"]) for s in sessions}
    assert all(after_removal[s] == before[s] for s in sessions if before[s] != "r1")
    assert all(assign_replica(s, rids + ["r3"]) in (before[s], "r3") for s in sessions)
    assert assign_replica("x", []) is None


def test_least_loaded_tie_breaking(stub_fleet):
    router, _ = stub_fleet
    r0, r1, r2 = router.replica_list()
    r0.begin(), r0.begin(), r1.begin()
    assert router._pick(None, set()).rid == "r2"
    r2.begin()
    assert router._pick(None, set()).rid == "r1"
    assert router._pick(None, {"r1"}).rid == "r2"
    assert router._pick(None, {"r0", "r1", "r2"}) is None


def test_sticky_sessions_survive_replica_death(stub_fleet):
    router, stubs = stub_fleet
    code, payload = _act(router, session="drill-session")
    assert code == 200
    home = payload["replica"]
    for _ in range(5):
        code, payload = _act(router, session="drill-session")
        assert code == 200 and payload["replica"] == home
    stubs[int(home[1:])].close()
    router.mark_dead(home)
    code, payload = _act(router, session="drill-session")
    survivor = payload["replica"]
    assert code == 200 and survivor != home
    for _ in range(3):
        code, payload = _act(router, session="drill-session")
        assert code == 200 and payload["replica"] == survivor


def test_failover_costs_latency_not_requests(stub_fleet):
    router, stubs = stub_fleet
    stubs[0].fail_acts = stubs[1].fail_acts = 10
    for _ in range(4):
        assert _act(router)[0] == 200
    assert router.stats()["failovers"] >= 1
    for stub in stubs:
        stub.close()
    for rep in router.replica_list():
        rep.probed = False
    code, payload = _act(router)
    assert code == 503 and "replica_unavailable" in payload["error"]
    assert router.stats()["unroutable"] == 1


def test_carry_mirror_and_migration_on_death_and_on_respawn():
    """A dead replica's session replays reset + carry onto the survivor; a
    session whose slot came back as a new process replays it onto the new
    process (the JAX router routes it there with no replay)."""
    stubs = [StubReplica(stateful=True) for _ in range(2)]
    router = FleetRouter({f"r{i}": s.url for i, s in enumerate(stubs)}, _cfg())
    try:
        for rep in router.replica_list():
            assert router._probe(rep)
        code, payload = _act(router, session="ep-1")
        assert code == 200 and "carry" not in payload
        home = payload["replica"]
        _act(router, session="ep-1")
        with router._sessions_lock:
            mirrored = router._sessions["ep-1"]["carry"]
        assert mirrored is not None and mirrored["acts"] >= 1
        stubs[int(home[1:])].close()
        router.mark_dead(home)
        code, payload = _act(router, session="ep-1")
        survivor = stubs[int(payload["replica"][1:])]
        assert code == 200 and survivor.resets == 1 and survivor.restores == 1
        assert survivor.carries["ep-1"] == mirrored and router.stats()["migrations"] == 1

        # the survivor's slot is served by a new process at a new address
        with router._sessions_lock:
            mirrored = router._sessions["ep-1"]["carry"]
        reborn = StubReplica(stateful=True)
        stubs.append(reborn)
        router.replace_replica(payload["replica"], reborn.url)
        assert router._probe(router.get_replica(payload["replica"]))
        code, again = _act(router, session="ep-1")
        assert code == 200 and again["replica"] == payload["replica"]
        assert reborn.resets == 1 and reborn.restores == 1 and reborn.carries["ep-1"] == mirrored
        assert router.stats()["migrations"] == 2
    finally:
        _close(stubs)


def test_breaker_eject_and_readmit():
    stubs = [StubReplica() for _ in range(2)]
    router = FleetRouter({f"r{i}": s.url for i, s in enumerate(stubs)}, _cfg())
    router.start()
    try:
        assert router.wait_healthy(min_replicas=2, timeout=10.0)
        stubs[0].close()
        deadline = time.monotonic() + 10.0
        r0 = router.get_replica("r0")
        while r0.routable and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not r0.routable and router.stats()["ejects"] >= 1
        for _ in range(3):
            assert _act(router)[0] == 200
        assert stubs[1].acts >= 3 and stubs[0].acts == 0
        stubs[0].open()
        deadline = time.monotonic() + 10.0
        while not router.get_replica("r0").routable and time.monotonic() < deadline:
            time.sleep(0.05)
        assert router.get_replica("r0").routable and router.stats()["readmits"] >= 1
    finally:
        router.stop()
        _close(stubs)


def test_rolling_reload_halts_on_poison(tmp_path, stub_fleet):
    router, stubs = stub_fleet
    for s in stubs:
        s.reload_to = 200
    stubs[1].reload_mode = "error"
    with pytest.raises(IOError, match="r1 reload answered 500"):
        router._rollout_to(tmp_path / "step_200")
    assert [s.reloads for s in stubs] == [1, 1, 0]
    assert all(not rep.draining for rep in router.replica_list()) and router.stats()["reload_halts"] == 1
    stubs[1].reload_mode = "stale"
    with pytest.raises(IOError, match="r1 is at step"):
        router._rollout_to(tmp_path / "step_200")
    assert stubs[2].reloads == 0
    stubs[1].reload_mode = "ok"
    assert router._rollout_to(tmp_path / "step_200") == 200
    assert [s.reloads for s in stubs] == [3, 3, 1] and all(s.step == 200 for s in stubs)
    assert router.stats()["replicas_reloaded"] == 5


def test_watcher_rejects_poisoned_commit_before_any_replica(tmp_path):
    """A newer snapshot whose shard fails its CRC never reaches a replica;
    a good commit after it rolls out to every one."""
    import torch

    from sheeprl_tpu_torch.checkpoint.protocol import shard_name, write_snapshot

    stubs = [StubReplica(step=100) for _ in range(2)]
    router = FleetRouter({f"r{i}": s.url for i, s in enumerate(stubs)}, _cfg(reload_poll_s=3600.0),
                         ckpt_root=tmp_path)
    router.start()
    try:
        assert router.wait_healthy(min_replicas=2, timeout=10.0) and router._fleet_store.step == 100
        poisoned = write_snapshot(tmp_path, 200, {"agent": {"x": torch.zeros(64)}})
        shard = poisoned / shard_name(0)
        raw = bytearray(shard.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        shard.write_bytes(bytes(raw))
        code, payload = router.reload_once()
        assert code == 200 and payload["reloaded"] is False
        assert all(s.reloads == 0 for s in stubs) and router._fleet_store.step == 100
        assert router.watcher.last_error is not None
        for s in stubs:
            s.reload_to = 300
        write_snapshot(tmp_path, 300, {"agent": {"x": torch.ones(64)}})
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline and router._fleet_store.step != 300:
            router.reload_once()
            time.sleep(0.2)
        assert router._fleet_store.step == 300 and all(s.step == 300 for s in stubs)
        assert router.stats()["rolling_reloads"] == 1
    finally:
        router.stop()
        _close(stubs)


@pytest.mark.parametrize("site", ["serve.router", "serve.replica"])
def test_a_fault_plan_acts_at_each_fleet_site(stub_fleet, site):
    """``serve.router`` fails the router's own handling of a request;
    ``serve.replica`` fails one router→replica leg, which fails over."""
    router, stubs = stub_fleet
    assert site not in faults.UNPORTED_SITES
    faults.install_plan(faults.FaultPlan.from_specs([{"site": site, "kind": "raise", "at": 1}]))
    try:
        if site == "serve.router":
            with pytest.raises(faults.InjectedFault):
                _act(router)
            assert _act(router)[0] == 200
        else:
            code, payload = _act(router)
            assert code == 200 and router.stats()["failovers"] == 1
            assert sum(s.acts for s in stubs) == 1
        assert [spec._fires for spec in faults.active_plan().specs_for(site)] == [1]
    finally:
        faults.clear_plan()


def test_a_fleet_of_two_port_replicas_through_a_sigkill(tmp_path):
    """Two tiny port replicas (DreamerV3, CPU) behind the router: sessions
    step, one replica is SIGKILLed, every request is answered, its session
    continues on the survivor with its carry, the slot respawns, and each
    replica's ``/v1/stats`` reports its kernel launches."""
    import signal

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.checkpoint.protocol import write_snapshot
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.fleet import LocalFleet
    from sheeprl_tpu_torch.serve.loader import probe_spaces, write_run_config
    from tests.test_torch_model_registry import TINY_DV3

    cfg = compose([*TINY_DV3, "algo.world_model.recurrent_model.fused_pallas=True"])
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    modules = build_agent(fabric, *spaces_to_dims(action_space), cfg, obs_space)
    write_run_config(tmp_path / "run", cfg)
    write_snapshot(tmp_path / "run" / "checkpoint", 8, {"agent": {n: m.state_dict() for n, m in modules.items()}})

    fleet = LocalFleet(tmp_path / "run", overrides=["serve.batch_ladder=[1,4]", "serve.max_wait_ms=1"], replicas=2,
                       backoff_base_s=0.1, backoff_max_s=0.2, echo=False, device="cpu").start()
    server = None
    try:
        router = FleetRouter(fleet.addresses(), _cfg(health_poll_s=0.1, readmit_s=0.3, request_timeout_s=60.0))
        fleet.attach(router)
        server = FleetServer(router).start()
        assert router.wait_healthy(min_replicas=2, timeout=120.0) and router.stateful
        client = PolicyClient(server.url, timeout=60.0, retries=6, retry_base_s=0.1)
        obs = {"state": np.zeros(4, np.float32)}
        homes = {}
        for step in range(3):
            for session in ("a", "b", "c"):
                client.act(obs, session=session)
        with router._sessions_lock:
            homes = {s: router._sessions[s]["rid"] for s in ("a", "b", "c")}
        victim = homes["a"]
        stats = PolicyClient(router.get_replica(victim).url).stats()
        assert set(stats["kernel_launches"]) == {"rssm", "gru"}  # the CPU runs the plain versions: no launch
        fleet.kill(int(victim[1:]), sig=signal.SIGKILL)
        for step in range(3):
            for session in ("a", "b", "c"):
                assert client.act(obs, session=session).shape == tuple(client.health()["action_shape"])
        with router._sessions_lock:
            now = {s: router._sessions[s]["rid"] for s in ("a", "b", "c")}
        assert now["a"] != victim and router.stats()["migrations"] >= 1
        assert PolicyClient(router.get_replica(now["a"]).url).session_carry("a") is not None
        deadline = time.monotonic() + 120.0
        while router.stats()["respawns"] < 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert router.stats()["respawns"] == 1
    finally:
        if server is not None:
            server.stop()
        fleet.stop()


def test_a_replica_on_another_device_than_asked_is_a_failed_start(tmp_path, capsys):
    """A child that binds on the CPU when the fleet runs on the card is
    killed, never routed to."""
    from sheeprl_tpu_torch.serve.fleet import LocalFleet

    line = "serving dreamer_v3 (checkpoint step 8) on http://127.0.0.1:1 (cpu) — batch ladder [1]"
    fleet = LocalFleet(tmp_path, replicas=1, echo=False, device="cuda", spawn_timeout_s=30.0,
                       child_cmd=lambda argv: [sys.executable, "-c",
                                               f"import time; print({line!r}, flush=True); time.sleep(60)"])
    with pytest.raises(RuntimeError, match="failed to start"):
        fleet.start()
    assert "came up on cpu, not cuda: killed" in capsys.readouterr().out
