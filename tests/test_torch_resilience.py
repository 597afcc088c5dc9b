"""The port's resilience layer (``sheeprl_tpu_torch/resilience/{retry,faults}.py``)
against the JAX package's (``sheeprl_tpu/resilience``), on the CPU.

Each case of ``tests/test_resilience/test_retry.py`` and ``test_faults.py``
is driven through JAX's module and the port's, with the same fake clocks,
random streams and plans: both must give the same outcome.  Then the port's
own wiring: the checkpoint writer's watchdog (``checkpoint.hang_warn_s``)
and its bounded ``close``, every fault site the port has firing once, and a
plan at a site whose module the port lacks refused with its ROADMAP item.
"""

import importlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR

# the modules (each package's ``resilience`` exports a function ``retry`` too)
jax_faults = importlib.import_module("sheeprl_tpu.resilience.faults")
jax_retry = importlib.import_module("sheeprl_tpu.resilience.retry")
faults = importlib.import_module("sheeprl_tpu_torch.resilience.faults")
retry = importlib.import_module("sheeprl_tpu_torch.resilience.retry")

MODULES = {"jax": (jax_retry, jax_faults), "torch": (retry, faults)}


@pytest.fixture(autouse=True)
def _clean_plans():
    for _, f in MODULES.values():
        f.clear_plan()
    yield
    for _, f in MODULES.values():
        f.clear_plan()


class FakeClock:
    """``time.monotonic`` / ``time.sleep`` that advance a counter."""

    def __init__(self):
        self.now, self.sleeps = 100.0, []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def _outcome(fn):
    """``("ok", value)`` or ``("raised", type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return ("raised", type(e).__name__, str(e))


# -- retry -------------------------------------------------------------------------
def _flaky(fail_times, exc=OSError("blip"), value="ok"):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fail_times:
            raise exc
        return value

    return fn, calls


def _retry_case(name, r):
    if name == "succeeds_after_transient_failures":
        fn, calls = _flaky(2)
        return _outcome(lambda: r.retry(fn, attempts=5, base_s=0.001)), len(calls)
    if name == "gives_up_after_attempts":
        fn, calls = _flaky(99, OSError("gone"))
        return _outcome(lambda: r.retry(fn, attempts=3, base_s=0.001)), len(calls)
    if name == "non_transient_propagates_immediately":
        fn, calls = _flaky(99, ValueError("bug, not blip"))
        return _outcome(lambda: r.retry(fn, attempts=5, base_s=0.001, retry_on=(OSError,))), len(calls)
    if name == "should_retry_filter":
        fn, calls = _flaky(99, OSError(418, "teapot"))
        return _outcome(lambda: r.retry(fn, attempts=5, base_s=0.001, should_retry=lambda e: e.args[0] != 418)), \
            len(calls)
    if name == "deadline_bounds_total_time":
        fn, calls = _flaky(99)
        return _outcome(lambda: r.retry(fn, attempts=100, base_s=0.5, multiplier=1.0, jitter=0.0,
                                        deadline_s=1.2)), len(calls)
    if name == "backoff_grows":
        fn, _ = _flaky(99)
        seen = []
        out = _outcome(lambda: r.retry(fn, attempts=4, base_s=0.01, multiplier=2.0, jitter=0.0,
                                       on_retry=lambda n, e, s: seen.append((n, s))))
        return out, seen
    if name == "jittered_backoff":
        fn, _ = _flaky(99)
        return _outcome(lambda: r.retry(fn, attempts=6, base_s=0.1, max_s=0.5, jitter=0.5))
    raise KeyError(name)


RETRY_CASES = ("succeeds_after_transient_failures", "gives_up_after_attempts",
               "non_transient_propagates_immediately", "should_retry_filter", "deadline_bounds_total_time",
               "backoff_grows", "jittered_backoff")


@pytest.mark.parametrize("case", RETRY_CASES)
def test_retry_as_jax(case, monkeypatch):
    outcomes = {}
    for name, (r, _) in MODULES.items():
        clock = FakeClock()
        monkeypatch.setattr(r.time, "monotonic", clock.monotonic)
        monkeypatch.setattr(r.time, "sleep", clock.sleep)
        monkeypatch.setattr(r.random, "random", np.random.default_rng(7).random)
        outcomes[name] = (_retry_case(case, r), clock.sleeps)
        monkeypatch.undo()
    assert outcomes["torch"] == outcomes["jax"]


# -- watchdog and breaker ----------------------------------------------------------
def _watchdog_case(name, r):
    stalls = []
    if name == "detects_stall_once_and_rearms_on_beat":
        wd = r.Watchdog(0.08, on_stall=stalls.append, interval_s=0.02)
        try:
            wd.arm()
            time.sleep(0.3)
            first = len(stalls)
            wd.beat()
            time.sleep(0.3)
            return first, len(stalls), wd.stalls
        finally:
            wd.close()
    if name == "no_stall_while_beating_or_disarmed":
        wd = r.Watchdog(0.1, on_stall=stalls.append, interval_s=0.02)
        try:
            wd.arm()
            for _ in range(10):
                wd.beat()
                time.sleep(0.02)
            wd.disarm()
            time.sleep(0.25)
            return len(stalls)
        finally:
            wd.close()
    if name == "context_manager":
        wd = r.Watchdog(10.0, on_stall=stalls.append, interval_s=0.02)
        try:
            with wd.watching() as w:
                same = w is wd
            time.sleep(0.1)
            return same, len(stalls)
        finally:
            wd.close()
    raise KeyError(name)


@pytest.mark.parametrize("case", ("detects_stall_once_and_rearms_on_beat", "no_stall_while_beating_or_disarmed",
                                  "context_manager"))
def test_watchdog_as_jax(case):
    assert _watchdog_case(case, retry) == _watchdog_case(case, jax_retry)


def _breaker_case(name, r, clock):
    B = r.CircuitBreaker
    if name == "open_half_open_close_cycle":
        b, trail = B(failure_threshold=2, reset_timeout_s=0.1), []
        trail.append((b.state, b.allow()))
        b.record_failure()
        trail.append(b.state)
        b.record_failure()
        trail.append((b.state, b.allow()))
        clock.sleep(0.12)
        trail.append((b.state, b.allow()))
        b.record_success()
        return trail + [b.state, b.failures]
    if name == "half_open_failure_reopens":
        b, trail = B(failure_threshold=1, reset_timeout_s=0.05), []
        b.record_failure()
        trail.append(b.allow())
        clock.sleep(0.06)
        trail.append(b.allow())
        b.record_failure()
        return trail + [b.state, b.opens]
    if name == "snapshot_shape":
        b = B(failure_threshold=3, name="t")
        b.record_failure()
        return b.snapshot()
    raise KeyError(name)


@pytest.mark.parametrize("case", ("open_half_open_close_cycle", "half_open_failure_reopens", "snapshot_shape"))
def test_circuit_breaker_as_jax(case, monkeypatch):
    outcomes = {}
    for name, (r, _) in MODULES.items():
        clock = FakeClock()
        monkeypatch.setattr(r.time, "monotonic", clock.monotonic)
        outcomes[name] = _breaker_case(case, r, clock)
        monkeypatch.undo()
    assert outcomes["torch"] == outcomes["jax"]


# -- the fault plan --------------------------------------------------------------------
def _fires(f, site, n):
    pattern = []
    for _ in range(n):
        try:
            f.fault_point(site)
            pattern.append(0)
        except f.InjectedFault:
            pattern.append(1)
    return pattern


def _fault_case(name, f):
    plan = f.FaultPlan.from_specs
    if name == "empty_plan_compiles_to_none":
        out = f.install_plan(plan([]))
        f.fault_point("env.step")
        return out, f.active_plan(), f.fault_bytes("checkpoint.write_shard", b"abc")
    rejected = {
        "unknown_site_rejected": [{"site": "env.stpe", "kind": "raise", "at": 1}],
        "unknown_kind_rejected": [{"site": "env.step", "kind": "explode", "at": 1}],
        "missing_schedule_rejected": [{"site": "env.step", "kind": "raise"}],
        "unknown_field_rejected": [{"site": "env.step", "kind": "raise", "att": 1}],
        "bad_exception_name_rejected": [{"site": "env.step", "kind": "raise", "at": 1, "exception": "Nope"}],
        "corrupt_at_value_site_rejected": [{"site": "env.step", "kind": "corrupt", "every": 1}],
        "trace_kind_at_host_site_rejected": [{"site": "env.step", "kind": "nonfinite", "at": 1}],
        "host_kind_at_trace_site_rejected": [{"site": "update.grads", "kind": "raise", "at": 1}],
        "probability_rejected_at_trace_site": [{"site": "update.grads", "kind": "nonfinite", "p": 0.5}],
    }
    if name in rejected:
        return _outcome(lambda: plan(rejected[name]))
    if name == "at_fires_exactly_once":
        f.install_plan(plan([{"site": "env.step", "kind": "raise", "at": 3}]))
        return _fires(f, "env.step", 13)
    if name == "every_fires_periodically_with_max_fires":
        f.install_plan(plan([{"site": "env.step", "kind": "raise", "every": 3, "max_fires": 2}]))
        return _fires(f, "env.step", 12)
    if name == "p_schedule_is_seeded_deterministic":
        out = []
        for seed in (7, 7, 8):
            f.install_plan(plan([{"site": "env.step", "kind": "raise", "p": 0.3}], seed=seed))
            out.append(_fires(f, "env.step", 50))
        return out
    if name == "sites_are_independent":
        f.install_plan(plan([{"site": "env.reset", "kind": "raise", "at": 1}]))
        return _fires(f, "env.step", 1), _fires(f, "env.reset", 1)
    if name == "custom_exception_class":
        f.install_plan(plan([{"site": "checkpoint.write_shard", "kind": "raise", "at": 1, "exception": "OSError",
                              "message": "disk on fire"}]))
        return _outcome(lambda: f.fault_point("checkpoint.write_shard"))
    if name == "corrupt_changes_bytes_keeps_length":
        f.install_plan(plan([{"site": "checkpoint.write_shard", "kind": "corrupt", "at": 1}]))
        payload = bytes(range(256)) * 4
        return [f.fault_bytes("checkpoint.write_shard", payload) for _ in range(2)]
    if name == "truncate_halves_payload":
        f.install_plan(plan([{"site": "checkpoint.write_shard", "kind": "truncate", "at": 1}]))
        return f.fault_bytes("checkpoint.write_shard", b"x" * 100)
    if name == "rows_truncate_and_raise":
        f.install_plan(plan([{"site": "replay.spill", "kind": "truncate", "at": 1},
                             {"site": "replay.spill", "kind": "raise", "at": 2}]))
        rows = {"obs": np.arange(12).reshape(4, 3)}
        first = f.fault_rows("replay.spill", rows)["obs"].tolist()
        return first, _outcome(lambda: f.fault_rows("replay.spill", rows))
    if name == "specs_for_does_not_advance_counters":
        p = plan([{"site": "update.grads", "kind": "nonfinite", "at": 1}])
        return len(p.specs_for("update.grads")), p.specs_for("update.grads")[0]._calls, p.specs_for("env.step")
    if name == "targets_prefix":
        p = plan([{"site": "env.step", "kind": "raise", "at": 1}])
        return p.targets("env."), p.targets("serve.")
    raise KeyError(name)


FAULT_CASES = ("empty_plan_compiles_to_none", "unknown_site_rejected", "unknown_kind_rejected",
               "missing_schedule_rejected", "unknown_field_rejected", "bad_exception_name_rejected",
               "corrupt_at_value_site_rejected", "trace_kind_at_host_site_rejected",
               "host_kind_at_trace_site_rejected", "probability_rejected_at_trace_site", "at_fires_exactly_once",
               "every_fires_periodically_with_max_fires", "p_schedule_is_seeded_deterministic",
               "sites_are_independent", "custom_exception_class", "corrupt_changes_bytes_keeps_length",
               "truncate_halves_payload", "rows_truncate_and_raise", "specs_for_does_not_advance_counters",
               "targets_prefix")


@pytest.mark.parametrize("case", FAULT_CASES)
def test_fault_plan_as_jax(case):
    assert _fault_case(case, faults) == _fault_case(case, jax_faults)


def _install_case(name, f, monkeypatch):
    if name == "env_var_roundtrip":
        plan = f.FaultPlan.from_specs([{"site": "serve.http", "kind": "latency", "every": 2, "seconds": 0.01}], seed=5)
        monkeypatch.setenv(f.ENV_VAR, plan.to_json())
        installed = f.install_from_env()
        return installed.sites, installed.seed, plan.to_json()
    if name == "env_var_bare_list":
        monkeypatch.setenv(f.ENV_VAR, json.dumps([{"site": "env.step", "kind": "raise", "at": 1}]))
        return f.install_from_env().sites
    if name == "install_from_config_disabled":
        return f.install_from_config({"fault_injection": {"enabled": False, "plan": [
            {"site": "env.step", "kind": "raise", "at": 1}]}})
    if name == "install_from_config_enabled":
        plan = f.install_from_config({"seed": 3, "fault_injection": {
            "enabled": True, "seed": None, "plan": [{"site": "env.step", "kind": "raise", "at": 1}]}})
        return plan.sites, plan.seed
    if name == "env_var_wins_over_config":
        monkeypatch.setenv(f.ENV_VAR, json.dumps([{"site": "serve.http", "kind": "raise", "at": 1}]))
        return f.install_from_config({"fault_injection": {
            "enabled": True, "plan": [{"site": "env.step", "kind": "raise", "at": 1}]}}).sites
    raise KeyError(name)


@pytest.mark.parametrize("case", ("env_var_roundtrip", "env_var_bare_list", "install_from_config_disabled",
                                  "install_from_config_enabled", "env_var_wins_over_config"))
def test_fault_plan_install_paths_as_jax(case, monkeypatch):
    outcomes = {}
    for name, (_, f) in MODULES.items():
        outcomes[name] = _install_case(case, f, monkeypatch)
        monkeypatch.undo()
        f.clear_plan()
    assert outcomes["torch"] == outcomes["jax"]


@pytest.mark.parametrize("site", sorted(faults.UNPORTED_SITES))
def test_a_plan_at_an_unported_site_is_refused(site, monkeypatch):
    """The site is known to JAX's registry, so the plan validates; the port
    has no module that fires it, so installing it raises, naming the item."""
    kind = "truncate" if site in faults.ROW_SITES else "raise"
    plan = faults.FaultPlan.from_specs([{"site": site, "kind": kind, "at": 1}])
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, queue A item [56]\(b\)"):
        faults.install_plan(plan)
    assert faults.active_plan() is None
    monkeypatch.setenv(faults.ENV_VAR, plan.to_json())
    with pytest.raises(NotImplementedError, match=site):
        faults.install_from_config({})


# -- the checkpoint writer ---------------------------------------------------------------
def test_writer_watchdog_flags_a_wedged_job(tmp_path):
    """``checkpoint.hang_warn_s`` arms the writer's watchdog: a save whose
    commit hangs past it (a planted ``checkpoint.commit`` hang) gives one
    stall (a warning and ``Resilience/watchdog_stalls``) and still commits."""
    from sheeprl_tpu_torch.checkpoint.manager import CheckpointManager
    from sheeprl_tpu_torch.utils.structured import dotdict

    before = RESILIENCE_MONITOR.totals()["stalls"]
    mgr = CheckpointManager(dotdict({"checkpoint": {"async_save": True, "hang_warn_s": 0.05}}), tmp_path)
    _install({"site": "checkpoint.commit", "kind": "hang", "at": 1, "seconds": 0.4})
    with pytest.warns(RuntimeWarning, match="no progress"):
        mgr.save(1, {"w": torch.ones(3)})
        mgr.finalize(5.0)
    assert mgr.latest() is not None
    assert RESILIENCE_MONITOR.totals()["stalls"] == before + 1
    assert RESILIENCE_MONITOR.metrics()["Resilience/watchdog_stalls"] >= 1.0


def test_writer_close_is_bounded_with_a_wedged_job():
    """A job that never returns (dead storage) does not hang teardown:
    ``close(timeout_s=0.5)`` returns within a few seconds and warns that it
    abandons the worker."""
    from sheeprl_tpu_torch.checkpoint.writer import AsyncCheckpointWriter

    release = threading.Event()
    w = AsyncCheckpointWriter(queue_size=1, io_retries=1, hang_warn_s=0)
    w.submit(lambda: release.wait(60.0))
    w.submit(lambda: 0)  # fills the bounded queue behind the stuck job
    t0 = time.monotonic()
    with pytest.warns(RuntimeWarning, match="abandoning the daemon thread"):
        w.close(timeout_s=0.5)
    assert time.monotonic() - t0 < 5.0
    release.set()


@pytest.mark.parametrize("case", ("transient_io_error_retried_not_parked", "exhausted_retries_park_and_reraise",
                                  "non_io_error_not_retried"))
def test_hardened_writer_as_jax(case):
    from sheeprl_tpu.checkpoint.writer import AsyncCheckpointWriter as JaxWriter
    from sheeprl_tpu_torch.checkpoint.writer import AsyncCheckpointWriter

    def drive(cls):
        w = cls(queue_size=2, io_retries=2 if case == "exhausted_retries_park_and_reraise" else 3,
                io_retry_base_s=0.001)
        job, calls = _flaky({"transient_io_error_retried_not_parked": 2}.get(case, 99),
                            ValueError("bug") if case == "non_io_error_not_retried" else OSError("x"),
                            value=7)  # a save job returns the bytes it wrote
        w.submit(job)
        out = _outcome(lambda: w.flush(10.0))
        w.close(5.0)
        return out, len(calls)

    assert drive(AsyncCheckpointWriter) == drive(JaxWriter)


# -- every fault site of the port ------------------------------------------------------
def _install(*specs):
    faults.install_plan(faults.FaultPlan.from_specs(list(specs)))


def _injected(site):
    return RESILIENCE_MONITOR.totals()["injected_by_site"].get(site, 0)


def test_env_sites_fire_inside_restart_on_exception():
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.envs.wrappers import FaultInjectionEnv
    from sheeprl_tpu_torch.utils.env import make_env

    base = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "fabric.accelerator=cpu"]
    _install({"site": "env.step", "kind": "raise", "at": 2}, {"site": "env.reset", "kind": "raise", "at": 1})
    env = make_env(compose(base), 0)()
    assert isinstance(env, FaultInjectionEnv)
    with pytest.raises(faults.InjectedFault):
        env.reset()
    env.step(env.action_space.sample())
    with pytest.raises(faults.InjectedFault):
        env.step(env.action_space.sample())
    _install({"site": "env.step", "kind": "raise", "at": 1})
    env = make_env(compose([*base, "env.restart_on_exception=True"]), 0)()
    restarts = RESILIENCE_MONITOR.totals()["env_restarts"]
    *_, info = env.step(env.action_space.sample())
    assert info["restart_on_exception"] and RESILIENCE_MONITOR.totals()["env_restarts"] == restarts + 1
    faults.clear_plan()
    assert not isinstance(make_env(compose(base), 0)(), FaultInjectionEnv)


def test_checkpoint_sites_fire(tmp_path):
    from sheeprl_tpu_torch.checkpoint.protocol import (
        is_committed,
        latest_checkpoint,
        verify_checkpoint,
        verify_or_quarantine,
        write_snapshot,
    )

    state = {"w": torch.arange(64.0)}
    _install({"site": "checkpoint.commit", "kind": "raise", "at": 1})
    with pytest.raises(faults.InjectedFault):
        write_snapshot(tmp_path, 1, state)
    assert not is_committed(tmp_path / "step_000000000001") and latest_checkpoint(tmp_path) is None
    before = RESILIENCE_MONITOR.totals()["quarantined"]
    _install({"site": "checkpoint.write_shard", "kind": "corrupt", "at": 1})
    step = write_snapshot(tmp_path, 2, state)
    assert is_committed(step) and any("CRC" in p for p in verify_checkpoint(step))
    assert verify_or_quarantine(step) and latest_checkpoint(tmp_path) is None
    assert RESILIENCE_MONITOR.totals()["quarantined"] == before + 1
    assert _injected("checkpoint.write_shard") >= 1 and _injected("checkpoint.commit") >= 1


def test_serve_http_site_fires_and_the_client_retries():
    from sheeprl_tpu_torch.serve.client import PolicyClient
    from sheeprl_tpu_torch.serve.server import PolicyServer

    class Service:
        def start(self):
            pass

        def stop(self):
            pass

        def stats(self):
            return {"served": 7}

    before = _injected("serve.http")
    _install({"site": "serve.http", "kind": "raise", "at": 1})
    with PolicyServer(Service(), port=0) as server:
        assert PolicyClient(server.url, retry_base_s=0.01).stats() == {"served": 7}
    assert _injected("serve.http") == before + 1


def test_fabric_copy_to_site_fires_in_the_player_weight_copy():
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import PlayerSync

    module = torch.nn.Linear(2, 2)
    psync = PlayerSync(compose(["exp=sac", "env=dummy"]), torch.device("cpu"), lambda: {"actor": module})
    _install({"site": "fabric.copy_to", "kind": "raise", "at": 2})
    psync.init()
    with pytest.raises(faults.InjectedFault):
        psync.init()


def test_replay_spill_site_fires_in_the_spill_worker():
    from sheeprl_tpu_torch.data.device_replay import HostSpill

    _install({"site": "replay.spill", "kind": "raise", "at": 2})
    spill = HostSpill(8, 2)
    row = {"obs": np.zeros((1, 2, 3), np.float32)}
    with pytest.warns(RuntimeWarning, match="spill tier degraded"):
        for _ in range(3):
            spill.submit(row)
        spill.flush(5.0)
    assert spill.degraded and len(spill.buffer) == 2  # the failed write alone is lost
    spill.close()
