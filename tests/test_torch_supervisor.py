"""The port's run supervisor against the JAX package's, on the CPU.

``classify`` and the postmortem parsing are held to JAX's functions on the
same documents; the supervision loop runs JAX's scripted-children cases
(``tests/test_supervisor/test_supervise.py``) with the port's
:class:`Supervisor`, plus a child whose ``/healthz`` answers 503
``stalled`` until the stall rule kills it.  The port's own
``postmortem.json`` of an env that crashed past its restart budget (the
port dumps it where ``RestartOnException`` gives up) is classified as JAX
classifies it, and a pod-shaped invocation raises."""

import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

from sheeprl_tpu_torch.config.compose import ConfigError
from sheeprl_tpu_torch.supervisor import (
    DETERMINISTIC,
    DIVERGED,
    EXIT_BREAKER,
    EXIT_BUDGET,
    EXIT_OK,
    PREEMPTED,
    SUCCESS,
    TRANSIENT,
    Supervisor,
    classify,
    crash_error,
    load_postmortem,
    resolve_supervisor,
)
from sheeprl_tpu_torch.utils.structured import dotdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX module (its package's ``classify`` attribute is the function)
jax_classify = importlib.import_module("sheeprl_tpu.supervisor.classify")


def _pm(reason="exception", error="InjectedFault: boom", last_step=37, **extra):
    doc = {"schema": "sheeprl.postmortem/1", "reason": reason, "last_step": last_step,
           "events": [{"kind": "span"}, {"kind": "crash", "error": error}]}
    doc.update(extra)
    return doc


def _same_verdict(returncode, postmortem, **kw):
    """The port's verdict, asserted equal to JAX's on the same evidence."""
    got, want = classify(returncode, postmortem, **kw), jax_classify.classify(returncode, postmortem, **kw)
    assert (got.kind, got.reason, got.signature, got.detail, got.restartable) == \
        (want.kind, want.reason, want.signature, want.detail, want.restartable)
    return got


# -- classify -----------------------------------------------------------------------
@pytest.mark.parametrize("returncode, postmortem, hung, kind, signature", [
    (0, None, False, SUCCESS, None),
    (-9, None, False, TRANSIENT, None),
    (0, _pm(), True, TRANSIENT, ("hang", 37)),
    (1, _pm(), False, TRANSIENT, ("InjectedFault: boom", 37)),
    (1, _pm(reason="preemption"), False, PREEMPTED, None),
    (0, _pm(reason="preemption"), False, PREEMPTED, None),
    (1, _pm(error="DivergenceError: diverged at step 99", last_step=99), False, DIVERGED,
     ("DivergenceError: diverged at step 99", 99)),
    (1, None, False, TRANSIENT, None),
    (1, {"schema": "sheeprl.postmortem/1", "reason": "watchdog", "last_step": 5, "events": []}, False, TRANSIENT,
     ("rc=1, reason=watchdog", 5)),
], ids=["clean", "kill-9", "hang", "exception", "preempted", "preempted-rc0", "diverged", "no-postmortem",
        "no-crash-event"])
def test_classify_matches_jax(returncode, postmortem, hung, kind, signature):
    v = _same_verdict(returncode, postmortem, hung=hung)
    assert v.kind == kind and v.signature == signature
    assert v.kind != DETERMINISTIC  # the breaker's verdict, never one episode's
    assert v.restartable == (kind != SUCCESS)


@pytest.mark.parametrize("content", [None, "missing", "{ not json", json.dumps({"schema": "other/1"}),
                                     json.dumps(_pm())], ids=["none", "missing", "malformed", "schema", "ours"])
def test_load_postmortem_matches_jax(content, tmp_path):
    path = None if content is None else str(tmp_path / "postmortem.json")
    if content not in (None, "missing"):
        (tmp_path / "postmortem.json").write_text(content)
    assert load_postmortem(path) == jax_classify.load_postmortem(path)


@pytest.mark.parametrize("doc", [_pm(), {**_pm(), "events": [*_pm()["events"], {"kind": "crash", "error": "second"}]},
                                 {"events": [{"kind": "span"}]}, {}, {"events": "x"}],
                         ids=["one", "newest", "none", "empty", "malformed"])
def test_crash_error_matches_jax(doc):
    assert crash_error(doc) == jax_classify.crash_error(doc)


def test_an_env_crashed_past_its_budget_is_classified_as_jax_does(tmp_path, monkeypatch):
    """A tiny SAC run whose every ``env.step`` raises under
    ``env.restart_on_exception``: ``RestartOnException`` gives up (the
    recorder's ``watchdog.giveup``, reason ``env crashed``), ``cli.run``
    records the crash, and the postmortem it leaves is a transient crash
    with a signature, the same verdict as JAX's."""
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv("SHEEPRL_FAULT_PLAN", json.dumps({"plan": [{"site": "env.step", "kind": "raise",
                                                                    "every": 1}]}))
    with pytest.raises(RuntimeError, match="Environment crashed"):
        run(["exp=sac", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "env.num_envs=1", "env.restart_on_exception=True",
             "fabric.accelerator=cpu", "algo.mlp_keys.encoder=[state]", "algo.actor.hidden_size=8",
             "algo.critic.hidden_size=8", "algo.total_steps=64", "buffer.size=64", "buffer.memmap=False",
             "metric.log_level=0", f"log_dir={tmp_path}"])
    monkeypatch.delenv("SHEEPRL_FAULT_PLAN")
    from sheeprl_tpu_torch.resilience.faults import install_from_env

    install_from_env()
    paths = list(tmp_path.glob("**/postmortem.json"))
    assert len(paths) == 1
    doc = load_postmortem(str(paths[0]))
    assert any(e.get("kind") == "watchdog.giveup" and e.get("reason") == "env crashed" for e in doc["events"])
    v = _same_verdict(1, doc)
    assert v.kind == TRANSIENT and v.signature[0].startswith("RuntimeError: Environment crashed")


# -- the supervision loop over scripted children ----------------------------------------
def make_supervisor(tmp_path, child_script, scfg=None, argv=None):
    cfg = dotdict({"supervisor": {"max_restarts": 3, "backoff_base_s": 0.01, "poll_interval_s": 0.1,
                                  "kill_grace_s": 5.0, "introspect": False, **(scfg or {})},
                   "log_dir": str(tmp_path), "root_dir": "exp"})
    return Supervisor(cfg, list(argv or ["exp=fake"]),
                      child_cmd=lambda child_argv: [sys.executable, "-c", child_script, *child_argv],
                      handle_signals=False)


def episodes_of(sup):
    with open(sup.audit_path) as f:
        return [json.loads(line) for line in f]


def child_source(tmp_path, body):
    """A child script with a launch counter and a postmortem writer in scope."""
    return textwrap.dedent(
        f"""
        import json, os, sys, time
        ROOT = {str(tmp_path)!r}
        MARKER = os.path.join(ROOT, "launches")
        launches = int(open(MARKER).read()) if os.path.exists(MARKER) else 0
        open(MARKER, "w").write(str(launches + 1))

        def write_postmortem(doc, run="run_a"):
            run_dir = os.path.join(ROOT, "exp", run, "version_0")
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "postmortem.json"), "w") as f:
                f.write(doc if isinstance(doc, str) else json.dumps(doc))
        """
    ) + textwrap.dedent(body)


PM_CRASH = json.dumps(_pm(reason="exception", events=[{"kind": "crash", "error": "InjectedFault: boom"}]))
PM_PREEMPT = json.dumps({"schema": "sheeprl.postmortem/1", "reason": "preemption", "last_step": 20, "events": []})
SCRIPTED = {
    # id: (child body, supervisor overrides, exit code, classifications, actions)
    "crash-once": (f"""
        if launches == 0:
            write_postmortem({PM_CRASH!r})
            sys.exit(1)
        sys.exit(0)
        """, {}, EXIT_OK, ["transient", "success"], ["restart", "done"]),
    "preempted-rc0": (f"""
        if launches == 0:
            write_postmortem({PM_PREEMPT!r})
        sys.exit(0)
        """, {}, EXIT_OK, ["preempted", "success"], ["restart", "done"]),
    "kill-9": ("""
        if launches == 0:
            os.kill(os.getpid(), 9)
        sys.exit(0)
        """, {}, EXIT_OK, ["transient", "success"], ["restart", "done"]),
    "breaker": (f"""
        write_postmortem({PM_CRASH!r}, run="run_%d" % launches)
        sys.exit(1)
        """, {}, EXIT_BREAKER, ["transient", "deterministic"], ["restart", "stop"]),
    "advancing-steps": ("""
        doc = {"schema": "sheeprl.postmortem/1", "reason": "exception", "last_step": 10 * (launches + 1),
               "events": [{"kind": "crash", "error": "InjectedFault: boom"}]}
        write_postmortem(doc, run="run_%d" % launches)
        sys.exit(1)
        """, {"max_restarts": 2}, EXIT_BUDGET, ["transient"] * 3, ["restart", "restart", "budget-exhausted"]),
    "malformed": ("""
        write_postmortem("{ not json", run="run_%d" % launches)
        sys.exit(1)
        """, {"max_restarts": 2}, EXIT_BUDGET, ["transient"] * 3, ["restart", "restart", "budget-exhausted"]),
}


@pytest.mark.parametrize("case", list(SCRIPTED))
def test_scripted_children(case, tmp_path):
    body, scfg, code, kinds, actions = SCRIPTED[case]
    sup = make_supervisor(tmp_path, child_source(tmp_path, body), scfg)
    assert sup.run() == code
    eps = episodes_of(sup)
    assert [e["classification"] for e in eps] == kinds
    assert [e["action"] for e in eps] == actions
    if case == "kill-9":
        assert eps[0]["returncode"] == -9 and eps[0]["signature"] is None
    if case == "breaker":
        assert "circuit breaker open" in eps[1]["reason"]
        assert eps[1]["signature"] == ["InjectedFault: boom", 37]
    if case == "malformed":
        assert all(e["signature"] is None for e in eps)


def test_restart_forces_auto_resume(tmp_path):
    out = tmp_path / "argv.json"
    sup = make_supervisor(tmp_path, child_source(tmp_path, f"""
        if launches == 0:
            sys.exit(1)
        json.dump(sys.argv[1:], open({str(out)!r}, "w"))
        sys.exit(0)
        """), argv=["exp=fake", "algo.total_steps=64"])
    assert sup.run() == EXIT_OK
    relaunch = json.load(open(out))
    assert relaunch[0] == "exp=fake" and relaunch[-1] == "checkpoint.resume_from=auto"


def test_silent_child_without_a_heartbeat_is_killed_and_restarted(tmp_path):
    sup = make_supervisor(tmp_path, child_source(tmp_path, """
        if launches == 0:
            time.sleep(300)
        sys.exit(0)
        """), {"introspect": True, "first_heartbeat_timeout_s": 1.0, "poll_interval_s": 0.2})
    assert sup.run() == EXIT_OK
    eps = episodes_of(sup)
    assert eps[0]["hung"] is True and eps[0]["classification"] == "transient"
    assert eps[1]["classification"] == "success"


STALLED_CHILD = """
    import http.server, threading

    class Stalled(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"ok": False, "stalled": True, "last_update_age_s": 99.0}).encode()
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    if launches == 0:
        server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Stalled)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        print(f"telemetry introspection on http://127.0.0.1:{server.server_address[1]}", flush=True)
        time.sleep(300)
    assert sys.argv[-2:] == ["telemetry.introspect.port=0", "checkpoint.resume_from=auto"], sys.argv
    sys.exit(0)
    """


def test_stalled_child_is_killed_by_the_stall_rule(tmp_path):
    """The child answers ``/healthz`` 503 ``stalled`` past
    ``stall_grace_s``: SIGTERM, classified a hang, restarted with the
    endpoint forced on and ``resume_from=auto``."""
    sup = make_supervisor(tmp_path, child_source(tmp_path, STALLED_CHILD),
                          {"introspect": True, "stall_grace_s": 0.5, "poll_interval_s": 0.1})
    assert sup.run() == EXIT_OK
    eps = episodes_of(sup)
    assert eps[0]["hung"] is True and eps[0]["returncode"] == -15
    assert eps[0]["classification"] == "transient" and eps[0]["signature"] == ["hang", None]
    assert eps[1]["classification"] == "success"


def test_the_child_is_the_port():
    sup = Supervisor(dotdict({"supervisor": {}}), ["exp=ppo"], handle_signals=False)
    assert sup._child_cmd(sup._episode_argv(1)) == [sys.executable, "-m", "sheeprl_tpu_torch", "exp=ppo",
                                                    "telemetry.introspect.port=0", "checkpoint.resume_from=auto"]


# -- pod-shaped invocations -------------------------------------------------------------
def test_a_pod_shaped_invocation_raises(monkeypatch):
    cfg = dotdict({"supervisor": {}, "fabric": {"distributed": {"num_processes": 2}}})
    with pytest.raises(ConfigError, match=r"queue A item 5\(b\)"):
        resolve_supervisor(cfg, ["exp=ppo"])
    monkeypatch.setenv("SHEEPRL_FAKE_DCN", "4")
    with pytest.raises(ConfigError, match=r"queue A item 5\(b\)"):
        resolve_supervisor(dotdict({"supervisor": {}}), ["exp=ppo"])
    monkeypatch.delenv("SHEEPRL_FAKE_DCN")
    assert isinstance(resolve_supervisor(dotdict({"supervisor": {}}), ["exp=ppo"]), Supervisor)


def test_main_dispatches_supervise():
    """``python -m sheeprl_tpu_torch supervise`` reaches the supervisor's
    ``main`` (which refuses a pod-shaped run before launching anything)."""
    proc = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch", "supervise", "exp=ppo",
                           "fabric.distributed.num_processes=2"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode != 0
    assert "ConfigError" in proc.stderr and "queue A item 5(b)" in proc.stderr
