"""The port's telemetry subsystem against the JAX package's, on the CPU.

The hub, the span tracker, the trace scheduler, the flight recorder and the
introspection endpoint of ``sheeprl_tpu_torch/telemetry/`` are held to
``sheeprl_tpu/telemetry/``'s: the same span sequence under one patched clock
gives the same breakdown and ``Phase/*``; one metric dict renders to the same
Prometheus text byte for byte; the endpoints answer with the same keys and
the same stall rule; ``postmortem.json`` has the same schema and keys; the
scheduler makes the same start/stop calls for the same triggers; the hub
has the same sources after import; a tiny DreamerV3 run through each
package's ``cli.run`` logs the same set of metric names.  Then the port
alone: a crashing run dumps its postmortem and lands the final flush, and
the span fence lets a CUDA error through and skips a capture.
"""

import csv
import glob
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from sheeprl_tpu.telemetry import introspect as jax_introspect
from sheeprl_tpu.telemetry import recorder as jax_recorder
from sheeprl_tpu.telemetry import spans as jax_spans
from sheeprl_tpu.telemetry import tracer as jax_tracer
from sheeprl_tpu_torch.telemetry import introspect, recorder, spans, tracer

from tests.test_torch_train_cli import TINY


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _span_run(module, monkeypatch, clock):
    monkeypatch.setattr(module, "_now", clock)
    clock.t = 0.0
    tracker = module.SpanTracker()
    a = tracker.push("rollout")
    clock.t = 2.0
    tracker.pop(a)
    b = tracker.push("update.dispatch")
    clock.t = 3.0
    c = tracker.push("replay.write")
    clock.t = 4.5
    tracker.pop(c)
    d = tracker.push("ckpt.snapshot")  # leaked: unwound with its parent
    clock.t = 7.0
    tracker.pop(b)
    del d
    clock.t = 10.0
    return tracker.breakdown(), tracker.metrics(), tracker.updates_done


def test_span_breakdown_and_phase_metrics_match_jax(monkeypatch):
    clock = Clock()
    assert _span_run(spans, monkeypatch, clock) == _span_run(jax_spans, monkeypatch, clock)
    assert spans.TIMER_PHASES == jax_spans.TIMER_PHASES


METRICS = {"Compile/executables": 3.0, "Phase/update.dispatch": 0.25, "Phase/other": 0.75, "Serve/p99_ms": 12.5,
           "Health/diverged": 0, "odd name-with spaces": 1, "odd_name_with_spaces": 2, "not a number": "x",
           "Checkpoint/total_bytes": 1.5e9}


def test_prometheus_text_matches_jax_byte_for_byte():
    text = introspect.prometheus_text(METRICS)
    assert text == jax_introspect.prometheus_text(METRICS)
    assert introspect.prometheus_text({}) == jax_introspect.prometheus_text({}) == ""
    assert introspect.PROMETHEUS_CONTENT_TYPE == jax_introspect.PROMETHEUS_CONTENT_TYPE
    assert "sheeprl_compile_executables 3.0\n" in text


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_introspection_endpoints_match_jax(monkeypatch):
    answers = {}
    for name, mod, span_mod in (("port", introspect, spans), ("jax", jax_introspect, jax_spans)):
        # one completed update 100 s ago: past a 10 s stall threshold
        monkeypatch.setattr(span_mod.SPANS, "_last_update_done", time.time() - 100.0)
        with mod.IntrospectionServer(port=0, stall_after_s=10.0) as server:
            health = _get(f"{server.url}/healthz")
            rec = _get(f"{server.url}/v1/recorder?n=3")
            metrics = _get(f"{server.url}/metrics")
            phase = _get(f"{server.url}/v1/phase")
            missing = _get(f"{server.url}/nope")
        with mod.IntrospectionServer(port=0, stall_after_s=0.0) as server:
            healthy = _get(f"{server.url}/healthz")
        answers[name] = (health, rec, metrics, phase, missing, healthy)
    for (h, r, m, p, x, ok), (jh, jr, jm, jp, jx, jok) in [(answers["port"], answers["jax"])]:
        assert h[0] == jh[0] == 503 and ok[0] == jok[0] == 200 and x[0] == jx[0] == 404
        assert json.loads(h[2]).keys() == json.loads(jh[2]).keys()
        assert json.loads(h[2])["stalled"] and json.loads(jh[2])["stalled"]
        assert json.loads(r[2]).keys() == json.loads(jr[2]).keys() and len(json.loads(r[2])["events"]) <= 3
        assert m[1] == jm[1] == jax_introspect.PROMETHEUS_CONTENT_TYPE
        assert b"sheeprl_telemetry_uptime_s" in m[2] and b"sheeprl_telemetry_uptime_s" in jm[2]
        assert json.loads(p[2]).keys() == json.loads(jp[2]).keys()


def test_postmortem_schema_and_keys_match_jax(tmp_path):
    assert recorder.SCHEMA == jax_recorder.SCHEMA
    docs = []
    for name, mod in (("port", recorder), ("jax", jax_recorder)):
        rec = mod.FlightRecorder(capacity=4)
        for i in range(6):
            rec.record("span", name="rollout", seconds=float(i))
        path = rec.dump("exception", path=str(tmp_path / name / "postmortem.json"))
        assert path is not None and len(rec) == 4
        with open(path) as f:
            docs.append(json.load(f))
    port, ref = docs
    assert port.keys() == ref.keys() and port["schema"] == ref["schema"] and port["reason"] == ref["reason"]
    assert port["monitors"].keys() == ref["monitors"].keys()
    for group in ref["monitors"]:
        assert port["monitors"][group].keys() == ref["monitors"][group].keys(), group
    assert port["phase_breakdown"].keys() == ref["phase_breakdown"].keys()
    assert [e["seconds"] for e in port["events"]] == [e["seconds"] for e in ref["events"]] == [2.0, 3.0, 4.0, 5.0]
    assert recorder.FlightRecorder().dump("exception") is None  # no run dir, no path: nothing written


def _schedule(module, monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv(module.ENV_VAR, "9, 10")
    sched = module.TraceScheduler(start_fn=lambda p: calls.append(("start", p[len(str(tmp_path)):])),
                                  stop_fn=lambda: calls.append(("stop",)))
    sched.configure({"trace_at": [2, 5, 6], "trace_updates": 2}, str(tmp_path))
    for n in range(1, 16):
        if n == 12:
            sched.request()
        sched.tick()
        calls.append(("active", n, sched.active))
    sched.close()
    return calls, sched.windows_captured, sched.update_count


def test_trace_scheduler_matches_jax(monkeypatch, tmp_path):
    port = _schedule(tracer, monkeypatch, tmp_path)
    assert port == _schedule(jax_tracer, monkeypatch, tmp_path)
    starts = [c[1] for c in port[0] if c[0] == "start"]
    assert starts == ["/trace/update_000002", "/trace/update_000005", "/trace/update_000009",
                      "/trace/update_000012"]


def test_default_trace_window_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "update_000001")
    tracer._default_start(path)
    (torch.ones(8) * 2).sum()
    tracer._default_stop()
    with open(f"{path}/{tracer.TRACE_FILE}") as f:
        assert "traceEvents" in json.load(f)


def test_hub_sources_after_import_match_jax():
    code = ("import sheeprl_tpu.telemetry as j, sheeprl_tpu_torch.telemetry as p; "
            "print(j.HUB.source_names()); print(p.HUB.source_names())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    jax_names, port_names = out.stdout.strip().splitlines()[-2:]
    assert jax_names == port_names == "['checkpoint', 'compile', 'resilience', 'spans']"


def test_span_fence_raises_cuda_errors_and_skips_captures(monkeypatch):
    """A synchronise that raises (an asynchronous kernel fault surfacing)
    propagates out of the span edge; inside a capture the edge does not
    synchronise at all."""
    syncs = []

    def synchronize():
        syncs.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    tracker = spans.SpanTracker()
    tracker.configure({"enabled": True, "sync": True})
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tracker.push("replay.write")
    capturing[0] = True
    tracker.pop(tracker.push("replay.write"))
    assert len(syncs) == 1


def _metric_names(log_dir):
    (path,) = glob.glob(f"{log_dir}/**/metrics.csv", recursive=True)
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    return {name for _, name, _ in rows}, rows


# the tiny recipe of test_torch_train_cli, one update (the JAX package has no fused kernel flag on the CPU
# path other than its interpret mode, so both run the plain RSSM)
CLI = [*(o for o in TINY if "fused_pallas" not in o), "dry_run=True", "algo.run_test=False",
       "telemetry.introspect.port=0"]


def _fresh_monitors():
    """The checkpoint and resilience monitors of both packages emptied: they
    are process-global, and an earlier test in this process may have counted
    into them."""
    from sheeprl_tpu.telemetry import monitors as jax_monitors
    from sheeprl_tpu_torch.telemetry import monitors

    for mod in (monitors, jax_monitors):
        mod.CHECKPOINT_MONITOR.reset()
        mod.RESILIENCE_MONITOR.reset()


def test_cli_run_logs_the_metric_names_jax_logs(tmp_path):
    from sheeprl_tpu.cli import run as jax_run
    from sheeprl_tpu_torch.cli import run

    _fresh_monitors()
    run([*CLI, f"log_dir={tmp_path / 'port'}"])
    jax_run([*CLI, f"log_dir={tmp_path / 'jax'}"])
    port, _ = _metric_names(tmp_path / "port")
    ref, _ = _metric_names(tmp_path / "jax")
    assert port == ref, (sorted(port - ref), sorted(ref - port))
    assert {"Phase/rollout", "Phase/update.dispatch", "Phase/other", "Compile/executables"} <= port


def test_crashing_run_dumps_postmortem_and_lands_the_final_flush(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.resilience import faults

    monkeypatch.setenv(faults.ENV_VAR, json.dumps({"plan": [{"site": "checkpoint.write_shard", "kind": "raise",
                                                             "at": 1}]}))
    _fresh_monitors()
    with pytest.raises(Exception):
        run([*CLI, "checkpoint.io_retries=1", f"log_dir={tmp_path}"])
    (path,) = glob.glob(f"{tmp_path}/**/postmortem.json", recursive=True)
    with open(path) as f:
        doc = json.load(f)
    assert doc["reason"] == "exception" and doc["schema"] == recorder.SCHEMA
    kinds = [e["kind"] for e in doc["events"]]
    assert "crash" in kinds and "fault.injected" in kinds and "span" in kinds
    assert doc["monitors"]["resilience"]["injected"] == 1
    # the injected fault was counted after the last metric interval: only the
    # final flush can have logged it, at the last step
    names, rows = _metric_names(tmp_path)
    assert "Resilience/faults_injected" in names
    last_step = max(int(s) for s, _, _ in rows)
    assert any(n == "Resilience/faults_injected" and int(s) == last_step for s, n, _ in rows)
