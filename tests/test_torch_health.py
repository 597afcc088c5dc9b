"""The health guard inside the train window (``sheeprl_tpu_torch/resilience/health.py``)
against the JAX package's (``sheeprl_tpu/resilience/health.py``), on the CPU.

A scripted loss stream (finite, NaN, spikes, patience, planted faults) gives
the same ``HealthState``, the same parameters and the same polled
``Health/*`` metrics through JAX's ``wrap`` and the port's.  A tiny guarded
DreamerV3 window equals the unguarded one bit for bit with ``fused_pallas``,
``use_pallas`` and neither (on the CPU the kernels' plain versions run), and
a planted ``nonfinite`` window leaves every trained tensor bit for bit as it
was.  In the loops: the state is read only every ``health.poll_every_updates``
iterations, SAC rolls back in the loop within its budget, and the Dreamer
family raises ``DivergenceError``.
"""

import csv
import glob
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.parallel.compile import compile_once
from sheeprl_tpu.resilience import faults as jax_faults
from sheeprl_tpu.resilience.health import HealthSentinel as JaxSentinel
from sheeprl_tpu_torch.resilience import faults
from sheeprl_tpu_torch.resilience.health import DivergenceError, HealthSentinel, HealthState


@pytest.fixture(autouse=True)
def _clean_plans():
    jax_faults.clear_plan()
    faults.clear_plan()
    yield
    jax_faults.clear_plan()
    faults.clear_plan()


DETECTOR = {"min_windows": 2, "patience": 2, "spike_factor": 2.0, "spike_min": 0.1, "ema_decay": 0.5,
            "poll_every_updates": 1, "divergence": {"action": "rollback"}}
# name: (sentinel config, batch values, phase kind, planted update.grads specs)
STREAMS = {
    "finite": ({}, [1, 2, 3, 4, 5, 6], "toy", []),
    "nonfinite_loss": ({}, [1, -1, 1], "nan_on_neg", []),
    "nan_params": ({}, [1], "nan_params", []),
    "nan_params_unchecked": ({"check_params": False}, [1], "nan_params", []),
    "single_spike": (DETECTOR, [1, 1, 1, 100, 1, 1], "toy", []),
    "patience": (DETECTOR, [1, 1, 1, 100, 100, 100], "toy", []),
    "action_none": ({**DETECTOR, "divergence": {"action": "none"}}, [1, 1, 1, 100, 100, 100], "toy", []),
    "planted_nonfinite": ({}, [1, 1, 1], "toy", [{"site": "update.grads", "kind": "nonfinite", "at": 2}]),
    "planted_divergence": ({"min_windows": 4, "patience": 1, "spike_factor": 2.0, "spike_min": 0.1,
                            "divergence": {"action": "rollback", "fault_scale": 1e6}}, [1] * 6, "toy",
                           [{"site": "update.grads", "kind": "divergence", "at": 5}]),
    "planted_every": ({}, [1] * 7, "toy", [{"site": "update.grads", "kind": "nonfinite", "every": 3,
                                            "max_fires": 1}]),
}


def _jax_run(hcfg, batches, kind, specs):
    jax_faults.install_plan(jax_faults.FaultPlan.from_specs(specs))
    s = JaxSentinel(hcfg)

    def phase(p, o, batch, k, c):
        g = jnp.mean(batch)
        if kind == "nan_on_neg":
            g = jnp.where(g < 0, jnp.float32(jnp.nan), g)
        if kind == "nan_params":
            return {"w": p["w"] + jnp.float32(jnp.nan)}, o, (jnp.float32(1.0),)
        return {"w": p["w"] - 0.1 * g * jnp.ones_like(p["w"])}, o + 1, (g,)

    guarded = compile_once(s.wrap(phase), name="health_parity")
    h, p, o, k = s.init_state(), {"w": jnp.ones((4,))}, jnp.int32(0), jax.random.PRNGKey(0)
    history = []
    for i, b in enumerate(batches):
        h, p, o, _ = guarded(h, p, o, jnp.full((8,), float(b)), k, jnp.int32(i))
        history.append(np.asarray(p["w"]).copy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        action = s.poll(h, 7)
    vals = jax.device_get(h)
    return {f: np.asarray(getattr(vals, f)).item() for f in HealthState._fields}, history, action, s.metrics()


def _torch_run(hcfg, batches, kind, specs):
    faults.install_plan(faults.FaultPlan.from_specs(specs))
    s = HealthSentinel(hcfg)
    w, o = torch.ones(4), torch.zeros((), dtype=torch.int32)

    def window(batch):
        g = batch.mean()
        if kind == "nan_on_neg":
            g = torch.where(g < 0, torch.tensor(float("nan")), g)
        if kind == "nan_params":
            w.copy_(w + float("nan"))
            return None, (torch.tensor(1.0),)
        w.copy_(w - 0.1 * g * torch.ones_like(w))
        o.add_(1)
        return None, (g,)

    guarded = s.wrap(window, lambda: ([w], [o]), "cpu")
    history = []
    for b in batches:
        guarded(torch.full((8,), float(b)))
        history.append(w.numpy().copy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        action = s.poll(7)
    return {f: getattr(s.state, f).item() for f in HealthState._fields}, history, action, s.metrics()


@pytest.mark.parametrize("stream", list(STREAMS))
def test_health_state_as_jax(stream):
    j_state, j_hist, j_action, j_metrics = _jax_run(*STREAMS[stream])
    t_state, t_hist, t_action, t_metrics = _torch_run(*STREAMS[stream])
    for f in HealthState._fields:
        np.testing.assert_allclose(t_state[f], j_state[f], rtol=1e-6, err_msg=f)
    for t, j in zip(t_hist, j_hist):
        np.testing.assert_allclose(t, j, rtol=1e-6)
    assert t_action == j_action
    assert t_metrics.keys() == j_metrics.keys()
    for k, v in j_metrics.items():
        np.testing.assert_allclose(t_metrics[k], v, rtol=1e-6, err_msg=k)


def test_divergence_reporting_rollback_budget_and_reseed():
    s = HealthSentinel({**DETECTOR, "divergence": {"action": "none"}})
    window = s.wrap(lambda loss: (None, [torch.tensor(loss)]), lambda: ([], []), "cpu")
    for loss in (1.0, 1.0, 1.0, 100.0, 100.0):
        window(loss)
    with pytest.warns(RuntimeWarning, match="diverged"):
        assert s.poll(1) == "none"
    assert s.metrics()["Health/diverged"] == 1.0
    s.reseed_state()
    assert s.state.dispatches.item() == 5 and s.state.diverged.item() == 0 and s.state.ema.item() == 0.0
    budget = HealthSentinel({"divergence": {"action": "rollback", "max_rollbacks": 1}})
    budget.begin_rollback(1)
    with pytest.raises(DivergenceError, match="exhausted"):
        budget.begin_rollback(2)


# -- a tiny DreamerV3 window, guarded and not -----------------------------------------------
KERNEL_FLAGS = {"fused_pallas": "algo.world_model.recurrent_model.fused_pallas=True",
                "use_pallas": "algo.world_model.recurrent_model.use_pallas=True", "plain": None}


def _tiny_dv3(flag):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, build_dv3_optimizers
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.config.compose import compose
    from sheeprl_tpu_torch.fabric import build_fabric
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from tests.test_torch_train_cli import TINY

    overrides = [o for o in TINY if "pallas" not in o] + ["algo.horizon=2", "seed=4"]
    cfg = compose(overrides + ([KERNEL_FLAGS[flag]] if KERNEL_FLAGS[flag] else []))
    torch.manual_seed(4)
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    modules = build_agent(fabric, dims, cont, cfg, obs_space)
    return cfg, DV3Trainer(cfg, modules, build_dv3_optimizers(cfg, modules), ("rgb",), ("state",), cont), dims


def _state(trainer):
    params, opt = trainer.guarded_state()
    return [t.clone() for t in (*params, *opt)]


@pytest.mark.parametrize("flag", list(KERNEL_FLAGS))
def test_guarded_dreamer_window_is_the_unguarded_one_bit_for_bit(flag):
    from tests.test_torch_train_cli import _tiny_window

    cfg, trainer, dims = _tiny_dv3(flag)
    blocks, noise = _tiny_window(trainer, dims)

    def window(c):
        return c + 1, trainer.train_phase(blocks, noise, c)

    start, snap = _state(trainer), trainer.snapshot()
    _, unguarded_metrics = window(0)
    unguarded = _state(trainer)
    trainer.restore(snap)
    assert all(torch.equal(a, b) for a, b in zip(_state(trainer), start))
    _, guarded_metrics = HealthSentinel.from_config(cfg).wrap(window, trainer.guarded_state, "cpu")(0)
    assert all(torch.equal(a, b) for a, b in zip(guarded_metrics, unguarded_metrics))
    assert all(torch.equal(a, b) for a, b in zip(_state(trainer), unguarded))
    assert not all(torch.equal(a, b) for a, b in zip(unguarded, start))

    # a planted nonfinite window: every trained tensor as it was, bit for bit
    faults.install_plan(faults.FaultPlan.from_specs([{"site": "update.grads", "kind": "nonfinite", "at": 1}]))
    sentinel = HealthSentinel.from_config(cfg)
    sentinel.wrap(window, trainer.guarded_state, "cpu")(1)
    assert all(torch.equal(a, b) for a, b in zip(_state(trainer), unguarded))
    assert sentinel.state.skipped.item() == 1 and sentinel.state.nonfinite_loss.item() == 1


# -- the loops -------------------------------------------------------------------------------
SAC = ["exp=sac", "env=dummy", "env.id=continuous_dummy", "env.num_envs=2", "env.capture_video=False",
       "algo.learning_starts=8", "algo.replay_ratio=0.5", "algo.per_rank_batch_size=8", "algo.run_test=False",
       "algo.mlp_keys.encoder=[state]", "algo.hidden_size=16", "fabric.accelerator=cpu", "buffer.memmap=False",
       "buffer.size=512", "metric.log_level=1", "metric.log_every=1", "metric/logger=csv"]


def _logged(log_dir, name):
    with open(glob.glob(f"{log_dir}/**/metrics.csv", recursive=True)[0]) as f:
        return [float(v) for _, n, v in list(csv.reader(f))[1:] if n == name]


def test_the_state_is_read_every_poll_interval(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import run

    polled, poll = [], HealthSentinel.poll

    def spy_should_poll(self, update, total_iters):
        due = update % self.poll_every == 0 or update >= total_iters
        if due:
            polled.append(update)
        return due

    reads = []
    monkeypatch.setattr(HealthSentinel, "should_poll", spy_should_poll)
    monkeypatch.setattr(HealthSentinel, "poll", lambda self, step: reads.append(step) or poll(self, step))
    run([*SAC, "algo.total_steps=40", "health.poll_every_updates=3", "checkpoint.save_last=False",
         f"log_dir={tmp_path}"])
    # 20 iterations, training from iteration 4 on: read at 6, 9, ..., 18 and the last
    assert polled == [6, 9, 12, 15, 18, 20] and len(reads) == len(polled)
    assert _logged(tmp_path, "Health/windows")[-1] == 17.0


ROLLBACK = ["health.poll_every_updates=1", "health.min_windows=2", "health.patience=1", "health.spike_factor=2.0",
            "health.spike_min=0.1", "health.divergence.action=rollback", "checkpoint.async_save=False"]


@pytest.mark.parametrize("case", ["rolls_back", "past_the_budget", "no_committed_snapshot"])
def test_sac_rolls_back_in_the_loop(case, tmp_path, monkeypatch, capsys):
    from sheeprl_tpu_torch.checkpoint import rollback
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setenv(faults.ENV_VAR, json.dumps({"plan": [{"site": "update.grads", "kind": "divergence",
                                                             "at": 6}]}))
    targets, rollback_state = [], rollback.rollback_state
    monkeypatch.setattr("sheeprl_tpu_torch.algos.sac.sac.rollback_state",
                        lambda mgr, fabric: targets.append(rollback_state(mgr, fabric)) or targets[-1])
    args = [*SAC, *ROLLBACK, "algo.total_steps=40", f"log_dir={tmp_path}"]
    if case == "rolls_back":
        run([*args, "checkpoint.every=4"])
        (state, step_dir), = targets
        assert state["policy_step"] == int(step_dir.name.split("_")[1]) and state["policy_step"] <= 14
        assert "rolled back to committed snapshot" in capsys.readouterr().out
        assert _logged(tmp_path, "Health/rollbacks")[-1] == 1.0
    elif case == "past_the_budget":
        with pytest.raises(DivergenceError, match="exhausted"):
            run([*args, "checkpoint.every=4", "health.divergence.max_rollbacks=0"])
    else:
        with pytest.raises(DivergenceError, match="no committed checkpoint"):
            run([*args, "checkpoint.every=0", "checkpoint.save_last=False"])
        assert targets == [(None, None)]


def test_dreamer_family_raises_divergence_error(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import run
    from tests.test_torch_train_cli import TINY

    monkeypatch.setenv(faults.ENV_VAR, json.dumps({"plan": [{"site": "update.grads", "kind": "divergence",
                                                             "at": 2}]}))
    with pytest.raises(DivergenceError, match="resume_from=auto"):
        run([*TINY, *ROLLBACK, "algo.run_test=False", "algo.total_steps=60", "algo.replay_ratio=0.125",
             f"log_dir={tmp_path}"])
