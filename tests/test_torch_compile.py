"""The port's compile-once layer (``sheeprl_tpu_torch/parallel/compile.py``)
against the JAX package's (``sheeprl_tpu/parallel/compile.py``), on the CPU.

Each case of ``tests/test_parallel/test_compile.py`` is driven through JAX's
``AOTFunction`` and the port's ``GraphFunction`` with the same call
sequence: both must count the same builds after every call and raise
``RecompileLimitExceeded`` at the same call.  On the CPU the port's function
runs eagerly under the audit; the captured CUDA graphs run on the card only
(``chip_smoke.py`` phase 37).  Then ``algo.max_recompiles`` is held in the
port's train loops: a DreamerV3 dry run completes under a zero budget (an
Anakin PPO run does in ``test_torch_train_cli.py``), and a forced new shape
raises in both.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.parallel.compile import AOTFunction
from sheeprl_tpu.utils.profiler import CompileMonitor as JaxCompileMonitor
from sheeprl_tpu.utils.profiler import RecompileLimitExceeded as JaxRecompileLimitExceeded
from sheeprl_tpu_torch.parallel.compile import CompilePool, GraphFunction, compile_once, warmup_batch_ladder
from sheeprl_tpu_torch.telemetry.monitors import CompileMonitor, RecompileLimitExceeded
from sheeprl_tpu_torch.utils import profiler


def _drive(make, calls):
    """``[(count after the call, tripped)]`` for ``calls`` = ``[(args, kwargs)]``
    on the wrapper ``make()`` returns, which counts into its own monitor."""
    fn = make()
    trail = []
    for args, kwargs in calls:
        try:
            fn(*args, **kwargs)
            tripped = False
        except (RecompileLimitExceeded, JaxRecompileLimitExceeded) as e:
            assert "signature history" in str(e)
            tripped = True
        trail.append((fn._monitor.count(fn.name), tripped))
    return trail


def _x(shape, dtype=np.float32):
    return np.ones(shape, dtype)


# name: (jax fn, torch fn, wrapper kwargs, calls as (numpy args, kwargs))
CASES = {
    "same_signature": (lambda x: x * 2.0, lambda x: x * 2.0, {},
                       [((_x(4),), {}), ((_x(4) + 1,), {})]),
    "changed_shape": (lambda x: x.sum(), lambda x: x.sum(), {}, [((_x(4),), {}), ((_x(8),), {})]),
    "changed_dtype": (lambda x: x + 1, lambda x: x + 1, {},
                      [((_x(4),), {}), ((_x(4, np.int32),), {})]),
    "max_recompiles_0": (lambda x: x * 1.0, lambda x: x * 1.0, {"max_recompiles": 0},
                         [((_x(4),), {}), ((_x(5),), {}), ((_x(4),), {})]),
    "max_recompiles_1": (lambda x: x * 1.0, lambda x: x * 1.0, {"max_recompiles": 1},
                         [((_x(4),), {}), ((_x(5),), {}), ((_x(6),), {}), ((_x(5),), {})]),
    "static_by_value": (lambda x, mode=False: x * 2.0 if mode else x + 1.0,
                        lambda x, mode=False: x * 2.0 if mode else x + 1.0, {"static_argnames": ("mode",)},
                        [((_x(3),), {}), ((_x(3),), {"mode": True}), ((_x(3), True), {}),
                         ((_x(3), False), {})]),
    "static_argnums": (lambda n, x: x * n, lambda n, x: x * n, {"static_argnums": (0,)},
                       [((2, _x(3)), {}), ((2, _x(3)), {}), ((3, _x(3)), {})]),
    "python_scalar_by_type": (lambda x, s: x * s, lambda x, s: x * s, {},
                              [((_x(2), 2.0), {}), ((_x(2), 3.0), {}), ((_x(2), 3), {})]),
}


def _jax_calls(calls):
    return [(tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), kwargs)
            for args, kwargs in calls]


def _torch_calls(calls):
    return [(tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args), kwargs)
            for args, kwargs in calls]


@pytest.mark.parametrize("case", list(CASES))
def test_graph_function_audits_as_aot_function(case):
    """The same call sequence gives the same build counts after every call,
    and trips the budget at the same call, in both packages."""
    jfn, tfn, kwargs, calls = CASES[case]
    jax_trail = _drive(lambda: AOTFunction(jfn, name=case, monitor=JaxCompileMonitor(), **kwargs), _jax_calls(calls))
    torch_trail = _drive(lambda: GraphFunction(tfn, name=case, monitor=CompileMonitor(), **kwargs),
                         _torch_calls(calls))
    assert torch_trail == jax_trail


def test_env_default_limit_as_aot_function(monkeypatch):
    monkeypatch.setenv("SHEEPRL_MAX_RECOMPILES", "0")
    calls = [((_x(2),), {}), ((_x(3),), {})]
    jax_trail = _drive(lambda: AOTFunction(lambda x: x, name="envcap", monitor=JaxCompileMonitor()),
                       _jax_calls(calls))
    torch_trail = _drive(lambda: GraphFunction(lambda x: x, name="envcap", monitor=CompileMonitor()),
                         _torch_calls(calls))
    assert torch_trail == jax_trail == [(1, False), (1, True)]


def test_guard_fires_before_paying_for_the_build():
    """Tripping the budget must not first run (or capture) the function: JAX
    traces nothing for the refused shape, the port calls nothing."""
    traced, called = [], []

    def jfn(x):
        traced.append(1)
        return x

    def tfn(x):
        called.append(1)
        return x

    aot = AOTFunction(jfn, name="pretrace", monitor=JaxCompileMonitor(), max_recompiles=0)
    gf = GraphFunction(tfn, name="pretrace", monitor=CompileMonitor(), max_recompiles=0)
    aot(jnp.ones((2,)))
    gf(torch.ones(2))
    before = (len(traced), len(called))
    with pytest.raises(JaxRecompileLimitExceeded):
        aot(jnp.ones((3,)))
    with pytest.raises(RecompileLimitExceeded):
        gf(torch.ones(3))
    assert (len(traced), len(called)) == before
    assert gf.cache_size() == aot.cache_size() == 1


def test_failed_build_rolls_the_audit_back():
    """A build that raises is not counted: the retry is the first build again."""
    monitor = CompileMonitor()
    fail = [True]

    def fn(x):
        if fail[0]:
            raise ValueError("boom")
        return x + 1

    gf = GraphFunction(fn, name="flaky", monitor=monitor, max_recompiles=0)
    with pytest.raises(ValueError):
        gf(torch.ones(2))
    assert monitor.count("flaky") == 0 and gf.cache_size() == 0
    fail[0] = False
    assert torch.equal(gf(torch.ones(2)), torch.full((2,), 2.0))
    assert monitor.count("flaky") == 1


def test_a_graph_route_refuses_host_inputs_before_capturing():
    """On a card device the function is captured, which takes tensors on the
    card: a CPU tensor or an object leaf raises before anything runs, and the
    audit is rolled back."""
    monitor = CompileMonitor()
    gf = GraphFunction(lambda x: x, name="card", device="cuda", monitor=monitor)
    assert gf.graphs
    for bad in (torch.ones(2), object()):
        with pytest.raises(TypeError):
            gf(bad)
    assert monitor.count("card") == 0 and gf._compile_count == 0
    eager = GraphFunction(lambda x: x, name="card", device="cuda", eager_reason="a reason")
    assert not eager.graphs and not compile_once(lambda x: x).graphs


def test_pytree_structure_round_trips():
    from sheeprl_tpu_torch.parallel.compile import _flatten, _unflatten

    State = collections.namedtuple("State", "a b")
    tree = ({"s": State(torch.zeros(1), [1, None])}, (2.0,))
    leaves = []
    structure = _flatten(tree, leaves)
    back = _unflatten(structure, iter(leaves))
    assert isinstance(back[0]["s"], State) and isinstance(back[0]["s"].b, list) and back[1] == (2.0,)
    assert back[0]["s"].b == [1, None] and back[0]["s"].a is leaves[0]


def test_profiler_shims_are_the_monitor():
    from sheeprl_tpu_torch.telemetry import monitors

    assert profiler.COMPILE_MONITOR is monitors.COMPILE_MONITOR
    assert profiler.RecompileLimitExceeded is monitors.RecompileLimitExceeded


def test_warmup_pool_and_ladder():
    """Benign warm-up failures are swallowed at join, the budget is a hard
    error; the ladder builds one entry per rung on the calling thread."""
    pool = CompilePool(max_workers=1)
    pool.submit_fn(lambda: (_ for _ in ()).throw(ValueError("benign")))
    pool.join()

    def boom():
        raise RecompileLimitExceeded("hard")

    pool.submit_fn(boom)
    with pytest.raises(RecompileLimitExceeded):
        pool.join()
    gf = GraphFunction(lambda x: x * 2, name="ladder", monitor=CompileMonitor(), max_recompiles=2)
    warmup_batch_ladder(gf, lambda b: (torch.zeros(b, 3),), (1, 8, 32), pool=pool)
    assert gf.cache_size() == 3
    pool.shutdown()


# -- algo.max_recompiles in the train loops -------------------------------------
def _dv3_vector():
    """The CLI tests' tiny DreamerV3 recipe on the vector observation alone."""
    from tests.test_torch_train_cli import TINY

    drop = ("buffer.checkpoint", "algo.cnn_keys")
    return [o for o in TINY if not o.startswith(drop)] + ["buffer.checkpoint=False", "algo.cnn_keys.encoder=[]"]


def test_dreamer_v3_loop_under_zero_budget(tmp_path):
    """A drift-free DreamerV3 dry run completes under ``max_recompiles=0``;
    a run whose windows change length (the first window repays the prefill,
    the next one is a single update) trips the budget at the second window."""
    from sheeprl_tpu_torch.cli import run

    run([*_dv3_vector(), "dry_run=True", "algo.run_test=False", "algo.max_recompiles=0", f"log_dir={tmp_path / 'a'}"])
    with pytest.raises(RecompileLimitExceeded, match="train_phase"):
        run([*_dv3_vector(), "algo.learning_starts=16", "algo.total_steps=40", "algo.replay_ratio=0.25",
             "algo.run_test=False", "algo.max_recompiles=0", f"log_dir={tmp_path / 'b'}"])


def test_anakin_ppo_new_shape_trips_the_budget(tmp_path, monkeypatch):
    """Anakin PPO under ``max_recompiles=0`` (its drift-free run completes in
    ``test_torch_train_cli.py``'s ``ppo-cartpole`` case): a rollout forced one
    step short in the second iteration reaches the update with a new shape,
    which raises."""
    from sheeprl_tpu_torch.algos.ppo import ppo as ppo_mod
    from sheeprl_tpu_torch.cli import run
    from tests.test_torch_train_cli import DEVICE_ENV_COMMON, DEVICE_ENV_RUNS

    make = ppo_mod.make_rollout_fn

    def short_second_rollout(*args, **kwargs):
        rollout, calls = make(*args, **kwargs), []

        def shortened(actor, noise, reset_draws=None):
            calls.append(1)
            new, traj, last_obs, stats = rollout(actor, noise, reset_draws)
            if len(calls) == 2:
                traj = {k: v[:-1] for k, v in traj.items()}
            return new, traj, last_obs, stats

        return shortened

    monkeypatch.setattr(ppo_mod, "make_rollout_fn", short_second_rollout)
    with pytest.raises(RecompileLimitExceeded, match="ppo.train_phase"):
        run([*DEVICE_ENV_COMMON, *DEVICE_ENV_RUNS["ppo-cartpole"][0], "algo.run_test=False",
             "checkpoint.save_last=False", f"log_dir={tmp_path}"])
