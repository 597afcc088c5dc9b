"""The one-device scale layer of the port against the JAX package, on the CPU.

* ``parallel/pipeline.py``: ``resolve_pipeline``'s validation and messages,
  ``bubble_fraction``, ``one_f_one_b``'s unit order, ``split_microbatches`` /
  ``merge_microbatches`` and ``chunked_rows`` with their remainder errors,
  each against JAX's on the same inputs; ``pipeline_value_and_grad`` on a toy
  three-stage chain against JAX's (loss, stacked aux and gradients to 1e-6).
* DreamerV3's pipelined update (``pipeline.stages=2``, ``microbatches=4``,
  ``imagination_microbatches=2``), for the posterior scan and for
  ``decoupled_rssm``, against JAX's pipelined ``make_train_phase`` on one CPU
  device (it builds there: with no ``pipeline`` mesh axis no rule is
  rewritten) on the same parameters and draws, at the tolerances of
  ``tests/test_torch_train_step.py``; and against the port's own
  monolithic update within 1e-5 relative L2 (only the order of float sums
  differs).
* ``algo.remat=True`` equals remat off for DreamerV1, V2 and V3 (within
  1e-6 relative L2; it is bit for bit).
* The remainder error in JAX's text, ``check_algo`` refusing another
  algorithm, and each lever training through ``cli.run``.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_train_step as train_step
from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_build_opts
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_phase as jax_make_train_phase
from sheeprl_tpu.parallel import pipeline as jp
from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as dv1_agent
from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1Trainer
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2Trainer
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_agent as dv2_agent
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, blocks_to_device, build_dv3_optimizers
from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.parallel import pipeline as pp
from sheeprl_tpu_torch.serve.loader import probe_spaces
from tests.test_torch_dreamer_v1 import TINY as FAMILY_TINY
from tests.test_torch_dreamer_v2 import CLI as FAMILY_CLI
from tests.test_torch_train_cli import TINY as CLI_TINY
from tests.test_torch_train_step import SGD, _overrides

PIPE = ("pipeline.stages=2", "pipeline.microbatches=4", "pipeline.imagination_microbatches=2")
PIPE_B = 4  # the pipelined updates' batch: 4 microbatches of one row


def _raises_like(jax_fn, port_fn):
    """Both raise ``ValueError`` with the same text."""
    with pytest.raises(ValueError) as j:
        jax_fn()
    with pytest.raises(ValueError) as p:
        port_fn()
    assert str(p.value) == str(j.value)


# -- the pipeline functions -------------------------------------------------------
RESOLVE = {
    "default": {},
    "2stage": {"stages": 2, "microbatches": 4},
    "accumulate": {"stages": 1, "microbatches": 3, "imagination_microbatches": 5},
    "3stage": {"stages": 3, "microbatches": 3},
    "zero": {"microbatches": 0},
    "schedule": {"schedule": "gpipe"},
    "all-bubble": {"stages": 3, "microbatches": 2},
}


@pytest.mark.parametrize("case", list(RESOLVE))
def test_resolve_pipeline_against_jax(case):
    cfg = {"pipeline": RESOLVE[case]}
    try:
        want = jp.resolve_pipeline(cfg)
    except ValueError:
        _raises_like(lambda: jp.resolve_pipeline(cfg), lambda: pp.resolve_pipeline(cfg))
        return
    got = pp.resolve_pipeline(cfg)
    for field in ("stages", "microbatches", "axis", "schedule", "imagination_microbatches", "enabled", "bubble_frac"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.metrics() == want.metrics()
    for algo in ("dreamer_v3", "dreamer_v2", "p2e_dv3_exploration"):
        if want.enabled and algo not in jp.PIPELINE_ALGOS:
            _raises_like(lambda: want.check_algo(algo), lambda: got.check_algo(algo))
        else:
            got.check_algo(algo)
    assert pp.PIPELINE_ALGOS == jp.PIPELINE_ALGOS


def test_schedule_and_bubble_against_jax():
    for S in range(1, 5):
        for M in range(1, 7):
            assert pp.one_f_one_b(S, M) == jp.one_f_one_b(S, M), (S, M)
            assert pp.bubble_fraction(S, M) == jp.bubble_fraction(S, M)
    for bad in ((0, 2), (2, 0)):
        _raises_like(lambda: jp.one_f_one_b(*bad), lambda: pp.one_f_one_b(*bad))


def test_split_merge_and_chunked_rows_against_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 8, 3)).astype(np.float32),
            "b": [rng.standard_normal((5, 8)).astype(np.float32)]}
    for axis in (0, 1):
        M = 4 if axis == 1 else 5
        j = jp.split_microbatches(jax.tree.map(jnp.asarray, tree), M, axis=axis)
        p = pp.split_microbatches({"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(tree["b"][0])]}, M,
                                  axis=axis)
        np.testing.assert_array_equal(p["b"][0].numpy(), np.asarray(j["b"][0]))
        np.testing.assert_array_equal(p["a"].numpy(), np.asarray(j["a"]))
        np.testing.assert_array_equal(pp.merge_microbatches(p["a"], axis).numpy(), tree["a"])
        np.testing.assert_array_equal(np.asarray(jp.merge_microbatches(j["a"], axis)), tree["a"])
    x = rng.standard_normal((5, 8)).astype(np.float32)
    _raises_like(lambda: jp.split_microbatches({"x": jnp.asarray(x)}, 3, axis=1),
                 lambda: pp.split_microbatches({"x": torch.from_numpy(x)}, 3, axis=1))
    _raises_like(lambda: jp.split_microbatches({"x": jnp.asarray(x)}, 2, axis=2),
                 lambda: pp.split_microbatches({"x": torch.from_numpy(x)}, 2, axis=2))

    w = rng.standard_normal((8, 6)).astype(np.float32)
    rows = rng.standard_normal((12, 8)).astype(np.float32)
    for chunks in (1, 3, 4, 12):
        got = pp.chunked_rows(lambda r: torch.tanh(r @ torch.from_numpy(w)), torch.from_numpy(rows), chunks)
        want = jp.chunked_rows(lambda r: jnp.tanh(r @ w), jnp.asarray(rows), chunks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    _raises_like(lambda: jp.chunked_rows(jnp.tanh, jnp.asarray(rows), 5),
                 lambda: pp.chunked_rows(torch.tanh, torch.from_numpy(rows), 5))


def test_pipeline_value_and_grad_on_a_toy_chain_against_jax():
    """A three-stage chain (the middle stage's carry a pair, one part of it
    unused by the last stage) over 4 microbatches in 1F1B order."""
    rng = np.random.default_rng(1)
    w = {k: rng.standard_normal(s).astype(np.float32) / 3 for k, s in
         (("w1", (5, 6)), ("w2", (6, 4)), ("w3", (4, 2)), ("b3", (2,)))}
    data = {"x": rng.standard_normal((3, 8, 5)).astype(np.float32),
            "y": rng.standard_normal((3, 8, 2)).astype(np.float32)}
    M = 4

    def j_stages():
        def s0(p, _c, c):
            return jnp.tanh(c["x"] @ p["w1"])

        def s1(p, h, c):
            return jnp.sin(h @ p["w2"]), h

        def s2(p, carry, c):
            g, _ = carry
            pred = g @ p["w3"] + p["b3"]
            return jnp.mean((pred - c["y"]) ** 2), {"pred": pred, "scale": jnp.mean(jnp.abs(pred))}

        return (s0, s1, s2)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w.items()}

    def p_stages():
        def s0(_c, c):
            return torch.tanh(c["x"] @ params["w1"])

        def s1(h, c):
            return torch.sin(h @ params["w2"]), h

        def s2(carry, c):
            g, _ = carry
            pred = g @ params["w3"] + params["b3"]
            return torch.mean((pred - c["y"]) ** 2), {"pred": pred, "scale": torch.mean(torch.abs(pred))}

        return (s0, s1, s2)

    j_consts = jp.split_microbatches(jax.tree.map(jnp.asarray, data), M, axis=1)
    # traced once, as the JAX train phase runs it
    j_loss, j_aux, j_grads = jax.jit(lambda p, c: jp.pipeline_value_and_grad(j_stages(), p, c, microbatches=M))(
        jax.tree.map(jnp.asarray, w), j_consts)
    p_consts = pp.split_microbatches({k: torch.from_numpy(v) for k, v in data.items()}, M, axis=1)
    p_loss, p_aux, p_grads = pp.pipeline_value_and_grad(p_stages(), list(params.values()), p_consts, microbatches=M)
    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-6)
    for k in ("pred", "scale"):
        np.testing.assert_allclose(p_aux[k].numpy(), np.asarray(j_aux[k]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pp.merge_microbatches(p_aux["pred"], 1).numpy(),
                               np.asarray(jp.merge_microbatches(j_aux["pred"], 1)), rtol=1e-6, atol=1e-6)
    for (k, p), g in zip(params.items(), p_grads):
        assert g is p.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(j_grads[k]), rtol=1e-5, atol=1e-6, err_msg=k)


# -- DreamerV3's pipelined update ----------------------------------------------------
def _rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _flat(states, start):
    return torch.cat([(states[k] - start[k]).flatten() for k in sorted(states)])


@pytest.mark.parametrize("decoupled", [False, True], ids=["posterior-scan", "decoupled_rssm"])
def test_pipelined_dv3_update_against_jax_and_the_monolithic_update(decoupled, monkeypatch):
    monkeypatch.setattr(train_step, "B", PIPE_B)
    extra = (*PIPE, f"algo.per_rank_batch_size={PIPE_B}", "algo.world_model.recurrent_model.fused_pallas=True",
             *(("algo.world_model.decoupled_rssm=True",) if decoupled else ()))
    overrides = _overrides("discrete_dummy", False, None, SGD, extra)
    # JAX's pipelined phase (one CPU device, no pipeline mesh axis) is the reference
    trainer, pcfg, j_metrics, p_metrics, start, after = train_step.family_run(
        jax_agent, jax_make_train_phase, jax_build_opts, build_agent, DV3Trainer, build_dv3_optimizers, overrides,
        False, 1, 0, n_split=2, rollouts=(1,))
    assert trainer.pipe.enabled and trainer.stage_names == ("encoder_rssm", "heads")
    assert np.isfinite(p_metrics).all()
    np.testing.assert_allclose(p_metrics, j_metrics, rtol=1e-5, atol=2e-5)
    pipelined = dict(train_step._flat_states(trainer.agent_state()))
    for path, j_after in after.items():
        if "moments" in path:
            np.testing.assert_allclose(float(pipelined[path]), float(j_after), rtol=1e-5, atol=1e-6, err_msg=path)
            continue
        j_delta = (j_after - start[path]).numpy()
        p_delta = (pipelined[path] - start[path]).numpy()
        np.testing.assert_allclose(p_delta, j_delta, rtol=1e-4, atol=1e-3 * max(np.abs(j_delta).max(), 1e-12),
                                   err_msg=path)

    # the port's monolithic update from the same state and draws
    mono_overrides = [o for o in overrides if not o.startswith("pipeline.")]
    mono = _port_update(mono_overrides, start)
    trained = {k: v for k, v in pipelined.items() if "moments" not in k}
    assert set(trained) == set(mono)
    assert _rel_l2(_flat(trained, start), _flat(mono, start)) < 1e-5


def _port_update(overrides, start, trainer_cls=DV3Trainer, build=build_agent, gaussian=False, n_split=2):
    """The port's update on ``family_run``'s block and draws (vector
    observations), from the flat state ``start``; the trained tensors after it."""
    cfg = compose(list(overrides))
    fabric = build_fabric(cfg)
    obs_space, act_space = probe_spaces(cfg)
    actions_dim, is_cont = spaces_to_dims(act_space)
    state = {}
    for path, v in start.items():
        top, rest = path.split("/", 1)
        state.setdefault(top, {})[rest] = v.clone()
    modules = build(fabric, actions_dim, is_cont, cfg, obs_space, state)
    trainer = trainer_cls(cfg, modules, build_dv3_optimizers(cfg, modules), (), ("state",), is_cont, state)
    rng = np.random.default_rng(7)
    block = train_step._block(rng, 1, False, actions_dim, is_cont)
    wm = cfg.algo.world_model
    latent = (wm.stochastic_size,) if gaussian else (wm.stochastic_size, wm.discrete_size)
    noise = train_step.family_noise(jax.random.PRNGKey(11), 1, actions_dim, is_cont, latent, n_split, (1,), gaussian)
    trainer.train_phase(blocks_to_device(block, (), ("state",), "cpu"), noise, 0)
    return {k: v for k, v in train_step._flat_states(trainer.agent_state()) if "moments" not in k}


# -- algo.remat ---------------------------------------------------------------------------
REMAT = {
    # id: (exp, port builder, trainer, Gaussian latents, key splits)
    "dreamer_v1": ("dreamer_v1", dv1_agent, DV1Trainer, True, 3),
    "dreamer_v2": ("dreamer_v2", dv2_agent, DV2Trainer, False, 3),
    "dreamer_v3": ("dreamer_v3", build_agent, DV3Trainer, False, 2),
}


@pytest.mark.parametrize("algo", list(REMAT))
def test_remat_equals_remat_off(algo):
    """The scan steps re-computed in the backward (``torch.utils.checkpoint``
    on the posterior and imagination steps) give the update of remat off,
    from one state and one set of draws; continuous actions, so the actor's
    gradient runs back through the re-computed imagination."""
    exp, build, trainer_cls, gaussian, n_split = REMAT[algo]
    base = ["exp=" + exp, *train_step.BASE[1:], "env.id=continuous_dummy", "algo.cnn_keys.encoder=[]",
            "algo.mlp_keys.encoder=[state]", *SGD]
    if exp == "dreamer_v3":
        base.append("algo.world_model.recurrent_model.fused_pallas=True")
    else:
        base = [o for o in base if not o.startswith(("algo=", "algo.world_model.discrete_size"))]
    cfg = compose(base)
    fabric = build_fabric(cfg)
    obs_space, act_space = probe_spaces(cfg)
    actions_dim, is_cont = spaces_to_dims(act_space)
    torch.manual_seed(0)
    start = {f"{name}/{k}": v.detach().clone() for name, m in
             build(fabric, actions_dim, is_cont, cfg, obs_space).items() for k, v in m.state_dict().items()}
    off = _port_update(base, start, trainer_cls, build, gaussian, n_split)
    on = _port_update([*base, "algo.remat=True"], start, trainer_cls, build, gaussian, n_split)
    assert set(on) == set(off)
    assert _rel_l2(_flat(on, start), _flat(off, start)) <= 1e-6


# -- errors ---------------------------------------------------------------------------------
def test_microbatch_remainder_and_other_algorithms_raise_with_jax_text(tmp_path, monkeypatch):
    """A batch of 2 rows cannot split into 4 microbatches: the update raises
    the text JAX's ``split_microbatches`` raises on the same tree; a
    pipelined run of another algorithm raises JAX's ``check_algo`` text
    before anything is built."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    trees, split = [], dreamer_v3.split_microbatches

    def spy(tree, *args, **kwargs):
        trees.append(tree)
        return split(tree, *args, **kwargs)

    monkeypatch.setattr(dreamer_v3, "split_microbatches", spy)
    with pytest.raises(ValueError) as got:
        run([*CLI_TINY, "dry_run=True", f"log_dir={tmp_path / 'remainder'}", "pipeline.microbatches=4"])
    with pytest.raises(ValueError) as want:
        jp.split_microbatches(jax.tree.map(lambda t: jnp.asarray(t.numpy()), trees[0]), 4, axis=1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        run(["exp=dreamer_v2", *FAMILY_TINY, *FAMILY_CLI, f"log_dir={tmp_path / 'dv2'}", "pipeline.microbatches=2"])
    with pytest.raises(ValueError) as want:
        jp.PipelineSpec(microbatches=2).check_algo("dreamer_v2")
    assert str(got.value) == str(want.value)
    assert not glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True)


# -- the levers through cli.run ---------------------------------------------------------------
CLI_LEVERS = {
    # id: (extra overrides, stage names, microbatches)
    "stages1-microbatches2-remat": (("pipeline.microbatches=2", "algo.remat=True"), ("world_model",), 2),
    "stages2-imagination2": (("pipeline=2stage", "pipeline.microbatches=2", "pipeline.imagination_microbatches=2"),
                             ("encoder_rssm", "heads"), 2),
    "stages3-batch3": (("pipeline.stages=3", "pipeline.microbatches=3", "algo.per_rank_batch_size=3"),
                       ("encoder", "rssm", "heads"), 3),
}


@pytest.mark.parametrize("case", list(CLI_LEVERS))
def test_levers_train_through_the_cli(case, tmp_path, monkeypatch):
    extra, names, microbatches = CLI_LEVERS[case]
    seen = {}
    init = DV3Trainer.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen["names"] = getattr(self, "stage_names", None)

    monkeypatch.setattr(DV3Trainer, "__init__", spy)
    run([*CLI_TINY, "dry_run=True", "algo.run_test=False", f"log_dir={tmp_path}", *extra])
    assert seen["names"] == names
    (snapshot,) = glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True)
    state = load_step_dir(snapshot)
    assert state["grad_steps"] == 1
    assert all(torch.isfinite(v).all() for v in state["agent"]["world_model"].values())
    (metrics_csv,) = glob.glob(f"{tmp_path}/**/metrics.csv", recursive=True)
    assert f",Pipeline/microbatches,{float(microbatches)}" in open(metrics_csv).read()


@pytest.mark.parametrize("exp", ["dreamer_v1", "dreamer_v2"])
def test_remat_trains_the_family_through_the_cli(exp, tmp_path):
    run([f"exp={exp}", *FAMILY_TINY, *FAMILY_CLI, "algo.remat=True", f"log_dir={tmp_path}"])
    (snapshot,) = glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True)
    assert load_step_dir(snapshot)["grad_steps"] == 1
