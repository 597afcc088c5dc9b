"""Training resumed from a snapshot the JAX package wrote, family by family.

For every family the JAX package writes a committed snapshot through its
own checkpoint code: the agent's parameters (numpy-drawn, the shapes of its
``build_agent``), the optax state of each optimizer after three steps on
random gradients (the chain its loops build: ``clip_by_global_norm`` and
``inject_hyperparams`` of Adam, the RMSprops or SGD), raw and typed PRNG
keys, and the loop's counters.  Then:

* ``convert.resume_state_from_jax`` gives the port's optimizers the state
  that makes their next step JAX's next step: one more step on the same
  random gradients (converted by the parameters' own converter) moves each
  parameter by JAX's change to 1e-4 of the group's largest change plus
  1e-7 (elementwise fp32 work only; the ``DRIFT.md`` tier of a gradient
  step).  A control that drops the optimizer state lands far outside;
* ``cli.run`` continues the snapshot: the counters go on from it;
* for DreamerV3, SAC and PPO the first whole update from the same
  snapshot, on a fixed batch and JAX's draws, agrees with JAX's train phase
  (``make_train_phase``, ``make_sac_train_fns``, the PPO ``main``'s own)
  within the family parity test's tolerance, and without the optimizer
  state it does not; the rest of the families' loss sides are held by their
  own parity tests;
* the host replay ring a JAX run saved loads into the port's;
* a population snapshot (PPO with Adam, A2C with the centred RMSprop with
  momentum, P = 2) resumes: the stacked optimizer takes JAX's next vmapped
  step at each member's learning rate, to the same bound (a control without
  the optimizer state misses it), and the PBT carry is JAX's; ``cli.run``
  continues the committed fixture ``tests/fixtures/jax_ppo_population/``
  (written by ``tools/write_jax_population_fixture.py``): counters,
  exploits and episodes go on from it.
"""

import contextlib
import fcntl
import glob
import os
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sheeprl_tpu.algos.ppo.utils import spaces_to_dims as jax_spaces_to_dims
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import (
    OptaxState,
    agent_from_jax,
    load_resume_state,
    policy_state_from_jax,
    sac_state_from_jax,
)
from sheeprl_tpu_torch.fabric import build_fabric
from tests.test_torch_dreamer_v1 import CLI as DV1_CLI
from tests.test_torch_dreamer_v1 import TINY as DV1_TINY
from tests.test_torch_dreamer_v2 import CLI as DV2_CLI
from tests.test_torch_dreamer_v2 import TINY as DV2_TINY
from tests.test_torch_p2e_dv3 import CLI as P2E_CLI
from tests.test_torch_p2e_dv3 import TINY as P2E_TINY
from tests.test_torch_train_cli import OFF_POLICY, OFF_POLICY_COMMON, ON_POLICY, ON_POLICY_COMMON
from tests.test_torch_train_cli import TINY as DV3_TINY


def _no_dry(overrides):
    return [o for o in overrides if not o.startswith("dry_run")]


#: family → (its tiny CLI recipe, the snapshot's update, policy steps per update)
FAMILIES = {
    "dreamer_v3": (DV3_TINY, 20, 2),
    "p2e_dv3_exploration": ([*P2E_TINY, *_no_dry(P2E_CLI)], 20, 2),
    "dreamer_v2": (["exp=dreamer_v2", *DV2_TINY, *_no_dry(DV2_CLI)], 20, 2),
    "p2e_dv2_exploration": (["exp=p2e_dv2_exploration", *DV2_TINY, *_no_dry(DV2_CLI)], 20, 2),
    "dreamer_v1": (["exp=dreamer_v1", *DV1_TINY, *_no_dry(DV1_CLI)], 20, 2),
    "p2e_dv1_exploration": (["exp=p2e_dv1_exploration", *DV1_TINY, *_no_dry(DV1_CLI)], 20, 2),
    "ppo": ([*ON_POLICY_COMMON, *ON_POLICY["ppo"]], 2, 16),
    "ppo-sgd-momentum": ([*ON_POLICY_COMMON, *ON_POLICY["ppo"], "algo.optimizer.name=sgd", "algo.optimizer.lr=0.01",
                          "algo.optimizer.momentum=0.9"], 2, 16),
    "a2c-rmsprop-centered-momentum": ([*ON_POLICY_COMMON, *ON_POLICY["a2c"], "algo.optimizer.name=rmsprop",
                                       "algo.optimizer.momentum=0.9", "algo.optimizer.centered=True"], 2, 16),
    "a2c-rmsprop_tf-centered-momentum": ([*ON_POLICY_COMMON, *ON_POLICY["a2c"], "algo.optimizer.name=rmsprop_tf",
                                          "algo.optimizer.momentum=0.9", "algo.optimizer.centered=True"], 2, 16),
    "ppo_recurrent": ([*ON_POLICY_COMMON, *ON_POLICY["ppo_recurrent"]], 2, 16),
    "sac": (["exp=sac", *OFF_POLICY_COMMON, *OFF_POLICY["sac"][0]], 10, 2),
    "droq": (["exp=droq", *OFF_POLICY_COMMON, *OFF_POLICY["droq"][0]], 10, 2),
    "sac_ae": (["exp=sac_ae", *OFF_POLICY_COMMON, *OFF_POLICY["sac_ae"][0]], 10, 2),
}
GRAD_STEPS = 1000


def _recipe(family):
    return [*FAMILIES[family][0], "env.sync_env=True"]


# -- the JAX side -----------------------------------------------------------------
def _jax_agent(jcfg, seed=0):
    """The JAX ``build_agent`` of the config's algorithm, its parameters
    numpy-drawn from ``seed`` (kernels ~ N(0, 1/fan_in), LayerNorm scales
    near one)."""
    import importlib

    name = str(jcfg.algo.name)
    fabric = jax_build_fabric(jcfg)
    obs_space, action_space = jax_probe_spaces(jcfg)
    modules = {
        "dreamer_v3": "sheeprl_tpu.algos.dreamer_v3.agent", "p2e_dv3_exploration":
        "sheeprl_tpu.algos.p2e_dv3.p2e_dv3_exploration", "dreamer_v2": "sheeprl_tpu.algos.dreamer_v2.dreamer_v2",
        "p2e_dv2_exploration": "sheeprl_tpu.algos.p2e_dv2.p2e_dv2_exploration",
        "dreamer_v1": "sheeprl_tpu.algos.dreamer_v1.agent", "p2e_dv1_exploration":
        "sheeprl_tpu.algos.p2e_dv1.p2e_dv1_exploration", "ppo": "sheeprl_tpu.algos.ppo.agent",
        "a2c": "sheeprl_tpu.algos.ppo.agent", "ppo_recurrent": "sheeprl_tpu.algos.ppo_recurrent.agent",
        "sac": "sheeprl_tpu.algos.sac.agent", "droq": "sheeprl_tpu.algos.droq.agent",
        "sac_ae": "sheeprl_tpu.algos.sac_ae.agent"}
    build = importlib.import_module(modules[name]).build_agent
    if name in ("sac", "droq"):
        obs_dim = int(sum(np.prod(obs_space[k].shape) for k in jcfg.algo.mlp_keys.encoder))
        args = (fabric, int(np.prod(action_space.shape)), jcfg, obs_dim)
    elif name == "sac_ae":
        args = (fabric, int(np.prod(action_space.shape)), jcfg, obs_space)
    else:
        dims, cont = jax_spaces_to_dims(action_space)
        args = (fabric, dims, cont, jcfg, obs_space)
    shapes = jax.eval_shape(lambda: build(*args)[-1])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if key.endswith("kernel"):
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        return 1.0 + 0.1 * noise if key.endswith("scale") else 0.1 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _groups(jcfg, params):
    """Each optimizer of the family's JAX loop: port name → (the path of its
    parameters in the agent tree, its optax chain)."""
    algo, name = jcfg.algo, str(jcfg.algo.name)
    if name in ("ppo", "a2c", "ppo_recurrent"):
        return {None: ((), jax_build_optimizer(algo.optimizer, algo.max_grad_norm))}
    if name in ("sac", "droq", "sac_ae"):
        groups = {g: ((g,), jax_build_optimizer(algo[g].optimizer)) for g in ("actor", "critic")}
        groups["alpha"] = (("log_alpha",), jax_build_optimizer(algo.alpha.optimizer))
        if name == "sac_ae":
            groups.update({g: ((g,), jax_build_optimizer(algo[g].optimizer)) for g in ("encoder", "decoder")})
        return groups
    section = {"actor_task": "actor", "critic_exploration": "critic"}
    groups = {g: ((g,), jax_build_optimizer(algo[section.get(g, g)].optimizer,
                                            algo[section.get(g, g)].get("clip_gradients")))
              for g in ("world_model", "actor", "critic", "actor_task", "critic_exploration", "ensembles") if g in params}
    for c in params.get("critics_exploration", {}):
        groups[f"critics_exploration.{c}"] = (("critics_exploration", c, "critic"),
                                               jax_build_optimizer(algo.critic.optimizer, algo.critic.clip_gradients))
    return groups


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = _set(tree[path[0]], path[1:], value)
    return out


def _grads(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32)), tree)


def _opt_layout(opt):
    """The opt_state tree as the JAX loop saves it (P2E-DV3's exploration
    critics nested under ``critics_exploration``; a single state as it is)."""
    if None in opt:
        return opt[None]
    out = {}
    for k, v in opt.items():
        if k.startswith("critics_exploration."):
            out.setdefault("critics_exploration", {})[k.split(".", 1)[1]] = v
        else:
            out[k] = v
    return out


def _jax_snapshot(root, family, steps=3):
    """The JAX package's own committed snapshot of ``family`` after
    ``steps`` optimizer steps on random gradients; returns its step
    directory, the parameters and the chains' states."""
    from sheeprl_tpu.checkpoint.protocol import step_dir_name, write_commit, write_shard
    from sheeprl_tpu.checkpoint.serialize import snapshot_tree, to_host_tree

    jcfg = jax_compose(_recipe(family))
    params = jax.tree.map(jnp.asarray, _jax_agent(jcfg))
    groups = _groups(jcfg, params)
    opt = {}
    for g, (path, chain) in groups.items():
        sub = _get(params, path)
        state = chain.init(sub)
        for s in range(steps):
            updates, state = chain.update(_grads(sub, 100 * s), state, sub)
            sub = optax.apply_updates(sub, updates)
        params = _set(params, path, sub)
        opt[g] = state
    update, per = FAMILIES[family][1:]
    state = {"agent": params, "opt_state": _opt_layout(opt), "key": jax.random.PRNGKey(5),
             "player_key": jax.random.key(6), "policy_step": update * per, "update": update, "last_log": 0,
             "last_checkpoint": update * per, "grad_steps": GRAD_STEPS,
             "ratio": {"ratio": float(jcfg.algo.get("replay_ratio", 1.0) or 1.0), "prev": float(update * per),
                       "pretrain_steps": 0}}
    version = pathlib.Path(root) / family / "version_0"
    (version / "checkpoint").mkdir(parents=True)
    (version / "config.yaml").write_text(yaml.safe_dump(jcfg.as_dict()))
    step = version / "checkpoint" / step_dir_name(update * per)
    write_shard(step, 0, to_host_tree(snapshot_tree(state)))
    assert write_commit(step, update * per, 1, timeout_s=10.0)
    return step, params, opt


def _shared_dir(tmp_path_factory, name):
    """A directory every xdist worker of this session shares (the workers'
    base temps sit side by side under the session's)."""
    base = tmp_path_factory.getbasetemp()
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / name
    root.mkdir(parents=True, exist_ok=True)
    return root


@contextlib.contextmanager
def _locked(path):
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _built_once(root, name, build):
    """``build(root)`` run by the first worker that needs ``name``, its
    result (its last element a step directory, the rest picklable host
    trees) kept under ``root`` for the session: the JAX snapshots cost
    seconds to minutes each, and every worker drawing one of their tests
    would otherwise build its own."""
    done = root / f"{name}.pkl"
    with _locked(root / f"{name}.lock"):
        if not done.exists():
            done.write_bytes(pickle.dumps(jax.device_get(build(root))))
    return pickle.loads(done.read_bytes())


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    root, cache = _shared_dir(tmp_path_factory, "jax_resume"), {}

    def get(family):
        if family not in cache:
            step, params, opt = _built_once(root, family, lambda r: _jax_snapshot(r, family))
            jcfg = jax_compose(_recipe(family))
            cache[family] = (step, jcfg, params, _groups(jcfg, params), opt)
        return cache[family]

    return get


# -- the port side ----------------------------------------------------------------
def _port_optimizers(pcfg, state, with_opt_state=True):
    """The port agent and optimizers a loop builds from ``state``."""
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    name = str(pcfg.algo.name)
    fabric = build_fabric(pcfg)
    obs_space, action_space = probe_spaces(pcfg)
    saved = state["opt_state"] if with_opt_state else None
    if name in ("ppo", "a2c", "ppo_recurrent"):
        from sheeprl_tpu_torch.utils.optim import build_optimizer

        mod = "ppo_recurrent" if name == "ppo_recurrent" else "ppo"
        build = __import__(f"sheeprl_tpu_torch.algos.{mod}.agent", fromlist=["build_agent"]).build_agent
        dims, cont = spaces_to_dims(action_space)
        agent = build(fabric, dims, cont, pcfg, obs_space, state["agent"])
        opt = build_optimizer(agent.named_parameters(), pcfg.algo.optimizer, pcfg.algo.max_grad_norm)
        if saved is not None:
            opt.load_state_dict(saved)
        return {None: agent}, {None: opt}
    if name in ("sac", "droq", "sac_ae"):
        from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
        from sheeprl_tpu_torch.algos.sac_ae.sac_ae import SACAETrainer

        build = __import__(f"sheeprl_tpu_torch.algos.{name}.agent", fromlist=["build_agent"]).build_agent
        act_dim = int(np.prod(action_space.shape))
        if name == "sac_ae":
            agent = build(fabric, act_dim, pcfg, obs_space, state["agent"])
        else:
            agent = build(fabric, act_dim, pcfg, int(sum(np.prod(obs_space[k].shape)
                                                         for k in pcfg.algo.mlp_keys.encoder)), state["agent"])
        trainer = SACAETrainer if name == "sac_ae" else SACTrainer
        opts = trainer.build_optimizers(pcfg, agent, saved)
        return {g: (agent if g == "alpha" else getattr(agent, g)) for g in opts}, opts
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers
    from sheeprl_tpu_torch.algos.p2e_utils import p2e_optimizers

    mods = {"dreamer_v3": "dreamer_v3.agent", "p2e_dv3_exploration": "p2e_dv3.p2e_dv3_exploration",
            "dreamer_v2": "dreamer_v2.dreamer_v2", "p2e_dv2_exploration": "p2e_dv2.p2e_dv2_exploration",
            "dreamer_v1": "dreamer_v1.agent", "p2e_dv1_exploration": "p2e_dv1.p2e_dv1_exploration"}
    build = __import__(f"sheeprl_tpu_torch.algos.{mods[name]}", fromlist=["build_agent"]).build_agent
    dims, cont = spaces_to_dims(action_space)
    modules = build(fabric, dims, cont, pcfg, obs_space, state["agent"])
    opts = (p2e_optimizers if name.startswith("p2e") else build_dv3_optimizers)(pcfg, modules, saved)
    flat = {g: (modules["critics_exploration"][g.split(".", 1)[1]]["critic"] if g.startswith("critics_exploration.")
                else modules[g]) for g in opts}
    return flat, opts


def _step_both(family, snap, with_opt_state=True):
    """One more step of every optimizer on both sides, on the same random
    gradients.  Returns ``[(group, name, port change, JAX change)]``."""
    step, jcfg, params, groups, opt = snap
    pcfg = compose([*_recipe(family), f"checkpoint.resume_from={step}"])
    state = load_resume_state(step, pcfg)
    modules, opts = _port_optimizers(pcfg, state, with_opt_state)
    out = []
    for g, (path, chain) in groups.items():
        sub = _get(params, path)
        grads = _grads(sub, 7)
        updates, _ = chain.update(grads, opt[g], sub)
        j_delta = jax.tree.map(lambda u: np.asarray(u, np.float32), updates)
        converted = state["opt_state"] if g is None else state["opt_state"][g]
        assert isinstance(converted, OptaxState)
        p_grads = converted.convert(jax.tree.map(np.asarray, grads))
        j_delta = converted.convert(j_delta)
        o = opts[g]
        named = dict(zip(o.names, o.params))
        if set(p_grads) == {None}:
            p_grads = {o.names[0]: p_grads[None]}
            j_delta = {o.names[0]: j_delta[None]}
        before = {n: p.detach().clone() for n, p in named.items()}
        for n, p in named.items():
            p.grad = p_grads[n].reshape(p.shape).clone() if p.requires_grad else None
        o.step()
        for n, p in named.items():
            if p.requires_grad:
                out.append((g, n, (p.detach() - before[n]).numpy(), j_delta[n].reshape(p.shape).numpy()))
    return out


def _close(pairs):
    """Whether every change agrees to 1e-4 of its group's largest change + 1e-7."""
    scale = {}
    for g, _, _, j in pairs:
        scale[g] = max(scale.get(g, 0.0), float(np.abs(j).max()))
    worst = max(float(np.abs(p - j).max() - 1e-4 * scale[g] - 1e-7) for g, _, p, j in pairs)
    return worst <= 0.0, worst


@pytest.mark.parametrize("family", list(FAMILIES))
def test_resumed_optimizers_take_jax_next_step(family, snapshots):
    snap = snapshots(family)
    ok, worst = _close(_step_both(family, snap))
    assert ok, f"{family}: a change misses JAX's by {worst} beyond the tolerance"
    ok_control, _ = _close(_step_both(family, snap, with_opt_state=False))
    assert not ok_control, f"{family}: the step without the optimizer state agrees too"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_counters_and_generators_carry_over(family, snapshots):
    step = snapshots(family)[0]
    pcfg = compose(_recipe(family))
    update, per = FAMILIES[family][1:]
    state = load_resume_state(step, pcfg)
    assert {k: state[k] for k in ("policy_step", "update", "last_checkpoint", "grad_steps")} == {
        "policy_step": update * per, "update": update, "last_checkpoint": update * per, "grad_steps": GRAD_STEPS}
    assert state["ratio"]["prev"] == float(update * per)
    seeds = state["generator_seeds"]
    words = np.asarray(jax.random.PRNGKey(5))
    assert seeds["train"] == (int(words[0]) << 32) | int(words[1])
    assert seeds["train"] != seeds["player"]
    # the agent is the JAX agent, converted (Moments, targets, log_alpha among it)
    want = agent_from_jax(load_step_dir(step)["agent"], pcfg)
    assert set(state["agent"]) == set(want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cli_run_continues_the_jax_snapshot(family, snapshots, tmp_path):
    from sheeprl_tpu_torch.cli import run

    step = snapshots(family)[0]
    update, per = FAMILIES[family][1:]
    total = (update + 1) * per  # one more update: the fewest that show the counters going on
    run([*_recipe(family), f"checkpoint.resume_from={step}", f"algo.total_steps={total}", f"log_dir={tmp_path}",
         "checkpoint.every=1000000", "algo.run_test=False"])
    (last,) = sorted(glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True))[-1:]
    saved = load_step_dir(last)
    assert saved["policy_step"] == total and saved["update"] == update + 1
    if "grad_steps" in saved:
        assert saved["grad_steps"] >= GRAD_STEPS
    (metrics,) = glob.glob(f"{tmp_path}/**/metrics.csv", recursive=True)
    steps = [int(line.split(",")[0]) for line in pathlib.Path(metrics).read_text().splitlines()[1:]]
    assert steps and min(steps) > update * per  # nothing logged before the snapshot's step


# -- populations ----------------------------------------------------------------------
POP_COMMON = ["env=jax_cartpole", "population.size=2", "population.exploit_every=2", "population.warmup=1",
              "env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.mlp_keys.encoder=[state]",
              "algo.dense_units=8", "algo.mlp_layers=1", "algo.encoder.dense_units=8", "algo.encoder.mlp_layers=1",
              "algo.encoder.mlp_features_dim=8", "algo.max_grad_norm=0.5", "fabric.accelerator=cpu",
              "env.sync_env=True", "env.capture_video=False"]
POPULATIONS = {
    "ppo": ["exp=ppo", *POP_COMMON, "algo.update_epochs=1"],
    "a2c-rmsprop-centered-momentum": ["exp=a2c", *POP_COMMON, "algo.optimizer.name=rmsprop",
                                      "algo.optimizer.momentum=0.9", "algo.optimizer.centered=True"],
}
POP_SIZE = 2
POP_FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "jax_ppo_population"


def _stacked(tree, convert=policy_state_from_jax):
    """A stacked ``(P, ...)`` flax tree → the port's stacked state, member by member."""
    members = [convert(jax.tree.map(lambda x: np.asarray(x)[m], tree)) for m in range(POP_SIZE)]
    return {k: torch.stack([mm[k] for mm in members]) for k in members[0]}


def _population_snapshot(root, family, steps=3):
    """A population snapshot the JAX package's checkpoint code commits: two
    members drawn apart, their vmapped optax state after ``steps`` steps on
    random gradients at one learning rate each (the injected rate, as the
    population phase sets it), and a PBT carry."""
    from sheeprl_tpu.utils.optim import set_learning_rate

    jcfg = jax_compose(POPULATIONS[family])
    params = jax.tree.map(lambda *m: jnp.stack(m), *(_jax_agent(jcfg, seed=m) for m in range(POP_SIZE)))
    chain = jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    lr = float(jcfg.algo.optimizer.lr) * np.array([0.5, 2.0], np.float32)
    opt = set_learning_rate(jax.vmap(chain.init)(params), lr)
    for s in range(steps):
        updates, opt = jax.vmap(chain.update)(_grads(params, 100 * s), opt, params)
        params = optax.apply_updates(params, updates)
    hp = {"lr": lr, "ent_coef": np.array([0.01, 0.02], np.float32)}
    if family == "ppo":
        hp["clip_coef"] = np.array([0.1, 0.3], np.float32)
    population = {"fitness": np.array([1.5, -0.5], np.float32), "ep_count": np.array([3, 4], np.int32),
                  "exploits": np.array(2, np.int32), "hp": hp}
    state = {"agent": params, "opt_state": opt, "key": jax.random.PRNGKey(5), "player_key": jax.random.key(6),
             "policy_step": 64, "update": 2, "last_log": 0, "last_checkpoint": 64, "population": population}
    step = _write_jax_state(pathlib.Path(root) / family, jcfg, state, 64)
    return params, opt, population, step


@pytest.fixture(scope="module")
def population_snapshots(tmp_path_factory):
    root, cache = _shared_dir(tmp_path_factory, "jax_population"), {}

    def get(family):
        if family not in cache:
            params, opt, population, step = _built_once(root, family, lambda r: _population_snapshot(r, family))
            jcfg = jax_compose(POPULATIONS[family])
            cache[family] = (step, jcfg, params, jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm),
                             opt, population)
        return cache[family]

    return get


def _population_step(family, snap, with_opt_state=True):
    """One more step of the stacked optimizer on both sides, on the same
    random gradients: ``[(None, name, port change, JAX change)]``."""
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu_torch.population.members import StackedAgent, StackedOptimizer
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    step, _, params, chain, opt, _ = snap
    pcfg = compose([*POPULATIONS[family], f"checkpoint.resume_from={step}"])
    state = load_resume_state(step, pcfg)
    obs_space, act_space = probe_spaces(pcfg)
    dims, cont = spaces_to_dims(act_space)
    agent = StackedAgent(build_agent(build_fabric(pcfg), dims, cont, pcfg, obs_space), POP_SIZE, state["agent"])
    optimizer = StackedOptimizer(agent.params, pcfg.algo.optimizer, pcfg.algo.max_grad_norm)
    if with_opt_state:
        optimizer.load_state_dict(state["opt_state"])
    grads = _grads(params, 7)
    updates, _ = jax.vmap(chain.update)(grads, opt, params)
    p_grads, j_delta = _stacked(grads), _stacked(updates)
    before = {n: p.detach().clone() for n, p in agent.params.items()}
    optimizer.step([p_grads[n] for n in agent.params], state["population"]["hp"]["lr"])
    return [(None, n, (p.detach() - before[n]).numpy(), j_delta[n].numpy()) for n, p in agent.params.items()]


@pytest.mark.parametrize("family", list(POPULATIONS))
def test_resumed_population_optimizers_take_jax_next_step(family, population_snapshots):
    snap = population_snapshots(family)
    ok, worst = _close(_population_step(family, snap))
    assert ok, f"{family}: a member's change misses JAX's by {worst} beyond the tolerance"
    ok_control, _ = _close(_population_step(family, snap, with_opt_state=False))
    assert not ok_control, f"{family}: the step without the optimizer state agrees too"


@pytest.mark.parametrize("family", list(POPULATIONS))
def test_a_jax_population_carry_is_resumed(family, population_snapshots):
    step, _, params, _, opt, population = population_snapshots(family)
    state = load_resume_state(step, compose(POPULATIONS[family]))
    assert (state["policy_step"], state["update"]) == (64, 2)
    for k in ("fitness", "ep_count", "exploits"):
        np.testing.assert_array_equal(state["population"][k].numpy(), population[k], err_msg=k)
    assert state["population"]["hp"].keys() == population["hp"].keys()
    for k, v in population["hp"].items():
        np.testing.assert_array_equal(state["population"]["hp"][k].numpy(), v, err_msg=k)
    for n, v in _stacked(params).items():
        torch.testing.assert_close(state["agent"][n], v, rtol=0, atol=0, msg=n)
    counts = [np.asarray(x) for x in jax.tree.leaves(opt) if np.shape(x) == (POP_SIZE,)
              and np.asarray(x).dtype == np.int32]
    want_count = counts[0] if family == "ppo" else np.zeros(POP_SIZE)  # Adam counts, the RMSprops do not
    np.testing.assert_array_equal(state["opt_state"]["count"].numpy(), want_count)


def test_a_jax_population_snapshot_resumes(tmp_path):
    """``cli.run`` resumes the committed JAX population (P = 4, PPO) for two
    more population phases: the counters, the exploits and every member's
    episodes go on from the snapshot; the phase exploits once more
    (``exploit_every=2``)."""
    import sys

    from sheeprl_tpu_torch.cli import run

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from tools.write_jax_population_fixture import NUM_ENVS, POPULATION_OVERRIDES, ROLLOUT, SIZE

    (step,) = POP_FIXTURE.glob("checkpoint/step_*")
    saved = load_step_dir(step)
    total = int(saved["policy_step"]) + 2 * SIZE * NUM_ENVS * ROLLOUT
    run([*POPULATION_OVERRIDES, f"checkpoint.resume_from={step}", f"algo.total_steps={total}",
         f"log_dir={tmp_path}", "metric/logger=csv"])
    (last,) = sorted(glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True))[-1:]
    resumed = load_step_dir(last)
    assert resumed["policy_step"] == total and resumed["update"] == saved["update"] + 2
    pop, before = resumed["population"], saved["population"]
    assert int(pop["exploits"]) == int(before["exploits"]) + 1
    assert bool((pop["ep_count"].numpy() >= before["ep_count"]).all()) and int(pop["ep_count"].sum()) > int(
        before["ep_count"].sum())
    assert pop["fitness"].shape == (SIZE,) and bool(torch.isfinite(pop["fitness"]).all())


# -- DreamerV3: the first whole update ----------------------------------------------
def test_dreamer_v3_first_update_matches_jax_from_the_snapshot(snapshots):
    """From the same JAX-written snapshot, the port's first update (world
    model, behaviour, target critic) on a fixed replay block with JAX's
    draws against JAX's ``make_train_phase``: the metrics to 1e-5
    relative; each module's parameter change to 2e-2 of its L2 norm
    (Adam's normalised step amplifies fp32 rounding where a moment is near
    zero); without the Adam state the change misses by far more."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_build_agent
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers as jax_build_opts
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_phase as jax_make_train_phase
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3Trainer, blocks_to_device, build_dv3_optimizers
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from tests.test_torch_train_step import _block, _noise_from_keys

    step, jcfg, params, _, opt = snapshots("dreamer_v3")
    pcfg = compose(_recipe("dreamer_v3"))
    obs_space, action_space = jax_probe_spaces(jcfg)
    dims, cont = jax_spaces_to_dims(action_space)
    cnn_keys, mlp_keys = ("rgb",), ("state",)
    block = _block(np.random.default_rng(7), 1, True, dims, cont)
    key = jax.random.PRNGKey(11)
    S, D = pcfg.algo.world_model.stochastic_size, pcfg.algo.world_model.discrete_size
    blocks = blocks_to_device(block, cnn_keys, mlp_keys, "cpu")

    start = agent_from_jax(jax.tree.map(np.array, params), pcfg)
    jfabric = jax_build_fabric(jcfg)  # the phase donates its inputs: hand it copies
    world_model, actor, critic, jparams = jax_build_agent(jfabric, dims, cont, jcfg, obs_space,
                                                          jax.tree.map(jnp.array, params))
    wm_opt, actor_opt, critic_opt, _ = jax_build_opts(jfabric, jcfg, jparams)
    phase = jax_make_train_phase(jfabric, jcfg, world_model, actor, critic, wm_opt, actor_opt, critic_opt,
                                 cnn_keys=cnn_keys, mlp_keys=mlp_keys, is_continuous=cont)
    new_params, _, j_metrics = phase(jparams, jax.tree.map(jnp.array, _opt_layout(opt)),
                                     {k: jnp.asarray(v.numpy()) for k, v in blocks.items()}, key, jnp.int32(GRAD_STEPS))
    j_after = agent_from_jax(jax.tree.map(np.array, new_params), pcfg)

    def port_update(with_opt_state):
        state = load_resume_state(step, pcfg)
        modules = build_agent(build_fabric(pcfg), dims, cont, pcfg, probe_spaces(pcfg)[0], state["agent"])
        opts = build_dv3_optimizers(pcfg, modules, state["opt_state"] if with_opt_state else None)
        trainer = DV3Trainer(pcfg, modules, opts, cnn_keys, mlp_keys, cont, state["agent"])
        metrics = trainer.train_phase(blocks, _noise_from_keys(key, 1, dims, cont, S, D), GRAD_STEPS)
        return trainer, np.array([float(m) for m in metrics])

    def gaps(trainer):
        out = {}
        for name in ("world_model", "actor", "critic"):
            p_state = trainer.modules()[name].state_dict()
            jd = np.concatenate([(j_after[name][k] - start[name][k]).numpy().ravel() for k in j_after[name]])
            pd = np.concatenate([(p_state[k].detach() - start[name][k]).numpy().ravel() for k in j_after[name]])
            out[name] = float(np.linalg.norm(pd - jd) / np.linalg.norm(jd))
        return out

    trainer, p_metrics = port_update(True)
    np.testing.assert_allclose(p_metrics, np.array([float(m) for m in j_metrics]), rtol=1e-5, atol=2e-5)
    resumed = gaps(trainer)
    assert max(resumed.values()) < 2e-2, resumed
    control = gaps(port_update(False)[0])
    assert min(control.values()) > 10 * 2e-2, control
    for k in ("low", "high"):
        np.testing.assert_allclose(float(trainer.moments[k]), float(j_after["moments"][k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["uniform", "sequential"])
def test_a_saved_replay_buffer_is_carried_over(layout):
    """With ``buffer.checkpoint=True`` the JAX loops save their host ring
    (SAC's ``ReplayBuffer``, the Dreamer family's
    ``EnvIndependentReplayBuffer``): the resumed state hands it on, and the
    port's ring loads it with the same rows and cursors."""
    from sheeprl_tpu.data import buffers as jax_buffers
    from sheeprl_tpu_torch.convert import resume_state_from_jax
    from sheeprl_tpu_torch.data import buffers

    rng = np.random.default_rng(3)
    rows = {"obs": rng.standard_normal((5, 2, 4)).astype(np.float32),
            "rewards": rng.standard_normal((5, 2, 1)).astype(np.float32)}
    if layout == "uniform":
        jax_rb, port_rb = jax_buffers.ReplayBuffer(8, 2), buffers.ReplayBuffer(8, 2)
    else:
        jax_rb = jax_buffers.EnvIndependentReplayBuffer(8, n_envs=2, buffer_cls=jax_buffers.SequentialReplayBuffer)
        port_rb = buffers.EnvIndependentReplayBuffer(8, n_envs=2, buffer_cls=buffers.SequentialReplayBuffer)
    jax_rb.add(rows)
    family = "sac" if layout == "uniform" else "dreamer_v3"
    jcfg = jax_compose(_recipe(family))
    state = resume_state_from_jax({"agent": jax.tree.map(np.asarray, _jax_agent(jcfg)), "rb": jax_rb.state_dict()},
                                  compose(_recipe(family)))
    port_rb.load_state_dict(state["rb"])
    assert port_rb.state_dict().keys() == jax_rb.state_dict().keys()
    np.testing.assert_equal(jax.tree.map(np.asarray, port_rb.state_dict()), jax.tree.map(np.asarray, jax_rb.state_dict()))


def _write_jax_state(root, jcfg, state, step):
    """``state`` committed as the JAX package commits a step directory."""
    from sheeprl_tpu.checkpoint.protocol import step_dir_name, write_commit, write_shard
    from sheeprl_tpu.checkpoint.serialize import snapshot_tree, to_host_tree

    version = pathlib.Path(root) / "version_0"
    (version / "checkpoint").mkdir(parents=True)
    (version / "config.yaml").write_text(yaml.safe_dump(jcfg.as_dict()))
    path = version / "checkpoint" / step_dir_name(step)
    write_shard(path, 0, to_host_tree(snapshot_tree(state)))
    assert write_commit(path, step, 1, timeout_s=10.0)
    return path


def test_sac_first_update_matches_jax_from_the_snapshot(tmp_path):
    """SAC's first whole update after a resume (critic, actor, temperature,
    the target EMA) on a fixed batch and JAX's draws, against JAX's
    ``make_sac_train_fns`` phase from the same snapshot (three updates in):
    every parameter within ``test_torch_sac.py``'s 1e-5 absolute and the
    losses within 1e-5 relative; without the Adam states the parameters miss
    that tolerance."""
    from sheeprl_tpu.algos.sac import agent as jax_agent
    from sheeprl_tpu.algos.sac.sac import make_sac_train_fns
    from sheeprl_tpu_torch.algos.sac import agent as pt_agent
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer
    from tests.test_torch_sac import (
        ACT_DIM,
        OBS_DIM,
        PARAM_TOL,
        SAC,
        action_noise,
        draw_batches,
        jax_optimizers,
        jax_update_keys,
        plain_apply,
    )

    jcfg, pcfg = jax_compose(SAC), compose(SAC)
    actor, critic, params = jax_agent.build_agent(jax_build_fabric(jcfg), ACT_DIM, jcfg, OBS_DIM)
    opts, o_state = jax_optimizers(jcfg, jax.device_get(params))
    _, train_phase = make_sac_train_fns(actor, critic, plain_apply, *opts, jcfg, ACT_DIM)

    def jax_phase(p, o, batches, k, step0):
        copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731 - the phase donates its inputs
        return train_phase(copy(p), copy(o), {n: jnp.asarray(v) for n, v in batches.items()}, k, jnp.int32(step0))

    params, o_state, _ = jax_phase(params, o_state, draw_batches(3, 8, seed=1), jax.random.PRNGKey(1), 0)
    params, o_state = jax.device_get(params), jax.device_get(o_state)
    step = _write_jax_state(tmp_path, jcfg, {"agent": params, "opt_state": o_state, "key": jax.random.PRNGKey(4),
                                             "player_key": jax.random.key(5), "policy_step": 24, "update": 12,
                                             "grad_steps": 3}, 24)
    batches, k = draw_batches(1, 8, seed=2), jax.random.PRNGKey(3)
    new_params, _, want = jax_phase(params, o_state, batches, k, 3)
    want_state = sac_state_from_jax(jax.device_get(new_params))
    noise = [{"next": action_noise(kn, 8), "pi": action_noise(kp, 8)} for kn, kp, *_ in jax_update_keys(k, 1)]

    def port(with_opt_state):
        state = load_resume_state(step, compose([*SAC, f"checkpoint.resume_from={step}"]))
        agent = pt_agent.build_agent(build_fabric(pcfg), ACT_DIM, pcfg, OBS_DIM, state["agent"])
        trainer = SACTrainer(pcfg, agent, SACTrainer.build_optimizers(
            pcfg, agent, state["opt_state"] if with_opt_state else None), ACT_DIM)
        losses = trainer.train_phase({n: torch.from_numpy(v) for n, v in batches.items()}, noise, 3)
        return agent.state_dict(), [float(x) for x in losses]

    got, losses = port(True)
    np.testing.assert_allclose(losses, [float(x) for x in want], rtol=1e-5, atol=1e-7)
    for name, v in want_state.items():
        np.testing.assert_allclose(got[name].detach().numpy(), v.numpy(), err_msg=name, **PARAM_TOL)
    control, _ = port(False)
    assert any(not np.allclose(control[n].detach().numpy(), v.numpy(), rtol=PARAM_TOL["rtol"], atol=PARAM_TOL["atol"])
               for n, v in want_state.items())


def test_ppo_first_phase_matches_jax_from_the_snapshot(tmp_path, monkeypatch):
    """PPO's first whole train phase after a resume (two epochs of two
    minibatches: four clipped Adam steps) on a fixed rollout and JAX's
    permutations, against the JAX ``main``'s own train phase from the same
    snapshot (one phase in): the losses within ``test_torch_ppo.py``'s
    tolerance and every parameter within its 1e-5 absolute; without the Adam
    state the parameters miss it."""
    from sheeprl_tpu_torch.algos.ppo import agent as pt_agent
    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
    from sheeprl_tpu_torch.utils.optim import build_optimizer
    from tests.test_torch_ppo import (
        BASE,
        PARAM_TOL,
        TRAIN_CASES,
        T,
        B,
        _t,
        assert_losses_match,
        capture_jax_train_phase,
        draw_params,
        jax_agent,
        jax_epoch_permutation,
        jax_ppo_main,
        rollout_from_seed,
    )

    overrides = (*BASE, *TRAIN_CASES["continuous"])
    jfn, jcfg, jfabric, obs_space, act_space = capture_jax_train_phase(jax_ppo_main, overrides, tmp_path, monkeypatch)
    dims, cont = jax_spaces_to_dims(act_space)
    keys = tuple(jcfg.algo.mlp_keys.encoder)
    agent, init = jax_agent.build_agent(jfabric, dims, cont, jcfg, obs_space)
    dist_type = jcfg.get("distribution", {}).get("type", "auto")

    def rollout(seed, params):
        r, last, rng = rollout_from_seed(seed, obs_space, keys, (), dims, cont, T, B)
        out, _ = jax.jit(agent.apply)(params, {k: r[k].reshape(T * B, *r[k].shape[2:]) for k in keys})
        lp, _ = jax_agent.evaluate_actions(out, r["actions"].reshape(T * B, -1), dims, cont, dist_type)
        r["logprobs"] = (np.asarray(lp).reshape(T, B) + 0.3 * rng.standard_normal((T, B))).astype(np.float32)
        return r, last

    def jax_phase(params, opt_state, r, last, key):
        copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731
        return jfn(copy(params), copy(opt_state), r, last, key, jnp.float32(0.2), jnp.float32(0.01), batch_size=8,
                   num_minibatches=2)

    params = draw_params(init)
    optimizer = jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    r0, last0 = rollout(1, params)
    params, opt_state, _ = jax_phase(params, optimizer.init(params), r0, last0, jax.random.PRNGKey(5))
    params, opt_state = jax.device_get(params), jax.device_get(opt_state)
    step = _write_jax_state(tmp_path / "run", jcfg, {"agent": params, "opt_state": opt_state, "update": 1,
                                                     "policy_step": T * B, "key": jax.random.PRNGKey(6)}, T * B)
    r1, last1 = rollout(2, params)
    key = jax.random.PRNGKey(11)
    want_params, _, want_losses = jax_phase(params, opt_state, r1, last1, key)
    want = policy_state_from_jax(jax.device_get(want_params))
    perms = [_t(np.asarray(jax_epoch_permutation(k, T, B, 8, 2, False, 1)))
             for k in jax.random.split(key, int(jcfg.algo.update_epochs))]

    def port(with_opt_state):
        cfg = compose([*overrides, f"checkpoint.resume_from={step}"])
        state = load_resume_state(step, cfg)
        module = pt_agent.build_agent(build_fabric(cfg), dims, cont, cfg, obs_space, state["agent"])
        opt = build_optimizer(module.named_parameters(), cfg.algo.optimizer, cfg.algo.max_grad_norm)
        if with_opt_state:
            opt.load_state_dict(state["opt_state"])
        trainer = PPOTrainer(cfg, module, opt, keys, dims, cont, T, B)
        losses = trainer.train_phase({k: _t(v) for k, v in r1.items()}, {k: _t(v) for k, v in last1.items()}, perms,
                                     0.2, 0.01)
        return module.state_dict(), losses

    got, losses = port(True)
    assert_losses_match(losses, want_losses)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), v.numpy(), err_msg=name, **PARAM_TOL)
    control, _ = port(False)
    assert any(not np.allclose(control[n].detach().numpy(), v.numpy(), rtol=PARAM_TOL["rtol"], atol=PARAM_TOL["atol"])
               for n, v in want.items())
