"""The port's population training against the JAX package's, on the CPU.

The JAX side is the package's own: ``sheeprl_tpu/population/core.py`` and
the live ``make_population_phase`` closure of ``sheeprl_tpu/algos/ppo``'s
``main``, captured where ``main`` hands it to ``fabric.compile`` (as
``tests/test_torch_anakin.py`` captures the Anakin phase).  Both sides start
from one numpy-drawn parameter tree tiled over the members and one JAX env
state per member; the port is handed what the JAX keys draw: every member's
action noise, reset draws and minibatch orders, and the explore factors.

Tolerances are the train-phase tiers of ``tests/test_torch_ppo.py`` (the
parameters 1e-5 absolute, losses 1e-5 relative; ``tests/test_regression/
DRIFT.md``): Adam's moments 1e-5 relative + 1e-7 absolute beside them;
fitness, episode counts, exploits, discrete actions and everything PBT
selects or copies exactly.
"""

import json
import os
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import population as jpop
from sheeprl_tpu.algos.a2c.a2c import main as jax_a2c_main
from sheeprl_tpu.algos.ppo import agent as jax_ppo_agent
from sheeprl_tpu.algos.ppo.ppo import epoch_permutation as jax_epoch_permutation
from sheeprl_tpu.algos.ppo.ppo import main as jax_ppo_main
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.envs.jax import anakin as jax_anakin
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu.utils.structured import dotdict as jdotdict
from sheeprl_tpu_torch import population as pop
from sheeprl_tpu_torch.algos.a2c.a2c import A2CTrainer
from sheeprl_tpu_torch.algos.ppo.agent import build_agent, sample_actions
from sheeprl_tpu_torch.algos.ppo.population import NO_ANAKIN, PopulationRoute
from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import env_state_from_jax, policy_state_from_jax
from sheeprl_tpu_torch.envs.device import VectorDeviceEnv, env_from_cfg
from sheeprl_tpu_torch.envs.device.anakin import make_rollout_fn
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.population.members import StackedAgent, StackedOptimizer
from sheeprl_tpu_torch.utils.optim import build_optimizer
from sheeprl_tpu_torch.utils.structured import dotdict
from tests.test_torch_anakin import COMMON, ENVS, Side, assert_env_states_match
from tests.test_torch_ppo import LOSS_RTOL, PARAM_TOL, _Captured, draw_params

T, B, P = 8, 4, 3
MOMENT_TOL = dict(rtol=1e-5, atol=1e-7)
POPULATION = (f"population.size={P}", "population.exploit_every=2", "population.warmup=1")
CASES = {
    # id: (JAX main, port trainer, overrides)
    "ppo": (jax_ppo_main, PPOTrainer, ("exp=ppo", *ENVS["cartpole"], "algo.per_rank_batch_size=12",
                                       "algo.update_epochs=2", "algo.ent_coef=0.01", "algo.max_grad_norm=0.5")),
    "a2c": (jax_a2c_main, A2CTrainer, ("exp=a2c", *ENVS["cartpole"], "algo.optimizer.eps=0.1",
                                       "algo.ent_coef=0.01", "algo.max_grad_norm=0.5")),
}
BASE = {"lr": 1e-3, "ent_coef": 0.01}


def _t(a):
    return torch.from_numpy(np.array(a))


def _pbt_pop(**over):
    p = dict(size=4, exploit_every=2, warmup=0, frac=0.25, perturb_min=0.8, perturb_max=1.25, init_min=0.5,
             init_max=2.0, bound_min=0.05, bound_max=20.0, fitness_alpha=0.3, levels=None)
    p.update(over)
    return p


def _configs(**over):
    """The same ``population`` group as JAX's and the port's ``PBTConfig``."""
    p = _pbt_pop(**over)
    return (jpop.PBTConfig.from_cfg(jdotdict({"population": p}), base=dict(BASE)),
            pop.PBTConfig.from_cfg(dotdict({"population": p}), base=dict(BASE)))


def jax_factors(key, names, jpbt):
    """The explore factors JAX's ``pbt_exploit_explore`` draws from ``key``."""
    return {name: _t(jnp.exp(jax.random.uniform(jax.random.fold_in(key, i), (jpbt.size,),
                                                minval=jnp.log(jpbt.perturb_min), maxval=jnp.log(jpbt.perturb_max))))
            for i, name in enumerate(sorted(names))}


# -- PBTConfig ---------------------------------------------------------------------
@pytest.mark.parametrize("over, match", [
    ({"size": 1}, "size"), ({"frac": 0.9}, "frac"), ({"frac": 0.0}, "frac"),
    ({"perturb_min": 1.5, "perturb_max": 1.2}, "perturb"), ({"init_min": 0.0}, "init_min"),
    ({"bound_min": 2.0, "bound_max": 1.0}, "bound_min"), ({"fitness_alpha": 0.0}, "fitness_alpha"),
])
def test_config_rejects_what_jax_rejects(over, match):
    with pytest.raises(ValueError, match=match) as jax_err:
        jpop.PBTConfig.from_cfg(jdotdict({"population": _pbt_pop(**over)}), base=dict(BASE))
    with pytest.raises(ValueError, match=match) as port_err:
        pop.PBTConfig.from_cfg(dotdict({"population": _pbt_pop(**over)}), base=dict(BASE))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("size, frac, n", [(4, 0.25, 1), (8, 0.5, 4), (2, 0.5, 1), (3, 0.25, 1), (16, 0.25, 4),
                                           (5, 0.5, 2)])
def test_n_select_clamps_to_half(size, frac, n):
    jpbt, pbt = _configs(size=size, frac=frac)
    assert pbt.n_select == jpbt.n_select == n


def test_init_hyperparams_are_seeded_and_bounded():
    _, pbt = _configs(size=8, init_min=0.1, init_max=50.0, bound_min=0.5, bound_max=2.0)
    a, b = (pbt.init_hyperparams(torch.Generator().manual_seed(3)) for _ in range(2))
    c = pbt.init_hyperparams(torch.Generator().manual_seed(4))
    for name, base in BASE.items():
        assert a[name].shape == (8,) and a[name].dtype == torch.float32
        assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
        assert (a[name] >= base * 0.5 * (1 - 1e-6)).all() and (a[name] <= base * 2.0 * (1 + 1e-6)).all()


# -- exploit / explore -------------------------------------------------------------
def _stacks(size, fitness):
    params = {"w": np.arange(size * 3, dtype=np.float32).reshape(size, 3)}
    opt_state = {"mu": np.arange(size, dtype=np.float32) * 10.0, "nu": np.arange(size, dtype=np.float32) * 100.0}
    return params, opt_state, np.asarray(fitness, np.float32)


@pytest.mark.parametrize("size, frac, fitness", [
    (4, 0.25, [3.0, 0.5, 2.0, 1.0]),
    (6, 0.5, [0.1, 4.0, 4.0, -2.0, 3.0, 0.5]),  # ties: the stable order
    (5, 0.4, [1.0, 1.0, 1.0, 1.0, 1.0]),  # no fitness yet: index order
])
@pytest.mark.parametrize("gate", [True, False], ids=["open", "closed"])
def test_exploit_explore_matches_jax(size, frac, fitness, gate):
    jpbt, pbt = _configs(size=size, frac=frac)
    params, opt_state, fit = _stacks(size, fitness)
    hp = jpbt.init_hyperparams(jax.random.PRNGKey(11))
    key = jax.random.PRNGKey(5)
    j_params, j_opt, j_hp, j_fit, j_n = jpop.pbt_exploit_explore(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt_state), hp, jnp.asarray(fit),
        jnp.asarray(gate), key, jpbt)

    p_params = [_t(params["w"])]
    p_opt = [_t(opt_state["mu"]), _t(opt_state["nu"])]
    p_hp = {k: _t(v) for k, v in hp.items()}
    p_fit = _t(fit)
    before = [t.clone() for t in (*p_params, *p_opt)]
    n = pop.pbt_exploit_explore(p_params, p_opt, p_hp, p_fit, torch.tensor(gate), jax_factors(key, hp, jpbt), pbt)
    assert int(n) == int(j_n) == (pbt.n_select if gate else 0)
    # copies are copies: parameters, moments and fitness bit for bit
    assert torch.equal(p_params[0], _t(j_params["w"]))
    assert torch.equal(p_opt[0], _t(j_opt["mu"])) and torch.equal(p_opt[1], _t(j_opt["nu"]))
    assert torch.equal(p_fit, _t(j_fit))
    for name in hp:
        np.testing.assert_allclose(p_hp[name].numpy(), np.asarray(j_hp[name]), rtol=1e-6, err_msg=name)
        base = BASE[name]
        assert (p_hp[name] >= base * pbt.bound_min * (1 - 1e-6)).all()
        assert (p_hp[name] <= base * pbt.bound_max * (1 + 1e-6)).all()
    if not gate:  # the closed gate is a bitwise no-op
        assert all(torch.equal(a, b) for a, b in zip(before, (*p_params, *p_opt)))
        for name in hp:
            assert torch.equal(p_hp[name], _t(hp[name]))
    else:  # one source index for parameters and moments alike
        src = [int(np.flatnonzero(np.all(np.asarray(j_params["w"])[m] == params["w"], axis=1))[0])
               for m in range(size)]
        assert [int(np.flatnonzero(opt_state["mu"] == float(p_opt[0][m]))[0]) for m in range(size)] == src


def test_perturbation_stays_within_bounds():
    _, pbt = _configs(size=8, frac=0.5, perturb_min=0.5, perturb_max=3.0, bound_min=0.5, bound_max=2.0)
    gen = torch.Generator().manual_seed(1)
    hp = pbt.init_hyperparams(gen)
    fitness = torch.arange(8.0)
    for _ in range(5):
        pop.pbt_exploit_explore([torch.zeros(8, 3)], [torch.zeros(8)], hp, fitness, torch.tensor(True),
                                pop.perturbation_factors(pbt, hp, gen), pbt)
        for name, base in BASE.items():
            assert (hp[name] >= base * 0.5 * (1 - 1e-6)).all() and (hp[name] <= base * 2.0 * (1 + 1e-6)).all()


def test_exploit_gate_follows_the_update_counter():
    """JAX's toy phase: cadence 2, warmup 5, the exploits at updates 6 and 8
    only, and the member with the lowest lr copied up."""
    _, pbt = _configs(exploit_every=2, warmup=5)
    w, mu = torch.zeros(pbt.size, 3), torch.zeros(pbt.size)
    members = {"update": torch.zeros(pbt.size, dtype=torch.int32), "ep_ret": torch.zeros(3)}
    carry = pop.init_population_state(members, pbt, num_envs=3)
    hp = pbt.init_hyperparams(torch.Generator().manual_seed(2))
    lr0 = hp["lr"].clone()

    def member_phase(members, hp, draws):
        stats = {"ep_done": torch.ones(2, pbt.size * 3, dtype=torch.bool),
                 "ep_ret": (hp["lr"] * 1e3).repeat_interleave(3).expand(2, -1)}
        return {**members, "update": members["update"] + 1}, torch.zeros(pbt.size, 3), stats

    phase = pop.make_population_phase(member_phase, pbt, carry, hp, [w], lambda: [mu],
                                      torch.Generator().manual_seed(0))
    fired = []
    for update in range(1, 9):
        phase()
        if int(carry["exploits"]) > len(fired) * pbt.n_select:
            fired.append(update)
    assert fired == [6, 8]
    worst = int(lr0.argmin())
    assert float(hp["lr"][worst]) != float(lr0[worst])


# -- level curriculum --------------------------------------------------------------
class _Levelled(NamedTuple):
    level: jnp.ndarray


class _Static(NamedTuple):
    grid: jnp.ndarray


def test_level_curriculum_pins_levels_through_autoreset():
    """Member m's rows at ``levels[m % len(levels)]`` (JAX's (P, B) levels,
    member-major), kept through two autoresets of multiroom."""
    cfg = compose(["exp=ppo", "env=jax_multiroom", "env.max_episode_steps=3", "fabric.accelerator=cpu"])
    levels, n = [0.0, 1.0], 2
    want = np.asarray(jpop.apply_level_curriculum(_Levelled(jnp.zeros((P, n))), levels, P, n).level).reshape(-1)

    venv = VectorDeviceEnv(env_from_cfg(cfg), P * n, "cpu", torch.Generator().manual_seed(0))
    state = pop.apply_level_curriculum(venv.reset()[0], levels, P, n)
    assert torch.equal(state.level, _t(want))
    for _ in range(7):  # episodes of 3 steps: two autoresets
        state = venv.step(state, torch.zeros(P * n, dtype=torch.long))[0]
    assert torch.equal(state.level, _t(want))


def test_level_curriculum_refuses_a_static_level_env():
    cfg = compose(["exp=ppo", "env=jax_forage", "fabric.accelerator=cpu"])
    with pytest.raises(ValueError) as jax_err:
        jpop.apply_level_curriculum(_Static(jnp.zeros((1, 2))), [0.0, 1.0], 1, 2)
    state = VectorDeviceEnv(env_from_cfg(cfg), 2, "cpu", torch.Generator().manual_seed(0)).reset()[0]
    with pytest.raises(ValueError) as port_err:
        pop.apply_level_curriculum(state, [0.0, 1.0], 1, 2)
    assert str(port_err.value) == str(jax_err.value)


# -- whole population windows against JAX -------------------------------------------
def capture_jax_population_phase(jax_main, overrides, tmp_path, monkeypatch):
    """The raw population phase of a JAX on-policy ``main``, taken where
    ``main`` hands it to ``fabric.compile`` (``main`` stops there)."""
    monkeypatch.chdir(tmp_path)
    cfg = jax_compose([*overrides, "metric.log_level=0", f"log_dir={tmp_path}/jax"])
    fabric = jax_build_fabric(cfg)
    compile_ = type(fabric).compile
    captured = {}

    def spy(self, fn, *, name=None, **kwargs):
        if name is not None and name.endswith(".population_phase"):
            captured["fn"] = jax.jit(fn)
            raise _Captured
        return compile_(self, fn, name=name, **kwargs)

    monkeypatch.setattr(type(fabric), "compile", spy)
    with pytest.raises(_Captured):
        jax_main(fabric, cfg)
    monkeypatch.undo()
    return captured["fn"], cfg, fabric


class PopulationSides:
    """One population config on both sides: JAX's phase, stacked parameters,
    optimizer state, carry and hyperparameters; the port's
    :class:`PopulationRoute` started from the same values."""

    def __init__(self, case, tmp_path, monkeypatch, extra=()):
        jax_main, self.trainer_cls, extra_case = CASES[case]
        overrides = (*COMMON, *extra_case, *POPULATION, *extra)
        self.is_ppo = self.trainer_cls is PPOTrainer
        self.jfn, jcfg, jfabric = capture_jax_population_phase(jax_main, overrides, tmp_path, monkeypatch)
        self.side = side = Side(overrides)
        self.jcfg = jcfg
        a = jcfg.algo
        base = {"lr": float(a.optimizer.lr), "ent_coef": float(a.ent_coef)}
        if self.is_ppo:
            base["clip_coef"] = float(a.clip_coef)
        self.jpbt = jpop.PBTConfig.from_cfg(jcfg, base=base)
        self.jagent, init = jax_ppo_agent.build_agent(jfabric, side.actions_dim, side.cont, jcfg, side.obs_space)
        self.params = jpop.tile_stack(draw_params(init, seed=5), P)
        self.opt_state = jax.vmap(jax_build_optimizer(a.optimizer, a.max_grad_norm).init)(self.params)
        actors = [self._member(m) for m in range(P)]
        members = jax.tree.map(lambda *x: jnp.stack(x), *actors)
        members["update"] = jnp.zeros((P,), jnp.int32)
        self.pop = jpop.init_population_state(members, self.jpbt, B)
        self.hp = self.jpbt.init_hyperparams(jax.random.PRNGKey(9))
        self.jroll = jax.jit(jax_anakin.make_rollout_fn(
            side.jvenv, self.jagent.apply,
            lambda out, k: jax_ppo_agent.sample_actions(out, side.actions_dim, side.cont, k),
            cnn_keys=(), mlp_keys=("state",), action_space=side.act_space, gamma=float(a.gamma), rollout_steps=T,
            store_logprobs=self.is_ppo))

        self.cfg = compose(list(overrides))
        fabric = build_fabric(self.cfg)
        gens = {"train": torch.Generator().manual_seed(0), "player": torch.Generator().manual_seed(1),
                "env": torch.Generator().manual_seed(2)}
        state = {"agent": stacked_state(self.params)}
        self.route = PopulationRoute(fabric, self.cfg, self.trainer_cls, side.penv, side.obs_space,
                                     side.p_act_space, side.actions_dim, side.cont, gens, state, 1)
        rc = self.route.pop
        for dst, src in zip(rc["members"]["env"], env_state_from_jax(members["env"], side.state_cls)):
            dst.copy_(src.reshape(dst.shape))
        for k, v in self.hp.items():
            self.route.hp[k].copy_(_t(v))

    def _member(self, m):
        """Member ``m``'s start: a reset whose first ``m + 1`` rows speed
        towards the edge, so the members' fitness differs."""
        env_state, _ = self.side.jvenv.reset(jax.random.PRNGKey(20 + m))
        rows = jnp.arange(B) <= m
        env_state = env_state._replace(x=jnp.where(rows, 2.3, env_state.x),
                                       x_dot=jnp.where(rows, 2.5, env_state.x_dot))
        return {"env": env_state, "ep_ret": jnp.zeros((B,), jnp.float32), "ep_len": jnp.zeros((B,), jnp.int32)}

    def draws(self, key):
        """What JAX's phase draws from ``key``, as the port takes it."""
        k_members, k_pbt, _ = jax.random.split(key, 3)
        noise, resets, perms = [[] for _ in range(T)], [[] for _ in range(T)], []
        for m, km in enumerate(jax.random.split(k_members, P)):
            k_roll, k_train = jax.random.split(km) if self.is_ppo else (km, None)
            pm = jax.tree.map(lambda x: x[m], self.params)
            actor = jax.tree.map(lambda x: x[m], self.pop["members"])
            actions = self.jroll(pm, actor, k_roll)[1]["actions"]
            for t, step in enumerate(self.side.noise(k_roll)):
                noise[t].append(step)
            for t, d in enumerate(self.side.reset_draws(actor["env"], actions)):
                resets[t].append(d)
            if self.is_ppo:
                tr = self.route.trainer.single
                perms.append(torch.stack([
                    _t(jax_epoch_permutation(k, T, B, tr.batch_size, tr.num_minibatches,
                                             bool(self.jcfg.buffer.share_data), 1))
                    for k in jax.random.split(k_train, tr.update_epochs)]))
        members = {
            "noise": [[torch.cat([per[m][i] for m in range(P)]) for i in range(len(per[0]))] for per in noise],
            "reset": [{k: torch.cat([per[m][k] for m in range(P)]) for k in per[0]} for per in resets],
        }
        if perms:
            members["perms"] = torch.stack(perms)
        return {"members": members, "factors": jax_factors(k_pbt, self.hp, self.jpbt)}

    def window(self, key):
        """One window on both sides; JAX's losses and the next key."""
        draws = self.draws(key)
        self.params, self.opt_state, self.pop, self.hp, key, j_losses, _ = self.jfn(
            self.params, self.opt_state, self.pop, self.hp, key)
        losses, _ = self.route.step(draws)
        return losses, j_losses, key


def stacked_state(params):
    """Stacked flax parameters → the port's stacked ``state_dict``."""
    members = [policy_state_from_jax(jax.device_get(jax.tree.map(lambda x: x[m], params))) for m in range(P)]
    return {k: torch.stack([s[k] for s in members]) for k in members[0]}


def jax_moments(opt_state):
    """The stacked moments of JAX's optimizer state under the port's names,
    and Adam's step count (None for the RMSprops)."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(leaf, "mu"):
            return {"exp_avg": stacked_state(leaf.mu), "exp_avg_sq": stacked_state(leaf.nu)}, leaf.count
        if hasattr(leaf, "nu"):
            return {"square_avg": stacked_state(leaf.nu)}, None
    raise AssertionError("no moments in the JAX optimizer state")


def assert_sides_match(sides, losses, j_losses):
    route = sides.route
    np.testing.assert_allclose(losses.numpy(), np.stack([np.asarray(x) for x in j_losses], -1), rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * 0.1)
    want = stacked_state(sides.params)
    for k, v in route.agent.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **PARAM_TOL)
    moments, count = jax_moments(sides.opt_state)
    for kind, tree in moments.items():
        for k, v in tree.items():
            np.testing.assert_allclose(route.optimizer.state[k][kind].numpy(), v.numpy(), err_msg=f"{kind} {k}",
                                       **MOMENT_TOL)
    if count is not None:
        np.testing.assert_array_equal(route.optimizer.count.numpy(), np.asarray(count, np.float32))
    carry = route.pop
    np.testing.assert_array_equal(carry["fitness"].numpy(), np.asarray(sides.pop["fitness"]))
    np.testing.assert_array_equal(carry["ep_count"].numpy(), np.asarray(sides.pop["ep_count"]))
    assert int(carry["exploits"]) == int(sides.pop["exploits"])
    np.testing.assert_array_equal(carry["members"]["update"].numpy(), np.asarray(sides.pop["members"]["update"]))
    for k in sides.hp:
        np.testing.assert_allclose(route.hp[k].numpy(), np.asarray(sides.hp[k]), rtol=1e-6, err_msg=k)
    jenv = jax.tree.map(lambda x: x.reshape((P * B,) + x.shape[2:]), sides.pop["members"]["env"])
    assert_env_states_match(carry["members"]["env"], jenv, sides.side.state_cls)


@pytest.mark.parametrize("case", ["ppo", "a2c"])
def test_population_windows_match_jax(case, tmp_path, monkeypatch):
    """Two windows of the whole population phase, held to JAX's after each:
    window 1 with the exploit gate closed (update 1 = warmup), window 2
    opening it (update 2 > warmup 1, cadence 2)."""
    sides = PopulationSides(case, tmp_path, monkeypatch)
    key = jax.random.PRNGKey(8)
    for w in (1, 2):
        losses, j_losses, key = sides.window(key)
        assert_sides_match(sides, losses, j_losses)
        assert int(sides.pop["exploits"]) == (sides.jpbt.n_select if w == 2 else 0)
    assert (np.asarray(sides.pop["ep_count"]) > 0).all()
    assert len(set(np.asarray(sides.pop["fitness"]).tolist())) > 1  # the members' fitness differs


def test_population_equals_single_member_phases(tmp_path, monkeypatch):
    """The population phase at P = 3 against three single-member port phases
    with the same draws and hyperparameters, each member clipped by its own
    gradient norm (``max_grad_norm`` 0.5 clips every member here)."""
    sides = PopulationSides("ppo", tmp_path, monkeypatch, extra=("population.exploit_every=0",))
    route, side = sides.route, sides.side
    draws = sides.draws(jax.random.PRNGKey(8))
    start = {k: v.clone() for k, v in route.agent.state_dict().items()}
    env0 = [x.clone() for x in route.pop["members"]["env"]]
    hp = {k: v.clone() for k, v in route.hp.items()}
    losses, _ = route.step(draws)
    a = sides.cfg.algo
    for m in range(P):
        rows = slice(m * B, (m + 1) * B)
        agent = build_agent(build_fabric(sides.cfg), side.actions_dim, side.cont, sides.cfg, side.obs_space,
                            {k: v[m] for k, v in start.items()})
        optimizer = build_optimizer(agent.parameters(), a.optimizer, a.max_grad_norm)
        trainer = PPOTrainer(sides.cfg, agent, optimizer, ("state",), side.actions_dim, side.cont, T, B)
        venv = VectorDeviceEnv(side.penv, B, "cpu", torch.Generator().manual_seed(0))
        roll = make_rollout_fn(venv, agent, lambda out, noise: sample_actions(out, side.actions_dim, side.cont, noise),
                               cnn_keys=(), mlp_keys=("state",), action_space=side.p_act_space, gamma=float(a.gamma),
                               rollout_steps=T)
        actor = {"env": type(route.pop["members"]["env"])(*(x[rows] for x in env0)), "ep_ret": torch.zeros(B),
                 "ep_len": torch.zeros(B, dtype=torch.int32), "update": 0}
        noise = [[x[rows] for x in step_noise] for step_noise in draws["members"]["noise"]]
        resets = [{k: v[rows] for k, v in d.items()} for d in draws["members"]["reset"]]
        _, rollout, last_obs, _ = roll(actor, noise, resets)
        for group in optimizer.optimizer.param_groups:
            group["lr"] = float(hp["lr"][m])
        single = trainer.train_phase(rollout, last_obs, list(draws["members"]["perms"][m]),
                                     float(hp["clip_coef"][m]), float(hp["ent_coef"][m]))
        np.testing.assert_allclose(losses[m].numpy(), torch.stack(single).numpy(), rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * 0.1)
        for k, v in agent.state_dict().items():
            np.testing.assert_allclose(route.agent.params[k][m].detach().numpy(), v.numpy(), err_msg=f"{m} {k}",
                                       **PARAM_TOL)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop", "rmsprop_tf"])
def test_stacked_optimizer_matches_the_port_optimizer(name):
    """A stacked optimizer against ``utils/optim.py``'s on every member alone,
    each at its own learning rate, with a clip that bites on some members
    only (their gradient norms are 0.1x, 1x and 5x one scale)."""
    rng = np.random.default_rng(0)
    w = _t(rng.standard_normal((P, 5, 4)).astype(np.float32))
    scale = np.array([0.1, 1.0, 5.0], np.float32)[:, None, None]
    grads = [_t(rng.standard_normal((P, 5, 4)).astype(np.float32) * scale) for _ in range(3)]
    lrs = torch.tensor([1e-2, 3e-3, 5e-2])
    cfg = dotdict({"name": name, "lr": 1e-3, "eps": 1e-5, "momentum": 0.0 if name.startswith("adam") else 0.5})
    stacked = {"w": w.clone().requires_grad_(True)}
    opt = StackedOptimizer(stacked, cfg, max_grad_norm=2.0)
    for g in grads:
        opt.step([g], lrs)
    for m in range(P):
        p = torch.nn.Parameter(w[m].clone())
        single = build_optimizer([p], cfg, 2.0)
        for group in single.optimizer.param_groups:
            group["lr"] = float(lrs[m])
        for g in grads:
            p.grad = g[m].clone()
            single.step()
        np.testing.assert_allclose(stacked["w"][m].detach().numpy(), p.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} member {m}")


def test_stacked_agent_is_the_module_per_member():
    cfg = compose(["exp=ppo", *COMMON, *ENVS["forage"]])
    side = Side(("exp=ppo", *COMMON, *ENVS["forage"]))
    module = build_agent(build_fabric(cfg), side.actions_dim, side.cont, cfg, side.obs_space)
    states = [{k: v + 0.01 * m for k, v in module.state_dict().items()} for m in range(P)]
    agent = StackedAgent(module, P, {k: torch.stack([s[k] for s in states]) for k in states[0]})
    obs = {"rgb": torch.rand(P, 5, *side.obs_space["rgb"].shape)}
    out, value = agent(obs)
    for m in range(P):
        module.load_state_dict(states[m])
        o, v = module({"rgb": obs["rgb"][m]})
        np.testing.assert_allclose(out[m].detach().numpy(), o.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(value[m].detach().numpy(), v.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_population_phase_makes_no_host_round_trip(tmp_path, monkeypatch):
    """The CPU's stand-in for the card's sync gate: a whole population phase
    with its exploit gate open, past the first, reads nothing back."""
    cfg = compose(["exp=ppo", *COMMON, *ENVS["cartpole"], *POPULATION, "population.warmup=0",
                   "population.exploit_every=1", "algo.per_rank_batch_size=16", "algo.update_epochs=1"])
    side = Side(("exp=ppo", *COMMON, *ENVS["cartpole"]))
    gens = {k: torch.Generator().manual_seed(i) for i, k in enumerate(("train", "player", "env"))}
    route = PopulationRoute(build_fabric(cfg), cfg, PPOTrainer, side.penv, side.obs_space, side.p_act_space,
                            side.actions_dim, side.cont, gens, {}, 1)
    route.step()

    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"{name} inside the population phase")
        return raiser

    for name in ("item", "tolist", "numpy", "cpu", "nonzero", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    for name in ("tensor", "as_tensor", "from_numpy", "nonzero", "masked_select"):
        monkeypatch.setattr(torch, name, refuse(f"torch.{name}"))
    route.step()
    monkeypatch.undo()
    assert int(route.pop["exploits"]) == 2 * route.pbt.n_select


# -- the loop through cli.run ------------------------------------------------------
CLI = ("env=jax_cartpole", "population.size=4", "population.exploit_every=2", "population.warmup=1",
       "env.num_envs=4", "algo.rollout_steps=16", "algo.per_rank_batch_size=32", "algo.update_epochs=1",
       "algo.mlp_keys.encoder=[state]", "algo.dense_units=16", "algo.total_steps=1280", "algo.max_recompiles=1",
       "fabric.accelerator=cpu", "checkpoint.save_last=True", "checkpoint.every=1000000",
       "metric.log_level=1", "metric.log_every=1", "metric/logger=csv", "algo.run_test=False")


def _run_dir(root: Path) -> Path:
    return max(root.glob("*/*/*/version_0"), key=os.path.getmtime)


@pytest.mark.parametrize("exp", ["ppo", "a2c"])
def test_cli_run_trains_a_population(exp, tmp_path):
    from sheeprl_tpu_torch.checkpoint.protocol import list_checkpoints
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.telemetry import HUB

    root = tmp_path / "runs"
    run([f"exp={exp}", *CLI, f"log_dir={root}", "algo.run_test=True"])
    assert "population" not in HUB.source_names()  # cli.run unregisters it on the way out
    run_dir = _run_dir(root)
    summary = json.loads((run_dir / "population_summary.json").read_text())
    names = ["lr", "ent_coef"] + (["clip_coef"] if exp == "ppo" else [])
    j_summary = json.loads(Path(jpop.write_population_summary(
        str(tmp_path), {"fitness": np.zeros(4), "ep_count": np.zeros(4), "exploits": 0},
        {k: np.ones(4) for k in names}, 0)).read_text())
    assert set(summary) == set(j_summary) and set(summary["hyperparams"]) == set(j_summary["hyperparams"])
    assert summary["exploit_events"] > 0 and summary["policy_step"] == 1280
    rows = (run_dir / "metrics.csv").read_text()
    monitor = jpop.PopulationMonitor()
    monitor.observe(np.zeros(4), {k: np.ones(4) for k in names}, 0)
    for key in monitor.metrics():
        assert f",{key}," in rows, key
    assert ",Loss/policy_loss," in rows

    # a resume restores the PBT carry: with nothing left to train the
    # summary reads back what the last checkpoint saved
    last = list_checkpoints(run_dir / "checkpoint")[-1]
    run([f"exp={exp}", *CLI, f"log_dir={tmp_path / 'resumed'}", f"checkpoint.resume_from={last}"])
    resumed = json.loads((_run_dir(tmp_path / "resumed") / "population_summary.json").read_text())
    for k in ("fitness", "episodes_per_member", "exploit_events", "hyperparams", "policy_step"):
        assert resumed[k] == summary[k], k


def test_population_off_the_anakin_path_raises(tmp_path):
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(ValueError) as err:
        run(["exp=ppo", *CLI, "algo.anakin=False", f"log_dir={tmp_path}"])
    assert str(err.value) == NO_ANAKIN
