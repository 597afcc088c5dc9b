"""Decoupled PPO and SAC, and the topology they resolve, against the JAX
package on the CPU.

* ``parallel/topology.py::resolve_topology``: every case and message of
  JAX's on one process; where JAX takes the Sebulba split the port raises
  naming the next ROADMAP item.
* ``exp=ppo_decoupled``: three iterations through each package's
  ``cli.run`` from one parameter tree, the port handed the draws the JAX
  keys make (each rollout's player stream ``fold_in(key, 0)`` split per
  step, each update's minibatch orders from its key): the same actions, the
  log-probs and truncation-bootstrapped rewards of the stale player, the
  losses and the parameters after every update (1e-5, the tiers of
  ``tests/test_torch_ppo.py``); and directly, rollout *k+1* acted with the
  weights trained on rollout *k-1*, the player never aliasing them.
* ``exp=sac_decoupled``: the port's ``PlayerSync`` against JAX's through 25
  windows at ``sync_every`` 10, deferred and not: the weights the player
  holds and the staleness gauges after every call.
* Dry runs of both recipes through ``cli.run``, each resumed from its own
  checkpoint and evaluated; ``algo.player.dedicated=True`` warns with JAX's
  text.
"""

import glob
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo import ppo_decoupled as jax_ppo_decoupled
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel import topology as jax_topology
from sheeprl_tpu.parallel.fabric import PlayerSync as JaxPlayerSync
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu_torch.algos.ppo import ppo_decoupled
from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
from sheeprl_tpu_torch.cli import evaluation, run
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import policy_state_from_jax
from sheeprl_tpu_torch.fabric import PlayerSync
from sheeprl_tpu_torch.parallel import topology
from tests.test_torch_ppo import PARAM_TOL, assert_losses_match, jax_action_noise
from tests.test_torch_train_cli import OFF_POLICY_COMMON, ON_POLICY_COMMON

ONE_PROCESS = types.SimpleNamespace(num_processes=1, model_axis=None)


def _snapshots(log_dir):
    return sorted(glob.glob(f"{log_dir}/**/checkpoint/step_*", recursive=True))


# -- resolve_topology ---------------------------------------------------------------
TOPOLOGIES = {
    "absent": None,
    "auto": {"name": "auto"},
    "pipelined": {"name": "pipelined", "actor_devices": 2},
    "unknown": {"name": "anakin"},
    "pod-one-process": {"name": "pod"},
    "sebulba": {"name": "sebulba"},
    "auto-sized-split": {"name": "auto", "actor_devices": 1},
}


@pytest.mark.parametrize("case", list(TOPOLOGIES))
def test_resolve_topology_against_jax(case):
    cfg = {} if TOPOLOGIES[case] is None else {"topology": TOPOLOGIES[case]}
    try:
        want = jax_topology.resolve_topology(cfg, ONE_PROCESS)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            topology.resolve_topology(cfg, ONE_PROCESS)
        assert str(got.value) == str(e)
        return
    assert topology.topology_cfg(cfg) == jax_topology.topology_cfg(cfg)
    if want == "sebulba":
        # JAX runs its degenerate Sebulba on one device; the port defers it, naming the item
        with pytest.raises(NotImplementedError, match=r"queue A item 5\(b\)"):
            topology.resolve_topology(cfg, ONE_PROCESS)
    else:
        assert topology.resolve_topology(cfg, ONE_PROCESS) == want == "pipelined"


# -- decoupled PPO against JAX's loop -------------------------------------------------------
PPO = ["exp=ppo_decoupled", "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "env.num_envs=2",
       "env.max_episode_steps=5", "algo.rollout_steps=4", "algo.per_rank_batch_size=4", "algo.update_epochs=2",
       "algo.total_steps=24", "algo.dense_units=8", "algo.mlp_layers=1", "algo.cnn_keys.encoder=[]",
       "algo.mlp_keys.encoder=[state]", "algo.anneal_lr=True", "algo.anneal_clip_coef=True",
       "algo.anneal_ent_coef=True", "algo.ent_coef=0.01", "algo.run_test=False", "metric.log_level=0",
       "buffer.memmap=False", "checkpoint.every=1000000", "checkpoint.async_save=False", "fabric.accelerator=cpu"]
ITERS, T, N_ENVS = 3, 4, 2


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _jax_run(tmp_path, monkeypatch):
    """JAX's decoupled PPO through its ``cli.run``, recording each rollout's
    key, player parameters and rollout, and each update's parameters,
    key and results."""
    rollouts, updates = [], []
    run_rollout, build = jax_ppo_decoupled._run_rollout, jax_ppo_decoupled._build_train_fns

    def rollout_spy(ctx, obs, p_params, key, fold_rank=None):
        out = run_rollout(ctx, obs, p_params, key, fold_rank)
        rollouts.append({"key": np.array(key), "fold": fold_rank, "params": _np(p_params),
                         "rollout": {k: np.array(v) for k, v in out[1].items()}})
        return out

    def build_spy(*args, **kwargs):
        policy_step_fn, values_fn, train_phase, raw = build(*args, **kwargs)

        def train_spy(p, o, rollout, last_obs, k, clip, ent, **kw):
            rec = {"params_in": _np(p), "key": np.array(k), "clip": float(clip), "ent": float(ent), **kw}
            p, o, losses = train_phase(p, o, rollout, last_obs, k, clip, ent, **kw)
            rec.update(params_out=_np(p), losses=[float(x) for x in losses])
            updates.append(rec)
            return p, o, losses

        return policy_step_fn, values_fn, train_spy, raw

    monkeypatch.setattr(jax_ppo_decoupled, "_run_rollout", rollout_spy)
    monkeypatch.setattr(jax_ppo_decoupled, "_build_train_fns", build_spy)
    jax_run([*PPO, f"log_dir={tmp_path / 'jax'}"])
    monkeypatch.undo()
    return rollouts, updates


def _jax_draws(rollout, actions_dim, dist_type="auto"):
    """The action draws of one JAX rollout: its player stream
    ``fold_in(key, fold)`` split once per step."""
    sk = jax.random.fold_in(jnp.asarray(rollout["key"]), rollout["fold"])
    draws = []
    for _ in range(T):
        k_sample, sk = jax.random.split(sk)
        noise = jax_action_noise(k_sample, N_ENVS, actions_dim, False, dist_type)
        draws.append([torch.from_numpy(np.array(x)) for x in noise])
    return draws


def _jax_perms(update, epochs=2):
    """JAX's minibatch orders of one update (``permutation`` per epoch key, padded by wrap-around)."""
    n, bs, nmb = T * N_ENVS, update["batch_size"], update["num_minibatches"]
    perms = []
    for k_e in jax.random.split(jnp.asarray(update["key"]), epochs):
        perm = np.asarray(jax.random.permutation(k_e, n))
        pad = nmb * bs - n
        perms.append(torch.from_numpy(np.concatenate([perm, perm[:pad]]) if pad > 0 else perm))
    return perms


def test_decoupled_ppo_against_jax_loop(tmp_path, monkeypatch):
    j_rollouts, j_updates = _jax_run(tmp_path, monkeypatch)
    assert len(j_rollouts) == len(j_updates) == ITERS
    actions_dim = (4,)

    draws = [d for r in j_rollouts for d in _jax_draws(r, actions_dim)]
    seen = {"rollout_player": [], "rollout_rows": [], "trained": [], "losses": []}
    build, sample, train_phase = ppo_decoupled.build_agent, ppo_decoupled.sample_actions, \
        ppo_decoupled.PPOTrainer.train_phase
    holder = {}

    def build_spy(fabric, actions_dim_, is_cont, cfg, obs_space, state=None):
        agent = build(fabric, actions_dim_, is_cont, cfg, obs_space, state)
        agent.load_state_dict(policy_state_from_jax(j_updates[0]["params_in"]))
        holder["agent"] = agent
        return agent

    def sample_spy(out, actions_dim_, is_cont, noise=None, greedy=False, dist_type="auto"):
        assert isinstance(noise, torch.Generator)
        return sample(out, actions_dim_, is_cont, draws.pop(0), greedy, dist_type)

    def deepcopy_spy(module):
        holder["player"] = copy_module.deepcopy(module)
        return holder["player"]

    def rollout_spy(envs, rb, obs, *args):
        seen["rollout_player"].append({k: v.clone() for k, v in holder["player"].state_dict().items()})
        out = host_rollout(envs, rb, obs, *args)
        seen["rollout_rows"].append({k: np.array(v) for k, v in rb.buffer.items()})
        return out

    def train_spy(self, rollout, last_obs, perms, clip_coef, ent_coef):
        u = j_updates[len(seen["trained"])]
        assert math.isclose(float(clip_coef), u["clip"], rel_tol=1e-6)
        assert math.isclose(float(ent_coef), u["ent"], rel_tol=1e-6)
        assert (self.batch_size, self.num_minibatches) == (u["batch_size"], u["num_minibatches"])
        losses = train_phase(self, rollout, last_obs, _jax_perms(u), clip_coef, ent_coef)
        seen["trained"].append({k: v.clone() for k, v in self.agent.state_dict().items()})
        seen["losses"].append(losses)
        return losses

    import copy as copy_module

    host_rollout = ppo_decoupled.host_rollout
    monkeypatch.setattr(ppo_decoupled, "build_agent", build_spy)
    monkeypatch.setattr(ppo_decoupled, "sample_actions", sample_spy)
    monkeypatch.setattr(ppo_decoupled, "copy", types.SimpleNamespace(deepcopy=deepcopy_spy))
    monkeypatch.setattr(ppo_decoupled, "host_rollout", rollout_spy)
    monkeypatch.setattr(ppo_decoupled.PPOTrainer, "train_phase", train_spy)
    run([*PPO, f"log_dir={tmp_path / 'port'}"])
    assert not draws and len(seen["trained"]) == ITERS

    init = policy_state_from_jax(j_updates[0]["params_in"])
    for k in range(ITERS):
        # the rollout: JAX's actions, and the stale player's log-probs and bootstraps
        rows, want = seen["rollout_rows"][k], j_rollouts[k]["rollout"]
        np.testing.assert_array_equal(rows["actions"], want["actions"])
        np.testing.assert_allclose(rows["logprobs"][..., 0], want["logprobs"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rows["rewards"][..., 0], want["rewards"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(rows["dones"][..., 0], want["dones"])
        # the update
        assert_losses_match(seen["losses"][k], j_updates[k]["losses"])
        for name, v in policy_state_from_jax(j_updates[k]["params_out"]).items():
            np.testing.assert_allclose(seen["trained"][k][name].numpy(), v.numpy(), err_msg=f"{k}: {name}",
                                       **PARAM_TOL)
    # a truncation was bootstrapped with the stale player's value
    assert any(np.any(r["rollout"]["rewards"] != 1.0) for r in j_rollouts)
    # rollout k+1 acted with the weights of update k-1: the first two with the initial ones
    players = seen["rollout_player"]
    for k in range(ITERS):
        want = init if k < 2 else seen["trained"][k - 2]
        assert all(torch.equal(players[k][n], want[n]) for n in want), k
    assert not any(torch.equal(players[2][n], seen["trained"][1][n]) for n in players[2])
    # the player's tensors are its own
    agent_ptrs = {p.data_ptr() for p in holder["agent"].parameters()}
    assert not agent_ptrs & {p.data_ptr() for p in holder["player"].parameters()}


# -- decoupled SAC's player cadence ------------------------------------------------------------
@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "immediate"])
def test_player_sync_cadence_and_staleness_against_jax(deferred):
    """25 train windows at ``sync_every`` 10: before each window the player
    may take pending weights, after it the window count decides a refresh.
    The weights are the window's index, so the player's tells which window
    it acts with."""
    overrides = ["exp=sac_decoupled", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy",
                 "fabric.accelerator=cpu", f"algo.player.deferred_sync={deferred}"]
    jcfg, pcfg = jax_compose(overrides), compose(overrides)
    assert int(pcfg.algo.player.sync_every) == int(jcfg.algo.player.sync_every) == 10
    jsync = JaxPlayerSync(jax_build_fabric(jcfg), jcfg, extract=lambda p: p["actor"])
    trained = torch.nn.Linear(1, 1, bias=False)
    psync = PlayerSync(pcfg, torch.device("cpu"), lambda: {"actor": trained})
    with torch.no_grad():
        trained.weight.fill_(0.0)
    j_player = jsync.init({"actor": jnp.zeros(())})
    psync.init()

    def same():
        assert float(psync.modules["actor"].weight) == float(j_player)
        assert psync.metrics() == jsync.metrics()

    same()
    for window in range(1, 26):
        j_player = jsync.before_dispatch(j_player)
        psync.before_dispatch()
        same()
        with torch.no_grad():
            trained.weight.fill_(float(window))  # the window trains
        j_player = jsync.after_dispatch({"actor": jnp.asarray(float(window))}, j_player)
        psync.after_dispatch()
        same()
    assert psync.staleness_max == (10 if deferred else 9)


# -- the recipes through cli.run --------------------------------------------------------------------
PPO_CLI = ["exp=ppo_decoupled", *ON_POLICY_COMMON, "env.id=discrete_dummy", "algo.cnn_keys.encoder=[]",
           "algo.mlp_keys.encoder=[state]", "algo.update_epochs=2", "algo.anneal_lr=True", "algo.anneal_clip_coef=True",
           "algo.anneal_ent_coef=True", "algo.ent_coef=0.01"]


def test_ppo_decoupled_dry_run_resumes_and_evaluates(tmp_path, capsys):
    first = tmp_path / "first"
    with pytest.warns(UserWarning) as record:
        run([*PPO_CLI, "dry_run=True", "algo.run_test=True",
             "algo.player.dedicated=True", f"log_dir={first}"])
    jax_text = ("algo.player.dedicated=True needs >= 2 processes (jax.distributed); falling back to the "
                "single-controller pipelined topology (deprecated — prefer topology=sebulba, docs/sebulba.md)")
    assert jax_text in [str(w.message) for w in record]
    (snapshot,) = _snapshots(first)
    state = load_step_dir(snapshot)
    assert state["update"] == 1 and state["policy_step"] == 16  # a dry run collects no rollout after its update
    assert set(state["generators"]) == {"train", "player"}
    resumed = tmp_path / "resumed"
    run([*PPO_CLI, "algo.total_steps=64", "algo.run_test=False",
         f"checkpoint.resume_from={snapshot}", f"log_dir={resumed}"])
    (after,) = _snapshots(resumed)
    after_state = load_step_dir(after)
    # the first rollout again, then updates 2-4 with the rollouts after 2 and 3
    assert after_state["update"] == 4 and after_state["policy_step"] == 16 + 3 * 16
    assert after_state["opt_state"]["state"][0]["step"].item() > state["opt_state"]["state"][0]["step"].item()
    reward = evaluation([f"checkpoint_path={after}", "fabric.accelerator=cpu"])
    assert math.isfinite(reward) and f"Test/cumulative_reward: {reward}" in capsys.readouterr().out


def test_sac_decoupled_dry_run_resumes_and_logs_staleness(tmp_path):
    first = tmp_path / "first"
    common = ["exp=sac_decoupled", *OFF_POLICY_COMMON, "algo.mlp_keys.encoder=[state]", "algo.player.sync_every=3"]
    run([*common, "algo.total_steps=48", "algo.run_test=False", "buffer.checkpoint=True", f"log_dir={first}"])
    (snapshot,) = _snapshots(first)
    state = load_step_dir(snapshot)
    assert state["psync"]["windows"] > 2 * 3  # several refreshes at sync_every 3
    rows = open(glob.glob(f"{first}/**/metrics.csv", recursive=True)[0]).read().splitlines()
    stale = [float(r.rsplit(",", 1)[1]) for r in rows if ",Player/param_staleness_max," in r]
    assert stale and max(stale) == 3.0  # sync_every, the deferred refresh landing one window late
    resumed = tmp_path / "resumed"
    run([*common, "algo.total_steps=64", "algo.run_test=False", f"checkpoint.resume_from={snapshot}",
         f"log_dir={resumed}"])
    (after,) = _snapshots(resumed)
    after_state = load_step_dir(after)
    assert after_state["update"] == 32 and after_state["policy_step"] == 64
    assert math.isfinite(evaluation([f"checkpoint_path={after}", "fabric.accelerator=cpu"]))
