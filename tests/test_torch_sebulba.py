"""The Sebulba actor/learner runtime (``sheeprl_tpu_torch/sebulba/``,
``parallel/topology.py``) against the JAX package on the CPU.

* The trajectory queue's contract, the port of JAX's
  ``TestTrajQueueSemantics``: backpressure blocks and never drops, a wedged
  learner times out loudly, a torn segment and a planted ``truncate`` at
  ``sebulba.traj_queue`` are rejected and counted.
* ``ParamBroadcast``: the cases of JAX's ``tests/test_parallel/
  test_topology.py``, and an in-place optimizer step after a publish that
  leaves the actor's fetched copy as it was.
* ``derive_ladder``, ``resolve_topology`` and ``DeviceTopology`` over grids of
  inputs: JAX's results, errors, warning and description.
* The worker protocols on the dummy envs with one deterministic ``infer``
  stub: the segments equal JAX's bit for bit (a truncation bootstrap; SAC's
  prefill draws).
* The policy at every rung of the ladder (actions equal; log-probs and
  values within 1e-5) and the actor engine's compile-once dispatch; PPO's
  learner phase on the concatenated segments (parameters within 1e-5
  relative L2 after one phase, the losses within 1e-5 relative) and one SAC
  learner window on a ring filled per worker slice (the parameters 1e-5
  absolute, the losses 1e-5 relative, the tiers of ``tests/test_torch_sac.py``),
  each given JAX's parameters and JAX's draws.
* The slice through ``cli.run`` (host workers, the fused ``jax_cartpole``
  actor, SAC): the counters of JAX's run of the same config and JAX's
  stats keys.  Thread timing decides which version each actor holds in
  either package, so the whole run is held to its counters and contract.
* The drills of JAX's ``TestChaosDrills`` and ``TestPreemption``: a crashed
  and a hung worker are respawned, a SIGTERM mid-run ends in a committed
  save that a resumed run continues; and a Sebulba-written snapshot served.
"""

import copy
import glob
import os
import signal
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.algos.ppo import agent as jax_agent
from sheeprl_tpu.checkpoint import PREEMPTION_GUARD as JAX_PREEMPTION_GUARD
from sheeprl_tpu.algos.ppo.ppo_decoupled import _build_train_fns as jax_train_fns
from sheeprl_tpu.cli import run as jax_run
from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel import topology as jax_topology
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.sebulba import actor as jax_actor
from sheeprl_tpu.sebulba import ppo as jax_sppo
from sheeprl_tpu.sebulba import sac as jax_ssac
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu.utils import env as jax_env
from sheeprl_tpu.utils.optim import build_optimizer as jax_build_optimizer
from sheeprl_tpu_torch.checkpoint.preemption import PREEMPTION_GUARD
from sheeprl_tpu_torch.checkpoint.protocol import checkpoint_step, load_step_dir
from sheeprl_tpu_torch.cli import run
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.convert import policy_state_from_jax
from sheeprl_tpu_torch.fabric import build_fabric
from sheeprl_tpu_torch.parallel import topology
from sheeprl_tpu_torch.parallel.topology import ParamBroadcast, StalenessExceeded
from sheeprl_tpu_torch.resilience.faults import ENV_VAR, FaultPlan, clear_plan, install_plan
from sheeprl_tpu_torch.sebulba import ppo as sppo
from sheeprl_tpu_torch.sebulba import sac as ssac
from sheeprl_tpu_torch.sebulba.actor import ActorEngine, derive_ladder
from sheeprl_tpu_torch.sebulba.queues import ObsBlock, ObsQueue, QueueFull, TornTrajectory, TrajQueue
from sheeprl_tpu_torch.telemetry.spans import SPANS
from sheeprl_tpu_torch.utils import env as pt_env
from tests.test_torch_ppo import assert_losses_match, draw_params, jax_action_noise

CPU = build_fabric(compose(["exp=ppo", "fabric.accelerator=cpu"]))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


# -- the trajectory queue (JAX's TestTrajQueueSemantics) ------------------------------------
def _seg(t=4, b=2):
    return {"state": np.zeros((t, b, 4), np.float32), "rewards": np.zeros((t, b), np.float32),
            "last_state": np.zeros((b, 4), np.float32)}


def _queue(capacity=2, steps=4):
    return TrajQueue(capacity, steps, CPU, stage=True, bootstrap_keys=("last_state",), timeout_s=1.0)


def test_backpressure_blocks_the_producer_and_never_drops():
    q = _queue(capacity=2)
    q.put(_seg(), {"version": 0})
    q.put(_seg(), {"version": 1})
    unblocked_at = {}

    def producer():
        q.put(_seg(), {"version": 2})  # blocks until the learner pops
        unblocked_at["t"] = time.monotonic()

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.3)
    assert "t" not in unblocked_at, "a full queue blocks, it does not drop"
    t0 = time.monotonic()
    items = q.get_many(2)
    t.join(5.0)
    assert not t.is_alive() and unblocked_at["t"] >= t0
    items += q.get_many(1)
    assert [m["version"] for _, m in items] == [0, 1, 2] and q.total_put == 3
    # staged on the learner's device as tensors
    assert all(isinstance(v, torch.Tensor) for seg, _ in items for v in seg.values())


def test_a_wedged_learner_times_the_producer_out_loudly():
    q = _queue(capacity=1)
    q.put(_seg(), {})
    with pytest.raises(QueueFull):
        q.put(_seg(), {})  # nobody pops: fail after timeout_s, not hang


def test_a_torn_segment_is_rejected_never_enqueued():
    q = _queue()
    torn = _seg()
    torn["state"] = torn["state"][:2]
    with pytest.raises(TornTrajectory):
        q.put(torn, {})
    assert q.qsize() == 0 and q.torn_rejected == 1


def test_a_truncate_plan_at_the_traj_queue_is_rejected_and_counted():
    """The ``sebulba.traj_queue`` plan installs (the site is ported) and fires."""
    install_plan(FaultPlan.from_specs([{"site": "sebulba.traj_queue", "kind": "truncate", "at": 1}]))
    try:
        q = _queue()
        with pytest.raises(TornTrajectory):
            q.put(_seg(), {})
        assert q.torn_rejected == 1 and q.metrics()["Sebulba/queue_torn_rejected"] == 1.0
        q.put(_seg(), {})  # the fault fired once; clean puts flow again
        assert q.qsize() == 1
    finally:
        clear_plan()


# -- ParamBroadcast (JAX's tests/test_parallel/test_topology.py cases) ---------------------------
def _bcast(**kw):
    return ParamBroadcast(CPU, [CPU.device], **kw)


def test_publish_fetch_versions_and_the_copy():
    bc = _bcast(max_staleness=2)
    params = {"w": torch.arange(4.0)}
    assert bc.publish(params, version=0) == 0
    got, version = bc.fetch(0)
    assert version == 0 and torch.equal(got.tensors["w"], torch.arange(4.0))
    # the actor's copy is its own, not the learner's tensor
    assert got.tensors["w"].data_ptr() != params["w"].data_ptr()
    bc.publish(params)  # auto-increment
    assert bc.version == 1 and bc.staleness(0) == 1


def test_gate_blocks_until_the_actor_fetches_within_the_bound():
    bc = _bcast(max_staleness=1, gate_timeout_s=30.0)
    params = {"w": torch.zeros(2)}
    for v in (1, 2, 3):
        bc.publish(params, version=v)

    def late_fetch():
        time.sleep(0.3)
        bc.fetch(0)

    t = threading.Thread(target=late_fetch)
    t.start()
    waited = bc.gate()
    t.join(5.0)
    assert not t.is_alive() and waited >= 0.2 and bc.staleness(0) == 0


def test_gate_times_out_loudly_on_a_wedged_actor():
    bc = _bcast(max_staleness=0, gate_timeout_s=0.2)
    bc.publish({"w": torch.zeros(2)}, version=0)
    bc.publish({"w": torch.zeros(2)}, version=1)  # never fetched
    with pytest.raises(StalenessExceeded):
        bc.gate()


def test_staleness_metrics_and_the_resume_baseline():
    bc = _bcast(max_staleness=4)
    for v in range(4):
        bc.publish({"w": torch.zeros(2)}, version=v)
    bc.fetch(0)
    m = bc.metrics()
    assert m["Sebulba/param_version"] == 3.0 and m["Sebulba/param_staleness_max"] == 3.0
    resumed = _bcast(max_staleness=4)
    resumed.publish({"w": torch.zeros(2)}, version=999)  # a resumed run's first publish
    assert resumed.fetch(0)[1] == 999 and resumed.metrics()["Sebulba/param_staleness_max"] == 0.0


def test_an_in_place_optimizer_step_leaves_the_fetched_copy_until_the_next_publish():
    learner = torch.nn.Linear(3, 2)
    actor = torch.nn.Linear(3, 2).requires_grad_(False)
    opt = torch.optim.SGD(learner.parameters(), lr=0.5)
    bc = _bcast()
    bc.publish(learner, version=0)
    staged, _ = bc.fetch(0)
    staged.copy_into(topology.named_tensors(actor))
    published = {k: v.clone() for k, v in learner.state_dict().items()}
    learner(torch.ones(1, 3)).sum().backward()
    opt.step()  # writes the learner's parameters in place
    for k, v in actor.state_dict().items():
        assert torch.equal(v, published[k]) and not torch.equal(v, learner.state_dict()[k]), k
    bc.publish(learner, version=1)
    staged, _ = bc.fetch(0)
    staged.copy_into(topology.named_tensors(actor))
    assert all(torch.equal(v, learner.state_dict()[k]) for k, v in actor.state_dict().items())


# -- derive_ladder, resolve_topology and DeviceTopology against JAX ---------------------------
LADDERS = [(1, 1, None), (2, 2, None), (3, 4, None), (4, 3, None), (5, 8, None), (2, 4, [2, 8]), (2, 4, [8, 2, 4]),
           (3, 2, [3, 5]), (4, 2, [6])]


@pytest.mark.parametrize("block,blocks,override", LADDERS)
def test_derive_ladder_against_jax(block, blocks, override):
    try:
        want = jax_actor.derive_ladder(block, blocks, override)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            derive_ladder(block, blocks, override)
        assert str(got.value) == str(e)
        return
    assert derive_ladder(block, blocks, override) == want


ONE_PROCESS = type("OneProcess", (), {"num_processes": 1, "model_axis": None})()
SPLITS = {"sebulba": {"name": "sebulba"}, "sized": {"name": "auto", "actor_devices": 1},
          "sized-learners": {"name": "sebulba", "actor_devices": 2, "learner_devices": 3}}


@pytest.mark.parametrize("case", list(SPLITS))
def test_one_device_topology_against_jax(case):
    cfg = {"topology": SPLITS[case]}
    assert topology.resolve_topology(cfg, ONE_PROCESS) == jax_topology.resolve_topology(cfg, ONE_PROCESS) == "sebulba"
    jfabric = jax_build_fabric(jax_compose(["exp=ppo_decoupled", "fabric.accelerator=cpu"]))
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jtopo = jax_topology.DeviceTopology.from_config(jfabric, cfg)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        ptopo = topology.DeviceTopology.from_config(CPU, cfg)
    assert [(w.category, str(w.message)) for w in pw] == [(w.category, str(w.message)) for w in jw]
    assert ptopo.shared and jtopo.shared and ptopo.num_actors == jtopo.num_actors == 1
    assert ptopo.describe() == jtopo.describe().replace(str(jtopo.actor_devices[0]), str(CPU.device))
    assert ptopo.learner_fabric is CPU


# -- the worker protocols against JAX's --------------------------------------------------------
class _Worker:
    """What a protocol reads of its worker: ``beat``, ``infer``, the seed and the env steps."""

    def __init__(self, seed, infer):
        self.seed, self.env_steps, self._infer = seed, 0, infer

    def beat(self):
        pass

    def infer(self, block):
        return self._infer(block)


def _ppo_infer(block):
    """A deterministic stand-in for the actor (the same numbers on both sides)."""
    s = block["state"].sum(-1)
    return {"actions": (np.floor(np.abs(s) * 7) % 4).astype(np.float32)[:, None],
            "logprobs": (-0.1 * np.abs(s)).astype(np.float32), "values": (0.5 * s).astype(np.float32)}


def _sac_infer(block):
    return {"actions": np.tanh(block["obs"][:, :2] * 0.7).astype(np.float32)}


def _envs(make_env, vectorize, cfg, seed, n):
    return vectorize(cfg, [make_env(cfg, seed + j, 0, vector_env_idx=j) for j in range(n)])


def _segments(protocol, make_env, vectorize, cfg, infer, steps, rounds=2, seed=5):
    envs = _envs(make_env, vectorize, cfg, seed, int(cfg.env.num_envs))
    worker = _Worker(seed, infer)
    obs, _ = envs.reset(seed=seed)
    protocol.on_reset(worker, obs)
    out = []
    for _ in range(rounds):
        obs, seg, stats, n = protocol.run_segment(worker, envs, obs, steps)
        worker.env_steps += n
        out.append((seg, stats, n))
    envs.close()
    return out


def _assert_segments_equal(got, want):
    assert len(got) == len(want)
    for (gs, gstats, gn), (ws, wstats, wn) in zip(got, want):
        assert set(gs) == set(ws) and gn == wn and gstats == wstats
        for k in ws:
            assert gs[k].dtype == ws[k].dtype, k
            np.testing.assert_array_equal(gs[k], ws[k], err_msg=k)


def test_ppo_worker_protocol_against_jax():
    """Episodes cut at 3 steps: the truncation bootstrap's second inference
    runs, and every leaf equals JAX's bit for bit."""
    ov = ["exp=ppo_decoupled", "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "env.num_envs=2",
          "env.max_episode_steps=3", "env.capture_video=False", "algo.cnn_keys.encoder=[]",
          "algo.mlp_keys.encoder=[state]"]
    jcfg, pcfg = jax_compose(ov), compose(ov)
    jprobe, pprobe = jax_env.make_env(jcfg, 0, 0)(), pt_env.make_env(pcfg, 0, 0)()
    calls = {"n": 0}

    def counted(block):
        calls["n"] += 1
        return _ppo_infer(block)

    want = _segments(jax_sppo.PPOWorkerProtocol(("state",), (), ("state",), jprobe.action_space, 0.9),
                     jax_env.make_env, jax_env.vectorize, jcfg, _ppo_infer, steps=8)
    got = _segments(sppo.PPOWorkerProtocol(("state",), (), ("state",), pprobe.action_space, 0.9),
                    pt_env.make_env, pt_env.vectorize, pcfg, counted, steps=8)
    jprobe.close(), pprobe.close()
    assert calls["n"] > 16  # the bootstrap's inferences ran
    _assert_segments_equal(got, want)
    assert set(got[0][0]) == {"state", "actions", "logprobs", "rewards", "dones", "last_state"}


def test_sac_worker_protocol_against_jax():
    """Prefill for 6 env steps (numpy's uniform draws from the worker's seed),
    then the stub; done rows carry the true final observation."""
    ov = ["exp=sac_decoupled", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "env.num_envs=2",
          "env.max_episode_steps=3", "env.capture_video=False", "algo.mlp_keys.encoder=[state]"]
    jcfg, pcfg = jax_compose(ov), compose(ov)
    jprobe, pprobe = jax_env.make_env(jcfg, 0, 0)(), pt_env.make_env(pcfg, 0, 0)()
    want = _segments(jax_ssac.SACWorkerProtocol(("state",), jprobe.action_space, 6), jax_env.make_env,
                     jax_env.vectorize, jcfg, _sac_infer, steps=4)
    got = _segments(ssac.SACWorkerProtocol(("state",), pprobe.action_space, 6), pt_env.make_env, pt_env.vectorize,
                    pcfg, _sac_infer, steps=4)
    jprobe.close(), pprobe.close()
    _assert_segments_equal(got, want)
    assert not np.array_equal(got[0][0]["next_obs"][1:], got[0][0]["obs"][2:])  # final observations kept


# -- the policy per rung and the learners, given JAX's parameters and draws ------------------
PPO_NET = ["exp=ppo_decoupled", "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "fabric.accelerator=cpu",
           "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "algo.dense_units=8", "algo.mlp_layers=1",
           "algo.update_epochs=2", "algo.per_rank_batch_size=6", "algo.rollout_steps=4", "env.num_envs=4"]


def _ppo_pair():
    jcfg, pcfg = jax_compose(PPO_NET), compose(PPO_NET)
    jfabric = jax_build_fabric(jcfg)
    obs_space, act_space = jax_probe_spaces(jcfg)
    jagent, init = jax_agent.build_agent(jfabric, (4,), False, jcfg, obs_space)
    params = draw_params(init)
    from sheeprl_tpu_torch.algos.ppo.agent import build_agent
    from sheeprl_tpu_torch.serve.loader import probe_spaces

    p_obs, _ = probe_spaces(pcfg)
    agent = build_agent(build_fabric(pcfg), (4,), False, pcfg, p_obs, policy_state_from_jax(jax.device_get(params)))
    return jcfg, pcfg, jfabric, jagent, params, agent, obs_space


def test_policy_at_every_rung_against_jax():
    jcfg, pcfg, _, jagent, params, agent, _ = _ppo_pair()
    policy = sppo.make_policy(agent, (4,), False, "auto")

    @jax.jit
    def jax_policy(p, obs, k):  # JAX's policy_fn (sebulba/ppo.py), its key split first
        out, value = jagent.apply(p, obs)
        actions, logprob, _ = jax_agent.sample_actions(out, (4,), False, jax.random.split(k)[0])
        return actions, logprob, value

    rng = np.random.default_rng(2)
    for rung in derive_ladder(2, 4):
        obs = rng.standard_normal((rung, 4)).astype(np.float32)
        key = jax.random.PRNGKey(rung)
        k_sample, _ = jax.random.split(key)
        actions, logprob, value = jax_policy(params, {"state": obs}, key)
        noise = [_t(x) for x in jax_action_noise(k_sample, rung, (4,), False, "auto")]
        with torch.no_grad():
            got = policy({"state": _t(obs)}, noise)
        np.testing.assert_array_equal(got["actions"].numpy(), np.asarray(actions))
        np.testing.assert_allclose(got["logprobs"].numpy(), np.asarray(logprob), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["values"].numpy(), np.asarray(value[..., 0]), rtol=1e-5, atol=1e-5)


def test_actor_engine_dispatch_is_compile_once_and_pads_to_a_rung():
    """Every rung built by the warm-up, one program each across 20
    dispatches; a partial round padded to a built rung; the outputs those of
    the policy on the engine's own copy, drawn from its generator."""
    _, _, _, _, _, agent, _ = _ppo_pair()
    modules = copy.deepcopy(agent).requires_grad_(False)
    bc = _bcast(max_staleness=100)
    bc.publish(agent, version=0)
    gen = torch.Generator().manual_seed(3)
    policy = sppo.make_policy(modules, (4,), False, "auto")
    eng = ActorEngine(0, "cpu", policy, modules, {"state": (4,)}, derive_ladder(2, 3), 2, ObsQueue(4), bc, gen)
    start = gen.get_state()
    eng.warmup()
    assert torch.equal(gen.get_state(), start)  # the warm-up's draws were put back
    assert eng.cache_sizes() == {2: 1, 4: 1, 6: 1}
    rng = np.random.default_rng(0)
    for window in range(20):
        blocks = [ObsBlock(i, {"state": rng.standard_normal((2, 4)).astype(np.float32)}, 2) for i in range(1 + window % 3)]
        ref_gen = torch.Generator().manual_seed(0)
        ref_gen.set_state(gen.get_state())
        rows = np.zeros((max(4, 2 * len(blocks)) if len(blocks) > 1 else 2, 4), np.float32)
        for j, b in enumerate(blocks):
            rows[2 * j:2 * j + 2] = b.obs["state"]
        with torch.no_grad():
            want = policy({"state": _t(rows)}, ref_gen)
        eng._dispatch(blocks)
        for j, b in enumerate(blocks):
            out = b.wait(1.0)
            np.testing.assert_array_equal(out["actions"], want["actions"][2 * j:2 * j + 2].numpy())
            assert out["_version"] == 0
    assert eng.cache_sizes() == {2: 1, 4: 1, 6: 1} and eng.dispatches == 20
    assert eng.rows_served == 2 * sum(1 + w % 3 for w in range(20)) and eng.rows_padded == 0


def test_ppo_learner_phase_against_jax():
    """Two producers' segments concatenated along the env axis, then one
    whole train phase (GAE, 2 epochs x 3 minibatches of Adam) on each side,
    the port handed JAX's minibatch orders."""
    jcfg, pcfg, _, jagent, params, agent, obs_space = _ppo_pair()
    T, Bw = 4, 2
    rng = np.random.default_rng(4)

    def seg():
        return {"state": rng.standard_normal((T, Bw, 4)).astype(np.float32),
                "actions": rng.integers(0, 4, (T, Bw, 1)).astype(np.float32),
                "logprobs": (-1.4 + 0.2 * rng.standard_normal((T, Bw))).astype(np.float32),
                "rewards": rng.standard_normal((T, Bw)).astype(np.float32),
                "dones": (rng.random((T, Bw)) < 0.25).astype(np.float32),
                "last_state": rng.standard_normal((Bw, 4)).astype(np.float32)}

    segs = [seg(), seg()]
    optimizer = jax_build_optimizer(jcfg.algo.optimizer, jcfg.algo.max_grad_norm)
    _, _, _, raw = jax_train_fns(jagent, optimizer, jcfg, ("state",), (4,), False, "auto")
    rollout = {k: np.concatenate([s[k] for s in segs], axis=1) for k in ("state", *sppo.ROLLOUT_KEYS)}
    last_obs = {"state": np.concatenate([s["last_state"] for s in segs], axis=0)}
    key = jax.random.PRNGKey(9)
    bs, nmb = 6, 3  # 16 rows: 3 minibatches of 6, the last padded by wrap-around
    phase = jax.jit(raw, static_argnames=("batch_size", "num_minibatches"))
    new_params, _, want = phase(params, optimizer.init(params), rollout, last_obs, key, jnp.float32(0.2),
                                jnp.float32(0.01), batch_size=bs, num_minibatches=nmb)
    perms = []
    for k_e in jax.random.split(key, 2):
        perm = np.asarray(jax.random.permutation(k_e, T * 2 * Bw))
        perms.append(torch.from_numpy(np.concatenate([perm, perm[:nmb * bs - perm.size]])))

    from sheeprl_tpu_torch.algos.ppo.ppo import PPOTrainer
    from sheeprl_tpu_torch.utils.optim import build_optimizer

    opt = build_optimizer(agent.named_parameters(), pcfg.algo.optimizer, pcfg.algo.max_grad_norm)
    trainer = PPOTrainer(pcfg, agent, opt, ("state",), (4,), False, T, 2 * Bw)
    assert (trainer.batch_size, trainer.num_minibatches) == (bs, nmb)
    phase_fn = sppo.make_learner_phase(trainer, ("state",))
    got = phase_fn([{k: _t(v) for k, v in s.items()} for s in segs], perms, 0.2, 0.01)
    assert_losses_match(got, want)
    expected = policy_state_from_jax(jax.device_get(new_params))
    for name, v in agent.state_dict().items():
        assert _rel_l2(v.numpy(), expected[name].numpy()) <= 1e-5, name


def test_sac_learner_window_against_jax():
    """The learner's ring filled as the Sebulba learner fills it (each
    worker's segment into its env slice), then one window of 3 updates."""
    from sheeprl_tpu.algos.sac.sac import make_sac_train_fns
    from sheeprl_tpu.data.device_replay import DeviceReplay as JaxDeviceReplay
    from sheeprl_tpu.data.device_replay import fused_uniform_train as jax_fused
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainer, VectorLayout
    from sheeprl_tpu_torch.data import device_replay as pdr
    from sheeprl_tpu_torch.envs import spaces
    from tests.test_torch_device_replay import jax_uniform_draws
    from tests.test_torch_sac import (ACT_DIM, LOSS_RTOL, OBS_DIM, SAC, action_noise, assert_agent_matches,
                                      jax_optimizers, jax_update_keys, plain_apply, setup)

    U, B, E, Ew, S = 3, 8, 4, 2, 4
    jcfg, cfg, actor, critic, params, agent = setup(SAC)
    opts, o_state = jax_optimizers(jcfg, params)
    _, train_phase = make_sac_train_fns(actor, critic, plain_apply, *opts, jcfg, ACT_DIM)
    jring, pring = JaxDeviceReplay(16, E), pdr.DeviceReplay(16, E)
    rng = np.random.default_rng(7)
    for _ in range(2):  # two rounds, each worker's segment into its slice
        for worker in range(E // Ew):
            seg = {"obs": rng.standard_normal((S, Ew, OBS_DIM)).astype(np.float32),
                   "next_obs": rng.standard_normal((S, Ew, OBS_DIM)).astype(np.float32),
                   "actions": rng.uniform(-0.99, 0.99, (S, Ew, ACT_DIM)).astype(np.float32),
                   "rewards": rng.standard_normal((S, Ew, 1)).astype(np.float32),
                   "terminated": (rng.random((S, Ew, 1)) < 0.3).astype(np.float32)}
            jring.add(seg, indices=range(worker * Ew, worker * Ew + Ew))
            pring.add(seg, indices=range(worker * Ew, worker * Ew + Ew))
    key = jax.random.PRNGKey(5)
    k_sample, k_train = jax.random.split(key)
    noise = [{"next": action_noise(k_next, B), "pi": action_noise(k_pi, B)}
             for k_next, k_pi, *_ in jax_update_keys(k_train, U)]
    layout = VectorLayout(compose([*SAC, "algo.mlp_keys.encoder=[state]"]),
                          spaces.Dict({"state": spaces.Box(-1, 1, (OBS_DIM,), np.float32)}))
    trainer = SACTrainer(cfg, agent, SACTrainer.build_optimizers(cfg, agent), ACT_DIM)
    indices = pring.uniform_indices_from(*jax_uniform_draws(jring, k_sample, U * B, False))
    counter, got = pdr.fused_uniform_train(trainer, pring, None, B, U, layout.prep, 0, indices=indices, noise=noise)

    def jax_prep(b):
        return {"obs": b["obs"], "next_obs": b["next_obs"], "actions": b["actions"],
                "rewards": b["rewards"][..., 0], "terminated": b["terminated"][..., 0]}

    fused = jax_fused(jax_build_fabric(jcfg), train_phase, jring, B, jax_prep, name="test.sebulba_sac")
    new_params, _, j_counter, want = fused(params, o_state, jring.buffers, jring.cursor, key, jnp.int32(0),
                                           n_samples=U)
    assert counter == int(j_counter) == U
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=LOSS_RTOL)
    assert_agent_matches(agent, jax.device_get(new_params))


# -- the slice through cli.run, against JAX's run of the same config ----------------------------
COMMON = ["env.capture_video=False", "fabric.accelerator=cpu", "algo.run_test=False", "checkpoint.every=0",
          "checkpoint.save_last=False", "buffer.memmap=False", "print_config=False", "algo.max_recompiles=1"]
PPO_WORKERS = ["exp=ppo_decoupled", "env=dummy", "env.id=discrete_dummy", "env.max_episode_steps=16", "env.num_envs=4",
               "env.sync_env=True", "topology=sebulba", "topology.env_workers=2", "topology.traj_queue_slots=2",
               "algo.rollout_steps=4", "algo.per_rank_batch_size=8", "algo.update_epochs=1",
               "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]", "algo.dense_units=8", "algo.mlp_layers=1",
               "metric.log_level=1", "metric.log_every=1"]
PPO_FUSED = ["exp=ppo_decoupled", "env=jax_cartpole", "env.num_envs=4", "topology=sebulba", "topology.actor_devices=1",
             "topology.traj_queue_slots=2", "algo.rollout_steps=4", "algo.per_rank_batch_size=8",
             "algo.update_epochs=1", "algo.cnn_keys.encoder=[]", "algo.mlp_keys.encoder=[state]", "algo.dense_units=8",
             "algo.mlp_layers=1", "buffer.transfer_guard=True", "metric.log_level=0"]
SAC_WORKERS = ["exp=sac_decoupled", "env=dummy", "env.id=continuous_dummy", "env.max_episode_steps=16",
               "env.num_envs=4", "env.sync_env=True", "topology=sebulba", "topology.env_workers=2",
               "topology.segment_steps=4", "algo.per_rank_batch_size=8", "algo.learning_starts=16",
               "algo.replay_ratio=0.5", "algo.mlp_keys.encoder=[state]", "algo.hidden_size=8", "buffer.size=256",
               "buffer.device=True", "metric.log_level=1", "metric.log_every=1"]


def _stats_of(monkeypatch, *modules):
    """Record the stats dict each package's runtime assembles."""
    seen = []
    for module in modules:
        orig = module.collect_run_stats

        def spy(_orig=orig, **kw):
            seen.append(_orig(**kw))
            return seen[-1]

        monkeypatch.setattr(module, "collect_run_stats", spy)
    return seen


def _run_port(overrides, log_dir):
    PREEMPTION_GUARD.reset()
    try:
        run([*COMMON, *overrides, f"log_dir={log_dir}"])
    finally:
        PREEMPTION_GUARD.reset()


CLI_CASES = {"ppo-workers": (PPO_WORKERS, "algo.total_steps=64", jax_sppo, sppo),
             "ppo-fused": (PPO_FUSED, "algo.total_steps=64", jax_sppo, sppo),
             "sac-workers": (SAC_WORKERS, "algo.total_steps=96", jax_ssac, ssac)}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_run_reports_jax_counters(case, tmp_path, monkeypatch):
    overrides, steps, jax_module, port_module = CLI_CASES[case]
    seen = _stats_of(monkeypatch, jax_module, port_module)
    try:
        jax_run([*overrides, steps, *COMMON, f"log_dir={tmp_path}/jax"])
    finally:
        # JAX's run leaves its SIGTERM latch installed; processes this worker
        # forks later would inherit it
        JAX_PREEMPTION_GUARD.reset()
    _run_port([*overrides, steps], tmp_path / "port")
    want, got = seen
    assert set(got) == set(want)
    for key in ("updates", "env_steps", "torn_rejected", "worker_restarts"):
        assert got[key] == want[key], key
    assert got["torn_rejected"] == 0 and got["env_steps"] == int(steps.split("=")[1])
    assert [list(s.values()) for s in got["actor_cache_sizes"]] == [[1] * len(s) for s in got["actor_cache_sizes"]]
    assert got["param_staleness_max"] <= 2 + 1 and got["traj_staleness_max"] <= 2 + 4
    assert 0.0 <= got["actor_idle_frac"] <= 1.0 and 0.0 <= got["queue_depth_frac"] <= 1.0
    if port_module is sppo:
        assert got["updates"] == 4


# -- the drills (JAX's TestChaosDrills and TestPreemption) --------------------------------------
@pytest.mark.parametrize("kind", ["raise", "hang"])
def test_a_crashed_or_hung_worker_is_respawned(kind, tmp_path, monkeypatch):
    """A planted ``sebulba.env_worker`` fault at its 6th step: the worker dies
    (``raise``) or wedges for 2.5 s past a 1 s deadline (``hang``); the
    supervisor deposes and respawns it, and the run completes with every env
    step and nothing torn."""
    seen = _stats_of(monkeypatch, sppo)
    spec = {"site": "sebulba.env_worker", "kind": kind, "at": 6, "max_fires": 1}
    extra = ["algo.total_steps=96"]
    if kind == "hang":
        spec["seconds"] = 2.5
        extra.append("topology.worker_deadline_s=1.0")
    monkeypatch.setenv(ENV_VAR, FaultPlan.from_specs([spec]).to_json())  # what cli.run installs
    try:
        _run_port([*PPO_WORKERS, *extra], tmp_path)
    finally:
        clear_plan()
    (stats,) = seen
    assert stats["worker_restarts"] >= 1 and stats["updates"] == 6
    assert stats["env_steps"] == 96 and stats["torn_rejected"] == 0


def test_sigterm_mid_run_commits_a_save_that_a_resumed_run_continues(tmp_path, monkeypatch):
    seen = _stats_of(monkeypatch, sppo)
    base_updates = SPANS.updates_done
    stop = threading.Event()

    def preempt_after_progress():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not stop.is_set():
            if SPANS.updates_done >= base_updates + 2:
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.02)

    killer = threading.Thread(target=preempt_after_progress, daemon=True)
    killer.start()
    try:
        _run_port([*PPO_WORKERS, "algo.total_steps=100000", "checkpoint.save_last=True"], tmp_path / "first")
    finally:
        stop.set()
        killer.join(5)
    (stats,) = seen
    assert 2 <= stats["updates"] < 100000 // 16
    steps = [checkpoint_step(p) for p in glob.glob(f"{tmp_path}/first/**/checkpoint/step_*", recursive=True)]
    committed = sorted(s for s in steps if s >= 0)
    assert committed and committed[-1] >= 2 * 16
    (snapshot,) = [p for p in glob.glob(f"{tmp_path}/first/**/checkpoint/step_*", recursive=True)
                   if checkpoint_step(p) == committed[-1]]
    state = load_step_dir(snapshot)
    total = state["policy_step"] + 2 * 16
    _run_port([*PPO_WORKERS, f"algo.total_steps={total}", "checkpoint.save_last=True",
               f"checkpoint.resume_from={snapshot}"], tmp_path / "resumed")
    resumed = seen[-1]
    (after,) = glob.glob(f"{tmp_path}/resumed/**/checkpoint/step_*", recursive=True)
    after_state = load_step_dir(after)
    assert after_state["policy_step"] == total and after_state["update"] == total // 16
    assert resumed["updates"] == total // 16 - state["update"]
    assert after_state["opt_state"]["state"][0]["step"].item() > state["opt_state"]["state"][0]["step"].item()


# -- a Sebulba-written snapshot, served --------------------------------------------------------
def test_a_sebulba_snapshot_serves_as_the_ppo_player(tmp_path):
    from sheeprl_tpu_torch.serve.loader import probe_spaces
    from sheeprl_tpu_torch.serve.players import PLAYER_BUILDERS, build_ppo_player
    from sheeprl_tpu_torch.serve.service import PolicyService

    assert PLAYER_BUILDERS["ppo_decoupled"] is PLAYER_BUILDERS["ppo"] is build_ppo_player
    _run_port([*PPO_WORKERS, "algo.total_steps=32", "checkpoint.save_last=True"], tmp_path)
    (snapshot,) = glob.glob(f"{tmp_path}/**/checkpoint/step_*", recursive=True)
    service = PolicyService.from_checkpoint(snapshot, ["fabric.accelerator=cpu", "serve.batch_ladder=[1,4]"])
    try:
        served = service.player
        state = load_step_dir(snapshot)
        cfg = compose([*PPO_WORKERS, "exp=ppo", "fabric.accelerator=cpu"])
        obs_space, act_space = probe_spaces(cfg)
        ref = build_ppo_player(build_fabric(cfg), cfg, state, obs_space, act_space)
        rows = {"state": np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32)}
        greedy = torch.ones(4, dtype=torch.bool)
        with torch.no_grad():
            _, a_served = served.step(served.params, (), {k: _t(v) for k, v in served.prepare(rows).items()}, 0, greedy)
            _, a_ref = ref.step(ref.params, (), {k: _t(v) for k, v in ref.prepare(rows).items()}, 0, greedy)
        assert served.algo == "ppo_decoupled"
        np.testing.assert_array_equal(a_served.numpy(), a_ref.numpy())
    finally:
        service.stop()
