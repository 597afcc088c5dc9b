"""Snapshots the JAX package wrote, read and served by the port with no JAX.

The JAX package writes, through its own checkpoint code: the committed
DreamerV3 fixture (``tests/fixtures/jax_dv3``: a dry run of its ``cli.run``
at narrow widths with ``fused_pallas=True``, ``tools/write_jax_fixture.py``),
and here a PPO and a SAC step directory and a legacy ``.ckpt`` file (a
typed PRNG key among them).  In a subprocess whose imports refuse ``jax``,
``flax``, ``optax`` and ``sheeprl_tpu`` (as ``test_torch_no_jax.py``), the
port loads each through ``serve.loader.load_policy`` and steps it: the
DreamerV3 world model's next ``h``, posterior logits and the actor's logits
within ``test_torch_serve.py``'s 1e-4 of the JAX outputs recorded on the
same inputs and posterior noise, the sampled latent and greedy actions
equal; PPO's and SAC's greedy actions equal JAX's player's (SAC within
1e-4).  Every global the JAX pickles name is on the port's list, an
unlisted one is refused, training resumes from the fixture and from the
committed JAX population, and the committed fixture is still what the tool
writes.
"""

import json
import pathlib
import pickle
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import yaml

from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.parallel.fabric import build_fabric as jax_build_fabric
from sheeprl_tpu.serve.loader import load_policy as jax_load_policy
from sheeprl_tpu.serve.loader import probe_spaces as jax_probe_spaces
from sheeprl_tpu_torch.checkpoint.serialize import JAX_GLOBALS, load_jax_pickle

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "jax_dv3"
sys.path.insert(0, str(ROOT / "tools"))
import write_jax_fixture  # noqa: E402

TOL = 1e-4
JAX_RUNS = {
    "ppo": ["exp=ppo", "env=dummy", "env.sync_env=True", "env.id=discrete_dummy", "algo.cnn_keys.encoder=[rgb]",
            "algo.mlp_keys.encoder=[state]", "algo.encoder.cnn_features_dim=8", "algo.dense_units=8",
            "algo.mlp_layers=1", "fabric.accelerator=cpu"],
    "sac": ["exp=sac", "env=dummy", "env.sync_env=True", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]",
            "algo.hidden_size=8", "fabric.accelerator=cpu"],
}


def _drawn(shapes, seed=0):
    """Parameters of the JAX builder's shapes drawn with numpy: kernels ~
    N(0, 1/fan_in), the rest small (no weight at an init value that could
    hide a layout error)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if str(getattr(path[-1], "key", path[-1])).endswith("kernel"):
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        return 0.1 * noise

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_state(name, cfg):
    """A state shaped as the JAX loops checkpoint it: the agent's parameters
    (the shapes of the JAX ``build_agent``), its optimizer states, a raw and
    a typed PRNG key, counters."""
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu.utils.optim import build_optimizer

    fabric = jax_build_fabric(cfg)
    obs_space, action_space = jax_probe_spaces(cfg)
    if name == "ppo":
        from sheeprl_tpu.algos.ppo.agent import build_agent

        dims, cont = spaces_to_dims(action_space)
        params = _drawn(jax.eval_shape(lambda: build_agent(fabric, dims, cont, cfg, obs_space)[1]))
        opt_state = build_optimizer(cfg.algo.optimizer, cfg.algo.max_grad_norm).init(params)
    else:
        from sheeprl_tpu.algos.sac.agent import build_agent

        obs_dim = int(sum(np.prod(obs_space[k].shape) for k in cfg.algo.mlp_keys.encoder))
        act_dim = int(np.prod(action_space.shape))
        params = _drawn(jax.eval_shape(lambda: build_agent(fabric, act_dim, cfg, obs_dim)[2]))
        opt_state = {"actor": build_optimizer(cfg.algo.actor.optimizer).init(params["actor"]),
                     "critic": build_optimizer(cfg.algo.critic.optimizer).init(params["critic"]),
                     "alpha": build_optimizer(cfg.algo.alpha.optimizer).init(params["log_alpha"])}
    return {"agent": params, "opt_state": opt_state, "key": jax.random.PRNGKey(1), "player_key": jax.random.key(2),
            "policy_step": 8, "update": 1}


def _write_jax_run(run_dir, name, legacy=False):
    """The JAX package's own snapshot of a ``name`` agent under ``run_dir``:
    a committed step directory (``checkpoint/protocol.py``) and, with
    ``legacy``, the same state as a single file
    (``utils/checkpoint.py::save_checkpoint``).  Returns both paths."""
    from sheeprl_tpu.checkpoint.protocol import step_dir_name, write_commit, write_shard
    from sheeprl_tpu.checkpoint.serialize import snapshot_tree, to_host_tree
    from sheeprl_tpu.utils.checkpoint import save_checkpoint

    cfg = jax_compose(JAX_RUNS[name])
    state = _jax_state(name, cfg)
    version = run_dir / "version_0"
    (version / "checkpoint").mkdir(parents=True)
    (version / "config.yaml").write_text(yaml.safe_dump(cfg.as_dict()))
    step = version / "checkpoint" / step_dir_name(8)
    write_shard(step, 0, to_host_tree(snapshot_tree(state)))
    assert write_commit(step, 8, 1, timeout_s=10.0)
    if not legacy:
        return step, None
    legacy_dir = run_dir.with_name(run_dir.name + "_legacy") / "version_0"
    (legacy_dir / "checkpoint").mkdir(parents=True)
    shutil.copy(version / "config.yaml", legacy_dir / "config.yaml")
    save_checkpoint(legacy_dir / "checkpoint" / "ckpt_8_0.ckpt", state)
    return step, legacy_dir / "checkpoint" / "ckpt_8_0.ckpt"


def _jax_greedy(path, B=3):
    """The JAX player's observations and greedy actions for ``path``."""
    _, _, _, player = jax_load_policy(path, ["fabric.accelerator=cpu"])
    rng = np.random.default_rng(5)
    raw = {k: (rng.integers(0, 256, (B, *shape), dtype=np.uint8) if dt == "uint8"
               else rng.standard_normal((B, *shape)).astype(np.float32)) for k, (shape, dt) in player.obs_spec.items()}
    _, actions = player.step_batch(player.params, (), player.prepare(raw), 0, np.ones(B, bool))
    return raw, player.postprocess(np.asarray(actions))


PORT_SCRIPT = textwrap.dedent(
    """
    import importlib.abc, json, sys
    sys.path.insert(0, {root!r})
    BLOCKED = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"{{name}} is blocked: the port must not import it")
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    import torch
    from sheeprl_tpu_torch.serve.loader import load_policy

    cases = json.loads(sys.argv[1])
    out = {{}}
    for name, (path, inputs) in cases.items():
        _, cfg, _, player = load_policy(path, ["fabric.accelerator=cpu"])
        x = dict(np.load(inputs))
        if name == "dreamer_v3":
            wm, actor = player.params["world_model"], player.params["actor"]
            obs = {{k: torch.from_numpy(v) for k, v in player.prepare({{"rgb": x["rgb"], "state": x["state"]}}).items()}}
            t = {{k: torch.from_numpy(x[k]) for k in ("h", "z", "a", "noise")}}
            B = t["h"].shape[0]
            with torch.no_grad():
                h, z, post, _ = wm.dynamic_noise(t["h"], t["z"], t["a"], wm.encode(obs), torch.zeros(B, 1), t["noise"])
                logits = actor(torch.cat([z, h], -1))
                greedy = actor.sample(logits, torch.Generator().manual_seed(0), greedy=True)
                (h_s, z_s, a_s), served = player.step(player.params, (t["h"], t["z"], t["a"]), obs, 0,
                                                      torch.ones(B, dtype=torch.bool), post_noise=t["noise"])
            res = {{"h_next": h, "post_logits": post, "z_next": z, "actor_logits": logits, "greedy_action": greedy,
                   "served_h": h_s, "served_action": served}}
        else:
            _, actions = player.step_batch(player.params, (), player.prepare({{k: x[k] for k in player.obs_spec}}), 0,
                                           np.ones(len(x["expected"]), bool))
            res = {{"greedy_action": player.postprocess(actions)}}
        np.savez(inputs.replace(".npz", ".port.npz"), **{{k: np.asarray(v) for k, v in res.items()}})
    leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
    assert not leaked, leaked
    print("ok")
    """
)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """The fixture copied out of the tree, the PPO and SAC step directories
    and the legacy SAC file, each with its JAX player's greedy actions."""
    tmp = tmp_path_factory.mktemp("jax_written")
    shutil.copytree(FIXTURE, tmp / "dv3")
    paths = {"dreamer_v3": tmp / "dv3", "ppo": _write_jax_run(tmp / "ppo", "ppo")[0]}
    paths["sac"], paths["sac_legacy"] = _write_jax_run(tmp / "sac", "sac", legacy=True)
    cases = {"dreamer_v3": (str(paths["dreamer_v3"]), str(FIXTURE / "outputs.npz"))}
    for name in ("ppo", "sac"):
        raw, expected = _jax_greedy(paths[name])
        np.savez(tmp / f"{name}.npz", expected=expected, **raw)
        cases[name] = (str(paths[name]), str(tmp / f"{name}.npz"))
    shutil.copy(tmp / "sac.npz", tmp / "sac_legacy.npz")  # the same state: the same actions
    cases["sac_legacy"] = (str(paths["sac_legacy"]), str(tmp / "sac_legacy.npz"))
    return paths, cases


def test_the_port_serves_jax_snapshots_with_jax_blocked(jax_written, tmp_path):
    _, cases = jax_written
    cases = {**cases, "dreamer_v3": (cases["dreamer_v3"][0], str(tmp_path / "dv3.npz"))}
    shutil.copy(FIXTURE / "outputs.npz", tmp_path / "dv3.npz")
    proc = subprocess.run([sys.executable, "-c", PORT_SCRIPT.format(root=str(ROOT)), json.dumps(cases)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr
    jx = np.load(FIXTURE / "outputs.npz")
    port = np.load(tmp_path / "dv3.port.npz")
    for key in ("h_next", "post_logits", "actor_logits"):
        np.testing.assert_allclose(port[key], jx[key], rtol=TOL, atol=TOL, err_msg=key)
    shape = (-1, *jx["noise"].shape[1:])  # the sample's categories (straight-through values differ by ulps)
    np.testing.assert_array_equal(port["z_next"].reshape(shape).argmax(-1), jx["z_next"].reshape(shape).argmax(-1))
    np.testing.assert_array_equal(port["greedy_action"], jx["greedy_action"])
    np.testing.assert_allclose(port["served_h"], jx["h_next"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(port["served_action"], jx["greedy_action"])
    for name in ("ppo", "sac", "sac_legacy"):
        expected = np.load(cases[name][1])["expected"]
        got = np.load(cases[name][1].replace(".npz", ".port.npz"))["greedy_action"]
        if name == "ppo":
            np.testing.assert_array_equal(got, expected)
        else:
            np.testing.assert_allclose(got, expected, rtol=TOL, atol=TOL, err_msg=name)


def test_every_global_of_the_jax_snapshots_is_on_the_list(jax_written):
    paths, _ = jax_written
    pickles = [paths["dreamer_v3"] / "checkpoint" / "step_000000000040" / "shard_r00000.pkl",
               paths["ppo"] / "shard_r00000.pkl", paths["sac"] / "shard_r00000.pkl", paths["sac_legacy"]]
    listed = {".".join(key) for key in JAX_GLOBALS}
    found = {g for p in pickles for g in write_jax_fixture.pickle_globals(p)}
    assert found - listed == set(), f"globals the JAX package writes that the port's list lacks: {found - listed}"
    assert "sheeprl_tpu.checkpoint.serialize.KeyArrayRef" in found  # the typed key made it in
    state = load_jax_pickle(paths["sac_legacy"])
    assert type(state["player_key"]).__name__ == "KeyArrayRef" and state["player_key"].impl.startswith("threefry")


class _Payload:
    def __reduce__(self):
        import os

        return (os.system, ("echo the snapshot ran code",))


@pytest.mark.parametrize("payload", [_Payload(), __import__("collections").OrderedDict(a=1)],
                         ids=["os.system", "OrderedDict"])
def test_a_pickle_with_an_unlisted_global_is_refused(payload, capfd):
    with pytest.raises(pickle.UnpicklingError, match="refusing global"):
        load_jax_pickle(pickle.dumps({"agent": payload}, protocol=pickle.HIGHEST_PROTOCOL))
    assert "ran code" not in capfd.readouterr().out


@pytest.mark.parametrize("setting", ["checkpoint.resume_from", "checkpoint.exploration_ckpt_path", "population"])
def test_resuming_training_from_a_jax_snapshot_raises(jax_written, tmp_path, setting):
    """Every JAX-written snapshot resumes now (the name is kept from when a
    population snapshot raised, ROADMAP item 6(c)): the fixture resumes a
    DreamerV3 run (its counters go on from step 40, update 20) and seeds a
    P2E-DV3 finetuning run; the committed JAX population
    (``tests/fixtures/jax_ppo_population``, PPO at P = 4) trains one more
    population phase, its PBT carry going on."""
    from sheeprl_tpu_torch.checkpoint.protocol import load_step_dir
    from sheeprl_tpu_torch.cli import run

    paths, _ = jax_written
    snapshot = paths["dreamer_v3"] / "checkpoint" / "step_000000000040"
    fixture = [o for o in write_jax_fixture.DV3_OVERRIDES if not o.startswith(("dry_run", "exp=", "checkpoint.every"))]
    common = [*fixture, "env.sync_env=True", "algo.total_steps=44", "checkpoint.every=1000000",
              f"log_dir={tmp_path}"]
    if setting == "population":
        import write_jax_population_fixture as pop_fixture

        pop = tmp_path / "pop"
        shutil.copytree(pop_fixture.FIXTURE, pop)
        (step,) = (pop / "checkpoint").glob("step_*")
        saved = load_step_dir(step)
        total = int(saved["policy_step"]) + pop_fixture.SIZE * pop_fixture.NUM_ENVS * pop_fixture.ROLLOUT
        run([*pop_fixture.POPULATION_OVERRIDES, f"checkpoint.resume_from={step}", f"algo.total_steps={total}",
             f"log_dir={tmp_path / 'logs'}"])
        (last,) = sorted((tmp_path / "logs").glob("**/checkpoint/step_*"))[-1:]
        resumed = load_step_dir(last)
        assert (resumed["policy_step"], resumed["update"]) == (total, saved["update"] + 1)
        # the carry went on from the snapshot's, not from zero
        assert bool((resumed["population"]["ep_count"].numpy() >= saved["population"]["ep_count"]).all())
        assert int(resumed["population"]["exploits"]) >= int(saved["population"]["exploits"]) > 0
        return
    exp = "exp=dreamer_v3" if setting == "checkpoint.resume_from" else "exp=p2e_dv3_finetuning"
    # a finetuning run counts from 0: 4 iterations, none of them training
    steps = [] if setting == "checkpoint.resume_from" else ["algo.total_steps=8"]
    run([exp, *common, f"{setting}={snapshot}", *steps])
    (last,) = sorted(pathlib.Path(tmp_path).glob("**/checkpoint/step_*"))[-1:]
    saved = load_step_dir(last)
    if setting == "checkpoint.resume_from":
        assert (saved["policy_step"], saved["update"]) == (44, 22)
    else:  # a finetuning run starts its counters afresh from the explored agent
        assert saved["policy_step"] == 8 and set(saved["agent"]) >= {"world_model", "actor", "critic"}


def test_the_fixture_is_what_the_tool_writes():
    """Its ``agent`` and ``opt_state`` trees have the keys, shapes and dtypes
    the JAX package's own builders give for its config, and ``outputs.npz``
    holds the tool's fixed inputs and outputs of the shapes they give."""
    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import build_dv3_optimizers
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu.serve.loader import load_run_config

    step = FIXTURE / "checkpoint" / "step_000000000040"
    cfg = load_run_config(step)
    assert [o for o in write_jax_fixture.DV3_OVERRIDES if "fused_pallas" in o] and \
        cfg.algo.world_model.recurrent_model.fused_pallas
    fabric = jax_build_fabric(cfg)
    obs_space, action_space = jax_probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    params = jax.eval_shape(lambda: build_agent(fabric, dims, cont, cfg, obs_space)[3])
    state = load_jax_pickle(step / "shard_r00000.pkl")
    opt_state = build_dv3_optimizers(fabric, cfg, state["agent"])[3]

    def spec(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p): (tuple(np.shape(v)), str(v.dtype)) for p, v in leaves}

    assert spec(state["agent"]) == spec(params)
    assert spec(state["opt_state"]) == spec(jax.tree_util.tree_map(np.asarray, opt_state))
    assert {"agent", "opt_state", "key", "player_key", "policy_step", "update", "ratio", "psync"} <= set(state)
    recorded = np.load(FIXTURE / "outputs.npz")
    wmc, B = cfg.algo.world_model, write_jax_fixture.BATCH
    inputs = write_jax_fixture.fixed_inputs(wmc.stochastic_size, wmc.discrete_size,
                                            wmc.recurrent_model.recurrent_state_size, sum(dims))
    for key, value in inputs.items():
        np.testing.assert_array_equal(recorded[key], value, err_msg=key)
    stoch_flat = wmc.stochastic_size * wmc.discrete_size
    assert {k: recorded[k].shape for k in set(recorded.files) - set(inputs)} == {
        "h_next": (B, wmc.recurrent_model.recurrent_state_size), "z_next": (B, stoch_flat),
        "post_logits": (B, wmc.stochastic_size, wmc.discrete_size), "actor_logits": (B, sum(dims)),
        "greedy_action": (B, sum(dims))}
    assert sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file()) < 4 << 20
