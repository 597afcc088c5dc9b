#!/usr/bin/env python3
"""Write the JAX-written DreamerV3 snapshot that the port's tests and
``chip_smoke.py`` phase 55 read with no JAX: ``tests/fixtures/jax_dv3/``.

    JAX_PLATFORMS=cpu python tools/write_jax_fixture.py          # (re)write the fixture
    JAX_PLATFORMS=cpu python tools/write_jax_fixture.py --scan   # globals of real JAX snapshots

The fixture is what the JAX package itself writes: a dry run of its
``cli.run`` (DreamerV3 at narrow widths, ``fused_pallas=True``, the dummy
env's 64x64 ``rgb`` and 4-wide ``state``, 20 iterations and one update),
whose committed ``step_*`` directory and ``config.yaml`` are copied in.
Beside them, ``outputs.npz`` holds the JAX world model's and actor's own
outputs on fixed inputs (:data:`BATCH` rows drawn from a seed): the inputs
(``rgb``, ``state``, the carry ``h``, ``z``, ``a`` and the posterior's
Gumbel ``noise``), then ``h_next`` (one posterior RSSM step), the posterior
logits, the sampled ``z_next``, the actor's logits and its greedy action.

``--scan`` runs a dry run of each family the port serves or registers and
prints every global their pickles name: the list
``sheeprl_tpu_torch/checkpoint/serialize.py::JAX_GLOBALS`` is built from it.

This tool imports the JAX package; the port never does.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickletools
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "jax_dv3"
BATCH = 4
SEED = 13

DV3_OVERRIDES = (
    "exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "algo=dreamer_v3_XS", "env.num_envs=2",
    "env.capture_video=False", "fabric.accelerator=cpu", "metric.log_level=0", "buffer.memmap=False",
    "checkpoint.every=1000000", "checkpoint.async_save=False", "algo.per_rank_batch_size=2",
    "algo.per_rank_sequence_length=8", "algo.learning_starts=0", "algo.horizon=4", "algo.cnn_keys.encoder=[rgb]",
    "algo.mlp_keys.encoder=[state]", "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.dense_units=16",
    "algo.mlp_layers=1", "algo.world_model.recurrent_model.recurrent_state_size=16",
    "algo.world_model.transition_model.hidden_size=16", "algo.world_model.representation_model.hidden_size=16",
    "algo.world_model.discrete_size=5", "algo.world_model.stochastic_size=4",
    "algo.world_model.recurrent_model.fused_pallas=True", "env.max_episode_steps=20", "buffer.size=200",
    "dry_run=True", "algo.run_test=False",
)
#: the dry runs ``--scan`` reads, one per family the port serves or registers
SCAN_RUNS = {
    "dreamer_v3": DV3_OVERRIDES,
    "ppo": ("exp=ppo", "env=dummy", "env.id=discrete_dummy", "algo.cnn_keys.encoder=[rgb]",
            "algo.mlp_keys.encoder=[state]", "algo.encoder.cnn_features_dim=8", "algo.update_epochs=1",
            "algo.rollout_steps=8", "algo.per_rank_batch_size=8", "algo.dense_units=8", "algo.mlp_layers=1",
            "dry_run=True", "env.max_episode_steps=12"),
    "a2c": ("exp=a2c", "env=dummy", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]",
            "algo.optimizer.name=rmsprop", "algo.rollout_steps=8", "algo.per_rank_batch_size=8",
            "algo.dense_units=8", "algo.mlp_layers=1", "dry_run=True", "env.max_episode_steps=12"),
    "sac": ("exp=sac", "env=dummy", "env.id=continuous_dummy", "algo.mlp_keys.encoder=[state]",
            "algo.total_steps=8", "algo.learning_starts=4", "algo.per_rank_batch_size=2", "algo.hidden_size=4",
            "buffer.size=32", "env.max_episode_steps=6", "algo.run_test=False"),
}
SCAN_COMMON = ("env.num_envs=2", "env.capture_video=False", "fabric.accelerator=cpu", "metric.log_level=0",
               "buffer.memmap=False", "checkpoint.every=1000000", "checkpoint.async_save=False")


@contextlib.contextmanager
def _inside(path: Path):
    """Run inside ``path`` (so the run config records a relative log_dir)."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def dry_run(overrides: Sequence[str], workdir: Path) -> Path:
    """One dry run of the JAX package's ``cli.run`` under ``workdir``;
    returns its ``version_0`` directory."""
    from sheeprl_tpu.cli import run

    with _inside(workdir):
        run([*overrides, "log_dir=logs/runs", "print_config=False"])
    (version,) = workdir.glob("logs/runs/**/version_0")
    return version


def pickle_globals(path: Path) -> List[str]:
    """Every ``module.name`` global a pickle file names (``GLOBAL`` and
    ``STACK_GLOBAL``, whose two strings are the last pushed before it)."""
    found, strings = set(), []
    for op, arg, _ in pickletools.genops(path.read_bytes()):
        if isinstance(arg, str):
            strings.append(arg)
        if op.name == "GLOBAL":
            found.add(arg.replace(" ", "."))
        elif op.name == "STACK_GLOBAL":
            found.add(".".join(strings[-2:]))
    return sorted(found)


def gumbel(rng: np.random.Generator, shape: Sequence[int]) -> np.ndarray:
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, size=shape)
    return (-np.log(-np.log(u))).astype(np.float32)


def fixed_inputs(stoch: int, discrete: int, rec: int, actions: int) -> Dict[str, np.ndarray]:
    """The fixed batch the outputs are recorded on."""
    rng = np.random.default_rng(SEED)
    eye_z, eye_a = np.eye(discrete, dtype=np.float32), np.eye(actions, dtype=np.float32)
    return {
        "rgb": rng.integers(0, 256, (BATCH, 64, 64, 3), dtype=np.uint8),
        "state": rng.standard_normal((BATCH, 4)).astype(np.float32),
        "h": np.tanh(rng.standard_normal((BATCH, rec))).astype(np.float32),
        "z": eye_z[rng.integers(0, discrete, (BATCH, stoch))].reshape(BATCH, stoch * discrete),
        "a": eye_a[rng.integers(0, actions, BATCH)],
        "noise": gumbel(rng, (BATCH, stoch, discrete)),
    }


def record_outputs(fixture: Path) -> Dict[str, np.ndarray]:
    """The JAX world model's and actor's outputs on :func:`fixed_inputs`,
    from the snapshot under ``fixture`` as the JAX package loads it."""
    import jax
    import jax.numpy as jnp

    from sheeprl_tpu.algos.dreamer_v3.agent import build_agent
    from sheeprl_tpu.algos.ppo.utils import spaces_to_dims
    from sheeprl_tpu.parallel.fabric import build_fabric
    from sheeprl_tpu.serve.loader import load_run_config, probe_spaces, resolve_checkpoint
    from sheeprl_tpu.utils.checkpoint import load_checkpoint

    ckpt = resolve_checkpoint(fixture)
    cfg = load_run_config(ckpt)
    fabric = build_fabric(cfg)
    obs_space, action_space = probe_spaces(cfg)
    dims, cont = spaces_to_dims(action_space)
    wm, actor, _, params = build_agent(fabric, dims, cont, cfg, obs_space, load_checkpoint(ckpt)["agent"])
    wmc = cfg.algo.world_model
    x = fixed_inputs(wmc.stochastic_size, wmc.discrete_size, wmc.recurrent_model.recurrent_state_size, sum(dims))
    obs = {"rgb": jnp.asarray(x["rgb"], jnp.float32) / 255.0 - 0.5, "state": jnp.asarray(x["state"])}
    WM = type(wm)
    embed = wm.apply(params["world_model"], obs, method=WM.encode)
    h, z, post, _ = wm.apply(params["world_model"], x["h"], x["z"], x["a"], embed, jnp.zeros((BATCH, 1)),
                             jnp.asarray(x["noise"]), method=WM.dynamic_noise)
    logits = actor.apply(params["actor"], jnp.concatenate([z, h], -1))
    greedy = actor.sample(logits, jax.random.PRNGKey(0), greedy=True)
    out = {"h_next": h, "post_logits": post, "z_next": z, "actor_logits": logits, "greedy_action": greedy}
    return {**x, **{k: np.asarray(v, np.float32) for k, v in out.items()}}


def write_fixture(out: Path = FIXTURE) -> Path:
    """Run the JAX dry run, copy its snapshot and config under ``out`` and
    record ``outputs.npz``."""
    with tempfile.TemporaryDirectory() as tmp:
        version = dry_run(DV3_OVERRIDES, Path(tmp))
        (step,) = (version / "checkpoint").glob("step_*")
        shutil.rmtree(out, ignore_errors=True)
        (out / "checkpoint").mkdir(parents=True)
        shutil.copy2(version / "config.yaml", out / "config.yaml")
        shutil.copytree(step, out / "checkpoint" / step.name)
    np.savez_compressed(out / "outputs.npz", **record_outputs(out))
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {out.relative_to(ROOT)}: {size / 2**20:.2f} MiB")
    return out


def scan() -> Dict[str, List[str]]:
    """The globals of each family's real dry-run snapshot."""
    found = {}
    for name, overrides in SCAN_RUNS.items():
        with tempfile.TemporaryDirectory() as tmp:
            version = dry_run([*overrides, *SCAN_COMMON], Path(tmp))
            (shard,) = version.glob("checkpoint/step_*/shard_r00000.pkl")
            found[name] = pickle_globals(shard)
        print(f"{name}: {found[name]}", flush=True)
    return found


def main(argv: Any = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scan", action="store_true", help="print the globals of real JAX snapshots")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.scan:
        scan()
    else:
        write_fixture()
    return 0


if __name__ == "__main__":
    sys.exit(main())
