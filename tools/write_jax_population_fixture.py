#!/usr/bin/env python3
"""Write the JAX-written PPO population snapshot that the port's tests and
``chip_smoke.py`` phase 64 resume with no JAX: ``tests/fixtures/jax_ppo_population/``.

    JAX_PLATFORMS=cpu python tools/write_jax_population_fixture.py

The fixture is what the JAX package itself writes: a run of its ``cli.run``
training a population of :data:`SIZE` PPO agents (actor and critic MLPs of
64 x 2 behind a one-layer 32-wide state encoder, so that the snapshot stays
under 1 MB; the ``jax_cartpole`` device env on the Anakin axis; in-trace
PBT exploiting every second phase) for :data:`PHASES` population phases.
Its committed ``step_*`` directory and its ``config.yaml`` are copied in: a
stacked ``(P, ...)`` agent, the vmapped optax state (Adam under
``inject_hyperparams``, one learning rate per member), the keys, the
counters and the PBT carry (``fitness``, ``ep_count``, ``exploits``,
``hp``).

This tool imports the JAX package; the port never does.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "jax_ppo_population"
SIZE = 4
NUM_ENVS = 4
ROLLOUT = 16
PHASES = 6

POPULATION_OVERRIDES = (
    "exp=ppo", "env=jax_cartpole", f"population.size={SIZE}", "population.exploit_every=2", "population.warmup=1",
    "algo.encoder.mlp_layers=1", "algo.encoder.dense_units=32", "algo.encoder.mlp_features_dim=32",
    f"env.num_envs={NUM_ENVS}", f"algo.rollout_steps={ROLLOUT}", "algo.per_rank_batch_size=16",
    "algo.update_epochs=1", "algo.mlp_keys.encoder=[state]", f"algo.total_steps={SIZE * NUM_ENVS * ROLLOUT * PHASES}",
    "fabric.accelerator=cpu", "env.sync_env=True", "env.capture_video=False", "checkpoint.save_last=True",
    "checkpoint.every=1000000", "checkpoint.async_save=False", "metric.log_level=0", "seed=7",
)


def write_fixture(out: Path = FIXTURE) -> Path:
    """Run the JAX population, copy its last committed snapshot and its
    config under ``out``."""
    sys.path.insert(0, str(ROOT))
    from tools.write_jax_fixture import dry_run

    with tempfile.TemporaryDirectory() as tmp:
        version = dry_run(POPULATION_OVERRIDES, Path(tmp))
        (step,) = (version / "checkpoint").glob("step_*")
        shutil.rmtree(out, ignore_errors=True)
        (out / "checkpoint").mkdir(parents=True)
        shutil.copy2(version / "config.yaml", out / "config.yaml")
        shutil.copytree(step, out / "checkpoint" / step.name)
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {out.relative_to(ROOT)}: {size / 2**20:.2f} MiB")
    return out


if __name__ == "__main__":
    write_fixture()
