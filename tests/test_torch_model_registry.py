"""The port's model registry and its entry points on the CPU, held to the JAX
package: ``utils/model_manager.py`` and ``utils/mlflow_manager.py`` (the
cases of ``tests/test_utils/test_model_manager.py``), the names, keys and
metadata ``register_model_from_checkpoint`` writes against JAX's for the
same config, a JAX-registered ``params.pkl`` read as JAX's numpy tree,
``algo.extra_modules`` imported by ``run``, ``evaluation``,
``registration`` and ``serve``, ``available_agents`` and the dispatch of
``python -m sheeprl_tpu_torch``."""

import csv
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sheeprl_tpu.config.compose import compose as jax_compose
from sheeprl_tpu.utils.model_manager import FileSystemModelManager as JaxManager
from sheeprl_tpu.utils.model_manager import register_model_from_checkpoint as jax_register
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.checkpoint.protocol import write_snapshot
from sheeprl_tpu_torch.config.compose import compose
from sheeprl_tpu_torch.serve.loader import write_run_config
from sheeprl_tpu_torch.utils.model_manager import FileSystemModelManager, register_model_from_checkpoint
from sheeprl_tpu_torch.utils.structured import dotdict


def test_register_load_roundtrip(tmp_path):
    mm = FileSystemModelManager(tmp_path / "registry")
    params = {"w": torch.randn(3, 3), "nested": {"b": torch.arange(4, dtype=torch.int64)}}
    assert mm.register_model("ppo_agent", params, description="test") == 1
    assert mm.register_model("ppo_agent", {"w": torch.zeros(3, 3)}) == 2
    assert mm.get_latest_version("ppo_agent") == 2
    first = mm.load_model("ppo_agent", version=1)
    assert torch.equal(first["w"], params["w"]) and torch.equal(first["nested"]["b"], params["nested"]["b"])
    assert torch.equal(mm.load_model("ppo_agent")["w"], torch.zeros(3, 3))  # latest
    assert mm.models() == ["ppo_agent"]


def test_transition_and_info(tmp_path):
    mm = FileSystemModelManager(tmp_path / "registry")
    mm.register_model("m", {"w": torch.zeros(2)}, metadata={"algo": "ppo"})
    mm.transition_model("m", 1, "production")
    info = mm.get_model_info("m", 1)
    assert info["stage"] == "production" and info["metadata"] == {"algo": "ppo"} and info["version"] == 1


def test_delete(tmp_path):
    mm = FileSystemModelManager(tmp_path / "registry")
    mm.register_model("m", {"w": torch.zeros(2)})
    mm.register_model("m", {"w": torch.zeros(2)})
    mm.delete_model("m", 1)
    assert mm.get_latest_version("m") == 2
    mm.delete_model("m")
    assert mm.get_latest_version("m") is None


def test_missing_model_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        FileSystemModelManager(tmp_path / "registry").load_model("nope")


def test_register_best_models(tmp_path):
    """The run whose metric peaked highest wins; its last checkpoint's
    sub-models are registered (a committed snapshot, or a legacy file)."""
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint
    from sheeprl_tpu_torch.utils.model_manager import register_best_models

    log_dir = tmp_path / "runs"
    for run, (reward, w) in {"a": (10.0, 1.0), "b": (99.0, 2.0), "c": (50.0, 3.0)}.items():
        vdir = log_dir / run / "version_0"
        (vdir / "checkpoint").mkdir(parents=True)
        with open(vdir / "metrics.csv", "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["step", "name", "value"])
            wr.writerow([1, "Rewards/rew_avg", reward / 2])
            wr.writerow([2, "Rewards/rew_avg", reward])
        state = {"agent": {"actor": {"w": torch.full((2,), w)}}}
        if run == "c":
            save_checkpoint(vdir / "checkpoint" / "ckpt_2_0.ckpt", state)
        else:
            write_snapshot(vdir / "checkpoint", 2, state)
    cfg = dotdict({"algo": {"name": "ppo"}, "env": {"id": "CartPole-v1"}, "seed": 0,
                   "model_manager": {"registry_root": str(tmp_path / "registry")}})
    assert register_best_models(str(log_dir), cfg, metric="Rewards/rew_avg") == {"actor": 1}
    assert float(FileSystemModelManager(tmp_path / "registry").load_model("ppo_actor")["w"][0]) == 2.0


def test_get_model_manager_dispatch_and_the_mlflow_raise(tmp_path):
    """Neither machine has ``mlflow``: only the dispatch and the raise can run."""
    from sheeprl_tpu_torch.utils.imports import _IS_MLFLOW_AVAILABLE
    from sheeprl_tpu_torch.utils.mlflow_manager import MlflowModelManager, get_model_manager

    mm = get_model_manager(dotdict({"model_manager": {"registry_root": str(tmp_path / "r")}}))
    assert isinstance(mm, FileSystemModelManager)
    assert not _IS_MLFLOW_AVAILABLE
    with pytest.raises(ModuleNotFoundError, match="mlflow is not installed"):
        MlflowModelManager(tracking_uri=f"file:{tmp_path}/mlruns")
    with pytest.raises(ModuleNotFoundError, match="mlflow is not installed"):
        get_model_manager(dotdict({"model_manager": {"backend": "mlflow"}}))


def _meta(root):
    out = {}
    for meta in sorted(root.glob("*/v*/meta.yaml")):
        info = yaml.safe_load(meta.read_text())
        info.pop("registered_at")
        out[meta.parent.parent.name] = info
    return out


@pytest.mark.parametrize("exp,keys", [("dreamer_v3", {"world_model", "actor", "critic", "target_critic", "moments"}),
                                      ("ppo", {"agent"})])
def test_register_model_from_checkpoint_matches_jax(tmp_path, exp, keys):
    """The same config and sub-models: the same registered names, versions,
    descriptions, stages and metadata in both packages' registries, and
    the algorithm tables agree."""
    import importlib

    overrides = [f"exp={exp}", "env=dummy", "env.sync_env=True", "model_manager.disabled=False"]
    rng = np.random.default_rng(0)
    if exp == "ppo":
        agent = {"actor.head.weight": rng.standard_normal((2, 3)).astype(np.float32)}
    else:
        agent = {k: {"w": rng.standard_normal(3).astype(np.float32)} for k in keys}
    roots = {}
    for name, (compose_fn, register) in {"jax": (jax_compose, jax_register),
                                          "torch": (compose, register_model_from_checkpoint)}.items():
        cfg = compose_fn([*overrides, f"model_manager.registry_root={tmp_path / name}"])
        table = importlib.import_module(f"sheeprl_{'tpu' if name == 'jax' else 'tpu_torch'}.algos.{exp}.utils")
        assert table.MODELS_TO_REGISTER == keys
        state = {"agent": agent if name == "jax" else {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                                                          {n: torch.from_numpy(a) for n, a in v.items()})
                                                      for k, v in agent.items()}}
        assert register(None, cfg, state, table.MODELS_TO_REGISTER) == {k: 1 for k in keys}
        roots[name] = tmp_path / name
    assert _meta(roots["torch"]) == _meta(roots["jax"]) and len(_meta(roots["jax"])) == len(keys)


def test_a_jax_registered_params_pkl_loads_as_its_numpy_tree(tmp_path):
    tree = {"w": jnp.arange(6.0).reshape(2, 3), "nested": {"b": jnp.ones(2, jnp.int32), "s": jnp.float32(0.5)}}
    assert JaxManager(tmp_path / "r").register_model("jax_model", tree, metadata={"algo": "ppo"}) == 1
    mm = FileSystemModelManager(tmp_path / "r")
    loaded = mm.load_model("jax_model")
    assert mm.download_model("jax_model").endswith("params.pkl")
    assert isinstance(loaded["w"], np.ndarray) and isinstance(loaded["nested"]["b"], np.ndarray)
    np.testing.assert_array_equal(loaded["w"], np.asarray(tree["w"]))
    np.testing.assert_array_equal(loaded["nested"]["b"], np.asarray(tree["nested"]["b"]))
    assert loaded["nested"]["b"].dtype == np.int32 and float(loaded["nested"]["s"]) == 0.5
    assert mm.get_model_info("jax_model")["metadata"] == {"algo": "ppo"}


# -- the entry points ------------------------------------------------------------------
PROBE = "ext_probe_module_for_entry_points"
TINY_DV3 = ["exp=dreamer_v3", "env=dummy", "env.sync_env=True", "algo=dreamer_v3_XS", "fabric.accelerator=cpu", "algo.cnn_keys.encoder=[]",
            "algo.mlp_keys.encoder=[state]", "algo.dense_units=8", "algo.mlp_layers=1",
            "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.transition_model.hidden_size=8",
            "algo.world_model.representation_model.hidden_size=8", "algo.world_model.stochastic_size=4",
            "algo.world_model.discrete_size=4"]


class ProbeImported(RuntimeError):
    pass


@pytest.mark.parametrize("entry", ["run", "evaluation", "registration", "serve"])
def test_extra_modules_are_imported_by_every_entry_point(tmp_path, monkeypatch, entry):
    """``algo.extra_modules`` names a module whose import raises: each entry
    point must reach the import, after it has the run's config."""
    (tmp_path / f"{PROBE}.py").write_text(f"import sys\nraise sys.modules[{__name__!r}].ProbeImported('imported')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    overrides = [*TINY_DV3, f"algo.extra_modules=[{PROBE}]"]
    run_dir = tmp_path / "run"
    write_run_config(run_dir, compose(overrides))
    write_snapshot(run_dir / "checkpoint", 1, {"agent": {}})
    argv = [f"log_dir={tmp_path / 'logs'}", *overrides] if entry == "run" else [f"checkpoint_path={run_dir}"]
    with pytest.raises(ProbeImported):
        getattr(cli, entry)(argv)


def test_available_agents_lists_every_ported_algorithm(capsys):
    from sheeprl_tpu_torch.utils.registry import algorithm_registry

    cli.available_agents()
    out = capsys.readouterr().out
    # the JAX package's 17, decoupled PPO (ppo_decoupled) and SAC (sac_decoupled) among them
    assert len(algorithm_registry) == 17
    assert {"ppo_decoupled", "sac_decoupled"} <= set(algorithm_registry)
    assert all(name in out for name in algorithm_registry)


@pytest.mark.parametrize("argv,called", [(["eval", "checkpoint_path=x"], "evaluation"),
                                         (["serve", "checkpoint_path=x"], "serve"),
                                         (["--register-model", "checkpoint_path=x"], "registration"),
                                         (["agents"], "available_agents"), (["exp=ppo"], "run")])
def test_main_dispatches_as_the_jax_main(monkeypatch, argv, called):
    calls = []
    for name in ("evaluation", "serve", "registration", "available_agents", "run"):
        monkeypatch.setattr(cli, name, lambda *a, _n=name: calls.append((_n, a)))
    monkeypatch.setattr(sys, "argv", ["sheeprl_tpu_torch", *argv])
    runpy.run_module("sheeprl_tpu_torch", run_name="__main__")
    expected = () if called == "available_agents" else ((argv if called == "run" else argv[1:]),)
    assert calls == [(called, expected)]
