"""The port's graftlint (``sheeprl_tpu_torch/analysis/``) against the JAX
package's registry rules.

* The snippets of ``tests/test_analysis/test_rules.py``'s registry cases go
  through both packages' rules, each with its own ``RepoContext`` (its own
  config tree and fault registry): the same findings on the same lines.
* One case shows the divergence: the port resolves a name bound to a cfg
  subtree in its own function scope, the JAX rule per module.
* Suppression comments, the stale-baseline ``--strict`` failure, and the
  refusal of the JAX-law rules the port does not carry.
* Over the port itself: no unsuppressed finding against the committed
  baseline, and no stale entry; the dead-key rule finds ``matmul_precision``
  again when ``cli.run`` stops reading it.
"""

import json
import textwrap
from pathlib import Path

import pytest

from sheeprl_tpu.analysis import RepoContext as JaxRepoContext
from sheeprl_tpu.analysis import registry as jax_registry
from sheeprl_tpu.analysis.core import SourceFile as JaxSourceFile
from sheeprl_tpu.analysis.core import repo_root as jax_repo_root
from sheeprl_tpu_torch.analysis import DEFAULT_BASELINE, NOT_PORTED, Baseline, RepoContext, run_analysis
from sheeprl_tpu_torch.analysis import registry
from sheeprl_tpu_torch.analysis.__main__ import main as lint_main
from sheeprl_tpu_torch.analysis.core import REPO_PACKAGE, SourceFile, iter_py_files, relpath, repo_root


@pytest.fixture(scope="module")
def contexts():
    return {"jax": JaxRepoContext.build(jax_repo_root()), "port": RepoContext.build(repo_root())}


def _lint(code, contexts, package):
    """The per-file registry findings of ``code`` as ``(rule, line, context,
    message)``, the package names in messages made alike."""
    text = textwrap.dedent(code)
    if package == "jax":
        found = jax_registry.check_file(JaxSourceFile(Path("snippet.py"), "snippet.py", text), contexts["jax"])
    else:
        found = registry.check_file(SourceFile(Path("snippet.py"), "snippet.py", text), contexts["port"])
    out = {(f.rule, f.line, f.context, f.message.replace("sheeprl_tpu_torch/", "sheeprl_tpu/")
            .replace("(sheeprl_tpu/analysis/context.py)", "(docs/static_analysis.md + analysis/context.py)"))
           for f in found}
    return sorted(out, key=lambda f: (f[1], f[0]))


def _line(code, marker):
    for i, line in enumerate(textwrap.dedent(code).splitlines(), 1):
        if marker in line:
            return i
    raise AssertionError(marker)


#: the snippets of tests/test_analysis/test_rules.py::TestRegistries → the rules they flag
SNIPPETS = {
    "cfg_known_key": ("""
        def run(cfg):
            return cfg.algo.total_steps, cfg.buffer.size, cfg.env.num_envs
        """, []),
    "cfg_unknown_key": ("""
        def run(cfg):
            return cfg.algo.learning_startss  # TYPO
        """, ["cfg-unknown-key"]),
    "cfg_optional_get": ("""
        def run(cfg):
            return cfg.algo.get("definitely_not_a_key"), cfg.get("nope", 1)
        """, []),
    "cfg_leaf_value_methods": ("""
        def run(cfg):
            return cfg.buffer.device.lower()
        """, []),
    "fault_site_known": ("""
        from sheeprl_tpu.resilience.faults import fault_point

        def run():
            fault_point("env.step")
        """, []),
    "fault_site_typo": ("""
        from sheeprl_tpu.resilience.faults import fault_point

        def run():
            fault_point("env.stpe")  # TYPO
        """, ["fault-site-unknown"]),
    "fault_spec_dict_and_kwarg": ("""
        def plan(FaultSpec):
            a = FaultSpec(site="serve.htpp", kind="raise", at=1)  # KWARG
            b = {"site": "env.reset", "at": 2}
            c = {"site": "checkpoint.commmit", "every": 3}  # DICT
            return a, b, c
        """, ["fault-site-unknown", "fault-site-unknown"]),
    "retry_site_label": ("""
        def run(retry, job):
            return retry(job, attempts=3, site="checkpoint.write")
        """, []),
    "metric_documented_family": ("""
        def run(aggregator, logger):
            aggregator.update("Loss/value_loss", 1.0)
            logger.log_metrics({"Rewards/rew_avg": 1.0}, 0)
        """, []),
    "metric_unknown_family": ("""
        def run(aggregator, metrics):
            aggregator.update("Bogus/value", 1.0)  # AGG
            metrics["AlsoBogus/x"] = 2.0  # STORE
        """, ["metric-family-unknown", "metric-family-unknown"]),
    "non_metric_slash_strings": ("""
        def run(d):
            protocol_version = "HTTP/1.1"
            d["some/path/like/thing"] = 1
            return protocol_version
        """, []),
    "subtree_binding": ("""
        def run(cfg):
            wm = cfg.algo.world_model
            rm = wm.recurrent_model
            return rm.recurrent_state_size, wm.encoderr  # TYPO
        """, ["cfg-unknown-key"]),
    "closure_sees_the_outer_binding": ("""
        def run(cfg):
            wm = cfg.algo.world_model

            def inner():
                return wm.decoderr  # TYPO
            return inner
        """, ["cfg-unknown-key"]),
}


@pytest.mark.parametrize("case", list(SNIPPETS))
def test_the_port_rules_give_jaxs_findings(case, contexts):
    code, rules = SNIPPETS[case]
    port, jax_found = _lint(code, contexts, "port"), _lint(code, contexts, "jax")
    assert port == jax_found
    assert [f[0] for f in port] == rules
    for marker in ("# TYPO", "# KWARG", "# DICT", "# AGG", "# STORE"):
        if marker in code:
            assert _line(code, marker) in [f[1] for f in port], marker


def test_a_name_resolves_in_its_own_scope(contexts):
    """The divergence: ``wm = self.world_model`` read in one function is a
    module attribute there; the JAX rule resolves ``wm`` through the other
    function's ``wm = cfg.algo.world_model`` and reports a missing key."""
    code = """
    def build(cfg):
        wm = cfg.algo.world_model
        return wm.recurrent_model

    class Trainer:
        def step(self):
            wm = self.world_model
            return wm.rssm_step(1)  # SCOPE
    """
    assert _lint(code, contexts, "port") == []
    jax_found = _lint(code, contexts, "jax")
    assert [(f[0], f[1]) for f in jax_found] == [("cfg-unknown-key", _line(code, "# SCOPE"))]


def _write(tmp_path, code, name="mod.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(code))
    return p


BOGUS = """
def run(aggregator):
    aggregator.update("Bogus/value", 1.0){trailer}
"""


@pytest.mark.parametrize("trailer, suppressed", [("", False), ("  # graftlint: disable=metric-family-unknown", True),
                                                 ("  # graftlint: disable=cfg-dead-key", False),
                                                 ("  # graftlint: disable=metric-family-unknwn", False)])
def test_suppression_comments(tmp_path, trailer, suppressed):
    report = run_analysis([_write(tmp_path, BOGUS.format(trailer=trailer))], root=tmp_path)
    assert [f.rule for f in report.suppressed if f.rule == "metric-family-unknown"] == (
        ["metric-family-unknown"] if suppressed else [])
    assert [f.rule for f in report.findings] == ([] if suppressed else ["metric-family-unknown"])
    assert any("metric-family-unknwn" in n for n in report.notes) == trailer.endswith("unknwn")


def test_a_stale_baseline_entry_fails_strict_only(tmp_path, capsys):
    mod = _write(tmp_path, BOGUS.format(trailer=""))
    entries = [{"rule": "metric-family-unknown", "file": relpath(mod, repo_root()), "match": "Bogus/value",
                "reason": "accepted for this test"},
               {"rule": "cfg-dead-key", "match": "nothing matches this", "reason": "stale on purpose"}]
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"version": 1, "entries": entries}))
    assert lint_main([str(mod), "--baseline", str(baseline)]) == 0
    assert lint_main([str(mod), "--baseline", str(baseline), "--strict"]) == 1
    assert "stale baseline entry" in capsys.readouterr().out
    entries[1]["reason"] = " "
    baseline.write_text(json.dumps({"version": 1, "entries": entries}))
    assert lint_main([str(mod), "--baseline", str(baseline)]) == 2  # an entry without a reason


@pytest.mark.parametrize("rule", sorted(NOT_PORTED))
def test_the_jax_law_rules_are_refused(rule, tmp_path, capsys):
    with pytest.raises(ValueError, match="not ported: it checks a JAX law"):
        run_analysis([_write(tmp_path, "x = 1\n")], root=tmp_path, select=[rule])
    assert lint_main(["--select", rule]) == 2
    assert "not ported" in capsys.readouterr().err


@pytest.fixture(scope="module")
def port_report():
    return run_analysis(baseline=Baseline.load(DEFAULT_BASELINE))


def test_the_port_is_clean(port_report):
    assert port_report.findings == [], "\n" + "\n".join(f.render() for f in port_report.findings)
    assert port_report.stale_baseline == []
    assert port_report.files_analyzed > 100
    for entry in Baseline.load(DEFAULT_BASELINE).entries:
        assert "ROADMAP.md" in entry["reason"], entry  # each accepted finding names the item that ends it
    # the baseline holds dead keys of the layer the port does not have, nothing else
    assert {f.rule for f in port_report.baselined} == {"cfg-dead-key"}
    assert all(f.context.split(".")[0] in ("topology", "sharding") or f.context == "buffer.share_data"
               for f in port_report.baselined)


def test_the_json_report(capsys):
    assert lint_main(["--strict", "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["unsuppressed"] == [] and report["stale_baseline"] == []


def test_the_dead_key_rule_finds_matmul_precision_unread(contexts):
    """``matmul_precision`` was read nowhere in the port (ROADMAP.md §C 3);
    with ``cli.run``'s read taken out of the sources, the rule reports it."""
    root = repo_root()
    sources = []
    for path in iter_py_files([root / REPO_PACKAGE]):
        text = path.read_text()
        if path.name == "cli.py" and path.parent.name == REPO_PACKAGE:
            assert 'cfg.get("matmul_precision")' in text
            text = text.replace('cfg.get("matmul_precision")', "None")
        sources.append(SourceFile(path, relpath(path, root), text))
    dead = {f.context for f in registry.check_repo(sources, contexts["port"]) if f.rule == "cfg-dead-key"}
    assert "matmul_precision" in dead
