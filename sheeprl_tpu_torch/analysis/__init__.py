"""graftlint for the port (counterpart of ``sheeprl_tpu/analysis/``): the
registry rules, an AST pass run at review time.

* ``cfg-unknown-key`` / ``cfg-dead-key`` — every ``cfg.<path>`` read has a
  key in ``sheeprl_tpu_torch/configs/``, and every key there is read
  (a setting read nowhere is the class of fault several port slices
  repaired by hand);
* ``fault-site-unknown`` — every fault-site literal is a site of the port's
  ``resilience/faults.py``;
* ``metric-family-unknown`` — every emitted metric uses a known family.

The JAX package's donation, trace-purity and PRNG rules check JAX laws and
are not ported (``core.NOT_PORTED``).

Entry points: ``python -m sheeprl_tpu_torch.analysis [--strict] [--select
RULES] [--format json]`` (also ``python -m sheeprl_tpu_torch lint``), and
:func:`run_analysis` in process.  ``# graftlint: disable=<rule>`` suppresses
a rule on a line; ``analysis/baseline.json`` is the ledger of accepted
findings, each with its reason.
"""

from sheeprl_tpu_torch.analysis.baseline import DEFAULT_BASELINE, Baseline, BaselineError
from sheeprl_tpu_torch.analysis.context import METRIC_FAMILIES, RepoContext
from sheeprl_tpu_torch.analysis.core import NOT_PORTED, RULE_IDS, Finding, Report, run_analysis

__all__ = [
    "Baseline",
    "BaselineError",
    "DEFAULT_BASELINE",
    "Finding",
    "METRIC_FAMILIES",
    "NOT_PORTED",
    "Report",
    "RepoContext",
    "RULE_IDS",
    "run_analysis",
]
