"""CLI for the port's graftlint: ``python -m sheeprl_tpu_torch.analysis``
(or ``python -m sheeprl_tpu_torch lint``).

Exit codes: 0 = clean (no unsuppressed findings; under ``--strict`` also no
stale baseline entries), 1 = findings, 2 = usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sheeprl_tpu_torch.analysis",
        description="graftlint for sheeprl_tpu_torch: the config, fault-site and metric-family registries.",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to analyze (default: the sheeprl_tpu_torch package)",
    )
    parser.add_argument(
        "--strict", action="store_true",
        help="also fail on stale baseline entries (the CI spelling)",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="baseline file (default: sheeprl_tpu_torch/analysis/baseline.json)",
    )
    parser.add_argument(
        "--select", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt",
    )
    args = parser.parse_args(argv)

    from sheeprl_tpu_torch.analysis.baseline import DEFAULT_BASELINE, Baseline, BaselineError
    from sheeprl_tpu_torch.analysis.core import run_analysis

    baseline = None
    path = Path(args.baseline) if args.baseline else DEFAULT_BASELINE
    if path.is_file():
        try:
            baseline = Baseline.load(path)
        except (BaselineError, ValueError) as e:
            print(f"graftlint: invalid baseline {path}: {e}", file=sys.stderr)
            return 2

    select = [r.strip() for r in args.select.split(",")] if args.select else None
    try:
        report = run_analysis(args.paths or None, select=select, baseline=baseline)
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2

    if args.fmt == "json":
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render_text())

    if report.findings:
        return 1
    if args.strict and report.stale_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
