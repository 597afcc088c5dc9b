"""Baseline mechanics: the checked-in ledger of ACCEPTED findings (a copy
of ``sheeprl_tpu/analysis/baseline.py`` for the port).

``analysis/baseline.json`` lets the repo land at zero *unsuppressed*
findings without papering over the analyzer's precision limits inline.
Every entry names a rule, an optional file, a ``match`` substring against
the finding message, and a mandatory human **reason** — an entry without a
reason is a validation error, because a baseline whose entries nobody can
explain is just a mute button.

Matching is content-based (rule + file + message substring), NOT
line-based: line numbers churn with every edit above a finding, and a
baseline that goes stale on unrelated refactors trains people to
regenerate it blindly.  ``--strict`` additionally fails on entries that
matched nothing — a fixed finding must take its baseline entry with it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from sheeprl_tpu_torch.analysis.core import RULE_IDS, Finding

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"


class BaselineError(ValueError):
    pass


class Baseline:
    def __init__(self, entries: List[Dict[str, Any]], path: Optional[Path] = None):
        self.path = path
        self.entries = entries
        self._hits = [0] * len(entries)
        for i, e in enumerate(entries):
            if not isinstance(e, dict):
                raise BaselineError(f"baseline entry {i} is not an object: {e!r}")
            rule = e.get("rule")
            if rule not in RULE_IDS:
                raise BaselineError(f"baseline entry {i} names unknown rule {rule!r}")
            if not str(e.get("reason", "")).strip():
                raise BaselineError(
                    f"baseline entry {i} ({rule} {e.get('file', '*')}) has no "
                    "reason — every accepted finding must say why"
                )

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        data = json.loads(Path(path).read_text())
        if isinstance(data, dict):
            entries = data.get("entries", [])
        else:
            entries = data
        return cls(list(entries), path=Path(path))

    def matches(self, f: Finding) -> bool:
        for i, e in enumerate(self.entries):
            if e["rule"] != f.rule:
                continue
            file = e.get("file")
            if file and file != f.path:
                continue
            match = e.get("match")
            if match and match not in f.message and match != f.context:
                continue
            self._hits[i] += 1
            return True
        return False

    def stale_entries(self) -> List[Dict[str, Any]]:
        return [e for e, h in zip(self.entries, self._hits) if h == 0]
