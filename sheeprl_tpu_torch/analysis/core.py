"""graftlint core for the port: findings, suppressions and the driver
(counterpart of ``sheeprl_tpu/analysis/core.py``).

The analyzer is a pure-AST pass (no code of the analysed package runs):
every rule receives a parsed :class:`SourceFile` plus the shared
:class:`~sheeprl_tpu_torch.analysis.context.RepoContext` (the composed-config
key tree of ``sheeprl_tpu_torch/configs/``, the fault-site registry read out
of ``resilience/faults.py``, the metric families) and returns
:class:`Finding` objects.  The driver applies suppression comments and the
checked-in baseline, then renders text or JSON reports.

The port carries the four registry rules.  The JAX package's donation,
trace-purity and PRNG rules match ``jax.*`` call sites (donated argnums,
traced functions, ``jax.random`` keys), which the port never makes: they are
not ported, and selecting one raises with that reason
(:data:`NOT_PORTED`).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

REPO_PACKAGE = "sheeprl_tpu_torch"

#: every rule id the engine knows, with a one-line meaning
RULE_IDS: Dict[str, str] = {
    "cfg-unknown-key": (
        "a cfg.<path> attribute access has no backing key anywhere in the "
        "composed sheeprl_tpu_torch/configs/ tree"
    ),
    "cfg-dead-key": (
        "a YAML leaf under sheeprl_tpu_torch/configs/ is read by no code path "
        "(dead config)"
    ),
    "fault-site-unknown": (
        "a fault-site string literal does not exist in "
        "resilience/faults.py's KNOWN_SITES registry"
    ),
    "metric-family-unknown": (
        "an emitted metric name uses a Family/ prefix that is not a "
        "documented metric family"
    ),
    "parse-error": "the file does not parse — nothing in it can be analyzed",
}

_JAX_LAW = "it checks a JAX law (jax.* call sites), and the port imports no JAX"

#: the JAX package's rules the port does not carry, and why
NOT_PORTED: Dict[str, str] = {
    rule: _JAX_LAW for rule in (
        "use-after-donate", "donation-borrowed-buffer", "trace-impure-time", "trace-host-concretize",
        "trace-python-branch", "prng-key-reuse", "prng-split-discarded",
    )
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, "/" separated
    line: int
    message: str
    context: str = ""  # enclosing function, yaml key path, ...

    def render(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{ctx}"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class SourceFile:
    """One parsed Python file plus its suppression table."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = ast.parse(text, filename=str(path))
        self.suppressed_lines, self.suppressed_file, self.suppression_warnings = (
            _parse_suppressions(text)
        )

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self.suppressed_file or "all" in self.suppressed_file:
            return True
        rules = self.suppressed_lines.get(line)
        return bool(rules) and (rule in rules or "all" in rules)


_SUPPRESS_RE = re.compile(r"graftlint:\s*(disable(?:-file)?)\s*=\s*([\w,\- ]+)")


def _parse_suppressions(
    text: str,
) -> Tuple[Dict[int, Set[str]], Set[str], List[Tuple[int, Set[str]]]]:
    """``# graftlint: disable=<rule>[,<rule>...]`` suppresses the named
    rules on its own line; on a comment-only line it also covers the next
    code line.  ``# graftlint: disable-file=<rule>`` covers the whole file.
    Comments are read with tokenize so string literals can't fake one.
    Returns (per-line rules, file-wide rules, unknown-rule warnings) — a
    typo'd rule name suppresses nothing and is surfaced as a report note.
    """
    by_line: Dict[int, Set[str]] = {}
    file_wide: Set[str] = set()
    warnings: List[Tuple[int, Set[str]]] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(text).readline)
        comments = [(t.start[0], t.string, t.line) for t in tokens if t.type == tokenize.COMMENT]
    except tokenize.TokenError:
        comments = []
    for lineno, comment, full_line in comments:
        m = _SUPPRESS_RE.search(comment)
        if not m:
            continue
        rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
        unknown = rules - set(RULE_IDS) - {"all"}
        if unknown:
            rules -= unknown
            warnings.append((lineno, unknown))
        if "disable-file" in m.group(1):
            file_wide |= rules
        else:
            by_line.setdefault(lineno, set()).update(rules)
            if full_line.strip().startswith("#"):
                # comment-only line: also cover the next line
                by_line.setdefault(lineno + 1, set()).update(rules)
    return by_line, file_wide, warnings


def call_name(call: ast.Call) -> Optional[str]:
    """Last dotted segment of the callee (``fabric.compile`` -> "compile")."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class Report:
    def __init__(self) -> None:
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self.baselined: List[Finding] = []
        self.stale_baseline: List[Dict[str, Any]] = []
        self.notes: List[str] = []
        self.files_analyzed: int = 0
        self.wall_s: float = 0.0

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            "files_analyzed": self.files_analyzed,
            "wall_s": round(self.wall_s, 3),
            "unsuppressed": [f.to_dict() for f in self.findings],
            "suppressed": len(self.suppressed),
            "baselined": len(self.baselined),
            "stale_baseline": self.stale_baseline,
            "counts": self.counts(),
            "notes": self.notes,
        }

    def render_text(self) -> str:
        out: List[str] = [f.render() for f in self.findings]
        for entry in self.stale_baseline:
            out.append(
                "stale baseline entry (matched nothing): "
                f"{entry.get('rule')} {entry.get('file', '*')} "
                f"match={entry.get('match', '')!r}"
            )
        out.extend(f"note: {note}" for note in self.notes)
        out.append(
            f"graftlint: {len(self.findings)} unsuppressed finding(s), "
            f"{len(self.baselined)} baselined, {len(self.suppressed)} "
            f"comment-suppressed across {self.files_analyzed} file(s) "
            f"in {self.wall_s:.2f}s"
        )
        return "\n".join(out)


def iter_py_files(paths: Sequence[Path]) -> Iterable[Path]:
    seen: Set[Path] = set()
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            if p not in seen:
                seen.add(p)
                yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" in f.parts or f in seen:
                    continue
                seen.add(f)
                yield f


def repo_root() -> Path:
    """The checkout holding the package (the parent of ``sheeprl_tpu_torch/``)."""
    return Path(__file__).resolve().parents[2]


def relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def check_select(select: Optional[Sequence[str]]) -> Set[str]:
    """The rule ids to run: all by default; a rule the port does not carry
    raises with its reason, an unknown one raises."""
    selected = set(select) if select else set(RULE_IDS)
    not_ported = sorted(selected & set(NOT_PORTED))
    if not_ported:
        raise ValueError(f"rule(s) {not_ported} are not ported: {NOT_PORTED[not_ported[0]]}")
    unknown = selected - set(RULE_IDS)
    if unknown:
        raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
    return selected


def run_analysis(
    paths: Optional[Sequence[os.PathLike]] = None,
    *,
    select: Optional[Sequence[str]] = None,
    baseline: Any = None,  # Baseline | None; resolved by caller/CLI
    context: Any = None,  # RepoContext; built lazily when None
    root: Optional[Path] = None,
) -> Report:
    """Analyze ``paths`` (default: the ``sheeprl_tpu_torch`` package) and
    return a :class:`Report`; the CLI wraps it."""
    import time as _time

    from sheeprl_tpu_torch.analysis import registry
    from sheeprl_tpu_torch.analysis.context import RepoContext

    t0 = _time.perf_counter()
    selected = check_select(select)
    root = root or repo_root()
    targets = [Path(p) for p in (paths or [root / REPO_PACKAGE])]
    ctx = context if context is not None else RepoContext.build(root)
    report = Report()
    report.notes.extend(ctx.notes)

    sources: List[SourceFile] = []
    raw: List[Finding] = []
    for path in iter_py_files(targets):
        rel = relpath(path, root)
        try:
            src = SourceFile(path, rel, path.read_text())
        except (SyntaxError, UnicodeDecodeError) as e:
            raw.append(Finding("parse-error", rel, getattr(e, "lineno", 1) or 1,
                               f"file does not parse: {e}"))
            continue
        sources.append(src)
        raw.extend(registry.check_file(src, ctx))
    report.files_analyzed = len(sources)

    # repo-level rules (dead config; yaml-side fault sites) need the whole
    # read-set, so they run after the per-file sweep.  Dead config is only
    # meaningful when the WHOLE package was analyzed — on a file subset
    # every key the subset doesn't read would misreport as dead.
    pkg = (root / REPO_PACKAGE).resolve()
    full_package = any(Path(t).resolve() == pkg for t in targets)
    raw.extend(registry.check_repo(sources, ctx, dead_config=full_package))

    uniq: Dict[Tuple[str, str, int, str], Finding] = {}
    for f in raw:
        uniq.setdefault((f.rule, f.path, f.line, f.message), f)
    findings = sorted(uniq.values(), key=lambda f: (f.path, f.line, f.rule))

    by_rel = {s.rel: s for s in sources}
    for f in findings:
        src = by_rel.get(f.path)
        suppressed_inline = src is not None and src.is_suppressed(f.rule, f.line)
        # baseline matching runs even for DESELECTED rules so their ledger
        # entries register hits — otherwise `--select x --strict` would
        # falsely report every other rule's entries as stale
        baselined = (
            not suppressed_inline and baseline is not None and baseline.matches(f)
        )
        if f.rule not in selected:
            continue
        if suppressed_inline:
            report.suppressed.append(f)
        elif baselined:
            report.baselined.append(f)
        else:
            report.findings.append(f)
    for src in sources:
        for line, names in sorted(src.suppression_warnings):
            report.notes.append(
                f"{src.rel}:{line}: suppression comment names unknown rule(s) "
                f"{sorted(names)} — it suppresses nothing"
            )
    if baseline is not None:
        report.stale_baseline = baseline.stale_entries()
    report.wall_s = _time.perf_counter() - t0
    return report
