"""The port's registry cross-checks (counterpart of
``sheeprl_tpu/analysis/registry.py``, whose rule family 4 they are).

The framework has three string-keyed registries whose consumers and
producers live far apart, so a typo validates nowhere until runtime (or
never — a dead YAML knob silently reassures whoever flips it):

* ``cfg-unknown-key`` — every ``cfg.<a>.<b>`` attribute chain in the
  package must resolve against the union of the Hydra-style YAML tree
  under ``sheeprl_tpu_torch/configs/`` (root config, group files under their
  group, exp overlays at root, ``@``-placed groups at their mounts).
  ``.get("k", default)`` steps are the sanctioned optional-access
  spelling and are never errors (they still count as reads).  A name bound
  to a cfg subtree (``wm = cfg.algo.world_model``) resolves in its own
  function scope and the scopes nested in it; the JAX rule resolves names
  per module, so a name bound to a module attribute in one function
  (``wm = self.world_model``) took another function's cfg binding there.
* ``cfg-dead-key`` — a YAML leaf no code path reads.  The read-set is
  collected from the package PLUS the read-only root ``chip_smoke.py``
  (the port's tests stay out: an override a test sets is no read by the
  port's code): prefix reads cover subtrees
  (``build_optimizer(cfg.algo.actor.optimizer)`` reads everything under
  it), ``${a.b.c}`` YAML interpolations count, and a final conservative
  fallback treats a leaf as read when its last segment appears anywhere
  in code as an attribute name or an exact string literal (that is how
  ``topo_cfg.get("env_workers")``-style subtree reads look).  What
  survives all of that is genuinely dead.
* ``fault-site-unknown`` — every fault-site string literal (hook calls,
  ``site=`` kwargs, ``"site":`` dict entries, YAML fault plans) must
  exist in ``resilience/faults.py``'s ``KNOWN_SITES`` registry.
* ``metric-family-unknown`` — every emitted metric name ``Family/rest``
  (aggregator updates, ``log_metrics`` payload keys, ``Family/``-keyed
  subscript stores, ``AGGREGATOR_KEYS`` tables, ``extra_metrics`` dicts)
  must use a documented family (``context.METRIC_FAMILIES``; the
  human-readable catalogue is the JAX package's docs/static_analysis.md).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from sheeprl_tpu_torch.analysis.context import (
    DEAD_KEY_EXEMPT_PREFIXES,
    SPEC_SIBLING_KEYS,
    RepoContext,
)
from sheeprl_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    call_name,
    iter_py_files,
    relpath,
)

#: extra roots scanned for READS only (they never produce findings, but a
#: key only they read is not dead)
READ_ONLY_ROOTS = ("chip_smoke.py",)

#: dict/dotdict methods that terminate a cfg chain without extending it
_DICT_METHODS = (
    "keys", "values", "items", "pop", "update", "setdefault", "copy",
    "clear", "to_dict", "as_dict", "get",
)

_METRIC_RE = re.compile(r"^[A-Z][A-Za-z0-9_]*/[\w./\- %]+$")

_FAULT_HOOKS = ("fault_point", "fault_bytes", "fault_rows")


# ---------------------------------------------------------------------------
# cfg access collection
# ---------------------------------------------------------------------------

class CfgAccess:
    __slots__ = ("path", "line", "optional", "context")

    def __init__(self, path: str, line: int, optional: bool, context: str):
        self.path = path
        self.line = line
        self.optional = optional
        self.context = context


def cfg_accesses(src: SourceFile) -> List[CfgAccess]:
    """Per-file cfg-access list, computed ONCE per SourceFile — both the
    unknown-key check and the dead-config harvest need it, and the walk
    (binding resolution + per-node chain analysis) is the most expensive
    part of this rule family."""
    cached = getattr(src, "_cfg_accesses", None)
    if cached is None:
        cached = _collect_cfg_accesses(src.tree)
        src._cfg_accesses = cached
    return cached


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _split_scope(scope: ast.AST) -> Tuple[List[ast.AST], List[ast.AST]]:
    """``scope``'s own nodes (the decorators, defaults and bases of the
    scopes nested in it among them) and the scopes nested directly in it."""
    nodes: List[ast.AST] = []
    scopes: List[ast.AST] = []
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop(0)
        if isinstance(node, _SCOPES):
            scopes.append(node)
            todo.extend(getattr(node, "decorator_list", []))
            if isinstance(node, ast.ClassDef):
                todo.extend(node.bases)
            else:
                todo.extend(d for d in (*node.args.defaults, *node.args.kw_defaults) if d is not None)
            continue
        nodes.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return nodes, scopes


def _bound_names(scope: ast.AST, nodes: List[ast.AST]) -> Set[str]:
    """The names ``scope`` binds itself (``nodes`` are its own): its
    parameters and the plain names its assignments target (``cfg`` is the
    root, never a binding)."""
    names: Set[str] = set()
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = scope.args
        names.update(x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs, a.vararg, a.kwarg) if x is not None)
    names.update(n.id for n in nodes if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store))
    return names - {"cfg"}


def _collect_cfg_accesses(tree: ast.Module) -> List[CfgAccess]:
    """Attribute/get chains rooted at a name ``cfg`` — plus one level of
    subtree variables (``v = cfg.algo.world_model`` makes later ``v.x``
    accesses resolve as ``algo.world_model.x``), resolved per scope: a
    function sees its own bindings and those of the scopes around it, and a
    name it binds to anything else hides an outer cfg binding.  A binding
    through .get() keeps its optionality: later chains on the variable are
    still the sanctioned optional spelling."""
    accesses: List[CfgAccess] = []

    def visit(scope: ast.AST, outer: Dict[str, Tuple[str, bool]], func: str) -> None:
        nodes, scopes = _split_scope(scope)
        bound = _bound_names(scope, nodes)
        bindings = {k: v for k, v in outer.items() if k not in bound}
        for node in nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                res = _chain_of(node.value, bindings)
                if res is not None and res[0]:
                    bindings[node.targets[0].id] = res
        seen: Set[int] = set()
        for node in nodes:
            if id(node) in seen or not isinstance(node, (ast.Attribute, ast.Call)):
                continue
            res = _chain_of(node, bindings)
            if res is None:
                continue
            # mark every sub-node consumed (even for empty paths, e.g. a
            # bare `cfg.get(dynamic)`) so inner attributes of the same chain
            # don't re-report shorter prefixes
            for sub in ast.walk(node):
                seen.add(id(sub))
            path, optional = res
            if path:
                accesses.append(CfgAccess(path, node.lineno, optional, func))
        for child in scopes:
            # an access's context is its outermost function, as in JAX's rule
            name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else ""
            visit(child, bindings, func or name)

    visit(tree, {}, "")
    return accesses


def _chain_of(node: ast.AST, bindings: Dict[str, Tuple[str, bool]]) -> Optional[Tuple[str, bool]]:
    """Resolve a ``cfg.a.b`` / ``cfg.a.get("b")`` / ``v.c`` expression to
    ``(dotted path, passed-through-optional-get)``.  None = not a cfg
    expression."""
    parts: List[str] = []
    optional = False
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Call):
            # only .get("literal"[, default]) extends the chain
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "get":
                if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                    parts.append(node.args[0].value)
                    optional = True
                    node = func.value
                    continue
                # .get(<dynamic>) — chain ends at the receiver
                node = func.value
                optional = True
                continue
            if isinstance(func, ast.Attribute) and func.attr in _DICT_METHODS:
                node = func.value
                continue
            return None
        elif isinstance(node, ast.Name):
            root = node.id
            if root == "cfg":
                prefix: List[str] = []
            elif root in bindings:
                bound_path, bound_optional = bindings[root]
                prefix = bound_path.split(".")
                optional = optional or bound_optional
            else:
                return None
            # drop trailing dict-method segments that slipped into parts
            chain = prefix + parts[::-1]
            chain = [c for c in chain if c not in _DICT_METHODS]
            return ".".join(chain), optional
        elif isinstance(node, ast.Subscript):
            # dynamic subscript: chain ends; keep what we have as a read of
            # the receiver subtree
            node = node.value
            optional = True
        else:
            return None


# ---------------------------------------------------------------------------
# per-file checks
# ---------------------------------------------------------------------------

def check_file(src: SourceFile, ctx: RepoContext) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_check_cfg_unknown(src, ctx))
    findings.extend(_check_fault_sites(src, ctx))
    findings.extend(_check_metric_families(src, ctx))
    return findings


def _check_cfg_unknown(src: SourceFile, ctx: RepoContext) -> List[Finding]:
    if not ctx.config_paths:
        return []
    findings: List[Finding] = []
    for access in cfg_accesses(src):
        if access.optional:
            continue
        if ctx.has_config_path(access.path):
            continue
        # report at the deepest resolving prefix for a useful message
        parts = access.path.split(".")
        known = ""
        for i in range(len(parts) - 1, 0, -1):
            p = ".".join(parts[:i])
            if ctx.has_config_path(p):
                known = p
                break
        if known and known in ctx.config_leaves:
            # the chain resolves to a LEAF and keeps going: the tail is
            # attribute access on the value (`cfg.buffer.device.lower()`),
            # not a config path
            continue
        findings.append(
            Finding(
                "cfg-unknown-key",
                src.rel,
                access.line,
                f"cfg.{access.path} has no backing key in sheeprl_tpu_torch/configs/"
                + (f" (deepest resolving prefix: '{known}')" if known else ""),
                context=access.context,
            )
        )
    return findings


def _check_fault_sites(src: SourceFile, ctx: RepoContext) -> List[Finding]:
    if not ctx.fault_sites:
        return []
    # the registry definition file itself is the source of truth
    if src.rel.endswith("resilience/faults.py"):
        return []
    sites = set(ctx.fault_sites)
    findings: List[Finding] = []

    def bad(lit: str, line: int, how: str) -> None:
        findings.append(
            Finding(
                "fault-site-unknown",
                src.rel,
                line,
                f"fault site '{lit}' ({how}) is not in resilience/faults.py "
                f"KNOWN_SITES — a typo here silently disarms the drill",
            )
        )

    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            cname = call_name(node)
            if cname in _FAULT_HOOKS and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    if a0.value not in sites:
                        bad(a0.value, node.lineno, f"first arg of {cname}")
            if cname == "FaultSpec":
                # NOTE: only FaultSpec's site= names an injection site; the
                # retry/Watchdog primitives also take site= but that labels
                # Resilience/* metric accounting, a different namespace
                for kw in node.keywords:
                    if (
                        kw.arg == "site"
                        and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, str)
                        and kw.value.value not in sites
                    ):
                        bad(kw.value.value, node.lineno, "FaultSpec site= kwarg")
        elif isinstance(node, ast.Dict):
            entry = _fault_spec_dict(node)
            if entry is not None:
                site, line = entry
                if site not in sites:
                    bad(site, line, "fault-plan spec dict")
    return findings


#: a dict is a fault-plan spec only when "site" has schedule/kind siblings —
#: bare {"site": ...} dicts exist in other schemas.  The sibling-key set is
#: context.SPEC_SIBLING_KEYS, shared with the YAML-side plan scan so the
#: Python and YAML halves of this rule can't drift.
_SPEC_SIBLINGS = SPEC_SIBLING_KEYS


def _fault_spec_dict(node: ast.Dict) -> Optional[Tuple[str, int]]:
    keys = {
        k.value for k in node.keys
        if isinstance(k, ast.Constant) and isinstance(k.value, str)
    }
    if "site" not in keys or not keys.intersection(_SPEC_SIBLINGS):
        return None
    for k, v in zip(node.keys, node.values):
        if (
            isinstance(k, ast.Constant) and k.value == "site"
            and isinstance(v, ast.Constant) and isinstance(v.value, str)
        ):
            return v.value, v.lineno
    return None


#: metric-emission shapes: .update("Family/...", ...) on an aggregator-ish
#: receiver; dict keys in log_metrics(...) / extra_metrics=; subscript
#: stores with a Family/ literal key; AGGREGATOR_KEYS tables
def _check_metric_families(src: SourceFile, ctx: RepoContext) -> List[Finding]:
    families = set(ctx.metric_families)
    findings: List[Finding] = []

    def verify(lit: str, line: int, how: str) -> None:
        if not _METRIC_RE.match(lit):
            return
        family = lit.split("/", 1)[0]
        if family not in families:
            findings.append(
                Finding(
                    "metric-family-unknown",
                    src.rel,
                    line,
                    f"metric '{lit}' ({how}) uses undocumented family "
                    f"'{family}/' — add it to the documented families "
                    "(sheeprl_tpu_torch/analysis/context.py) or fold "
                    "it into an existing one",
                )
            )

    for node in ast.walk(src.tree):
        if isinstance(node, ast.Call):
            cname = call_name(node)
            if cname == "update" and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    verify(a0.value, node.lineno, "aggregator update")
            if cname == "log_metrics" and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Dict):
                    for k in a0.keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str):
                            verify(k.value, k.lineno, "log_metrics key")
            for kw in node.keywords:
                if kw.arg == "extra_metrics" and isinstance(kw.value, ast.Dict):
                    for k in kw.value.keys:
                        if isinstance(k, ast.Constant) and isinstance(k.value, str):
                            verify(k.value, k.lineno, "extra_metrics key")
        elif isinstance(node, ast.Assign):
            # metrics["Family/x"] = ... subscript stores
            for t in node.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                ):
                    verify(t.slice.value, t.lineno, "metric-dict store")
            # AGGREGATOR_KEYS = ["Family/x", ...] tables
            names = {x.id for x in node.targets if isinstance(x, ast.Name)}
            if any("AGGREGATOR" in n or "METRICS" in n for n in names) and isinstance(
                node.value, (ast.List, ast.Tuple, ast.Set)
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                        verify(elt.value, elt.lineno, "aggregator-keys table")
    return findings


# ---------------------------------------------------------------------------
# repo-level checks (need the whole read-set)
# ---------------------------------------------------------------------------

def check_repo(
    sources: Sequence[SourceFile], ctx: RepoContext, dead_config: bool = True
) -> List[Finding]:
    findings: List[Finding] = []
    if ctx.config_paths and dead_config:
        findings.extend(_check_dead_config(sources, ctx))
    if ctx.fault_sites:
        sites = set(ctx.fault_sites)
        for site, rel, line in ctx.yaml_fault_sites:
            if site not in sites:
                findings.append(
                    Finding(
                        "fault-site-unknown",
                        rel,
                        line,
                        f"fault site '{site}' in a YAML fault plan is not in "
                        "resilience/faults.py KNOWN_SITES",
                    )
                )
    return findings


def _check_dead_config(sources: Sequence[SourceFile], ctx: RepoContext) -> List[Finding]:
    reads: Set[str] = set(ctx.yaml_reads)
    attr_names: Set[str] = set()
    str_consts: Set[str] = set()

    def harvest(tree: ast.Module, accesses: Optional[List[CfgAccess]] = None) -> None:
        for access in accesses if accesses is not None else _collect_cfg_accesses(tree):
            reads.add(access.path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                attr_names.add(node.attr)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                s = node.value
                if 0 < len(s) < 80:
                    str_consts.add(s)
                    # `a.b.c=value` CLI-override literals read a.b.c
                    if "=" in s:
                        reads.add(s.split("=", 1)[0].lstrip("+"))

    for src in sources:
        harvest(src.tree, cfg_accesses(src))  # reuses the check_file walk
    for extra in READ_ONLY_ROOTS:
        p = ctx.root / extra
        if not p.exists():
            continue
        for f in iter_py_files([p]):
            try:
                harvest(ast.parse(f.read_text()))
            except (SyntaxError, UnicodeDecodeError):
                continue

    read_prefixes = reads  # every read covers its whole subtree

    def is_read(path: str) -> bool:
        parts = path.split(".")
        for i in range(1, len(parts) + 1):
            if ".".join(parts[:i]) in read_prefixes:
                return True
        last = parts[-1]
        return last in attr_names or last in str_consts

    findings: List[Finding] = []
    for path, leaf in sorted(ctx.config_leaves.items()):
        if any(path == p or path.startswith(p + ".") for p in DEAD_KEY_EXEMPT_PREFIXES):
            continue
        if is_read(path):
            continue
        findings.append(
            Finding(
                "cfg-dead-key",
                leaf.file,
                leaf.line,
                f"config key '{path}' is read by no code path (dead config) — "
                "remove it or route it through a deprecation shim",
                context=path,
            )
        )
    return findings
