"""Shared repo context for the port's registry rules (counterpart of
``sheeprl_tpu/analysis/context.py``): the composed-config key tree of
``sheeprl_tpu_torch/configs/`` (with per-leaf provenance), the fault-site
registry extracted from the port's ``resilience/faults.py`` (``KNOWN_SITES``
plus the names of ``UNPORTED_SITES``, sites whose module the port does not
have yet), and the documented metric families.

Everything here is derived **statically** — YAML files are parsed with the
same loader the compose engine uses (so ``1e-3`` floats and friends agree),
and the fault-site registry is read out of ``faults.py``'s AST rather than
imported, keeping the analyzer runnable without initializing anything.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from sheeprl_tpu_torch.analysis.core import REPO_PACKAGE

#: The documented metric families (the JAX package's, whose
#: docs/static_analysis.md keeps the human-facing table).  A metric name
#: ``Family/rest`` emitted anywhere — aggregator updates, hub sources,
#: ``log_metrics`` payloads, ``extra_metrics`` dicts — must use one of
#: these prefixes or carry a suppression/baseline entry.
METRIC_FAMILIES: Tuple[str, ...] = (
    "Loss",        # per-update optimization losses
    "Rewards",     # episode returns
    "Game",        # episode length / env accounting
    "State",       # world-model latent diagnostics (kl, entropies)
    "Test",        # evaluation rollouts
    "Time",        # utils.timer phase walls
    "Params",      # run parameters surfaced as metrics (replay ratio, lr)
    "Grads",       # gradient norms
    "Info",        # miscellaneous run info (ratios, counters)
    "Compile",     # compile-once recompile detector
    "Checkpoint",  # async snapshot writer
    "Resilience",  # fault injections, retries, watchdogs, breakers
    "Phase",       # telemetry span phase-breakdown fractions
    "Health",      # training-health sentinels
    "Serve",       # policy-as-a-service stats
    "Fleet",       # serving-fleet router (replicas, failovers, migrations)
    "Sebulba",     # actor-learner topology queues/broadcast
    "Dcn",         # cross-host pod transport (segments, broadcast, control)
    "Player",      # PlayerSync staleness
    "Telemetry",   # introspection endpoint self-metrics
    "Population",  # in-trace PBT: fitness spread, exploits, hp quantiles
)

#: config subtrees whose LEAVES are data, not knobs — metric names as keys,
#: user-authored fault plans, partition-rule tables: reading them key-by-key
#: is not how they are consumed, so the dead-key rule skips them.
DEAD_KEY_EXEMPT_PREFIXES: Tuple[str, ...] = (
    "metric.aggregator.metrics",
    "fault_injection.plan",
    "sharding.rules",
)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping) and v:
            out.update(_flatten(v, path + "."))
        else:
            out[path] = v
    return out


@dataclasses.dataclass
class ConfigLeaf:
    path: str          # dotted, e.g. "buffer.device_mirror"
    file: str          # repo-relative yaml file that (first) defines it
    line: int


class RepoContext:
    """Everything the rules need beyond a single file's AST."""

    def __init__(self) -> None:
        self.config_paths: Set[str] = set()       # every dotted path incl. interior nodes
        self.config_leaves: Dict[str, ConfigLeaf] = {}
        self.yaml_reads: Set[str] = set()          # ${a.b.c} interpolation targets
        self.yaml_fault_sites: List[Tuple[str, str, int]] = []  # (site, file, line)
        self.fault_sites: Tuple[str, ...] = ()
        self.metric_families: Tuple[str, ...] = METRIC_FAMILIES
        self.notes: List[str] = []
        self.root: Path = Path(".")

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, root: Path) -> "RepoContext":
        ctx = cls()
        ctx.root = root
        ctx._load_fault_registry(root / REPO_PACKAGE / "resilience" / "faults.py")
        ctx._load_config_tree(root / REPO_PACKAGE / "configs")
        return ctx

    def _load_fault_registry(self, faults_py: Path) -> None:
        """KNOWN_SITES (the site registry; ROW/BYTE/TRACE sites are subsets
        of it) and the keys of UNPORTED_SITES out of faults.py's AST."""
        sites: List[str] = []
        try:
            tree = ast.parse(faults_py.read_text())
        except (OSError, SyntaxError) as e:
            self.notes.append(f"fault registry unavailable ({e}); fault-site rule disabled")
            self.fault_sites = ()
            return
        for node in tree.body:
            if isinstance(node, ast.Assign):
                names = {t.id for t in node.targets if isinstance(t, ast.Name)}
                if "KNOWN_SITES" in names and isinstance(node.value, (ast.Tuple, ast.List)):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                            sites.append(elt.value)
                if "UNPORTED_SITES" in names and isinstance(node.value, ast.Dict):
                    for key in node.value.keys:
                        if isinstance(key, ast.Constant) and isinstance(key.value, str) and key.value not in sites:
                            sites.append(key.value)
        if not sites:
            self.notes.append("KNOWN_SITES not found in faults.py; fault-site rule disabled")
        self.fault_sites = tuple(sites)

    # -- config tree ---------------------------------------------------------
    def _load_config_tree(self, config_dir: Path) -> None:
        """Union of every YAML file's keys, mounted where compose would put
        them: root ``config.yaml`` and ``exp/*`` at the root, each group dir
        under its group name, and ``@``-placed groups (``/optim@optimizer``)
        at their placement paths inside the placing group.  Groups only ever
        referenced through ``@`` placements (optim, logger) do NOT mount at
        root — recording them there would manufacture dead keys."""
        try:
            from sheeprl_tpu_torch.config.compose import _ConfigLoader  # same float grammar
            import yaml

            def load(path: Path) -> Dict[str, Any]:
                with open(path) as f:
                    data = yaml.load(f, Loader=_ConfigLoader)
                return data if isinstance(data, dict) else {}
        except Exception as e:  # pragma: no cover - yaml always present in repo
            self.notes.append(f"config tree unavailable ({e}); cfg rules disabled")
            return

        if not config_dir.is_dir():
            self.notes.append(f"config dir {config_dir} missing; cfg rules disabled")
            return

        def record(tree: Mapping[str, Any], prefix: str, file: Path) -> None:
            rel = _rel(file, self.root)
            for path, _value in _flatten(tree).items():
                full = f"{prefix}{path}" if prefix else path
                if full not in self.config_leaves:
                    self.config_leaves[full] = ConfigLeaf(
                        full, rel, _yaml_key_line(file, path.rsplit(".", 1)[-1])
                    )
                parts = full.split(".")
                for i in range(1, len(parts) + 1):
                    self.config_paths.add(".".join(parts[:i]))
            _collect_interpolations(tree, self.yaml_reads)
            _collect_fault_sites(tree, rel, file, self.yaml_fault_sites)

        # pass 1: parse every file, strip defaults, collect '@' placements
        # and the root defaults group list
        parsed: List[Tuple[str, Path, Dict[str, Any]]] = []  # (group, file, data)
        at_mounts: Set[Tuple[str, str]] = set()  # (mount prefix, group)
        root_groups: Set[str] = set()

        root_cfg = config_dir / "config.yaml"
        root_data: Dict[str, Any] = {}
        if root_cfg.is_file():
            root_data = load(root_cfg)
            for entry in root_data.pop("defaults", []) or []:
                if isinstance(entry, Mapping):
                    for g in entry:
                        g = str(g)
                        for pfx in ("optional ", "override "):
                            if g.startswith(pfx):
                                g = g[len(pfx):]
                        root_groups.add(g)

        for sub in sorted(config_dir.iterdir()):
            if not sub.is_dir():
                continue
            group = sub.name
            for f in sorted(p for p in sub.iterdir() if p.suffix in (".yaml", ".yml")):
                data = load(f)
                for entry in data.pop("defaults", None) or []:
                    if not isinstance(entry, Mapping):
                        continue
                    for k in entry:
                        k = str(k)
                        if k.startswith("override "):
                            k = k[len("override "):]
                        if "@" in k:
                            src, _, at = k.partition("@")
                            mount = at if group == "exp" else f"{group}.{at}"
                            at_mounts.add((mount, src.lstrip("/")))
                        # '/group: name' entries re-select root groups —
                        # covered by that group's own root mount
                parsed.append((group, f, data))

        # pass 2: record at the right mounts
        at_only = {g for _, g in at_mounts} - root_groups
        if root_data:
            record(root_data, "", root_cfg)
        for group, f, data in parsed:
            if group == "exp":
                record(data, "", f)  # exp overlays mount at root
            elif group not in at_only:
                record(data, f"{group}.", f)
        for mount, group in sorted(at_mounts):
            for g, f, data in parsed:
                if g == group:
                    record(data, f"{mount}.", f)

    # -- queries -------------------------------------------------------------
    def has_config_path(self, path: str) -> bool:
        """True when ``path`` is a known interior node or leaf."""
        return path in self.config_paths


def _rel(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def _yaml_key_line(file: Path, key: str) -> int:
    """Best-effort line of a YAML key: first ``key:`` occurrence.  Good
    enough for pointing a finding at (duplicate nested key names are rare
    in this tree and the file is always exact)."""
    try:
        lines = file.read_text().splitlines()
    except OSError:
        return 1
    pat = re.compile(rf"^\s*['\"]?{re.escape(key)}['\"]?\s*:")
    for i, raw in enumerate(lines, 1):
        if pat.match(raw):
            return i
    return 1


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _collect_interpolations(tree: Any, out: Set[str]) -> None:
    if isinstance(tree, Mapping):
        for v in tree.values():
            _collect_interpolations(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect_interpolations(v, out)
    elif isinstance(tree, str):
        for m in _INTERP.finditer(tree):
            ref = m.group(1)
            if not ref.split(".", 1)[0] in ("env", "eval", "now", "oc"):
                out.add(ref)


#: a mapping is a fault-plan spec only when its "site" key has schedule/kind
#: siblings — the ONE definition shared by the Python-side dict check
#: (registry.py) and the YAML-side plan scan below, so the two can't drift
SPEC_SIBLING_KEYS = ("kind", "at", "every", "p", "seconds", "max_fires", "exception")


def _collect_fault_sites(
    tree: Any, rel: str, file: Path, out: List[Tuple[str, str, int]]
) -> None:
    """``site:`` entries of fault-plan-shaped mappings (a ``site`` key with
    schedule/kind siblings — the fault_injection plan schema)."""
    if isinstance(tree, Mapping):
        site = tree.get("site")
        if isinstance(site, str) and any(k in tree for k in SPEC_SIBLING_KEYS):
            out.append((site, rel, _yaml_key_line(file, "site")))
        for v in tree.values():
            _collect_fault_sites(v, rel, file, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect_fault_sites(v, rel, file, out)
