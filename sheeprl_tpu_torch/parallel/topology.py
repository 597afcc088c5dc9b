"""Which decoupled topology a run takes (counterpart of
``resolve_topology`` in ``sheeprl_tpu/parallel/topology.py``).

The port runs one process on one device, so its only topology is the
pipelined single-controller loop: the update of one rollout overlaps the
collection of the next, the player acting on weights one iteration (PPO) or
``algo.player.sync_every`` windows (SAC) old.  ``auto`` and ``pipelined``
resolve to it.  ``pod`` needs several processes and raises the JAX
package's ``ValueError``.  A wanted device split (``topology=sebulba``, or
``topology.actor_devices`` set) is the JAX package's Sebulba, whose
degenerate one-device form is the next item of the port (ROADMAP.md, queue
A item 5(b)): it raises, and never falls back to the pipelined loop.
"""

from __future__ import annotations

from typing import Any, Dict

SEBULBA_DEFERRED = (
    "the Sebulba actor/learner split (topology=sebulba, or topology.actor_devices set) is not ported yet: "
    "its degenerate form on one device comes next, then the split above one device (sheeprl_tpu/sebulba/; "
    "ROADMAP.md, queue A item 5(b)); topology=pipelined runs the single-controller decoupled loop"
)


def topology_cfg(cfg: Any) -> Dict[str, Any]:
    """The ``topology`` config group as a plain dict (empty when absent)."""
    raw = cfg.get("topology") if hasattr(cfg, "get") else None
    return dict(raw) if raw else {}


def resolve_topology(cfg: Any, fabric: Any = None) -> str:
    """The decoupled topology of this run: ``"pipelined"``, the only one the
    port has; the others raise (see the module's docstring)."""
    topo = topology_cfg(cfg)
    name = str(topo.get("name", "auto")).lower()
    if name == "pipelined":
        return "pipelined"
    if name not in ("auto", "sebulba", "pod"):
        raise ValueError(f"topology.name must be auto|pipelined|sebulba|pod, got {name!r}")
    num_processes = int(getattr(fabric, "num_processes", 1) or 1)
    if name == "pod" and num_processes <= 1:
        raise ValueError(
            "topology=pod needs a multi-process fabric (fabric.distributed.*, "
            "or SHEEPRL_FAKE_DCN=N for the CI pod)"
        )
    wanted = name in ("sebulba", "pod") or topo.get("actor_devices") is not None
    if not wanted:
        return "pipelined"
    raise NotImplementedError(SEBULBA_DEFERRED)
