"""Decoupled SAC on one device (counterpart of the pipelined ``main`` of
``sheeprl_tpu/algos/sac/sac_decoupled.py``).

With one process the decoupled topology is SAC's own loop,
:func:`~sheeprl_tpu_torch.algos.sac.sac.off_policy_loop`, whose
:class:`~sheeprl_tpu_torch.fabric.PlayerSync` refreshes the player's copy of
the actor only after every ``algo.player.sync_every``-th train window (10 in
``configs/algo/sac_decoupled.yaml``), deferred to the start of the next
window: the player acts on weights up to ``sync_every`` windows old, and
``Player/param_staleness_windows`` / ``Player/param_staleness_max`` report
how old.  ``algo.player.dedicated=True`` warns as the JAX package does and
takes this loop; a wanted device split raises
(:func:`~sheeprl_tpu_torch.parallel.topology.resolve_topology`).
"""

from __future__ import annotations

from typing import Any

from sheeprl_tpu_torch.algos.ppo.ppo_decoupled import warn_dedicated_fallback
from sheeprl_tpu_torch.algos.sac.sac import off_policy_loop
from sheeprl_tpu_torch.parallel.topology import resolve_topology
from sheeprl_tpu_torch.utils.registry import register_algorithm


@register_algorithm(decoupled=True, name="sac_decoupled")
def main(fabric: Any, cfg: Any) -> None:
    resolve_topology(cfg, fabric)
    warn_dedicated_fallback(cfg)
    off_policy_loop(fabric, cfg)
