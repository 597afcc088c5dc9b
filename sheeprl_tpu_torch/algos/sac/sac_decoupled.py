"""Decoupled SAC (``sheeprl_tpu/algos/sac/sac_decoupled.py``) is the scale
layer's topology and is not ported yet: ``exp=sac_decoupled`` raises."""

from __future__ import annotations

from typing import Any

from sheeprl_tpu_torch.utils.registry import register_algorithm


@register_algorithm(decoupled=True)
def main(fabric: Any, cfg: Any) -> None:
    raise NotImplementedError(
        "sac_decoupled is not ported yet: the decoupled topologies come with the scale layer "
        "(ROADMAP.md, queue A item 5); exp=sac trains the coupled SAC"
    )
