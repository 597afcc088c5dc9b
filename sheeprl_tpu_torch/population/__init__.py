"""Population training with in-trace PBT on the Anakin axis (counterpart of
``sheeprl_tpu/population/``)."""

from sheeprl_tpu_torch.population.core import (
    PBTConfig,
    PopulationMonitor,
    apply_level_curriculum,
    init_population_state,
    make_population_phase,
    pbt_exploit_explore,
    perturbation_factors,
    tile_stack,
    write_population_summary,
)

__all__ = [
    "PBTConfig",
    "PopulationMonitor",
    "apply_level_curriculum",
    "init_population_state",
    "make_population_phase",
    "pbt_exploit_explore",
    "perturbation_factors",
    "tile_stack",
    "write_population_summary",
]
