"""The Sebulba actor/learner runtime on one device (counterpart of
``sheeprl_tpu/sebulba/``).

The decoupled algorithms route here when ``topology=sebulba`` resolves
(:mod:`sheeprl_tpu_torch.parallel.topology`): the actor role (batched
inference engines, or the fused Anakin rollout for device envs) and the
learner role (the train phase consuming a bounded trajectory queue) share
the one device, with learner → actor parameters published under a bounded
staleness.
"""

from sheeprl_tpu_torch.sebulba.actor import (  # noqa: F401
    ActorEngine,
    EnvWorker,
    FusedActor,
    WorkerSupervisor,
    derive_ladder,
)
from sheeprl_tpu_torch.sebulba.queues import (  # noqa: F401
    ObsBlock,
    ObsQueue,
    TornTrajectory,
    TrajQueue,
)
