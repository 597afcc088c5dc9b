"""The serving fleet: a health-checked router over N replica processes
(counterpart of ``sheeprl_tpu/serve/fleet/``).

* ``router``   — :class:`FleetRouter` + :class:`FleetServer`: a stdlib-HTTP
  front doing health-checked least-loaded dispatch, per-replica circuit
  breakers (eject/readmit), rendezvous-hash session affinity with carry
  migration on replica death, and fleet-wide rolling hot reload driven by
  the same ``CommitWatcher`` single servers use;
* ``replicas`` — :class:`LocalFleet`: spawns the replicas
  (``python -m sheeprl_tpu_torch.serve``) and respawns the dead with
  jittered backoff.

One address for clients, N interchangeable replica processes behind it: a
replica death costs at most one in-flight step, never a session.
"""

from sheeprl_tpu_torch.serve.fleet.replicas import LocalFleet
from sheeprl_tpu_torch.serve.fleet.router import FleetRouter, FleetServer, ReplicaState, assign_replica

__all__ = [
    "FleetRouter",
    "FleetServer",
    "LocalFleet",
    "ReplicaState",
    "assign_replica",
]
