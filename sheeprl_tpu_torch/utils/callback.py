"""The replay tail of a checkpoint (counterpart of the buffer-consistency
trick of ``sheeprl_tpu/utils/callback.py``, ``CheckpointCallback`` and
``_consistent_tail``).

The environments' state is not checkpointed, so a resumed run must not read
the step at a ring's write head as continuing across the checkpoint: the
saved copy marks that step ``truncated`` / ``dones`` = 1.  ``terminated``
is never forced (it is a value flag: a forced 1 would kill that row's
bootstrap), and a layout that stores ``next_<key>`` rows (SAC, DroQ,
SAC-AE) needs no patch, since each row is self-contained.

The JAX callback patches the live ring, saves, and puts the rows back.  Here
the patch lands on the state's own copy of the two arrays, so a save that is
written in the background never races a restore of the live ring.  The
port's save routing (async snapshots, commits, retention) is
``checkpoint/manager.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer

#: the episode-boundary keys a checkpoint forces at each ring's write head
TAIL_KEYS = ("truncated", "dones")


def consistent_tail(state: Dict[str, Any]) -> None:
    """Force ``truncated`` / ``dones`` = 1 on the write-head row of a host
    ring's state (one ring's ``state_dict``, or ``{"buffers": [...]}``, one
    per env stream), replacing the two arrays in ``state`` by patched copies:
    the arrays a ``state_dict`` holds may be the live ring's own (or the
    memmaps behind it).  An empty ring and a ``next_*`` layout are left as
    they are."""

    def patch_one(sub: Dict[str, Any]) -> None:
        buf = sub.get("buffer") or {}
        if not buf or any(k.startswith("next_") for k in buf):
            return
        filled = int(sub["buffer_size"]) if sub.get("full") else int(sub.get("pos", 0))
        if filled == 0:
            return
        tail = (int(sub["pos"]) - 1) % int(sub["buffer_size"])
        for key in TAIL_KEYS:
            if key in buf:
                arr = np.array(np.asarray(buf[key]), copy=True)
                arr[tail] = 1
                buf[key] = arr

    if "buffers" in state:
        for sub in state["buffers"]:
            patch_one(sub)
    else:
        patch_one(state)


def replay_state(rb: Any) -> Dict[str, Any]:
    """``rb``'s state for a snapshot, dispatched as JAX's callback does: a
    ``ReplayBuffer`` and each sub-buffer of an ``EnvIndependentReplayBuffer``
    get the tail patch on the saved copy; an ``EpisodeBuffer`` (which saves
    closed episodes only) and the card's ``DeviceReplay`` (which patches its
    own snapshot) save as they are.  The live ring is never changed."""
    state = rb.state_dict()  # fresh dicts around the ring's arrays
    if isinstance(rb, (ReplayBuffer, EnvIndependentReplayBuffer)):
        consistent_tail(state)
    return state
