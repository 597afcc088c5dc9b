"""Checkpoint orchestration for one process (counterpart of
``sheeprl_tpu/checkpoint/manager.py``): cadence, async saves, commit,
retention and resume discovery.

* cadence: ``checkpoint.every`` policy steps, and the final save when
  ``checkpoint.save_last``;
* saving: the state is copied to the host on the caller's thread, so the
  loop may go on updating its tensors at once; the shard write and the
  commit (``protocol.py``) run on the writer thread
  (``checkpoint.async_save=True``) or inline;
* retention: keep the newest ``checkpoint.keep_last`` committed snapshots
  plus every one whose step is a multiple of ``checkpoint.keep_every``;
* resume: :func:`resolve_auto_resume` finds the newest committed snapshot of
  the experiment (``checkpoint.resume_from=auto``);
  :meth:`CheckpointManager.latest` the newest of this run (the rollback's
  target, ``rollback.py``);
* preemption (``checkpoint.save_on_preemption``, ``preemption.py``): the
  first ``should_save`` installs the SIGTERM/SIGINT latch; once it is set,
  ``should_save`` answers True, ``save`` commits synchronously, and the loop
  exits after that save, without its test episode;
* liveness: the writer arms a watchdog with ``checkpoint.hang_warn_s``
  around each job (``writer.py``).

Two settings of the JAX manager act only above one process, where the port
does not run yet (ROADMAP.md, queue A item 5(b)):
``checkpoint.commit_timeout_s`` bounds rank 0's wait for the other ranks'
shards before the commit (one process has written its only shard before it
commits, so nothing is waited for), and
``checkpoint.preemption_poll_every`` spaces the collective by which the
ranks agree on a preemption (one process reads its latch at once, as JAX's
``preempted`` does with one process).
"""

from __future__ import annotations

import glob
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from sheeprl_tpu_torch.checkpoint.preemption import PREEMPTION_GUARD
from sheeprl_tpu_torch.telemetry.monitors import CHECKPOINT_MONITOR
from sheeprl_tpu_torch.checkpoint.protocol import (
    checkpoint_step,
    fsync_dir,
    is_committed,
    latest_checkpoint,
    list_checkpoints,
    step_dir_name,
    write_commit,
    write_shard,
)
from sheeprl_tpu_torch.checkpoint.writer import AsyncCheckpointWriter, run_with_io_retry


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` that ``torch.load(weights_only=True)`` reads back:
    tensors moved to the CPU, numpy arrays as tensors, containers and
    scalars kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if hasattr(tree, "__array__"):  # a MemmapArray
        return torch.from_numpy(np.array(tree))
    return tree


def gc_checkpoints(root: Union[str, os.PathLike], keep_last: Optional[int], keep_every: Optional[int] = None):
    """Delete committed snapshots beyond the newest ``keep_last``, except
    those whose step is a multiple of ``keep_every``, and torn snapshots
    older than the newest committed one.  ``keep_last`` <= 0 keeps all."""
    root = Path(root)
    if keep_last is None or keep_last <= 0:
        return []
    committed = list_checkpoints(root, committed_only=True)
    victims = committed[:-keep_last]
    if keep_every and keep_every > 0:
        victims = [d for d in victims if checkpoint_step(d) % keep_every != 0]
    if committed:
        newest = checkpoint_step(committed[-1])
        victims += [d for d in list_checkpoints(root, committed_only=False)
                    if not is_committed(d) and checkpoint_step(d) < newest]
    deleted = []
    for d in victims:
        try:
            shutil.rmtree(d)
            deleted.append(d)
        except OSError:
            pass
    if deleted:
        fsync_dir(root)
    return deleted


class CheckpointManager:
    def __init__(self, cfg: Any, log_dir: Union[str, os.PathLike]):
        ckpt_cfg = cfg.checkpoint if "checkpoint" in cfg else {}
        self.every = int(ckpt_cfg.get("every", 0) or 0)
        self.save_last = bool(ckpt_cfg.get("save_last", True))
        self.keep_last = ckpt_cfg.get("keep_last", 5)
        self.keep_every = ckpt_cfg.get("keep_every")
        self.async_save = bool(ckpt_cfg.get("async_save", True))
        self.queue_size = int(ckpt_cfg.get("queue_size", 2) or 2)
        self.io_retries = int(ckpt_cfg.get("io_retries", 3) or 1)
        self.io_retry_base_s = float(ckpt_cfg.get("io_retry_base_s", 0.5))
        self.hang_warn_s = float(ckpt_cfg.get("hang_warn_s", 120.0) or 0)
        self.save_on_preemption = bool(ckpt_cfg.get("save_on_preemption", True))
        # read as JAX reads them; both act only above one process (module docstring)
        self.commit_timeout_s = float(ckpt_cfg.get("commit_timeout_s", 300.0))
        self.preemption_poll_every = int(ckpt_cfg.get("preemption_poll_every", 10) or 10)
        self.root = Path(log_dir) / "checkpoint"
        self._writer: Optional[AsyncCheckpointWriter] = None
        self._guard = PREEMPTION_GUARD
        self._preempted = False
        self._finalized = False

    # -- cadence -----------------------------------------------------------------
    @property
    def preempted(self) -> bool:
        """Whether a preemption is pending: the process's SIGTERM/SIGINT latch,
        read at once (one process), or :meth:`force_preempt`."""
        if not self._preempted and self._guard.requested():
            self._preempted = True
        return self._preempted

    def force_preempt(self) -> None:
        """Adopt a preemption decided outside the latch: the next
        ``should_save`` answers True and the save is synchronous."""
        self._preempted = True

    def should_save(self, policy_step: int, last_checkpoint: int, final: bool = False) -> bool:
        """The cadence every loop shares: ``checkpoint.every`` policy steps,
        the final ``save_last`` save, or a pending preemption, which saves
        now whatever the cadence.  With ``checkpoint.save_on_preemption`` the
        first call installs the SIGTERM/SIGINT latch (idempotent): only a
        loop that reads the latch swallows the first signal."""
        if self.save_on_preemption:
            self._guard.install()
        if self.preempted:
            return True
        if self.every > 0 and policy_step - last_checkpoint >= self.every:
            return True
        return final and self.save_last

    def step_dir(self, step: int) -> Path:
        return self.root / step_dir_name(step)

    def save(self, step: int, state: Dict[str, Any], sync: Optional[bool] = None) -> Path:
        """Snapshot ``state`` now (host copies) and commit it as ``step``;
        synchronously with ``checkpoint.async_save=False`` or once preempted
        (the final save must be committed before the process exits).  The
        copies to the host wait for the work queued on the device, a
        replayed window's included, so call it outside ``steady_guard``."""
        sync = (not self.async_save or self.preempted) if sync is None else sync
        step_dir = self.step_dir(step)
        step_dir.mkdir(parents=True, exist_ok=True)
        snap = to_host(state)

        def job() -> int:
            nbytes = write_shard(step_dir, 0, snap)["bytes"]
            if write_commit(step_dir, step, world=1):
                gc_checkpoints(self.root, self.keep_last, self.keep_every)
            return nbytes

        if sync:
            if self._writer is not None:
                self._writer.flush()
            t0 = time.perf_counter()
            nbytes = run_with_io_retry(job, self.io_retries, self.io_retry_base_s)
            CHECKPOINT_MONITOR.record_save(seconds=time.perf_counter() - t0, nbytes=nbytes, asynchronous=False)
        else:
            if self._writer is None:
                self._writer = AsyncCheckpointWriter(self.queue_size, self.io_retries, self.io_retry_base_s,
                                                     self.hang_warn_s)
            self._writer.submit(job)
        return step_dir

    def latest(self) -> Optional[Path]:
        """The newest committed snapshot of this run."""
        return latest_checkpoint(self.root)

    def flush(self) -> None:
        """Wait for the queued saves without finalizing (a rollback needs the
        pending commits on disk, then keeps checkpointing)."""
        if self._writer is not None:
            self._writer.flush()

    def finalize(self, timeout_s: Optional[float] = 300.0) -> None:
        """Drain outstanding async saves (idempotent; call before teardown)."""
        if self._finalized:
            return
        self._finalized = True
        if self._writer is not None:
            self._writer.close(timeout_s)
            self._writer = None


def resolve_auto_resume(base: Union[str, os.PathLike], root_dir: Union[str, os.PathLike],
                        exclude: Any = ()) -> Optional[Path]:
    """Newest committed snapshot (by commit time) across every run and
    version under ``<base>/<root_dir>``."""
    root = os.path.join(os.fspath(base), os.fspath(root_dir))
    best: Optional[Path] = None
    best_mtime = -1.0
    for ckpt_root in glob.glob(os.path.join(root, "*", "version_*", "checkpoint")):
        for step_dir in map(Path, glob.glob(os.path.join(ckpt_root, "step_*"))):
            if checkpoint_step(step_dir) < 0 or step_dir in exclude:
                continue
            try:
                mtime = (step_dir / "COMMIT").stat().st_mtime
            except OSError:
                continue
            if mtime > best_mtime:
                best, best_mtime = step_dir, mtime
    return best
