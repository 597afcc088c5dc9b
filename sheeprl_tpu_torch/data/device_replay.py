"""Device-resident replay on one device (counterpart of
``sheeprl_tpu/data/device_replay.py``).

With ``buffer.device`` on (``auto``: whenever the run's device is CUDA) the
replay ring of the Dreamer family and of SAC, DroQ and SAC-AE lives on the
card, and a train window samples from it there:

* **Storage** is one dict of device tensors ``(W, E, *feat)``, allocated in
  full at the first add of a key; uint8 pixels stay uint8.  ``W`` is the
  window kept on the card (:func:`fit_hbm_window`), ``E`` the env count.
* **Writes** stage host rows with explicit copies from pinned memory
  (:func:`stage`) and scatter them at ring slots the host computes from its
  cursor shadows.
* **Sampling** draws indices on the device from the run's train generator
  and gathers there: :func:`fused_uniform_train` and
  :func:`fused_sequence_train` fold the draw, the gather, the layout's
  ``prep`` and the trainer's ``train_phase`` into one call, so a steady
  train window copies nothing from the host — which :func:`steady_guard`
  turns into an error on the card.  Each index law is split into a draw
  (:func:`draw_uniform`, :func:`draw_sequence`) and its application
  (:meth:`DeviceReplay.uniform_indices_from`,
  :meth:`DeviceReplay.sequence_indices_from`), so a test can hand the port
  the draws a JAX key makes.
* **Capacity beyond the window** is shadowed on the host by
  :class:`HostSpill`: appends enqueue the rows to a full-capacity host ring
  (optionally memmapped) that a daemon thread fills; the train step never
  touches it, and a checkpoint prefers it because it holds more history.

Cursors (``pos``/``filled`` per env) live twice: as int64 tensors on the
device, which sampling reads, and as numpy shadows on the host for
``len``, :meth:`DeviceReplay.can_sample` and
:meth:`DeviceReplay.can_sample_sequences`, so eligibility never waits on the
device.  The JAX package shards the ring over a mesh; on one device that is
a no-op, and this port has no mesh.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import queue
import threading
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sheeprl_tpu_torch.resilience.faults import fault_rows
from sheeprl_tpu_torch.telemetry.spans import span
from sheeprl_tpu_torch.utils.callback import consistent_tail

Arrays = Dict[str, np.ndarray]
Cursor = Dict[str, torch.Tensor]

#: draws of a uniform start are reduced modulo the number of valid starts;
#: over this range the modulo bias is below 1e-12 for any ring a card holds
_RAW_RANGE = 1 << 62

#: the ring keeps what JAX's arrays keep with 64-bit types off
_CANONICAL = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def _canonical(dtype: Any) -> np.dtype:
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


# --------------------------------------------------------------------------
# config resolution
# --------------------------------------------------------------------------

def resolve_device_replay(cfg: Any, device: Union[str, torch.device]) -> bool:
    """``buffer.device``: ``auto`` means on when the run's device is CUDA
    (on the CPU the device ring would duplicate the host ring in the same
    memory); True/False force it, so a CPU test can run the device path."""
    mode = cfg.buffer.get("device", "auto")
    if isinstance(mode, str) and mode.lower() == "auto":
        return torch.device(device).type == "cuda"
    return bool(mode)


def estimate_step_bytes(
    obs_space: Any, obs_keys: Sequence[str], extra_bytes: int = 64, copies_per_key: int = 1
) -> int:
    """Ring bytes per (env, step), from the observation space, before
    anything is allocated: ``extra_bytes`` covers actions, rewards and
    flags; ``copies_per_key`` is 2 for layouts that also store
    ``next_<k>`` rows."""
    total = int(extra_bytes)
    for k in obs_keys:
        space = obs_space[k]
        total += int(np.prod(space.shape)) * np.dtype(space.dtype).itemsize * int(copies_per_key)
    return total


def fit_hbm_window(
    capacity: int, n_envs: int, step_bytes: int, requested: Optional[int] = None
) -> Tuple[int, bool]:
    """``(window_steps, spill_needed)`` under the device byte budget
    (``SHEEPRL_REPLAY_BUDGET_BYTES``, default 8 GiB).  The window is the
    per-env ring length kept on the device; anything beyond it lives only in
    the host spill tier.  An explicit ``buffer.hbm_window`` is honoured,
    still capped by the budget."""
    budget = float(os.environ.get("SHEEPRL_REPLAY_BUDGET_BYTES", 8 * 2**30))
    window = int(capacity) if requested is None else min(int(requested), int(capacity))
    fits = max(1, int(budget // max(step_bytes * n_envs, 1)))
    if window > fits:
        print(
            f"[sheeprl_tpu_torch] buffer.device: window shrunk {window} -> {fits} "
            f"steps/env (~{step_bytes * n_envs * fits / 2**30:.2f} GiB ring; raise "
            "SHEEPRL_REPLAY_BUDGET_BYTES to widen) — older data lives in the host "
            "spill tier",
            flush=True,
        )
        window = fits
    return window, window < int(capacity)


def update_chunks(n_updates: int, cap: Optional[int] = None, bytes_per_update: float = 0.0) -> List[int]:
    """A window of ``n_updates`` as power-of-two chunks, largest first.

    ``cap`` (default ``SHEEPRL_MAX_WINDOW_UPDATES``, 1024) bounds a chunk;
    with ``bytes_per_update`` (the gathered bytes of one update,
    :meth:`DeviceReplay.sampled_bytes_per_update`) it also keeps a chunk's
    gathered block under ``SHEEPRL_MAX_HBM_WINDOW_BYTES`` (default 2 GiB).
    Fixed power-of-two shapes are what a captured graph of a window needs."""
    if cap is None:
        cap = int(os.environ.get("SHEEPRL_MAX_WINDOW_UPDATES", 1024))
    if bytes_per_update > 0.0:
        budget = float(os.environ.get("SHEEPRL_MAX_HBM_WINDOW_BYTES", 2**31))
        cap = min(int(cap), max(1, int(budget // bytes_per_update)))
    cap = 1 << (max(1, int(cap)).bit_length() - 1)
    chunks: List[int] = []
    remaining = int(n_updates)
    while remaining > 0:
        step = min(cap, 1 << (remaining.bit_length() - 1))
        chunks.append(step)
        remaining -= step
    return chunks


@contextlib.contextmanager
def steady_guard(enabled: bool) -> Iterator[None]:
    """Around a steady train window on the card: any call that makes the
    host wait for the device raises (``torch.cuda.set_sync_debug_mode
    ("error")``) — a blocking copy from the host (``torch.tensor(x,
    device="cuda")``, a pageable ``.to("cuda")``) as well as a read back
    (``.item()``, ``.cpu()``, a tensor's truth value).  That is stricter
    than ``jax.transfer_guard_host_to_device``, which refuses only the
    first, so what reads the device (the health flag, metrics) sits after
    the guarded block.  Explicit staging (:func:`stage`) stays legal.
    Without CUDA it does nothing."""
    if not enabled or not torch.cuda.is_available():
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


# --------------------------------------------------------------------------
# explicit staging
# --------------------------------------------------------------------------

def stage(x: Any, device: Union[str, torch.device]) -> torch.Tensor:
    """An explicit copy of host data to ``device``.  On CUDA the rows go
    through pinned memory and the copy does not block; the pinned buffer
    belongs to torch's host allocator, which reuses it only after the copy
    has landed, so the caller may overwrite ``x`` at once.  On the CPU the
    tensor shares ``x``'s memory: every consumer here copies it at once."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage_rollout(tree: Dict[str, Any], device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """On-policy rollout blocks staged to ``device`` (:func:`stage` per key),
    so a guarded train phase finds them there."""
    return {k: stage(np.asarray(v), device) for k, v in tree.items()}


def stage_scalar(value: float, device: Union[str, torch.device], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A scalar (an annealed coefficient) as a 0-d tensor on ``device``,
    made there by a fill (no copy from the host)."""
    return torch.full((), float(value), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# async host spill tier
# --------------------------------------------------------------------------

class HostSpill:
    """Asynchronous full-capacity host shadow of a :class:`DeviceReplay`.

    The caller (the env loop) copies the incoming rows and enqueues them;
    one daemon thread drains the queue into a host ring (``ReplayBuffer``,
    or with ``sequential`` one sub-buffer per env, because the Dreamer add
    path appends reset rows to the done envs only), optionally memmapped.
    An error in the worker is parked: :attr:`degraded` flips, the device
    ring keeps training and a checkpoint falls back to the device ring.

    :attr:`fault` is the ``replay.spill`` fault site: the worker passes each
    job's rows through it before writing (by default the active fault plan's
    :func:`~sheeprl_tpu_torch.resilience.faults.fault_rows`, a no-op without
    a plan)."""

    def __init__(
        self,
        capacity: int,
        n_envs: int,
        sequential: bool = False,
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        queue_size: int = 256,
    ):
        from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer, ReplayBuffer

        self.capacity = int(capacity)
        if sequential:
            self._rb: Any = EnvIndependentReplayBuffer(
                int(capacity), n_envs=int(n_envs), memmap=memmap, memmap_dir=memmap_dir
            )
        else:
            self._rb = ReplayBuffer(int(capacity), int(n_envs), memmap=memmap, memmap_dir=memmap_dir)
        self.fault: Optional[Callable[[Arrays], Arrays]] = functools.partial(fault_rows, "replay.spill")
        self._queue: "queue.Queue[Optional[Tuple[Any, Any]]]" = queue.Queue(
            maxsize=max(1, int(queue_size))
        )
        self._error: Optional[BaseException] = None
        self._idle = threading.Event()
        self._idle.set()
        self._pending = 0
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="replay-spill", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            data, indices = job
            try:
                if data is None:  # a repair_tail, in order with the adds before it
                    self._rb.repair_tail(indices)
                else:
                    self._rb.add(self.fault(data) if self.fault is not None else data, indices=indices)
            except BaseException as e:  # parked: the spill degrades, training goes on
                if self._error is None:
                    self._error = e
                    warnings.warn(
                        f"replay spill tier degraded ({type(e).__name__}: {e}); the "
                        "device ring keeps training, capacity beyond its window "
                        "is no longer persisted",
                        RuntimeWarning,
                    )
            finally:
                self._queue.task_done()
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    @property
    def degraded(self) -> bool:
        return self._error is not None

    @property
    def backlog(self) -> int:
        return self._queue.unfinished_tasks

    @property
    def buffer(self) -> Any:
        """The host ring (drain it with :meth:`flush` before reading)."""
        return self._rb

    def submit(self, data: Arrays, indices: Optional[Sequence[int]] = None) -> None:
        """Enqueue one append; the rows are copied here (the caller reuses
        its step arrays).  Blocks only when the bounded queue is full."""
        self._put(({k: np.array(v, copy=True) for k, v in data.items()},
                   list(indices) if indices is not None else None))

    def submit_repair(self, env: int) -> None:
        """Enqueue ``repair_tail(env)`` behind the appends before it, so the
        shadow carries the truncation mark the device ring got (the JAX
        module repairs the device ring alone)."""
        self._put((None, int(env)))

    def _put(self, job: Tuple[Any, Any]) -> None:
        if self._closed:
            return
        with self._lock:
            self._pending += 1
            self._idle.clear()
        self._queue.put(job)

    def flush(self, timeout_s: Optional[float] = 60.0) -> bool:
        return self._idle.wait(timeout_s)

    def state_dict(self) -> Dict[str, Any]:
        self.flush()
        return self._rb.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.flush()
        self._rb.load_state_dict(state)

    def close(self, timeout_s: float = 30.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._idle.wait(timeout_s)
        try:
            self._queue.put(None, timeout=5.0)
        except queue.Full:
            pass
        self._thread.join(5.0)


def build_device_replay(cfg: Any, capacity: int, n_envs: int, device: Union[str, torch.device], step_bytes: int,
                        sequential: bool, memmap_dir: Optional[Union[str, os.PathLike]]) -> "DeviceReplay":
    """A loop's ring: ``capacity`` steps per env wanted (``buffer.size``),
    the window the byte budget and ``buffer.hbm_window`` allow on
    ``device``, and a spill tier (memmapped with ``buffer.memmap``) when the
    window is the shorter."""
    window, spill_needed = fit_hbm_window(capacity, n_envs, step_bytes, cfg.buffer.get("hbm_window"))
    spill = (HostSpill(capacity, n_envs, sequential=sequential, memmap=cfg.buffer.memmap, memmap_dir=memmap_dir)
             if spill_needed else None)
    return DeviceReplay(window, n_envs, device, spill=spill)


# --------------------------------------------------------------------------
# index draws (the random half of each index law)
# --------------------------------------------------------------------------

def draw_uniform(generator: torch.Generator, total: int, n_envs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw draws of ``total`` uniform samples, on the generator's
    device: a step draw over ``[0, 2**62)`` (reduced modulo the valid steps
    by :meth:`DeviceReplay.uniform_indices_from`) and an env in ``[0,
    n_envs)``."""
    dev = generator.device
    raw = torch.randint(0, _RAW_RANGE, (int(total),), generator=generator, device=dev)
    env = torch.randint(0, int(n_envs), (int(total),), generator=generator, device=dev)
    return raw, env


def draw_sequence(generator: torch.Generator, total: int, n_envs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw draws of ``total`` sequence samples, on the generator's
    device: standard Gumbels ``(total, n_envs)`` for the env (a Gumbel-max
    over the occupancy logits, as ``jax.random.categorical`` draws) and a
    start draw over ``[0, 2**62)``."""
    dev = generator.device
    u = torch.rand((int(total), int(n_envs)), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))
    raw = torch.randint(0, _RAW_RANGE, (int(total),), generator=generator, device=dev)
    return gumbel, raw


# --------------------------------------------------------------------------
# the device-resident ring
# --------------------------------------------------------------------------

class DeviceReplay:
    """Replay ring ``Dict[str, (W, E, *feat)]`` on one device.

    Write path: host ``(T, B, *)`` rows → :func:`stage` per key → a scatter
    at ring slots computed from the host cursor shadows; the device cursors
    are refreshed by one staged copy into the same two tensors, so a
    captured window can read them in place."""

    #: how long :meth:`state_dict` waits for the spill worker before it
    #: falls back to a device-ring snapshot
    _spill_flush_timeout_s: float = 60.0

    def __init__(
        self,
        capacity: int,
        n_envs: int,
        device: Union[str, torch.device] = "cpu",
        spill: Optional[HostSpill] = None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if n_envs <= 0:
            raise ValueError(f"n_envs must be positive, got {n_envs}")
        self._capacity = int(capacity)
        self._n_envs = int(n_envs)
        self.device = torch.device(device)
        self.spill = spill
        self._buf: Dict[str, torch.Tensor] = {}
        self._pos_h = np.zeros(self._n_envs, np.int64)
        self._filled_h = np.zeros(self._n_envs, np.int64)
        self.cursor: Cursor = {
            "pos": torch.zeros(self._n_envs, dtype=torch.int64, device=self.device),
            "filled": torch.zeros(self._n_envs, dtype=torch.int64, device=self.device),
        }

    # -- geometry / introspection -------------------------------------------
    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def buffer_size(self) -> int:
        return self._capacity

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def buffers(self) -> Dict[str, torch.Tensor]:
        """The ring tensors (read them, never write them)."""
        return self._buf

    @property
    def full(self) -> bool:
        return bool((self._filled_h >= self._capacity).all())

    @property
    def empty(self) -> bool:
        return not self._buf

    def __len__(self) -> int:
        return int(self._filled_h.sum())

    def __contains__(self, key: str) -> bool:
        return key in self._buf

    def keys(self) -> Tuple[str, ...]:
        return tuple(self._buf.keys())

    def describe(self) -> str:
        spill = f", a host spill of {self.spill.capacity}" if self.spill is not None else ""
        return f"a device ring on {self.device} ({self._capacity} steps/env{spill})"

    @property
    def hbm_bytes(self) -> int:
        """Bytes the ring holds on the device."""
        return sum(a.numel() * a.element_size() for a in self._buf.values())

    def sampled_bytes_per_update(self, batch_size: int, sequence_length: int = 1,
                                 derive_next: Sequence[str] = ()) -> float:
        """Bytes one update's gathered batch takes on the device (call after
        the first add): the ``bytes_per_update`` of :func:`update_chunks`."""
        total = 0.0
        for k, buf in self._buf.items():
            row = int(np.prod(buf.shape[2:])) * buf.element_size()
            copies = 2 if k in derive_next else 1
            total += row * int(batch_size) * int(sequence_length) * copies
        return total

    def can_sample(self, min_steps: int = 1) -> bool:
        return bool((self._filled_h >= max(1, int(min_steps))).any())

    def can_sample_sequences(self, sequence_length: int) -> bool:
        # the host law: some env holds more than sequence_length steps
        return bool((self._filled_h > int(sequence_length)).any())

    # -- write path ----------------------------------------------------------
    def _ensure(self, key: str, feat_shape: Tuple[int, ...], dtype: Any) -> None:
        if key in self._buf:
            return
        np_dtype = _canonical(dtype)
        torch_dtype = torch.from_numpy(np.zeros((), np_dtype)).dtype
        # a failed allocation raises: there is no fallback to the host ring
        self._buf[key] = torch.zeros((self._capacity, self._n_envs, *feat_shape), dtype=torch_dtype,
                                     device=self.device)

    def _rows(self, x: Any) -> torch.Tensor:
        """Host rows in the ring's dtype, staged to the device."""
        return stage(np.asarray(x, dtype=_canonical(np.asarray(x).dtype)), self.device)

    def _refresh_cursor(self) -> None:
        staged = stage(np.stack([self._pos_h, self._filled_h]), self.device)
        self.cursor["pos"].copy_(staged[0])
        self.cursor["filled"].copy_(staged[1])

    def add(self, data: Arrays, indices: Optional[Sequence[int]] = None) -> None:
        """Append ``T`` steps of ``(T, B, *)`` host data for all (or
        ``indices``) envs — the host buffers' ``add``."""
        if not isinstance(data, dict) or not data:
            raise ValueError("add() expects a non-empty dict of (T, B, *) arrays")
        first = next(iter(data.values()))
        if np.ndim(first) < 2:
            raise ValueError("Buffer data must be (T, B, *)")
        steps = int(np.shape(first)[0])
        if self.spill is not None:
            # the spill shadows the full capacity: it gets the whole block,
            # before the truncation to the window below
            self.spill.submit(data, indices=indices)
        if steps > self._capacity:
            data = {k: np.asarray(v)[-self._capacity:] for k, v in data.items()}
            steps = self._capacity
        env_sel = np.arange(self._n_envs) if indices is None else np.asarray(list(indices), np.int64)
        if np.shape(first)[1] != len(env_sel):
            raise ValueError(f"data has {np.shape(first)[1]} envs, expected {len(env_sel)}")
        for k, v in data.items():
            self._ensure(k, np.shape(v)[2:], np.asarray(v).dtype)
        # the ring slots each env is about to write (host math, no device read)
        t_idx = (self._pos_h[env_sel][None, :] + np.arange(steps)[:, None]) % self._capacity  # (T, K)
        # host→ring staging is its own telemetry phase (replay.write)
        with span("replay.write"):
            t_dev = stage(t_idx, self.device)
            e_dev = stage(env_sel, self.device)
            for k, v in data.items():
                self._buf[k][t_dev, e_dev[None, :]] = self._rows(np.asarray(v)[-steps:])
        self._pos_h[env_sel] = (self._pos_h[env_sel] + steps) % self._capacity
        self._filled_h[env_sel] = np.minimum(self._filled_h[env_sel] + steps, self._capacity)
        self._refresh_cursor()

    def repair_tail(self, env: int = 0) -> None:
        """Mark the last written step of ``env`` as a truncation (its stream
        broke: a crashed and restarted env) — the host buffers' contract."""
        if self._filled_h[env] == 0:
            return
        if self.spill is not None:
            self.spill.submit_repair(env)
        tail = int((self._pos_h[env] - 1) % self._capacity)
        for key, value in (("truncated", 1.0), ("terminated", 0.0), ("is_first", 0.0)):
            if key in self._buf:
                row = np.full((1, 1, *self._buf[key].shape[2:]), value, np.float32)
                self.write_at(key, row, np.asarray([[tail]]), [env])

    def write_at(self, key: str, rows: np.ndarray, time_pos: np.ndarray, env_cols: Sequence[int]) -> None:
        """Scatter ``rows (T, K, *)`` at ring slots ``time_pos (T, K)`` of
        env columns ``env_cols (K,)``; the cursors are untouched."""
        rows = np.asarray(rows)
        self._ensure(key, rows.shape[2:], rows.dtype)
        t = stage(np.asarray(time_pos, np.int64), self.device)
        e = stage(np.asarray(list(env_cols), np.int64), self.device)
        self._buf[key][t, e[None, :]] = self._rows(rows).to(self._buf[key].dtype)

    def gather_at(self, key: str, time_idx: np.ndarray, env_idx: np.ndarray) -> torch.Tensor:
        """The ring rows of ``key`` at explicit coordinates."""
        t = stage(np.asarray(time_idx, np.int64), self.device)
        e = stage(np.asarray(env_idx, np.int64), self.device)
        return self._buf[key][t, e]

    # -- index laws (the deterministic half) ---------------------------------
    def uniform_indices_from(self, raw_step: torch.Tensor, env: torch.Tensor, cursor: Optional[Cursor] = None,
                             sample_next_obs: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(step, env)`` of uniform draws — the host ``ReplayBuffer`` law:
        the envs of a uniform layout advance in lockstep, so env 0's cursor
        is the ring's; when the ring is full and successor rows are needed,
        the slot before the write head is excluded by basing the draws at
        ``pos``.  ``raw_step`` is reduced modulo the number of valid steps
        (a draw already inside it is kept as it is)."""
        cursor = self.cursor if cursor is None else cursor
        cap = self._capacity
        pos, filled = cursor["pos"][0], cursor["filled"][0]
        full = filled >= cap
        trim = 1 if sample_next_obs else 0
        valid = torch.where(full, torch.full_like(filled, cap - trim), (filled - trim).clamp_min(0))
        r = raw_step % valid.clamp_min(1)
        step = torch.where(full, (pos + r) % cap, r) if sample_next_obs else r
        return step, env

    def sequence_indices_from(self, gumbel: torch.Tensor, raw_start: torch.Tensor, sequence_length: int,
                              cursor: Optional[Cursor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(t_idx (total, L), env (total,))`` of contiguous sequence draws
        — the ``EnvIndependentReplayBuffer`` law: envs weighted by occupancy
        among those holding at least ``L`` steps (the argmax of the
        occupancy logits plus ``gumbel``), the start uniform over the env's
        valid range, a sequence never crossing its env's write head."""
        cursor = self.cursor if cursor is None else cursor
        cap, L = self._capacity, int(sequence_length)
        pos, filled = cursor["pos"], cursor["filled"]
        full = filled >= cap
        max_start = torch.where(full, torch.full_like(filled, cap - L), filled - L)
        weights = torch.where(filled >= L, filled, torch.zeros_like(filled)).to(torch.float32)
        logits = torch.where(weights > 0, torch.log(weights.clamp_min(1e-9)),
                             torch.full_like(weights, -math.inf))
        env = torch.argmax(gumbel + logits, dim=-1)
        valid = (max_start[env] + 1).clamp_min(1)
        start = raw_start % valid
        base = torch.where(full[env], pos[env], torch.zeros_like(start))
        t_idx = (base[:, None] + start[:, None] + torch.arange(L, device=env.device)[None, :]) % cap
        return t_idx, env

    def uniform_indices(self, generator: torch.Generator, total: int, sample_next_obs: bool = False):
        return self.uniform_indices_from(*draw_uniform(generator, total, self._n_envs),
                                         sample_next_obs=sample_next_obs)

    def sequence_indices(self, generator: torch.Generator, total: int, sequence_length: int):
        return self.sequence_indices_from(*draw_sequence(generator, total, self._n_envs), sequence_length)

    # -- gathers ---------------------------------------------------------------
    def sample_uniform(self, generator: Optional[torch.Generator], batch_size: int, n_samples: int = 1,
                       keys: Optional[Sequence[str]] = None, derive_next: Sequence[str] = (),
                       indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Uniform ``(n_samples, batch_size, *)`` batches gathered on the
        device, at ``indices`` (``(step, env)``) or at draws from
        ``generator``.  ``derive_next`` lists keys whose successor row is
        emitted as ``next_<k>`` (layouts that do not store it)."""
        n, b = int(n_samples), int(batch_size)
        if indices is None:
            indices = self.uniform_indices(generator, n * b, sample_next_obs=bool(derive_next))
        step, env = indices
        out: Dict[str, torch.Tensor] = {}
        for k, buf in self._buf.items():
            if keys is not None and k not in keys:
                continue
            out[k] = buf[step, env].reshape(n, b, *buf.shape[2:])
        for k in derive_next:
            if k in self._buf:
                buf = self._buf[k]
                out[f"next_{k}"] = buf[(step + 1) % self._capacity, env].reshape(n, b, *buf.shape[2:])
        return out

    def sample_sequences(self, generator: Optional[torch.Generator], batch_size: int, sequence_length: int,
                         n_samples: int = 1, keys: Optional[Sequence[str]] = None,
                         indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Contiguous ``(n_samples, L, batch_size, *)`` sequence batches
        gathered on the device — the Dreamer family's layout — at
        ``indices`` (``(t_idx, env)``) or at draws from ``generator``."""
        n, b, L = int(n_samples), int(batch_size), int(sequence_length)
        if indices is None:
            indices = self.sequence_indices(generator, n * b, L)
        t_idx, env = indices
        # index straight into the (n, L, b) layout: one gather, contiguous
        t_nlb = t_idx.reshape(n, b, L).transpose(1, 2).contiguous()
        e_nlb = env.reshape(n, 1, b)
        return {k: buf[t_nlb, e_nlb] for k, buf in self._buf.items() if keys is None or k in keys}

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """A host snapshot.  The spill tier's full-capacity ring when it is
        armed and healthy (it holds more history than the window; a degraded
        spill, or one that does not drain in time, falls back to the device
        ring); otherwise one copy of the ring to the host.  Either way the
        checkpoint's tail patch lands on the copy: the step at each env's
        write head must not look continuable on resume, so ``truncated``
        and ``dones`` are forced there, never ``terminated`` (a value flag)."""
        if self.spill is not None and not self.spill.degraded:
            if self.spill.flush(self._spill_flush_timeout_s):
                state = self.spill.state_dict()
                consistent_tail(state)
                state["device_replay"] = {
                    "pos": np.array(self._pos_h),
                    "filled": np.array(self._filled_h),
                    "from_spill": True,
                }
                return state
            warnings.warn(
                "replay spill tier did not drain in time; checkpointing the "
                "device ring (its window) instead of the full spill history",
                RuntimeWarning,
            )
        buf = {k: v.detach().to("cpu", copy=True).numpy() for k, v in self._buf.items()}
        if buf and not any(k.startswith("next_") for k in buf):
            for env in range(self._n_envs):
                if self._filled_h[env] == 0:
                    continue
                tail = int((self._pos_h[env] - 1) % self._capacity)
                for key in ("truncated", "dones"):
                    if key in buf:
                        buf[key][tail, env] = 1.0
        return {
            "buffer": buf,
            "pos": np.array(self._pos_h),
            "filled": np.array(self._filled_h),
            "buffer_size": self._capacity,
            "n_envs": self._n_envs,
            "device_replay": {"from_spill": False},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "DeviceReplay":
        meta = state.get("device_replay") or {}
        if meta.get("from_spill"):
            return self._load_from_spill(state, meta)
        if int(state.get("n_envs", self._n_envs)) != self._n_envs:
            raise ValueError(
                f"Checkpointed replay has {state.get('n_envs')} envs, expected "
                f"{self._n_envs} (resume requires the same world size)"
            )
        if "buffers" in state:
            raise ValueError(
                "this checkpoint was written by the host EnvIndependent buffer "
                "backend; restore it with buffer.device=False or re-collect — "
                "host->device restore is only supported through the spill tier"
            )
        saved_cap = int(state.get("buffer_size", self._capacity))
        pos = np.asarray(state["pos"]).reshape(-1)
        # a host ReplayBuffer's state has a scalar cursor and no "filled"
        # (the JAX module reads the key unconditionally and fails there)
        filled = np.asarray(state.get("filled", state["pos"])).reshape(-1)
        if pos.size == 1:
            pos = np.full(self._n_envs, int(pos[0]))
            filled = np.full(self._n_envs, saved_cap if state.get("full") else int(pos[0]))
        if saved_cap != self._capacity:
            raise ValueError(f"Checkpointed replay window {saved_cap} != {self._capacity}")
        for k, v in state["buffer"].items():
            v = np.asarray(v)
            self._ensure(k, v.shape[2:], v.dtype)
            self._buf[k].copy_(self._rows(v))
        self._pos_h = pos.astype(np.int64).copy()
        self._filled_h = np.minimum(filled.astype(np.int64), self._capacity).copy()
        self._refresh_cursor()
        return self

    def _load_from_spill(self, state: Dict[str, Any], meta: Dict[str, Any]) -> "DeviceReplay":
        """Restore a spill-tier checkpoint: reload the full host shadow, then
        rebuild the window from each env's newest rows at exactly the saved
        cursors."""
        if self.spill is None:
            raise ValueError(
                "checkpoint was written from the replay spill tier but this "
                "run has no spill armed — keep the same buffer.size / "
                "buffer.hbm_window / SHEEPRL_REPLAY_BUDGET_BYTES as the saved run"
            )
        self.spill.load_state_dict({k: v for k, v in state.items() if k != "device_replay"})
        pos = np.asarray(meta["pos"]).reshape(-1).astype(np.int64)
        filled = np.minimum(np.asarray(meta["filled"]).reshape(-1).astype(np.int64), self._capacity)
        if pos.size != self._n_envs:
            raise ValueError(f"spill checkpoint has {pos.size} env cursors, expected {self._n_envs}")
        for env in range(self._n_envs):
            history = self._spill_env_history(env)  # key -> (L_e, *) oldest to newest
            if not history:
                continue
            length = next(iter(history.values())).shape[0]
            n = int(min(filled[env], length))
            if n == 0:
                continue
            slots = (pos[env] - n + np.arange(n)) % self._capacity
            for k, rows in history.items():
                self.write_at(k, rows[-n:][:, None], slots[:, None], [env])
            filled[env] = n
        self._pos_h = pos.copy()
        self._filled_h = filled.copy()
        self._refresh_cursor()
        return self

    def _spill_env_history(self, env: int) -> Dict[str, np.ndarray]:
        """One env's rows in the spill's host ring, oldest to newest."""
        from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer

        host = self.spill.buffer
        if isinstance(host, EnvIndependentReplayBuffer):
            sub = host.buffer[env]
            length = len(sub)
            if length == 0:
                return {}
            idx = (sub._pos + np.arange(sub.buffer_size)) % sub.buffer_size if sub.full else np.arange(length)
            return {k: np.asarray(sub[k])[idx, 0] for k in sub.keys()}
        length = len(host)
        if length == 0:
            return {}
        idx = (host._pos + np.arange(host.buffer_size)) % host.buffer_size if host.full else np.arange(length)
        return {k: np.asarray(host[k])[idx, env] for k in host.keys()}


# --------------------------------------------------------------------------
# fused sample + update
# --------------------------------------------------------------------------

def fused_uniform_train(trainer: Any, replay: DeviceReplay, generator: torch.Generator, batch_size: int,
                        n_samples: int, prep: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                        counter: int, derive_next: Sequence[str] = (),
                        indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        noise: Any = None) -> Tuple[int, Tuple[torch.Tensor, ...]]:
    """One chunk of ``n_samples`` updates on uniform batches drawn and
    gathered on the device: the indices from ``generator`` (or
    ``indices``), the gather, ``prep``, then ``trainer.train_phase(batches,
    noise or generator, counter)``.  Returns ``(counter + n_samples,
    metrics)``; nothing is read back."""
    batch = replay.sample_uniform(generator, batch_size, n_samples, derive_next=derive_next, indices=indices)
    metrics = trainer.train_phase(prep(batch), generator if noise is None else noise, counter)
    return counter + int(n_samples), metrics


def fused_sequence_train(trainer: Any, replay: DeviceReplay, generator: torch.Generator, batch_size: int,
                         sequence_length: int, n_samples: int,
                         prep: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]], counter: int,
                         indices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         noise: Any = None) -> Tuple[int, Tuple[torch.Tensor, ...]]:
    """The sequence twin of :func:`fused_uniform_train` (the Dreamer
    family): ``(n_samples, L, B, *)`` blocks drawn and gathered on the
    device, then the trainer's window of updates.  This is the function the
    DreamerV3 loop captures as one CUDA graph per chunk size: it reads the
    cursors in place from the ring's two persistent tensors, draws from
    ``generator`` (registered with the graph), and takes ``counter`` as a
    0-d tensor on the device there (an int when it runs eagerly)."""
    blocks = replay.sample_sequences(generator, batch_size, sequence_length, n_samples, indices=indices)
    metrics = trainer.train_phase(prep(blocks), generator if noise is None else noise, counter)
    return counter + int(n_samples), metrics
