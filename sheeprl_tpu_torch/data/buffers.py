"""Host replay buffers (copies of ``sheeprl_tpu/data/buffers.py``, numpy only).

``ReplayBuffer`` (uniform FIFO ring), ``SequentialReplayBuffer`` (contiguous
sequences with wrap-around), ``EnvIndependentReplayBuffer`` (one
sub-buffer per env), all over ``(T, B, *)`` numpy arrays, and
``EpisodeBuffer`` (whole episodes, end-prioritised sequence sampling), with
their ``state_dict`` / ``load_state_dict``.  ``sample(..., n_samples=k)`` returns
``(k, ...)``-stacked arrays, one block per train window.  Sampling draws from
numpy's global generator, which ``Fabric.seed_everything`` seeds.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from sheeprl_tpu_torch.data.memmap import MemmapArray

Arrays = Dict[str, np.ndarray]


def _steps_and_envs(data: Arrays) -> Tuple[int, int]:
    key = next(iter(data))
    shape = data[key].shape
    if len(shape) < 2:
        raise ValueError(f"Buffer data must be (T, B, *): key '{key}' has shape {shape}")
    return shape[0], shape[1]


class ReplayBuffer:
    """Uniform-sampling FIFO ring buffer over ``Dict[str, (size, n_envs, *)]``.

    Storage is lazily allocated on the first ``add`` (so observation keys and
    shapes need not be declared up front), optionally as ``MemmapArray``s
    under ``memmap_dir`` (reference behavior: sheeprl/data/buffers.py:20-360).
    """

    batch_axis: int = 1

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        obs_keys: Sequence[str] = (),
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be positive, got {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"n_envs must be positive, got {n_envs}")
        self._buffer_size = int(buffer_size)
        self._n_envs = int(n_envs)
        self._memmap = bool(memmap)
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        if self._memmap and self._memmap_dir is not None:
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._buf: Dict[str, Union[np.ndarray, MemmapArray]] = {}
        self._obs_keys = tuple(obs_keys)
        self._pos = 0
        self._full = False

    # -- properties -------------------------------------------------------
    @property
    def buffer(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self._buf.items()}

    @property
    def buffer_size(self) -> int:
        return self._buffer_size

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> bool:
        return self._full

    @property
    def is_memmap(self) -> bool:
        return self._memmap

    @property
    def empty(self) -> bool:
        return not self._buf

    def __len__(self) -> int:
        return self._buffer_size if self._full else self._pos

    def __contains__(self, key: str) -> bool:
        return key in self._buf

    def __getitem__(self, key: str) -> np.ndarray:
        return np.asarray(self._buf[key])

    def keys(self) -> Tuple[str, ...]:
        return tuple(self._buf.keys())

    # -- write path -------------------------------------------------------
    def _allocate(self, key: str, shape: Tuple[int, ...], dtype: Any) -> None:
        full_shape = (self._buffer_size, self._n_envs) + tuple(shape)
        if self._memmap:
            filename = None
            if self._memmap_dir is not None:
                filename = self._memmap_dir / f"{key}.memmap"
            self._buf[key] = MemmapArray(full_shape, dtype=dtype, filename=filename)
        else:
            self._buf[key] = np.zeros(full_shape, dtype=dtype)

    def add(self, data: Arrays, indices: Optional[Sequence[int]] = None) -> None:
        """Append ``T`` steps of ``(T, B, *)`` data for all (or ``indices``) envs."""
        if not isinstance(data, dict) or not data:
            raise ValueError("add() expects a non-empty dict of (T, B, *) arrays")
        steps, envs = _steps_and_envs(data)
        if steps > self._buffer_size:
            # keep only the last buffer_size steps
            data = {k: v[-self._buffer_size:] for k, v in data.items()}
            steps = self._buffer_size
        env_sel = np.arange(self._n_envs) if indices is None else np.asarray(indices)
        if envs != len(env_sel):
            raise ValueError(f"data has {envs} envs, expected {len(env_sel)}")
        for k, v in data.items():
            if k not in self._buf:
                self._allocate(k, v.shape[2:], v.dtype)
        idx = (self._pos + np.arange(steps)) % self._buffer_size
        for k, v in data.items():
            self._buf[k][idx[:, None], env_sel[None, :]] = v
        if self._pos + steps >= self._buffer_size:
            self._full = True
        self._pos = int((self._pos + steps) % self._buffer_size)

    # -- read path --------------------------------------------------------
    def _valid_steps(self, sample_next_obs: bool) -> np.ndarray:
        """Step indices that can be sampled.  When ``sample_next_obs`` we must
        not sample the slot right before the write head (its successor is the
        oldest, unrelated step — reference: sheeprl/data/buffers.py:244-264)."""
        if self._full:
            if sample_next_obs:
                valid = (self._pos + np.arange(self._buffer_size - 1)) % self._buffer_size
            else:
                valid = np.arange(self._buffer_size)
        else:
            n = self._pos - 1 if sample_next_obs else self._pos
            valid = np.arange(max(n, 0))
        return valid

    def sample(
        self,
        batch_size: int,
        sample_next_obs: bool = False,
        n_samples: int = 1,
        keys: Optional[Sequence[str]] = None,
        **kwargs: Any,
    ) -> Arrays:
        """Uniformly sample ``n_samples`` × ``batch_size`` transitions.

        Returns ``(n_samples, batch_size, *)`` arrays.  When
        ``sample_next_obs`` is set, adds ``next_<key>`` entries for every
        observation key by reading the successor step.  ``keys`` restricts
        the gathered output.
        """
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be positive")
        if self.empty or len(self) == 0:
            raise RuntimeError("Cannot sample from an empty buffer")
        valid = self._valid_steps(sample_next_obs)
        if valid.size == 0:
            raise RuntimeError("No valid steps to sample (buffer too small)")
        total = batch_size * n_samples
        step_idx = valid[np.random.randint(0, valid.size, size=total)]
        env_idx = np.random.randint(0, self._n_envs, size=total)
        batch = self._gather(step_idx, env_idx, sample_next_obs, keys=keys)
        return {k: v.reshape(n_samples, batch_size, *v.shape[1:]) for k, v in batch.items()}

    def _gather(
        self,
        step_idx: np.ndarray,
        env_idx: np.ndarray,
        sample_next_obs: bool,
        keys: Optional[Sequence[str]] = None,
    ) -> Arrays:
        out: Arrays = {}
        for k, v in self._buf.items():
            if keys is not None and k not in keys:
                continue
            arr = np.asarray(v)
            out[k] = arr[step_idx, env_idx]
        if sample_next_obs:
            next_idx = (step_idx + 1) % self._buffer_size
            obs_keys = self._obs_keys or tuple(k for k in self._buf if k.startswith("obs") or k == "observations")
            for k in obs_keys:
                if k in self._buf and (keys is None or k in keys):
                    out[f"next_{k}"] = np.asarray(self._buf[k])[next_idx, env_idx]
        return out

    def repair_tail(self, env: int = 0) -> None:
        """Mark the last written step as a truncation: called when the data
        stream breaks mid-episode (e.g. a crashed-and-restarted env) so the
        stored partial episode never bootstraps across the break.  The
        patched row must not also start an episode (reference behavior:
        sheeprl/algos/dreamer_v3/dreamer_v3.py:595-608)."""
        if len(self) == 0:
            return
        tail = (self._pos - 1) % self._buffer_size
        for key, value in (("truncated", 1.0), ("terminated", 0.0), ("is_first", 0.0)):
            if key in self._buf:
                self._buf[key][tail, env] = value

    # -- persistence ------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "buffer": {k: v if isinstance(v, MemmapArray) else np.asarray(v) for k, v in self._buf.items()},
            "pos": self._pos,
            "full": self._full,
            "buffer_size": self._buffer_size,
            "n_envs": self._n_envs,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> "ReplayBuffer":
        if state["buffer_size"] != self._buffer_size or state["n_envs"] != self._n_envs:
            raise ValueError(
                "Checkpointed buffer has incompatible geometry: "
                f"size {state['buffer_size']} x envs {state['n_envs']} vs "
                f"{self._buffer_size} x {self._n_envs} (resume requires the same world size, "
                "as in the reference, sheeprl/algos/dreamer_v3/dreamer_v3.py:486-492)"
            )
        self._buf = dict(state["buffer"])
        self._pos = int(state["pos"])
        self._full = bool(state["full"])
        return self


class SequentialReplayBuffer(ReplayBuffer):
    """Samples contiguous length-L sequences, ignoring episode boundaries,
    with modulo wrap-around when full (reference: sheeprl/data/buffers.py:363-526).

    Output layout: ``(n_samples, sequence_length, batch_size, *)`` — the
    natural shape for a ``lax.scan`` over time with a static batch.
    """

    batch_axis: int = 2

    def sample(
        self,
        batch_size: int,
        sequence_length: int = 1,
        n_samples: int = 1,
        sample_next_obs: bool = False,
        keys: Optional[Sequence[str]] = None,
        **kwargs: Any,
    ) -> Arrays:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be positive")
        if sequence_length <= 0:
            raise ValueError(f"sequence_length must be positive, got {sequence_length}")
        filled = len(self)
        if filled == 0:
            raise RuntimeError("Cannot sample from an empty buffer")
        if filled < sequence_length:
            raise RuntimeError(
                f"Buffer has {filled} steps, fewer than sequence_length={sequence_length}"
            )
        # valid sequence start offsets (relative to the oldest step); one
        # extra trailing step is reserved when next-observations are needed
        span = sequence_length + (1 if sample_next_obs else 0)
        if self._full:
            # a sequence may not cross the write head
            max_start = self._buffer_size - span
            base = self._pos
        else:
            max_start = self._pos - span
            base = 0
        if max_start < 0:
            raise RuntimeError("Not enough contiguous data for the requested sequence length")
        total = batch_size * n_samples
        starts = np.random.randint(0, max_start + 1, size=total)
        env_idx = np.random.randint(0, self._n_envs, size=total)
        # absolute step indices (total, L)
        step_idx = (base + starts[:, None] + np.arange(sequence_length)[None, :]) % self._buffer_size
        def gather(arr: np.ndarray, idx: np.ndarray) -> np.ndarray:
            g = arr[idx, env_idx[:, None]]  # (total, L, *)
            return g.reshape(n_samples, batch_size, sequence_length, *arr.shape[2:]).swapaxes(1, 2)

        out: Arrays = {}
        for k, v in self._buf.items():
            if keys is not None and k not in keys:
                continue
            out[k] = gather(np.asarray(v), step_idx)
        if sample_next_obs:
            next_idx = (step_idx + 1) % self._buffer_size
            obs_keys = self._obs_keys or tuple(
                k for k in self._buf if k.startswith("obs") or k == "observations"
            )
            for k in obs_keys:
                if k in self._buf and (keys is None or k in keys):
                    out[f"next_{k}"] = gather(np.asarray(self._buf[k]), next_idx)
        return out


class EnvIndependentReplayBuffer:
    """One sub-buffer per environment stream
    (reference: sheeprl/data/buffers.py:529-743).

    Needed because per-env streams advance at different rates after resets;
    sampling draws a multinomial split across sub-buffers then concatenates
    on the sub-buffer class's batch axis.
    """

    def __init__(
        self,
        buffer_size: int,
        n_envs: int = 1,
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        buffer_cls: type = SequentialReplayBuffer,
        **kwargs: Any,
    ):
        self._buffer_size = buffer_size
        self._n_envs = n_envs
        self._buffer_cls = buffer_cls
        self._buffers: List[ReplayBuffer] = []
        for i in range(n_envs):
            sub_dir = None
            if memmap and memmap_dir is not None:
                sub_dir = Path(memmap_dir) / f"env_{i}"
            self._buffers.append(
                buffer_cls(buffer_size, n_envs=1, memmap=memmap, memmap_dir=sub_dir, **kwargs)
            )
        self._concat_along = getattr(buffer_cls, "batch_axis", 1)

    @property
    def buffer(self) -> List[ReplayBuffer]:
        return self._buffers

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> bool:
        return all(b.full for b in self._buffers)

    def __len__(self) -> int:
        return sum(len(b) for b in self._buffers)

    def add(self, data: Arrays, indices: Optional[Sequence[int]] = None) -> None:
        env_sel = list(range(self._n_envs)) if indices is None else list(indices)
        for col, env in enumerate(env_sel):
            self._buffers[env].add({k: v[:, col:col + 1] for k, v in data.items()})

    def sample(self, batch_size: int, n_samples: int = 1, **kwargs: Any) -> Arrays:
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be positive")
        # only sub-buffers able to serve the request get sampling mass
        min_len = kwargs.get("sequence_length", 1) + (1 if kwargs.get("sample_next_obs") else 0)
        occupied = np.array(
            [len(b) if len(b) >= min_len else 0 for b in self._buffers], dtype=np.float64
        )
        if occupied.sum() == 0:
            raise RuntimeError("Cannot sample from an empty buffer")
        probs = occupied / occupied.sum()
        counts = np.random.multinomial(batch_size, probs)
        parts: List[Arrays] = []
        for b, c in zip(self._buffers, counts):
            if c > 0:
                parts.append(b.sample(int(c), n_samples=n_samples, **kwargs))
        keys = parts[0].keys()
        return {k: np.concatenate([p[k] for p in parts], axis=self._concat_along) for k in keys}

    def repair_tail(self, env: int) -> None:
        """See :meth:`ReplayBuffer.repair_tail` — applied to one env stream."""
        self._buffers[env].repair_tail(env=0)

    def state_dict(self) -> Dict[str, Any]:
        return {"buffers": [b.state_dict() for b in self._buffers]}

    def load_state_dict(self, state: Dict[str, Any]) -> "EnvIndependentReplayBuffer":
        saved = state["buffers"]
        if len(saved) != self._n_envs:
            raise ValueError(
                f"Checkpoint has {len(saved)} env buffers, expected {self._n_envs}"
            )
        for b, s in zip(self._buffers, saved):
            b.load_state_dict(s)
        return self


class EpisodeBuffer:
    """Whole-episode storage with end-prioritised sequence sampling
    (reference: sheeprl/data/buffers.py:746-1155).

    Open episodes accumulate per env; an episode is committed on termination
    or truncation if it is at least ``minimum_episode_length`` long, evicting
    the oldest committed episodes when the stored steps would exceed
    ``buffer_size``.
    """

    def __init__(
        self,
        buffer_size: int,
        sequence_length: int,
        n_envs: int = 1,
        prioritize_ends: bool = False,
        minimum_episode_length: Optional[int] = None,
        memmap: bool = False,
        memmap_dir: Optional[Union[str, os.PathLike]] = None,
        **kwargs: Any,
    ):
        if buffer_size <= 0:
            raise ValueError(f"buffer_size must be positive, got {buffer_size}")
        if sequence_length <= 0:
            raise ValueError(f"sequence_length must be positive, got {sequence_length}")
        self._buffer_size = buffer_size
        self._sequence_length = sequence_length
        self._minimum_episode_length = minimum_episode_length or sequence_length
        if self._minimum_episode_length < sequence_length:
            raise ValueError("minimum_episode_length must be >= sequence_length")
        self._n_envs = n_envs
        self._prioritize_ends = prioritize_ends
        self._memmap = memmap
        self._memmap_dir = Path(memmap_dir) if memmap_dir is not None else None
        if self._memmap and self._memmap_dir is not None:
            self._memmap_dir.mkdir(parents=True, exist_ok=True)
        self._episodes: List[Arrays] = []
        self._open: List[Optional[Dict[str, List[np.ndarray]]]] = [None] * n_envs
        self._stored_steps = 0
        self._episode_counter = 0

    @property
    def buffer(self) -> List[Arrays]:
        return self._episodes

    @property
    def n_envs(self) -> int:
        return self._n_envs

    @property
    def full(self) -> bool:
        return self._stored_steps >= self._buffer_size

    def __len__(self) -> int:
        return self._stored_steps

    def add(self, data: Arrays, indices: Optional[Sequence[int]] = None) -> None:
        """``data`` is ``(T, B, *)`` and must hold a ``terminated`` (or
        ``dones``) signal, and may hold ``truncated``, to commit episodes."""
        done = None
        for key in ("dones", "terminated"):
            if key in data:
                done = data[key].astype(bool)
                break
        if done is None:
            raise ValueError("EpisodeBuffer.add requires a 'dones' or 'terminated' key")
        if "truncated" in data:
            done = done | data["truncated"].astype(bool)
        steps, _ = _steps_and_envs(data)
        env_sel = list(range(self._n_envs)) if indices is None else list(indices)
        for col, env in enumerate(env_sel):
            for t in range(steps):
                if self._open[env] is None:
                    self._open[env] = {k: [] for k in data}
                for k, v in data.items():
                    # a copy: the caller may reuse its arrays for the next step
                    self._open[env][k].append(np.array(v[t, col]))
                if bool(np.asarray(done[t, col]).reshape(-1)[0]):
                    self._commit(env)

    def repair_tail(self, env: int) -> None:
        """The stream of ``env`` broke mid-episode: its open (uncommitted)
        episode can never be finished, so it is discarded."""
        self._open[env] = None

    def _commit(self, env: int) -> None:
        open_ep = self._open[env]
        self._open[env] = None
        if open_ep is None:
            return
        length = len(next(iter(open_ep.values())))
        if length < self._minimum_episode_length:
            return
        episode: Dict[str, Any] = {k: np.stack(v) for k, v in open_ep.items()}
        if self._memmap:
            self._episode_counter += 1
            episode = {
                k: MemmapArray.from_array(
                    v,
                    filename=(self._memmap_dir / f"ep_{self._episode_counter}_{k}.memmap")
                    if self._memmap_dir is not None
                    else None,
                )
                for k, v in episode.items()
            }
        self._episodes.append(episode)
        self._stored_steps += length
        while self._stored_steps > self._buffer_size and self._episodes:
            evicted = self._episodes.pop(0)
            self._stored_steps -= len(next(iter(evicted.values())))
            for v in evicted.values():
                if isinstance(v, MemmapArray):
                    v.close(delete_file=True)

    def sample(
        self,
        batch_size: int,
        n_samples: int = 1,
        sequence_length: Optional[int] = None,
        **kwargs: Any,
    ) -> Arrays:
        """``(n_samples, L, batch_size, *)`` sequences: episodes are chosen
        uniformly among those at least ``L`` long, then a start uniform over
        the valid range; with ``prioritize_ends`` the start is drawn over the
        whole episode and clamped to the last valid start, so the final
        window carries (L+1)/(ep_len+1) of the mass (reference:
        buffers.py:1077-1099)."""
        L = sequence_length or self._sequence_length
        if not self._episodes:
            raise RuntimeError("Cannot sample from an empty EpisodeBuffer")
        lengths = np.array([len(next(iter(ep.values()))) for ep in self._episodes])
        eligible = np.where(lengths >= L)[0]
        if eligible.size == 0:
            raise RuntimeError(f"No episode is >= sequence_length={L}")
        total = batch_size * n_samples
        chosen = np.random.choice(eligible, size=total)
        keys = self._episodes[0].keys()
        gathered: Dict[str, List[np.ndarray]] = {k: [] for k in keys}
        for ep_idx in chosen:
            ep = self._episodes[ep_idx]
            ep_len = lengths[ep_idx]
            max_start = ep_len - L
            if self._prioritize_ends:
                start = min(np.random.randint(0, ep_len + 1), max_start)
            else:
                start = np.random.randint(0, max_start + 1)
            for k in keys:
                gathered[k].append(np.asarray(ep[k][start:start + L]))
        out: Arrays = {}
        for k, chunks in gathered.items():
            arr = np.stack(chunks)  # (total, L, *)
            out[k] = arr.reshape(n_samples, batch_size, L, *arr.shape[2:]).swapaxes(1, 2)
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The committed episodes; open ones are dropped, like the
        reference's checkpoint (sheeprl/utils/callback.py:122-142)."""
        return {"episodes": self._episodes, "stored_steps": self._stored_steps}

    def load_state_dict(self, state: Dict[str, Any]) -> "EpisodeBuffer":
        self._episodes = list(state["episodes"])
        self._stored_steps = int(state["stored_steps"])
        return self
