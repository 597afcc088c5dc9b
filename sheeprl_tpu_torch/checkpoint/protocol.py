"""Commit protocol for snapshot directories (the JAX package's layout, with
``torch.save`` shards).

Layout of one snapshot::

    <ckpt_root>/
      step_000000001024/
        shard_r00000.pt         # rank 0's state: torch.save of state dicts
        shard_r00000.meta.json  # {crc32, bytes} for that shard
        MANIFEST.json           # step, world size, per-shard crc32/bytes
        COMMIT                  # empty marker, LAST write of the protocol

Every write is tmp-file + fsync + rename + dir-fsync, and ``COMMIT`` lands
only after every shard's meta file, so :func:`latest_checkpoint` (which
only considers directories holding ``COMMIT``) never selects a torn
snapshot.  Shards are read with ``torch.load(weights_only=True)``: tensors
and plain containers only, no pickled code.  A step directory the JAX
package wrote has the same layout with ``shard_r*.pkl`` shards: it verifies
here alike, and :func:`load_step_dir` reads it through the restricted
unpickler of ``serialize.py``.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from sheeprl_tpu_torch.resilience.faults import fault_bytes, fault_point
from sheeprl_tpu_torch.telemetry.monitors import RESILIENCE_MONITOR

COMMIT_FILE = "COMMIT"
MANIFEST_FILE = "MANIFEST.json"
STEP_PREFIX = "step_"
CORRUPT_SUFFIX = ".corrupt"

PathLike = Union[str, os.PathLike]


def step_dir_name(step: int) -> str:
    return f"{STEP_PREFIX}{int(step):012d}"


def shard_name(rank: int) -> str:
    return f"shard_r{int(rank):05d}.pt"


def _meta_name(rank: int) -> str:
    return f"shard_r{int(rank):05d}.meta.json"


def _shard_rank(name: str) -> Optional[int]:
    """Rank of a shard file, the port's (``.pt``) or the JAX package's (``.pkl``)."""
    stem, dot, ext = name.partition(".")
    if stem.startswith("shard_r") and dot and ext in ("pt", "pkl"):
        try:
            return int(stem[len("shard_r"):])
        except ValueError:
            return None
    return None


def fsync_dir(path: PathLike) -> None:
    """fsync a directory so a just-renamed entry survives power loss (best effort)."""
    try:
        fd = os.open(os.fspath(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_write(path: PathLike, payload: bytes) -> None:
    """tmp file in the target directory → fsync → ``os.replace`` → fsync(dir)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(path.parent)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def checkpoint_step(step_dir: PathLike) -> int:
    """Policy step encoded in a snapshot directory name (-1 if not one)."""
    name = Path(step_dir).name
    if not name.startswith(STEP_PREFIX):
        return -1
    try:
        return int(name[len(STEP_PREFIX):])
    except ValueError:
        return -1


def write_shard(step_dir: PathLike, rank: int, state: Any) -> Dict[str, int]:
    """Durably write one rank's shard, then its meta sidecar (whose presence
    implies a complete shard)."""
    step_dir = Path(step_dir)
    buf = io.BytesIO()
    torch.save(state, buf)
    payload = buf.getvalue()
    meta = {"crc32": zlib.crc32(payload) & 0xFFFFFFFF, "bytes": len(payload)}
    # fault site: raise/hang is a dying disk; corrupt/truncate damage the
    # payload after its CRC was taken, the bit-rotted or short shard that
    # verify_checkpoint must catch (the meta keeps the intended size and CRC)
    payload = fault_bytes("checkpoint.write_shard", payload)
    durable_write(step_dir / shard_name(rank), payload)
    durable_write(step_dir / _meta_name(rank), json.dumps(meta).encode())
    return meta


def write_commit(step_dir: PathLike, step: int, world: int = 1) -> bool:
    """Write the CRC manifest, then ``COMMIT``, once every rank's meta file
    exists; returns False (snapshot left uncommitted) otherwise."""
    step_dir = Path(step_dir)
    if any(not (step_dir / _meta_name(r)).exists() for r in range(world)):
        return False
    shards = {}
    for r in range(world):
        with open(step_dir / _meta_name(r)) as f:
            shards[shard_name(r)] = json.load(f)
    # fault site: a crash or hang here, after the shards and before COMMIT,
    # is the torn snapshot that resume and serving must never choose
    fault_point("checkpoint.commit")
    manifest = {"step": int(step), "world": int(world), "time": time.time(), "shards": shards}
    durable_write(step_dir / MANIFEST_FILE, json.dumps(manifest, indent=1).encode())
    durable_write(step_dir / COMMIT_FILE, b"")
    return True


def write_snapshot(ckpt_root: PathLike, step: int, state: Any) -> Path:
    """One-rank snapshot ``<ckpt_root>/step_<step>``: shard, manifest, COMMIT."""
    step_dir = Path(ckpt_root) / step_dir_name(step)
    write_shard(step_dir, 0, state)
    if not write_commit(step_dir, step, world=1):
        raise RuntimeError(f"could not commit {step_dir}")
    return step_dir


def is_committed(step_dir: PathLike) -> bool:
    return (Path(step_dir) / COMMIT_FILE).exists()


def read_manifest(step_dir: PathLike) -> Dict[str, Any]:
    with open(Path(step_dir) / MANIFEST_FILE) as f:
        return json.load(f)


def verify_checkpoint(step_dir: PathLike) -> List[str]:
    """Re-read every shard and check it against the manifest.  Returns the
    list of problems (empty == intact)."""
    step_dir = Path(step_dir)
    if not is_committed(step_dir):
        return [f"{step_dir}: no {COMMIT_FILE} marker"]
    try:
        manifest = read_manifest(step_dir)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{step_dir}: unreadable manifest ({e})"]
    problems: List[str] = []
    shards = manifest.get("shards", {})
    world = int(manifest.get("world", len(shards)) or len(shards))
    listed = {_shard_rank(n) for n in shards}
    unlisted = [r for r in range(world) if r not in listed]
    if unlisted:
        problems.append(f"manifest world={world} but shards for ranks {unlisted} are not listed")
    for name, meta in shards.items():
        shard = step_dir / name
        if not shard.exists():
            problems.append(f"{name}: missing")
            continue
        data = shard.read_bytes()
        if len(data) != meta["bytes"]:
            problems.append(f"{name}: {len(data)} bytes, manifest says {meta['bytes']}")
        elif (zlib.crc32(data) & 0xFFFFFFFF) != meta["crc32"]:
            problems.append(f"{name}: CRC mismatch")
    return problems


def quarantine_checkpoint(step_dir: PathLike) -> Optional[Path]:
    """Rename a damaged committed snapshot to ``step_*.corrupt`` so discovery
    never sees it again (the data is kept).  None if the rename failed."""
    step_dir = Path(step_dir)
    target = step_dir.with_name(step_dir.name + CORRUPT_SUFFIX)
    suffix = 1
    while target.exists():
        target = step_dir.with_name(f"{step_dir.name}{CORRUPT_SUFFIX}.{suffix}")
        suffix += 1
    try:
        os.replace(step_dir, target)
    except OSError:
        return None
    fsync_dir(step_dir.parent)
    RESILIENCE_MONITOR.record_quarantine(target)
    return target


def verify_or_quarantine(step_dir: PathLike) -> List[str]:
    """:func:`verify_checkpoint`; a committed snapshot with problems is quarantined."""
    step_dir = Path(step_dir)
    problems = verify_checkpoint(step_dir)
    if problems and is_committed(step_dir):
        quarantined = quarantine_checkpoint(step_dir)
        if quarantined is not None:
            problems = [*problems, f"quarantined to {quarantined}"]
    return problems


def list_checkpoints(root: PathLike, committed_only: bool = True) -> List[Path]:
    """Snapshot directories under ``root``, sorted by ascending step."""
    root = Path(root)
    if not root.is_dir():
        return []
    dirs = [d for d in root.iterdir() if d.is_dir() and checkpoint_step(d) >= 0]
    if committed_only:
        dirs = [d for d in dirs if is_committed(d)]
    return sorted(dirs, key=checkpoint_step)


def latest_checkpoint(root: PathLike) -> Optional[Path]:
    """Newest COMMITTED snapshot under ``root``, or None."""
    ckpts = list_checkpoints(root, committed_only=True)
    return ckpts[-1] if ckpts else None


def newer_checkpoint(root: PathLike, after_step: int) -> Optional[Path]:
    """Newest COMMITTED snapshot under ``root`` with step > ``after_step``,
    or None — the serving layer's commit-watch primitive (torn snapshots
    are invisible here by construction)."""
    newest = latest_checkpoint(root)
    if newest is not None and checkpoint_step(newest) > int(after_step):
        return newest
    return None


def load_step_dir(step_dir: PathLike, rank: int = 0, map_location: Any = None) -> Any:
    """One rank's state from a committed snapshot (shard 0 when this rank
    has none), tensors placed by ``map_location``; a snapshot the JAX
    package wrote comes back as its numpy tree."""
    step_dir = Path(step_dir)
    if not is_committed(step_dir):
        raise FileNotFoundError(
            f"checkpoint {step_dir} has no {COMMIT_FILE} marker — it is a torn snapshot"
        )
    if any(step_dir.glob("shard_r*.pkl")):  # the JAX package's layout
        from sheeprl_tpu_torch.checkpoint.serialize import load_jax_pickle

        shard = step_dir / f"shard_r{int(rank):05d}.pkl"
        return load_jax_pickle(shard if shard.exists() else step_dir / "shard_r00000.pkl")
    shard = step_dir / shard_name(rank)
    if not shard.exists():
        shard = step_dir / shard_name(0)
    return torch.load(shard, map_location=map_location, weights_only=True)
