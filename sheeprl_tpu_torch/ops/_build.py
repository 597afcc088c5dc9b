"""Build the port's CUDA sources with ``nvcc`` at first use, load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/sheeprl_tpu_torch/lib<name>-<digest>.so``
beside the package; the digest covers the sources and the flags, so an edited
kernel is rebuilt and a stale library is never loaded.  The libraries have a
plain C interface (no PyTorch headers), which keeps a build to seconds.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sheeprl_tpu_torch"
SOURCES = ("gru", "rssm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_BUILD_LOCK = threading.Lock()  # one build at a time: a warm-up thread's and a first call's
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of sheeprl_tpu_torch are compiled at first "
        "use (put nvcc on PATH or set CUDA_HOME)"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet: one ``nvcc``
    per source, all started together.  Returns ``{name: ptxas report}`` for
    the sources compiled by this call (registers, shared memory, spills)."""
    with _BUILD_LOCK:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, str]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, tmp, out, proc))
    reports, failures = {}, []
    for name, tmp, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        reports[name] = stderr + stdout
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if needed, with ``argtypes``
    set from ``signatures`` and every function returning a C ``int``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
