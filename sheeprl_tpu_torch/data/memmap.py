"""Disk-backed arrays for replay persistence (copy of ``sheeprl_tpu/data/memmap.py``).

An ``np.memmap`` container with explicit file ownership, transparent ndarray
behaviour, and pickle support that reopens the map on load.  Numpy only.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np


class MemmapArray(np.lib.mixins.NDArrayOperatorsMixin):
    def __init__(
        self,
        shape: Tuple[int, ...],
        dtype: Any = np.float32,
        filename: Optional[os.PathLike] = None,
        mode: str = "r+",
    ):
        self._shape = tuple(int(s) for s in shape)
        self._dtype = np.dtype(dtype)
        self._anonymous = filename is None
        if filename is None:
            import tempfile

            fd, filename = tempfile.mkstemp(suffix=".memmap")
            os.close(fd)
            self._owner = True
        else:
            filename = os.fspath(filename)
            self._owner = not os.path.exists(filename)
            Path(filename).parent.mkdir(parents=True, exist_ok=True)
        self._filename = str(filename)
        exists = os.path.exists(self._filename) and os.path.getsize(self._filename) > 0
        create_mode = "r+" if exists and mode != "w+" else "w+"
        self._array: Optional[np.memmap] = np.memmap(
            self._filename, dtype=self._dtype, mode=create_mode, shape=self._shape
        )

    # -- construction -----------------------------------------------------
    @classmethod
    def from_array(
        cls, array: np.ndarray, filename: Optional[os.PathLike] = None
    ) -> "MemmapArray":
        out = cls(array.shape, array.dtype, filename=filename, mode="w+")
        out._array[:] = array
        out.flush()
        return out

    # -- ndarray protocol -------------------------------------------------
    @property
    def array(self) -> np.memmap:
        if self._array is None:
            raise RuntimeError("MemmapArray is closed")
        return self._array

    @property
    def filename(self) -> str:
        return self._filename

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def ndim(self) -> int:
        return len(self._shape)

    def __len__(self) -> int:
        return self._shape[0]

    def __getitem__(self, idx: Any) -> np.ndarray:
        return self.array[idx]

    def __setitem__(self, idx: Any, value: Any) -> None:
        self.array[idx] = value

    def __array__(self, dtype: Any = None, copy: Optional[bool] = None) -> np.ndarray:
        arr = np.asarray(self.array)
        return arr.astype(dtype) if dtype is not None else arr

    def __array_ufunc__(self, ufunc: Any, method: str, *inputs: Any, **kwargs: Any) -> Any:
        unwrapped = [np.asarray(i.array) if isinstance(i, MemmapArray) else i for i in inputs]
        return getattr(ufunc, method)(*unwrapped, **kwargs)

    def __repr__(self) -> str:
        return f"MemmapArray(shape={self._shape}, dtype={self._dtype}, file={self._filename})"

    # -- lifecycle --------------------------------------------------------
    def flush(self) -> None:
        if self._array is not None:
            self._array.flush()

    def close(self, delete_file: Optional[bool] = None) -> None:
        if self._array is not None:
            self._array.flush()
            del self._array
            self._array = None
        if delete_file is None:
            delete_file = self._owner
        if delete_file and os.path.exists(self._filename):
            try:
                os.unlink(self._filename)
            except OSError:
                pass

    def __del__(self) -> None:
        # anonymous temp files are cleaned up on GC; named files persist so
        # buffers can be reopened after a restart (the point of memmapping)
        try:
            self.close(delete_file=self._owner and self._anonymous)
        except Exception:
            pass

    # -- pickling (reopen map on load; reference memmap.py:251-258) -------
    def __getstate__(self) -> dict:
        self.flush()
        return {
            "_shape": self._shape,
            "_dtype": self._dtype,
            "_filename": self._filename,
            "_owner": False,
            "_anonymous": False,
        }

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        if not os.path.exists(self._filename):
            # The pickle stream only carries a REFERENCE to the backing file;
            # when a checkpoint moves hosts without its memmap_buffer dir the
            # data is genuinely gone.  Rehydrate an owned, anonymous,
            # zero-filled backing of the right geometry and say so clearly,
            # instead of letting np.memmap raise a bare FileNotFoundError
            # from deep inside unpickling (the caller would have no idea
            # which buffer, file, or checkpoint key was at fault).
            import tempfile
            import warnings

            missing = self._filename
            fd, fresh = tempfile.mkstemp(suffix=".memmap")
            os.close(fd)
            warnings.warn(
                f"MemmapArray backing file '{missing}' is missing (checkpoint "
                "restored on a different host without its memmap_buffer "
                "directory?): rehydrating shape "
                f"{self._shape} {self._dtype} ZERO-FILLED in '{fresh}' — "
                "buffer contents from before the move are lost",
                RuntimeWarning,
                stacklevel=2,
            )
            self._filename = fresh
            self._owner = True
            self._anonymous = True
            self._array = np.memmap(fresh, dtype=self._dtype, mode="w+", shape=self._shape)
            return
        self._array = np.memmap(self._filename, dtype=self._dtype, mode="r+", shape=self._shape)
