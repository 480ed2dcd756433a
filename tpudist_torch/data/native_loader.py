"""ctypes bindings and the prefetching loader over the native gather engine
— the counterpart of :mod:`tpudist.data.native_loader`.

The answer to ``DataLoader(num_workers=N)`` (``demo.py:150``).  Split of
responsibilities:

- **Python owns determinism**: batch order comes from the same seeded
  :class:`~tpudist_torch.data.sharding.ShardPlan` permutation as the
  synchronous loader — the native path changes when bytes move, never which
  rows are chosen (tests hold it batch for batch against the JAX loader).
- **C++ owns the bytes**: ``native/gather.cpp``'s thread pool copies dataset
  rows into a ring of preallocated batch buffers up to ``prefetch_depth``
  batches ahead, overlapping host assembly with device steps.

The library is compiled with ``g++ -O3 -shared -fPIC -pthread`` at first use
into ``build/tpudist_torch/libtpugather-<hash>.so`` beside the CUDA kernels
(``<hash>`` covers the source and the flags, as :mod:`tpudist_torch.ops.
_build` names its libraries).  ``--num_workers`` is a performance hint:
where no ``g++`` exists, :func:`tpudist_torch.data.make_loader` falls back
to the synchronous loader, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from tpudist_torch.data.loader import ShardedLoader
from tpudist_torch.data.sharding import epoch_indices
from tpudist_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "native" / "gather.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_lock = threading.Lock()


def library_path() -> Path:
    """``build/tpudist_torch/libtpugather-<hash of source and flags>.so``."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtpugather-{h.hexdigest()[:16]}.so"


def _build_library() -> Optional[Path]:
    """Compile ``gather.cpp`` unless its library exists; ``None`` without a
    working ``g++``."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target so the final rename stays on one filesystem
    with tempfile.TemporaryDirectory(dir=out.parent) as td:
        tmp_out = Path(td) / out.name
        cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp_out)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp_out, out)  # atomic: concurrent builds are safe
        except (OSError, subprocess.SubprocessError):
            return None
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The process-wide gather library, built on first use; ``None`` when
    it cannot be built or loaded."""
    global _LIB, _LIB_TRIED
    with _lock:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        path = _build_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.tg_create.restype = ctypes.c_void_p
        lib.tg_create.argtypes = [ctypes.c_int]
        lib.tg_submit.restype = ctypes.c_int64
        lib.tg_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p]
        lib.tg_wait.restype = ctypes.c_int
        lib.tg_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tg_poll.restype = ctypes.c_int
        lib.tg_poll.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tg_destroy.restype = None
        lib.tg_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return load_library() is not None


class GatherPool:
    """Thin RAII wrapper over the C thread pool."""

    def __init__(self, num_workers: int):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native gather library unavailable (no g++?)")
        self._lib = lib
        self._handle = ctypes.c_void_p(lib.tg_create(num_workers))

    def submit(self, src: np.ndarray, idx: np.ndarray, dst: np.ndarray) -> int:
        """Enqueue ``dst[i] = src[idx[i]]``.  All arrays must be C-contiguous
        and stay alive (and ``dst`` unread) until :meth:`wait` returns."""
        if self._handle is None:
            raise RuntimeError("GatherPool is closed")
        if not (src.flags.c_contiguous and dst.flags.c_contiguous
                and idx.dtype == np.int64 and idx.flags.c_contiguous):
            raise ValueError("GatherPool.submit needs C-contiguous arrays "
                             "and int64 indices")
        row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                     dtype=np.int64))
        return self._lib.tg_submit(
            self._handle, src.ctypes.data_as(ctypes.c_void_p), row_bytes,
            idx.ctypes.data_as(ctypes.c_void_p), len(idx),
            dst.ctypes.data_as(ctypes.c_void_p))

    def wait(self, job: int) -> None:
        # after close() every worker has joined: nothing runs, and waiting
        # on a freed pool would be a use-after-free
        if self._handle is None:
            return
        self._lib.tg_wait(self._handle, job)

    def close(self) -> None:
        if self._handle:
            self._lib.tg_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - interpreter-shutdown best effort
        try:
            self.close()
        except Exception:
            pass


class PrefetchingLoader(ShardedLoader):
    """:class:`ShardedLoader` with native background batch assembly: the
    same ``(x, y)`` batches in the same order.  Assembly runs in a ring of
    ``prefetch_depth + 1`` reused buffers, so the batch being materialized
    is never concurrently written; the yielded arrays are copies of the
    ring slot (``torch.from_numpy`` of a slot would alias a buffer the pool
    later overwrites)."""

    def __init__(self, dataset, batch_size, plan, *, num_workers: int = 2,
                 prefetch_depth: int = 4):
        super().__init__(dataset, batch_size, plan)
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = max(1, prefetch_depth)
        self._pool = GatherPool(self.num_workers)
        self._fields: Sequence[np.ndarray] = [
            np.ascontiguousarray(dataset.x), np.ascontiguousarray(dataset.y)]
        # depth + 1 slots: batch i + depth (submitted while batch i is
        # yielded) lands in batch i - 1's slot, never batch i's
        self._slots = [
            tuple(np.empty((batch_size,) + f.shape[1:], f.dtype)
                  for f in self._fields)
            for _ in range(self.prefetch_depth + 1)]

    def iter_from(self, skip_batches: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx_all = epoch_indices(self.plan, self._epoch).astype(np.int64)
        starts = list(range(skip_batches * self.batch_size, len(idx_all),
                            self.batch_size))
        if self.plan.drop_last:
            starts = [s for s in starts
                      if s + self.batch_size <= len(idx_all)]
        inflight: list = []  # (jobs, idx slice, slot, rows), FIFO

        def submit(batch_i: int) -> None:
            start = starts[batch_i]
            sel = idx_all[start:start + self.batch_size]
            slot = self._slots[batch_i % (self.prefetch_depth + 1)]
            jobs = [self._pool.submit(f, sel, dst[:len(sel)])
                    for f, dst in zip(self._fields, slot)]
            inflight.append((jobs, sel, slot, len(sel)))

        try:
            for i in range(min(self.prefetch_depth, len(starts))):
                submit(i)
            for i in range(len(starts)):
                jobs, _sel, slot, n = inflight.pop(0)
                for j in jobs:
                    self._pool.wait(j)
                out = tuple(dst[:n].copy() for dst in slot)
                if i + self.prefetch_depth < len(starts):
                    submit(i + self.prefetch_depth)
                yield out
        finally:
            # abandoned mid-epoch: the workers hold raw pointers into
            # idx_all and the slots, so drain every job before they go
            for jobs, _sel, _slot, _n in inflight:
                for j in jobs:
                    self._pool.wait(j)

    def close(self) -> None:
        self._pool.close()
