"""Build and load the port's CUDA kernels: nvcc → shared library → ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/tpudist_torch/<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source, every ``csrc/*.cuh`` header and the compiler
flags — an edited kernel can never load a stale library.  The sources have a
plain C interface (no PyTorch headers), so a build takes seconds; the
wrapper passes every pointer and the CUDA stream as ``c_void_p``.

Kernels are built at first use (:func:`load`) or all at once, one ``nvcc``
process per source started together (:func:`build`).  ``--use_fast_math`` is
deliberately absent: the int8 requantization and the temperature scale need
IEEE division and round-half-to-even to match the plain versions bit for bit,
and the flash kernels' exp/log and softmax divisions follow JAX's f32 math.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpudist_torch"
KERNELS = ("paged_attention", "paged_prefill", "fused_sample",
           "flash_attention", "flash_backward", "fused_rope_qkv",
           "lora_delta", "fused_mlp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s, or
    the one on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "tpudist_torch build from source on the machine with the GPU")
    return found


def source_hash(name: str) -> str:
    """Content hash of one kernel's build inputs (source, headers, flags)."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(name)}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns ``name → seconds``
    until that source's ``nvcc`` exited (0.0 for a library already built);
    raises with the compiler's output if any build fails.  The compiler's
    log (``-Xptxas -v``: registers, shared memory, spills) lands beside
    each library as ``<name>-<hash>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    missing = [n for n in names if not library_path(n).is_file()]
    out = {n: 0.0 for n in names if n not in missing}
    nvcc = nvcc_path() if missing else ""
    procs = {}
    for name in missing:
        lib = library_path(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        with open(lib.with_suffix(".log"), "w") as log:
            procs[name] = (subprocess.Popen(nvcc_command(nvcc, name, tmp),
                                            stdout=log,
                                            stderr=subprocess.STDOUT),
                           time.perf_counter(), tmp, lib)
    failed = []
    while procs:  # each source's seconds until its own nvcc exits
        for name, (proc, t0, tmp, lib) in list(procs.items()):
            if proc.poll() is None:
                continue
            out[name] = time.perf_counter() - t0
            del procs[name]
            if proc.returncode != 0:
                failed.append((name,
                               lib.with_suffix(".log").read_text()[-4000:]))
                continue
            os.replace(tmp, lib)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name} ---\n{text}" for name, text in failed))
    return out


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing);
    ``declare`` sets the ``argtypes``/``restype`` of its entry points once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.tpd_error_string.argtypes = [ctypes.c_int]
            lib.tpd_error_string.restype = ctypes.c_char_p
            declare(lib)
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.tpd_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc} ({msg})")


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> Optional[ctypes.c_void_p]:
    """A tensor's device pointer for ctypes (``None`` passes NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def dtype_code(dtype) -> int:
    """The C side's dtype enum (``paged_common.cuh``: kF32, kBF16, kI8;
    ``flash_common.cuh`` uses the same kF32 and kBF16)."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    if dtype not in codes:
        raise TypeError(f"unsupported dtype {dtype} (float32, bfloat16, int8)")
    return codes[dtype]
