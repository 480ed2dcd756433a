"""Crash-record decorator — a copy of :mod:`tpudist.utils.record`, parity
with ``torch.distributed.elastic``'s ``@record`` (``demo.py:14,156``):
worker tracebacks are captured to a per-rank error file so a launcher can
surface the first failure instead of a wall of interleaved stderr.

The file path comes from ``TPUDIST_ERROR_FILE`` (set by the launcher;
``%r`` is replaced by the process id) and defaults to
``tpudist_error_<pid>.json`` in the temporary directory (``$TMPDIR``).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile
import time
import traceback
from typing import Callable


def error_file_path(process_id: int) -> str:
    template = os.environ.get(
        "TPUDIST_ERROR_FILE",
        os.path.join(tempfile.gettempdir(), "tpudist_error_%r.json"))
    return template.replace("%r", str(process_id))


def _resolve_process_id() -> int:
    from tpudist_torch.utils.envutil import env_rank

    return env_rank(0)


def write_error_record(payload: dict, process_id: "int | None" = None) -> "str | None":
    """Write a crash record atomically (tmp + ``os.replace``, same pattern
    as the checkpoint manager's meta overlays) and return its path.

    Atomicity matters: the record is written while the process is dying,
    and a SIGKILL landing mid-``json.dump`` of a plain ``open(...,"w")``
    would leave a torn file that a launcher cannot read.
    Identity fields (process_id/pid/timestamp/argv) are filled in; the
    caller's ``payload`` wins on collision.  Returns ``None`` when the
    record could not be written (never raises — the original failure must
    still propagate).
    """
    if process_id is None:
        process_id = _resolve_process_id()
    full = {
        "process_id": process_id,
        "pid": os.getpid(),
        "timestamp": time.time(),
        "argv": sys.argv,
    }
    full.update(payload)
    path = error_file_path(process_id)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(full, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def record(fn: Callable) -> Callable:
    """Decorate an entry point ``main``; on exception, write a structured
    error record and re-raise."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — we re-raise
            write_error_record({
                "exc_type": type(e).__name__,
                "message": str(e),
                "traceback": traceback.format_exc(),
            })
            raise

    return wrapper
