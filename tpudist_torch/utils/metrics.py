"""W&B-compatible metrics logging with a first-class offline mode — a copy
of :mod:`tpudist.utils.metrics`.

Rank-0-only ``wandb.init(project=…, group=…)`` (``demo.py:76-78``),
per-iteration ``log(..., commit=)`` (``demo.py:119-121``), ``--dry_run`` →
``WANDB_MODE=dryrun`` (``demo.py:160-161``), and ``finish()`` before the
process group goes down (``demo.py:133-136``).  wandb is optional: without
it (or in dry-run mode) a JSONL logger with the same surface records to
``<log_dir>/<group>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Mapping, Optional

from tpudist_torch.runtime.bootstrap import process_index


class MetricsLogger:
    """Minimal wandb-Run-alike: ``log(metrics, commit=)`` + ``finish()``."""

    def __init__(self, run=None, jsonl_path: Optional[Path] = None):
        self._run = run  # a real wandb run, or None
        self._jsonl_path = jsonl_path
        self._jsonl_file = None
        self._pending: dict = {}
        self._step = 0
        if jsonl_path is not None:
            jsonl_path.parent.mkdir(parents=True, exist_ok=True)
            self._jsonl_file = open(jsonl_path, "a")

    def log(self, metrics: Mapping[str, float], commit: bool = True) -> None:
        self._pending.update(metrics)
        if not commit:
            return
        record, self._pending = self._pending, {}
        if self._run is not None:
            self._run.log(record)
        if self._jsonl_file is not None:
            record = {"_step": self._step, "_time": time.time(), **record}
            try:
                # Flush EVERY committed line: a kill between commits must
                # lose at most the line being written, never a window of
                # already-committed rows sitting in the userspace buffer.
                self._jsonl_file.write(json.dumps(record) + "\n")
                self._jsonl_file.flush()
            except (OSError, ValueError):
                # ValueError = file closed underneath (finish() raced a
                # straggling log call); metrics must not take the run
                # down — but the fd must not leak either.
                f, self._jsonl_file = self._jsonl_file, None
                try:
                    f.close()
                except (OSError, ValueError):
                    pass
        self._step += 1

    def finish(self) -> None:
        """Must run before ``runtime.shutdown()`` — same ordering discipline
        as ``wandb.finish()`` before ``destroy_process_group``
        (``demo.py:133-136``).  Idempotent, and safe to call (or to keep
        ``log``-ging) after the underlying file is gone: a double teardown
        path must never crash the run it is cleaning up.  The final fsync
        makes every committed row durable — a SIGKILL right after loses at
        most a trailing partial line."""
        if self._pending:
            self.log({}, commit=True)
        if self._run is not None:
            run, self._run = self._run, None
            try:
                run.finish()
            except Exception:  # noqa: BLE001 — wandb teardown is best-effort
                pass
        f, self._jsonl_file = self._jsonl_file, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
            except (OSError, ValueError):
                pass
            try:
                f.close()
            except OSError:
                pass


class _NullLogger(MetricsLogger):
    def __init__(self):
        super().__init__(run=None, jsonl_path=None)


def init_metrics(
    project: str = "tpudist",
    group: Optional[str] = None,
    *,
    dry_run: bool = False,
    log_dir: str = "runs",
    rank_zero_only: bool = True,
) -> MetricsLogger:
    """Create the job's metrics logger (rank 0 gets the real one; other ranks
    a no-op, mirroring ``if rank == 0: wandb.init`` at ``demo.py:76-78``)."""
    if rank_zero_only and process_index() != 0:
        return _NullLogger()
    if dry_run:
        os.environ["WANDB_MODE"] = "dryrun"  # demo.py:160-161
    use_wandb = not dry_run and os.environ.get("WANDB_MODE") not in ("dryrun", "offline", "disabled")
    run = None
    if use_wandb:
        try:
            import wandb

            run = wandb.init(
                project=project,
                group=group,
                settings=wandb.Settings(start_method="thread"),  # demo.py:78
            )
        except Exception:
            run = None  # no wandb / no credentials → JSONL fallback only
    jsonl = Path(log_dir) / f"{group or project}" / "metrics.jsonl"
    return MetricsLogger(run=run, jsonl_path=jsonl)
