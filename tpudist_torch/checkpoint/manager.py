"""Checkpoint manager for the port's train states — the counterpart of
:mod:`tpudist.checkpoint.manager`, in a torch format of its own.

One checkpoint is one file, ``step_<N>.pt``, holding for each model its
module, optimizer and scheduler ``state_dict``s, and ``meta``: the loop's
``iteration`` and ``epoch`` and the run's base seed.  That is everything a
resume needs to continue the unbroken run bit for bit: the loader's order
is a pure function of ``(seed, epoch)`` (:mod:`tpudist_torch.data.sharding`)
and the toy step draws no random numbers, so no RNG state is saved.

- Rank 0 writes; the other ranks wait at a barrier.  The states hold the
  whole tensors — a replica under DDP, or the gathered state of a sharded
  layout (:mod:`tpudist_torch.parallel.zero`'s views, whose ``state_dict``
  every rank takes part in) — so a checkpoint written under one layout and
  world size loads under any other: the port's counterpart of the JAX
  manager's ``restore_resharded``.
- Writes are atomic: ``step_<N>.tmp``, flushed and synced, then
  ``os.replace``; :attr:`CheckpointManager.latest_step` counts finished
  files only, and retention keeps the last ``max_to_keep``.
- ``async_save`` snapshots the states to host memory on the caller's
  thread and writes on a worker thread; a second save waits for the first.
- :meth:`CheckpointManager.restore` loads into the live modules, each
  tensor onto its parameter's device, and with ``restore_fallback`` falls
  back to the newest earlier step that loads when the latest is corrupt.
- ``save(..., force=True)`` at a step already saved stamps its new meta
  (the preemption save's ``preempted``) as an atomic sidecar,
  ``meta_overlay_<N>.json``, that restore merges in, as JAX's does.
- Saves, restores and drains are the ``ckpt_save``, ``ckpt_restore`` and
  ``ckpt_wait`` telemetry spans, and a due ``ckpt_corrupt`` fault
  (:mod:`tpudist_torch.runtime.faults`) garbles a step after its write.

:class:`CheckpointConfig`, :func:`checkpoint_dir_for`,
:func:`resolve_checkpoint_location` and :func:`setup_checkpointing` are
copied from the JAX package (the last without its ``mesh``: the port
needs no resharding).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpudist_torch import telemetry
from tpudist_torch.comm.collectives import barrier, host_allreduce_sum
from tpudist_torch.runtime.bootstrap import process_index

_PREFIX, _SUFFIX = "step_", ".pt"


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    save_every: int = 1000          # sweeper.yml:26-31 --checkpoint_every
    max_to_keep: Optional[int] = 3
    async_save: bool = True
    # Transient save I/O errors (filesystem blips on network storage) are
    # retried this many times with a short backoff before surfacing.
    save_retries: int = 2
    save_retry_backoff_s: float = 0.5
    # restore(): fall back to the newest EARLIER valid step when the latest
    # is corrupt/incomplete (bounded by max_to_keep's retention window).
    restore_fallback: bool = True


class CheckpointRestoreError(RuntimeError):
    """Every retained checkpoint step failed to restore."""


def checkpoint_dir_for(
    scratch_dir: Optional[str] = None, exp_name: Optional[str] = None
) -> Path:
    """The reference's directory contract (``job_submitter.sh:157-159``):
    ``${scratch_dir}/[${project_name}/]${exp_name}/checkpoints``, with
    env-var fallbacks on the same names the launcher exports (SURVEY.md
    §5.6).  ``project_name`` (exported by ``launch/job_submitter.sh``)
    namespaces experiments from different checkouts; when unset the path
    matches the reference exactly."""
    scratch = scratch_dir or os.environ.get("scratch_dir", "scratch")
    exp = exp_name or os.environ.get("exp_name", "default_exp")
    project = os.environ.get("project_name")
    base = Path(scratch) / project if project else Path(scratch)
    return base / exp / "checkpoints"


def _to_host(obj):
    """A copy of ``obj`` (nested dicts, lists and tuples) whose tensors are
    fresh CPU tensors: the snapshot a later in-place step cannot touch."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_dicts(states) -> Dict[str, dict]:
    """``{name: {"model", "optimizer", "scheduler"}}`` state dicts of a
    ``Dict[str, ModelState]`` (the scheduler's ``None`` without one)."""
    return {name: {"model": st.model.state_dict(),
                   "optimizer": st.optimizer.state_dict(),
                   "scheduler": (st.scheduler.state_dict()
                                 if st.scheduler is not None else None)}
            for name, st in states.items()}


def load_state_dicts(states, saved: Dict[str, dict]) -> None:
    """Load :func:`state_dicts` output into the live ``states``, each
    tensor onto its parameter's device."""
    if set(saved) != set(states):
        raise ValueError(f"the checkpoint holds models {sorted(saved)}, "
                         f"the run {sorted(states)}")
    for name, st in states.items():
        st.model.load_state_dict(saved[name]["model"])
        st.optimizer.load_state_dict(saved[name]["optimizer"])
        if st.scheduler is not None:
            st.scheduler.load_state_dict(saved[name]["scheduler"])


class CheckpointManager:
    """Save/restore ``(states, meta)`` with retention and atomic files."""

    def __init__(self, config: CheckpointConfig, *,
                 seed: Optional[int] = None):
        self.config = config
        self.seed = seed
        self._dir = Path(config.directory).resolve()
        # every rank makes it (idempotent), none races rank 0's first write
        self._dir.mkdir(parents=True, exist_ok=True)
        # the steps saved by this run or found on disk: every rank decides
        # the same, so they meet at each save's barrier
        self._saved = set(self.all_steps())
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> Path:
        return self._dir / f"{_PREFIX}{step}{_SUFFIX}"

    def all_steps(self) -> List[int]:
        """The finished steps on disk, oldest first (``.tmp`` files of an
        unfinished write do not count)."""
        steps = []
        for p in self._dir.glob(f"{_PREFIX}*{_SUFFIX}"):
            try:
                steps.append(int(p.name[len(_PREFIX):-len(_SUFFIX)]))
            except ValueError:
                continue
        return sorted(steps)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ---------------------------------------------------------------

    def maybe_save(self, step: int, states: Any, meta: dict) -> bool:
        """Save if ``step`` is on the cadence; returns whether a save started."""
        if self.config.save_every <= 0 or step % self.config.save_every != 0:
            return False
        return self.save(step, states, meta)

    def save(self, step: int, states: Any, meta: dict,
             force: bool = False) -> bool:
        """Save ``states`` and ``meta`` (plus the seed) as ``step``; a step
        already saved is left as it is (a cadence save and the final save
        may collide), unless ``force``: then its new meta is stamped as a
        sidecar overlay once the step's write finished (non-destructive —
        the step's tensors are the same, and no window exists in which the
        step is gone).  Returns whether a save started."""
        with telemetry.span("ckpt_save", step=step,
                            blocking=not self.config.async_save):
            return self._save(step, states, meta, force)

    def _save(self, step: int, states: Any, meta: dict,
              force: bool) -> bool:
        if step in self._saved:
            if not force:
                return False
            if process_index() == 0:
                self._join_writer()  # stamp only a finished step
                self._write_meta_overlay(step, dict(meta, seed=self.seed))
            barrier("checkpoint_save")
            return True
        self._saved.add(step)
        # every rank: a sharded state's state_dict gathers its shards
        whole = state_dicts(states)
        if process_index() == 0:
            payload = {"states": _to_host(whole),
                       "meta": dict(meta, seed=self.seed)}
            self._join_writer()
            if self.config.async_save:
                self._writer = threading.Thread(
                    target=self._write_async, args=(step, payload),
                    name="tpudist-ckpt-writer", daemon=True)
                self._writer.start()
            else:
                self._write(step, payload)
            # chaos: a due ckpt_corrupt fault garbles this step once its
            # (possibly async) write finished; one None check when unarmed
            from tpudist_torch.runtime import faults

            faults.inject_ckpt_save(step, self._path(step),
                                    wait=self._join_writer)
        barrier("checkpoint_save")
        return True

    def _write_async(self, step: int, payload: dict) -> None:
        try:
            self._write(step, payload)
        except BaseException as e:  # noqa: BLE001 — re-raised by the caller
            self._error = e

    def _write(self, step: int, payload: dict) -> None:
        """Write ``step`` atomically, retrying transient I/O errors, then
        retire the steps past ``max_to_keep``."""
        path = self._path(step)
        tmp = path.with_suffix(".tmp")
        for attempt in range(self.config.save_retries + 1):
            try:
                with open(tmp, "wb") as f:
                    torch.save(payload, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                break
            except OSError as e:
                if attempt == self.config.save_retries:
                    raise
                print(f"[tpudist_torch.checkpoint] save(step={step}) "
                      f"attempt {attempt + 1} failed: {e}; retrying",
                      file=sys.stderr, flush=True)
                time.sleep(self.config.save_retry_backoff_s * 2 ** attempt)
        keep = self.config.max_to_keep
        if keep is not None:
            for old in self.all_steps()[:-keep]:
                self._path(old).unlink(missing_ok=True)
                self._overlay_path(old).unlink(missing_ok=True)

    def _overlay_path(self, step: int) -> Path:
        return self._dir / f"meta_overlay_{step}.json"

    def _write_meta_overlay(self, step: int, meta: dict) -> None:
        """Atomic (tmp + rename on the same filesystem) sidecar write."""
        import json

        tmp = self._overlay_path(step).with_suffix(".json.tmp")
        tmp.write_text(json.dumps(meta))
        os.replace(tmp, self._overlay_path(step))

    def _read_meta_overlay(self, step: int) -> dict:
        import json

        p = self._overlay_path(step)
        if not p.exists():
            return {}
        try:
            return dict(json.loads(p.read_text()))
        except (ValueError, OSError):
            return {}  # torn write of the stamp: fall back to base meta

    def _join_writer(self) -> None:
        """Wait for the write in flight; raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait_until_finished(self) -> None:
        """Drain the write in flight (rank 0), then meet at a barrier: on
        return every step saved so far is on disk.  Recorded as
        ``ckpt_wait`` so the goodput report attributes the background
        write's blocking tail."""
        with telemetry.span("ckpt_wait"):
            if process_index() == 0:
                self._join_writer()
            barrier("checkpoint_written")

    def close(self) -> None:
        self.wait_until_finished()

    # -- restore ------------------------------------------------------------

    def _load(self, step: int) -> dict:
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        # force-save stamps win
        payload["meta"] = {**payload["meta"],
                           **self._read_meta_overlay(step)}
        return payload

    def restore(self, states: Any, step: Optional[int] = None) -> dict:
        """Load ``step`` (default: the latest) into the live ``states`` and
        return its meta.

        With no explicit ``step`` and ``restore_fallback``, a latest step
        that does not load (a torn file, bit rot) is skipped for the newest
        earlier one that does; every rank tries each candidate and they
        agree over the host group before any of them loads it.  Raises
        :class:`CheckpointRestoreError` when none loads,
        ``FileNotFoundError`` when there is no checkpoint."""
        explicit = step is not None
        steps = self.all_steps()
        if step is None:
            step = steps[-1] if steps else None
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.config.directory}")
        with telemetry.span("ckpt_restore", step=step):
            return self._restore(states, step, steps, explicit)

    def _restore(self, states, step, steps, explicit) -> dict:
        if explicit or not self.config.restore_fallback:
            payload = self._load(step)
            load_state_dicts(states, payload["states"])
            return dict(payload["meta"])
        candidates = sorted((s for s in steps if s <= step), reverse=True)
        failures = []
        for s in candidates:
            try:
                payload, err = self._load(s), None
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — corruption surfaces as
                # whatever the zip reader or unpickler noticed first
                payload, err = None, e
            if float(host_allreduce_sum(np.float64(err is not None))) == 0:
                load_state_dicts(states, payload["states"])
                if failures:
                    print(f"[tpudist_torch.checkpoint] degraded restore: "
                          f"step {s} used instead of corrupt step(s) "
                          f"{[f for f, _ in failures]}", file=sys.stderr,
                          flush=True)
                return dict(payload["meta"])
            print(f"[tpudist_torch.checkpoint] restore(step={s}) failed: "
                  f"{type(err).__name__ if err else 'on another rank'}: "
                  f"{err or ''}", file=sys.stderr, flush=True)
            failures.append((s, err))
        raise CheckpointRestoreError(
            f"all retained checkpoint steps failed to restore under "
            f"{self.config.directory}: {[s for s, _ in failures]}"
        ) from failures[-1][1]


def resolve_checkpoint_location(
    directory: Optional[str], *, save_every: int = 0, resume: bool = False
) -> Optional[str]:
    """Resolve where checkpoints live: explicit ``directory`` wins, else the
    launcher's env contract (``scratch_dir``/``exp_name`` exported by
    ``launch/job_submitter.sh``) when checkpointing was requested.  Returns
    ``None`` when checkpointing is off; raises ``ValueError`` when resume is
    requested with no resolvable location.  The single source of truth for
    both the plain demos and the Trainer facade."""
    if directory is not None:
        return directory
    if (save_every > 0 or resume) and (
        "scratch_dir" in os.environ or "exp_name" in os.environ
    ):
        return str(checkpoint_dir_for())
    if resume:
        raise ValueError(
            "resume needs a checkpoint location: pass --checkpoint_dir / "
            "checkpoint_dir or export scratch_dir/exp_name (launcher "
            "contract)"
        )
    return None


def setup_checkpointing(
    states: Any, directory: str, *, save_every: int = 0, resume: bool = False,
    seed: Optional[int] = None,
) -> Tuple[CheckpointManager, Any, int]:
    """Build the manager over a resolved ``directory``; on resume, restore
    the latest step into ``states``.  Returns ``(manager, states,
    start_iteration)``.

    ``seed`` is the run's base seed, saved with every step; a resume under
    another seed raises, since the data order it would continue is not the
    saved run's."""
    mgr = CheckpointManager(
        CheckpointConfig(directory=directory, save_every=save_every),
        seed=seed)
    start = 0
    if resume and mgr.latest_step is not None:
        meta = mgr.restore(states)
        saved = meta.get("seed")
        if seed is not None and saved is not None and saved != seed:
            raise ValueError(
                f"the checkpoint under {directory} was written with seed "
                f"{saved}, this run has seed {seed}: the loader's order is "
                f"a function of the seed, so resume with --seed {saved}")
        start = int(meta.get("iteration", 0))
    return mgr, states, start
