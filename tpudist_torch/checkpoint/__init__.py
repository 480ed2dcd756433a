"""Checkpoint / resume — the counterpart of :mod:`tpudist.checkpoint`, in
a torch format of its own (:mod:`tpudist_torch.checkpoint.manager`): the
reference's directory contract (``<scratch_dir>/<exp_name>/checkpoints``,
``job_submitter.sh:157-159``), atomic files with retention, asynchronous
saves, and restore into the live modules on their own devices."""

from tpudist_torch.checkpoint.manager import (CheckpointConfig,
                                              CheckpointManager,
                                              CheckpointRestoreError,
                                              checkpoint_dir_for,
                                              resolve_checkpoint_location,
                                              setup_checkpointing)

__all__ = ["CheckpointConfig", "CheckpointManager", "CheckpointRestoreError",
           "checkpoint_dir_for", "resolve_checkpoint_location",
           "setup_checkpointing"]
