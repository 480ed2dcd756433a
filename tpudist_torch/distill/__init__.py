"""Online draft distillation (the serving↔training flywheel) — the
counterpart of :mod:`tpudist.distill`.

Three pieces wired end to end: :mod:`capture` taps finished-request
streams off the serving loop into a bounded ring, :mod:`loop` drives
the port's own Trainer on that ring in a background thread, and
:mod:`swap` gates the resulting candidate on a held-out slice before
the server lands it between decode blocks as a same-shape weight update
(no slot program rebuilt; speculation's correctness never depended on the
draft).  A tied draft's first swap unties it: the draft gets parameters of
its own, the target's stay as they were.

:mod:`~tpudist_torch.distill.capture` is numpy and the standard
library; the trainer and scorer halves run the port's kernels on the
draft's device.
"""

from tpudist_torch.distill.capture import CaptureBuffer, CapturedStream
from tpudist_torch.distill.loop import DistillLoop
from tpudist_torch.distill.swap import gate_swap, score_holdout
from tpudist_torch.distill.train import (
    DraftDistillModule,
    continuations_from_target,
    distill_draft,
    distill_streams,
    pack_streams,
)

__all__ = [
    "CaptureBuffer",
    "CapturedStream",
    "DistillLoop",
    "DraftDistillModule",
    "continuations_from_target",
    "distill_draft",
    "distill_streams",
    "gate_swap",
    "pack_streams",
    "score_holdout",
]
