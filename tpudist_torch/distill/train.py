"""The one draft-distillation code path — the counterpart of
:mod:`tpudist.distill.train`.

Two entries share the same objective (next-token cross entropy on the
target's own continuations — sequence-level distillation):

- :func:`distill_draft` — the offline form: GENERATE the target's greedy
  continuations of a prompt pool (:func:`~tpudist_torch.models.generate`),
  then fit a fresh draft of the tied geometry to them with plain Adam
  steps.
- :class:`DraftDistillModule` + :func:`pack_streams` — the online form:
  the capture ring already holds the continuations the target emitted in
  production, so the flywheel skips generation and drives the port's own
  :class:`~tpudist_torch.trainer.Trainer` on the packed streams,
  warm-started from the serving draft's current weights.

Padding contract: packed batches pad with ``-1``.  The model is fed the
tokens clamped to ``>= 0`` (a ``-1`` would index past the embedding) and
the loss masks every position whose TARGET is ``-1``
(:func:`~tpudist_torch.models.transformer.lm_loss_with_targets`), so pad
positions contribute exactly zero gradient; causal attention keeps them
out of every real position's output.

The Trainer trains a copy that owns its own f32 ``Parameter`` s (the
serving draft's weights loaded into it, :func:`draft_copy`): the serving
draft — a tied draft's weights are the target's own — is never written,
and the candidate comes back in the serving copy's names, shapes and
dtypes.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpudist_torch.models.transformer import (TransformerLM,
                                              create_transformer,
                                              lm_loss_with_targets)
from tpudist_torch.trainer.trainer import LMTrainerModule

#: the geometry a draft copy takes from the draft it copies
_GEOMETRY = ("vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_len",
             "rope", "n_kv_heads", "sliding_window", "n_experts", "dtype")


def pack_streams(streams, pad_to: Optional[int] = None,
                 pad_rows_to: Optional[int] = None) -> np.ndarray:
    """Pack captured streams into one ``[N, T]`` int32 matrix padded
    with ``-1`` — ONE shape per round.  ``pad_to`` forces the time dim
    (rounds with growing rings can pin a shape across rounds);
    ``pad_rows_to`` pads N with all-``-1`` rows (fully masked → zero
    loss) so the batch divides a data-parallel mesh."""
    if not streams:
        raise ValueError("pack_streams: no streams")
    T = max(len(s) for s in streams)
    if pad_to is not None:
        if pad_to < T:
            raise ValueError(f"pad_to={pad_to} < longest stream {T}")
        T = int(pad_to)
    N = len(streams)
    if pad_rows_to is not None and pad_rows_to > N:
        N = int(pad_rows_to)
    toks = np.full((N, T), -1, np.int32)
    for i, s in enumerate(streams):
        t = s.tokens if hasattr(s, "tokens") else np.asarray(s, np.int32)
        toks[i, :len(t)] = t
    return toks


def draft_copy(draft: TransformerLM, params: dict, *,
               param_dtype: Optional[torch.dtype] = None) -> TransformerLM:
    """A :class:`TransformerLM` of ``draft``'s geometry, on its device,
    owning its own parameters (in ``param_dtype``, default the draft's),
    loaded with ``params`` (a state dict of ``draft``'s names).  No
    ``moe_fn``: an MoE draft's FFN is the dense top-1 reference, as the
    JAX draft clones ``moe_fn=None``."""
    device = draft.tok_embed.device
    with torch.device(device):
        copy = TransformerLM(
            param_dtype=param_dtype or draft.param_dtype,
            **{k: getattr(draft, k) for k in _GEOMETRY})
    copy.load_state_dict(params)
    return copy


class _Clamped(nn.Module):
    """``lm(max(tokens, 0))`` over a training context whose MoE layers run
    the dense reference (the JAX apply shim over the ``moe_fn=None``
    draft)."""

    def __init__(self, lm: TransformerLM):
        super().__init__()
        self.lm = lm

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        ctx = self.lm.train_context()
        ctx.moe_routed = False
        return self.lm(tokens.clamp_min(0), ctx)


class DraftDistillModule(LMTrainerModule):
    """The :class:`~tpudist_torch.trainer.LMTrainerModule` the flywheel
    feeds to ``Trainer.fit``: a copy of the serving draft warm-started
    from ``draft_params`` (same geometry by construction — the swap-gate
    invariant), pad-aware forward and loss, Adam at ``lr`` (optax's
    defaults: eps 1e-8 after the square root, bias corrections on)."""

    def __init__(self, draft_model: TransformerLM, draft_params: dict,
                 lr: float = 3e-3):
        self._model = draft_model
        self._params = draft_params
        self._lr = float(lr)

    def configure_lm(self, generator: torch.Generator) -> nn.Module:
        # a copy with its own f32 masters: the Trainer writes to the module
        # it trains, and the serving draft's weights may be the target's
        return _Clamped(draft_copy(self._model, self._params,
                                   param_dtype=torch.float32)
                        .requires_grad_(True))

    def configure_optimizers(self):
        from tpudist_torch.train.optim import build_optimizer

        return functools.partial(build_optimizer, lr=self._lr)

    def loss(self, logits: torch.Tensor, tokens: torch.Tensor
             ) -> torch.Tensor:
        # next-token targets; pad (and the position BEFORE a pad run's
        # start) masked via the -1 convention
        return lm_loss_with_targets(logits[:, :-1], tokens[:, 1:])


def distill_streams(draft_model: TransformerLM, draft_params: dict,
                    streams, *, steps: int = 40, lr: float = 3e-3,
                    max_steps_cap: int = 1000) -> Tuple[dict, float]:
    """One distillation round through the port's Trainer: fit the draft
    (warm-started from ``draft_params``) to the captured streams and
    return ``(candidate, final_loss)``; ``candidate`` is a state dict with
    ``draft_params``' names, shapes and dtypes.  Runs on the draft's
    device (``strategy='dp'``: the rows padded to the process group's
    world size, a replicated draft)."""
    import torch.distributed as dist

    from tpudist_torch.trainer.trainer import Trainer

    steps = max(1, min(int(steps), max_steps_cap))
    world = dist.get_world_size() if dist.is_initialized() else 1
    toks = pack_streams(streams, pad_rows_to=-(-len(streams) // world)
                        * world)
    trainer = Trainer(max_steps=steps, strategy="dp", dry_run=True,
                      progress_bar=False, log_every=steps,
                      device=str(draft_model.tok_embed.device))
    losses = trainer.fit(DraftDistillModule(draft_model, draft_params, lr),
                         [toks])
    trained = trainer.final_states["lm"].model.lm
    cand = {name: t.detach().to(draft_params[name].dtype)
            for name, t in trained.state_dict().items()}
    return cand, (losses or {}).get("lm")


def distill_draft(model: TransformerLM, layers: int, prompt_pool,
                  steps: int, max_new: int, *, lr: float = 3e-3,
                  seed: int = 11):
    """Build a TRAINED draft the way production does: distill the
    target's own greedy continuations of the serving prompt pool into a
    shallow student of the tied geometry (``layers`` blocks, drawn from
    ``seed``; cross-entropy on next-token, the sequence-level
    distillation objective).  Returns ``(draft, its state dict,
    final_loss)``."""
    from tpudist_torch.models.generate import generate

    device = model.tok_embed.device
    geo = {k: getattr(model, k) for k in _GEOMETRY}
    geo["n_layers"] = int(layers)
    draft = create_transformer(seed, device=device,
                               param_dtype=torch.float32, trainable=True,
                               **geo)
    T = max(len(p) for p in prompt_pool) + max_new
    toks = np.zeros((len(prompt_pool), T), np.int32)
    tgts = np.full((len(prompt_pool), T - 1), -1, np.int32)
    for i, p in enumerate(prompt_pool):
        out = generate(model, torch.as_tensor(np.asarray(p, np.int32),
                                              device=device)[None],
                       max_new)[0].cpu().numpy()
        toks[i, :len(out)] = out
        tgts[i, :len(out) - 1] = out[1:]
    opt = torch.optim.Adam(draft.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    tt = torch.from_numpy(toks).to(device)
    tg = torch.from_numpy(tgts).to(device)
    loss = None
    for _ in range(max(1, steps)):
        opt.zero_grad(set_to_none=True)
        loss = lm_loss_with_targets(draft(tt[:, :-1]), tg)
        loss.backward()
        opt.step()
    draft.requires_grad_(False)
    return draft, draft.state_dict(), float(loss.detach())


def continuations_from_target(model: TransformerLM, prompt_pool,
                              max_new: int) -> List[np.ndarray]:
    """The target's greedy continuations of a prompt pool as plain
    ``[T_i]`` arrays (prompt + emitted) — the offline twin of what the
    capture ring collects from live traffic."""
    from tpudist_torch.models.generate import generate

    device = model.tok_embed.device
    return [generate(model, torch.as_tensor(np.asarray(p, np.int32),
                                            device=device)[None],
                     max_new)[0].cpu().numpy() for p in prompt_pool]
