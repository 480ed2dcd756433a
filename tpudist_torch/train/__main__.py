"""Single-device LM training: ``python -m tpudist_torch.train``.

The single-seq-shard counterpart of ``examples/demo_long_context.py``: a
decoder-only TransformerLM (f32 master weights; ``--precision bf16``
computes in bf16 with f32 LayerNorm, softmax and loss) trained with Adam on
the synthetic increment-chain task (x[t+1] = (x[t] + 1) % vocab from a
random start) or on a tokenized corpus (``--data_path``).  On CUDA the
attention forward and backward run through the hand-written flash kernels.
Prints the loss every ``--log_every`` iterations and ``final lm loss: ...``
at the end.

The GPU path is the default (``--device cuda``, which raises without CUDA);
``--device cpu`` runs the plain PyTorch path, e.g. a tiny smoke run::

  python -m tpudist_torch.train --device cpu --seq_len 64 --d_model 64 \\
      --n_layers 2 --n_heads 4 --d_ff 128 --total_iterations 20

The d1024 geometry the smoke test trains on one H100::

  python -m tpudist_torch.train --seq_len 2048 --d_model 1024 --n_layers 8 \\
      --n_heads 8 --d_ff 4096 --vocab 256 --batch_size 8 --precision bf16 \\
      --total_iterations 30
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpudist_torch.models import create_transformer, resolve_device
from tpudist_torch.train.lm import make_lm_train_step
from tpudist_torch.train.optim import OPTIMIZERS, SCHEDULES, build_optimizer

# options of the JAX entry point that need parts not ported yet, with the
# ROADMAP item that ports each
_NOT_PORTED = {
    "seq_shards": "ROADMAP queue A, item 6c (parallel/: ring attention)",
    "moe_experts": "ROADMAP queue A, item 6c (parallel/: MoE)",
    "fsdp": "ROADMAP queue A, item 6c (parallel/: FSDP)",
    "zigzag": "ROADMAP queue A, item 6c (parallel/: zigzag ring)",
    "remat": "ROADMAP queue A, item 6a (remat)",
    "generate": "ROADMAP queue A, item 6b (generate after training)",
}


def get_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without CUDA) or cpu "
                        "(the plain PyTorch path)")
    p.add_argument("--seq_len", default=512, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--vocab", default=64, type=int)
    p.add_argument("--d_model", default=128, type=int)
    p.add_argument("--n_layers", default=2, type=int)
    p.add_argument("--n_heads", default=4, type=int)
    p.add_argument("--d_ff", default=512, type=int)
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                   help="bf16 = f32 master weights, bf16 compute")
    p.add_argument("--rope", action="store_true",
                   help="rotary positions instead of the learned table")
    p.add_argument("--n_kv_heads", default=None, type=int,
                   help="grouped-query attention: K/V heads (default: "
                        "= heads)")
    p.add_argument("--sliding_window", default=None, type=int,
                   help="attend the previous N positions only")
    p.add_argument("--accum_steps", default=1, type=int,
                   help="gradient-accumulation microbatches per update")
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--lr_schedule", choices=list(SCHEDULES),
                   default="constant")
    p.add_argument("--warmup_steps", default=0, type=int)
    p.add_argument("--total_iterations", default=300, type=int)
    p.add_argument("--optimizer", choices=list(OPTIMIZERS), default="adam")
    p.add_argument("--grad_clip", default=0.0, type=float,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--weight_decay", default=0.0, type=float,
                   help="decoupled decay on weight matrices (adam → adamw)")
    p.add_argument("--data_path", default=None,
                   help="tokenized corpus (.npy or raw binary token stream); "
                        "default: the synthetic increment-chain task")
    p.add_argument("--data_dtype", default=None,
                   help="raw-binary token dtype (default uint16)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--log_every", default=1, type=int)
    p.add_argument("--seq_shards", default=1, type=int)
    p.add_argument("--moe_experts", default=0, type=int)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--zigzag", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--generate", default=0, type=int)
    args = p.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        value = getattr(args, flag)
        if value and not (flag == "seq_shards" and value == 1):
            raise NotImplementedError(f"--{flag} is not ported yet: {item}")
    return args


def make_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Increment-chain tokens: fully predictable after the first position."""
    start = rng.integers(0, vocab, size=(batch, 1))
    ramp = np.arange(seq, dtype=np.int64)[None, :]
    return ((start + ramp) % vocab).astype(np.int32)


def build_training(args: argparse.Namespace):
    """``(model, step, next_batch)`` for ``args``: the trainable model on
    ``args.device``, the train step over its optimizer, and a function
    returning the next ``[batch, seq_len]`` int32 token batch (numpy)."""
    device = resolve_device(args.device)
    model = create_transformer(
        args.seed, device=device, trainable=True,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        param_dtype=torch.float32, vocab=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        max_len=args.seq_len, rope=args.rope, n_kv_heads=args.n_kv_heads,
        sliding_window=args.sliding_window)
    opt, sched = build_optimizer(
        model.parameters(), args.lr, optimizer=args.optimizer,
        schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
        total_steps=args.total_iterations, grad_clip=args.grad_clip,
        weight_decay=args.weight_decay)
    step = make_lm_train_step(model, opt, scheduler=sched,
                              accum_steps=args.accum_steps)
    if args.data_path is not None:
        from tpudist_torch.data import make_lm_loader

        windows, corpus, _ = make_lm_loader(
            args.data_path, seq_len=args.seq_len,
            batch_size=args.batch_size, dtype=args.data_dtype,
            seed=args.seed)
        max_tok = int(np.max(windows.tokens))
        if max_tok >= args.vocab:
            raise SystemExit(f"--data_path holds token id {max_tok} but "
                             f"--vocab is {args.vocab}")
        return model, step, lambda: next(corpus)
    rng = np.random.default_rng(args.seed)
    return model, step, lambda: make_batch(rng, args.batch_size,
                                           args.seq_len, args.vocab)


def main(argv=None) -> float:
    args = get_args(argv)
    model, step, next_batch = build_training(args)
    device = next(model.parameters()).device
    loss = None
    t0 = time.perf_counter()
    for it in range(args.total_iterations):
        tokens = torch.from_numpy(next_batch()).to(device)
        loss = step(tokens)
        if it % args.log_every == 0:
            print(f"iteration {it}: loss/lm {float(loss):.4f}", flush=True)
    final = float(loss) if loss is not None else float("nan")
    print(f"{args.total_iterations} iterations in "
          f"{time.perf_counter() - t0:.2f} s on {device}")
    print(f"final lm loss: {final:.4f}")
    return final


if __name__ == "__main__":
    main(sys.argv[1:])
