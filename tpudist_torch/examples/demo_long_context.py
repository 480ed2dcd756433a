"""Long-context LM training over a ``(data × seq)`` mesh — the counterpart
of ``examples/demo_long_context.py``.

A decoder-only TransformerLM (f32 master weights; ``--precision bf16``
computes in bf16 with f32 LayerNorm, softmax and loss) trained
data-parallel over the process group: each rank holds a replica under DDP
(NCCL on the card, gloo on the CPU), steps on its share of the batch, and
the logged loss is the global mean.  On CUDA the attention forward and
backward run through the hand-written flash kernels.

``--seq_shards N`` shards the sequence over a ring of ``N`` places (ring
attention, :mod:`tpudist_torch.parallel`): across ``N`` ranks of each
data row when the process group has several ranks (``data`` = world /
``N``), or folded onto the one device of a one-process job (the
:class:`~tpudist_torch.parallel.LocalRing`: the same launches in the same
order, not seq-parallel memory).  ``--zigzag`` lays the tokens out in the
causal-balanced zigzag order, ``--inner_block`` sub-blocks the plain ring
body's KV, and ``--sliding_window`` lives inside the ring (the model's own
window is off, and comes back for ``--generate``), as in the JAX demo.

Two batch contracts, as the JAX demo's:

- the synthetic increment-chain task (x[t+1] = (x[t] + 1) % vocab from a
  random start): ``--batch_size`` is the global batch, drawn whole on every
  rank from the shared seed, each rank taking its contiguous rows;
- a tokenized corpus (``--data_path``): ``--batch_size`` is per data row,
  each row reading its own shard of the windows (``--dataloader``; the
  ranks of one ring read the same rows), assembled on the native gather
  pool with ``--num_workers > 0``; ``--eval_fraction`` holds out the corpus
  tail, evaluated every ``--eval_every`` iterations on up to 4 fixed
  batches, the same on every rank.

Each rank takes its seq slice of its data row's batch, the zigzag
permutation applied first, with the next-token targets built in temporal
order (:class:`~tpudist_torch.parallel.SeqLayout`).

Batches reach the device through :func:`tpudist_torch.data.
prefetch_to_device`.  ``--remat`` (with ``--remat_policy``) recomputes each
block in the backward; ``--generate N`` decodes N tokens after training
from an 8-token prompt through the dense KV cache (greedy, or sampled with
``--gen_temperature``/``--gen_top_k``/``--gen_top_p``).  Metrics go to
``runs/<group>/metrics.jsonl`` (``loss/lm``, ``loss/eval``).  ``--fsdp``
shards the parameters and the optimizer state over the ``data`` axis
(ZeRO-3, :func:`tpudist_torch.parallel.fsdp_sharding`, carried out by
:mod:`tpudist_torch.parallel.zero`: each block's shards gathered for its
forward and again for its backward, the gradients reduce-scattered), with
the JAX demo's ``fsdp: X MiB state/chip`` line; it composes with the ring,
``--accum_steps``, ``--remat``, eval and ``--generate`` (which decodes
from the gathered weights).  ``--moe_experts E`` replaces every block's
dense FFN with a routed MoE of ``E`` experts (:func:`tpudist_torch.
parallel.make_moe`, top ``--moe_topk``), one expert a place of a ``model``
axis of ``E`` devices a rank (folded onto the card where the host has
fewer), its routing statistics logged as ``moe/dropped_fraction``,
``moe/load_max`` and ``moe/balance_loss`` and ``--moe_balance`` times its
balance loss added to the trained loss; it composes with dp, not with
``--seq_shards``, as in the JAX demo.
``--n_heads`` and ``--d_ff`` set the geometry the JAX demo leaves at the
model's defaults (4 heads, d_ff 512).

One process on the CPU::

  python -m tpudist_torch.examples.demo_long_context --device cpu \\
      --dry_run --seq_len 64 --d_model 64 --total_iterations 20

Two ranks over gloo (one command per rank, ``RANK`` 0 and 1)::

  RANK=0 WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=29500 \\
      python -m tpudist_torch.examples.demo_long_context --device cpu \\
      --dry_run --seq_len 64 --d_model 64 --total_iterations 20

Four seq shards on the CPU (one process: a LocalRing; or four ranks over
gloo, ``WORLD_SIZE=4``, one ring)::

  python -m tpudist_torch.examples.demo_long_context --device cpu \\
      --dry_run --seq_len 64 --d_model 64 --seq_shards 4 --zigzag

The d1024 geometry on one card under the torchrun contract::

  RANK=0 WORLD_SIZE=1 MASTER_ADDR=localhost MASTER_PORT=29500 \\
      python -m tpudist_torch.examples.demo_long_context --dry_run \\
      --seq_len 2048 --d_model 1024 --n_layers 8 --n_heads 8 --d_ff 4096 \\
      --vocab 256 --batch_size 8 --precision bf16 --total_iterations 30
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpudist_torch.config import build_parser
from tpudist_torch.config import get_args as parse_args
from tpudist_torch.data.prefetch import prefetch_to_device
from tpudist_torch.models.transformer import (RingCausal,
                                              create_transformer, lm_loss,
                                              resolve_device)
from tpudist_torch.runtime import (describe_runtime, initialize,
                                   process_count, rank_print,
                                   resolve_shared_seed, shutdown)
from tpudist_torch.runtime.mesh import (MeshConfig, data_parallel_mesh,
                                        make_mesh, model_devices)
from tpudist_torch.train.lm import make_lm_eval_step, make_lm_train_step
from tpudist_torch.train.optim import build_optimizer_from_args
from tpudist_torch.utils import init_metrics, trace
from tpudist_torch.utils.record import record

def get_args(argv=None):
    """The JAX demo's flags on the shared parser, plus ``--n_heads`` and
    ``--d_ff``."""
    p = build_parser()
    p.add_argument("--seq_len", default=512, type=int)
    p.add_argument("--seq_shards", default=1, type=int,
                   help="size of the seq mesh axis (ring length)")
    p.add_argument("--inner_block", default=None, type=int,
                   help="sub-block the ring's per-shard KV consumption")
    p.add_argument("--vocab", default=64, type=int)
    p.add_argument("--d_model", default=128, type=int)
    p.add_argument("--n_layers", default=2, type=int)
    p.add_argument("--n_heads", default=4, type=int)
    p.add_argument("--d_ff", default=512, type=int)
    p.add_argument("--moe_experts", default=0, type=int,
                   help="replace the dense FFN with a routed MoE of this "
                        "many experts, expert-parallel over a model axis of "
                        "the same size (requires --seq_shards 1)")
    p.add_argument("--moe_topk", default=1, type=int,
                   help="experts per token (1 = Switch raw gate, >1 = "
                        "Mixtral-style renormalized gates)")
    p.add_argument("--moe_balance", default=0.0, type=float,
                   help="weight of the Switch/GShard load-balancing aux "
                        "loss added to the LM loss (e.g. 0.01)")
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32",
                   help="bf16 = f32 master weights, bf16 compute")
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded params + optimizer state (ZeRO-3 "
                        "over the data axis)")
    p.add_argument("--zigzag", action="store_true",
                   help="causal-balanced zigzag ring layout (requires "
                        "--seq_shards > 1; excludes --sliding_window/"
                        "--rope/--inner_block)")
    p.add_argument("--sliding_window", default=None, type=int,
                   help="local attention: attend the previous N positions "
                        "only")
    p.add_argument("--rope", action="store_true",
                   help="rotary position encoding instead of the learned "
                        "position table")
    p.add_argument("--n_kv_heads", default=None, type=int,
                   help="grouped-query attention: K/V heads (default: "
                        "= heads)")
    p.add_argument("--accum_steps", default=1, type=int,
                   help="gradient-accumulation microbatches per update")
    p.add_argument("--remat", action="store_true",
                   help="recompute each transformer block in the backward")
    p.add_argument("--remat_policy", default="nothing",
                   choices=["nothing", "dots", "dots_no_batch"],
                   help="what the remat'd backward may keep: 'dots' saves "
                        "the matmul outputs, 'dots_no_batch' the 2-D ones")
    p.add_argument("--gen_temperature", default=0.0, type=float,
                   help="sampling temperature for --generate (0 = greedy)")
    p.add_argument("--gen_top_k", default=None, type=int,
                   help="top-k filter for --generate sampling")
    p.add_argument("--gen_top_p", default=None, type=float,
                   help="nucleus top-p filter for --generate sampling")
    p.add_argument("--generate", default=0, type=int,
                   help="after training, decode this many tokens from a "
                        "prompt through the KV cache and print them")
    p.add_argument("--data_path", default=None, type=str,
                   help="tokenized corpus (.npy or raw binary token "
                        "stream); default: the synthetic increment-chain "
                        "task")
    p.add_argument("--data_dtype", default=None, type=str,
                   help="raw-binary token dtype (default uint16; .npy "
                        "files carry their own)")
    p.add_argument("--eval_fraction", default=0.0, type=float,
                   help="hold out this tail fraction of --data_path "
                        "windows for evaluation")
    p.add_argument("--eval_every", default=50, type=int,
                   help="evaluate the held-out set every N iterations")
    p.set_defaults(batch_size=8, total_iterations=300, lr=3e-4)
    return parse_args(argv, parser=p)


def make_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int):
    """Increment-chain tokens: fully predictable after the first position."""
    start = rng.integers(0, vocab, size=(batch, 1))
    ramp = np.arange(seq, dtype=np.int64)[None, :]
    return ((start + ramp) % vocab).astype(np.int32)


def build_model(args, device) -> torch.nn.Module:
    """The trainable TransformerLM of ``args`` on ``device``, its weights
    drawn from ``args.seed`` (every rank draws the same), with
    ``--moe_experts`` MoE FFNs (their ``moe_fn`` set by the caller).  On
    the ring (``--seq_shards > 1``) the model's own window is off: the ring
    holds it."""
    return create_transformer(
        args.seed, device=device, trainable=True,
        dtype=torch.bfloat16 if args.precision == "bf16" else torch.float32,
        param_dtype=torch.float32, vocab=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        max_len=args.seq_len, rope=args.rope, n_kv_heads=args.n_kv_heads,
        sliding_window=None if args.seq_shards > 1 else args.sliding_window,
        remat=args.remat,
        remat_policy=args.remat_policy, n_experts=args.moe_experts)


def moe_parts(args, mesh):
    """``--moe_experts``: the expert-parallel layer over ``mesh``'s
    ``model`` axis (top ``--moe_topk``, statistics averaged over ``data``)
    for the model's ``moe_fn``, ``None`` without MoE."""
    if args.moe_experts == 0:
        return None
    from tpudist_torch.models.transformer import moe_expert_fn
    from tpudist_torch.parallel import make_moe

    return make_moe(mesh, moe_expert_fn, batch_axis="data",
                    k=args.moe_topk)


def moe_rows(aux: dict) -> dict:
    """The JAX demo's ``moe/*`` metric rows of a step's ``aux``."""
    if "moe_dropped_fraction" not in aux:
        return {}
    return {"moe/dropped_fraction": float(aux["moe_dropped_fraction"]),
            "moe/load_max": float(aux["moe_expert_load"].max()),
            "moe/balance_loss": float(aux["moe_balance_loss"])}


def open_corpus(args, *, num_shards: int = 1, shard_id: int = 0):
    """``(windows, train stream, eval indices)`` of ``--data_path`` for this
    rank's shard; raises ``SystemExit`` when the corpus holds a token id
    past ``--vocab``."""
    from tpudist_torch.data import make_lm_loader

    windows, corpus, eval_idx = make_lm_loader(
        args.data_path, seq_len=args.seq_len, batch_size=args.batch_size,
        dtype=args.data_dtype, num_shards=num_shards, shard_id=shard_id,
        seed=args.seed, mode=args.dataloader,
        eval_fraction=args.eval_fraction, num_workers=args.num_workers)
    max_tok = int(np.max(windows.tokens))
    if max_tok >= args.vocab:
        if hasattr(corpus, "close"):
            corpus.close()
        raise SystemExit(
            f"--data_path holds token id {max_tok} but --vocab is "
            f"{args.vocab}: raise --vocab (embedding gathers clamp "
            "silently)")
    return windows, corpus, eval_idx


def seq_parts(args, ring):
    """``(ctx, loss_fn, place)`` of the step over ``ring`` (``None``: one
    sequence shard): the model's ring attention context (the zigzag ring
    under ``--zigzag``, else the causal ring with ``--inner_block`` and
    ``--sliding_window``), the loss, and the function that cuts a row
    batch into this process's ``(tokens, targets)``
    (:class:`~tpudist_torch.parallel.SeqLayout`); without a ring the
    model's own attention, ``lm_loss`` and the batch as it is."""
    if ring is None:
        return None, lm_loss, lambda batch: batch
    from tpudist_torch.parallel import (SeqLayout, make_ring_attention,
                                        make_zigzag_ring_attention)

    if args.zigzag:
        attention = make_zigzag_ring_attention(ring)
    else:
        attention = make_ring_attention(ring, causal=True,
                                        inner_block=args.inner_block,
                                        window=args.sliding_window)
    layout = SeqLayout(ring, args.seq_len, zigzag=args.zigzag)
    return (RingCausal(args.rope, attention, layout.positions), layout.loss,
            layout.place)


def fsdp_layout(args, mesh, model, opt):
    """``--fsdp``: the ZeRO-3 layout of the model and its optimizer over
    the mesh's ``data`` axis (``None`` without the flag), and the JAX
    demo's line of its bytes a device."""
    if not args.fsdp:
        return None
    from tpudist_torch.parallel import fsdp_sharding, state_bytes_per_device

    layout = fsdp_sharding(mesh, model, opt)
    rank_print(f"fsdp: {state_bytes_per_device(layout) / 2**20:.1f} MiB "
               "state/chip (ZeRO-3 layout)")
    return layout


def build_training(args):
    """``(model, step, next_batch)`` for ``args`` in one process: the
    trainable model on ``args.device`` (its experts' places folded onto
    it), the train step over its optimizer (returning ``(loss, aux)`` with
    ``--moe_experts``),
    and a function returning the next batch (numpy) — the synthetic task,
    or the corpus with ``--data_path``: ``[batch, seq_len]`` int32 tokens,
    or with ``--seq_shards > 1`` (every shard on this process's device)
    the pair ``(tokens, targets)`` of the ring's layout."""
    from tpudist_torch.parallel import LocalRing

    _check_flags(args)
    if args.seed is None:
        args.seed = resolve_shared_seed(None)
    device = resolve_device(args.device)
    model = build_model(args, device)
    experts = max(args.moe_experts, 1)
    mesh = make_mesh(MeshConfig(data=-1, model=experts),
                     devices=model_devices(experts, device), device=device)
    model.moe_fn = moe_parts(args, mesh)
    opt, sched = build_optimizer_from_args(args, model.parameters())
    ctx, loss_fn, place = seq_parts(
        args, LocalRing(args.seq_shards) if args.seq_shards > 1 else None)
    layout = fsdp_layout(args, data_parallel_mesh(device=device), model, opt)
    step = make_lm_train_step(model, opt, scheduler=sched,
                              accum_steps=args.accum_steps, ctx=ctx,
                              loss_fn=loss_fn, state_sharding=layout,
                              aux=args.moe_experts > 0,
                              moe_balance_weight=args.moe_balance)
    if args.data_path is not None:
        _, corpus, _ = open_corpus(args)
        return model, step, lambda: place(next(corpus))
    rng = np.random.default_rng(args.seed)
    return model, step, lambda: place(make_batch(
        rng, args.batch_size, args.seq_len, args.vocab))


def _check_flags(args) -> None:
    """The JAX demo's flag checks (``:135-142``, ``:155-163``,
    ``:268-270``)."""
    if args.moe_experts > 0 and args.seq_shards > 1:
        raise SystemExit("--moe_experts composes with dp, not sp: use "
                         "--seq_shards 1")
    if args.moe_experts > 0 and not 1 <= args.moe_topk <= args.moe_experts:
        raise SystemExit(
            f"--moe_topk {args.moe_topk} must be in [1, "
            f"{args.moe_experts}] (= --moe_experts)")
    if args.moe_experts == 0 and (args.moe_topk != 1 or args.moe_balance):
        raise SystemExit("--moe_topk/--moe_balance need --moe_experts > 0")
    if args.seq_shards < 1:
        raise SystemExit(f"--seq_shards must be at least 1, got "
                         f"{args.seq_shards}")
    if args.zigzag:
        if args.seq_shards < 2:
            raise SystemExit("--zigzag balances the RING; needs "
                             "--seq_shards > 1")
        if args.sliding_window or args.rope or args.inner_block:
            raise SystemExit("--zigzag excludes --sliding_window/--rope/"
                             "--inner_block (window already rebalances; "
                             "rope derives positions from array order)")
    if args.eval_fraction > 0 and args.data_path is None:
        raise SystemExit("--eval_fraction needs --data_path (the synthetic "
                         "task has no held-out set)")


def _to_device(batch, device):
    """A numpy batch, or a tuple of them, as tensors on ``device``."""
    if isinstance(batch, tuple):
        return tuple(torch.from_numpy(a).to(device) for a in batch)
    return torch.from_numpy(batch).to(device)


def _generate(args, model, windows) -> None:
    """``--generate``: decode after training from the corpus's first 8
    tokens or a synthetic prompt (``:339-378``)."""
    from tpudist_torch.models.generate import generate

    if process_count() > 1:
        rank_print("--generate skipped on multi-host runs")
        return
    if windows is not None:
        prompt = windows.gather(np.zeros(1, np.int64))[:, :8]
    else:
        prompt = make_batch(np.random.default_rng(args.seed + 1), 1, 8,
                            args.vocab)
    temp = args.gen_temperature
    if temp == 0.0 and (args.gen_top_k is not None
                        or args.gen_top_p is not None):
        # the filters mean nothing under greedy argmax: sample
        temp = 1.0
        rank_print("--gen_top_k/--gen_top_p given with temperature 0: "
                   "sampling at temperature 1.0")
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(args.seed or 0)
    # a ring-trained windowed model decodes with the window the ring held,
    # through the model's own cache (the JAX demo's module.clone)
    model.sliding_window = args.sliding_window
    out = generate(model, torch.from_numpy(prompt).to(device), args.generate,
                   temperature=temp, top_k=args.gen_top_k,
                   top_p=args.gen_top_p, generator=gen)
    rank_print(f"prompt {prompt[0].tolist()} -> "
               f"{out[0, 8:].cpu().tolist()}")


@record
def main(argv=None) -> float:
    """Train, evaluate, decode; returns the final loss."""
    args = get_args(argv)
    _check_flags(args)
    device = resolve_device(args.device)
    ctx = initialize(use_node_rank=args.use_node_rank, device=device)
    args.seed = resolve_shared_seed(args.seed)
    n_seq, experts = args.seq_shards, args.moe_experts
    # the model axis holds the experts, one a place (folded onto the
    # rank's card where the host has fewer)
    mesh = (make_mesh(MeshConfig(data=-1, seq=n_seq,
                                 model=max(experts, 1)),
                      devices=model_devices(max(experts, 1), device),
                      device=device)
            if n_seq > 1 or experts else data_parallel_mesh(device=device))
    # the data rows: the ranks of one ring read the same rows
    rows, data_row = mesh.shape["data"], mesh.coords["data"]
    describe_runtime(ctx, args.seed, mesh.devices[0])
    model_axis = f", 'model': {experts}" if experts else ""
    rank_print(f"mesh={{'data': {rows}, 'seq': {n_seq}{model_axis}}} "
               f"seq_len={args.seq_len} (block {args.seq_len // n_seq}"
               "/chip)")
    dev = mesh.devices[0]
    seq_ctx, loss_fn, place = seq_parts(args, mesh.ring)
    model = build_model(args, dev)
    model.moe_fn = moe_parts(args, mesh)
    opt, sched = build_optimizer_from_args(args, model.parameters())
    layout = fsdp_layout(args, mesh, model, opt)
    step = make_lm_train_step(model, opt, scheduler=sched,
                              accum_steps=args.accum_steps, ctx=seq_ctx,
                              loss_fn=loss_fn, state_sharding=layout,
                              aux=experts > 0,
                              moe_balance_weight=args.moe_balance)
    logger = init_metrics(args.project, args.group or "demo_long_context",
                          dry_run=args.dry_run)
    rng = np.random.default_rng(args.seed)
    windows = corpus = None
    if args.data_path is not None:
        # per-row shard of the windows; --batch_size is per data row
        windows, corpus, eval_idx = open_corpus(args, num_shards=rows,
                                                shard_id=data_row)
    elif args.batch_size % rows:
        unit = "ranks" if n_seq == 1 else "data rows"
        raise SystemExit(f"the synthetic --batch_size {args.batch_size} is "
                         f"the global batch: it must divide over {rows} "
                         f"{unit}")
    eval_batches = []
    if corpus is not None and 0 < len(eval_idx) < args.batch_size:
        rank_print(f"WARNING: eval disabled — the held-out tail has "
                   f"{len(eval_idx)} windows, fewer than one batch of "
                   f"{args.batch_size}")
    if corpus is not None and len(eval_idx) >= args.batch_size:
        # fixed held-out batches (up to 4), the same on every rank
        n_eval = min(4, len(eval_idx) // args.batch_size)
        eval_batches = [_to_device(place(windows.gather(
            eval_idx[i * args.batch_size:(i + 1) * args.batch_size])), dev)
            for i in range(n_eval)]
    eval_step = make_lm_eval_step(model, loss_fn=loss_fn, ctx=seq_ctx,
                                  params_sharding=step.runtime)

    def eval_loss() -> float:
        return float(np.mean([float(eval_step(b)) for b in eval_batches]))

    share = args.batch_size // rows

    def batch_source():
        for _ in range(args.total_iterations):
            if corpus is not None:
                yield place(next(corpus))
            else:
                # the same global batch on every rank: this data row's rows
                yield place(make_batch(rng, args.batch_size, args.seq_len,
                                       args.vocab)[data_row * share:
                                                   (data_row + 1) * share])

    batches = prefetch_to_device(batch_source(), dev)
    loss = None
    t0 = time.perf_counter()
    with trace(args.profile_dir):
        for it, tokens in enumerate(batches):
            loss, aux = step(tokens) if experts else (step(tokens), {})
            do_eval = bool(eval_batches) and it % args.eval_every == 0
            if it % args.log_every == 0 or do_eval:
                row = {"loss/lm": float(loss), "iteration": it}
                if do_eval:
                    row["loss/eval"] = eval_loss()
                row.update(moe_rows(aux))
                logger.log(row)
                rank_print(f"iteration {it}: " + " ".join(
                    f"{k} {v:.4f}" for k, v in row.items()
                    if k != "iteration"))
    batches.close()
    final = float(loss) if loss is not None else float("nan")
    rank_print(f"{args.total_iterations} iterations in "
               f"{time.perf_counter() - t0:.2f} s on {dev}")
    logger.finish()
    if hasattr(corpus, "close"):
        corpus.close()  # joins the native gather pool's workers
    rank_print(f"final lm loss: {final:.4f}")
    if args.generate > 0:
        # --fsdp: every rank gathers the whole weights first
        _generate(args, model if step.runtime is None
                  else step.runtime.materialize(), windows)
    # the process group goes down even at world 1, where the JAX demo
    # has none to tear down
    shutdown()
    return final


if __name__ == "__main__":
    main()
