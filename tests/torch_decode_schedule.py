#!/usr/bin/env python3
"""Does a lane's decode depend on the block schedule, or on its slot?

Phase 4's model and server geometry (``chip_smoke.py``: d 1024, 8 layers,
bf16, a paged pool in 16-token blocks, 8 slots, chunk 64) on one card:
phase 4's first 8 requests (greedy and its sampled lane) are prefilled in
one admission batch and decoded 48 tokens with ``logprobs=2``, once at the
engine's full block (K 8) as the reference and then again at other
schedules: K 8 again, K 1, K 4, K cycling through 1, 2, 4, 8, 2, and K 8
and a mixed cycle with the lanes in other slots.  For each schedule it
prints how many lanes' tokens equal the reference's, how many logprobs
rows differ, and each lane's first differing row.  K 8 again and K 8 with
the slots permuted read the reference bit for bit when decode is
row-independent at a fixed slot count; another K moves a position between
the pool and the decode window buffer, which the paged decode kernel's
split walk merges in another order.  Prints one JSON object and the card's
``nvidia-smi`` line.  Imports no JAX.

  python3 tests/torch_decode_schedule.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

TOKENS = 48
PERM = [3, 7, 1, 0, 6, 2, 5, 4]
SCHEDULES = (("k8 again", [8], None), ("k1", [1], None), ("k4", [4], None),
             ("mixed", [1, 2, 4, 8, 2], None), ("k8 permuted", [8], PERM),
             ("mixed permuted", [2, 8, 1, 4], PERM))


def run(torch, model, reqs, temps, pattern, perm=None):
    """Prefill the 8 requests in slots ``perm`` and decode ``TOKENS``
    tokens a lane with block sizes cycling through ``pattern``; returns
    each request's tokens and top-2 logprob rows."""
    import chip_smoke as cs
    from tpudist_torch.serve import SlotEngine

    eng = SlotEngine(model, num_slots=cs.SLOTS, prefill_pad=cs.P,
                     kv_block=cs.BS, decode_block=8, logprobs=2,
                     device="cuda")
    perm = perm or list(range(8))
    eng.start_batch([(perm[i], reqs[i][0], temps[i], i, 64)
                     for i in range(8)])
    while eng.prefilling_slots():
        eng.advance_prefill()
    toks = {i: [] for i in range(8)}
    lps = {i: [] for i in range(8)}
    j = 0
    while min(len(t) for t in toks.values()) < TOKENS:
        info, out = eng.decode_block(max_k=pattern[j % len(pattern)])
        j += 1
        for s, t in out.items():
            i = perm.index(s)
            toks[i] += t
            lps[i] += [tuple(v) for _, v in info["logprobs"][s]]
    torch.cuda.synchronize()
    return ({i: t[:TOKENS] for i, t in toks.items()},
            {i: row[:TOKENS] for i, row in lps.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_schedule: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tpudist_torch.models import TransformerLM, create_transformer
    from tpudist_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(("paged_attention", "paged_prefill", "fused_sample"))
    cpu = create_transformer(0, device="cpu", dtype=torch.float32,
                             **cs.MODEL)
    model = TransformerLM(dtype=torch.bfloat16, **cs.MODEL)
    model.load_state_dict(cpu.state_dict())
    model = model.to("cuda").requires_grad_(False)
    _, reqs, temps, _ = cs.phase4_traffic(7)
    base_t, base_l = run(torch, model, reqs, temps, [8])
    res = {}
    for name, pattern, perm in SCHEDULES:
        t, l = run(torch, model, reqs, temps, pattern, perm)
        res[name] = dict(
            lanes_tokens_equal=sum(t[i] == base_t[i] for i in range(8)),
            lp_rows_differing=sum(a != b for i in range(8)
                                  for a, b in zip(l[i], base_l[i])),
            first_differing_row=[next((j for j, (a, b) in enumerate(
                zip(l[i], base_l[i])) if a != b), None) for i in range(8)])
        print(name, res[name], flush=True)
    card = cs.card_line()
    out = dict(card=card, tokens=TOKENS, schedules=res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
