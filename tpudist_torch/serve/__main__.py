"""``python -m tpudist_torch.serve`` — self-contained serving demo.

Builds a randomly initialized :class:`TransformerLM`, starts the
continuous-batching server on ``--device`` (``cuda`` by default), pushes a
burst of requests with mixed prompt/output lengths through it, drains, and
prints a JSON summary (per-request TTFT/TPOT and server stats, with the
device it ran on).  Same flags as ``python -m tpudist.serve`` plus
``--device``; the KV knobs come from ``TPUDIST_SERVE_*`` (e.g.
``TPUDIST_SERVE_KV_INT8=1``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.serve",
        description="continuous-batching serving demo (random weights)")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--queue", type=int, default=64)
    p.add_argument("--max-new", type=int, default=16,
                   help="output-length ceiling; each request draws from "
                        "[2, max-new]")
    p.add_argument("--prompt-len", type=int, default=12,
                   help="prompt-length ceiling; each request draws from "
                        "[1, prompt-len]")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--decode-block", type=int, default=8,
                   help="max fused decode tokens per dispatch (K)")
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--replicas", type=int, default=1,
                   help="replica servers behind a fleet router (only 1 is "
                        "ported)")
    p.add_argument("--telemetry-dir", default=None,
                   help="where serving spans land (default: "
                        "TPUDIST_TELEMETRY_DIR or runs/telemetry)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain kernel versions)")
    args = p.parse_args(argv)
    if args.replicas != 1:
        raise NotImplementedError(
            "--replicas: the fleet router is not ported yet (ROADMAP.md "
            "queue A item 8)")

    import numpy as np
    import torch

    from tpudist_torch import telemetry
    from tpudist_torch.models import create_transformer
    from tpudist_torch.serve import AdmissionError, InferenceServer, \
        ServeConfig

    if args.telemetry_dir:
        telemetry.start(args.telemetry_dir)
    dtype = torch.bfloat16 if args.device.startswith("cuda") \
        else torch.float32
    model = create_transformer(
        args.seed, device=args.device, dtype=dtype, vocab=args.vocab,
        d_model=args.d_model, n_layers=args.n_layers,
        n_heads=max(2, args.d_model // 32), d_ff=4 * args.d_model,
        max_len=args.max_len)
    # half the prompt ceiling, so the longer prompts run chunked prefill
    prefill_pad = max(1, min(args.prompt_len // 2, args.max_len // 2))
    cfg = dataclasses.replace(
        ServeConfig.from_env(), num_slots=args.slots,
        queue_limit=args.queue, max_new=args.max_new,
        prefill_pad=prefill_pad, decode_block=args.decode_block)
    server = InferenceServer(model, cfg, device=args.device).start()
    rng = np.random.default_rng(args.seed)
    handles = []
    plen_cap = max(1, min(args.prompt_len, args.max_len - args.max_new))
    try:
        for i in range(args.requests):
            plen = int(rng.integers(1, plen_cap + 1))
            max_new = int(rng.integers(2, args.max_new + 1))
            prompt = rng.integers(0, args.vocab, size=plen).astype(np.int32)
            while True:
                try:
                    handles.append(server.submit(
                        prompt, max_new=max_new,
                        temperature=args.temperature, seed=i))
                    break
                except AdmissionError as e:
                    if e.reason != "queue_full":
                        raise
                    time.sleep(0.01)  # the bounded queue doing its job
        for h in handles:
            h.wait()
        stats = server.stats()
    finally:
        server.close()
    report = telemetry.finish()
    rows = [{
        "id": h.id, "prompt_len": int(len(h.request.prompt)),
        "tokens_out": len(h.tokens), "reason": h.finish_reason,
        "ttft_ms": round(h.ttft_s * 1e3, 2) if h.ttft_s else None,
        "tpot_ms": round(h.tpot_s * 1e3, 2) if h.tpot_s else None,
    } for h in handles]
    device = (torch.cuda.get_device_name(0) if args.device.startswith("cuda")
              else "cpu")
    print(json.dumps({"device": device, "requests": rows, "stats": stats,
                      "telemetry_report": bool(report)},
                     indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
