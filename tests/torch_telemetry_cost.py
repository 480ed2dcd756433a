"""What the port's default-on telemetry costs phase 4's server on the
card, and where: phase 4's model and 16 requests, queued before the
server starts (``chip_smoke.phase22_serve_run``), served in rounds, each
round running every mode once in an order rotated by one a round:

- ``off``: ``TPUDIST_TELEMETRY=0``;
- ``on``: telemetry as it ships (the JSONL stream and the metrics feed);
- ``scraped``: ``on`` with the endpoints up and scraped mid-serve;
- ``ring``: ``on`` without the JSONL stream (records kept in the ring);
- ``nosink``: ``on`` without the metrics feed;
- ``block``: ``on`` with the stream block-buffered (1 MiB) instead of
  line-buffered, so the run makes no write call until the session closes;
- ``writer``: ``on`` with the stream's writes made by a thread of their
  own (the record still encoded on the engine thread);
- ``on_nogc`` and ``off_nogc``: ``on`` and ``off`` with the cyclic
  garbage collector off for the run.

``--modes`` picks some of them (all by default).

Every run starts after a full collection.  Each run reports the engine
thread's wall and CPU time in the serving loop and the part of it inside
the engine's calls (decode blocks, prefill), the engine's own dispatch
and fetch split of its decode blocks, the loop's iterations, the time in
the telemetry seams on the engine thread (the record emit with the
metrics feed, the decode-block span, the finish event and the lifeline),
and the collector's passes and time.  Prints one line a run, the medians
by mode and the card's ``nvidia-smi`` line; ``--out FILE`` also writes
them as JSON.  Needs one card::

    python3 tests/torch_telemetry_cost.py --rounds 4 --out cost.json
"""

import argparse
import collections
import functools
import gc
import json
import os
import queue
import statistics
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODES = ("off", "on", "scraped", "ring", "nosink", "block", "writer",
         "on_nogc", "off_nogc")


class ThreadedStream:
    """A stream whose ``write`` hands the line to a daemon thread, which
    writes it to ``f``; ``close`` drains the lines, then closes ``f``."""

    def __init__(self, f):
        self.f, self.q = f, queue.SimpleQueue()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        for line in iter(self.q.get, None):
            self.f.write(line)

    def write(self, line):
        self.q.put(line)

    def flush(self):
        pass

    def fileno(self):
        return self.f.fileno()

    def close(self):
        self.q.put(None)
        self.t.join()
        self.f.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    import urllib.request  # noqa: F401 — the scrape's first import, once

    import chip_smoke as cs
    from tpudist_torch import telemetry
    from tpudist_torch.models import TransformerLM, create_transformer
    from tpudist_torch.ops import _build
    from tpudist_torch.serve import engine as eng_mod
    from tpudist_torch.serve import server as srv
    from tpudist_torch.telemetry import metrics, spans, trace

    _build.build(list(cs.SERVE_KERNELS))
    card = cs.card_line()
    cpu_model = create_transformer(0, device="cpu", dtype=torch.float32,
                                   **cs.MODEL)
    model = TransformerLM(dtype=torch.bfloat16, **cs.MODEL)
    model.load_state_dict(cpu_model.state_dict())
    model = model.to("cuda").requires_grad_(False)
    del cpu_model

    acc = collections.defaultdict(float)  # seconds
    cnt = collections.defaultdict(int)  # counts

    def timed(owner, name, label, cpu=False):
        fn = getattr(owner, name)

        @functools.wraps(fn)
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            c0 = time.thread_time() if cpu else 0.0
            try:
                return fn(*a, **k)
            finally:
                acc[label] += time.perf_counter() - t0
                if cpu:
                    acc[label + "_cpu"] += time.thread_time() - c0
                cnt[label + "_n"] += 1

        setattr(owner, name, wrapper)

    timed(spans.TelemetrySession, "_emit", "emit")
    timed(metrics, "feed_record", "feed")
    timed(trace, "emit_request_lifeline", "lifeline")
    timed(srv.InferenceServer, "_record_block", "decode_span")
    timed(srv.InferenceServer, "_note_finished", "finish")
    timed(srv.InferenceServer, "_run_loop", "loop", cpu=True)
    timed(srv.InferenceServer, "_admit", "iter")
    for name in ("decode_auto", "start_batch", "advance_prefill"):
        timed(eng_mod.SlotEngine, name, "engine")
    servers = []
    start = srv.InferenceServer.start

    def keep(self):
        servers.append(self)
        return start(self)

    srv.InferenceServer.start = keep

    gc_t0 = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_t0["t"] = time.perf_counter()
        elif "t" in gc_t0:
            acc["gc"] += time.perf_counter() - gc_t0.pop("t")
            cnt[f"gc{info['generation']}_n"] += 1

    gc.callbacks.append(on_gc)
    real_start = telemetry.start
    tmp = tempfile.mkdtemp()
    cs.phase22_serve_run(torch, model)  # a warm turn, not counted
    runs = []
    modes = tuple(args.modes.split(","))
    for rnd in range(args.rounds):
        order = modes[rnd % len(modes):] + modes[:rnd % len(modes)]
        for mode in order:
            on = not mode.startswith("off")

            def patched_start(*a, **k):
                s = real_start(*a, **k)
                if mode == "ring":
                    s._file.close()
                    s._file = None
                if mode == "nosink":
                    spans._SINK = None
                if mode in ("block", "writer"):
                    s._file.close()
                    s._file = open(s.path, "a", buffering=1 << 20) \
                        if mode == "block" else ThreadedStream(
                            open(s.path, "a", buffering=1))
                return s

            telemetry.start = patched_start
            sink = spans._SINK
            gc.collect()
            if mode.endswith("nogc"):
                gc.disable()
            acc.clear()
            cnt.clear()
            try:
                r = cs.phase22_serve_run(
                    torch, model,
                    os.path.join(tmp, f"r{rnd}_{mode}") if on else None,
                    endpoints=mode == "scraped")
            finally:
                gc.enable()
                telemetry.start = real_start
                spans._SINK = sink
            st = servers[-1].engine.decode_stats()
            row = dict(mode=mode, round=rnd, tokens_per_s=r["tokens_per_s"],
                       wall_s=r["wall_s"],
                       dispatch_ms=st["dispatch_s"] * 1e3,
                       fetch_ms=st["sync_s"] * 1e3, blocks=st["blocks"],
                       iterations=cnt.pop("iter_n"),
                       host_ms=(acc["loop"] - acc["engine"]) * 1e3,
                       **{k + "_ms": v * 1e3 for k, v in acc.items()
                          if k != "iter"}, **cnt)
            runs.append(row)
            print(json.dumps(row), flush=True)
    gc.callbacks.remove(on_gc)
    keys = ("tokens_per_s", "wall_s", "loop_ms", "loop_cpu_ms", "engine_ms",
            "host_ms", "dispatch_ms", "fetch_ms", "emit_ms", "gc_ms")
    medians = {m: {k: statistics.median(r.get(k, 0.0) for r in runs
                                        if r["mode"] == m) for k in keys}
               for m in modes}
    with open(os.path.join(tmp, f"r0_{modes[1]}", "rank0_gen0.jsonl")) as f:
        records = collections.Counter(json.loads(x)["name"] for x in f)
    print(json.dumps({"medians": medians, "records_per_run": records}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, runs=runs, medians=medians,
                           records=records), f, indent=2)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
