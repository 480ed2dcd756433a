"""``python -m tpudist_torch.telemetry report <run_dir>`` — post-hoc report CLI.

Aggregates every ``rank*_gen*.jsonl`` under ``<run_dir>`` (or its
``telemetry/`` subdirectory) into ``report.json`` + ``report.md`` and
prints the markdown.  No jax required — runs anywhere the JSONL landed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpudist_torch.telemetry",
        description="tpudist telemetry tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser(
        "report",
        help="merge a run's per-rank telemetry JSONL into "
             "report.json + report.md")
    rp.add_argument("run_dir",
                    help="telemetry dir (or a run dir with a telemetry/ "
                         "subdirectory)")
    rp.add_argument("--out-dir", default=None,
                    help="where to write report.json/report.md "
                         "(default: the telemetry dir)")
    rp.add_argument("--json", action="store_true", dest="json_out",
                    help="print report.json instead of the markdown")
    tp = sub.add_parser(
        "trace",
        help="export a run's per-request lifelines as a Perfetto-"
             "loadable Chrome trace (trace.json)")
    tp.add_argument("run_dir",
                    help="telemetry dir (or a run dir with a telemetry/ "
                         "subdirectory)")
    tp.add_argument("--out", default=None,
                    help="output path (default: <telemetry dir>/trace.json)")
    args = p.parse_args(argv)

    if args.cmd == "trace":
        import json as _json

        from tpudist_torch.telemetry.trace import export_chrome_trace

        out = export_chrome_trace(args.run_dir, args.out)
        doc = _json.loads(out.read_text())
        n_events = len(doc.get("traceEvents", []))
        n_traces = doc.get("otherData", {}).get("traces", 0)
        print(f"[tpudist.telemetry] wrote {out} "
              f"({n_traces} request lifelines, {n_events} trace events) — "
              f"load it in Perfetto (ui.perfetto.dev) or chrome://tracing")
        return 0 if n_events else 1

    from tpudist_torch.telemetry.aggregate import render_markdown, write_reports

    report, paths = write_reports(args.run_dir, out_dir=args.out_dir)
    if args.json_out:
        print(json.dumps(report, indent=2))
    else:
        print(render_markdown(report))
    if report.get("num_records", 0) == 0:
        print(f"[tpudist.telemetry] no records under {args.run_dir}",
              file=sys.stderr)
        return 1
    for kind, path in paths.items():
        if path is not None:
            print(f"[tpudist.telemetry] wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
