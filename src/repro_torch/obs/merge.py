"""Merge N per-replica trace files into one Perfetto-loadable view.

Each replica's :class:`repro_torch.obs.trace.Tracer` stamps microseconds
relative to its *own* creation, so two files from the same serve disagree
about when "now" started by however long replica construction was
staggered.  The
replicas do, however, tick in lockstep (``ReplicaRouter.step`` advances all
of them per router tick), which makes each trace's **first ``tick`` span**
a common fiducial: shifting every file so its first tick starts at t=0
aligns the monotonic clocks without any shared-epoch bookkeeping.  A file
with no tick span (edge: a replica that never ran) falls back to its
earliest timestamp.

pids: the scheduler already stamps ``pid = replica index`` into every
event, so per-replica files written through the router carry distinct pids
and merge untouched.  Files whose pids collide (e.g. two independent
single-replica serves) are re-numbered by input order and get a
``process_name`` metadata event naming the source file, so Perfetto shows
which track came from where.

CLI::

    python -m repro_torch.obs.merge --out merged.json r0.json r1.json ...

Validates the merged result (same structural checks as
``repro_torch.obs.report``) and exits nonzero on problems, like the report
CLI.  The port's own copy of ``src/repro/obs/merge.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.report import load_trace, validate

# one prebuilt encoder, same rationale as repro_torch.obs.trace
_ENCODE = json.JSONEncoder(separators=(",", ":")).encode


def align_offset(events: Sequence[Dict[str, Any]]) -> float:
    """The timestamp to subtract from ``events``: the first ``tick`` span's
    start, else the earliest timestamp, else 0 (empty trace)."""
    ticks = [ev["ts"] for ev in events
             if ev.get("ph") == "X" and ev.get("name") == "tick"
             and "ts" in ev]
    if ticks:
        return min(ticks)
    stamped = [ev["ts"] for ev in events if "ts" in ev]
    return min(stamped) if stamped else 0.0


def merge_events(traces: Sequence[Sequence[Dict[str, Any]]], *,
                 labels: Optional[Sequence[str]] = None,
                 ) -> List[Dict[str, Any]]:
    """Merge already-loaded event lists: align each on its first tick,
    renumber pids if any two inputs collide, keep every file's events in a
    single time-sorted stream (never negative timestamps)."""
    pid_sets = [{ev.get("pid", 0) for ev in t} for t in traces]
    collide = any(pid_sets[i] & pid_sets[j]
                  for i in range(len(traces)) for j in range(i))
    merged: List[Dict[str, Any]] = []
    for i, events in enumerate(traces):
        off = align_offset(events)
        if collide and labels is not None:
            merged.append({"name": "process_name", "ph": "M", "pid": i,
                           "args": {"name": f"replica {i} ({labels[i]})"}})
        for ev in events:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] - off, 3)
            if collide:
                ev["pid"] = i
            merged.append(ev)
    # a uniform shift keeps the alignment; Perfetto dislikes negative ts
    stamped = [ev["ts"] for ev in merged if "ts" in ev]
    if stamped and min(stamped) < 0:
        lift = -min(stamped)
        for ev in merged:
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + lift, 3)
    merged.sort(key=lambda ev: ev.get("ts", -1.0))
    return merged


def merge_traces(paths: Sequence[str],
                 out: Optional[str] = None) -> List[Dict[str, Any]]:
    """Load, align, and merge trace files; optionally write the merged
    array to ``out`` in the same one-event-per-line form ``Tracer.close``
    uses (``json.load``-able AND line-parseable)."""
    if not paths:
        raise ValueError("merge_traces needs at least one trace file")
    traces = [load_trace(p) for p in paths]
    merged = merge_events(traces,
                          labels=[os.path.basename(p) for p in paths])
    if out:
        with open(out, "w") as fh:
            fh.write("[\n")
            fh.write(",\n".join(_ENCODE(ev) for ev in merged))
            fh.write("\n]\n")
    return merged


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.merge",
        description="Merge per-replica trace files into one "
                    "Perfetto-loadable file (first-tick clock alignment).")
    ap.add_argument("traces", nargs="+", metavar="TRACE.json",
                    help="per-replica trace_event files, replica order")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="write the merged JSON array here")
    args = ap.parse_args(argv)
    merged = merge_traces(args.traces, out=args.out)
    pids = sorted({ev.get("pid", 0) for ev in merged})
    print(f"merged {len(args.traces)} traces → {len(merged)} events, "
          f"pids {pids}" + (f" → {args.out}" if args.out else ""))
    problems = validate(merged)
    for p in problems:
        print(f"  - {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
