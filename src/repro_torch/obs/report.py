"""Render a serving trace: tick timeline, request waterfall, causes.

Usage::

    python -m repro_torch.obs.report trace.json
    python -m repro_torch.obs.report --diff A.json B.json [--out d.md]

The input is the JSON-array trace_event file written by
:class:`repro_torch.obs.trace.Tracer` (also line-parseable — see that
module).  The port's own copy of ``src/repro/obs/report.py``: the same
text, table for table, from the same events.

``--diff`` compares two traces: an aligned tick timeline (tick k of A
against tick k of B), per-phase queued/prefill/decode/suspended totals, and
per-request-class latency deltas, as markdown tables.

Exit codes gate CI: 0 clean, 1 when structural validation fails on any
input (unclosed spans, bad nesting — the problems are printed either way),
2 on usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Request-lifecycle phases in waterfall order, with 1-char bar glyphs.
_PHASES = ("queued", "prefill", "decode", "suspended")
_GLYPH = {"queued": ".", "prefill": "=", "decode": "#", "suspended": "~"}


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read a trace file; tolerates both the array form and bare JSONL."""
    with open(path) as fh:
        text = fh.read()
    try:
        data = json.loads(text)
        if isinstance(data, list):
            return data
    except json.JSONDecodeError:
        pass
    events = []
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if not line or line in ("[", "]"):
            continue
        events.append(json.loads(line))
    return events


def validate(events: List[Dict[str, Any]]) -> List[str]:
    """Structural checks; returns a list of problems (empty == clean).

    - no span was force-closed (``unclosed`` flag from ``Tracer.close``)
    - complete spans on each (pid, tid) track nest properly: a span that
      starts inside another must end inside it too.
    """
    problems = []
    tracks: Dict[Any, List[Dict[str, Any]]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        if ev.get("args", {}).get("unclosed"):
            problems.append(f"unclosed span {ev['name']!r} on "
                            f"pid={ev.get('pid')} tid={ev.get('tid')}")
        tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for (pid, tid), spans in tracks.items():
        spans.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[Dict[str, Any]] = []
        for ev in spans:
            start, end = ev["ts"], ev["ts"] + ev.get("dur", 0.0)
            while stack and start >= stack[-1]["ts"] + stack[-1]["dur"] - 1e-6:
                stack.pop()
            if stack:
                outer_end = stack[-1]["ts"] + stack[-1]["dur"]
                if end > outer_end + 1e-6:
                    problems.append(
                        f"span {ev['name']!r} overlaps {stack[-1]['name']!r} "
                        f"without nesting (pid={pid} tid={tid})")
            stack.append(ev)
    return problems


def _request_rows(events):
    """Aggregate per-request phase totals + lifecycle instants."""
    names = {}            # (pid, tid) -> track label
    rows: Dict[Any, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    for ev in events:
        pid, tid = ev.get("pid", 0), ev.get("tid", 0)
        if tid == 0:      # scheduler track
            continue
        key = (pid, tid)
        row = rows.setdefault(key, {
            "label": names.get(key, f"pid{pid}/tid{tid}"),
            "phase_ms": {p: 0.0 for p in _PHASES},
            "segments": [], "tokens": 0, "preempts": 0,
            "retire": None, "start": None, "end": None, "priority": 0,
        })
        ts = ev.get("ts", 0.0)
        if ev.get("ph") == "X":
            name, dur = ev["name"], ev.get("dur", 0.0)
            if name == "queued":
                row["priority"] = ev.get("args", {}).get("priority", 0)
            if name in row["phase_ms"]:
                row["phase_ms"][name] += dur / 1000.0
                row["segments"].append((ts, dur, name))
            row["start"] = ts if row["start"] is None else min(row["start"], ts)
            row["end"] = max(row["end"] or 0.0, ts + dur)
        elif ev.get("ph") == "i":
            if ev["name"] == "token":
                row["tokens"] += 1
            elif ev["name"] == "preempt":
                row["preempts"] += 1
            elif ev["name"] == "retire":
                row["retire"] = ev.get("args", {}).get("cause", "?")
    return rows


def summarize(events: List[Dict[str, Any]], *, width: int = 48,
              max_ticks: int = 40) -> str:
    out: List[str] = []
    problems = validate(events)
    if problems:
        out.append("TRACE PROBLEMS:")
        out.extend(f"  - {p}" for p in problems)

    # --- tick timeline --------------------------------------------------
    ticks = [ev for ev in events
             if ev.get("ph") == "X" and ev["name"] == "tick"]
    counters = [ev for ev in events
                if ev.get("ph") == "C" and ev["name"] == "sched"]
    out.append(f"tick timeline ({len(ticks)} ticks)")
    shown = ticks[:max_ticks]
    gauges = {round(c["ts"], 1): c["args"] for c in counters}
    for i, ev in enumerate(shown):
        args = ev.get("args", {})
        # nearest counter emitted at/after this tick's start
        g = args or {}
        for ts, vals in gauges.items():
            if ts >= ev["ts"] - 1.0:
                g = {**vals, **args}
                break
        extras = " ".join(f"{k}={g[k]}" for k in ("active", "queue",
                                                  "free_slots") if k in g)
        out.append(f"  tick {args.get('tick', i):>4}  "
                   f"dur={ev.get('dur', 0.0) / 1000.0:8.3f}ms  {extras}")
    if len(ticks) > max_ticks:
        out.append(f"  ... {len(ticks) - max_ticks} more ticks")

    # --- per-request waterfall ------------------------------------------
    rows = _request_rows(events)
    starts = [r["start"] for r in rows.values() if r["start"] is not None]
    ends = [r["end"] for r in rows.values() if r["end"] is not None]
    if rows and starts and ends:
        span_start, span_end = min(starts), max(ends)
        scale = width / max(span_end - span_start, 1e-9)
        out.append("")
        out.append("request waterfall "
                   "(.=queued ==prefill #=decode ~=suspended)")
        for key in sorted(rows):
            row = rows[key]
            bar = [" "] * width
            for ts, dur, name in row["segments"]:
                lo = int((ts - span_start) * scale)
                hi = max(int((ts + dur - span_start) * scale), lo + 1)
                for j in range(lo, min(hi, width)):
                    bar[j] = _GLYPH[name]
            ph = row["phase_ms"]
            out.append(
                f"  {row['label']:>8} |{''.join(bar)}| "
                f"queued={ph['queued']:.1f}ms prefill={ph['prefill']:.1f}ms "
                f"decode={ph['decode']:.1f}ms tokens={row['tokens']}")

        # --- cause table ------------------------------------------------
        causes: Dict[str, int] = {}
        preempted = 0
        for row in rows.values():
            preempted += row["preempts"]
            if row["retire"]:
                causes[row["retire"]] = causes.get(row["retire"], 0) + 1
        out.append("")
        out.append("retire causes: " + (", ".join(
            f"{k}={v}" for k, v in sorted(causes.items())) or "none"))
        out.append(f"preemptions: {preempted}")
    if not problems:
        out.append("trace OK: all spans closed and nested")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Trace diff: two traces, one markdown comparison.
# ---------------------------------------------------------------------------
def _tick_durs_ms(events) -> List[float]:
    """Tick durations in ms, in tick order."""
    ticks = [(ev.get("args", {}).get("tick", i), ev.get("dur", 0.0) / 1000.0)
             for i, ev in enumerate(events)
             if ev.get("ph") == "X" and ev.get("name") == "tick"]
    return [d for _, d in sorted(ticks, key=lambda t: t[0])]


def _percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (matches ``ServeReport``'s convention of
    never interpolating across raw samples)."""
    s = sorted(values)
    idx = min(int(round(q / 100.0 * (len(s) - 1))), len(s) - 1)
    return s[idx]


def _trace_stats(events) -> Dict[str, Any]:
    """The comparable aggregates of one trace."""
    rows = _request_rows(events)
    ticks = _tick_durs_ms(events)
    phases = {p: sum(r["phase_ms"][p] for r in rows.values())
              for p in _PHASES}
    classes: Dict[int, List[float]] = {}
    class_tokens: Dict[int, int] = {}
    for r in rows.values():
        if r["start"] is None or r["end"] is None:
            continue
        cls = r["priority"]
        classes.setdefault(cls, []).append((r["end"] - r["start"]) / 1000.0)
        class_tokens[cls] = class_tokens.get(cls, 0) + r["tokens"]
    return {
        "ticks": len(ticks),
        "tick_total_ms": sum(ticks),
        "tick_mean_ms": sum(ticks) / len(ticks) if ticks else 0.0,
        "tick_durs": ticks,
        "requests": len(rows),
        "tokens": sum(r["tokens"] for r in rows.values()),
        "preemptions": sum(r["preempts"] for r in rows.values()),
        "phases": phases,
        "classes": classes,
        "class_tokens": class_tokens,
    }


def _delta(a: float, b: float) -> str:
    if a == 0.0:
        return "—" if b == 0.0 else "+∞"
    return f"{(b - a) / a * 100.0:+.1f}%"


def diff(events_a, events_b, label_a: str = "A", label_b: str = "B", *,
         max_ticks: int = 40) -> str:
    """Markdown comparison of two traces: headline aggregates, the tick
    timeline aligned by tick index, and per-request-class latency
    deltas."""
    sa, sb = _trace_stats(events_a), _trace_stats(events_b)
    lines = [f"## Trace diff — {label_a} → {label_b}", ""]
    lines += [f"| metric | {label_a} | {label_b} | Δ% |",
              "|---|---:|---:|---:|"]
    scalar_rows: List[Tuple[str, float, float, str]] = [
        ("ticks", sa["ticks"], sb["ticks"], "d"),
        ("tick total ms", sa["tick_total_ms"], sb["tick_total_ms"], "f"),
        ("tick mean ms", sa["tick_mean_ms"], sb["tick_mean_ms"], "f"),
        ("requests", sa["requests"], sb["requests"], "d"),
        ("tokens", sa["tokens"], sb["tokens"], "d"),
        ("preemptions", sa["preemptions"], sb["preemptions"], "d"),
    ]
    for p in _PHASES:
        scalar_rows.append((f"{p} ms (Σ requests)",
                            sa["phases"][p], sb["phases"][p], "f"))
    for name, va, vb, kind in scalar_rows:
        fmt = (lambda v: f"{v:.0f}") if kind == "d" else (
            lambda v: f"{v:.3f}")
        lines.append(f"| {name} | {fmt(va)} | {fmt(vb)} | {_delta(va, vb)} |")

    # --- aligned tick timeline ------------------------------------------
    da, db = sa["tick_durs"], sb["tick_durs"]
    n = max(len(da), len(db))
    lines += ["", "### Aligned tick timeline (by tick index)", "",
              f"| tick | {label_a} ms | {label_b} ms | Δ% |",
              "|---:|---:|---:|---:|"]
    for i in range(min(n, max_ticks)):
        va = da[i] if i < len(da) else None
        vb = db[i] if i < len(db) else None
        fa = f"{va:.3f}" if va is not None else "—"
        fb = f"{vb:.3f}" if vb is not None else "—"
        d = _delta(va, vb) if va is not None and vb is not None else "—"
        lines.append(f"| {i} | {fa} | {fb} | {d} |")
    if n > max_ticks:
        lines.append(f"| … | {max(len(da) - max_ticks, 0)} more "
                     f"| {max(len(db) - max_ticks, 0)} more | |")

    # --- per-request-class latency deltas -------------------------------
    all_classes = sorted(set(sa["classes"]) | set(sb["classes"]))
    if all_classes:
        lines += ["", "### Per-request-class latency (request lifetime, "
                  "arrival → last span)", "",
                  f"| class | n {label_a}→{label_b} "
                  f"| mean ms {label_a} | mean ms {label_b} | Δ% "
                  f"| p95 ms {label_a} | p95 ms {label_b} | Δ% "
                  f"| tokens {label_a}→{label_b} |",
                  "|---:|---|---:|---:|---:|---:|---:|---:|---|"]
        for cls in all_classes:
            la = sa["classes"].get(cls, [])
            lb = sb["classes"].get(cls, [])
            if la and lb:
                ma, mb = sum(la) / len(la), sum(lb) / len(lb)
                pa, pb = _percentile(la, 95), _percentile(lb, 95)
                lines.append(
                    f"| {cls} | {len(la)}→{len(lb)} | {ma:.3f} | {mb:.3f} "
                    f"| {_delta(ma, mb)} | {pa:.3f} | {pb:.3f} "
                    f"| {_delta(pa, pb)} "
                    f"| {sa['class_tokens'].get(cls, 0)}"
                    f"→{sb['class_tokens'].get(cls, 0)} |")
            else:
                side = label_b if lb else label_a
                lines.append(f"| {cls} | {len(la)}→{len(lb)} | — | — | — "
                             f"| — | — | — | only in {side} |")
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize one trace, or --diff two.  Exits 1 when "
                    "structural validation fails on any input.")
    ap.add_argument("trace", nargs="?", metavar="trace.json",
                    help="trace file to summarize")
    ap.add_argument("--diff", nargs=2, metavar=("A.json", "B.json"),
                    default=None,
                    help="compare two traces (aligned ticks, phase totals, "
                         "per-class latency deltas) instead of summarizing")
    ap.add_argument("--out", metavar="PATH", default=None,
                    help="also write the diff markdown to PATH")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if (args.trace is None) == (args.diff is None):
        ap.print_usage(sys.stderr)
        print("error: pass exactly one of trace.json or --diff A B",
              file=sys.stderr)
        return 2

    if args.diff is None:
        events = load_trace(args.trace)
        print(summarize(events))
        problems = validate(events)
        for p in problems:
            print(f"TRACE PROBLEM: {p}", file=sys.stderr)
        return 1 if problems else 0

    path_a, path_b = args.diff
    events_a, events_b = load_trace(path_a), load_trace(path_b)
    problems = []
    for path, events in ((path_a, events_a), (path_b, events_b)):
        problems += [f"{path}: {p}" for p in validate(events)]
    text = diff(events_a, events_b, label_a=path_a, label_b=path_b)
    sys.stdout.write(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    for p in problems:
        print(f"TRACE PROBLEM: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
