"""Chrome ``trace_event`` tracer for the serving stack.

Events follow the Trace Event Format that Perfetto and ``chrome://tracing``
ingest: complete spans (``ph="X"`` with ``ts``/``dur`` in microseconds),
instants (``"i"``), counters (``"C"``) and thread-name metadata (``"M"``).
The scheduler maps ``pid`` to the replica index and ``tid`` to a track —
tid 0 is the scheduler tick track, tid ``rid + 1`` is request ``rid``'s
lifecycle track.

The output file is a valid JSON **array** written one event per line::

    [
    {"name": "tick", "ph": "X", ...},
    {"name": "queued", "ph": "X", ...}
    ]

so it both ``json.load``s (Perfetto-compatible) and can be parsed line by
line by :mod:`repro_torch.obs.report` without holding the whole file.

The port's own copy of ``src/repro/obs/trace.py``: the same events, field
for field, read from the port's clock (:mod:`repro_torch.obs.clock`).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.obs import clock as _clock

# one prebuilt encoder: json.dumps with non-default separators constructs a
# fresh JSONEncoder per call, which roughly doubles per-event cost
_ENCODE = json.JSONEncoder(separators=(",", ":")).encode


class Span:
    """An open span handle: ``begin()`` returns one, ``end()`` closes it."""

    __slots__ = ("name", "pid", "tid", "cat", "start_us", "args", "closed")

    def __init__(self, name: str, pid: int, tid: int, cat: str,
                 start_us: float, args: Optional[Dict[str, Any]]):
        self.name = name
        self.pid = pid
        self.tid = tid
        self.cat = cat
        self.start_us = start_us
        self.args = dict(args) if args else {}
        self.closed = False


class _SpanCtx:
    """``with tracer.span(...)`` handle — a plain class, not a
    ``@contextmanager`` generator, because the generator protocol costs
    ~1µs per use and spans are the hot path."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: "Span"):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> "Span":
        return self._span

    def __exit__(self, *exc) -> None:
        self._tracer.end(self._span)


class Tracer:
    """Collects trace events in memory; :meth:`close` writes the file.

    ``clock`` defaults to the process-wide :mod:`repro_torch.obs.clock`; the
    tracer records microseconds relative to its own creation so virtual
    clocks produce small, exact timestamps.

    The hot-path buffer holds one flat tuple of scalars per event — no
    dict build, no serialization — so emitting costs a tuple pack and a
    list append, and the growing buffer is cheap for the cyclic garbage
    collector (CPython untracks tuples of atoms after a collection pass,
    where a heap of long-lived dicts keeps gen-2 scans expensive).  JSON
    encoding happens once, in :meth:`close`, outside the serve loop.

    ``flush_every=N`` bounds the buffer instead: whenever N events are
    pending they are encoded and appended to ``path`` incrementally, so a
    long-lived server holds at most N events in memory.  The file stays
    the same valid JSON array (:meth:`close` writes the closing bracket);
    :attr:`events` then exposes only the still-buffered tail and
    :attr:`total_events` counts everything emitted.
    """

    def __init__(self, path: Optional[str] = None, *,
                 clock: Optional[_clock.Clock] = None, pid: int = 0,
                 flush_every: Optional[int] = None):
        if flush_every is not None:
            if path is None:
                raise ValueError("flush_every needs a path to flush to")
            if flush_every < 1:
                raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.path = path
        self.clock = clock or _clock.get()
        self.pid = pid
        self.flush_every = flush_every
        # entries: ("X", name, cat, pid, tid, ts, dur, args_items)
        #          ("i", name, cat, pid, tid, ts, args_items)
        #          ("C", name, cat, pid, ts, args_items)
        #          ("M", pid, tid, name)
        self._buf: List[tuple] = []
        self._mono = self.clock.monotonic          # bound: hot-path calls
        self._epoch = self._mono()
        self._open: Dict[int, Span] = {}           # id(span) → span, O(1) end
        self._named_tracks: set = set()
        self._fh = None                            # lazy incremental handle
        self._flushed = 0                          # events already on disk

    @staticmethod
    def _to_dict(entry: tuple) -> Dict[str, Any]:
        ph = entry[0]
        if ph == "X":
            _, name, cat, pid, tid, ts, dur, args = entry
            return {"name": name, "ph": "X", "cat": cat, "pid": pid,
                    "tid": tid, "ts": round(ts, 3),
                    "dur": round(max(dur, 0.0), 3), "args": dict(args)}
        if ph == "i":
            _, name, cat, pid, tid, ts, args = entry
            return {"name": name, "ph": "i", "s": "t", "cat": cat,
                    "pid": pid, "tid": tid, "ts": round(ts, 3),
                    "args": dict(args)}
        if ph == "C":
            _, name, cat, pid, ts, args = entry
            return {"name": name, "ph": "C", "cat": cat, "pid": pid,
                    "tid": 0, "ts": round(ts, 3), "args": dict(args)}
        _, pid, tid, name = entry
        return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name}}

    @property
    def events(self) -> List[Dict[str, Any]]:
        """The buffered events, materialized as trace_event dicts.  With
        ``flush_every`` set this is only the unflushed tail — already
        flushed events live in the file."""
        return [self._to_dict(e) for e in self._buf]

    @property
    def total_events(self) -> int:
        """Events emitted over the tracer's lifetime: flushed + buffered."""
        return self._flushed + len(self._buf)

    def _emit(self, entry: tuple) -> None:
        self._buf.append(entry)
        if self.flush_every is not None and len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Append the buffered events to ``path`` and empty the buffer.
        No-op without a path or with nothing buffered."""
        if self.path is None or not self._buf:
            return
        if self._fh is None:
            self._fh = open(self.path, "w")
            self._fh.write("[\n")
        body = ",\n".join(_ENCODE(self._to_dict(e)) for e in self._buf)
        self._fh.write(",\n" + body if self._flushed else body)
        self._flushed += len(self._buf)
        self._buf.clear()

    # -- time ------------------------------------------------------------
    def now_us(self) -> float:
        return (self._mono() - self._epoch) * 1e6

    # -- spans -----------------------------------------------------------
    def begin(self, name: str, *, tid: int = 0, pid: Optional[int] = None,
              cat: str = "serving", args: Optional[Dict[str, Any]] = None,
              ) -> Span:
        span = Span(name, self.pid if pid is None else pid, tid, cat,
                    (self._mono() - self._epoch) * 1e6, args)
        self._open[id(span)] = span
        return span

    def end(self, span: Span, args: Optional[Dict[str, Any]] = None) -> None:
        if span.closed:
            raise RuntimeError(f"span {span.name!r} ended twice")
        span.closed = True
        del self._open[id(span)]
        if args:
            span.args.update(args)
        now = (self._mono() - self._epoch) * 1e6
        self._emit((
            "X", span.name, span.cat, span.pid, span.tid,
            span.start_us, now - span.start_us, tuple(span.args.items())))

    def span(self, name: str, *, tid: int = 0, pid: Optional[int] = None,
             cat: str = "serving", args: Optional[Dict[str, Any]] = None,
             ) -> _SpanCtx:
        return _SpanCtx(self, self.begin(name, tid=tid, pid=pid, cat=cat,
                                         args=args))

    # -- point events ----------------------------------------------------
    def instant(self, name: str, *, tid: int = 0, pid: Optional[int] = None,
                cat: str = "serving", args: Optional[Dict[str, Any]] = None,
                ) -> None:
        self._emit((
            "i", name, cat, self.pid if pid is None else pid, tid,
            (self._mono() - self._epoch) * 1e6,
            tuple(args.items()) if args else ()))

    def counter(self, name: str, values: Dict[str, float], *,
                pid: Optional[int] = None, cat: str = "serving") -> None:
        self._emit((
            "C", name, cat, self.pid if pid is None else pid,
            (self._mono() - self._epoch) * 1e6, tuple(values.items())))

    def thread_name(self, tid: int, name: str, *,
                    pid: Optional[int] = None) -> None:
        """Label a track (once per (pid, tid)); Perfetto shows it as the
        row name."""
        p = self.pid if pid is None else pid
        if (p, tid) in self._named_tracks:
            return
        self._named_tracks.add((p, tid))
        self._emit(("M", p, tid, name))

    # -- output ----------------------------------------------------------
    def close(self) -> List[Dict[str, Any]]:
        """Force-close leftovers (flagged ``unclosed``) and finish the file.

        Returns the events still in memory — everything, unless
        ``flush_every`` already streamed a prefix to disk (then only the
        tail; the file has the rest).  Without incremental flushing a
        second close rewrites the file from the retained buffer.
        """
        for span in list(self._open.values()):
            span.args["unclosed"] = True
            self.end(span)
        events = self.events
        if self._fh is not None or self.flush_every is not None:
            # incremental mode: append the tail, close the array, release
            # the handle.  The buffer was streamed out, so a second close
            # has nothing left to write.
            self.flush()
            if (self._fh is None and self.path is not None
                    and self._flushed == 0):
                self._fh = open(self.path, "w")   # zero events: empty array
                self._fh.write("[\n")
            if self._fh is not None:
                self._fh.write("\n]\n")
                self._fh.close()
                self._fh = None
        elif self.path is not None:
            with open(self.path, "w") as fh:
                fh.write("[\n")
                fh.write(",\n".join(_ENCODE(ev) for ev in events))
                fh.write("\n]\n")
        return events
