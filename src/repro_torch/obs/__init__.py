"""Observability layer of the port (own copy of ``src/repro/obs``'s
serving seams), stdlib only at import time:

- :mod:`repro_torch.obs.clock` — the injectable clock (``monotonic`` /
  ``perf_counter`` / ``wall_time``); tests install a ``VirtualClock``.
- :mod:`repro_torch.obs.trace` — a :class:`~repro_torch.obs.trace.Tracer`
  writing Chrome ``trace_event`` spans (request lifecycles and the
  scheduler's ticks) that Perfetto and ``repro_torch.obs.report`` read.
- :mod:`repro_torch.obs.metrics` — the process-wide registry of counters,
  gauges and histograms, off by default.
- :mod:`repro_torch.obs.kernels` — the dispatch path each op resolved to,
  the kernel plans used, and the decode step's analytic cost with, on the
  card, its kernels from ``torch.profiler``.

``python -m repro_torch.obs.report trace.json`` renders a tick timeline,
per-request waterfall and preemption-cause table (``--diff A B`` compares
two traces); ``python -m repro_torch.obs.merge`` aligns per-replica traces
into one Perfetto view.
"""
from repro_torch.obs import clock, kernels, metrics, trace

__all__ = ["clock", "kernels", "metrics", "trace"]
