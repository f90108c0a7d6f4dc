"""Suite-wide setup: import paths + environment report.

The env report prints the exact portability surface the compat layer probes
(JAX version, backend, host device count, shard_map source, cost_analysis
shape, Pallas mode) at the top of every pytest run, so a red CI log starts
with the facts that usually explain it.
"""
from __future__ import annotations

import os
import sys

_TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS_DIR)
_SRC = os.path.join(_REPO, "src")

# Make `import repro` and `import _hypothesis_compat` work even when the
# caller forgot PYTHONPATH=src (plain `pytest` from the repo root).
for p in (_SRC, _TESTS_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# Hermetic autotune persistence: the dispatch registry reads this env var at
# import and writes to it on every new decision.  Point it at a per-run temp
# file (unless the caller pinned one) so the suite neither pollutes nor reads
# the developer's real ~/.cache/repro/autotune.json.
if "REPRO_AUTOTUNE_CACHE" not in os.environ:
    import tempfile
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(
        tempfile.gettempdir(), f"repro_autotune_test_{os.getpid()}.json")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc for the port's "
        "kernels); skipped where torch.cuda.is_available() is false")


def pytest_report_header(config):
    try:
        from repro import compat
        caps = compat.capabilities()
    except Exception as e:                  # never break collection over this
        return f"repro env: unavailable ({type(e).__name__}: {e})"
    try:
        import hypothesis
        hyp = f"hypothesis {hypothesis.__version__}"
    except ImportError:
        hyp = "hypothesis absent (fixed-seed fallback)"
    return (
        f"repro env: jax {caps.jax_version} | backend {caps.backend} | "
        f"host devices {caps.device_count} | "
        f"shard_map from {caps.shard_map_source} | "
        f"cost_analysis returns {caps.cost_analysis_shape} | "
        f"pallas {'native' if caps.pallas_native else 'interpret'} | {hyp}"
    )
