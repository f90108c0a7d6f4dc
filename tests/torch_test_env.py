"""Caps torch's CPU threads in a pytest-xdist worker.

Every ``tests/test_torch_*.py`` (and ``tests/torch_distributed_world.py``)
imports this module before anything else of torch's runs.  Under xdist each
of the N workers would otherwise start one intra-op thread a core, so N
workers run N × cores threads on the machine's cores and the port's tests
slow down many times over.  Inside a worker (``PYTEST_XDIST_WORKER`` set)
this sets torch's intra-op threads to ``cores // N`` (at least 1), and sets
``OMP_NUM_THREADS`` to the same value unless the caller set it, so that the
subprocesses the tests start (the gloo world, the CLI runs, the reference's
subprocess) inherit it.  Without xdist it changes nothing.
"""
import os


def worker_threads():
    """Threads a worker may use, or None outside a pytest-xdist worker."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not os.environ.get("PYTEST_XDIST_WORKER") or not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


THREADS = worker_threads()
if THREADS is not None:
    # torch first: the worker's own OpenMP runtime starts from the same
    # environment as without the cap (the JAX package's tests share the
    # process), and only torch's pool is capped in it
    import torch

    torch.set_num_threads(THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
