#!/usr/bin/env python3
"""Whether M threads can each run their own autograd backward on one NVIDIA
GPU while a collective in that backward waits for the other threads.

    python3 tools/thread_backward.py [--ranks M] [--timeout SECONDS]

Each of M threads builds a small graph on the card through a
``torch.autograd.Function`` whose backward meets the other threads at a
``threading.Barrier`` (as a model rank's "f" all-reduce of its gradient
would meet the other ranks), then calls ``torch.autograd.grad``.  The
autograd engine runs the backward of every CUDA node on one worker thread
per device, whichever thread started it, so the first thread to reach the
barrier holds that worker while the others' nodes wait behind it: the
barrier breaks at ``--timeout``.  The same graphs on the CPU (run in their
callers' threads) meet.  ``chip_smoke.py`` therefore runs the model axis's
thread ranks' forward in threads and replays their backward's collectives
(``_replay_grads``).  Prints one JSON line: each device's outcome per
thread, the seconds it took, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import threading
import time


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def run(device: str, ranks: int, timeout: float) -> dict:
    import torch
    barrier = threading.Barrier(ranks, timeout=timeout)

    class Meet(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 1.0

        @staticmethod
        def backward(ctx, g):
            barrier.wait()
            return g

    outcome = {}

    def rank(r):
        try:
            x = torch.randn(16, device=device, requires_grad=True)
            loss = (Meet.apply(x * 2.0) * 3.0).sum()
            torch.autograd.grad(loss, x)
            outcome[r] = "met"
        except threading.BrokenBarrierError:
            outcome[r] = "barrier broke"
    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(ranks)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    return {"outcome": [outcome.get(r, "hung") for r in range(ranks)],
            "seconds": round(time.perf_counter() - t0, 3)}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args()
    out = {"cpu": run("cpu", args.ranks, args.timeout)}
    if torch.cuda.is_available():
        out["cuda"] = run("cuda", args.ranks, args.timeout)
        out["device"] = _smi()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
