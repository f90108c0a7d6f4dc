#!/usr/bin/env python3
"""Count the ``torch.profiler`` sessions that record no device event, over
``chip_smoke.py``'s phase-3 kernel checks, on one NVIDIA GPU, with this
checkout's ``repro_torch`` or another's, so two versions can be compared
on one card, one after the other.

    python3 tools/profiler_sessions.py [--src DIR] [--rounds N]
                                       [--activities cuda|cpu,cuda]
                                       [--warmup none|kernel|schedule]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's).  The kernels are built (``phase_build``), then
``phase_kernels`` runs ``--rounds`` times (its own lines kept quiet) with
every profiler session it opens recorded under ``--activities``: a session
that records no device event is counted as empty, with whether it saw a
CUDA launch call among its host events and whether the port's launch
counters moved during it, and runs again (at most 3 times) so the checks
go on; a round whose checks fail on what a session recorded is counted
and the next round runs.  ``--warmup kernel`` launches one small kernel, synchronized, at
the start of every session, before the checks' work; ``--warmup
schedule`` opens each session with ``torch.profiler.schedule(wait=0,
warmup=1, active=1)`` and that small kernel in the warm-up step, whose
events the profiler drops.  Prints one line per empty session and a JSON
line with the counts and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--activities", default="cuda",
                    choices=("cuda", "cpu,cuda"))
    ap.add_argument("--warmup", default="none",
                    choices=("none", "kernel", "schedule"))
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                   # inserts ROOT/src at the front
    sys.path.insert(0, os.path.abspath(a.src))
    import torch
    if not torch.cuda.is_available():
        print("profiler_sessions: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import dispatch
    if not dispatch.__file__.startswith(os.path.abspath(a.src)):
        raise RuntimeError(f"imported {dispatch.__file__}, not {a.src}")
    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if a.activities == "cpu,cuda" else [])
    tally = {"sessions": 0, "empty": 0, "empty_with_launch_calls": 0,
             "empty_with_port_launches": 0}

    def counted(fn, *_, **__):
        caller = sys._getframe(1).f_code.co_name
        for attempt in range(1, 4):
            before = sum(dispatch.launch_counts().values())
            plan = (schedule(wait=0, warmup=1, active=1)
                    if a.warmup == "schedule" else None)
            with profile(activities=acts, schedule=plan) as prof:
                if a.warmup != "none":
                    torch.zeros(1, device="cuda")
                    torch.cuda.synchronize()
                if plan is not None:
                    prof.step()
                out = fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
            tally["sessions"] += 1
            if any(str(e.device_type).endswith("CUDA") for e in events):
                return out, prof
            calls = any(e.key.startswith(LAUNCH_CALLS) for e in events)
            moved = sum(dispatch.launch_counts().values()) > before
            tally["empty"] += 1
            tally["empty_with_launch_calls"] += calls
            tally["empty_with_port_launches"] += moved
            print(f"empty session: {caller}, attempt {attempt}, launch "
                  f"calls seen {calls}, port launches counted {moved}, "
                  f"{len(events)} host events", file=sys.stderr)
        raise RuntimeError(f"{caller}: 3 empty sessions in a row")

    cs._profiled = counted
    failed = []
    with contextlib.redirect_stdout(io.StringIO()):
        cs.phase_build()
        for _ in range(a.rounds):
            try:
                cs.phase_kernels()
            except AssertionError as e:     # a check the profile failed
                failed.append(str(e)[:200])
    for msg in failed:
        print(f"round failed: {msg}", file=sys.stderr)
    print(json.dumps({"src": os.path.relpath(os.path.abspath(a.src), ROOT),
                      "activities": a.activities, "warmup": a.warmup,
                      "rounds": a.rounds, "failed_rounds": len(failed),
                      **tally, "torch": torch.__version__,
                      "nvidia_smi": cs._smi()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
