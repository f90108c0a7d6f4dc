#!/usr/bin/env python3
"""Time the port's one-token decode entry points on one NVIDIA GPU, from
this checkout's ``src`` or another's, so two versions of the kernels can be
compared on one card, one after the other.

    python3 tools/decode_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's); the inputs, checks and timers are
``chip_smoke.py``'s, at its phase 8 shapes: the paged decode (B 8, BS 16,
vlen 66–329) and the contiguous decode (B 8, S 328, vlen 65–328), bf16 q,
with bf16 and int8 K/V, and the lockstep's contiguous decode (B 4, S 288,
vlen 257), each held against its plain version on the timed input first
(max abs error within 2e-2).  For each: the device time of one wrapper call
(launches queued behind a device sleep, ``_device_call_ms``), the time of
back-to-back wrapper calls (``_ms``), the host's time per wrapper call and
per ``prepare`` / ``launch`` of it (the least of 7 runs of 100 calls: the
host's clock spreads widely between runs), each kernel's device time
per call from ``torch.profiler``, and for the bf16 contiguous shapes one
SDPA call's device time; then the host's time to read the current stream
as ``torch.cuda.current_stream(0).cuda_stream`` and as its raw handle.
Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_min_us(fn, calls: int = 100, runs: int = 7) -> float:
    """Host time of one call of ``fn`` in µs: the least over ``runs`` runs
    of ``calls`` back-to-back calls, the device drained between runs."""
    import time
    import torch
    best = float("inf")
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def _kernel_us(fn, reps: int = 20) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches, µs, from
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {evt.key.split("(")[0][-60:]: evt.self_device_time_total / reps
            for evt in prof.key_averages()
            if str(evt.device_type).endswith("CUDA")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                   # inserts ROOT/src at the front
    sys.path.insert(0, os.path.abspath(a.src))
    import torch
    if not torch.cuda.is_available():
        print("decode_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_decode as fd
    if not fd.__file__.startswith(os.path.abspath(a.src)):
        raise RuntimeError(f"imported {fd.__file__}, not from {a.src}")
    gen = torch.Generator().manual_seed(1)
    bf16 = dict(device="cuda", dtype=torch.bfloat16)
    rows = {}

    def record(name, call, plain, prep, sdpa=None):
        err = (call().float() - plain().float()).abs().max().item()
        if not err <= 2e-2:
            raise AssertionError(f"{name}: max abs err {err:.3g} > 2e-2")
        args, _ = prep()
        rows[name] = {"device_ms": cs._device_call_ms(call),
                      "ms": cs._ms(call), "host_us": _host_min_us(call),
                      "prepare_us": _host_min_us(prep),
                      "launch_us": _host_min_us(lambda: fd.launch(args)),
                      "kernels_us": _kernel_us(call), "max_abs_err": err}
        if sdpa is not None:
            rows[name]["sdpa_device_ms"] = cs._device_call_ms(sdpa)

    vlens = [329, 290, 251, 212, 173, 134, 95, 66]
    q, kp, vp, tk, tp, vl = cs._paged_inputs(gen, dtype=torch.bfloat16,
                                             bs=16, vlens=vlens, share=False)
    record("flash_decode_paged",
           lambda: fd.flash_decode_paged(q, kp, vp, tk, vl),
           lambda: fd.flash_decode_paged_plain(q, kp, vp, tp, vl),
           lambda: fd.prepare_paged(q, kp, vp, tk, vl))
    q, _, pl, _, tp, vl = cs._int8_paged_inputs(gen, dtype=torch.bfloat16,
                                                bs=16, vlens=vlens)
    kw = dict(k_scale_pool=pl[2], v_scale_pool=pl[3])
    record("flash_decode_paged_int8",
           lambda: fd.flash_decode_paged(q, pl[0], pl[1], tp, vl, **kw),
           lambda: fd.flash_decode_paged_plain(q, pl[0], pl[1], tp, vl, **kw),
           lambda: fd.prepare_paged(q, pl[0], pl[1], tp, vl, **kw))
    for name, s, vlens in (
            ("flash_decode", 328, [328, 289, 250, 211, 172, 133, 94, 65]),
            ("flash_decode, lockstep", 288, [257] * 4)):
        q, _, _, k, v = cs._contiguous_inputs(gen, dtype=torch.bfloat16, s=s,
                                              vlens=vlens)
        vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
        mask = (torch.arange(s, device="cuda")[None, :]
                < vl[:, None].long())[:, None, None, :]
        record(name, lambda: fd.flash_decode(q, k, v, vl),
               lambda: fd.flash_decode_plain(q, k, v, vl),
               lambda: fd.prepare(q, k, v, vl),
               sdpa=lambda: cs._sdpa(q, k, v, mask))
    vlens = [328, 289, 250, 211, 172, 133, 94, 65]
    cache = cs._int8_contiguous_inputs(gen, s=328, vlens=vlens)[4:]
    kw = dict(k_scale=cache[2], v_scale=cache[3])
    q = torch.randn(8, 1, 15, 64, generator=gen).to(**bf16)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    record("flash_decode_int8",
           lambda: fd.flash_decode(q, cache[0], cache[1], vl, **kw),
           lambda: fd.flash_decode_plain(q, cache[0], cache[1], vl, **kw),
           lambda: fd.prepare(q, cache[0], cache[1], vl, **kw))
    stream_us = {
        "current_stream().cuda_stream": _host_min_us(
            lambda: torch.cuda.current_stream(0).cuda_stream, calls=1000),
        "raw handle": _host_min_us(
            lambda: torch._C._cuda_getCurrentRawStream(0), calls=1000)}
    print(json.dumps({"label": a.label, "src": a.src, "smi": cs._smi(),
                      "rows": rows, "stream_us": stream_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
