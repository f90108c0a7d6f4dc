#!/usr/bin/env python3
"""Time the port's MLA latent attention kernels (rows 4m and 5m) on one
NVIDIA GPU, from this checkout's ``src`` or another's, so two versions of
the kernels can be compared on one card, one after the other.

    python3 tools/mla_kernel_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's); the inputs, checks and timers are
``chip_smoke.py``'s phase 8 (``_mla_attention_times``, ``MLA_TIMED``):
minicpm3-4b's 40 heads over R 256 + Dr 32, bf16, scale 96^-0.5, every
latent row past a row's vlen NaN: the decode at B 8 over vlen 65-328 (S
328), the cached prefill at a 64-token chunk at offset 64, the lockstep
prefill (B 4, Tq 256, S 288) and an int8 run's single-shot prefill (Tq = S
= 256), each held against its plain version on the timed input first (1e-3
+ 2^-7·|plain|). The decode is timed three times more, to part its time
between its split CTAs and its merge: at one split a row (the plan's splits
joined into one, so a CTA walks a whole row and the last merges a single
partial), and at its plan with every vlen 32 and every vlen 64 (a row of
one or two live splits, whose merge, where there is one, reads one or two
partials). For each: back-to-back launches (``ms``), launches queued behind
a device sleep (``device_ms``), the bound, the plain version and SDPA.
Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        print("mla_kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_mla as fm
    if not fm.__file__.startswith(os.path.abspath(a.src)):
        raise RuntimeError(f"imported {fm.__file__}, not from {a.src}")
    gen = torch.Generator().manual_seed(1)
    rows = cs._mla_attention_times(gen)
    for n in (32, 64):
        cases = [(key, b, tq, offs, [n] * b, s)
                 for key, b, tq, offs, _, s in cs.MLA_TIMED[:1]]
        rows.update(cs._mla_attention_times(gen, tag=f", vlen {n}",
                                            cases=cases))
    planned = fm.decode_plan

    def one_split(b, h, max_len, dtype, sms):
        p = planned(b, h, max_len, dtype, sms)
        return p._replace(split=p.split * p.splits, splits=1,
                          workspace=p.workspace // p.splits)
    fm.decode_plan = one_split
    try:
        rows.update(cs._mla_attention_times(
            gen, keys=("flash_decode_mla",), tag=", one split a row"))
    finally:
        fm.decode_plan = planned
    print(json.dumps({"label": a.label, "src": a.src, "smi": cs._smi(),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
