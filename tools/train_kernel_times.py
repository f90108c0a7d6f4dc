#!/usr/bin/env python3
"""Time the port's training kernels (the fresh flash forward and its dq and
dk/dv backward) on one NVIDIA GPU, from this checkout's ``src`` or
another's, so two versions of the kernels can be compared on one card, one
after the other.

    python3 tools/train_kernel_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's); the inputs, checks and timers are
``chip_smoke.py``'s phase 8 (``_train_kernel_times``): B 8, T 512, bf16,
causal, each kernel held against its plain version on the timed input
first (``_scaled_err`` within 2e-2), at smollm-360m's 15/5 heads of
64 and, where the imported kernels take the pair
(``flash_attention_bwd.HEAD_DIMS``: head dims, or (Dqk, Dv) pairs), at
mistral-nemo-12b's 32/8 and qwen2-moe-a2.7b's 16/16 heads of 128 and at
minicpm3-4b's 40/40 of Dqk 96 / Dv 64.  For each: back-to-back launches
(``ms``) and launches queued behind a device sleep (``device_ms``), the
bound, the plain version and SDPA.  Prints one JSON line with the card's
name and power limit.
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
        print("train_kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention_bwd as fab
    if not fab.__file__.startswith(os.path.abspath(a.src)):
        raise RuntimeError(f"imported {fab.__file__}, not from {a.src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    rows = cs._train_kernel_times(gen)
    pairs = [d if isinstance(d, tuple) else (d, d) for d in fab.HEAD_DIMS]
    if (128, 128) in pairs:
        for tag, (hkv, g) in cs.TRAIN_TIMED_128.items():
            rows.update(cs._train_kernel_times(gen, hkv, g, 128, tag))
    if (96, 64) in pairs:
        rows.update(cs._train_kernel_times(gen, cs.MLA_HEADS, 1, 96, "_d96",
                                           dv=64))
    print(json.dumps({"label": a.label, "src": a.src, "smi": cs._smi(),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
