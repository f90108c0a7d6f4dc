#!/usr/bin/env python3
"""Time the fused softmax+top-k and the bf16 cached prefills on one NVIDIA
GPU, from this checkout's ``src`` or another's, so two versions of the
kernels can be compared on one card, one after the other.

    python3 tools/topk_prefill_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is imported (by
default this checkout's); the inputs, checks and timers are
``chip_smoke.py``'s.  Each call is first held against its plain version on
the timed input, then timed as the device time of one wrapper launch
(launches queued behind a device sleep, ``_device_call_ms``) and back to
back (``_ms``):

* ``softmax_topk`` at the serving paths' sampling shapes ([8 | 4 | 1,
  49152] fp32, k = 5) and phase 9's library calls ([4096, 49152] bf16,
  [70000, 1000] fp32), beside ``torch.topk(torch.softmax(x, -1), 5)``;
* the bf16 paged prefill (row 3) at phase 8's chunk (B 1, Tq 64 at offset
  64, vlen 128, BS 16) and a later chunk (offset 192, vlen 256);
* the bf16 contiguous prefill (row 5, B 1, Tq 64 at offset 64, vlen 128,
  Tk 328) and the bf16 fresh forward (row 6, B 8, T 512), which share the
  tensor-core tile loop.

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
        print("topk_prefill_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import softmax_topk as st
    if not st.__file__.startswith(os.path.abspath(a.src)):
        raise RuntimeError(f"imported {st.__file__}, not from {a.src}")
    gen = torch.Generator().manual_seed(1)
    rows = {}

    for r, v, dtype in ((8, 49152, "float32"), (4, 49152, "float32"),
                        (1, 49152, "float32"), (4096, 49152, "bfloat16"),
                        (70000, 1000, "float32")):
        x = (torch.randn(r, v, generator=gen) * 4.0).to(
            device="cuda", dtype=getattr(torch, dtype))
        got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
        if not torch.equal(got.indices.long(), want.indices):
            raise AssertionError(f"softmax_topk [{r}, {v}]: indices differ")
        args, _ = st.prepare(x, 5)
        rows[f"softmax_topk [{r}, {v}] {dtype}"] = {
            "device_ms": cs._device_call_ms(lambda: st.launch(args)),
            "ms": cs._ms(lambda: st.launch(args)),
            "library_device_ms": cs._device_call_ms(
                lambda: torch.topk(torch.softmax(x, -1), 5))}
        del x, args

    for qoff, vlen in ((64, 128), (192, 256)):
        q, kp, vp, tk, tp, vl = cs._paged_inputs(
            gen, dtype=torch.bfloat16, bs=16, vlens=[vlen], tq=64,
            share=False)
        qo = torch.tensor([qoff], dtype=torch.int32, device="cuda")
        cs._prefill_err(q, kp, vp, qo, vl, tk, tp, "on the timed input",
                        2e-2)
        args, _ = fa.prepare_paged(q, kp, vp, qo, vl, tk)
        rows[f"flash_attention_paged Tq 64 at {qoff}, vlen {vlen}"] = {
            "device_ms": cs._device_call_ms(lambda: fa.launch(args)),
            "ms": cs._ms(lambda: fa.launch(args))}

    q, _, _, k, v = cs._contiguous_inputs(gen, dtype=torch.bfloat16, s=328,
                                          vlens=[128], tq=64)
    qo = torch.tensor([64], dtype=torch.int32, device="cuda")
    vl = torch.tensor([128], dtype=torch.int32, device="cuda")
    cs._offset_err((q, k, v, k, v), qo, vl, "on the timed input", 2e-2)
    args, _ = fa.prepare(q, k, v, qo, vl)
    rows["flash_attention_offset Tq 64 at 64, vlen 128"] = {
        "device_ms": cs._device_call_ms(lambda: fa.launch(args)),
        "ms": cs._ms(lambda: fa.launch(args))}

    q, k, v, _ = cs._fresh_inputs(gen, dtype=torch.bfloat16, b=8, t=512)
    k, v = k.contiguous(), v.contiguous()
    args, _ = fa.prepare_fwd(q, k, v)
    rows["flash_attention B 8, T 512"] = {
        "device_ms": cs._device_call_ms(lambda: fa.launch(args)),
        "ms": cs._ms(lambda: fa.launch(args))}
    print(json.dumps({"label": a.label, "src": a.src, "smi": cs._smi(),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
