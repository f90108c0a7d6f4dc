#!/usr/bin/env python3
"""Time ``repro_torch.models.transformer.init`` at full width on one NVIDIA
GPU: the seeded fp32 draw on the CPU (the default, which gives the same
weights on every device) and the same seed drawn on the card, each then
cast to bf16 on the card.

    python3 tools/init_times.py [--arch NAME[:LAYERS]] ...

Each ``--arch`` is a config name, with a layer count to cut its depth to
(default: ``mistral_nemo_12b`` at its 40 layers and ``deepseek_coder_33b``
at 8).  For each: the parameter count, the seconds from the call to the
device's finish for each draw device, and the CPU draw's rate.  Prints one
JSON line with those numbers and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _count(params) -> int:
    if isinstance(params, dict):
        return sum(_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(_count(v) for v in params)
    return params.numel()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append")
    a = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("init_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.models import transformer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = []
    for spec in a.arch or ["mistral_nemo_12b", "deepseek_coder_33b:8"]:
        name, _, layers = spec.partition(":")
        cfg = configs.get(name)
        if layers:
            cfg = cfg.replace(num_layers=int(layers))
        row = {"arch": cfg.name, "layers": cfg.num_layers}
        for draw in ("cpu", "cuda"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = transformer.init(cfg, seed=0, device="cuda",
                                      draw_device=draw)
            torch.cuda.synchronize()
            row[f"{draw}_draw_s"] = time.perf_counter() - t0
            row["params"] = _count(params)
            del params
            torch.cuda.empty_cache()
        row["cpu_ns_per_draw"] = row["cpu_draw_s"] / row["params"] * 1e9
        print(f"init {cfg.name}, {cfg.num_layers} layers, {row['params']} "
              f"params: CPU draw {row['cpu_draw_s']:.1f}s "
              f"({row['cpu_ns_per_draw']:.2f} ns a draw), card draw "
              f"{row['cuda_draw_s']:.2f}s", flush=True)
        rows.append(row)
    print(json.dumps({"device": smi, "torch": torch.__version__,
                      "threads": torch.get_num_threads(), "init": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
