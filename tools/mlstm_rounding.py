#!/usr/bin/env python3
"""How much fp32 rounding of the mLSTM cell's inputs moves its gradients, and
whether column slices of a GEMM round as the whole GEMM does.

    python3 tools/mlstm_rounding.py [--device cuda|cpu] [--seeds N] [--batch B]

For each of N draws of xlstm-125m's mLSTM block (full width: D 768, inner
1536, 4 heads, chunk 256; matrices normal at 1/sqrt(fan-in), vectors 1 +
0.1 · normal, as ``chip_smoke.py`` draws a block) over x [B, 512, 768] and
a normal cotangent, it prints each leaf's gradient error, over the leaf's
largest entry, of

* the fp32 block against the same block evaluated in float64 (the fp32
  leaves of the block kept at 64 bits while the draw runs: its rounding
  floor), and
* the fp32 block with its cell's inputs (q, k, v and the gate logits)
  perturbed by a random half unit in the last place against the
  unperturbed one: what a different summation order of the products that
  feed the cell (a row-parallel split summed over ranks) does.

The gate bias's gradient (``if_bias``, a sum over B·T positions of the
cell's gate gradients) is the leaf these move most.  Then, on the card,
whether each rank's column slice of ``a @ w`` (plain, and the packed
[first half's block r | second half's block r] of ``w_zx`` / ``w_up``)
equals that slice of the whole product bit for bit, at M 2 and 4, fp32 and
bf16.  Prints one JSON line with all of it and, on the card, its name and
power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


@contextlib.contextmanager
def _float64():
    """The block's fp32 leaves kept at 64 bits: ``Tensor.float()`` leaves a
    float64 tensor as it is, and new tensors default to float64."""
    import torch
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else cast(self, *a, **k))
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = cast
        torch.set_default_dtype(torch.float32)


def _grads(block, x, dy, cfg) -> dict:
    import torch
    from repro_torch.models import xlstm
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in block.items()}
    xg = x.detach().clone().requires_grad_(True)
    y = xlstm.mlstm_block_apply(leaves, xg, cfg)[0]
    g = torch.autograd.grad((y * dy).sum(), [xg] + list(leaves.values()))
    return dict(zip(["dx"] + list(leaves), g))


def _err(got, want) -> float:
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def rounding(device: str, seeds: int, batch: int) -> list:
    import torch
    from repro_torch import configs
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import xlstm
    cfg = configs.get("xlstm_125m")
    shapes = tpm.param_shapes(cfg)["layers"][0]
    chunked = xlstm.mlstm_chunked
    rows = []
    for seed in range(seeds):
        gen = torch.Generator(device=device).manual_seed(seed)
        block = {}
        for name, shape in shapes.items():
            w = torch.randn(shape, generator=gen, device=device)
            block[name] = 1 + 0.1 * w if len(shape) == 1 else \
                w * shape[0] ** -0.5
        x = torch.randn(batch, 512, cfg.d_model, generator=gen,
                        device=device)
        dy = torch.randn(x.shape, generator=gen, device=device)
        g32 = _grads(block, x, dy, cfg)
        with _float64():
            g64 = _grads({k: v.double() for k, v in block.items()},
                         x.double(), dy.double(), cfg)
        noise = torch.Generator(device=device).manual_seed(1000 + seed)

        def perturbed(*inputs, **kw):
            return chunked(*(t * (1 + 2.0 ** -24 * (2 * torch.rand(
                t.shape, generator=noise, device=device) - 1))
                for t in inputs), **kw)
        xlstm.mlstm_chunked = perturbed
        try:
            gp = _grads(block, x, dy, cfg)
        finally:
            xlstm.mlstm_chunked = chunked
        rows.append({"seed": seed,
                     "fp32_vs_fp64": {k: _err(g32[k], g64[k]) for k in g32},
                     "half_ulp_inputs": {k: _err(gp[k], g32[k])
                                         for k in g32}})
        row = rows[-1]
        others = [max(v for k, v in row[what].items() if k != "if_bias")
                  for what in ("fp32_vs_fp64", "half_ulp_inputs")]
        print(f"seed {seed}: if_bias fp32 vs fp64 "
              f"{row['fp32_vs_fp64']['if_bias']:.3g}, half-ulp inputs "
              f"{row['half_ulp_inputs']['if_bias']:.3g}; the other leaves "
              f"at most {others[0]:.3g} / {others[1]:.3g}", flush=True)
    return rows


def column_slices() -> dict:
    """{GEMM: [bit-equal at M 2 plain, M 2 packed, M 4 plain, M 4
    packed]} at the training shapes of the blocks' column-parallel
    products."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, (m, k, n) in {"x @ w_up (xlstm)": (4096, 768, 3072),
                            "dy @ w_down.T (xlstm)": (4096, 768, 1536),
                            "x @ w_zx (zamba2)": (4096, 2048, 8192)}.items():
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            w = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
            whole, same = a @ w, []
            for ranks in (2, 4):
                c, h = n // ranks, n // 2
                same.append(all(torch.equal(
                    whole[:, r * c:(r + 1) * c],
                    a @ w[:, r * c:(r + 1) * c].contiguous())
                    for r in range(ranks)))
                c = h // ranks
                same.append(all(torch.equal(
                    torch.cat([whole[:, r * c:(r + 1) * c],
                               whole[:, h + r * c:h + (r + 1) * c]], 1),
                    a @ torch.cat([w[:, r * c:(r + 1) * c],
                                   w[:, h + r * c:h + (r + 1) * c]], 1))
                    for r in range(ranks)))
            out[f"{name} {str(dtype)[6:]}"] = same
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rounding": rounding(args.device, args.seeds, args.batch)}
    if args.device != "cpu":
        out["column_slices_bit_equal"] = column_slices()
        out["device"] = _smi()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
