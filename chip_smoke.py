#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one card visible::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its final line:

1. device: the card's name, and its name and power limit from nvidia-smi
   (printed again before the kernels line);
2. build: the CUDA kernels under ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a; the int8 forms build from the same sources), with the build
   time and, per kernel, ptxas's registers, spills and static shared
   memory (and the dynamic shared memory of the wgmma kernels, the
   one-token decode's split plan and dynamic shared memory at each serving
   path's shape, the fused softmax+top-k's plan at each sampling shape and
   phase 9's largest calls, and the paged prefill's grid at the serving
   chunk);
3. kernels against their plain PyTorch versions at the serving and
   training paths' shapes (fused softmax+top-k at the decode batch's
   logits, k = 1, 5 and 32, fp32 and bf16, with exact ties across the
   plan's slice edges, an all -inf slice, a padded vocabulary and a constant
   row, a repeat bit-equal and one kernel launch a call seen by the
   profiler, then 70000 rows in one CTA a row; paged decode; paged prefill
   at pages of 8, 16 and 32 over shuffled tables, with edge cases, the
   64-token chunks after long cached prefixes, Tq 65 and 130, offsets off
   the 64-key tile and a vlen ending mid-page in the second key tile, each
   dtype's form named from the kernels the profiler saw (bf16 on the tensor
   cores, fp32 on the CUDA cores); contiguous decode over ragged slots;
   contiguous cached prefill
   at the slot pool's chunks and tails, the lockstep prefill, the int8
   runs' single-shot prefills, offsets off the 64-row tile and Tq 65 and
   130, each dtype's form named from the kernels the profiler saw (bf16 on
   the tensor cores, fp32 on the CUDA cores); the fresh
   flash forward and its dq and dk/dv backward at T = 512, 37 and 1, causal
   and not, and ``FlashAttention``'s gradients against autograd through the
   plain forward, each dtype's form named from the kernels the profiler saw
   run (bf16: the wgmma kernels on the tensor cores; fp32: the CUDA-core
   kernels); the int8 forms of the paged decode, the contiguous decode
   and the paged prefill at the int8 serving run's shapes, their int8 K/V
   and bf16 scales from the port's ``_quantize_kv``; fp32 and bf16; every
   dead table entry, every cache position at or past a row's valid length
   and every K/V row past T poisoned with NaN, for the int8 forms in the
   scales, with ±127 in the payload); then the split decode's edges in its
   four forms (paged and contiguous, fp and int8 K/V), fp32 and bf16: rows
   at vlen 0, 1, every split edge ± 1 and the full M·BS or S, one row for
   every count of live splits, everything past vlen poisoned, vlen 0 giving
   exactly 0, and a second call bit-equal to the first;
4. serve: smollm-360m at full width in bf16 through its three serving paths,
   then the same three with ``--kv-cache-dtype int8``, each with the launch
   counts set to 0 just before it and read just after: ``Engine`` with the
   paged continuous-batching scheduler, ``Engine`` over the slot pool, and
   the lockstep loop; every request finishes, every token id is in the
   vocabulary, and each kernel's launch count equals what the scheduler's
   own counters (or the loop's steps) imply; the int8 runs prefill every
   prompt in one chunk and, paged, share and cache no block; the fp and
   int8 pools' bytes per cached token;
5. parity: short full-width fp32 workloads of the three paths, once on the
   card through the kernels and once on the CPU through the plain versions;
   token streams (and the paged pool's stats) must be identical; for the
   int8 paths, whose quantization can round an element one step apart
   where the two devices' fp32 K projections differ in their last bits,
   the int8 cache after the first prefill within 1 of the CPU's and its
   scales within one bf16 ulp, the first decode step's logits within
   ``INT8_LOGIT_RTOL`` of the logit scale, and the token agreement of the
   same workloads printed;
6. train: ``python -m repro_torch.launch.train`` (its ``train`` function)
   at full width in bf16, 20 steps of 8 × 512 tokens with one checkpoint at
   the end, with the launch counts set to 0 just before it and read just
   after: every loss and grad norm finite, and with remat "full" 2 forward
   launches per layer and step (the forward, then its recomputation in the
   backward) and one dq and one dk/dv launch; then a restart at 2 layers
   (6 steps checkpointed every 3, then a run to 8 that resumes at 6) whose
   parameters equal an uninterrupted 8-step run bit for bit;
7. train parity: one fp32 loss-and-gradient evaluation of the full-width
   model cut to 2 layers (batch 2 × 128) on the card through the kernels
   and on the CPU through the plain versions, from the same weights;
8. times: each kernel, first held against its plain version on the very
   inputs it is timed on (CUDA events, median of 20 samples after warm-up) at
   the serving and training paths' shapes, beside its bound, its plain
   version and, where one PyTorch call computes the same function, that
   call; the cached prefill at the slot pool's chunk, the lockstep prefill
   and an int8 single-shot prefill beside SDPA, with each call's device
   time too (events around launches queued behind a device
   sleep: the events of a small kernel's back-to-back launches time the
   host's launch path), also for rows 1-4, the int8 decodes and the int8
   paged prefill, the training kernels (and the whole backward), with the
   library call's device time beside rows 1, 4, 6 and 7 (top-k of a
   softmax, SDPA forward, SDPA's autograd backward); then
   full-width decode steps and prefill chunks of the paged pool
   and the slot pool, their int8 decode steps, and a full-width train step,
   end to end, against the device's busy time inside them (torch.profiler);
   the four online-softmax kernels at [4000, 100000] fp32 beside
   torch.softmax / torch.logsumexp, and the effective accesses per element
   (ms × 3.35 TB/s over the bytes of x) of the exact softmax, the
   normalizer, torch.softmax and torch.logsumexp at every shape of phase 9
   (back-to-back and device times), beside the paper's 3 (online), 4 (safe) and 1
   (normalizer), and both designs of the online softmax at the two V on
   either side of the row-resident limit;
9. library: the paper's online softmax through its public entry points,
   with the launch counts set to 0 just before and read just after:
   ``dispatch.online_softmax`` under each softmax form (exact, bf16, exp2)
   and ``ops.online_normalizer`` at smollm-360m's logit shapes ([8, 49152]
   fp32, [4096, 49152] bf16), the paper's regimes ([4000, V] and [10, V],
   V = 1000, 10000, 100000, fp32), V = 1001 and 4097, V on both sides of
   the row-resident limit, rows starting off a 16-byte boundary (fp32 and
   bf16) and 70000 rows, one counted launch per call; each held
   against its plain version on the CPU over up to 24 rows (m equal, d and
   y within the forms' analytic bounds, rows with -inf prefixes, tails and
   all -inf giving (-inf, 0) and y = 0); ``dispatch.softmax_topk`` over
   70000 rows against its plain version on the card; then the gradients:
   ``ops.softmax_topk``, the unflagged ``dispatch.softmax_topk`` and
   ``dispatch.online_softmax`` on a requires-grad input, each with a
   backward and its fp32 gradient against the CPU's, and
   ``dispatch.online_normalizer`` raising for such an input (it has no
   backward) rather than returning a detached result.

The line before the last is a JSON object with one entry per kernel (with
the path it was ported for); the last line is ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12,      # fp32 outside the tensor cores
            "bfloat16": 989e12}    # bf16 tensor cores, dense
KERNELS = {
    "softmax_topk": {
        "source": "src/repro_torch/kernels/csrc/softmax_topk.cu",
        "replaces": "src/repro/kernels/softmax_topk.py:100"},
    "flash_decode_paged": {
        "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
        "replaces": "src/repro/kernels/flash_decode.py:245"},
    "flash_attention_paged": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_paged.cu",
        "replaces": "src/repro/kernels/flash_attention.py:432"},
    "flash_decode": {
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:98"},
    "flash_attention_offset": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_offset.cu",
        "replaces": "src/repro/kernels/flash_attention.py:260"},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:122"},
    "flash_attention_bwd_dq": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:134"},
    "flash_attention_bwd_dkv": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:154"},
    # the int8 forms: of rows 2 and 3 (the same pallas_calls with scale
    # pages), and of the contiguous decode, where the reference ran XLA
    "flash_decode_paged_int8": {
        "source": "src/repro_torch/kernels/csrc/flash_decode_paged.cu",
        "replaces": "src/repro/kernels/flash_decode.py:245"},
    "flash_decode_int8": {
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/dispatch.py:858"},
    "flash_attention_paged_int8": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_paged.cu",
        "replaces": "src/repro/kernels/flash_attention.py:432"},
    # the library surface: Algorithm 3's two sweeps, its normalizer, and
    # kernel forms of the bf16 and exp2 softmax forms (XLA in the reference)
    "online_softmax": {
        "source": "src/repro_torch/kernels/csrc/online_softmax.cu",
        "replaces": "src/repro/kernels/online_softmax.py:66,77"},
    "online_normalizer": {
        "source": "src/repro_torch/kernels/csrc/online_softmax.cu",
        "replaces": "src/repro/kernels/online_softmax.py:99"},
    "online_softmax_bf16": {
        "source": "src/repro_torch/kernels/csrc/online_softmax.cu",
        "replaces": "src/repro/kernels/dispatch.py:514"},
    "online_softmax_exp2": {
        "source": "src/repro_torch/kernels/csrc/online_softmax.cu",
        "replaces": "src/repro/kernels/dispatch.py:520"},
}
# the serving runs of phase 4 (the CLI's own flags); each kernel's
# "launches" comes from the run of the path it was ported for
SERVE_ARGS = ["--continuous", "--paged", "--requests", "16", "--slots", "8",
              "--prompt-len", "256", "--tokens", "64", "--block-size", "16",
              "--prefill-chunk", "64", "--shared-prefix", "16"]
SLOT_ARGS = ["--continuous", "--requests", "16", "--slots", "8",
             "--prompt-len", "256", "--tokens", "64", "--prefill-chunk", "64"]
LOCKSTEP_ARGS = ["--batch", "4", "--prompt-len", "256", "--tokens", "32"]
INT8 = ["--kv-cache-dtype", "int8"]
PARITY_ARGS = ["--continuous", "--paged", "--requests", "3", "--slots", "3",
               "--prompt-len", "40", "--tokens", "16", "--block-size", "16",
               "--prefill-chunk", "32", "--shared-prefix", "16"]
SLOT_PARITY_ARGS = ["--continuous", "--requests", "3", "--slots", "2",
                    "--prompt-len", "40", "--tokens", "12", "--prefill-chunk",
                    "16"]
LOCKSTEP_PARITY_ARGS = ["--batch", "2", "--prompt-len", "37", "--tokens", "8"]
# the training run of phase 6 (the CLI's own flags), its 2-layer restart
# runs, and the fp32 parity batch of phase 7
TRAIN_ARGS = ["--arch", "smollm_360m", "--steps", "20", "--seq-len", "512",
              "--global-batch", "8", "--checkpoint-every", "20"]
RESTART_ARGS = ["--arch", "smollm_360m", "--layers", "2", "--seq-len", "512",
                "--global-batch", "8"]
TRAIN_PARITY = dict(layers=2, batch=2, seq_len=128)
KERNEL_PATH = {"softmax_topk": "paged", "flash_decode_paged": "paged",
               "flash_attention_paged": "paged", "flash_decode": "slot pool",
               "flash_attention_offset": "slot pool",
               "flash_attention": "train", "flash_attention_bwd_dq": "train",
               "flash_attention_bwd_dkv": "train",
               "flash_decode_paged_int8": "paged int8",
               "flash_decode_int8": "slot pool int8",
               "flash_attention_paged_int8": "kernel check only",
               "online_softmax": "library", "online_normalizer": "library",
               "online_softmax_bf16": "library",
               "online_softmax_exp2": "library"}
# phase 9's shapes (R, V, dtype, start): smollm-360m's logits at a decode
# step and for one 8 x 512 train batch, the paper's two regimes (batch 4000
# and batch 10) at V = 1000, 10000 and 100000, V = 1001 and 4097 (rows that
# are no multiple of a 16-byte vector), V on both sides of the row-resident
# limit (osk.RESIDENT_ROW_BYTES: 57344 fp32 entries is the last row held on
# chip), rows whose start lies `start` entries past a 16-byte boundary, and
# 70000 rows (more than grid.y's 65535); the timed rows of phase 8 are
# 4000 x 100000 fp32
LIBRARY_SHAPES = ((8, 49152, "float32", 0), (4096, 49152, "bfloat16", 0),
                  (4000, 1000, "float32", 0), (4000, 10000, "float32", 0),
                  (4000, 100000, "float32", 0), (10, 1000, "float32", 0),
                  (10, 10000, "float32", 0), (10, 100000, "float32", 0),
                  (4000, 1001, "float32", 0), (4000, 4097, "float32", 0),
                  (1000, 57344, "float32", 0), (1000, 57345, "float32", 0),
                  (4000, 1001, "float32", 1), (4096, 1001, "bfloat16", 1),
                  (70000, 1000, "float32", 0))
LIBRARY_TIMED = (4000, 100000, "float32")
# the rows each side of the row-resident limit, timed in both designs
LIBRARY_LIMIT = ((1000, 57344, "float32"), (1000, 57345, "float32"))
# dispatch.softmax_topk over more rows than grid.y holds
TOPK_ROWS = (70000, 1000)
LIBRARY_CPU_ROWS = 24     # rows of each input held against the CPU
# the library's fp32 gradients (ops.softmax_topk, the unflagged
# dispatch.softmax_topk, dispatch.online_softmax), card vs CPU: within 1e-4
# of the largest entry.  The online softmax's is y·(g − Σ g·y) from the
# kernel's y, which agrees with the CPU's to a few fp32 ulps.  The top-k's
# gradient is s·(dlse − Σ dval·val) + dval·val at the top k, s =
# exp(x − lse); the kernel's lse agrees with the CPU's to ~1e-6 relative (row
# 1's rtol 1e-5 gate), which moves s by ~|lse|·1e-6 ≈ 1e-5 relative, and
# the two devices round exp and the sums apart by a few ulps.
TOPK_GRAD_RTOL = 1e-4
# int8 parity gate: the first decode step's max |logit difference| between
# the card and the CPU over the logit scale (max |logit|), fp32 weights.  A
# K/V element one int8 step apart moves its attention score by ~|q| max|k|
# / 127 in one layer; a wrong scale address or a dropped scale moves the
# logits by O(1) of their scale.
INT8_LOGIT_RTOL = 1e-2


def _fail(msg: str) -> None:
    raise AssertionError(msg)


def _ms(fn, samples: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``samples`` of the CUDA-event time of ``inner``
    back-to-back calls, divided by ``inner``, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


# ---------------------------------------------------------------------------
# 1-2: device and build
# ---------------------------------------------------------------------------
def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def phase_device() -> dict:
    import torch
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    print(f"nvidia-smi: {_smi()}")
    return {"platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    print(f"build: {len(built)} of {len(build.SOURCES)} kernel libraries "
          f"compiled in {time.perf_counter() - t0:.2f}s "
          f"({build.build_dir()})")
    for name, log in build.BUILD_LOG.items():
        for kernel, info in _ptxas_report(log).items():
            extra = ""
            if kernel in WGMMA_SMEM:
                fn = getattr(build.library(name), WGMMA_SMEM[kernel])
                extra = f", {fn()} bytes dynamic smem (wgmma form)"
            print(f"  ptxas {name} {kernel}: {info['registers']} registers, "
                  f"{info['smem']} bytes static smem, spill stores "
                  f"{info['spill_stores']} / loads {info['spill_loads']} "
                  f"bytes{extra}")
    _print_decode_plans()
    _print_topk_plans()
    _print_paged_prefill_grid()


# the one-token decode's plans at the serving paths' shapes: (what, B, M·BS
# or S, page, K/V dtype); 5 KV heads of 3 query heads, D 64
DECODE_PLANS = (("paged, bf16 pool", 8, 21 * 16, 16, "bfloat16"),
                ("paged, int8 pool", 8, 21 * 16, 16, "int8"),
                ("slot pool, bf16 caches", 8, 328, 16, "bfloat16"),
                ("slot pool, int8 caches", 8, 328, 16, "int8"),
                ("lockstep, bf16 caches", 4, 288, 16, "bfloat16"))


def _print_decode_plans() -> None:
    """The split decode kernels' dynamic shared memory depends on the
    split the wrapper plans: print the plan at each serving path's shape."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    sms = build.sm_count(torch.device("cuda"))
    for what, b, max_len, page, dtype in DECODE_PLANS:
        p = fd.decode_plan(b, 5, 3, 64, max_len, page, getattr(torch, dtype),
                           sms)
        print(f"  decode plan {what} [B={b}, {max_len} positions, {sms} "
              f"SMs]: split {p.split} x {p.splits} ({b * 5 * p.splits} "
              f"CTAs of {p.threads} threads), {p.smem} bytes dynamic smem a "
              f"split CTA, {4 * p.workspace} bytes of partials")


# the fused softmax+top-k's plans: (what, R, V, k, logits dtype): the
# serving paths' sampling (fp32 logits over smollm-360m's 49152 entries: the
# decode batch of 8 slots, the lockstep's 4, one prompt's first token) and
# the library's largest calls of phase 9
TOPK_PLANS = (("decode sampling, 8 slots", 8, 49152, 5, "float32"),
              ("lockstep sampling, batch 4", 4, 49152, 5, "float32"),
              ("first token of a prefill", 1, 49152, 5, "float32"),
              ("library, bf16 logits", 4096, 49152, 5, "bfloat16"),
              ("library, 70000 rows", 70000, 1000, 5, "float32"))


def _print_topk_plans() -> None:
    """The fused softmax+top-k's split at each sampling shape: slices a
    row, CTAs, threads and the merging CTA's dynamic shared memory."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import softmax_topk as st
    sms = build.sm_count(torch.device("cuda"))
    for what, r, v, k, dtype in TOPK_PLANS:
        p = st.plan(r, v, k, getattr(torch, dtype), sms)
        print(f"  softmax_topk plan {what} [{r}, {v}] {dtype} k={k}, {sms} "
              f"SMs: {p.slices} slices of {p.slice} ({r * p.slices} CTAs of "
              f"{p.threads} threads), {p.smem} bytes dynamic smem"
              + (" (one CTA a row: no merge)" if p.slices == 1 else ""))


def _print_paged_prefill_grid() -> None:
    """The paged prefill's grid at the serving run's chunk (B 1, Tq 64, 15
    query heads): bf16 one warpgroup a 64-row query tile and head, fp32 one
    CTA a 16-row tile and head."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    b, tq, hq = 1, 64, 15
    smem = build.library("flash_attention_paged") \
        .flash_attention_paged_wgmma_smem()
    print(f"  paged prefill grid [B={b}, Tq={tq}, Hq={hq}]: bf16 "
          f"{-(-tq // 64) * b * hq} CTAs of 128 threads (paged_wgmma_kernel, "
          f"{smem} bytes dynamic smem), fp32 {-(-tq // fa.BQ) * b * hq} CTAs "
          "of 128 threads (prefill_paged_kernel)")


# the tensor-core kernels and the C function giving each one's dynamic
# shared memory (in the library of its source)
WGMMA_SMEM = {"fresh_fwd_wgmma_kernel": "flash_attention_fwd_wgmma_smem",
              "offset_wgmma_kernel": "flash_attention_offset_wgmma_smem",
              "paged_wgmma_kernel": "flash_attention_paged_wgmma_smem",
              "bwd_dq_wgmma_kernel": "flash_attention_bwd_dq_wgmma_smem",
              "bwd_dkv_wgmma_kernel": "flash_attention_bwd_dkv_wgmma_smem"}


def _ptxas_report(log: str) -> dict:
    """ptxas -v's report per kernel of one source: {kernel symbol:
    {registers, smem, spill_stores, spill_loads}}, the symbol being the
    longest name of PORT_KERNEL_SYMBOLS inside the mangled entry name, with
    a template instance's arguments (dtype, form, flags) after it."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
            found = [s for s in PORT_KERNEL_SYMBOLS if s in name]
            cur = max(found, key=len) if found else name
            tail = name.split(cur, 1)[1] if found else ""
            if tail.startswith("I"):  # a template's arguments, mangled
                args = re.findall(r"__nv_bfloat16|Form\w+?E|L[bi]\d+E|^If",
                                  tail.split("Ev", 1)[0])
                words = [{"If": "f32", "__nv_bfloat16": "bf16"}.get(
                    a, a[:-1].lstrip("L").lstrip("bi") if a[0] == "L"
                    else a[:-1]) for a in args]
                if words:
                    cur += "<" + ",".join(words) + ">"
            out[cur] = {"registers": 0, "smem": 0, "spill_stores": 0,
                        "spill_loads": 0}
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out[cur]["spill_stores"] = int(spill.group(1))
            out[cur]["spill_loads"] = int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[cur]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(smem.group(1)) if smem else 0
    return out


# ---------------------------------------------------------------------------
# 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def _paged_inputs(gen, *, dtype, bs, vlens, hkv=5, g=3, d=64, tq=1,
                  share=True):
    """Random pools [P, Hkv, BS, D] and tables for rows of valid lengths
    ``vlens``.  Block 0 is the sentinel; block 1 is filled with NaN and every
    dead table entry of the kernel's table points at it (the plain version's
    table points dead entries at the sentinel), so a kernel that reads a dead
    entry turns its output NaN.  Rows 0 and 1 share their first pages."""
    import torch
    b = len(vlens)
    live = [max(1, -(-v // bs)) for v in vlens]
    m = max(live) + 1
    n_fresh = sum(live)
    p = 2 + n_fresh
    k_pool = torch.randn(p, hkv, bs, d, generator=gen)
    v_pool = torch.randn(p, hkv, bs, d, generator=gen)
    k_pool[1] = float("nan")
    v_pool[1] = float("nan")
    perm = (torch.randperm(n_fresh, generator=gen) + 2).tolist()
    t_kernel = torch.ones((b, m), dtype=torch.int32)
    t_plain = torch.zeros((b, m), dtype=torch.int32)
    for row, n in enumerate(live):
        for j in range(n):
            t_kernel[row, j] = t_plain[row, j] = perm.pop()
        if vlens[row] <= 1 and row == b - 1:       # an idle row: sentinel
            t_kernel[row, 0] = t_plain[row, 0] = 0
    if share and b > 1:
        n_shared = min(live[0], live[1]) - 1
        t_kernel[1, :n_shared] = t_kernel[0, :n_shared]
        t_plain[1, :n_shared] = t_plain[0, :n_shared]
    q = torch.randn(b, tq, hkv * g, d, generator=gen)
    dev = dict(device="cuda", dtype=dtype)
    return (q.to(**dev), k_pool.to(**dev), v_pool.to(**dev),
            t_kernel.cuda(), t_plain.cuda(),
            torch.tensor(vlens, dtype=torch.int32, device="cuda"))


def _launch_counts(prof) -> dict:
    """Launches of each of the port's kernel symbols among a profile's
    device events."""
    counts = {}
    for evt in prof.key_averages():
        found = [sym for sym in PORT_KERNEL_SYMBOLS if sym in evt.key]
        if found and str(evt.device_type).endswith("CUDA"):
            sym = max(found, key=len)
            counts[sym] = counts.get(sym, 0) + evt.count
    return counts


def _topk_input(gen, r, v, slice_len):
    """x [r, v] fp32 (on the host) with the sampler's hard cases at the
    plan's slice edges: row 1 five exact ties at the top, two straddling
    each of the first two slice edges; row 2 a padded vocabulary (-inf past
    40000); row 3 constant (ties across every edge); row 4 its second slice
    all -inf, row 5 its first.  Returns (x, row 1's tied indices)."""
    import torch
    x = torch.randn(r, v, generator=gen) * 4.0
    ties = sorted({17, slice_len - 1, slice_len, 2 * slice_len - 1,
                   2 * slice_len})
    x[1, ties] = float(x[1].max()) + 1.0
    x[2, 40000:] = float("-inf")
    x[3, :] = x[3, 0]
    x[4, slice_len:2 * slice_len] = float("-inf")
    x[5, :slice_len] = float("-inf")
    return x, ties


def _check_softmax_topk(gen) -> float:
    """The fused softmax+top-k against its plain version at the decode
    batch's logits [8, 49152] (``_topk_input``: ties straddling the plan's
    slice edges, an all -inf slice, a padded vocabulary, a constant row) at
    k = 1, 5 and 32, fp32 and bf16: indices equal, values and lse within
    rtol 1e-5 (bf16 values within one bf16 ulp, rtol 2^-7), row 1's ties in
    index order, a second call bit-equal to the first, and the profiler
    seeing one launch of ``softmax_topk_kernel`` a call and no other port
    kernel; then [70000, 1000] fp32, whose plan is one CTA a row (S = 1).
    Returns the fp32 k = 5 max abs error (values and lse)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels import softmax_topk as st
    sms = build.sm_count(torch.device("cuda"))
    r, v, worst = 8, 49152, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 5, 32):
            p = st.plan(r, v, k, dtype, sms)
            x, ties = _topk_input(gen, r, v, p.slice)
            x = x.to(device="cuda", dtype=dtype)
            what = (f"softmax_topk [{r}, {v}] {str(dtype)[6:]} k={k} "
                    f"({p.slices} slices of {p.slice})")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = st.softmax_topk(x, k)
                torch.cuda.synchronize()
            seen = _launch_counts(prof)
            if seen != {"softmax_topk_kernel": 1}:
                _fail(f"{what}: the profiler saw {seen}, not one launch of "
                      "softmax_topk_kernel")
            again = st.softmax_topk(x, k)
            want = st.softmax_topk_plain(x, k)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
                _fail(f"{what}: two calls on the same input differ")
            if not torch.equal(got.indices.long(), want.indices):
                _fail(f"{what}: indices differ:\n{got.indices}\n"
                      f"{want.indices}")
            if got.indices[1].tolist()[:min(k, 5)] != ties[:min(k, 5)]:
                _fail(f"{what}: tie order {got.indices[1].tolist()}, want "
                      f"{ties}")
            vrtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            for a, b_, name, rtol in (
                    (got.values, want.values, "values", vrtol),
                    (got.logsumexp, want.logsumexp, "lse", 1e-5)):
                if not torch.allclose(a.float(), b_.float(), rtol=rtol,
                                      atol=0.0):
                    _fail(f"{what}: {name} beyond rtol {rtol:.3g}: max abs "
                          f"{(a.float() - b_.float()).abs().max().item():.3g}")
            err = max((got.values.float() - want.values.float()).abs().max()
                      .item(), (got.logsumexp - want.logsumexp).abs().max()
                      .item())
            if dtype == torch.float32 and k == 5:
                worst = err
            print(f"kernel {what}: indices equal (ties across slice edges "
                  f"in index order, an all -inf slice, -inf padding, a "
                  f"constant row), max abs err {err:.3g} (values rtol "
                  f"{vrtol:.3g}, lse 1e-5); one softmax_topk_kernel launch "
                  "seen by the profiler; a repeat bit-equal")
    rows, v = TOPK_ROWS
    p = st.plan(rows, v, 5, torch.float32, sms)
    if p.slices != 1:
        _fail(f"softmax_topk plan at [{rows}, {v}]: {p.slices} slices, not "
              "one CTA a row")
    x = torch.randn(rows, v, generator=gen).cuda() * 4.0
    got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    torch.cuda.synchronize()
    if not torch.equal(got.indices.long(), want.indices) or not \
            torch.allclose(got.logsumexp, want.logsumexp, rtol=1e-5, atol=0):
        _fail(f"softmax_topk [{rows}, {v}]: differs from its plain version")
    print(f"kernel softmax_topk [{rows}, {v}] float32 k=5 (one CTA a row): "
          "indices equal, lse within rtol 1e-5")
    return worst


def _check_decode(gen) -> float:
    import torch
    from repro_torch.kernels import flash_decode as fd
    worst = 0.0
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for bs in (8, 16):
            vlens = [300, 177, 1, 64, 33, 250, 9, 1]     # ragged; idle last
            q, kp, vp, tk, tp, vl = _paged_inputs(gen, dtype=dtype, bs=bs,
                                                  vlens=vlens)
            got = fd.flash_decode_paged(q, kp, vp, tk, vl)
            torch.cuda.synchronize()
            want = fd.flash_decode_paged_plain(q, kp, vp, tp, vl)
            if not torch.isfinite(got).all():
                _fail(f"flash_decode_paged {dtype} BS={bs}: non-finite "
                      "output (a dead table entry was read)")
            err = (got.float() - want.float()).abs().max().item()
            if err > atol:
                _fail(f"flash_decode_paged {dtype} BS={bs}: max abs err "
                      f"{err:.3g} > {atol}")
            if dtype == torch.float32:
                worst = max(worst, err)
            print(f"kernel flash_decode_paged {str(dtype)[6:]} BS={bs} B=8 "
                  f"G=3 D=64: max abs err {err:.3g} (atol {atol})")
    return worst


def _prefill_err(q, kp, vp, qo, vl, tk, tp, what: str, atol: float,
                 plain_pools=None):
    """Kernel against plain on one prefill input (the plain version on
    ``plain_pools`` when given: the kernel's pools with their poisoned
    tails zeroed); raises beyond ``atol`` or when the -inf pattern of lse
    differs.  Returns (max abs error, the kernel's lse)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    out, lse = fa.flash_attention_paged(q, kp, vp, qo, vl, tk)
    torch.cuda.synchronize()
    w_out, w_lse = fa.flash_attention_paged_plain(
        q, *(plain_pools or (kp, vp)), qo, vl, tp)
    if not torch.isfinite(out).all():
        _fail(f"flash_attention_paged {what}: non-finite output (a dead "
              "table entry was read)")
    if not torch.equal(torch.isneginf(lse), torch.isneginf(w_lse)):
        _fail(f"flash_attention_paged {what}: lse -inf pattern differs")
    fin = torch.isfinite(w_lse)
    err = max((out.float() - w_out.float()).abs().max().item(),
              (lse[fin] - w_lse[fin]).abs().max().item())
    if err > atol:
        _fail(f"flash_attention_paged {what}: max abs err {err:.3g} > {atol}")
    return err, lse


# (Tq, q_offset per row, vlen per row): edge cases (chunks crossing block
# edges, a row with no valid key), the serving run's 64-token chunks after
# cached prefixes (phase 4 reaches q_offset ~200, vlen ~270), then the
# tensor-core tile's edges: Tq 65 and 130 (a 64-row query tile and one more
# row, two and two more), q_offsets off the 64-key tile (37, 100), and a
# vlen ending mid-page inside the second key tile (100)
PREFILL_CASES = (
    (37, [0, 5, 13, 0], [37, 42, 50, 0]),
    (64, [64], [128]),
    (64, [192], [256]),
    (65, [37, 100], [102, 165]),
    (130, [3, 150], [133, 280]),
    (36, [64], [100]),
)
# each dtype's form of the paged prefill, as the profiler names its kernel
PREFILL_FORMS = {"float32": ("CUDA cores", "prefill_paged_kernel"),
                 "bfloat16": ("tensor cores (wgmma)", "paged_wgmma_kernel")}


def _check_prefill(gen) -> float:
    """Every case of ``PREFILL_CASES`` at BS 8, 16 and 32, fp32 (atol 1e-5)
    and bf16 (atol 2e-2), over shuffled (non-monotonic) tables with every
    dead entry pointing at a NaN page and every position past a row's vlen
    in its last live page NaN; under torch.profiler, which must see that
    dtype's form (``PREFILL_FORMS``) and no other port kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    worst = 0.0
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        form, symbol = PREFILL_FORMS[str(dtype)[6:]]
        errs = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for bs in (8, 16, 32):
                for tq, qoff, vlens in PREFILL_CASES:
                    q, kp, vp, tk, tp, vl = _paged_inputs(
                        gen, dtype=dtype, bs=bs, vlens=vlens, tq=tq)
                    (kk, kpl), (vk, vpl) = (_poisoned_tails(x, tk, vlens, bs)
                                            for x in (kp, vp))
                    qo = torch.tensor(qoff, dtype=torch.int32, device="cuda")
                    what = (f"{str(dtype)[6:]} BS={bs} B={len(vlens)} "
                            f"Tq={tq} q_offset={qoff} vlen={vlens}")
                    err, lse = _prefill_err(q, kk, vk, qo, vl, tk, tp, what,
                                            atol, plain_pools=(kpl, vpl))
                    if 0 in vlens and not torch.isneginf(
                            lse[vlens.index(0)]).all():
                        _fail(f"flash_attention_paged {what}: lse of the "
                              "keyless row is not -inf")
                    errs.append(err)
            torch.cuda.synchronize()
        seen = _kernels_seen(prof)
        if seen != [symbol]:
            _fail(f"flash_attention_paged {str(dtype)[6:]}: the profiler saw "
                  f"{seen}, the {form} form is {symbol}")
        if dtype == torch.float32:
            worst = max(errs)
        print(f"kernel flash_attention_paged {str(dtype)[6:]} ({form}, "
              f"{symbol}): {len(errs)} cases (BS 8/16/32; Tq 37/64/65/130/36 "
              f"at q_offset 0..192, off the 64-key tile, a keyless row, a "
              f"vlen ending mid-page in the second key tile; shuffled "
              f"tables, dead entries and positions past vlen NaN): max abs "
              f"err {max(errs):.3g} (atol {atol})")
    return worst


def _contiguous_inputs(gen, *, dtype, s, vlens, tq=1, hkv=5, g=3, d=64):
    """q [B, Tq, Hq, D] and caches [B, S, Hkv, D] in the model layout.
    Returns (q, k, v for the kernel, with every position at or past a row's
    valid length NaN, so a kernel that reads one turns its output NaN; k, v
    for the plain version, those positions zeroed), all on the card."""
    import torch
    b = len(vlens)
    q = torch.randn(b, tq, hkv * g, d, generator=gen)
    k = torch.randn(b, s, hkv, d, generator=gen)
    v = torch.randn(b, s, hkv, d, generator=gen)
    dead = (torch.arange(s)[None, :] >= torch.tensor(vlens)[:, None])[
        ..., None, None]
    dev = dict(device="cuda", dtype=dtype)
    return (q.to(**dev),
            k.masked_fill(dead, float("nan")).to(**dev),
            v.masked_fill(dead, float("nan")).to(**dev),
            k.masked_fill(dead, 0.0).to(**dev),
            v.masked_fill(dead, 0.0).to(**dev))


def _check_contiguous_decode(gen) -> float:
    import torch
    from repro_torch.kernels import flash_decode as fd
    worst = 0.0
    # the slot pool's decode batch: 8 slots of 328, ragged; idle row last
    vlens = [328, 290, 177, 64, 33, 250, 9, 1]
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v, k0, v0 = _contiguous_inputs(gen, dtype=dtype, s=328,
                                             vlens=vlens)
        vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
        got = fd.flash_decode(q, k, v, vl)
        torch.cuda.synchronize()
        want = fd.flash_decode_plain(q, k0, v0, vl)
        if not torch.isfinite(got).all():
            _fail(f"flash_decode {dtype}: non-finite output (a position at "
                  "or past vlen was read)")
        err = (got.float() - want.float()).abs().max().item()
        if err > atol:
            _fail(f"flash_decode {dtype}: max abs err {err:.3g} > {atol}")
        if dtype == torch.float32:
            worst = max(worst, err)
        print(f"kernel flash_decode {str(dtype)[6:]} B=8 S=328 G=3 D=64 "
              f"vlen {vlens}: max abs err {err:.3g} (atol {atol})")
    return worst


def _offset_err(inputs, qo, vl, what: str, atol: float):
    """The contiguous prefill kernel against its plain version on one
    input; raises beyond ``atol``, on non-finite output or when the -inf
    pattern of lse differs.  Returns (max abs error, the kernel's lse)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    q, k, v, k0, v0 = inputs
    out, lse = fa.flash_attention_offset(q, k, v, qo, vl)
    torch.cuda.synchronize()
    w_out, w_lse = fa.flash_attention_offset_plain(q, k0, v0, qo, vl)
    if not torch.isfinite(out).all():
        _fail(f"flash_attention_offset {what}: non-finite output (a "
              "position at or past vlen was read)")
    if not torch.equal(torch.isneginf(lse), torch.isneginf(w_lse)):
        _fail(f"flash_attention_offset {what}: lse -inf pattern differs")
    fin = torch.isfinite(w_lse)
    err = max((out.float() - w_out.float()).abs().max().item(),
              (lse[fin] - w_lse[fin]).abs().max().item())
    if err > atol:
        _fail(f"flash_attention_offset {what}: max abs err {err:.3g} > "
              f"{atol}")
    return err, lse


def _offset_cases():
    """(Tk, Tq, q_offset per row, vlen per row): the slot pool's 64-token
    chunks of a 256-token prompt into a slot of 328, the power-of-two tails
    ``prefill_schedule`` gives a 63-token remainder, a B = 3 case with a
    keyless row and Tq = 37 (not a multiple of the 16-row tile), the
    lockstep prefill (B = 4, Tq = 256 at offset 0 into caches of 288), the
    int8 runs' single-shot prefills (B = 1, Tq = Tk = 80 and 272), offsets
    off the 64-row tile, and Tq = 65 and 130 (a 64-row tile and one more
    row, two and two more)."""
    cases = [(328, 64, [off], [off + 64]) for off in (0, 64, 192)]
    off = 256
    for w in (32, 16, 8, 4, 2, 1):
        cases.append((328, w, [off], [off + w]))
        off += w
    cases.append((64, 37, [0, 5, 13], [37, 42, 0]))
    cases.append((288, 256, [0] * 4, [256] * 4))
    cases += [(80, 80, [0], [80]), (272, 272, [0], [272]),
              (328, 64, [100], [164]), (300, 65, [37, 100], [102, 165]),
              (300, 130, [3, 150], [133, 280])]
    return cases


# each dtype's form of the cached prefill, as the profiler names its kernel
OFFSET_FORMS = {"float32": ("CUDA cores", "prefill_offset_kernel"),
                "bfloat16": ("tensor cores (wgmma)", "offset_wgmma_kernel")}


def _check_offset(gen) -> float:
    """Every case of ``_offset_cases`` in fp32 (atol 1e-5) and bf16 (atol
    2e-2), K/V NaN at and past each row's valid length, under
    torch.profiler, which must see that dtype's form (``OFFSET_FORMS``) and
    no other port kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    worst = 0.0
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        errs = []
        form, symbol = OFFSET_FORMS[str(dtype)[6:]]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for tk, tq, qoff, vlens in _offset_cases():
                inputs = _contiguous_inputs(gen, dtype=dtype, s=tk,
                                            vlens=vlens, tq=tq)
                qo = torch.tensor(qoff, dtype=torch.int32, device="cuda")
                vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
                what = (f"{str(dtype)[6:]} B={len(vlens)} Tk={tk} Tq={tq} "
                        f"q_offset={qoff} vlen={vlens}")
                err, lse = _offset_err(inputs, qo, vl, what, atol)
                if 0 in vlens and not torch.isneginf(
                        lse[vlens.index(0)]).all():
                    _fail(f"flash_attention_offset {what}: lse of the "
                          "keyless row is not -inf")
                errs.append(err)
            torch.cuda.synchronize()
        seen = _kernels_seen(prof)
        if seen != [symbol]:
            _fail(f"flash_attention_offset {str(dtype)[6:]}: the profiler "
                  f"saw {seen}, the {form} form is {symbol}")
        if dtype == torch.float32:
            worst = max(errs)
        print(f"kernel flash_attention_offset {str(dtype)[6:]} ({form}, "
              f"{symbol}): {len(errs)} cases (64-token chunks at q_offset "
              f"0/64/192, tails 32..1, B=3 Tq=37 with a keyless row, "
              f"lockstep B=4 Tq=256, single-shot Tq=Tk=80/272, q_offset "
              f"100/37/150/3, Tq=65/130; K/V NaN past vlen): max abs err "
              f"{max(errs):.3g} (atol {atol})")
    return worst


def _fresh_inputs(gen, *, dtype, b, t, hkv=5, g=3, d=64, spare=16):
    """q, dout [B, T, Hq, D] and k, v [B, T, Hkv, D] on the card, k and v
    cut from buffers of T + ``spare`` positions whose rows past T are NaN
    (so they are strided views, and a kernel that reads past T turns its
    output NaN)."""
    import torch
    q = torch.randn(b, t, hkv * g, d, generator=gen)
    dout = torch.randn(b, t, hkv * g, d, generator=gen)
    kv = torch.randn(2, b, t + spare, hkv, d, generator=gen)
    kv[:, :, t:] = float("nan")
    kv = kv.to(device="cuda", dtype=dtype)
    return (q.to(device="cuda", dtype=dtype), kv[0, :, :t], kv[1, :, :t],
            dout.to(device="cuda", dtype=dtype))


def _scaled_err(got, want) -> float:
    """Max abs error over the larger of 1 and the reference's largest
    entry (gradients sum over up to T keys or queries)."""
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


def _fresh_errs(q, k, v, dout, causal: bool) -> dict:
    """The fresh forward and the two backward kernels against their plain
    versions on one input: {name: scaled max abs error}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal)
    torch.cuda.synchronize()
    k0, v0 = torch.nan_to_num(k), torch.nan_to_num(v)
    w_out, w_lse = fa.flash_attention_fwd_plain(q, k0, v0, causal=causal)
    w_dq, w_dk, w_dv = fab.flash_attention_bwd_plain(q, k0, v0, out, lse,
                                                     dout, causal=causal)
    for name, x in (("out", out), ("lse", lse), ("dq", dq), ("dk", dk),
                    ("dv", dv)):
        if not torch.isfinite(x).all():
            _fail(f"fresh attention {name}: non-finite values (a K/V row "
                  "past T was read)")
    return {"flash_attention": max(_scaled_err(out, w_out),
                                   (lse - w_lse).abs().max().item()),
            "flash_attention_bwd_dq": _scaled_err(dq, w_dq),
            "flash_attention_bwd_dkv": max(_scaled_err(dk, w_dk),
                                           _scaled_err(dv, w_dv))}


# each dtype's form of the three training kernels: what it runs on, and the
# kernel symbols the profiler must see (and no other port kernel)
FRESH_FORMS = {"float32": ("CUDA cores", ("fresh_fwd_kernel", "bwd_dq_kernel",
                                          "bwd_dkv_kernel")),
               "bfloat16": ("tensor cores (wgmma)",
                            ("fresh_fwd_wgmma_kernel", "bwd_dq_wgmma_kernel",
                             "bwd_dkv_wgmma_kernel"))}


def _kernels_seen(prof) -> list:
    """The port's kernel symbols among a profile's device events."""
    return sorted(_launch_counts(prof))


def _check_fresh(gen) -> dict:
    """The training kernels at T = 512 (the training run's), 37 (not a
    multiple of the 16- or 64-row tile) and 1, causal and not, B = 2, 15/5
    heads, D = 64; then ``FlashAttention``'s dq, dk, dv against autograd
    through the plain forward.  The first case of each dtype runs under
    torch.profiler, which must see that dtype's form (``FRESH_FORMS``) and
    no other port kernel.  Errors are max abs over max(1, the largest
    reference entry); fp32 within 1e-5, bf16 within 2e-2.  Returns the bf16
    errors: the training path runs bf16."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa
    worst = dict.fromkeys(("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"), 0.0)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        errs = dict.fromkeys(worst, 0.0)
        form, symbols = FRESH_FORMS[str(dtype)[6:]]
        seen = None
        for t in (512, 37, 1):
            for causal in (True, False):
                inputs = _fresh_inputs(gen, dtype=dtype, b=2, t=t)
                if seen is None:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        case = _fresh_errs(*inputs, causal)
                    seen = _kernels_seen(prof)
                    if seen != sorted(symbols):
                        _fail(f"fresh attention {str(dtype)[6:]}: the "
                              f"profiler saw {seen}, the {form} form is "
                              f"{sorted(symbols)}")
                else:
                    case = _fresh_errs(*inputs, causal)
                for name, err in case.items():
                    if err > atol:
                        _fail(f"{name} {str(dtype)[6:]} T={t} causal="
                              f"{causal}: scaled max abs err {err:.3g} > "
                              f"{atol}")
                    errs[name] = max(errs[name], err)
        q, k, v, dout = _fresh_inputs(gen, dtype=dtype, b=2, t=37)
        k, v = torch.nan_to_num(k), torch.nan_to_num(v)
        grads = []
        for fn in (lambda a, b_, c: fa.FlashAttention.apply(a, b_, c, True),
                   lambda a, b_, c: fa.flash_attention_fwd_plain(
                       a, b_, c, causal=True)[0]):
            args = [x.detach().clone().requires_grad_(True)
                    for x in (q, k, v)]
            fn(*args).backward(dout)
            grads.append([a.grad for a in args])
        torch.cuda.synchronize()
        auto = max(_scaled_err(a, b_) for a, b_ in zip(*grads))
        if auto > atol:
            _fail(f"FlashAttention {str(dtype)[6:]}: gradients differ from "
                  f"autograd through the plain forward by {auto:.3g}")
        print(f"kernel fresh attention {str(dtype)[6:]} on the {form} "
              f"({', '.join(seen)} seen by the profiler) B=2 Hq=15 Hkv=5 D=64"
              f" T=512/37/1 causal and not, K/V NaN past T: scaled max abs "
              f"err forward {errs['flash_attention']:.3g}, dq "
              f"{errs['flash_attention_bwd_dq']:.3g}, dk/dv "
              f"{errs['flash_attention_bwd_dkv']:.3g}; FlashAttention "
              f"gradients against autograd through the plain forward "
              f"{auto:.3g} (atol {atol})")
        if dtype == torch.bfloat16:
            worst = errs
    return worst


def _layer_view(x):
    """``x`` as layer 1 of a two-layer buffer whose layer 0 is poison (NaN,
    or 127 for int8): the per-layer view ``caches[name][i]`` the serving
    path passes."""
    import torch
    poison = float("nan") if x.is_floating_point() else 127
    buf = torch.full((2,) + tuple(x.shape), poison, dtype=x.dtype,
                     device=x.device)
    buf[1] = x
    return buf[1]


def _int8_paged_inputs(gen, *, dtype, bs, vlens, tq=1, hkv=5, g=3, d=64):
    """int8 pools [P, Hkv, BS, D] and bf16 scale pages [P, Hkv, BS] from the
    port's ``_quantize_kv`` of random K/V, for rows of valid lengths
    ``vlens``, in two copies with the same live values.  The kernel's: block
    1 holds ±127 with NaN scales and every dead table entry points at it,
    and every scale at or past a row's vlen in its last live block is NaN
    (payload ±127), so a kernel that reads one turns its output NaN.  The
    plain version's: dead entries at the sentinel block 0, those scales 0.
    Block 0's scales are 0 in both; a last row with vlen <= 1 decodes on
    it, as an idle row does.  Rows 0 and 1 share their first pages.
    Returns (q, kernel pools (k, v, k_scale, v_scale), plain pools, kernel
    table, plain table, vlen), on the card."""
    import torch
    from repro_torch.models.layers import _quantize_kv
    b = len(vlens)
    live = [max(1, -(-v // bs)) for v in vlens]
    m = max(live) + 1
    n_fresh = sum(live)
    p = 2 + n_fresh
    k8, ks = _quantize_kv(torch.randn(p, bs, hkv, d, generator=gen))
    v8, vs = _quantize_kv(torch.randn(p, bs, hkv, d, generator=gen))
    pools = [x.transpose(1, 2).contiguous() for x in (k8, v8, ks, vs)]
    pools[2][0] = pools[3][0] = 0.0
    perm = (torch.randperm(n_fresh, generator=gen) + 2).tolist()
    t_kernel = torch.ones((b, m), dtype=torch.int32)
    t_plain = torch.zeros((b, m), dtype=torch.int32)
    for row, n in enumerate(live):
        for j in range(n):
            t_kernel[row, j] = t_plain[row, j] = perm.pop()
        if vlens[row] <= 1 and row == b - 1:       # an idle row: sentinel
            t_kernel[row, 0] = t_plain[row, 0] = 0
    if b > 1:
        n_shared = min(live[0], live[1]) - 1
        t_kernel[1, :n_shared] = t_kernel[0, :n_shared]
        t_plain[1, :n_shared] = t_plain[0, :n_shared]
    kern = [x.clone() for x in pools]
    plain = [x.clone() for x in pools]
    kern[0][1], kern[1][1] = 127, -127
    kern[2][1] = kern[3][1] = float("nan")
    for row, n in enumerate(vlens):
        for pos in range(n, live[row] * bs):
            blk = int(t_kernel[row, pos // bs])
            if blk > 1:
                kern[0][blk, :, pos % bs] = 127
                kern[1][blk, :, pos % bs] = -127
                kern[2][blk, :, pos % bs] = kern[3][blk, :, pos % bs] = \
                    float("nan")
                for x in (plain[2], plain[3]):
                    x[blk, :, pos % bs] = 0.0
    q = torch.randn(b, tq, hkv * g, d, generator=gen)
    return (q.to(device="cuda", dtype=dtype),
            [_layer_view(x.cuda()) for x in kern],
            [_layer_view(x.cuda()) for x in plain],
            t_kernel.cuda(), t_plain.cuda(),
            torch.tensor(vlens, dtype=torch.int32, device="cuda"))


def _check_int8(gen) -> dict:
    """The int8 forms against their plain versions: paged decode at the
    int8 serving run's decode batch (B = 8, vlen up to 329, a row with
    vlen 0 and an idle row on the sentinel block), BS 16 and 8; paged
    prefill at the prefill cases (chunks crossing block edges, a keyless
    row, 64-token chunks after cached prefixes); contiguous decode over the
    slot pool's ragged slots of 328 (vlen 0 and 1 among them).  fp32 within
    1e-5, bf16 q within 2e-2 (identical int8 and scale inputs, so only the
    fp32 summation order differs)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    worst = dict.fromkeys(("flash_decode_paged_int8", "flash_decode_int8",
                           "flash_attention_paged_int8"), 0.0)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        errs = dict.fromkeys(worst, 0.0)
        for bs in (8, 16):
            vlens = [329, 290, 177, 0, 33, 250, 9, 1]
            q, kern, plain, tk, tp, vl = _int8_paged_inputs(
                gen, dtype=dtype, bs=bs, vlens=vlens)
            got = fd.flash_decode_paged(q, kern[0], kern[1], tk, vl,
                                        k_scale_pool=kern[2],
                                        v_scale_pool=kern[3])
            torch.cuda.synchronize()
            want = fd.flash_decode_paged_plain(q, plain[0], plain[1], tp, vl,
                                               k_scale_pool=plain[2],
                                               v_scale_pool=plain[3])
            if not torch.isfinite(got).all():
                _fail(f"flash_decode_paged_int8 {dtype} BS={bs}: non-finite "
                      "output (a dead entry or a tail scale was read)")
            errs["flash_decode_paged_int8"] = max(
                errs["flash_decode_paged_int8"],
                (got.float() - want.float()).abs().max().item())
            for tq, qoff, pvl in PREFILL_CASES:
                q, kern, plain, tk, tp, vl = _int8_paged_inputs(
                    gen, dtype=dtype, bs=bs, vlens=pvl, tq=tq)
                qo = torch.tensor(qoff, dtype=torch.int32, device="cuda")
                out, lse = fa.flash_attention_paged(
                    q, kern[0], kern[1], qo, vl, tk, k_scale_pool=kern[2],
                    v_scale_pool=kern[3])
                torch.cuda.synchronize()
                w_out, w_lse = fa.flash_attention_paged_plain(
                    q, plain[0], plain[1], qo, vl, tp, k_scale_pool=plain[2],
                    v_scale_pool=plain[3])
                what = f"{str(dtype)[6:]} BS={bs} Tq={tq} vlen={pvl}"
                if not torch.isfinite(out).all():
                    _fail(f"flash_attention_paged_int8 {what}: non-finite "
                          "output (a dead entry or a tail scale was read)")
                if not torch.equal(torch.isneginf(lse),
                                   torch.isneginf(w_lse)):
                    _fail(f"flash_attention_paged_int8 {what}: lse -inf "
                          "pattern differs")
                fin = torch.isfinite(w_lse)
                errs["flash_attention_paged_int8"] = max(
                    errs["flash_attention_paged_int8"],
                    (out.float() - w_out.float()).abs().max().item(),
                    (lse[fin] - w_lse[fin]).abs().max().item())
        vlens = [328, 290, 177, 0, 33, 250, 9, 1]
        k, v, ks, vs, kp, vp, ksp, vsp = _int8_contiguous_inputs(
            gen, s=328, vlens=vlens)
        q = torch.randn(8, 1, 15, 64, generator=gen).to(device="cuda",
                                                        dtype=dtype)
        vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
        got = fd.flash_decode(q, k, v, vl, k_scale=ks, v_scale=vs)
        torch.cuda.synchronize()
        want = fd.flash_decode_plain(q, kp, vp, vl, k_scale=ksp, v_scale=vsp)
        if not torch.isfinite(got).all():
            _fail(f"flash_decode_int8 {dtype}: non-finite output (a "
                  "position at or past vlen was read)")
        errs["flash_decode_int8"] = (got.float()
                                     - want.float()).abs().max().item()
        for name, err in errs.items():
            if err > atol:
                _fail(f"{name} {str(dtype)[6:]}: max abs err {err:.3g} > "
                      f"{atol}")
        print(f"kernel int8 forms {str(dtype)[6:]} q, 15/5 heads, D 64, "
              f"int8 K/V + bf16 scales from _quantize_kv, NaN scales and "
              f"±127 in every dead entry and tail: paged decode B=8 vlen "
              f"0..329 BS 8/16 {errs['flash_decode_paged_int8']:.3g}, "
              f"paged prefill {len(PREFILL_CASES)} cases BS 8/16 "
              f"{errs['flash_attention_paged_int8']:.3g}, contiguous decode "
              f"B=8 S=328 {errs['flash_decode_int8']:.3g} max abs err "
              f"(atol {atol})")
        if dtype == torch.bfloat16:
            worst = errs
    return worst


def _int8_contiguous_inputs(gen, *, s, vlens, hkv=5, d=64):
    """int8 caches [B, S, Hkv, D] and bf16 scales [B, S, Hkv] from
    ``_quantize_kv`` of random K/V, as per-layer views: the kernel's with
    ±127 and NaN scales at or past each row's vlen, the plain version's
    with those scales 0.  Returns (k, v, k_scale, v_scale) twice."""
    import torch
    from repro_torch.models.layers import _quantize_kv
    b = len(vlens)
    k8, ks = _quantize_kv(torch.randn(b, s, hkv, d, generator=gen))
    v8, vs = _quantize_kv(torch.randn(b, s, hkv, d, generator=gen))
    dead = torch.arange(s)[None, :] >= torch.tensor(vlens)[:, None]
    kern = [k8.clone(), v8.clone(), ks.masked_fill(dead[..., None],
                                                   float("nan")),
            vs.masked_fill(dead[..., None], float("nan"))]
    kern[0][dead], kern[1][dead] = 127, -127
    plain = [k8, v8, ks.masked_fill(dead[..., None], 0.0),
             vs.masked_fill(dead[..., None], 0.0)]
    return tuple(_layer_view(x.cuda()) for x in kern + plain)


def _split_edges(plan, max_len: int, b: int, gen) -> list:
    """Valid lengths for ``b`` rows: 0, 1, every split edge k·split and its
    neighbours ±1, and the full ``max_len`` (so one row for every count of
    live splits), the rest drawn at random."""
    import torch
    edges = [0, 1]
    for k in range(1, plan.splits):
        edges += [k * plan.split - 1, k * plan.split, k * plan.split + 1]
    edges.append(max_len)
    if {plan.live(v, max_len) for v in edges} != set(range(plan.splits + 1)):
        _fail(f"split edges {edges} miss a count of live splits")
    rest = torch.randint(2, max_len + 1, (b - len(edges),), generator=gen)
    return edges + rest.tolist()


def _split_plan(fd, hkv, max_len, unit, kv_dtype):
    """The smallest batch (from 8) whose split edges fit one row each, and
    the plan the wrapper makes for it on this card."""
    import torch
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    for b in range(8, 256):
        plan = fd.decode_plan(b, hkv, 3, 64, max_len, unit, kv_dtype,
                              build.sm_count(dev))
        if 3 * plan.splits <= b:
            return b, plan
    _fail(f"no batch fits the split edges of a {max_len}-position cache")


def _poisoned_tails(pool, tables, vlens, bs):
    """The kernel's and the plain version's copies of a paged pool: in the
    kernel's, every position at or past a row's vlen inside its last live
    block is NaN; in the plain version's, 0 (it masks them, but 0 · NaN is
    NaN)."""
    kern, plain = pool.clone(), pool.clone()
    for row, n in enumerate(vlens):
        for pos in range(n, -(-max(n, 1) // bs) * bs):
            blk = int(tables[row, pos // bs])
            if blk > 1:
                kern[blk, :, pos % bs] = float("nan")
                plain[blk, :, pos % bs] = 0.0
    return kern, plain


def _decode_split_inputs(gen, name, dtype, vlens, *, hkv, bs, m, s):
    """(q, the kernel's operands, the plain version's, vlen) of one decode
    form for rows of valid lengths ``vlens``; paged tables cut to ``m``
    entries (every live one), contiguous caches of ``s`` positions."""
    import torch
    if name == "flash_decode_paged_int8":
        q, kern, plain, tk, tp, vl = _int8_paged_inputs(
            gen, dtype=dtype, bs=bs, vlens=vlens)
        return (q, (*kern, tk[:, :m].contiguous()),
                (*plain, tp[:, :m].contiguous()), vl)
    if name == "flash_decode_paged":
        q, kp, vp, tk, tp, vl = _paged_inputs(gen, dtype=dtype, bs=bs,
                                              vlens=vlens)
        (kk, kpl), (vk, vpl) = (_poisoned_tails(x, tk, vlens, bs)
                                for x in (kp, vp))
        return (q, (kk, vk, tk[:, :m].contiguous()),
                (kpl, vpl, tp[:, :m].contiguous()), vl)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    if name == "flash_decode_int8":
        cache = _int8_contiguous_inputs(gen, s=s, vlens=vlens, hkv=hkv)
        q = torch.randn(len(vlens), 1, hkv * 3, 64, generator=gen).to(
            device="cuda", dtype=dtype)
        return q, cache[:4], cache[4:], vl
    q, k, v, k0, v0 = _contiguous_inputs(gen, dtype=dtype, s=s, vlens=vlens)
    return q, (k, v), (k0, v0), vl


def _decode_call(fd, name, q, ops, vl, plain=False):
    """One call of a decode form (or its plain version) on ``ops``: (k, v,
    [k_scale, v_scale,] [tables])."""
    paged = name.startswith("flash_decode_paged")
    kv, rest = ops[:2], ops[2:]
    tables = rest[-1:] if paged else ()
    scales = rest[:2] if name.endswith("int8") else ()
    kw = (dict(zip(("k_scale_pool", "v_scale_pool") if paged
                   else ("k_scale", "v_scale"), scales)))
    fn = {(True, False): fd.flash_decode_paged,
          (True, True): fd.flash_decode_paged_plain,
          (False, False): fd.flash_decode,
          (False, True): fd.flash_decode_plain}[(paged, plain)]
    return fn(q, *kv, *tables, vl, **kw)


def _check_decode_splits(gen) -> dict:
    """The split decode's edges in all four forms (paged and contiguous, fp
    and int8 K/V), fp32 and bf16 q: rows at vlen 0, 1, every split edge ± 1
    and the full M·BS (paged, BS 16, M 21) or S (328), one row for every
    count of live splits, at the plan the wrapper makes; every dead table
    entry and every position at or past vlen poisoned (NaN; int8 ±127 with
    NaN scales); vlen 0 gives exactly 0; a second call on the same input is
    bit-equal to the first; the profiler sees the form's split kernel (its
    last live split of each row merges) and no other kernel of the port.
    Returns the worst error per form, fp32 for the fp forms and bf16 for
    the int8 forms (the JSON line's convention)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_decode as fd
    hkv, bs, m, s = 5, 16, 21, 328
    worst = {}
    split_kernel = {"flash_decode_paged": "decode_paged_split_kernel",
                    "flash_decode_paged_int8":
                        "decode_paged_int8_split_kernel",
                    "flash_decode": "decode_split_kernel",
                    "flash_decode_int8": "decode_int8_split_kernel"}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for name in ("flash_decode_paged", "flash_decode_paged_int8",
                     "flash_decode", "flash_decode_int8"):
            int8 = name.endswith("int8")
            paged = name.startswith("flash_decode_paged")
            max_len, unit = (m * bs, bs) if paged else (
                s, fd.CONTIGUOUS_TILE)
            b, plan = _split_plan(fd, hkv, max_len, unit,
                                  torch.int8 if int8 else dtype)
            vlens = _split_edges(plan, max_len, b, gen)
            q, kern, plain, vl = _decode_split_inputs(
                gen, name, dtype, vlens, hkv=hkv, bs=bs, m=m, s=s)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = _decode_call(fd, name, q, kern, vl)
                torch.cuda.synchronize()
            again = _decode_call(fd, name, q, kern, vl)
            torch.cuda.synchronize()
            seen = _kernels_seen(prof)
            if seen != [split_kernel[name]]:
                _fail(f"{name}: the profiler saw {seen}, not "
                      f"{split_kernel[name]} alone")
            want = _decode_call(fd, name, q, plain, vl, plain=True)
            what = (f"{name} {str(dtype)[6:]} B={b} split {plan.split} x "
                    f"{plan.splits}")
            if not torch.isfinite(got).all():
                _fail(f"{what}: non-finite output (a dead entry or a "
                      "position at or past vlen was read)")
            if not torch.equal(got, again):
                _fail(f"{what}: two calls on the same input differ")
            if got[0].abs().max().item() != 0.0:
                _fail(f"{what}: vlen 0 gave a nonzero output")
            err = (got.float() - want.float()).abs().max().item()
            if err > atol:
                _fail(f"{what}: max abs err {err:.3g} > {atol}")
            if (dtype == torch.bfloat16) == int8:
                worst[name] = err
            print(f"kernel {what} ({seen[0]} seen by the profiler): vlen "
                  f"0, 1, each split edge ± 1, {max_len}; "
                  f"max abs err {err:.3g} (atol {atol}); a repeat "
                  "bit-equal")
    return worst


def phase_kernels() -> dict:
    import torch
    gen = torch.Generator().manual_seed(0)
    errs = {"softmax_topk": _check_softmax_topk(gen),
            "flash_decode_paged": _check_decode(gen),
            "flash_attention_paged": _check_prefill(gen),
            "flash_decode": _check_contiguous_decode(gen),
            "flash_attention_offset": _check_offset(gen),
            **_check_fresh(gen),
            **_check_int8(gen)}
    for name, err in _check_decode_splits(gen).items():
        errs[name] = max(errs[name], err)
    return errs


# ---------------------------------------------------------------------------
# 4: serve smollm-360m at full width through Engine (the main path)
# ---------------------------------------------------------------------------
def _check_finished(what: str, report, requests, vocab: int) -> None:
    by_rid = {r.rid: r for r in report.results}
    if sorted(by_rid) != [r.rid for r in requests]:
        _fail(f"serve {what}: finished {sorted(by_rid)} of {len(requests)} "
              "requests")
    for req in requests:
        res = by_rid[req.rid]
        if len(res.tokens) != req.max_new_tokens or res.evicted:
            _fail(f"serve {what}: request {req.rid} gave {len(res.tokens)} "
                  f"of {req.max_new_tokens} tokens (evicted={res.evicted})")
        if not all(0 <= t < vocab for t in res.tokens):
            _fail(f"serve {what}: request {req.rid} has a token id outside "
                  "the vocabulary")


def _implied_counts(sched, n_layers: int) -> dict:
    """Launches the scheduler's counters imply: one decode-kernel launch per
    layer for every decode step and one-token prefill chunk, one prefill-
    kernel launch per layer for every wider chunk, one softmax_topk per
    decode step and per finished prefill; the other path's kernels none.
    With int8 K/V the decode kernels are the int8 forms, and every prefill
    (over the prompt's exact K/V) is the contiguous prefill kernel."""
    ones = sched.chunk_widths.get(1, 0)
    dec, pre = (("flash_decode_paged", "flash_attention_paged")
                if sched.paged else ("flash_decode", "flash_attention_offset"))
    if sched.family.quantized:
        dec, pre = f"{dec}_int8", "flash_attention_offset"
    want = dict.fromkeys(KERNELS, 0)
    want[dec] = (sched.decode_steps + ones) * n_layers
    want[pre] = (sched.prefill_chunks - ones) * n_layers
    want["softmax_topk"] = sched.decode_steps + sched.prefills_done
    return want


def _check_counts(what: str, counts: dict, want: dict) -> None:
    """Fail unless the launches equal the counters' and every kernel of
    the path (and the sampler) launched."""
    path = [k for k, p in KERNEL_PATH.items() if p == what] + ["softmax_topk"]
    if counts != want or not all(want[k] for k in path):
        _fail(f"serve {what}: launches {counts}, the counters imply {want}")


def _pool_bytes_per_token(pool) -> float:
    """Bytes of every leaf of a block pool per cacheable token position."""
    leaves = list(pool.caches.values())
    slots = leaves[0].shape[1] * pool.block_size
    return sum(x.numel() * x.element_size() for x in leaves) / slots


def _check_int8_run(what: str, report, sched, requests) -> None:
    """An int8 run prefills every prompt in one chunk and, paged, shares,
    reuses and caches no block and frees every block at the end."""
    if sched.prefill_chunks != len(requests) or \
            sched.prefills_done != len(requests):
        _fail(f"serve {what}: {sched.prefill_chunks} prefill chunks for "
              f"{len(requests)} requests (int8 prefill is single shot)")
    p = report.paged
    if p is not None and (p["blocks_shared"] or p["prefix_cache_hits"]
                          or p["cached_blocks"] or p["tokens_reused"]
                          or p["free_blocks"] != p["num_blocks"]):
        _fail(f"serve {what}: int8 blocks were shared or cached: {p}")


def phase_serve():
    """The three serving paths at full width in bf16, then the same with
    int8 K/V, each between a reset and a read of the launch counts.
    Returns ({path: counts}, what the step timings reuse)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = serve.config_for(serve.parse_args(SERVE_ARGS))
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} {cfg.dtype}, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}; weights from "
          f"seed 0 in {time.perf_counter() - t0:.1f}s")
    counts, engines = {}, {}
    for what, argv in (("paged", SERVE_ARGS), ("slot pool", SLOT_ARGS),
                       ("paged int8", SERVE_ARGS + INT8),
                       ("slot pool int8", SLOT_ARGS + INT8)):
        args = serve.parse_args(argv)
        run_cfg = serve.config_for(args)
        dispatch.reset_launch_counts()
        report, eng, requests, _ = serve.run(args, run_cfg, params)
        torch.cuda.synchronize()
        counts[what] = dispatch.launch_counts()
        sched = eng.scheduler
        _check_finished(what, report, requests, cfg.vocab_size)
        _check_counts(what, counts[what],
                      _implied_counts(sched, cfg.num_layers))
        if sched.family.quantized:
            _check_int8_run(what, report, sched, requests)
        print(f"serve {what} launches: {counts[what]} = scheduler counters "
              f"(decode steps {sched.decode_steps}, prefill chunks "
              f"{sched.prefill_chunks} of which "
              f"{sched.chunk_widths.get(1, 0)} one-token, prefills "
              f"{sched.prefills_done}, {cfg.num_layers} layers)")
        engines[what] = eng
    fp, q8 = (_pool_bytes_per_token(engines[w].scheduler.pool)
              for w in ("paged", "paged int8"))
    print(f"serve pool bytes per cached token: {cfg.dtype} K/V {fp:.0f}, "
          f"int8 K/V + bf16 scales {q8:.0f} ({fp / q8:.3f}x the tokens in "
          f"the same bytes)")

    for what, argv in (("lockstep", LOCKSTEP_ARGS),
                       ("lockstep int8", LOCKSTEP_ARGS + INT8)):
        args = serve.parse_args(argv)
        dispatch.reset_launch_counts()
        ids = serve.lockstep(args, serve.config_for(args), params)
        torch.cuda.synchronize()
        counts[what] = dispatch.launch_counts()
        if ids.shape != (args.batch, args.tokens) or not (
                (ids >= 0) & (ids < cfg.vocab_size)).all():
            _fail(f"serve {what}: token ids of shape {ids.shape} outside "
                  "the vocabulary or short")
        dec = "flash_decode_int8" if args.kv_cache_dtype else "flash_decode"
        want = dict.fromkeys(KERNELS, 0)
        want.update({"softmax_topk": args.tokens,
                     dec: (args.tokens - 1) * cfg.num_layers,
                     "flash_attention_offset": cfg.num_layers})
        if counts[what] != want:
            _fail(f"serve {what}: launches {counts[what]}, its steps imply "
                  f"{want}")
        print(f"serve {what} launches: {counts[what]} = one prefill, "
              f"{args.tokens - 1} decode steps and {args.tokens} samples "
              f"over {cfg.num_layers} layers")
    return counts, {"params": params, "cfg": cfg, "engines": engines}


# ---------------------------------------------------------------------------
# 5: fp32 parity at full width: kernels on the card vs plain on the CPU
# ---------------------------------------------------------------------------
def _first_decode_logits(params, cfg, prompt, *, device, block_size, chunk,
                         token):
    """Logits of one sequence's first decode step, through the engine's
    paged primitives on ``device``."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    m = -(-(len(prompt) + 1) // block_size)
    pools = engine.init_paged_cache(cfg, m + 1, block_size, device)
    table = torch.arange(1, m + 1, dtype=torch.int32, device=device)[None]
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=device)[None]
    length, pos = 0, 0
    for w in engine.prefill_schedule(len(prompt), chunk):
        _, pools, length = engine.prefill_chunk_paged(
            params, pools, table, length, toks[:, pos:pos + w], cfg)
        pos += w
    hidden, _ = transformer.forward(
        params, torch.tensor([[token]], device=device), cfg, caches=pools,
        cache_len=torch.tensor([length], device=device), block_tables=table)
    return engine.logits_from_hidden(params, hidden[:, -1], cfg)


def _parity_runs(what: str, argv, cfg, params_by_device):
    """Serve ``argv`` on the card and on the CPU; fail unless the token
    streams (and the paged pool's stats) are identical.  Returns (the CPU's
    streams, the requests)."""
    from repro_torch.launch import serve
    runs = {}
    for device, params in params_by_device.items():
        args = serve.parse_args(argv + ["--device", device])
        t0 = time.perf_counter()
        report, _, requests, _ = serve.run(args, cfg, params)
        runs[device] = ({r.rid: r.tokens for r in report.results},
                        report.paged)
        print(f"parity {what} {device}: {report.total_tokens} tokens in "
              f"{time.perf_counter() - t0:.1f}s")
    if runs["cuda"][0] != runs["cpu"][0]:
        _fail(f"parity {what}: token streams differ\ncuda {runs['cuda'][0]}"
              f"\ncpu  {runs['cpu'][0]}")
    if runs["cuda"][1] != runs["cpu"][1]:
        _fail(f"parity {what}: pool stats differ {runs['cuda'][1]} vs "
              f"{runs['cpu'][1]}")
    print(f"parity {what}: {len(requests)} requests, token streams identical "
          f"({sum(len(t) for t in runs['cpu'][0].values())} tokens)"
          + (", pool stats equal" if runs["cpu"][1] is not None else ""))
    return runs["cpu"][0], requests


def phase_parity() -> None:
    import numpy as np
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    base = serve.parse_args(PARITY_ARGS)
    cfg = serve.config_for(base).replace(dtype="float32")
    params_cpu = transformer.init(cfg, seed=1, device="cpu")
    params_gpu = transformer.params_to(params_cpu, "cuda")
    params_by_device = {"cuda": params_gpu, "cpu": params_cpu}
    streams, requests = _parity_runs("paged", PARITY_ARGS, cfg,
                                     params_by_device)
    prompt = requests[0].prompt
    token = streams[requests[0].rid][0]
    kw = dict(block_size=base.block_size, chunk=base.prefill_chunk,
              token=token)
    lg = _first_decode_logits(params_gpu, cfg, prompt, device="cuda", **kw)
    lc = _first_decode_logits(params_cpu, cfg, prompt, device="cpu", **kw)
    diff = (lg.cpu() - lc).abs().max().item()
    print(f"parity paged: first decode step max |logit diff| {diff:.3g} "
          f"(logit scale {lc.abs().max().item():.3g})")
    _parity_runs("slot pool", SLOT_PARITY_ARGS, cfg, params_by_device)
    ids = {device: serve.lockstep(serve.parse_args(
               LOCKSTEP_PARITY_ARGS + ["--device", device]), cfg, params)
           for device, params in params_by_device.items()}
    if not np.array_equal(ids["cuda"], ids["cpu"]):
        _fail(f"parity lockstep: token ids differ\ncuda {ids['cuda']}\n"
              f"cpu  {ids['cpu']}")
    print(f"parity lockstep: {ids['cpu'].size} token ids identical "
          f"({' '.join(LOCKSTEP_PARITY_ARGS)})")


def _int8_first_step(params, cfg, prompts, *, device, mode: str,
                     block_size: int):
    """The int8 cache right after the first (single-shot) prefill of
    ``prompts`` [B, T], and the logits of the first decode step after it
    (input: each prompt's first token), on ``device``: through a block table
    (``mode`` "paged"), or contiguous caches at per-row lengths ("slot
    pool") or at one shared length ("lockstep").  Returns ({leaf: cache on
    the CPU}, logits [B, V] on the CPU)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    toks = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    b, t = toks.shape
    if mode == "paged":
        m = -(-(t + 1) // block_size)
        caches = engine.init_paged_cache(cfg, m + 1, block_size, device)
        table = torch.arange(1, m + 1, dtype=torch.int32,
                             device=device)[None]
        _, caches, length = engine.prefill_chunk_paged(params, caches, table,
                                                       0, toks, cfg)
        kw = dict(cache_len=torch.tensor([length], device=device),
                  block_tables=table)
    elif mode == "slot pool":
        _, caches, length = engine.chunked_prefill(params, toks, cfg,
                                                   max_len=t + 8)
        kw = dict(cache_len=torch.tensor([length], device=device))
    else:
        _, caches, length = engine.prefill(params, toks, cfg, max_len=t + 8)
        kw = dict(cache_len=length)
    snap = {n: x.cpu().clone() for n, x in caches.items()}
    hidden, _ = transformer.forward(params, toks[:, :1], cfg, caches=caches,
                                    **kw)
    return snap, engine.logits_from_hidden(params, hidden[:, -1], cfg).cpu()


def _agreement(a: dict, b: dict) -> tuple[int, int]:
    """(positions where two streams per request agree, positions)."""
    same = sum(x == y for r in a for x, y in zip(a[r], b[r]))
    return same, sum(len(a[r]) for r in a)


def phase_parity_int8() -> None:
    """The int8 paths at full width in fp32, card against CPU.  Token
    streams are not a sound gate: the two fp32 K projections differ in
    their last bits, and an element within that of a .5 rounding boundary
    quantizes one int8 step apart.  Gated instead: after the first prefill
    every int8 entry within 1 and every scale within one bf16 ulp of the
    CPU's, and the first decode step's max |logit diff| within
    ``INT8_LOGIT_RTOL`` of the logit scale.  Printed: the entries that
    differ, and the token agreement of the parity workloads."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    base = serve.parse_args(PARITY_ARGS + INT8)
    cfg = serve.config_for(base).replace(dtype="float32")
    params_cpu = transformer.init(cfg, seed=1, device="cpu")
    params = {"cuda": transformer.params_to(params_cpu, "cuda"),
              "cpu": params_cpu}
    requests, _ = serve.workload(base, cfg)
    lock_prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                     (2, 37))
    for mode, prompts in (("paged", requests[0].prompt[None]),
                          ("slot pool", requests[0].prompt[None]),
                          ("lockstep", lock_prompts)):
        got = {d: _int8_first_step(params[d], cfg, prompts, device=d,
                                   mode=mode, block_size=base.block_size)
               for d in ("cuda", "cpu")}
        (c_gpu, l_gpu), (c_cpu, l_cpu) = got["cuda"], got["cpu"]
        n_diff = n_all = 0
        for name in ("k", "v"):
            d8 = (c_gpu[name].int() - c_cpu[name].int()).abs()
            n_diff += int((d8 > 0).sum())
            n_all += d8.numel()
            if d8.max().item() > 1:
                _fail(f"parity {mode} int8: {name} entries differ by "
                      f"{d8.max().item()} (> 1)")
        for name in ("k_scale", "v_scale"):
            ulps = (c_gpu[name].view(torch.int16).int()
                    - c_cpu[name].view(torch.int16).int()).abs()
            if ulps.max().item() > 1:
                _fail(f"parity {mode} int8: {name} differs by "
                      f"{ulps.max().item()} bf16 ulps (> 1)")
        scale = l_cpu.abs().max().item()
        diff = (l_gpu - l_cpu).abs().max().item()
        if not diff <= INT8_LOGIT_RTOL * scale:
            _fail(f"parity {mode} int8: first decode step max |logit diff| "
                  f"{diff:.3g} > {INT8_LOGIT_RTOL} x logit scale {scale:.3g}")
        print(f"parity {mode} int8: after the first prefill "
              f"({prompts.shape[0]} x {prompts.shape[1]} tokens) {n_diff} of "
              f"{n_all} int8 entries differ (each by 1), scales within 1 "
              f"bf16 ulp; first decode step max |logit diff| {diff:.3g} "
              f"(logit scale {scale:.3g}, tol {INT8_LOGIT_RTOL} x scale)")
    for what, argv in (("paged", PARITY_ARGS), ("slot pool",
                                                 SLOT_PARITY_ARGS)):
        streams = {}
        for device in ("cuda", "cpu"):
            args = serve.parse_args(argv + INT8 + ["--device", device])
            report, _, _, _ = serve.run(args, cfg, params[device])
            streams[device] = {r.rid: r.tokens for r in report.results}
        same, total = _agreement(streams["cuda"], streams["cpu"])
        print(f"parity {what} int8: token agreement {same} of {total} "
              f"({' '.join(argv + INT8)})")
    ids = {d: serve.lockstep(serve.parse_args(
               LOCKSTEP_PARITY_ARGS + INT8 + ["--device", d]), cfg,
               params[d]) for d in ("cuda", "cpu")}
    print(f"parity lockstep int8: token agreement "
          f"{int((ids['cuda'] == ids['cpu']).sum())} of {ids['cpu'].size}")


# ---------------------------------------------------------------------------
# 6: train smollm-360m at full width through the training CLI
# ---------------------------------------------------------------------------
def _train(argv, ckpt_dir: str):
    """``repro_torch.launch.train`` on ``argv`` into ``ckpt_dir``, quiet.
    Returns (params, opt_state, history, run config)."""
    from repro_torch.launch import train
    args = train.parse_args(argv + ["--checkpoint-dir", ckpt_dir])
    return train.train(args, log=lambda *_: None)


def phase_train():
    """20 full-width bf16 steps between a reset and a read of the launch
    counts, then the 2-layer restart check.  Returns (the counts, what the
    train-step timing reuses)."""
    import tempfile
    import torch
    from repro_torch import tree
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    args = train.parse_args(TRAIN_ARGS)
    with tempfile.TemporaryDirectory() as tmp:
        dispatch.reset_launch_counts()
        params, opt, hist, run = _train(TRAIN_ARGS, os.path.join(tmp, "a"))
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        steps, n = len(hist), run.model.num_layers
        print(f"train: {run.model.name} {run.model.dtype}, {n} layers, "
              f"d_model {run.model.d_model}, {steps} steps of "
              f"{args.global_batch} x {args.seq_len} tokens, remat "
              f"{run.model.remat}, grads reduced in "
              f"{run.parallel.grad_reduce_dtype}")
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        if steps != args.steps or not all(
                map(math.isfinite, losses + norms)):
            _fail(f"train: {steps} steps, losses {losses}, grad norms "
                  f"{norms}")
        want = dict.fromkeys(KERNELS, 0)
        want.update(flash_attention=2 * steps * n,
                    flash_attention_bwd_dq=steps * n,
                    flash_attention_bwd_dkv=steps * n)
        if counts != want:
            _fail(f"train: launches {counts}, remat 'full' implies {want}")
        dts = [h["dt"] for h in hist[1:]]
        tok = args.global_batch * args.seq_len
        print(f"train: first loss {losses[0]:.4f} → last loss "
              f"{losses[-1]:.4f}; grad norm {norms[0]:.4f} → {norms[-1]:.4f};"
              f" step 0 {hist[0]['dt'] * 1e3:.1f}ms, steps 1-{steps - 1} "
              f"median {statistics.median(dts) * 1e3:.1f}ms = "
              f"{tok / statistics.median(dts):.0f} tokens/s")
        print(f"train launches: {counts} = per step {2 * n} forward "
              f"(forward + recomputation), {n} dq, {n} dk/dv over {steps} "
              "steps")

        # restart: 6 steps checkpointed every 3, then on to 8, against an
        # uninterrupted 8 (warmup 20 > 8 steps: the schedule does not
        # depend on --steps, so the runs take the same steps)
        _train(RESTART_ARGS + ["--steps", "6", "--checkpoint-every", "3"],
               os.path.join(tmp, "b"))
        p_re, o_re, h_re, _ = _train(RESTART_ARGS + ["--steps", "8"],
                                     os.path.join(tmp, "b"))
        p_ref, o_ref, _, _ = _train(RESTART_ARGS + ["--steps", "8"],
                                    os.path.join(tmp, "c"))
        if [h["step"] for h in h_re] != [6, 7] or int(o_re.step) != 8:
            _fail(f"train restart: resumed at {[h['step'] for h in h_re]}")
        same = all(torch.equal(a, b) for a, b in zip(
            tree.leaves((p_re, o_re)), tree.leaves((p_ref, o_ref))))
        if not same:
            _fail("train restart: parameters differ from an uninterrupted "
                  "run")
        print("train restart: 2 layers, 6 steps (checkpoints at 3 and 6) "
              "then resumed at 6 to 8: parameters and optimizer state "
              "bit-identical to an uninterrupted 8-step run")
    return counts, {"params": params, "opt": opt, "run": run, "args": args}


# ---------------------------------------------------------------------------
# 7: fp32 training parity at full width: kernels on the card vs the CPU
# ---------------------------------------------------------------------------
def phase_train_parity() -> None:
    """Loss and every gradient of one fp32 batch, full width cut to 2
    layers, on the card (kernels) and on the CPU (plain versions), from the
    same weights.  The loss within 1e-5 relative; each gradient leaf within
    1e-4 of its largest entry (fp32 sums in other orders on the two
    devices, through the 49152-wide head)."""
    import numpy as np
    import torch
    from repro_torch import configs, tree
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.models import transformer
    cfg = configs.get("smollm_360m").replace(
        num_layers=TRAIN_PARITY["layers"], dtype="float32")
    batch = SyntheticDataset(SyntheticConfig(
        cfg.vocab_size, TRAIN_PARITY["seq_len"],
        TRAIN_PARITY["batch"])).batch(0)
    params_cpu = transformer.init(cfg, seed=2, device="cpu")
    out = {}
    for device, params in (("cuda", transformer.params_to(params_cpu,
                                                          "cuda")),
                           ("cpu", params_cpu)):
        params = tree.map(lambda p: p.requires_grad_(True), params)
        b = {k: torch.as_tensor(np.asarray(v), device=device)
             for k, v in batch.items()}
        t0 = time.perf_counter()
        loss, _ = transformer.loss_fn(params, b, cfg)
        grads = torch.autograd.grad(loss, tree.leaves(params))
        out[device] = (loss.item(), [g.cpu() for g in grads])
        print(f"train parity {device}: loss {out[device][0]:.6f} in "
              f"{time.perf_counter() - t0:.1f}s")
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, where = 0.0, ""
    paths = [p for p, _ in tree.leaves_with_path(params_cpu)]
    for path, a, b in zip(paths, out["cuda"][1], out["cpu"][1]):
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if err > worst:
            worst, where = err, path
    if rel > 1e-5 or worst > 1e-4:
        _fail(f"train parity: loss rel diff {rel:.3g} (1e-5), gradient "
              f"{where} rel diff {worst:.3g} (1e-4)")
    print(f"train parity: fp32 {cfg.num_layers} layers full width, batch "
          f"{TRAIN_PARITY['batch']} x {TRAIN_PARITY['seq_len']}: loss rel "
          f"diff {rel:.3g} (tol 1e-5); worst gradient leaf {where} max abs "
          f"diff {worst:.3g} of its largest entry (tol 1e-4) over "
          f"{len(paths)} leaves")


# ---------------------------------------------------------------------------
# 8: times at the serving and training paths' shapes
# ---------------------------------------------------------------------------
def _bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _host_ms(fn, samples: int = 10, warmup: int = 2) -> float:
    """Median host time of ``fn`` ending in a device synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


PORT_KERNEL_SYMBOLS = ("softmax_topk_kernel", "paged_wgmma_kernel",
                       "decode_paged_split_kernel", "prefill_paged_kernel",
                       "decode_split_kernel", "prefill_offset_kernel",
                       "offset_wgmma_kernel",
                       "fresh_fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel",
                       "fresh_fwd_wgmma_kernel", "bwd_dq_wgmma_kernel",
                       "bwd_dkv_wgmma_kernel",
                       "decode_paged_int8_split_kernel",
                       "decode_int8_split_kernel",
                       "prefill_paged_int8_kernel", "rows_kernel",
                       "md_slice_kernel", "md_merge_kernel",
                       "normalize_kernel")


def _device_ms(fn, reps: int = 5) -> tuple[float, float]:
    """Device time of ``fn`` per call from ``torch.profiler``: (all CUDA
    kernels, the port's own kernels), in ms, averaged over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = ours = 0.0
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        total += evt.self_device_time_total
        if any(sym in evt.key for sym in PORT_KERNEL_SYMBOLS):
            ours += evt.self_device_time_total
    if total <= 0.0:
        _fail("profiler recorded no device time")
    return total / reps / 1e3, ours / reps / 1e3


def phase_steps(serve_ctx, train_ctx) -> None:
    """Where a step's time goes: one full-width decode step over 8 busy
    slots and one 64-token prefill chunk, of the paged pool and of the slot
    pool, the same decode steps over the int8 runs' pools, and one
    full-width train step of 8 x 512 tokens, timed from the
    host's call to the device's finish, against the device's busy time
    inside it (all kernels, and the port's own, from torch.profiler)."""
    import torch
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.serving import engine
    from repro_torch.training.train_step import make_train_step
    params, cfg, engines = (serve_ctx[k]
                            for k in ("params", "cfg", "engines"))
    pool = engines["paged"].scheduler.pool   # idle after the serve: reuse
    slots = engines["slot pool"].scheduler.pool
    n, m = pool.num_slots, pool.max_blocks
    tables = torch.arange(1, n * m + 1, dtype=torch.int32,
                          device="cuda").reshape(n, m)
    lens = torch.tensor([328, 289, 250, 211, 172, 133, 94, 65],
                        device="cuda")[:n]
    toks = torch.ones((n, 1), dtype=torch.int64, device="cuda")
    noise = torch.zeros((n, 5), device="cuda")
    chunk = torch.ones((1, 64), dtype=torch.int64, device="cuda")
    slot_lens = lens.clamp(max=slots.slot_len - 1)
    scratch = engine.init_cache(cfg, 1, slots.slot_len, "cuda")
    steps = {
        f"paged decode [B={n}, {cfg.num_layers} layers, bf16]":
            lambda: engine.decode_step_paged(params, pool.caches, tables,
                                             lens, toks, cfg, noise=noise,
                                             top_k=5),
        "paged prefill chunk [64 tokens at offset 64, bf16]":
            lambda: engine.prefill_chunk_paged(params, pool.caches,
                                               tables[:1], 64, chunk, cfg),
        f"slot-pool decode [B={slots.num_slots}, {cfg.num_layers} layers, "
        "bf16]":
            lambda: engine.decode_step_slots(params, slots.caches, slot_lens,
                                             toks, cfg, noise=noise, top_k=5),
        "slot-pool prefill chunk [64 tokens at offset 64, bf16]":
            lambda: engine.prefill_chunk(params, scratch, 64, chunk, cfg)}
    # the int8 runs' pools: the same decode batches over int8 K/V
    q8_pool = engines["paged int8"].scheduler.pool
    q8_slots = engines["slot pool int8"].scheduler.pool
    q8_cfg = q8_pool.cfg
    steps[f"paged int8 decode [B={n}, {cfg.num_layers} layers, bf16, int8 "
          "K/V]"] = lambda: engine.decode_step_paged(
        params, q8_pool.caches, tables, lens, toks, q8_cfg, noise=noise,
        top_k=5)
    steps[f"slot-pool int8 decode [B={q8_slots.num_slots}, "
          f"{cfg.num_layers} layers, bf16, int8 K/V]"] = \
        lambda: engine.decode_step_slots(params, q8_slots.caches, slot_lens,
                                         toks, q8_cfg, noise=noise, top_k=5)
    run, targs = train_ctx["run"], train_ctx["args"]
    step_fn = make_train_step(run)
    batch = SyntheticDataset(SyntheticConfig(
        run.model.vocab_size, targs.seq_len, targs.global_batch)).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    state = [train_ctx["params"], train_ctx["opt"]]

    def train_step():
        state[0], state[1], _ = step_fn(state[0], state[1], batch)

    steps[f"train step [{targs.global_batch} x {targs.seq_len} tokens, "
          f"{run.model.num_layers} layers, bf16, remat full]"] = train_step
    for name, fn in steps.items():
        reps = 2 if fn is train_step else 5
        wall = _host_ms(fn, samples=5 if fn is train_step else 10)
        busy, ours = _device_ms(fn, reps=reps)
        print(f"step {name}: {wall:.3f}ms host call to device finish; "
              f"device busy {busy:.3f}ms ({100 * busy / wall:.1f}%, idle "
              f"{100 - 100 * busy / wall:.1f}%), of which the port's "
              f"kernels {ours:.3f}ms")


def _sdpa(q, k, v, mask):
    """The library yardstick: one PyTorch SDPA call on [B, H, T, D] views
    of the model layout, GQA by ``enable_gqa``, masked by a boolean mask."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def phase_times() -> dict:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import softmax_topk as st
    gen = torch.Generator().manual_seed(1)
    rows = {}

    # softmax_topk: the decode batch's fp32 logits [8, 49152], k = 5
    x = (torch.randn(8, 49152, generator=gen) * 30.0).cuda()
    got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    if not torch.equal(got.indices.long(), want.indices) or not \
            torch.allclose(got.values, want.values, rtol=1e-5, atol=0.0):
        _fail("softmax_topk disagrees with its plain version on the timed "
              "input")
    args, _ = st.prepare(x, 5)
    r, v, k = 8, 49152, 5
    p = st.plan(r, v, k, x.dtype, build.sm_count(x.device))
    b_ms, b_by = _bound(r * v * 4 + r * k * 8 + r * 4, 4.0 * r * v,
                        "float32")

    def library():
        return torch.topk(torch.softmax(x, -1), 5)
    rows["softmax_topk"] = {
        "ms": _ms(lambda: st.launch(args)),
        "device_ms": _device_call_ms(lambda: st.launch(args)),
        "wrapper_ms": _ms(lambda: st.softmax_topk(x, 5)),
        "plain_ms": _ms(lambda: st.softmax_topk_plain(x, 5)),
        "library_ms": _ms(library),
        "library_device_ms": _device_call_ms(library),
        "library_call": "torch.topk(torch.softmax(x, -1), k) (two calls)",
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"x [8, 49152] float32, k=5, {p.slices} slices of "
                 f"{p.slice}"}

    # paged decode: 8 slots of the serving run's pool (BS=16, 21 blocks a
    # row), bf16, ragged valid lengths across the run's range
    vlens = [329, 290, 251, 212, 173, 134, 95, 66]
    q, kp, vp, tk, tp, vl = _paged_inputs(gen, dtype=torch.bfloat16, bs=16,
                                          vlens=vlens, share=False)
    err = (fd.flash_decode_paged(q, kp, vp, tk, vl).float()
           - fd.flash_decode_paged_plain(q, kp, vp, tp, vl).float()).abs().max()
    if not err <= 2e-2:
        _fail(f"flash_decode_paged on the timed input: max abs err "
              f"{err.item():.3g} > 2e-2")
    hq, d, hkv, esz = 15, 64, 5, 2
    nbytes = (2 * q.numel() * esz + sum(vlens) * hkv * d * esz * 2
              + sum(-(-n // 16) for n in vlens) * 4 + len(vlens) * 4)
    ops = 4.0 * hq * d * sum(vlens)
    args, _ = fd.prepare_paged(q, kp, vp, tk, vl)
    plan = _plan_of(fd, q, kp, tk)
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_decode_paged"] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode_paged(q, kp, vp, tk, vl)),
        "plain_ms": _ms(lambda: fd.flash_decode_paged_plain(q, kp, vp, tp, vl)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 Hq=15 Hkv=5 D=64 BS=16 bf16 vlen {vlens}, {plan}"}

    # paged prefill: one 64-token chunk at offset 64 (the serving run's
    # chunk width), bf16
    tq, qoff, vlen = 64, 64, 128
    q, kp, vp, tk, tp, vl = _paged_inputs(gen, dtype=torch.bfloat16, bs=16,
                                          vlens=[vlen], tq=tq, share=False)
    qo = torch.tensor([qoff], dtype=torch.int32, device="cuda")
    _prefill_err(q, kp, vp, qo, vl, tk, tp, "on the timed input", 2e-2)
    pairs = sum(min(vlen, qoff + i + 1) for i in range(tq))
    nbytes = (2 * q.numel() * esz + hq * tq * 4 + vlen * hkv * d * esz * 2
              + (vlen // 16) * 4 + 8)
    args, _ = fa.prepare_paged(q, kp, vp, qo, vl, tk)
    b_ms, b_by = _bound(nbytes, 4.0 * hq * d * pairs, "bfloat16")
    rows["flash_attention_paged"] = {
        "ms": _ms(lambda: fa.launch(args)),
        "device_ms": _device_call_ms(lambda: fa.launch(args)),
        "wrapper_ms": _ms(lambda: fa.flash_attention_paged(q, kp, vp, qo, vl,
                                                           tk)),
        "plain_ms": _ms(lambda: fa.flash_attention_paged_plain(q, kp, vp, qo,
                                                               vl, tp)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": "B=1 Tq=64 q_offset=64 vlen=128 Hq=15 Hkv=5 D=64 BS=16 bf16"
                 " (tensor cores, paged_wgmma_kernel)"}

    # contiguous decode: the slot pool's 8 slots of 328, ragged, bf16; the
    # library yardstick is one SDPA call on transposed views with a boolean
    # valid-length mask
    vlens = [328, 289, 250, 211, 172, 133, 94, 65]
    q, _, _, k, v = _contiguous_inputs(gen, dtype=torch.bfloat16, s=328,
                                       vlens=vlens)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    err = (fd.flash_decode(q, k, v, vl).float()
           - fd.flash_decode_plain(q, k, v, vl).float()).abs().max()
    if not err <= 2e-2:
        _fail(f"flash_decode on the timed input: max abs err "
              f"{err.item():.3g} > 2e-2")
    mask = (torch.arange(328, device="cuda")[None, :]
            < vl[:, None].long())[:, None, None, :]
    nbytes = (2 * q.numel() * esz + sum(vlens) * hkv * d * esz * 2
              + len(vlens) * 4)
    args, _ = fd.prepare(q, k, v, vl)
    plan = _plan_of(fd, q, k)
    b_ms, b_by = _bound(nbytes, 4.0 * hq * d * sum(vlens), "bfloat16")
    rows["flash_decode"] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode(q, k, v, vl)),
        "plain_ms": _ms(lambda: fd.flash_decode_plain(q, k, v, vl)),
        "library_ms": _ms(lambda: _sdpa(q, k, v, mask)),
        "library_device_ms": _device_call_ms(lambda: _sdpa(q, k, v, mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 S=328 Hq=15 Hkv=5 D=64 bf16 vlen {vlens}, {plan}"}

    # contiguous cached prefill: the slot pool's 64-token chunk at offset
    # 64 into a slot of 328, then (printed only) the lockstep prefill and an
    # int8 run's single-shot prefill (its exact bf16 K/V, Tq = Tk = 256);
    # back-to-back and device times of the kernel (bf16: tensor cores) and
    # of SDPA
    for key, (b, tk, tq, qoff, vlen) in (
            ("flash_attention_offset", (1, 328, 64, 64, 128)),
            ("flash_attention_offset, lockstep", (4, 288, 256, 0, 256)),
            ("flash_attention_offset, int8 single-shot",
             (1, 256, 256, 0, 256))):
        q, _, _, k, v = _contiguous_inputs(gen, dtype=torch.bfloat16, s=tk,
                                           vlens=[vlen] * b, tq=tq)
        qo = torch.full((b,), qoff, dtype=torch.int32, device="cuda")
        vl = torch.full((b,), vlen, dtype=torch.int32, device="cuda")
        _offset_err((q, k, v, k, v), qo, vl, "on the timed input", 2e-2)
        kpos = torch.arange(tk, device="cuda")
        qpos = qoff + torch.arange(tq, device="cuda")
        mask = ((kpos[None, :] < vlen) & (kpos[None, :] <= qpos[:, None]))
        pairs = sum(min(vlen, qoff + i + 1) for i in range(tq))
        nbytes = (2 * q.numel() * esz + b * hq * tq * 4
                  + b * vlen * hkv * d * esz * 2 + b * 8)
        args, _ = fa.prepare(q, k, v, qo, vl)
        b_ms, b_by = _bound(nbytes, 4.0 * b * hq * d * pairs, "bfloat16")

        def sdpa():
            return _sdpa(q, k, v, mask[None, None])
        rows[key] = {
            "ms": _ms(lambda: fa.launch(args)),
            "device_ms": _device_call_ms(lambda: fa.launch(args)),
            "wrapper_ms": _ms(lambda: fa.flash_attention_offset(q, k, v, qo,
                                                                vl)),
            "plain_ms": _ms(lambda: fa.flash_attention_offset_plain(
                q, k, v, qo, vl)),
            "library_ms": _ms(sdpa),
            "library_device_ms": _device_call_ms(sdpa),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B={b} Tq={tq} q_offset={qoff} vlen={vlen} Tk={tk} "
                     "Hq=15 Hkv=5 D=64 bf16"}
    rows.update(_train_kernel_times(gen))
    rows.update(_int8_kernel_times(gen))
    rows.update(_library_kernel_times())
    for name, row in rows.items():
        lib = (f"{row['library_ms']:.4f}ms" if row["library_ms"] is not None
               else "none")
        extra = "".join(
            f", {label} {row[k]:.4f}ms" for k, label in (
                ("device_ms", "kernel device time"),
                ("library_device_ms", "library device time")) if k in row)
        print(f"time {name} [{row['shape']}]: kernel {row['ms']:.4f}ms "
              f"(wrapper call {row['wrapper_ms']:.4f}ms), bound "
              f"{row['bound_ms']:.5f}ms by {row['bound_by']}, plain "
              f"{row['plain_ms']:.4f}ms, library {lib}{extra}")
    return rows


def _plan_of(fd, q, k, tables=None) -> str:
    """The split a decode call on these operands launches with (the
    wrapper's plan: paged pools with ``tables``, else contiguous caches)."""
    from repro_torch.kernels import build
    b, _, hq, d = q.shape
    if tables is not None:
        hkv, unit = k.shape[1], k.shape[2]
        max_len = tables.shape[1] * unit
    else:
        hkv, max_len, unit = k.shape[2], k.shape[1], fd.CONTIGUOUS_TILE
    p = fd.decode_plan(b, hkv, hq // hkv, d, max_len, unit, k.dtype,
                       build.sm_count(q.device))
    return f"split {p.split} x {p.splits}"


def _device_call_ms(fn, samples: int = 20, inner: int = 10) -> float:
    """Device time of one call of ``fn``: CUDA events around ``inner``
    back-to-back calls that the host queued behind a device sleep, so the
    device runs them without waiting for the host's launch path (what
    ``_ms`` times for a small kernel); median of ``samples``, over
    ``inner``.  The sleep doubles until it outlasts the host's queueing."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles, out = 1 << 22, []
    while len(out) < samples:
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        slept.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if queued_ms > 0.5 * _sleep_ms(cycles):
            cycles *= 2                 # the host may have let it idle
            if cycles > 1 << 32:
                _fail("the host queues too slowly to time the device")
            continue
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def _host_us(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn`` in µs: ``calls`` calls back to back
    on the host's clock, the device left to finish after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


_SLEEP_MS = {}


def _sleep_ms(cycles: int) -> float:
    """How long ``torch.cuda._sleep(cycles)`` keeps the device busy, ms."""
    if cycles not in _SLEEP_MS:
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_MS[cycles] = start.elapsed_time(end)
    return _SLEEP_MS[cycles]


def _train_kernel_times(gen) -> dict:
    """Rows 6-7 at the training shape (B = 8, T = 512, 15/5 heads, D = 64,
    bf16, causal): the fresh forward, and the dq and dk/dv kernels, each
    against its bound; the wrapper and plain times of the forward and of the
    whole backward; the library yardstick is SDPA (is_causal, enable_gqa) on
    [B, H, T, D] views, its forward for row 6 and its autograd backward for
    row 7 (the dq and dk/dv rows both carry the whole backward's plain and
    library times)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    b, t, hq, hkv, d, esz = 8, 512, 15, 5, 64, 2
    q, k, v, dout = _fresh_inputs(gen, dtype=torch.bfloat16, b=b, t=t)
    k, v = k.contiguous(), v.contiguous()      # the model's K/V layout
    errs = _fresh_errs(q, k, v, dout, True)
    if max(errs.values()) > 2e-2:
        _fail(f"fresh attention on the timed input: {errs}")
    out, lse = fa.flash_attention_fwd(q, k, v)
    pairs = t * (t + 1) // 2
    per_pair = 2.0 * d * b * hq              # flops of one product per pair
    io = b * t * (2 * hq + 2 * hkv) * d * esz   # q, dout (or out), k, v
    stats = 2 * b * hq * t * 4                  # lse and delta, fp32
    shape = "B=8 T=512 Hq=15 Hkv=5 D=64 bf16 causal"

    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)

    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (qs, ks, vs))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)
    lib_dout = dout.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (qg, kg, vg), lib_dout,
                                   retain_graph=True)

    fwd_args, _ = fa.prepare_fwd(q, k, v)
    dq_args, dkv_args, _ = fab.prepare(q, k, v, out, lse, dout)
    bwd_plain = _ms(lambda: fab.flash_attention_bwd_plain(
        q, k, v, out, lse, dout), samples=5, inner=2)
    bwd_lib = _ms(sdpa_bwd)
    bwd_wrapper = _ms(lambda: fab.flash_attention_bwd(q, k, v, out, lse,
                                                      dout))
    rows = {}
    b_ms, b_by = _bound(io + b * hq * t * 4, 2 * per_pair * pairs,
                        "bfloat16")
    bwd_lib_device = _device_call_ms(sdpa_bwd)
    bwd_device = _device_call_ms(lambda: fab.flash_attention_bwd(
        q, k, v, out, lse, dout))
    rows["flash_attention"] = {
        "ms": _ms(lambda: fa.launch(fwd_args)),
        "device_ms": _device_call_ms(lambda: fa.launch(fwd_args)),
        "wrapper_ms": _ms(lambda: fa.flash_attention_fwd(q, k, v)),
        "plain_ms": _ms(lambda: fa.flash_attention_fwd_plain(q, k, v),
                        samples=5, inner=2),
        "library_ms": _ms(sdpa),
        "library_device_ms": _device_call_ms(sdpa),
        "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    # dq: s, dp and dq products; reads q, k, v, dout, lse, delta, writes dq
    b_ms, b_by = _bound(io + stats + b * t * hq * d * esz,
                        3 * per_pair * pairs, "bfloat16")
    rows["flash_attention_bwd_dq"] = {
        "ms": _ms(lambda: fab.launch(dq_args)),
        "device_ms": _device_call_ms(lambda: fab.launch(dq_args)),
        "wrapper_ms": bwd_wrapper, "plain_ms": bwd_plain,
        "library_ms": bwd_lib, "library_device_ms": bwd_lib_device,
        "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    # dk/dv: s, dp, dk and dv products; writes dk and dv
    b_ms, b_by = _bound(io + stats + 2 * b * t * hkv * d * esz,
                        4 * per_pair * pairs, "bfloat16")
    rows["flash_attention_bwd_dkv"] = {
        "ms": _ms(lambda: fab.launch(dkv_args)),
        "device_ms": _device_call_ms(lambda: fab.launch(dkv_args)),
        "wrapper_ms": bwd_wrapper, "plain_ms": bwd_plain,
        "library_ms": bwd_lib, "library_device_ms": bwd_lib_device,
        "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    # the whole backward's bound (five products; out read for delta)
    b_ms, b_by = _bound(io + b * t * hq * d * esz + b * hq * t * 4
                        + b * t * (hq + 2 * hkv) * d * esz,
                        5 * per_pair * pairs, "bfloat16")
    print(f"time flash attention backward, both kernels [{shape}]: bound "
          f"{b_ms:.5f}ms by {b_by}; wrapper (delta + dq + dk/dv) "
          f"{bwd_wrapper:.4f}ms, device {bwd_device:.4f}ms; plain "
          f"{bwd_plain:.4f}ms, SDPA autograd backward {bwd_lib:.4f}ms, "
          f"device {bwd_lib_device:.4f}ms")
    return rows


def _int8_kernel_times(gen) -> dict:
    """The int8 forms at the int8 serving runs' shapes (bf16 q): paged
    decode over 8 slots of the pool (BS 16, vlen 66..329), contiguous decode
    over 8 slots of 328, and the paged prefill at row 3's chunk (64 tokens
    at offset 64, vlen 128), each first held against its plain version on
    the timed input.  Bounds count 1 byte per int8 K/V value read once, 2
    per bf16 scale, q read and out written once, and the two dequantizing
    multiplies per value beside the 4·D flops per (head, position).  No
    single PyTorch call computes a dequantize and attention."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    hq, d, hkv, esz = 15, 64, 5, 2
    rows = {}

    def kv_bytes(n):          # int8 K and V plus their bf16 scales
        return n * hkv * (2 * d + 2 * 2)

    vlens = [329, 290, 251, 212, 173, 134, 95, 66]
    q, _, pl, _, tp, vl = _int8_paged_inputs(gen, dtype=torch.bfloat16,
                                             bs=16, vlens=vlens)
    kw = dict(k_scale_pool=pl[2], v_scale_pool=pl[3])
    err = (fd.flash_decode_paged(q, pl[0], pl[1], tp, vl, **kw).float()
           - fd.flash_decode_paged_plain(q, pl[0], pl[1], tp, vl,
                                         **kw).float()).abs().max().item()
    if not err <= 2e-2:
        _fail(f"flash_decode_paged_int8 on the timed input: max abs err "
              f"{err:.3g} > 2e-2")
    nbytes = (2 * q.numel() * esz + kv_bytes(sum(vlens))
              + sum(-(-n // 16) for n in vlens) * 4 + len(vlens) * 4)
    ops = (4.0 * hq * d + 2.0 * hkv * d) * sum(vlens)
    args, _ = fd.prepare_paged(q, pl[0], pl[1], tp, vl, **kw)
    plan = _plan_of(fd, q, pl[0], tp)
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_decode_paged_int8"] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode_paged(q, pl[0], pl[1], tp,
                                                        vl, **kw)),
        "plain_ms": _ms(lambda: fd.flash_decode_paged_plain(
            q, pl[0], pl[1], tp, vl, **kw)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 Hq=15 Hkv=5 D=64 BS=16 int8 K/V, bf16 q, vlen "
                 f"{vlens}, {plan}"}

    vlens = [328, 289, 250, 211, 172, 133, 94, 65]
    cache = _int8_contiguous_inputs(gen, s=328, vlens=vlens)[4:]
    kw = dict(k_scale=cache[2], v_scale=cache[3])
    q = torch.randn(8, 1, hq, d, generator=gen).to(device="cuda",
                                                   dtype=torch.bfloat16)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    err = (fd.flash_decode(q, cache[0], cache[1], vl, **kw).float()
           - fd.flash_decode_plain(q, cache[0], cache[1], vl,
                                   **kw).float()).abs().max().item()
    if not err <= 2e-2:
        _fail(f"flash_decode_int8 on the timed input: max abs err {err:.3g}"
              " > 2e-2")
    nbytes = 2 * q.numel() * esz + kv_bytes(sum(vlens)) + len(vlens) * 4
    ops = (4.0 * hq * d + 2.0 * hkv * d) * sum(vlens)
    args, _ = fd.prepare(q, cache[0], cache[1], vl, **kw)
    plan = _plan_of(fd, q, cache[0])
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_decode_int8"] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode(q, cache[0], cache[1], vl,
                                                  **kw)),
        "plain_ms": _ms(lambda: fd.flash_decode_plain(q, cache[0], cache[1],
                                                      vl, **kw)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 S=328 Hq=15 Hkv=5 D=64 int8 K/V, bf16 q, vlen "
                 f"{vlens}, {plan}"}

    tq, qoff, vlen = 64, 64, 128
    q, _, pl, _, tp, vl = _int8_paged_inputs(gen, dtype=torch.bfloat16,
                                             bs=16, vlens=[vlen], tq=tq)
    qo = torch.tensor([qoff], dtype=torch.int32, device="cuda")
    kw = dict(k_scale_pool=pl[2], v_scale_pool=pl[3])
    out, _ = fa.flash_attention_paged(q, pl[0], pl[1], qo, vl, tp, **kw)
    want, _ = fa.flash_attention_paged_plain(q, pl[0], pl[1], qo, vl, tp,
                                             **kw)
    err = (out.float() - want.float()).abs().max().item()
    if not err <= 2e-2:
        _fail(f"flash_attention_paged_int8 on the timed input: max abs err "
              f"{err:.3g} > 2e-2")
    pairs = sum(min(vlen, qoff + i + 1) for i in range(tq))
    nbytes = (2 * q.numel() * esz + hq * tq * 4 + kv_bytes(vlen)
              + (vlen // 16) * 4 + 8)
    ops = 4.0 * hq * d * pairs + 2.0 * hkv * d * vlen
    args, _ = fa.prepare_paged(q, pl[0], pl[1], qo, vl, tp, **kw)
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_attention_paged_int8"] = {
        "ms": _ms(lambda: fa.launch(args)),
        "device_ms": _device_call_ms(lambda: fa.launch(args)),
        "wrapper_ms": _ms(lambda: fa.flash_attention_paged(
            q, pl[0], pl[1], qo, vl, tp, **kw)),
        "plain_ms": _ms(lambda: fa.flash_attention_paged_plain(
            q, pl[0], pl[1], qo, vl, tp, **kw)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": "B=1 Tq=64 q_offset=64 vlen=128 Hq=15 Hkv=5 D=64 BS=16 "
                 "int8 K/V, bf16 q"}
    return rows


# ---------------------------------------------------------------------------
# 9: the library surface at smollm-360m's logit shapes and the paper's
# regimes
# ---------------------------------------------------------------------------
def _library_input(r, v, dtype, seed, start=0):
    """x [R, V] on the card, randn × 4 from a seeded CUDA generator, with
    row 0 dead over its leading half (and over its whole first slice when
    the row streams in more than one), row 1 all -inf and row 2 dead over
    its last third; with ``start`` > 0 a contiguous view that begins
    ``start`` entries past a 16-byte boundary."""
    import torch
    from repro_torch.kernels import online_softmax as osk
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(r, v, generator=gen, device="cuda") * 4.0
    p = osk.plan(v, getattr(torch, dtype))
    dead = v // 2
    if p.design == "stream" and p.slices > 1:
        dead = max(dead, p.slice_vectors * p.vec)
    x[0, :dead] = float("-inf")
    x[1] = float("-inf")
    x[2, v - v // 3:] = float("-inf")
    x = x.to(getattr(torch, dtype))
    if start:
        buf = torch.empty(r * v + start, dtype=x.dtype, device="cuda")
        x = buf[start:].view(r, v).copy_(x)
        if x.data_ptr() % 16 == 0:
            _fail(f"library input [{r}, {v}] {dtype} starts on a 16-byte "
                  "boundary")
    return x


def _cpu_rows(r):
    """Rows held against the CPU: the three edge rows and a spread of the
    others (every row when R is small)."""
    if r <= LIBRARY_CPU_ROWS:
        return list(range(r))
    n = LIBRARY_CPU_ROWS - 3
    return [0, 1, 2] + sorted({3 + (i * (r - 4)) // (n - 1) for i in range(n)})


def _hold_library(what, x, ys, m, d) -> dict:
    """One input's kernel outputs against the plain versions on the CPU over
    the rows of ``_cpu_rows``: m equal, the exact normalizer's d within
    ``exact_error_bound`` of the plain d, (-inf, 0) on the dead row; each
    form's y within ``kernel_error_bound`` of the fp32 reference, relative
    to each entry (the bounds count relative roundings; y ≤ 1 makes them
    max-abs bounds too), the bf16 form within ``bf16_error_bound`` where
    that is not vacuous (V ≤ 2048), and each form within a derived
    tolerance of its own plain form: the bound (exact), twice the bound
    (exp2: both lie within it of the reference), the kernel's bound plus
    the plain bf16 form's measured distance from the reference (bf16, whose
    sequential-scan bound is vacuous past V = 2048).  On the card, every
    -inf entry gives y = 0 and every y is finite.  Returns {kernel: max abs
    error against its plain version}."""
    import torch
    from repro_torch.core import softmax_forms as sf
    from repro_torch.kernels import online_softmax as osk
    rows = _cpu_rows(x.shape[0])
    xc = x[rows].cpu()
    ref = osk.online_softmax_plain(xc.float())
    pm, pd = osk.online_normalizer_plain(xc)
    dk = d[rows].cpu()
    live = pd > 0
    rel = ((dk - pd).abs()[live] / pd[live]).max().item()
    if not torch.equal(m[rows].cpu(), pm) or rel > sf.exact_error_bound(xc) \
            or not torch.equal(dk[~live], pd[~live]) or d[1].item() != 0.0:
        _fail(f"online_normalizer {what}: m or d differs from the plain "
              f"version (d rel err {rel:.3g})")
    errs = {"online_normalizer": (dk - pd).abs().max().item()}
    dead = torch.isneginf(x)
    for form, y in ys.items():
        name = osk.KERNEL_NAMES[form]
        yc = y[rows].cpu().float()
        bound = osk.kernel_error_bound(xc, form)
        if form == "bf16" and x.shape[-1] <= 2048:
            bound = min(bound, sf.bf16_error_bound(xc)
                        + (sf.BF16_EPS if x.dtype == torch.bfloat16 else 0))
        plain = osk.online_softmax_plain(xc, form).float()
        tol = {"exact": bound, "exp2": 2 * bound,
               "bf16": bound + (plain - ref).abs().max().item()}[form]
        err = (yc - ref).abs()
        perr = (yc - plain).abs().max().item()
        if (err > bound * ref + 1e-30).any() or perr > tol:
            _fail(f"{name} {what}: max abs err {err.max().item():.3g} "
                  f"(bound {bound:.3g} of each entry), {perr:.3g} against "
                  f"its plain form (tol {tol:.3g})")
        if not torch.isfinite(y).all() or (y[dead] != 0).any():
            _fail(f"{name} {what}: non-finite y, or y != 0 at a -inf entry")
        errs[name] = perr
        print(f"library {name} {what}: max abs err {err.max().item():.3g} "
              f"vs the fp32 reference (bound {bound:.3g} of each entry), "
              f"{perr:.3g} vs its plain form (tol {tol:.3g}), the plain "
              f"form {(plain - ref).abs().max().item():.3g} from the "
              "reference; -inf rows 0")
    print(f"library online_normalizer {what}: m equal, d max rel err "
          f"{rel:.3g} (bound {sf.exact_error_bound(xc):.3g}), dead row "
          "(-inf, 0)")
    return errs


def phase_library():
    """Phase 9: ``dispatch.online_softmax`` under each softmax form and
    ``ops.online_normalizer`` on every shape of ``LIBRARY_SHAPES``, then
    ``dispatch.softmax_topk`` over ``TOPK_ROWS`` against its plain version
    on the card, then ``ops.softmax_topk``, the unflagged
    ``dispatch.softmax_topk`` (k = 5)
    and ``dispatch.online_softmax`` with a backward at [8, 49152] fp32, and
    ``dispatch.online_normalizer``'s refusal of a requires-grad input,
    between a reset and a read of the launch counts; each output and
    gradient held against the CPU's.  Returns (the counts, {kernel: max abs
    error against its plain version over the fp32 shapes})."""
    import torch
    from repro_torch.kernels import dispatch, ops
    from repro_torch.kernels import online_softmax as osk
    from repro_torch.kernels import softmax_topk as st
    dispatch.reset_launch_counts()
    calls = dict.fromkeys(KERNELS, 0)
    errs = {}
    for i, (r, v, dtype, start) in enumerate(LIBRARY_SHAPES):
        x = _library_input(r, v, dtype, seed=100 + i, start=start)
        ys = {}
        for form in dispatch.SOFTMAX_FORMS:
            prev = dispatch.set_softmax_form(form)
            try:
                ys[form] = dispatch.online_softmax(x)
            finally:
                dispatch.set_softmax_form(prev)
            calls[osk.KERNEL_NAMES[form]] += 1
        m, d = ops.online_normalizer(x)
        calls["online_normalizer"] += 1
        torch.cuda.synchronize()
        p = osk.plan(v, x.dtype)
        what = (f"[{r}, {v}] {dtype}{f' from +{start}' if start else ''} "
                f"({p.design}, {p.threads} threads, {p.slices} slices)")
        for name, err in _hold_library(what, x, ys, m, d).items():
            if dtype == "float32":
                errs[name] = max(errs.get(name, 0.0), err)
        del x, ys, m, d

    # softmax_topk over more rows than grid.y holds, against its plain
    # version on the card
    r, v = TOPK_ROWS
    x = torch.randn(r, v, generator=torch.Generator(device="cuda")
                    .manual_seed(11), device="cuda") * 4.0
    got = dispatch.softmax_topk(x, 5)
    calls["softmax_topk"] += 1
    want = st.softmax_topk_plain(x, 5)
    torch.cuda.synchronize()
    if not torch.equal(got.indices.long(), want.indices) or not (
            torch.allclose(got.values, want.values, rtol=1e-5, atol=0.0)
            and torch.allclose(got.logsumexp, want.logsumexp, rtol=1e-5,
                               atol=0.0)):
        _fail(f"dispatch.softmax_topk [{r}, {v}]: indices, values or lse "
              "differ from the plain version")
    print(f"library dispatch.softmax_topk [{r}, {v}] fp32 k=5: indices "
          "equal to the plain version's, values and lse within rtol 1e-5")
    del x, got, want

    x0 = torch.randn(8, 49152, generator=torch.Generator().manual_seed(9))
    w = torch.randn(8, 49152, generator=torch.Generator().manual_seed(10))
    entries = {
        "ops.softmax_topk": lambda x: _topk_loss(ops.softmax_topk(x, 5)),
        "dispatch.softmax_topk": lambda x: _topk_loss(
            dispatch.softmax_topk(x, 5)),
        "dispatch.online_softmax": lambda x: dispatch.online_softmax(x) * w.to(
            x.device)}
    for what, loss in entries.items():
        grads = {}
        for dev in ("cuda", "cpu"):
            xg = (x0 * 4.0).to(dev).requires_grad_(True)
            out = loss(xg)
            if out.grad_fn is None:
                _fail(f"{what} on {dev}: a requires-grad input gave a "
                      "detached result")
            out.sum().backward()
            grads[dev] = xg.grad.cpu()
        calls["online_softmax" if "online" in what else "softmax_topk"] += 1
        scale = grads["cpu"].abs().max().item()
        gerr = (grads["cuda"] - grads["cpu"]).abs().max().item()
        if not gerr <= TOPK_GRAD_RTOL * scale:
            _fail(f"{what} gradient: max abs diff {gerr:.3g} > "
                  f"{TOPK_GRAD_RTOL} x {scale:.3g}")
        print(f"library {what} [8, 49152] fp32 backward: gradient max abs "
              f"diff card vs CPU {gerr:.3g} (tol {TOPK_GRAD_RTOL} of the "
              f"largest entry, {scale:.3g})")
    try:
        dispatch.online_normalizer(x0.cuda().requires_grad_(True))
        _fail("dispatch.online_normalizer: a requires-grad input on CUDA "
              "did not raise (the kernel has no backward)")
    except NotImplementedError:
        print("library dispatch.online_normalizer: a requires-grad input "
              "on CUDA raises NotImplementedError (no backward), nothing "
              "launched")
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    # one counted launch per wrapper call (osk.LAUNCHES_PER_CALL; the
    # softmax_topk wrapper counts one per call too)
    want = {k: n * osk.LAUNCHES_PER_CALL for k, n in calls.items()}
    if counts != want:
        _fail(f"library: launches {counts}, its calls imply {want}")
    print(f"library launches: {counts} = {len(LIBRARY_SHAPES)} shapes x "
          "(3 forms + the normalizer), 1 softmax_topk over "
          f"{TOPK_ROWS[0]} rows, then 2 softmax_topk and 1 online_softmax "
          "with a backward")
    return counts, errs


def _topk_loss(out):
    """A scalar-able loss of both differentiable outputs of softmax+top-k."""
    return (out.values ** 2).sum() + 0.1 * (out.logsumexp ** 2).sum()


def _library_kernel_times() -> dict:
    """The four library kernels at ``LIBRARY_TIMED`` (each first held
    against its plain version on the timed input), then the effective
    accesses per element of the exact softmax and the normalizer beside
    torch.softmax and torch.logsumexp at every shape of ``LIBRARY_SHAPES``
    (ms × 3.35 TB/s over the bytes of x, from back-to-back calls and from
    the device time of calls queued ahead): the paper counts 3 for the online softmax, 4
    for safe softmax and 1 for the normalizer; then the exact softmax in
    both designs at ``LIBRARY_LIMIT``, each held against its plain version
    first.  The bounds count x read once and y (or m and d) written
    once."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import online_softmax as osk
    r, v, dtype = LIBRARY_TIMED
    x = _library_input(r, v, dtype, seed=200)
    n, esz = r * v, x.element_size()
    shape = f"x [{r}, {v}] {dtype}"
    calls = {form: osk.prepare(x, form) for form in osk.FORM_CODES}
    md_call, (m, d) = osk.prepare_normalizer(x)
    for call, _ in calls.values():
        osk.launch(call)
    osk.launch(md_call)
    torch.cuda.synchronize()
    _hold_library(f"[{r}, {v}] {dtype} (timed input)", x,
                  {f: y for f, (_, y) in calls.items()}, m, d)
    rows = {}
    for form, (call, _) in calls.items():
        b_ms, b_by = _bound(2 * n * esz, 4.0 * n, "float32")
        slow = form != "exact"          # the bf16/exp2 plain forms loop
        rows[osk.KERNEL_NAMES[form]] = {
            "ms": _ms(lambda: osk.launch(call)),
            "device_ms": _device_call_ms(lambda: osk.launch(call)),
            "library_device_ms": _device_call_ms(
                lambda: torch.softmax(x, -1)),
            "wrapper_ms": _ms(lambda: osk.online_softmax(x, form)),
            "plain_ms": _ms(lambda: osk.online_softmax_plain(x, form),
                            samples=3 if slow else 5, inner=1, warmup=1),
            "library_ms": _ms(lambda: torch.softmax(x, -1)),
            "library_call": "torch.softmax(x, -1)",
            "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    b_ms, b_by = _bound(n * esz + 8 * r, 4.0 * n, "float32")
    rows["online_normalizer"] = {
        "ms": _ms(lambda: osk.launch(md_call)),
        "device_ms": _device_call_ms(lambda: osk.launch(md_call)),
        "library_device_ms": _device_call_ms(
            lambda: torch.logsumexp(x, -1)),
        "wrapper_ms": _ms(lambda: osk.online_normalizer(x)),
        "plain_ms": _ms(lambda: osk.online_normalizer_plain(x), samples=5,
                        inner=1, warmup=1),
        "library_ms": _ms(lambda: torch.logsumexp(x, -1)),
        "library_call": "torch.logsumexp(x, -1)",
        "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    del x, calls, md_call, m, d

    for r, v, dtype, start in LIBRARY_SHAPES:
        x = _library_input(r, v, dtype, seed=300, start=start)
        nbytes = x.numel() * x.element_size()
        call, _ = osk.prepare(x, "exact")
        md_call, _ = osk.prepare_normalizer(x)
        fns = {"online softmax": lambda: osk.launch(call),
               "torch.softmax": lambda: torch.softmax(x, -1),
               "online normalizer": lambda: osk.launch(md_call),
               "torch.logsumexp": lambda: torch.logsumexp(x, -1)}
        t = {k: (_ms(fn), _device_call_ms(fn)) for k, fn in fns.items()}
        p = osk.plan(v, x.dtype)
        print(f"accesses per element [{r}, {v}] {dtype}"
              f"{f' from +{start}' if start else ''} ({p.design}): "
              + ", ".join(f"{k} {ms * 1e-3 * HBM_BYTES_PER_S / nbytes:.3f} "
                          f"({ms:.4f}ms; device {dev:.4f}ms, "
                          f"{dev * 1e-3 * HBM_BYTES_PER_S / nbytes:.3f})"
                          for k, (ms, dev) in t.items())
              + "; the paper's model: online softmax 3, safe softmax 4, "
              "normalizer 1")
        del x, call, md_call

    # what one call costs the host at the smallest timed rows: where it
    # exceeds the kernel's device time, back-to-back launches time the host
    x = _library_input(4000, 1000, "float32", seed=500)
    call, _ = osk.prepare(x, "exact")
    host = {"osk.launch (the kernel's launch path)": lambda: osk.launch(call),
            "dispatch.online_softmax (the entry point)":
                lambda: dispatch.online_softmax(x),
            "torch.softmax": lambda: torch.softmax(x, -1)}
    print("host time per call [4000, 1000] float32: " + ", ".join(
        f"{k} {_host_us(fn):.1f}us" for k, fn in host.items()))
    del x, call

    # both designs at the rows either side of the row-resident limit
    for r, v, dtype in LIBRARY_LIMIT:
        x = _library_input(r, v, dtype, seed=400)
        nbytes = x.numel() * x.element_size()
        auto = osk.plan(v, x.dtype)
        nvec = -(-v // auto.vec)
        other = (osk.Plan("stream", osk.STREAM_THREADS, auto.vec,
                          osk.SLICE_VECTORS, -(-nvec // osk.SLICE_VECTORS), 0)
                 if auto.design != "stream" else
                 osk.Plan("block", osk.MAX_ROW_THREADS, auto.vec,
                          osk.SLICE_VECTORS, 1, nvec * osk.VEC_BYTES))
        out = []
        for p in (auto, other):
            call, y = osk.prepare_plan(x, "exact", p)
            osk.launch(call)
            torch.cuda.synchronize()
            _hold_library(f"[{r}, {v}] {dtype} as {p.design}", x,
                          {"exact": y}, *osk.online_normalizer(x))
            ms = _ms(lambda: osk.launch(call))
            dev = _device_call_ms(lambda: osk.launch(call))
            out.append(f"{p.design}{' (the plan)' if p is auto else ''} "
                       f"{ms:.4f}ms, device {dev:.4f}ms = "
                       f"{dev * 1e-3 * HBM_BYTES_PER_S / nbytes:.3f} "
                       "accesses")
        print(f"row-resident limit {osk.RESIDENT_ROW_BYTES} B: [{r}, {v}] "
              f"{dtype}, {v * x.element_size()} B a row: " + "; ".join(out))
        del x, call, y
    return rows


def _timed(phase, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # fp32 means fp32: the parity phase compares against the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = phase_device()
    _timed(phase_build)
    errs = _timed(phase_kernels)
    counts, serve_ctx = _timed(phase_serve)
    _timed(phase_parity)
    _timed(phase_parity_int8)
    counts["train"], train_ctx = _timed(phase_train)
    _timed(phase_train_parity)
    times = _timed(phase_times)
    _timed(phase_steps, serve_ctx, train_ctx)
    counts["library"], lib_errs = _timed(phase_library)
    errs.update(lib_errs)
    kernels = []
    for name, meta in KERNELS.items():
        row, path = times[name], KERNEL_PATH[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "path": path,
            "launches": counts[path][name] if path in counts else 0,
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "wrapper_ms": row["wrapper_ms"],
            **{k: row[k] for k in ("device_ms", "library_device_ms")
               if k in row}})
    # again at the end, beside the numbers, where a reader of the last
    # lines of the output finds it
    print(f"nvidia-smi: {_smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
