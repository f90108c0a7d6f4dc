"""Kernel profiling hooks of the port: dispatch paths, kernel plans, and
the decode step's cost.

Port of ``src/repro/obs/kernels.py``.  :func:`record_path` counts each
op's path: ``"cuda"`` where a kernel module counts a launch, ``"cpu"``
where ``kernels/dispatch.py`` runs a plain version.  The kernel wrappers call
:func:`record_autotune` with the plans they launch under — the decode
split (``flash_decode.decode_plan``) and the softmax+top-k split
(``softmax_topk.plan``), what the port computes where the reference swept
TPU tiles.  The scheduler hands its first decode step to
:func:`profile_step` once :func:`enable_profiling` armed it.  The reference
attached XLA's cost analysis to the compiled step; the port has no XLA, so
:func:`profile_step` records the analytic count of :func:`decode_step_cost`
and, on the card, queues a replay of the step that :func:`run_pending`
runs under ``torch.profiler`` after the serve, recording its kernels.

Recording is plain-dict bookkeeping, and nothing here imports torch at
module load.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

from repro_torch.obs import metrics as _metrics

#: The roofline the profile's ``bound_ms`` is taken against: H100 SXM HBM3
#: bandwidth and dense peak rates per weight type (bf16 on the tensor
#: cores; fp32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
_ITEMSIZE = {"bfloat16": 2, "float32": 4}

_paths: Dict[str, Dict[str, Any]] = {}
_autotune: Dict[tuple, Any] = {}
_costs: Dict[str, Dict[str, Any]] = {}
_profiling = False
_pending: List[tuple] = []      # (label, dtype, device, replay) to profile
_dropped: List[int] = []        # the attempt of each dropped session

#: Host calls that launch work on the card, as the profiler names them.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch")
#: The kernel ``torch.cuda._sleep`` launches (as :func:`kernel_name` gives
#: it): each profiler session's first launch, left out of what it recorded.
WARMUP_KERNEL = "at::cuda::spin_kernel"
#: Sessions :func:`profile_session` opens before it gives up on dropped
#: ones: a process that opens a few hundred (``chip_smoke.py``'s kernel
#: checks) has seen the card's profiler drop three in a row.
SESSION_TRIES = 6


def enable_profiling() -> None:
    """Arm :func:`profile_step` (on the card :func:`run_pending` replays
    the step under ``torch.profiler``, so it is opt-in even when metrics
    are on)."""
    global _profiling
    _profiling = True


def disable_profiling() -> None:
    global _profiling
    _profiling = False


def profiling_enabled() -> bool:
    return _profiling


def record_path(op: str, path: str) -> None:
    """An op resolved: ``"cuda"`` (its kernel launches) or ``"cpu"`` (its
    plain version runs).  ``op`` is the kernel's launch-count name."""
    entry = _paths.get(op)
    if entry is None:
        entry = _paths[op] = {"path": path, "count": 0}
    entry["path"] = path
    entry["count"] += 1


def record_autotune(kind: str, key: Any, decision) -> None:
    """A kernel plan (a ``NamedTuple`` or a mapping) was used for ``key``,
    the planner's arguments.  Stored as given; :func:`snapshot` renders
    it."""
    _autotune[(kind, key)] = decision


def record_cost(label: str, cost: Dict[str, Any]) -> None:
    """Store a step's cost: ``flops`` and ``bytes_accessed``, and from a
    card's profile ``device_ms``, ``bound_ms`` and ``kernels``."""
    _costs[label] = dict(cost)
    if _metrics.enabled():
        _metrics.gauge(f"kernels.{label}.flops").set(cost["flops"])
        _metrics.gauge(f"kernels.{label}.bytes_accessed").set(
            cost["bytes_accessed"])


def decode_step_cost(cfg, batch: int, live_lens: Sequence[int]) -> dict:
    """Analytic count of one decode step of ``batch`` rows whose live rows
    attend over ``live_lens`` keys each (the cache after the step's write).

    ``flops``: 2 × the parameters of every layer matmul (q, k, v, o and
    the MLP's two or three) × ``batch``, plus the attention's 4·Hq·D per
    live key and layer (QKᵀ and PV), plus the LM head's 2·d·V × ``batch``.
    An MoE layer (``cfg.moe``) counts, in place of the MLP, what the port's
    one-hot form computes (``layers.moe_apply``): each row is a group of
    one token, so each of the E_pad experts gets a bucket of C = max(
    ceil(K·capacity_factor/E), 4) places a row; the fp32 router 2·d·E,
    the dispatch and combine products 2·E_pad·C·d each, the experts' three
    products 2·E_pad·C·d·F each (every bucket place, used or not), all ×
    ``batch``, and the shared expert as an MLP of ``d_ff_shared``.
    ``bytes_accessed``: those weights read once in ``cfg.dtype`` (an MoE
    layer: the router in fp32 and every padded expert, picked or not, as
    the batched products read them), the live K/V read once (int8 plus its
    bf16 scale per position and KV head when the cache is quantized), and
    the fp32 logits [batch, V] written once.  Norms, RoPE, the embedding
    gather, the router's top-k and one-hot bookkeeping and the sampler's k
    entries are left out.
    """
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.head_dim or d // hq
    layers, vocab = cfg.num_layers, cfg.vocab_size
    w = _ITEMSIZE[cfg.dtype]
    mats = 3 if cfg.act == "silu" else 2
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    mc = cfg.moe
    if mc is None:
        ffn_flops = 2 * mats * d * cfg.d_ff * batch
        ffn_bytes = mats * d * cfg.d_ff * w
    else:
        e, e_pad = mc.num_experts, mc.pad_experts_to or mc.num_experts
        cap = max(math.ceil(mc.experts_per_token * mc.capacity_factor / e),
                  4)
        places = e_pad * cap * batch
        ffn_flops = (2 * d * e * batch + 2 * 2 * places * d
                     + 3 * 2 * places * d * mc.d_ff_expert
                     + 2 * mats * d * mc.d_ff_shared * batch)
        ffn_bytes = (d * e * 4 + 3 * e_pad * d * mc.d_ff_expert * w
                     + mats * d * mc.d_ff_shared * w)
    live = sum(int(n) for n in live_lens)
    flops = ((2 * attn * batch + ffn_flops) * layers
             + 4 * hq * dh * live * layers + 2 * d * vocab * batch)
    kv_entries = live * layers * 2 * hkv
    kv_bytes = (kv_entries * dh + 2 * kv_entries
                if cfg.kv_cache_dtype == "int8" else kv_entries * dh * w)
    nbytes = ((attn * w + ffn_bytes) * layers + d * vocab * w + kv_bytes
              + batch * vocab * 4)
    return {"flops": float(flops), "bytes_accessed": float(nbytes),
            "dtype": cfg.dtype}


def kernel_name(key: str) -> str:
    """A profiler event's function name without its return type, an
    anonymous namespace, template arguments or parameters."""
    name = key.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return name.strip()


def profile_step(fn, label: str, *args, cost: dict, device="cpu",
                 **kwargs) -> None:
    """Record ``costs[label]`` = ``cost`` (from :func:`decode_step_cost`)
    and, on a CUDA ``device``, queue ``fn(*args, **kwargs)`` — a replay of
    the step on private copies of its inputs — for :func:`run_pending`,
    which runs it under ``torch.profiler`` and adds ``device_ms`` (the sum
    of its device events), ``kernels`` (device ms and calls by kernel name)
    and ``bound_ms`` = max(bytes / HBM rate, flops / peak rate of the
    weights' type).  A profiler session slows every later launch of its
    process, so the scheduler queues its first decode step here rather than
    running it under one while it serves."""
    record_cost(label, {k: v for k, v in cost.items() if k != "dtype"})
    if getattr(device, "type", device) == "cuda":
        _pending.append((label, cost["dtype"], device,
                         lambda: fn(*args, **kwargs)))


def run_pending() -> None:
    """Run the queued step replays, each in a :func:`profile_session`,
    and add their device figures to their ``costs`` entries.  Raises as
    that does."""
    while _pending:
        label, dtype, device, replay = _pending.pop(0)
        _, prof = profile_session(replay, device)
        kernels: Dict[str, Dict[str, float]] = {}
        for evt in prof.key_averages():
            name = kernel_name(evt.key)
            if (not str(evt.device_type).endswith("CUDA")
                    or name == WARMUP_KERNEL):
                continue
            k = kernels.setdefault(name, {"ms": 0.0, "calls": 0})
            k["ms"] += evt.self_device_time_total / 1e3
            k["calls"] += evt.count
        rec = dict(_costs[label], kernels=kernels,
                   device_ms=sum(k["ms"] for k in kernels.values()))
        rec["bound_ms"] = 1e3 * max(rec["bytes_accessed"] / HBM_BYTES_PER_S,
                                    rec["flops"] / PEAK_OPS[dtype])
        record_cost(label, rec)


def _cuda_launches() -> int:
    return sum(v["count"] for v in _paths.values() if v["path"] == "cuda")


def profile_session(fn, device=None, *, cpu: bool = True):
    """``fn()`` under ``torch.profiler`` (CUDA activity, and CPU's with
    ``cpu``) up to a device synchronize: (its result, the profile).  The
    card's profiler now and then loses the kernels of a session's first
    launches, or of a whole session, so each session first launches
    :data:`WARMUP_KERNEL` and waits for it.  A session that launched
    kernels all the same (the port's launch sites counted one, or the
    profiler saw a CUDA launch call besides the warm-up's) but recorded no
    device event besides the warm-up was dropped and runs again, at most
    :data:`SESSION_TRIES` in all, so ``fn`` must be safe to repeat.  A
    session that launched nothing raises: the port runs its kernels or
    fails, and an empty profile would hide that.  So does the last session
    dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, SESSION_TRIES + 1):
        before = _cuda_launches()
        with profile(activities=acts) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
            out = fn()
            torch.cuda.synchronize(device)
        events = prof.key_averages()
        if any(str(e.device_type).endswith("CUDA")
               and kernel_name(e.key) != WARMUP_KERNEL for e in events):
            return out, prof
        calls = sum(e.count for e in events
                    if e.key.startswith(LAUNCH_CALLS))
        if _cuda_launches() == before and calls <= 1:
            raise RuntimeError("torch.profiler saw no CUDA kernel: the "
                               "session launched none")
        _dropped.append(attempt)
    raise RuntimeError(f"torch.profiler saw no CUDA kernel in "
                       f"{SESSION_TRIES} sessions that launched kernels")


def _plain(decision) -> Dict[str, Any]:
    return dict(decision._asdict() if hasattr(decision, "_asdict")
                else decision)


def snapshot() -> Dict[str, Any]:
    return {
        "paths": {k: dict(v) for k, v in sorted(_paths.items())},
        "autotune": dict(sorted((f"{kind}/{key}", _plain(v))
                                for (kind, key), v in _autotune.items())),
        "costs": {k: dict(v) for k, v in sorted(_costs.items())},
    }


def dropped_sessions() -> int:
    """Sessions that launched kernels but recorded no device event (each
    run again by :func:`profile_session`) since :func:`reset`."""
    return len(_dropped)


def reset() -> None:
    _paths.clear()
    _autotune.clear()
    _costs.clear()
    _pending.clear()
    _dropped.clear()
