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

    An MLA layer (``cfg.mla``) counts the absorbed decode's products in
    place of q, k, v and o: ``wdq`` [D, Rq], ``wuq`` [Rq, H·(Dn+Dr)],
    ``wdkv`` [D, R+Dr], the W_uk absorption (q_nope [H, Dn] against
    [R, H, Dn]), the W_uv one (the context [H, R] against [R, H, Dv]) and
    ``wo`` [H·Dv, D], each 2 × its parameters × ``batch``; its attention
    2·H·(R + Dr + R) flops per live key and layer (every head scores the
    (R + Dr)-wide latent row and takes the R-wide value, which is the same
    row's c); and its cache bytes the latent row, R + Dr elements in the
    model dtype per live key and layer, read once (V is that c, not read
    again; an int8 config keeps fp latents).

    The recurrent models (``cfg.ssm`` / ``cfg.xlstm``, ``_recurrent_cost``)
    count, a row each, their layers' projections (2 × parameters flops,
    parameters × element size bytes) and their state's arithmetic and
    bytes: a Mamba2 layer's ``w_zx``, ``w_bc``, ``w_dt`` and ``w_out``, its
    conv's 2·width·(inner + 2N) flops, the SSD step's 5·H·N·P (decay and
    outer-product update, 3; the read-out C·S, 2) and the fp32 state and
    the conv tails read and written once; an mLSTM layer's ``w_up``, ``wq``
    / ``wk`` / ``wv``, ``w_down`` and the fp32 ``w_if``, its conv, 6·H·Dh²
    for C (update 4, read-out 2) and 6·H·Dh for n, and C, n, m and the conv
    tail read and written; an sLSTM layer's fp32 gate projection [D, 4D]
    and recurrent matrices [4, H, Dh, Dh] and its gated MLP, and its four
    fp32 state vectors read and written.  zamba2's shared block counts as
    a dense layer at every one of its calls (its weights are read again
    by each: 134 MB at full width does not stay on chip between calls),
    each call attending over its own live K/V.  The conv weights, norms and
    per-head vectors are left out, as the norms are above.

    An encoder-decoder decode step (``cfg.family == "encdec"``,
    ``_encdec_cost``) runs the decoder alone: each layer's self-attention
    projections, the cross-attention's q and o (its K/V are cached) and
    the GELU MLP, 2 × parameters × ``batch`` flops and the weights read
    once; its attention 4·Hq·D flops per key over the live self keys and
    every row's ``encoder_seq_len`` cross keys, and those keys' K/V read
    once; the tied head as above.  The paged step's gather of the cross
    blocks into a slot batch (a copy of them) is left out.
    """
    if cfg.family == "encdec":
        return _encdec_cost(cfg, batch, live_lens)
    if cfg.ssm is not None or cfg.xlstm is not None:
        return _recurrent_cost(cfg, batch, live_lens)
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.head_dim or d // hq
    layers, vocab = cfg.num_layers, cfg.vocab_size
    w = _ITEMSIZE[cfg.dtype]
    mats = 3 if cfg.act == "silu" else 2
    attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
    m = cfg.mla
    if m is not None:
        attn = (d * m.q_lora_rank
                + m.q_lora_rank * hq * (m.qk_nope_head_dim
                                        + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * hq * (m.qk_nope_head_dim + m.v_head_dim)
                + hq * m.v_head_dim * d)
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
    if m is None:
        per_key = 4 * hq * dh
        kv_entries = live * layers * 2 * hkv
        kv_bytes = (kv_entries * dh + 2 * kv_entries
                    if cfg.kv_cache_dtype == "int8"
                    else kv_entries * dh * w)
    else:
        row = m.kv_lora_rank + m.qk_rope_head_dim
        per_key = 2 * hq * (row + m.kv_lora_rank)
        kv_bytes = live * layers * row * w
    flops = ((2 * attn * batch + ffn_flops) * layers
             + per_key * live * layers + 2 * d * vocab * batch)
    nbytes = ((attn * w + ffn_bytes) * layers + d * vocab * w + kv_bytes
              + batch * vocab * 4)
    return {"flops": float(flops), "bytes_accessed": float(nbytes),
            "dtype": cfg.dtype}


def _recurrent_cost(cfg, batch: int, live_lens: Sequence[int]) -> dict:
    """``decode_step_cost`` of an xLSTM or hybrid (Mamba2 + shared block)
    model: see there."""
    from repro_torch.models import transformer
    d, b, vocab = cfg.d_model, batch, cfg.vocab_size
    w = _ITEMSIZE[cfg.dtype]
    counts = transformer.layer_counts(cfg)
    flops = 2 * d * vocab * b
    nbytes = d * vocab * w + b * vocab * 4
    sc, xc = cfg.ssm, cfg.xlstm
    if counts.get("mamba"):
        inner = sc.expand * d
        h, n = inner // sc.head_dim, sc.d_state
        proj = d * 2 * inner + d * 2 * n + d * h + inner * d
        state = h * n * sc.head_dim
        tails = (sc.d_conv - 1) * (inner + 2 * n)
        flops += counts["mamba"] * b * (2 * proj + 5 * state
                                        + 2 * sc.d_conv * (inner + 2 * n))
        nbytes += counts["mamba"] * (proj * w
                                     + 2 * b * (state * 4 + tails * w))
    if counts.get("mlstm"):
        inner = xc.expand * d
        hh = xc.num_heads
        dh = inner // hh
        proj, w_if = d * 2 * inner + 3 * inner * inner + inner * d, \
            inner * 2 * hh
        st = hh * dh * dh + hh * dh
        flops += counts["mlstm"] * b * (2 * (proj + w_if)
                                        + 2 * xc.conv_width * inner
                                        + 6 * hh * dh * dh + 6 * hh * dh)
        nbytes += counts["mlstm"] * (
            proj * w + w_if * 4
            + 2 * b * (st * 4 + hh * 4 + (xc.conv_width - 1) * inner * w))
    if counts.get("slstm"):
        dh = d // xc.num_heads
        gates, rec = d * 4 * d, 4 * xc.num_heads * dh * dh
        mlp = 3 * d * (int(d * 4 / 3 / 64) * 64 or 64)
        flops += counts["slstm"] * b * 2 * (gates + rec + mlp)
        nbytes += counts["slstm"] * ((gates + rec) * 4 + mlp * w
                                     + 2 * b * 4 * d * 4)
    if counts.get("attn"):
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        dh = cfg.resolved_head_dim
        dense = (d * hq * dh + 2 * d * hkv * dh + hq * dh * d
                 + (3 if cfg.act == "silu" else 2) * d * cfg.d_ff)
        live = sum(int(x) for x in live_lens)
        flops += counts["attn"] * (2 * dense * b + 4 * hq * dh * live)
        nbytes += counts["attn"] * (dense * w + live * 2 * hkv * dh * w)
    return {"flops": float(flops), "bytes_accessed": float(nbytes),
            "dtype": cfg.dtype}


def _encdec_cost(cfg, batch: int, live_lens: Sequence[int]) -> dict:
    """``decode_step_cost`` of an encoder-decoder's decode step: see
    there."""
    d, b, vocab = cfg.d_model, batch, cfg.vocab_size
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    w = _ITEMSIZE[cfg.dtype]
    layer = (d * hq * dh + 2 * d * hkv * dh + hq * dh * d   # self q k v o
             + 2 * hq * dh * d                             # cross q, o
             + (3 if cfg.act == "silu" else 2) * d * cfg.d_ff)
    keys = sum(int(x) for x in live_lens) + len(live_lens) \
        * cfg.encoder_seq_len
    n = cfg.num_layers
    flops = n * (2 * layer * b + 4 * hq * dh * keys) + 2 * d * vocab * b
    nbytes = (n * (layer * w + keys * 2 * hkv * dh * w) + d * vocab * w
              + b * vocab * 4)
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
