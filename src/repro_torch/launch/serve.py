"""Serving launcher of the port: continuous batching and the lockstep
baseline.

``python -m repro_torch.launch.serve --continuous [--paged] [--smoke]
[--device cpu]`` serves Poisson-staggered synthetic requests (the
reference's workload generator, same draws) through a ``ReplicaRouter`` of
``--replicas`` engines (one by default; more are routed by prefix
affinity, or round-robin with ``--no-affinity``) — over the slot pool, or
with ``--paged`` over the block pool with a shared synthetic prompt prefix
— and prints the reference's report lines: throughput, p50/p95 per-token
latency, decode steps and prefill chunks, occupancy against the
drain-and-refill bound, paged the block pool's accounting, and with more
than one replica the router's.  ``--priority-classes N`` draws each
request's class, ``--slo-ms`` gives class 0 a deadline, and paged a request
that cannot be placed swaps out lower-priority decodes through host memory
(``--no-preempt`` turns that off); the report then adds each class's
latencies and phases, the SLO attainment and the preemption and swap
counts.  ``--trace FILE`` writes the serve's Chrome ``trace_event`` spans
(one tracer shared by the replicas, a pid each), ``--trace DIR/`` one
``replica{i}.json`` per replica plus a clock-aligned ``merged.json``;
``--metrics`` turns the metrics registry and the kernel profile on and
prints each op's kernel path, the profiled decode step's cost (on the card
the first decode step is replayed under ``torch.profiler`` once the serve
is over, so the serve's own numbers are taken without a profiler session)
and the histograms.  Without ``--continuous`` the lockstep baseline runs:
one batch of ``--batch`` prompts prefilled together, then decoded together
at one shared cache length, reporting prefill and decode times and the
first row's token ids.  The model runs on the card unless ``--device
cpu`` asks for the CPU, where the kernels' plain versions serve.
``--kv-cache-dtype int8`` stores K/V as int8 with a bf16 scale per
(position, KV head) in every mode: each prompt prefills in one chunk, paged
blocks are never shared, and decode reads the int8 cache through the
dequantizing kernels.

Port of ``src/repro/launch/serve.py`` (``_lockstep`` at line 44,
``_continuous`` at 88, ``main`` at 264); weights and sampling generators
come from seed 0.  The lockstep prompts come from a seeded numpy generator
(``default_rng(1)``), not from ``jax.random.randint``, which the port does
not reproduce.  Every replica shares the same weights.  ``--trace`` and
``--metrics`` serve the continuous mode only, as in the reference; the
lockstep baseline refuses them.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.core.topk_fusion import topk_sample
from repro_torch.models import transformer
from repro_torch.obs import clock as obs_clock
from repro_torch.obs import kernels as obs_kernels
from repro_torch.obs import merge as obs_merge
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import engine
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.router import ReplicaRouter


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and KV pool (default "
                         "cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="prompts of the lockstep batch")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over Poisson arrivals")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch rows of the pool")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic requests to serve")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="mean arrivals per scheduler tick")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens prefilled per tick")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: block pool + prefix sharing "
                         "(continuous mode)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="KV block size in tokens")
    ap.add_argument("--blocks", type=int, default=0,
                    help="pool capacity in blocks (0 = every slot at full "
                         "length)")
    ap.add_argument("--shared-prefix", type=int, default=8,
                    help="shared synthetic prompt prefix length")
    ap.add_argument("--kv-cache-dtype", default="",
                    help="override the config's KV-cache dtype (int8: "
                         "int8 K/V with a bf16 scale per position and KV "
                         "head, dequantized after the read; empty = config "
                         "default)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help="priority classes of the workload (>1 draws each "
                         "request's class; smaller = more urgent)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="completion deadline of class-0 requests (0 = "
                         "none)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="no preempt-and-swap of lower-priority decodes "
                         "(paged; priorities only order admission)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the router, sharing the "
                         "weights")
    ap.add_argument("--no-affinity", action="store_true",
                    help="route round-robin instead of by prefix affinity")
    ap.add_argument("--trace", default="",
                    help="write request-lifecycle and scheduler spans to "
                         "this Chrome trace_event file (continuous mode; "
                         "open in Perfetto or summarize with "
                         "repro_torch.obs.report); a directory (trailing "
                         "'/' or an existing one) gets one replica{i}.json "
                         "per replica plus a clock-aligned merged.json")
    ap.add_argument("--metrics", action="store_true",
                    help="turn on the metrics registry and the kernel "
                         "profile (continuous mode); prints each op's "
                         "kernel path, the profiled decode step's cost and "
                         "the histograms after the run")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous (the lockstep "
                         "baseline keeps its contiguous cache)")
    for cond, what in ((bool(args.trace), "--trace"),
                       (args.metrics, "--metrics")):
        if cond and not args.continuous:
            raise SystemExit(f"{what} requires --continuous (it traces and "
                             "measures the continuous-batching scheduler)")
    return args


def config_for(args):
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.kv_cache_dtype:
        cfg = cfg.replace(kv_cache_dtype=args.kv_cache_dtype)
    return cfg


def workload(args, cfg) -> tuple[list, int]:
    """The reference CLI's synthetic requests and slot length."""
    vocab = cfg.real_vocab_size or cfg.vocab_size
    slot_len = args.max_len or (args.prompt_len + args.tokens + 8)
    if args.paged:                              # the paged geometry contract
        slot_len += -slot_len % args.block_size
    requests = sched_mod.poisson_workload(
        args.requests, rate_per_tick=args.rate,
        prompt_lens=(max(2, args.prompt_len // 4), args.prompt_len),
        decode_lens=(max(2, args.tokens // 8), args.tokens),
        vocab=vocab, seed=1,
        shared_prefix=args.shared_prefix if args.paged else 0,
        priority_classes=args.priority_classes, slo_ms=args.slo_ms or None)
    return requests, slot_len


def run(args, cfg, params, *, noise_fn=None, clock=None):
    """Serve the CLI's workload through a ``ReplicaRouter`` of
    ``--replicas`` engines (sampling generators from seed 0; ``clock``, if
    given, times every stamp and span); print the report, and with
    ``--metrics`` / ``--trace`` what they recorded.  Returns (report,
    router, requests, slot_len)."""
    requests, slot_len = workload(args, cfg)
    if args.metrics:
        obs_metrics.enable()
        obs_kernels.enable_profiling()
    tracer = tracers = trace_dir = None
    if args.trace:
        if args.trace.endswith(os.sep) or os.path.isdir(args.trace):
            trace_dir = args.trace.rstrip(os.sep) or os.sep
            os.makedirs(trace_dir, exist_ok=True)
            tracers = [obs_trace.Tracer(
                os.path.join(trace_dir, f"replica{i}.json"), clock=clock)
                for i in range(args.replicas)]
        else:
            tracer = obs_trace.Tracer(args.trace, clock=clock)
    router = ReplicaRouter(
        params, cfg, replicas=args.replicas, affinity=not args.no_affinity,
        num_slots=args.slots, slot_len=slot_len,
        prefill_chunk=args.prefill_chunk, top_k=args.top_k, seed=0,
        paged=args.paged, block_size=args.block_size,
        num_blocks=args.blocks or None, preempt=not args.no_preempt,
        clock=clock, noise_fn=noise_fn, device=args.device, tracer=tracer,
        tracers=tracers)
    report = router.serve(requests)
    if tracer is not None:
        tracer.close()
    merged_path = None
    if tracers is not None:
        for t in tracers:
            t.close()
        merged_path = os.path.join(trace_dir, "merged.json")
        obs_merge.merge_traces([t.path for t in tracers], out=merged_path)
    print_report(args, report, slot_len)
    if args.metrics:
        print_metrics()
    if tracer is not None:
        print(f"trace: {len(tracer.events)} events → {args.trace} "
              f"(open in Perfetto, or: python -m repro_torch.obs.report "
              f"{args.trace})")
    if merged_path is not None:
        print(f"trace: {args.replicas} per-replica files in {trace_dir}"
              f"{os.sep} → merged view {merged_path} "
              f"(open in Perfetto, or: python -m repro_torch.obs.report "
              f"{merged_path})")
    return report, router, requests, slot_len


def print_metrics() -> None:
    """The reference's ``--metrics`` lines: each op's kernel path, each
    profiled step's cost (with, from the card, its device and bound
    times, profiled here, after the serve), each histogram and the
    instrument count."""
    obs_kernels.run_pending()
    prof = obs_kernels.snapshot()
    for op, rec in prof["paths"].items():
        print(f"kernel path: {op} → {rec['path']} (×{rec['count']})")
    for label, cost in prof["costs"].items():
        line = (f"kernel cost: {label} flops={cost['flops']:.4g} "
                f"bytes={cost['bytes_accessed']:.4g}")
        if "device_ms" in cost:
            line += (f" device_ms={cost['device_ms']:.4g} "
                     f"bound_ms={cost['bound_ms']:.4g}")
        print(line)
    snap = obs_metrics.snapshot()
    for mname, rec in snap.items():
        if rec.get("type") != "histogram":
            continue
        print(f"metric {mname}: n={rec['count']} "
              f"mean={rec['mean']:.4g} p50={rec['p50']:.4g} "
              f"p95={rec['p95']:.4g}")
    print(f"metrics: {len(snap)} instruments recorded")


def _mean(vals) -> float:
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else 0.0


def print_report(args, report, slot_len: int) -> None:
    pct = report.latency_percentiles((50, 95))
    baseline = report.baseline_occupancy(args.slots * args.replicas)
    mode = "paged continuous batching" if args.paged else "continuous batching"
    where = (f"{args.slots} slots" if args.replicas == 1
             else f"{args.replicas} replicas × {args.slots} slots")
    print(f"{mode}: {len(report.results)} requests over "
          f"{where} (slot_len={slot_len}, "
          f"prefill_chunk={args.prefill_chunk})")
    print(f"tokens: {report.total_tokens} in {report.wall_time:.2f}s "
          f"→ {report.tokens_per_s:.1f} tok/s")
    print(f"per-token latency: p50={pct['p50']*1e3:.1f}ms "
          f"p95={pct['p95']*1e3:.1f}ms")
    print(f"decode steps: {report.decode_steps}  "
          f"prefill chunks: {report.prefill_chunks}")
    print(f"batch occupancy: {report.occupancy:.3f} "
          f"(drain-and-refill baseline: {baseline:.3f})")
    p = report.paged
    if p is not None:
        print(f"block pool: {p['num_blocks']}×{p['block_size']} blocks, "
              f"free now {p['free_blocks']}, min free {p['min_free_blocks']}")
        print(f"blocks saved by sharing: {p['blocks_shared']} "
              f"(prefill tokens reused: {p['tokens_reused']}, "
              f"copy-on-write copies: {p['cow_copies']})")
        print(f"prefix cache: {p['cached_blocks']} blocks resident, "
              f"{p['prefix_cache_hits']} hits, "
              f"{p['reclaimed_blocks']} reclaimed under pressure")
    if args.replicas > 1:
        r = report.router
        routing = "prefix-affinity" if r["affinity"] else "round-robin"
        print(f"router: {routing}, per-replica requests "
              f"{r['per_replica']}, affinity routes {r['affinity_routes']}")
        if r["backpressure_rejects"]:
            print(f"backpressure: {r['backpressure_rejects']} rejected "
                  f"{r['rejected']}")
    if args.priority_classes > 1:
        for pr, pct_c in sorted(
                report.latency_percentiles_by_class((50, 95)).items()):
            rs = [r for r in report.results if r.priority == pr]
            print(f"class {pr}: n={len(rs)} p50={pct_c['p50']*1e3:.1f}ms "
                  f"p95={pct_c['p95']*1e3:.1f}ms "
                  f"queued={_mean([r.queued_ms for r in rs]):.1f}ms "
                  f"prefill={_mean([r.prefill_ms for r in rs]):.1f}ms "
                  f"decode={_mean([r.decode_ms for r in rs]):.1f}ms "
                  f"preemptions={sum(r.preempted for r in rs)}")
        att = report.slo_attainment()
        if att is not None:
            bearing = sum(1 for r in report.results if r.slo_ms is not None)
            print(f"SLO attainment: {att*100:.1f}% of {bearing} "
                  f"deadline-bearing requests")
        if p is not None:
            print(f"preemptions: {report.preemptions} "
                  f"(blocks swapped out: {p['swapped_blocks_out']}, "
                  f"swapped back in: {p['swapped_blocks_in']})")
    evicted = [r.rid for r in report.results if r.evicted]
    if evicted:
        print(f"evicted at capacity: {evicted}")


def lockstep(args, cfg, params, *, prompts=None, noise_fn=None):
    """The drain-and-refill baseline: prefill ``--batch`` prompts of
    ``--prompt-len`` together into fresh caches, sample the first token,
    then decode ``--tokens - 1`` steps at one shared cache length; print the
    reference's report lines.  Returns the generated ids [B, tokens]
    (numpy).

    ``prompts`` [B, T] defaults to ``default_rng(1)`` draws.  Sampling takes
    one Gumbel draw [B, k] per step from a ``torch.Generator`` seeded 0, or
    ``noise_fn(step)``: step 0 samples after the prefill, step i + 1 after
    decode step i (a test injects the reference's draws here)."""
    max_len = args.max_len or (args.prompt_len + args.tokens)
    vocab = cfg.real_vocab_size or cfg.vocab_size
    device = torch.device(args.device)
    if prompts is None:
        prompts = np.random.default_rng(1).integers(
            0, vocab, (args.batch, args.prompt_len))
    toks = torch.as_tensor(np.asarray(prompts, np.int64), device=device)
    gen = torch.Generator().manual_seed(0)

    def noise(step):
        if noise_fn is None:
            return None                 # topk_sample draws from gen
        return torch.as_tensor(np.asarray(noise_fn(step)), dtype=torch.float32)

    t0 = obs_clock.monotonic()
    last, caches, length = engine.prefill(params, toks, cfg, max_len=max_len)
    logits = transformer.logits_last(params, last[:, None], cfg)
    tok, _ = topk_sample(logits, args.top_k, noise=noise(0), generator=gen)
    out = [tok.cpu()]                   # waits for the device
    t_prefill = obs_clock.monotonic() - t0
    t0 = obs_clock.monotonic()
    for i in range(args.tokens - 1):
        tok, caches, length = engine.decode_step(
            params, caches, length, tok[:, None], cfg, noise=noise(i + 1),
            generator=gen, top_k=args.top_k)
        out.append(tok)
    gen_ids = torch.stack([t.cpu() for t in out], dim=1).numpy()
    t_decode = obs_clock.monotonic() - t0
    b = toks.shape[0]
    print(f"prefill: {b}×{toks.shape[1]} in {t_prefill*1e3:.1f}ms")
    print(f"decode: {args.tokens - 1} steps × {b} seqs in "
          f"{t_decode*1e3:.1f}ms "
          f"({(args.tokens - 1) * b / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample token ids:", gen_ids[0, :16].tolist())
    return gen_ids


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = config_for(args)
    params = transformer.init(cfg, seed=0, device=args.device)
    if not args.continuous:
        lockstep(args, cfg, params)
        return 0
    report, _, _, _ = run(args, cfg, params)
    if report.occupancy <= report.baseline_occupancy(args.slots
                                                     * args.replicas):
        print("WARNING: occupancy did not beat the drain-and-refill baseline")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
