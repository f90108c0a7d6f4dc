"""Serving launcher of the port: continuous batching and the lockstep
baseline.

``python -m repro_torch.launch.serve --continuous [--paged] [--smoke]
[--device cpu]`` serves Poisson-staggered synthetic requests (the
reference's workload generator, same draws) through one ``Engine`` — over
the slot pool, or with ``--paged`` over the block pool with a shared
synthetic prompt prefix — and prints the reference's report lines:
throughput, p50/p95 per-token latency, decode steps and prefill chunks,
occupancy against the drain-and-refill bound and, paged, the block pool's
accounting.  Without ``--continuous`` the lockstep baseline runs: one batch
of ``--batch`` prompts prefilled together, then decoded together at one
shared cache length, reporting prefill and decode times and the first
row's token ids.  The model runs on the card unless ``--device cpu`` asks
for the CPU, where the kernels' plain versions serve.  ``--kv-cache-dtype
int8`` stores K/V as int8 with a bf16 scale per (position, KV head) in
every mode: each prompt prefills in one chunk, paged blocks are never
shared, and decode reads the int8 cache through the dequantizing kernels.

Port of ``src/repro/launch/serve.py`` (``_lockstep`` at line 44,
``_continuous`` at 88, ``main`` at 264); weights and sampling generators
come from seed 0.  The lockstep prompts come from a seeded numpy generator
(``default_rng(1)``), not from ``jax.random.randint``, which the port does
not reproduce.  ``--replicas > 1``, ``--priority-classes > 1`` (with
int8 K/V too: preempt-and-swap of int8 pools), ``--trace`` and
``--metrics`` are not ported yet and say so.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.core.topk_fusion import topk_sample
from repro_torch.models import transformer
from repro_torch.obs import clock as obs_clock
from repro_torch.serving import engine
from repro_torch.serving import scheduler as sched_mod
from repro_torch.serving.engine_api import Engine


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
    # reference options whose slices are not ported yet: they say so
    ap.add_argument("--priority-classes", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--trace", default="")
    ap.add_argument("--metrics", action="store_true")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous (the lockstep "
                         "baseline keeps its contiguous cache)")
    not_ported = [
        (args.kv_cache_dtype == "int8" and args.priority_classes > 1,
         "--kv-cache-dtype int8 with --priority-classes > 1 "
         "(preempt-and-swap of int8 pools)"),
        (args.replicas > 1, "--replicas > 1 (the replica router)"),
        (args.priority_classes > 1,
         "--priority-classes > 1 (SLO scheduling)"),
        (bool(args.trace), "--trace"),
        (args.metrics, "--metrics"),
    ]
    for cond, what in not_ported:
        if cond:
            raise SystemExit(f"repro_torch.launch.serve: {what} is not "
                             "ported yet (see ROADMAP.md)")
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
        shared_prefix=args.shared_prefix if args.paged else 0)
    return requests, slot_len


def run(args, cfg, params, *, noise_fn=None):
    """Serve the CLI's workload through one ``Engine`` (sampling generators
    from seed 0); print the report.  Returns (report, engine, requests,
    slot_len)."""
    requests, slot_len = workload(args, cfg)
    eng = Engine(params, cfg, num_slots=args.slots, slot_len=slot_len,
                 prefill_chunk=args.prefill_chunk, top_k=args.top_k,
                 seed=0, paged=args.paged, block_size=args.block_size,
                 num_blocks=args.blocks or None, noise_fn=noise_fn,
                 device=args.device)
    report = eng.serve(requests)
    print_report(args, report, slot_len)
    return report, eng, requests, slot_len


def print_report(args, report, slot_len: int) -> None:
    pct = report.latency_percentiles((50, 95))
    baseline = report.baseline_occupancy(args.slots)
    mode = "paged continuous batching" if args.paged else "continuous batching"
    print(f"{mode}: {len(report.results)} requests over "
          f"{args.slots} slots (slot_len={slot_len}, "
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
    if report.occupancy <= report.baseline_occupancy(args.slots):
        print("WARNING: occupancy did not beat the drain-and-refill baseline")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
