#!/usr/bin/env python3
"""Device memory of one bf16 train step, phase by phase, on one NVIDIA GPU:
what ``training.train_step.init_state`` holds (weights, AdamW moments),
what the forward saves under the model's remat, what the backward leaves
(the gradients), the peak of AdamW's update over what was held, and what is
still allocated after the step, before and after a garbage collection.
The step is ``make_train_step``'s with one microbatch, split at its phases.

    python3 tools/train_memory.py [--arch llava_next_34b] [--layers 2]
        [--batch 1] [--seq 256] [--steps 2]

``--layers`` cuts the decoder's depth (and an encoder-decoder's encoder's).
A VLM's batch carries ``patch_embeds`` [B, P, D] and an encoder-decoder's
``frames`` [B, S_enc, D], bf16, beside ``--seq`` tokens
(``chip_smoke._StepBatches``).  Prints a line a step and one JSON line
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2 ** 30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llava_next_34b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--steps", type=int, default=2)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                   # inserts ROOT/src at the front
    import torch
    if not torch.cuda.is_available():
        print("train_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch import configs, tree
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.distributed import compression
    from repro_torch.optim import adamw
    from repro_torch.training import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(a.arch)
    if a.layers:
        cfg = cfg.replace(num_layers=a.layers, **(
            {"encoder_layers": a.layers} if cfg.family == "encdec" else {}))
    run = RunConfig(model=cfg)
    extra = {"vlm": ("patch_embeds", (cfg.num_patches, cfg.d_model)),
             "encdec": ("frames", (cfg.encoder_seq_len, cfg.d_model))}
    if cfg.family in extra:
        key, shape = extra[cfg.family]
        batch = cs._StepBatches(cfg, a.batch, a.seq, key, shape,
                                torch.bfloat16).batch(0)
    else:
        batch = SyntheticDataset(SyntheticConfig(
            cfg.real_vocab_size or cfg.vocab_size, a.seq, a.batch)).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}

    def alloc():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() / GIB

    def peak():
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / GIB

    base = alloc()
    params, opt = ts.init_state(run, device="cuda")
    weights = sum(p.numel() * p.element_size() for p in tree.leaves(params))
    moments = sum(x.numel() * x.element_size() for x in
                  tree.leaves(opt.mu) + tree.leaves(opt.nu))
    out = {"arch": a.arch, "layers": cfg.num_layers, "batch": a.batch,
           "seq": a.seq, "remat": cfg.remat, "smi": cs._smi(),
           "parameters": sum(p.numel() for p in tree.leaves(params)),
           "weights_gib": weights / GIB, "moments_gib": moments / GIB,
           "init_gib": alloc() - base, "steps": []}
    print(f"train_memory {a.arch}, {cfg.num_layers} layers, {a.batch} x "
          f"{a.seq} tokens{' + ' + key if cfg.family in extra else ''}: "
          f"{out['parameters'] / 1e9:.3f}e9 parameters, weights "
          f"{out['weights_gib']:.3f} GiB, AdamW moments "
          f"{out['moments_gib']:.3f} GiB, held after init "
          f"{out['init_gib']:.3f} GiB ({out['smi']})")
    for step in range(a.steps):
        held = alloc()
        torch.cuda.reset_peak_memory_stats()
        leaves = tree.leaves(params)
        loss, _ = ts.loss_for(cfg)(params, batch, cfg)
        saved, fwd_peak = alloc() - held, peak() - held
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        del loss
        kept, bwd_peak = alloc() - held, peak() - held
        grads = compression.cast_grads(tree.unflatten(params, grads),
                                       run.parallel.grad_reduce_dtype)
        torch.cuda.reset_peak_memory_stats()
        params, opt, _ = adamw.update(grads, opt, params, run.optimizer)
        upd_peak = peak() - held
        del grads, leaves
        after = alloc() - held
        gc.collect()
        collected = alloc() - held
        row = {"held_gib": held - base, "forward_saved_gib": saved,
               "forward_peak_gib": fwd_peak, "gradients_gib": kept,
               "backward_peak_gib": bwd_peak, "update_peak_gib": upd_peak,
               "after_step_gib": after, "after_collect_gib": collected}
        out["steps"].append(row)
        print(f"step {step}: held {row['held_gib']:.3f} GiB; forward saves "
              f"+{saved:.3f} (peak +{fwd_peak:.3f}); backward leaves "
              f"+{kept:.3f} (peak +{bwd_peak:.3f}); AdamW's update peaks "
              f"+{upd_peak:.3f} over what was held; after the step "
              f"+{after:.3f}, after gc.collect() +{collected:.3f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
