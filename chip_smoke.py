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
   chunk); the latent attention kernels (``flash_mla.cu``, both forms:
   bf16 ``mla_decode_wgmma_kernel`` / ``mla_prefill_wgmma_kernel`` on the
   tensor cores, fp32 ``mla_split_kernel`` / ``mla_prefill_kernel``) must
   build without a spill, and each dtype's decode split at B 8 over 328
   positions and B 4 over 288 and prefill grid at a 64-token chunk and the
   lockstep prefill, with their dynamic shared memory, are printed; the
   training kernels (the fresh forward, its dq and dk/dv backward, both
   forms) must be in ptxas's report at every (Dqk, Dv) pair,
   ``TRAIN_INSTANCES``: (64, 64), (128, 128) and minicpm3-4b's (96, 64),
   without a spill;
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
   exactly 0, and a second call bit-equal to the first; then the serving
   kernels' head_dim-128 instances, each check above again at D 128 with
   mistral-nemo-12b's 32/8 heads (G 4) and deepseek-coder-33b's 56/8 (G
   7): the paged and contiguous cached prefills (bf16 through two 128-byte
   swizzle atoms a row on the tensor cores, fp32 on the CUDA cores), the
   int8 forms and the split decode's edges in its four forms, and the
   sampler at their vocabularies, [8, 131072] and [8, 32256]; then the MoE
   decoders' shapes: the fused softmax+top-k as the expert router runs it
   through ``dispatch.softmax_topk`` on [G, S, E] logits ([8, 60] and [64,
   60] top 4, [8, 16] and [256, 16] top 1, and the widths 6 and 61, whose
   rows start off a 16-byte boundary), with exact ties in index order and
   ``layers.moe_route`` keeping and dropping the same assignments on the
   card as on the CPU, the sampler at [8, 151936] and [8, 202048], and every
   check of the D-128 instances again at qwen2-moe-a2.7b's 16/16 heads (G
   1) and llama4-scout-17b-a16e's 40/8 (G 5); the training kernels' D-128
   instances (the fresh forward, its dq and dk/dv backward, two 128-byte
   atom columns a row on the tensor cores) run the fresh checks above at
   each of those four models' heads, the profiler naming the D-128
   instance of each dtype's form; then the MLA decoder's latent attention
   at minicpm3-4b's 40 heads over R 256 + Dr 32, scale 96^-0.5, fp32 and
   bf16, every latent row past a row's vlen NaN: the decode
   (``flash_decode_mla``) at B 8 over vlen 65-328, at the batch whose
   rows take vlen 0, 1, each split edge ± 1 and 328 (vlen 0 giving exactly
   0) and at 7 heads over vlens ending mid-64-key tile, the cached prefill
   (``flash_attention_mla``) at 64-token chunks after cached prefixes, Tq
   65 and 130 at offsets off the 32- and 64-row tiles (vlens ending
   mid-tile, a last 64-row tile with rows past T·H), the int8 single-shot
   and the lockstep prefills and 7 heads at Tq 37, each a repeat bit-equal
   and its dtype's form alone seen by the profiler (bf16 the tensor-core
   kernels, fp32 the CUDA-core ones); and the sampler at minicpm3-4b's
   [8, 73728], with every row's 280 padded entries -inf; then the training
   kernels' (96, 64) instances, minicpm3-4b's decompressed MLA (q and k 64
   nope + 32 rope, v 64, at 40/40 heads), through every fresh check above
   (T 512, 37 and 1, causal and not, fp32 and bf16, k and v through
   strides of their own, NaN past T, the profiler naming the <96,64>
   instance of each dtype's form); then the recurrent decoders' shapes:
   the sampler at zamba2-1.2b's [8, 32000] and xlstm-125m's [8, 50304],
   and every D-64 check above again at zamba2's shared attention block,
   32/32 heads (G 1): rows 4 and 5 (its decode and single-shot prefill),
   the paged forms, the int8 forms and the training kernels; then
   whisper-small's: the fresh forward non-causal at its encoder's B 1, T
   1536, 12/12 heads of 64 (and its backward), the contiguous decode over
   all 1536 cross keys and over short ragged self lengths at B 8 (its
   split plan at S 1536 printed, a repeat bit-equal), fp32 and bf16, and
   the sampler at [8, 51968] with every row's 103 padded entries -inf;
   then whisper-small's training: rows 6 and 7 non-causal at Tq ≠ Tk, the
   cross-attention's 256 queries over 1536 keys, forward, dq and dk/dv
   and ``FlashAttention``'s gradients, fp32 and bf16; then
   llava-next-34b's (56/8 heads of 128, G 7): the sampler at [8, 64000]
   and the lockstep's [2, 64000], row 5 at the lockstep prefill (B 2, Tq
   2944 at offset 0 over caches of 2960, each dtype's form named from the
   profiler), row 4 over 2945 and 2960 keys (a repeat bit-equal), rows 6
   and 7 causal at its training sequence of 3136, fp32 and bf16;
4. serve: smollm-360m at full width and ``SMOLLM_LAYERS`` of its 32 layers
   in bf16 through its three serving paths,
   then the same three with ``--kv-cache-dtype int8``, each with the launch
   counts set to 0 just before it and read just after: ``Engine`` with the
   paged continuous-batching scheduler, ``Engine`` over the slot pool, and
   the lockstep loop; every request finishes, every token id is in the
   vocabulary, and each kernel's launch count equals what the scheduler's
   own counters (or the loop's steps) imply; the int8 runs prefill every
   prompt in one chunk and, paged, share and cache no block; the fp and
   int8 pools' bytes per cached token; then SLO scheduling with
   preempt-and-swap (24 requests at 0.5 arrivals a tick, two priority
   classes, class 0 with a deadline, the pool cut to 112 blocks), bf16 and
   int8 K/V: at least 2 preemptions, blocks swapped in equal to those
   swapped out, bytes equal to blocks times a block's bytes from the
   config, no int8 block kept shared; and the same traffic without
   classes through a 2-replica router; launch counts equal to the
   schedulers' counters in each; then mistral-nemo-12b at full width and
   ``MISTRAL_LAYERS`` of its 40 layers (bf16, weights drawn on the card
   from seed 0) through the same
   paged, slot-pool and lockstep workloads and the int8 paged and slot-pool
   ones, each between a reset and a read of the launch counts (equal to the
   counters, every attention op a head_dim-128 instance), its pools' bytes
   per cached token against the config's, each run's peak device memory,
   and its "step" lines (a B 8 decode step of each pool and a 64-token
   paged prefill chunk, host call to device finish against device busy,
   the port's kernels and the weights' byte bound); and deepseek-coder-33b
   at full width and ``DEEPSEEK_LAYERS`` of its 62 layers through the paged
   and slot-pool workloads; then qwen2-moe-a2.7b at full width and
   ``QWEN2_LAYERS`` of its 24 layers (60 experts padded to 64, top 4,
   weights drawn on the card)
   through the same paged, slot-pool and lockstep workloads and the int8
   paged one (launch counts equal to the counters, the router's one
   softmax_topk launch a layer and forward counted apart as
   ``softmax_topk_router``), its paged "step" lines and its decode step
   profiled by ``obs.kernels.profile_step`` (the router and the sampler in
   ``softmax_topk_kernel``, one a layer and one); and llama4-scout-17b-a16e
   at full width and ``LLAMA4_LAYERS`` of its 48 layers (16 experts, top 1)
   through the paged workload; then the MLA decoder minicpm3-4b at full
   width (62 layers, 8.53 GB of bf16 drawn on the card) through the
   slot-pool workload at ``MINICPM_SERVE_LAYERS`` of its layers, and at
   ``MINICPM_CUT_LAYERS`` layers its int8 form
   (fp latents, each prompt in one chunk) and the lockstep workload, each
   between a reset and a read of the launch counts: one latent attention
   launch a layer and forward, equal to the scheduler's counters; the
   pools' bytes per cached token against 62 x 288 x 2 = 35712, peak device
   memory, and its "step" lines (a B 8 slot-pool decode step and a
   64-token prefill chunk, host call to device finish against device busy,
   beside the weights' 2.546 ms byte bound, each step's latent attention
   in the bf16 tensor-core kernel and never the fp32 form's; the decode
   step's kernels and its ``decode_step_cost`` bound); then the recurrent
   decoders at full width and ``STATE_SERVE_LAYERS``, bf16, weights drawn
   on the card: zamba2-1.2b (8 of its 38 layers, its shared attention
   block called twice) and xlstm-125m (6 of its 12 layers, layer 5 an
   sLSTM), each through the
   paged state pool (one block a sequence's whole state row), the slot
   pool (prompts snapped to the scan's quantum, 128 and 256) and the
   lockstep workload, between a reset and a read of the launch counts,
   equal to the counters (zamba2: a row-4 launch a shared-block call and
   decode step, a row-5 launch a call and single-shot prefill; xlstm: the
   sampler alone); p50 / p95, state bytes a sequence, zamba2's K/V bytes
   a token, nothing shared and every block back, peak memory; and their
   "step" lines (a B 8 decode step and a 256-token prefill, host call to
   device finish against device busy, the kernels by device time, the
   recurrent cores' device time alone beside them, the weights' and
   ``decode_step_cost``'s byte bounds); then the encoder-decoder
   whisper-small at full width and depth (12 + 12 layers, bf16, weights
   drawn on the card) through ``python -m repro_torch.launch.serve --arch
   whisper_small --continuous --paged`` (``WHISPER_SERVE_ARGS``: 12
   requests over the default 3 audios), between a reset and a read of the
   launch counts: one encoder run an audio and every repeat a whole-audio
   hit (cross blocks shared = hits x 96, tokens reused = hits x 1536), the
   launches equal to the counters (the encoder's non-causal fresh forward
   12 a fresh encode and none on a hit, the contiguous decode 24 a decode
   step and 24 a prefill, the sampler one each), tok/s, p50 / p95, peak
   memory, the pool's bytes a cached decoder token and an audio, and
   "step" lines (a B 8 paged decode step beside ``decode_step_cost``, a
   fresh prefill); then the VLM llava-next-34b at full width and
   ``LLAVA_SERVE_LAYERS`` of its 60 layers (bf16, weights drawn on the
   card) through the lockstep loop (``LLAVA_LOCKSTEP_ARGS``: 2 prompts of
   64 behind the CLI's 2880 seeded patch embeddings, 16 tokens), between a
   reset and a read of the launch counts (one row-5 prefill and 15 row-4
   decode launches a layer, one sampler launch a token), its ``prefill:``
   / ``decode:`` lines, peak memory, and "step" lines (a decode step over
   2960 keys and the prefill beside the weights' byte bound);
5. parity: short fp32 workloads of the three paths (smollm-360m at full
   width and ``SMOLLM_LAYERS`` layers), once on the
   card through the kernels and once on the CPU through the plain versions;
   token streams (and the paged pool's stats) must be identical; for the
   int8 paths, whose quantization can round an element one step apart
   where the two devices' fp32 K projections differ in their last bits,
   the int8 cache after the first prefill within 1 of the CPU's and its
   scales within one bf16 ulp, the first decode step's logits within
   ``INT8_LOGIT_RTOL`` of the logit scale, and the token agreement of the
   same workloads printed; then a short SLO workload that preempts and its
   2-replica routed form, on the card with every block a swap-out frees
   filled with NaN at once and on the CPU, under virtual clocks: streams,
   decisions (admissions, resumes, preemptions) and pool and swap stats
   identical, each preempted stream equal to its ``--no-preempt`` run, and
   the same again with a device sleep queued before every decode step;
   and mistral-nemo-12b, then qwen2-moe-a2.7b, at full width cut to
   ``PARITY_128_LAYERS`` (1) in fp32: the paged, slot-pool and lockstep parity workloads'
   streams identical on the card (head_dim-128 kernels; the router's fused
   softmax+top-k) and the CPU; then minicpm3-4b the same way, the
   slot-pool and lockstep workloads (no paged latent cache): its latent
   attention kernels on the card against their plain versions on the CPU;
   then zamba2-1.2b at 7 layers (two calls of the shared block, each with
   its own K/V) and xlstm-125m at 6 (layer 5 an sLSTM), full width, fp32:
   a 2 x 256 forward's hidden states and logits within
   ``STATE_PARITY_RTOL`` of the CPU's, and the paged, slot-pool and
   lockstep streams identical; then whisper-small at full width cut to 2
   + 2 layers: the paged streams and pool stats identical on the card and
   the CPU, and on the card a whole-audio hit bit-identical to a fresh
   encode, its install writing no cross block;
6. train: ``python -m repro_torch.launch.train`` (its ``train`` function)
   at full width in bf16, 10 steps of 8 × 512 tokens with one checkpoint at
   the end, with the launch counts set to 0 just before it and read just
   after: every loss and grad norm finite, and with remat "full" 2 forward
   launches per layer and step (the forward, then its recomputation in the
   backward) and one dq and one dk/dv launch; then a restart at 2 layers
   (6 steps checkpointed every 3, then a run to 8 that resumes at 6) whose
   parameters equal an uninterrupted 8-step run bit for bit; then the
   head_dim-128 models through the same ``train`` (``TRAIN_128``):
   mistral-nemo-12b at full width and 2 of its 40 layers, qwen2-moe-a2.7b at
   full width and 2 of its 24, weights drawn on the card,
   ``TRAIN_128_STEPS`` steps each without a checkpoint (the restart above
   checks it; these runs' 24 and 18 GB took most of their time), between a
   reset and a read of the launch counts (2 forward, 1 dq and 1 dk/dv
   launch per layer and step, and for qwen2-moe 2 router launches): every
   loss and grad norm finite, the loss falling, peak device memory, a
   "step" line with the kernels that take the device's time; then
   ``REMAT_STEPS`` steps of each under remat "block" and "full" from the
   same seed, their peak memory and step times side by side and their
   parameters bit-identical; and the MLA decoder minicpm3-4b the same way
   at full width and 4 of its 62 layers, its decompressed attention
   through the training kernels' (96, 64) instances (the same launch
   counts, no latent kernel); then the recurrent decoders at full width
   (``TRAIN_STATE``): zamba2-1.2b at 20 of 38 layers (8 forward, 4 dq and
   4 dk/dv launches a step: its shared block's 4 calls) and xlstm-125m at
   its full 12 (no attention launch), ``TRAIN_STATE_STEPS`` steps, then for
   zamba2 ``REMAT_STATE_STEPS`` under each remat policy and the step line
   with the recurrent cores' device time alone beside it; then, through
   ``training.train_step`` (``init_state``, ``make_train_step``,
   ``training.loop.run``) as a user trains them outside the CLI, whose
   stream carries neither frames nor patches: whisper-small at full width
   and depth (``WHISPER_TRAIN``: B 8 x 256 tokens beside frames [8, 1536,
   768] bf16; 72 forward, 36 dq and 36 dk/dv launches a step: the
   encoder's non-causal self-attention, the decoder's causal one and its
   cross-attention, each forward twice under the layers' checkpoints) and
   llava-next-34b at full width and ``LLAVA_TRAIN_LAYERS`` of its 60
   (``LLAVA_TRAIN``: 1 x 256 tokens behind its 2880 patch embeddings, T'
   3136), each with its launches, peak memory and a step line;
7. train parity: one fp32 loss-and-gradient evaluation of each full-width
   model cut to 2 layers (batch ``TRAIN_PARITY``; one sequence of it and
   one layer for the head_dim-128 models and minicpm3-4b) on the card through the
   kernels and on the CPU through the plain versions, from the same
   weights: smollm-360m's drawn on the CPU, mistral-nemo-12b's,
   qwen2-moe-a2.7b's and minicpm3-4b's on the card; qwen2-moe's router
   keeping the same assignments on both devices in every layer, and
   minicpm3's MLA leaves among the gradients held; then zamba2-1.2b at 7
   layers (two shared-block calls) and xlstm-125m at 6 (layer 5 an
   sLSTM), one sequence of 256 tokens, weights drawn on the card; then
   whisper-small at 2 + 2 layers with frames [1, 1536, 768]; then
   llava-next-34b at 1 layer and ``LLAVA_PARITY``'s 64 patches: a forward
   within ``STATE_PARITY_RTOL``, the lockstep streams identical under the
   same injected Gumbel draws, and loss and gradients (``mm_proj``'s
   among them) with a patch batch;
8. times: each kernel, first held against its plain version on the very
   inputs it is timed on (CUDA events, median of 20 samples after warm-up) at
   the serving and training paths' shapes (the serving kernels' D-128
   instances at mistral-nemo-12b's, the sampler at V 131072 and 32256; the
   router at [8, 60], [64, 60], [8, 16] and [256, 16], the sampler at V
   151936 and 202048, and the D-128 instances at G 1 and G 5; the training
   kernels' D-128 instances at mistral-nemo-12b's and qwen2-moe-a2.7b's
   training shapes and their (96, 64) instances at minicpm3-4b's, beside
   SDPA with a 64-wide v; the latent attention's decode at B 8 over vlen 65-328
   and its prefill at a 64-token chunk at offset 64, the lockstep prefill
   and an int8 run's single-shot prefill, bf16, beside one SDPA call on
   the concatenated inputs, and the sampler at [8, 73728] with the padded
   entries -inf; the sampler at V 32000 and 50304 and rows 4 and 5 at
   zamba2's 32/32 heads of 64: its slot pool's decode and its single-shot
   prefill of 256 tokens; rows 6 and 7 at zamba2's training shape, B 8, T
   512, 32/32 heads of 64; whisper-small's row 6 non-causal at B 1, T
   1536, row 4 over 1536 keys at B 8 and the sampler at [8, 51968];
   rows 6 and 7 non-causal at whisper's training encoder, B 8, T 1536,
   and cross-attention, B 8, 256 queries over 1536 keys; llava's sampler
   at [2, 64000], row 4 at B 2 over 2960 keys and row 5 at its lockstep
   prefill, G 7 D 128, and rows 6 and 7 at its training sequence, B 1, T
   3136),
   beside its bound, its plain
   version and, where one PyTorch call computes the same function, that
   call; the cached prefill at the slot pool's chunk, the lockstep prefill
   and an int8 single-shot prefill beside SDPA, with each call's device
   time too (events around launches queued behind a device
   sleep: the events of a small kernel's back-to-back launches time the
   host's launch path), also for rows 1-4, the int8 decodes and the int8
   paged prefill, the training kernels (and the whole backward), with the
   library call's device time beside rows 1, 4, 6 and 7 (top-k of a
   softmax, SDPA forward, SDPA's autograd backward); then
   decode steps and prefill chunks of the paged pool and the slot pool
   (smollm-360m at full width and ``SMOLLM_LAYERS`` layers), their int8
   decode steps, and a full-width train step,
   end to end, against the device's busy time inside them (torch.profiler);
   the four online-softmax kernels at [4000, 100000] fp32 beside
   torch.softmax / torch.logsumexp, and the effective accesses per element
   (ms × 3.35 TB/s over the bytes of x) of the exact softmax, the
   normalizer, torch.softmax and torch.logsumexp at every shape of phase 9
   (back-to-back and device times), beside the paper's 3 (online), 4 (safe) and 1
   (normalizer), and both designs of the online softmax at the two V on
   either side of the row-resident limit; then the swap: ``swap_out`` and
   ``swap_in`` of one 21-block sequence and ``prefetch_swap_in`` alone,
   host call to device finish, beside a plain pinned ``copy_`` of the same
   bytes each way, and a decode step with and without one pending
   prefetch;
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
   backward) rather than returning a detached result;
10. observability, in a process of its own (so no other phase's
   ``torch.profiler`` session runs before it, and its own runs before none
   of theirs): phase 4's paged run five times, each with the launch
   counts set to 0 just before it and read just after (equal to the
   scheduler's counters, and for the ``--metrics`` run one decode step
   more): untraced (warm-up), untraced, with ``--trace FILE``, with
   ``--trace FILE --metrics`` (which replays its first decode step under
   ``torch.profiler`` once the serve is over, the process's first
   session) and untraced again; token
   streams equal bit for bit across the five, both traces valid (every
   span closed and nested) with one ``token`` instant per token, one
   ``retire`` per request and every ``decode`` section inside a ``tick``,
   the metrics counters equal to the report's, every op's kernel path
   ``cuda`` with its count equal to the launch counts, and the profiled
   decode step showing the split decode once per layer and the sampler
   once; it prints each run's tok/s, each trace's host-side ``admit`` /
   ``prefill`` / ``decode`` span sums, the profiled step's device time,
   bound and kernels, and the kernel plans used; then the round-robin
   router run with ``--trace DIR/``: both replica traces and the merged
   one valid, pids 0 and 1, first ticks aligned, and ``python -m
   repro_torch.obs.report`` exiting 0 on the merged file.

``phase_distributed`` (after phase 6's training run) runs the distributed layer
at world size 1 under NCCL (a ``FileStore``, no network) over a (1, 1)
``DeviceMesh``: rows 4 and 4q with their lse against the plain version's
at smollm-360m's decode batch, at D 128 and in int8 (vlen 0 giving out 0
and lse -inf, the lse form's output bit-equal to the plain launch's), the
⊕ of 2, 4 and 8 cache slices through the kernel (``merge_partials``)
against the whole cache, the lockstep path under the context (fp and int8
K/V, tokens identical to the unsharded run, one lse-form decode a layer
and step and one row 1 a token counted), ``launch.train --mesh 1x1``
beside the unsharded run, and the times of row 4 with and without its lse
and of the merge's three collectives.

Each phase prints its wall time, and the end the whole run's, which is
to stay under 600 s, half the 1200 s it is allowed.  The line before the last is a JSON object
with one entry per kernel (with the path it was ported for); the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))
# the script's start, for the whole run's wall time printed at its end
START = time.perf_counter()

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
    # MLA's absorbed attention over its latent cache: no pallas_call, the
    # reference's XLA fallbacks for a custom-scale decode and for a prefill
    # whose value dim is not q's
    "flash_decode_mla": {
        "source": "src/repro_torch/kernels/csrc/flash_mla.cu",
        "replaces": "src/repro/kernels/dispatch.py:573"},
    "flash_attention_mla": {
        "source": "src/repro_torch/kernels/csrc/flash_mla.cu",
        "replaces": "src/repro/kernels/dispatch.py:887"},
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
# the launch counters ``dispatch.launch_counts`` reads: one a kernel, the
# MoE router's launches of softmax_topk under a key of their own, and the
# lse forms of rows 4 and 4q (the sequence-sharded decode's)
COUNTERS = (*KERNELS, "softmax_topk_router", "flash_decode_lse",
            "flash_decode_int8_lse", "flash_attention_qoffset",
            "flash_attention_bwd_dq_qoffset",
            "flash_attention_bwd_dkv_qoffset")
# smollm-360m's serving and parity phases (4, 5, 8 and 10) run at full
# width and this many of its 32 layers: the head_dim-128 models' full-width
# runs took the script's time (32 → 8), then the recurrent decoders'
# training (8 → 4), and an earlier path's depth gives way first
SMOLLM_LAYERS = 4
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
# the SLO runs of phase 4: 24 Poisson requests of the paged run's shapes
# at 0.5 arrivals a tick, two priority classes, class 0 with a deadline,
# and a pool cut from 168 blocks (8 slots x 21) to 112, where the run
# preempts (the scheduler's decisions depend only on the lengths and
# prompts, so a CPU rehearsal with a narrow model finds them); the router
# run serves the same traffic without priorities through 2 replicas
SLO_TRAFFIC = ["--continuous", "--paged", "--requests", "24", "--slots", "8",
               "--prompt-len", "256", "--tokens", "64", "--block-size", "16",
               "--prefill-chunk", "64", "--shared-prefix", "16", "--rate",
               "0.5", "--blocks", "112"]
SLO_ARGS = SLO_TRAFFIC + ["--priority-classes", "2", "--slo-ms", "5000"]
ROUTER_ARGS = SLO_TRAFFIC + ["--replicas", "2"]
# phase 5's SLO parity workload (preempts twice, evicts nothing) and its
# routed form over 2 replicas, round-robin so both serve
SLO_PARITY_ARGS = ["--continuous", "--paged", "--requests", "6", "--slots",
                   "2", "--prompt-len", "32", "--tokens", "12",
                   "--block-size", "16", "--prefill-chunk", "32",
                   "--shared-prefix", "16", "--rate", "0.5", "--max-len",
                   "80", "--blocks", "6", "--priority-classes", "2",
                   "--slo-ms", "50"]
ROUTER_PARITY_ARGS = SLO_PARITY_ARGS + ["--replicas", "2", "--no-affinity"]
# a device sleep queued before every decode step of one parity run, so the
# swap-in staging stream really runs beside a busy current stream
DECODE_SLEEP_CYCLES = 20_000_000
# the training run of phase 6 (the CLI's own flags), its 2-layer restart
# runs, and the fp32 parity batch of phase 7
TRAIN_ARGS = ["--arch", "smollm_360m", "--steps", "10", "--seq-len", "512",
              "--global-batch", "8", "--checkpoint-every", "10"]
RESTART_ARGS = ["--arch", "smollm_360m", "--layers", "2", "--seq-len", "512",
                "--global-batch", "8"]
TRAIN_PARITY = dict(layers=2, batch=2, seq_len=128)
# phase 6's full-width training runs of the bigger models: (label, the
# run's key in the launch counts, the CLI's flags): mistral-nemo-12b at full
# width and 2 of its 40 layers (4 until the recurrent decoders' training
# took the script's time), qwen2-moe-a2.7b at full width and 2 of its 24
# (1.83e9, ~22 GB), the MLA decoder minicpm3-4b at full width and 4 of its
# 62 (8 until then; 62.67e6 a layer and 377.5e6 for the untied embedding
# and head; its 4.26e9 with AdamW's fp32 state do not fit one card); each
# TRAIN_128_STEPS steps of 8 x 512 tokens under remat "full", then
# REMAT_STEPS steps under remat "block" and "full" from the same seed
TRAIN_128 = (("mistral-nemo-12b", "mistral train",
              ["--arch", "mistral_nemo_12b", "--layers", "2"]),
             ("qwen2-moe-a2.7b", "qwen2 train",
              ["--arch", "qwen2_moe_a2p7b", "--layers", "2"]),
             ("minicpm3-4b", "minicpm3 train",
              ["--arch", "minicpm3_4b", "--layers", "4"]))
# (cut from 10 and 3 steps for the script's time, as the parity batch
# below; most of these phases' time is outside the steps: the draws, the
# end-of-run checkpoints, the fp32 copies to the CPU)
TRAIN_128_STEPS = 6
REMAT_STEPS = 2
TRAIN_128_ARGS = ["--seq-len", "512", "--global-batch", "8"]
# phase 7's fp32 parity of the head_dim-128 models and the MLA decoder:
# (arch, ...) and their batch, TRAIN_PARITY's cut to one sequence and one
# layer (2 until the recurrent decoders' phases took the script's time)
TRAIN_PARITY_128 = ("mistral_nemo_12b", "qwen2_moe_a2p7b", "minicpm3_4b")
TRAIN_PARITY_BATCH_128 = dict(layers=1, batch=1, seq_len=128)
# phase 6's recurrent decoders, at full width: zamba2-1.2b at 20 of its 38
# Mamba2 layers (its shared block called 4 times, the last after a segment
# of 2, as at 38's 7th call; full depth until the encoder-decoder's and
# the VLM's training took the script's time) and xlstm-125m at full depth
# (12 layers: at 6 its loss rose over the two steps, so it keeps its
# depth); TRAIN_STATE_STEPS steps of 8 x 512 under remat "full" each, then
# (zamba2 only) a profiled step and REMAT_STATE_STEPS under "block" and
# "full": xlstm's profiled step (~109k launches, ~25 s a session), its
# cores' profile (~20 s) and its remat pair (~9 s) were cut for the script's
# time when the distributed phase came (its last numbers: PERF.md §5, PR 30)
TRAIN_STATE = (("zamba2-1.2b", "zamba2 train",
                ["--arch", "zamba2_1p2b", "--layers", "20"], True),
               ("xlstm-125m", "xlstm train", ["--arch", "xlstm_125m"], False))
TRAIN_STATE_STEPS = 2
# their remat "block" / "full" comparison: one step each (an xlstm step is
# ~3 s and ~110k launches)
REMAT_STATE_STEPS = 1
# phase 7's fp32 parity of the recurrent decoders at full width and cut
# depth, (arch, layers): zamba2 at 7 (6 + 1 Mamba2 layers, two shared-block
# calls), xlstm at 6 (layer 5 an sLSTM); one sequence of 256 tokens (two
# chunks of zamba2's scan, one of xlstm's)
TRAIN_PARITY_STATE = (("zamba2_1p2b", 7), ("xlstm_125m", 6))
TRAIN_PARITY_BATCH_STATE = dict(batch=1, seq_len=256)
KERNEL_PATH = {"softmax_topk": "paged", "flash_decode_paged": "paged",
               "flash_attention_paged": "paged", "flash_decode": "slot pool",
               "flash_attention_offset": "slot pool",
               "flash_attention": "train", "flash_attention_bwd_dq": "train",
               "flash_attention_bwd_dkv": "train",
               "flash_decode_paged_int8": "paged int8",
               "flash_decode_int8": "slot pool int8",
               "flash_attention_paged_int8": "kernel check only",
               "flash_decode_mla": "minicpm3 slot pool",
               "flash_attention_mla": "minicpm3 slot pool",
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
def _smollm_config(args, **changes):
    """The serve CLI's config for ``args`` (smollm-360m), cut to
    ``SMOLLM_LAYERS`` layers, with ``changes``."""
    from repro_torch.launch import serve
    return serve.config_for(args).replace(num_layers=SMOLLM_LAYERS,
                                          **changes)


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
            base, _, arg = kernel.partition("<")
            if base in WGMMA_SMEM:
                fn = getattr(build.library(name), WGMMA_SMEM[base])
                dims = [int(x) for x in arg.rstrip(">").split(",") if x]
                if base in SHIFTED:           # (Dqk, Dv); not the flag
                    dims = dims[:2]
                fn.argtypes = [ctypes.c_int] * len(dims)
                smem = fn(*dims)
                extra = f", {smem} bytes dynamic smem (wgmma form)"
            print(f"  ptxas {name} {kernel}: {info['registers']} registers, "
                  f"{info['smem']} bytes static smem, spill stores "
                  f"{info['spill_stores']} / loads {info['spill_loads']} "
                  f"bytes{extra}")
    _check_train_builds()
    _print_decode_plans()
    _print_mla_plans()
    _print_topk_plans()
    _print_paged_prefill_grid()


# the one-token decode's plans at the serving paths' shapes: (what, B, M·BS
# or S, page, K/V dtype), at each model's heads: smollm-360m's 5 KV heads of
# 3 query heads at D 64, then mistral-nemo-12b's 8 of 4 and
# deepseek-coder-33b's 8 of 7 at D 128
DECODE_PLANS = (("paged, bf16 pool", 8, 21 * 16, 16, "bfloat16"),
                ("paged, int8 pool", 8, 21 * 16, 16, "int8"),
                ("slot pool, bf16 caches", 8, 328, 16, "bfloat16"),
                ("slot pool, int8 caches", 8, 328, 16, "int8"),
                ("lockstep, bf16 caches", 4, 288, 16, "bfloat16"))
MODEL_HEADS = (("smollm-360m", 5, 3, 64), ("mistral-nemo-12b", 8, 4, 128),
               ("deepseek-coder-33b", 8, 7, 128),
               ("qwen2-moe-a2.7b", 16, 1, 128),
               ("llama4-scout-17b-a16e", 8, 5, 128),
               ("zamba2-1.2b", 32, 1, 64))
# the head_dim-128 dense models, (model, Hkv, G, D): their kernels' checks
# run at both groups, G 7 being the first that is no power of two
HEAD_DIM_128 = MODEL_HEADS[1:3]
# the MoE decoders' heads at D 128: qwen2-moe-a2.7b's 16/16 (G 1, MHA) and
# llama4-scout-17b-a16e's 40/8 (G 5); their instances go by group
# (``<kernel>_d128_g<G>``)
HEAD_DIM_MOE = MODEL_HEADS[3:5]
# zamba2-1.2b's shared attention block: 32/32 heads of 64 (G 1), its
# instances ``<kernel>_g1``
HEAD_DIM_STATE = MODEL_HEADS[5:]


def _print_decode_plans() -> None:
    """The split decode kernels' dynamic shared memory depends on the
    split the wrapper plans: print the plan at each serving path's shape,
    for each model's heads."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as fd
    sms = build.sm_count(torch.device("cuda"))
    for model, hkv, g, d in MODEL_HEADS:
        for what, b, max_len, page, dtype in DECODE_PLANS:
            p = fd.decode_plan(b, hkv, g, d, max_len, page,
                               getattr(torch, dtype), sms)
            print(f"  decode plan {model} (Hkv {hkv}, G {g}, D {d}) {what} "
                  f"[B={b}, {max_len} positions, {sms} SMs]: split "
                  f"{p.split} x {p.splits} ({b * hkv * p.splits} CTAs of "
                  f"{p.threads} threads), {p.smem} bytes dynamic smem a "
                  f"split CTA, {4 * p.workspace} bytes of partials")


# the training kernels' instances, (Dqk, Dv): every form of each must be in
# ptxas's report without a spill
TRAIN_INSTANCES = ((64, 64), (128, 128), (96, 64))
TRAIN_SYMBOLS = {"flash_attention_fwd": ("fresh_fwd_wgmma_kernel",
                                         "fresh_fwd_kernel"),
                 "flash_attention_bwd": ("bwd_dq_wgmma_kernel",
                                         "bwd_dkv_wgmma_kernel",
                                         "bwd_dq_kernel", "bwd_dkv_kernel")}
# the tensor-core training kernels come in two instances a pair, the last
# template argument (kShift) 0 for a launch at q offset 0 and 1 at another
SHIFTED = ("fresh_fwd_wgmma_kernel", "bwd_dq_wgmma_kernel",
           "bwd_dkv_wgmma_kernel")


def _check_train_builds() -> None:
    """The fresh forward's and the backward's instances at every
    ``TRAIN_INSTANCES`` pair (minicpm3-4b's decompressed MLA at (96, 64)),
    bf16 on the tensor cores and fp32 on the CUDA cores, in ptxas's report
    of a build this process ran, with no spill."""
    from repro_torch.kernels import build
    for source, symbols in TRAIN_SYMBOLS.items():
        if build.BUILD_LOG.get(source) is None:
            continue
        report = _ptxas_report(build.BUILD_LOG[source])
        want = {f"{sym}<{'f32,' if 'wgmma' not in sym else ''}{a},{b}"
                + (f",{shift}>" if sym in SHIFTED else ">")
                for sym in symbols for a, b in TRAIN_INSTANCES
                for shift in (0, 1)}
        missing = want - set(report)
        if missing:
            _fail(f"ptxas {source}: no report of {sorted(missing)}")
        for kernel in sorted(want):
            info = report[kernel]
            if info["spill_stores"] or info["spill_loads"]:
                _fail(f"ptxas {source} {kernel}: spills {info}")
    print(f"  training kernels at (Dqk, Dv) {TRAIN_INSTANCES}: every form "
          "built, no spill")


def _print_mla_plans() -> None:
    """The latent attention kernels: ptxas's report must name both forms
    of both entry points and show no spill; the decode's split for each
    dtype at minicpm3-4b's serving shapes (the slot pool's B 8 over slots
    of 328, the lockstep's B 4 over 288) and the prefill's grid for each
    dtype at a 64-token chunk and the lockstep prefill, with each form's
    dynamic shared memory."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_mla as fm
    report = _ptxas_report(build.BUILD_LOG.get("flash_mla", ""))
    for kernel, info in report.items():
        if info["spill_stores"] or info["spill_loads"]:
            _fail(f"ptxas flash_mla {kernel}: spills {info}")
    missing = {"mla_split_kernel", "mla_prefill_kernel",
               "mla_decode_wgmma_kernel", "mla_prefill_wgmma_kernel"} - {
        k.partition("<")[0] for k in report}
    if build.BUILD_LOG.get("flash_mla") is not None and missing:
        _fail(f"ptxas flash_mla: no report of {sorted(missing)}")
    sms = build.sm_count(torch.device("cuda"))
    smem = {torch.bfloat16: build.library("flash_mla").flash_mla_wgmma_smem(),
            torch.float32: 0}           # the fp32 forms' tiles are static
    for what, b, s in (("slot pool", 8, MLA_S), ("lockstep", 4, 288)):
        for dtype in (torch.bfloat16, torch.float32):
            p = fm.decode_plan(b, MLA_HEADS, s, dtype, sms)
            print(f"  mla decode plan minicpm3-4b {what} [B={b}, H="
                  f"{MLA_HEADS}, S={s}] {str(dtype)[6:]}, {sms} SMs: split "
                  f"{p.split} x {p.splits} ({b * p.splits} CTAs of "
                  f"{p.threads} threads, {fm.tile(dtype)}-row tiles, "
                  f"{smem[dtype]} bytes dynamic smem), "
                  f"{4 * p.workspace} bytes of partials")
    for b, tq in ((1, 64), (4, 256)):
        for dtype in (torch.bfloat16, torch.float32):
            g = fm.prefill_grid(b, tq, MLA_HEADS, dtype)
            print(f"  mla prefill grid minicpm3-4b [B={b}, Tq={tq}, H="
                  f"{MLA_HEADS}] {str(dtype)[6:]}: {g.ctas} x {b} CTAs of "
                  f"{g.threads} threads, {g.rows} (token, head) rows each, "
                  f"{smem[dtype]} bytes dynamic smem")


# the fused softmax+top-k's plans: (what, R, V, k, logits dtype): the
# serving paths' sampling (fp32 logits over smollm-360m's 49152 entries: the
# decode batch of 8 slots, the lockstep's 4, one prompt's first token) and
# the library's largest calls of phase 9
TOPK_PLANS = (("decode sampling, 8 slots", 8, 49152, 5, "float32"),
              ("lockstep sampling, batch 4", 4, 49152, 5, "float32"),
              ("first token of a prefill", 1, 49152, 5, "float32"),
              ("mistral-nemo-12b decode sampling", 8, 131072, 5, "float32"),
              ("mistral-nemo-12b first token", 1, 131072, 5, "float32"),
              ("deepseek-coder-33b decode sampling", 8, 32256, 5,
               "float32"),
              ("qwen2-moe-a2.7b decode sampling", 8, 151936, 5, "float32"),
              ("llama4-scout-17b-a16e decode sampling", 8, 202048, 5,
               "float32"),
              ("minicpm3-4b decode sampling", 8, 73728, 5, "float32"),
              ("qwen2-moe-a2.7b router, decode B 8", 8, 60, 4, "float32"),
              ("qwen2-moe-a2.7b router, a 64-token chunk", 64, 60, 4,
               "float32"),
              ("llama4-scout-17b-a16e router, 256 tokens", 256, 16, 1,
               "float32"),
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
    """The paged prefill's grid at the serving run's chunk (B 1, Tq 64) for
    each model's query heads: bf16 one warpgroup a 64-row query tile and
    head, fp32 one CTA a 16-row tile and head."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    fn = build.library("flash_attention_paged") \
        .flash_attention_paged_wgmma_smem
    fn.argtypes = [ctypes.c_int]
    b, tq = 1, 64
    for model, hkv, g, d in MODEL_HEADS:
        hq = hkv * g
        print(f"  paged prefill grid {model} [B={b}, Tq={tq}, Hq={hq}, "
              f"D={d}]: bf16 {-(-tq // 64) * b * hq} CTAs of 128 threads "
              f"(paged_wgmma_kernel, {fn(d)} bytes dynamic smem), fp32 "
              f"{-(-tq // fa.BQ) * b * hq} CTAs of 128 threads "
              "(prefill_paged_kernel)")


# the tensor-core kernels and the C function giving each one's dynamic
# shared memory (in the library of its source)
WGMMA_SMEM = {"fresh_fwd_wgmma_kernel": "flash_attention_fwd_wgmma_smem",
              "offset_wgmma_kernel": "flash_attention_offset_wgmma_smem",
              "paged_wgmma_kernel": "flash_attention_paged_wgmma_smem",
              "bwd_dq_wgmma_kernel": "flash_attention_bwd_dq_wgmma_smem",
              "bwd_dkv_wgmma_kernel": "flash_attention_bwd_dkv_wgmma_smem",
              "mla_decode_wgmma_kernel": "flash_mla_wgmma_smem",
              "mla_prefill_wgmma_kernel": "flash_mla_wgmma_smem"}


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
    40000, or past 7/8 of a shorter row); row 3 constant (ties across every
    edge); row 4 its second slice all -inf, row 5 its first.  Returns (x,
    row 1's tied indices)."""
    import torch
    x = torch.randn(r, v, generator=gen) * 4.0
    ties = sorted({17, slice_len - 1, slice_len, 2 * slice_len - 1,
                   2 * slice_len})
    x[1, ties] = float(x[1].max()) + 1.0
    x[2, min(40000, v - v // 8):] = float("-inf")
    x[3, :] = x[3, 0]
    x[4, slice_len:2 * slice_len] = float("-inf")
    x[5, :slice_len] = float("-inf")
    return x, ties


def _check_softmax_topk(gen, v: int = 49152) -> float:
    """The fused softmax+top-k against its plain version at the decode
    batch's logits [8, v] (``_topk_input``: ties straddling the plan's
    slice edges, an all -inf slice, a padded vocabulary, a constant row) at
    k = 1, 5 and 32, fp32 and bf16: indices equal, values and lse within
    rtol 1e-5 (bf16 values within one bf16 ulp, rtol 2^-7), row 1's ties in
    index order, a second call bit-equal to the first, and the profiler
    seeing one launch of ``softmax_topk_kernel`` a call and no other port
    kernel; then, at smollm-360m's vocabulary, [70000, 1000] fp32, whose
    plan is one CTA a row (S = 1).  Returns the fp32 k = 5 max abs error
    (values and lse)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import softmax_topk as st
    sms = build.sm_count(torch.device("cuda"))
    r, worst = 8, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 5, 32):
            p = st.plan(r, v, k, dtype, sms)
            x, ties = _topk_input(gen, r, v, p.slice)
            x = x.to(device="cuda", dtype=dtype)
            what = (f"softmax_topk [{r}, {v}] {str(dtype)[6:]} k={k} "
                    f"({p.slices} slices of {p.slice})")
            got, prof = _profiled(lambda: st.softmax_topk(x, k))
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
    if v != 49152:
        return worst
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


def _check_prefill(gen, hkv: int = 5, g: int = 3, d: int = 64) -> float:
    """Every case of ``PREFILL_CASES`` at BS 8, 16 and 32, fp32 (atol 1e-5)
    and bf16 (atol 2e-2), over shuffled (non-monotonic) tables with every
    dead entry pointing at a NaN page and every position past a row's vlen
    in its last live page NaN; under torch.profiler, which must see that
    dtype's form (``PREFILL_FORMS``) and no other port kernel."""
    import torch
    worst = 0.0
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        form, symbol = PREFILL_FORMS[str(dtype)[6:]]

        def cases():
            errs = []
            for bs in (8, 16, 32):
                for tq, qoff, vlens in PREFILL_CASES:
                    q, kp, vp, tk, tp, vl = _paged_inputs(
                        gen, dtype=dtype, bs=bs, vlens=vlens, tq=tq,
                        hkv=hkv, g=g, d=d)
                    (kk, kpl), (vk, vpl) = (_poisoned_tails(x, tk, vlens, bs)
                                            for x in (kp, vp))
                    qo = torch.tensor(qoff, dtype=torch.int32, device="cuda")
                    what = (f"{str(dtype)[6:]} D={d} G={g} BS={bs} "
                            f"B={len(vlens)} Tq={tq} q_offset={qoff} "
                            f"vlen={vlens}")
                    err, lse = _prefill_err(q, kk, vk, qo, vl, tk, tp, what,
                                            atol, plain_pools=(kpl, vpl))
                    if 0 in vlens and not torch.isneginf(
                            lse[vlens.index(0)]).all():
                        _fail(f"flash_attention_paged {what}: lse of the "
                              "keyless row is not -inf")
                    errs.append(err)
            return errs
        errs, prof = _profiled(cases)
        seen = _kernels_seen(prof)
        if seen != [symbol]:
            _fail(f"flash_attention_paged {str(dtype)[6:]}: the profiler saw "
                  f"{seen}, the {form} form is {symbol}")
        if dtype == torch.float32:
            worst = max(errs)
        print(f"kernel flash_attention_paged {str(dtype)[6:]} "
              f"{hkv * g}/{hkv} heads D {d} ({form}, "
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
    input; raises beyond ``atol`` (the output's ``_scaled_err``, lse's max
    abs error), on non-finite output or when the -inf pattern of lse
    differs.  Returns (that error, the kernel's lse)."""
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
    err = max(_scaled_err(out, w_out, absolute=True),
              (lse[fin] - w_lse[fin]).abs().max().item())
    if err > atol:
        _fail(f"flash_attention_offset {what}: row-scaled err {err:.3g} > "
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


def _check_offset(gen, hkv: int = 5, g: int = 3, d: int = 64) -> float:
    """Every case of ``_offset_cases`` in fp32 (atol 1e-5) and bf16 (atol
    2e-2; ``_offset_err``), K/V NaN at and past each row's valid length, under
    torch.profiler, which must see that dtype's form (``OFFSET_FORMS``) and
    no other port kernel."""
    import torch
    worst = 0.0
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        form, symbol = OFFSET_FORMS[str(dtype)[6:]]

        def cases():
            errs = []
            for tk, tq, qoff, vlens in _offset_cases():
                inputs = _contiguous_inputs(gen, dtype=dtype, s=tk,
                                            vlens=vlens, tq=tq, hkv=hkv,
                                            g=g, d=d)
                qo = torch.tensor(qoff, dtype=torch.int32, device="cuda")
                vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
                what = (f"{str(dtype)[6:]} D={d} G={g} B={len(vlens)} "
                        f"Tk={tk} Tq={tq} q_offset={qoff} vlen={vlens}")
                err, lse = _offset_err(inputs, qo, vl, what, atol)
                if 0 in vlens and not torch.isneginf(
                        lse[vlens.index(0)]).all():
                    _fail(f"flash_attention_offset {what}: lse of the "
                          "keyless row is not -inf")
                errs.append(err)
            return errs
        errs, prof = _profiled(cases)
        seen = _kernels_seen(prof)
        if seen != [symbol]:
            _fail(f"flash_attention_offset {str(dtype)[6:]}: the profiler "
                  f"saw {seen}, the {form} form is {symbol}")
        if dtype == torch.float32:
            worst = max(errs)
        print(f"kernel flash_attention_offset {str(dtype)[6:]} "
              f"{hkv * g}/{hkv} heads D {d} ({form}, "
              f"{symbol}): {len(errs)} cases (64-token chunks at q_offset "
              f"0/64/192, tails 32..1, B=3 Tq=37 with a keyless row, "
              f"lockstep B=4 Tq=256, single-shot Tq=Tk=80/272, q_offset "
              f"100/37/150/3, Tq=65/130; K/V NaN past vlen): row-scaled err "
              f"{max(errs):.3g} (atol {atol})")
    return worst


def _fresh_inputs(gen, *, dtype, b, t, hkv=5, g=3, d=64, spare=16, dv=None,
                  tk=None):
    """q [B, T, Hq, D], dout [B, T, Hq, Dv] and k [B, Tk, Hkv, D], v
    [B, Tk, Hkv, Dv] on the card (Tk is T unless ``tk`` is given: the
    cross-attention's keys), k and v cut from buffers of Tk + ``spare``
    positions whose rows past Tk are NaN (so they are strided views, and a
    kernel that reads past Tk turns its output NaN).  Dv is D unless ``dv``
    is given (MLA's 96 / 64: k and v then come from buffers of their own,
    with strides of their own)."""
    import torch
    tk = tk or t
    q = torch.randn(b, t, hkv * g, d, generator=gen)
    dout = torch.randn(b, t, hkv * g, dv or d, generator=gen)
    if dv is not None:
        k = torch.randn(b, tk + spare, hkv, d, generator=gen)
        v = torch.randn(b, tk + spare, hkv, dv, generator=gen)
        k[:, tk:] = v[:, tk:] = float("nan")
        k, v = (x.to(device="cuda", dtype=dtype)[:, :tk] for x in (k, v))
    else:
        kv = torch.randn(2, b, tk + spare, hkv, d, generator=gen)
        kv[:, :, tk:] = float("nan")
        kv = kv.to(device="cuda", dtype=dtype)
        k, v = kv[0, :, :tk], kv[1, :, :tk]
    return (q.to(device="cuda", dtype=dtype), k, v,
            dout.to(device="cuda", dtype=dtype))


def _scaled_err(got, want, *, by_row: bool = True,
                absolute: bool = False) -> float:
    """A bf16 output's largest error of a row (the last axis: one query's
    output or dq, one key's dk or dv, one head's decode output) over that
    row's largest reference entry, floored at ``ROW_FLOOR`` of the
    tensor's largest (a row the maths makes ~0, as a keyless query's or a
    causal dq's first, is held at that scale).  At the long-key shapes a
    row's entries lie far below 1 (a causal row late in 3136 keys, a
    cross-attention row over 1536), so a scale of 1, or of the whole
    tensor, would let a wrong row of the tensor-core forms pass.

    Without ``by_row``, a bf16 error is over the tensor's largest entry:
    for ``FlashAttention`` against autograd through the plain forward,
    whose bf16 backward takes delta from the rounded output (as the
    reference's does) where autograd's softmax takes it exact, an
    absolute difference that a small row would magnify.  With
    ``absolute`` (the decode and cached-prefill checks, which held the max
    abs error before rows were scaled) a row's scale is at most 1.

    Other dtypes, and a bf16 tensor whose largest entry is below
    ``NOISE_PEAK`` (rounding noise around a zero the maths gives: one
    key's dq and dk), take the max abs error over the larger of 1 and that
    entry, or with ``absolute`` the max abs error itself: fp32 is held at
    1e-5, below bf16's own rounding, where its noise rows (~1e-6) would
    fail a row scale.  NaN anywhere reads as inf."""
    import torch
    g, w = got.float(), want.float()
    peak = w.abs().max().item()
    diff = (g - w).abs()
    if want.dtype != torch.bfloat16 or peak < NOISE_PEAK:
        err = diff.max().item() / (1.0 if absolute else max(1.0, peak))
    elif not by_row:
        err = diff.max().item() / peak
    else:
        rows = w.abs().amax(-1, keepdim=True).clamp_min(ROW_FLOOR * peak)
        if absolute:
            rows = rows.clamp_max(1.0)
        err = (diff / rows).max().item()
    return err if err == err else float("inf")


# ``_scaled_err``'s floors: a bf16 row's scale is at least this share of
# the tensor's largest entry, and a bf16 tensor below this largest entry
# is noise
ROW_FLOOR, NOISE_PEAK = 1e-2, 1e-3


def _fresh_errs(q, k, v, dout, causal: bool, q_offset: int = 0) -> dict:
    """The fresh forward and the two backward kernels against their plain
    versions on one input, query row i at ``q_offset`` + i: {name:
    ``_scaled_err``}."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    # the offset only where set, so the timing tools can import the
    # kernels of a version that has no offset
    off = {"q_offset": q_offset} if q_offset else {}
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, **off)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, **off)
    torch.cuda.synchronize()
    k0, v0 = torch.nan_to_num(k), torch.nan_to_num(v)
    w_out, w_lse = fa.flash_attention_fwd_plain(q, k0, v0, causal=causal,
                                                **off)
    w_dq, w_dk, w_dv = fab.flash_attention_bwd_plain(q, k0, v0, out, lse,
                                                     dout, causal=causal,
                                                     **off)
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


# sessions of phase 3 that recorded some of the port's kernels but not all
# that ``want`` named, and ran again (``_profiled``)
PARTIAL_SESSIONS = []


def _profiled(fn, cpu: bool = False, want=()):
    """``fn()`` in one ``obs.kernels.profile_session`` (CUDA activity, and
    CPU's with ``cpu``, up to a device synchronize, after a synchronized
    warm-up launch; a session that launched kernels but recorded none runs
    again, at most ``obs.kernels.SESSION_TRIES`` in all): (its result, the
    profile).  With ``want`` (kernel symbols that ``fn`` launches), a
    session whose port kernels are some of those but not all lost device
    events (the card's profiler now and then drops a session's first
    launches) and runs again, within the same number of tries."""
    from repro_torch.obs import kernels as obs_kernels
    for attempt in range(1, obs_kernels.SESSION_TRIES + 1):
        out, prof = obs_kernels.profile_session(fn, cpu=cpu)
        if not set(_launch_counts(prof)) < set(want):
            break
        PARTIAL_SESSIONS.append(attempt)
    return out, prof


def _template_args(prof, symbols) -> dict:
    """{symbol: the set of template argument lists (spaces dropped) its
    device events carry in ``prof``} for the given port kernel symbols, so
    a check can name the instance (head dim, dtype) that ran."""
    import re
    out = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        for sym in symbols:
            found = re.search(re.escape(sym) + r"<([^>]*)>", evt.key)
            if found:
                out.setdefault(sym, set()).add(
                    found.group(1).replace(" ", ""))
    return out


def _check_fresh(gen, hkv: int = 5, g: int = 3, d: int = 64,
                 dv=None) -> dict:
    """The training kernels at T = 512 (the training runs'), 37 (not a
    multiple of the 16- or 64-row tile) and 1, causal and not, B = 2,
    ``hkv`` KV heads of ``g`` query heads, head dims ``d`` (q, k) and
    ``dv`` (v; ``d`` unless given); then ``FlashAttention``'s dq, dk, dv
    against autograd through the plain forward.  The first case of each
    dtype runs under torch.profiler, which must see that dtype's form
    (``FRESH_FORMS``) at head dims (``d``, ``dv``) (each symbol's template
    arguments) and no other port kernel.  Errors are ``_scaled_err``'s
    (bf16: each row's over its largest entry); fp32 within 1e-5, bf16
    within 2e-2.
    Returns the bf16 errors: the training path runs bf16."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    worst = dict.fromkeys(("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"), 0.0)
    dims = f"{d},{dv or d}"
    heads = f"Hq={hkv * g} Hkv={hkv} D={d}" + (f" Dv={dv}" if dv else "")
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        errs = dict.fromkeys(worst, 0.0)
        form, symbols = FRESH_FORMS[str(dtype)[6:]]
        seen = None
        for t in (512, 37, 1):
            for causal in (True, False):
                inputs = _fresh_inputs(gen, dtype=dtype, b=2, t=t, hkv=hkv,
                                       g=g, d=d, dv=dv)
                if seen is None:
                    case, prof = _profiled(
                        lambda: _fresh_errs(*inputs, causal), cpu=True,
                        want=symbols)
                    seen = _kernels_seen(prof)
                    targs = _template_args(prof, symbols)
                    if seen != sorted(symbols) or any(
                            len(a) != 1 or ",".join(
                                x for x in next(iter(a)).split(",")
                                if x.isdigit()) != dims
                            for a in targs.values()):
                        _fail(f"fresh attention {str(dtype)[6:]} {heads}: "
                              f"the profiler saw {seen} with template "
                              f"arguments {targs}, the {form} form is "
                              f"{sorted(symbols)} at <{dims}>")
                    seen = [f"{sym}<{next(iter(targs[sym]))}>"
                            for sym in sorted(symbols)]
                else:
                    case = _fresh_errs(*inputs, causal)
                for name, err in case.items():
                    if err > atol:
                        _fail(f"{name} {str(dtype)[6:]} {heads} T={t} "
                              f"causal={causal}: row-scaled err "
                              f"{err:.3g} > {atol}")
                    errs[name] = max(errs[name], err)
        q, k, v, dout = _fresh_inputs(gen, dtype=dtype, b=2, t=37, hkv=hkv,
                                      g=g, d=d, dv=dv)
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
        auto = max(_scaled_err(a, b_, by_row=False)
                   for a, b_ in zip(*grads))
        if auto > atol:
            _fail(f"FlashAttention {str(dtype)[6:]} {heads}: gradients "
                  f"differ from autograd through the plain forward by "
                  f"{auto:.3g}")
        print(f"kernel fresh attention {str(dtype)[6:]} on the {form} "
              f"({', '.join(seen)} seen by the profiler) B=2 {heads} "
              f"T=512/37/1 causal and not, K/V NaN past T: row-scaled "
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


def _check_int8(gen, hkv: int = 5, g: int = 3, d: int = 64) -> dict:
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
                gen, dtype=dtype, bs=bs, vlens=vlens, hkv=hkv, g=g, d=d)
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
                    gen, dtype=dtype, bs=bs, vlens=pvl, tq=tq, hkv=hkv, g=g,
                    d=d)
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
            gen, s=328, vlens=vlens, hkv=hkv, d=d)
        q = torch.randn(8, 1, hkv * g, d, generator=gen).to(device="cuda",
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
        print(f"kernel int8 forms {str(dtype)[6:]} q, {hkv * g}/{hkv} heads, "
              f"D {d}, "
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


def _split_plan(fd, hkv, max_len, unit, kv_dtype, g=3, d=64):
    """The smallest batch (from 8) whose split edges fit one row each, and
    the plan the wrapper makes for it on this card."""
    import torch
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    for b in range(8, 256):
        plan = fd.decode_plan(b, hkv, g, d, max_len, unit, kv_dtype,
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


def _decode_split_inputs(gen, name, dtype, vlens, *, hkv, bs, m, s, g=3,
                         d=64):
    """(q, the kernel's operands, the plain version's, vlen) of one decode
    form for rows of valid lengths ``vlens``; paged tables cut to ``m``
    entries (every live one), contiguous caches of ``s`` positions."""
    import torch
    if name == "flash_decode_paged_int8":
        q, kern, plain, tk, tp, vl = _int8_paged_inputs(
            gen, dtype=dtype, bs=bs, vlens=vlens, hkv=hkv, g=g, d=d)
        return (q, (*kern, tk[:, :m].contiguous()),
                (*plain, tp[:, :m].contiguous()), vl)
    if name == "flash_decode_paged":
        q, kp, vp, tk, tp, vl = _paged_inputs(gen, dtype=dtype, bs=bs,
                                              vlens=vlens, hkv=hkv, g=g, d=d)
        (kk, kpl), (vk, vpl) = (_poisoned_tails(x, tk, vlens, bs)
                                for x in (kp, vp))
        return (q, (kk, vk, tk[:, :m].contiguous()),
                (kpl, vpl, tp[:, :m].contiguous()), vl)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    if name == "flash_decode_int8":
        cache = _int8_contiguous_inputs(gen, s=s, vlens=vlens, hkv=hkv, d=d)
        q = torch.randn(len(vlens), 1, hkv * g, d, generator=gen).to(
            device="cuda", dtype=dtype)
        return q, cache[:4], cache[4:], vl
    q, k, v, k0, v0 = _contiguous_inputs(gen, dtype=dtype, s=s, vlens=vlens,
                                         hkv=hkv, g=g, d=d)
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


def _check_decode_splits(gen, hkv: int = 5, g: int = 3,
                         d: int = 64) -> dict:
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
    from repro_torch.kernels import flash_decode as fd
    bs, m, s = 16, 21, 328
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
                                  torch.int8 if int8 else dtype, g=g, d=d)
            vlens = _split_edges(plan, max_len, b, gen)
            q, kern, plain, vl = _decode_split_inputs(
                gen, name, dtype, vlens, hkv=hkv, bs=bs, m=m, s=s, g=g, d=d)
            got, prof = _profiled(
                lambda: _decode_call(fd, name, q, kern, vl))
            again = _decode_call(fd, name, q, kern, vl)
            torch.cuda.synchronize()
            seen = _kernels_seen(prof)
            if seen != [split_kernel[name]]:
                _fail(f"{name}: the profiler saw {seen}, not "
                      f"{split_kernel[name]} alone")
            want = _decode_call(fd, name, q, plain, vl, plain=True)
            what = (f"{name} {str(dtype)[6:]} {hkv * g}/{hkv} heads D {d} "
                    f"B={b} split {plan.split} x {plan.splits}")
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


# the head_dim-128 models' vocabularies, the sampler's rows
VOCABS_128 = (131072, 32256)
# the MoE decoders' vocabularies (qwen2-moe-a2.7b, llama4-scout-17b-a16e)
VOCABS_MOE = (151936, 202048)
# the router through the fused softmax+top-k, (rows, experts, k): qwen2-moe's
# 60 experts top 4 at a decode step's 8 rows and a 64-token chunk's 64,
# llama4-scout's 16 top 1 at 8 rows and a 256-token prefill; then widths
# that are no multiple of a 16-byte vector, so rows start off a boundary
# and take the kernel's scalar head and tail (the smoke config's 6 experts
# top 2, and 61)
ROUTER_SHAPES = ((8, 60, 4), (64, 60, 4), (8, 16, 1), (256, 16, 1),
                 (64, 6, 2), (64, 61, 4))


def _check_instances(gen, model: str, hkv: int, g: int, d: int) -> dict:
    """Every check of the attention kernels' D 64 instances again at
    ``model``'s ``hkv`` KV heads of ``g`` query heads and head dim ``d``:
    the paged and contiguous cached prefills (fp32 on the CUDA cores, bf16
    on the tensor cores), the int8 forms, the fresh forward and its dq and
    dk/dv backward (the training kernels), the split decode's edges in its
    four forms.  Returns {kernel: max abs error}."""
    found = {"flash_attention_paged": _check_prefill(gen, hkv, g, d),
             "flash_attention_offset": _check_offset(gen, hkv, g, d),
             **_check_int8(gen, hkv, g, d), **_check_fresh(gen, hkv, g, d)}
    for name, err in _check_decode_splits(gen, hkv, g, d).items():
        found[name] = max(found.get(name, 0.0), err)
    print(f"kernel head_dim {d} at {model}'s {hkv * g}/{hkv} heads "
          f"(G {g}): every instance within its tolerance")
    return found


def _merge_errs(errs: dict, found: dict, suffix: str) -> None:
    for name, err in found.items():
        key = name + suffix
        errs[key] = max(errs.get(key, 0.0), err)


def _check_head_dim_128(gen) -> dict:
    """The serving kernels' head_dim-128 instances against their plain
    versions (``_check_instances``) with mistral-nemo-12b's 32/8 heads and
    deepseek-coder-33b's 56/8 (two atom columns a row on the tensor cores),
    and the sampler at both models' vocabularies.  Returns {instance: max
    abs error} (keys ``<kernel>_d128`` and ``softmax_topk_v<V>``)."""
    errs = {f"softmax_topk_v{v}": _check_softmax_topk(gen, v=v)
            for v in VOCABS_128}
    for model, hkv, g, d in HEAD_DIM_128:
        _merge_errs(errs, _check_instances(gen, model, hkv, g, d), "_d128")
    return errs


def _check_router(gen) -> dict:
    """The fused softmax+top-k as the MoE router runs it (``ROUTER_SHAPES``,
    fp32): through ``dispatch.softmax_topk`` on a [G, S, E] view, against
    the plain version on the same logits: indices equal in order (ties
    within a row, which decide the drops, in index order), values and lse
    within rtol 1e-5, a repeat bit-equal, one ``softmax_topk_kernel`` launch
    seen by the profiler; then ``layers.moe_route`` over the same logits
    (an identity router, exact on both devices) at qwen2-moe's capacity
    factor keeps and drops the same assignments on the card as on the CPU.
    Returns {``softmax_topk_router_e<E>``: max abs error (values, lse)}."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import softmax_topk as st
    from repro_torch.models import layers as L
    base = configs.get("qwen2_moe_a2p7b")
    errs = {}
    for r, e, k in ROUTER_SHAPES:
        x = torch.randn(r, e, generator=gen) * 2.0
        x[0, [e // 3, e - 1]] = float(x[0].max()) + 1.0   # a tie at the top
        x[1, :] = x[1, 0]                                  # all tie
        g, s_ = (r, 1) if r == 8 else (1, r)               # decode | chunk
        xc = x.reshape(g, s_, e).cuda()
        what = f"softmax_topk router [{r}, {e}] float32 k={k} (G {g}, S {s_})"
        got, prof = _profiled(lambda: dispatch.softmax_topk(xc, k))
        seen = _launch_counts(prof)
        if seen != {"softmax_topk_kernel": 1}:
            _fail(f"{what}: the profiler saw {seen}, not one launch of "
                  "softmax_topk_kernel")
        again = dispatch.softmax_topk(xc, k)
        want = st.softmax_topk_plain(xc, k)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
            _fail(f"{what}: two calls on the same input differ")
        if not torch.equal(got.indices.long(), want.indices):
            _fail(f"{what}: indices differ:\n{got.indices}\n{want.indices}")
        ties = got.indices.reshape(r, k)[0, :2].tolist()
        if ties != [e // 3, e - 1][:k]:
            _fail(f"{what}: tie order {ties}, want {[e // 3, e - 1][:k]}")
        for a, b_, name in ((got.values, want.values, "values"),
                            (got.logsumexp, want.logsumexp, "lse")):
            if not torch.allclose(a, b_, rtol=1e-5, atol=0.0):
                _fail(f"{what}: {name} beyond rtol 1e-5: max abs "
                      f"{(a - b_).abs().max().item():.3g}")
        err = max((got.values - want.values).abs().max().item(),
                  (got.logsumexp - want.logsumexp).abs().max().item())
        key = f"softmax_topk_router_e{e}"
        errs[key] = max(errs.get(key, 0.0), err)
        moe = dataclasses.replace(base.moe, num_experts=e,
                                  experts_per_token=k, pad_experts_to=0)
        cfg = base.replace(moe=moe)
        routes = {dev: L.moe_route({"router": torch.eye(e, device=dev)},
                                   xc.to(dev), cfg)
                  for dev in ("cuda", "cpu")}
        kc, kp = routes["cuda"].keep.cpu(), routes["cpu"].keep
        if not torch.equal(kc, kp) or not torch.equal(
                routes["cuda"].idx.long().cpu(), routes["cpu"].idx):
            _fail(f"{what}: moe_route keeps {kc.sum().item()} assignments "
                  f"on the card, {kp.sum().item()} on the CPU")
        print(f"kernel {what}: indices equal (ties in index order), max abs "
              f"err {err:.3g} (rtol 1e-5); one softmax_topk_kernel launch "
              f"seen by the profiler; a repeat bit-equal; moe_route keeps "
              f"{kp.sum().item()} of {kp.numel()} assignments (capacity "
              f"{routes['cpu'].cap}) on both devices")
    return errs


def _check_moe_shapes(gen) -> dict:
    """The MoE decoders' kernel shapes against their plain versions: the
    router (``_check_router``), the sampler at both vocabularies, and every
    serving kernel's D-128 instance at qwen2-moe's 16/16 heads (G 1) and
    llama4-scout's 40/8 (G 5).  Returns {instance: max abs error} (keys
    ``softmax_topk_router_e<E>``, ``softmax_topk_v<V>``,
    ``<kernel>_d128_g<G>``)."""
    errs = _check_router(gen)
    errs.update({f"softmax_topk_v{v}": _check_softmax_topk(gen, v=v)
                 for v in VOCABS_MOE})
    for model, hkv, g, d in HEAD_DIM_MOE:
        _merge_errs(errs, _check_instances(gen, model, hkv, g, d),
                    f"_d128_g{g}")
    return errs


# minicpm3-4b's latent attention: 40 heads over one latent row of R 256
# (c, also the value) and Dr 32 (r), at the scale (qk_nope + qk_rope)^-0.5
MLA_HEADS, MLA_R, MLA_DR = 40, 256, 32
MLA_SCALE = 96 ** -0.5
# the slot pool's slots (prompt 256 + 64 tokens + 8) and a decode step's
# ragged lengths over them
MLA_S = 328
MLA_DECODE_VLENS = [328, 289, 250, 211, 172, 133, 94, 65]
# the cached prefill's cases, (B, Tq, per-row offsets, S, H): the slot
# pool's 64-token chunks after cached prefixes, Tq 65 and 130 at offsets
# off the 32-row and 64-row tiles (so vlen ends mid-tile, and the last
# 64-row tile of T·H flattened rows holds rows past T·H), an int8 run's
# single-shot prefill and the lockstep prefill at minicpm3-4b's 40 heads;
# then 7 heads (T·H 259: a last tile of 3 rows, a token's heads across
# tile edges)
MLA_PREFILL_CASES = ((3, 64, (0, 64, 200), 328, 40),
                     (2, 65, (7, 100), 328, 40),
                     (2, 130, (0, 33), 328, 40), (1, 256, (0,), 256, 40),
                     (4, 256, (0, 0, 0, 0), 288, 40),
                     (2, 37, (5, 70), 328, 7))
# the decode's cases past the slot pool's step, (label, H, vlens): vlens
# ending mid-64-key tile at 7 heads (a Q tile of 7 rows)
MLA_DECODE_CASES = (("mid-tile, 7 heads", 7,
                     [1, 63, 65, 100, 127, 129, 191, 327]),)
# the kernel each dtype's form runs, as the profiler names it: bf16 on the
# tensor cores, fp32 on the CUDA cores
MLA_FORMS = {"bfloat16": ("mla_decode_wgmma_kernel",
                          "mla_prefill_wgmma_kernel"),
             "float32": ("mla_split_kernel", "mla_prefill_kernel")}
# minicpm3-4b's vocabulary, 73448 real entries padded to 73728
MLA_VOCAB, MLA_REAL_VOCAB = 73728, 73448


def _mla_inputs(gen, *, dtype, b, tq, vlens, s, poison=True, h=MLA_HEADS):
    """q_eff [B, Tq, H, 256], q_rope [B, Tq, H, 32] and latent caches c
    [B, S, 256], r [B, S, 32], each cache layer 1 of a [2, B, S, ...]
    tensor (read through its strides, as a serving layer's is), every row
    at or past its vlen NaN (``poison``); and vlen [B] int32."""
    import torch
    q = torch.randn(b, tq, h, MLA_R, generator=gen)
    qr = torch.randn(b, tq, h, MLA_DR, generator=gen)
    c = torch.randn(2, b, s, MLA_R, generator=gen)
    r = torch.randn(2, b, s, MLA_DR, generator=gen)
    for row, n in enumerate(vlens):
        if poison:
            c[1, row, n:] = float("nan")
            r[1, row, n:] = float("nan")
    dev = dict(device="cuda", dtype=dtype)
    return (q.to(**dev), qr.to(**dev), c.to(**dev)[1], r.to(**dev)[1],
            torch.tensor(vlens, dtype=torch.int32, device="cuda"))


def _mla_err(what, got, again, want, atol, rtol, zero_rows=()) -> float:
    """Kernel against plain: finite, a repeat bit-equal, the rows with no
    visible key exactly 0, every entry within ``atol + rtol·|plain|``.
    Returns the max abs error."""
    import torch
    if not torch.isfinite(got).all():
        _fail(f"{what}: non-finite output (a row past vlen was read)")
    if not torch.equal(got, again):
        _fail(f"{what}: two calls on the same input differ")
    for row in zero_rows:
        if got[row].abs().max().item() != 0.0:
            _fail(f"{what}: row {row} (vlen 0) gave a nonzero output")
    diff = (got.float() - want.float()).abs()
    over = diff - (atol + rtol * want.float().abs())
    if over.max().item() > 0:
        _fail(f"{what}: max abs err {diff.max().item():.3g} beyond atol "
              f"{atol} + rtol {rtol:.3g}")
    return diff.max().item()


def _check_mla(gen) -> dict:
    """MLA's kernels against their plain versions at minicpm3-4b's heads
    and widths, fp32 and bf16, every latent row past a row's vlen NaN:
    the decode at B 8 over the slot pool's ragged lengths 65-328, at the
    smallest batch whose rows take vlen 0, 1, each split edge ± 1 and the
    full 328 (one row for every count of live splits), vlen 0 giving
    exactly 0, and at 7 heads over vlens ending mid-64-key tile
    (``MLA_DECODE_CASES``); the cached prefill (``MLA_PREFILL_CASES``); each
    a repeat bit-equal, the profiler seeing its dtype's form alone
    (``MLA_FORMS``: bf16 the tensor-core kernels, fp32 the CUDA-core ones);
    then the sampler at minicpm3-4b's vocabulary.  Tolerances: fp32 atol
    1e-5 (two fp32 accumulations in other orders); bf16 one bf16 ulp of the
    output, rtol 2^-7, plus atol 1e-3 (each side rounds its fp32 result to
    bf16 once, and the kernel's P·V takes P as two bf16 terms; the outputs
    reach 2-4, where an ulp is 0.0156-0.031).  Returns {kernel: max abs error}
    (fp32)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_mla as fm
    sms = build.sm_count(torch.device("cuda"))
    worst = {"flash_decode_mla": 0.0, "flash_attention_mla": 0.0}
    for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0),
                              (torch.bfloat16, 1e-3, 2.0 ** -7)):
        name = str(dtype)[6:]
        dec_sym, pre_sym = MLA_FORMS[name]
        b_edge = next(b for b in range(8, 256) if 3 * fm.decode_plan(
            b, MLA_HEADS, MLA_S, dtype, sms).splits <= b)
        plan = fm.decode_plan(b_edge, MLA_HEADS, MLA_S, dtype, sms)
        for label, h, vlens in (
                ("ragged", MLA_HEADS, MLA_DECODE_VLENS),
                ("split edges", MLA_HEADS,
                 _split_edges(plan, MLA_S, b_edge, gen)),
                *MLA_DECODE_CASES):
            q, qr, c, r, vl = _mla_inputs(gen, dtype=dtype, b=len(vlens),
                                          tq=1, vlens=vlens, s=MLA_S, h=h)
            p = fm.decode_plan(len(vlens), h, MLA_S, dtype, sms)
            what = (f"flash_decode_mla {name} B={len(vlens)} H={h} "
                    f"S={MLA_S} {label} (split {p.split} x {p.splits})")

            def call():
                return fm.flash_decode_mla(q, qr, c, r, vl, scale=MLA_SCALE)
            got, prof = _profiled(call, want=(dec_sym,))
            seen = _kernels_seen(prof)
            if seen != [dec_sym]:
                _fail(f"{what}: the profiler saw {seen}, not {dec_sym} "
                      "alone")
            want = fm.flash_decode_mla_plain(q, qr, c, r, vl,
                                             scale=MLA_SCALE)
            err = _mla_err(what, got, call(), want, atol, rtol,
                           [i for i, n in enumerate(vlens) if n == 0])
            if dtype == torch.float32:
                worst["flash_decode_mla"] = max(worst["flash_decode_mla"],
                                                err)
            print(f"kernel {what}: vlen {min(vlens)}..{max(vlens)}, rows "
                  f"past vlen NaN; max abs err {err:.3g} (atol {atol}, rtol "
                  f"{rtol:.3g}); a repeat bit-equal; {dec_sym} seen by the "
                  "profiler")
        for b, tq, offs, s, h in MLA_PREFILL_CASES:
            vlens = [o + tq for o in offs]
            q, qr, c, r, vl = _mla_inputs(gen, dtype=dtype, b=b, tq=tq,
                                          vlens=vlens, s=s, h=h)
            qo = torch.tensor(offs, dtype=torch.int32, device="cuda")
            g = fm.prefill_grid(b, tq, h, dtype)
            what = (f"flash_attention_mla {name} B={b} Tq={tq} H={h} "
                    f"q_offset {list(offs)} vlen {vlens} S={s} ({g.ctas} x "
                    f"{b} CTAs of {g.rows} rows)")

            def call():
                return fm.flash_attention_mla(q, qr, c, r, qo, vl,
                                              scale=MLA_SCALE)
            got, prof = _profiled(call, want=(pre_sym,))
            seen = _kernels_seen(prof)
            if seen != [pre_sym]:
                _fail(f"{what}: the profiler saw {seen}, not {pre_sym} "
                      "alone")
            want = fm.flash_attention_mla_plain(q, qr, c, r, qo, vl,
                                                scale=MLA_SCALE)
            err = _mla_err(what, got, call(), want, atol, rtol)
            if dtype == torch.float32:
                worst["flash_attention_mla"] = max(
                    worst["flash_attention_mla"], err)
            print(f"kernel {what}: causal, rows past vlen NaN; max abs err "
                  f"{err:.3g} (atol {atol}, rtol {rtol:.3g}); a repeat "
                  f"bit-equal; {pre_sym} seen by the profiler")
    worst[f"softmax_topk_v{MLA_VOCAB}"] = _check_padded_sampler(gen)
    return worst


def _check_padded_sampler(gen, vocab: int = 0, real: int = 0) -> float:
    """Row 1 at a padded vocabulary's logits [8, ``vocab``] (minicpm3-4b's
    73728 by default): ``_check_softmax_topk``'s cases, then the serving
    path's own input, every row's entries from ``real`` on -inf
    (``engine.logits_from_hidden``): indices equal to the plain version's
    and all real, lse within rtol 1e-5.  Returns the fp32 k = 5 max abs
    error."""
    import torch
    from repro_torch.kernels import softmax_topk as st
    vocab, real = vocab or MLA_VOCAB, real or MLA_REAL_VOCAB
    worst = _check_softmax_topk(gen, v=vocab)
    x = torch.randn(8, vocab, generator=gen).cuda() * 4.0
    x[:, real:] = float("-inf")
    got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    torch.cuda.synchronize()
    if not torch.equal(got.indices.long(), want.indices) or \
            got.indices.max().item() >= real or not \
            torch.allclose(got.logsumexp, want.logsumexp, rtol=1e-5, atol=0):
        _fail(f"softmax_topk [8, {vocab}] with the padded entries -inf: "
              "differs from its plain version or picked a padded entry")
    print(f"kernel softmax_topk [8, {vocab}] float32 k=5, the "
          f"{vocab - real} padded entries of every row -inf: indices equal "
          "and real, lse within rtol 1e-5")
    return worst


def _check_mla_train(gen) -> dict:
    """The training kernels' (96, 64) instances, minicpm3-4b's decompressed
    MLA (q and k 64 nope + 32 rope, v 64, at its default scale 96^-0.5), at
    its 40/40 heads: every fresh check (``_check_fresh``: T 512 and 37,
    bf16 and fp32, each dtype's form named from the profiler), k and v
    read through strides of their own.  Returns {``<kernel>_d96``: max
    error}."""
    found = _check_fresh(gen, hkv=MLA_HEADS, g=1, d=96, dv=64)
    return {name + "_d96": err for name, err in found.items()}


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
    errs.update(_check_head_dim_128(gen))
    errs.update(_check_moe_shapes(gen))
    errs.update(_check_mla(gen))
    errs.update(_check_mla_train(gen))
    errs.update(_check_state_shapes(gen))
    errs.update(_check_whisper_shapes(gen))
    errs.update(_check_whisper_train_shapes(gen))
    errs.update(_check_llava_shapes(gen))
    return errs


# the recurrent decoders' vocabularies (zamba2-1.2b, xlstm-125m): the
# sampler's rows
VOCABS_STATE = (32000, 50304)


def _check_state_shapes(gen) -> dict:
    """The recurrent decoders' kernel shapes against their plain versions:
    the sampler at both vocabularies, and every D-64 instance at zamba2's
    32/32 heads (G 1, ``_check_instances``), rows 4 and 5 of its shared
    block among them.  Returns {instance: max abs error} (keys
    ``softmax_topk_v<V>``, ``<kernel>_g1``)."""
    errs = {f"softmax_topk_v{v}": _check_softmax_topk(gen, v=v)
            for v in VOCABS_STATE}
    for model, hkv, g, d in HEAD_DIM_STATE:
        _merge_errs(errs, _check_instances(gen, model, hkv, g, d), f"_g{g}")
    return errs


def _check_whisper_shapes(gen) -> dict:
    """whisper-small's kernel shapes against their plain versions: row 6
    non-causal at its encoder's B 1, T 1536, 12/12 heads of 64 (fp32 and
    bf16, the forward and its backward, K/V NaN past T); row 4 at a B 8
    decode step's cross-attention over all 1536 keys and its
    self-attention's short ragged lengths, 12/12 heads (fp32 and bf16,
    every position past a row's length NaN, the split plan at S 1536
    printed); row 1 at [8, 51968] with every row's 103 padded entries
    -inf.  Errors are ``_scaled_err``'s (bf16: each row's over its
    largest entry).  Returns {instance: error}: ``flash_attention_nc_t1536``,
    ``flash_decode_s1536``, ``softmax_topk_v51968`` (bf16 for the
    attention, as the serving path runs)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    errs = {f"softmax_topk_v{WHISPER_VOCAB}": _check_padded_sampler(
        gen, WHISPER_VOCAB, WHISPER_REAL_VOCAB)}
    geom = dict(hkv=WHISPER_HEADS, g=1, d=64)
    heads = f"Hq={WHISPER_HEADS} Hkv={WHISPER_HEADS} D=64"
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        name = str(dtype)[6:]
        found = _fresh_errs(*_fresh_inputs(gen, dtype=dtype, b=1,
                                           t=WHISPER_S_ENC, **geom), False)
        if max(found.values()) > atol:
            _fail(f"fresh attention non-causal {name} B=1 T={WHISPER_S_ENC} "
                  f"{heads}: {found} beyond {atol}")
        decode = 0.0
        for vlens in ([WHISPER_S_ENC] * 8, [1, 2, 3, 9, 17, 40, 64, 100]):
            q, k, v, k0, v0 = _contiguous_inputs(
                gen, dtype=dtype, s=WHISPER_S_ENC, vlens=vlens, **geom)
            vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
            got = fd.flash_decode(q, k, v, vl)
            again = fd.flash_decode(q, k, v, vl)
            want = fd.flash_decode_plain(q, k0, v0, vl)
            torch.cuda.synchronize()
            err = _scaled_err(got, want, absolute=True)
            if not torch.isfinite(got).all() or err > atol or \
                    not torch.equal(got, again):
                _fail(f"flash_decode {name} B=8 S={WHISPER_S_ENC} {heads} "
                      f"vlen {vlens}: row-scaled err {err:.3g} (atol "
                      f"{atol}), repeat equal {torch.equal(got, again)}")
            decode = max(decode, err)
        print(f"kernel whisper-small {name}: fresh attention non-causal "
              f"B=1 T={WHISPER_S_ENC} {heads}, K/V NaN past T: row-scaled "
              f"err forward {found['flash_attention']:.3g}, dq "
              f"{found['flash_attention_bwd_dq']:.3g}, dk/dv "
              f"{found['flash_attention_bwd_dkv']:.3g}; flash_decode B=8 "
              f"S={WHISPER_S_ENC} {heads} over all {WHISPER_S_ENC} keys "
              f"({_plan_of(fd, q, k)}) and ragged self lengths 1-100: "
              f"row-scaled err {decode:.3g}, a repeat bit-equal (atol "
              f"{atol})")
        if dtype == torch.bfloat16:
            errs["flash_attention_nc_t1536"] = found["flash_attention"]
            errs["flash_decode_s1536"] = decode
            # the encoder's training instances: the same kernels, causal 0,
            # at T 1536 (timed at the training batch, B 8)
            for name, err in found.items():
                errs[name + "_nc_b8_t1536"] = err
    return errs


# whisper-small's training (phase 6): the cross-attention's fresh forward
# and backward, the decoder's T queries over the encoder's 1536 keys
WHISPER_TRAIN_T = 256


def _check_whisper_train_shapes(gen) -> dict:
    """whisper-small's training shapes beyond ``_check_whisper_shapes``'s
    non-causal T 1536: rows 6 and 7 non-causal at Tq ≠ Tk, the
    cross-attention's ``WHISPER_TRAIN_T`` queries over 1536 keys, B 2,
    12/12 heads of 64, fp32 and bf16 (K/V NaN past 1536; forward, dq,
    dk/dv against their plain versions, ``_scaled_err`` within 1e-5 /
    2e-2), then
    ``FlashAttention``'s gradients at that shape against autograd through
    the plain forward.  Returns the bf16 errors, keys ``<kernel>_x1536``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    geom = dict(hkv=WHISPER_HEADS, g=1, d=64)
    t, tk = WHISPER_TRAIN_T, WHISPER_S_ENC
    what = (f"B=2 Tq={t} Tk={tk} Hq={WHISPER_HEADS} Hkv={WHISPER_HEADS} "
            "D=64 non-causal")
    errs = {}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        name = str(dtype)[6:]
        q, k, v, dout = _fresh_inputs(gen, dtype=dtype, b=2, t=t, tk=tk,
                                      **geom)
        found = _fresh_errs(q, k, v, dout, False)
        if max(found.values()) > atol:
            _fail(f"fresh attention {name} {what}: {found} beyond {atol}")
        k, v = torch.nan_to_num(k), torch.nan_to_num(v)
        grads = []
        for fn in (lambda a, b_, c: fa.FlashAttention.apply(a, b_, c, False),
                   lambda a, b_, c: fa.flash_attention_fwd_plain(
                       a, b_, c, causal=False)[0]):
            args = [x.detach().clone().requires_grad_(True)
                    for x in (q, k, v)]
            fn(*args).backward(dout)
            grads.append([a.grad for a in args])
        torch.cuda.synchronize()
        auto = max(_scaled_err(a, b_, by_row=False)
                   for a, b_ in zip(*grads))
        if auto > atol:
            _fail(f"FlashAttention {name} {what}: gradients differ from "
                  f"autograd through the plain forward by {auto:.3g}")
        print(f"kernel whisper-small training {name}: fresh attention "
              f"{what} (the cross-attention), K/V NaN past Tk: row-scaled "
              f"err forward {found['flash_attention']:.3g}, dq "
              f"{found['flash_attention_bwd_dq']:.3g}, dk/dv "
              f"{found['flash_attention_bwd_dkv']:.3g}; FlashAttention "
              f"gradients against autograd through the plain forward "
              f"{auto:.3g} (atol {atol})")
        if dtype == torch.bfloat16:
            errs = {f"{key}_x1536": err for key, err in found.items()}
    return errs


# llava-next-34b (VLM): its vocabulary, 56/8 heads of 128 (G 7) and the
# lockstep run's shapes (phase 4): B 2 prompts of 64 behind the 2880 patch
# embeddings, 16 new tokens, so a prefill of Tq 2944 into caches of 2960
LLAVA = ["--arch", "llava_next_34b"]
LLAVA_VOCAB, LLAVA_HKV, LLAVA_G = 64000, 8, 7
LLAVA_PATCHES = 2880
LLAVA_LOCKSTEP_ARGS = LLAVA + ["--batch", "2", "--prompt-len", "64",
                               "--tokens", "16"]
LLAVA_TQ, LLAVA_S = LLAVA_PATCHES + 64, LLAVA_PATCHES + 64 + 16
# its training sequence (phase 6): 256 text tokens behind the patches
LLAVA_TRAIN_T = LLAVA_PATCHES + 256


def _check_llava_shapes(gen) -> dict:
    """llava-next-34b's kernel shapes against their plain versions, fp32
    (atol 1e-5) and bf16 (2e-2): row 1 at [8, 64000] (``_check_softmax_
    topk``'s cases) and at the lockstep's [2, 64000], k 5; row 5 at the
    lockstep prefill, B 2, Tq 2944 at offset 0 over caches of 2960 whose
    last 16 positions are NaN, 56/8 heads of 128, the profiler naming each
    dtype's form; row 4 at the decode steps' first and last lengths (2945
    and 2960 of 2960, NaN past each), a repeat bit-equal, its split plan
    printed; rows 6 and 7 causal at the training sequence, B 1, T 3136,
    56/8 of 128 (K/V NaN past T).  Attention errors are ``_scaled_err``'s
    (bf16: each row's over its largest entry).  Returns the bf16 errors (row 1:
    fp32),
    keys ``softmax_topk_v64000``, ``flash_attention_offset_d128_g7_q2944``,
    ``flash_decode_d128_g7_s2960`` and ``<training kernel>_d128_g7_t3136``."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import softmax_topk as st
    errs = {f"softmax_topk_v{LLAVA_VOCAB}": _check_softmax_topk(
        gen, v=LLAVA_VOCAB)}
    x = (torch.randn(2, LLAVA_VOCAB, generator=gen) * 4.0).cuda()
    got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    torch.cuda.synchronize()
    if not torch.equal(got.indices.long(), want.indices) or not \
            torch.allclose(got.logsumexp, want.logsumexp, rtol=1e-5, atol=0):
        _fail(f"softmax_topk [2, {LLAVA_VOCAB}]: differs from its plain "
              "version")
    print(f"kernel softmax_topk [2, {LLAVA_VOCAB}] float32 k=5 (the "
          "lockstep's sampler): indices equal, lse within rtol 1e-5")
    geom = dict(hkv=LLAVA_HKV, g=LLAVA_G, d=128)
    heads = f"Hq={LLAVA_HKV * LLAVA_G} Hkv={LLAVA_HKV} D=128"
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        name = str(dtype)[6:]
        form, symbol = OFFSET_FORMS[name]
        vlens = [LLAVA_TQ] * 2
        inputs = _contiguous_inputs(gen, dtype=dtype, s=LLAVA_S, vlens=vlens,
                                    tq=LLAVA_TQ, **geom)
        qo = torch.zeros(2, dtype=torch.int32, device="cuda")
        vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
        what = f"{name} B=2 Tq={LLAVA_TQ} Tk={LLAVA_S} {heads}"
        (prefill, _), prof = _profiled(
            lambda: _offset_err(inputs, qo, vl, what, atol))
        if _kernels_seen(prof) != [symbol]:
            _fail(f"flash_attention_offset {what}: the profiler saw "
                  f"{_kernels_seen(prof)}, the {form} form is {symbol}")
        del inputs
        decode = 0.0
        for vlens in ([LLAVA_TQ + 1] * 2, [LLAVA_S] * 2):
            q, k, v, k0, v0 = _contiguous_inputs(gen, dtype=dtype, s=LLAVA_S,
                                                 vlens=vlens, **geom)
            vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
            got = fd.flash_decode(q, k, v, vl)
            again = fd.flash_decode(q, k, v, vl)
            want = fd.flash_decode_plain(q, k0, v0, vl)
            torch.cuda.synchronize()
            err = _scaled_err(got, want, absolute=True)
            if not torch.isfinite(got).all() or err > atol or \
                    not torch.equal(got, again):
                _fail(f"flash_decode {name} B=2 S={LLAVA_S} {heads} vlen "
                      f"{vlens}: row-scaled err {err:.3g} (atol {atol}), "
                      f"repeat equal {torch.equal(got, again)}")
            decode = max(decode, err)
        found = _fresh_errs(*_fresh_inputs(gen, dtype=dtype, b=1,
                                           t=LLAVA_TRAIN_T, **geom), True)
        if max(found.values()) > atol:
            _fail(f"fresh attention causal {name} B=1 T={LLAVA_TRAIN_T} "
                  f"{heads}: {found} beyond {atol}")
        print(f"kernel llava-next-34b {name} {heads} (G {LLAVA_G}): "
              f"flash_attention_offset ({form}, {symbol}) B=2 "
              f"Tq={LLAVA_TQ} at offset 0 over Tk={LLAVA_S}, NaN past "
              f"{LLAVA_TQ}: row-scaled err {prefill:.3g}; flash_decode B=2 "
              f"S={LLAVA_S} at vlen {LLAVA_TQ + 1} and {LLAVA_S} "
              f"({_plan_of(fd, q, k)}): row-scaled err {decode:.3g}, a "
              f"repeat "
              f"bit-equal; fresh attention causal B=1 T={LLAVA_TRAIN_T}, "
              f"K/V NaN past T: row-scaled err forward "
              f"{found['flash_attention']:.3g}, dq "
              f"{found['flash_attention_bwd_dq']:.3g}, dk/dv "
              f"{found['flash_attention_bwd_dkv']:.3g} (atol {atol})")
        if dtype == torch.bfloat16:
            errs[f"flash_attention_offset_d128_g7_q{LLAVA_TQ}"] = prefill
            errs[f"flash_decode_d128_g7_s{LLAVA_S}"] = decode
            errs.update({f"{key}_d128_g7_t{LLAVA_TRAIN_T}": err
                         for key, err in found.items()})
    return errs


# ---------------------------------------------------------------------------
# 4: serve smollm-360m at full width and SMOLLM_LAYERS layers through Engine
# (the main path)
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
    decode step and per finished prefill (the sampler), and for an MoE
    model one softmax_topk_router a layer for every decode step and
    prefill chunk (the router's launches of the same kernel); the other
    path's kernels none.  With int8 K/V the decode kernels are the int8
    forms, and every prefill (over the prompt's exact K/V) is the
    contiguous prefill kernel.  An MLA model's decode and prefill kernels
    are the latent attention's, whatever its int8 flag (fp latents).  A
    fixed-state model's attention layers (zamba2's shared-block calls,
    ``n_layers`` of them; none for xLSTM) read contiguous caches, paged or
    not: its pool gathers state rows into a slot batch."""
    ones = sched.chunk_widths.get(1, 0)
    dec, pre = (("flash_decode_paged", "flash_attention_paged")
                if sched.paged and sched.family.kind == "token"
                else ("flash_decode", "flash_attention_offset"))
    if sched.cfg.mla is not None:
        dec, pre = "flash_decode_mla", "flash_attention_mla"
    elif sched.family.quantized:
        dec, pre = f"{dec}_int8", "flash_attention_offset"
    want = dict.fromkeys(COUNTERS, 0)
    want[dec] = (sched.decode_steps + ones) * n_layers
    want[pre] = (sched.prefill_chunks - ones) * n_layers
    want["softmax_topk"] = sched.decode_steps + sched.prefills_done
    want["softmax_topk_router"] = _router_launches(sched, n_layers)
    return want


def _attn_layers(cfg) -> int:
    """A model's attention layers: every layer of a dense, MoE or MLA stack,
    zamba2's shared-block calls, none of xLSTM's."""
    from repro_torch.models import transformer
    return transformer.layer_counts(cfg).get("attn", 0)


def _router_launches(sched, n_layers: int) -> int:
    """The MoE router's softmax_topk launches in a continuous run: one a
    layer for every forward (decode step or prefill chunk); 0 for a dense
    model."""
    if sched.cfg.moe is None:
        return 0
    return n_layers * (sched.decode_steps + sched.prefill_chunks)


def _check_counts(what: str, counts: dict, want: dict, path=None) -> None:
    """Fail unless the launches equal the counters' and every kernel of
    the path (``path``, else the kernels ported for ``what``, and the
    sampler) launched."""
    if path is None:
        path = [k for k, p in KERNEL_PATH.items() if p == what]
    path = list(path) + ["softmax_topk"]
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
    """The three serving paths at full width and ``SMOLLM_LAYERS`` layers
    in bf16, then the same with int8 K/V, each between a reset and a read
    of the launch counts.
    Returns ({path: counts}, what the step timings reuse)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = _smollm_config(serve.parse_args(SERVE_ARGS))
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} {cfg.dtype}, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}; weights from "
          f"seed 0 in {time.perf_counter() - t0:.1f}s")
    counts, engines = {}, {}
    for what, argv in SERVE_PATHS:
        counts[what], engines[what] = _serve_path(what, argv, cfg, params,
                                                  what)
    _check_pool_bytes(cfg, engines)
    _serve_slo(params, cfg, counts)

    for what, argv in (("lockstep", LOCKSTEP_ARGS),
                       ("lockstep int8", LOCKSTEP_ARGS + INT8)):
        counts[what] = _serve_lockstep(what, argv, cfg, params)
    return counts, {"params": params, "cfg": cfg, "engines": engines}


def _serve_lockstep(what: str, argv, cfg, params) -> dict:
    """The lockstep loop of ``argv`` with ``cfg``'s weights between a reset
    and a read of the launch counts: token ids in the vocabulary, and one
    prefill launch and (tokens - 1) decode launches a layer, one sample a
    token.  Returns the launch counts."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    dispatch.reset_launch_counts()
    ids = serve.lockstep(args, cfg.replace(kv_cache_dtype=args.kv_cache_dtype),
                         params)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    if ids.shape != (args.batch, args.tokens) or not (
            (ids >= 0) & (ids < cfg.vocab_size)).all():
        _fail(f"serve {what}: token ids of shape {ids.shape} outside "
              "the vocabulary or short")
    dec = "flash_decode_int8" if args.kv_cache_dtype else "flash_decode"
    pre = "flash_attention_offset"
    if cfg.mla is not None:
        dec, pre = "flash_decode_mla", "flash_attention_mla"
    # an MoE model routes once a layer in the prefill and in each decode
    # step: tokens forwards in all
    router = args.tokens * cfg.num_layers if cfg.moe is not None else 0
    n_attn = _attn_layers(cfg)
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"softmax_topk": args.tokens, "softmax_topk_router": router,
                 dec: (args.tokens - 1) * n_attn, pre: n_attn})
    if counts != want:
        _fail(f"serve {what}: launches {counts}, its steps imply {want}")
    print(f"serve {what} launches: {counts} = one prefill, "
          f"{args.tokens - 1} decode steps and {args.tokens} samples "
          f"over {n_attn} attention layers"
          + (f", {router} router launches" if router else ""))
    return counts


# ---------------------------------------------------------------------------
# 4b: the head_dim-128 dense decoders at full width
# ---------------------------------------------------------------------------
MISTRAL = ["--arch", "mistral_nemo_12b"]
DEEPSEEK = ["--arch", "deepseek_coder_33b"]
# mistral-nemo-12b's serving runs (phase 4b) at full width and this many of
# its 40 layers: its five runs at all 40 took ~52 s
# of the script, which the MLA decoder's serving runs needed (40 → 16), and
# at 16 ~36 s, which minicpm3-4b's training runs needed (16 → 8), and at
# 8 the recurrent decoders' training and whisper-small's serving needed
# (8 → 4; parity keeps its depth of 2), and at 4 whisper-small's and
# llava-next-34b's training and llava's serving (4 → 2)
MISTRAL_LAYERS = 2
# deepseek-coder-33b at full width and cut depth: 2 of its 62 layers (8
# until the recurrent decoders' training took the script's time, 4 until
# llava-next-34b's, whose lockstep run exercises the same D-128 G-7
# serving instances; all 62 would be 66.7 GB, beside the pools and the 0.9
# GB fp32 head copy of every sample on an 80 GB card)
DEEPSEEK_LAYERS = 2
# phase 4's continuous-batching workloads, which every model serves:
# (path, flags); the path names the kernels (KERNEL_PATH) that must launch
SERVE_PATHS = (("paged", SERVE_ARGS), ("slot pool", SLOT_ARGS),
               ("paged int8", SERVE_ARGS + INT8),
               ("slot pool int8", SLOT_ARGS + INT8))
# the head_dim-128 instances and the sampler at those models' vocabularies,
# as the JSON line lists them: name → (the kernel whose source, counter and
# TPU site they share, the run whose launches they report)
INSTANCES = {
    "softmax_topk_v131072": ("softmax_topk", "mistral paged"),
    "softmax_topk_v32256": ("softmax_topk", "deepseek paged"),
    "flash_decode_paged_d128": ("flash_decode_paged", "mistral paged"),
    "flash_attention_paged_d128": ("flash_attention_paged", "mistral paged"),
    "flash_decode_d128": ("flash_decode", "mistral slot pool"),
    "flash_attention_offset_d128": ("flash_attention_offset",
                                    "mistral slot pool"),
    "flash_decode_paged_int8_d128": ("flash_decode_paged_int8",
                                     "mistral paged int8"),
    "flash_decode_int8_d128": ("flash_decode_int8", "mistral slot pool int8"),
    "flash_attention_paged_int8_d128": ("flash_attention_paged_int8",
                                        "kernel check only"),
    # the MoE decoders: the router's launches of softmax_topk are counted
    # under a key of their own (a third item: the count's key in that run)
    "softmax_topk_router_e60": ("softmax_topk", "qwen2 paged",
                                "softmax_topk_router"),
    "softmax_topk_router_e16": ("softmax_topk", "llama4 paged",
                                "softmax_topk_router"),
    "softmax_topk_v151936": ("softmax_topk", "qwen2 paged"),
    "softmax_topk_v73728": ("softmax_topk", "minicpm3 slot pool"),
    "softmax_topk_v202048": ("softmax_topk", "llama4 paged"),
    "flash_decode_paged_d128_g1": ("flash_decode_paged", "qwen2 paged"),
    "flash_attention_paged_d128_g1": ("flash_attention_paged",
                                      "qwen2 paged"),
    "flash_decode_d128_g1": ("flash_decode", "qwen2 slot pool"),
    "flash_attention_offset_d128_g1": ("flash_attention_offset",
                                       "qwen2 slot pool"),
    "flash_decode_paged_int8_d128_g1": ("flash_decode_paged_int8",
                                        "qwen2 paged int8"),
    "flash_decode_int8_d128_g1": ("flash_decode_int8", "kernel check only"),
    "flash_attention_paged_int8_d128_g1": ("flash_attention_paged_int8",
                                           "kernel check only"),
    "flash_decode_paged_d128_g5": ("flash_decode_paged", "llama4 paged"),
    "flash_attention_paged_d128_g5": ("flash_attention_paged",
                                      "llama4 paged"),
    # llama4-scout serves the paged workload only: these are checked and
    # timed at its heads, and launch on no path of this script
    "flash_decode_d128_g5": ("flash_decode", "kernel check only"),
    "flash_attention_offset_d128_g5": ("flash_attention_offset",
                                       "kernel check only"),
    "flash_decode_paged_int8_d128_g5": ("flash_decode_paged_int8",
                                        "kernel check only"),
    "flash_decode_int8_d128_g5": ("flash_decode_int8", "kernel check only"),
    "flash_attention_paged_int8_d128_g5": ("flash_attention_paged_int8",
                                           "kernel check only"),
    # the training kernels' D-128 instances of mistral-nemo-12b's and
    # qwen2-moe-a2.7b's training runs (phase 3 also checks them at
    # deepseek-coder-33b's and llama4-scout's heads)
    **{kernel + tag: (kernel, path)
       for tag, path in (("_d128", "mistral train"), ("_d128_g1",
                                                      "qwen2 train"))
       for kernel in ("flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")},
    # their (96, 64) instances: minicpm3-4b's decompressed MLA (rows 6m, 7m)
    **{kernel + "_d96": (kernel, "minicpm3 train")
       for kernel in ("flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")},
    # the recurrent decoders: the sampler at zamba2's and xlstm's
    # vocabularies, and rows 4 and 5 at zamba2's shared block (D 64, G 1)
    "softmax_topk_v32000": ("softmax_topk", "zamba2 slot pool"),
    "softmax_topk_v50304": ("softmax_topk", "xlstm slot pool"),
    "flash_decode_g1": ("flash_decode", "zamba2 slot pool"),
    "flash_attention_offset_g1": ("flash_attention_offset",
                                  "zamba2 slot pool"),
    # zamba2-1.2b's training: rows 6 and 7 at its shared block's 32/32
    # heads of 64 (G 1), at its training shape
    **{kernel + "_g1": (kernel, "zamba2 train")
       for kernel in ("flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")},
    # whisper-small: row 6 non-causal over its encoder's window, row 4 over
    # its cross-attention's 1536 keys (its self-attention's decode too),
    # row 1 at its padded vocabulary
    "flash_attention_nc_t1536": ("flash_attention", "whisper paged"),
    "flash_decode_s1536": ("flash_decode", "whisper paged"),
    "softmax_topk_v51968": ("softmax_topk", "whisper paged"),
    # whisper-small's training: rows 6 and 7 non-causal over its encoder's
    # 1536 frames and at its cross-attention's 256 queries over them (the
    # run's launches of each kernel: encoder, decoder and cross-attention)
    **{kernel + tag: (kernel, "whisper train")
       for tag in ("_nc_b8_t1536", "_x1536")
       for kernel in ("flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")},
    # llava-next-34b: the sampler at its vocabulary and rows 4 and 5 at its
    # lockstep run's shapes (56/8 heads of 128, G 7), rows 6 and 7 at its
    # training sequence of 2880 patches and 256 tokens
    # rows 4 and 4q with their lse: the sequence-sharded decode's local
    # step, on the lockstep path under the (1, 1) mesh's context
    "flash_decode_lse": ("flash_decode", "distributed lockstep",
                         "flash_decode_lse"),
    "flash_decode_int8_lse": ("flash_decode_int8",
                              "distributed lockstep int8",
                              "flash_decode_int8_lse"),
    f"softmax_topk_v{LLAVA_VOCAB}": ("softmax_topk", "llava lockstep"),
    f"flash_decode_d128_g7_s{LLAVA_S}": ("flash_decode", "llava lockstep"),
    f"flash_attention_offset_d128_g7_q{LLAVA_TQ}": ("flash_attention_offset",
                                                   "llava lockstep"),
    **{f"{kernel}_d128_g7_t{LLAVA_TRAIN_T}": (kernel, "llava train")
       for kernel in ("flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")},
    # rows 6 and 7 at a causal q offset: sequence mode's last rank (Tq 128
    # at offset 384 over 512 keys, smollm's 15/5 heads); the launches are
    # the offset forms' in phase_model_axis's run of the 4 ranks' blocks
    **{kernel + "_qoff384": (kernel, "model axis seq", kernel + "_qoffset")
       for kernel in ("flash_attention", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv")},
}
# the training kernels' timed D-128 instances: tag → (Hkv, G)
TRAIN_TIMED_128 = {"_d128": (8, 4), "_d128_g1": (16, 1)}


def _weight_bytes(params) -> int:
    """Bytes of every tensor of a parameter tree."""
    if isinstance(params, dict):
        return sum(_weight_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(_weight_bytes(v) for v in params)
    return params.numel() * params.element_size()


def _card_weights(cfg):
    """``cfg``'s weights drawn on the card from seed 0 (a full-width CPU
    draw takes a minute or more): (params, their bytes)."""
    import torch
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device="cuda", draw_device="cuda")
    torch.cuda.synchronize()
    nbytes = _weight_bytes(params)
    mc, m = cfg.moe, cfg.mla
    ffn = (f"d_ff {cfg.d_ff}" if mc is None else
           f"{mc.num_experts} experts (padded to "
           f"{mc.pad_experts_to or mc.num_experts}) top {mc.experts_per_token}"
           f" of d_ff {mc.d_ff_expert} + a shared expert of "
           f"{mc.d_ff_shared}, capacity factor {mc.capacity_factor}")
    heads = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
             f"{cfg.resolved_head_dim}" if m is None else
             f"{cfg.num_heads} latent-attention heads (q_lora "
             f"{m.q_lora_rank}, kv_lora {m.kv_lora_rank}, qk_nope "
             f"{m.qk_nope_head_dim}, qk_rope {m.qk_rope_head_dim}, v_head "
             f"{m.v_head_dim})")
    print(f"serve: {cfg.name} {cfg.dtype}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {heads}, {ffn}, vocab {cfg.vocab_size}"
          f"{f' ({cfg.real_vocab_size} real)' if cfg.real_vocab_size else ''}"
          f", untied head; {nbytes / 1e9:.3f} GB of weights drawn on the "
          f"card from seed 0 in {time.perf_counter() - t0:.1f}s")
    return params, nbytes


def _serve_path(what: str, argv, cfg, params, path: str):
    """Serve ``argv`` with ``cfg``'s weights between a reset and a read of
    the launch counts: every request finishes in the vocabulary, the
    launches equal the scheduler's counters and every kernel of ``path``
    launched; an int8 run prefills in one chunk and shares nothing.  Prints
    the peak of device memory.  Returns (launch counts, the engine)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    run_cfg = cfg.replace(kv_cache_dtype=args.kv_cache_dtype)
    print(f"serve {what}: {cfg.name}, {cfg.num_layers} layers")
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    report, router, requests, _ = serve.run(args, run_cfg, params)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    eng = router.engines[0]
    sched = eng.scheduler
    _check_finished(what, report, requests, cfg.vocab_size)
    _check_counts(what, counts, _implied_counts(sched, _attn_layers(cfg)),
                  path=[k for k, p in KERNEL_PATH.items() if p == path])
    if sched.family.quantized:
        _check_int8_run(what, report, sched, requests)
    print(f"serve {what} launches: {counts} = scheduler counters (decode "
          f"steps {sched.decode_steps}, prefill chunks {sched.prefill_chunks} "
          f"of which {sched.chunk_widths.get(1, 0)} one-token, prefills "
          f"{sched.prefills_done}, {_attn_layers(cfg)} attention layers); "
          f"{report.tokens_per_s:.1f} tok/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, eng


def _check_pool_bytes(cfg, engines) -> None:
    """The paged pools' bytes per cached token equal the config's: 2 (K,
    V) × layers × KV heads × head_dim × the element size, plus a bf16
    scale per (position, KV head) for int8."""
    for path in ("paged", "paged int8"):
        pool = engines[path].scheduler.pool
        got = _pool_bytes_per_token(pool)
        want = _block_bytes(pool.cfg, pool.block_size) / pool.block_size
        if got != want:
            _fail(f"serve {cfg.name} {path}: {got} pool bytes per cached "
                  f"token, the config gives {want}")
    fp, q8 = (_pool_bytes_per_token(engines[p].scheduler.pool)
              for p in ("paged", "paged int8"))
    print(f"serve {cfg.name} pool bytes per cached token: {cfg.dtype} K/V "
          f"{fp:.0f}, int8 K/V + bf16 scales {q8:.0f} ({fp / q8:.3f}x the "
          "tokens in the same bytes)")


def _steps_128(params, cfg, engines, weight_bytes: int,
               only: tuple = ()) -> None:
    """Phase 8's "step" lines for a head_dim-128 model
    (``_serving_steps``; with ``only``, those whose names start so), each
    beside the weights' byte bound (every weight read once at 3.35 TB/s),
    and the paged decode step's kernels by device time."""
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    for name, fn in _serving_steps(params, cfg, engines).items():
        if only and not name.startswith(only):
            continue
        line, busy, by = _step_line(f"{cfg.name} {name}", fn)
        print(f"{line}; the weights' byte bound {bound:.3f}ms "
              f"({weight_bytes / 1e9:.3f} GB at 3.35 TB/s), device busy "
              f"{busy / bound:.2f}x it")
        if name.startswith("paged decode"):
            rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
            print(f"step {cfg.name} {name} by kernel (device ms a step x "
                  f"launches a step): " + "; ".join(
                      f"{k} {ms:.4f} x {n:g}" for k, (ms, n) in rows))


def phase_serve_128() -> dict:
    """mistral-nemo-12b at full width and ``MISTRAL_LAYERS`` layers (bf16)
    through phase 4's paged, slot-pool and lockstep workloads and their
    int8 paged and slot-pool forms, each between a reset and a read of the
    launch counts, then its "step" lines; deepseek-coder-33b at full width
    and ``DEEPSEEK_LAYERS`` layers through the paged and slot-pool
    workloads.  Every attention op runs a head_dim-128 instance.  Returns
    {run: counts}."""
    import torch
    from repro_torch import configs
    counts = {}
    cfg = configs.get("mistral_nemo_12b").replace(num_layers=MISTRAL_LAYERS)
    params, nbytes = _card_weights(cfg)
    engines = {}
    for path, argv in SERVE_PATHS:
        what = f"mistral {path}"
        counts[what], engines[path] = _serve_path(what, MISTRAL + argv, cfg,
                                                  params, path)
    _check_pool_bytes(cfg, engines)
    counts["mistral lockstep"] = _serve_lockstep(
        "mistral lockstep", MISTRAL + LOCKSTEP_ARGS, cfg, params)
    _steps_128(params, cfg, engines, nbytes)
    del params, engines
    torch.cuda.empty_cache()

    cfg = configs.get("deepseek_coder_33b").replace(
        num_layers=DEEPSEEK_LAYERS)
    params, _ = _card_weights(cfg)
    for path, argv in SERVE_PATHS[:2]:
        what = f"deepseek {path}"
        counts[what], _ = _serve_path(what, DEEPSEEK + argv, cfg, params,
                                      path)
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 4c: the MoE decoders at full width
# ---------------------------------------------------------------------------
QWEN2 = ["--arch", "qwen2_moe_a2p7b"]
LLAMA4 = ["--arch", "llama4_scout_17b_a16e"]
# llama4-scout-17b-a16e at full width and cut depth: 2 of its 48 layers,
# ~13.0 GB of bf16 weights (2.21e9 parameters a layer, 2.07e9 in its
# embedding and head); all 48 would be ~216 GB.  4 layers served in time
# on a fast host, but the script outran its time on slower ones, and this
# depth is the first cut
LLAMA4_LAYERS = 2
# qwen2-moe-a2.7b's serving runs (phase 4c) at full width and this many of
# its 24 layers: its four runs at all 24 took ~35 s of the
# script, which the MLA decoder's serving runs needed (24 → 8), and at 8
# ~20 s, of which minicpm3-4b's training runs needed some (8 → 6), then
# the recurrent decoders' training (6 → 4), then whisper-small's and
# llava-next-34b's training and llava's serving (4 → 2)
QWEN2_LAYERS = 2
# qwen2-moe-a2.7b's continuous-batching runs: phase 4's workloads but the
# int8 slot pool, the second cut for the script's time (its kernel
# instance, flash_decode_int8 at G 1, is checked and timed in phases 3
# and 8, and launches on mistral-nemo's int8 slot-pool run at G 4)
MOE_SERVE_PATHS = SERVE_PATHS[:3]


def _profile_moe_step(params, cfg, engines) -> None:
    """``obs.kernels.profile_step`` on a paged decode step of the MoE model
    (B 8 over the phase's idle pool, lengths 65..328): its analytic cost
    (``decode_step_cost``: the one-hot form reads every padded expert) and
    its kernels from ``torch.profiler``; the router and the sampler share
    ``softmax_topk_kernel``, one launch a layer and one, and the split
    decode runs once a layer."""
    import torch
    from repro_torch.obs import kernels as obs_kernels
    from repro_torch.serving import engine
    pool = engines["paged"].scheduler.pool
    n, m = pool.num_slots, pool.max_blocks
    tables = torch.arange(1, n * m + 1, dtype=torch.int32,
                          device="cuda").reshape(n, m)
    lens = [328, 289, 250, 211, 172, 133, 94, 65][:n]
    label = f"{cfg.name} decode_step_paged"
    cost = obs_kernels.decode_step_cost(cfg, n, [x + 1 for x in lens])
    obs_kernels.profile_step(
        engine.decode_step_paged, label, params, pool.caches, tables,
        torch.tensor(lens, device="cuda"),
        torch.ones((n, 1), dtype=torch.int64, device="cuda"), cfg,
        cost=cost, device=torch.device("cuda"),
        noise=torch.zeros((n, 5), device="cuda"), top_k=5)
    obs_kernels.run_pending()
    rec = obs_kernels.snapshot()["costs"][label]
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    want = {"softmax_topk_kernel": cfg.num_layers + 1,
            "decode_paged_split_kernel": cfg.num_layers}
    if any(calls.get(k) != v for k, v in want.items()):
        _fail(f"profile {label}: kernel calls {calls}, want {want}")
    top = sorted(rec["kernels"].items(), key=lambda kv: -kv[1]["ms"])[:6]
    print(f"profile {label} [B={n}]: device {rec['device_ms']:.3f}ms over "
          f"{sum(calls.values())} launches, bound {rec['bound_ms']:.3f}ms "
          f"({rec['bytes_accessed'] / 1e9:.3f} GB, "
          f"{rec['flops'] / 1e9:.1f} GFLOP: decode_step_cost), "
          f"softmax_topk_kernel x {calls['softmax_topk_kernel']} (router a "
          "layer + sampler); top kernels: " + "; ".join(
              f"{k} {v['ms']:.4f}ms x {v['calls']}" for k, v in top))


def phase_serve_moe() -> dict:
    """qwen2-moe-a2.7b at full width and ``QWEN2_LAYERS`` layers (bf16, 60
    experts padded to 64, top 4) through phase 4's paged, slot-pool and lockstep
    workloads and the int8 paged one (``MOE_SERVE_PATHS``), each between a
    reset and a read of the launch counts (the router's, one a layer and
    forward, under ``softmax_topk_router``), then its paged "step" lines
    and its profiled decode step; then llama4-scout-17b-a16e at full width
    and ``LLAMA4_LAYERS`` layers (16 experts, top 1) through the paged
    workload.  Every attention op runs a head_dim-128 instance, at G 1 and
    G 5.  Returns {run: counts}."""
    import torch
    from repro_torch import configs
    counts = {}
    cfg = configs.get("qwen2_moe_a2p7b").replace(num_layers=QWEN2_LAYERS)
    params, nbytes = _card_weights(cfg)
    engines = {}
    for path, argv in MOE_SERVE_PATHS:
        what = f"qwen2 {path}"
        counts[what], engines[path] = _serve_path(what, QWEN2 + argv, cfg,
                                                  params, path)
    _check_pool_bytes(cfg, engines)
    counts["qwen2 lockstep"] = _serve_lockstep(
        "qwen2 lockstep", QWEN2 + LOCKSTEP_ARGS, cfg, params)
    # the paged steps only (the script's time): the slot-pool and int8
    # steps differ from them in attention alone, which mistral's lines show
    _steps_128(params, cfg, engines, nbytes,
               only=("paged decode", "paged prefill"))
    _profile_moe_step(params, cfg, engines)
    del params, engines
    torch.cuda.empty_cache()

    cfg = configs.get("llama4_scout_17b_a16e").replace(
        num_layers=LLAMA4_LAYERS)
    params, _ = _card_weights(cfg)
    counts["llama4 paged"], _ = _serve_path(
        "llama4 paged", LLAMA4 + SERVE_ARGS, cfg, params, "paged")
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 4d: the MLA decoder at full width
# ---------------------------------------------------------------------------
MINICPM = ["--arch", "minicpm3_4b"]
# minicpm3-4b's continuous-batching runs (its latent cache has no paged
# form): phase 4's slot-pool workload, fp and int8 (fp latents, each prompt
# in one chunk); both launch the two latent attention kernels
MINICPM_PATHS = (("minicpm3 slot pool", SLOT_ARGS),
                 ("minicpm3 slot pool int8", SLOT_ARGS + INT8))
# the int8 slot-pool and lockstep runs take the first this many of the 62
# layers, for the script's time (8 until the recurrent decoders' training,
# 4 until whisper-small's and llava-next-34b's training)
MINICPM_CUT_LAYERS = 2
# and the bf16 slot-pool run this many: all 62 took ~30 s of the script,
# which the recurrent decoders' phases needed (62 -> 16, then 16 -> 8 for
# their training, then 8 -> 4 for whisper's and llava's; the step lines
# keep all 62)
MINICPM_SERVE_LAYERS = 4


def _check_latent_bytes(cfg, engines) -> None:
    """Each slot pool's bytes per cached token equal the latent row's: R +
    Dr elements of the model dtype a layer (62 x 288 x 2 = 35712 for
    minicpm3-4b), the int8 run's too (fp latents)."""
    m = cfg.mla
    want = cfg.num_layers * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    for what, eng in engines.items():
        pool = eng.scheduler.pool
        got = sum(x.numel() * x.element_size() for x in pool.caches.values()
                  ) / (pool.num_slots * pool.slot_len) * (
            cfg.num_layers / pool.cfg.num_layers)
        if got != want:
            _fail(f"serve {what}: {got} pool bytes per cached token, the "
                  f"latent row gives {want}")
    print(f"serve {cfg.name} pool bytes per cached token: {want} = "
          f"{cfg.num_layers} layers x ({m.kv_lora_rank} + "
          f"{m.qk_rope_head_dim}) x 2 (bf16 latents, under --kv-cache-dtype "
          "int8 too, per layer alike at its cut depth)")


def _steps_mla(params, cfg, engines, weight_bytes: int) -> None:
    """minicpm3-4b's "step" lines at all of ``cfg``'s layers, on latent
    caches of its slot pool's geometry: a decode step over the 8 slots at
    lengths 65-328 and a 64-token prefill chunk at offset 64, each beside
    the weights' byte bound, each step's latent attention in the bf16
    form's tensor-core kernel (never the fp32 form's); the decode step's
    kernels by device time, and its ``decode_step_cost`` bound."""
    import torch
    from repro_torch.obs import kernels as obs_kernels
    from repro_torch.serving import engine
    slots = engines["minicpm3 slot pool"].scheduler.pool
    n = slots.num_slots
    lens = torch.tensor(MLA_DECODE_VLENS[:n], device="cuda").clamp(
        max=slots.slot_len - 1)
    toks = torch.ones((n, 1), dtype=torch.int64, device="cuda")
    noise = torch.zeros((n, 5), device="cuda")
    chunk = torch.ones((1, 64), dtype=torch.int64, device="cuda")
    caches = engine.init_cache(cfg, n, slots.slot_len, "cuda")
    scratch = engine.init_cache(cfg, 1, slots.slot_len, "cuda")
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    cost = obs_kernels.decode_step_cost(cfg, n, (lens + 1).tolist())
    steps = {
        f"slot-pool decode [B={n}, {cfg.num_layers} layers, bf16]":
            lambda: engine.decode_step_slots(params, caches, lens, toks, cfg,
                                             noise=noise, top_k=5),
        "slot-pool prefill chunk [64 tokens at offset 64, bf16]":
            lambda: engine.prefill_chunk(params, scratch, 64, chunk, cfg)}
    for name, fn in steps.items():
        line, busy, by = _step_line(f"{cfg.name} {name}", fn)
        dec_sym, pre_sym = MLA_FORMS["bfloat16"]
        sym, fp32_sym = ((dec_sym, "mla_split_kernel") if "decode" in name
                         else (pre_sym, "mla_prefill_kernel"))
        if not any(sym in k for k in by) or any(fp32_sym in k for k in by):
            _fail(f"step {cfg.name} {name}: the profiler saw "
                  f"{sorted(by)}, not {sym} (and no {fp32_sym})")
        print(f"{line}; the weights' byte bound {bound:.3f}ms "
              f"({weight_bytes / 1e9:.3f} GB at 3.35 TB/s), device busy "
              f"{busy / bound:.2f}x it")
        if "decode" in name:
            c_ms = 1e3 * max(cost["bytes_accessed"] / HBM_BYTES_PER_S,
                             cost["flops"] / PEAK_OPS["bfloat16"])
            rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
            print(f"step {cfg.name} {name}: decode_step_cost bound "
                  f"{c_ms:.3f}ms ({cost['bytes_accessed'] / 1e9:.3f} GB, "
                  f"{cost['flops'] / 1e9:.1f} GFLOP); by kernel (device ms a "
                  "step x launches a step): " + "; ".join(
                      f"{k} {ms:.4f} x {k_n:g}" for k, (ms, k_n) in rows))


def phase_serve_mla() -> dict:
    """minicpm3-4b at full width (62 layers drawn on the card, bf16)
    through phase 4's slot-pool workload at its first
    ``MINICPM_SERVE_LAYERS`` layers, then at its first
    ``MINICPM_CUT_LAYERS`` layers the slot pool's int8 form (fp latents,
    single-shot prefill) and the lockstep workload, each between a reset
    and a read of the launch counts: one latent attention launch a
    layer and forward (``flash_decode_mla`` for every decode step and
    one-token chunk, ``flash_attention_mla`` for every wider chunk), equal
    to the scheduler's counters; then the latent pools' bytes per token and
    the "step" lines at all 62 layers.  Returns {run: counts}."""
    import torch
    from repro_torch import configs
    cfg = configs.get("minicpm3_4b")
    params, nbytes = _card_weights(cfg)

    def first(n):
        return (cfg.replace(num_layers=n),
                {**params, "layers": params["layers"][:n]})
    cut_cfg, cut = first(MINICPM_CUT_LAYERS)
    counts, engines = {}, {}
    for (what, argv), (c, p) in zip(MINICPM_PATHS,
                                    (first(MINICPM_SERVE_LAYERS),
                                     (cut_cfg, cut))):
        counts[what], engines[what] = _serve_path(
            what, MINICPM + argv, c, p, "minicpm3 slot pool")
        sched = engines[what].scheduler
        ones = sched.chunk_widths.get(1, 0)
        print(f"serve {what}: {c.num_layers} latent attention launches a "
              f"forward: flash_decode_mla {counts[what]['flash_decode_mla']} "
              f"= {c.num_layers} x ({sched.decode_steps} decode steps + "
              f"{ones} one-token chunks), flash_attention_mla "
              f"{counts[what]['flash_attention_mla']} = {c.num_layers} x "
              f"{sched.prefill_chunks - ones} wider chunks")
    _check_latent_bytes(cfg, engines)
    counts["minicpm3 lockstep"] = _serve_lockstep(
        "minicpm3 lockstep", MINICPM + LOCKSTEP_ARGS, cut_cfg, cut)
    _steps_mla(params, cfg, engines, nbytes)
    del params, cut, engines
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# 4e: the recurrent decoders at full width and depth
# ---------------------------------------------------------------------------
# (label, the CLI's arch flags): zamba2-1.2b (38 Mamba2 layers, its shared
# attention block called 7 times) and xlstm-125m (10 mLSTM, 2 sLSTM layers)
STATE_MODELS = (("zamba2", "zamba2_1p2b"), ("xlstm", "xlstm_125m"))
# their serving runs' depth at full width: zamba2 8 of its 38 layers
# (6 + 2 Mamba2 layers, 2 shared-block calls), xlstm 6 of its 12
# (layer 5 an sLSTM); both served at full depth until their training at
# full depth took the script's time
STATE_SERVE_LAYERS = {"zamba2_1p2b": 8, "xlstm_125m": 6}
# their continuous-batching runs: phase 4's paged workload (its pool one
# state row a sequence; the shared prefix is not shared) and slot-pool
# workload, the CLI snapping each prompt to the scan's quantum (zamba2 128,
# xlstm 256); then the lockstep workload
STATE_PATHS = (("paged", SERVE_ARGS), ("slot pool", SLOT_ARGS))
# the recurrent cores' PyTorch functions, whose kernels the step lines
# count apart
RECURRENT_CORES = ("ssd_chunked", "ssd_decode_step", "causal_conv",
                   "mlstm_chunked", "mlstm_decode_step", "slstm_scan")


def _state_weights(cfg):
    """A recurrent model's weights drawn on the card from seed 0: (params,
    their bytes)."""
    import torch
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device="cuda", draw_device="cuda")
    torch.cuda.synchronize()
    nbytes = _weight_bytes(params)
    what = _recurrent_what(cfg, transformer.layer_counts(cfg))
    print(f"serve: {cfg.name} {cfg.dtype}, d_model {cfg.d_model}, {what}, "
          f"vocab {cfg.vocab_size}, untied head; {nbytes / 1e9:.3f} GB of "
          f"weights ({_param_count(params) / 1e9:.3f}e9 parameters) drawn "
          f"on the card from seed 0 in {time.perf_counter() - t0:.1f}s")
    return params, nbytes


def _recurrent_what(cfg, counts: dict) -> str:
    """A recurrent model's layers in words."""
    if cfg.ssm is not None:
        sc = cfg.ssm
        return (f"{counts['mamba']} Mamba2 layers (d_state {sc.d_state}, "
                f"{sc.expand * cfg.d_model // sc.head_dim} heads of "
                f"{sc.head_dim}, chunk {sc.chunk}), a shared attention block "
                f"({cfg.num_heads}/{cfg.num_kv_heads} heads of "
                f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}) called "
                f"{counts['attn']} times")
    xc = cfg.xlstm
    return (f"{counts['mlstm']} mLSTM + {counts['slstm']} sLSTM layers "
            f"({xc.num_heads} heads, expand {xc.expand}, chunk {xc.chunk})")


def _param_count(params) -> int:
    if isinstance(params, dict):
        return sum(_param_count(v) for v in params.values())
    if isinstance(params, list):
        return sum(_param_count(v) for v in params)
    return params.numel()


def _check_state_pools(cfg, engines) -> dict:
    """The fixed-state pools against the config: a paged pool's block is
    one sequence's whole state row (table one column wide, nothing shared
    or copied, every block back), the slot pool's rows the same bytes; and
    zamba2's K/V bytes per token, 7 calls x K and V x 32 heads x 64 x 2 B
    = 57344 at full depth.  Returns {"state_bytes": a row's recurrent state,
    "kv_bytes_per_token": ...}."""
    from repro_torch.models import transformer
    paged = engines["paged"].scheduler
    pool = paged.pool
    if pool.max_blocks != 1:
        _fail(f"serve {cfg.name} paged: {pool.max_blocks} table columns, a "
              "state row is one block")
    st = pool.stats()
    if st["blocks_shared"] or st["cow_copies"] or \
            st["free_blocks"] != st["num_blocks"]:
        _fail(f"serve {cfg.name} paged: state blocks shared, copied or "
              f"kept: {st}")
    row = {k: x[:, 0].numel() * x.element_size()
           for k, x in pool.caches.items()}
    slots = engines["slot pool"].scheduler.pool
    slot_row = {k: x[:, 0].numel() * x.element_size()
                for k, x in slots.caches.items()}
    kv = row.get("k", 0) + row.get("v", 0)
    state = sum(row.values()) - kv
    if state != sum(slot_row.values()) - slot_row.get("k", 0) \
            - slot_row.get("v", 0):
        _fail(f"serve {cfg.name}: paged and slot rows hold other state "
              f"({row} vs {slot_row})")
    per_tok = kv / pool.slot_len
    want = 2 * transformer.layer_counts(cfg).get("attn", 0) \
        * cfg.num_kv_heads * cfg.resolved_head_dim \
        * transformer.DTYPES[cfg.dtype].itemsize
    if per_tok != want:
        _fail(f"serve {cfg.name}: {per_tok} K/V bytes per token, the "
              f"config gives {want}")
    print(f"serve {cfg.name} state: {state} bytes of recurrent state a "
          f"sequence ({state / 2**20:.2f} MiB: "
          + ", ".join(f"{k} {v}" for k, v in row.items()
                      if k not in ("k", "v"))
          + f"), K/V {per_tok:.0f} bytes per token; a paged block is the "
          f"whole row, {sum(row.values())} bytes at slot_len "
          f"{pool.slot_len}; blocks shared 0, copy-on-write 0, all "
          f"{st['num_blocks']} back")
    return {"state_bytes": state, "kv_bytes_per_token": per_tok}


def _state_steps(params, cfg, engines, weight_bytes: int) -> None:
    """A recurrent model's "step" lines: a slot-pool decode step over its
    8 slots (lengths 65-328) and a single-shot prefill of 256 tokens, host
    call to device finish against device busy; the decode step's kernels
    by device time, with the recurrent cores' kernels (``RECURRENT_CORES``
    alone at the step's shapes) apart; the weights' byte bound and
    ``decode_step_cost``'s bound (weights, the state read and written,
    zamba2's K/V)."""
    import torch
    from repro_torch.obs import kernels as obs_kernels
    from repro_torch.serving import engine
    slots = engines["slot pool"].scheduler.pool
    n = slots.num_slots
    lens = torch.tensor(MLA_DECODE_VLENS[:n], device="cuda").clamp(
        max=slots.slot_len - 1)
    toks = torch.ones((n, 1), dtype=torch.int64, device="cuda")
    noise = torch.zeros((n, 5), device="cuda")
    prompt = torch.ones((1, 256), dtype=torch.int64, device="cuda")
    scratch = engine.init_cache(cfg, 1, slots.slot_len, "cuda")
    bound = weight_bytes / HBM_BYTES_PER_S * 1e3
    cost = obs_kernels.decode_step_cost(cfg, n, (lens + 1).tolist())
    c_ms = 1e3 * max(cost["bytes_accessed"] / HBM_BYTES_PER_S,
                     cost["flops"] / PEAK_OPS["bfloat16"])
    steps = {
        f"slot-pool decode [B={n}, {cfg.num_layers} layers, bf16]": (
            lambda: engine.decode_step_slots(params, slots.caches, lens,
                                             toks, cfg, noise=noise,
                                             top_k=5),
            lambda: _cores(cfg, slots.caches, n, 1)),
        "single-shot prefill [256 tokens, B=1, bf16]": (
            lambda: engine.prefill_chunk(params, scratch, 0, prompt, cfg),
            lambda: _cores(cfg, scratch, 1, 256))}
    for name, (fn, cores) in steps.items():
        line, busy, by = _step_line(f"{cfg.name} {name}", fn)
        _, _, by_cores = _device_ms(cores)
        core_ms = sum(ms for ms, _ in by_cores.values())
        core_n = sum(k for _, k in by_cores.values())
        print(f"{line}; the weights' byte bound {bound:.3f}ms "
              f"({weight_bytes / 1e9:.3f} GB at 3.35 TB/s), device busy "
              f"{busy / bound:.2f}x it; the recurrent cores alone "
              f"({', '.join(RECURRENT_CORES)} at the step's shapes): "
              f"{core_ms:.3f}ms device over {core_n:g} launches, "
              f"{100 * core_ms / busy:.1f}% of the step's device busy")
        rows = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
        launches = sum(k for _, k in by.values())
        print(f"step {cfg.name} {name}: {launches:g} kernel launches; by "
              "kernel (device ms a step x launches a step): " + "; ".join(
                  f"{k} {ms:.4f} x {k_n:g}" for k, (ms, k_n) in rows))
        if "decode" in name:
            print(f"step {cfg.name} {name}: decode_step_cost bound "
                  f"{c_ms:.3f}ms ({cost['bytes_accessed'] / 1e9:.3f} GB: "
                  f"weights, the state read and written, the K/V; "
                  f"{cost['flops'] / 1e9:.1f} GFLOP)")


def _cores(cfg, caches: dict, b: int, t: int) -> None:
    """The recurrent cores of one forward at batch ``b`` and ``t`` tokens,
    alone: every Mamba2 layer's three convs and its chunked scan or decode
    step; every mLSTM layer's conv and chunked form or decode step, every
    sLSTM layer's scan; on stand-in activations of the forward's shapes,
    from the cache's state (read, not written)."""
    import torch
    from repro_torch.models import ssm, xlstm
    dev, bf16 = "cuda", torch.bfloat16
    decode = t == 1
    if cfg.ssm is not None:
        sc = cfg.ssm
        inner = sc.expand * cfg.d_model
        h, n = inner // sc.head_dim, sc.d_state
        x = torch.ones((b, t, inner), dtype=bf16, device=dev)
        bc = torch.ones((b, t, n), dtype=bf16, device=dev)
        dtv = torch.full((b, t, h), 0.01, device=dev)
        w_x = torch.ones((inner, sc.d_conv), device=dev)
        w_n = torch.ones((n, sc.d_conv), device=dev)
        a = torch.zeros(h, device=dev)
        xh = x.reshape(b, t, h, sc.head_dim)
        for i in range(caches["ssm"].shape[0]):
            ssm.causal_conv(x, w_x, caches["conv_x"][i] if decode else None)
            for leaf in ("conv_b", "conv_c"):
                ssm.causal_conv(bc, w_n, caches[leaf][i] if decode else None)
            if decode:
                ssm.ssd_decode_step(caches["ssm"][i], xh[:, 0], dtv[:, 0], a,
                                    bc[:, 0], bc[:, 0], a)
            else:
                ssm.ssd_chunked(xh, dtv, a, bc, bc, a, chunk=sc.chunk)
        return
    xc = cfg.xlstm
    inner = xc.expand * cfg.d_model
    hh, d = xc.num_heads, cfg.d_model
    q = torch.ones((b, t, hh, inner // hh), dtype=bf16, device=dev)
    g = torch.zeros((b, t, hh), device=dev)
    xm = torch.ones((b, t, inner), dtype=bf16, device=dev)
    w = torch.ones((inner, xc.conv_width), device=dev)
    for i in range(caches["C"].shape[0]):
        ssm.causal_conv(xm, w, caches["conv"][i] if decode else None)
        if decode:
            state = (caches["m"][i], caches["C"][i], caches["n"][i])
            xlstm.mlstm_decode_step(state, q[:, 0], q[:, 0], q[:, 0],
                                    g[:, 0], g[:, 0])
        else:
            xlstm.mlstm_chunked(q, q, q, g, g, chunk=xc.chunk)
    gx = torch.zeros((b, t, 4, d), device=dev)
    r = torch.zeros((4, hh, d // hh, d // hh), device=dev)
    for i in range(caches["s_c"].shape[0]):
        xlstm.slstm_scan(gx, r, num_heads=hh, init=tuple(
            caches[k][i] for k in xlstm.SLSTM_LEAVES))


def phase_serve_state() -> dict:
    """The recurrent decoders at full width and ``STATE_SERVE_LAYERS``,
    bf16, weights drawn on the card: zamba2-1.2b (8 of its 38 layers, the
    shared attention block called twice) and xlstm-125m (6 of its 12
    layers), each through the paged
    state pool, the slot pool and the lockstep workload, between a reset
    and a read of the launch counts: equal to the scheduler's counters
    (zamba2: a row-4 launch a shared-block call and decode step, a row-5
    launch a call and prefill; xlstm: the sampler only); tok/s, p50/p95, state bytes a sequence,
    zamba2's K/V bytes a token and peak memory; then each model's "step"
    lines.  Returns {run: counts}."""
    import torch
    from repro_torch import configs
    counts = {}
    for label, arch in STATE_MODELS:
        cfg = configs.get(arch).replace(num_layers=STATE_SERVE_LAYERS[arch])
        params, nbytes = _state_weights(cfg)
        engines = {}
        for path, argv in STATE_PATHS:
            what = f"{label} {path}"
            counts[what], engines[path] = _serve_path(
                what, ["--arch", arch] + argv, cfg, params,
                "slot pool" if label == "zamba2" else "sampler only")
            sched = engines[path].scheduler
            pct = engines[path].report().latency_percentiles((50, 95))
            n_attn = _attn_layers(cfg)
            print(f"serve {what}: per-token latency "
                  f"p50 {pct['p50'] * 1e3:.1f}ms p95 "
                  f"{pct['p95'] * 1e3:.1f}ms; {sched.prefill_chunks} "
                  f"single-shot prefills of {sorted(sched.chunk_widths)} "
                  f"tokens; flash_decode {counts[what]['flash_decode']} = "
                  f"{n_attn} x {sched.decode_steps} decode steps, "
                  f"flash_attention_offset "
                  f"{counts[what]['flash_attention_offset']} = {n_attn} x "
                  f"{sched.prefill_chunks} prefills, softmax_topk "
                  f"{counts[what]['softmax_topk']}")
        _check_state_pools(cfg, engines)
        counts[f"{label} lockstep"] = _serve_lockstep(
            f"{label} lockstep", ["--arch", arch] + LOCKSTEP_ARGS, cfg,
            params)
        _state_steps(params, cfg, engines, nbytes)
        del params, engines
        torch.cuda.empty_cache()
    return counts


def phase_parity_state() -> None:
    """Phase 5's fp32 parity for the recurrent decoders at full width and
    cut depth, card against CPU, the same weights (drawn on the card, copied
    to the CPU): zamba2-1.2b at 7 layers (6 + 1 Mamba2 layers and two calls
    of the shared block, each with its own K/V), xlstm-125m at 6 (layer 5
    an sLSTM): hidden states and last-position logits of a 2 x 256 forward
    within ``STATE_PARITY_RTOL`` of their scale, then the paged, slot-pool
    and lockstep parity workloads' token streams identical under the same
    noise (``_parity_2_layers``)."""
    for arch, layers in (("zamba2_1p2b", 7), ("xlstm_125m", 6)):
        _parity_2_layers(arch, layers=layers, forward=True)


# the encoder-decoder whisper-small (12 + 12 layers, 12/12 heads of 64, G
# 1, d_ff 3072, vocab 51968 of which 51865 real, the head tied): its
# encoder window, vocabulary and heads
WHISPER = ["--arch", "whisper_small"]
WHISPER_S_ENC, WHISPER_HEADS = 1536, 12
WHISPER_VOCAB, WHISPER_REAL_VOCAB = 51968, 51865
# its serving run (phase 4): the CLI's paged route (the only one it takes)
# with the reference's default 3 audios over 12 requests of 8-64 new
# tokens, 8 slots, 16-position blocks (96 cross blocks an audio)
WHISPER_SERVE_ARGS = WHISPER + ["--continuous", "--paged", "--requests",
                                "12", "--slots", "8", "--tokens", "64",
                                "--block-size", "16"]
# phase 5's fp32 parity: full width cut to 2 + 2 layers, 5 requests over 2
# audios, so repeats adopt cross blocks on both devices
WHISPER_PARITY_ARGS = WHISPER + ["--continuous", "--paged", "--requests",
                                 "5", "--slots", "2", "--tokens", "8",
                                 "--block-size", "16", "--audios", "2"]
WHISPER_PARITY_LAYERS = 2


def _whisper_weights(cfg, seed: int = 0):
    """whisper's weights drawn on the card from ``seed``: (params, their
    bytes)."""
    import torch
    from repro_torch.models import encdec
    t0 = time.perf_counter()
    params = encdec.init(cfg, seed=seed, device="cuda", draw_device="cuda")
    torch.cuda.synchronize()
    nbytes = _weight_bytes(params)
    print(f"serve: {cfg.name} {cfg.dtype}, {cfg.encoder_layers} encoder + "
          f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, encoder window "
          f"{cfg.encoder_seq_len}, vocab {cfg.vocab_size} "
          f"({cfg.real_vocab_size} real), tied head; {nbytes / 1e9:.3f} GB "
          f"of weights ({_param_count(params) / 1e9:.3f}e9 parameters) "
          f"drawn on the card from seed {seed} in "
          f"{time.perf_counter() - t0:.1f}s")
    return params, nbytes


@contextlib.contextmanager
def _counting_prefills(calls: dict):
    """Count the scheduler's enc-dec prefills by path while inside:
    ``calls["fresh"]`` (the encoder runs) and ``calls["cached"]`` (a
    whole-audio hit over the shared cross blocks)."""
    from repro_torch.serving import engine
    real = {"fresh": engine.encdec_prefill,
            "cached": engine.encdec_prefill_cached}

    def counted(key):
        def fn(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return real[key](*a, **kw)
        return fn
    engine.encdec_prefill = counted("fresh")
    engine.encdec_prefill_cached = counted("cached")
    try:
        yield calls
    finally:
        engine.encdec_prefill = real["fresh"]
        engine.encdec_prefill_cached = real["cached"]


def phase_serve_whisper() -> dict:
    """whisper-small at full width and depth (12 + 12 layers, bf16,
    weights drawn on the card) through ``python -m repro_torch.launch.serve
    --arch whisper_small --continuous --paged`` (``WHISPER_SERVE_ARGS``),
    between a reset and a read of the launch counts: every request
    finishes in the real vocabulary; the encoder ran once an audio and a
    repeat adopted the audio's cross blocks (blocks shared = hits x 96,
    tokens reused = hits x 1536); the launches equal what the counters
    imply: row 6 (the encoder's non-causal fresh forward) 12 a fresh
    encode and none on a hit, row 4 24 a decode step and 24 a prefill (the
    self- and cross-attention of 12 layers), row 1 one a decode step and
    a prefill, nothing else; tok/s, p50/p95, peak memory, the pool's bytes
    per cached decoder token and per audio; then "step" lines: a B 8 decode
    step through the pool (every row over its audio's 1536 cross keys)
    beside ``decode_step_cost``'s bound, and a fresh prefill (the encoder
    over 1536 frames and the BOS step).  Returns {"whisper paged":
    counts}."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.obs import kernels as obs_kernels
    from repro_torch.serving import engine
    cfg = configs.get("whisper_small")
    params, _ = _whisper_weights(cfg)
    args = serve.parse_args(WHISPER_SERVE_ARGS)
    what = "whisper paged"
    held = _reset_peak()
    dispatch.reset_launch_counts()
    with _counting_prefills({}) as calls:
        report, router, requests, _ = serve.run(args, cfg, params)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    sched = router.engines[0].scheduler
    pool = sched.pool
    _check_finished(what, report, requests, cfg.real_vocab_size)
    audios = {tuple(int(t) for t in r.prompt) for r in requests}
    fresh, hits = calls.get("fresh", 0), calls.get("cached", 0)
    nc = WHISPER_S_ENC // args.block_size
    p = report.paged
    if fresh != len(audios) or fresh + hits != len(requests) or \
            p["blocks_shared"] != hits * nc or \
            p["tokens_reused"] != hits * WHISPER_S_ENC:
        _fail(f"serve {what}: {fresh} encoder runs and {hits} hits for "
              f"{len(requests)} requests over {len(audios)} audios; pool "
              f"{p}")
    layers = cfg.num_layers
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention=cfg.encoder_layers * fresh,
                flash_decode=2 * layers * (sched.decode_steps
                                           + sched.prefill_chunks),
                softmax_topk=sched.decode_steps + sched.prefills_done)
    if counts != want:
        _fail(f"serve {what}: launches {counts}, the counters imply {want}")
    pct = report.latency_percentiles((50, 95))
    block = {k: x[:, 0].numel() * x.element_size()
             for k, x in pool.caches.items()}
    self_tok = (block["self_k"] + block["self_v"]) / pool.slot_len
    audio = (block["cross_k"] + block["cross_v"]) * nc
    print(f"serve {what} launches: {counts} = flash_attention "
          f"{cfg.encoder_layers} x {fresh} fresh encodes (none on the "
          f"{hits} whole-audio hits), flash_decode {2 * layers} x "
          f"({sched.decode_steps} decode steps + {sched.prefill_chunks} "
          f"prefills), softmax_topk {sched.decode_steps} + "
          f"{sched.prefills_done}; {report.tokens_per_s:.1f} tok/s; "
          f"per-token latency p50 {pct['p50'] * 1e3:.1f}ms p95 "
          f"{pct['p95'] * 1e3:.1f}ms; peak device memory {peak:.2f} GiB "
          f"over the {held / 2**30:.2f} held before it")
    print(f"serve {what} pool: {len(requests)} requests over {len(audios)} "
          f"audios, {hits} whole-audio hits: cross blocks shared "
          f"{p['blocks_shared']} = {hits} x {nc}, tokens reused "
          f"{p['tokens_reused']} = {hits} x {WHISPER_S_ENC}, prefix-cache "
          f"hits {p['prefix_cache_hits']}; {p['num_blocks']} blocks of "
          f"{sum(block.values())} bytes (a {pool.slot_len}-position self "
          f"row and {args.block_size} cross positions); "
          f"{self_tok:.0f} bytes a cached decoder token, {audio} bytes "
          f"({audio / 2**20:.2f} MiB) of cross K/V an audio")

    # the step lines: a decode step of 8 rows over one audio's blocks (the
    # cross blocks the pool held, rows of their own for the self K/V), and
    # a fresh prefill
    n = sched.pool.num_slots
    cross = torch.arange(1, nc + 1, device="cuda").expand(n, nc)
    rows = torch.arange(nc + 1, nc + 1 + n, device="cuda")
    lens = torch.tensor(MLA_DECODE_VLENS[:n], device="cuda").clamp(
        max=pool.slot_len - 1)
    active = torch.ones(n, dtype=torch.bool, device="cuda")
    toks = torch.ones((n, 1), dtype=torch.int64, device="cuda")
    noise = torch.zeros((n, 5), device="cuda")
    frames = engine.encdec_frames_from_ids(requests[0].prompt, cfg, "cuda")
    bos = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    cost = obs_kernels.decode_step_cost(cfg, n, (lens + 1).tolist())
    c_ms = 1e3 * max(cost["bytes_accessed"] / HBM_BYTES_PER_S,
                     cost["flops"] / PEAK_OPS["bfloat16"])
    with torch.no_grad():
        line, _, by = _step_line(
            f"{cfg.name} paged decode [B={n}, {layers} decoder layers, "
            f"self lengths {lens.tolist()}, {WHISPER_S_ENC} cross keys a "
            "row, bf16]",
            lambda: engine.decode_step_encdec_paged(
                params, pool.caches, cross, rows, active, lens, toks, cfg,
                noise=noise, top_k=5))
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:6]
        print(f"{line}; decode_step_cost bound {c_ms:.3f}ms "
              f"({cost['bytes_accessed'] / 1e9:.3f} GB: the decoder's "
              f"weights, the self and cross K/V; the gather of the cross "
              f"blocks not counted); by kernel: " + ", ".join(
                  f"{k} {ms:.3f}ms x{k_n:g}" for k, (ms, k_n) in top))
        line, _, _ = _step_line(
            f"{cfg.name} fresh prefill [{WHISPER_S_ENC} frames through "
            f"{cfg.encoder_layers} encoder layers, then BOS, bf16]",
            lambda: engine.encdec_prefill(params, frames, bos, cfg,
                                          max_len=pool.slot_len),
            samples=5)
        print(line)
    del params, router, sched, pool
    torch.cuda.empty_cache()
    return {what: counts}


# llava-next-34b's lockstep run (phase 4) at full width and this many of
# its 60 layers: 557.8e6 parameters a layer and 0.92e9 for each of the
# embedding and the untied head, so 10.9 GB of bf16 weights at 8
LLAVA_SERVE_LAYERS = 8


def phase_serve_llava() -> dict:
    """llava-next-34b at full width and ``LLAVA_SERVE_LAYERS`` layers
    (bf16, weights drawn on the card) through the lockstep loop
    (``LLAVA_LOCKSTEP_ARGS``: 2 prompts of 64 behind the CLI's 2880 seeded
    patch embeddings, 16 tokens, caches of 2960), between a reset and a
    read of the launch counts (``_serve_lockstep``: one row-5 prefill and
    15 row-4 decode launches a layer at 56/8 heads of 128, one sampler
    launch a token at V 64000); peak device memory; then the decode step
    over 2960 keys and the prefill as "step" lines beside the weights'
    byte bound and ``decode_step_cost``'s.  Returns {"llava lockstep":
    launch counts}."""
    import torch
    from repro_torch import configs
    from repro_torch.obs import kernels as obs_kernels
    from repro_torch.serving import engine
    cfg = configs.get("llava_next_34b").replace(
        num_layers=LLAVA_SERVE_LAYERS)
    held = _reset_peak()
    params, nbytes = _card_weights(cfg)
    print(f"serve llava lockstep: {cfg.name}, {cfg.num_layers} layers, "
          f"{cfg.num_patches} patch embeddings through mm_proj ahead of "
          f"each prompt: a prefill of Tq {LLAVA_TQ} into caches of "
          f"{LLAVA_S}")
    counts = {"llava lockstep": _serve_lockstep(
        "llava lockstep", LLAVA_LOCKSTEP_ARGS, cfg, params)}
    print(f"serve llava lockstep: peak device memory "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
          f"over the {held / 2**30:.2f} held before it")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, LLAVA_TQ - cfg.num_patches),
                         generator=gen, device="cuda")
    pe = torch.randn((2, cfg.num_patches, cfg.d_model), generator=gen,
                     device="cuda")
    _, caches, n = engine.prefill(params, toks, cfg, max_len=LLAVA_S,
                                  patch_embeds=pe)
    tok = toks[:, -1:]
    sample = torch.Generator().manual_seed(0)
    cost = obs_kernels.decode_step_cost(cfg, 2, [LLAVA_S] * 2)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    for name, fn, samples in (
            (f"lockstep decode [B 2 over {LLAVA_S} keys]",
             lambda: engine.decode_step(params, caches, LLAVA_S - 1, tok,
                                        cfg, generator=sample), 10),
            (f"lockstep prefill [B 2, {cfg.num_patches} patches + "
             f"{LLAVA_TQ - cfg.num_patches} tokens]",
             lambda: engine.prefill(params, toks, cfg, max_len=LLAVA_S,
                                    patch_embeds=pe), 3)):
        line, busy, by = _step_line(f"{cfg.name} {name}", fn,
                                    samples=samples, reps=1)
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:6]
        print(f"{line}; the weights' byte bound {bound:.3f}ms "
              f"({nbytes / 1e9:.3f} GB at 3.35 TB/s), decode_step_cost "
              f"{cost['bytes_accessed'] / HBM_BYTES_PER_S * 1e3:.3f}ms; by "
              "kernel (device ms a step x launches): " + "; ".join(
                  f"{k} {ms:.4f} x {k_n:g}" for k, (ms, k_n) in top))
    del params, caches
    torch.cuda.empty_cache()
    return counts


def phase_parity_whisper() -> None:
    """Phase 5's fp32 parity for whisper-small at full width cut to 2 + 2
    layers (weights drawn on the card from seed 1, copied to the CPU): the
    paged workload (``WHISPER_PARITY_ARGS``) on the card through the
    kernels and on the CPU through the plain versions gives identical token
    streams and pool stats; then on the card a same-audio hit
    (``encdec_prefill_cached`` over the cross blocks a fresh prefill
    installed) gives the fresh prefill's last hidden state and decoder
    caches bit for bit, and the install of a hit writes no cross block."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import cache_family, engine
    cfg = configs.get("whisper_small").replace(
        num_layers=WHISPER_PARITY_LAYERS,
        encoder_layers=WHISPER_PARITY_LAYERS, dtype="float32")
    params_cuda, _ = _whisper_weights(cfg, seed=1)
    params_by_device = {"cuda": params_cuda,
                        "cpu": transformer.params_to(params_cuda, "cpu")}
    what = f"{cfg.name} (2 + 2 layers)"
    _parity_runs(f"{what} paged", WHISPER_PARITY_ARGS, cfg,
                 params_by_device)
    fam = cache_family.resolve(cfg)
    bs, slot_len = 16, 32
    nc = WHISPER_S_ENC // bs
    pools = fam.init_paged_cache(nc + 3, bs, "cuda", slot_len=slot_len)
    ids = torch.randint(0, WHISPER_REAL_VOCAB, (WHISPER_S_ENC,),
                        generator=torch.Generator().manual_seed(5))
    bos = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    cross = torch.arange(1, nc + 1, device="cuda")
    with torch.no_grad():
        frames = engine.encdec_frames_from_ids(ids, cfg, "cuda")
        h_fresh, c_fresh, _ = engine.encdec_prefill(
            params_cuda, frames, bos, cfg, max_len=slot_len)
        engine.install_encdec_row(pools, c_fresh, cross,
                                  torch.tensor([nc + 1], device="cuda"))
        before = {k: pools[k].clone() for k in ("cross_k", "cross_v")}
        h_hit, c_hit, _ = engine.encdec_prefill_cached(
            params_cuda, engine.gather_encdec_cross(pools, cross), bos, cfg,
            max_len=slot_len)
        engine.install_encdec_row(pools, c_hit,
                                  torch.full((nc,), nc + 3, device="cuda"),
                                  torch.tensor([nc + 2], device="cuda"))
    same = torch.equal(h_fresh, h_hit) and all(
        torch.equal(c_fresh[k], c_hit[k]) for k in c_fresh)
    kept = all(torch.equal(pools[k], before[k]) for k in before)
    if not (same and kept):
        _fail(f"parity {what}: a whole-audio hit differs from the fresh "
              f"prefill (equal: {same}) or rewrote the cross blocks "
              f"(kept: {kept})")
    print(f"parity {what}: on the card a whole-audio hit (no encoder) gives "
          f"the fresh prefill's hidden state and all {len(c_fresh)} "
          f"decoder cache leaves bit for bit; its install wrote none of the "
          f"{nc} shared cross blocks")
    del params_by_device, params_cuda, pools
    torch.cuda.empty_cache()


# phase 5's fp32 stream parity of mistral-nemo-12b and qwen2-moe-a2.7b:
# full width and this many layers (2 until the recurrent decoders' phases
# took the script's time)
PARITY_128_LAYERS = 1


def phase_parity_128() -> None:
    """Phase 5's fp32 stream parity for mistral-nemo-12b at full width cut
    to ``PARITY_128_LAYERS`` (``_parity_2_layers``)."""
    _parity_2_layers("mistral_nemo_12b", layers=PARITY_128_LAYERS)


def _parity_2_layers(arch: str, paged: bool = True, layers: int = 2,
                     forward: bool = False) -> None:
    """``arch`` at full width cut to ``layers`` layers in fp32, weights
    drawn on the card from seed 1 and copied to the CPU (a CPU draw of
    these ~1.8e9 weights takes 12-15 s, the copy a second or two): with
    ``forward``, the hidden states and last-position logits of a 2 x 256
    forward on both devices within ``STATE_PARITY_RTOL`` of their scale;
    the paged (with ``paged``), slot-pool and lockstep parity workloads on
    the card through the kernels and on the CPU through the plain versions
    give identical token streams."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = configs.get(arch).replace(num_layers=layers, dtype="float32")
    name = cfg.name
    t0 = time.perf_counter()
    params_cuda = transformer.init(cfg, seed=1, device="cuda",
                                   draw_device="cuda")
    params_by_device = {"cuda": params_cuda,
                        "cpu": transformer.params_to(params_cuda, "cpu")}
    print(f"parity {name}: {_weight_bytes(params_cuda) // 4} weights "
          f"({layers} layers, fp32) drawn on the card and copied to the CPU "
          f"in {time.perf_counter() - t0:.1f}s")
    if forward:
        _forward_parity(f"{name} ({layers} layers)", cfg, params_by_device)
    if paged:
        _parity_runs(f"{name} ({layers} layers) paged", PARITY_ARGS, cfg,
                     params_by_device)
    _parity_runs(f"{name} ({layers} layers) slot pool", SLOT_PARITY_ARGS, cfg,
                 params_by_device)
    ids = {device: serve.lockstep(serve.parse_args(
               LOCKSTEP_PARITY_ARGS + ["--device", device]), cfg, params)
           for device, params in params_by_device.items()}
    if not np.array_equal(ids["cuda"], ids["cpu"]):
        _fail(f"parity {name} lockstep: token ids differ\ncuda "
              f"{ids['cuda']}\ncpu  {ids['cpu']}")
    print(f"parity {name} ({layers} layers) lockstep: {ids['cpu'].size} "
          "token ids identical")
    del params_by_device
    torch.cuda.empty_cache()


# the recurrent decoders' fp32 forward parity, card against CPU: max |diff|
# of the hidden states and of the logits over the CPU's max |value|.  Each
# device rounds its fp32 products and sums in its own order (~1e-7 relative
# an operation), which the scans carry through 256 steps and 7 layers; a
# wrong state carry or a dropped term moves them by O(1) of their scale
STATE_PARITY_RTOL = 1e-3


def _forward_parity(what: str, cfg, params_by_device, shape=(2, 256),
                    patches=None) -> None:
    """Hidden states of a ``shape`` forward (2 x 256: two 128-token chunks
    of zamba2's scan, one 256-token chunk of xlstm's; a VLM's behind
    ``patches``) and their last position's logits, on the card and on the
    CPU, within ``STATE_PARITY_RTOL`` of the CPU's scale."""
    import torch
    from repro_torch.models import transformer
    toks = torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(3))
    out = {}
    for device, params in params_by_device.items():
        pe = None if patches is None else patches.to(device)
        with torch.no_grad():
            h, _ = transformer.forward(params, toks.to(device), cfg,
                                       patch_embeds=pe)
            out[device] = (h.cpu(), transformer.logits_last(params, h,
                                                            cfg).cpu())
    for i, name in enumerate(("hidden", "logits")):
        got, want = out["cuda"][i], out["cpu"][i]
        if not torch.isfinite(got).all():
            _fail(f"parity {what}: the card's {name} are not finite")
        diff = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not diff <= STATE_PARITY_RTOL * scale:
            _fail(f"parity {what}: {name} max |diff| {diff:.3g} beyond "
                  f"{STATE_PARITY_RTOL} x scale {scale:.3g}")
        print(f"parity {what} forward {list(h.shape[:2])}: {name} max "
              f"|card - CPU| "
              f"{diff:.3g} = {diff / scale:.3g} of scale {scale:.3g} "
              f"(<= {STATE_PARITY_RTOL})")


def phase_parity_moe() -> None:
    """Phase 5's fp32 stream parity for qwen2-moe-a2.7b at full width cut
    to ``PARITY_128_LAYERS`` (``_parity_2_layers``): the router's fused softmax+top-k,
    the G 1 attention instances and the one-hot experts on the card against
    the plain versions on the CPU, under the same prefill chunking (so the
    same capacity groups)."""
    _parity_2_layers("qwen2_moe_a2p7b", layers=PARITY_128_LAYERS)


def phase_parity_mla() -> None:
    """Phase 5's fp32 stream parity for minicpm3-4b at full width cut to 2
    layers (``_parity_2_layers``, slot pool and lockstep: its latent cache
    has no paged form): the latent attention kernels on the card against
    their plain versions on the CPU."""
    _parity_2_layers("minicpm3_4b", paged=False)


def _block_bytes(cfg, block_size: int) -> int:
    """Bytes of one block over every layer's pool leaves, from the config
    alone: K and V, plus a bf16 scale per (position, KV head) when they are
    int8."""
    import torch
    from repro_torch.models import transformer
    int8 = cfg.kv_cache_dtype == "int8"
    item = 1 if int8 else transformer.DTYPES[cfg.dtype].itemsize
    return 2 * cfg.num_layers * cfg.num_kv_heads * block_size * (
        cfg.resolved_head_dim * item + (torch.bfloat16.itemsize if int8
                                        else 0))


@contextlib.contextmanager
def _serving_probes(*, poison: bool = False, sleep_cycles: int = 0):
    """Record the schedulers' decisions and swaps while the block is open:
    yields (decisions, swaps, resumes), decisions as ("admit" | "resume" |
    "preempt", rid) in order, swaps as (rid, entry kinds, blocks freed),
    resumes as (rid, host blocks restored, whether ``swap_in`` restored
    them from the prefetch's staged copy).
    ``poison`` fills the blocks each ``PagedPool.swap_out`` frees, at once,
    with NaN (int8: +127 in K, -127 in V, NaN in the scales), so a resumed
    sequence that read pool memory instead of its host or staged copy
    could not give its stream; ``sleep_cycles`` queues a device sleep
    before every paged decode step."""
    import torch
    from repro_torch.serving import engine, paged, scheduler
    sched_cls, pool_cls = scheduler.ContinuousScheduler, paged.PagedPool
    saved = {n: getattr(sched_cls, n)
             for n in ("_start_prefill", "_try_resume", "_swap_out")}
    saved_swap, saved_decode = pool_cls.swap_out, engine.decode_step_paged
    saved_swap_in = pool_cls.swap_in
    decisions, swaps, resumes = [], [], []

    def logged(name, kind, rid_of):
        def call(self, arg):
            ok = saved[name](self, arg)
            if ok is not False:
                decisions.append((kind, rid_of(arg)))
            return ok
        return call

    def swap_out(self, slot, rid):
        free_before = set(self.alloc._free)
        rec = saved_swap(self, slot, rid)
        freed = sorted(set(self.alloc._free) - free_before)
        swaps.append((rid, tuple(k for k, _ in rec.entries), len(freed)))
        if poison and freed:
            for name, x in self.caches.items():
                if x.dtype == torch.int8:
                    x[:, freed] = 127 if name == "k" else -127
                else:
                    x[:, freed] = float("nan")
        return rec

    def swap_in(self, rid):
        rec = self.swapped[rid]
        staged = bool(rec.staged)
        seq = saved_swap_in(self, rid)
        if seq is not None:
            resumes.append((rid, sum(k == "host" for k, _ in rec.entries),
                            staged))
        return seq

    def decode_step_paged(*args, **kwargs):
        torch.cuda._sleep(sleep_cycles)
        return saved_decode(*args, **kwargs)

    sched_cls._start_prefill = logged("_start_prefill", "admit",
                                      lambda req: req.rid)
    sched_cls._try_resume = logged("_try_resume", "resume", lambda rid: rid)
    sched_cls._swap_out = logged("_swap_out", "preempt",
                                 lambda flight: flight.req.rid)
    pool_cls.swap_out = swap_out
    pool_cls.swap_in = swap_in
    if sleep_cycles:
        engine.decode_step_paged = decode_step_paged
    try:
        yield decisions, swaps, resumes
    finally:
        for n, fn in saved.items():
            setattr(sched_cls, n, fn)
        pool_cls.swap_out = saved_swap
        pool_cls.swap_in = saved_swap_in
        engine.decode_step_paged = saved_decode


def _check_prefetched(what: str, p: dict, resumes) -> str:
    """Fail unless the run's resumes went through the staging stream: at
    least one ``swap_in`` restored the prefetch's staged copy, the blocks
    those resumes restored are the pool's ``swap_prefetched_blocks``, and
    every resume's blocks add up to ``swapped_blocks_in``.  Returns the
    summary for the run's line."""
    staged = [n for _, n, from_staged in resumes if from_staged]
    if not staged or p["swap_prefetched_blocks"] < 1:
        _fail(f"{what}: no resume read a staged copy ({resumes}; {p})")
    if sum(staged) != p["swap_prefetched_blocks"] or \
            sum(n for _, n, _ in resumes) != p["swapped_blocks_in"]:
        _fail(f"{what}: resumes {resumes} disagree with the pool's "
              f"prefetched / swapped-in blocks {p}")
    return (f"prefetched {p['swap_prefetched_blocks']} blocks = those of the "
            f"{len(staged)} of {len(resumes)} resumes that restored the "
            f"staged copy")


def _serve_slo(params, cfg, counts: dict) -> None:
    """Phase 4's SLO runs (bf16, then int8 K/V) and the router runs (with
    prefix affinity, which sends this one-prefix traffic to one replica,
    then round-robin, so both replicas decode), each between a reset and a
    read of the launch counts."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    for what, argv in (("paged slo", SLO_ARGS),
                       ("paged slo int8", SLO_ARGS + INT8),
                       ("router", ROUTER_ARGS),
                       ("router round-robin", ROUTER_ARGS + ["--no-affinity"])
                       ):
        args = serve.parse_args(argv)
        run_cfg = _smollm_config(args)
        with _serving_probes() as (_, swaps, resumes):
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            report, router, requests, _ = serve.run(args, run_cfg, params)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts[what] = dispatch.launch_counts()
        scheds = [e.scheduler for e in router.engines]
        _check_finished(what, report, requests, cfg.vocab_size)
        want = dict.fromkeys(COUNTERS, 0)
        for sched in scheds:
            for k, n in _implied_counts(sched, cfg.num_layers).items():
                want[k] += n
        int8 = bool(args.kv_cache_dtype)
        _check_counts(what, counts[what], want,
                      path=(("flash_decode_paged_int8",
                             "flash_attention_offset") if int8 else
                            ("flash_decode_paged", "flash_attention_paged")))
        p = report.paged
        print(f"serve {what} launches: {counts[what]} = scheduler counters "
              f"(decode steps {report.decode_steps}, prefill chunks "
              f"{report.prefill_chunks}, {len(scheds)} engine(s)); "
              f"{report.total_tokens} tokens in {wall:.1f}s, "
              f"{report.tokens_per_s:.1f} tok/s")
        if what.startswith("router"):
            r = report.router
            if sum(r["per_replica"]) != len(requests) or (
                    args.no_affinity and min(r["per_replica"]) < 1):
                _fail(f"serve {what}: assigned {r['per_replica']} of "
                      f"{len(requests)} requests")
            print(f"serve {what}: {r['replicas']} replicas sharing one copy "
                  f"of the weights, per-replica requests {r['per_replica']}, "
                  f"affinity routes {r['affinity_routes']}, backpressure "
                  f"rejects {r['backpressure_rejects']}; merged "
                  f"{report.tokens_per_s:.1f} tok/s over "
                  f"{report.wall_time:.2f}s; blocks shared "
                  f"{p['blocks_shared']}, prefix-cache hits "
                  f"{p['prefix_cache_hits']}")
            continue
        per_block = _block_bytes(run_cfg, args.block_size)
        if report.preemptions < 2:
            _fail(f"serve {what}: {report.preemptions} preemptions at "
                  f"--blocks {args.blocks} (need at least 2)")
        if p["swapped_blocks_in"] != p["swapped_blocks_out"] or \
                p["swapped_bytes_out"] != p["swapped_blocks_out"] * per_block:
            _fail(f"serve {what}: swap counters {p} (a block is "
                  f"{per_block} bytes)")
        if int8:
            _check_int8_run(what, report, scheds[0], requests)
            if any("shared" in kinds for _, kinds, _ in swaps):
                _fail(f"serve {what}: an int8 swap kept a shared block")
        prefetched = _check_prefetched(f"serve {what}", p, resumes)
        by_class = report.latency_percentiles_by_class((50, 95))
        att = report.slo_attainment()
        print(f"serve {what}: --blocks {args.blocks} of 168, preemptions "
              f"{report.preemptions}, blocks swapped out "
              f"{p['swapped_blocks_out']} = in {p['swapped_blocks_in']} "
              f"({p['swapped_bytes_out']} bytes, {per_block} a block; "
              f"entries {sum(len(k) for _, k, _ in swaps)} of which shared "
              f"{sum(k.count('shared') for _, k, _ in swaps)}), "
              f"{prefetched}; " + "; ".join(
                  f"class {c} p50 {v['p50'] * 1e3:.1f} ms p95 "
                  f"{v['p95'] * 1e3:.1f} ms" for c, v in by_class.items())
              + f"; SLO attainment {att * 100:.1f}% at --slo-ms "
              f"{args.slo_ms:g}")


# ---------------------------------------------------------------------------
# 5: fp32 parity at full width and SMOLLM_LAYERS layers: kernels on the
# card vs plain on the CPU
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
    cfg = _smollm_config(base, dtype="float32")
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


def _slo_parity_run(argv, cfg, params, device: str, **probes):
    """One run of ``argv`` on ``device`` under a ``VirtualClock`` (deadline
    slack reads the clock), quiet.  Returns (streams, decisions, pool
    stats, preempted rids, swaps, resumes)."""
    import io
    from repro_torch.launch import serve
    from repro_torch.obs.clock import VirtualClock
    args = serve.parse_args(argv + ["--device", device])
    with _serving_probes(**probes) as (decisions, swaps, resumes), \
            contextlib.redirect_stdout(io.StringIO()):
        report, _, _, _ = serve.run(args, cfg, params, clock=VirtualClock())
    return ({r.rid: r.tokens for r in report.results}, decisions,
            report.paged, sorted(r.rid for r in report.results
                                 if r.preempted), swaps, resumes)


def phase_parity_slo() -> None:
    """SLO scheduling with preempt-and-swap, and a 2-replica router, at
    full width and ``SMOLLM_LAYERS`` layers in fp32: on the card with
    every block a swap-out frees poisoned at once, and on the CPU (plain versions, unpoisoned: they
    multiply masked-out values by 0, which NaN survives), under virtual
    clocks.  Streams, decisions and pool and swap stats must be identical;
    every preempted request's stream must equal its run with
    ``--no-preempt`` on the card; and a poisoned card run with a device
    sleep queued before every decode step (the staging stream then copies
    beside a busy current stream) must give the same streams again."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cfg = _smollm_config(serve.parse_args(SLO_PARITY_ARGS), dtype="float32")
    params_cpu = transformer.init(cfg, seed=1, device="cpu")
    params = {"cuda": transformer.params_to(params_cpu, "cuda"),
              "cpu": params_cpu}
    for what, argv in (("slo", SLO_PARITY_ARGS),
                       ("router", ROUTER_PARITY_ARGS)):
        t0 = time.perf_counter()
        card = _slo_parity_run(argv, cfg, params["cuda"], "cuda",
                               poison=True)
        cpu = _slo_parity_run(argv, cfg, params["cpu"], "cpu")
        for i, name in ((0, "token streams"), (1, "decisions"),
                        (2, "pool and swap stats"), (5, "resume sources")):
            if card[i] != cpu[i]:
                _fail(f"parity {what}: {name} differ\ncuda {card[i]}\n"
                      f"cpu  {cpu[i]}")
        if len(card[3]) < 1 or card[2]["swapped_blocks_out"] < 1:
            _fail(f"parity {what}: nothing was preempted ({card[2]})")
        prefetched = _check_prefetched(f"parity {what}", card[2], card[5])
        calm = _slo_parity_run(argv + ["--no-preempt"], cfg, params["cuda"],
                               "cuda")
        for rid in card[3]:
            if card[0][rid] != calm[0][rid]:
                _fail(f"parity {what}: preempted request {rid} gave "
                      f"{card[0][rid]}, its never-preempted run "
                      f"{calm[0][rid]}")
        if calm[2]["swapped_blocks_out"]:
            _fail(f"parity {what}: --no-preempt swapped {calm[2]}")
        extra = ""
        if what == "slo":
            slept = _slo_parity_run(argv, cfg, params["cuda"], "cuda",
                                    poison=True,
                                    sleep_cycles=DECODE_SLEEP_CYCLES)
            if slept[:3] != card[:3] or slept[5] != card[5]:
                _fail(f"parity {what}: with a device sleep before each "
                      f"decode step the run differs\nslept {slept[:3]} "
                      f"{slept[5]}\ncard  {card[:3]} {card[5]}")
            extra = (f"; again with {_sleep_ms(DECODE_SLEEP_CYCLES):.1f} ms "
                     "of device sleep before every decode step: identical")
        p = card[2]
        print(f"parity {what}: card (freed blocks poisoned) and CPU "
              f"identical: {sum(len(t) for t in card[0].values())} tokens, "
              f"{len(card[1])} decisions "
              f"({sum(k == 'preempt' for k, _ in card[1])} preemptions of "
              f"rids {card[3]}), swapped blocks out {p['swapped_blocks_out']}"
              f" = in {p['swapped_blocks_in']}, {prefetched}; preempted "
              f"streams equal their "
              f"--no-preempt runs{extra} ({time.perf_counter() - t0:.1f}s; "
              f"{' '.join(argv)})")


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
    """The int8 paths at full width and ``SMOLLM_LAYERS`` layers in fp32,
    card against CPU.  Token streams are not a sound gate: the two fp32 K projections differ in
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
    cfg = _smollm_config(base, dtype="float32")
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
    """10 full-width bf16 steps between a reset and a read of the launch
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
        print(_train_line(run.model.name, hist, args))
        want = _train_counts(run.model, steps)
        if counts != want:
            _fail(f"train: launches {counts}, remat 'full' implies {want}")
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
    return counts, {"params": params, "opt": opt, "run": run, "args": args,
                    "losses": [h["loss"] for h in hist]}


def _train_counts(cfg, steps: int) -> dict:
    """The launch counts a bf16 training run of ``steps`` steps implies
    under remat "full" or "block" (both recompute attention and the
    router): per attention layer and step 2 fresh forwards (the forward,
    then its recomputation in the backward), one dq and one dk/dv launch,
    and for an MoE model 2 router launches; nothing else (an ``mla``
    block's decompressed attention takes the same three kernels at (96,
    64), and its latent serving kernels launch 0 times).  The attention
    layers are every layer of a dense, MoE, MLA or VLM stack, zamba2's 7
    shared-block calls and none of xLSTM's; an encoder-decoder's are its
    encoder layers' self-attention (non-causal) and each decoder layer's
    self- and cross-attention (every encoder and decoder layer is
    checkpointed)."""
    n = (cfg.encoder_layers + 2 * cfg.num_layers if cfg.family == "encdec"
         else _attn_layers(cfg))
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention=2 * steps * n,
                flash_attention_bwd_dq=steps * n,
                flash_attention_bwd_dkv=steps * n)
    if cfg.moe is not None:
        want["softmax_topk_router"] = 2 * steps * n
    return want


def _train_line(name: str, hist, args) -> str:
    """The losses, grad norms, step times and tokens/s of a training run's
    history; fails unless every loss and grad norm is finite."""
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if len(hist) != args.steps or not all(map(math.isfinite,
                                              losses + norms)):
        _fail(f"train {name}: {len(hist)} steps, losses {losses}, grad "
              f"norms {norms}")
    dts = [h["dt"] for h in hist[1:]]
    tok = args.global_batch * args.seq_len
    return (f"train {name}: first loss {losses[0]:.4f} → last loss "
            f"{losses[-1]:.4f}; grad norm {norms[0]:.4f} → {norms[-1]:.4f};"
            f" step 0 {hist[0]['dt'] * 1e3:.1f}ms, steps 1-{len(hist) - 1} "
            f"median {statistics.median(dts) * 1e3:.1f}ms = "
            f"{tok / statistics.median(dts):.0f} tokens/s")


def _remat_runs(run, args, name: str, steps: int = REMAT_STEPS) -> None:
    """``steps`` train steps under remat "block", then under "full",
    each from ``run.seed``'s weights drawn on the card and the CLI's batches
    (``train_step.init_state``, ``make_train_step``): each one's peak
    device memory and median step time (host call to device finish); the
    parameters after the last step bit-identical (both compute the same
    values: "block" keeps the products without batch dims that "full"
    recomputes, and every kernel and product is deterministic)."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.kernels import dispatch
    from repro_torch.training.train_step import init_state, make_train_step
    cfg = run.model
    ds = SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.real_vocab_size or cfg.vocab_size,
        seq_len=args.seq_len, global_batch=args.global_batch,
        seed=run.seed))
    kept, lines = {}, []
    t_all = time.perf_counter()
    for remat in ("block", "full"):
        r = dataclasses.replace(run, model=cfg.replace(remat=remat))
        held = _reset_peak()
        params, opt = init_state(r, device="cuda")
        step = make_train_step(r)
        dispatch.reset_launch_counts()
        dts, losses = [], []
        for i in range(steps):
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in ds.batch(i).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
            dts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        want = _train_counts(r.model, steps)
        if counts != want:
            _fail(f"train {name} remat {remat}: launches {counts}, want "
                  f"{want}")
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        kept[remat] = [p.detach() for p in tree.leaves(params)]
        lines.append(f"remat {remat}: peak {peak:.2f} GiB over the "
                     f"{held / 2**30:.2f} held before it, median step "
                     f"{statistics.median(dts) * 1e3:.1f}ms (steps "
                     f"{', '.join(f'{x * 1e3:.1f}' for x in dts)}ms), losses "
                     f"{', '.join(f'{x:.4f}' for x in losses)}")
        del params, opt, step
    same = [torch.equal(a, b) for a, b in zip(kept["block"], kept["full"])]
    if not all(same):
        worst = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(kept["block"], kept["full"]))
        _fail(f"train {name}: after {steps} steps {same.count(False)} "
              f"of {len(same)} parameter leaves differ between remat "
              f"'block' and 'full' (max abs {worst:.3g})")
    del kept
    torch.cuda.empty_cache()
    print(f"train {name} remat: {steps} steps each from seed "
          f"{run.seed}; {'; '.join(lines)}; parameters bit-identical "
          f"(launches as remat 'full' implies in both; "
          f"{time.perf_counter() - t_all:.1f}s in all)")


def _model_what(cfg) -> str:
    """A model's width in words: its heads and feed-forward, or its
    recurrent layers."""
    from repro_torch.models import transformer
    mc, ml = cfg.moe, cfg.mla
    if cfg.ssm is not None or cfg.xlstm is not None:
        return _recurrent_what(cfg, transformer.layer_counts(cfg))
    ffn = (f"d_ff {cfg.d_ff}" if mc is None else
           f"{mc.num_experts} experts padded to {mc.pad_experts_to}, "
           f"top {mc.experts_per_token}, d_ff {mc.d_ff_expert}, shared "
           f"{mc.d_ff_shared}")
    heads = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
             f"{cfg.resolved_head_dim}" if ml is None else
             f"{cfg.num_heads} MLA heads, q_lora {ml.q_lora_rank}, "
             f"kv_lora {ml.kv_lora_rank}, Dqk "
             f"{ml.qk_nope_head_dim + ml.qk_rope_head_dim} "
             f"({ml.qk_nope_head_dim} + {ml.qk_rope_head_dim} rope), Dv "
             f"{ml.v_head_dim}")
    return f"{heads}, {ffn}"


def _train_run(name: str, key: str, argv, steps: int, cores=None,
               remat_steps: int = REMAT_STEPS, samples: int = 3,
               profile: bool = True) -> dict:
    """One full-width training run through ``launch.train``: weights drawn
    on the card, ``steps`` bf16 steps under remat "full"
    (``--checkpoint-every 0``: smollm-360m's restart runs check the
    checkpoint), between a reset and a read of the launch counts (equal to
    ``_train_counts``); every loss and grad norm finite and the loss
    falling; peak device memory; a "step" line (host call to device
    finish over ``samples`` steps, device busy, the port's kernels, with
    ``cores`` the recurrent cores' device time alone at the step's shapes,
    ``cores(cfg, b, t)``); then ``remat_steps`` steps each under remat
    "block" and "full" (``_remat_runs``).  Without ``profile`` the run
    stops after its launch counts: no step line, cores or remat runs.
    Returns the run's launch counts."""
    import tempfile
    import torch
    from repro_torch import configs, tree
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.kernels import dispatch
    from repro_torch.launch import train
    from repro_torch.training.train_step import make_train_step
    argv = argv + TRAIN_128_ARGS + ["--steps", str(steps),
                                    "--checkpoint-every", "0"]
    args = train.parse_args(argv)
    held = _reset_peak()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dispatch.reset_launch_counts()
        params, opt, hist, run = _train(argv, tmp)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    cfg = run.model
    n_params = sum(p.numel() for p in tree.leaves(params))
    depth = configs.get(cfg.name).num_layers
    print(f"train {name}: {cfg.dtype}, {cfg.num_layers} of {depth} "
          f"layers at full width (d_model {cfg.d_model}, "
          f"{_model_what(cfg)}, vocab {cfg.vocab_size}), "
          f"{n_params / 1e9:.3f}e9 parameters drawn on the card, "
          f"{args.steps} steps of {args.global_batch} x {args.seq_len} "
          f"tokens, remat {cfg.remat}; peak device memory {peak:.2f} "
          f"GiB over the {held / 2**30:.2f} held before it; {wall:.1f}s "
          f"in all (draw and steps; no checkpoint: phase 6's restart "
          f"runs check it), steps {sum(h['dt'] for h in hist):.1f}s")
    print(_train_line(name, hist, args))
    losses = [h["loss"] for h in hist]
    if not losses[-1] < losses[0]:
        _fail(f"train {name}: the loss did not fall: {losses}")
    want = _train_counts(cfg, len(hist))
    if counts != want:
        _fail(f"train {name}: launches {counts}, remat 'full' implies "
              f"{want}")
    live = {k: v for k, v in counts.items() if v}
    n = _attn_layers(cfg)
    print(f"train {name} launches: {live} = per step {2 * n} forward "
          f"(forward + recomputation), {n} dq, {n} dk/dv"
          + (f", {2 * n} router" if cfg.moe else "")
          + f" over {len(hist)} steps ({n} attention layers)")
    if not profile:
        return counts
    # the "step" line: one more step of the trained state
    step_fn = make_train_step(run)
    batch = SyntheticDataset(SyntheticConfig(
        cfg.real_vocab_size or cfg.vocab_size, args.seq_len,
        args.global_batch, seed=run.seed)).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    state = [params, opt]

    def train_step():
        state[0], state[1], _ = step_fn(state[0], state[1], batch)

    t0 = time.perf_counter()
    line, busy, by = _step_line(
        f"train step {name} [{args.global_batch} x {args.seq_len} "
        f"tokens, {cfg.num_layers} layers, bf16, remat full]",
        train_step, samples=samples, warmup=min(samples, 2),
        reps=min(samples, 2))
    took = time.perf_counter() - t0
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    launches = sum(k for _, k in by.values())
    print(line + f"; {launches:g} kernel launches; by kernel: " + ", ".join(
        f"{k} {ms:.2f}ms x{n:.0f}" for k, (ms, n) in top)
        + f" (measured in {took:.1f}s)")
    if cores is not None:
        t0 = time.perf_counter()
        _, _, by_cores = _device_ms(lambda: cores(cfg, args.global_batch,
                                                  args.seq_len), reps=1)
        took = time.perf_counter() - t0
        core_ms = sum(ms for ms, _ in by_cores.values())
        print(f"step train step {name}: the recurrent cores alone "
              f"({', '.join(RECURRENT_CORES)} at the step's shapes, each "
              f"layer's forward twice and its backward): {core_ms:.3f}ms "
              f"device over {sum(k for _, k in by_cores.values()):g} "
              f"launches, {100 * core_ms / busy:.1f}% of the step's device "
              f"busy (measured in {took:.1f}s)")
    del params, opt, state, step_fn
    torch.cuda.empty_cache()
    _remat_runs(run, args, name, remat_steps)
    return counts


def phase_train_128() -> dict:
    """The head_dim-128 models and the MLA decoder trained through
    ``launch.train`` at full width (``TRAIN_128``; minicpm3-4b's attention
    through the training kernels' (96, 64) instances), ``TRAIN_128_STEPS``
    steps each (``_train_run``; writing these 24.3 / 18.3 GB checkpoints
    took most of the runs' time, so none is written).  Returns {run:
    launch counts}."""
    return {key: _train_run(name, key, flags, TRAIN_128_STEPS)
            for name, key, flags in TRAIN_128}


def phase_train_state() -> dict:
    """The recurrent decoders trained through ``launch.train`` at full
    width (``TRAIN_STATE``): zamba2-1.2b at 20 of its 38 Mamba2 layers
    with its shared block called 4 times (rows 6 and 7 at D 64, G 1: 8
    forward, 4 dq and 4 dk/dv launches a step) and xlstm-125m at its full
    12 layers (no attention kernel), ``TRAIN_STATE_STEPS`` steps each and
    ``REMAT_STATE_STEPS`` under each remat policy (``_train_run``, one
    step timed on the step line, the recurrent cores' device time alone
    beside it, ``_train_cores``; xlstm's run stops after its counts).
    Returns {run: launch counts}."""
    return {key: _train_run(name, key, flags, TRAIN_STATE_STEPS,
                            cores=_train_cores,
                            remat_steps=REMAT_STATE_STEPS, samples=1,
                            profile=profile)
            for name, key, flags, profile in TRAIN_STATE}


def _train_cores(cfg, b: int, t: int) -> None:
    """The recurrent cores of one train step under remat "full", alone,
    at batch ``b`` and ``t`` tokens: each layer's forward twice (the
    forward, then its recomputation in the backward) and its backward,
    on stand-in bf16 activations of the step's shapes: every Mamba2
    layer's three convs and its chunked scan, every mLSTM layer's conv
    and chunked form, every sLSTM layer's scan."""
    import torch
    from repro_torch.models import ssm, transformer, xlstm
    dev, bf16 = "cuda", torch.bfloat16
    counts = transformer.layer_counts(cfg)

    def leaf(shape, dtype=bf16, scale=0.1):
        return (torch.randn(shape, device=dev) * scale).to(dtype)

    def fwd_bwd(fn, *args):
        with torch.no_grad():
            fn(*args)
        args = [a.detach().requires_grad_(True) for a in args]
        fn(*args).float().sum().backward()

    if cfg.ssm is not None:
        sc = cfg.ssm
        inner = sc.expand * cfg.d_model
        h, n = inner // sc.head_dim, sc.d_state
        x, bc = leaf((b, t, inner)), leaf((b, t, n))
        w_x, w_n = leaf((inner, sc.d_conv), torch.float32), \
            leaf((n, sc.d_conv), torch.float32)
        dtv = torch.full((b, t, h), 0.01, device=dev)
        a = torch.zeros(h, device=dev)
        xh = x.reshape(b, t, h, sc.head_dim)
        for _ in range(counts["mamba"]):
            fwd_bwd(lambda u, w: ssm.causal_conv(u, w)[0], x, w_x)
            for _ in ("conv_b", "conv_c"):
                fwd_bwd(lambda u, w: ssm.causal_conv(u, w)[0], bc, w_n)
            fwd_bwd(lambda u, d_, bb, cc: ssm.ssd_chunked(
                u, d_, a, bb, cc, a, chunk=sc.chunk)[0], xh, dtv, bc, bc)
        return
    xc = cfg.xlstm
    inner, hh, d = xc.expand * cfg.d_model, xc.num_heads, cfg.d_model
    q = leaf((b, t, hh, inner // hh))
    g = torch.zeros((b, t, hh), device=dev)
    xm, w = leaf((b, t, inner)), leaf((inner, xc.conv_width), torch.float32)
    for _ in range(counts.get("mlstm", 0)):
        fwd_bwd(lambda u, ww: ssm.causal_conv(u, ww)[0], xm, w)
        fwd_bwd(lambda qq, kk, vv, ig, fg: xlstm.mlstm_chunked(
            qq, kk, vv, ig, fg, chunk=xc.chunk)[0], q, q, q, g, g)
    gx = leaf((b, t, 4, d), torch.float32)
    r = leaf((4, hh, d // hh, d // hh), torch.float32)
    for _ in range(counts.get("slstm", 0)):
        fwd_bwd(lambda gg, rr: xlstm.slstm_scan(gg, rr, num_heads=hh)[0],
                gx, r)


# ---------------------------------------------------------------------------
# 6b: the encoder-decoder and the VLM trained through training.train_step
# ---------------------------------------------------------------------------
# whisper-small at full width and depth (12 + 12 layers): WHISPER_TRAIN's
# steps of B x WHISPER_TRAIN_T tokens beside frames [B, 1536, 768] bf16
# (the dry-run's batch), then a step line over its samples
WHISPER_TRAIN = dict(batch=8, steps=2, samples=2)
# llava-next-34b at full width and LLAVA_TRAIN_LAYERS of its 60 layers
# (2.08e9 parameters, ~25 GB with the gradients and AdamW's fp32 moments):
# one sequence of 256 tokens behind the 2880 patch embeddings [1, 2880,
# 7168] bf16, T' = 3136
LLAVA_TRAIN_LAYERS = 2
LLAVA_TRAIN = dict(batch=1, steps=2, samples=2)


class _StepBatches:
    """A training stream as ``training.loop.run`` reads it: the CLI's
    synthetic tokens and labels (``SyntheticDataset``) of ``b`` x ``t``
    and, beside them, ``key`` [b, *shape] in ``dtype``, N(0, 1) drawn on
    the card from a generator seeded with the step, so a batch is a pure
    function of its step (the dry-run's frames for an encoder-decoder, the
    patch embeddings for a VLM)."""

    def __init__(self, cfg, b: int, t: int, key: str, shape: tuple, dtype):
        from repro_torch.data.synthetic import (SyntheticConfig,
                                                SyntheticDataset)
        self.b, self.t, self.key, self.shape, self.dtype = (b, t, key, shape,
                                                            dtype)
        self.tokens = SyntheticDataset(SyntheticConfig(
            cfg.real_vocab_size or cfg.vocab_size, t, b))

    def batch(self, step: int) -> dict:
        import torch
        out = self.tokens.batch(step)
        gen = torch.Generator(device="cuda").manual_seed(step)
        out[self.key] = torch.randn((self.b, *self.shape), generator=gen,
                                    device="cuda").to(self.dtype)
        return out


def _loop_train(name: str, key: str, cfg, data, *, steps: int, samples: int,
                what: str) -> dict:
    """``cfg`` trained the way a user trains it through
    ``training.train_step``: ``init_state`` (weights drawn on the card from
    seed 0), then ``make_train_step`` and ``training.loop.run`` for
    ``steps`` bf16 steps over ``data`` (``_StepBatches``), no checkpoint,
    between a reset and a read of the launch counts, which must equal
    ``_train_counts``; every loss and grad norm finite; peak device memory
    over what was held before; then a "step" line over ``samples`` more
    steps (host call to device finish, device busy, the kernels by device
    time).  Returns the launch counts."""
    import dataclasses
    import tempfile
    import types
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig)
    from repro_torch.kernels import dispatch
    from repro_torch.training import loop
    from repro_torch.training.train_step import init_state, make_train_step
    held = _reset_peak()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the training CLI's optimizer and parallel settings
        run = RunConfig(model=cfg, optimizer=OptimizerConfig(
            warmup_steps=20, total_steps=steps),
            parallel=ParallelConfig(), checkpoint_dir=tmp,
            checkpoint_every=0)
        params, opt = init_state(run, device="cuda")
        torch.cuda.synchronize()
        drawn = time.perf_counter() - t0
        step = make_train_step(run)
        dispatch.reset_launch_counts()
        params, opt, hist = loop.run(run, steps=steps, train_step=step,
                                     params=params, opt_state=opt,
                                     dataset=data, log=lambda *_: None)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    n_params = sum(p.numel() for p in tree.leaves(params))
    extra = data.batch(0)[data.key]
    print(f"train {name}: {cfg.dtype}, {what}, {n_params / 1e9:.3f}e9 "
          f"parameters drawn on the card in {drawn:.1f}s; {steps} steps "
          f"through make_train_step + training.loop.run of {data.b} x "
          f"{data.t} tokens with {data.key} {list(extra.shape)} "
          f"{str(extra.dtype)[6:]} beside them, remat {cfg.remat}; peak "
          f"device memory {peak:.2f} GiB over the {held / 2**30:.2f} held "
          "before it")
    print(_train_line(name, hist, types.SimpleNamespace(
        steps=steps, global_batch=data.b, seq_len=data.t)))
    want = _train_counts(cfg, len(hist))
    if counts != want:
        _fail(f"train {name}: launches {counts}, remat 'full' implies "
              f"{want}")
    per = {k: v // len(hist) for k, v in counts.items() if v}
    print(f"train {name} launches: {per} a step over {len(hist)} steps, as "
          f"remat 'full' implies ({want['flash_attention_bwd_dq'] // steps} "
          "attention calls a step, each a forward, its recomputation, a dq "
          "and a dk/dv launch)")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch(0).items()}
    state = [params, opt]

    def train_step():
        state[0], state[1], _ = step(state[0], state[1], batch)

    t0 = time.perf_counter()
    line, busy, by = _step_line(
        f"train step {name} [{data.b} x {data.t} tokens + {data.key}, "
        f"bf16, remat full]", train_step, samples=samples, warmup=1, reps=1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:8]
    print(line + f"; {sum(n for _, n in by.values()):g} kernel launches; "
          "by kernel: " + ", ".join(f"{k} {ms:.2f}ms x{n:.0f}"
                                    for k, (ms, n) in top)
          + f" (measured in {time.perf_counter() - t0:.1f}s)")
    del params, opt, state, step, batch
    torch.cuda.empty_cache()
    return {key: counts}


def phase_train_whisper() -> dict:
    """whisper-small at full width and depth (12 + 12 layers, bf16)
    trained through ``training.train_step`` (``_loop_train``) over
    ``WHISPER_TRAIN``'s batches of tokens and frames [B, 1536, 768]: on the
    card its encoder's self-attention runs rows 6 / 7 non-causal over 1536
    frames, its decoder's causal over ``WHISPER_TRAIN_T`` tokens and its
    cross-attention non-causal at Tq 256 over Tk 1536: 36 forward, 36 dq
    and 36 dk/dv launches, twice the forwards.  Returns {"whisper train":
    launch counts}."""
    import torch
    from repro_torch import configs
    cfg = configs.get("whisper_small")
    data = _StepBatches(cfg, WHISPER_TRAIN["batch"], WHISPER_TRAIN_T,
                        "frames", (cfg.encoder_seq_len, cfg.d_model),
                        torch.bfloat16)
    return _loop_train(
        "whisper-small", "whisper train", cfg, data,
        steps=WHISPER_TRAIN["steps"], samples=WHISPER_TRAIN["samples"],
        what=f"{cfg.encoder_layers} + {cfg.num_layers} layers at full width "
             f"(d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
             f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
             f"{cfg.vocab_size}, tied head)")


def phase_train_llava() -> dict:
    """llava-next-34b at full width and ``LLAVA_TRAIN_LAYERS`` of its 60
    layers (bf16) trained through ``training.train_step``
    (``_loop_train``) over one sequence of 256 tokens behind its 2880
    patch embeddings [1, 2880, 7168] (T' 3136): rows 6 / 7 causal at T
    3136, 56/8 heads of 128 (G 7), the patch positions dropped before the
    CE.  Returns {"llava train": launch counts}."""
    import torch
    from repro_torch import configs
    cfg = configs.get("llava_next_34b")
    depth = cfg.num_layers
    cfg = cfg.replace(num_layers=LLAVA_TRAIN_LAYERS)
    data = _StepBatches(cfg, LLAVA_TRAIN["batch"],
                        LLAVA_TRAIN_T - cfg.num_patches, "patch_embeds",
                        (cfg.num_patches, cfg.d_model), torch.bfloat16)
    return _loop_train(
        "llava-next-34b", "llava train", cfg, data,
        steps=LLAVA_TRAIN["steps"], samples=LLAVA_TRAIN["samples"],
        what=f"{cfg.num_layers} of {depth} layers at full width (d_model "
             f"{cfg.d_model}, {_model_what(cfg)}, vocab {cfg.vocab_size}, "
             f"untied head, mm_proj [{cfg.d_model}, {cfg.d_model}]), "
             f"T' {LLAVA_TRAIN_T}")


def _reset_peak() -> int:
    """Free what no longer has a reference (checkpoint frames can sit in
    reference cycles until the collector runs) and reset the device's peak
    memory statistic: returns the bytes still allocated, which the peak
    read after a run includes."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


# ---------------------------------------------------------------------------
# 7: fp32 training parity at full width: kernels on the card vs the CPU
# ---------------------------------------------------------------------------
def _train_parity(cfg, params_cuda, params_cpu, what: str,
                  shape=TRAIN_PARITY, extra=None) -> None:
    """Loss (``train_step.loss_for(cfg)``) and every gradient of one fp32
    batch (``shape``'s tokens and labels, and ``extra``'s CPU tensors: an
    encoder-decoder's frames, a VLM's patch embeddings) of ``cfg`` on the
    card (kernels) and on the CPU (plain versions), from the same weights.
    The loss within 1e-5 relative; each gradient leaf within 1e-4 of its
    largest entry (fp32 sums in other orders on the two devices, through
    the wide head).  An MoE model's router must pick and keep the same
    assignments on both devices in every layer (the forward and its
    recomputation): a near-tie that flips one fails with the logit gap
    that decided it."""
    import torch
    from repro_torch import tree
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.models import layers as L
    from repro_torch.training.train_step import loss_for
    batch = SyntheticDataset(SyntheticConfig(
        cfg.real_vocab_size or cfg.vocab_size, shape["seq_len"],
        shape["batch"])).batch(0)
    batch.update(extra or {})
    out, routes = {}, {}
    real_route = L.moe_route
    for device, params in (("cuda", params_cuda), ("cpu", params_cpu)):
        params = tree.map(lambda p: p.detach().requires_grad_(True), params)
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        seen = routes[device] = []

        def recording(p, xg, c, seen=seen):
            r = real_route(p, xg, c)
            seen.append((r.idx.cpu(), r.keep.cpu(), r.logits.detach().cpu()))
            return r

        L.moe_route = recording
        t0 = time.perf_counter()
        loss, _ = loss_for(cfg)(params, b, cfg)
        grads = torch.autograd.grad(loss, tree.leaves(params))
        out[device] = (loss.item(), [g.cpu() for g in grads])
        L.moe_route = real_route
        print(f"train parity {what} {device}: loss {out[device][0]:.6f} in "
              f"{time.perf_counter() - t0:.1f}s")
    for i, ((ig, kg, _), (ic, kc, lc)) in enumerate(zip(routes["cuda"],
                                                       routes["cpu"])):
        if torch.equal(ig.long(), ic.long()) and torch.equal(kg, kc):
            continue
        bad = (ig.long() != ic.long()).any(-1) | (kg != kc).any(-1)
        g_, s_ = (int(x) for x in bad.nonzero()[0])
        top = lc[g_, s_].sort(descending=True).values
        k = ic.shape[-1]
        gap = (top[k - 1] - top[k]).item() if k < top.numel() else 0.0
        _fail(f"train parity {what}: router call {i} (layers in order, "
              f"then their recomputation in reverse) picks "
              f"{ig[g_, s_].tolist()} / keeps {kg[g_, s_].tolist()} on the "
              f"card, {ic[g_, s_].tolist()} / {kc[g_, s_].tolist()} on the "
              f"CPU for token {s_} of group {g_}: logit gap between its "
              f"k-th and (k+1)-th expert {gap:.3g}")
    if len(routes["cuda"]) != len(routes["cpu"]):
        _fail(f"train parity {what}: {len(routes['cuda'])} router calls on "
              f"the card, {len(routes['cpu'])} on the CPU")
    rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, where = 0.0, ""
    paths = [p for p, _ in tree.leaves_with_path(params_cpu)]
    for path, a, b in zip(paths, out["cuda"][1], out["cpu"][1]):
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if err > worst:
            worst, where = err, path
    if rel > 1e-5 or worst > 1e-4:
        _fail(f"train parity {what}: loss rel diff {rel:.3g} (1e-5), "
              f"gradient {where} rel diff {worst:.3g} (1e-4)")
    kept = sum(int(kc.sum()) for _, kc, _ in routes["cpu"])
    router = (f"; router: {len(routes['cpu'])} calls (forward and "
              f"recomputation), the same {kept} kept assignments on both "
              "devices" if routes["cpu"] else "")
    if cfg.mla is not None:
        mla = [p for p in paths if p.rsplit("/", 1)[-1] in MLA_LEAVES]
        if len(mla) != len(MLA_LEAVES) * cfg.num_layers:
            _fail(f"train parity {what}: MLA leaves {mla}")
        router += f"; the {len(mla)} MLA leaves among them"
    if "mm_proj" in paths:
        router += "; mm_proj among them"
    inputs = "".join(f" + {k} {list(v.shape)}" for k, v in (extra or
                                                            {}).items())
    print(f"train parity {what}: fp32 {cfg.num_layers} layers full width, "
          f"batch {shape['batch']} x {shape['seq_len']}{inputs}: loss "
          f"rel diff {rel:.3g} (tol 1e-5); worst gradient leaf {where} max "
          f"abs diff {worst:.3g} of its largest entry (tol 1e-4) over "
          f"{len(paths)} leaves{router}")


# the MLA attention's own leaves (``models/layers.mla_init``)
MLA_LEAVES = ("wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv")


def phase_train_parity() -> None:
    """``_train_parity`` of smollm-360m at full width cut to
    ``TRAIN_PARITY``'s 2 layers, weights drawn on the CPU."""
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get("smollm_360m").replace(
        num_layers=TRAIN_PARITY["layers"], dtype="float32")
    params_cpu = transformer.init(cfg, seed=2, device="cpu")
    _train_parity(cfg, transformer.params_to(params_cpu, "cuda"), params_cpu,
                  cfg.name)


def phase_train_parity_128() -> None:
    """``_train_parity`` of mistral-nemo-12b, qwen2-moe-a2.7b and
    minicpm3-4b at full width cut to ``TRAIN_PARITY_BATCH_128``'s 1 layer
    and one sequence: weights drawn on the card from seed 2 (a CPU draw of
    ~1.9e9 weights takes 12-15 s) and copied to the CPU; qwen2-moe's router
    gradient and minicpm3's MLA leaves (the low-rank q, the latent and
    rope-key projections, W_uk and W_uv, the two norms) among the leaves,
    its attention through the fp32 (96, 64) instances."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    shape = TRAIN_PARITY_BATCH_128
    for arch in TRAIN_PARITY_128:
        cfg = configs.get(arch).replace(num_layers=shape["layers"],
                                        dtype="float32")
        params_cuda = transformer.init(cfg, seed=2, device="cuda",
                                       draw_device="cuda")
        _train_parity(cfg, params_cuda,
                      transformer.params_to(params_cuda, "cpu"), cfg.name,
                      shape)
        del params_cuda
        torch.cuda.empty_cache()


def phase_train_parity_state() -> None:
    """``_train_parity`` of the recurrent decoders at full width and cut
    depth (``TRAIN_PARITY_STATE``), one sequence of 256 tokens: weights
    drawn on the card from seed 2 and copied to the CPU; the Mamba2 convs,
    SSD leaves and the shared block (zamba2, two calls, rows 6 and 7 at D
    64, G 1 on the card in fp32), the mLSTM and sLSTM gates and recurrent
    weights (xlstm) among the gradients."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    for arch, layers in TRAIN_PARITY_STATE:
        cfg = configs.get(arch).replace(num_layers=layers, dtype="float32")
        params_cuda = transformer.init(cfg, seed=2, device="cuda",
                                       draw_device="cuda")
        _train_parity(cfg, params_cuda,
                      transformer.params_to(params_cuda, "cpu"),
                      f"{cfg.name} ({layers} layers)",
                      dict(layers=layers, **TRAIN_PARITY_BATCH_STATE))
        del params_cuda
        torch.cuda.empty_cache()


def phase_train_parity_whisper() -> None:
    """``_train_parity`` of whisper-small at full width cut to 2 + 2
    layers (``WHISPER_PARITY_LAYERS``), one sequence of 64 tokens beside
    frames [1, 1536, 768] fp32: weights drawn on the card from seed 2 and
    copied to the CPU; the adapter, the encoder (rows 6 / 7 non-causal at T
    1536 in fp32 on the card) and the cross-attention (Tq 64 over Tk 1536)
    among the gradients."""
    import torch
    from repro_torch import configs
    from repro_torch.models import encdec, transformer
    cfg = configs.get("whisper_small").replace(
        num_layers=WHISPER_PARITY_LAYERS,
        encoder_layers=WHISPER_PARITY_LAYERS, dtype="float32")
    params_cuda = encdec.init(cfg, seed=2, device="cuda", draw_device="cuda")
    frames = torch.randn((1, cfg.encoder_seq_len, cfg.d_model),
                         generator=torch.Generator().manual_seed(4))
    _train_parity(cfg, params_cuda, transformer.params_to(params_cuda, "cpu"),
                  f"{cfg.name} (2 + 2 layers)",
                  dict(layers=WHISPER_PARITY_LAYERS, batch=1, seq_len=64),
                  extra={"frames": frames})
    del params_cuda
    torch.cuda.empty_cache()


# phase 7's fp32 parity of llava-next-34b: full width, 1 layer, and 64
# patch embeddings in place of 2880 (the CPU's time: its forward and
# backward over every patch position)
LLAVA_PARITY = dict(layers=1, patches=64, batch=1, seq_len=128)


def phase_parity_llava() -> None:
    """llava-next-34b in fp32 at full width, ``LLAVA_PARITY``'s 1 layer and
    64 patches (weights drawn on the card from seed 1, copied to the CPU),
    card against CPU: a forward of 128 tokens behind the patches
    (``_forward_parity``: hidden states and last logits within
    ``STATE_PARITY_RTOL`` of scale); the lockstep parity workload
    (``LOCKSTEP_PARITY_ARGS``: B 2, 37-token prompts behind the CLI's
    seeded patches, 8 tokens) under the same injected Gumbel draws, token
    streams identical; then ``_train_parity``'s loss and gradients, with a
    patch batch, ``mm_proj``'s among them."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    shape = LLAVA_PARITY
    cfg = configs.get("llava_next_34b").replace(
        num_layers=shape["layers"], num_patches=shape["patches"],
        dtype="float32")
    what = f"{cfg.name} ({shape['layers']} layer, {cfg.num_patches} patches)"
    t0 = time.perf_counter()
    params_cuda = transformer.init(cfg, seed=1, device="cuda",
                                   draw_device="cuda")
    params_by_device = {"cuda": params_cuda,
                        "cpu": transformer.params_to(params_cuda, "cpu")}
    print(f"parity {what}: {_weight_bytes(params_cuda) // 4} weights drawn "
          f"on the card and copied to the CPU in "
          f"{time.perf_counter() - t0:.1f}s")
    gen = torch.Generator().manual_seed(6)
    patches = torch.randn((shape["batch"], cfg.num_patches, cfg.d_model),
                          generator=gen)
    _forward_parity(what, cfg, params_by_device,
                    (shape["batch"], shape["seq_len"]), patches)
    args = LLAVA + LOCKSTEP_PARITY_ARGS
    draws = np.random.default_rng(7).gumbel(
        size=(8, 2, 5)).astype(np.float32)
    ids = {device: serve.lockstep(
               serve.parse_args(args + ["--device", device]), cfg, params,
               noise_fn=lambda step: draws[step])
           for device, params in params_by_device.items()}
    if not np.array_equal(ids["cuda"], ids["cpu"]):
        _fail(f"parity {what} lockstep: token ids differ\ncuda "
              f"{ids['cuda']}\ncpu  {ids['cpu']}")
    print(f"parity {what} lockstep: {ids['cpu'].size} token ids identical "
          f"under the same injected Gumbel draws (B 2, 37-token prompts "
          f"behind {cfg.num_patches} patches, 8 tokens)")
    _train_parity(cfg, params_cuda, params_by_device["cpu"], what,
                  dict(layers=shape["layers"], batch=shape["batch"],
                       seq_len=shape["seq_len"]),
                  extra={"patch_embeds": patches})
    del params_by_device, params_cuda
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 8: times at the serving and training paths' shapes
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# 7b: the distributed layer at world size 1 (NCCL)
# ---------------------------------------------------------------------------
# row 4's lse form at smollm-360m's decode batch (B 8 over 328, 15/5 heads
# of 64), at D 128 (32/8 heads) and in its int8 form; every shape has a row
# at vlen 0 (an lse of -inf) and rows short enough that some of the 2, 4
# and 8 cache slices of the merge check lie wholly past them
LSE_VLENS = [328, 0, 1, 17, 41, 100, 250, 327]
LSE_S = 328
LSE_CASES = (("smollm", "fp", 5, 3, 64), ("d128", "fp", 8, 4, 128),
             ("smollm", "int8", 5, 3, 64))
MERGE_SLICES = (2, 4, 8)
# the lockstep path under the (1, 1) mesh's context: smollm-360m at full
# width and SMOLLM_LAYERS layers, the lockstep run of phase 4 (B 4, 32
# tokens), fp K/V and then int8
DIST_LOCKSTEP_ARGS = LOCKSTEP_ARGS
# ``launch.train --mesh 1x1``, 3 steps of phase 6's run (its warmup of 20
# steps makes the first 3 steps' schedule that of its 10): the losses
# beside phase 6's first 3
DIST_TRAIN_ARGS = ["--arch", "smollm_360m", "--steps", "3", "--seq-len",
                   "512", "--global-batch", "8", "--checkpoint-every", "0",
                   "--mesh", "1x1"]


def _nccl_world():
    """A world of 1 under NCCL through a FileStore (no network), and the
    (data 1, model 1) mesh on the card.  Returns (mesh, the store's
    directory)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    d = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(d, "store"), 1), rank=0, world_size=1)
    if dist.get_backend() != "nccl":
        _fail(f"distributed: backend {dist.get_backend()}, not nccl")
    return mesh_mod.make_debug_mesh(1, 1, device_type="cuda"), d


def _lse_inputs(gen, kind: str, hkv: int, g: int, d: int, dtype):
    """(kernel operands, plain operands) at ``LSE_VLENS``: q and caches
    with NaN (int8: ±127 and NaN scales) past each row's vlen for the
    kernel, zeros for the plain version."""
    import torch
    if kind != "int8":
        q, k, v, k0, v0 = _contiguous_inputs(gen, dtype=dtype, s=LSE_S,
                                             vlens=LSE_VLENS, hkv=hkv, g=g,
                                             d=d)
        return (q, k, v, {}), (q, k0, v0, {})
    q = torch.randn(len(LSE_VLENS), 1, hkv * g, d, generator=gen).to(
        device="cuda", dtype=dtype)
    kern = _int8_contiguous_inputs(gen, s=LSE_S, vlens=LSE_VLENS, hkv=hkv,
                                   d=d)
    return ((q, kern[0], kern[1], dict(k_scale=kern[2], v_scale=kern[3])),
            (q, kern[4], kern[5], dict(k_scale=kern[6], v_scale=kern[7])))


def _check_lse(gen) -> dict:
    """Rows 4 and 4q with their lse against the plain version's, fp32 and
    bf16, and the ⊕ of 2, 4 and 8 cache slices (each row 4 with its lse,
    merged by ``merge_partials``) against row 4 over the whole cache.
    Returns {JSON name: fp32 max abs error}."""
    import torch
    from repro_torch.distributed.decode_attention import merge_partials
    from repro_torch.kernels import flash_decode as fd
    vl = torch.tensor(LSE_VLENS, dtype=torch.int32, device="cuda")
    errs = {"flash_decode_lse": 0.0, "flash_decode_int8_lse": 0.0}
    for name, kind, hkv, g, d in LSE_CASES:
        key = "flash_decode_int8_lse" if kind == "int8" else \
            "flash_decode_lse"
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            (q, k, v, sc), (_, k0, v0, sc0) = _lse_inputs(gen, kind, hkv, g,
                                                          d, dtype)
            out, lse = fd.flash_decode(q, k, v, vl, return_lse=True, **sc)
            again = fd.flash_decode(q, k, v, vl, **sc)
            torch.cuda.synchronize()
            want, want_lse = fd.flash_decode_plain(q, k0, v0, vl,
                                                   return_lse=True, **sc0)
            dead = vl == 0
            if not (torch.isneginf(lse[dead]).all()
                    and torch.isfinite(lse[~dead]).all()
                    and (out[dead] == 0).all()):
                _fail(f"{key} {name} {dtype}: vlen 0 must give out 0 and "
                      "lse -inf, the others a finite lse")
            if not torch.equal(out, again):
                _fail(f"{key} {name} {dtype}: the lse form's output differs "
                      "from the plain launch's")
            lse_err = ((lse[~dead] - want_lse[~dead]).abs()
                       / want_lse[~dead].abs().clamp_min(1.0)).max().item()
            err = _scaled_err(out, want, absolute=True)
            if not (lse_err <= 1e-5 and err <= atol):
                _fail(f"{key} {name} {dtype}: lse err {lse_err:.3g} (> "
                      f"1e-5) or output err {err:.3g} (> {atol})")
            worst = 0.0
            for n in MERGE_SLICES:
                step = -(-LSE_S // n)
                outs, lses = [], []
                for i in range(n):
                    cut = slice(i * step, min((i + 1) * step, LSE_S))
                    o, l = fd.flash_decode(
                        q, k[:, cut], v[:, cut],
                        (vl - i * step).clamp(0, step), return_lse=True,
                        **{s: t[:, cut] for s, t in sc.items()})
                    outs.append(o)
                    lses.append(l)
                got = merge_partials(torch.stack(outs), torch.stack(lses))
                m_err = _scaled_err(got, out, absolute=True)
                if not m_err <= atol:
                    _fail(f"{key} {name} {dtype}: the ⊕ of {n} slices is "
                          f"{m_err:.3g} from the whole cache (> {atol})")
                worst = max(worst, m_err)
            if dtype == torch.float32:
                errs[key] = max(errs[key], err)
            print(f"distributed {key} {name} {str(dtype)[6:]} B=8 S={LSE_S} "
                  f"{hkv * g}/{hkv} D={d} vlen {LSE_VLENS}: lse err "
                  f"{lse_err:.3g} (1e-5), out err {err:.3g} ({atol}), vlen "
                  f"0 → (0, -inf); ⊕ of {'/'.join(map(str, MERGE_SLICES))} "
                  f"slices vs whole cache {worst:.3g} ({atol})")
    return errs


def _dist_lockstep(what: str, argv, cfg, params, ctx, noise) -> tuple:
    """The lockstep loop of ``argv`` unsharded, then under ``ctx`` between
    a reset and a read of the launch counts, both with ``noise``; the
    tokens must be identical and the sharded run's launches one lse-form
    decode a layer and step and one row 1 a token.  Returns the counts."""
    import torch
    from repro_torch.distributed import context
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    cfg = cfg.replace(kv_cache_dtype=args.kv_cache_dtype)
    want_ids = serve.lockstep(args, cfg, params, noise_fn=noise)
    dispatch.reset_launch_counts()
    with context.use(ctx):
        ids = serve.lockstep(args, cfg, params, noise_fn=noise)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    if not (ids == want_ids).all():
        _fail(f"{what}: tokens under the context differ from the unsharded "
              "run's")
    dec = ("flash_decode_int8_lse" if args.kv_cache_dtype
           else "flash_decode_lse")
    want = dict.fromkeys(COUNTERS, 0)
    want.update({"softmax_topk": args.tokens,
                 "flash_attention_offset": cfg.num_layers,
                 dec: (args.tokens - 1) * cfg.num_layers})
    if counts != want:
        _fail(f"{what}: launches {counts}, its steps imply {want}")
    print(f"{what}: {args.batch} x {args.tokens} tokens, {cfg.num_layers} "
          f"layers, tokens identical to the unsharded run; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return counts


def _dist_train(unsharded: list) -> None:
    """``launch.train --mesh 1x1`` beside the same steps of phase 6's run
    (``unsharded``, its losses): the first loss bit-equal, the later within
    1e-4 relative.  The run goes through the model axis's code with a
    group of one (heads mode, every f / g an NCCL all-reduce over one
    rank): its launches of rows 6 / 7 are the unsharded run's, and it
    makes ``_model_axis_collectives`` all-reduces a step, no all-gather."""
    import tempfile
    import torch
    from repro_torch.distributed import tensor_parallel
    from repro_torch.kernels import dispatch
    dispatch.reset_launch_counts()
    tensor_parallel.reset_collectives()
    with tempfile.TemporaryDirectory() as tmp:
        _, _, mesh, run = _train(DIST_TRAIN_ARGS, tmp)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    coll = dict(tensor_parallel.collectives)
    a = unsharded[:3]
    b = [h["loss"] for h in mesh]
    if len(a) != 3 or len(b) != 3 or a[0] != b[0] or any(
            abs(x - y) > 1e-4 * abs(x) for x, y in zip(a, b)):
        _fail(f"train --mesh 1x1: losses {b}, unsharded {a}")
    want = _train_counts(run.model, 3)
    want_coll = {"all_reduce": 3 * _model_axis_collectives(run.model),
                 "all_gather": 0}
    if counts != want or coll != want_coll:
        _fail(f"train --mesh 1x1: launches {counts} (want {want}), model-"
              f"group collectives {coll} (want {want_coll})")
    print(f"distributed train --mesh 1x1 (NCCL, {DIST_TRAIN_ARGS[1]} at 32 "
          f"layers, 8 x 512, the model axis in heads mode over one rank): "
          f"losses {b}, unsharded {a}; "
          + ("bit-equal at every step" if a == b
             else "first bit-equal, later within 1e-4")
          + f"; launches over 3 steps "
          f"{ {k: v for k, v in counts.items() if v} }, model-group "
          f"collectives {coll}")


def _model_axis_collectives(cfg) -> int:
    """A dense decoder's model-group all-reduces a step in heads mode with
    every leaf sharded (a group of one), under remat "full": a layer's two
    g's (attention's and the MLP's output) in the forward, attention's
    again in its recomputation (which stops at the last tensor the
    backward needs, before the MLP's), and its two f's (their inputs) in
    the backward; the embedding's g; the cross-entropy's three in the
    forward (max, sum, label) and dh's in the backward; the clipping
    norm's one."""
    return 5 * cfg.num_layers + 1 + 4 + 1


def phase_distributed(serve_ctx, train_ctx) -> tuple:
    """The distributed layer on the card at world size 1 under NCCL: rows
    4 and 4q with their lse, the ⊕ of cache slices through the real kernel,
    the lockstep path under the (1, 1) mesh's context (fp and int8 K/V),
    ``launch.train --mesh 1x1`` beside phase 6's run and the times of row
    4 with and without its lse and of the merge's three collectives.
    Returns (launch counts by path, errors, time rows)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import context
    from repro_torch.distributed.decode_attention import merge_collective
    from repro_torch.kernels import flash_decode as fd
    mesh, store_dir = _nccl_world()
    try:
        gen = torch.Generator().manual_seed(31)
        errs = _check_lse(gen)
        ctx = context.ShardContext(mesh=mesh, par=ParallelConfig())
        noise_gen = torch.Generator().manual_seed(4)
        draws = [torch.empty(4, 5).exponential_(generator=noise_gen).log_()
                 .neg_() for _ in range(32)]
        counts = {}
        for what, argv in (("distributed lockstep", DIST_LOCKSTEP_ARGS),
                           ("distributed lockstep int8",
                            DIST_LOCKSTEP_ARGS + INT8)):
            counts[what] = _dist_lockstep(what, argv, serve_ctx["cfg"],
                                          serve_ctx["params"], ctx,
                                          lambda i: draws[i])
        _dist_train(train_ctx["losses"])
        # times: row 4 with and without its lse at B 8 over 328 (bf16), and
        # the merge's three collectives at world 1 on the host's clock
        rows = {}
        _, _, hkv, g, d = LSE_CASES[0]
        vlens, s = SLOT_DECODE
        for key, kind in (("flash_decode_lse", "fp"),
                          ("flash_decode_int8_lse", "int8")):
            if kind == "fp":
                q, _, _, k, v = _contiguous_inputs(
                    gen, dtype=torch.bfloat16, s=s, vlens=vlens, hkv=hkv,
                    g=g, d=d)
                sc, esz = {}, 2
            else:
                q = torch.randn(len(vlens), 1, hkv * g, d,
                                generator=gen).to("cuda", torch.bfloat16)
                kern = _int8_contiguous_inputs(gen, s=s, vlens=vlens,
                                               hkv=hkv, d=d)
                k, v = kern[4], kern[5]
                sc, esz = dict(k_scale=kern[6], v_scale=kern[7]), 1
            vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
            hq = hkv * g
            nbytes = (2 * q.numel() * 2 + sum(vlens) * hkv * d * esz * 2
                      + (sum(vlens) * hkv * 2 * 2 if sc else 0)
                      + len(vlens) * 4 + len(vlens) * hq * 4)
            b_ms, b_by = _bound(nbytes, 4.0 * hq * d * sum(vlens),
                                "bfloat16")
            args, _ = fd.prepare(q, k, v, vl, return_lse=True, **sc)
            plain_args, _ = fd.prepare(q, k, v, vl, **sc)
            mask = (torch.arange(s, device="cuda")[None, :]
                    < vl[:, None].long())[:, None, None, :]
            kd = k.to(torch.bfloat16) * sc["k_scale"][..., None] if sc else k
            vd = v.to(torch.bfloat16) * sc["v_scale"][..., None] if sc else v
            rows[key] = {
                "ms": _ms(lambda: fd.launch(args)),
                "device_ms": _device_call_ms(lambda: fd.launch(args)),
                "without_lse_device_ms": _device_call_ms(
                    lambda: fd.launch(plain_args)),
                "wrapper_ms": _ms(lambda: fd.flash_decode(
                    q, k, v, vl, return_lse=True, **sc)),
                "plain_ms": _ms(lambda: fd.flash_decode_plain(
                    q, k, v, vl, return_lse=True, **sc)),
                "library_ms": _ms(lambda: _sdpa(q, kd, vd, mask)),
                "library_device_ms": _device_call_ms(
                    lambda: _sdpa(q, kd, vd, mask)),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"B={len(vlens)} S={s} {hq}/{hkv} D={d} bf16 q, "
                         f"{'int8' if sc else 'bf16'} K/V, vlen {vlens}, "
                         f"{_plan_of(fd, q, k)}, with its lse [B, Hq]"}
            print(f"time {key}: device {rows[key]['device_ms']:.4f} ms, "
                  f"without the lse "
                  f"{rows[key]['without_lse_device_ms']:.4f} ms")
        out, lse = fd.flash_decode(q, k, v, vl, return_lse=True, **sc)
        group = context.group(mesh, ("model",))
        merge_ms = _host_ms(lambda: merge_collective(out, lse, group),
                            samples=20)
        print(f"time distributed merge (3 all_reduce, world 1, NCCL, "
              f"[{len(vlens)}, {hkv * g}]): host {merge_ms:.4f} ms a merge")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    return counts, errs, rows


# the model axis in one process: smollm-360m's sequence mode at M 4 (its
# 15 heads do not split 4 ways) over B 8 x T 512, 15/5 heads of 64, and its
# tied head [960, 49152] split into 4 x 12288 columns over 8 x 512 tokens
MODEL_AXIS_M = 4
MODEL_AXIS_ATTN = dict(b=8, t=512, hkv=5, g=3, d=64)
MODEL_AXIS_CE = dict(t=8 * 512, d=960, v=49152, chunks=16)
# the timed rank: the last, Tq 128 at offset 384 over Tk 512
MODEL_AXIS_TAG = "_qoff384"


def _offset_blocks(gen, dtype) -> tuple[dict, dict]:
    """Sequence mode's attention through the real kernels: the M ranks'
    row blocks (``FlashAttention.apply`` at offsets 0 / 128 / 256 / 384
    over keys [0, (r+1)·128)) against one causal launch over all 512 rows,
    forward and backward (``torch.autograd.grad``): the blocks' out and dq
    concatenated, their dK / dV summed (in fp32).  The blocks run between
    a reset and a read of the launch counts.  Returns ({what: error},
    the blocks' launch counts)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import flash_attention as fa
    a = MODEL_AXIS_ATTN
    q, k, v, dout = _fresh_inputs(gen, dtype=dtype, b=a["b"], t=a["t"],
                                  hkv=a["hkv"], g=a["g"], d=a["d"])
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    whole = fa.FlashAttention.apply(qg, kg, vg, True)
    grads = torch.autograd.grad(whole, (qg, kg, vg), dout)
    torch.cuda.synchronize()
    rows = a["t"] // MODEL_AXIS_M
    outs, sums = [], [torch.zeros_like(x, dtype=torch.float32)
                      for x in (q, k, v)]
    dispatch.reset_launch_counts()
    for r in range(MODEL_AXIS_M):
        lo, hi = r * rows, (r + 1) * rows
        o = fa.FlashAttention.apply(qg[:, lo:hi], kg[:, :hi], vg[:, :hi],
                                    True, lo)
        for acc, g in zip(sums, torch.autograd.grad(
                o, (qg, kg, vg), dout[:, lo:hi])):
            acc += g.float()
        outs.append(o.detach())
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    got = (torch.cat(outs, 1), *sums)
    errs = {}
    for name, x, w in zip(("out", "dq", "dk", "dv"), got,
                          (whole.detach(), *grads)):
        if not torch.isfinite(x).all():
            _fail(f"model axis blocks {dtype}: non-finite {name}")
        errs[name] = _scaled_err(x.to(w.dtype) if dtype == torch.float32
                                 else x.to(torch.bfloat16), w)
    return errs, counts


def _vocab_shards(gen) -> dict:
    """Vocabulary-parallel cross-entropy's arithmetic on the card: the M
    shards' ``vocab_shard_stats``, the pure ⊕ (``merge_vocab_partials``)
    and each shard's ``vocab_shard_grads`` from the merged lse, against
    the unsharded ``chunked_cross_entropy`` and its autograd backward, in
    fp32.  Returns {what: max abs error over max(1, largest entry)}."""
    import torch
    from repro_torch.core import cross_entropy as ce
    c = MODEL_AXIS_CE
    t, d, v, m = c["t"], c["d"], c["v"], MODEL_AXIS_M
    h = torch.randn(t, d, generator=gen).cuda()
    w = (torch.randn(d, v, generator=gen) * d ** -0.5).cuda()
    labels = torch.randint(0, v, (t,), generator=gen).cuda()
    dloss = (torch.randn(t, generator=gen) / t).cuda()
    hg, wg = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = ce.chunked_cross_entropy(hg, wg, labels, num_chunks=c["chunks"])
    w_dh, w_dw = torch.autograd.grad(want, (hg, wg), dloss)
    n = v // m
    chunks = math.gcd(c["chunks"], n)
    shards = [w[:, r * n:(r + 1) * n] for r in range(m)]
    stats = [ce.vocab_shard_stats(h, shards[r], labels - r * n, chunks)
             for r in range(m)]
    if {int(x) // n for x in labels.tolist()} != set(range(m)):
        _fail("vocab shards: the labels miss a shard")
    lse, label = ce.merge_vocab_partials(
        *(torch.stack([st[i] for st in stats]) for i in range(3)))
    parts = [ce.vocab_shard_grads(h, shards[r], labels - r * n, lse, dloss,
                                  chunks, 0.0) for r in range(m)]
    dh = sum(p[0] for p in parts)
    dw = torch.cat([p[1] for p in parts], 1)
    torch.cuda.synchronize()
    return {name: _scaled_err(x, y) for name, x, y in (
        ("loss", lse - label, want.detach()), ("dh", dh, w_dh),
        ("dW", dw, w_dw))}


def phase_model_axis() -> tuple:
    """The model axis's shards in one process on the card (one card: NCCL
    takes no two ranks on it, so the collectives ran at world 1 in phase
    9 and at world 4 under gloo in the CPU tests): sequence mode's offset
    blocks through rows 6 / 7 (fp32 within 1e-5, bf16 by
    ``_scaled_err``'s row rule within 2e-2), the vocabulary shards' ⊕ and
    backward (fp32 within 1e-5), then rows 6 and 7 at the last rank's
    offset held against their plain versions in fp32 and timed in bf16,
    with the four ranks' sum.  Returns ({"model axis seq": the bf16
    blocks' launch counts}, {JSON name: fp32 error}, time rows)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    gen = torch.Generator().manual_seed(32)
    counts = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        errs, counts = _offset_blocks(gen, dtype)
        if max(errs.values()) > tol:
            _fail(f"model axis sequence blocks {dtype}: {errs} (> {tol})")
        print(f"model axis sequence mode {str(dtype)[6:]}: {MODEL_AXIS_M} "
              f"blocks of 128 rows at offsets 0/128/256/384 vs one causal "
              f"launch over 512 ({MODEL_AXIS_ATTN}): "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + f" ({tol})")
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention=1, flash_attention_bwd_dq=1,
                flash_attention_bwd_dkv=1,
                flash_attention_qoffset=MODEL_AXIS_M - 1,
                flash_attention_bwd_dq_qoffset=MODEL_AXIS_M - 1,
                flash_attention_bwd_dkv_qoffset=MODEL_AXIS_M - 1)
    if counts != want:
        _fail(f"model axis blocks: launches {counts}, want {want}")
    ce_errs = _vocab_shards(gen)
    if max(ce_errs.values()) > 1e-5:
        _fail(f"model axis vocab shards: {ce_errs} (> 1e-5)")
    c = MODEL_AXIS_CE
    print(f"model axis vocab-parallel CE: {MODEL_AXIS_M} shards of "
          f"{c['v'] // MODEL_AXIS_M} columns of [{c['d']}, {c['v']}] over "
          f"{c['t']} tokens, merged by the pure ⊕, vs the unsharded chunked "
          "CE (fp32): " + ", ".join(f"{k} {e:.3g}" for k, e in
                                    ce_errs.items()) + " (1e-5)")
    # rows 6 / 7 at the last rank's offset: fp32 against the plain
    # versions (the JSON line's errors), then the bf16 times
    a, rows = MODEL_AXIS_ATTN, MODEL_AXIS_ATTN["t"] // MODEL_AXIS_M
    last = (MODEL_AXIS_M - 1) * rows
    q, k, v, dout = _fresh_inputs(gen, dtype=torch.float32, b=a["b"],
                                  t=rows, hkv=a["hkv"], g=a["g"], d=a["d"],
                                  tk=a["t"])
    found = _fresh_errs(q, k, v, dout, True, last)
    if max(found.values()) > 1e-5:
        _fail(f"model axis rows 6/7 at offset {last} (fp32): {found}")
    errs = {kernel + MODEL_AXIS_TAG: e for kernel, e in found.items()}
    times = _train_kernel_times(gen, a["hkv"], a["g"], a["d"],
                                MODEL_AXIS_TAG, t=rows, q_offset=last)
    # the M ranks' device times: rank r's block at offset r·128 over keys
    # [0, (r+1)·128), each of the three kernels
    q, k, v, dout = _fresh_inputs(gen, dtype=torch.bfloat16, b=a["b"],
                                  t=a["t"], hkv=a["hkv"], g=a["g"], d=a["d"])
    k, v = k.contiguous(), v.contiguous()
    total = dict.fromkeys(("flash_attention", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"), 0.0)
    for r in range(MODEL_AXIS_M):
        lo, hi = r * rows, (r + 1) * rows
        qr, dr = q[:, lo:hi].contiguous(), dout[:, lo:hi].contiguous()
        off = {"q_offset": lo} if lo else {}
        fwd, (out, lse) = fa.prepare_fwd(qr, k[:, :hi], v[:, :hi], **off)
        fa.launch(fwd)
        dq_args, dkv_args, _ = fab.prepare(qr, k[:, :hi], v[:, :hi], out,
                                           lse, dr, **off)
        for name, fn in (("flash_attention", lambda: fa.launch(fwd)),
                         ("flash_attention_bwd_dq",
                          lambda: fab.launch(dq_args)),
                         ("flash_attention_bwd_dkv",
                          lambda: fab.launch(dkv_args))):
            total[name] += _device_call_ms(fn)
    for name, ms in total.items():
        times[name + MODEL_AXIS_TAG]["ranks_sum_device_ms"] = ms
    for name, row in times.items():
        print(f"time {name} [{row['shape']}]: kernel {row['ms']:.4f}ms, "
              f"device {row['device_ms']:.4f}ms, bound "
              f"{row['bound_ms']:.5f}ms by {row['bound_by']}, plain "
              f"{row['plain_ms']:.4f}ms, SDPA causal_lower_right "
              f"{row['library_ms']:.4f}ms (device "
              f"{row['library_device_ms']:.4f}ms); the {MODEL_AXIS_M} "
              f"ranks' blocks (offsets 0-{last}) summed: device "
              f"{row['ranks_sum_device_ms']:.4f}ms")
    return {"model axis seq": counts}, errs, times


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
                       "prefill_paged_int8_kernel", "mla_split_kernel",
                       "mla_prefill_kernel", "mla_decode_wgmma_kernel",
                       "mla_prefill_wgmma_kernel", "rows_kernel",
                       "md_slice_kernel", "md_merge_kernel",
                       "normalize_kernel")


# sessions of ``_device_ms`` that recorded no device time, and ran again
DROPPED_STEP_SESSIONS = []


def _device_ms(fn, reps: int = 2) -> tuple[float, float, dict]:
    """Device time of ``fn`` per call from ``torch.profiler``, averaged
    over ``reps`` calls: (all CUDA kernels, the port's own kernels, {kernel:
    (ms, launches)}), in ms.  Only the CUDA activity is recorded: the host
    side's thousands of operator events a serving step cost seconds of
    processing each.  As in ``obs.kernels.profile_session``, each session
    first launches ``WARMUP_KERNEL`` and waits for it (left out of the
    times), and a session that recorded no device time (the card's
    profiler now and then drops a whole session) runs again, at most
    ``SESSION_TRIES`` in all; ``fn`` launches kernels on every call, so the
    last one empty fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import kernels as obs_kernels
    for attempt in range(1, obs_kernels.SESSION_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = ours = 0.0
        by = {}
        for evt in prof.key_averages():
            if not str(evt.device_type).endswith("CUDA"):
                continue
            name = obs_kernels.kernel_name(evt.key)
            if name == obs_kernels.WARMUP_KERNEL:
                continue
            ms = evt.self_device_time_total / reps / 1e3
            total += ms
            if any(sym in evt.key for sym in PORT_KERNEL_SYMBOLS):
                ours += ms
            name = name[:48]
            was, n = by.get(name, (0.0, 0.0))
            by[name] = (was + ms, n + evt.count / reps)
        if total > 0.0:
            return total, ours, by
        DROPPED_STEP_SESSIONS.append(attempt)
    _fail(f"profiler recorded no device time in "
          f"{obs_kernels.SESSION_TRIES} sessions")


def _serving_steps(params, cfg, engines) -> dict:
    """A model's serving steps at full width, on the pools its phase-4
    runs left idle: a decode step over 8 busy slots and a 64-token prefill
    chunk at offset 64, of the paged pool and of the slot pool, and the
    decode steps over the int8 runs' pools (each pool looked up when its
    step runs: a phase that serves no int8 slot pool asks for no step of
    it).  Returns {name: fn}."""
    import torch
    from repro_torch.serving import engine
    pool = engines["paged"].scheduler.pool
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
    q8_pool = engines["paged int8"].scheduler.pool
    q8_cfg = q8_pool.cfg
    layers = f"{cfg.num_layers} layers"
    return {
        f"paged decode [B={n}, {layers}, bf16]":
            lambda: engine.decode_step_paged(params, pool.caches, tables,
                                             lens, toks, cfg, noise=noise,
                                             top_k=5),
        "paged prefill chunk [64 tokens at offset 64, bf16]":
            lambda: engine.prefill_chunk_paged(params, pool.caches,
                                               tables[:1], 64, chunk, cfg),
        f"slot-pool decode [B={slots.num_slots}, {layers}, bf16]":
            lambda: engine.decode_step_slots(params, slots.caches, slot_lens,
                                             toks, cfg, noise=noise, top_k=5),
        "slot-pool prefill chunk [64 tokens at offset 64, bf16]":
            lambda: engine.prefill_chunk(params, scratch, 64, chunk, cfg),
        f"paged int8 decode [B={n}, {layers}, bf16, int8 K/V]":
            lambda: engine.decode_step_paged(params, q8_pool.caches, tables,
                                             lens, toks, q8_cfg, noise=noise,
                                             top_k=5),
        f"slot-pool int8 decode [B={slots.num_slots}, {layers}, bf16, "
        "int8 K/V]":
            lambda: engine.decode_step_slots(
                params, engines["slot pool int8"].scheduler.pool.caches,
                slot_lens, toks, q8_cfg, noise=noise, top_k=5)}


def _step_line(name: str, fn, *, samples: int = 10, warmup: int = 2,
               reps: int = 2) -> tuple[str, float, dict]:
    """One "step" line: host call to device finish (median of
    ``samples`` after ``warmup`` calls), device busy over ``reps`` calls
    and the port's kernels' share of it (torch.profiler).  Returns (the
    line, device busy ms, its kernels as ``_device_ms`` gives them)."""
    wall = _host_ms(fn, samples=samples, warmup=warmup)
    busy, ours, by = _device_ms(fn, reps=reps)
    return (f"step {name}: {wall:.3f}ms host call to device finish; device "
            f"busy {busy:.3f}ms ({100 * busy / wall:.1f}%, idle "
            f"{100 - 100 * busy / wall:.1f}%), of which the port's kernels "
            f"{ours:.3f}ms"), busy, by


def phase_steps(serve_ctx, train_ctx) -> None:
    """Where a step's time goes: smollm-360m's serving steps at
    ``SMOLLM_LAYERS`` layers (``_serving_steps``) and one full-width train step of 8 x 512 tokens,
    timed from the host's call to the device's finish, against the
    device's busy time inside it (all kernels, and the port's own, from
    torch.profiler)."""
    import torch
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.training.train_step import make_train_step
    steps = _serving_steps(*(serve_ctx[k]
                             for k in ("params", "cfg", "engines")))
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
        train = fn is train_step
        print(_step_line(name, fn, samples=5 if train else 10)[0])


def phase_swap_times(serve_ctx) -> None:
    """Preempt-and-swap on the card: ``swap_out`` and ``swap_in`` of one
    21-block sequence of the idle bf16 paged pool, each from the host call
    to the device's finish, ``prefetch_swap_in`` alone (to the staging
    stream's finish) and ``swap_in`` after it, the bytes moved and the
    copies' rate beside the host link's (a plain pinned ``copy_`` of the
    same bytes, each way, CUDA events); then a decode step of the pool from
    the host call to its tokens on the host, without and with one pending
    prefetch issued right after the step, as the scheduler does."""
    import numpy as np
    import torch
    from repro_torch.serving import engine
    params, cfg, engines = (serve_ctx[k]
                            for k in ("params", "cfg", "engines"))
    pool = engines["paged"].scheduler.pool
    prompt = np.arange(320) + 7000        # 21 blocks with the first write
    if pool.probe(prompt):
        _fail("swap times: the timing prompt matched the prefix index")
    seq = pool.admit(prompt)
    pool.lens[seq.slot] = len(prompt)
    n_blocks = len(seq.blocks)
    nbytes = n_blocks * pool.block_bytes
    rid = 10 ** 6

    def host_to_finish(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    outs, ins, pre, ins_pre = [], [], [], []
    for i in range(12):
        ms, rec = host_to_finish(lambda: pool.swap_out(seq.slot, rid))
        if i >= 2:
            outs.append(ms)
        if i % 2:
            ms, staged = host_to_finish(lambda: pool.prefetch_swap_in(rid))
            if staged != n_blocks:
                _fail(f"swap times: staged {staged} of {n_blocks} blocks")
            pre.append(ms)
        ms, seq = host_to_finish(lambda: pool.swap_in(rid))
        if i >= 2:
            (ins_pre if i % 2 else ins).append(ms)
    link = {}
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    link["device to host"] = _ms(lambda: host.copy_(dev, non_blocking=True))
    link["host to device"] = _ms(lambda: dev.copy_(host, non_blocking=True))
    gbs = {k: nbytes / v / 1e6 for k, v in link.items()}
    med = {k: statistics.median(v) for k, v in (
        ("out", outs), ("in", ins), ("prefetch", pre), ("in after", ins_pre))}
    print(f"swap: one sequence of {n_blocks} blocks, {nbytes} bytes "
          f"({pool.block_bytes} a block, bf16): swap_out "
          f"{med['out']:.3f} ms host call to device finish "
          f"({nbytes / med['out'] / 1e6:.2f} GB/s), swap_in from the host "
          f"copy {med['in']:.3f} ms ({nbytes / med['in'] / 1e6:.2f} GB/s), "
          f"prefetch_swap_in alone {med['prefetch']:.3f} ms "
          f"({nbytes / med['prefetch'] / 1e6:.2f} GB/s), swap_in after it "
          f"{med['in after']:.3f} ms; the host link, a pinned copy_ of the "
          f"same bytes: device to host {link['device to host']:.3f} ms "
          f"({gbs['device to host']:.2f} GB/s), host to device "
          f"{link['host to device']:.3f} ms ({gbs['host to device']:.2f} "
          "GB/s)")
    # phase_steps' decode batch over the same pool (what the rows hold
    # does not matter to the time)
    n, m = pool.num_slots, pool.max_blocks
    tables = torch.arange(1, n * m + 1, dtype=torch.int32,
                          device="cuda").reshape(n, m)
    lens = torch.tensor([328, 289, 250, 211, 172, 133, 94, 65],
                        device="cuda")[:n]
    toks = torch.ones((n, 1), dtype=torch.int64, device="cuda")
    noise = torch.zeros((n, 5), device="cuda")

    def step(prefetch: bool):
        if prefetch:                      # a fresh, unstaged record
            pool.swap_out(pool.swap_in(rid).slot, rid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, _, _ = engine.decode_step_paged(params, pool.caches, tables,
                                             lens, toks, cfg, noise=noise,
                                             top_k=5)
        t1 = time.perf_counter()
        if prefetch:
            pool.prefetch_swap_in(rid)
        t2 = time.perf_counter()
        tok.cpu()
        t3 = time.perf_counter()
        return (t3 - t0) * 1e3, (t2 - t1) * 1e3

    pool.swap_out(seq.slot, rid)
    for flag in (False, True):
        step(flag)
    plain, with_pf = [], []
    for _ in range(10):                   # in turns
        plain.append(step(False)[0])
        with_pf.append(step(True))
    pool.release(pool.swap_in(rid).slot)
    print(f"swap: decode step [B={n}, {cfg.num_layers} layers, bf16] host "
          f"call to tokens on the host {statistics.median(plain):.3f} ms; "
          f"with one pending prefetch of {n_blocks} blocks issued after the "
          f"step {statistics.median([w for w, _ in with_pf]):.3f} ms (the "
          f"prefetch call itself "
          f"{statistics.median([p for _, p in with_pf]):.3f} ms of host "
          "time)")


def _sdpa(q, k, v, mask):
    """The library yardstick: one PyTorch SDPA call on [B, H, T, D] views
    of the model layout, GQA by ``enable_gqa``, masked by a boolean mask."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def phase_times() -> dict:
    import torch
    gen = torch.Generator().manual_seed(1)
    rows = _serving_kernel_times(gen)
    rows.update(_train_kernel_times(gen))
    rows.update(_int8_kernel_times(gen))
    # the head_dim-128 instances at mistral-nemo-12b's shapes (32/8 heads),
    # and the sampler at both models' vocabularies
    _, hkv, g, d = HEAD_DIM_128[0]
    for v in VOCABS_128:
        rows.update(_topk_times(gen, v))
    rows.update(_serving_kernel_times(gen, hkv=hkv, g=g, d=d, topk=False))
    rows.update(_int8_kernel_times(gen, hkv=hkv, g=g, d=d))
    # the MoE decoders': the router, the sampler at their vocabularies, and
    # the D-128 instances at G 1 (qwen2-moe's 16/16) and G 5 (llama4's 40/8)
    rows.update(_router_times(gen))
    for v in VOCABS_MOE:
        rows.update(_topk_times(gen, v))
    for _, hkv, g, d in HEAD_DIM_MOE:
        rows.update(_serving_kernel_times(gen, hkv=hkv, g=g, d=d, topk=False,
                                          tag=f"_g{g}"))
        rows.update(_int8_kernel_times(gen, hkv=hkv, g=g, d=d, tag=f"_g{g}"))
    # the training kernels' D-128 instances at mistral-nemo-12b's training
    # shape (32/8 heads) and qwen2-moe-a2.7b's (16/16)
    for tag, (hkv, g) in TRAIN_TIMED_128.items():
        rows.update(_train_kernel_times(gen, hkv, g, 128, tag))
    # their (96, 64) instances at minicpm3-4b's training shape (40/40 heads,
    # q and k 96 wide, v 64)
    rows.update(_train_kernel_times(gen, MLA_HEADS, 1, 96, "_d96", dv=64))
    # the MLA decoder's latent attention and its sampler
    rows.update(_mla_kernel_times(gen))
    # the recurrent decoders': the sampler at their vocabularies, and rows
    # 4 and 5 at zamba2's shared block (32/32 heads of 64, G 1): its slot
    # pool's decode and its single-shot prefill of 256 tokens
    for v in VOCABS_STATE:
        rows.update(_topk_times(gen, v))
    for _, hkv, g, d in HEAD_DIM_STATE:
        rows.update(_serving_kernel_times(
            gen, hkv=hkv, g=g, d=d, topk=False, tag=f"_g{g}", paged=False,
            prefills=(("flash_attention_offset", (1, 328, 256, 0, 256)),)))
    # zamba2's training: rows 6 and 7 at its shared block's 32/32 heads of
    # 64 at B 8, T 512; then whisper-small's instances
    rows.update(_train_kernel_times(gen, 32, 1, 64, "_g1"))
    rows.update(_whisper_kernel_times(gen))
    # whisper-small's training: rows 6 and 7 non-causal over its encoder's
    # 8 x 1536 frames, and at its cross-attention's 256 queries a row over
    # them; then llava-next-34b's serving instances and rows 6 and 7 at its
    # training sequence (1 x 3136, 56/8 heads of 128)
    rows.update(_train_kernel_times(gen, WHISPER_HEADS, 1, 64, "_nc_b8_t1536",
                                    t=WHISPER_S_ENC, causal=False))
    rows.update(_train_kernel_times(gen, WHISPER_HEADS, 1, 64, "_x1536",
                                    t=WHISPER_TRAIN_T, tk=WHISPER_S_ENC,
                                    causal=False))
    rows.update(_llava_kernel_times(gen))
    rows.update(_train_kernel_times(gen, LLAVA_HKV, LLAVA_G, 128,
                                    f"_d128_g{LLAVA_G}_t{LLAVA_TRAIN_T}",
                                    b=1, t=LLAVA_TRAIN_T))
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


def _topk_times(gen, v: int = 49152, real: int = 0, r: int = 8) -> dict:
    """Row 1 at a decode batch's fp32 logits [``r``, ``v``], k = 5
    (entries from ``real`` on -inf, as a padded vocabulary's), held against
    its plain version on the timed input; keyed ``softmax_topk`` at
    smollm-360m's vocabulary, else ``softmax_topk_v<v>``."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import softmax_topk as st
    x = (torch.randn(r, v, generator=gen) * 30.0).cuda()
    if real:
        x[:, real:] = float("-inf")
    got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    if not torch.equal(got.indices.long(), want.indices) or not \
            torch.allclose(got.values, want.values, rtol=1e-5, atol=0.0):
        _fail(f"softmax_topk [{r}, {v}] disagrees with its plain version on "
              "the timed input")
    args, _ = st.prepare(x, 5)
    k = 5
    p = st.plan(r, v, k, x.dtype, build.sm_count(x.device))
    b_ms, b_by = _bound(r * v * 4 + r * k * 8 + r * 4, 4.0 * r * v,
                        "float32")

    def library():
        return torch.topk(torch.softmax(x, -1), 5)
    key = "softmax_topk" if v == 49152 else f"softmax_topk_v{v}"
    return {key: {
        "ms": _ms(lambda: st.launch(args)),
        "device_ms": _device_call_ms(lambda: st.launch(args)),
        "wrapper_ms": _ms(lambda: st.softmax_topk(x, 5)),
        "plain_ms": _ms(lambda: st.softmax_topk_plain(x, 5)),
        "library_ms": _ms(library),
        "library_device_ms": _device_call_ms(library),
        "library_call": "torch.topk(torch.softmax(x, -1), k) (two calls)",
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"x [{r}, {v}] float32, k=5, {p.slices} slices of "
                 f"{p.slice}" + (f", entries from {real} -inf" if real
                                 else "")}}


def _whisper_kernel_times(gen) -> dict:
    """whisper-small's instances, each held against its plain version on
    the timed input: row 1 at [8, 51968] with the padded entries -inf
    (``_topk_times``); row 6 non-causal at the encoder's B 1, T 1536,
    12/12 heads of 64, bf16, beside one SDPA forward; row 4 at a B 8
    decode step's cross-attention over all 1536 keys, 12/12 heads, bf16,
    beside one SDPA call (no mask: every key is valid).  Bytes count each
    operand once; operations 2 per multiply-add of QKᵀ and PV."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    rows = _topk_times(gen, WHISPER_VOCAB, real=WHISPER_REAL_VOCAB)
    h, d, t, esz = WHISPER_HEADS, 64, WHISPER_S_ENC, 2
    heads = f"Hq={h} Hkv={h} D={d}"
    q, k, v, _ = _fresh_inputs(gen, dtype=torch.bfloat16, b=1, t=t, hkv=h,
                               g=1, d=d)
    k, v = k.contiguous(), v.contiguous()
    out, _ = fa.flash_attention_fwd(q, k, v, causal=False)
    want, _ = fa.flash_attention_fwd_plain(q, k, v, causal=False)
    err = _scaled_err(out, want, absolute=True)
    if not err <= 2e-2:
        _fail(f"flash_attention non-causal on the timed input: row-scaled "
              f"err {err:.3g} > 2e-2")
    args, _ = fa.prepare_fwd(q, k, v, causal=False)
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs)
    b_ms, b_by = _bound(4 * t * h * d * esz + h * t * 4,
                        4.0 * h * t * t * d, "bfloat16")
    rows["flash_attention_nc_t1536"] = {
        "ms": _ms(lambda: fa.launch(args)),
        "device_ms": _device_call_ms(lambda: fa.launch(args)),
        "wrapper_ms": _ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                         causal=False)),
        "plain_ms": _ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal=False), samples=5, inner=2),
        "library_ms": _ms(sdpa), "library_device_ms": _device_call_ms(sdpa),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=1 T={t} {heads} bf16 non-causal (the encoder)"}
    vlens = [t] * 8
    q, _, _, k, v = _contiguous_inputs(gen, dtype=torch.bfloat16, s=t,
                                       vlens=vlens, hkv=h, g=1, d=d)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    err = _scaled_err(fd.flash_decode(q, k, v, vl),
                      fd.flash_decode_plain(q, k, v, vl), absolute=True)
    if not err <= 2e-2:
        _fail(f"flash_decode over {t} keys on the timed input: row-scaled "
              f"err {err:.3g} > 2e-2")
    args, _ = fd.prepare(q, k, v, vl)

    def sdpa_dec():
        return F.scaled_dot_product_attention(qs, ks, vs)
    b_ms, b_by = _bound(2 * q.numel() * esz + sum(vlens) * h * d * esz * 2
                        + len(vlens) * 4, 4.0 * h * d * sum(vlens),
                        "bfloat16")
    rows["flash_decode_s1536"] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode(q, k, v, vl)),
        "plain_ms": _ms(lambda: fd.flash_decode_plain(q, k, v, vl)),
        "library_ms": _ms(sdpa_dec),
        "library_device_ms": _device_call_ms(sdpa_dec),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 S={t} {heads} bf16, every key valid (the "
                 f"cross-attention), {_plan_of(fd, q, k)}"}
    return rows


def _llava_kernel_times(gen) -> dict:
    """llava-next-34b's serving instances at its lockstep run's shapes,
    each held against its plain version on the timed input: row 1 at
    [2, 64000]; row 4 at B 2 over all 2960 keys, 56/8 heads of 128, bf16,
    and row 5 at the prefill of B 2 x 2944 at offset 0 into caches of
    2960, each beside one SDPA call (``_contiguous_kernel_times``).  Keys
    ``softmax_topk_v64000``, ``flash_decode_d128_g7_s2960``,
    ``flash_attention_offset_d128_g7_q2944``."""
    rows = _topk_times(gen, LLAVA_VOCAB, r=2)
    tag = f"_d128_g{LLAVA_G}"
    found = _contiguous_kernel_times(
        gen, tag, dict(hkv=LLAVA_HKV, g=LLAVA_G, d=128),
        f"Hq={LLAVA_HKV * LLAVA_G} Hkv={LLAVA_HKV} D=128",
        (("flash_attention_offset", (2, LLAVA_S, LLAVA_TQ, 0, LLAVA_TQ)),),
        decode=([LLAVA_S] * 2, LLAVA_S))
    rows["flash_decode" + tag + f"_s{LLAVA_S}"] = found["flash_decode" + tag]
    rows["flash_attention_offset" + tag + f"_q{LLAVA_TQ}"] = \
        found["flash_attention_offset" + tag]
    return rows


def _mla_kernel_times(gen) -> dict:
    """MLA's kernels at minicpm3-4b's serving shapes
    (``_mla_attention_times``), then the sampler at its padded
    vocabulary."""
    rows = _topk_times(gen, MLA_VOCAB, real=MLA_REAL_VOCAB)
    rows.update(_mla_attention_times(gen))
    return rows


# phase 8's MLA shapes, (row key, B, Tq, per-row offsets, vlens, S): the
# slot pool's decode step over its 8 slots (lengths 65-328), a 64-token
# prefill chunk at offset 64 (vlen 128), the lockstep prefill (B 4, Tq 256
# into caches of 288) and an int8 run's single-shot prefill (Tq = S = 256)
MLA_TIMED = (("flash_decode_mla", 8, 1, [0] * 8, MLA_DECODE_VLENS, MLA_S),
             ("flash_attention_mla", 1, 64, [64], [128], MLA_S),
             ("flash_attention_mla, lockstep", 4, 256, [0] * 4, [256] * 4,
              288),
             ("flash_attention_mla, int8 single-shot", 1, 256, [0], [256],
              256))


def _mla_attention_times(gen, keys=None, tag: str = "",
                         cases=MLA_TIMED) -> dict:
    """MLA's latent attention at ``cases``' shapes (``MLA_TIMED``'s by
    default; those whose key is in ``keys``, by default all), bf16, each
    held against its plain version on the timed input (1e-3 +
    2^-7·|plain|), beside one SDPA call
    on the same inputs (q_cat = [q_eff, q_rope] over the 40 heads, the
    concatenated key [c, r] as one KV head by ``enable_gqa``, V = c, scale
    96^-0.5, a boolean mask; the concatenation made before the timing);
    rows keyed ``<key><tag>``.  Bound: each input read once (the live
    latent rows, 288 values each), the output written once; the
    operations 2·H·(288 + 256) a visible (query, key) pair."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_mla as fm
    rows = {}
    esz, h, width = 2, MLA_HEADS, MLA_R + MLA_DR
    for key, b, tq, offs, vlens, s in cases:
        if keys is not None and key not in keys:
            continue
        q, qr, c, r, vl = _mla_inputs(gen, dtype=torch.bfloat16, b=b, tq=tq,
                                      vlens=vlens, s=s)
        decode = key == "flash_decode_mla"
        qo = torch.tensor(offs, dtype=torch.int32, device="cuda")
        if decode:
            def kernel():
                return fm.flash_decode_mla(q, qr, c, r, vl, scale=MLA_SCALE)

            def plain():
                return fm.flash_decode_mla_plain(q, qr, c, r, vl,
                                                 scale=MLA_SCALE)
            args, _ = fm.prepare_decode(q, qr, c, r, vl, scale=MLA_SCALE)
            p = fm.decode_plan(b, h, s, q.dtype, build.sm_count(q.device))
            pairs = sum(vlens)
            shape = (f"B={b} H=40 R=256 Dr=32 S={s} bf16 vlen {vlens}, "
                     f"split {p.split} x {p.splits}")
        else:
            def kernel():
                return fm.flash_attention_mla(q, qr, c, r, qo, vl,
                                              scale=MLA_SCALE)

            def plain():
                return fm.flash_attention_mla_plain(q, qr, c, r, qo, vl,
                                                    scale=MLA_SCALE)
            args, _ = fm.prepare_prefill(q, qr, c, r, qo, vl,
                                         scale=MLA_SCALE)
            pairs = sum(min(n, o + i + 1) for n, o in zip(vlens, offs)
                        for i in range(tq))
            shape = (f"B={b} Tq={tq} q_offset={offs[0]} vlen={vlens[0]} "
                     f"H=40 R=256 Dr=32 S={s} bf16")
        want = plain().float()
        err = (kernel().float() - want).abs()
        if (err - 1e-3 - 2.0 ** -7 * want.abs()).max().item() > 0:
            _fail(f"{key} on the timed input: max abs err "
                  f"{err.max().item():.3g} beyond 1e-3 + 2^-7·|plain|")
        # the library's inputs: the rows past vlen zeroed (SDPA would carry
        # their NaN through a zero weight), the key concatenated
        live = (torch.arange(s, device="cuda")[None, :]
                < vl[:, None].long())
        c0 = torch.where(live[..., None], c, 0).contiguous()
        r0 = torch.where(live[..., None], r, 0)
        qcat = torch.cat([q, qr], -1).transpose(1, 2)      # [B, H, Tq, 288]
        kcat = torch.cat([c0, r0], -1)[:, None]             # [B, 1, S, 288]
        vv = c0[:, None]                                     # [B, 1, S, 256]
        kpos = torch.arange(s, device="cuda")
        qpos = qo[:, None].long() + torch.arange(tq, device="cuda")
        mask = live[:, None, :] if decode else (
            live[:, None, :] & (kpos[None, None, :] <= qpos[..., None]))
        mask = mask[:, None]                                 # [B, 1, Tq, S]

        def library():
            return F.scaled_dot_product_attention(
                qcat, kcat, vv, attn_mask=mask, scale=MLA_SCALE,
                enable_gqa=True)
        lib_err = (library().transpose(1, 2).float() - want).abs()
        if (lib_err - 2e-2 - 2.0 ** -6 * want.abs()).max().item() > 0:
            _fail(f"{key}: SDPA differs from the plain version by "
                  f"{lib_err.max().item():.3g}")
        nbytes = ((q.numel() + qr.numel()) * esz + sum(vlens) * width * esz
                  + q.numel() * esz + b * 8)
        b_ms, b_by = _bound(nbytes, 2.0 * h * (width + MLA_R) * pairs,
                            "bfloat16")
        rows[key + tag] = {
            "ms": _ms(lambda: fm.launch(args)),
            "device_ms": _device_call_ms(lambda: fm.launch(args)),
            "wrapper_ms": _ms(kernel), "plain_ms": _ms(plain),
            "library_ms": _ms(library),
            "library_device_ms": _device_call_ms(library),
            "library_call": "F.scaled_dot_product_attention(q_cat, [c, r], "
                            "c, mask, scale=96**-0.5, enable_gqa=True)",
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err":
                err.max().item(), "shape": shape}
    return rows


# the router's timed shapes: (row key, rows, experts, k); the JSON line
# lists the decode step's, the others are printed
ROUTER_TIMED = (("softmax_topk_router_e60", 8, 60, 4),
                ("softmax_topk_router_e60, 64-token chunk", 64, 60, 4),
                ("softmax_topk_router_e16", 8, 16, 1),
                ("softmax_topk_router_e16, 256 tokens", 256, 16, 1))


def _router_times(gen) -> dict:
    """Row 1 as the MoE router runs it (``ROUTER_TIMED``: fp32 logits
    [rows, E], top k), held against its plain version on the timed input,
    beside ``torch.topk(torch.softmax(x))``.  The bound reads x once and
    writes k values, k int32 indices and the lse a row; 4 fp32 operations
    an entry."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import softmax_topk as st
    rows = {}
    for key, r, e, k in ROUTER_TIMED:
        x = (torch.randn(r, e, generator=gen) * 2.0).cuda()
        got, want = st.softmax_topk(x, k), st.softmax_topk_plain(x, k)
        if not torch.equal(got.indices.long(), want.indices) or not \
                torch.allclose(got.values, want.values, rtol=1e-5, atol=0.0):
            _fail(f"softmax_topk [{r}, {e}] k={k} disagrees with its plain "
                  "version on the timed input")
        args, _ = st.prepare(x, k)
        p = st.plan(r, e, k, x.dtype, build.sm_count(x.device))
        b_ms, b_by = _bound(r * e * 4 + r * k * 8 + r * 4, 4.0 * r * e,
                            "float32")

        def library():
            return torch.topk(torch.softmax(x, -1), k)
        rows[key] = {
            "ms": _ms(lambda: st.launch(args)),
            "device_ms": _device_call_ms(lambda: st.launch(args)),
            "wrapper_ms": _ms(lambda: st.softmax_topk(x, k)),
            "plain_ms": _ms(lambda: st.softmax_topk_plain(x, k)),
            "library_ms": _ms(library),
            "library_device_ms": _device_call_ms(library),
            "library_call": "torch.topk(torch.softmax(x, -1), k) (two "
                            "calls)",
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"x [{r}, {e}] float32, k={k}, {p.slices} slice of "
                     f"{p.slice}, {p.threads} threads a CTA"}
    return rows


# row 5's timed calls: (key, (B, Tk, Tq, q_offset, vlen)): the slot pool's
# 64-token chunk at offset 64 into a slot of 328, then (printed only) the
# lockstep prefill and an int8 run's single-shot prefill (its exact bf16 K/V,
# Tq = Tk = 256)
SERVING_PREFILLS = (("flash_attention_offset", (1, 328, 64, 64, 128)),
                    ("flash_attention_offset, lockstep", (4, 288, 256, 0, 256)),
                    ("flash_attention_offset, int8 single-shot",
                     (1, 256, 256, 0, 256)))


def _serving_kernel_times(gen, *, hkv: int = 5, g: int = 3, d: int = 64,
                          topk: bool = True, tag: str = "",
                          paged: bool = True,
                          prefills=SERVING_PREFILLS) -> dict:
    """Rows 1-5 at the serving paths' shapes, each held against its plain
    version on the very inputs it is timed on, at ``hkv`` KV heads of ``g``
    query heads and head dim ``d`` (rows keyed ``<kernel>_d<d><tag>`` off
    D 64): the sampler (with ``topk``), the paged decode and cached prefill
    (with ``paged``), the contiguous decode and the cached prefill's
    ``prefills``, SDPA beside rows 4 and 5."""
    rows = _topk_times(gen) if topk else {}
    suffix = ("" if d == 64 else f"_d{d}") + tag
    geom = dict(hkv=hkv, g=g, d=d)
    heads = f"Hq={hkv * g} Hkv={hkv} D={d}"
    if paged:
        rows.update(_paged_kernel_times(gen, suffix, geom, heads))
    rows.update(_contiguous_kernel_times(gen, suffix, geom, heads, prefills))
    return rows


def _paged_kernel_times(gen, suffix: str, geom: dict, heads: str) -> dict:
    """Rows 2 and 3 of ``_serving_kernel_times``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    hkv, d = geom["hkv"], geom["d"]
    hq, esz = hkv * geom["g"], 2
    rows = {}
    # paged decode: 8 slots of the serving run's pool (BS=16, 21 blocks a
    # row), bf16, ragged valid lengths across the run's range
    vlens = [329, 290, 251, 212, 173, 134, 95, 66]
    q, kp, vp, tk, tp, vl = _paged_inputs(gen, dtype=torch.bfloat16, bs=16,
                                          vlens=vlens, share=False, **geom)
    err = (fd.flash_decode_paged(q, kp, vp, tk, vl).float()
           - fd.flash_decode_paged_plain(q, kp, vp, tp, vl).float()).abs().max()
    if not err <= 2e-2:
        _fail(f"flash_decode_paged{suffix} on the timed input: max abs err "
              f"{err.item():.3g} > 2e-2")
    nbytes = (2 * q.numel() * esz + sum(vlens) * hkv * d * esz * 2
              + sum(-(-n // 16) for n in vlens) * 4 + len(vlens) * 4)
    ops = 4.0 * hq * d * sum(vlens)
    args, _ = fd.prepare_paged(q, kp, vp, tk, vl)
    plan = _plan_of(fd, q, kp, tk)
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_decode_paged" + suffix] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode_paged(q, kp, vp, tk, vl)),
        "plain_ms": _ms(lambda: fd.flash_decode_paged_plain(q, kp, vp, tp, vl)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 {heads} BS=16 bf16 vlen {vlens}, {plan}"}

    # paged prefill: one 64-token chunk at offset 64 (the serving run's
    # chunk width), bf16
    tq, qoff, vlen = 64, 64, 128
    q, kp, vp, tk, tp, vl = _paged_inputs(gen, dtype=torch.bfloat16, bs=16,
                                          vlens=[vlen], tq=tq, share=False,
                                          **geom)
    qo = torch.tensor([qoff], dtype=torch.int32, device="cuda")
    _prefill_err(q, kp, vp, qo, vl, tk, tp, "on the timed input", 2e-2)
    pairs = sum(min(vlen, qoff + i + 1) for i in range(tq))
    nbytes = (2 * q.numel() * esz + hq * tq * 4 + vlen * hkv * d * esz * 2
              + (vlen // 16) * 4 + 8)
    args, _ = fa.prepare_paged(q, kp, vp, qo, vl, tk)
    b_ms, b_by = _bound(nbytes, 4.0 * hq * d * pairs, "bfloat16")
    rows["flash_attention_paged" + suffix] = {
        "ms": _ms(lambda: fa.launch(args)),
        "device_ms": _device_call_ms(lambda: fa.launch(args)),
        "wrapper_ms": _ms(lambda: fa.flash_attention_paged(q, kp, vp, qo, vl,
                                                           tk)),
        "plain_ms": _ms(lambda: fa.flash_attention_paged_plain(q, kp, vp, qo,
                                                               vl, tp)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=1 Tq=64 q_offset=64 vlen=128 {heads} BS=16 bf16 "
                 "(tensor cores, paged_wgmma_kernel)"}
    return rows


# the slot pool's decode batch that phase 8 times row 4 at: 8 slots of
# 328, ragged (valid lengths, cache length)
SLOT_DECODE = ([328, 289, 250, 211, 172, 133, 94, 65], 328)


def _contiguous_kernel_times(gen, suffix: str, geom: dict, heads: str,
                             prefills, decode=SLOT_DECODE) -> dict:
    """Rows 4 and 5 of ``_serving_kernel_times``, row 4 at ``decode``'s
    (valid lengths, cache length)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    hkv, d = geom["hkv"], geom["d"]
    hq, esz = hkv * geom["g"], 2
    rows = {}
    # contiguous decode, bf16; the library yardstick is one SDPA call on
    # transposed views with a boolean valid-length mask
    vlens, s = decode
    q, _, _, k, v = _contiguous_inputs(gen, dtype=torch.bfloat16, s=s,
                                       vlens=vlens, **geom)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    err = _scaled_err(fd.flash_decode(q, k, v, vl),
                      fd.flash_decode_plain(q, k, v, vl), absolute=True)
    if not err <= 2e-2:
        _fail(f"flash_decode{suffix} on the timed input: row-scaled err "
              f"{err:.3g} > 2e-2")
    mask = (torch.arange(s, device="cuda")[None, :]
            < vl[:, None].long())[:, None, None, :]
    nbytes = (2 * q.numel() * esz + sum(vlens) * hkv * d * esz * 2
              + len(vlens) * 4)
    args, _ = fd.prepare(q, k, v, vl)
    plan = _plan_of(fd, q, k)
    b_ms, b_by = _bound(nbytes, 4.0 * hq * d * sum(vlens), "bfloat16")
    rows["flash_decode" + suffix] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode(q, k, v, vl)),
        "plain_ms": _ms(lambda: fd.flash_decode_plain(q, k, v, vl)),
        "library_ms": _ms(lambda: _sdpa(q, k, v, mask)),
        "library_device_ms": _device_call_ms(lambda: _sdpa(q, k, v, mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={len(vlens)} S={s} {heads} bf16 vlen {vlens}, {plan}"}

    # contiguous cached prefill at ``prefills``; back-to-back and device
    # times of the kernel (bf16: tensor cores) and of SDPA
    for key, (b, tk, tq, qoff, vlen) in prefills:
        q, _, _, k, v = _contiguous_inputs(gen, dtype=torch.bfloat16, s=tk,
                                           vlens=[vlen] * b, tq=tq, **geom)
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
        name, _, form = key.partition(",")
        rows[name + suffix + ("," + form if form else "")] = {
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
                     f"{heads} bf16"}
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


def _train_kernel_times(gen, hkv: int = 5, g: int = 3, d: int = 64,
                        tag: str = "", dv=None, *, b: int = 8, t: int = 512,
                        tk: int = 0, causal: bool = True,
                        q_offset: int = 0) -> dict:
    """Rows 6-7 at a training shape (``b`` rows of ``t`` queries over
    ``tk`` keys (``t`` unless given: the cross-attention's), ``hkv`` KV
    heads of ``g`` query heads, head dims ``d`` (q, k) and ``dv`` (v, out;
    ``d`` unless given), bf16, ``causal``; smollm-360m's B 8, T 512, 15/5 of
    64, causal by default): the fresh forward, and the dq and dk/dv
    kernels, each against its bound; the wrapper and plain times of the
    forward and of the whole backward; the library yardstick is SDPA
    (is_causal, enable_gqa) on [B, H, T, D] views, its forward for row 6
    and its autograd backward for row 7 (the dq and dk/dv rows both carry
    the whole backward's plain and library times).  Bytes count each
    operand once at its width; operations two per multiply-add of each
    product over the (query, key) pairs attended, below the diagonal when
    causal (S and dP contract over D and Dv, dQ and dK are D wide, O and dV
    Dv).  ``q_offset``: a sequence-parallel rank's block, query row i at
    q_offset + i over Tk = q_offset + T keys, causal; the library is then
    SDPA with ``causal_lower_right`` over K/V repeated to the query heads.
    Keys ``<kernel><tag>``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    hq, esz, tk = hkv * g, 2, (q_offset + t if q_offset else tk or t)
    dv = dv or d
    off = {"q_offset": q_offset} if q_offset else {}
    q, k, v, dout = _fresh_inputs(gen, dtype=torch.bfloat16, b=b, t=t,
                                  hkv=hkv, g=g, d=d,
                                  dv=dv if dv != d else None, tk=tk)
    k, v = k.contiguous(), v.contiguous()      # the model's K/V layout
    errs = _fresh_errs(q, k, v, dout, causal, q_offset)
    if max(errs.values()) > 2e-2:
        _fail(f"fresh attention on the timed input: {errs}")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, **off)
    pairs = (t * q_offset + t * (t + 1) // 2 if causal else t * tk)
    per_pair = 2.0 * b * hq                  # flops per width of a product
    qk = b * (t * hq + tk * hkv) * d * esz      # q and k
    vo = b * (t * hq + tk * hkv) * dv * esz     # dout (or out) and v
    stat = b * hq * t * 4                       # lse or delta, fp32
    shape = (f"B={b} T={t}" + (f" Tk={tk}" if tk != t else "")
             + f" Hq={hq} Hkv={hkv} D={d}" + (f" Dv={dv}" if dv != d else "")
             + " bf16 " + ("causal" if causal else "non-causal")
             + (f" at q offset {q_offset}" if q_offset else ""))

    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    if q_offset:
        from torch.nn.attention.bias import causal_lower_right
        ks, vs = (x.repeat_interleave(g, dim=1) for x in (ks, vs))
        mask = causal_lower_right(t, tk)

        def lib(qx, kx, vx):
            return F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask)
    else:
        def lib(qx, kx, vx):
            return F.scaled_dot_product_attention(qx, kx, vx,
                                                  is_causal=causal,
                                                  enable_gqa=True)

    def sdpa():
        return lib(qs, ks, vs)

    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (qs, ks, vs))
    lib_out = lib(qg, kg, vg)
    lib_dout = dout.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (qg, kg, vg), lib_dout,
                                   retain_graph=True)

    fwd_args, _ = fa.prepare_fwd(q, k, v, causal=causal, **off)
    dq_args, dkv_args, _ = fab.prepare(q, k, v, out, lse, dout,
                                       causal=causal, **off)
    bwd_plain = _ms(lambda: fab.flash_attention_bwd_plain(
        q, k, v, out, lse, dout, causal=causal, **off), samples=5, inner=2)
    bwd_lib = _ms(sdpa_bwd)
    bwd_wrapper = _ms(lambda: fab.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=causal, **off))
    rows = {}
    # forward: reads q, k, v, writes out and lse; S (D) and O (Dv)
    b_ms, b_by = _bound(qk + vo + stat, per_pair * (d + dv) * pairs,
                        "bfloat16")
    bwd_lib_device = _device_call_ms(sdpa_bwd)
    bwd_device = _device_call_ms(lambda: fab.flash_attention_bwd(
        q, k, v, out, lse, dout, causal=causal, **off))
    rows["flash_attention" + tag] = {
        "ms": _ms(lambda: fa.launch(fwd_args)),
        "device_ms": _device_call_ms(lambda: fa.launch(fwd_args)),
        "wrapper_ms": _ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, **off)),
        "plain_ms": _ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal=causal, **off), samples=5, inner=2),
        "library_ms": _ms(sdpa),
        "library_device_ms": _device_call_ms(sdpa),
        "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    # dq: s, dp and dq products; reads q, k, v, dout, lse, delta, writes dq
    b_ms, b_by = _bound(qk + vo + 2 * stat + b * t * hq * d * esz,
                        per_pair * (2 * d + dv) * pairs, "bfloat16")
    rows["flash_attention_bwd_dq" + tag] = {
        "ms": _ms(lambda: fab.launch(dq_args)),
        "device_ms": _device_call_ms(lambda: fab.launch(dq_args)),
        "wrapper_ms": bwd_wrapper, "plain_ms": bwd_plain,
        "library_ms": bwd_lib, "library_device_ms": bwd_lib_device,
        "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    # dk/dv: s, dp, dk and dv products; writes dk and dv
    b_ms, b_by = _bound(qk + vo + 2 * stat + b * tk * hkv * (d + dv) * esz,
                        per_pair * 2 * (d + dv) * pairs, "bfloat16")
    rows["flash_attention_bwd_dkv" + tag] = {
        "ms": _ms(lambda: fab.launch(dkv_args)),
        "device_ms": _device_call_ms(lambda: fab.launch(dkv_args)),
        "wrapper_ms": bwd_wrapper, "plain_ms": bwd_plain,
        "library_ms": bwd_lib, "library_device_ms": bwd_lib_device,
        "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    # the whole backward's bound: reads q, k, v, out, dout, lse and delta,
    # writes dq, dk and dv; five products (S, dP, dQ, dK, dV)
    b_ms, b_by = _bound(qk + vo + b * t * hq * dv * esz + 2 * stat
                        + b * (t * hq + tk * hkv) * d * esz
                        + b * tk * hkv * dv * esz,
                        per_pair * (3 * d + 2 * dv) * pairs, "bfloat16")
    print(f"time flash attention backward{tag}, both kernels [{shape}]: bound "
          f"{b_ms:.5f}ms by {b_by}; wrapper (delta + dq + dk/dv) "
          f"{bwd_wrapper:.4f}ms, device {bwd_device:.4f}ms; plain "
          f"{bwd_plain:.4f}ms, SDPA autograd backward {bwd_lib:.4f}ms, "
          f"device {bwd_lib_device:.4f}ms")
    return rows


def _int8_kernel_times(gen, hkv: int = 5, g: int = 3, d: int = 64,
                       tag: str = "") -> dict:
    """The int8 forms at the int8 serving runs' shapes (bf16 q): paged
    decode over 8 slots of the pool (BS 16, vlen 66..329), contiguous decode
    over 8 slots of 328, and the paged prefill at row 3's chunk (64 tokens
    at offset 64, vlen 128), each first held against its plain version on
    the timed input.  Bounds count 1 byte per int8 K/V value read once, 2
    per bf16 scale, q read and out written once, and the two dequantizing
    multiplies per value beside the 4·D flops per (head, position).  No
    single PyTorch call computes a dequantize and attention.  At ``hkv``
    KV heads of ``g`` query heads and head dim ``d`` (rows keyed
    ``<kernel>_d<d><tag>`` off D 64)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    hq, esz = hkv * g, 2
    suffix = ("" if d == 64 else f"_d{d}") + tag
    geom = dict(hkv=hkv, g=g, d=d)
    heads = f"Hq={hq} Hkv={hkv} D={d}"
    rows = {}

    def kv_bytes(n):          # int8 K and V plus their bf16 scales
        return n * hkv * (2 * d + 2 * 2)

    vlens = [329, 290, 251, 212, 173, 134, 95, 66]
    q, _, pl, _, tp, vl = _int8_paged_inputs(gen, dtype=torch.bfloat16,
                                             bs=16, vlens=vlens, **geom)
    kw = dict(k_scale_pool=pl[2], v_scale_pool=pl[3])
    err = (fd.flash_decode_paged(q, pl[0], pl[1], tp, vl, **kw).float()
           - fd.flash_decode_paged_plain(q, pl[0], pl[1], tp, vl,
                                         **kw).float()).abs().max().item()
    if not err <= 2e-2:
        _fail(f"flash_decode_paged_int8{suffix} on the timed input: max "
              f"abs err "
              f"{err:.3g} > 2e-2")
    nbytes = (2 * q.numel() * esz + kv_bytes(sum(vlens))
              + sum(-(-n // 16) for n in vlens) * 4 + len(vlens) * 4)
    ops = (4.0 * hq * d + 2.0 * hkv * d) * sum(vlens)
    args, _ = fd.prepare_paged(q, pl[0], pl[1], tp, vl, **kw)
    plan = _plan_of(fd, q, pl[0], tp)
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_decode_paged_int8" + suffix] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode_paged(q, pl[0], pl[1], tp,
                                                        vl, **kw)),
        "plain_ms": _ms(lambda: fd.flash_decode_paged_plain(
            q, pl[0], pl[1], tp, vl, **kw)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 {heads} BS=16 int8 K/V, bf16 q, vlen {vlens}, "
                 f"{plan}"}

    vlens = [328, 289, 250, 211, 172, 133, 94, 65]
    cache = _int8_contiguous_inputs(gen, s=328, vlens=vlens, hkv=hkv,
                                    d=d)[4:]
    kw = dict(k_scale=cache[2], v_scale=cache[3])
    q = torch.randn(8, 1, hq, d, generator=gen).to(device="cuda",
                                                   dtype=torch.bfloat16)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    err = (fd.flash_decode(q, cache[0], cache[1], vl, **kw).float()
           - fd.flash_decode_plain(q, cache[0], cache[1], vl,
                                   **kw).float()).abs().max().item()
    if not err <= 2e-2:
        _fail(f"flash_decode_int8{suffix} on the timed input: max abs err "
              f"{err:.3g} > 2e-2")
    nbytes = 2 * q.numel() * esz + kv_bytes(sum(vlens)) + len(vlens) * 4
    ops = (4.0 * hq * d + 2.0 * hkv * d) * sum(vlens)
    args, _ = fd.prepare(q, cache[0], cache[1], vl, **kw)
    plan = _plan_of(fd, q, cache[0])
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_decode_int8" + suffix] = {
        "ms": _ms(lambda: fd.launch(args)),
        "device_ms": _device_call_ms(lambda: fd.launch(args)),
        "wrapper_ms": _ms(lambda: fd.flash_decode(q, cache[0], cache[1], vl,
                                                  **kw)),
        "plain_ms": _ms(lambda: fd.flash_decode_plain(q, cache[0], cache[1],
                                                      vl, **kw)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=8 S=328 {heads} int8 K/V, bf16 q, vlen {vlens}, "
                 f"{plan}"}

    tq, qoff, vlen = 64, 64, 128
    q, _, pl, _, tp, vl = _int8_paged_inputs(gen, dtype=torch.bfloat16,
                                             bs=16, vlens=[vlen], tq=tq,
                                             **geom)
    qo = torch.tensor([qoff], dtype=torch.int32, device="cuda")
    kw = dict(k_scale_pool=pl[2], v_scale_pool=pl[3])
    out, _ = fa.flash_attention_paged(q, pl[0], pl[1], qo, vl, tp, **kw)
    want, _ = fa.flash_attention_paged_plain(q, pl[0], pl[1], qo, vl, tp,
                                             **kw)
    err = (out.float() - want.float()).abs().max().item()
    if not err <= 2e-2:
        _fail(f"flash_attention_paged_int8{suffix} on the timed input: max "
              f"abs err "
              f"{err:.3g} > 2e-2")
    pairs = sum(min(vlen, qoff + i + 1) for i in range(tq))
    nbytes = (2 * q.numel() * esz + hq * tq * 4 + kv_bytes(vlen)
              + (vlen // 16) * 4 + 8)
    ops = 4.0 * hq * d * pairs + 2.0 * hkv * d * vlen
    args, _ = fa.prepare_paged(q, pl[0], pl[1], qo, vl, tp, **kw)
    b_ms, b_by = _bound(nbytes, ops, "bfloat16")
    rows["flash_attention_paged_int8" + suffix] = {
        "ms": _ms(lambda: fa.launch(args)),
        "device_ms": _device_call_ms(lambda: fa.launch(args)),
        "wrapper_ms": _ms(lambda: fa.flash_attention_paged(
            q, pl[0], pl[1], qo, vl, tp, **kw)),
        "plain_ms": _ms(lambda: fa.flash_attention_paged_plain(
            q, pl[0], pl[1], qo, vl, tp, **kw)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B=1 Tq=64 q_offset=64 vlen=128 {heads} BS=16 int8 K/V, "
                 "bf16 q"}
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
    calls = dict.fromkeys(COUNTERS, 0)
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


# ---------------------------------------------------------------------------
# 10: observability at full width and SMOLLM_LAYERS layers
# ---------------------------------------------------------------------------
SECTIONS = ("admit", "prefill", "decode")      # the tick's section spans
PROFILED_KERNELS = ("decode_paged_split_kernel", "softmax_topk_kernel")


def _section_ms(events, pid: int = 0) -> dict:
    """Sums of the scheduler track's section spans, and of its ticks, in
    ms of host time."""
    out = dict.fromkeys(("tick",) + SECTIONS, 0.0)
    for e in events:
        if e["ph"] == "X" and e["tid"] == 0 and e["pid"] == pid \
                and e["name"] in out:
            out[e["name"]] += e["dur"] / 1e3
    return out


def _check_trace(what: str, events, report, pids=(0,)) -> None:
    """A trace validates, holds one token instant per generated token and
    one retire per request, and nests every decode section in a tick."""
    from repro_torch.obs import report as obs_report
    problems = obs_report.validate(events)
    if problems:
        _fail(f"observability {what}: trace problems {problems[:5]}")
    inst = [e for e in events if e["ph"] == "i"]
    tokens = sum(e["name"] == "token" for e in inst)
    retires = sum(e["name"] == "retire" for e in inst)
    if tokens != report.total_tokens or retires != len(report.results):
        _fail(f"observability {what}: {tokens} token and {retires} retire "
              f"instants for {report.total_tokens} tokens and "
              f"{len(report.results)} requests")
    ticks = [e for e in events if e["ph"] == "X" and e["name"] == "tick"]
    decodes = [e for e in events if e["ph"] == "X" and e["name"] == "decode"
               and e["tid"] == 0]
    if len(decodes) != report.decode_steps or not all(
            any(t["pid"] == d["pid"] and t["ts"] <= d["ts"] and
                d["ts"] + d["dur"] <= t["ts"] + t["dur"] for t in ticks)
            for d in decodes):
        _fail(f"observability {what}: {len(decodes)} decode spans for "
              f"{report.decode_steps} steps, or one outside its tick")
    got = sorted({e["pid"] for e in events})
    if got != sorted(pids):
        _fail(f"observability {what}: pids {got}, want {list(pids)}")


def _serve_timed(params, cfg, argv):
    """One serve of ``argv`` between a reset and a read of the launch
    counts: (report, router, requests, launch counts, wall seconds)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    report, router, requests, _ = serve.run(args, cfg, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return report, router, requests, dispatch.launch_counts(), wall


def phase_observability() -> None:
    """Phase 4's paged run, in a process where ``torch.profiler`` has not
    run yet: untraced twice (the first warms up), traced with ``--trace
    FILE``, traced with ``--metrics`` too (its first decode step replayed
    under the process's first profiler session once the serve is over),
    and untraced again; each between a reset and a read of the launch
    counts, which must equal the schedulers' counters (and the replayed
    step's launches).  Streams equal bit for bit across all five; both
    traces sound, with the report's counts; the metrics counters the
    report's; each op's path ``cuda`` with the launch counts; the profiled
    step's kernels.  Then the round-robin router run with ``--trace
    DIR/``: both replica traces and the merged one valid, aligned on their
    first ticks, and the report CLI exits 0 on the merged file."""
    import tempfile
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.obs import kernels as obs_kernels
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import report as obs_report
    cfg = _smollm_config(serve.parse_args(SERVE_ARGS))
    params = transformer.init(cfg, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {w: os.path.join(tmp, f"{w}.json")
                 for w in ("traced", "metrics")}
        runs = {}
        for what, extra in (("warm-up", []), ("untraced", []),
                            ("traced", ["--trace", paths["traced"]]),
                            ("metrics", ["--trace", paths["metrics"],
                                         "--metrics"]),
                            ("after the profiler", [])):
            if what == "metrics":
                obs_metrics.reset()
                obs_kernels.reset()
            runs[what] = _serve_timed(params, cfg, SERVE_ARGS + extra)
            report, router, requests, counts, _ = runs[what]
            if what == "metrics":
                prof, snap = obs_kernels.snapshot(), obs_metrics.snapshot()
                obs_metrics.disable()
                obs_kernels.disable_profiling()
            _check_finished(f"observability {what}", report, requests,
                            cfg.vocab_size)
            want = _implied_counts(router.engines[0].scheduler,
                                   cfg.num_layers)
            if what == "metrics":       # the profile's replayed step
                want["flash_decode_paged"] += cfg.num_layers
                want["softmax_topk"] += 1
            _check_counts("paged", counts, want)
        eng = runs["metrics"][1].engines[0]
        streams = {w: {r.rid: r.tokens for r in run[0].results}
                   for w, run in runs.items()}
        if any(st != streams["warm-up"] for st in streams.values()):
            _fail("observability: streams differ between the untraced, "
                  "traced and profiled runs")
        events = {w: obs_report.load_trace(pth) for w, pth in paths.items()}
        for w, ev in events.items():
            _check_trace(w, ev, runs[w][0])
        report, counts = runs["metrics"][0], runs["metrics"][3]
        want = {"serving.tokens": report.total_tokens,
                "serving.preemptions": report.preemptions,
                "serving.occupancy": report.decode_steps}
        got = {k: snap.get(k, {}).get("count" if k.endswith("occupancy")
                                      else "value", 0) for k in want}
        if got != want:
            _fail(f"observability: metrics {got}, the report's {want}")
        launched = {k for k, n in counts.items() if n}
        if set(prof["paths"]) != launched or any(
                (p["path"], p["count"]) != ("cuda", counts[op])
                for op, p in prof["paths"].items()):
            _fail(f"observability: kernel paths {prof['paths']}, launches "
                  f"{counts}")
        cost = prof["costs"]["decode_step_paged"]
        seen = cost["kernels"]
        calls = {k: seen.get(k, {}).get("calls") for k in PROFILED_KERNELS}
        if calls != {"decode_paged_split_kernel": cfg.num_layers,
                     "softmax_topk_kernel": 1}:
            _fail(f"observability: the profiled decode step ran {calls} "
                  f"(want {cfg.num_layers} split decodes, 1 sampler); it "
                  f"saw {sorted(seen)[:40]}")
        print(f"observability paged: {report.total_tokens} tokens, "
              f"{report.decode_steps} decode steps, {report.prefill_chunks} "
              "chunks; tok/s (wall s): " + "; ".join(
                  f"{w} {run[0].tokens_per_s:.1f} ({run[4]:.2f})"
                  for w, run in runs.items())
              + f"; streams equal; traces valid ({len(events['traced'])} / "
              f"{len(events['metrics'])} events), {report.total_tokens} "
              f"token and {len(report.results)} retire instants; metrics "
              f"{got}")
        for w, ev in events.items():
            sec = _section_ms(ev)
            print(f"observability host spans, {w} run, sums over its "
                  f"ticks: tick {sec['tick']:.1f} ms = " + " + ".join(
                      f"{k} {sec[k]:.1f}" for k in SECTIONS)
                  + f" + outside sections "
                  f"{sec['tick'] - sum(sec[k] for k in SECTIONS):.1f}; "
                  f"decode {sec['decode'] / report.decode_steps:.2f} ms a "
                  f"step")
        top = sorted(seen.items(), key=lambda kv: -kv[1]["ms"])
        print(f"observability profiled decode step (B "
              f"{eng.scheduler.pool.num_slots}, the run's first, replayed "
              f"after the serve; {obs_kernels.dropped_sessions()} dropped "
              f"session(s) run again): device "
              f"{cost['device_ms']:.4f} ms over {len(seen)} kernels, bound "
              f"{cost['bound_ms']:.4f} ms (flops {cost['flops']:.4g}, bytes "
              f"{cost['bytes_accessed']:.4g}); " + "; ".join(
                  f"{k} {v['ms']:.4f} ms x{v['calls']}" for k, v in top))
        print("observability paths: " + ", ".join(
            f"{op} {p['path']} x{p['count']}"
            for op, p in prof["paths"].items()) + "; plans: " + "; ".join(
                f"{k} -> {v}" for k, v in prof["autotune"].items()))

        tdir = os.path.join(tmp, "router") + os.sep
        report, router, _, counts, _ = _serve_timed(
            params, cfg, ROUTER_ARGS + ["--no-affinity", "--trace", tdir])
        want = dict.fromkeys(COUNTERS, 0)
        for e in router.engines:
            for k, n in _implied_counts(e.scheduler, cfg.num_layers).items():
                want[k] += n
        _check_counts("paged", counts, want)
        per = [obs_report.load_trace(os.path.join(tdir, f"replica{i}.json"))
               for i in range(2)]
        for i, ev in enumerate(per):
            if obs_report.validate(ev) or {e["pid"] for e in ev} != {i}:
                _fail(f"observability router: replica {i}'s trace")
        merged = obs_report.load_trace(os.path.join(tdir, "merged.json"))
        _check_trace("router merged", merged, report, pids=(0, 1))
        firsts = [min(e["ts"] for e in merged if e["ph"] == "X"
                      and e["name"] == "tick" and e["pid"] == pid)
                  for pid in (0, 1)]
        if firsts[0] != firsts[1]:
            _fail(f"observability router: first ticks at {firsts}")
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report",
             os.path.join(tdir, "merged.json")], capture_output=True,
            text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
        if cli.returncode != 0:
            _fail(f"observability router: report CLI exit {cli.returncode}:"
                  f" {cli.stderr[-500:]}")
        secs = [_section_ms(merged, pid) for pid in (0, 1)]
        print(f"observability router: 2 replicas, {len(merged)} merged "
              f"events, pids 0 and 1, first ticks both at "
              f"{firsts[0]:.3f} us (the queued spans opened before them "
              f"start at 0), per-replica requests "
              f"{report.router['per_replica']}, {report.tokens_per_s:.1f} "
              f"tok/s traced; report CLI exit 0; host tick ms "
              + " / ".join(f"{s['tick']:.1f}" for s in secs))


def phase_observability_process() -> None:
    """Phase 10 in a child process, where ``torch.profiler`` has not run
    (this process's phases 3 and 8 start it) and whose own session ends
    with it; its lines print as it runs."""
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            "chip_smoke.phase_observability()")
    sys.stdout.flush()
    out = subprocess.run([sys.executable, "-c", code], timeout=900,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(REPO, "src")))
    if out.returncode != 0:
        _fail(f"observability: its process exited {out.returncode}")


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
    from repro_torch.obs import kernels as obs_kernels
    print(f"profiler: {obs_kernels.dropped_sessions()} session(s) of phase 3 "
          "launched kernels but recorded no device event, and ran again; "
          f"{len(PARTIAL_SESSIONS)} recorded only some of their kernels, "
          "and ran again")
    counts, serve_ctx = _timed(phase_serve)
    counts.update(_timed(phase_serve_128))
    counts.update(_timed(phase_serve_moe))
    counts.update(_timed(phase_serve_mla))
    counts.update(_timed(phase_serve_state))
    counts.update(_timed(phase_serve_whisper))
    counts.update(_timed(phase_serve_llava))
    _timed(phase_parity)
    _timed(phase_parity_128)
    _timed(phase_parity_moe)
    _timed(phase_parity_mla)
    _timed(phase_parity_state)
    _timed(phase_parity_whisper)
    _timed(phase_parity_int8)
    _timed(phase_parity_slo)
    counts["train"], train_ctx = _timed(phase_train)
    dist_counts, dist_errs, dist_rows = _timed(phase_distributed, serve_ctx,
                                               train_ctx)
    counts.update(dist_counts)
    errs.update(dist_errs)
    ma_counts, ma_errs, ma_rows = _timed(phase_model_axis)
    counts.update(ma_counts)
    errs.update(ma_errs)
    dist_rows.update(ma_rows)
    counts.update(_timed(phase_train_128))
    counts.update(_timed(phase_train_state))
    counts.update(_timed(phase_train_whisper))
    counts.update(_timed(phase_train_llava))
    _timed(phase_train_parity)
    _timed(phase_train_parity_128)
    _timed(phase_train_parity_state)
    _timed(phase_train_parity_whisper)
    _timed(phase_parity_llava)
    times = _timed(phase_times)
    times.update(dist_rows)
    _timed(phase_steps, serve_ctx, train_ctx)
    _timed(phase_swap_times, serve_ctx)
    counts["library"], lib_errs = _timed(phase_library)
    errs.update(lib_errs)
    _timed(phase_observability_process)
    kernels = []
    entries = [(name, name, KERNEL_PATH[name], name) for name in KERNELS]
    entries += [(name, kernel, path, (key or [kernel])[0])
                for name, (kernel, path, *key) in INSTANCES.items()]
    for name, kernel, path, key in entries:
        row, meta = times[name], KERNELS[kernel]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "path": path,
            "launches": counts[path][key] if path in counts else 0,
            "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "wrapper_ms": row["wrapper_ms"],
            **{k: row[k] for k in ("device_ms", "library_device_ms")
               if k in row}})
    print(f"profiler: {len(DROPPED_STEP_SESSIONS)} session(s) of the step "
          "lines recorded no device time, and ran again")
    print(f"chip_smoke: {time.perf_counter() - START:.1f}s in all")
    # again at the end, beside the numbers, where a reader of the last
    # lines of the output finds it
    print(f"nvidia-smi: {_smi()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
