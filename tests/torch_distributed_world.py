"""The port's distributed layer in one gloo world of 4 CPU processes.

``python tests/torch_distributed_world.py INPUTS.npz OUT_DIR`` spawns 4
ranks (``torch.multiprocessing``; the address is a ``FileStore`` in
OUT_DIR, no network) and runs every check of
``tests/test_torch_distributed.py`` that needs more than one rank, over
the meshes (2, 2), (1, 4) and (4, 1) built from the same 4 ranks: the
data-parallel step, and the model axis's steps (``MODEL_AXIS_CASES``: the
dense, MoE, MLA and recurrent decoders), its CLI runs and its
crash-restarts.  Each
rank writes what it computed to ``OUT_DIR/rank{r}.pt``; the test compares
those with the reference's (run apart, with 4 forced host devices) and
with the port's single-process results, which ranks compute here outside
any context (``SINGLE_RANK``).  JAX is not imported here.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
MESHES = ((2, 2), (1, 4), (4, 1))
TOP_K = 5
DP_CASES = ("equal", "unequal", "bf16")
#: the 2-layer smoke configs of the model axis's checks, by the prefix of
#: their weights in the inputs: (arch, changes to the config; "moe" changes
#: its MoEConfig).  qwen2-moe's 6 experts unpadded (E 6) do not split over
#: 4 ranks, so they run in ffn mode; minicpm3 with 3 heads runs sequence
#: mode; zamba2's 8 SSM heads of 16 and 4 attention heads, xlstm's mLSTM
#: and sLSTM layer.  The reference's subprocess builds the same configs.
VARIANTS = {
    "w": ("smollm_360m", {}),
    "wm": ("mistral_nemo_12b", {}),
    "wq": ("qwen2_moe_a2p7b", {}),
    "wq6": ("qwen2_moe_a2p7b", {"moe": {"pad_experts_to": 0}}),
    "wl": ("llama4_scout_17b_a16e", {}),
    "wc": ("minicpm3_4b", {}),
    "wc3": ("minicpm3_4b", {"num_heads": 3, "num_kv_heads": 3}),
    "wz": ("zamba2_1p2b", {}),
    "wx": ("xlstm_125m", {}),
}
#: the rank that takes each variant's unsharded step (smollm's is rank 0's
#: ``single_equal``)
SINGLE_RANK = {"wm": 1, "wq": 2, "wq6": 3, "wl": 1, "wc": 2, "wc3": 3,
               "wz": 0, "wx": 0}
#: the model axis's one-step checks: name → (the variant, mesh, remat);
#: smollm's 3 heads shard in sequence mode at M 2 and 4, mistral-nemo's 4
#: heads in heads mode (its 2 kv heads shard at M 2 and are expanded to
#: the query heads at M 4); qwen2-moe's 8 padded experts split 2 a rank at
#: M 4 (the 2 pads on rank 3) and 4 at M 2, its 6 unpadded ones in ffn
#: mode (24 of 96 columns an expert at M 4); llama4-scout's 4 experts top
#: 1, its 2 kv heads expanded at M 4 and sharded at M 2; minicpm3's 4 MLA
#: heads in heads mode, 3 in sequence mode through rows 6m / 7m at offsets;
#: zamba2's Mamba2 blocks over their SSM heads (2 a rank at M 4) with its
#: shared block in heads mode; xlstm's mLSTM inner channels and sLSTM ffn
#: (its 2 heads make the mode "sequence" at M 4, but it has no attention;
#: its mLSTM gathers the cell's inputs)
MODEL_AXIS_CASES = {
    "smollm_1x4": ("w", (1, 4), "full"),
    "smollm_2x2": ("w", (2, 2), "full"),
    "mistral_2x2": ("wm", (2, 2), "full"),
    "mistral_1x4": ("wm", (1, 4), "full"),
    "smollm_block_1x4": ("w", (1, 4), "block"),
    "qwen2_1x4": ("wq", (1, 4), "full"),
    "qwen2_2x2": ("wq", (2, 2), "full"),
    "qwen2e6_1x4": ("wq6", (1, 4), "full"),
    "llama4_1x4": ("wl", (1, 4), "full"),
    "llama4_2x2": ("wl", (2, 2), "full"),
    "minicpm3_1x4": ("wc", (1, 4), "full"),
    "minicpm3_2x2": ("wc", (2, 2), "full"),
    "minicpm3h3_1x4": ("wc3", (1, 4), "full"),
    "zamba2_1x4": ("wz", (1, 4), "full"),
    "zamba2_2x2": ("wz", (2, 2), "full"),
    "xlstm_1x4": ("wx", (1, 4), "full"),
    "xlstm_2x2": ("wx", (2, 2), "full"),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _mesh(shape):
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.make_debug_mesh(*shape, device_type="cpu")


def _ctx(mesh, **kw):
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import context
    return context.ShardContext(mesh=mesh, par=ParallelConfig(), **kw)


def _rows(mesh, b):
    """This rank's rows of a batch of ``b`` over the data axis."""
    from repro_torch.distributed import context
    n = context.axis_size(mesh, ("data",))
    i = context.axis_index(mesh, ("data",))
    return slice(i * b // n, (i + 1) * b // n)


def _seq(mesh, s):
    from repro_torch.distributed import context
    n = context.axis_size(mesh, ("model",))
    i = context.axis_index(mesh, ("model",))
    return slice(i * s // n, (i + 1) * s // n)


def decode_checks(inp, out, meshes):
    """sharded_decode_attention over each mesh, fp32 and int8 caches."""
    from repro_torch.distributed.decode_attention import \
        sharded_decode_attention
    q, vlen = _t(inp["dec_q"]), _t(inp["dec_vlen"])
    for shape in MESHES[:2]:
        mesh = meshes[shape]
        r, s = _rows(mesh, q.shape[0]), _seq(mesh, inp["dec_k"].shape[1])
        common = dict(mesh=mesh, seq_axes=("model",), batch_axes=("data",),
                      chunk_size=16, scale=q.shape[-1] ** -0.5)
        out[f"decode_fp_{shape}"] = (r, sharded_decode_attention(
            q[r], _t(inp["dec_k"])[r, s], _t(inp["dec_v"])[r, s], vlen[r],
            **common))
        out[f"decode_int8_{shape}"] = (r, sharded_decode_attention(
            q[r], _t(inp["dec_k8"])[r, s], _t(inp["dec_v8"])[r, s], vlen[r],
            k_scale=_t(inp["dec_ks"]).to(torch.bfloat16)[r, s],
            v_scale=_t(inp["dec_vs"]).to(torch.bfloat16)[r, s], **common))


def sample_checks(inp, out, meshes):
    """sharded_topk_sample over each mesh with the reference's Gumbels
    (the same key on every shard: each data shard draws [B_local, k]), and
    the tokens gathered from every rank."""
    from repro_torch.distributed.decode_attention import sharded_topk_sample
    logits = _t(inp["smp_logits"])
    for shape in MESHES[:2]:
        mesh = meshes[shape]
        r = _rows(mesh, logits.shape[0])
        tok, probs = sharded_topk_sample(
            logits[r], TOP_K, mesh=mesh, batch_axes=("data",),
            noise=_t(inp[f"smp_noise_{shape[0]}"]))
        every = [torch.empty_like(tok) for _ in range(WORLD)]
        dist.all_gather(every, tok)
        out[f"sample_{shape}"] = (r, tok, probs, torch.stack(every))
    # a generator seeded alike on every rank: the rows of one draw for the
    # whole batch, as one process would sample
    mesh = meshes[(2, 2)]
    r = _rows(mesh, logits.shape[0])
    tok, _ = sharded_topk_sample(
        logits[r], TOP_K, mesh=mesh, batch_axes=("data",),
        generator=torch.Generator().manual_seed(5))
    out["sample_generator"] = (r, tok)


def int8_checks(inp, out):
    from repro_torch.distributed import compression
    rank = dist.get_rank()
    x = _t(inp["i8_x"][rank])
    q, scale = compression._quantize(x)
    out["int8_own"] = (q, scale, compression.int8_allreduce(x))
    out["int8_replicated"] = compression.int8_allreduce(_t(inp["i8_x"][0]))


def variant(prefix, configs):
    """``VARIANTS[prefix]``'s 2-layer smoke config from ``configs`` (the
    port's or the reference's package)."""
    import dataclasses
    arch, changes = VARIANTS[prefix]
    cfg = configs.get_smoke(arch).replace(num_layers=2)
    changes = dict(changes)
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
    return cfg.replace(**changes)


def _run(dtype, prefix="w", remat="full"):
    from repro_torch import configs
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig)
    cfg = variant(prefix, configs).replace(remat=remat)
    return RunConfig(model=cfg, optimizer=OptimizerConfig(
        lr=1e-3, warmup_steps=0, schedule="constant"),
        parallel=ParallelConfig(grad_reduce_dtype=dtype))


def _start(inp, run, prefix="w"):
    from repro_torch import tree
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim import adamw
    ref = {k[len(prefix) + 1:]: v for k, v in inp.items()
           if k.startswith(prefix + "/")}
    params = params_from_numpy(_unflat(ref), device="cpu")
    params = tree.map(lambda p: p.requires_grad_(True), params)
    return params, adamw.init(params)


def _unflat(flat: dict) -> dict:
    """{"a/b/0/c": array} → nested dicts and lists (the reference's layout:
    integer keys are list indices)."""
    root: dict = {}
    for path, v in flat.items():
        node, keys = root, path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(root)


def _batch(inp, case):
    return {k: _t(inp[f"dp_{case}_{k}"]) for k in ("tokens", "labels")}


def _flat(params):
    from repro_torch import tree
    return {p: v.detach().clone() for p, v in tree.leaves_with_path(params)}


def _step(run, params, opt, batch):
    """One train step; returns (params, metrics, the gradients AdamW
    took)."""
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import make_train_step
    seen = {}
    update = adamw.update

    def spy(grads, *a, **kw):
        seen["grads"] = _flat(grads)
        return update(grads, *a, **kw)
    adamw.update = spy
    try:
        params, _, m = make_train_step(run)(params, opt, batch)
    finally:
        adamw.update = update
    return params, m, seen["grads"]


def train_checks(inp, out, meshes):
    """One data-parallel step on (4, 1) per case; rank 0 also takes the
    single-process step on the whole batch.  Whether the ranks end equal
    is read through a MAX / MIN all-reduce of every leaf."""
    from repro_torch import tree
    from repro_torch.distributed import context
    rank = dist.get_rank()
    for case in DP_CASES:
        run = _run("bfloat16" if case == "bf16" else "float32")
        batch = _batch(inp, case)
        if rank == 0:
            params, opt = _start(inp, run)
            params, m, grads = _step(run, params, opt, batch)
            out[f"single_{case}"] = (_flat(params), float(m["loss"]), grads)
        mesh = meshes[(4, 1)]
        r = _rows(mesh, batch["tokens"].shape[0])
        params, opt = _start(inp, run)
        with context.use(_ctx(mesh)):
            params, m, grads = _step(run, params, opt,
                                     {k: v[r] for k, v in batch.items()})
        same = True
        for leaf in tree.leaves(params):
            hi, lo = leaf.detach().clone(), leaf.detach().clone()
            dist.all_reduce(hi, op=dist.ReduceOp.MAX)
            dist.all_reduce(lo, op=dist.ReduceOp.MIN)
            same = same and torch.equal(hi, lo)
        out[f"dp_{case}"] = (_flat(params) if rank == 0 else None,
                             float(m["loss"]), same,
                             grads if rank == 0 else None)


class _Routes:
    """The routing of every ``moe_route`` call while it is entered: each
    call's (idx, keep) in call order (a layer's forward, then its
    recomputation under remat "full")."""

    def __enter__(self):
        from repro_torch.models import layers
        self.seen, self.route = [], layers.moe_route

        def spy(*a, **kw):
            r = self.route(*a, **kw)
            self.seen.append((r.idx.detach().clone(), r.keep.clone()))
            return r
        layers.moe_route = spy
        return self.seen

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.moe_route = self.route


def _aux(m):
    return {k: float(v) for k, v in m.items() if k.startswith("moe_")}


def model_axis_checks(inp, out, meshes):
    """One step of each ``MODEL_AXIS_CASES`` case from the full fp32
    weights: every rank keeps its model-axis shards, steps on its data
    rows, and gathers the updated parameters and the gradients AdamW took
    over the model axis; rank 0 keeps them, every rank its loss, its MoE
    aux losses and routing.  ``SINGLE_RANK`` takes each variant's
    unsharded step (smollm's is rank 0's ``single_equal``).  The
    collectives of each step are counted."""
    from repro_torch.distributed import sharding, tensor_parallel
    from repro_torch.distributed import context
    from repro_torch.optim import adamw
    rank = dist.get_rank()
    batch = _batch(inp, "equal")
    for prefix, owner in SINGLE_RANK.items():
        if rank == owner:
            run = _run("float32", prefix)
            params, opt = _start(inp, run, prefix)
            with _Routes() as routes:
                params, m, grads = _step(run, params, opt, batch)
            out[f"single_{prefix}"] = (_flat(params), float(m["loss"]),
                                       grads, _aux(m), routes,
                                       float(m["grad_norm"]))
    for name, (prefix, shape, remat) in MODEL_AXIS_CASES.items():
        run = _run("float32", prefix, remat)
        mesh = meshes[shape]
        par = sharding.derive_parallel(run.model, mesh, run.parallel)
        place = tensor_parallel.placements(run.model, par, mesh)
        params, _ = _start(inp, run, prefix)
        params = tensor_parallel.shard_tree(params, place, mesh)
        r = _rows(mesh, batch["tokens"].shape[0])
        tensor_parallel.reset_collectives()
        with context.use(context.ShardContext(mesh=mesh, par=par)):
            experts = ("ffn" if tensor_parallel.model_axis(run.model)
                       .shards("expert_ffn") else "expert")
            with _Routes() as routes:
                params, m, grads = _step(run, params, adamw.init(params),
                                         {k: v[r] for k, v in batch.items()})
            counts = dict(tensor_parallel.collectives)
            full = tensor_parallel.gather_tree(params, place, mesh)
            g_full = tensor_parallel.gather_tree(
                _unflat_paths(grads, params), place, mesh)
        out[f"ma_{name}"] = (_flat(full) if rank == 0 else None,
                             float(m["loss"]), _flat(g_full)
                             if rank == 0 else None, par.attn_mode, counts,
                             experts, _aux(m), (r, routes),
                             float(m["grad_norm"]))


def _unflat_paths(flat: dict, like):
    """{"a/0/b": tensor} (``_flat``'s) → a tree shaped like ``like``."""
    from repro_torch import tree
    return tree.unflatten(like, [flat[p] for p, _ in
                                 tree.leaves_with_path(like)])


def model_axis_cli_checks(out_dir, out, arch="smollm_360m", tag="",
                          cli=True, restart=True, saved=False):
    """``launch.train --mesh 2x2`` on ``arch``'s smoke config for 3 steps
    beside rank 0's unsharded run of the same flags (with ``saved``, each
    writes its state at step 3, and rank 0 compares the two checkpoints
    leaf by leaf: the sharded run's gathered whole); then a crash at step
    3 (after the step-2 checkpoint) and a restart to step 4 against an
    uninterrupted 4-step run, each rank's final shards compared bit for
    bit.  ``tag`` suffixes the keys."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import context
    from repro_torch.launch import train
    from repro_torch.training import loop
    rank = dist.get_rank()
    flags = ["--arch", arch, "--smoke", "--device", "cpu",
             "--seq-len", "16", "--global-batch", "8"]

    def go(extra, ckpt):
        return train.train(train.parse_args(
            flags + extra + ["--checkpoint-dir",
                             os.path.join(out_dir, ckpt + tag)]),
            log=lambda _: None)
    if cli:
        every = ["--checkpoint-every", "3" if saved else "0"]
        _, _, hist, _ = go(["--steps", "3", "--mesh", "2x2"] + every,
                           "ma_cli")
        out["ma_cli" + tag] = [h["loss"] for h in hist]
        if rank == 0:
            with context.use(None):
                _, _, hist, _ = go(["--steps", "3"] + every, "ma_cli_single")
            out["ma_cli_single" + tag] = [h["loss"] for h in hist]
            if saved:
                out["ma_saved" + tag] = _compare_saved(*(
                    os.path.join(out_dir, d + tag, "step_3", "arrays.npz")
                    for d in ("ma_cli", "ma_cli_single")))
    if not restart:
        return
    restart = ["--steps", "4", "--mesh", "2x2", "--checkpoint-every", "2"]
    want, _, _, _ = go(restart, "ma_whole")

    class Boom(RuntimeError):
        pass

    def bomb(i):
        if i == 3:
            raise Boom()
    run = loop.run
    loop.run = lambda *a, **kw: run(*a, inject_failure=bomb, **kw)
    try:
        go(restart, "ma_crash")
        crashed = False
    except Boom:
        crashed = True
    finally:
        loop.run = run
    dist.barrier()
    if rank == 0:                  # the step-2 write ends in its thread
        ckpt = CheckpointManager(os.path.join(out_dir, "ma_crash" + tag))
        for _ in range(600):
            if ckpt.latest_step() == 2:
                break
            time.sleep(0.05)
    dist.barrier()
    got, _, hist, _ = go(restart, "ma_crash")
    from repro_torch import tree
    out["ma_restart" + tag] = (crashed, [h["step"] for h in hist], all(
        torch.equal(a, b) and b.requires_grad
        for a, b in zip(tree.leaves(want), tree.leaves(got))))


def _compare_saved(got_path, want_path):
    """{leaf: (its shape in each checkpoint, max |got − want|, max |want|)}
    of two checkpoints' arrays."""
    with np.load(got_path) as got, np.load(want_path) as want:
        return {k: (got[k].shape, want[k].shape,
                    float(np.abs(got[k] - want[k]).max()),
                    float(np.abs(want[k]).max()))
                for k in sorted(set(got.files) | set(want.files))
                if k in got.files and k in want.files} | {
            k: None for k in set(got.files) ^ set(want.files)}


def model_axis_refusals(out):
    """``--mesh 1x2`` on each family the model axis lacks."""
    from repro_torch.launch import train
    res = {}
    for arch in ("whisper_small", "llava_next_34b"):
        try:
            train.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                              "--mesh", "1x2"])
            res[arch] = "no error"
        except NotImplementedError as e:
            res[arch] = f"NotImplementedError: {e}"
    out["ma_refusals"] = res


def lockstep_checks(inp, out, meshes):
    """The lockstep loop under (1, 4) and (2, 2) (fp, and int8 on (1, 4)),
    each rank's rows; rank 1 runs the unsharded fp loop and rank 2 the
    int8 one, outside any context."""
    from repro_torch import configs
    from repro_torch.distributed import context
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    rank = dist.get_rank()
    cfg = configs.get_smoke("smollm_360m")
    params = transformer.init(cfg, seed=0, device="cpu")
    prompts = inp["ls_prompts"]
    noise = inp["ls_noise"]

    def argv(kv):
        return serve.parse_args(
            ["--arch", "smollm_360m", "--smoke", "--device", "cpu",
             "--batch", str(prompts.shape[0]), "--prompt-len",
             str(prompts.shape[1]), "--tokens", str(noise.shape[0]),
             "--max-len", "20"] + (["--kv-cache-dtype", kv] if kv else []))

    def go(kv):
        a = argv(kv)
        return serve.lockstep(a, serve.config_for(a), params, prompts=prompts,
                              noise_fn=lambda i: noise[i])
    if rank in (1, 2):
        kv = "" if rank == 1 else "int8"
        with context.use(None):
            out[f"lockstep_single_{kv or 'fp'}"] = go(kv)
    for shape, kv in (((1, 4), ""), ((2, 2), ""), ((1, 4), "int8")):
        mesh = meshes[shape]
        with context.use(_ctx(mesh)):
            ids = go(kv)
        out[f"lockstep_{kv or 'fp'}_{shape}"] = (
            _rows(mesh, prompts.shape[0]), ids)


def cli_checks(out_dir, out):
    """``launch.train --mesh 4x1 --device cpu`` in this world: who saved."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train
    saves = []
    orig = CheckpointManager.save

    def save(self, step, state):
        saves.append(step)
        return orig(self, step, state)
    CheckpointManager.save = save
    try:
        _, _, hist, _ = train.train(train.parse_args(
            ["--arch", "smollm_360m", "--smoke", "--device", "cpu",
             "--steps", "2", "--seq-len", "16", "--global-batch", "8",
             "--mesh", "4x1", "--checkpoint-dir",
             os.path.join(out_dir, "ckpt")]), log=lambda _: None)
    finally:
        CheckpointManager.save = orig
    out["cli"] = (saves, [h["loss"] for h in hist])


def refusal_checks(out):
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    pg = train.process_group("cpu")
    res = {"cpu": (pg.backend, pg.device, pg.created)}
    for what, fn in (("cuda", lambda: train.process_group("cuda")),
                     ("mesh 2x4", lambda: mesh_mod.make_debug_mesh(
                         2, 4, device_type="cpu"))):
        try:
            fn()
            res[what] = "no error"
        except (RuntimeError, ValueError) as e:
            res[what] = f"{type(e).__name__}: {e}"
    out["refusals"] = res


def worker(rank, inputs, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    inp = dict(np.load(inputs))
    out = {}
    meshes = {shape: _mesh(shape) for shape in MESHES}
    decode_checks(inp, out, meshes)
    sample_checks(inp, out, meshes)
    int8_checks(inp, out)
    train_checks(inp, out, meshes)
    lockstep_checks(inp, out, meshes)
    cli_checks(out_dir, out)
    refusal_checks(out)
    model_axis_checks(inp, out, meshes)
    model_axis_cli_checks(out_dir, out)
    model_axis_cli_checks(out_dir, out, "qwen2_moe_a2p7b", "_qwen2",
                          restart=False, saved=True)
    model_axis_cli_checks(out_dir, out, "minicpm3_4b", "_minicpm3",
                          cli=False)
    model_axis_cli_checks(out_dir, out, "zamba2_1p2b", "_zamba2",
                          restart=False, saved=True)
    model_axis_cli_checks(out_dir, out, "xlstm_125m", "_xlstm", cli=False)
    model_axis_refusals(out)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def main(argv) -> int:
    inputs, out_dir = argv
    os.makedirs(out_dir, exist_ok=True)
    mp.spawn(worker, args=(inputs, out_dir), nprocs=WORLD, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
