"""Training launcher of the port: ``python -m repro_torch.launch.train --arch
smollm_360m [--smoke] [--device cpu]``.

Trains a decoder on the deterministic synthetic stream with AdamW,
checkpointing every ``--checkpoint-every`` steps and at the end, and
resuming from the newest committed checkpoint in ``--checkpoint-dir`` when
one exists.  Prints a line every ``log_every`` steps and ends with
``first loss … → last loss …``.  The model runs on the card unless
``--device cpu`` asks for the CPU, where the kernels' plain versions run.

Port of ``src/repro/launch/train.py`` (``main`` at line 23, the mesh at
51-74), with the reference's flags; ``--layers`` (cut the depth, keep the
width) is the port's own.

``--mesh DxM`` trains over a (data D, model M) mesh of D·M ranks: one
process a rank, under ``torchrun --nproc-per-node D·M`` on a machine with
that many cards (or one process for ``--mesh 1x1``; on the CPU, inside a
gloo world of D·M processes).  The model axis runs a dense, MoE, MLA or
recurrent decoder tensor-parallel (``distributed/tensor_parallel.py``):
attention in heads mode where the query heads split over M, else in
sequence mode; the MoE experts split over M where their padded count
divides it, else each expert's ffn; zamba2's Mamba2 blocks over their SSM
heads (the gated norm's sum of squares summed over the ranks), its shared
block as a dense layer; xLSTM's mLSTM inner channels (the cell whole on
every rank) and its sLSTM ffn; the placements of ``sharding.axis_rules``;
data-parallel gradient sums run over the data axis as before.  Without a
process group the launcher initialises one, from torchrun's environment
(``RANK``, ``WORLD_SIZE``; ``cuda:LOCAL_RANK``) or, where that is absent,
a world of 1 through a ``FileStore`` in a temporary directory; a group
already present (a test's spawned workers) is used as it is.  The backend is NCCL on the card and
gloo with ``--device cpu`` only; a group of the other backend raises.  The
launcher builds the (data, model) ``DeviceMesh`` (``launch.mesh``),
draws the full parameters from the seed on every rank and keeps the
rank's model-axis shards, broadcasts data rank 0's over the data axis,
feeds each rank its rows through ``HostShardedLoader`` (by its data index)
and runs the loop under the ``ShardContext``, where the train step
all-reduces the gradients over the data axis.  At a checkpoint every rank
gathers the full state and rank 0 (data 0, model 0) alone writes it;
every rank reads it and keeps its shards.  M > 1 with an
encoder-decoder or VLM config raises ``NotImplementedError``
(``tensor_parallel.MISSING``), and a placement whose dim does not split
over M, or that would cut a Mamba2 head across ranks, raises
``ValueError`` naming the leaf (``tensor_parallel.check_splits``), both
before anything is initialised.

An MLA model (``--arch minicpm3_4b``) trains like the others: its
decompressed attention (Dqk 96, Dv 64) runs the fresh forward's and the
backward's (96, 64) instances on the card and their plain versions on the
CPU.  The recurrent decoders (``--arch zamba2_1p2b``, ``--arch
xlstm_125m``) train the same way, autograd through their plain PyTorch
scans: zamba2's shared attention block, called after every 6 Mamba2
layers and once more to close the stack, runs the fresh forward and its
backward at D 64, G 1 at every call; xlstm runs no attention kernel.
The VLM (``--arch llava_next_34b``) trains on the text alone, as the
reference's CLI trains it: the stream carries no patch embeddings.

The encoder-decoder (``--arch whisper_small``) is refused before anything
is initialised: the synthetic stream carries tokens and labels only, and
its loss needs frames.  The reference's CLI takes the same stream and
fails in ``encdec.loss_fn`` on ``batch["frames"]``; the port says so.
It trains through ``training.train_step`` (``init_state``,
``make_train_step``, ``training.loop.run``) with a batch ``{frames
[B, S_enc, D], tokens, labels}``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import NamedTuple, Optional

import repro_torch.configs as configs
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig)
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.training import loop
from repro_torch.training.train_step import init_state, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers (0 = "
                         "keep it)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="save every N steps and after the last (0 = never "
                         "save)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 → mesh (data=2, model=2): data-parallel "
                         "over 2 ranks, a dense, MoE, MLA or recurrent "
                         "decoder tensor-parallel over 2 (torchrun); "
                         "default: one process, no mesh")
    return ap


def mesh_dims(spec: str) -> tuple:
    """``"DxM"`` (or ``"D"``) → (D, M)."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) == 1:
        dims += (1,)
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError(f"--mesh {spec}: want DxM, e.g. 4x1")
    return dims


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.mesh:
        from repro_torch.distributed import sharding, tensor_parallel as tp
        n_data, n_model = mesh_dims(args.mesh)
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get(args.arch))
        if cfg.family in tp.MISSING and n_model > 1:
            raise NotImplementedError(
                f"--mesh {args.mesh}: the model axis runs the dense, MoE, "
                f"MLA and recurrent decoders only; {cfg.name} "
                f"({cfg.family}) lacks {tp.MISSING[cfg.family]}")
        if cfg.family not in tp.MISSING:
            sizes = {"data": n_data, "model": n_model}
            tp.placements(cfg, sharding.derive_parallel(cfg, sizes), sizes)
    return args


def run_config(args: argparse.Namespace) -> RunConfig:
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if cfg.family == "encdec":
        raise SystemExit(
            f"{args.arch}: the synthetic stream carries tokens and labels "
            "only, no frames, and the encoder-decoder's loss needs them; "
            "train it through repro_torch.training.train_step (init_state, "
            "make_train_step, training.loop.run) with a batch {frames "
            "[B, S_enc, D], tokens, labels}")
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    return RunConfig(
        model=cfg,
        optimizer=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps),
        parallel=ParallelConfig(microbatches=args.microbatches),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
    )


def train(args: argparse.Namespace, *, log=print):
    """Initialise (or restore) and train.  Returns (params, opt_state,
    history, run config)."""
    run_cfg = run_config(args)
    cfg = run_cfg.model
    ds = SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.real_vocab_size or cfg.vocab_size,
        seq_len=args.seq_len, global_batch=args.global_batch,
        seed=run_cfg.seed))
    if args.mesh:
        return _train_mesh(args, run_cfg, ds, log=log)
    params, opt_state = init_state(run_cfg, device=args.device)
    params, opt_state, history = loop.run(
        run_cfg, steps=args.steps, train_step=make_train_step(run_cfg),
        params=params, opt_state=opt_state, dataset=ds, log=log)
    return params, opt_state, history, run_cfg


class ProcessGroup(NamedTuple):
    """A ``--mesh`` run's process group: its backend, the rank's device,
    whether ``process_group`` initialised it (and so destroys it), and the
    temporary directory of its ``FileStore`` (None for torchrun's or a
    caller's group)."""
    backend: str
    device: str
    created: bool
    store_dir: Optional[str]


def process_group(device: str) -> ProcessGroup:
    """The process group of a ``--mesh`` run, NCCL for a card and gloo for
    ``--device cpu``.  An existing group must be of that backend."""
    import torch
    import torch.distributed as dist
    cpu = torch.device(device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(f"--mesh on {device}: no CUDA device (the CPU "
                           "runs only with --device cpu)")
    created, store_dir = True, None
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"--mesh on {device} needs a {backend} process "
                             f"group, found {have}")
        created = False
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:                                # a world of one, no network
        store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
        store = dist.FileStore(os.path.join(store_dir, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    if not cpu:
        index = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        device = f"cuda:{index}"
    return ProcessGroup(backend, device, created, store_dir)


def _train_mesh(args, run_cfg, ds, *, log=print):
    """``train`` over a (data, model) mesh: steps under the
    ``ShardContext`` on each rank's model-axis shards, data rank 0's
    parameters broadcast over the data axis first."""
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.data.synthetic import HostShardedLoader
    from repro_torch.distributed import context, sharding, tensor_parallel
    from repro_torch.launch import mesh as mesh_mod
    n_data, n_model = mesh_dims(args.mesh)
    pg = process_group(args.device)
    try:
        mesh = mesh_mod.make_debug_mesh(
            n_data, n_model, device_type="cpu" if pg.backend == "gloo"
            else "cuda")
        par = sharding.derive_parallel(run_cfg.model, mesh, run_cfg.parallel)
        ctx = context.ShardContext(mesh=mesh, par=par)
        loader = HostShardedLoader(
            ds, host_id=context.axis_index(mesh, par.data_axes),
            num_hosts=context.axis_size(mesh, par.data_axes))
        rank = dist.get_rank()
        with context.use(ctx):
            params, opt_state = init_state(run_cfg, device=pg.device)
            data = context.group(mesh, par.data_axes)
            src = dist.get_global_rank(data, 0)
            for leaf in tree.leaves(params):
                dist.broadcast(leaf.data, src=src, group=data)
            params, opt_state, history = loop.run(
                run_cfg, steps=args.steps,
                train_step=make_train_step(run_cfg), params=params,
                opt_state=opt_state, dataset=loader, writer=rank == 0,
                log=log if rank == 0 else (lambda _: None),
                sharding=tensor_parallel.state_sharding(run_cfg.model))
    finally:
        if pg.created:
            dist.destroy_process_group()
        if pg.store_dir is not None:
            shutil.rmtree(pg.store_dir, ignore_errors=True)
    return params, opt_state, history, run_cfg


def main(argv=None) -> int:
    _, _, history, _ = train(parse_args(argv))
    losses = [h["loss"] for h in history if "loss" in h]
    if losses:
        print(f"first loss {losses[0]:.4f} → last loss {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
