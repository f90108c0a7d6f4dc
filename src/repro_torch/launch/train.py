"""Training launcher of the port: ``python -m repro_torch.launch.train --arch
smollm_360m [--smoke] [--device cpu]``.

Trains a decoder on the deterministic synthetic stream with AdamW,
checkpointing every ``--checkpoint-every`` steps and at the end, and
resuming from the newest committed checkpoint in ``--checkpoint-dir`` when
one exists.  Prints a line every ``log_every`` steps and ends with
``first loss … → last loss …``.  The model runs on the card unless
``--device cpu`` asks for the CPU, where the kernels' plain versions run.

Port of ``src/repro/launch/train.py`` (``main`` at line 23), with the
reference's flags; ``--layers`` (cut the depth, keep the width) is the
port's own.  ``--mesh`` is not ported yet (the distributed slice) and says
so.  An MLA model (``--arch minicpm3_4b``) trains like the others: its
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
import tempfile

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
                    help="not ported yet (the distributed slice)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet (distributed)")
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
    params, opt_state = init_state(run_cfg, device=args.device)
    ds = SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.real_vocab_size or cfg.vocab_size,
        seq_len=args.seq_len, global_batch=args.global_batch,
        seed=run_cfg.seed))
    params, opt_state, history = loop.run(
        run_cfg, steps=args.steps, train_step=make_train_step(run_cfg),
        params=params, opt_state=opt_state, dataset=ds, log=log)
    return params, opt_state, history, run_cfg


def main(argv=None) -> int:
    _, _, history, _ = train(parse_args(argv))
    losses = [h["loss"] for h in history if "loss" in h]
    if losses:
        print(f"first loss {losses[0]:.4f} → last loss {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
