"""Fault-tolerant training loop: checkpoint/restart, straggler watchdog,
heartbeats, crash-exact data resumption — the port of
``src/repro/training/loop.py`` (lines 36-109).

The loop is an idempotent function of (checkpoint dir, step): ``run``
restores the newest COMMITTED checkpoint, and the counter-based data
pipeline regenerates exactly the next batch, so a run killed at any step and
restarted ends with the parameters of an uninterrupted one.
``inject_failure`` lets tests crash the loop at a chosen step.

On the model axis (``sharding``, a ``tensor_parallel.StateSharding``) the
state in memory is this rank's shards: at a checkpoint step every rank
gathers the full state (a collective) and the writer alone saves it, so a
checkpoint is the same file whatever the mesh; a restore reads the full
state and keeps this rank's shards.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.obs import clock as obs_clock


class StragglerWatchdog:
    """Flags steps slower than ``factor`` × running median."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.events: list[dict] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        med = float(np.median(self.times))
        if len(self.times) >= 5 and dt > self.factor * med:
            self.events.append({"step": step, "dt": dt, "median": med})
            return True
        return False


def run(run_cfg: RunConfig, *, steps: int, train_step: Callable,
        params, opt_state, dataset: SyntheticDataset,
        inject_failure: Optional[Callable[[int], None]] = None,
        log: Callable[[str], None] = print, writer: bool = True,
        sharding=None):
    """Run ``steps`` optimizer steps with checkpoint/restart semantics.

    Returns (params, opt_state, history).  Restores from the newest committed
    checkpoint in ``run_cfg.checkpoint_dir`` if one exists (restart path).
    Saves every ``checkpoint_every`` steps and after the last, or never
    when ``checkpoint_every`` is 0.  Batches go to the parameters'
    device.  ``writer`` False (every rank but rank 0) reads the checkpoints
    and writes neither them nor the heartbeat.  ``sharding``: the state's
    model-axis sharding, or None for a whole state."""
    ckpt = CheckpointManager(run_cfg.checkpoint_dir,
                             keep=run_cfg.keep_checkpoints)
    device = tree.leaves(params)[0].device
    watchdog = StragglerWatchdog()
    hb_path = os.path.join(run_cfg.checkpoint_dir, "heartbeat")

    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        log(f"[restore] resuming from committed step {latest}")
        state = {"params": params, "opt": opt_state}
        if sharding is not None:
            state = sharding.gather(state)      # the full tree's shapes
        state = ckpt.restore(latest, state)
        if sharding is not None:
            state = sharding.shard(state)
            state["params"] = tree.map(
                lambda new, old: new.requires_grad_(old.requires_grad),
                state["params"], params)
        params, opt_state = state["params"], state["opt"]
        start = latest

    history = []
    step = start
    while step < steps:
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in dataset.batch(step).items()}
        if inject_failure is not None:
            inject_failure(step)          # may raise — simulated node death
        t0 = obs_clock.monotonic()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()
                   if np.ndim(v) == 0}
        dt = obs_clock.monotonic() - t0
        if watchdog.observe(step, dt):
            log(f"[straggler] step {step} took {dt:.3f}s "
                f"(median {np.median(watchdog.times):.3f}s)")
        if writer:
            with open(hb_path, "w") as f:
                json.dump({"step": step, "t": obs_clock.wall_time()}, f)
        history.append({"step": step, "dt": dt, **metrics})
        if step % run_cfg.log_every == 0:
            log(f"[step {step}] loss={metrics.get('loss', float('nan')):.4f} "
                f"dt={dt * 1e3:.1f}ms")
        step += 1
        if run_cfg.checkpoint_every > 0 and (
                step % run_cfg.checkpoint_every == 0 or step == steps):
            state = {"params": params, "opt": opt_state}
            if sharding is not None:
                state = sharding.gather(state)
            if writer:
                ckpt.save(step, state)
    ckpt.wait()
    return params, opt_state, history
