"""Checkpointing: async and atomic, the port of
``src/repro/checkpoint/manager.py`` with its layout and guarantees::

    <dir>/step_<N>/arrays.npz      flattened param + opt leaves ("/"-joined keys)
    <dir>/step_<N>/manifest.json   step, leaf index
    <dir>/step_<N>/COMMITTED       written LAST → crash-safe commit marker

* **Async**: ``save`` copies every leaf to host memory synchronously, then a
  daemon thread serializes, so training goes on during the write.
* **Atomic**: the writer stages into ``step_N.tmp`` and ``os.rename``\\ s it
  before dropping the COMMITTED marker; restore ignores uncommitted
  directories, so a crash mid-write never corrupts the restore source.
* **Retention**: only the newest ``keep`` committed steps stay.

bf16 leaves (numpy has no bfloat16) are stored as their raw 16-bit words
under a marked key, as the reference does, and read back with
``tensor.view(torch.bfloat16)``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree

PyTree = Any
_BF16_MARK = "__bf16__:"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (the live tensor goes on changing in place)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(state: PyTree) -> dict:
    """{key: numpy array}; bf16 leaves as uint16 words under a marked
    key."""
    flat = {}
    for key, leaf in tree.leaves_with_path(state):
        arr = _to_numpy(leaf)
        if leaf.dtype == torch.bfloat16:
            flat[_BF16_MARK + key] = arr
        else:
            flat[key] = arr
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: PyTree, *, blocking: bool = False):
        """Snapshot now, write in the background (or block if asked)."""
        self.wait()                      # one in-flight write at a time
        flat = _flatten(state)

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                manifest = {"step": step, "leaves": sorted(flat)}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                shutil.rmtree(final, ignore_errors=True)
                os.rename(tmp, final)
                with open(os.path.join(final, "COMMITTED"), "w") as f:
                    f.write("ok")
                self._retention()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _retention(self):
        for s in self.committed_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def committed_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "COMMITTED")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: PyTree) -> PyTree:
        """Load step's arrays into the structure of ``like``: each leaf takes
        its ``like`` leaf's dtype and device (and ``requires_grad``)."""
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        out = []
        for key, leaf in tree.leaves_with_path(like):
            if _BF16_MARK + key in flat:
                t = torch.from_numpy(
                    flat[_BF16_MARK + key].view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(flat[key])
            assert tuple(t.shape) == tuple(leaf.shape), (key, t.shape,
                                                         leaf.shape)
            t = t.to(device=leaf.device, dtype=leaf.dtype)
            out.append(t.requires_grad_(leaf.requires_grad))
        return tree.unflatten(like, out)
