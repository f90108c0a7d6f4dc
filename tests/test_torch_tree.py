"""The port's trees hold no reference cycle over their leaves.

``tree.leaves_with_path`` and ``tree.unflatten`` see every gradient of a
train step.  A recursive closure that names itself is a cycle through its
frame's cell, which keeps every leaf it saw alive until the cyclic
collector runs (on llava-next-34b at 2 layers, ~19.4 GiB of gradients held
after a step on the card).  Here one train step of the 2-layer smoke
smollm runs with the collector off and ``gc.DEBUG_SAVEALL`` on, after a
first step that imports what the step imports lazily; what a collection
then finds unreachable must hold no tensor.  (torch's own
``tree_flatten`` helpers leave cycles too, but none holds a tensor.)
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig)
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.training.train_step import init_state, make_train_step


def _garbage_tensors(fn) -> list:
    """Tensors in the cycles that ``fn()`` leaves behind."""
    gc.collect()
    gc.garbage.clear()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        fn()
        gc.collect()
        found = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    return found


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_leaves_no_tensor_in_a_cycle(microbatches):
    cfg = configs.get_smoke("smollm_360m").replace(num_layers=2)
    run = RunConfig(model=cfg, optimizer=OptimizerConfig(warmup_steps=0),
                    parallel=ParallelConfig(microbatches=microbatches))
    ds = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=4))
    batch = {k: torch.as_tensor(v) for k, v in ds.batch(0).items()}

    def step():
        params, opt = init_state(run, device="cpu")
        params, opt, metrics = make_train_step(run)(params, opt, batch)
        assert np.isfinite(float(metrics["loss"]))

    step()      # the first step's lazy imports (torch._dynamo) leave cycles
    found = _garbage_tensors(step)
    assert not found, (f"{len(found)} tensors ({sum(t.numel() for t in found)}"
                       " elements) held only by reference cycles")


def test_tree_helpers_keep_order_and_structure():
    """The stack walk flattens in the recursive order (dict keys sorted,
    NamedTuple fields, list indices), and ``unflatten`` inverts it."""
    import collections
    pair = collections.namedtuple("pair", "b a")
    t = {"z": [1, (2, 3)], "a": pair(4, {"y": 5, "x": 6}), "m": 7}
    got = tree.leaves_with_path(t)
    assert got == [("a/b", 4), ("a/a/x", 6), ("a/a/y", 5), ("m", 7),
                   ("z/0", 1), ("z/1/0", 2), ("z/1/1", 3)]
    back = tree.unflatten(t, [leaf for _, leaf in got])
    assert back == t and list(back) == list(t)
    assert isinstance(back["a"], pair)
    assert _garbage_tensors(lambda: tree.unflatten(
        t, [torch.ones(1)] * len(got))) == []
