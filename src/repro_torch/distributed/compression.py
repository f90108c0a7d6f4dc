"""Gradient compression: the port of ``cast_grads`` of
``src/repro/distributed/compression.py`` (line 31).

Gradients are cast to ``grad_reduce_dtype`` (default bf16) at the autodiff
boundary, where a data-parallel all-reduce would move half the bytes.  The
train step casts even on one device, as the reference's does
(``train_step.py:61``), so one device rounds the gradients as many would.
The int8 error-feedback forms come with the distributed slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree

PyTree = Any


def cast_grads(grads: PyTree, dtype) -> PyTree:
    """``grads`` cast to ``dtype`` ("bfloat16", "float16"); float32 (or
    None) leaves them as they are."""
    if dtype in ("float32", "fp32", None):
        return grads
    dt = getattr(torch, dtype)
    return tree.map(lambda g: g.to(dt), grads)
