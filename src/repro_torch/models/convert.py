"""Carry the reference's weights and optimizer state into the port.

``params_from_numpy(tree)`` takes the reference's parameter tree — the value
half of ``repro.models.layers.split_params(transformer.init(...))`` with its
leaves as numpy arrays and each segment's layers stacked on a leading axis —
and returns the port's parameter dict (``models.transformer``'s layout, one
dict per layer).  ``adamw_state_from_numpy`` carries the reference's
``AdamWState`` (step, and ``mu``/``nu`` trees shaped like its parameters)
through the same mapping.  No JAX is needed: the caller turns the leaves
into numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWState


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                         # a writable copy, C-contiguous
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, *, device="cuda") -> dict:
    """Reference tree ``{"embedding": {"embed"[, "head"]}, "final_norm":
    {"scale"}, "segments": [{"ln1", "attn", "ln2", "mlp" | "moe"}
    stacked]}`` → the port's ``{"embed", "final_norm", "layers": [...]}``
    on ``device`` (the card unless the caller asks for the CPU).  An MoE
    layer's ``"moe"`` dict carries the router, the stacked experts and the
    shared expert's ``"shared"`` MLP dict as they are; an MLA layer's
    ``"attn"`` carries its eight leaves, its ``q_norm`` / ``kv_norm``
    ``{"scale"}`` dicts becoming flat tensors as ``ln1``'s does."""
    segments = tree["segments"]
    keys = set(segments[0]) if len(segments) == 1 else set()
    if keys not in ({"ln1", "attn", "ln2", "mlp"},
                    {"ln1", "attn", "ln2", "moe"}):
        raise NotImplementedError("params_from_numpy converts dense, MoE "
                                  "and MLA stacks (one segment of dense, "
                                  "moe or mla blocks) only")
    seg = segments[0]
    n = np.asarray(seg["ln1"]["scale"]).shape[0]

    def leaves(tree_i, i: int) -> dict:
        return {k: (leaves(w, i) if isinstance(w, dict)
                    else _tensor(w[i], device)) for k, w in tree_i.items()}

    def layer(i: int) -> dict:
        out = {
            "ln1": _tensor(seg["ln1"]["scale"][i], device),
            "attn": {k: _tensor(w["scale"][i] if isinstance(w, dict)
                                else w[i], device)
                     for k, w in seg["attn"].items()},
            "ln2": _tensor(seg["ln2"]["scale"][i], device),
        }
        ffn = "moe" if "moe" in seg else "mlp"
        out[ffn] = leaves(seg[ffn], i)
        return out

    params = {"embed": _tensor(tree["embedding"]["embed"], device)}
    if "head" in tree["embedding"]:
        params["head"] = _tensor(tree["embedding"]["head"], device)
    params["final_norm"] = _tensor(tree["final_norm"]["scale"], device)
    params["layers"] = [layer(i) for i in range(n)]
    return params


def adamw_state_from_numpy(state, *, device="cuda") -> AdamWState:
    """The reference's ``AdamWState(step, mu, nu)`` (numpy leaves) → the
    port's, on ``device``."""
    step, mu, nu = state
    return AdamWState(
        step=torch.as_tensor(np.asarray(step), dtype=torch.int32,
                             device=device),
        mu=params_from_numpy(mu, device=device),
        nu=params_from_numpy(nu, device=device))
