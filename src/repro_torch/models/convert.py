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
    {"scale"}, "segments": [{"ln1", "attn", "ln2", "mlp"} stacked]}`` →
    the port's ``{"embed", "final_norm", "layers": [...]}`` on ``device``
    (the card unless the caller asks for the CPU)."""
    segments = tree["segments"]
    if len(segments) != 1 or set(segments[0]) != {"ln1", "attn", "ln2",
                                                  "mlp"}:
        raise NotImplementedError("params_from_numpy converts dense stacks "
                                  "(one segment of dense blocks) only")
    seg = segments[0]
    n = np.asarray(seg["ln1"]["scale"]).shape[0]

    def layer(i: int) -> dict:
        return {
            "ln1": _tensor(seg["ln1"]["scale"][i], device),
            "attn": {k: _tensor(seg["attn"][k][i], device)
                     for k in ("wq", "wk", "wv", "wo")},
            "ln2": _tensor(seg["ln2"]["scale"][i], device),
            "mlp": {k: _tensor(w[i], device) for k, w in seg["mlp"].items()},
        }

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
