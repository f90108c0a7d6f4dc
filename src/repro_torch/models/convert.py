"""Carry the reference's weights and optimizer state into the port.

``params_from_numpy(tree)`` takes the reference's parameter tree — the value
half of ``repro.models.layers.split_params(transformer.init(...))`` with its
leaves as numpy arrays and each segment's layers stacked on a leading axis —
and returns the port's parameter dict (``models.transformer``'s layout, one
dict per layer, the hybrid's shared block once; ``models.encdec``'s for an
encoder-decoder).  ``adamw_state_from_numpy`` carries the reference's
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


def _leaf(w, i: int, device):
    """Layer ``i`` of a stacked leaf, or of a nested dict of them; a
    ``{"scale": ...}`` norm dict becomes its tensor."""
    if isinstance(w, dict):
        if set(w) == {"scale"}:
            return _leaf(w["scale"], i, device)
        return {k: _leaf(v, i, device) for k, v in w.items()}
    return _tensor(w if i is None else w[i], device)


def params_from_numpy(tree: dict, *, device="cuda") -> dict:
    """Reference tree ``{"embedding": {"embed"[, "head"]}, "final_norm":
    {"scale"}, "segments": [stacked blocks, ...][, "shared_attn": {...}][,
    "mm_proj"]}`` → the port's ``{"embed"[, "head"][, "mm_proj"],
    "final_norm", "layers": [...][, "shared_attn"]}`` on ``device`` (the
    card unless the caller asks for the CPU).  Each segment's stacked
    layers become one dict each, in stack order: dense, MoE, MLA, mamba,
    mlstm and slstm blocks alike, every ``{"scale"}`` norm dict becoming a
    flat tensor (``ln1``, an MLA layer's ``q_norm`` / ``kv_norm``, a mamba
    layer's ``ln`` and its block's ``norm``, the xLSTM blocks' ``norm`` /
    ``hnorm``) and the rest carried as it is (an MoE layer's router,
    stacked experts and ``"shared"`` MLP; a VLM's ``mm_proj``).  A hybrid
    model's ``{}`` placeholder segments take no layer; its unstacked
    ``shared_attn`` block converts once.  An encoder-decoder tree (one
    with ``"encoder"``) takes ``_encdec_from_numpy``."""
    if "encoder" in tree:
        return _encdec_from_numpy(tree, device)
    layers = []
    for seg in tree["segments"]:
        if not seg:
            continue                      # the shared block's placeholder
        n = next(iter(_stack_sizes(seg)))
        layers += [_leaf(seg, i, device) for i in range(n)]
    params = {"embed": _tensor(tree["embedding"]["embed"], device)}
    if "head" in tree["embedding"]:
        params["head"] = _tensor(tree["embedding"]["head"], device)
    if "mm_proj" in tree:
        params["mm_proj"] = _tensor(tree["mm_proj"], device)
    params["final_norm"] = _tensor(tree["final_norm"]["scale"], device)
    params["layers"] = layers
    if "shared_attn" in tree:
        params["shared_attn"] = _leaf(tree["shared_attn"], None, device)
    return params


def _encdec_from_numpy(tree: dict, device) -> dict:
    """The reference's encoder-decoder tree (``repro.models.encdec.init``:
    ``adapter``, the stacked ``encoder`` / ``decoder`` blocks, the
    ``{"scale", "bias"}`` LayerNorms, the tied ``embedding`` and
    ``pos_embed``) → the port's (``models.encdec``): one dict a layer,
    each LayerNorm kept as its ``{"scale", "bias"}`` dict."""
    def stack(seg):
        return [_leaf(seg, i, device)
                for i in range(next(iter(_stack_sizes(seg))))]

    params = {"adapter": _tensor(tree["adapter"], device),
              "encoder": stack(tree["encoder"]),
              "enc_norm": _leaf(tree["enc_norm"], None, device),
              "embed": _tensor(tree["embedding"]["embed"], device)}
    if "head" in tree["embedding"]:
        params["head"] = _tensor(tree["embedding"]["head"], device)
    params["pos_embed"] = _tensor(tree["pos_embed"], device)
    params["decoder"] = stack(tree["decoder"])
    params["dec_norm"] = _leaf(tree["dec_norm"], None, device)
    return params


def _stack_sizes(tree) -> set:
    """The leading (layer) axis of every leaf of a stacked segment."""
    if isinstance(tree, dict):
        return set().union(*(_stack_sizes(v) for v in tree.values()))
    return {np.shape(tree)[0]}


def adamw_state_from_numpy(state, *, device="cuda") -> AdamWState:
    """The reference's ``AdamWState(step, mu, nu)`` (numpy leaves) → the
    port's, on ``device``."""
    step, mu, nu = state
    return AdamWState(
        step=torch.as_tensor(np.asarray(step), dtype=torch.int32,
                             device=device),
        mu=params_from_numpy(mu, device=device),
        nu=params_from_numpy(nu, device=device))
