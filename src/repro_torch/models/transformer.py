"""Decoder-only LM for the dense block kind: init, forward, training loss,
decode logits.

Port of ``src/repro/models/transformer.py`` for ``dense`` blocks:
``block_pattern`` (line 41), ``init`` (176; the port's own seeded
initialiser with the reference's shapes and scales), ``forward`` (217; a
Python loop over layers in place of ``lax.scan``, each layer under
``torch.utils.checkpoint`` where the reference's ``_maybe_remat`` put it
under ``jax.checkpoint``), ``loss_fn`` (280) and ``logits_last`` (306,
which casts to fp32 before the head product as at line 309).

Parameters are a plain dict::

    {"embed": [V, D], ("head": [D, V] when untied,) "final_norm": [D],
     "layers": [{"ln1": [D], "attn": {"wq", "wk", "wv", "wo"},
                 "ln2": [D], "mlp": {"w_gate", "w_up", "w_down"}}, ...]}

Norm scales stay float32 as in the reference; the rest takes ``cfg.dtype``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import core
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def block_pattern(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.family in ("dense", "vlm"):
        return [("dense", cfg.num_layers)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, slice 4)")


def init(cfg: ModelConfig, *, seed: int = 0,
         device: Union[str, torch.device] = "cuda") -> dict:
    """Random weights from ``seed``: normal with scale 1/sqrt(fan_in) for
    projections and 1 for the embedding, ones for norm scales — the
    reference's ``_dense_init`` shapes and scales.  Draws happen on the CPU
    (so a seed gives the same weights on every device), then move."""
    block_pattern(cfg)
    gen = torch.Generator().manual_seed(seed)
    dt = DTYPES[cfg.dtype]
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen) * scale
        return w.to(device=device, dtype=dt)

    def ones():
        return torch.ones(d, device=device)

    params = {"embed": dense((v, d), scale=1.0)}
    if not cfg.tie_embeddings:
        params["head"] = dense((d, v))
    params["final_norm"] = ones()
    layers = []
    for _ in range(cfg.num_layers):
        mlp = {"w_up": dense((d, f)), "w_down": dense((f, d))}
        if cfg.act == "silu":
            mlp["w_gate"] = dense((d, f))
        layers.append({
            "ln1": ones(),
            "attn": {"wq": dense((d, hq * hd)), "wk": dense((d, hkv * hd)),
                     "wv": dense((d, hkv * hd)), "wo": dense((hq * hd, d))},
            "ln2": ones(), "mlp": mlp})
    params["layers"] = layers
    return params


def params_to(params, device=None, dtype=None):
    """Copy a parameter tree to ``device``; ``dtype`` recasts the projection
    and embedding weights (norm scales stay float32)."""
    if isinstance(params, dict):
        return {k: (params_to(v, device, None) if k in ("ln1", "ln2",
                                                        "final_norm")
                    else params_to(v, device, dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)


def forward(params: dict, tokens: Tensor, cfg: ModelConfig, *,
            caches: Optional[dict] = None,
            cache_len: Optional[Union[int, Tensor]] = None,
            block_tables: Optional[Tensor] = None):
    """tokens [B, T] → (hidden [B, T, D], caches).

    ``block_tables`` [B, M]: paged KV serving — ``caches`` holds the block
    pools ``{"k", "v": [L, P, Hkv, BS, D]}`` (no batch axis; see
    ``serving.engine.init_paged_cache``) and every attention layer writes and
    reads through the table, in place.  ``cache_len`` is an int (one
    sequence) or a [B] tensor (per-slot offsets).  Layer i sees leaf ``[i]``
    of every cache leaf, so an int8 cache's scales travel with its K/V."""
    x = L.embed_tokens(params, tokens)
    t = tokens.shape[1]
    base = torch.as_tensor(cache_len if cache_len is not None else 0,
                           dtype=torch.int64, device=x.device)
    # scalar base → positions [T]; per-slot base [B] → positions [B, T]
    positions = base[..., None] + torch.arange(t, device=x.device)
    remat = _remat(cfg, training=caches is None and torch.is_grad_enabled())
    for i, lp in enumerate(params["layers"]):
        cache = (None if caches is None
                 else {name: leaf[i] for name, leaf in caches.items()})
        layer = functools.partial(_block_apply, cfg=cfg, positions=positions,
                                  cache=cache, cache_len=cache_len,
                                  block_tables=block_tables)
        x = remat(layer, lp, x)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, caches


def _block_apply(lp: dict, x: Tensor, *, cfg: ModelConfig, positions, cache,
                 cache_len, block_tables) -> Tensor:
    """One dense block: [norm → GQA attention] + [norm → SwiGLU MLP]."""
    h = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
    a, _ = L.attention_apply(lp["attn"], h, cfg, positions=positions,
                             cache=cache, cache_len=cache_len,
                             block_tables=block_tables)
    x = x + a
    h = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], h, cfg)


def _remat(cfg: ModelConfig, *, training: bool):
    """How a layer runs: under ``torch.utils.checkpoint`` (its activations
    recomputed in the backward) for ``remat="full"`` on a training forward,
    directly otherwise.  Serving forwards (with caches) never recompute, as
    in the reference (``_maybe_remat(inference=True)``)."""
    if not training or cfg.remat == "none":
        return lambda fn, *args: fn(*args)
    if cfg.remat != "full":
        raise NotImplementedError(
            f"remat {cfg.remat!r} is not ported yet (the port recomputes "
            "whole layers: remat 'full' or 'none')")
    return functools.partial(checkpoint, use_reentrant=False,
                             preserve_rng_state=False)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """batch: tokens [B, T], labels [B, T] (−1 = masked) → (mean CE over the
    unmasked labels, {"ce_loss", "loss"}).  The tied head's gradient reaches
    ``embed`` through both the token gather and the head product."""
    hidden, _ = forward(params, batch["tokens"], cfg)
    d = hidden.shape[-1]
    labels = batch["labels"].reshape(-1).long()
    w = L.head_matrix(params, cfg)
    h2 = hidden.reshape(-1, d)
    valid = labels >= 0
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    if cfg.use_chunked_ce:
        tok_loss = core.chunked_cross_entropy(h2, w, safe_labels,
                                              num_chunks=cfg.vocab_chunks)
    else:
        tok_loss = core.full_cross_entropy(h2, w, safe_labels)
    denom = valid.sum().clamp(min=1)
    loss = (tok_loss * valid).sum() / denom
    return loss, {"ce_loss": loss, "loss": loss}


def logits_last(params: dict, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """LM-head logits for the last position only (decode path), in fp32."""
    w = L.head_matrix(params, cfg)
    return hidden[:, -1].float() @ w.float()
