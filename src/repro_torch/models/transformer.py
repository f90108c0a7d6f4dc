"""Decoder-only LM for the dense and MoE block kinds: init, forward,
training loss, decode logits.

Port of ``src/repro/models/transformer.py`` for ``dense`` and ``moe``
blocks: ``block_pattern`` (line 41), ``block_apply`` (114; dense takes the
MLP, moe ``layers.moe_apply``, at 150-154), ``init`` (176; the port's own
seeded initialiser with the reference's shapes and scales), ``forward``
(217; a Python loop over layers in place of ``lax.scan``, each layer under
``torch.utils.checkpoint`` where the reference's ``_maybe_remat`` put it
under ``jax.checkpoint``, the MoE aux losses summed over layers as at
270-272), ``loss_fn`` (280, which adds them over ``num_layers``) and
``logits_last`` (306, which casts to fp32 before the head product as at
line 309).

Parameters are a plain dict::

    {"embed": [V, D], ("head": [D, V] when untied,) "final_norm": [D],
     "layers": [{"ln1": [D], "attn": {"wq", "wk", "wv", "wo"},
                 "ln2": [D], "mlp": {"w_gate", "w_up", "w_down"}}, ...]}

An MoE layer holds ``"moe": {"router": [D, E] float32, "w_gate", "w_up":
[E_pad, D, F], "w_down": [E_pad, F, D], ("shared": {"w_gate", "w_up",
"w_down"}, an MLP of d_ff_shared)}`` in place of ``"mlp"``.  Norm scales
and the router stay float32 as in the reference; the rest takes
``cfg.dtype``.
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


#: Leaves that keep float32 whatever ``cfg.dtype`` is.
FP32_LEAVES = ("ln1", "ln2", "final_norm", "router")


def block_pattern(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.family in ("dense", "vlm"):
        return [("dense", cfg.num_layers)]
    if cfg.family == "moe":
        return [("moe", cfg.num_layers)]
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)")


def init(cfg: ModelConfig, *, seed: int = 0,
         device: Union[str, torch.device] = "cuda",
         draw_device: Union[str, torch.device] = "cpu") -> dict:
    """Random weights from ``seed``: normal with scale 1/sqrt(fan_in) for
    projections and 1 for the embedding, ones for norm scales — the
    reference's ``_dense_init`` shapes and scales, the untied ``head``
    and the MoE leaves included (the fp32 router [D, E]; the experts
    [E_pad, D, F] / [E_pad, F, D] at 1/sqrt(E_pad), the reference's fan-in
    of a stacked leaf; the shared expert's MLP).  Each tensor is drawn in
    fp32 on ``draw_device`` from one seeded ``torch.Generator`` there, then
    cast to ``cfg.dtype`` (the router: kept fp32) on ``device``.  The
    default draws on the CPU, so a seed gives the same weights on every
    device (what the CPU-vs-card parity runs need);
    ``draw_device="cuda"`` draws on the card, with other numbers from the
    same seed, for full-width card runs: a 12B model's ~1.2e10 CPU draws
    take over a minute, the card's well under a second
    (``tools/init_times.py``)."""
    kind = block_pattern(cfg)[0][0]
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    dt = DTYPES[cfg.dtype]
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def dense(shape, scale=None, dtype=dt):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, device=draw_device)
        return w.mul_(scale).to(device=device, dtype=dtype)

    def ones():
        return torch.ones(d, device=device)

    def mlp(ff):
        p = {"w_up": dense((d, ff)), "w_down": dense((ff, d))}
        if cfg.act == "silu":
            p["w_gate"] = dense((d, ff))
        return p

    def moe():
        mc = cfg.moe
        e, ff = mc.pad_experts_to or mc.num_experts, mc.d_ff_expert
        p = {"router": dense((d, mc.num_experts), dtype=torch.float32),
             "w_gate": dense((e, d, ff)), "w_up": dense((e, d, ff)),
             "w_down": dense((e, ff, d))}
        if mc.d_ff_shared:
            p["shared"] = mlp(mc.d_ff_shared)
        return p

    params = {"embed": dense((v, d), scale=1.0)}
    if not cfg.tie_embeddings:
        params["head"] = dense((d, v))
    params["final_norm"] = ones()
    layers = []
    for _ in range(cfg.num_layers):
        # the feed-forward leaves are drawn before the attention's
        ffn = {"moe": moe()} if kind == "moe" else {"mlp": mlp(f)}
        layers.append({
            "ln1": ones(),
            "attn": {"wq": dense((d, hq * hd)), "wk": dense((d, hkv * hd)),
                     "wv": dense((d, hkv * hd)), "wo": dense((hq * hd, d))},
            "ln2": ones(), **ffn})
    params["layers"] = layers
    return params


def params_to(params, device=None, dtype=None):
    """Copy a parameter tree to ``device``; ``dtype`` recasts the projection
    and embedding weights (norm scales and the router stay float32)."""
    if isinstance(params, dict):
        return {k: (params_to(v, device, None) if k in FP32_LEAVES
                    else params_to(v, device, dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)


def forward(params: dict, tokens: Tensor, cfg: ModelConfig, *,
            caches: Optional[dict] = None,
            cache_len: Optional[Union[int, Tensor]] = None,
            block_tables: Optional[Tensor] = None, return_aux: bool = False):
    """tokens [B, T] → (hidden [B, T, D], caches), and with ``return_aux``
    a third item: the MoE aux losses (``moe_lb_loss``, ``moe_z_loss``)
    summed over layers, ``{}`` for a dense model.

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
    aux_total: dict = {}
    for i, lp in enumerate(params["layers"]):
        cache = (None if caches is None
                 else {name: leaf[i] for name, leaf in caches.items()})
        layer = functools.partial(_block_apply, cfg=cfg, positions=positions,
                                  cache=cache, cache_len=cache_len,
                                  block_tables=block_tables, aux=return_aux)
        x, aux = remat(layer, lp, x)
        for name, val in aux.items():
            aux_total[name] = aux_total.get(name, 0.0) + val
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return (x, caches, aux_total) if return_aux else (x, caches)


def _block_apply(lp: dict, x: Tensor, *, cfg: ModelConfig, positions, cache,
                 cache_len, block_tables, aux: bool):
    """One block: [norm → GQA attention] + [norm → SwiGLU MLP] (dense) or
    [norm → mixture of experts] (moe).  Returns (x, the MoE aux losses when
    ``aux``, else {})."""
    h = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
    a, _ = L.attention_apply(lp["attn"], h, cfg, positions=positions,
                             cache=cache, cache_len=cache_len,
                             block_tables=block_tables)
    x = x + a
    h = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        m, losses = L.moe_apply(lp["moe"], h, cfg, aux=aux)
        return x + m, losses
    return x + L.mlp_apply(lp["mlp"], h, cfg), {}


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
    unmasked labels plus each MoE aux loss over ``num_layers``, {"ce_loss",
    the aux losses, "loss"}).  The tied head's gradient reaches ``embed``
    through both the token gather and the head product."""
    hidden, _, aux = forward(params, batch["tokens"], cfg, return_aux=True)
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
    ce = (tok_loss * valid).sum() / denom
    loss = ce
    for val in aux.values():
        loss = loss + val / max(cfg.num_layers, 1)
    return loss, {"ce_loss": ce, **aux, "loss": loss}


def logits_last(params: dict, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """LM-head logits for the last position only (decode path), in fp32."""
    w = L.head_matrix(params, cfg)
    return hidden[:, -1].float() @ w.float()
