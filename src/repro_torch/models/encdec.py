"""Encoder-decoder transformer (whisper's backbone): init, encoder,
decoder with a self-attention cache and a cross-attention cache, training
loss.

Port of ``src/repro/models/encdec.py``: ``sinusoidal`` (line 25),
``init`` (45; the port's own seeded initialiser with the reference's
shapes and scales), ``encode`` (65), ``_cross_attention`` (83),
``decode_hidden`` (101) and ``loss_fn`` (138).  The audio frontend is a
stub, as in the reference: the frames are precomputed embeddings
[B, S_enc, D] and a linear ``adapter`` stands in for the conv stack.  The
encoder is bidirectional self-attention over sinusoidal positions; the
decoder is causal self-attention (cached), cross-attention over the
encoder output (its K/V computed once at prefill and cached) and a GELU
MLP, with LayerNorm and learned positions, the head tied to the
embedding.  The self-attentions of both apply RoPE as well, on top of
those positions, as the reference's ``attention_apply`` does.

Attention goes through ``dispatch.sdpa``: the encoder's self-attention is
the fresh forward with ``causal=False`` (row 6), the decoder's
self-attention takes the cached routes as a decoder-only model's does.
The reference's cross-attention is the jnp ``core.online_attention(causal=
False)``; here it goes through ``dispatch.sdpa`` too, so on the card it
reaches a kernel: a one-token query takes the decode kernel (row 4) with
every one of the S_enc keys valid, a wider one with a cache the cached
prefill (row 5) with ``causal=False``, and the training form (no cache)
the fresh forward.  On the CPU each runs the same online arithmetic.

``loss_fn`` trains on either device (``training.train_step`` picks it for
an encoder-decoder): on the card every attention of its forward is the
fresh forward through ``FlashAttention`` (row 6) and its backward the dq
and dk/dv kernels (row 7): the encoder's non-causal over S_enc, the
decoder's causal over its T tokens, and the cross-attention's non-causal
T queries over S_enc keys.  Each encoder and decoder layer is
checkpointed, so a step launches the forward twice a layer and
attention.

Parameters are a plain dict::

    {"adapter": [D, D], "encoder": [{"ln1", "attn": {"wq", "wk", "wv",
     "wo"}, "ln2", "mlp": {"w_up", "w_down"}}, ...], "enc_norm",
     "embed": [V, D], ("head": [D, V] when untied,) "pos_embed":
     [max_seq_len, D], "decoder": [{"ln1", "self_attn", "lnx",
     "cross_attn", "ln2", "mlp"}, ...], "dec_norm"}

each norm ``{"scale", "bias"}`` in fp32, the rest in ``cfg.dtype``.
Decoder caches are a flat dict, layer axis 0 and batch axis 1 of every
leaf (``serving.cache_family.EncDecFamily``): ``{"self_k", "self_v":
[L, B, S, Hkv, D], "cross_k", "cross_v": [L, B, S_enc, Hkv, D]}``,
written in place.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import core
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models.transformer import DTYPES

Tensor = torch.Tensor

#: The decoder cache's leaves: the self-attention's, then the
#: cross-attention's.
SELF_LEAVES = ("self_k", "self_v")
CROSS_LEAVES = ("cross_k", "cross_v")


def sinusoidal(t: int, d: int, device=None) -> Tensor:
    """[t, d] fp32: sin then cos of pos / 10000^(2i/d), i < d/2."""
    return sinusoidal_at(torch.arange(t, device=device), d)


def sinusoidal_at(pos: Tensor, d: int) -> Tensor:
    """Rows ``pos`` [N] of the ``sinusoidal`` table, [N, d], each entry
    computed as the table computes it."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / torch.pow(
        torch.tensor(10000.0, device=pos.device), 2 * dim[None, :] / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init(cfg: ModelConfig, *, seed: int = 0,
         device: Union[str, torch.device] = "cuda",
         draw_device: Union[str, torch.device] = "cpu") -> dict:
    """Random weights from ``seed``, the reference's shapes and scales:
    projections normal at 1/sqrt(fan_in), the embedding at 1, the learned
    positions at 0.02, norms ones and zeros.  Drawn in fp32 on
    ``draw_device`` from one seeded generator, then cast to ``cfg.dtype``
    on ``device`` (the norms stay fp32), as ``transformer.init`` does."""
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    dt = DTYPES[cfg.dtype]
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, device=draw_device)
        return w.mul_(scale).to(device=device, dtype=dt)

    def norm():
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}

    def attention():
        return {"wq": dense((d, hq * hd)), "wk": dense((d, hkv * hd)),
                "wv": dense((d, hkv * hd)), "wo": dense((hq * hd, d))}

    def mlp():
        p = {"w_up": dense((d, f)), "w_down": dense((f, d))}
        if cfg.act == "silu":
            p["w_gate"] = dense((d, f))
        return p

    params = {"adapter": dense((d, d)),
              "encoder": [{"ln1": norm(), "attn": attention(), "ln2": norm(),
                           "mlp": mlp()}
                          for _ in range(cfg.encoder_layers)],
              "enc_norm": norm(),
              "embed": dense((v, d), scale=1.0)}
    if not cfg.tie_embeddings:
        params["head"] = dense((d, v))
    params["pos_embed"] = dense((cfg.max_seq_len, d), scale=0.02)
    params["decoder"] = [{"ln1": norm(), "self_attn": attention(),
                          "lnx": norm(), "cross_attn": attention(),
                          "ln2": norm(), "mlp": mlp()}
                         for _ in range(cfg.num_layers)]
    params["dec_norm"] = norm()
    return params


def _remat(training: bool):
    """The reference checkpoints every encoder and training-decoder layer
    (``jax.checkpoint``, nothing saved): the same under
    ``torch.utils.checkpoint`` on a forward that builds a graph."""
    if not training:
        return lambda fn, *args: fn(*args)
    return functools.partial(checkpoint, use_reentrant=False,
                             preserve_rng_state=False)


def _encoder_block(lp: dict, x: Tensor, *, cfg: ModelConfig,
                   positions: Tensor) -> Tensor:
    h = L.layer_norm(lp["ln1"], x, cfg.norm_eps)
    a, _ = L.attention_apply(lp["attn"], h, cfg, positions=positions,
                             causal=False)
    x = x + a
    h = L.layer_norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], h, cfg)


def encode(params: dict, frames: Tensor, cfg: ModelConfig) -> Tensor:
    """frames [B, S_enc, D] (stub embeddings) → encoder hidden
    [B, S_enc, D]."""
    x = frames.to(DTYPES[cfg.dtype]) @ params["adapter"]
    x = x + sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = _remat(torch.is_grad_enabled())
    block = functools.partial(_encoder_block, cfg=cfg, positions=positions)
    for lp in params["encoder"]:
        x = remat(block, lp, x)
    return L.layer_norm(params["enc_norm"], x, cfg.norm_eps)


def _cross_attention(p: dict, x: Tensor, cfg: ModelConfig, *,
                     enc_out: Optional[Tensor] = None,
                     cache: Optional[dict] = None) -> Tensor:
    """Cross-attention of x [B, T, D] over the encoder output ``enc_out``
    (its K/V projected here and, with a cache, written into the cache in
    place: the cache is replaced, not read) or over the cached
    projection (``enc_out=None``).  No RoPE.  Returns [B, T, D]."""
    b, t, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, t, hq, hd)
    if enc_out is not None:
        s_enc = enc_out.shape[1]
        k = (enc_out @ p["wk"]).reshape(b, s_enc, hkv, hd)
        v = (enc_out @ p["wv"]).reshape(b, s_enc, hkv, hd)
        if cache is not None:
            cache["cross_k"].copy_(k)
            cache["cross_v"].copy_(v)
    else:
        k, v = cache["cross_k"], cache["cross_v"]
    if cache is None:
        out = dispatch.sdpa(cfg, q, k, v, causal=False, q_offset=0,
                            kv_valid_len=None)
    else:
        # every encoder position is a valid key: the serving routes (the
        # decode kernel for one token, the cached prefill for more)
        valid = torch.full((b,), k.shape[1], dtype=torch.int32,
                           device=x.device)
        out = dispatch.sdpa(cfg, q, k, v, causal=False, q_offset=0,
                            kv_valid_len=valid, decode=(t == 1))
    return out.reshape(b, t, hq * hd) @ p["wo"]


def _decoder_block(lp: dict, x: Tensor, enc_out: Optional[Tensor], *,
                   cfg: ModelConfig, positions: Tensor, cache: Optional[dict],
                   cache_len) -> Tensor:
    h = L.layer_norm(lp["ln1"], x, cfg.norm_eps)
    self_cache = (None if cache is None else
                  {"k": cache["self_k"], "v": cache["self_v"]})
    a, _ = L.attention_apply(lp["self_attn"], h, cfg, positions=positions,
                             cache=self_cache, cache_len=cache_len)
    x = x + a
    h = L.layer_norm(lp["lnx"], x, cfg.norm_eps)
    x = x + _cross_attention(lp["cross_attn"], h, cfg, enc_out=enc_out,
                             cache=cache)
    h = L.layer_norm(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], h, cfg)


def decode_hidden(params: dict, tokens: Tensor, enc_out: Optional[Tensor],
                  cfg: ModelConfig, *, caches: Optional[dict] = None,
                  cache_len: Optional[Union[int, Tensor]] = None):
    """Decoder forward: tokens [B, T] → (hidden [B, T, D], caches).

    ``caches`` (``SELF_LEAVES`` + ``CROSS_LEAVES``, layer axis 0) are
    written in place: this call's self K/V at ``cache_len`` (a scalar, or
    per-row [B]), and, when ``enc_out`` is given, the cross K/V projected
    from it; with ``enc_out=None`` the cross-attention reads the cached
    projection.  Without caches (training) every layer attends over this
    call's tokens and ``enc_out``, checkpointed as in the reference."""
    x = L.embed_tokens(params, tokens)
    t = tokens.shape[1]
    base = torch.as_tensor(cache_len if cache_len is not None else 0,
                           dtype=torch.int64, device=x.device)
    # scalar base → positions [T]; per-slot base [B] → positions [B, T]
    positions = base[..., None] + torch.arange(t, device=x.device)
    x = x + params["pos_embed"][positions]
    remat = _remat(caches is None and torch.is_grad_enabled())
    for i, lp in enumerate(params["decoder"]):
        cache = (None if caches is None else
                 {name: leaf[i] for name, leaf in caches.items()})
        block = functools.partial(_decoder_block, cfg=cfg,
                                  positions=positions, cache=cache,
                                  cache_len=cache_len)
        x = remat(block, lp, x, enc_out)
    return L.layer_norm(params["dec_norm"], x, cfg.norm_eps), caches


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """batch: frames [B, S, D], tokens [B, T], labels [B, T] (−1 = masked)
    → (mean chunked CE over the unmasked labels, {"loss", "ce_loss"})."""
    enc_out = encode(params, batch["frames"], cfg)
    hidden, _ = decode_hidden(params, batch["tokens"], enc_out, cfg)
    d = hidden.shape[-1]
    labels = batch["labels"].reshape(-1).long()
    valid = labels >= 0
    w = L.head_matrix(params, cfg)
    tok_loss = core.chunked_cross_entropy(
        hidden.reshape(-1, d), w, torch.where(valid, labels,
                                              torch.zeros_like(labels)),
        num_chunks=cfg.vocab_chunks)
    loss = (tok_loss * valid).sum() / valid.sum().clamp(min=1)
    return loss, {"loss": loss, "ce_loss": loss}
