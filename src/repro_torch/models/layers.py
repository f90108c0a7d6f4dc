"""Model layers of the port: norms, rotary embedding, GQA attention over
a paged KV pool or a contiguous KV cache, multi-head latent attention over
a contiguous latent cache, the SwiGLU and GELU MLPs, the mixture of
experts, embedding and LM head.

Port of ``src/repro/models/layers.py``: ``rms_norm`` (line 90),
``layer_norm`` (101), ``rope`` (109), ``cache_write`` (146),
``paged_cache_write`` (163), ``_quantize_kv`` (203), the paged and the
contiguous branches of ``attention_apply``, fp and int8 (277-353), and its
``causal`` keyword (242), ``mla_apply`` (388),
``mlp_apply`` (459), ``moe_apply`` (486), ``embed_tokens`` (555) and
``head_matrix`` (559).  Parameters are plain dicts of tensors.

The training forms (``cache=None``) of ``attention_apply``, ``mlp_apply``
and ``embed_tokens`` take ``tp``, the ambient model axis
(``distributed.tensor_parallel.model_axis``), and then run on this rank's
shards of the weights: the MLP column- then row-parallel, the embedding
vocabulary-parallel, attention in heads mode (the rank's heads) or in
sequence mode (the rank's block of query rows over the keys up to its
end, the reference's ``_constrain_seq_parallel`` at 212-226; K/V expanded
to the query heads as ``_maybe_expand_kv`` at 229-240 where the kv heads
do not split).  Activations between sublayers are replicated over the
model group.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context as _context
from repro_torch.distributed import tensor_parallel as _tp
from repro_torch.kernels import dispatch

Tensor = torch.Tensor


def rms_norm(scale: Tensor, x: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm(p: dict, x: Tensor, eps: float) -> Tensor:
    """LayerNorm with ``p = {"scale", "bias"}`` (fp32), over the last axis
    in fp32: the population variance, as ``jnp.var``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding. x [..., T, H, D_rot]; positions [..., T] or [T]."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., :, None].float() * freqs            # [.., T, D/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cache_write(cache: Tensor, new: Tensor,
                cache_len: Union[int, Tensor]) -> Tensor:
    """Write ``new`` [B, t, ...] into ``cache`` [B, S, ...] at offset
    ``cache_len`` along the sequence axis, in place, and return the cache.

    A scalar ``cache_len`` is the lockstep batch (one shared offset: a
    ``copy_`` into the slice); a [B] vector writes each row at its own offset
    (the slot pool: one ``index_put_``).  The JAX code returned a new array
    (``dynamic_update_slice``, which clamps a start that would overrun S);
    here every position written must lie inside S.

    Under a ``ShardContext`` the cache is this rank's slice of the sequence,
    positions [start, start + S) with start = S · (its index along the
    context's ``cache_seq_axes``): the rank writes the part of
    [cache_len, cache_len + t) that falls in its slice, usually nothing (a
    scalar ``cache_len`` only: the lockstep batch)."""
    b, t = new.shape[:2]
    new = new.to(cache.dtype)
    ctx = _context.get()
    if ctx is not None:
        if torch.is_tensor(cache_len) and cache_len.dim() > 0:
            raise NotImplementedError(
                "a sequence-sharded cache takes the lockstep batch's scalar "
                "length, not per-row lengths")
        s = cache.shape[1]
        start = _context.axis_index(ctx.mesh, ctx.cache_seq_axes) * s
        lo = max(int(cache_len), start)
        hi = min(int(cache_len) + t, start + s)
        if lo < hi:
            cache.narrow(1, lo - start, hi - lo).copy_(
                new.narrow(1, lo - int(cache_len), hi - lo))
        return cache
    if not torch.is_tensor(cache_len) or cache_len.dim() == 0:
        cache.narrow(1, int(cache_len), t).copy_(new)
        return cache
    pos = cache_len.to(cache.device, torch.int64)[:, None] + torch.arange(
        t, device=cache.device)                                      # [B, t]
    rows = torch.arange(b, device=cache.device)[:, None].expand(b, t)
    cache.index_put_((rows, pos), new)
    return cache


def paged_cache_write(pool: Tensor, new: Tensor, cache_len: Union[int, Tensor],
                      block_tables: Tensor) -> Tensor:
    """Write ``new`` [B, t, Hkv, D] into the block pool [P, Hkv, BS, D]
    through the block table [B, M], in place, and return the pool.

    Row b's position ``cache_len[b] + i`` lands in physical block
    ``block_tables[b, pos // BS]`` at offset ``pos % BS``.  The JAX code
    rebuilt the pool functionally (``pool.at[...].set``); here one
    ``index_put_`` scatters into it.  Distinct rows never write the same
    (block, offset), except idle rows, which all land in the sentinel
    block 0 that the allocator never hands out."""
    b, t = new.shape[:2]
    bs = pool.shape[2]
    ln = torch.as_tensor(cache_len, dtype=torch.int64,
                         device=pool.device).expand(b)
    pos = ln[:, None] + torch.arange(t, device=pool.device)          # [B, t]
    bids = torch.gather(block_tables.to(pool.device, torch.int64), 1,
                        pos // bs).reshape(-1)
    offs = (pos % bs).reshape(-1)
    heads = torch.arange(pool.shape[1], device=pool.device)
    flat = new.to(pool.dtype).reshape((b * t,) + tuple(new.shape[2:]))
    pool.index_put_((bids[:, None], heads[None, :], offs[:, None]), flat)
    return pool


def _quantize_kv(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-(position, head) int8 quantization: x [B, T, H, D] → (int8
    [B, T, H, D], bf16 scale [B, T, H]).  The reference's arithmetic: the
    scale is max|x| / 127 (at least 1e-8) in fp32, the values round half to
    even (``torch.round``, like ``jnp.round``) and clip to ±127, and the
    stored scale rounds to bf16."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def attention_apply(p: dict, x: Tensor, cfg: ModelConfig, *,
                    positions: Tensor, causal: bool = True,
                    cache: Optional[dict] = None,
                    cache_len: Optional[Union[int, Tensor]] = None,
                    block_tables: Optional[Tensor] = None,
                    tp: Optional[_tp.ModelAxis] = None):
    """x [B, T, D] → (out [B, T, D], cache).

    * ``cache=None``: self-attention over this call's K/V, causal unless
      ``causal=False`` (whisper's encoder), the training form
      (differentiable; see ``dispatch.sdpa``).  RoPE applies either way,
      as in the reference.  With ``tp`` the weights are this rank's shards
      and the attention runs tensor-parallel (``_attention_model_axis``).
    * paged serving: ``cache`` holds this layer's block pools
      ``{"k", "v": [P, Hkv, BS, D]}`` shared by every sequence; this step's
      K/V are written through ``block_tables`` at ``cache_len`` (in place)
      and attention reads the pages through the same table.
    * contiguous caches (the slot pool, the lockstep batch): ``cache``
      holds ``{"k", "v": [B, S, Hkv, D]}``; this step's K/V are written at
      ``cache_len`` (a scalar or per-row [B]) in place, and attention reads
      each row's valid prefix.

    Either way a one-token step (decode, or a one-token prefill tail) takes
    the decode kernel, and a wider one the cached-prefill kernel, with the
    queries at absolute offset ``cache_len`` and ``cache_len + t`` valid
    positions per row.

    The cache layout, not a config string, selects the int8 form: a cache
    with ``"k_scale"`` holds int8 K/V (pools or caches) and bf16 scales
    beside them ([P, Hkv, BS] pages or [B, S, Hkv]).  Every step writes the
    quantized K/V and their scales; a prefill (t > 1, single shot) attends
    over this call's exact K/V through the cached-prefill kernel, and a
    decode step over the int8 cache through the dequantizing decode kernel.
    """
    if tp is not None and cache is None:
        return _attention_model_axis(p, x, cfg, tp, positions=positions,
                                     causal=causal), None
    b, t, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, t, hq, hd)
    k = (x @ p["wk"]).reshape(b, t, hkv, hd)
    v = (x @ p["wv"]).reshape(b, t, hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None and "k_scale" in cache:
        k8, ks = _quantize_kv(k)
        v8, vs = _quantize_kv(v)
        for name, new in (("k", k8), ("v", v8), ("k_scale", ks),
                          ("v_scale", vs)):
            if block_tables is not None:
                paged_cache_write(cache[name], new, cache_len, block_tables)
            else:
                cache_write(cache[name], new, cache_len)
        valid = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=x.device).expand(b) + t
        if t > 1:
            out = dispatch.sdpa(cfg, q, k, v, causal=True, q_offset=cache_len,
                                kv_valid_len=valid)
        else:
            out = dispatch.sdpa(cfg, q, cache["k"], cache["v"], causal=False,
                                q_offset=cache_len, kv_valid_len=valid,
                                decode=True, k_scale=cache["k_scale"],
                                v_scale=cache["v_scale"],
                                block_tables=block_tables)
    elif cache is not None:
        if block_tables is not None:
            k_all = paged_cache_write(cache["k"], k, cache_len, block_tables)
            v_all = paged_cache_write(cache["v"], v, cache_len, block_tables)
        else:
            k_all = cache_write(cache["k"], k, cache_len)
            v_all = cache_write(cache["v"], v, cache_len)
        valid = torch.as_tensor(cache_len, dtype=torch.int32,
                                device=x.device).expand(b) + t
        out = dispatch.sdpa(cfg, q, k_all, v_all, causal=t > 1,
                            q_offset=cache_len, kv_valid_len=valid,
                            decode=(t == 1), block_tables=block_tables)
    else:
        out = dispatch.sdpa(cfg, q, k, v, causal=causal, q_offset=0,
                            kv_valid_len=None)
    out = out.reshape(b, t, hq * hd) @ p["wo"]
    return out, cache


def _attention_model_axis(p: dict, x: Tensor, cfg: ModelConfig,
                          tp: _tp.ModelAxis, *, positions: Tensor,
                          causal: bool) -> Tensor:
    """The training form on the model axis; x [B, T, D] replicated over
    the group, out [B, T, D] replicated.

    heads mode (Hq divisible by M): the rank's Hq/M query heads from its
    columns of wq; its Hkv/M kv heads where ``kv_out`` shards, else the
    whole K/V (wk, wv replicated, through ``copy_to_model``) repeated to
    the query heads and sliced to the rank's; rows 6/7 at the local heads;
    the rank's rows of wo; the partial outputs summed
    (``reduce_from_model``).

    sequence mode: each of wq/wk/wv/wo gathered whole where its placement
    shards it (``gather_weight``) or passed through ``copy_to_model``; q
    for the rank's rows [r·T/M, (r+1)·T/M) at their RoPE positions, K/V
    for keys [0, (r+1)·T/M) (all T when not causal); rows 6/7 at causal
    offset r·T/M; the rows through wo, then gathered (``gather_rows``).
    T % M != 0 raises."""
    b, t, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    x = _tp.copy_to_model(x, tp)
    if tp.mode == "heads":
        hl = hq // tp.size
        q = (x @ p["wq"]).reshape(b, t, hl, hd)
        if tp.shards("kv_out"):
            hkl = hkv // tp.size
            k = (x @ p["wk"]).reshape(b, t, hkl, hd)
            v = (x @ p["wv"]).reshape(b, t, hkl, hd)
        else:
            g, heads = hq // hkv, slice(tp.index * hl, (tp.index + 1) * hl)
            k = (x @ _tp.copy_to_model(p["wk"], tp)).reshape(b, t, hkv, hd)
            v = (x @ _tp.copy_to_model(p["wv"], tp)).reshape(b, t, hkv, hd)
            k = k.repeat_interleave(g, dim=2)[:, :, heads]
            v = v.repeat_interleave(g, dim=2)[:, :, heads]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        out = dispatch.sdpa(cfg, q, k, v, causal=causal, q_offset=0,
                            kv_valid_len=None)
        out = out.reshape(b, t, hl * hd) @ p["wo"]
        return _tp.reduce_from_model(out, tp)
    if t % tp.size:
        raise ValueError(f"sequence-parallel attention: T={t} does not "
                         f"split over the model axis's {tp.size} ranks")
    w = {}
    for name, logical, dim in (("wq", "qkv_out", 1), ("wk", "kv_out", 1),
                               ("wv", "kv_out", 1), ("wo", "qkv_out", 0)):
        w[name] = (_tp.gather_weight(p[name], dim, tp) if tp.shards(logical)
                   else _tp.copy_to_model(p[name], tp))
    rows = t // tp.size
    lo, hi = tp.index * rows, (tp.index + 1) * rows
    keys = hi if causal else t
    q = (x[:, lo:hi] @ w["wq"]).reshape(b, rows, hq, hd)
    k = (x[:, :keys] @ w["wk"]).reshape(b, keys, hkv, hd)
    v = (x[:, :keys] @ w["wv"]).reshape(b, keys, hkv, hd)
    q = rope(q, positions[..., lo:hi], cfg.rope_theta)
    k = rope(k, positions[..., :keys], cfg.rope_theta)
    out = dispatch.sdpa(cfg, q, k, v, causal=causal, q_offset=lo,
                        kv_valid_len=None)
    out = out.reshape(b, rows, hq * hd) @ w["wo"]
    return _tp.gather_rows(out, 1, tp)


def mla_apply(p: dict, x: Tensor, cfg: ModelConfig, *, positions: Tensor,
              cache: Optional[dict] = None,
              cache_len: Optional[Union[int, Tensor]] = None,
              tp: Optional[_tp.ModelAxis] = None):
    """Multi-head latent attention (MiniCPM3 / DeepSeek-V2): x [B, T, D] →
    (out [B, T, D], cache), the reference's ``mla_apply`` step for step.

    The queries come from a low-rank path (``wdq``, ``q_norm``, ``wuq``),
    split into a no-position part and a rotary part; the keys and values
    from one compressed latent ``c_kv`` [B, T, R] (``wdkv``, ``kv_norm``)
    and a rotary key ``k_rope`` [B, T, Dr] shared by every head.  The scale
    is (qk_nope + qk_rope)^-0.5.

    * ``cache``: this layer's latent cache ``{"c_kv": [B, S, R], "k_rope":
      [B, S, Dr]}``; the step's latents are written at ``cache_len`` (a
      scalar or per-row [B]) in place, then the absorbed form attends: W_uk
      folds into the query (``q_eff`` [B, T, H, R]), every head scores
      ``q_eff·c + q_rope·r`` against the same latent rows and takes
      ``softmax·c`` (``dispatch.mla_attention``, which reads the cache in
      place), and W_uv maps the [B, T, H, R] context to the value heads.
      An int8 config keeps fp latents too, as the reference's does.
    * ``cache=None`` (training): the decompressed form, K = [c·W_uk,
      k_rope broadcast to the heads] and V = c·W_uv, through
      ``dispatch.sdpa`` (Dqk 96, Dv 64): on CUDA the fresh forward's and
      the backward's (96, 64) instances (``FlashAttention``), k and v read
      through their own strides; on the CPU their plain versions
      (``_mla_train``).  With ``tp`` the weights are this rank's shards and
      the attention runs tensor-parallel.
    """
    if cache is None:
        return _mla_train(p, x, cfg, tp, positions=positions), None
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    nope, rot = m.qk_nope_head_dim, m.qk_rope_head_dim
    cq = rms_norm(p["q_norm"], x @ p["wdq"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(b, t, h, nope + rot)
    q_nope, q_rope = q.split([nope, rot], dim=-1)
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = (x @ p["wdkv"]).split([m.kv_lora_rank, rot], dim=-1)
    c_kv = rms_norm(p["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    c_all = cache_write(cache["c_kv"], c_kv, cache_len)
    r_all = cache_write(cache["k_rope"], k_rope, cache_len)
    wuk3 = p["wuk"].reshape(m.kv_lora_rank, h, nope)
    q_eff = torch.einsum("bthk,rhk->bthr", q_nope, wuk3)
    valid = torch.as_tensor(cache_len, dtype=torch.int32,
                            device=x.device).expand(b) + t
    ctx = dispatch.mla_attention(cfg, q_eff, q_rope, c_all, r_all,
                                 causal=t > 1, q_offset=cache_len,
                                 kv_valid_len=valid,
                                 scale=(nope + rot) ** -0.5, decode=(t == 1))
    wuv3 = p["wuv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bthr,rhk->bthk", ctx, wuv3)
    return out.reshape(b, t, h * m.v_head_dim) @ p["wo"], cache


def _mla_train(p: dict, x: Tensor, cfg: ModelConfig,
               tp: Optional[_tp.ModelAxis], *, positions: Tensor) -> Tensor:
    """MLA's training form, x [B, T, D] → out [B, T, D]: without ``tp``
    every head; with ``tp`` on the model axis, x and out replicated over
    the group, in one of two modes.

    heads mode (H divisible by M): ``cq``, ``c_kv`` and ``k_rope`` computed
    whole from the replicated x and weights (wdq, q_norm, wdkv, kv_norm),
    each through ``copy_to_model`` just before its rank-specific use (so
    those four weights get whole gradients without one); the rank's H/M
    heads from its columns of wuq / wuk / wuv (head-major: a block of
    columns is a block of heads); rows 6m / 7m at the local heads; the
    rank's rows of wo; the partial outputs summed (``reduce_from_model``).

    sequence mode: every weight gathered whole where ``qkv_out`` shards it
    (``gather_weight``) or passed through ``copy_to_model`` (the low-rank
    projections and both norms too: here they act on rank-specific rows);
    q for the rank's rows [r·T/M, (r+1)·T/M) at their RoPE positions,
    ``c_kv`` / ``k_rope`` for keys [0, (r+1)·T/M); rows 6m / 7m at causal
    offset r·T/M; the rows through wo, then gathered (``gather_rows``).
    T % M != 0 raises."""
    m = cfg.mla
    b, t, _ = x.shape
    h, eps, theta = cfg.num_heads, cfg.norm_eps, cfg.rope_theta
    nope, rot, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    heads = tp is None or tp.mode == "heads"
    if heads:
        w, lo, hi = p, 0, t
        h = h if tp is None else h // tp.size
        qx = kx = x
    else:
        if t % tp.size:
            raise ValueError(f"sequence-parallel attention: T={t} does not "
                             f"split over the model axis's {tp.size} ranks")
        w = {name: (_tp.gather_weight(p[name], dim, tp)
                    if dim is not None and tp.shards("qkv_out")
                    else _tp.copy_to_model(p[name], tp))
             for name, dim in (("wdq", None), ("q_norm", None), ("wuq", 1),
                               ("wdkv", None), ("kv_norm", None),
                               ("wuk", 1), ("wuv", 1), ("wo", 0))}
        x = _tp.copy_to_model(x, tp)
        rows = t // tp.size
        lo, hi = tp.index * rows, (tp.index + 1) * rows
        qx, kx = x[:, lo:hi], x[:, :hi]
    cq = rms_norm(w["q_norm"], qx @ w["wdq"], eps)
    c_kv, k_rope = (kx @ w["wdkv"]).split([r, rot], dim=-1)
    c_kv = rms_norm(w["kv_norm"], c_kv, eps)
    k_rope = rope(k_rope[:, :, None, :], positions[..., :hi], theta)[:, :, 0]
    if tp is not None and heads:
        cq, c_kv, k_rope = (_tp.copy_to_model(z, tp)
                            for z in (cq, c_kv, k_rope))
    q = (cq @ w["wuq"]).reshape(b, hi - lo, h, nope + rot)
    q_nope, q_rope = q.split([nope, rot], dim=-1)
    q_rope = rope(q_rope, positions[..., lo:hi], theta)
    k_nope = (c_kv @ w["wuk"]).reshape(b, hi, h, nope)
    v = (c_kv @ w["wuv"]).reshape(b, hi, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, hi, h, rot)],
                  dim=-1)
    out = dispatch.sdpa(cfg, torch.cat([q_nope, q_rope], dim=-1), k, v,
                        causal=True, q_offset=lo, kv_valid_len=None,
                        scale=(nope + rot) ** -0.5)
    out = out.reshape(b, hi - lo, h * m.v_head_dim) @ w["wo"]
    if tp is None:
        return out
    return (_tp.reduce_from_model(out, tp) if heads
            else _tp.gather_rows(out, 1, tp))


def _mlp(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    up = x @ p["w_up"]
    if cfg.act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return h @ p["w_down"]


def mlp_apply(p: dict, x: Tensor, cfg: ModelConfig,
              tp: Optional[_tp.ModelAxis] = None) -> Tensor:
    """The MLP; with ``tp`` where ``ffn`` shards, column-parallel w_up /
    w_gate and row-parallel w_down between ``copy_to_model`` and
    ``reduce_from_model``."""
    if tp is None or not tp.shards("ffn"):
        return _mlp(p, x, cfg)
    return _tp.reduce_from_model(_mlp(p, _tp.copy_to_model(x, tp), cfg), tp)


class MoERoute(NamedTuple):
    """Where ``moe_route`` sends a group's tokens: S tokens, K experts a
    token, capacity C a group and expert."""
    logits: Tensor   # [G, S, E] float32 router logits
    probs: Tensor    # [G, S, K] the top-k probabilities renormalized over K
    idx: Tensor      # [G, S, K] the chosen experts, best first
    lse: Tensor      # [G, S] float32 log-sum-exp of the logits
    em: Tensor       # [G, S, K, E_pad] float32 one-hot of idx
    pos: Tensor      # [G, S·K, E_pad] float32 place in the expert's bucket
                     # (-1 where the assignment is not to that expert)
    cap: int         # C

    @property
    def keep(self) -> Tensor:
        """[G, S, K] bool: the assignment has a place < C (kept)."""
        return (self.pos.amax(-1) < self.cap).reshape(self.idx.shape)


def moe_route(p: dict, xg: Tensor, cfg: ModelConfig) -> MoERoute:
    """Route groups of tokens xg [G, S, D]: the fp32 router product, the
    paper's Algorithm 4 over the experts (``dispatch.softmax_topk``, the
    fused kernel on the card, its launches counted as
    ``softmax_topk_router``), the top-k probabilities renormalized, then
    each assignment's place in its expert's bucket from a running count per
    expert in flattened (s, k) order.  Capacity is ``ceil(S·K·
    capacity_factor / E)``, at least 4; an assignment at or past it is
    dropped.  So which assignments drop depends on the token order within
    a group and on the order of a token's K indices (best first, ties to
    the lower index, as the kernel's plain version orders them)."""
    mc = cfg.moe
    g, s, _ = xg.shape
    e_pad = mc.pad_experts_to or mc.num_experts
    k = mc.experts_per_token
    logits = xg.float() @ p["router"]                          # [G, S, E]
    probs, idx, lse = dispatch.softmax_topk(
        logits, k, counter="softmax_topk_router")              # [G, S, K]
    probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = max(math.ceil(s * k * mc.capacity_factor / mc.num_experts), 4)
    em = (idx.long()[..., None] == torch.arange(
        e_pad, device=xg.device)).float()                      # [G,S,K,E]
    flat = em.reshape(g, s * k, e_pad)
    pos = torch.cumsum(flat, dim=1) * flat - 1.0               # [G, S·K, E]
    return MoERoute(logits, probs, idx, lse, em, pos, cap)


def moe_apply(p: dict, x: Tensor, cfg: ModelConfig, *,
              aux: bool = True,
              tp: Optional[_tp.ModelAxis] = None) -> tuple[Tensor, dict]:
    """Mixture of experts on x [B, T, D] → (y [B, T, D], aux losses).

    The reference's capacity-bucketed one-hot form (``moe_apply`` at
    ``src/repro/models/layers.py:486``), kept as it is: the B·T tokens go
    in groups of S = min(group_size, T) (so a decode step's B tokens are B
    groups of one, and a prefill chunk of c tokens one group of c up to
    ``group_size``), ``moe_route`` gives each assignment its place, a
    one-hot dispatch [G, S, E_pad, C] gathers the kept tokens into
    per-expert buckets [E_pad, G·C, D] (the pads exist and are never
    picked), each expert runs SwiGLU over its bucket as batched matrix
    products (so every expert's weights are read, picked or not), and the
    combine weights (probability × one-hot) sum the K expert outputs back
    per token; then the shared expert's MLP is added.  A dropped
    assignment contributes nothing.

    ``aux``: the load-balance loss E·mean_g Σ_e (fraction routed to e) ×
    (mean router probability of e), and the z-loss ``router_z_loss`` ×
    mean(lse²) from the kernel's lse.  Serving passes ``aux=False`` and
    gets ``{}``: only the training loss reads them (the reference's jitted
    serving step drops them as dead code).

    ``tp`` (training): the weights are this rank's shards.  Routing stays
    whole on every rank (the router product, row 1, the places), so every
    rank drops the same assignments as one process would, and the aux
    losses come out the same on every rank, their gradient whole.  Expert
    mode (``expert`` shards): rank r holds experts [r·E_pad/M,
    (r+1)·E_pad/M) and runs the dispatch and combine columns of those; ffn
    mode (``expert_ffn`` shards): it holds every expert's F/M columns and
    runs every bucket on them.  Either way its output is a partial sum:
    x and the renormalized probabilities that build the combine pass
    ``copy_to_model`` (the router weight, the logits and the lse do not),
    and one ``reduce_from_model`` sums the experts' partials, with the
    shared expert's where ``ffn`` shards it; a replicated shared expert is
    added after the sum."""
    mc = cfg.moe
    b, t, d = x.shape
    e_pad = mc.pad_experts_to or mc.num_experts
    k = mc.experts_per_token
    s = min(mc.group_size, t)
    g = (b * t) // s
    r = moe_route(p, x.reshape(g, s, d), cfg)
    losses = {}
    if aux:
        me = r.em.sum(2).mean(1)                               # [G, E_pad]
        pe = F.pad(torch.softmax(r.logits, dim=-1).mean(1),
                   (0, e_pad - mc.num_experts))
        losses = {"moe_lb_loss": mc.num_experts * (me * pe).sum(-1).mean(),
                  "moe_z_loss": mc.router_z_loss * r.lse.square().mean()}
    xc, probs, pos, em = x, r.probs, r.pos, r.em
    if tp is not None:
        xc, probs = _tp.copy_to_model(x, tp), _tp.copy_to_model(probs, tp)
        if tp.shards("expert"):
            n = e_pad // tp.size
            mine = slice(tp.index * n, (tp.index + 1) * n)
            pos, em = pos[..., mine], em[..., mine]
    shared_ffn = tp is not None and tp.shards("ffn")
    shared = (_mlp(p["shared"], xc if shared_ffn else x, cfg)
              if "shared" in p else None)
    e_loc = em.shape[-1]
    # one-hot of each kept assignment's place; -1 and places past C match
    # nothing, so unrouted and dropped assignments give zero rows
    disp = (pos[..., None] == torch.arange(
        r.cap, device=x.device, dtype=pos.dtype)).float()      # [G,SK,E,C]
    disp = disp.reshape(g, s, k, e_loc, r.cap)
    combine = torch.einsum("gske,gskec->gsec", em * probs[..., None], disp)
    xe = torch.einsum("gsec,gsd->egcd", disp.sum(2).to(x.dtype),
                      xc.reshape(g, s, d))
    xe = xe.reshape(e_loc, g * r.cap, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(e_loc, g, r.cap, d)
    y = torch.einsum("egcd,gsec->gsd", ye, combine.to(x.dtype))
    y = y.reshape(b, t, d)
    if shared_ffn:
        y = y + shared
    if tp is not None:
        y = _tp.reduce_from_model(y, tp)
    if shared is not None and not shared_ffn:
        y = y + shared
    return y, losses


def embed_tokens(p: dict, tokens: Tensor,
                 tp: Optional[_tp.ModelAxis] = None) -> Tensor:
    """The token embeddings; with ``tp`` where ``vocab`` shards,
    vocabulary-parallel: the rank holds rows [r·V/M, (r+1)·V/M), looks a
    token outside them up at 0 and zeroes it, and the ranks' rows are
    summed (``reduce_from_model``)."""
    if tp is None or not tp.shards("vocab"):
        return p["embed"][tokens]
    n = p["embed"].shape[0]
    local = tokens - tp.index * n
    inside = (local >= 0) & (local < n)
    x = p["embed"][torch.where(inside, local, torch.zeros_like(local))]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return _tp.reduce_from_model(x, tp)


def head_matrix(p: dict, cfg: ModelConfig) -> Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["head"]
