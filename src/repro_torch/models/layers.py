"""Model layers of the port: norms, rotary embedding, GQA attention over
a paged KV pool or a contiguous KV cache, the SwiGLU MLP, the mixture of
experts, embedding and LM head.

Port of ``src/repro/models/layers.py`` but MLA: ``rms_norm`` (line
90), ``rope`` (109), ``cache_write`` (146), ``paged_cache_write`` (163),
``_quantize_kv`` (203), the paged and the contiguous branches of
``attention_apply``, fp and int8 (277-353), ``mlp_apply`` (459),
``moe_apply`` (486), ``embed_tokens`` (555) and ``head_matrix`` (559).
Parameters are plain dicts of tensors.  The MLA branch comes with a later
slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch

Tensor = torch.Tensor


def rms_norm(scale: Tensor, x: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


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
    here every position written must lie inside S."""
    b, t = new.shape[:2]
    new = new.to(cache.dtype)
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
                    positions: Tensor, cache: Optional[dict] = None,
                    cache_len: Optional[Union[int, Tensor]] = None,
                    block_tables: Optional[Tensor] = None):
    """x [B, T, D] → (out [B, T, D], cache).

    * ``cache=None``: causal self-attention over this call's K/V, the
      training form (differentiable; see ``dispatch.sdpa``).
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
        out = dispatch.sdpa(cfg, q, k, v, causal=True, q_offset=0,
                            kv_valid_len=None)
    out = out.reshape(b, t, hq * hd) @ p["wo"]
    return out, cache


def mlp_apply(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    up = x @ p["w_up"]
    if cfg.act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return h @ p["w_down"]


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
              aux: bool = True) -> tuple[Tensor, dict]:
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
    serving step drops them as dead code)."""
    mc = cfg.moe
    b, t, d = x.shape
    e_pad = mc.pad_experts_to or mc.num_experts
    k = mc.experts_per_token
    s = min(mc.group_size, t)
    g = (b * t) // s
    xg = x.reshape(g, s, d)
    r = moe_route(p, xg, cfg)
    # one-hot of each kept assignment's place; -1 and places past C match
    # nothing, so unrouted and dropped assignments give zero rows
    disp = (r.pos[..., None] == torch.arange(
        r.cap, device=x.device, dtype=r.pos.dtype)).float()    # [G,SK,E,C]
    disp = disp.reshape(g, s, k, e_pad, r.cap)
    combine = torch.einsum("gske,gskec->gsec", r.em * r.probs[..., None],
                           disp)
    xe = torch.einsum("gsec,gsd->egcd", disp.sum(2).to(x.dtype), xg)
    xe = xe.reshape(e_pad, g * r.cap, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(e_pad, g, r.cap, d)
    y = torch.einsum("egcd,gsec->gsd", ye, combine.to(x.dtype))
    y = y.reshape(b, t, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg)
    if not aux:
        return y, {}
    me = r.em.sum(2).mean(1)                                   # [G, E_pad]
    pe = F.pad(torch.softmax(r.logits, dim=-1).mean(1),
               (0, e_pad - mc.num_experts))
    lb_loss = mc.num_experts * (me * pe).sum(-1).mean()
    z_loss = mc.router_z_loss * r.lse.square().mean()
    return y, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def embed_tokens(p: dict, tokens: Tensor) -> Tensor:
    return p["embed"][tokens]


def head_matrix(p: dict, cfg: ModelConfig) -> Tensor:
    return p["embed"].T if cfg.tie_embeddings else p["head"]
