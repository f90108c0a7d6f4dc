"""xLSTM blocks: the chunked-parallel mLSTM and the sequential sLSTM.

The mLSTM's exponential gating carries the stabilizer
``m_t = max(log f_t + m_{t−1}, ĩ_t)``, the paper's Algorithm 3 running max:
C and n are the running statistics rescaled by ``exp(m_old − m_new)`` as d
is.  The chunked form carries (m, C, n) from chunk to chunk.  The sLSTM
feeds its hidden state back through recurrent weights, so it runs step by
step (a Python loop over time here, a ``lax.scan`` in the reference).

Port of ``src/repro/models/xlstm.py``: ``mlstm_chunked`` (line 32),
``mlstm_decode_step`` (99), ``slstm_scan`` (121), ``mlstm_block_init`` /
``mlstm_block_apply`` (163, 185), ``slstm_block_init`` /
``slstm_block_apply`` (219, 240) and ``xlstm_cache_init`` (258).  Plain
PyTorch on tensors, on the card as on the CPU.  The blocks' training forms
also run on the model axis (``tp``): the mLSTM's inner channels split
with its cell (and the products that feed it) whole on every rank, the
sLSTM's ffn split.  Log sigmoid is
``F.logsigmoid``, the reference's ``-softplus(-f)`` without a linear
threshold; the mLSTM's m starts at −inf, so the first chunk's carried
terms are exp(−inf) = 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as _tp
from repro_torch.models.layers import rms_norm
from repro_torch.models.ssm import _chunk_len, causal_conv

Tensor = torch.Tensor
NEG_INF = float("-inf")

#: Cache leaves of an mLSTM layer and of an sLSTM layer.
MLSTM_LEAVES = ("m", "C", "n", "conv")
SLSTM_LEAVES = ("s_c", "s_n", "s_m", "s_h")


def mlstm_chunked(q: Tensor, k: Tensor, v: Tensor, i_gate: Tensor,
                  f_gate: Tensor, *, chunk: int, init: Optional[tuple] = None):
    """q, k, v [B, T, H, D] (k pre-scaled by 1/sqrt(D)); i_gate, f_gate
    [B, T, H] (logits).  Returns (h [B, T, H, D] in q's dtype, (m [B, H],
    C [B, H, D, D], n [B, H, D]) fp32)."""
    bsz, t, h, dh = q.shape
    ln = _chunk_len(t, chunk)
    nc = t // ln

    def tochunks(x):
        return x.reshape(bsz, nc, ln, *x.shape[2:]).float()

    qc, kc, vc = tochunks(q), tochunks(k), tochunks(v)
    ic, fc = tochunks(i_gate), tochunks(f_gate)
    mask = torch.ones((ln, ln), dtype=torch.bool, device=q.device).tril()
    if init is None:
        m_run = torch.full((bsz, h), NEG_INF, device=q.device)
        c_run = torch.zeros((bsz, h, dh, dh), device=q.device)
        n_run = torch.zeros((bsz, h, dh), device=q.device)
    else:
        m_run, c_run, n_run = (x.float() for x in init)
    hs = []
    for j in range(nc):
        qk_, kk_, vk_, ik_, fk_ = (x[:, j] for x in (qc, kc, vc, ic, fc))
        la = torch.cumsum(F.logsigmoid(fk_), dim=1)           # [B, L, H]
        # intra log-weights W[i, j] = la_i − la_j + ĩ_j (j ≤ i)
        w = la[:, :, None, :] - la[:, None, :, :] + ik_[:, None, :, :]
        w = torch.where(mask[None, :, :, None], w, NEG_INF)   # [B, L, L, H]
        m_intra = w.amax(dim=2)                               # [B, L, H]
        m_inter = la + m_run[:, None, :]                      # decayed carry
        m_i = torch.maximum(m_intra, m_inter)                 # online max
        p = torch.exp(w - m_i[:, :, None, :])
        s = torch.einsum("bihd,bjhd->bijh", qk_, kk_)
        ps = p * s
        inter_scale = torch.exp(m_inter - m_i)                # [B, L, H]
        h_num = torch.einsum("bijh,bjhd->bihd", ps, vk_) \
            + inter_scale[..., None] * torch.einsum("bihd,bhde->bihe", qk_,
                                                    c_run)
        qn = ps.sum(dim=2) + inter_scale * torch.einsum("bihd,bhd->bih", qk_,
                                                        n_run)
        denom = torch.maximum(qn.abs(), torch.exp(-m_i))
        hs.append(h_num / denom[..., None])
        # the carry at the chunk's end, rescaled to the new max
        la_end = la[:, -1, :]                                 # [B, H]
        tail = la_end[:, None, :] - la + ik_                  # [B, L, H]
        m_new = torch.maximum(la_end + m_run, tail.amax(dim=1))
        wb = torch.exp(tail - m_new[:, None, :])
        decay = torch.exp(la_end + m_run - m_new)
        c_run = decay[..., None, None] * c_run \
            + torch.einsum("bjhd,bjhe->bhde", wb[..., None] * kk_, vk_)
        n_run = decay[..., None] * n_run \
            + torch.einsum("bjh,bjhd->bhd", wb, kk_)
        m_run = m_new
    h_full = torch.stack(hs, dim=1).reshape(bsz, t, h, dh)
    return h_full.to(q.dtype), (m_run, c_run, n_run)


def mlstm_decode_step(state: tuple, q: Tensor, k: Tensor, v: Tensor,
                      i_gate: Tensor, f_gate: Tensor):
    """One stabilized mLSTM step.  q, k, v [B, H, D]; gates [B, H].
    Returns (h [B, H, D] fp32, (m, C, n))."""
    m, c, n = state
    q, k, v = q.float(), k.float(), v.float()
    ig = i_gate.float()
    logf = F.logsigmoid(f_gate.float())
    m_new = torch.maximum(logf + m, ig)
    f_sc = torch.exp(logf + m - m_new)
    i_sc = torch.exp(ig - m_new)
    c_new = f_sc[..., None, None] * c \
        + i_sc[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = f_sc[..., None] * n + i_sc[..., None] * k
    qn = (q * n_new).sum(dim=-1)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    h = (q[..., None, :] @ c_new).squeeze(-2) / denom[..., None]
    return h, (m_new, c_new, n_new)


def slstm_scan(gates_x: Tensor, r_weights: Tensor, *, num_heads: int,
               init: Optional[tuple] = None):
    """gates_x [B, T, 4, Dm]: W·x_t for (i, f, z, o), precomputed;
    r_weights [4, H, Dh, Dh]: each head's recurrent matrices on h_{t−1}.
    Returns (h [B, T, Dm] fp32, (c, n, m, h_prev) [B, Dm] each)."""
    bsz, t, _, dm = gates_x.shape
    hh = num_heads
    dh = dm // hh
    dev = gates_x.device
    if init is None:
        c = torch.zeros((bsz, dm), device=dev)
        n = torch.ones((bsz, dm), device=dev)
        m = torch.zeros((bsz, dm), device=dev)
        h = torch.zeros((bsz, dm), device=dev)
    else:
        c, n, m, h = (x.float() for x in init)
    gx_all = gates_x.float()
    hs = []
    for s in range(t):
        rec = torch.einsum("bhd,ghde->bghe", h.reshape(bsz, hh, dh),
                           r_weights).reshape(bsz, 4, dm)
        gi, gf, gz, go = (gx_all[:, s] + rec).unbind(dim=1)
        logf = F.logsigmoid(gf)
        m_new = torch.maximum(logf + m, gi)          # online-max stabilizer
        i_sc = torch.exp(gi - m_new)
        f_sc = torch.exp(logf + m - m_new)
        c = f_sc * c + i_sc * torch.tanh(gz)
        n = torch.clamp(f_sc * n + i_sc, min=1e-6)
        m = m_new
        h = torch.sigmoid(go) * (c / n)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def mlstm_block_init(cfg: ModelConfig, dense, ones, device) -> dict:
    """One mLSTM block's weights in the reference's shapes and scales
    (``dense`` and ``ones`` as ``ssm.mamba2_init`` takes them): the conv
    (scale 0.5), ``w_if`` and the zero ``if_bias`` fp32."""
    xc = cfg.xlstm
    d = cfg.d_model
    inner = xc.expand * d
    hh = xc.num_heads
    f32 = torch.float32
    return {
        "norm": ones(d),
        "w_up": dense((d, 2 * inner)),
        "conv": dense((inner, xc.conv_width), scale=0.5, dtype=f32),
        "wq": dense((inner, inner)),
        "wk": dense((inner, inner)),
        "wv": dense((inner, inner)),
        "w_if": dense((inner, 2 * hh), dtype=f32),
        "if_bias": torch.zeros(2 * hh, device=device),
        "hnorm": ones(inner),
        "w_down": dense((inner, d)),
    }


def mlstm_block_apply(p: dict, x: Tensor, cfg: ModelConfig, *,
                      cache: Optional[dict] = None,
                      tp: Optional[_tp.ModelAxis] = None):
    """x [B, T, D] → (x + the block's output, new state ``{"m", "C", "n",
    "conv"}``).  A ``cache`` with T == 1 takes the decode step; otherwise
    the chunked form, from the cache's state when there is one.  A given
    ``cache`` is overwritten with the new state, in place.

    ``tp`` (training, ``cache=None``), where ``inner`` shards: the weights
    are this rank's shards of the inner channels (``w_up``'s halves [xm_r |
    z_r], the depthwise ``conv``'s rows, the rows of ``wq`` / ``wk`` /
    ``wv`` / ``w_if``, ``hnorm``'s scale, ``w_down``'s rows).  The normed
    x passes ``copy_to_model``; the rank's xm and conv columns and the
    rows of the four cell-input weights are gathered whole
    (``gather_rows``: each rank then computes q, k, v and the gates, and
    their gradients, exactly as one device does, and keeps its own slice
    of the gradients), so the cell runs whole on every rank over all heads.
    ``hnorm`` normalises the whole h; the result passes ``copy_to_model``
    before it is cut to the rank's columns and scaled by its shard, and
    the ranks' ``w_down`` products are summed."""
    xc = cfg.xlstm
    bsz, t, d = x.shape
    inner = xc.expand * d
    hh = xc.num_heads
    dh = inner // hh
    if tp is not None and (cache is not None or not tp.shards("inner")):
        tp = None
    resid = x
    x = rms_norm(p["norm"], x, cfg.norm_eps)
    if tp is not None:
        x = _tp.copy_to_model(x, tp)
    xm, z = (x @ p["w_up"]).chunk(2, dim=-1)
    xcv, new_conv = causal_conv(xm, p["conv"],
                                state=None if cache is None
                                else cache["conv"])
    xcv = F.silu(xcv)
    w = p
    if tp is not None:
        # the rank's channels and weight rows gathered: the products of a
        # row-parallel split, summed over the ranks, would round otherwise
        # than one device's, which the cell's gate gradients amplify
        xm, xcv = (_tp.gather_rows(y, -1, tp) for y in (xm, xcv))
        w = {name: _tp.gather_rows(p[name], 0, tp)
             for name in ("wq", "wk", "wv", "w_if")}
    q = (xcv @ w["wq"]).reshape(bsz, t, hh, dh)
    k = (xcv @ w["wk"]).reshape(bsz, t, hh, dh) * (dh ** -0.5)
    v = (xm @ w["wv"]).reshape(bsz, t, hh, dh)
    # the fp32 gate weights promote the product to fp32, as in JAX
    gi, gf = ((xcv.float() @ w["w_if"]) + p["if_bias"]).chunk(2, dim=-1)
    state = None if cache is None else (cache["m"], cache["C"], cache["n"])
    if cache is not None and t == 1:
        h, new_state = mlstm_decode_step(state, q[:, 0], k[:, 0], v[:, 0],
                                         gi[:, 0], gf[:, 0])
        h = h[:, None]
    else:
        h, new_state = mlstm_chunked(q, k, v, gi, gf, chunk=xc.chunk,
                                     init=state)
    new = dict(zip(MLSTM_LEAVES, (*new_state, new_conv)))
    if cache is not None:
        for name, val in new.items():
            cache[name].copy_(val)
    h = h.reshape(bsz, t, inner).to(x.dtype)
    if tp is None:
        h = rms_norm(p["hnorm"], h, cfg.norm_eps)
        return resid + (h * F.silu(z)) @ p["w_down"], new
    hf = h.float()
    hf = hf * torch.rsqrt(hf.square().mean(dim=-1, keepdim=True)
                          + cfg.norm_eps)
    cols = z.shape[-1]
    hf = _tp.copy_to_model(hf, tp)[..., tp.index * cols:(tp.index + 1) * cols]
    h = (hf * p["hnorm"]).to(x.dtype)
    return resid + _tp.reduce_from_model((h * F.silu(z)) @ p["w_down"],
                                         tp), new


def _slstm_ffn(d: int) -> int:
    return int(d * 4 / 3 / 64) * 64 or 64


def slstm_block_init(cfg: ModelConfig, dense, ones, device) -> dict:
    """One sLSTM block's weights in the reference's shapes and scales: the
    gate projection [D, 4, D] and the recurrent matrices [4, H, Dh, Dh]
    (scale 1/sqrt(Dh)) fp32, the gated MLP of width int(4D/3/64)·64."""
    xc = cfg.xlstm
    d = cfg.d_model
    dh = d // xc.num_heads
    f_up = _slstm_ffn(d)
    f32 = torch.float32
    return {
        "norm": ones(d),
        "w_gates": dense((d, 4, d), dtype=f32),
        "r_weights": dense((4, xc.num_heads, dh, dh),
                           scale=1.0 / math.sqrt(dh), dtype=f32),
        "hnorm": ones(d),
        "w_up1": dense((d, f_up)),
        "w_up2": dense((d, f_up)),
        "w_down": dense((f_up, d)),
    }


def slstm_block_apply(p: dict, x: Tensor, cfg: ModelConfig, *,
                      cache: Optional[dict] = None,
                      tp: Optional[_tp.ModelAxis] = None):
    """x [B, T, D] → (x + the block's output, new state ``{"s_c", "s_n",
    "s_m", "s_h"}``), the scan starting from the cache's state when there
    is one (then overwritten in place).  The MLP's GELU is the tanh form,
    ``jax.nn.gelu``'s default.

    ``tp`` (training, ``cache=None``), where ``ffn`` shards: the gates,
    the recurrent weights, both norms and the scan are whole on every
    rank; the MLP is column-parallel ``w_up1`` / ``w_up2`` after
    ``copy_to_model`` and row-parallel ``w_down``, its partials summed
    (``reduce_from_model``), as ``layers.mlp_apply``."""
    bsz, t, d = x.shape
    if tp is not None and (cache is not None or not tp.shards("ffn")):
        tp = None
    xn = rms_norm(p["norm"], x, cfg.norm_eps)
    gates_x = (xn.float().reshape(bsz * t, d)
               @ p["w_gates"].reshape(d, 4 * d)).reshape(bsz, t, 4, d)
    init = (None if cache is None
            else tuple(cache[name] for name in SLSTM_LEAVES))
    h, new_state = slstm_scan(gates_x, p["r_weights"],
                              num_heads=cfg.xlstm.num_heads, init=init)
    new = dict(zip(SLSTM_LEAVES, new_state))
    if cache is not None:
        for name, val in new.items():
            cache[name].copy_(val)
    h = rms_norm(p["hnorm"], h.to(x.dtype), cfg.norm_eps)
    if tp is not None:
        h = _tp.copy_to_model(h, tp)
    y = (F.gelu(h @ p["w_up1"], approximate="tanh") * (h @ p["w_up2"])) \
        @ p["w_down"]
    if tp is not None:
        y = _tp.reduce_from_model(y, tp)
    return x + y, new


def is_slstm(cfg: ModelConfig, layer_idx: int) -> bool:
    """Whether layer ``layer_idx`` of an xLSTM stack is an sLSTM block: the
    reference's placement, ``i % slstm_every == slstm_every - 1``."""
    ev = cfg.xlstm.slstm_every
    return layer_idx % ev == ev - 1


def xlstm_cache_init(cfg: ModelConfig, layer_idx: int, batch: int, dtype,
                     device="cuda") -> dict:
    """Initial state of layer ``layer_idx``: an sLSTM's (c, n, m, h) [B, D]
    fp32 with n = 1; an mLSTM's m [B, H] = −inf, C [B, H, Dh, Dh] and n
    [B, H, Dh] zeros (fp32) and its conv tail [B, w − 1, inner] in
    ``dtype``."""
    xc = cfg.xlstm
    d = cfg.d_model
    if is_slstm(cfg, layer_idx):
        return {"s_c": torch.zeros((batch, d), device=device),
                "s_n": torch.ones((batch, d), device=device),
                "s_m": torch.zeros((batch, d), device=device),
                "s_h": torch.zeros((batch, d), device=device)}
    inner = xc.expand * d
    hh = xc.num_heads
    dh = inner // hh
    return {"m": torch.full((batch, hh), NEG_INF, device=device),
            "C": torch.zeros((batch, hh, dh, dh), device=device),
            "n": torch.zeros((batch, hh, dh), device=device),
            "conv": torch.zeros((batch, xc.conv_width - 1, inner),
                                dtype=dtype, device=device)}
