"""Mamba2 (SSD) block: the chunked-parallel form and the O(1) decode step.

The SSD recurrence  S_t = a_t·S_{t−1} + Δ_t·B_t x_tᵀ,  y_t = C_tᵀS_t + D·x_t
is evaluated chunkwise: pairs inside a chunk through a masked [L, L] decay
matrix, the chunks through a carried state — a running statistic updated
per tile, as the paper's online softmax carries (m, d), with exp-decay
weights in place of exp-normalized ones.

Port of ``src/repro/models/ssm.py``: ``ssd_chunked`` (line 26; a Python
loop over the chunks in place of ``lax.scan``), ``ssd_decode_step`` (78),
``causal_conv`` (95), ``mamba2_init`` (113), ``mamba2_apply`` (144) and
``mamba2_cache_init`` (196).  Plain PyTorch on tensors, on the card as on
the CPU.  The training form of ``mamba2_apply`` also runs on the model
axis (``tp``): the rank's SSM heads, with the gated norm's sum of squares
summed over the ranks.

Shapes: x [B, T, H, P]; B, C [B, T, N] (a single group); Δ [B, T, H];
A, D [H].
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as _tp
from repro_torch.models.layers import rms_norm

Tensor = torch.Tensor

#: One layer's cache leaves, in the order ``mamba2_cache_init`` gives them.
CACHE_LEAVES = ("ssm", "conv_x", "conv_b", "conv_c")


def _chunk_len(t: int, chunk: int) -> int:
    """The scan's chunk: ``chunk``, or T when shorter; T must divide into
    it (the reference asserts the same)."""
    ln = min(chunk, t)
    if t % ln:
        raise ValueError(f"a chunked scan over {t} steps needs a length <= "
                         f"{chunk} or a multiple of it")
    return ln


def ssd_chunked(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor,
                d_skip: Tensor, *, chunk: int,
                init_state: Optional[Tensor] = None):
    """Chunked SSD scan.  x [B, T, H, P]; dt [B, T, H] (> 0); a_log [H]
    (A = −exp(a_log)); b, c [B, T, N]; d_skip [H].  Returns (y [B, T, H, P]
    in x's dtype, final_state [B, H, N, P] fp32)."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    ln = _chunk_len(t, chunk)
    nc = t // ln
    xc = x.reshape(bsz, nc, ln, h, p).float()
    dtc = dt.reshape(bsz, nc, ln, h).float()
    bc = b.reshape(bsz, nc, ln, n).float()
    cc = c.reshape(bsz, nc, ln, n).float()
    a = -torch.exp(a_log.float())                              # [H] < 0
    mask = torch.ones((ln, ln), dtype=torch.bool, device=x.device).tril()
    s = (torch.zeros((bsz, h, n, p), device=x.device) if init_state is None
         else init_state.float())
    ys = []
    for k in range(nc):
        xk, dtk, bk, ck = xc[:, k], dtc[:, k], bc[:, k], cc[:, k]
        la = torch.cumsum(dtk * a, dim=1)                      # [B, L, H]
        # M[i, j] = (C_i·B_j)·exp(la_i − la_j)·Δ_j for j ≤ i; the decay
        # overflows above the diagonal, which `where` masks (no multiply)
        scores = torch.einsum("bin,bjn->bij", ck, bk)
        decay = la[:, :, None, :] - la[:, None, :, :]          # [B, L, L, H]
        w = torch.where(mask[None, :, :, None], torch.exp(decay), 0.0)
        m = scores[..., None] * w * dtk[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xk)
        # the entering state's contribution
        y_inter = torch.einsum("bin,bhnp->bihp", ck, s) \
            * torch.exp(la)[..., None]
        y_k = y_intra + y_inter + d_skip[None, None, :, None] * xk
        # the boundary state
        w_end = torch.exp(la[:, -1:, :] - la)                  # [B, L, H]
        sc_k = torch.einsum("bjn,bjhp->bhnp", bk,
                            (w_end * dtk)[..., None] * xk)
        gamma = torch.exp(la[:, -1, :])                        # [B, H]
        s = gamma[..., None, None] * s + sc_k
        ys.append(y_k)
    y = torch.stack(ys, dim=1).reshape(bsz, t, h, p).to(x.dtype)
    return y, s


def ssd_decode_step(state: Tensor, x: Tensor, dt: Tensor, a_log: Tensor,
                    b: Tensor, c: Tensor, d_skip: Tensor):
    """One-token SSD update.  state [B, H, N, P]; x [B, H, P]; dt [B, H];
    b, c [B, N].  Returns (y [B, H, P] in x's dtype, new_state fp32)."""
    a = -torch.exp(a_log.float())
    dtf, xf = dt.float(), x.float()
    decay = torch.exp(dtf * a)                                 # [B, H]
    upd = b.float()[:, None, :, None] * (dtf[..., None] * xf)[:, :, None, :]
    new_state = decay[..., None, None] * state + upd
    y = (c.float()[:, None, None, :] @ new_state).squeeze(2) \
        + d_skip[None, :, None] * xf
    return y.to(x.dtype), new_state


def causal_conv(x: Tensor, w: Tensor, state: Optional[Tensor] = None):
    """Causal depthwise conv by shift-adds.  x [B, T, C]; w [C, width].
    Returns (y [B, T, C], new_state [B, width − 1, C]).  The weight is cast
    to the activation dtype and the shifted products summed in the order
    i = 0 … width − 1, as the reference's."""
    width = w.shape[-1]
    w = w.to(x.dtype)
    if state is not None:
        x_ext = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, width - 1, 0))
    t = x.shape[1]
    y = sum(x_ext[:, i:i + t] * w[:, width - 1 - i] for i in range(width))
    new_state = x_ext[:, -(width - 1):] if width > 1 else None
    return y, new_state


def mamba2_init(cfg: ModelConfig, dense, ones, device) -> dict:
    """One Mamba2 block's weights in the reference's shapes and scales:
    ``dense(shape, scale=None, dtype=None)`` draws a projection (scale
    1/sqrt(shape[0]) by default, ``cfg.dtype`` unless ``dtype``) and
    ``ones(n)`` an fp32 norm scale.  ``dt_bias`` is the reference's numpy
    float64 inverse softplus of a log-spaced range over [dt_min, dt_max],
    cast to fp32; ``a_log`` zeros, ``d_skip`` ones and the three conv
    weights (scale 0.5) fp32."""
    sc = cfg.ssm
    d = cfg.d_model
    d_inner = sc.expand * d
    h = d_inner // sc.head_dim
    n = sc.d_state
    f32 = torch.float32
    dt_bias = np.log(np.expm1(np.exp(np.linspace(np.log(sc.dt_min),
                                                 np.log(sc.dt_max), h))))
    return {
        "w_zx": dense((d, 2 * d_inner)),
        "w_bc": dense((d, 2 * n)),
        "w_dt": dense((d, h)),
        "dt_bias": torch.as_tensor(dt_bias, dtype=f32, device=device),
        "a_log": torch.zeros(h, device=device),
        "d_skip": ones(h),
        "conv_x": dense((d_inner, sc.d_conv), scale=0.5, dtype=f32),
        "conv_b": dense((n, sc.d_conv), scale=0.5, dtype=f32),
        "conv_c": dense((n, sc.d_conv), scale=0.5, dtype=f32),
        "norm": ones(d_inner),
        "w_out": dense((d_inner, d)),
    }


def mamba2_apply(p: dict, x: Tensor, cfg: ModelConfig, *,
                 cache: Optional[dict] = None,
                 tp: Optional[_tp.ModelAxis] = None):
    """x [B, T, D] → (y [B, T, D], new state ``{"ssm": [B, H, N, P] fp32,
    "conv_x": [B, w − 1, inner], "conv_b", "conv_c": [B, w − 1, N]}``).

    A ``cache`` (that dict's leaves) with T == 1 takes the decode step from
    its state; otherwise the chunked scan starts from zeros, as the
    reference's does (a prefill is single shot).  A given ``cache`` is
    overwritten with the new state, in place.

    ``tp`` (training, ``cache=None``), where ``inner`` shards: the weights
    are this rank's shards, H/M SSM heads of P channels (``w_zx``'s halves
    [z_r | x_r], ``w_dt``, ``dt_bias``, ``a_log``, ``d_skip``, ``conv_x``,
    the norm's scale and ``w_out``'s rows); ``w_bc``, ``conv_b`` and
    ``conv_c`` are whole.  x passes ``copy_to_model`` for the rank's
    ``w_zx`` / ``w_dt`` products only, and B and C just before the scan,
    which every rank's heads read: so ``w_bc`` and the two convs get
    whole gradients.  The gated RMSNorm runs over the whole inner width:
    each rank's mean square of its columns, scaled by its share of the
    width, is summed over the ranks both ways (``sum_over_model``), and
    the ranks' ``w_out`` products are summed (``reduce_from_model``)."""
    sc = cfg.ssm
    bsz, t, d = x.shape
    d_inner = sc.expand * d
    n = sc.d_state
    if tp is not None and (cache is not None or not tp.shards("inner")):
        tp = None
    xs = x if tp is None else _tp.copy_to_model(x, tp)
    z, xin = (xs @ p["w_zx"]).chunk(2, dim=-1)
    local = z.shape[-1]                      # the rank's inner channels
    h = local // sc.head_dim
    bcr = x @ p["w_bc"]
    # torch's softplus is linear above 20, where log1p(exp(x)) equals x in
    # fp32 anyway
    dt_act = F.softplus((xs @ p["w_dt"]).float() + p["dt_bias"])
    if cache is None or t > 1:
        xc, st_x = causal_conv(xin, p["conv_x"])
        bb, st_b = causal_conv(bcr[..., :n], p["conv_b"])
        cc, st_c = causal_conv(bcr[..., n:], p["conv_c"])
        bb, cc = F.silu(bb), F.silu(cc)
        if tp is not None:
            bb, cc = _tp.copy_to_model(bb, tp), _tp.copy_to_model(cc, tp)
        y, s_new = ssd_chunked(F.silu(xc).reshape(bsz, t, h, sc.head_dim),
                               dt_act, p["a_log"], bb, cc,
                               p["d_skip"], chunk=sc.chunk)
    else:
        xc, st_x = causal_conv(xin, p["conv_x"], state=cache["conv_x"])
        bb, st_b = causal_conv(bcr[..., :n], p["conv_b"],
                               state=cache["conv_b"])
        cc, st_c = causal_conv(bcr[..., n:], p["conv_c"],
                               state=cache["conv_c"])
        y, s_new = ssd_decode_step(
            cache["ssm"], F.silu(xc)[:, 0].reshape(bsz, h, sc.head_dim),
            dt_act[:, 0], p["a_log"], F.silu(bb)[:, 0], F.silu(cc)[:, 0],
            p["d_skip"])
    new = {"ssm": s_new, "conv_x": st_x, "conv_b": st_b, "conv_c": st_c}
    if cache is not None:
        for name, val in new.items():
            cache[name].copy_(val)
    y = y.reshape(bsz, t, local) * F.silu(z)
    if tp is None:
        y = rms_norm(p["norm"], y, cfg.norm_eps)
        return (y @ p["w_out"]).to(x.dtype), new
    yf = y.float()
    ms = _tp.sum_over_model(
        yf.square().mean(dim=-1, keepdim=True) * (local / d_inner), tp)
    y = (yf * torch.rsqrt(ms + cfg.norm_eps) * p["norm"]).to(y.dtype)
    return _tp.reduce_from_model((y @ p["w_out"]).to(x.dtype), tp), new


def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype,
                      device="cuda") -> dict:
    """Zeroed state of one layer: ``ssm`` [B, H, N, P] fp32, the conv tails
    [B, w − 1, inner] and [B, w − 1, N] in ``dtype``."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    h = d_inner // sc.head_dim
    tail = (batch, sc.d_conv - 1)
    return {
        "ssm": torch.zeros((batch, h, sc.d_state, sc.head_dim),
                           device=device),
        "conv_x": torch.zeros(tail + (d_inner,), dtype=dtype, device=device),
        "conv_b": torch.zeros(tail + (sc.d_state,), dtype=dtype,
                              device=device),
        "conv_c": torch.zeros(tail + (sc.d_state,), dtype=dtype,
                              device=device),
    }
