"""Reduced-precision online-softmax forms and their analytic error bounds.

Port of ``src/repro/core/softmax_forms.py``: the blocked online ``(m, d)``
scan (``_blocked``/``_online_md``/``_normalize``, lines 54-92) with its two
knobs, the exponential and the accumulator dtype; the three forms
``softmax_bf16`` (95), ``softmax_exp2`` (106) and ``softmax_exact`` (113);
the analytic bounds (146-185), ``FORMS`` and ``int8_roundtrip_bound`` (215).
The bounds are numpy only; the port keeps its own copy.

These are the plain versions of the reduced-precision kernel forms in
``kernels/csrc/online_softmax.cu``: the bf16 form holds ``d`` in bfloat16,
summing each 128-entry leaf in float32, rounding the leaf sum to bfloat16
and merging leaves with the rescale, the product and the sum each rounded to
bfloat16; the exp2 form computes every exponential as ``2^(z·log₂e)`` with
the product rounded to float32.  Each bound is a worst-case max-abs
deviation from the fp32 two-pass reference (``safe_softmax``), computed from
the input's shape and dynamic range, never from an output.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.online_softmax import NEG_INF, safe_softmax

Tensor = torch.Tensor

BF16_EPS = 2.0 ** -8      # bfloat16 unit roundoff (8-bit significand)
F32_EPS = 2.0 ** -24      # float32 unit roundoff
LOG2E = 1.4426950408889634
DEFAULT_BLOCK = 128       # ⊕-tree leaf width of the blocked scan


def _blocked(x: Tensor, block: int) -> tuple[Tensor, int]:
    """[..., V] → ([..., NB, BLK] float32 padded with −inf, original V)."""
    xf = x.float()
    v = xf.shape[-1]
    pad = -v % block
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad), value=NEG_INF)
    return xf.reshape(*xf.shape[:-1], -1, block), v


def _online_md(xb: Tensor, *, exp_fn: Callable,
               acc_dtype: torch.dtype) -> tuple[Tensor, Tensor]:
    """Blocked online (m, d) scan: Algorithm 3 at block granularity.
    ``xb`` [..., NB, BLK] → (m [...] float32, d [...] in ``acc_dtype``)."""
    lead = xb.shape[:-2]
    m = torch.full(lead, NEG_INF, dtype=torch.float32, device=xb.device)
    d = torch.zeros(lead, dtype=acc_dtype, device=xb.device)
    for j in range(xb.shape[-2]):
        xj = xb[..., j, :]
        m_new = torch.maximum(m, xj.amax(dim=-1))
        alpha = exp_fn(torch.where(m == m_new, torch.zeros_like(m), m - m_new))
        p = torch.where(torch.isneginf(xj), torch.zeros_like(xj),
                        exp_fn(xj - m_new[..., None]))
        d = d * alpha.to(acc_dtype) + p.sum(dim=-1).to(acc_dtype)
        m = m_new
    return m, d


def _normalize(x: Tensor, m: Tensor, d: Tensor, exp_fn: Callable) -> Tensor:
    xf = x.float()
    num = torch.where(torch.isneginf(xf), torch.zeros_like(xf),
                      exp_fn(xf - m[..., None]))
    df = d.float()
    den = torch.where(df == 0, torch.ones_like(df), df)[..., None]
    y = num / den
    return y.to(x.dtype) if x.is_floating_point() else y


def _exp2_fn(z: Tensor) -> Tensor:
    return torch.exp2(z * torch.tensor(LOG2E, dtype=torch.float32))


_KNOBS = {"exact": (torch.exp, torch.float32),
          "bf16": (torch.exp, torch.bfloat16),
          "exp2": (_exp2_fn, torch.float32)}


def _softmax(x: Tensor, form: str, block: int) -> Tensor:
    """The blocked scan with the form's two knobs, then the normalize."""
    exp_fn, acc_dtype = _KNOBS[form]
    xb, _ = _blocked(x, block)
    m, d = _online_md(xb, exp_fn=exp_fn, acc_dtype=acc_dtype)
    return _normalize(x, m, d, exp_fn)


def softmax_bf16(x: Tensor, *, block: int = DEFAULT_BLOCK) -> Tensor:
    """Online softmax with the normalizer accumulated in bfloat16."""
    return _softmax(x, "bf16", block)


def softmax_exp2(x: Tensor, *, block: int = DEFAULT_BLOCK) -> Tensor:
    """Online softmax with exponentials as ``2^(z·log₂e)`` (hardware exp2)."""
    return _softmax(x, "exp2", block)


def softmax_exact(x: Tensor, *, block: int = DEFAULT_BLOCK) -> Tensor:
    """The fp32 online form on the same blocked scan — the control case."""
    return _softmax(x, "exact", block)


# ---------------------------------------------------------------------------
# Analytic error bounds (the reference's derivations, lines 131-185).
# ---------------------------------------------------------------------------
def _n_blocks(v: int, block: int) -> int:
    return max(math.ceil(v / block), 1)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _row_range(x) -> float:
    """max over rows of (row max − row min) over finite entries — the R in
    the exp2 bound; −inf entries contribute exp2(−inf) = 0 exactly."""
    xf = _np(x).reshape(-1, np.shape(x)[-1])
    fin = np.isfinite(xf)
    hi = np.where(fin, xf, -np.inf).max(axis=-1)
    lo = np.where(fin, xf, np.inf).min(axis=-1)
    r = hi - lo
    r = r[np.isfinite(r)]
    return float(r.max()) if r.size else 0.0


def exact_error_bound(x, *, block: int = DEFAULT_BLOCK) -> float:
    """fp32-vs-fp32 slop: ≤ (2V + 8)·u₃₂ relative on either statistic."""
    v = np.shape(x)[-1]
    t = (2 * v + 8) * F32_EPS
    return t / (1 - t)


def bf16_error_bound(x, *, block: int = DEFAULT_BLOCK) -> float:
    """rel(d) ≤ (4·NB + 2)·u_bf16 over NB blocks, plus 2 bf16 ulps for the
    numerator and the fp32 reference.  Raises where the bound is vacuous
    (t ≥ 0.5)."""
    v = np.shape(x)[-1]
    nb = _n_blocks(v, block)
    t = (4 * nb + 4) * BF16_EPS
    if t >= 0.5:
        raise ValueError(
            f"vacuous bf16 bound (t={t:.2f} ≥ 0.5) for V={v}, block={block}")
    return t / (1 - t)


def exp2_error_bound(x, *, block: int = DEFAULT_BLOCK) -> float:
    """exp2 term error 2·R·u₃₂ + u₃₂ per exponential (R the row's finite
    dynamic range), numerator + denominator, fp32 accumulation over NB
    blocks and V terms, and the reference's own (V+2)·u₃₂."""
    v = np.shape(x)[-1]
    nb = _n_blocks(v, block)
    r = _row_range(x)
    t = (4.0 * r + 4 * nb + 2 * v + 16) * F32_EPS
    return t / (1 - t)


class Form(NamedTuple):
    apply: Callable          # x → softmax(x), the reduced-precision way
    error_bound: Callable    # x → analytic max-abs bound vs fp32 reference


#: Every reduced-precision softmax form, keyed by the name
#: ``kernels.dispatch.set_softmax_form`` accepts.
FORMS: dict[str, Form] = {
    "exact": Form(softmax_exact, exact_error_bound),
    "bf16": Form(softmax_bf16, bf16_error_bound),
    "exp2": Form(softmax_exp2, exp2_error_bound),
}

reference = safe_softmax


#: fp32 slack multiplier in the int8 roundtrip bound (≤ 8 u₃₂ on 127·s).
_INT8_F32_SLACK = 8 * F32_EPS


def int8_roundtrip_bound(scale) -> np.ndarray:
    """Per-position max-abs reconstruction bound for the int8 KV roundtrip:
    ``|q·ŝ − x| ≤ 127·s·u_bf16 + s·(½ + fp32 slack)`` for the fp32 scale
    ``s`` (clamped ≥ 1e-8) and its bf16-rounded copy ``ŝ``."""
    s = np.maximum(_np(scale), 1e-8)
    return s * (0.5 + 127.0 * BF16_EPS + 127.0 * _INT8_F32_SLACK)
