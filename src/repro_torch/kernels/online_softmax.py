"""Online softmax (paper Algorithm 3) and its normalizer: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces ``src/repro/kernels/online_softmax.py``: ``online_softmax_pallas``
(the ``pallas_call`` of its normalizer sweep at line 66 and of its
normalize sweep at 77) and ``online_normalizer_pallas`` (99), plus kernel
forms of the bf16 and exp2 softmax forms, which the reference ran in XLA
(``src/repro/kernels/dispatch.py:514`` and ``:520``).  The kernels
(``csrc/online_softmax.cu``) take x [..., V] in float32 or bfloat16, any V,
and return y in x's dtype, or (m, d) in float32.

A row with no finite entry, or whose leading entries are all -inf, follows
``core.online_softmax``: (m, d) = (-inf, 0) for the former, y = 0 there.
The reference's Pallas kernel gives d = NaN for both (it takes
``exp(x - m_new)`` with ``m_new = -inf``); the port does not copy that.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import softmax_forms
from repro_torch.core.online_softmax import online_normalizer as _normalizer
from repro_torch.core.online_softmax import online_softmax as _softmax
from repro_torch.kernels import build

LEAF = 128            # entries of one leaf (the forms' ⊕-tree leaf)
SLICE = 32 * LEAF     # entries of one phase-one block
WARP_LEAVES = 4       # leaves one warp scans in order within a slice
BLOCK_WARPS = 8       # warps ⊕-merged by one phase-one block
FORM_CODES = {"exact": 0, "bf16": 1, "exp2": 2}
#: The kernel name each form launches under.
KERNEL_NAMES = {"exact": "online_softmax", "bf16": "online_softmax_bf16",
                "exp2": "online_softmax_exp2"}
#: Counted launches per wrapper call: one C entry point each, which runs
#: the normalizer sweep (and its ⊕-merge when V > SLICE) and, for the
#: softmax, the normalize sweep.
LAUNCHES_PER_CALL = 1

#: Kernel launches since the last reset.
launches = {"online_softmax": 0, "online_softmax_bf16": 0,
            "online_softmax_exp2": 0, "online_normalizer": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_SOFTMAX_ARGTYPES = [_C, _I, _I, _I, _I, _C, _C, _C, _C, _C, _C]
_NORMALIZER_ARGTYPES = [_C, _I, _I, _I, _C, _C, _C, _C, _C]


def online_softmax_plain(x: torch.Tensor, form: str = "exact") -> torch.Tensor:
    """The plain PyTorch version: ``core.online_softmax`` for the exact
    form, ``core.softmax_forms.softmax_bf16`` / ``softmax_exp2`` for the
    others."""
    if form == "exact":
        return _softmax(x)
    return softmax_forms.FORMS[form].apply(x)


def online_normalizer_plain(x: torch.Tensor):
    """The plain PyTorch version of the normalizer: (m, d) over the last
    axis (``core.online_normalizer``)."""
    return _normalizer(x)


def n_slices(v: int) -> int:
    return -(-v // SLICE)


def bf16_kernel_error_bound(x) -> float:
    """Max-abs bound of the bf16 kernel's y against the fp32 reference,
    from its merge tree.  Each leaf's fp32 sum is rounded once to bf16; a
    warp scans ≤ 4 leaves in order and each later step rounds every term
    already in d 3 times (the rescale's cast, the product, the sum); the
    block ⊕-merges 8 warps (3 levels) and phase two S slices (⌈S/32⌉ − 1
    lane steps, then ⌈log₂ min(S, 32)⌉ levels), 3 roundings a level.  So
    rel(d) ≤ K·u_bf16, K = 2 + 3·(3 + 3 + levels(S)); 2 more bf16 ulps for
    the numerator and the output, and (2V + 8)·u₃₂ for the fp32 leaf sums
    and the fp32 reference.  Unlike ``bf16_error_bound`` (4 roundings per
    leaf of a sequential scan) it stays below 1 at any V of the paper."""
    v = x.shape[-1] if isinstance(x, torch.Tensor) else x
    s = n_slices(v)
    levels = (-(-s // 32) - 1) + math.ceil(math.log2(min(s, 32)))
    k = 2 + 3 * ((WARP_LEAVES - 1) + math.ceil(math.log2(BLOCK_WARPS))
                 + levels)
    t = ((k + 2) * softmax_forms.BF16_EPS
         + (2 * v + 8) * softmax_forms.F32_EPS)
    return t / (1 - t)


def kernel_error_bound(x: torch.Tensor, form: str) -> float:
    """Max-abs bound of the kernel's y in ``form`` against the fp32
    reference on the same input: the form's analytic bound (the bf16 form's
    from the kernel's merge tree), plus one bf16 rounding of y (≤ 1) when x
    is bfloat16."""
    if form == "bf16":
        bound = bf16_kernel_error_bound(x)
    else:
        bound = softmax_forms.FORMS[form].error_bound(x)
    if x.dtype == torch.bfloat16:
        bound += softmax_forms.BF16_EPS
    return bound


def _rows(x: torch.Tensor, what: str):
    """Validate a CUDA tensor x [..., V] and view it as [R, V] rows."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    code = build.dtype_code(x)
    v = x.shape[-1]
    x2 = x.reshape(-1, v).contiguous()
    r = x2.shape[0]
    if r == 0 or v == 0 or r > 65535:
        raise ValueError(f"{what} kernel: shape {tuple(x.shape)} is empty or "
                         "has more than 65535 rows")
    dev = dict(dtype=torch.float32, device=x.device)
    m = torch.empty((r,), **dev)
    d = torch.empty((r,), **dev)
    s = n_slices(v)
    part = torch.empty((2, r * s if s > 1 else 1), **dev)
    return x2, code, r, v, m, d, part


def prepare(x: torch.Tensor, form: str = "exact"):
    """Validate x and allocate y, (m, d) and scratch for the softmax of
    ``form``.  Returns (call, y [..., V] in x's dtype); :func:`launch`
    fills y."""
    if form not in FORM_CODES:
        raise ValueError(f"unknown softmax form {form!r}; expected one of "
                         f"{tuple(FORM_CODES)}")
    x2, code, r, v, m, d, part = _rows(x, KERNEL_NAMES[form])
    y = torch.empty_like(x2)
    args = (x2, code, FORM_CODES[form], r, v, y, m, d, part[0], part[1])
    return ("online_softmax", KERNEL_NAMES[form], _SOFTMAX_ARGTYPES,
            args), y.reshape(x.shape)


def prepare_normalizer(x: torch.Tensor):
    """Validate x and allocate (m, d) and scratch.  Returns (call, (m, d)
    shaped like x's leading axes)."""
    x2, code, r, v, m, d, part = _rows(x, "online_normalizer")
    args = (x2, code, r, v, m, d, part[0], part[1])
    lead = x.shape[:-1]
    return ("online_normalizer", "online_normalizer", _NORMALIZER_ARGTYPES,
            args), (m.reshape(lead), d.reshape(lead))


def launch(call) -> None:
    """Launch a prepared call (counts one launch of its kernel name)."""
    entry, name, argtypes, args = call
    build.call(entry, argtypes, args, source="online_softmax")
    launches[name] += 1


def online_softmax(x: torch.Tensor, form: str = "exact") -> torch.Tensor:
    """Softmax over the last axis of a CUDA tensor, in one of the forms."""
    call, y = prepare(x, form)
    launch(call)
    return y


def online_normalizer(x: torch.Tensor):
    """(m, d) over the last axis of a CUDA tensor, float32."""
    call, md = prepare_normalizer(x)
    launch(call)
    return md
