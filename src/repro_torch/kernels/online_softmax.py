"""Online softmax (paper Algorithm 3) and its normalizer: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces ``src/repro/kernels/online_softmax.py``: ``online_softmax_pallas``
(the ``pallas_call`` of its normalizer sweep at line 66 and of its
normalize sweep at 77) and ``online_normalizer_pallas`` (99), plus kernel
forms of the bf16 and exp2 softmax forms, which the reference ran in XLA
(``src/repro/kernels/dispatch.py:514`` and ``:520``).  The kernels
(``csrc/online_softmax.cu``) take x [..., V] in float32 or bfloat16, any V
and any number of rows, and return y in x's dtype, or (m, d) in float32.

:func:`plan`, a pure function of V and the dtype, picks one of two designs:
rows that fit on chip (up to ``RESIDENT_ROW_BYTES``) are held one to a warp
or one to a CTA, so the softmax reads x once and writes y once; longer rows
stream through two sweeps over V-slices.  No option or variable selects
it.  y is allocated at x's address modulo 16 bytes (a view into a buffer a
few entries longer when x starts off a 16-byte boundary), so the kernels'
16-byte loads and stores line up on both.

A row with no finite entry, or whose leading entries are all -inf, follows
``core.online_softmax``: (m, d) = (-inf, 0) for the former, y = 0 there.
The reference's Pallas kernel gives d = NaN for both (it takes
``exp(x - m_new)`` with ``m_new = -inf``); the port does not copy that.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core import softmax_forms
from repro_torch.core.online_softmax import online_normalizer as _normalizer
from repro_torch.core.online_softmax import online_softmax as _softmax
from repro_torch.kernels import build
from repro_torch.obs import kernels as obs_kernels

VEC_BYTES = 16            # one vector load or store
WARP_ROW_BYTES = 8192     # rows up to this size: one warp a row
#: Rows up to this size stay on chip, one CTA a row (csrc rows_kernel);
#: longer rows stream in two sweeps.  Chosen on the card from the times on
#: either side of it (PERF.md): a row this size still fills one CTA's
#: shared memory (227 KB at most on the H100).
RESIDENT_ROW_BYTES = 229376
WARP_CTA_THREADS = 256    # one-warp-a-row CTAs: 8 rows each
MIN_ROW_THREADS = 64      # one-CTA-a-row CTAs: 64..512 threads,
MAX_ROW_THREADS = 512     # about 16 vectors a thread
STREAM_THREADS = 512      # streaming blocks
SLICE_VECTORS = 8192      # 16-byte vectors of one streaming (row, slice)
DESIGN_CODES = {"warp": 0, "block": 1, "stream": 2}
FORM_CODES = {"exact": 0, "bf16": 1, "exp2": 2}
#: The kernel name each form launches under.
KERNEL_NAMES = {"exact": "online_softmax", "bf16": "online_softmax_bf16",
                "exp2": "online_softmax_exp2"}
#: Counted launches per wrapper call: one C entry point each, which runs
#: the design's kernels (one row-resident kernel; or the streaming sweep
#: one, then the normalizer's merge or the softmax's sweep two).
LAUNCHES_PER_CALL = 1

#: Kernel launches since the last reset.
launches = {"online_softmax": 0, "online_softmax_bf16": 0,
            "online_softmax_exp2": 0, "online_normalizer": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_SOFTMAX_ARGTYPES = [_C, _I, _I, _I, _I, _I, _I, _I, _C, _C, _C, _C, _C, _C]
_NORMALIZER_ARGTYPES = [_C, _I, _I, _I, _I, _I, _I, _C, _C, _C, _C, _C]


class Plan(NamedTuple):
    """How the kernels take rows of V entries of one dtype."""
    design: str       # "warp", "block" (row-resident) or "stream"
    threads: int      # threads a CTA
    vec: int          # entries of one 16-byte vector
    slice_vectors: int  # 16-byte vectors of one (row, slice), streaming
    slices: int       # S: blocks a row (streaming), else 1
    smem: int         # the softmax's dynamic shared memory a CTA, bytes

    def scratch(self, rows: int) -> int:
        """Floats of each of part_m and part_d: one (m, d) per (row, slice)
        of the streaming design, none otherwise."""
        return rows * self.slices if self.design == "stream" else 0

    def tree_levels(self) -> int:
        """Merge levels of the ⊕-tree above a thread's leaf: 5 across a
        warp, log2(warps) across a CTA, and the slice merge (one warp: the
        lanes' sequential steps, then log2 of the lanes holding slices)."""
        levels = 5 + int(math.log2(self.threads // 32)) \
            if self.design != "warp" else 5
        if self.design == "stream":
            s = self.slices
            levels += (-(-s // 32) - 1) + math.ceil(math.log2(min(s, 32)))
        return levels


def plan(v: int, dtype=torch.float32) -> Plan:
    """The design the kernels use for rows of ``v`` entries of ``dtype``, a
    pure function of the two: one warp a row up to ``WARP_ROW_BYTES``, one
    CTA a row up to ``RESIDENT_ROW_BYTES`` (the row held in shared memory),
    then streaming slices of ``SLICE_VECTORS`` vectors.  Any row count
    works: rows lie on grid.x."""
    if v < 1 or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"online softmax kernels: rows of V={v} {dtype} "
                         "(need V >= 1, float32 or bfloat16)")
    esz = 4 if dtype == torch.float32 else 2
    vec = VEC_BYTES // esz
    nvec = -(-v // vec)
    row_bytes = v * esz
    if row_bytes <= WARP_ROW_BYTES:
        rows = WARP_CTA_THREADS // 32
        return Plan("warp", WARP_CTA_THREADS, vec, SLICE_VECTORS, 1,
                    rows * nvec * VEC_BYTES)
    if row_bytes <= RESIDENT_ROW_BYTES:
        threads = 1 << max(0, (-(-nvec // 16) - 1).bit_length())
        threads = min(max(threads, MIN_ROW_THREADS), MAX_ROW_THREADS)
        return Plan("block", threads, vec, SLICE_VECTORS, 1,
                    nvec * VEC_BYTES)
    return Plan("stream", STREAM_THREADS, vec, SLICE_VECTORS,
                -(-nvec // SLICE_VECTORS), 0)


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


def bf16_kernel_error_bound(x, dtype=None) -> float:
    """Max-abs bound of the bf16 kernel's y against the fp32 reference,
    from the merge tree of the design ``plan`` picks for x's V and dtype
    (``dtype`` when x is an int V; float32 if neither says).  A thread's
    leaf is an fp32 sum, rounded once to bf16; each merge level rounds every
    term already in d 3 times (the rescale's cast, the product, the sum).
    So rel(d) ≤ K·u_bf16, K = 2 + 3·levels (``Plan.tree_levels``: 5 for one
    warp a row, up to 9 for a CTA of 512, 9 plus the slice merge's levels
    streaming); 2 more bf16 ulps for the numerator and the output, and
    (2V + 8)·u₃₂ for the fp32 leaf sums and the fp32 reference.  The levels
    never fall as V grows, so neither does the bound; unlike
    ``bf16_error_bound`` (4 roundings per leaf of a sequential scan) it
    stays below 1 at any V of the paper."""
    if isinstance(x, torch.Tensor):
        v, dtype = x.shape[-1], x.dtype
    else:
        v, dtype = x, dtype or torch.float32
    k = 2 + 3 * plan(v, dtype).tree_levels()
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


def _rows(x: torch.Tensor, what: str, p: Plan | None):
    """Validate a CUDA tensor x [..., V] and view it as [R, V] rows, with
    its plan (``plan(V, dtype)`` unless given), (m, d) and the streaming
    design's scratch.  Any R works."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    code = build.dtype_code(x)
    v = x.shape[-1]
    x2 = x.reshape(-1, v).contiguous()
    r = x2.shape[0]
    if r == 0 or v == 0:
        raise ValueError(f"{what} kernel: shape {tuple(x.shape)} is empty")
    p = p or plan(v, x.dtype)
    # m, d and the scratch in one allocation
    buf = torch.empty((2 * r + 2 * p.scratch(r),), dtype=torch.float32,
                      device=x.device)
    m, d = buf[:r], buf[r:2 * r]
    part = buf[2 * r:].view(2, -1) if p.scratch(r) else (m, d)
    head = (x2, code)
    tail = (r, v, DESIGN_CODES[p.design], p.threads, p.slice_vectors)
    return head, tail, x2, m, d, part


def _like_at_same_offset(x2: torch.Tensor) -> torch.Tensor:
    """An empty tensor shaped like x2 whose address equals x2's modulo 16
    bytes, so one split of a row into head, 16-byte vectors and tail serves
    x and y."""
    if x2.data_ptr() % VEC_BYTES == 0:
        return torch.empty_like(x2)
    esz = x2.element_size()
    n = x2.numel()
    buf = torch.empty((n + VEC_BYTES // esz,), dtype=x2.dtype,
                      device=x2.device)
    off = ((x2.data_ptr() - buf.data_ptr()) % VEC_BYTES) // esz
    return buf[off:off + n].view(x2.shape)


def prepare(x: torch.Tensor, form: str = "exact"):
    """Validate x and allocate y, (m, d) and scratch for the softmax of
    ``form``.  Returns (call, y [..., V] in x's dtype); :func:`launch`
    fills y."""
    return prepare_plan(x, form, None)


def prepare_plan(x: torch.Tensor, form: str, p: Plan | None):
    """:func:`prepare` under the plan ``p`` (``plan(V, dtype)`` when None):
    how ``chip_smoke.py`` times one design against the other at the same
    V.  The entry points always take ``plan``'s."""
    if form not in FORM_CODES:
        raise ValueError(f"unknown softmax form {form!r}; expected one of "
                         f"{tuple(FORM_CODES)}")
    head, tail, x2, m, d, part = _rows(x, KERNEL_NAMES[form], p)
    y = _like_at_same_offset(x2)
    args = (*head, FORM_CODES[form], *tail, y, m, d, part[0], part[1])
    return ("online_softmax", KERNEL_NAMES[form], _SOFTMAX_ARGTYPES,
            args), y.reshape(x.shape)


def prepare_normalizer(x: torch.Tensor):
    """Validate x and allocate (m, d) and scratch.  Returns (call, (m, d)
    shaped like x's leading axes)."""
    head, tail, _, m, d, part = _rows(x, "online_normalizer", None)
    args = (*head, *tail, m, d, part[0], part[1])
    lead = x.shape[:-1]
    return ("online_normalizer", "online_normalizer", _NORMALIZER_ARGTYPES,
            args), (m.reshape(lead), d.reshape(lead))


def launch(call) -> None:
    """Launch a prepared call (counts one launch of its kernel name)."""
    entry, name, argtypes, args = call
    build.call(entry, argtypes, args, source="online_softmax")
    launches[name] += 1
    obs_kernels.record_path(name, "cuda")


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
