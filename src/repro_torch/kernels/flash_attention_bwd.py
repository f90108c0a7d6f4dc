"""Flash attention backward: the CUDA kernels' wrapper and its plain PyTorch
version.

``flash_attention_bwd`` replaces
``src/repro/kernels/flash_attention_bwd.py:flash_attention_bwd_pallas`` (the
``pallas_call``\\ s at line 134, dq, and 154, dk/dv).  bf16 operands run
the tensor-core (wgmma) forms of the two kernels, fp32 operands the
CUDA-core forms, by dtype alone (``csrc/flash_attention_bwd.cu``).  Both
forms recompute ``p = exp(s − lse)`` from the forward's saved log-sum-exp,
with ``delta = rowsum(dO ⊙ O)`` in fp32 computed here by PyTorch, as the
reference computed it outside its kernels (line 128).  The dk/dv kernel
loops over the query heads of each KV head's group, so dk and dv come back
already reduced to the KV heads; the reference emitted them per query head
and its wrapper summed them (``ops.py:196-197``).

Both kernels take the forward's causal ``q_offset`` (query row i at
position q_offset + i over keys 0..Tk-1), one integer for the launch; a
launch at an offset other than 0 counts as ``flash_attention_bwd_dq_qoffset``
and ``flash_attention_bwd_dkv_qoffset``.

Layouts keep the model's: q, dq [B, Tq, Hq, Dqk]; out, dout
[B, Tq, Hq, Dv]; k, dk [B, Tk, Hkv, Dqk]; v, dv [B, Tk, Hkv, Dv]; lse
[B, Hq, Tq] float32 (``flash_attention_fwd``'s).  Dv is Dqk's except in
MLA's decompressed training form (Dqk 96 = 64 nope + 32 rope, Dv 64).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.obs import kernels as obs_kernels

#: The (Dqk, Dv) head-dim pairs the backward kernels (and the fresh
#: forward) have csrc instances for: (64, 64) (smollm-360m), (128, 128)
#: (mistral-nemo-12b, qwen2-moe-a2.7b) and (96, 64) (minicpm3-4b's
#: decompressed MLA).  Another pair raises.
HEAD_DIMS = ((64, 64), (128, 128), (96, 64))

#: Kernel launches since the last reset (the training path's proof of route).
launches = {"flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq_qoffset": 0,
            "flash_attention_bwd_dkv_qoffset": 0}

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "flash_attention_bwd_dq": [_C] * 7 + [_I] * 8 + [_L] * 6
    + [ctypes.c_float, _I, _I, _C],
    "flash_attention_bwd_dkv": [_C] * 8 + [_I] * 8 + [_L] * 6
    + [ctypes.c_float, _I, _I, _C],
}


def check_q_offset(name, q_offset, tq, tk, causal) -> int:
    """The fresh kernels' causal offset as an int: query row i at position
    q_offset + i, so under the mask the keys must reach the last row's
    position (Tk >= q_offset + Tq).  Raises otherwise, and on a tensor of
    per-row offsets (the cached-prefill kernel's)."""
    if torch.is_tensor(q_offset):
        if q_offset.dim() != 0:
            raise ValueError(f"{name} kernel: one q_offset for the launch, "
                             f"got {tuple(q_offset.shape)}")
        q_offset = int(q_offset)
    q_offset = int(q_offset)
    if q_offset < 0 or (causal and tk < q_offset + tq):
        raise ValueError(f"{name} kernel: q_offset {q_offset} with Tq={tq}, "
                         f"Tk={tk} (need 0 <= q_offset, Tk >= q_offset + Tq)")
    return q_offset


def kv_strides(name, k, v, b):
    """k [B, Tk, Hkv, Dqk] and v [B, Tk, Hkv, Dv] of the fresh kernels are
    read through their strides, each with a unit last stride: at equal
    widths K's and V's must be equal (the kernels address both rows at
    once), at (96, 64) each has its own (MLA's k is a concatenation 96
    wide, its v a 64-wide product).  Returns (sb, ss, sh, vsb, vss,
    vsh)."""
    if k.dim() != 4 or v.dim() != 4 or k.shape[0] != b or \
            v.shape[:3] != k.shape[:3] or k.stride(-1) != 1 or \
            v.stride(-1) != 1 or (v.shape[-1] == k.shape[-1]
                                  and k.stride() != v.stride()):
        raise ValueError(f"{name} kernel: K/V {tuple(k.shape)}/"
                         f"{tuple(v.shape)} with strides {k.stride()}/"
                         f"{v.stride()} for {b} rows (need [B, Tk, Hkv, D] "
                         "each, unit last strides, equal K/V strides at "
                         "equal widths)")
    return k.stride()[:3] + v.stride()[:3]


def check_wgmma_operands(name, tensors, strides) -> None:
    """The bf16 kernels copy 16-byte chunks: every operand's pointer must be
    16-byte aligned and K/V's element strides multiples of 8.  Raises
    otherwise (fp32 operands pass unchecked)."""
    if tensors[0].dtype != torch.bfloat16:
        return
    if any(t.data_ptr() % 16 for t in tensors) or any(x % 8 for x in strides):
        raise ValueError(f"{name} kernel (bf16): operands must be 16-byte "
                         f"aligned and K/V strides {tuple(strides)} multiples "
                         "of 8")


def _acc_dtype(t):
    """fp32 accumulation, fp64 for fp64 inputs (which gradient checks use)."""
    return torch.promote_types(t.dtype, torch.float32)


def _delta(out, dout):
    """rowsum(dO ⊙ O) in fp32: [B, Tq, Hq, Dv] → [B, Hq, Tq]."""
    f = _acc_dtype(out)
    return (dout.to(f) * out.to(f)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *,
                              causal: bool = True, q_offset: int = 0):
    """The kernels' plain version, the reference kernels' formulas spelled
    out (``flash_attention_bwd.py:35-60`` and ``75-106``) over the whole
    score matrix: p = exp(s − lse), dp = dO·vᵀ, ds = p·(dp − delta)·scale,
    dq = ds·k, dk = dsᵀ·q, dv = pᵀ·dO, with dk and dv summed over each KV
    head's query heads; query row i at position ``q_offset`` + i.  dO, dp's contraction and dv take v's head dim, dq
    and dk q's.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, tq, hq, dh = q.shape
    tk, hkv, dv_ = k.shape[1], k.shape[2], v.shape[-1]
    g = hq // hkv
    scale = dh ** -0.5
    f = _acc_dtype(q)
    qf = q.to(f).reshape(b, tq, hkv, g, dh)
    dof = dout.to(f).reshape(b, tq, hkv, g, dv_)
    kf, vf = k.to(f), v.to(f)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf * scale, kf)
    lse_ = lse.reshape(b, hkv, g, tq, 1)
    p = torch.exp(s - lse_)
    if causal:
        keep = (torch.arange(tk, device=q.device)[None, :]
                <= q_offset + torch.arange(tq, device=q.device)[:, None])
        p = torch.where(keep, p, torch.zeros_like(p))
    delta = _delta(out, dout).reshape(b, hkv, g, tq, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, tq, hq, dh)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def prepare(q, k, v, out, lse, dout, *, causal: bool = True,
            q_offset: int = 0):
    """Validate CUDA operands of the two kernels, compute delta and allocate
    dq, dk, dv.  k [B, Tk, Hkv, Dqk] and v [B, Tk, Hkv, Dv] are passed by
    their own strides, never copied; query row i at position ``q_offset``
    + i, the forward's.  Returns (dq launch arguments, dk/dv
    launch arguments, (dq, dk, dv)); :func:`launch` fills them."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd kernel needs CUDA tensors, "
                         f"got {q.device}")
    b, tq, hq, dh = q.shape
    dvw = v.shape[-1]
    if k.dim() != 4 or v.dim() != 4 or k.shape[0] != b or \
            k.shape[-1] != dh or v.shape[:3] != k.shape[:3] or \
            out.shape != (b, tq, hq, dvw) or dout.shape != out.shape or \
            lse.shape != (b, hq, tq):
        raise ValueError(f"flash_attention_bwd kernel: q {tuple(q.shape)}, "
                         f"K/V {tuple(k.shape)}/{tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not match")
    tk, hkv = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype or dout.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd kernel: q {q.dtype}, K/V "
                         f"{k.dtype}/{v.dtype}, dout {dout.dtype}, lse "
                         f"{lse.dtype} (need one dtype and float32 lse)")
    if hq % hkv or (dh, dvw) not in HEAD_DIMS or hq > 65535 or \
            b > 65535 or tq == 0 or tk == 0:
        raise ValueError(f"flash_attention_bwd kernel: Hq={hq}, Hkv={hkv}, "
                         f"D={dh}, Dv={dvw}, Tq={tq}, Tk={tk} not supported "
                         f"((D, Dv) in {HEAD_DIMS})")
    strides = kv_strides("flash_attention_bwd", k, v, b)
    q_offset = check_q_offset("flash_attention_bwd", q_offset, tq, tk, causal)
    code = build.dtype_code(q)
    qc, doc, lc = q.contiguous(), dout.contiguous(), lse.contiguous()
    check_wgmma_operands("flash_attention_bwd", (qc, k, v, doc), strides)
    delta = _delta(out, dout)
    dq = torch.empty_like(qc)
    dk = torch.empty((b, tk, hkv, dh), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, tk, hkv, dvw), dtype=v.dtype, device=v.device)
    tail = (code, b, tq, tk, hq, hkv, dh, dvw, *strides, float(dh ** -0.5),
            int(bool(causal)), q_offset)
    suffix = "_qoffset" if q_offset else ""
    dq_args = ("flash_attention_bwd_dq" + suffix, qc, k, v, doc, lc, delta,
               dq) + tail
    dkv_args = ("flash_attention_bwd_dkv" + suffix, qc, k, v, doc, lc, delta,
                dk, dv) + tail
    return dq_args, dkv_args, (dq, dk, dv)


def launch(args) -> None:
    """Launch a prepared kernel (counts one launch of it, under its name:
    the kernel's, ``_qoffset`` added at an offset)."""
    name = args[0]
    entry = name.removesuffix("_qoffset")
    build.call(entry, _ARGTYPES[entry], args[1:],
               source="flash_attention_bwd")
    launches[name] += 1
    obs_kernels.record_path(name, "cuda")


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        q_offset: int = 0):
    """Launch the dq and the dk/dv kernels on CUDA tensors, query row i
    at position ``q_offset`` + i.  Returns (dq [B, Tq, Hq, Dqk], dk
    [B, Tk, Hkv, Dqk], dv [B, Tk, Hkv, Dv]) in the dtypes of q, k and v."""
    dq_args, dkv_args, grads = prepare(q, k, v, out, lse, dout,
                                       causal=causal, q_offset=q_offset)
    launch(dq_args)
    launch(dkv_args)
    return grads
