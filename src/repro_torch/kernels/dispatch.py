"""Kernel dispatch of the port: the entries model, serving and library code
call.

Port of ``src/repro/kernels/dispatch.py``: ``sdpa`` (line 816) with its
paged routes (``_paged_sdpa``, 696-731) and its contiguous routes (858-903,
without the sharded branch), int8 K/V included, ``softmax_topk`` (778),
``online_softmax`` (767) with the softmax-form preference
(``SOFTMAX_FORMS``/``softmax_form``/``set_softmax_form``, 738-764, read from
``REPRO_SOFTMAX_FORM`` at import as at 909), and ``online_normalizer`` (the
library's ``ops.online_normalizer``).
The reference chose Pallas by a config preference (``cfg.use_pallas``) and a
capability probe; here the choice goes by the tensor's device alone:

* ``cuda`` launches the hand-written kernel, or raises on what it does not
  take — never the plain version;
* ``cpu`` runs the kernel's plain PyTorch version;
* any other device raises.

Fresh attention (``kv_valid_len`` unset, ``q_offset`` 0: the training
form) runs ``FlashAttention`` on CUDA, the forward kernel with its dq and
dk/dv backward kernels, as the reference's ``_attention_pallas`` ran
``ops._flash`` (``dispatch.py:540``); on the CPU it runs the chunked online
form, which autograd differentiates.  On CUDA a custom scale and a value
head_dim other than q's still raise ``NotImplementedError``; on the CPU the
chunked online form serves them, as the reference's XLA path did.

int8 K/V come with ``k_scale``/``v_scale``: scale pages [P, Hkv, BS] beside
int8 pools (paged) or [B, S, Hkv] beside int8 caches.  On CUDA they launch
the int8 forms of the paged decode and prefill kernels and of the
contiguous decode kernel; a contiguous int8 prefill has no kernel (the
serving path's int8 prefill attends over fp K/V) and raises.  On the CPU
the same dequantizing chunked form the reference ran serves them all.

The online softmax runs its form's kernel on CUDA (exact, bf16 or exp2, all
in ``csrc/online_softmax.cu``) and the form's plain version on the CPU
(``core.online_softmax``, ``core.softmax_forms.softmax_bf16`` /
``softmax_exp2``).  No CUDA entry returns a detached result: under grad
mode a requires-grad input runs ``softmax_topk`` through
``ops.softmax_topk`` and ``online_softmax`` through ``ops.OnlineSoftmax``
(each launches the same kernel once, with a backward), and
``online_normalizer``, which has no backward (nor had the reference's
Pallas normalizer), raises; on the CPU the plain versions carry autograd.
The reference's autotuned vocab block (``tuned_block``/``block_decision``,
300-360) is a TPU tile sweep with no Hopper meaning yet and has no
counterpart.
"""
from __future__ import annotations

import os

import torch

from repro_torch import core
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import flash_attention_bwd as _flash_attention_bwd
from repro_torch.kernels import flash_decode as _flash_decode
from repro_torch.kernels import online_softmax as _online_softmax
from repro_torch.kernels import softmax_topk as _softmax_topk

_KERNEL_MODULES = {"softmax_topk": _softmax_topk,
                   "flash_decode_paged": _flash_decode,
                   "flash_decode": _flash_decode,
                   "flash_attention_paged": _flash_attention,
                   "flash_attention_offset": _flash_attention,
                   "flash_attention": _flash_attention,
                   "flash_attention_bwd_dq": _flash_attention_bwd,
                   "flash_attention_bwd_dkv": _flash_attention_bwd,
                   "flash_decode_paged_int8": _flash_decode,
                   "flash_decode_int8": _flash_decode,
                   "flash_attention_paged_int8": _flash_attention,
                   "online_softmax": _online_softmax,
                   "online_softmax_bf16": _online_softmax,
                   "online_softmax_exp2": _online_softmax,
                   "online_normalizer": _online_softmax}


def launch_counts() -> dict:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches[name] for name, mod in _KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in _KERNEL_MODULES.items():
        mod.launches[name] = 0


def _wants_grad(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _require_cpu(t, op: str) -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(f"{op}: no kernel or plain version for "
                                  f"device {t.device}")


SOFTMAX_FORMS = ("exact", "bf16", "exp2")
_SOFTMAX_FORM = "exact"


def softmax_form() -> str:
    """The softmax form currently preferred ("exact" / "bf16" / "exp2")."""
    return _SOFTMAX_FORM


def set_softmax_form(form: str) -> str:
    """Set the process softmax-form preference; returns the previous form.

    "exact" is the standard online form; "bf16" accumulates the normalizer
    in bfloat16; "exp2" computes exponentials as ``2^((x−m)·log2 e)``.
    Each form's worst-case deviation from the fp32 two-pass reference is
    bounded in ``core.softmax_forms``.  Also settable via the
    ``REPRO_SOFTMAX_FORM`` environment variable (read at import)."""
    global _SOFTMAX_FORM
    prev = _SOFTMAX_FORM
    _SOFTMAX_FORM = _known_form(form)
    return prev


def _known_form(form: str) -> str:
    if form not in SOFTMAX_FORMS:
        raise ValueError(
            f"unknown softmax form {form!r}; expected one of {SOFTMAX_FORMS}")
    return form


def online_softmax(x, *, form: str | None = None):
    """Softmax over the last axis (paper Algorithm 3) in ``form``, unset:
    the process preference (``set_softmax_form`` / ``REPRO_SOFTMAX_FORM``)."""
    form = _SOFTMAX_FORM if form is None else _known_form(form)
    if x.device.type == "cuda":
        if _wants_grad(x):
            from repro_torch.kernels import ops
            return ops.OnlineSoftmax.apply(x, form)
        return _online_softmax.online_softmax(x, form)
    _require_cpu(x, "online_softmax")
    return _online_softmax.online_softmax_plain(x, form)


def online_normalizer(x):
    """(m, d) over the last axis (Algorithm 3 lines 1-6), float32.  The
    kernel has no backward: on CUDA a requires-grad input under grad mode
    raises rather than coming back detached."""
    if x.device.type == "cuda":
        if _wants_grad(x):
            raise NotImplementedError(
                "online_normalizer has no backward on CUDA: call it under "
                "torch.no_grad() or on a detached input")
        return _online_softmax.online_normalizer(x)
    _require_cpu(x, "online_normalizer")
    return _online_softmax.online_normalizer_plain(x)


def softmax_topk(x, k: int,
                 differentiable: bool = False) -> "core.SoftmaxTopK":
    """Fused softmax+top-k (paper Algorithm 4) over the last axis.

    A requires-grad input under grad mode, or ``differentiable``, routes
    through ``ops.softmax_topk``, whose backward recomputes the softmax
    from the saved log-sum-exp (the reference is differentiable on every
    path and ignores the flag); otherwise the kernel runs bare (the serving
    path's logits need no gradient).  Both routes launch the kernel once."""
    if differentiable or _wants_grad(x):
        from repro_torch.kernels import ops
        return ops.softmax_topk(x, k)
    if x.device.type == "cuda":
        return _softmax_topk.softmax_topk(x, k)
    _require_cpu(x, "softmax_topk")
    return _softmax_topk.softmax_topk_plain(x, k)


def sdpa(cfg, q, k, v, *, causal, q_offset, kv_valid_len, scale=None,
         decode: bool = False, k_scale=None, v_scale=None, block_tables=None):
    """Attention — the single entry model layers call.

    q [B, Tq, Hq, D].  With ``block_tables`` [B, M] set, k/v are block pools
    [P, Hkv, BS, D] and the paged routes run (``decode`` picks the one-token
    kernel); otherwise k/v are contiguous [B, Tk, Hkv, D].  ``q_offset`` is
    the absolute position of query row 0 and ``kv_valid_len`` the valid
    cache prefix per row; masking is in absolute coordinates.  ``k_scale``/
    ``v_scale`` set: k/v are int8 with these bf16 scales (pages
    [P, Hkv, BS], or [B, Tk, Hkv]), dequantized after the read.
    """
    if block_tables is not None:
        return _paged_sdpa(cfg, q, k, v, causal=causal, q_offset=q_offset,
                           kv_valid_len=kv_valid_len, scale=scale,
                           decode=decode, block_tables=block_tables,
                           k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cuda":
        _require_kernel_form(q, v, scale, "contiguous attention")
        if decode:
            return _flash_decode.flash_decode(q, k, v, kv_valid_len,
                                              k_scale=k_scale, v_scale=v_scale)
        if k_scale is not None:
            raise NotImplementedError(
                "contiguous int8 attention wider than one token has no "
                "kernel: the int8 prefill attends over its exact K/V")
        if kv_valid_len is None:
            if not (isinstance(q_offset, int) and q_offset == 0):
                raise NotImplementedError(
                    "fresh attention on CUDA takes q_offset 0 (an offset "
                    "needs kv_valid_len: the cached-prefill kernel)")
            return _flash_attention.FlashAttention.apply(q, k, v, causal)
        out, _ = _flash_attention.flash_attention_offset(
            q, k, v, q_offset, kv_valid_len, causal=causal)
        return out
    _require_cpu(q, "sdpa")
    # the chunked online form: the plain version of both contiguous kernels
    # (flash_decode_plain, flash_attention_offset_plain) and of the fresh
    # forward (flash_attention_fwd_plain), differentiated by autograd
    return core.online_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len,
                                 chunk_size=cfg.attn_chunk, scale=scale,
                                 k_scale=k_scale, v_scale=v_scale)


def _require_kernel_form(q, v, scale, what: str) -> None:
    """The attention kernels take the default scale and v's head_dim equal
    to q's; MLA's absorbed forms are ported with MLA."""
    if scale is not None and scale != q.shape[-1] ** -0.5:
        raise NotImplementedError(
            f"{what} with a custom scale (MLA) is not ported yet")
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            f"{what} with a value head_dim other than q's (MLA) is not "
            "ported yet")


def _paged_sdpa(cfg, q, k, v, *, causal, q_offset, kv_valid_len, scale,
                decode, block_tables, k_scale=None, v_scale=None):
    _require_kernel_form(q, v, scale, "paged attention")
    scales = dict(k_scale_pool=k_scale, v_scale_pool=v_scale)
    if q.device.type == "cuda":
        if decode:
            return _flash_decode.flash_decode_paged(q, k, v, block_tables,
                                                    kv_valid_len, **scales)
        out, _ = _flash_attention.flash_attention_paged(
            q, k, v, q_offset, kv_valid_len, block_tables, causal=causal,
            **scales)
        return out
    _require_cpu(q, "paged sdpa")
    if decode:
        return _flash_decode.flash_decode_paged_plain(
            q, k, v, block_tables, kv_valid_len, chunk_size=cfg.attn_chunk,
            **scales)
    out, _ = _flash_attention.flash_attention_paged_plain(
        q, k, v, q_offset, kv_valid_len, block_tables, causal=causal,
        chunk_size=cfg.attn_chunk, **scales)
    return out


# Import-time: honor the softmax-form environment preference.
if os.environ.get("REPRO_SOFTMAX_FORM"):
    set_softmax_form(os.environ["REPRO_SOFTMAX_FORM"])
