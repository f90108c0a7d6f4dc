"""Kernel dispatch of the port: the entries model, serving and library code
call.

Port of ``src/repro/kernels/dispatch.py``: ``sdpa`` (line 816) with its
paged routes (``_paged_sdpa``, 696-731) and its contiguous routes (849-903),
int8 K/V included, ``softmax_topk`` (778),
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

Fresh attention (``kv_valid_len`` unset, ``q_offset`` one integer: 0, or
a sequence-parallel rank's first row; the training form) runs
``FlashAttention`` on CUDA, the forward kernel with its dq and dk/dv
backward kernels at that causal offset, as the reference's ``_attention_pallas`` ran
``ops._flash`` (``dispatch.py:540``); on the CPU it runs the chunked online
form, which autograd differentiates.  MLA's decompressed training form
(q and k 96 wide, v 64, at the default scale 96^-0.5) takes the same
kernels' (96, 64) instances on CUDA, where the reference's XLA path served
it (``models/layers.py:439``).  On CUDA a custom scale, and a value
head_dim other than q's on any other route or at a pair without an
instance, raise ``NotImplementedError``; on the CPU the chunked online form
serves them, as the reference's XLA path did.

``mla_attention`` is MLA's absorbed form over its latent cache (the
reference's ``mla_apply`` sent it through ``_sdpa`` with a custom scale
and Dv != Dqk, which its XLA fallbacks served, ``dispatch.py:573`` and
``:887``): on CUDA the decode and cached-prefill kernels of
``kernels/flash_mla.py``, on the CPU their plain versions.

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
counterpart; the kernels' own plans (the decode and softmax+top-k splits)
are recorded by their wrappers.

Under a ``distributed.context.ShardContext`` the one-token contiguous
decode goes to ``distributed.decode_attention.sharded_decode_attention``
(fp and int8 caches, as the reference's lines 849-857), whose local step is
``decode_attention_lse``: row 4's (or 4q's) lse form on CUDA, its plain
version on the CPU.  The paged routes raise there, with the reference's
words (708-712), and so does MLA's latent attention, which has no lse form.

Each op's path is recorded (``obs.kernels.record_path``, as the
reference's ``lookup`` did at line 113) under the kernel's launch-count
name: ``"cuda"`` by the kernel module where it counts a launch, so the
counts equal ``launch_counts``; ``"cpu"`` here, where a plain version
runs.
"""
from __future__ import annotations

import os

import torch

from repro_torch import core
from repro_torch.distributed import context as _context
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import flash_attention_bwd as _flash_attention_bwd
from repro_torch.kernels import flash_decode as _flash_decode
from repro_torch.kernels import flash_mla as _flash_mla
from repro_torch.kernels import online_softmax as _online_softmax
from repro_torch.kernels import softmax_topk as _softmax_topk
from repro_torch.obs import kernels as obs_kernels

_KERNEL_MODULES = {"softmax_topk": _softmax_topk,
                   "softmax_topk_router": _softmax_topk,
                   "flash_decode_paged": _flash_decode,
                   "flash_decode": _flash_decode,
                   "flash_attention_paged": _flash_attention,
                   "flash_attention_offset": _flash_attention,
                   "flash_attention": _flash_attention,
                   "flash_attention_bwd_dq": _flash_attention_bwd,
                   "flash_attention_bwd_dkv": _flash_attention_bwd,
                   "flash_attention_qoffset": _flash_attention,
                   "flash_attention_bwd_dq_qoffset": _flash_attention_bwd,
                   "flash_attention_bwd_dkv_qoffset": _flash_attention_bwd,
                   "flash_decode_paged_int8": _flash_decode,
                   "flash_decode_int8": _flash_decode,
                   "flash_attention_paged_int8": _flash_attention,
                   "flash_decode_lse": _flash_decode,
                   "flash_decode_int8_lse": _flash_decode,
                   "flash_decode_mla": _flash_mla,
                   "flash_attention_mla": _flash_mla,
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
    obs_kernels.record_path(_online_softmax.KERNEL_NAMES[form], "cpu")
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
    obs_kernels.record_path("online_normalizer", "cpu")
    return _online_softmax.online_normalizer_plain(x)


def softmax_topk(x, k: int, differentiable: bool = False,
                 counter: str = "softmax_topk") -> "core.SoftmaxTopK":
    """Fused softmax+top-k (paper Algorithm 4) over the last axis.

    A requires-grad input under grad mode, or ``differentiable``, routes
    through ``ops.softmax_topk``, whose backward recomputes the softmax
    from the saved log-sum-exp (the reference is differentiable on every
    path and ignores the flag); otherwise the kernel runs bare (the serving
    path's logits need no gradient).  Both routes launch the kernel once,
    counted under ``counter`` (``"softmax_topk_router"`` for the MoE
    router, so its launches are read apart from the sampler's)."""
    if differentiable or _wants_grad(x):  # its forward comes back here
        from repro_torch.kernels import ops
        return ops.softmax_topk(x, k, counter=counter)
    if x.device.type == "cuda":
        return _softmax_topk.softmax_topk(x, k, counter)
    _require_cpu(x, "softmax_topk")
    obs_kernels.record_path(counter, "cpu")
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
    ctx = _context.get()
    if decode and ctx is not None:
        from repro_torch.distributed.decode_attention import \
            sharded_decode_attention
        return sharded_decode_attention(
            q, k, v, kv_valid_len, mesh=ctx.mesh,
            seq_axes=ctx.cache_seq_axes, batch_axes=ctx.batch_axes,
            chunk_size=cfg.attn_chunk,
            scale=scale if scale is not None else q.shape[-1] ** -0.5,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type == "cuda":
        fresh = not decode and k_scale is None and kv_valid_len is None
        _require_kernel_form(q, v, scale, "contiguous attention",
                             pairs=_flash_attention.HEAD_DIMS[
                                 "flash_attention"] if fresh else ())
        if decode:
            return _flash_decode.flash_decode(q, k, v, kv_valid_len,
                                              k_scale=k_scale, v_scale=v_scale)
        if k_scale is not None:
            raise NotImplementedError(
                "contiguous int8 attention wider than one token has no "
                "kernel: the int8 prefill attends over its exact K/V")
        if kv_valid_len is None:
            if not isinstance(q_offset, int):
                raise NotImplementedError(
                    "fresh attention on CUDA takes one integer q_offset "
                    "(per-row offsets need kv_valid_len: the cached-prefill "
                    "kernel)")
            return _flash_attention.FlashAttention.apply(q, k, v, causal,
                                                         q_offset)
        out, _ = _flash_attention.flash_attention_offset(
            q, k, v, q_offset, kv_valid_len, causal=causal)
        return out
    _require_cpu(q, "sdpa")
    obs_kernels.record_path(_contiguous_op(decode, k_scale, kv_valid_len),
                            "cpu")
    # the chunked online form: the plain version of both contiguous kernels
    # (flash_decode_plain, flash_attention_offset_plain) and of the fresh
    # forward (flash_attention_fwd_plain), differentiated by autograd
    return core.online_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 kv_valid_len=kv_valid_len,
                                 chunk_size=cfg.attn_chunk, scale=scale,
                                 k_scale=k_scale, v_scale=v_scale)


def decode_attention_lse(q, k, v, kv_valid_len, *, chunk_size: int,
                         scale: float, k_scale=None, v_scale=None):
    """One-token attention of q [B, 1, Hq, D] over contiguous caches
    [B, S, Hkv, D] (int8 with ``k_scale``/``v_scale`` [B, S, Hkv]) up to
    ``kv_valid_len`` [B], with its log-sum-exp: (out [B, 1, Hq, D], lse
    [B, Hq] fp32, −inf for a row with no valid key).  A sequence shard's
    local step.  On CUDA the lse form of row 4 (or 4q) launches, at the
    default scale only; on the CPU its plain version runs."""
    if q.device.type == "cuda":
        _require_kernel_form(q, v, scale, "sharded decode attention")
        return _flash_decode.flash_decode(q, k, v, kv_valid_len,
                                          k_scale=k_scale, v_scale=v_scale,
                                          return_lse=True)
    _require_cpu(q, "decode_attention_lse")
    obs_kernels.record_path("flash_decode_int8_lse" if k_scale is not None
                            else "flash_decode_lse", "cpu")
    out, lse = core.attention.online_attention_lse(
        q, k, v, causal=False, kv_valid_len=kv_valid_len,
        chunk_size=chunk_size, scale=scale, k_scale=k_scale, v_scale=v_scale)
    return out, lse.reshape(q.shape[0], q.shape[2]).float()


def mla_attention(cfg, q_eff, q_rope, c_cache, r_cache, *, causal, q_offset,
                  kv_valid_len, scale, decode: bool):
    """MLA's absorbed attention over one layer's latent cache: q_eff
    [B, T, H, R] and q_rope [B, T, H, Dr] score ``scale·(q_eff·c + q_rope·r)``
    against c_cache [B, S, R] and r_cache [B, S, Dr] and return
    ``softmax·c`` [B, T, H, R].  ``decode`` (T == 1) takes the one-token
    kernel, otherwise the cached prefill (``causal`` in absolute
    coordinates from ``q_offset``); keys at or past ``kv_valid_len`` [B]
    are never read.  On CUDA the kernel launches or raises on a shape or
    dtype it does not take; on the CPU the plain version runs.  Under a
    ``ShardContext`` the decode raises: the latent kernels have no lse form
    to merge across sequence shards yet."""
    if decode and _context.get() is not None:
        raise NotImplementedError(
            "MLA's latent decode has no sharded ⊕-merge form yet (no lse "
            "output); drop the ShardContext")
    if q_eff.device.type == "cuda":
        if decode:
            return _flash_mla.flash_decode_mla(q_eff, q_rope, c_cache,
                                               r_cache, kv_valid_len,
                                               scale=scale)
        return _flash_mla.flash_attention_mla(
            q_eff, q_rope, c_cache, r_cache, q_offset, kv_valid_len,
            scale=scale, causal=causal)
    _require_cpu(q_eff, "mla_attention")
    obs_kernels.record_path("flash_decode_mla" if decode
                            else "flash_attention_mla", "cpu")
    return _flash_mla.mla_plain(q_eff, q_rope, c_cache, r_cache,
                                q_offset=q_offset, kv_valid_len=kv_valid_len,
                                scale=scale, causal=causal,
                                chunk_size=cfg.attn_chunk)


def _contiguous_op(decode: bool, k_scale, kv_valid_len) -> str:
    """The kernel whose plain version a contiguous attention call runs."""
    if decode:
        return "flash_decode_int8" if k_scale is not None else "flash_decode"
    return ("flash_attention" if kv_valid_len is None
            else "flash_attention_offset")


def _require_kernel_form(q, v, scale, what: str, pairs=()) -> None:
    """The attention kernels take the default scale, and v's head_dim
    equal to q's or, where the route has an instance for it (``pairs``: the
    fresh route's (Dqk, Dv), whose (96, 64) is MLA's decompressed training
    form at its default scale 96^-0.5), another.  MLA's absorbed serving
    forms have kernels of their own (``mla_attention``)."""
    if scale is not None and scale != q.shape[-1] ** -0.5:
        raise NotImplementedError(
            f"{what} with a custom scale is not ported (MLA's absorbed "
            "form runs through mla_attention)")
    dims = (q.shape[-1], v.shape[-1])
    if dims[1] != dims[0] and dims not in pairs:
        raise NotImplementedError(
            f"{what} with (Dqk, Dv) = {dims} has no kernel (value head "
            f"dims other than q's: {[p for p in pairs if p[0] != p[1]]})")


def _paged_sdpa(cfg, q, k, v, *, causal, q_offset, kv_valid_len, scale,
                decode, block_tables, k_scale=None, v_scale=None):
    """Paged serving is single-host: an ambient ShardContext is a routing
    bug, not a fallback case (the reference's words)."""
    if _context.get() is not None:
        raise NotImplementedError(
            "paged KV attention has no sharded ⊕-merge form yet; drop the "
            "ShardContext or serve unpaged")
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
    obs_kernels.record_path(
        ("flash_decode_paged" if decode else "flash_attention_paged")
        + ("_int8" if k_scale is not None else ""), "cpu")
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
