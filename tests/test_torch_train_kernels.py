"""The training slice's kernel modules against the JAX package, on the CPU.

* ``flash_attention_fwd_plain`` (out and lse) against
  ``flash_attention_pallas`` in interpret mode, and
  ``flash_attention_bwd_plain`` against ``flash_attention_bwd_pallas`` plus
  the reference wrapper's GQA sum, at the shapes of
  ``tests/kernels/test_flash_bwd.py`` (MHA, GQA, MQA with T = 96), causal
  and not;
* ``FlashAttention`` on the CPU against ``jax.grad`` of
  ``ops.flash_attention``, and against finite differences in float64
  (``torch.autograd.gradcheck``);
* the chunked cross-entropy's value and gradients (dh, dW) against the
  reference's custom VJP, with and without z-loss, at logits of order 1 and
  of order 1e4.

Tolerances: float32 on both sides; the packages compute the same math with
other matmul kernels and summation orders.  Forward and dq/dk/dv within
rtol 1e-5 / atol 1e-5 (2e-5 absolute for gradients, which sum over T keys);
the CE loss within rtol 1e-6 and its gradients within rtol 1e-5 / atol 1e-6
at order-1 logits; at 1e4 the logits themselves round at ~1e-3 in fp32, so
there the loss compares within rtol 1e-6 of its own size and gradients
within atol 2e-5.  The CUDA kernels are held against these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cross_entropy as RCE  # noqa: E402
from repro.kernels import ops as RO  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention_bwd import (  # noqa: E402
    flash_attention_bwd_pallas)
from repro_torch.core import cross_entropy as CE  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=2e-5)
# (B, T, Hq, Hkv, D, bq, bk) of tests/kernels/test_flash_bwd.py:15-19
SHAPES = [(2, 64, 4, 4, 32, 16, 16),     # MHA
          (1, 64, 8, 2, 32, 32, 16),     # GQA
          (2, 96, 4, 1, 16, 32, 32)]     # MQA, T not a power of two
SHAPE_IDS = ["mha", "gqa", "mqa"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, b, t, hq, hkv, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, t, hq, d), f(b, t, hkv, d), f(b, t, hkv, d), f(b, t, hq, d)


def _heads_first(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,t,hq,hkv,d,bq,bk", SHAPES, ids=SHAPE_IDS)
def test_plain_fwd_matches_pallas(b, t, hq, hkv, d, bq, bk, causal):
    q, k, v, _ = _qkv(0, b, t, hq, hkv, d)
    ref_out, ref_lse = flash_attention_pallas(
        _heads_first(q), _heads_first(k), _heads_first(v), causal=causal,
        bq=bq, bk=bk, interpret=True)
    out, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v),
                                            causal=causal, chunk_size=bk)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    assert lse.shape == (b, hq, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,t,hq,hkv,d,bq,bk", SHAPES, ids=SHAPE_IDS)
def test_plain_bwd_matches_pallas(b, t, hq, hkv, d, bq, bk, causal):
    """dq, and dk/dv already reduced to the KV heads, against the Pallas
    backward's per-query-head dk/dv summed over each group (``ops.py``'s
    wrapper), from the same saved out and lse."""
    q, k, v, dout = _qkv(1, b, t, hq, hkv, d)
    out, lse = flash_attention_pallas(_heads_first(q), _heads_first(k),
                                      _heads_first(v), causal=causal, bq=bq,
                                      bk=bk, interpret=True)
    dq, dk_h, dv_h = flash_attention_bwd_pallas(
        _heads_first(q), _heads_first(k), _heads_first(v), out, lse,
        _heads_first(dout), causal=causal, bq=bq, bk=bk, interpret=True)
    g = hq // hkv
    ref_dk = np.asarray(dk_h).reshape(b, hkv, g, t, d).sum(2)
    ref_dv = np.asarray(dv_h).reshape(b, hkv, g, t, d).sum(2)
    got = fab.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), _t(np.asarray(out).transpose(0, 2, 1, 3)),
        _t(np.asarray(lse)[..., 0]), _t(dout), causal=causal)
    for name, a, want in (("dq", got[0], np.asarray(dq)), ("dk", got[1],
                                                           ref_dk),
                          ("dv", got[2], ref_dv)):
        np.testing.assert_allclose(a.numpy(), want.transpose(0, 2, 1, 3),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("b,t,hq,hkv,d,bq,bk", SHAPES[1:], ids=SHAPE_IDS[1:])
def test_flash_attention_function_matches_jax_grad(b, t, hq, hkv, d, bq, bk):
    """``FlashAttention.apply`` on CPU tensors (plain forward and backward)
    against ``jax.grad`` of the reference's ``ops.flash_attention`` (Pallas
    in interpret mode, its custom VJP) of sum(out · w)."""
    q, k, v, w = _qkv(2, b, t, hq, hkv, d)

    def f_ref(q_, k_, v_):
        out = RO.flash_attention(q_, k_, v_, causal=True, bq=bq, bk=bk)
        return (out * w).sum(), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        f_ref, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(q),
                                                jnp.asarray(k),
                                                jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_(True) for x in (q, k, v))
    dispatch.reset_launch_counts()
    out = fa.FlashAttention.apply(qt, kt, vt, True)
    (out * _t(w)).sum().backward()
    assert set(dispatch.launch_counts().values()) == {0}   # plain on CPU
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad),
                               ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_function_gradcheck(causal):
    """Finite differences in float64 on a tiny GQA case: the backward's
    formulas are the forward's derivative."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(1, 5, 4, 3, generator=gen, dtype=torch.float64)
    k = torch.randn(1, 5, 2, 3, generator=gen, dtype=torch.float64)
    v = torch.randn(1, 5, 2, 3, generator=gen, dtype=torch.float64)
    args = tuple(x.requires_grad_(True) for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: fa.FlashAttention.apply(a, b_, c, causal), args,
        eps=1e-6, atol=1e-7, rtol=1e-5)


def test_fresh_sdpa_on_cpu_is_differentiable():
    """``dispatch.sdpa``'s fresh route on the CPU (the chunked online form,
    through autograd) gives FlashAttention's gradients."""
    from repro_torch import configs
    cfg = configs.get_smoke("smollm_360m")
    q, k, v, w = _qkv(4, 2, 40, 6, 2, 8)
    grads = []
    for fn in (lambda a, b_, c: dispatch.sdpa(cfg, a, b_, c, causal=True,
                                              q_offset=0, kv_valid_len=None),
               lambda a, b_, c: fa.FlashAttention.apply(a, b_, c, True)):
        args = [_t(x).requires_grad_(True) for x in (q, k, v)]
        (fn(*args) * _t(w)).sum().backward()
        grads.append([a.grad for a in args])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, **GRAD_TOL)


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("z_loss", [0.0, 1e-4], ids=["plain", "z_loss"])
@pytest.mark.parametrize("scale", [1.0, 1e4], ids=["logits_1", "logits_1e4"])
def test_chunked_ce_matches_reference(z_loss, scale):
    """Value and gradients (dh, dW) of sum(loss · c) against the reference's
    custom VJP; 1e4-sized logits exercise the ⊕ fold's max shift."""
    rng = np.random.default_rng(5)
    t, d, v, chunks = 24, 16, 64, 4
    h = (rng.standard_normal((t, d)) * np.sqrt(scale)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * np.sqrt(scale / d)).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    coef = rng.standard_normal(t).astype(np.float32)

    def f_ref(h_, w_):
        loss = RCE.chunked_cross_entropy(h_, w_, jnp.asarray(labels),
                                         num_chunks=chunks, z_loss=z_loss)
        return (loss * coef).sum(), loss

    (_, ref_loss), (ref_dh, ref_dw) = jax.value_and_grad(
        f_ref, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    ht, wt = _t(h).requires_grad_(True), _t(w).requires_grad_(True)
    loss = CE.chunked_cross_entropy(ht, wt, _t(labels), num_chunks=chunks,
                                    z_loss=z_loss)
    (loss * _t(coef)).sum().backward()
    ref_loss = np.asarray(ref_loss)
    atol = 1e-6 * max(1.0, float(np.abs(ref_loss).max()))
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, rtol=1e-6,
                               atol=atol)
    g_tol = dict(rtol=1e-5, atol=1e-6 if scale == 1.0 else 2e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(ref_dh),
                               err_msg="dh", **g_tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_dw),
                               err_msg="dW", **g_tol)
    # the baseline that materializes the logits gives the same loss
    full = CE.full_cross_entropy(_t(h), _t(w), _t(labels), z_loss=z_loss)
    ref_full = RCE.full_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                      jnp.asarray(labels), z_loss=z_loss)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full), rtol=1e-6,
                               atol=atol)
