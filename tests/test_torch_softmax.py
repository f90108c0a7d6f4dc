"""The port's online-softmax library surface against the JAX package, on the
CPU: the rest of ``core.online_softmax``, ``core.softmax_forms``,
``safe_softmax_then_topk``, the plain versions of the online-softmax kernels
against the Pallas kernels (interpret mode, explicit blocks, so no autotune
sweep runs), the routing of ``kernels.dispatch`` with its form preference,
and the gradients of the library entry points (``ops.softmax_topk``,
the unflagged ``dispatch.softmax_topk``, ``ops.OnlineSoftmax`` and the
plain normalizer).

Inputs are built with numpy from a seed and handed to both packages.  The
CUDA kernels run only on the card (``tests/test_torch_cuda.py``, marked
``cuda``, and ``python3 chip_smoke.py``).
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro.core import softmax_forms as ref_sf  # noqa: E402
from repro.kernels import dispatch as ref_dispatch  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.online_softmax import (  # noqa: E402
    online_normalizer_pallas, online_softmax_pallas)
from repro_torch import core  # noqa: E402
from repro_torch.core import softmax_forms as sf  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels import online_softmax as osk  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# float32 on both sides, the same algorithm with sums in another order
F32 = dict(rtol=1e-6, atol=1e-6)
# the bf16 forms: d is rounded to bf16 after every leaf on both sides; the
# fp32 leaf sums differ in their last bits, which can move one rounding of
# d by one bf16 ulp (2^-7 relative), so y by up to 2^-7 of itself
BF16_FORM = dict(rtol=2.0 ** -7, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _seed(*parts):
    return zlib.crc32("|".join(str(p) for p in parts).encode())


def _x(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# core.online_softmax: the functions the earlier slices left out
# ---------------------------------------------------------------------------
def test_identity_like_matches_reference():
    m, d = core.identity_like((2, 3))
    rm, rd = ref_core.identity_like((2, 3))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))


@pytest.mark.parametrize("shape", [(3, 50), (2, 2, 17), (1, 1)])
def test_online_normalizer_scan_matches_reference(shape):
    x = _x(_seed("scan", shape), shape)
    m, d = core.online_normalizer_scan(_t(x))
    rm, rd = ref_core.online_normalizer_scan(jnp.asarray(x))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **F32)


@pytest.mark.parametrize("block", [8, 32, 50, 128, 300])
def test_online_normalizer_blocked_matches_reference(block):
    x = _x(_seed("blocked", block), (4, 300))
    x[1, :64] = -np.inf                     # a dead leading stretch
    m, d = core.online_normalizer_blocked(_t(x), block=block)
    rm, rd = ref_core.online_normalizer_blocked(jnp.asarray(x), block=block)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **F32)
    # every tree shape gives the one-shot statistics
    m1, d1 = core.online_normalizer(_t(x))
    np.testing.assert_array_equal(m.numpy(), m1.numpy())
    np.testing.assert_allclose(d.numpy(), d1.numpy(), **F32)


def _where_case():
    x = _x(_seed("where"), (4, 37))
    where = np.random.default_rng(1).random((4, 37)) > 0.3
    where[2] = False                        # a fully masked row
    return x, where


@pytest.mark.parametrize("masked", [False, True])
def test_online_softmax_and_logsumexp_match_reference(masked):
    x, where = _where_case()
    kw = dict(where=_t(where)) if masked else {}
    rkw = dict(where=jnp.asarray(where)) if masked else {}
    y = core.online_softmax(_t(x), **kw)
    ry = ref_core.online_softmax(jnp.asarray(x), **rkw)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32)
    lse = core.online_logsumexp(_t(x), **kw)
    rlse = ref_core.online_logsumexp(jnp.asarray(x), **rkw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), **F32)
    if masked:          # d = 0 gives a softmax of 0, not NaN
        assert torch.equal(y[2], torch.zeros(37))
        assert torch.isneginf(lse[2])
        assert (y.numpy()[~where] == 0).all()


@pytest.mark.parametrize("fn", ["online_log_softmax", "naive_softmax",
                                "safe_softmax"])
def test_softmax_family_matches_reference(fn):
    x = _x(_seed(fn), (5, 64))
    got = getattr(core, fn)(_t(x))
    want = getattr(ref_core, fn)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_accesses_per_element_match_reference():
    assert core.ACCESSES_PER_ELEMENT == ref_core.ACCESSES_PER_ELEMENT
    assert core.ACCESSES_PER_ELEMENT["online_softmax"] == 3
    assert core.ACCESSES_PER_ELEMENT["safe_softmax"] == 4


def test_safe_softmax_then_topk_matches_reference():
    x = _x(_seed("unfused"), (6, 200))
    x[0, [9, 150, 40]] = x[0].max() + 1.0            # exact ties
    got = core.safe_softmax_then_topk(_t(x), 5)
    want = ref_core.safe_softmax_then_topk(jnp.asarray(x), 5)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **F32)
    np.testing.assert_allclose(got.logsumexp.numpy(),
                               np.asarray(want.logsumexp), **F32)
    fused = core.softmax_topk(_t(x), 5)              # Algorithm 4 agrees
    assert torch.equal(fused.indices, got.indices)
    torch.testing.assert_close(fused.values, got.values, **F32)


# ---------------------------------------------------------------------------
# core.softmax_forms: the port's copy against the reference's
# ---------------------------------------------------------------------------
def _gaussian(rng):
    return rng.normal(scale=4.0, size=(6, 300)).astype(np.float32)


def _wide_range(rng):
    return rng.normal(scale=20.0, size=(4, 257)).astype(np.float32)


def _shifted(rng):
    return (rng.normal(size=(3, 128)) + 1.0e4).astype(np.float32)


def _constant_rows(rng):
    return np.full((5, 200), 3.25, np.float32)


def _masked(rng):
    x = rng.normal(scale=3.0, size=(4, 192)).astype(np.float32)
    x[:, 150:] = -np.inf
    x[1, :140] = -np.inf                 # a dead leading leaf, then live
    return x


def _long_rows(rng):
    return rng.normal(scale=2.0, size=(2, 4096)).astype(np.float32)


_INPUTS = [_gaussian, _wide_range, _shifted, _constant_rows, _masked,
           _long_rows]


@pytest.mark.parametrize("form", sorted(sf.FORMS))
@pytest.mark.parametrize("maker", _INPUTS, ids=lambda f: f.__name__[1:])
def test_form_matches_reference_and_its_bound(form, maker):
    """The port's form equals the reference's form (F32, or BF16_FORM for
    the bf16 accumulator), lies within the port's bound of the port's
    fp32 reference, and the port's bound equals the reference's on the
    same input (or both refuse it as vacuous)."""
    x = maker(np.random.default_rng(_seed(form, maker.__name__)))
    got = sf.FORMS[form].apply(_t(x)).numpy()
    want = np.asarray(ref_sf.FORMS[form].apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, want,
                               **(BF16_FORM if form == "bf16" else F32))
    try:
        bound = sf.FORMS[form].error_bound(x)
    except ValueError:
        assert form == "bf16" and x.shape[-1] >= 2048
        with pytest.raises(ValueError, match="vacuous"):
            ref_sf.FORMS[form].error_bound(x)
        return
    assert bound == ref_sf.FORMS[form].error_bound(x)
    assert bound < 1.0
    ref = sf.reference(_t(x)).numpy()
    assert np.abs(got - ref).max() <= bound


def test_int8_roundtrip_bound_matches_reference():
    scale = np.array([0.0, 1e-9, 0.5, 3.0], np.float32)
    np.testing.assert_array_equal(sf.int8_roundtrip_bound(scale),
                                  ref_sf.int8_roundtrip_bound(scale))


@pytest.mark.parametrize("v", [1000, 2048, 10000, 49152, 100000])
def test_bf16_kernel_bound_is_non_vacuous(v):
    """The bf16 kernel's merge-tree bound, for the design ``plan`` picks
    for fp32 and for bf16 rows of V, prices every V of the paper and of
    smollm-360m's vocabulary; where the reference's sequential-scan bound
    prices V too, the kernel's tree needs fewer roundings."""
    for dtype in (torch.float32, torch.bfloat16):
        bound = osk.bf16_kernel_error_bound(v, dtype)
        assert 0 < bound < 0.25
        if v <= 2048:
            assert bound <= sf.bf16_error_bound(np.zeros((1, v)))


# ---------------------------------------------------------------------------
# Plain versions of the online-softmax kernels against the Pallas kernels
# (interpret mode), on finite rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r_blk,v_blk", [(4, 128), (8, 256), (2, 512)])
def test_plain_softmax_matches_pallas(r_blk, v_blk):
    x = _x(_seed("pallas", r_blk, v_blk), (8, 512), scale=4.0)
    want = online_softmax_pallas(jnp.asarray(x), r_blk=r_blk, v_blk=v_blk,
                                 interpret=True)
    got = osk.online_softmax_plain(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("r_blk,v_blk", [(4, 128), (8, 512)])
def test_plain_normalizer_matches_pallas(r_blk, v_blk):
    x = _x(_seed("pallas_md", r_blk, v_blk), (8, 512), scale=4.0)
    rm, rd = online_normalizer_pallas(jnp.asarray(x), r_blk=r_blk,
                                      v_blk=v_blk, interpret=True)
    m, d = osk.online_normalizer_plain(_t(x))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **F32)


def _dead_leading_tile():
    """Row 0 all -inf; row 1's first V-tile (128) -inf, the rest finite."""
    x = _x(_seed("dead"), (8, 512), scale=2.0)
    x[0] = -np.inf
    x[1, :128] = -np.inf
    return x


def test_plain_follows_xla_form_on_dead_leading_tiles():
    """Where a row's first tile is all -inf the port follows the
    reference's XLA form (``core.online_normalizer``): m equal, (-inf, 0)
    and y = 0 on the dead row, d and y within F32 elsewhere."""
    x = _dead_leading_tile()
    m, d = osk.online_normalizer_plain(_t(x))
    rm, rd = ref_core.online_normalizer(jnp.asarray(x))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), **F32)
    assert (m[0].item(), d[0].item()) == (float("-inf"), 0.0)
    assert float(rd[0]) == 0.0
    assert np.isfinite(d[1].item()) and d[1].item() > 0
    y = osk.online_softmax_plain(_t(x))
    ry = np.asarray(ref_core.online_softmax(jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), ry, **F32)
    assert (ry[0] == 0).all()
    assert torch.equal(y[0], torch.zeros(512))
    assert torch.equal(y[1, :128], torch.zeros(128))
    torch.testing.assert_close(y[1].sum(), torch.tensor(1.0))


def test_reference_pallas_kernel_gives_nan_on_dead_leading_tiles():
    """A known behaviour of the reference that the port does not copy: its
    normalizer kernel takes ``exp(x - m_new)`` with ``m_new = -inf`` on a
    tile that is all -inf, and the NaN persists."""
    x = _dead_leading_tile()
    _, rd = online_normalizer_pallas(jnp.asarray(x), r_blk=8, v_blk=128,
                                     interpret=True)
    rd = np.asarray(rd)
    assert np.isnan(rd[0]) and np.isnan(rd[1])
    assert np.isfinite(rd[2:]).all()


# ---------------------------------------------------------------------------
# kernels.dispatch / kernels.ops routing on the CPU
# ---------------------------------------------------------------------------
_NEW_KERNELS = ("online_softmax", "online_softmax_bf16",
                "online_softmax_exp2", "online_normalizer")


@pytest.mark.parametrize("form", dispatch.SOFTMAX_FORMS)
def test_dispatch_runs_each_forms_plain_version_on_cpu(form):
    dispatch.reset_launch_counts()
    x = _t(_x(_seed("route", form), (2, 3, 300)))
    prev = dispatch.set_softmax_form(form)
    try:
        got = dispatch.online_softmax(x)
    finally:
        dispatch.set_softmax_form(prev)
    want = (core.online_softmax(x) if form == "exact"
            else sf.FORMS[form].apply(x))
    assert got.shape == x.shape and torch.equal(got, want)
    assert torch.equal(dispatch.online_softmax(x, form=form), want)
    m, d = ops.online_normalizer(x)
    rm, rd = core.online_normalizer(x)
    assert torch.equal(m, rm) and torch.equal(d, rd)
    assert torch.equal(ops.online_softmax(x), core.online_softmax(x))
    assert set(dispatch.launch_counts().values()) == {0}


def test_dispatch_form_preference_rejects_unknown_forms():
    with pytest.raises(ValueError, match="exp2"):
        dispatch.set_softmax_form("fp8")
    with pytest.raises(ValueError, match="fp8"):
        dispatch.online_softmax(torch.zeros(2, 4), form="fp8")
    assert dispatch.softmax_form() == "exact"
    assert dispatch.SOFTMAX_FORMS == ("exact", "bf16", "exp2")


@pytest.mark.parametrize("form", ["bf16", "exp2"])
def test_env_var_selects_form_at_import(form):
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.kernels.dispatch as d; "
            "print(d.softmax_form())")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env={**os.environ, "REPRO_SOFTMAX_FORM": form,
                          "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == form


@pytest.mark.parametrize("call", [
    lambda x: dispatch.online_softmax(x),
    lambda x: dispatch.online_normalizer(x)], ids=["softmax", "normalizer"])
def test_dispatch_raises_on_other_devices(call):
    with pytest.raises(NotImplementedError, match="device meta"):
        call(torch.empty(2, 8, device="meta"))


@pytest.mark.parametrize("call", [
    lambda: osk.online_softmax(torch.zeros(2, 8)),
    lambda: osk.online_softmax(torch.zeros(2, 8), "bf16"),
    lambda: osk.online_normalizer(torch.zeros(2, 8))],
    ids=["softmax", "softmax_bf16", "normalizer"])
def test_online_softmax_wrappers_refuse_cpu_tensors(call):
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert dispatch.launch_counts() == before
    assert all(before[k] == 0 for k in _NEW_KERNELS)


# ---------------------------------------------------------------------------
# ops.softmax_topk: the gradient against the reference's custom VJP
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,k", [((6, 64), 5), ((2, 3, 96), 3)])
def test_softmax_topk_grad_matches_reference_vjp(shape, k):
    """``ops.softmax_topk``'s autograd backward against ``jax.grad``
    through the reference's ``_softmax_topk2d`` custom VJP (the Pallas
    forward in interpret mode, explicit blocks).  float32, rtol 1e-4 /
    atol 1e-6, the reference's own kernel-vs-XLA gradient tolerance."""
    x = _x(_seed("grad", shape, k), shape, scale=4.0)
    x.reshape(-1, shape[-1])[0, [3, 17]] = x.max() + 1.0       # a tie

    def f_ref(xj):
        vals, _, lse = ref_ops.softmax_topk(xj, k, r_blk=2, v_blk=32)
        return (vals ** 2).sum() + 0.1 * (lse ** 2).sum()

    want = np.asarray(jax.grad(f_ref)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    out = ops.softmax_topk(xt, k)
    ((out.values ** 2).sum() + 0.1 * (out.logsumexp ** 2).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4, atol=1e-6)
    vals, idx, _ = ref_ops.softmax_topk(jnp.asarray(x), k, r_blk=2, v_blk=32)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(idx))
    np.testing.assert_allclose(out.values.detach().numpy(), np.asarray(vals),
                               **F32)


def test_dispatch_softmax_topk_differentiable_keyword():
    x = _t(_x(_seed("diff"), (3, 40))).requires_grad_(True)
    out = dispatch.softmax_topk(x, 4, differentiable=True)
    out.values.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    plain = dispatch.softmax_topk(x.detach(), 4)
    assert torch.equal(out.indices, plain.indices)


# ---------------------------------------------------------------------------
# every entry point keeps its gradient: the unflagged dispatch.softmax_topk,
# ops.OnlineSoftmax and the normalizer against jax.grad through the reference
# ---------------------------------------------------------------------------
def _entry_loss(entry, xt, w):
    """(the torch output, its scalar loss, the same loss of the reference's
    entry point as a function of a JAX array); w weighs the outputs, so no
    gradient vanishes by the softmax's own sum."""
    k = 4
    if entry == "softmax_topk":
        out = dispatch.softmax_topk(xt, k)            # no differentiable=
        loss = ((out.values * _t(w[..., :k])).sum()
                + 0.1 * (out.logsumexp ** 2).sum())

        def ref(xj):
            o = ref_dispatch.softmax_topk(xj, k)
            return ((o.values * w[..., :k]).sum()
                    + 0.1 * (o.logsumexp ** 2).sum())
        return out.values, loss, ref
    if entry == "online_softmax":
        out = ops.OnlineSoftmax.apply(xt, "exact")
        return out, (out * _t(w)).sum(), \
            lambda xj: (ref_core.online_softmax(xj) * w).sum()
    m, d = dispatch.online_normalizer(xt)
    wm, wd = w[..., 0], w[..., 1]
    return d, (m * _t(wm)).sum() + (d * _t(wd)).sum(), \
        lambda xj: sum((a * b).sum() for a, b in zip(
            ref_core.online_normalizer(xj), (wm, wd)))


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 40)])
@pytest.mark.parametrize("entry", ["softmax_topk", "online_softmax",
                                   "online_normalizer"])
def test_entry_point_gradient_matches_reference(entry, shape):
    """The unflagged ``dispatch.softmax_topk`` on a requires-grad input
    routes through ``ops.softmax_topk`` and carries a graph, as the
    reference's ``dispatch.softmax_topk`` does on every path;
    ``ops.OnlineSoftmax`` (CPU tensors: the plain forward) has the exact
    form's backward; the normalizer's plain version is differentiated by
    autograd (on CUDA it raises for such an input: a ``cuda``-marked test).
    Each gradient against ``jax.grad`` through the reference, float32,
    rtol 1e-4 / atol 1e-6 as ``ops.softmax_topk``'s gradient test."""
    x = _x(_seed("entry grad", entry, shape), shape, scale=4.0)
    w = np.random.default_rng(_seed("w", entry, shape)).standard_normal(
        shape).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    out, loss, ref = _entry_loss(entry, xt, w)
    assert out.grad_fn is not None
    loss.backward()
    want = np.asarray(jax.grad(ref)(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4, atol=1e-6)
