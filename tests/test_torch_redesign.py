"""The redesigned online-softmax and cached-prefill kernels' CPU-side parts:
their wrappers' pure planners and their plain versions against the JAX
package.

* The plain entry points (``dispatch.online_softmax``,
  ``dispatch.online_normalizer``, ``dispatch.softmax_topk``) over 70000 rows,
  more than a CUDA grid's y axis holds, against the reference's ``ops``
  (Pallas in interpret mode, explicit blocks) on the same numpy inputs.
* ``online_softmax.plan``: the design each (V, dtype) takes, its threads,
  shared memory and scratch, and no row count anywhere in it.
* ``bf16_kernel_error_bound`` from the plan's merge tree: non-vacuous at
  every V the card checks, and never falling as V grows.
* The contiguous cached prefill's plain version at the shapes the card's
  tensor-core form is now held at (Tq 65 and 130, offsets off a 64-row
  tile, a single-shot prefill) against the Pallas kernel.

The kernels themselves run on the card: ``tests/test_torch_cuda.py`` (marked
``cuda``) and ``python3 chip_smoke.py``.
"""
import inspect
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_offset_pallas)
from repro_torch.core import softmax_forms as sf  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import online_softmax as osk  # noqa: E402

# float32 on both sides, the same algorithm with sums in another order
F32 = dict(rtol=1e-6, atol=1e-6)
ROWS, V = 70000, 8           # more rows than grid.y's 65535
# every V of chip_smoke.py's phase 9, by dtype
CARD_V = {torch.float32: (1000, 1001, 4097, 10000, 49152, 57344, 57345,
                          100000),
          torch.bfloat16: (1001, 49152)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rows(seed):
    return (np.random.default_rng(seed).standard_normal((ROWS, V))
            * 4.0).astype(np.float32)


@pytest.mark.parametrize("entry", ["online_softmax", "online_normalizer",
                                   "softmax_topk"])
def test_plain_entry_points_take_70000_rows(entry):
    """Each plain entry point over 70000 rows equals the reference's
    ``ops`` function on the same input (blocks of 250 rows, one V-tile)."""
    x = _rows(len(entry))
    blocks = dict(r_blk=250, v_blk=V)
    if entry == "online_softmax":
        got = dispatch.online_softmax(_t(x), form="exact")
        want = ref_ops.online_softmax(jnp.asarray(x), **blocks)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    elif entry == "online_normalizer":
        m, d = dispatch.online_normalizer(_t(x))
        rm, rd = ref_ops.online_normalizer(jnp.asarray(x), **blocks)
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        np.testing.assert_allclose(d.numpy(), np.asarray(rd), **F32)
    else:
        got = dispatch.softmax_topk(_t(x), 3)
        vals, idx, lse = ref_ops.softmax_topk(jnp.asarray(x), 3, **blocks)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(idx))
        np.testing.assert_allclose(got.values.numpy(), np.asarray(vals),
                                   **F32)
        np.testing.assert_allclose(got.logsumexp.numpy(), np.asarray(lse),
                                   **F32)
    assert (got if entry == "online_softmax" else m if
            entry == "online_normalizer" else got.values).shape[0] == ROWS


@pytest.mark.parametrize("v,dtype,design", [
    (1, torch.float32, "warp"), (1000, torch.float32, "warp"),
    (2048, torch.float32, "warp"), (2049, torch.float32, "block"),
    (4096, torch.bfloat16, "warp"), (4097, torch.bfloat16, "block"),
    (57344, torch.float32, "block"), (57345, torch.float32, "stream"),
    (114688, torch.bfloat16, "block"), (114689, torch.bfloat16, "stream"),
    (100000, torch.float32, "stream")])
def test_plan_picks_design_by_row_bytes(v, dtype, design):
    """One warp a row up to 8 KB, one CTA a row up to
    ``RESIDENT_ROW_BYTES``, streaming beyond; the same byte limits for both
    dtypes."""
    p = osk.plan(v, dtype)
    assert p.design == design
    esz = 4 if dtype == torch.float32 else 2
    nvec = -(-v // (16 // esz))
    assert p.vec == 16 // esz
    if design == "warp":
        assert v * esz <= osk.WARP_ROW_BYTES
        assert (p.threads, p.slices) == (osk.WARP_CTA_THREADS, 1)
        assert p.smem == osk.WARP_CTA_THREADS // 32 * nvec * 16
    elif design == "block":
        assert osk.WARP_ROW_BYTES < v * esz <= osk.RESIDENT_ROW_BYTES
        assert p.slices == 1 and p.smem == nvec * 16
        assert p.smem <= 227 * 1024                # one CTA's shared memory
    else:
        assert v * esz > osk.RESIDENT_ROW_BYTES
        assert p.threads == osk.STREAM_THREADS and p.smem == 0
        assert p.slices == -(-nvec // osk.SLICE_VECTORS) >= 1


def test_plan_threads_grow_with_the_row():
    """One-CTA-a-row CTAs take about 16 vectors a thread: a power of two
    from 64 to 512 that never falls as V grows."""
    for dtype in (torch.float32, torch.bfloat16):
        prev = 0
        for v in range(1, 120000, 997):
            p = osk.plan(v, dtype)
            if p.design != "block":
                continue
            assert osk.MIN_ROW_THREADS <= p.threads <= osk.MAX_ROW_THREADS
            assert p.threads & (p.threads - 1) == 0 and p.threads >= prev
            assert -(-v // p.vec) <= 16 * p.threads or \
                p.threads == osk.MAX_ROW_THREADS
            prev = p.threads


@pytest.mark.parametrize("rows", [1, 65535, 65536, 70000, 2 ** 31 - 1])
def test_plan_has_no_row_cap(rows):
    """The plan depends on V and the dtype only; the streaming scratch is
    one (m, d) per (row, slice) for any row count, none otherwise."""
    for v in (1000, 100000):
        p = osk.plan(v, torch.float32)
        want = rows * p.slices if p.design == "stream" else 0
        assert p.scratch(rows) == want
    assert list(inspect.signature(osk.plan).parameters) == ["v", "dtype"]


def test_plan_refuses_empty_rows_and_other_dtypes():
    for v, dtype in ((0, torch.float32), (10, torch.float16),
                     (10, torch.float64)):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            osk.plan(v, dtype)


def test_y_shares_x_offset_modulo_16_bytes():
    """y is allocated at x's address modulo 16 bytes (one head / vector /
    tail split serves both), contiguous and of x's shape, also when x
    starts off a 16-byte boundary."""
    for dtype, off in ((torch.float32, 1), (torch.float32, 3),
                       (torch.bfloat16, 1), (torch.float32, 0)):
        buf = torch.zeros(7 * 1001 + off, dtype=dtype)
        x2 = buf[off:].view(7, 1001)
        y = osk._like_at_same_offset(x2)
        assert y.shape == x2.shape and y.dtype == dtype
        assert y.is_contiguous()
        assert y.data_ptr() % 16 == x2.data_ptr() % 16


def test_bf16_kernel_bound_grows_with_v():
    """The bf16 form's bound from the plan's merge tree never falls as V
    grows (warp 5 levels ≤ CTA ≤ 9 ≤ streaming 9 + the slice merge), and it
    prices every V the card checks below 0.25."""
    for dtype in (torch.float32, torch.bfloat16):
        prev = 0.0
        for v in sorted({*range(1, 200001, 1231), *CARD_V[torch.float32]}):
            b = osk.bf16_kernel_error_bound(v, dtype)
            assert b >= prev, (v, dtype)
            prev = b
        for v in CARD_V[dtype]:
            assert 0 < osk.bf16_kernel_error_bound(v, dtype) < 0.25


@pytest.mark.parametrize("v", [1000, 1001, 2048, 4097, 10000, 49152,
                               57344, 57345, 100000])
def test_bf16_kernel_bound_counts_the_plan_tree(v):
    """K = 2 + 3·levels bf16 roundings of d, 2 more for the numerator and
    the output, (2V + 8)·u₃₂ for the fp32 sums; levels from the plan: 5
    across a warp, log2 of a CTA's warps, the streaming slice merge."""
    p = osk.plan(v, torch.float32)
    levels = 5 if p.design == "warp" else 5 + int(math.log2(p.threads // 32))
    if p.design == "stream":
        levels += (-(-p.slices // 32) - 1) + math.ceil(
            math.log2(min(p.slices, 32)))
    assert p.tree_levels() == levels
    t = (2 + 3 * levels + 2) * sf.BF16_EPS + (2 * v + 8) * sf.F32_EPS
    assert osk.bf16_kernel_error_bound(v) == pytest.approx(t / (1 - t))
    x = torch.zeros(2, v, dtype=torch.bfloat16)
    assert osk.bf16_kernel_error_bound(x) == osk.bf16_kernel_error_bound(
        v, torch.bfloat16)


@pytest.mark.parametrize("qoff,vlens,tq,tk,bq,bk", [
    ([15, 0], [80, 65], 65, 80, 13, 16),       # Tq 65, offset off the tile
    ([30, 3], [160, 133], 130, 160, 10, 32),   # Tq 130
    ([0], [80], 80, 80, 16, 16),               # a single-shot prefill
    ([37, 100], [102, 120], 65, 120, 5, 8)])   # both offsets off the tile
def test_plain_offset_prefill_at_new_shapes(qoff, vlens, tq, tk, bq, bk):
    """The contiguous cached prefill's plain version against
    ``flash_attention_offset_pallas`` at the widths and offsets the card's
    tensor-core form is now held at; out and lse in fp32 within 1e-5."""
    rng = np.random.default_rng(tq + tk)
    b = len(vlens)
    q = rng.standard_normal((b, tq, 6, 8)).astype(np.float32)
    k = rng.standard_normal((b, tk, 2, 8)).astype(np.float32)
    v = rng.standard_normal((b, tk, 2, 8)).astype(np.float32)
    qo, vlen = np.asarray(qoff, np.int32), np.asarray(vlens, np.int32)
    ref_out, ref_lse = flash_attention_offset_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(qo),
        jnp.asarray(vlen), causal=True, bq=bq, bk=bk, interpret=True)
    out, lse = fa.flash_attention_offset_plain(_t(q), _t(k), _t(v), _t(qo),
                                               _t(vlen), chunk_size=16)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **tol)
