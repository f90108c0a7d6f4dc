"""The paged cached prefill's plain version against the Pallas kernel
(interpret mode, as ``tests/kernels/`` runs it) at the edges of the
tensor-core form's 64-key tiles: Tq 65 and 130 (a 64-row query tile and one
more row, two and two more), q_offsets off the tile (37, 100), a vlen that
ends mid-page inside the second key tile, pages of 8, 16 and 32 positions,
and shuffled, non-monotonic block tables whose dead entries point at the
sentinel.

On the card the bf16 form runs ``paged_wgmma_kernel`` and the fp32 form
``prefill_paged_kernel``; ``tests/test_torch_cuda.py`` (marked ``cuda``)
and ``python3 chip_smoke.py`` hold both against this plain version there.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_paged_pallas)
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# float32 on both sides; the plain version gathers pages and runs the
# chunked online form, the Pallas kernel walks one page per grid step: the
# same masked (m, d, acc) recurrence in another summation order
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _shuffled_case(seed, *, vlens, bs, tq, hkv=2, g=3, d=8):
    """Pools [P, Hkv, BS, D] and tables [B, M] whose live entries are a
    random permutation of the pool's pages (so no row's pages ascend), dead
    entries at the sentinel 0; q [B, Tq, Hq, D]."""
    rng = np.random.default_rng(seed)
    b = len(vlens)
    live = [max(1, -(-v // bs)) for v in vlens]
    m = max(live) + 1
    p = 1 + sum(live)
    k_pool = rng.standard_normal((p, hkv, bs, d)).astype(np.float32)
    v_pool = rng.standard_normal((p, hkv, bs, d)).astype(np.float32)
    ids = list(rng.permutation(np.arange(1, p)))
    tables = np.zeros((b, m), np.int32)
    for row, n in enumerate(live):
        for j in range(n):
            tables[row, j] = ids.pop()
    q = rng.standard_normal((b, tq, hkv * g, d)).astype(np.float32)
    return q, k_pool, v_pool, tables, np.asarray(vlens, np.int32)


# (Tq, q_offset per row, vlen per row, BS, Pallas query tile bq)
CASES = [
    (65, [37, 100], [102, 165], 8, 13),     # Tq 65, offsets off the tile
    (65, [37, 100], [102, 165], 16, 65),
    (130, [3, 150], [133, 280], 32, 26),    # Tq 130
    (130, [3, 150], [133, 280], 16, 65),
    (36, [64, 0], [100, 36], 8, 12),        # vlen 100: mid-page, 2nd tile
    (36, [64], [100], 32, 36),
    (64, [37, 0], [101, 0], 16, 16),        # a keyless row
]


@pytest.mark.parametrize("tq,qoff,vlens,bs,bq", CASES)
def test_plain_paged_prefill_at_tile_edges(tq, qoff, vlens, bs, bq):
    """``flash_attention_paged_plain`` against
    ``flash_attention_paged_pallas`` over shuffled tables: out and lse in
    fp32 within 1e-5; a keyless row gives lse -inf on both."""
    q, kp, vp, tables, vlen = _shuffled_case(tq + bs, vlens=vlens, bs=bs,
                                             tq=tq)
    live = tables[tables > 0]
    assert (np.diff(live) < 0).any()          # not ascending
    qo = np.asarray(qoff, np.int32)
    ref_out, ref_lse = flash_attention_paged_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(qo), jnp.asarray(vlen),
        jnp.asarray(tables), causal=True, bq=bq, interpret=True)
    out, lse = fa.flash_attention_paged_plain(_t(q), _t(kp), _t(vp), _t(qo),
                                              _t(vlen), _t(tables),
                                              chunk_size=64)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    ref_lse = np.asarray(ref_lse)[..., 0]
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(ref_lse))
    fin = np.isfinite(ref_lse)
    np.testing.assert_allclose(lse.numpy()[fin], ref_lse[fin], **TOL)
    if 0 in vlens:
        assert np.isneginf(lse.numpy()[vlens.index(0)]).all()


@pytest.mark.parametrize("bs", [8, 16, 24, 32])
def test_plain_paged_prefill_ignores_what_lies_past_vlen(bs):
    """Positions past a row's vlen in its last live page and every dead
    table entry change nothing: the kernel never reads them, so the plain
    version it is held to must not depend on them either (NaN there on the
    card, garbage here)."""
    vlens, tq = [100, 37], 36
    q, kp, vp, tables, vlen = _shuffled_case(bs, vlens=vlens, bs=bs, tq=tq)
    qo = np.asarray([64, 1], np.int32)
    args = (_t(qo), _t(vlen), _t(tables))
    want, want_lse = fa.flash_attention_paged_plain(_t(q), _t(kp), _t(vp),
                                                    *args)
    kg, vg = kp.copy(), vp.copy()
    for row, n in enumerate(vlens):
        for pos in range(n, -(-n // bs) * bs):
            kg[tables[row, pos // bs], :, pos % bs] = 1e4
            vg[tables[row, pos // bs], :, pos % bs] = -1e4
    kg[0], vg[0] = 1e4, -1e4                  # the sentinel, dead entries
    got, got_lse = fa.flash_attention_paged_plain(_t(q), _t(kg), _t(vg),
                                                  *args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=0)
