"""The split one-token decode's host side, on the CPU: the planner that
cuts a call's key range into splits (``flash_decode.decode_plan``), and the
plain versions the CUDA kernels are held against, compared with the Pallas
kernels (interpret mode, as ``tests/kernels/`` runs them) at valid lengths
on the planner's split edges.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
(marked ``cuda``) and ``python3 chip_smoke.py`` hold them against the plain
versions there, at these edges too.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import (  # noqa: E402
    flash_decode_pallas, flash_decode_paged_pallas)
from repro_torch.kernels import flash_decode as fd  # noqa: E402

H100_SMS = 132
# float32 on both sides; the plain version runs the chunked online form,
# the Pallas kernel one page (or block) per grid step: the same masked
# (m, d, acc) recurrence in another summation order
TOL = dict(rtol=1e-5, atol=1e-5)

# (B, Hkv, G, max_len, page, K/V dtype): the serving paths' shapes (paged
# B 8 over 21 pages of 16, the slot pool's 328, the lockstep's 4 x 288),
# their int8 and fp32 forms, a long cache, a short one, odd pages
PLAN_CASES = [
    (8, 5, 3, 336, 16, torch.bfloat16), (8, 5, 3, 328, 16, torch.bfloat16),
    (4, 5, 3, 288, 16, torch.bfloat16), (8, 5, 3, 336, 16, torch.int8),
    (18, 5, 3, 336, 16, torch.float32), (1, 5, 3, 32768, 16, torch.bfloat16),
    (1, 8, 7, 100000, 16, torch.int8), (64, 8, 1, 4096, 16, torch.float32),
    (2, 1, 3, 16, 4, torch.float32), (3, 2, 8, 1, 8, torch.bfloat16),
    (8, 5, 3, 0, 16, torch.float32), (200, 5, 3, 336, 16, torch.bfloat16),
    (5, 3, 2, 1000, 24, torch.int8), (7, 2, 4, 517, 1, torch.float32),
]


def _plan(case, sms=H100_SMS):
    b, hkv, g, max_len, page, dtype = case
    return fd.decode_plan(b, hkv, g, 64, max_len, page, dtype, sms)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_covers_every_position_once_in_whole_pages(case):
    b, hkv, g, max_len, page, dtype = case
    plan = _plan(case)
    assert plan.split % page == 0 and plan.split >= page
    covered = list(itertools.chain.from_iterable(
        range(i * plan.split, min((i + 1) * plan.split, max_len))
        for i in range(plan.splits)))
    assert covered == list(range(max_len))
    # no split lies wholly past the cache (one split for an empty one)
    assert (plan.splits - 1) * plan.split < max(max_len, 1)
    assert plan.threads == fd.DECODE_THREADS


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_fills_the_card_where_the_cache_allows(case):
    """B·Hkv·splits reaches WAVES × the SMs, unless the split sits at its
    floor of MIN_SPLIT positions (a short cache does not split further) or
    the cache is a single split; the split never exceeds the cache or the
    CTA's byte budget."""
    b, hkv, g, max_len, page, dtype = case
    plan = _plan(case)
    floor = -(-fd.MIN_SPLIT // page) * page
    ctas = b * hkv * plan.splits
    assert ctas >= fd.WAVES * H100_SMS or plan.split <= floor \
        or plan.splits == 1, plan
    assert plan.split <= max(page, -(-max_len // page) * page)
    esz = dtype.itemsize
    assert plan.split * 64 * esz <= max(fd.SPLIT_BYTES, page * 64 * esz)
    # the longest such split: one page more would leave fewer splits
    # than the grid needs (or pass the budget)
    if fd.WAVES * H100_SMS > b * hkv and plan.split > floor:
        want = -(-fd.WAVES * H100_SMS // (b * hkv))
        longer = plan.split + page
        assert -(-max_len // longer) < want \
            or longer * 64 * esz > fd.SPLIT_BYTES


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_workspace_and_shared_memory_fit(case):
    b, hkv, g, max_len, page, dtype = case
    plan = _plan(case)
    scaled = dtype == torch.int8
    assert plan.workspace == b * hkv * plan.splits * g * (64 + 2)
    assert plan.smem == fd.split_smem(g, 64, dtype.itemsize, plan.split,
                                      scaled)
    assert plan.smem <= fd.SMEM_LIMIT
    # K and V of the split, the scores and the warps' accumulators
    assert plan.smem >= (2 * plan.split * 64 * dtype.itemsize
                         + 4 * g * plan.split + 4 * fd.DECODE_WARPS * g * 64)


def test_plan_is_pure():
    """A function of its arguments alone: the same plan from a cold cache,
    the SM count as an argument (nothing read from a device), and the
    serving shapes' splits as the kernels' notes state them."""
    fd.decode_plan.cache_clear()
    first = [_plan(c) for c in PLAN_CASES]
    fd.decode_plan.cache_clear()
    assert [_plan(c) for c in PLAN_CASES] == first
    assert _plan(PLAN_CASES[0]) == fd.DecodePlan(48, 7, 128, 16000, 55440)
    assert _plan(PLAN_CASES[1])[:2] == (48, 7)
    assert _plan(PLAN_CASES[2])[:2] == (32, 9)
    # a card of another size gives another split, never another coverage
    small = _plan(PLAN_CASES[0], sms=16)
    assert small.split * small.splits >= 336 and small.split >= 48


@pytest.mark.parametrize("vlen,live", [(0, 0), (1, 1), (47, 1), (48, 1),
                                       (49, 2), (336, 7), (400, 7), (-3, 0)])
def test_plan_live_splits(vlen, live):
    """The splits a row runs: ceil(min(max(vlen, 0), max_len) / split),
    the count the last-CTA merge walks (the others exit unread)."""
    assert _plan(PLAN_CASES[0]).live(vlen, 336) == live


@pytest.mark.parametrize("kwargs,match", [
    (dict(d=32), "D=32"), (dict(g=9), "G=9"), (dict(g=0), "G=0"),
    (dict(dtype=torch.float16), "float16"), (dict(b=0), "B=0"),
    (dict(b=65536), "B=65536"), (dict(page=0), "page=0"),
    (dict(max_len=-1), "max_len=-1"), (dict(sm_count=0), "supported"),
    (dict(page=1024), "shared memory")])
def test_plan_refuses_what_the_kernels_do_not_take(kwargs, match):
    args = dict(b=8, hkv=5, g=3, d=64, max_len=336, page=16,
                dtype=torch.bfloat16, sm_count=H100_SMS)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        fd.decode_plan(**args)


@pytest.mark.parametrize("offset,strides,ok", [
    (0, (), True), (0, (5 * 64 * 328, 5 * 64, 64), True),
    (8, (), False), (0, (5 * 64 * 328, 5 * 64 + 4, 64), False)])
def test_unaligned_rows_are_refused(offset, strides, ok):
    """The kernels copy K/V rows as 16-byte vectors: a base address or a
    stride off 16 bytes raises instead of launching."""
    buf = torch.zeros(4096 + 16, dtype=torch.bfloat16)
    k = buf[offset // 2:][:4096]
    if ok:
        fd._check_aligned("flash_decode", k, k, strides or (0,))
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fd._check_aligned("flash_decode", k, k, strides or (0,))


def _edges(plan, max_len):
    """vlen 0, 1, every split edge ± 1 and the full length: a row for
    every count of live splits."""
    out = [0, 1, max_len]
    for k in range(1, plan.splits):
        out += [k * plan.split - 1, k * plan.split, k * plan.split + 1]
    out = sorted(set(v for v in out if 0 <= v <= max_len))
    assert {plan.live(v, max_len) for v in out} == set(range(plan.splits + 1))
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("b,bs,m", [(8, 16, 21), (18, 16, 21), (4, 8, 36)])
def test_plain_paged_decode_matches_pallas_at_split_edges(b, bs, m):
    """``flash_decode_paged_plain`` against ``flash_decode_paged_pallas`` at
    every valid length on the plan's split edges (5 KV heads, G 3, D 64,
    the plan the wrapper makes for these pools on an H100), fp32 within
    1e-5; rows with vlen 0 give 0."""
    plan = fd.decode_plan(b, 5, 3, 64, m * bs, bs, torch.float32, H100_SMS)
    vlens = _edges(plan, m * bs)
    rng = np.random.default_rng(m + b)
    p = 1 + len(vlens) * m
    kp = rng.standard_normal((p, 5, bs, 64)).astype(np.float32)
    vp = rng.standard_normal((p, 5, bs, 64)).astype(np.float32)
    tables = (1 + rng.permutation(p - 1)[:len(vlens) * m]).reshape(
        len(vlens), m).astype(np.int32)
    q = rng.standard_normal((len(vlens), 1, 15, 64)).astype(np.float32)
    vlen = np.asarray(vlens, np.int32)
    ref = flash_decode_paged_pallas(
        jnp.asarray(q[:, 0]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(vlen), interpret=True)
    got = fd.flash_decode_paged_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(vlen), chunk_size=plan.split)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)
    assert not got[vlen == 0].any()


@pytest.mark.parametrize("b,s", [(8, 328), (4, 288), (18, 200)])
def test_plain_decode_matches_pallas_at_split_edges(b, s):
    """``flash_decode_plain`` against ``flash_decode_pallas`` (caches
    transposed to its [B, Hkv, S, D]) at every valid length on the plan's
    split edges for contiguous caches of S positions, fp32 within 1e-5."""
    plan = fd.decode_plan(b, 5, 3, 64, s, fd.CONTIGUOUS_TILE, torch.float32,
                          H100_SMS)
    vlens = _edges(plan, s)
    rng = np.random.default_rng(s + b)
    n = len(vlens)
    q = rng.standard_normal((n, 1, 15, 64)).astype(np.float32)
    k = rng.standard_normal((n, s, 5, 64)).astype(np.float32)
    v = rng.standard_normal((n, s, 5, 64)).astype(np.float32)
    vlen = np.asarray(vlens, np.int32)
    bk = 8 if s % 16 else 16
    ref = flash_decode_pallas(
        jnp.asarray(q[:, 0]), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(vlen), bk=bk,
        interpret=True)
    got = fd.flash_decode_plain(_t(q), _t(k), _t(v), _t(vlen),
                                chunk_size=plan.split)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)
    assert not got[vlen == 0].any()
