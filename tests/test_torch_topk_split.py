"""The fused softmax+top-k's split, on the CPU: the planner that cuts each
row into slices, one CTA each (``softmax_topk.plan``), and a plain model of
the kernel's arithmetic — a partial (m, d, top k) per slice of the plan,
then the paper's ⊕ over the partials in slice order and the top k of the
slices' candidates — held against the Pallas kernel (interpret mode, as
``tests/kernels/`` runs it) and against the port's plain version.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py``
(marked ``cuda``) and ``python3 chip_smoke.py`` hold it against the plain
version there, at these slice edges too.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.softmax_topk import softmax_topk_pallas  # noqa: E402
from repro_torch.kernels import softmax_topk as st  # noqa: E402

H100_SMS = 132
BIG_IDX = 2 ** 31 - 1     # the kernel's "no index" (INT_MAX)

# (R, V, k, dtype): the serving paths' sampling (8 slots, the lockstep's 4,
# one prompt), the library's calls of phase 9 (bf16 logits of a train
# batch, 70000 rows, the paper's regimes), a row of a million entries,
# rows shorter than a vector, k at its limits
PLAN_CASES = [
    (8, 49152, 5, torch.float32), (8, 49152, 5, torch.bfloat16),
    (4, 49152, 5, torch.float32), (1, 49152, 5, torch.float32),
    (4096, 49152, 5, torch.bfloat16), (70000, 1000, 5, torch.float32),
    (4000, 100000, 5, torch.float32), (10, 100000, 32, torch.float32),
    (1, 1000000, 32, torch.float32), (3, 3, 1, torch.float32),
    (263, 49152, 32, torch.bfloat16), (264, 49152, 1, torch.float32),
    (8, 1001, 5, torch.float32), (2, 4097, 32, torch.bfloat16),
]


def _plan(case, sms=H100_SMS):
    r, v, k, dtype = case
    return st.plan(r, v, k, dtype, sms)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_covers_every_entry_once(case):
    """Slices of whole 16-byte vectors tile the row: every entry lies in
    exactly one slice, and no slice lies wholly past the row; a CTA takes a
    power of two of threads in [64, 256]."""
    r, v, k, dtype = case
    p = _plan(case)
    assert p.vec == 16 // dtype.itemsize and p.slice % p.vec == 0
    covered = np.concatenate([np.arange(s * p.slice,
                                        min(v, (s + 1) * p.slice))
                              for s in range(p.slices)])
    np.testing.assert_array_equal(covered, np.arange(v))
    assert (p.slices - 1) * p.slice < v
    assert st.MIN_THREADS <= p.threads <= st.MAX_THREADS
    assert p.threads & (p.threads - 1) == 0


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_fills_the_card_or_stops_at_its_floors(case):
    """Rows that reach ``WAVES`` × the SMs alone take one CTA each.  Split
    rows reach that many CTAs unless the slice sits at its floor
    (``MIN_SLICE_VECTORS``, or ``MAX_SLICES`` slices a row), with at most
    twice the fewest slices that would; a thread of a one-vector plan has
    one batch."""
    r, v, k, dtype = case
    p = _plan(case)
    target = st.WAVES * H100_SMS
    if r >= target:
        assert p.slices == 1 and p.loads == st.LONG_LOADS
        return
    nvec = -(-v // p.vec)
    floor = max(st.MIN_SLICE_VECTORS, -(-nvec // st.MAX_SLICES))
    fewest = -(-nvec // max(-(-nvec // -(-target // r)), floor))
    if p.slices > 1:
        assert r * p.slices >= target or p.slice_vectors == floor
        assert fewest <= p.slices <= 2 * fewest
    if p.loads == 1:
        assert p.slices > 1 and p.threads >= p.slice_vectors


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fills_two_waves_at_the_decode_batch(dtype):
    """The serving path's sampling call, [8, 49152]: at least 2 × 132 CTAs
    (the parent design ran 96 then 8)."""
    p = st.plan(8, 49152, 5, dtype, H100_SMS)
    assert 8 * p.slices >= 2 * H100_SMS
    assert p.slices > 1 and p.smem == 8 * p.slices * 5


@pytest.mark.parametrize("r,v", [(70000, 1000), (4096, 49152), (264, 10)])
def test_plan_is_one_cta_a_row_when_rows_fill_the_card(r, v):
    for dtype in (torch.float32, torch.bfloat16):
        p = st.plan(r, v, 5, dtype, H100_SMS)
        assert p.slices == 1 and p.smem == 0
        assert p.slice >= v


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_candidates_fit_shared_memory(case):
    """The merging CTA's S·k candidates (8 bytes each) in its dynamic
    shared memory: at most 64 slices, so at most 16 KB, under the 48 KB a
    launch takes without opting in to more."""
    r, v, k, dtype = case
    p = _plan(case)
    assert p.smem == (8 * p.slices * k if p.slices > 1 else 0)
    assert p.slices <= st.MAX_SLICES
    assert p.smem <= 16 * 1024


def test_plan_is_pure():
    """A function of its arguments alone: the same plan from a cold cache,
    the SM count an argument (nothing read from a device), and the serving
    shape's split as the kernel's notes state it."""
    st.plan.cache_clear()
    first = [_plan(c) for c in PLAN_CASES]
    st.plan.cache_clear()
    assert [_plan(c) for c in PLAN_CASES] == first
    assert _plan(PLAN_CASES[0]) == st.Plan(1024, 48, 256, 1, 1920, 4)
    small = _plan(PLAN_CASES[0], sms=16)
    assert small.slices < 48 and small.slice * small.slices >= 49152


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=0), "k=0"), (dict(k=33), "k=33"), (dict(r=0), "0 rows"),
    (dict(v=0), "V=0"), (dict(dtype=torch.float16), "float16"),
    (dict(sm_count=0), "supported")])
def test_plan_refuses_what_the_kernel_does_not_take(kwargs, match):
    args = dict(r=8, v=49152, k=5, dtype=torch.float32, sm_count=H100_SMS)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        st.plan(**args)


def _rescale(m_old, m_new):
    """exp(m_old - m_new), 1 where both are -inf (the ⊕ identity)."""
    with np.errstate(invalid="ignore"):
        return np.where(m_old == m_new, 1.0, np.exp(m_old - m_new))


def _topk_order(u, p, k):
    """The best k of candidates (u, p) per row by (value desc, index asc)."""
    order = np.lexsort((p, -u), axis=-1)[..., :k]
    return (np.take_along_axis(u, order, -1),
            np.take_along_axis(p, order, -1))


def split_model(x, k, plan):
    """The kernel's arithmetic in float64: per slice of ``plan`` its (m, d)
    — (-inf, 0) for a slice all -inf — and its top k, padded with (-inf,
    BIG_IDX) where the slice is shorter; then ⊕ over the partials in slice
    order and the top k of the slices' candidates.  Returns (vals, idx,
    lse)."""
    x = x.astype(np.float64)
    r, v = x.shape
    m = np.full(r, -np.inf)
    d = np.zeros(r)
    cu, cp = [], []
    for s in range(plan.slices):
        lo, hi = s * plan.slice, min(v, (s + 1) * plan.slice)
        xs = x[:, lo:hi]
        ms = xs.max(-1)
        with np.errstate(invalid="ignore"):
            ds = np.where(np.isneginf(ms), 0.0,
                          np.exp(xs - ms[:, None]).sum(-1))
        mn = np.maximum(m, ms)
        d = d * _rescale(m, mn) + ds * _rescale(ms, mn)
        m = mn
        idx = np.broadcast_to(np.arange(lo, hi), xs.shape)
        pad = max(0, k - (hi - lo))
        u = np.concatenate([xs, np.full((r, pad), -np.inf)], -1)
        p = np.concatenate([idx, np.full((r, pad), BIG_IDX)], -1)
        su, sp = _topk_order(u, p, k)
        cu.append(su)
        cp.append(sp)
    u, p = _topk_order(np.concatenate(cu, -1), np.concatenate(cp, -1), k)
    return np.exp(u - m[:, None]) / d[:, None], p, m + np.log(d)


def _split_input(seed, r, v, plan):
    """Random logits with the kernel's hard cases at the plan's slice
    edges: row 0 five exact ties at the top, two straddling each of the
    first two edges; row 1 its second slice all -inf; row 2 constant over
    its first two slices (ties across an edge); the rest random."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, v)) * 4.0).astype(np.float32)
    e = plan.slice
    ties = sorted({3, e - 1, e, min(2 * e - 1, v - 1), min(2 * e, v - 1)})
    x[0, ties] = x[0].max() + 1.0
    x[1, e:2 * e] = -np.inf
    x[2, :2 * e] = x[2, 0]
    return x, ties


# (R, V, k, SMs, Pallas v_blk): V no multiple of the plan's slice in each
SPLIT_CASES = [(4, 3000, 5, H100_SMS, 1000), (3, 4097, 32, H100_SMS, 241),
               (8, 1001, 1, 16, 143), (4, 2570, 7, H100_SMS, 514)]


@pytest.mark.parametrize("r,v,k,sms,v_blk", SPLIT_CASES)
def test_split_model_matches_pallas(r, v, k, sms, v_blk):
    """The plain model of the split against ``softmax_topk_pallas`` on the
    same logits: indices equal (ties across slice edges to the lowest
    index), vals and lse within rtol 1e-6 (the Pallas kernel sums in
    float32 tile by tile, the model in float64 slice by slice)."""
    plan = st.plan(r, v, k, torch.float32, sms)
    assert plan.slices > 1 and v % plan.slice
    x, ties = _split_input(r + v, r, v, plan)
    vals, idx, lse = split_model(x, k, plan)
    ref_v, ref_i, ref_l = softmax_topk_pallas(jnp.asarray(x), k, r_blk=r,
                                              v_blk=v_blk, interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(ref_i))
    assert idx[0, :min(k, 5)].tolist() == ties[:min(k, 5)]
    np.testing.assert_allclose(vals, np.asarray(ref_v), rtol=1e-6, atol=0)
    np.testing.assert_allclose(lse, np.asarray(ref_l), rtol=1e-6, atol=0)
    assert np.isfinite(lse).all()


@pytest.mark.parametrize("r,v,k,sms,v_blk", SPLIT_CASES)
def test_split_model_matches_the_plain_version(r, v, k, sms, v_blk):
    """The same model against ``softmax_topk_plain``, the version the
    kernel is held to on the card: indices equal, vals and lse within rtol
    1e-6."""
    plan = st.plan(r, v, k, torch.float32, sms)
    x, _ = _split_input(r * v, r, v, plan)
    vals, idx, lse = split_model(x, k, plan)
    got = st.softmax_topk_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(idx, got.indices.numpy())
    np.testing.assert_allclose(vals, got.values.numpy(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(lse, got.logsumexp.numpy(), rtol=1e-6,
                               atol=0)


def test_a_slice_all_neg_inf_is_the_identity():
    """A slice with no finite entry contributes (-inf, 0): the row's (m, d)
    and top k are those of its other slices, with no NaN."""
    plan = st.plan(3, 3000, 5, torch.float32, H100_SMS)
    x, _ = _split_input(7, 3, 3000, plan)
    e = plan.slice
    kept = np.concatenate([x[1:2, :e], x[1:2, 2 * e:]], -1)
    vals, idx, lse = split_model(x[1:2], 5, plan)
    ref = st.softmax_topk_plain(torch.from_numpy(kept), 5)
    shifted = np.where(ref.indices.numpy() >= e, ref.indices.numpy() + e,
                       ref.indices.numpy())
    np.testing.assert_array_equal(idx, shifted)
    np.testing.assert_allclose(lse, ref.logsumexp.numpy(), rtol=1e-6)
    assert np.isfinite(vals).all()
