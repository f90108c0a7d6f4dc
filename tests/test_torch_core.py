"""The port's plain core (``repro_torch.core``, configs, clock) against the
JAX package, on the CPU.

Every test builds its inputs with numpy from a seed and hands the same
arrays to both packages.  Tolerances are float32-level: the two packages run
the same algorithms, with sums taken in another order.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro.configs import smollm_360m as ref_smollm  # noqa: E402
from repro.kernels.softmax_topk import softmax_topk_pallas  # noqa: E402
from repro_torch import configs, core  # noqa: E402
from repro_torch.obs import clock  # noqa: E402

# the modules (both ``core`` packages re-export a function of the same name)
ref_os = importlib.import_module("repro.core.online_softmax")
port_os = importlib.import_module("repro_torch.core.online_softmax")

F32 = dict(rtol=1e-6, atol=1e-6)   # same math, different summation order


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _x(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("arch_fn", ["config", "smoke"])
def test_configs_match_reference(arch_fn):
    ref = getattr(ref_smollm, arch_fn)()
    port = (configs.get if arch_fn == "config" else configs.get_smoke)(
        "smollm_360m")
    port_fields = dataclasses.asdict(port)
    for f in dataclasses.fields(ref):
        assert port_fields[f.name] == getattr(ref, f.name), f.name
    assert port.resolved_head_dim == ref.resolved_head_dim


def test_configs_reject_unported_arch():
    # every architecture of the reference is ported: a name outside its
    # registry raises
    with pytest.raises(NotImplementedError, match="not ported"):
        configs.get("gpt2_small")


@pytest.mark.parametrize("shape,masked_rows", [((4, 37), ()),
                                              ((3, 256), (1,)),
                                              ((2, 3, 50), ())])
def test_online_normalizer_matches_reference(shape, masked_rows):
    x = _x(0, shape)
    for r in masked_rows:                    # an all -inf row: (m, d) = (-inf, 0)
        x[r] = -np.inf
    m_ref, d_ref = ref_os.online_normalizer(jnp.asarray(x))
    m, d = port_os.online_normalizer(_t(x))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **F32)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), **F32)


def test_combine_matches_reference_including_identity():
    rng = np.random.default_rng(1)
    m_a, m_b = (rng.standard_normal(6) * 4).astype(np.float32), \
        (rng.standard_normal(6) * 4).astype(np.float32)
    d_a, d_b = rng.uniform(0.5, 3, 6).astype(np.float32), \
        rng.uniform(0.5, 3, 6).astype(np.float32)
    m_a[:2] = -np.inf                        # the ⊕ identity on one side
    d_a[:2] = 0.0
    m_b[0] = -np.inf                         # and on both: (-inf, 0) stays
    d_b[0] = 0.0
    ref = ref_os.combine((jnp.asarray(m_a), jnp.asarray(d_a)),
                         (jnp.asarray(m_b), jnp.asarray(d_b)))
    got = port_os.combine((_t(m_a), _t(d_a)), (_t(m_b), _t(d_b)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32)
    assert not torch.isnan(got[1]).any()


def test_combine_is_associative():
    xs = [_x(s, (5, 19)) for s in range(3)]
    mds = [port_os.online_normalizer(_t(x)) for x in xs]
    left = port_os.combine(port_os.combine(mds[0], mds[1]), mds[2])
    right = port_os.combine(mds[0], port_os.combine(mds[1], mds[2]))
    whole = port_os.online_normalizer(_t(np.concatenate(xs, axis=-1)))
    for a, b, c in zip(left, right, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)


def test_safe_softmax_matches_reference():
    x = _x(2, (3, 41))
    np.testing.assert_allclose(port_os.safe_softmax(_t(x)).numpy(),
                               np.asarray(ref_os.safe_softmax(jnp.asarray(x))),
                               **F32)


def _tied_logits(seed=3, rows=4, v=256):
    x = _x(seed, (rows, v))
    x[0, [200, 7, 131]] = x[0].max() + 1.0   # exact ties at the top
    x[1, :] = 0.5                            # every element tied
    x[2, 100:] = -np.inf                     # padded vocabulary
    x[3, [5, 250]] = x[3].max() + 2.0
    return x


@pytest.mark.parametrize("k", [1, 5, 8])
def test_softmax_topk_matches_core_and_pallas_with_ties(k):
    """Indices exactly equal to ``lax.top_k``'s (ties to the lowest index)
    through ``core.softmax_topk`` and the Pallas kernel in interpret mode;
    probabilities and lse at float32 level."""
    x = _tied_logits()
    got = core.softmax_topk(_t(x), k)
    ref = ref_core.softmax_topk(jnp.asarray(x), k)
    vals_p, idx_p, lse_p = softmax_topk_pallas(jnp.asarray(x), k, r_blk=4,
                                               v_blk=64, interpret=True)
    for idx in (ref.indices, idx_p):
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(idx))
    assert got.indices[0, :min(k, 3)].tolist() == [7, 131, 200][:k]
    assert got.indices[1].tolist() == list(range(k))
    for vals, lse in ((ref.values, ref.logsumexp), (vals_p, lse_p)):
        np.testing.assert_allclose(got.values.numpy(), np.asarray(vals), **F32)
        np.testing.assert_allclose(got.logsumexp.numpy(), np.asarray(lse),
                                   **F32)


def test_gumbel_pick_matches_reference():
    x = _x(4, (6, 64))
    g = np.random.default_rng(5).gumbel(size=(6, 5)).astype(np.float32)
    ref = ref_core.gumbel_pick(ref_core.softmax_topk(jnp.asarray(x), 5),
                               jnp.asarray(g))
    got = core.gumbel_pick(core.softmax_topk(_t(x), 5), _t(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gumbel_noise_is_seeded_and_standard():
    a = core.gumbel_noise((4000,), torch.Generator().manual_seed(3))
    b = core.gumbel_noise((4000,), torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    # standard Gumbel: mean = Euler–Mascheroni, var = pi^2 / 6 (loose: 4000
    # samples give a standard error of ~0.02 on the mean)
    assert abs(a.mean().item() - 0.5772) < 0.1
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.3


@pytest.mark.parametrize("causal,chunk", [(True, 4), (True, 16), (False, 5)])
def test_attention_matches_reference(causal, chunk):
    """online attention with per-row q_offset and kv_valid_len, GQA (G = 3),
    against the reference's at float32 level; the naive oracle (scalar
    offset, as the reference's takes) against the reference's naive one."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 8)).astype(np.float32)
    qoff = np.array([3, 6], np.int32)
    vlen = np.array([8, 11], np.int32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tol = dict(rtol=1e-5, atol=1e-5)
    ref = ref_core.online_attention(jq, jk, jv, causal=causal, q_offset=qoff,
                                    kv_valid_len=vlen, chunk_size=chunk)
    got = core.online_attention(_t(q), _t(k), _t(v), causal=causal,
                                q_offset=_t(qoff), kv_valid_len=_t(vlen),
                                chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    got_naive = core.naive_attention(_t(q), _t(k), _t(v), causal=causal,
                                     q_offset=_t(qoff), kv_valid_len=_t(vlen))
    np.testing.assert_allclose(got.numpy(), got_naive.numpy(), **tol)
    ref_naive = ref_core.naive_attention(jq, jk, jv, causal=causal,
                                         q_offset=4, kv_valid_len=vlen)
    got_naive = core.naive_attention(_t(q), _t(k), _t(v), causal=causal,
                                     q_offset=4, kv_valid_len=_t(vlen))
    np.testing.assert_allclose(got_naive.numpy(), np.asarray(ref_naive),
                               **tol)


def test_virtual_clock_moves_only_when_advanced():
    c = clock.VirtualClock(2.0)
    prev = clock.set_clock(c)
    try:
        assert clock.monotonic() == clock.perf_counter() == 2.0
        c.advance(0.5)
        assert clock.wall_time() == 2.5
        with pytest.raises(ValueError):
            c.advance(-1.0)
    finally:
        clock.set_clock(prev)
    assert isinstance(clock.get(), clock.SystemClock)
