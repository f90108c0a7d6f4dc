"""The xLSTM blocks of the port (``repro_torch.models.xlstm``) against the
JAX package's ``repro.models.xlstm``, on the CPU.

* ``mlstm_chunked`` with and without a carried (m, C, n), at T below the
  chunk and at T a multiple of it; the default start, m = −inf, gives
  finite results equal to an explicit −inf start's.
* ``mlstm_decode_step``, from a carried state and from m = −inf.
* ``slstm_scan`` with and without a carried (c, n, m, h).
* ``mlstm_block_apply`` and ``slstm_block_apply`` on the reference's
  weights (``mlstm_block_init`` / ``slstm_block_init`` through the port's
  converter): a prefill, then steps from the state it left, outputs and
  states against the reference's.
* The port against itself: the chunked mLSTM over T equals T decode steps.
* ``is_slstm`` / ``xlstm_cache_init`` and both blocks' init shapes and
  dtypes against the reference's.

Inputs are drawn from a seeded numpy generator and fed to both packages.
Tolerances: float32 everywhere; the packages compute the same math with
other contraction orders, so results agree to rtol 1e-5 and atol 1e-5 ·
max|reference| (``_close``), except the chunked form against its own
decode steps (two orders of a 32-step recurrence: 1e-4).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import xlstm as RX  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer, xlstm  # noqa: E402
from repro_torch.models.convert import _leaf  # noqa: E402

ARCH = "xlstm_125m"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30))


def _mlstm_inputs(seed, b=2, t=16, h=2, d=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal((b, t, h, d)).astype(f),
            (rng.standard_normal((b, t, h, d)) / np.sqrt(d)).astype(f),
            rng.standard_normal((b, t, h, d)).astype(f),
            (2.0 * rng.standard_normal((b, t, h))).astype(f),
            (2.0 * rng.standard_normal((b, t, h)) + 1.0).astype(f)]


def _mlstm_state(seed, b=2, h=2, d=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, h)).astype(f),
            rng.standard_normal((b, h, d, d)).astype(f),
            rng.standard_normal((b, h, d)).astype(f))


@pytest.mark.parametrize("t", [5, 32], ids=["below_chunk", "two_chunks"])
@pytest.mark.parametrize("with_init", [False, True],
                         ids=["m_neg_inf", "carried"])
def test_mlstm_chunked_matches_reference(t, with_init):
    """The chunked mLSTM at chunk 16 over T 5 and 32, from the default
    start (m = −inf: the first chunk's carried terms are 0, nothing NaN) or
    a carried state: outputs and (m, C, n)."""
    a = _mlstm_inputs(0, t=t)
    init = _mlstm_state(1) if with_init else None
    want_h, want_s = jax.jit(functools.partial(RX.mlstm_chunked, chunk=16))(
        *map(jnp.asarray, a),
        init=None if init is None else tuple(map(jnp.asarray, init)))
    got_h, got_s = xlstm.mlstm_chunked(
        *map(_t, a), chunk=16,
        init=None if init is None else tuple(map(_t, init)))
    assert torch.isfinite(got_h).all()
    _close(got_h.numpy(), want_h)
    for g, w in zip(got_s, want_s):
        _close(g.numpy(), w)
    if not with_init:
        neg = (torch.full((2, 2), float("-inf")), torch.zeros(2, 2, 8, 8),
               torch.zeros(2, 2, 8))
        again, _ = xlstm.mlstm_chunked(*map(_t, a), chunk=16, init=neg)
        assert torch.equal(again, got_h)


@pytest.mark.parametrize("start", ["carried", "m_neg_inf"])
def test_mlstm_decode_step_matches_reference(start):
    a = [x[:, 0] for x in _mlstm_inputs(2, t=1)]
    m, c, n = _mlstm_state(3)
    if start == "m_neg_inf":
        m = np.full_like(m, -np.inf)
        c, n = np.zeros_like(c), np.zeros_like(n)
    want_h, want_s = RX.mlstm_decode_step(
        tuple(map(jnp.asarray, (m, c, n))), *map(jnp.asarray, a))
    got_h, got_s = xlstm.mlstm_decode_step(tuple(map(_t, (m, c, n))),
                                           *map(_t, a))
    assert torch.isfinite(got_h).all()
    _close(got_h.numpy(), want_h)
    for g, w in zip(got_s, want_s):
        _close(g.numpy(), w)


@pytest.mark.parametrize("with_init", [False, True],
                         ids=["fresh", "carried"])
def test_slstm_scan_matches_reference(with_init):
    """The sLSTM over 9 steps with 2 heads of 4: outputs and the final
    (c, n, m, h)."""
    rng = np.random.default_rng(4)
    gx = (2.0 * rng.standard_normal((2, 9, 4, 8))).astype(np.float32)
    r = (rng.standard_normal((4, 2, 4, 4)) / 2.0).astype(np.float32)
    init = None
    if with_init:
        init = (rng.standard_normal((2, 8)).astype(np.float32),
                (1.0 + rng.random((2, 8))).astype(np.float32),
                rng.standard_normal((2, 8)).astype(np.float32),
                rng.standard_normal((2, 8)).astype(np.float32))
    want_h, want_s = RX.slstm_scan(
        jnp.asarray(gx), jnp.asarray(r), num_heads=2,
        init=None if init is None else tuple(map(jnp.asarray, init)))
    got_h, got_s = xlstm.slstm_scan(
        _t(gx), _t(r), num_heads=2,
        init=None if init is None else tuple(map(_t, init)))
    _close(got_h.numpy(), want_h)
    for g, w in zip(got_s, want_s):
        _close(g.numpy(), w)


@functools.lru_cache(maxsize=None)
def _blocks():
    """(reference weights by kind, its cfg, the port's, its cfg) of the
    smoke config's two block kinds, from the reference's inits."""
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    ref, port = {}, {}
    for kind, fn in (("mlstm", RX.mlstm_block_init),
                     ("slstm", RX.slstm_block_init)):
        ref[kind], _ = RL.split_params(fn(jax.random.PRNGKey(7), cfg_ref))
        if kind == "mlstm":     # a nonzero gate bias, so both gates matter
            ref[kind]["if_bias"] = jnp.linspace(-1.0, 2.0, 4)
        port[kind] = _leaf(jax.tree.map(np.asarray, ref[kind]), None, "cpu")
    return ref, cfg_ref, port, cfg


def _flat_ref(kind, c):
    """The reference block's cache as the port's flat leaves."""
    if kind == "mlstm":
        return {**dict(zip(("m", "C", "n"), c["mlstm"])), "conv": c["conv"]}
    return dict(zip(xlstm.SLSTM_LEAVES, c["slstm"]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_apply_prefill_then_steps_match_reference(kind):
    """A block's 16-token prefill without a cache, then three one-token
    steps from the state it left (the mLSTM's decode step, the sLSTM's
    scan): outputs and states against the reference's, the port's written
    into the given cache in place."""
    ref, cfg_ref, port, cfg = _blocks()
    apply_ref = {"mlstm": RX.mlstm_block_apply,
                 "slstm": RX.slstm_block_apply}[kind]
    apply = {"mlstm": xlstm.mlstm_block_apply,
             "slstm": xlstm.slstm_block_apply}[kind]
    x = np.random.default_rng(8).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    want, ref_cache = apply_ref(ref[kind], jnp.asarray(x[:, :16]), cfg_ref)
    got, cache = apply(port[kind], _t(x[:, :16]), cfg)
    _close(got.numpy(), want)
    for k, w in _flat_ref(kind, ref_cache).items():
        _close(cache[k].numpy(), w)
    cache = {k: v.clone() for k, v in cache.items()}
    for i in range(16, 19):
        want, ref_cache = apply_ref(ref[kind], jnp.asarray(x[:, i:i + 1]),
                                    cfg_ref, cache=ref_cache)
        got, new = apply(port[kind], _t(x[:, i:i + 1]), cfg, cache=cache)
        _close(got.numpy(), want)
        for k, w in _flat_ref(kind, ref_cache).items():
            assert torch.equal(cache[k], new[k])       # written in place
            _close(cache[k].numpy(), w)


def test_mlstm_chunked_equals_decode_steps():
    """The port against itself: the chunked mLSTM over 32 steps (two
    chunks, from a carried state) equals 32 decode steps."""
    a = list(map(_t, _mlstm_inputs(9, t=32)))
    state = tuple(map(_t, _mlstm_state(10)))
    h, (m_f, c_f, n_f) = xlstm.mlstm_chunked(*a, chunk=16, init=state)
    s = state
    for i in range(32):
        hi, s = xlstm.mlstm_decode_step(s, *(x[:, i] for x in a))
        _close(hi.numpy(), h[:, i].numpy(), rtol=1e-4)
    # the carried (C, n) are scaled by exp(−m): compare them at one scale
    scale = torch.exp(s[0] - m_f)
    _close((s[1] / scale[..., None, None]).numpy(), c_f.numpy(), rtol=1e-4)
    _close((s[2] / scale[..., None]).numpy(), n_f.numpy(), rtol=1e-4)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_inits_and_cache_match_reference(which):
    """Both blocks' leaves in the reference's shapes and dtypes (fp32 conv,
    gate weights and bias, recurrent matrices, norms), the sLSTM placement
    (layers 5 and 11 of 12 at full size) and every layer's initial state
    (m −inf, the sLSTM's n 1) against ``xlstm_cache_init``'s; the full
    config is only shaped, not drawn."""
    get = "get_smoke" if which == "smoke" else "get"
    cfg_ref, cfg = (getattr(ref_configs, get)(ARCH),
                    getattr(configs, get)(ARCH))
    slstm = [i for i in range(cfg.num_layers) if xlstm.is_slstm(cfg, i)]
    assert slstm == ([5, 11] if which == "full" else [1, 3])
    gen = torch.Generator().manual_seed(0)

    def dense(shape, scale=None, dtype=None):
        dtype = dtype or transformer.DTYPES[cfg.dtype]
        return torch.empty(shape, dtype=dtype) if which == "full" else \
            torch.randn(shape, generator=gen).to(dtype)

    for fn, ref_fn in ((xlstm.mlstm_block_init, RX.mlstm_block_init),
                       (xlstm.slstm_block_init, RX.slstm_block_init)):
        ref = jax.eval_shape(lambda k: RL.split_params(ref_fn(k, cfg_ref))[0],
                             jax.random.PRNGKey(0))
        mine = fn(cfg, dense, lambda n: torch.ones(n), "cpu")
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in mine.items()}
        want = {k: (tuple((v["scale"] if isinstance(v, dict) else v).shape),
                    str((v["scale"] if isinstance(v, dict) else v).dtype))
                for k, v in ref.items()}
        assert got == want, fn.__name__
    for i in (0, slstm[0]):
        want = jax.tree.map(np.asarray, RX.xlstm_cache_init(
            cfg_ref, i, 2, jnp.float32))
        got = xlstm.xlstm_cache_init(cfg, i, 2, torch.float32, "cpu")
        kind = "slstm" if i in slstm else "mlstm"
        for k, w in _flat_ref(kind, want).items():
            np.testing.assert_array_equal(got[k].numpy(), w)
