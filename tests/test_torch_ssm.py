"""The Mamba2 (SSD) block of the port (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm``, on the CPU.

* ``ssd_chunked`` with and without an initial state, at T below the chunk
  and at T a multiple of it; ``ssd_decode_step``; ``causal_conv`` with and
  without a carried state.
* ``mamba2_apply`` on the reference's weights (``mamba2_init``, carried
  through the port's converter): a prefill, then decode steps from the
  state it left, each output and state against the reference's.
* The port against itself: ``ssd_chunked`` over T equals T decode steps.
* ``mamba2_init``'s shapes, dtypes and ``dt_bias`` against the
  reference's; a scan length that does not divide into the chunk raises.

Inputs are drawn from a seeded numpy generator and fed to both packages.
Tolerances: float32 everywhere; the packages compute the same math with
other contraction orders, so results agree to rtol 1e-5 and atol 1e-5 ·
max|reference| (``_close``), except the scan against its own decode steps
(two summation orders of a 32-step recurrence: 1e-4).
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import ssm as RSSM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.convert import _leaf  # noqa: E402

ARCH = "zamba2_1p2b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30))


def _ssd_inputs(seed, b=2, t=16, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((b, t, h, p)).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(f),
        a_log=(0.3 * rng.standard_normal(h)).astype(f),
        b=rng.standard_normal((b, t, n)).astype(f),
        c=rng.standard_normal((b, t, n)).astype(f),
        d_skip=rng.standard_normal(h).astype(f))


@pytest.mark.parametrize("t", [6, 32], ids=["below_chunk", "two_chunks"])
@pytest.mark.parametrize("with_init", [False, True],
                         ids=["zero_state", "init_state"])
def test_ssd_chunked_matches_reference(t, with_init):
    """The chunked scan at chunk 16 over T 6 (one short chunk) and T 32
    (two chunks), from zeros or from a given state: outputs and final
    states."""
    a = _ssd_inputs(0, t=t)
    init = (np.random.default_rng(1).standard_normal((2, 3, 5, 4))
            .astype(np.float32) if with_init else None)
    want_y, want_s = jax.jit(functools.partial(RSSM.ssd_chunked, chunk=16))(
        *(jnp.asarray(a[k]) for k in ("x", "dt", "a_log", "b", "c",
                                      "d_skip")),
        init_state=None if init is None else jnp.asarray(init))
    got_y, got_s = ssm.ssd_chunked(
        *(_t(a[k]) for k in ("x", "dt", "a_log", "b", "c", "d_skip")),
        chunk=16, init_state=None if init is None else _t(init))
    assert got_y.shape == (2, t, 3, 4) and got_s.dtype == torch.float32
    _close(got_y.numpy(), want_y)
    _close(got_s.numpy(), want_s)


def test_ssd_decode_step_matches_reference():
    a = _ssd_inputs(2, t=1)
    state = np.random.default_rng(3).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    args = [a["x"][:, 0], a["dt"][:, 0], a["a_log"], a["b"][:, 0],
            a["c"][:, 0], a["d_skip"]]
    want_y, want_s = RSSM.ssd_decode_step(jnp.asarray(state),
                                          *map(jnp.asarray, args))
    got_y, got_s = ssm.ssd_decode_step(_t(state), *map(_t, args))
    _close(got_y.numpy(), want_y)
    _close(got_s.numpy(), want_s)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["padded", "carried"])
@pytest.mark.parametrize("t", [1, 7])
def test_causal_conv_matches_reference(with_state, t):
    """The shift-add conv of width 4 over T 1 and 7, from zero padding or
    a carried tail of 3: outputs and the new tail."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, t, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    want_y, want_s = RSSM.causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        state=jnp.asarray(st) if with_state else None)
    got_y, got_s = ssm.causal_conv(_t(x), _t(w),
                                   state=_t(st) if with_state else None)
    _close(got_y.numpy(), want_y)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@functools.lru_cache(maxsize=None)
def _block():
    """(reference weights, its cfg, the port's weights, its cfg) of one
    Mamba2 block of the smoke config, from the reference's
    ``mamba2_init``."""
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    p_ref, _ = RL.split_params(RSSM.mamba2_init(jax.random.PRNGKey(5),
                                                cfg_ref))
    # the smoke init's a_log is zeros: give the heads distinct decays
    p_ref["a_log"] = jnp.linspace(-1.0, 1.0, p_ref["a_log"].shape[0])
    port = _leaf(jax.tree.map(np.asarray, p_ref), None, "cpu")
    return p_ref, cfg_ref, port, cfg


def test_mamba2_apply_prefill_then_decode_matches_reference():
    """``mamba2_apply``: a 16-token prefill without a cache (the chunked
    scan), then three decode steps from the state it left, each step's
    output and new state (``ssm``, the three conv tails) against the
    reference's; the port writes the state into the given cache in
    place."""
    p_ref, cfg_ref, p, cfg = _block()
    x = np.random.default_rng(6).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    want, ref_cache = RSSM.mamba2_apply(p_ref, jnp.asarray(x[:, :16]),
                                        cfg_ref)
    got, cache = ssm.mamba2_apply(p, _t(x[:, :16]), cfg)
    _close(got.numpy(), want)
    for k in ssm.CACHE_LEAVES:
        _close(cache[k].numpy(), ref_cache[k])
    cache = {k: v.clone() for k, v in cache.items()}
    for i in range(16, 19):
        want, ref_cache = RSSM.mamba2_apply(p_ref, jnp.asarray(x[:, i:i + 1]),
                                            cfg_ref, cache=ref_cache)
        got, new = ssm.mamba2_apply(p, _t(x[:, i:i + 1]), cfg, cache=cache)
        _close(got.numpy(), want)
        for k in ssm.CACHE_LEAVES:
            assert torch.equal(cache[k], new[k])       # written in place
            _close(cache[k].numpy(), ref_cache[k])


def test_ssd_chunked_equals_decode_steps():
    """The port against itself: the chunked scan over 32 steps (two
    chunks, from a given state) equals 32 decode steps."""
    a = {k: _t(v) for k, v in _ssd_inputs(7, t=32).items()}
    state = _t(np.random.default_rng(8).standard_normal((2, 3, 5, 4))
               .astype(np.float32))
    y, s_final = ssm.ssd_chunked(a["x"], a["dt"], a["a_log"], a["b"],
                                 a["c"], a["d_skip"], chunk=16,
                                 init_state=state)
    s = state
    for i in range(32):
        yi, s = ssm.ssd_decode_step(s, a["x"][:, i], a["dt"][:, i],
                                    a["a_log"], a["b"][:, i], a["c"][:, i],
                                    a["d_skip"])
        _close(yi.numpy(), y[:, i].numpy(), rtol=1e-4)
    _close(s.numpy(), s_final.numpy(), rtol=1e-4)


@pytest.mark.parametrize("which", ["smoke", "full"])
def test_mamba2_init_shapes_match_reference(which):
    """The port's ``mamba2_init`` draws the reference's leaves in its
    shapes and dtypes (fp32 conv weights, ``dt_bias``, ``a_log``,
    ``d_skip``, ``norm``), with the same ``dt_bias`` and, at full width,
    64 heads of state N 64 by P 64; the full config is only shaped, not
    drawn."""
    get = "get_smoke" if which == "smoke" else "get"
    cfg_ref, cfg = (getattr(ref_configs, get)(ARCH),
                    getattr(configs, get)(ARCH))
    ref = jax.eval_shape(lambda k: RL.split_params(
        RSSM.mamba2_init(k, cfg_ref))[0], jax.random.PRNGKey(0))
    if which == "full":
        cache = jax.eval_shape(lambda: RSSM.mamba2_cache_init(
            cfg_ref, 1, jnp.bfloat16))
        assert cache["ssm"].shape == (1, 64, 64, 64)
        return
    gen = torch.Generator().manual_seed(0)

    def dense(shape, scale=None, dtype=None):
        dtype = dtype or transformer.DTYPES[cfg.dtype]
        return torch.randn(shape, generator=gen).to(dtype)

    mine = ssm.mamba2_init(cfg, dense, lambda n: torch.ones(n), "cpu")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in mine.items()}
    want = {k: (tuple(v["scale"].shape if isinstance(v, dict) else v.shape),
                str((v["scale"] if isinstance(v, dict) else v).dtype))
            for k, v in ref.items()}
    assert got == want
    real = RL.split_params(RSSM.mamba2_init(jax.random.PRNGKey(0),
                                            cfg_ref))[0]
    np.testing.assert_array_equal(mine["dt_bias"].numpy(),
                                  np.asarray(real["dt_bias"]))
    with pytest.raises(ValueError, match="multiple of it"):
        a = _ssd_inputs(9, t=20)
        ssm.ssd_chunked(*(_t(a[k]) for k in ("x", "dt", "a_log", "b", "c",
                                             "d_skip")), chunk=16)
