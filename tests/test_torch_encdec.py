"""The encoder-decoder (whisper-small's backbone) of the port
(``repro_torch.models.encdec``) against the JAX package's
``repro.models.encdec``, on the CPU, at the smoke config.

* ``configs.get`` / ``get_smoke`` field for field under both names.
* ``init``'s leaves in the reference's shapes and dtypes, and
  ``params_from_numpy`` of the reference's tree (the adapter, the stacked
  encoder and decoder, the ``{"scale", "bias"}`` LayerNorms, the tied
  embedding and the learned positions).
* ``layer_norm`` and ``sinusoidal``; ``encode`` and ``decode_hidden`` (a
  full forward without caches) on the reference's weights.
* A prefill of 4 tokens through ``engine.encdec_prefill``, then one-token
  steps over the caches, each hidden state equal to the full forward's at
  that position (the reference's ``tests/test_models.py``'s check), and
  the caches against the reference's ``encdec_prefill``; the lockstep
  ``encdec_decode_step``'s tokens under the reference's noise.
* ``loss_fn`` and every gradient leaf against the reference's
  ``value_and_grad``; AdamW's decay mask against ``p.ndim >= 2`` on the
  reference's stacked leaves.

Tolerances: float32; the packages compute the same math with other
contraction orders, so float results agree to rtol 1e-5 and atol 1e-5 ·
max|reference| (``_close``; through 2 + 2 layers, 1e-4), the loss to rtol
1e-5 and the gradients to ``tests/test_torch_training.py``'s rtol 1e-4,
atol 1e-5 of each leaf's largest entry.  The reference's own
prefill-against-forward check allows 5e-3; the port's is held at 1e-4.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import encdec as RED  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

from test_torch_training import _grad_close, _trees_close  # noqa: E402

ARCH = "whisper_small"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30))


@functools.lru_cache(maxsize=None)
def _models():
    """(reference params, reference cfg, port params, port cfg) of the
    smoke config: the same weights, from the reference's ``init``."""
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    params_ref = jax.jit(lambda key: RL.split_params(
        RED.init(key, cfg_ref))[0])(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, params_ref),
                               device="cpu")
    return params_ref, cfg_ref, params, cfg


def _inputs(cfg, seed=0, b=2, t=10):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.encoder_seq_len, cfg.d_model)
                                 ).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, t))
    return frames, tokens


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_configs_match_reference(which):
    ref = getattr(ref_configs, which)(ARCH)
    for name in (ARCH, "whisper-small"):
        mine = getattr(configs, which)(name)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert ref.family == "encdec" and ref.tie_embeddings


def test_init_and_convert_match_reference_layout():
    """The port's seeded ``init`` and the converted reference weights
    have the same paths, shapes and dtypes (fp32 LayerNorms, model-dtype
    projections); the learned positions are drawn at 0.02."""
    params_ref, _, conv, cfg = _models()
    mine = encdec.init(cfg, seed=0, device="cpu")
    a = {p: (tuple(x.shape), x.dtype) for p, x in tree.leaves_with_path(mine)}
    b = {p: (tuple(x.shape), x.dtype) for p, x in tree.leaves_with_path(conv)}
    assert a == b
    assert len(mine["encoder"]) == cfg.encoder_layers
    assert len(mine["decoder"]) == cfg.num_layers
    assert set(mine["decoder"][0]["ln1"]) == {"scale", "bias"}
    assert mine["pos_embed"].shape == (cfg.max_seq_len, cfg.d_model)
    assert 0.015 < float(mine["pos_embed"].std()) < 0.025
    np.testing.assert_array_equal(
        conv["decoder"][1]["cross_attn"]["wk"].numpy(),
        np.asarray(params_ref["decoder"]["cross_attn"]["wk"][1]))
    bf = encdec.init(configs.get_smoke(ARCH).replace(dtype="bfloat16"),
                     seed=0, device="cpu")
    assert bf["decoder"][0]["lnx"]["bias"].dtype == torch.float32
    assert bf["adapter"].dtype == torch.bfloat16


def test_layer_norm_and_sinusoidal_match_reference():
    rng = np.random.default_rng(4)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = RL.layer_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 1e-5)
    got = L.layer_norm({k: _t(v) for k, v in p.items()}, _t(x), 1e-5)
    _close(got.numpy(), want)
    _close(encdec.sinusoidal(512, 64).numpy(), RED.sinusoidal(512, 64))


def test_encode_and_decode_hidden_match_reference():
    """The encoder over the smoke window (64 frames), then the decoder's
    full forward over 10 tokens against it, without caches."""
    params_ref, cfg_ref, params, cfg = _models()
    frames, tokens = _inputs(cfg)
    enc_ref = jax.jit(lambda p, f: RED.encode(p, f, cfg_ref))(
        params_ref, jnp.asarray(frames))
    hid_ref, _ = jax.jit(lambda p, t, e: RED.decode_hidden(p, t, e, cfg_ref))(
        params_ref, jnp.asarray(tokens), enc_ref)
    with torch.no_grad():
        enc = encdec.encode(params, _t(frames), cfg)
        hid, caches = encdec.decode_hidden(params, _t(tokens), enc, cfg)
    assert caches is None and enc.shape == (2, 64, 64)
    _close(enc.numpy(), enc_ref, 1e-4)
    _close(hid.numpy(), hid_ref, 1e-4)


def test_prefill_then_decode_equals_full_forward():
    """``encdec_prefill`` of 4 tokens, then 6 one-token steps over its
    caches: each step's hidden state equals the full forward's at that
    position; the prefill's caches equal the reference's (self K/V at the
    4 positions, the cross K/V of all 64 frames, per layer)."""
    params_ref, cfg_ref, params, cfg = _models()
    frames, tokens = _inputs(cfg, seed=1)
    t, p = 10, 4
    _, caches_ref, _ = jax.jit(lambda pr, f, tk: RE.encdec_prefill(
        pr, f, tk, cfg_ref, max_len=t))(params_ref, jnp.asarray(frames),
                                        jnp.asarray(tokens[:, :p]))
    with torch.no_grad():
        enc = encdec.encode(params, _t(frames), cfg)
        full, _ = encdec.decode_hidden(params, _t(tokens), enc, cfg)
        last, caches, length = engine.encdec_prefill(
            params, _t(frames), _t(tokens[:, :p]), cfg, max_len=t)
        assert length == p
        _close(last.numpy(), full[:, p - 1].numpy(), 1e-4)
        for name, ref in (("self_k", caches_ref["self"]["k"]),
                          ("self_v", caches_ref["self"]["v"]),
                          ("cross_k", caches_ref["cross"]["k"]),
                          ("cross_v", caches_ref["cross"]["v"])):
            assert caches[name].shape == ref.shape, name
            _close(caches[name].numpy(), ref, 1e-4)
        for i in range(p, t):
            h1, caches = encdec.decode_hidden(
                params, _t(tokens[:, i:i + 1]), None, cfg, caches=caches,
                cache_len=i)
            _close(h1[:, 0].numpy(), full[:, i].numpy(), 1e-4)


def test_lockstep_decode_steps_match_reference():
    """``encdec_prefill`` of a BOS row, then three lockstep
    ``encdec_decode_step``s (the reference's dry-run decode), each
    sampling under the reference's Gumbel draw for its key: the token ids
    equal the reference's step for step."""
    params_ref, cfg_ref, params, cfg = _models()
    frames, _ = _inputs(cfg, seed=3)
    bos = np.zeros((2, 1), np.int64)
    step_ref = jax.jit(lambda pr, c, ln, tk, rng: RE.encdec_decode_step(
        pr, c, ln, tk, cfg_ref, rng=rng, top_k=5))
    _, caches_ref, ln_ref = jax.jit(lambda pr, f, tk: RE.encdec_prefill(
        pr, f, tk, cfg_ref, max_len=8))(params_ref, jnp.asarray(frames),
                                        jnp.asarray(bos))
    with torch.no_grad():
        _, caches, length = engine.encdec_prefill(params, _t(frames),
                                                  _t(bos), cfg, max_len=8)
    tok_ref, tok = jnp.asarray(bos[:, 0]), _t(bos[:, 0])
    got, want = [], []
    for i in range(3):
        rng = jax.random.PRNGKey(11 + i)
        tok_ref, caches_ref, ln_ref = step_ref(params_ref, caches_ref, ln_ref,
                                               tok_ref[:, None], rng)
        noise = _t(jax.random.gumbel(rng, (2, 5), jnp.float32))
        with torch.no_grad():
            tok, caches, length = engine.encdec_decode_step(
                params, caches, length, tok[:, None], cfg, noise=noise)
        got.append(tok.tolist())
        want.append(np.asarray(tok_ref).tolist())
    assert got == want and length == 4


def test_loss_and_grads_match_reference():
    """``loss_fn`` (masked labels, the tied embedding's two gradients) and
    every gradient leaf, the adapter, the encoder and the cross-attention
    among them, against the reference's ``value_and_grad``."""
    params_ref, cfg_ref, params, cfg = _models()
    frames, tokens = _inputs(cfg, seed=2, t=12)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, :3] = -1
    batch = {"frames": frames, "tokens": tokens, "labels": labels}
    (ref_loss, ref_m), ref_grads = jax.jit(jax.value_and_grad(
        lambda pr: RED.loss_fn(pr, jax.tree.map(jnp.asarray, batch),
                               cfg_ref), has_aux=True))(params_ref)
    p = tree.map(lambda x: x.clone().requires_grad_(True), params)
    loss, metrics = encdec.loss_fn(p, {k: _t(v) for k, v in batch.items()},
                                   cfg)
    grads = torch.autograd.grad(loss, tree.leaves(p))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert set(metrics) == set(ref_m)
    _trees_close(tree.unflatten(p, grads), ref_grads,
                 lambda got, want, path: _grad_close(got, want, path))
    by_path = dict(zip((path for path, _ in tree.leaves_with_path(p)),
                       grads))
    for path in ("adapter", "encoder/0/attn/wq", "decoder/1/cross_attn/wk",
                 "decoder/0/lnx/bias", "pos_embed"):
        assert by_path[path].abs().max() > 0, path


def test_weight_decay_mask_matches_reference():
    """``adamw.decays`` marks a port leaf exactly where the reference's
    AdamW decays its leaf (``p.ndim >= 2`` on the stacked encoder and
    decoder): every per-layer leaf, the LayerNorms among them; of the
    unstacked leaves the adapter, embedding and positions, not
    ``enc_norm`` / ``dec_norm``."""
    params_ref, _, params, _ = _models()
    marks = jax.tree.map(
        lambda a: np.full(a.shape, float(np.ndim(a) >= 2), np.float32),
        params_ref)
    got = dict(tree.leaves_with_path(params_from_numpy(marks,
                                                       device="cpu")))
    for path, x in tree.leaves_with_path(params):
        assert got[path].all() == got[path].any(), path
        assert adamw.decays(path, x) == bool(got[path].all()), path
    assert adamw.decays("decoder/0/ln1/scale", params["decoder"][0]["ln1"]
                        ["scale"])
    assert not adamw.decays("dec_norm/scale", params["dec_norm"]["scale"])
