"""The VLM llava-next-34b in the port against the JAX package, on the
CPU, at the smoke config (2 layers, d_model 64, 4/2 heads of 16, 16
patches).

* ``configs.get`` / ``get_smoke`` field for field under both names; every
  architecture of the reference's registry is now in the port's.
* ``init`` draws ``mm_proj`` [D, D] at 1/sqrt(D); ``params_from_numpy``
  carries the reference's across, leaf for leaf.
* ``forward`` with patch embeddings (projected and prepended, positions
  over P + T) and without them; ``loss_fn`` and every gradient,
  ``mm_proj``'s included, with patches (the P positions dropped before
  the CE) and without (``mm_proj``'s gradient zero in both packages).
* Two AdamW steps through ``make_train_step`` on a patch batch (the
  dry-run's shape) and on the text alone (the training CLI's stream);
  the text-only CLI run itself, whose ``mm_proj`` moves by weight decay
  alone.
* ``engine.prefill(patch_embeds=)``: the last hidden state, the caches
  and ``cache_len = T + P``.
* The lockstep loop under the reference's prompts, patches and Gumbel
  draws: the token stream equals the reference's ``prefill`` /
  ``decode_step``.
* ``launch.serve --continuous`` refuses a model with patches, word for
  word as the reference's ``main``; ``obs.kernels.decode_step_cost``
  gives a VLM step a dense decoder's cost.

Tolerances: float32 throughout; the packages compute the same math with
other contraction orders.  Hidden states and caches within rtol 1e-5 and
1e-5 of the reference's largest entry; losses within rtol 1e-5; gradients
and moments ``tests/test_torch_training.py``'s rtol 1e-4 and 1e-5 of each
leaf's largest entry; parameters after n steps within 2·lr·n with at most
1 % of entries past 1e-5; token streams exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.core import topk_sample as ref_topk_sample  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ParallelConfig, RunConfig)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import (adamw_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.obs import kernels as obs_kernels  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.training import train_step  # noqa: E402

from test_torch_training import (_batch, _grad_close, _lr_close,  # noqa: E402
                                 _np, _port, _trees_close)

ARCH = "llava_next_34b"
TOP_K = 5
LR = 1e-3


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
    smoke config: the reference's ``init`` carried across, the embedding
    scaled down so the smoke model's streams do not repeat their input."""
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    params_ref, _ = RL.split_params(RT.init(jax.random.PRNGKey(0), cfg_ref))
    params_ref["embedding"]["embed"] = params_ref["embedding"]["embed"] * 0.05
    return (params_ref, cfg_ref,
            params_from_numpy(jax.tree.map(np.asarray, params_ref),
                              device="cpu"), cfg)


def _patches(cfg, b=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_patches, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b=2, t=10, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_configs_match_reference(which):
    ref = getattr(ref_configs, which)(ARCH)
    for name in (ARCH, "llava-next-34b"):
        mine = getattr(configs, which)(name)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert ref.family == "vlm" and not ref.tie_embeddings
    assert ref.num_patches == (16 if which == "get_smoke" else 2880)
    assert transformer.block_pattern(getattr(configs, which)(ARCH)) == [
        ("dense", ref.num_layers)]


def test_every_reference_arch_is_ported():
    assert sorted(configs.ARCHS) == sorted(ref_configs.ARCHS)
    for arch in ref_configs.ARCHS:
        assert configs.get(arch).name == ref_configs.get(arch).name


def test_init_and_convert_carry_mm_proj():
    """The port's seeded ``init`` and the converted reference weights
    have the same leaves; ``mm_proj`` [D, D] in the model dtype, drawn at
    1/sqrt(D), carried across bit for bit; a text model has none."""
    params_ref, _, conv, cfg = _models()
    mine = transformer.init(cfg, seed=0, device="cpu")
    a = {p: (tuple(x.shape), x.dtype) for p, x in tree.leaves_with_path(mine)}
    b = {p: (tuple(x.shape), x.dtype) for p, x in tree.leaves_with_path(conv)}
    assert a == b and a["mm_proj"] == ((64, 64), torch.float32)
    np.testing.assert_array_equal(conv["mm_proj"].numpy(),
                                  np.asarray(params_ref["mm_proj"]))
    assert 0.8 / 8 < float(mine["mm_proj"].std()) < 1.2 / 8
    bf = transformer.init(cfg.replace(dtype="bfloat16"), seed=0,
                          device="cpu")
    assert bf["mm_proj"].dtype == torch.bfloat16
    assert "mm_proj" not in transformer.init(configs.get_smoke(
        "deepseek_coder_33b"), seed=0, device="cpu")


@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text"])
def test_forward_matches_reference(with_patches):
    """Hidden states [B, P + T, D] with patches (the patch positions
    first), [B, T, D] without, against the reference's ``forward``."""
    params_ref, cfg_ref, params, cfg = _models()
    toks = _tokens(cfg)
    pe = _patches(cfg) if with_patches else None
    want, _, _ = jax.jit(lambda p, t, e: RT.forward(p, t, cfg_ref,
                                                    patch_embeds=e))(
        params_ref, jnp.asarray(toks),
        None if pe is None else jnp.asarray(pe))
    with torch.no_grad():
        got, _ = transformer.forward(params, _t(toks), cfg,
                                     patch_embeds=None if pe is None
                                     else _t(pe))
    assert got.shape == (2, 10 + (16 if with_patches else 0), 64)
    _close(got.numpy(), want)


@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text"])
def test_loss_and_grads_match_reference(with_patches):
    """``loss_fn`` (masked labels; the patch positions dropped) and every
    gradient leaf through the train step's ``_value_and_grad`` against
    the reference's ``value_and_grad``: ``mm_proj``'s is nonzero with
    patches, and zero without them in both packages."""
    params_ref, cfg_ref, params, cfg = _models()
    batch = _batch(cfg, seq=12, gb=2)
    if with_patches:
        batch["patch_embeds"] = _patches(cfg, seed=4)
    (ref_loss, ref_m), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, jax.tree.map(jnp.asarray, batch), cfg_ref),
        has_aux=True))(params_ref)
    loss, metrics, grads = train_step._value_and_grad(
        _port(params_ref), {k: _t(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert set(metrics) == set(ref_m)
    _trees_close(grads, ref_grads,
                 lambda got, want, path: _grad_close(got, want, path))
    assert bool(grads["mm_proj"].abs().max() > 0) == with_patches
    assert bool(np.abs(np.asarray(ref_grads["mm_proj"])).max() > 0) == \
        with_patches


@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text"])
def test_train_steps_match_reference(with_patches):
    """Two AdamW steps from the reference's weights and optimizer state,
    on a patch batch or on the text alone: loss and grad norm each step,
    the first moments after the first, then the parameters (``mm_proj``
    among them) after both."""
    _, cfg_ref, _, cfg = _models()
    opt = dict(lr=LR, warmup_steps=2, total_steps=10)
    par = dict(grad_reduce_dtype="float32")
    ref_run = RB.RunConfig(model=cfg_ref, optimizer=RB.OptimizerConfig(**opt),
                           parallel=RB.ParallelConfig(**par))
    run = RunConfig(model=cfg, optimizer=OptimizerConfig(**opt),
                    parallel=ParallelConfig(**par))
    ref_params, ref_opt = jax.jit(lambda key: RTS.init_state(
        RB.RunConfig(model=cfg_ref), key)[:2])(jax.random.PRNGKey(0))
    params = _port(ref_params)
    opt_state = adamw_state_from_numpy(_np(ref_opt), device="cpu")
    ref_step = jax.jit(RTS.make_train_step(ref_run))
    step = train_step.make_train_step(run)
    for i in range(2):
        batch = _batch(cfg, seq=12, gb=2, step=i, masked=False)
        if with_patches:
            batch["patch_embeds"] = _patches(cfg, seed=10 + i)
        ref_params, ref_opt, rm = ref_step(
            ref_params, ref_opt, jax.tree.map(jnp.asarray, batch))
        params, opt_state, m = step(params, opt_state,
                                    {k: _t(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        if i == 0:
            _trees_close(opt_state.mu, ref_opt.mu,
                         lambda got, want, path: _grad_close(got, want,
                                                             path))
    _trees_close(params, ref_params, _lr_close(LR, 2))
    assert bool(opt_state.mu["mm_proj"].abs().max() > 0) == with_patches


def test_train_cli_trains_the_text_alone(tmp_path):
    """``launch.train --arch llava_next_34b --smoke --device cpu``, as the
    reference's CLI trains it: the stream has no patches, so ``mm_proj``
    gets zero gradients, its moments stay zero and it moves by weight
    decay alone (``p · Π(1 − lr_t · wd)``); the losses are finite."""
    args = train_cli.parse_args([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
        "--seq-len", "16", "--global-batch", "2", "--checkpoint-every", "0",
        "--checkpoint-dir", str(tmp_path)])
    run = train_cli.run_config(args)
    before = train_step.init_state(run, device="cpu")[0]["mm_proj"].detach()
    params, opt, hist, run = train_cli.train(args, log=lambda *_: None)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert not opt.mu["mm_proj"].any() and not opt.nu["mm_proj"].any()
    decay = np.prod([1 - h["lr"] * run.optimizer.weight_decay for h in hist])
    np.testing.assert_allclose(params["mm_proj"].detach().numpy(),
                               before.numpy() * decay, rtol=1e-6, atol=1e-7)
    assert opt.mu["layers"][0]["attn"]["wq"].abs().max() > 0


def test_prefill_with_patches_matches_reference():
    """``engine.prefill`` of 10 tokens behind 16 patches into caches of
    32: the last hidden state, each layer's K/V at every position, and
    ``cache_len`` 26 = T + P, as the reference's; without patches
    ``cache_len`` is T."""
    params_ref, cfg_ref, params, cfg = _models()
    toks, pe = _tokens(cfg, seed=2), _patches(cfg, seed=3)
    last_ref, caches_ref, n_ref = jax.jit(
        lambda p, t, e: RE.prefill(p, t, cfg_ref, max_len=32,
                                   patch_embeds=e))(
        params_ref, jnp.asarray(toks), jnp.asarray(pe))
    with torch.no_grad():
        last, caches, n = engine.prefill(params, _t(toks), cfg, max_len=32,
                                         patch_embeds=_t(pe))
        _, _, n_text = engine.prefill(params, _t(toks), cfg, max_len=32)
    assert n == int(n_ref) == 26 and n_text == 10
    _close(last.numpy(), last_ref)
    for name in ("k", "v"):
        ref = caches_ref[0]["attn"][name]
        assert caches[name].shape == ref.shape == (2, 2, 32, 2, 16)
        _close(caches[name].numpy(), ref)


def test_lockstep_stream_matches_reference():
    """The lockstep loop from the reference CLI's prompts
    (``randint(PRNGKey(1))``), patches (``normal(PRNGKey(2))``) and Gumbel
    draws (``PRNGKey(3)`` after the prefill, ``fold_in(PRNGKey(0), i)``
    after decode step i) gives the reference's ``prefill`` /
    ``decode_step`` tokens, over caches of ``max_len + P``."""
    params_ref, cfg_ref, params, cfg = _models()
    b, t, n = 3, 12, 6
    args = serve.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", str(b), "--prompt-len", str(t),
                             "--tokens", str(n)])
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (b, t), 0,
                                            cfg.vocab_size))
    patches = np.asarray(jax.random.normal(
        jax.random.PRNGKey(2), (b, cfg.num_patches, cfg.d_model),
        jnp.float32))
    base = jax.random.PRNGKey(0)

    def noise(step):
        key = (jax.random.PRNGKey(3) if step == 0
               else jax.random.fold_in(base, step - 1))
        return np.asarray(jax.random.gumbel(key, (b, TOP_K), jnp.float32))

    ids = serve.lockstep(args, cfg, params, prompts=prompts, patches=patches,
                         noise_fn=noise)
    last, caches, length = RE.prefill(
        params_ref, jnp.asarray(prompts), cfg_ref,
        max_len=t + n + cfg.num_patches, patch_embeds=jnp.asarray(patches))
    logits = RT.logits_last(params_ref, last[:, None], cfg_ref)
    tok, _ = ref_topk_sample(jax.random.PRNGKey(3), logits, TOP_K)
    want = [np.asarray(tok)]
    for i in range(n - 1):
        tok, caches, length = RE.decode_step(
            params_ref, caches, length, tok[:, None], cfg_ref,
            rng=jax.random.fold_in(base, i), top_k=TOP_K)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))
    assert int(length) == t + n - 1 + cfg.num_patches
    assert len(set(ids.ravel().tolist())) > 1


def test_continuous_refused_as_the_reference():
    """``--continuous`` with a patch model exits with the reference's
    message, in both packages, before any weight is drawn."""
    argv = ["--arch", ARCH, "--smoke", "--continuous"]
    with pytest.raises(SystemExit) as ref:
        ref_serve.main(argv)
    with pytest.raises(SystemExit) as mine:
        serve.main(argv + ["--device", "cpu"])
    assert str(mine.value) == str(ref.value) == (
        "continuous batching serves text-only archs for now")


def test_decode_step_cost_is_a_dense_decoders():
    """A llava decode step costs what the same stack as a dense text
    decoder costs: the patches enter at the prefill only."""
    cfg = configs.get(ARCH)
    lens = [2960, 2960]
    got = obs_kernels.decode_step_cost(cfg, 2, lens)
    want = obs_kernels.decode_step_cost(
        cfg.replace(family="dense", num_patches=0), 2, lens)
    assert got == want
    per_layer = 2 * (7168 * 56 * 128 + 2 * 7168 * 8 * 128 + 56 * 128 * 7168
                     + 3 * 7168 * 20480)
    assert got["bytes_accessed"] > 60 * per_layer
