"""The MLA decoder (minicpm3-4b) in the port against the JAX package, on the
CPU.

* ``configs.get`` / ``get_smoke``, field for field, ``MLAConfig`` included.
* ``init`` draws the MLA leaves in the reference's shapes (fp32 norms), and
  ``params_from_numpy`` carries the reference's across.
* ``layers.mla_apply`` against ``repro.models.layers.mla_apply`` on the same
  weights and inputs: without a cache (the decompressed training form), a
  cached prefill chunk at per-row offsets and a decode step at ragged
  ``cache_len``, outputs and written latents within 1e-5.
* ``transformer.forward`` / ``logits_last`` and ``loss_fn`` (the plain
  forms on the CPU), the latent cache after a prefill, and the reference's
  prefill-then-decode consistency in the port.
* The smoke config served: the slot pool, its int8 form (fp latents, single
  shot) and the lockstep loop give the reference's token streams under its
  noise, and the CLI's counter lines equal the reference CLI's; ``--paged``
  and ``engine.init_paged_cache`` raise the reference's ``ValueError``.
* The kernels' plain versions (``flash_decode_mla_plain``,
  ``flash_attention_mla_plain``) equal concatenate + ``online_attention``
  at 96^-0.5 with the rows past each valid length NaN, vlen 0 giving 0; the
  decode planner (a pure function); ``decode_step_cost`` against a hand
  count; ``launch.train`` taking CUDA for MLA (no refusal) and training on
  the CPU.

Tolerances: float32 everywhere; the packages compute the same math with
other matmul kernels and summation orders, so float results agree to
~1e-5 (atol 1e-5 · max|ref|, rtol 1e-5) and token streams exactly.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.core import topk_sample as ref_topk_sample  # noqa: E402
from repro.launch import serve as RSV  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.attention import online_attention  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_mla as fm  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs import kernels as obs_kernels  # noqa: E402
from repro_torch.serving import cache_family, engine, scheduler  # noqa: E402

ARCH = "minicpm3_4b"
TOP_K = 5
BASE_KEY = jax.random.PRNGKey(0)
SLOT_LEN, CHUNK = 40, 8
H100_SMS = 132
SCALE = 96 ** -0.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    """Within atol 1e-5 · max|want| and rtol 1e-5."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()),
                                               1e-30))


def ref_noise(rid, i, k):
    """The reference scheduler's per-(request, token) Gumbel draw."""
    key = jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)
    return np.asarray(jax.random.gumbel(key, (k,), jnp.float32))


@functools.partial(jax.jit, static_argnums=1)
def _ref_init(key, cfg_ref):
    return RL.split_params(RT.init(key, cfg_ref))[0]


@functools.lru_cache(maxsize=None)
def _models():
    """(reference params, reference cfg, port params, port cfg) of the smoke
    config: the same weights, from the reference's ``transformer.init``,
    the embedding scaled down so the smoke model's streams do not repeat
    their input token."""
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    params_ref = _ref_init(jax.random.PRNGKey(0), cfg_ref)
    params_ref["embedding"]["embed"] = params_ref["embedding"]["embed"] * 0.05
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), cfg


@pytest.fixture(scope="module")
def model():
    return _models()


def _mla_leaves(seed=3):
    """One MLA layer's weights from the reference's ``mla_init``: (the
    reference's tree, its cfg, the port's dict, the port's cfg)."""
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    p_ref, _ = RL.split_params(RL.mla_init(jax.random.PRNGKey(seed), cfg_ref))
    port = {k: _t(v["scale"] if isinstance(v, dict) else v)
            for k, v in jax.tree.map(np.asarray, p_ref,
                                     is_leaf=lambda x: not isinstance(
                                         x, dict)).items()}
    return p_ref, cfg_ref, port, cfg


# ---------------------------------------------------------------------------
# Configs, init and convert.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_configs_match_reference(which):
    """Both names (module and alias) give the reference's numbers, field
    for field, the ``MLAConfig`` included."""
    ref = getattr(ref_configs, which)(ARCH)
    for name in (ARCH, "minicpm3-4b"):
        mine = getattr(configs, which)(name)
        for f in dataclasses.fields(mine):
            if f.name == "mla":
                assert dataclasses.asdict(mine.mla) == \
                    dataclasses.asdict(ref.mla)
            else:
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert isinstance(mine.mla, configs.MLAConfig)


def test_full_config_size():
    """minicpm3-4b at full width and depth: 4.263e9 parameters (8.53 GB of
    bf16), the shapes ``init`` would draw, counted without drawing."""
    cfg = configs.get(ARCH)
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    attn = (d * m.q_lora_rank + m.q_lora_rank
            + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            + h * m.v_head_dim * d)
    layer = attn + 3 * d * cfg.d_ff + 2 * d
    total = cfg.num_layers * layer + 2 * cfg.vocab_size * d + d
    assert round(total / 1e9, 3) == 4.263
    small = cfg.replace(num_layers=1, vocab_size=256, real_vocab_size=0,
                        d_ff=8)
    p = transformer.init(small, seed=0, device="cpu")
    got = {k: tuple(v.shape) for k, v in p["layers"][0]["attn"].items()}
    assert got == {"wdq": (d, 768), "q_norm": (768,), "wuq": (768, h * 96),
                   "wdkv": (d, 288), "kv_norm": (256,),
                   "wuk": (256, h * 64), "wuv": (256, h * 64),
                   "wo": (h * 64, d)}
    assert sum(v.numel() for v in p["layers"][0]["attn"].values()) == attn


def test_init_draws_the_mla_leaves_like_the_reference(model):
    """The port's ``init`` draws every leaf the reference's does, in its
    shapes, scale 1/sqrt(the first axis) and fp32 ``q_norm`` / ``kv_norm``
    ones; ``params_to`` keeps those fp32 in a bf16 copy; and
    ``params_from_numpy`` carries the reference's values across."""
    params_ref, _, params, cfg = model
    mine = transformer.init(cfg, seed=0, device="cpu")
    seg = params_ref["segments"][0]
    for i, layer in enumerate(mine["layers"]):
        for k, w in layer["attn"].items():
            ref = np.asarray(seg["attn"][k]["scale"] if k.endswith("norm")
                             else seg["attn"][k])[i]
            assert tuple(w.shape) == ref.shape, k
            np.testing.assert_array_equal(params["layers"][i]["attn"][k],
                                          ref)
            if k.endswith("norm"):
                assert torch.equal(w, torch.ones_like(w))
            else:
                assert abs(w.std().item() * np.sqrt(w.shape[0]) - 1) < 0.2, k
    big = transformer.params_to(mine, "cpu", torch.bfloat16)
    assert big["layers"][0]["attn"]["q_norm"].dtype == torch.float32
    assert big["layers"][0]["attn"]["kv_norm"].dtype == torch.float32
    assert big["layers"][0]["attn"]["wuk"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# mla_apply against the reference.
# ---------------------------------------------------------------------------
def test_mla_apply_without_cache_matches_reference():
    """The decompressed form (K = [c·W_uk, k_rope], V = c·W_uv, Dqk 24,
    Dv 16 at smoke size) over a fresh causal sequence."""
    p_ref, cfg_ref, p, cfg = _mla_leaves()
    x = np.random.default_rng(0).standard_normal(
        (2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11)
    want, _ = RL.mla_apply(p_ref, jnp.asarray(x), cfg_ref,
                           positions=jnp.asarray(pos))
    got, cache = L.mla_apply(p, _t(x), cfg, positions=_t(pos))
    assert cache is None
    _close(got.numpy(), want)


def _latent_caches(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return (rng.standard_normal((b, s, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((b, s, m.qk_rope_head_dim)).astype(
                np.float32))


@pytest.mark.parametrize("t,lens", [(5, [3, 9]), (1, [0, 13])],
                         ids=["prefill_chunk", "decode"])
def test_mla_apply_with_cache_matches_reference(t, lens):
    """A cached prefill chunk of 5 tokens at per-row offsets [3, 9], and a
    decode step at ragged ``cache_len`` [0, 13], over latent caches already
    holding other rows: outputs and the written caches equal the
    reference's."""
    p_ref, cfg_ref, p, cfg = _mla_leaves(seed=5)
    b, s = len(lens), 24
    c0, r0 = _latent_caches(cfg, b, s, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    cl = np.asarray(lens, np.int32)
    pos = cl[:, None] + np.arange(t)
    want, ref_cache = RL.mla_apply(
        p_ref, jnp.asarray(x), cfg_ref, positions=jnp.asarray(pos),
        cache={"c_kv": jnp.asarray(c0), "k_rope": jnp.asarray(r0)},
        cache_len=jnp.asarray(cl))
    cache = {"c_kv": _t(c0), "k_rope": _t(r0)}
    got, out_cache = L.mla_apply(p, _t(x), cfg, positions=_t(pos),
                                 cache=cache, cache_len=_t(cl))
    assert out_cache is cache                       # written in place
    _close(got.numpy(), want)
    for k in ("c_kv", "k_rope"):
        _close(cache[k].numpy(), ref_cache[k])


def test_forward_logits_and_loss_match_reference(model):
    """The full smoke model without a cache: hidden states, the last
    position's logits and ``loss_fn`` (the plain attention forms on the
    CPU, with a gradient) agree with the reference's."""
    params_ref, cfg_ref, params, cfg = model
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 13))
    labels = rng.integers(0, cfg.vocab_size, (2, 13))
    labels[0, :3] = -1
    h_ref, _, _ = RT.forward(params_ref, jnp.asarray(toks), cfg_ref)
    h, _ = transformer.forward(params, _t(toks), cfg)
    _close(h.numpy(), h_ref)
    _close(transformer.logits_last(params, h, cfg).numpy(),
           RT.logits_last(params_ref, h_ref, cfg_ref))
    batch = {"tokens": toks, "labels": labels}
    loss_ref, _ = RT.loss_fn(params_ref, jax.tree.map(jnp.asarray, batch),
                             cfg_ref)
    loss, _ = transformer.loss_fn(params, {k: _t(v) for k, v in
                                           batch.items()}, cfg)
    _close(loss.detach().numpy(), loss_ref)
    wuk = params["layers"][0]["attn"]["wuk"].clone().requires_grad_(True)
    layer0 = {**params["layers"][0],
              "attn": {**params["layers"][0]["attn"], "wuk": wuk}}
    p2 = {**params, "layers": [layer0, *params["layers"][1:]]}
    transformer.loss_fn(p2, {k: _t(v) for k, v in batch.items()},
                        cfg)[0].backward()
    grad = wuk.grad
    assert grad is not None and torch.isfinite(grad).all() and \
        grad.abs().max() > 0


def test_prefill_cache_matches_reference(model):
    """``engine.prefill`` of a batch into fresh latent caches: the last
    hidden state and every layer's written ``c_kv`` / ``k_rope`` equal the
    reference's; the cache layout is {"c_kv": [L, B, S, R], "k_rope":
    [L, B, S, Dr]}."""
    params_ref, cfg_ref, params, cfg = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 10))
    last_ref, caches_ref, n_ref = RE.prefill(params_ref, jnp.asarray(toks),
                                             cfg_ref, max_len=16)
    last, caches, n = engine.prefill(params, _t(toks), cfg, max_len=16)
    assert n == n_ref == 10
    assert set(caches) == {"c_kv", "k_rope"}
    assert tuple(caches["c_kv"].shape) == (2, 3, 16, 16)
    assert tuple(caches["k_rope"].shape) == (2, 3, 16, 8)
    _close(last.numpy(), last_ref)
    for k in ("c_kv", "k_rope"):
        _close(caches[k].numpy(), caches_ref[0]["attn"][k])


def test_prefill_decode_consistency(model):
    """The reference's consistency test in the port: a prefill of 8 tokens
    then 8 teacher-forced decode steps reproduce the full forward (the
    reference's own tolerance, 5e-3)."""
    _, _, params, cfg = model
    b, t, p = 2, 16, 8
    toks = _t(np.random.default_rng(7).integers(0, cfg.vocab_size, (b, t)))
    full, _ = transformer.forward(params, toks, cfg)
    caches = engine.init_cache(cfg, b, t, "cpu")
    hp, caches = transformer.forward(params, toks[:, :p], cfg,
                                     caches=caches, cache_len=0)
    np.testing.assert_allclose(hp.numpy(), full[:, :p].numpy(), rtol=5e-3,
                               atol=5e-3)
    for i in range(p, t):
        h1, caches = transformer.forward(params, toks[:, i:i + 1], cfg,
                                         caches=caches, cache_len=i)
        np.testing.assert_allclose(h1[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp", "int8"])
def test_cache_family_keeps_fp_latents(kv):
    """Under either family the cache is the fp latent; the int8 family keeps
    its single-shot prefill and no sharing; paging is refused."""
    cfg = configs.get_smoke(ARCH).replace(kv_cache_dtype=kv)
    fam = cache_family.resolve(cfg)
    cache = engine.init_cache(cfg, 3, 20, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "c_kv": ((2, 3, 20, 16), torch.float32),
        "k_rope": ((2, 3, 20, 8), torch.float32)}
    assert fam.single_shot_prefill == (kv == "int8")
    assert fam.shareable == (kv != "int8")
    assert not engine.paged_supported(cfg)
    assert engine.paged_supported(configs.get_smoke("smollm_360m"))


def _prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 512, n) for n in (11, 19, 7, 16)]


def _requests(mod, *, decode=(6, 5, 7, 4), ticks=(0, 1, 2, 4)):
    return [mod.Request(rid=i, prompt=p, max_new_tokens=d, arrival_tick=t)
            for i, (p, d, t) in enumerate(zip(_prompts(), decode, ticks))]


def _tick_run(sched, requests):
    for req in requests:
        sched.submit(req)
    ticks = 0
    while sched.busy:
        sched.tick()
        ticks += 1
        assert ticks < 500
    return ({r.rid: list(r.tokens) for r in sched.finished},
            (sched.decode_steps, sched.prefill_chunks))


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp", "int8"])
def test_slot_pool_streams_equal_reference(model, kv):
    """The slot pool, fp and int8 (fp latents, each prompt in one chunk):
    the port's streams, decode steps and prefill chunks equal the reference
    scheduler's under its noise."""
    params_ref, cfg_ref, params, cfg = model
    cfg_ref = cfg_ref.replace(kv_cache_dtype=kv)
    cfg = cfg.replace(kv_cache_dtype=kv)
    geom = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
                top_k=TOP_K)
    want = _tick_run(RS.ContinuousScheduler(params_ref, cfg_ref,
                                            base_rng=BASE_KEY, **geom),
                     _requests(RS))
    mine = scheduler.ContinuousScheduler(params, cfg, noise_fn=ref_noise,
                                         device="cpu", **geom)
    got = _tick_run(mine, _requests(scheduler))
    assert got == want
    assert len({t for s in got[0].values() for t in s}) > 1
    if kv:
        assert mine.prefill_chunks == len(_prompts())


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp", "int8"])
def test_lockstep_ids_equal_reference(model, kv):
    """The lockstep loop from the reference's prompts and noise gives the
    reference's prefill / decode_step tokens."""
    params_ref, cfg_ref, params, cfg = model
    cfg_ref = cfg_ref.replace(kv_cache_dtype=kv)
    cfg = cfg.replace(kv_cache_dtype=kv)
    args = serve.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "3", "--prompt-len", "12",
                             "--tokens", "6"])
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (3, 12), 0, cfg.vocab_size))

    def noise(step):
        key = (jax.random.PRNGKey(3) if step == 0
               else jax.random.fold_in(BASE_KEY, step - 1))
        return np.asarray(jax.random.gumbel(key, (3, TOP_K), jnp.float32))

    ids = serve.lockstep(args, cfg, params, prompts=prompts, noise_fn=noise)
    last, caches, length = RE.prefill(params_ref, jnp.asarray(prompts),
                                      cfg_ref, max_len=18)
    logits = RT.logits_last(params_ref, last[:, None], cfg_ref)
    tok, _ = ref_topk_sample(jax.random.PRNGKey(3), logits, TOP_K)
    want = [np.asarray(tok)]
    for i in range(5):
        tok, caches, length = RE.decode_step(
            params_ref, caches, length, tok[:, None], cfg_ref,
            rng=jax.random.fold_in(BASE_KEY, i), top_k=TOP_K)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))
    assert len(set(ids.ravel().tolist())) > 1


CLI_ARGS = ["--arch", ARCH, "--smoke", "--continuous", "--device", "cpu",
            "--requests", "5", "--tokens", "8", "--prompt-len", "10",
            "--slots", "2", "--rate", "3.0", "--prefill-chunk", "8"]
_COUNTER_LINES = re.compile(r"^(continuous batching|decode steps|batch "
                            r"occupancy):.*$", re.M)


@pytest.mark.parametrize("kv", [[], ["--kv-cache-dtype", "int8"]],
                         ids=["fp", "int8"])
def test_cli_counters_equal_reference_cli(kv, capsys):
    """``python -m repro_torch.launch.serve --arch minicpm3_4b --smoke
    --continuous [--kv-cache-dtype int8]`` prints the reference CLI's
    counter lines on the same flags: decode steps, prefill chunks (one a
    request for int8) and occupancy."""
    argv = CLI_ARGS + kv
    rc = serve.main(argv)
    mine = capsys.readouterr().out
    rc_ref = RSV.main([a for a in argv if a not in ("--device", "cpu")])
    theirs = capsys.readouterr().out
    assert rc == rc_ref == 0
    lines = [m.group(0) for m in _COUNTER_LINES.finditer(mine)]
    assert len(lines) == 3
    assert lines == [m.group(0) for m in _COUNTER_LINES.finditer(theirs)]
    assert ("prefill chunks: 5" in mine) == bool(kv)


def test_paged_raises_the_reference_value_error():
    """``--paged`` and ``engine.init_paged_cache`` raise the reference's
    ``ValueError``, word for word; so does a forward with block tables."""
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    with pytest.raises(ValueError) as ref_err:
        RE.init_paged_cache(cfg_ref, num_blocks=4, block_size=8)
    with pytest.raises(ValueError) as err:
        engine.init_paged_cache(cfg, 4, 8, "cpu")
    assert str(err.value) == str(ref_err.value)
    assert "paged KV cache unsupported for arch 'minicpm3-4b-smoke'" in \
        str(err.value)
    with pytest.raises(ValueError) as cli_err:
        serve.main(CLI_ARGS + ["--paged"])
    assert str(cli_err.value) == str(ref_err.value)
    params = transformer.init(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="standard attention blocks only"):
        transformer.forward(params, torch.zeros((1, 1), dtype=torch.long),
                            cfg, caches=engine.init_cache(cfg, 1, 8, "cpu"),
                            cache_len=torch.tensor([0]),
                            block_tables=torch.zeros((1, 1),
                                                     dtype=torch.int32))


def test_train_refuses_cuda_and_runs_on_the_cpu(tmp_path):
    """``launch.train --arch minicpm3_4b`` no longer refuses CUDA for MLA
    (its decompressed attention has kernels at (96, 64)): on a box without
    a card, the default ``--device cuda`` fails for want of the device, not
    with ``NotImplementedError``; and it trains on the CPU through the
    plain forms."""
    if torch.cuda.is_available():
        pytest.skip("asserts the failure of a CUDA run on a box without a "
                    "card")
    with pytest.raises((RuntimeError, AssertionError),
                       match="CUDA|cuda|NVIDIA") as err:
        train.train(train.parse_args(["--arch", ARCH, "--smoke", "--steps",
                                      "1", "--checkpoint-dir",
                                      str(tmp_path / "a")]))
    assert not isinstance(err.value, NotImplementedError)
    _, _, hist, _ = train.train(train.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
         "--seq-len", "16", "--global-batch", "2", "--checkpoint-dir",
         str(tmp_path / "b")]), log=lambda *_: None)
    losses = [h["loss"] for h in hist if "loss" in h]
    assert len(losses) == 2 and all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# The kernels' plain versions, the dispatch entry and the planner.
# ---------------------------------------------------------------------------
def _mla_inputs(seed, *, b, t, h, s, vlens, r=256, dr=32):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, h, r, generator=gen)
    qr = torch.randn(b, t, h, dr, generator=gen)
    c = torch.randn(b, s, r, generator=gen)
    rr = torch.randn(b, s, dr, generator=gen)
    clean_c, clean_r = c.clone(), rr.clone()
    for row, n in enumerate(vlens):
        c[row, n:] = float("nan")
        rr[row, n:] = float("nan")
        clean_c[row, n:] = 0.0
        clean_r[row, n:] = 0.0
    return q, qr, c, rr, clean_c, clean_r


def _concat_attention(q, qr, c, rr, **kw):
    return online_attention(torch.cat([q, qr], -1),
                            torch.cat([c, rr], -1)[:, :, None],
                            c[:, :, None], scale=SCALE, **kw)


def test_plain_decode_is_concat_online_attention():
    """``flash_decode_mla_plain`` on caches NaN past each row's valid
    length equals concatenate + ``online_attention`` at 96^-0.5 on the
    same caches with those rows zeroed, exactly; vlen 0 gives 0; the
    scale is the one passed, not 288^-0.5."""
    vlens = [0, 1, 31, 32, 33, 70]
    q, qr, c, rr, c0, r0 = _mla_inputs(0, b=6, t=1, h=5, s=70, vlens=vlens)
    vl = torch.tensor(vlens)
    got = fm.flash_decode_mla_plain(q, qr, c, rr, vl, scale=SCALE,
                                    chunk_size=32)
    want = _concat_attention(q, qr, c0, r0, kv_valid_len=vl, chunk_size=32)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert got[0].abs().max().item() == 0.0
    other = _concat_attention(q, qr, c0, r0, kv_valid_len=vl, chunk_size=32)
    wrong = online_attention(torch.cat([q, qr], -1),
                             torch.cat([c0, r0], -1)[:, :, None],
                             c0[:, :, None], kv_valid_len=vl)
    assert torch.equal(got, other) and not torch.allclose(got[5], wrong[5])


def test_plain_prefill_is_concat_online_attention():
    """``flash_attention_mla_plain`` of Tq 7 at offsets [0, 20, 3] (causal,
    absolute coordinates), the rows past vlen NaN: equal to concatenate +
    ``online_attention`` on the zeroed caches; a row with vlen 0 gives 0."""
    vlens, offs = [7, 27, 0], [0, 20, 3]
    q, qr, c, rr, c0, r0 = _mla_inputs(1, b=3, t=7, h=4, s=40, vlens=vlens)
    vl, qo = torch.tensor(vlens), torch.tensor(offs)
    got = fm.flash_attention_mla_plain(q, qr, c, rr, qo, vl, scale=SCALE,
                                       chunk_size=16)
    want = _concat_attention(q, qr, c0, r0, causal=True, q_offset=qo,
                             kv_valid_len=vl, chunk_size=16)
    assert torch.equal(got, want)
    assert got[2].abs().max().item() == 0.0


def test_dispatch_mla_attention_routes_cpu_to_the_plain_versions():
    """On the CPU ``dispatch.mla_attention`` runs the plain versions (no
    launch counted, the path recorded as "cpu"); another device raises."""
    cfg = configs.get_smoke(ARCH)
    q, qr, c, rr, _, _ = _mla_inputs(2, b=2, t=1, h=3, s=20, vlens=[20, 20],
                                     r=16, dr=8)
    vl = torch.tensor([5, 20], dtype=torch.int32)
    dispatch.reset_launch_counts()
    obs_kernels.reset()
    got = dispatch.mla_attention(cfg, q, qr, c, rr, causal=False,
                                 q_offset=vl - 1, kv_valid_len=vl,
                                 scale=SCALE, decode=True)
    assert torch.equal(got, fm.flash_decode_mla_plain(
        q, qr, c, rr, vl, scale=SCALE, chunk_size=cfg.attn_chunk))
    q4, qr4 = (torch.randn(2, 4, 3, x) for x in (16, 8))
    out = dispatch.mla_attention(cfg, q4, qr4, c, rr, causal=True,
                                 q_offset=vl - 4, kv_valid_len=vl,
                                 scale=SCALE, decode=False)
    assert torch.equal(out, fm.flash_attention_mla_plain(
        q4, qr4, c, rr, vl - 4, vl, scale=SCALE, chunk_size=cfg.attn_chunk))
    counts = dispatch.launch_counts()
    assert counts["flash_decode_mla"] == counts["flash_attention_mla"] == 0
    paths = obs_kernels.snapshot()["paths"]
    assert paths["flash_decode_mla"] == {"path": "cpu", "count": 1}
    assert paths["flash_attention_mla"] == {"path": "cpu", "count": 1}
    with pytest.raises(NotImplementedError, match="device meta"):
        dispatch.mla_attention(cfg, q.to("meta"), qr.to("meta"),
                               c.to("meta"), rr.to("meta"), causal=False,
                               q_offset=0, kv_valid_len=vl, scale=SCALE,
                               decode=True)


@pytest.mark.parametrize("b,h,s,dtype,want", [
    # the slot pool's decode step at minicpm3-4b's heads: bf16 (the
    # tensor-core form) in 6 splits of one 64-key tile, fp32 in 11 of 32
    (8, 40, 328, torch.bfloat16, (64, 6, 256, 8 * 6 * 40 * 258)),
    (8, 40, 328, torch.float32, (32, 11, 256, 8 * 11 * 40 * 258)),
    # the lockstep loop's caches of 288 at B 4: 5 splits of 64 (bf16), 9
    # of 32 (fp32)
    (4, 40, 288, torch.bfloat16, (64, 5, 256, 4 * 5 * 40 * 258)),
    (4, 40, 288, torch.float32, (32, 9, 256, 4 * 9 * 40 * 258)),
    # a long cache: splits grow to keep 2 x 132 CTAs, whole tiles; bf16
    # merges at most MAX_MERGE partials a row
    (8, 40, 32768, torch.bfloat16, (1024, 32, 256, 8 * 32 * 40 * 258)),
    (1, 40, 32768, torch.bfloat16, (1024, 32, 256, 1 * 32 * 40 * 258)),
    (1, 40, 32768, torch.float32, (128, 256, 256, 1 * 256 * 40 * 258)),
    # an empty cache still plans one split
    (2, 4, 0, torch.float32, (32, 1, 256, 2 * 1 * 4 * 258)),
    (2, 4, 0, torch.bfloat16, (64, 1, 256, 2 * 1 * 4 * 258)),
])
def test_decode_plan(b, h, s, dtype, want):
    plan = fm.decode_plan(b, h, s, dtype, H100_SMS)
    assert tuple(plan) == want
    assert plan.split % fm.tile(dtype) == 0 and plan.split * plan.splits >= s
    assert plan.split % fm.TILE == 0


@pytest.mark.parametrize("b,t,h,dtype,want", [
    # a 64-token chunk at minicpm3-4b's 40 heads: 2560 flattened rows, 40
    # tiles of 64 (bf16) or 64 CTAs of 40 rows (fp32)
    (1, 64, 40, torch.bfloat16, (40, 64, 256)),
    (1, 64, 40, torch.float32, (64, 40, 256)),
    # the lockstep prefill, B 4 x Tq 256: 160 tiles a batch row
    (4, 256, 40, torch.bfloat16, (160, 64, 256)),
    (4, 256, 40, torch.float32, (256, 40, 256)),
    # T·H not a multiple of the tile: the last tile holds rows past T·H
    (2, 65, 40, torch.bfloat16, (41, 64, 256)),
    (2, 37, 7, torch.bfloat16, (5, 64, 256)),
    (2, 37, 7, torch.float32, (7, 40, 256)),
])
def test_prefill_grid(b, t, h, dtype, want):
    grid = fm.prefill_grid(b, t, h, dtype)
    assert tuple(grid) == want
    assert (grid.ctas - 1) * grid.rows < t * h <= grid.ctas * grid.rows


def test_prefill_grid_refuses_what_no_grid_covers():
    for args in ((65536, 1, 40, torch.bfloat16), (1, 0, 40, torch.float32),
                 (1, 4, 0, torch.bfloat16), (1, 4, 40, torch.float16)):
        with pytest.raises(ValueError, match="flash_attention_mla kernel"):
            fm.prefill_grid(*args)


def test_decode_plan_and_kernels_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="H=41"):
        fm.decode_plan(8, 41, 328, torch.bfloat16, H100_SMS)
    with pytest.raises(ValueError, match="float16"):
        fm.decode_plan(8, 40, 328, torch.float16, H100_SMS)
    q, qr, c, rr, _, _ = _mla_inputs(3, b=2, t=1, h=4, s=16, vlens=[16, 16])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fm.flash_decode_mla(q, qr, c, rr, torch.tensor([3, 4]), scale=SCALE)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fm.flash_attention_mla(q, qr, c, rr, 0, torch.tensor([3, 4]),
                               scale=SCALE)


def test_decode_step_cost_minicpm3_hand_counted():
    """``decode_step_cost`` of minicpm3-4b at B 8 over live lengths
    65..328: the absorbed products, 2·40·(288 + 256) flops and one 288-wide
    latent row of bf16 per live key and layer (V is that row's c)."""
    cfg = configs.get(ARCH)
    lens = [328, 289, 250, 211, 172, 133, 94, 65]
    cost = obs_kernels.decode_step_cost(cfg, 8, lens)
    d, h, f, v, n = 2560, 40, 6400, 73728, 62
    attn = (d * 768 + 768 * h * 96 + d * 288 + 256 * h * 64 + 256 * h * 64
            + h * 64 * d)
    mlp = 3 * d * f
    live = sum(lens)
    assert cost["flops"] == float(2 * (attn + mlp) * 8 * n
                                  + 2 * h * (288 + 256) * live * n
                                  + 2 * d * v * 8)
    assert cost["bytes_accessed"] == float(
        (attn + mlp) * 2 * n + d * v * 2 + live * n * 288 * 2 + 8 * v * 4)
    q8 = obs_kernels.decode_step_cost(cfg.replace(kv_cache_dtype="int8"), 8,
                                      lens)
    assert q8 == cost                     # int8 keeps fp latents
    # the latent cache per token: 62 x 288 x 2 bytes
    assert n * 288 * 2 == 35712
