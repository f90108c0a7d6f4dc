"""The head_dim-128 dense decoders (mistral-nemo-12b, deepseek-coder-33b)
in the port against the JAX package, on the CPU.

* ``configs.get`` / ``get_smoke`` for both architectures, field for field.
* The untied head: ``transformer.init`` draws it, ``convert`` carries it
  across and ``head_matrix`` reads it.
* Both smoke configs end to end (G 2, untied heads, deepseek's default
  rope_theta 1e6): the paged, slot-pool and lockstep streams and their
  int8 forms equal the reference's under the reference's noise, and the
  first logits agree within 1e-5.
* Sampling temperature and ``eos_id`` retirement: streams and retire ticks
  equal the reference's at temperature 0.7 and with an ``eos_id`` a stream
  hits.
* The plain attention versions at head_dim 128 with G 4 and G 7 against the
  Pallas kernels (interpret mode, as ``tests/kernels/`` runs them), and a
  one-layer model of d_model 256 with 32/8 and 56/8 heads of 128 against
  the reference's paged prefill and decode.
* The planners at the new shapes (pure functions): ``decode_plan`` at 8 KV
  heads of D 128 and ``softmax_topk.plan`` at V 131072 and 32256.

Tolerances: float32 everywhere; the packages compute the same math with
other matmul kernels and summation orders, so float results agree to ~1e-5
and sampled token streams exactly.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.core import topk_sample as ref_topk_sample  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_offset_pallas, flash_attention_paged_pallas)
from repro.kernels.flash_decode import (  # noqa: E402
    flash_decode_pallas, flash_decode_paged_pallas)
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import softmax_topk as st  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import engine, scheduler  # noqa: E402

ARCHS = ("mistral_nemo_12b", "deepseek_coder_33b")
TOL = dict(rtol=1e-5, atol=1e-5)
TOP_K = 5
BASE_KEY = jax.random.PRNGKey(0)
SLOT_LEN, CHUNK, BLOCK = 40, 8, 8
H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_key(rid, i):
    return jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)


def ref_noise(rid, i, k):
    """The reference scheduler's per-(request, token) Gumbel draw."""
    return np.asarray(jax.random.gumbel(_ref_key(rid, i), (k,), jnp.float32))


def _models(arch, **override):
    """(reference params, reference cfg, port params, port cfg) of the
    smoke config (with ``override``): the same weights, from the reference's
    ``transformer.init``, with the embedding scaled down so the smoke
    model's streams do not repeat their input token."""
    cfg_ref = ref_configs.get_smoke(arch).replace(**override)
    cfg = configs.get_smoke(arch).replace(**override)
    params_ref, _ = RL.split_params(RT.init(jax.random.PRNGKey(0), cfg_ref))
    params_ref["embedding"]["embed"] = params_ref["embedding"]["embed"] * 0.05
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), cfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _models(request.param)


# ---------------------------------------------------------------------------
# Configs and the untied head.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, which):
    """Both names (module and alias) give the reference's numbers, field
    for field."""
    ref = getattr(ref_configs, which)(arch)
    for name in (arch, arch.replace("_", "-")):
        mine = getattr(configs, which)(name)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert ref.resolved_head_dim == (16 if which == "get_smoke" else 128)
    assert not ref.tie_embeddings


def test_unported_arch_still_raises():
    # llava-next-34b, the last unported head_dim-128 model, is ported: a
    # name outside the reference's registry raises and is named
    with pytest.raises(NotImplementedError, match="gpt2_small"):
        configs.get("gpt2_small")


def test_untied_head_through_init_convert_and_logits(model):
    """``init`` draws the head [D, V] (apart from the embedding),
    ``params_from_numpy`` carries the reference's head across, and the
    logits read it: they equal the reference's ``logits_last``."""
    params_ref, cfg_ref, params, cfg = model
    mine = transformer.init(cfg, seed=0, device="cpu")
    assert mine["head"].shape == (cfg.d_model, cfg.vocab_size)
    assert not torch.equal(mine["head"], mine["embed"].T)
    np.testing.assert_array_equal(params["head"].numpy(),
                                  np.asarray(params_ref["embedding"]["head"]))
    assert L.head_matrix(params, cfg) is params["head"]
    h = np.random.default_rng(2).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    want = RT.logits_last(params_ref, jnp.asarray(h), cfg_ref)
    got = transformer.logits_last(params, _t(h), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_draws_on_the_card_only_when_asked():
    """The CPU draw is the default and repeats from a seed; a card draw is
    asked for by ``draw_device`` (here refused: no card on this host)."""
    cfg = configs.get_smoke("mistral_nemo_12b")
    a = transformer.init(cfg, seed=5, device="cpu")
    b = transformer.init(cfg, seed=5, device="cpu", draw_device="cpu")
    assert torch.equal(a["head"], b["head"])
    assert torch.equal(a["layers"][1]["mlp"]["w_down"],
                       b["layers"][1]["mlp"]["w_down"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            transformer.init(cfg, seed=5, device="cpu", draw_device="cuda")


# ---------------------------------------------------------------------------
# The smoke configs end to end.
# ---------------------------------------------------------------------------
def _prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 512, n) for n in (11, 19, 7, 16)]


def _requests(mod, *, decode=(6, 5, 7, 4), ticks=(0, 1, 2, 4)):
    return [mod.Request(rid=i, prompt=p, max_new_tokens=d, arrival_tick=t)
            for i, (p, d, t) in enumerate(zip(_prompts(), decode, ticks))]


def _tick_run(sched, requests):
    """Submit ``requests`` and tick ``sched`` until idle: (streams, the
    tick each request retired on)."""
    for req in requests:
        sched.submit(req)
    retired, ticks = {}, 0
    while sched.busy:
        sched.tick()
        ticks += 1
        for res in sched.finished:
            retired.setdefault(res.rid, ticks)
        assert ticks < 500
    return {r.rid: list(r.tokens) for r in sched.finished}, retired


def _serve_both(params_ref, cfg_ref, params, cfg, *, paged, **kw):
    """The same requests through the reference's scheduler and the port's
    (with the reference's noise): ((streams, retire ticks), the same of
    the port's, the port's scheduler)."""
    geom = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
                top_k=TOP_K, paged=paged, block_size=BLOCK, **kw)
    ref = RS.ContinuousScheduler(params_ref, cfg_ref, base_rng=BASE_KEY,
                                 **geom)
    mine = scheduler.ContinuousScheduler(params, cfg, noise_fn=ref_noise,
                                         device="cpu", **geom)
    return (_tick_run(ref, _requests(RS)),
            _tick_run(mine, _requests(scheduler)), mine)


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_streams_equal_reference(model, paged, kv):
    """Paged and slot-pool serving, fp and int8 K/V: the port's streams and
    retire ticks equal the reference scheduler's, token for token."""
    params_ref, cfg_ref, params, cfg = model
    if kv:
        cfg_ref = cfg_ref.replace(kv_cache_dtype=kv)
        cfg = cfg.replace(kv_cache_dtype=kv)
    (want, want_ticks), (got, got_ticks), sched = _serve_both(
        params_ref, cfg_ref, params, cfg, paged=paged)
    assert got == want
    assert got_ticks == want_ticks
    assert len({t for s in got.values() for t in s}) > 1
    if paged:
        sched.pool.alloc.check_invariants()


def test_first_logits_match_reference(model):
    """The paged prefill of one prompt in chunks, then its logits: within
    1e-5 of the reference's."""
    params_ref, cfg_ref, params, cfg = model
    prompt = _prompts()[1]
    m = -(-len(prompt) // BLOCK)
    table = np.arange(1, m + 1, dtype=np.int32)[None]
    pools_ref = RE.init_paged_cache(cfg_ref, m + 1, BLOCK)
    pools = engine.init_paged_cache(cfg, m + 1, BLOCK, "cpu")
    length, pos = 0, 0
    for w in engine.prefill_schedule(len(prompt), CHUNK):
        toks = prompt[None, pos:pos + w]
        last_ref, pools_ref, _ = RE.prefill_chunk_paged(
            params_ref, pools_ref, jnp.asarray(table),
            jnp.asarray([length], jnp.int32), jnp.asarray(toks), cfg_ref)
        last, pools, _ = engine.prefill_chunk_paged(
            params, pools, _t(table), torch.tensor([length]), _t(toks), cfg)
        length += w
        pos += w
    want = RE.logits_from_hidden(params_ref, last_ref, cfg_ref)
    got = engine.logits_from_hidden(params, last, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp", "int8"])
def test_lockstep_ids_equal_reference(model, kv):
    """The lockstep loop from the reference's prompts and noise gives the
    reference's prefill / decode_step tokens."""
    params_ref, cfg_ref, params, cfg = model
    cfg_ref = cfg_ref.replace(kv_cache_dtype=kv)
    cfg = cfg.replace(kv_cache_dtype=kv)
    args = serve.parse_args(["--arch", cfg.name.replace("-smoke", ""),
                             "--smoke", "--device", "cpu", "--batch", "3",
                             "--prompt-len", "12", "--tokens", "6"])
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


# ---------------------------------------------------------------------------
# Temperature and eos_id retirement.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_temperature_matches_reference(model, paged):
    """At temperature 0.7 the logits are divided before the fused
    softmax+top-k, in the prefill's first token and every decode step:
    streams and retire ticks equal the reference's, and differ from the
    temperature-1 streams."""
    params_ref, cfg_ref, params, cfg = model
    (want, want_ticks), (got, got_ticks), _ = _serve_both(
        params_ref, cfg_ref, params, cfg, paged=paged, temperature=0.7)
    assert got == want and got_ticks == want_ticks
    _, (plain, _), _ = _serve_both(params_ref, cfg_ref, params, cfg,
                                   paged=paged)
    assert plain != got


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_eos_retirement_matches_reference(model, paged):
    """With ``eos_id`` a token some stream samples mid-way, that request
    retires on it (keeping it) on the reference's tick, and every stream
    and retire tick equals the reference's."""
    params_ref, cfg_ref, params, cfg = model
    _, (free, _), _ = _serve_both(params_ref, cfg_ref, params, cfg,
                                  paged=paged)
    eos = next(t for s in free.values() for t in s[1:-1])
    (want, want_ticks), (got, got_ticks), sched = _serve_both(
        params_ref, cfg_ref, params, cfg, paged=paged, eos_id=eos)
    assert got == want and got_ticks == want_ticks
    cut = [rid for rid, s in got.items() if len(s) < len(free[rid])]
    assert cut
    for rid in cut:
        assert got[rid][-1] == eos
        assert got[rid] == free[rid][:len(got[rid])]
    assert sched.eos_id == eos and not sched.active


def test_sample_per_slot_temperature():
    """``sample_per_slot`` divides the logits by the temperature (a
    temperature of 1.0 leaves them as they are), as the reference's."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    noise = rng.gumbel(size=(3, TOP_K)).astype(np.float32)
    for temp in (1.0, 0.7, 2.5):
        got = engine.sample_per_slot(_t(logits), TOP_K, _t(noise), temp)
        want = engine.sample_per_slot(_t(logits / temp), TOP_K, _t(noise))
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The plain attention versions at head_dim 128, G 4 and G 7.
# ---------------------------------------------------------------------------
GROUPS = [(4, 2), (7, 2)]       # (G, Hkv): mistral's and deepseek's group


def _paged_case(seed, *, vlens, bs=8, hkv=2, g=4, d=128, tq=1):
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


@pytest.mark.parametrize("g,hkv", GROUPS)
def test_plain_paged_decode_at_d128_matches_pallas(g, hkv):
    q, kp, vp, tables, vlen = _paged_case(0, vlens=[1, 13, 20], g=g, hkv=hkv)
    ref = flash_decode_paged_pallas(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(tables),
                                    jnp.asarray(vlen), interpret=True)
    got = fd.flash_decode_paged_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(vlen), chunk_size=8)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("g,hkv", GROUPS)
def test_plain_paged_prefill_at_d128_matches_pallas(g, hkv):
    qoff, vlens, tq = [0, 9], [8, 17], 8
    q, kp, vp, tables, vlen = _paged_case(1, vlens=vlens, g=g, hkv=hkv,
                                          tq=tq)
    qo = np.asarray(qoff, np.int32)
    ref_out, ref_lse = flash_attention_paged_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(qo), jnp.asarray(vlen),
        jnp.asarray(tables), causal=True, bq=8, interpret=True)
    out, lse = fa.flash_attention_paged_plain(_t(q), _t(kp), _t(vp), _t(qo),
                                              _t(vlen), _t(tables),
                                              chunk_size=8)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **TOL)


@pytest.mark.parametrize("g,hkv", GROUPS)
def test_plain_contiguous_at_d128_matches_pallas(g, hkv):
    """The contiguous decode and cached prefill at D 128 against
    ``flash_decode_pallas`` and ``flash_attention_offset_pallas``."""
    rng = np.random.default_rng(3)
    b, s, tq = 2, 16, 8
    q = rng.standard_normal((b, tq, hkv * g, 128)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, 128)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, 128)).astype(np.float32)
    vlen = np.asarray([9, 16], np.int32)
    ref = flash_decode_pallas(
        jnp.asarray(q[:, 0]), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(vlen), bk=8,
        interpret=True)
    got = fd.flash_decode_plain(_t(q[:, :1]), _t(k), _t(v), _t(vlen),
                                chunk_size=8)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)
    qo = np.asarray([1, 8], np.int32)
    ref_out, ref_lse = flash_attention_offset_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(qo),
        jnp.asarray(vlen), causal=True, bq=8, bk=8, interpret=True)
    out, lse = fa.flash_attention_offset_plain(_t(q), _t(k), _t(v), _t(qo),
                                               _t(vlen), chunk_size=8)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **TOL)


@pytest.mark.parametrize("heads", [(32, 8), (56, 8)], ids=["G4", "G7"])
def test_one_layer_d128_model_matches_reference(heads):
    """A one-layer model of d_model 256 with 32/8 or 56/8 heads of 128:
    the paged prefill in chunks and two paged decode steps give the
    reference's logits within 1e-5."""
    hq, hkv = heads
    params_ref, cfg_ref, params, cfg = _models(
        "mistral_nemo_12b", num_layers=1, d_model=256, num_heads=hq,
        num_kv_heads=hkv, head_dim=128)
    prompt = np.random.default_rng(6).integers(0, 512, 13)
    m = 3
    table = np.arange(1, m + 1, dtype=np.int32)[None]
    pools_ref = RE.init_paged_cache(cfg_ref, m + 1, BLOCK)
    pools = engine.init_paged_cache(cfg, m + 1, BLOCK, "cpu")
    length, pos = 0, 0
    for w in engine.prefill_schedule(len(prompt), CHUNK):
        toks = prompt[None, pos:pos + w]
        last_ref, pools_ref, _ = RE.prefill_chunk_paged(
            params_ref, pools_ref, jnp.asarray(table),
            jnp.asarray([length], jnp.int32), jnp.asarray(toks), cfg_ref)
        last, pools, _ = engine.prefill_chunk_paged(
            params, pools, _t(table), torch.tensor([length]), _t(toks), cfg)
        length, pos = length + w, pos + w
    np.testing.assert_allclose(last.numpy(), np.asarray(last_ref), **TOL)
    tok = 7
    for _ in range(2):
        toks = np.asarray([[tok]])
        h_ref, pools_ref, _ = RT.forward(
            params_ref, jnp.asarray(toks), cfg_ref, caches=pools_ref,
            cache_len=jnp.asarray([length], jnp.int32),
            block_tables=jnp.asarray(table))
        h, pools = transformer.forward(
            params, _t(toks), cfg, caches=pools,
            cache_len=torch.tensor([length]), block_tables=_t(table))
        want = RE.logits_from_hidden(params_ref, h_ref[:, -1], cfg_ref)
        got = engine.logits_from_hidden(params, h[:, -1], cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = int(np.argmax(np.asarray(want)[0]))
        length += 1


# ---------------------------------------------------------------------------
# The planners at the new shapes.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g,dtype,max_len,page,want", [
    # mistral-nemo-12b (G 4), paged bf16 pool: 64 positions a split (16 KB
    # of K at D 128), 6 splits over 21 blocks of 16
    (4, torch.bfloat16, 336, 16, (64, 6, 128, 42048, 8 * 8 * 6 * 4 * 130)),
    # deepseek-coder-33b (G 7): the same split, more scores and partials
    (7, torch.bfloat16, 336, 16, (64, 6, 128, 48960, 8 * 8 * 6 * 7 * 130)),
    # int8 pools: 80 positions (the waves, under the 128 of 16 KB)
    (4, torch.int8, 336, 16, (80, 5, 128, 30656, 8 * 8 * 5 * 4 * 130)),
    # fp32 (the parity runs): 32 positions
    (4, torch.float32, 336, 16, (32, 11, 128, 41536, 8 * 8 * 11 * 4 * 130)),
    # the slot pool's caches of 328, bf16
    (4, torch.bfloat16, 328, fd.CONTIGUOUS_TILE,
     (64, 6, 128, 42048, 8 * 8 * 6 * 4 * 130)),
])
def test_decode_plan_at_head_dim_128(g, dtype, max_len, page, want):
    plan = fd.decode_plan(8, 8, g, 128, max_len, page, dtype, H100_SMS)
    assert tuple(plan) == want
    assert plan.smem == fd.split_smem(g, 128, dtype.itemsize, plan.split,
                                      dtype == torch.int8)


def test_decode_plan_fills_the_card_at_serving_lengths():
    """At B 8 and 8 KV heads, the serving lengths 65..328 run 29 live
    splits a KV head, 232 CTAs: more than the 132 SMs."""
    plan = fd.decode_plan(8, 8, 4, 128, 336, 16, torch.bfloat16, H100_SMS)
    vlens = [328, 289, 250, 211, 172, 133, 94, 65]
    live = [plan.live(v, 336) for v in vlens]
    assert live == [6, 5, 4, 4, 3, 3, 2, 2]
    assert 8 * sum(live) == 232 > H100_SMS


def test_decode_plan_refuses_head_dims_without_instances():
    with pytest.raises(ValueError, match="D=96"):
        fd.decode_plan(8, 8, 4, 96, 336, 16, torch.bfloat16, H100_SMS)
    assert fd.HEAD_DIMS == (64, 128)
    assert fa.HEAD_DIMS == {"flash_attention_offset": ((64, 64), (128, 128)),
                            "flash_attention_paged": ((64, 64), (128, 128)),
                            "flash_attention": ((64, 64), (128, 128),
                                                (96, 64))}


@pytest.mark.parametrize("v,want", [
    # mistral-nemo-12b: 32768 vectors, 64 slices of 512 (4 loads a thread)
    (131072, st.Plan(2048, 64, 128, 4, 2560, 4)),
    # deepseek-coder-33b: 8064 vectors (V no multiple of 1024), 33 slices
    # of 245, the last 224
    (32256, st.Plan(980, 33, 256, 1, 1320, 4)),
])
def test_softmax_topk_plan_at_head_dim_128_vocabularies(v, want):
    assert st.plan(8, v, 5, torch.float32, H100_SMS) == want
