"""The port's int8 KV-cache serving path against the JAX package, on the CPU.

Module by module — ``_quantize_kv``, ``DenseInt8Family`` (layouts and
``dequantize_block``), the plain versions of the three int8 attention
kernels (paged decode, contiguous decode, paged prefill) against the
reference's ``dispatch.sdpa`` int8 routes and its Pallas kernel in interpret
mode, ``attention_apply``'s int8 branches — with the reference's weights
carried across by ``models.convert.params_from_numpy``; then the paths as a
whole: paged and unpaged int8 scheduler streams against the reference's solo
runs under the same Gumbel noise, single-shot prefill of a long prompt, the
lockstep loop, and the CLI's report counters against the reference CLI's.

Tolerances: float32 everywhere (smoke config).  Quantized values are exact
(int8 equal, bf16 scales equal): both packages quantize the same fp32
values, and at these shapes the two CPU K projections agree to the bit.
Float attention outputs agree to ~1e-5 (other summation orders), sampled
token streams exactly.
"""
import functools
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.core import topk_sample as ref_topk_sample  # noqa: E402
from repro.kernels import dispatch as RD  # noqa: E402
from repro.kernels import ops as ROPS  # noqa: E402
from repro.launch import serve as RSV  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import cache_family as RCF  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import cache_family, engine, scheduler  # noqa: E402
from repro_torch.serving.engine_api import Engine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TOP_K = 5
BASE_KEY = jax.random.PRNGKey(0)
SLOT_LEN, BLOCK, CHUNK = 48, 8, 8
# the README's doctest workload with an int8 cache
README_ARGS = ["--smoke", "--continuous", "--device", "cpu", "--requests",
               "5", "--tokens", "8", "--prompt-len", "10", "--slots", "2",
               "--rate", "3.0", "--prefill-chunk", "8",
               "--kv-cache-dtype", "int8"]
PAGED_FLAGS = ["--paged", "--block-size", "8", "--shared-prefix", "8"]


def _t(a):
    """numpy / jax array → torch tensor; bf16 stays bf16."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(x):
    """torch tensor → numpy, bf16 as float32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).astype(np.float32) \
        if np.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


def _int8_cfgs():
    """(reference cfg, port cfg): the smoke config with int8 K/V."""
    return tuple(c.get_smoke("smollm_360m").replace(kv_cache_dtype="int8")
                 for c in (ref_configs, configs))


@pytest.fixture(scope="module")
def model():
    """(reference params, reference cfg, port params, port cfg), both cfgs
    with ``kv_cache_dtype="int8"``: the same weights, from the reference's
    ``transformer.init``, with the embedding scaled down so the smoke
    model's streams do not repeat their input token (as in the slot-pool
    tests), which makes them discriminate."""
    cfg_ref, cfg = _int8_cfgs()
    params_ref, _ = RL.split_params(RT.init(jax.random.PRNGKey(0), cfg_ref))
    params_ref["embedding"]["embed"] = params_ref["embedding"]["embed"] * 0.05
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), cfg


def _ref_key(rid, i):
    return jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)


def ref_noise(rid, i, k):
    """The reference scheduler's per-(request, token) Gumbel draw."""
    return np.asarray(jax.random.gumbel(_ref_key(rid, i), (k,), jnp.float32))


def _quantized(rng, shape):
    """Random fp32 K/V [B, S, H, D] and their reference quantization."""
    x = rng.standard_normal(shape).astype(np.float32)
    q8, sc = RL._quantize_kv(jnp.asarray(x))
    return x, np.asarray(q8), np.asarray(sc)


def _to_pools(x8, xs, tables, bs):
    """Contiguous int8 [B, S, H, D] and scales [B, S, H] → pool
    [P, H, BS, D] and scale pages [P, H, BS] through ``tables`` [B, M]
    (S == M·BS); unused blocks hold 0."""
    b, s, h = x8.shape[:3]
    p = int(tables.max()) + 1
    pool = np.zeros((p, h, bs) + x8.shape[3:], x8.dtype)
    spool = np.zeros((p, h, bs), xs.dtype)
    for bi in range(b):
        for mi in range(s // bs):
            seg = slice(mi * bs, (mi + 1) * bs)
            pool[tables[bi, mi]] = x8[bi, seg].swapaxes(0, 1)
            spool[tables[bi, mi]] = xs[bi, seg].swapaxes(0, 1)
    return pool, spool


# ---------------------------------------------------------------------------
# Module by module.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    """Same input, same int8 values and bf16 scales, exactly: fp32 and bf16
    inputs, all-zero (position, head) rows (scale clamped at 1e-8, values
    0), rows whose max|x| is one entry, and values placed on .5 boundaries
    of x / scale (round half to even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 2, 16)).astype(np.float32) * 3.0
    x[0, 2] = 0.0                                   # both heads all zero
    x[1, 3, 1] = 0.0
    x[2, 4, 0] = 0.0
    x[2, 4, 0, 5] = -1e-3                           # one nonzero entry
    # max|x| = 127 → scale 1: entries at k + 0.5 round half to even
    x[1, 1, 0] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                           126.5, -126.5, 0.49999997, 4.5, 5.5, -6.5, 7.5,
                           8.5], np.float32)
    xj = jnp.asarray(x, dtype=jnp.dtype(dtype))
    q_ref, s_ref = RL._quantize_kv(xj)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = L._quantize_kv(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert q.shape == xt.shape and s.shape == xt.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(_np(s), _np(s_ref))
    assert not q[0, 2].any() and (_np(s)[0, 2] > 0).all()
    assert q[1, 1, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]


def test_int8_family_layouts_match_reference():
    cfg_ref, cfg = _int8_cfgs()
    fam_ref, fam = RCF.resolve(cfg_ref), cache_family.resolve(cfg)
    assert type(fam).__name__ == "DenseInt8Family" == type(fam_ref).__name__
    assert fam.name == fam_ref.name == "dense_int8"
    for attr in ("quantized", "single_shot_prefill", "shareable"):
        assert getattr(fam, attr) == getattr(fam_ref, attr), attr
    assert fam.quantized and fam.single_shot_prefill and not fam.shareable
    for ref, mine in ((fam_ref.init_cache(3, 24)[0]["attn"],
                       fam.init_cache(3, 24, "cpu")),
                      (fam_ref.init_paged_cache(7, 8)[0]["attn"],
                       fam.init_paged_cache(7, 8, "cpu"))):
        assert set(ref) == set(mine) == {"k", "v", "k_scale", "v_scale"}
        for name, leaf in ref.items():
            assert tuple(mine[name].shape) == leaf.shape, name
            assert str(mine[name].dtype).replace("torch.", "") == \
                str(leaf.dtype), name
            assert not mine[name].any(), name
    assert type(cache_family.resolve(configs.get_smoke("smollm_360m"))) \
        is cache_family.DenseFamily


def test_dequantize_block_matches_reference():
    cfg_ref, cfg = _int8_cfgs()
    rng = np.random.default_rng(3)
    _, k8, ks = _quantized(rng, (1, 8, 2, 16))
    _, v8, vs = _quantized(rng, (1, 8, 2, 16))
    # one physical block [Hkv, BS, ·]
    blk = {"k": k8[0].swapaxes(0, 1), "k_scale": ks[0].swapaxes(0, 1),
           "v": v8[0].swapaxes(0, 1), "v_scale": vs[0].swapaxes(0, 1)}
    want = RCF.resolve(cfg_ref).dequantize_block(
        {"attn": {n: jnp.asarray(a) for n, a in blk.items()}})["attn"]
    got = cache_family.resolve(cfg).dequantize_block(
        {n: _t(a) for n, a in blk.items()})
    for name in ("k", "v"):
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.fixture(scope="module")
def int8_operands():
    """int8 caches [B, S, Hkv, D] (the reference's quantization of random
    K/V), their scales, the same scattered into pools through a table, and
    a decode query."""
    rng = np.random.default_rng(5)
    b, hkv, hq, hd, bs, m = 3, 2, 4, 16, 8, 4
    _, k8, ks = _quantized(rng, (b, bs * m, hkv, hd))
    _, v8, vs = _quantized(rng, (b, bs * m, hkv, hd))
    tables = (rng.permutation(b * m).reshape(b, m) + 1).astype(np.int32)
    k_pool, ks_pool = _to_pools(k8, ks, tables, bs)
    v_pool, vs_pool = _to_pools(v8, vs, tables, bs)
    q = rng.standard_normal((b, 1, hq, hd)).astype(np.float32)
    vlen = np.array([5, 17, 32], np.int32)
    return dict(contiguous=(k8, v8, ks, vs), paged=(k_pool, v_pool, ks_pool,
                                                    vs_pool),
                tables=tables, q=q, vlen=vlen, rng=rng)


@pytest.mark.parametrize("route", ["paged-decode", "contiguous-decode",
                                   "paged-prefill"])
def test_int8_plain_versions_match_reference(int8_operands, route):
    """Each int8 kernel's plain version, and the port's ``dispatch.sdpa`` on
    CPU tensors, against the reference's ``dispatch.sdpa`` int8 route on the
    same int8 values (its XLA dequantizing chunked form); the paged prefill
    also against the reference's Pallas kernel in interpret mode."""
    cfg_ref, cfg = _int8_cfgs()
    ops = int8_operands
    tables, vlen = ops["tables"], ops["vlen"]
    if route == "paged-prefill":
        tq = 6
        q = ops["rng"].standard_normal((3, tq, 4, 16)).astype(np.float32)
        qoff = np.array([2, 9, 20], np.int32)
        vlen = qoff + tq
    else:
        q, qoff = ops["q"], vlen - 1
    kv = ops["contiguous" if route == "contiguous-decode" else "paged"]
    decode = route != "paged-prefill"
    paged = route != "contiguous-decode"
    extra = dict(block_tables=tables) if paged else {}
    want = RD.sdpa(cfg_ref, jnp.asarray(q), *(jnp.asarray(a) for a in kv[:2]),
                   causal=not decode, q_offset=jnp.asarray(qoff),
                   kv_valid_len=jnp.asarray(vlen), decode=decode,
                   k_scale=jnp.asarray(kv[2]), v_scale=jnp.asarray(kv[3]),
                   **{n: jnp.asarray(a) for n, a in extra.items()})
    args = [_t(a) for a in kv]
    if route == "paged-decode":
        plain = fd.flash_decode_paged_plain(
            _t(q), args[0], args[1], _t(tables), _t(vlen),
            chunk_size=cfg.attn_chunk, k_scale_pool=args[2],
            v_scale_pool=args[3])
    elif route == "contiguous-decode":
        plain = fd.flash_decode_plain(_t(q), args[0], args[1], _t(vlen),
                                      chunk_size=cfg.attn_chunk,
                                      k_scale=args[2], v_scale=args[3])
    else:
        plain, lse = fa.flash_attention_paged_plain(
            _t(q), args[0], args[1], _t(qoff), _t(vlen), _t(tables),
            chunk_size=cfg.attn_chunk, k_scale_pool=args[2],
            v_scale_pool=args[3])
        # the Pallas kernel itself, in interpret mode off the TPU
        kern_out = ROPS.paged_flash_attention(
            jnp.asarray(q), *(jnp.asarray(a) for a in kv[:2]),
            jnp.asarray(qoff), jnp.asarray(vlen), jnp.asarray(tables),
            causal=True, k_scale_pool=jnp.asarray(kv[2]),
            v_scale_pool=jnp.asarray(kv[3]))
        np.testing.assert_allclose(plain.numpy(), np.asarray(kern_out),
                                   rtol=2e-5, atol=2e-5)
        assert torch.isfinite(lse).all()
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    got = dispatch.sdpa(cfg, _t(q), args[0], args[1], causal=not decode,
                        q_offset=_t(qoff), kv_valid_len=_t(vlen),
                        decode=decode, k_scale=args[2], v_scale=args[3],
                        **{n: _t(a) for n, a in extra.items()})
    assert torch.equal(got, plain)


def test_paged_int8_decode_bit_exact_vs_contiguous(int8_operands):
    """The port's copy of the reference's acceptance pin
    (``test_numerics.py``): gather-then-dequantize through a scattered block
    table equals the contiguous int8 decode bit for bit on the CPU (same
    chunk split, same dequantization, same masking)."""
    _, cfg = _int8_cfgs()
    ops = int8_operands
    q, vlen = _t(ops["q"]), _t(ops["vlen"])
    k8, v8, ks, vs = (_t(a) for a in ops["contiguous"])
    kp, vp, ksp, vsp = (_t(a) for a in ops["paged"])
    contiguous = dispatch.sdpa(cfg, q, k8, v8, causal=False,
                               q_offset=vlen - 1, kv_valid_len=vlen,
                               decode=True, k_scale=ks, v_scale=vs)
    paged = dispatch.sdpa(cfg, q, kp, vp, causal=False, q_offset=vlen - 1,
                          kv_valid_len=vlen, decode=True,
                          block_tables=_t(ops["tables"]), k_scale=ksp,
                          v_scale=vsp)
    assert torch.equal(paged, contiguous)


@pytest.mark.parametrize("paged,t", [(True, 5), (True, 1), (False, 5),
                                     (False, 1)],
                         ids=["paged-prefill", "paged-decode",
                              "contiguous-prefill", "contiguous-decode"])
def test_attention_apply_int8_matches_reference(model, paged, t):
    """``attention_apply``'s int8 branches: quantized K/V and scales written
    (through the table, or at per-row offsets), then a prefill over the
    call's exact K/V (t > 1) or a decode over the int8 cache (t == 1)."""
    params_ref, cfg_ref, params, cfg = model
    rng = np.random.default_rng(2)
    hkv, hd, bs = cfg.num_kv_heads, cfg.resolved_head_dim, 4
    lens = np.array([0, 0] if t > 1 else [6, 9], np.int32)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    positions = lens[:, None] + np.arange(t, dtype=np.int32)
    _, k8, ks = _quantized(rng, (2, 16, hkv, hd))
    _, v8, vs = _quantized(rng, (2, 16, hkv, hd))
    extra = {}
    cache0 = dict(k=k8, v=v8, k_scale=ks, v_scale=vs)
    if paged:
        tables = np.array([[2, 5, 7, 0], [1, 3, 4, 8]], np.int32)
        cache0 = dict(zip(("k", "k_scale", "v", "v_scale"),
                          _to_pools(k8, ks, tables, bs)
                          + _to_pools(v8, vs, tables, bs)))
        extra = dict(block_tables=tables)
    p_ref = jax.tree.map(lambda a: a[0], params_ref["segments"][0]["attn"])
    out_ref, cache_ref = RL.attention_apply(
        p_ref, jnp.asarray(x), cfg_ref, positions=jnp.asarray(positions),
        cache={n: jnp.asarray(a) for n, a in cache0.items()},
        cache_len=jnp.asarray(lens),
        **{n: jnp.asarray(a) for n, a in extra.items()})
    cache = {n: _t(a) for n, a in cache0.items()}
    out, cache = L.attention_apply(
        params["layers"][0]["attn"], _t(x), cfg, positions=_t(positions),
        cache=cache, cache_len=_t(lens),
        **{n: _t(a) for n, a in extra.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **TOL)
    # the two fp32 K projections agree here to the bit, so the quantized
    # cache does too: int8 values and bf16 scales equal
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_np(cache[name]), _np(cache_ref[name]),
                                      err_msg=name)


def test_write_slot_and_copy_block_carry_scales():
    """``write_slot`` and ``copy_paged_block`` walk every cache leaf, so an
    int8 cache's scales travel with its K/V."""
    _, cfg = _int8_cfgs()
    fam = cache_family.resolve(cfg)
    pool = fam.init_cache(2, 8, "cpu")
    seq = fam.init_cache(1, 8, "cpu")
    for i, leaf in enumerate(seq.values()):
        leaf.fill_(i + 1)
    engine.write_slot(cfg, pool, seq, 1)
    for name, leaf in pool.items():
        assert torch.equal(leaf[:, 1], seq[name][:, 0]), name
        assert not leaf[:, 0].any(), name
    pools = fam.init_paged_cache(4, 8, "cpu")
    for i, leaf in enumerate(pools.values()):
        leaf[:, 2] = i + 1
    engine.copy_paged_block(pools, 2, 3)
    for name, leaf in pools.items():
        assert torch.equal(leaf[:, 3], leaf[:, 2]) and leaf[:, 3].any(), name


# ---------------------------------------------------------------------------
# The paths as a whole.
# ---------------------------------------------------------------------------
def _workload(pattern):
    """The reference's int8 workload (``test_serving_families.py``): four
    requests, rid 3 an exact repeat of rid 0's prompt (the no-share probe);
    ``pattern`` permutes arrival order, not identity."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, n) for n in (11, 19, 7)]
    prompts.append(prompts[0].copy())
    decode = (6, 5, 7, 4)
    ticks = {"burst": (0, 0, 0, 0), "staggered": (0, 2, 4, 6),
             "reversed": (6, 4, 2, 0)}[pattern]
    return [scheduler.Request(rid=i, prompt=p, max_new_tokens=d,
                              arrival_tick=t)
            for i, (p, d, t) in enumerate(zip(prompts, decode, ticks))]


def _ref_solo_streams(params_ref, cfg_ref, requests, slot_len):
    """The reference alone, request by request: its int8 single-shot
    prefill (``chunked_prefill``), then batch-1 int8 decode, sampling with
    the scheduler's keys."""
    decode = jax.jit(functools.partial(RE.decode_step_slots, cfg=cfg_ref,
                                       top_k=TOP_K))
    streams = {}
    for req in requests:
        last, caches, length = RE.chunked_prefill(
            params_ref, jnp.asarray(req.prompt)[None], cfg_ref,
            max_len=slot_len, chunk=CHUNK)
        logits = RE.logits_from_hidden(params_ref, last, cfg_ref)
        tok = RE.sample_per_slot(_ref_key(req.rid, 0)[None], logits, TOP_K)
        tokens = [int(tok[0])]
        lens = jnp.asarray([int(length)], jnp.int32)
        for i in range(1, req.max_new_tokens):
            tok, caches, lens = decode(params_ref, caches, lens, tok[:, None],
                                       rngs=_ref_key(req.rid, i)[None])
            tokens.append(int(tok[0]))
        streams[req.rid] = tokens
    return streams


@pytest.fixture(scope="module")
def solo(model):
    params_ref, cfg_ref, _, _ = model
    return _ref_solo_streams(params_ref, cfg_ref, _workload("burst"),
                             SLOT_LEN)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
@pytest.mark.parametrize("pattern", ["burst", "staggered", "reversed"])
def test_int8_streams_equal_reference_solo_runs(model, solo, pattern, paged):
    """Each request's int8 stream, served by the port's scheduler with
    others arriving burst, staggered or reversed, equals the reference's
    solo run of it; every prompt prefills in one chunk; paged, nothing is
    shared (rid 3 repeats rid 0's prompt), nothing parks in the prefix
    cache, and every block is free again at the end."""
    _, _, params, cfg = model
    kw = dict(paged=True, block_size=BLOCK) if paged else dict(paged=False)
    eng = Engine(params, cfg, num_slots=2, slot_len=SLOT_LEN,
                 prefill_chunk=CHUNK, top_k=TOP_K, noise_fn=ref_noise,
                 device="cpu", **kw)
    report = eng.serve(_workload(pattern))
    got = {r.rid: r.tokens for r in report.results}
    assert got == solo
    assert len({t for s in got.values() for t in s}) > 1
    sched = eng.scheduler
    assert report.prefill_chunks == sched.prefills_done == 4
    assert sorted(sched.chunk_widths.elements()) == [7, 11, 11, 19]
    if paged:
        p = report.paged
        assert p["blocks_shared"] == p["cow_copies"] == 0
        assert p["tokens_reused"] == 0
        assert p["prefix_cache_hits"] == p["cached_blocks"] == 0
        assert p["free_blocks"] == p["num_blocks"]
        sched.pool.alloc.check_invariants()


def test_long_prompt_prefills_in_one_chunk_paged(model):
    """A prompt of 3 × chunk + 5 tokens goes in one chunk under paging (the
    reference's single-shot rule), and its stream equals the reference's
    solo run."""
    params_ref, cfg_ref, params, cfg = model
    prompt = np.random.default_rng(21).integers(0, 512, 3 * CHUNK + 5)
    req = scheduler.Request(rid=7, prompt=prompt, max_new_tokens=4)
    eng = Engine(params, cfg, num_slots=2, slot_len=SLOT_LEN,
                 prefill_chunk=CHUNK, top_k=TOP_K, noise_fn=ref_noise,
                 paged=True, block_size=BLOCK, device="cpu")
    report = eng.serve([req])
    assert report.prefill_chunks == 1
    assert dict(eng.scheduler.chunk_widths) == {3 * CHUNK + 5: 1}
    want = _ref_solo_streams(params_ref, cfg_ref, [req], SLOT_LEN)
    assert report.results[0].tokens == want[7]
    _, _, length = engine.chunked_prefill(params, _t(prompt)[None], cfg,
                                          max_len=SLOT_LEN, chunk=CHUNK)
    assert length == 3 * CHUNK + 5


def test_int8_lockstep_ids_equal_reference(model):
    """The port's lockstep loop over int8 caches from the reference's
    prompts and noise gives the reference's prefill / decode_step tokens."""
    params_ref, cfg_ref, params, cfg = model
    args = serve.parse_args(["--smoke", "--device", "cpu", "--batch", "3",
                             "--prompt-len", "12", "--tokens", "6",
                             "--kv-cache-dtype", "int8"])
    assert serve.config_for(args).kv_cache_dtype == "int8"
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (3, 12), 0, cfg.vocab_size))

    def noise(step):
        key = (jax.random.PRNGKey(3) if step == 0
               else jax.random.fold_in(BASE_KEY, step - 1))
        return np.asarray(jax.random.gumbel(key, (3, TOP_K), jnp.float32))

    ids = serve.lockstep(args, cfg, params, prompts=prompts, noise_fn=noise)
    last, caches, length = RE.prefill(params_ref, jnp.asarray(prompts),
                                      cfg_ref, max_len=18)
    assert "k_scale" in caches[0]["attn"]
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
    _, caches_t, _ = engine.prefill(params, _t(prompts), cfg, max_len=18)
    assert caches_t["k"].dtype == torch.int8
    assert caches_t["k_scale"].dtype == torch.bfloat16


_COUNTER_LINES = re.compile(r"^(paged continuous batching|continuous "
                            r"batching|decode steps|batch occupancy|block "
                            r"pool|blocks saved|prefix cache):.*$", re.M)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_cli_int8_counters_equal_reference_cli(paged, capsys):
    """``python -m repro_torch.launch.serve --smoke --continuous [--paged]
    --kv-cache-dtype int8`` prints the reference CLI's counter lines on the
    same flags: pool geometry, decode steps, one prefill chunk per request,
    occupancy and, paged, 0 blocks shared and nothing cached."""
    argv = README_ARGS + (PAGED_FLAGS if paged else [])
    rc = serve.main(argv)
    mine = capsys.readouterr().out
    ref_argv = [a for a in argv if a not in ("--device", "cpu")]
    ref_rc = RSV.main(ref_argv)
    theirs = capsys.readouterr().out
    assert rc == ref_rc
    mine_lines = [m.group(0) for m in _COUNTER_LINES.finditer(mine)]
    assert mine_lines == [m.group(0) for m in _COUNTER_LINES.finditer(theirs)]
    assert "prefill chunks: 5" in mine
    if paged:
        assert "blocks saved by sharing: 0 (prefill tokens reused: 0, " \
               "copy-on-write copies: 0)" in mine
        assert "prefix cache: 0 blocks resident, 0 hits" in mine
