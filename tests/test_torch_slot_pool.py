"""The port's slot pool and lockstep baseline against the JAX package, on the
CPU.

Module by module — ``cache_write``, ``attention_apply``'s contiguous-cache
branch, ``topk_sample`` and the engine's lockstep (``prefill``,
``decode_step``) and slot-pool (``chunked_prefill``, ``prefill_chunk``,
``write_slot``, ``decode_step_slots``) primitives — with the reference's
weights carried across by ``models.convert.params_from_numpy``; then the
paths as a whole: the README's workload served unpaged by the port's
``Engine`` must give, request by request, the reference's solo stream under
the same Gumbel noise (and the reference Engine's own counters); the same
workload served paged and unpaged by the port gives the same streams; and
the lockstep loop gives the reference ``_lockstep``'s tokens from the same
prompts and noise.

Tolerances: float32 everywhere (smoke config); the packages compute the same
math with other matmul kernels and summation orders, so float results agree
to ~1e-5 and sampled token streams exactly.
"""
import functools
import re
import types

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
from repro.serving import engine_api as RA  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.topk_fusion import topk_sample  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import engine, scheduler  # noqa: E402
from repro_torch.serving.engine_api import Engine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TOP_K = 5
BASE_KEY = jax.random.PRNGKey(0)
# the README's doctest workload, served from the slot pool (no --paged)
README_ARGS = ["--smoke", "--continuous", "--device", "cpu", "--requests",
               "5", "--tokens", "8", "--prompt-len", "10", "--slots", "2",
               "--rate", "3.0", "--prefill-chunk", "8"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """(reference params, reference cfg, port params, port cfg): the same
    weights, from the reference's ``transformer.init``, with the embedding
    scaled down so the smoke model's next-token distribution is not one
    dominant token (with tied embeddings it repeats its input otherwise),
    which makes the sampled streams discriminate."""
    cfg_ref = ref_configs.get_smoke("smollm_360m")
    params_ref, _ = RL.split_params(RT.init(jax.random.PRNGKey(0), cfg_ref))
    params_ref["embedding"]["embed"] = params_ref["embedding"]["embed"] * 0.05
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), \
        configs.get_smoke("smollm_360m")


def _ref_key(rid, i):
    return jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)


def ref_noise(rid, i, k):
    """The reference scheduler's per-(request, token) Gumbel draw."""
    return np.asarray(jax.random.gumbel(_ref_key(rid, i), (k,), jnp.float32))


def _ref_kv(caches_ref, name):
    return np.asarray(caches_ref[0]["attn"][name])


# ---------------------------------------------------------------------------
# Module by module.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cache_len", [3, [2, 5, 0]],
                         ids=["scalar", "per-row"])
def test_cache_write_matches_reference(cache_len):
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((3, 9, 2, 4)).astype(np.float32)
    new = rng.standard_normal((3, 4, 2, 4)).astype(np.float32)
    lens = np.asarray(cache_len, np.int32)
    ref = RL.cache_write(jnp.asarray(cache), jnp.asarray(new),
                         jnp.asarray(lens))
    arg = cache_len if isinstance(cache_len, int) else _t(lens)
    got = L.cache_write(_t(cache), _t(new), arg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("t,cache_len", [(1, [6, 0, 9]), (5, [3, 7, 0]),
                                         (5, 4), (1, 6)],
                         ids=["decode-per-row", "prefill-per-row",
                              "prefill-scalar", "decode-scalar"])
def test_attention_apply_contiguous_matches_reference(model, t, cache_len):
    """The contiguous branch: K/V written at ``cache_len`` (per-row or
    shared), then chunked prefill at ``cache_len > 0`` (t > 1, causal in
    absolute coordinates) or decode (t == 1)."""
    params_ref, cfg_ref, params, cfg = model
    rng = np.random.default_rng(2)
    hkv, hd, s = cfg.num_kv_heads, cfg.resolved_head_dim, 16
    k0 = rng.standard_normal((3, s, hkv, hd)).astype(np.float32)
    v0 = rng.standard_normal((3, s, hkv, hd)).astype(np.float32)
    x = rng.standard_normal((3, t, cfg.d_model)).astype(np.float32)
    lens = np.broadcast_to(np.asarray(cache_len, np.int32), (3,))
    positions = lens[:, None] + np.arange(t, dtype=np.int32)
    if isinstance(cache_len, int):
        positions = positions[0]
    p_ref = jax.tree.map(lambda a: a[0], params_ref["segments"][0]["attn"])
    out_ref, cache_ref = RL.attention_apply(
        p_ref, jnp.asarray(x), cfg_ref, positions=jnp.asarray(positions),
        cache={"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        cache_len=jnp.asarray(np.asarray(cache_len, np.int32)))
    arg = cache_len if isinstance(cache_len, int) else _t(lens)
    out, cache = L.attention_apply(
        params["layers"][0]["attn"], _t(x), cfg, positions=_t(positions),
        cache={"k": _t(k0), "v": _t(v0)}, cache_len=arg)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(cache_ref[name]), **TOL)


def test_topk_sample_matches_reference():
    """Same logits, same Gumbels: the same tokens and top-k probabilities;
    a generator stands in for the noise when none is given."""
    x = np.random.default_rng(4).standard_normal((6, 300)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tok_ref, vals_ref = ref_topk_sample(key, jnp.asarray(x), TOP_K)
    g = np.asarray(jax.random.gumbel(key, (6, TOP_K), jnp.float32))
    tok, vals = topk_sample(_t(x), TOP_K, noise=_t(g))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_ref))
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_ref), **TOL)
    a, _ = topk_sample(_t(x), TOP_K,
                       generator=torch.Generator().manual_seed(1))
    b, _ = topk_sample(_t(x), TOP_K,
                       generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="Gumbels"):
        topk_sample(_t(x), TOP_K)


def test_lockstep_prefill_and_decode_match_reference(model):
    """``prefill`` into fresh caches, then two ``decode_step``s at the
    shared length, sampling with the reference's batch-wide Gumbels."""
    params_ref, cfg_ref, params, cfg = model
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 9))
    last_ref, caches_ref, len_ref = RE.prefill(
        params_ref, jnp.asarray(prompts), cfg_ref, max_len=14)
    last, caches, length = engine.prefill(params, _t(prompts), cfg,
                                          max_len=14)
    assert length == int(len_ref) == 9
    np.testing.assert_allclose(last.numpy(), np.asarray(last_ref), **TOL)
    np.testing.assert_allclose(caches["k"].numpy(),
                               _ref_kv(caches_ref, "k"), **TOL)
    tok_ref = tok = np.array([3, 77, 200])
    tok = _t(tok)
    for i in range(2):
        key = jax.random.fold_in(BASE_KEY, i)
        tok_ref, caches_ref, len_ref = RE.decode_step(
            params_ref, caches_ref, len_ref, jnp.asarray(tok_ref)[:, None],
            cfg_ref, rng=key, top_k=TOP_K)
        g = np.asarray(jax.random.gumbel(key, (3, TOP_K), jnp.float32))
        tok, caches, length = engine.decode_step(
            params, caches, length, tok[:, None], cfg, noise=_t(g),
            top_k=TOP_K)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_ref))
    assert length == int(len_ref) == 11
    np.testing.assert_allclose(caches["v"].numpy(), _ref_kv(caches_ref, "v"),
                               **TOL)


def test_slot_primitives_match_reference(model):
    """``chunked_prefill`` of two prompts (chunks at ``cache_len > 0``,
    one-token tails), ``write_slot`` of each into a two-slot pool, then one
    ``decode_step_slots`` at ragged lengths with per-slot Gumbels."""
    params_ref, cfg_ref, params, cfg = model
    slot_len = 16
    pool_ref = RE.init_cache(cfg_ref, 2, slot_len)
    pool = engine.init_cache(cfg, 2, slot_len, "cpu")
    rng = np.random.default_rng(5)
    lens = []
    for slot, n in ((1, 11), (0, 7)):
        prompt = rng.integers(0, cfg.vocab_size, (1, n))
        last_ref, seq_ref, len_ref = RE.chunked_prefill(
            params_ref, jnp.asarray(prompt), cfg_ref, max_len=slot_len,
            chunk=4)
        last, seq, length = engine.chunked_prefill(
            params, _t(prompt), cfg, max_len=slot_len, chunk=4)
        assert length == int(len_ref) == n
        np.testing.assert_allclose(last.numpy(), np.asarray(last_ref), **TOL)
        pool_ref = RE.write_slot(cfg_ref, pool_ref, seq_ref, slot)
        engine.write_slot(cfg, pool, seq, slot)
        lens.append((slot, n))
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name].numpy(),
                                   _ref_kv(pool_ref, name), **TOL)
    slot_lens = np.array([7, 11], np.int32)
    toks = np.array([[12], [40]], np.int64)
    keys = jnp.stack([_ref_key(0, 1), _ref_key(1, 1)])
    tok_ref, pool_ref, new_ref = RE.decode_step_slots(
        params_ref, pool_ref, jnp.asarray(slot_lens), jnp.asarray(toks),
        cfg_ref, rngs=keys, top_k=TOP_K)
    noise = torch.stack([_t(ref_noise(0, 1, TOP_K)),
                         _t(ref_noise(1, 1, TOP_K))])
    tok, pool, new_lens = engine.decode_step_slots(
        params, pool, _t(slot_lens), _t(toks), cfg, noise=noise, top_k=TOP_K)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_ref))
    assert new_lens.tolist() == np.asarray(new_ref).tolist() == [8, 12]
    np.testing.assert_allclose(pool["k"].numpy(), _ref_kv(pool_ref, "k"),
                               **TOL)


def test_dispatch_routes_contiguous_cpu_tensors_to_plain_versions(model):
    """On the CPU the contiguous routes run the kernels' plain versions:
    decode → ``flash_decode_plain``, cached prefill →
    ``flash_attention_offset_plain``; no kernel launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    cfg = model[3]
    dispatch.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    k = torch.randn(2, 12, 1, 20, generator=gen)
    v = torch.randn(2, 12, 1, 20, generator=gen)
    q = torch.randn(2, 1, 3, 20, generator=gen)
    vlen = torch.tensor([5, 12])
    out = dispatch.sdpa(cfg, q, k, v, causal=False, q_offset=vlen - 1,
                        kv_valid_len=vlen, decode=True)
    assert torch.equal(out, fd.flash_decode_plain(q, k, v, vlen,
                                                  chunk_size=cfg.attn_chunk))
    q = torch.randn(2, 4, 3, 20, generator=gen)
    out = dispatch.sdpa(cfg, q, k, v, causal=True, q_offset=vlen - 4,
                        kv_valid_len=vlen)
    want, _ = fa.flash_attention_offset_plain(q, k, v, vlen - 4, vlen,
                                              chunk_size=cfg.attn_chunk)
    assert torch.equal(out, want)
    assert set(dispatch.launch_counts().values()) == {0}


def test_slot_pool_accounting():
    cfg = configs.get_smoke("smollm_360m")
    pool = scheduler.SlotPool(cfg, 2, 8, device="cpu")
    assert pool.caches["k"].shape == (cfg.num_layers, 2, 8, cfg.num_kv_heads,
                                      cfg.resolved_head_dim)
    a, b = pool.acquire(), pool.acquire()
    assert (a, b, pool.acquire(), pool.free_slots) == (0, 1, None, 0)
    seq = engine.init_cache(cfg, 1, 8, "cpu")
    seq["k"].fill_(2.0)
    pool.insert(b, seq, 5)
    assert pool.lens.tolist() == [0, 5]
    assert torch.equal(pool.caches["k"][:, b], seq["k"][:, 0])
    assert not pool.caches["k"][:, a].any()
    pool.release(b)
    assert pool.lens.tolist() == [0, 0] and pool.free_slots == 1


# ---------------------------------------------------------------------------
# The paths as a whole.
# ---------------------------------------------------------------------------
def _ref_solo_streams(params_ref, cfg_ref, requests, slot_len, chunk):
    """The reference alone, request by request: chunked prefill into a fresh
    cache, then batch-1 decode, sampling with the scheduler's keys."""
    prefill = jax.jit(functools.partial(RE.prefill_chunk, cfg=cfg_ref))
    decode = jax.jit(functools.partial(RE.decode_step_slots, cfg=cfg_ref,
                                       top_k=TOP_K))
    streams = {}
    for req in requests:
        caches = RE.init_cache(cfg_ref, 1, slot_len)
        length, pos = jnp.asarray(0, jnp.int32), 0
        prompt = jnp.asarray(req.prompt)[None]
        for w in RE.prefill_schedule(len(req.prompt), chunk):
            last, caches, length = prefill(params_ref, caches, length,
                                           prompt[:, pos:pos + w])
            pos += w
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
def readme_runs(model):
    params_ref, cfg_ref, params, cfg = model
    args = serve.parse_args(README_ARGS)
    requests, slot_len = serve.workload(args, cfg)
    report, eng, _, _ = serve.run(args, cfg, params, noise_fn=ref_noise)
    ref_requests = RS.poisson_workload(
        args.requests, rate_per_tick=args.rate, prompt_lens=(2, 10),
        decode_lens=(2, 8), vocab=cfg_ref.vocab_size, seed=1)
    ref_report = RA.Engine(
        params_ref, cfg_ref, num_slots=args.slots, slot_len=slot_len,
        prefill_chunk=args.prefill_chunk, top_k=TOP_K, base_rng=BASE_KEY,
        paged=False).serve(ref_requests)
    solo = _ref_solo_streams(params_ref, cfg_ref, requests, slot_len,
                             args.prefill_chunk)
    return dict(args=args, requests=requests, slot_len=slot_len,
                report=report, engine=eng, ref_report=ref_report, solo=solo)


def test_slot_pool_streams_equal_reference_solo_runs(readme_runs):
    report, solo = readme_runs["report"], readme_runs["solo"]
    got = {r.rid: r.tokens for r in report.results}
    assert got == solo
    assert sum(len(t) for t in got.values()) == report.total_tokens > 0
    assert len({t for s in got.values() for t in s}) > 1
    assert readme_runs["slot_len"] == 10 + 8 + 8     # not block-rounded


def test_slot_pool_scheduling_equals_reference(readme_runs):
    """Same workload, same scheduling decisions: the reference's unpaged
    Engine gives the same counters, occupancy and streams; the report has
    no block-pool accounting."""
    mine, ref = readme_runs["report"], readme_runs["ref_report"]
    assert mine.paged is None and ref.paged is None
    assert (mine.decode_steps, mine.prefill_chunks) == \
        (ref.decode_steps, ref.prefill_chunks)
    assert mine.occupancy == pytest.approx(ref.occupancy)
    assert {r.rid: r.tokens for r in mine.results} == \
        {r.rid: r.tokens for r in ref.results}
    eng = readme_runs["engine"]
    assert not eng.scheduler.paged and eng.stats()["free_slots"] == 2
    assert "free_blocks" not in eng.stats()


def test_paged_and_unpaged_serve_identical_streams(model):
    """The port against itself: the README workload (shared prefix
    included) served from the block pool and from the slot pool, with the
    port's own per-request generators, gives the same streams."""
    _, _, params, cfg = model
    args = serve.parse_args(README_ARGS + ["--paged", "--block-size", "8",
                                           "--shared-prefix", "8"])
    requests, slot_len = serve.workload(args, cfg)
    kw = dict(num_slots=args.slots, slot_len=slot_len,
              prefill_chunk=args.prefill_chunk, top_k=TOP_K, seed=11,
              block_size=args.block_size, device="cpu")
    paged = Engine(params, cfg, paged=True, **kw).serve(requests)
    unpaged = Engine(params, cfg, paged=False, **kw).serve(requests)
    assert paged.paged["blocks_shared"] > 0 and unpaged.paged is None
    assert {r.rid: r.tokens for r in paged.results} == \
        {r.rid: r.tokens for r in unpaged.results}


def _ref_lockstep_noise(batch):
    """The reference ``_lockstep``'s draws: PRNGKey(3) for the token after
    the prefill, ``fold_in(PRNGKey(0), i)`` for decode step i."""
    def noise(step):
        key = (jax.random.PRNGKey(3) if step == 0
               else jax.random.fold_in(BASE_KEY, step - 1))
        return np.asarray(jax.random.gumbel(key, (batch, TOP_K), jnp.float32))
    return noise


def test_lockstep_tokens_equal_reference(model, capsys):
    """The port's lockstep loop from the reference's prompts and noise
    gives the reference's tokens, every row (against the reference's
    prefill / decode_step loop) and in the printed line (against the
    reference CLI's ``_lockstep`` itself)."""
    params_ref, cfg_ref, params, cfg = model
    argv = ["--smoke", "--device", "cpu", "--batch", "3", "--prompt-len",
            "12", "--tokens", "6"]
    args = serve.parse_args(argv)
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (args.batch, args.prompt_len), 0,
        cfg.vocab_size))
    noise = _ref_lockstep_noise(args.batch)
    ids = serve.lockstep(args, cfg, params, prompts=prompts, noise_fn=noise)
    mine = capsys.readouterr().out

    last, caches, length = RE.prefill(params_ref, jnp.asarray(prompts),
                                      cfg_ref, max_len=18)
    logits = RT.logits_last(params_ref, last[:, None], cfg_ref)
    tok, _ = ref_topk_sample(jax.random.PRNGKey(3), logits, TOP_K)
    want = [np.asarray(tok)]
    for i in range(args.tokens - 1):
        tok, caches, length = RE.decode_step(
            params_ref, caches, length, tok[:, None], cfg_ref,
            rng=jax.random.fold_in(BASE_KEY, i), top_k=TOP_K)
        want.append(np.asarray(tok))
    want = np.stack(want, axis=1)
    assert ids.shape == (3, 6)
    np.testing.assert_array_equal(ids, want)
    assert len(set(ids.ravel().tolist())) > 1

    ref_args = types.SimpleNamespace(max_len=0, prompt_len=12, tokens=6,
                                     batch=3, top_k=TOP_K)
    RSV._lockstep(ref_args, cfg_ref, params_ref)
    theirs = capsys.readouterr().out
    line = re.compile(r"^sample token ids: .*$", re.M)
    assert line.search(mine).group(0) == line.search(theirs).group(0)


@pytest.mark.parametrize("extra", [[], ["--continuous"]],
                         ids=["lockstep", "slot-pool"])
def test_cli_runs_unpaged_paths_on_cpu(extra, capsys):
    """``python -m repro_torch.launch.serve --smoke [--continuous]
    --device cpu`` runs and prints the reference's report lines, without
    block-pool lines when unpaged."""
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                     "--tokens", "4", "--prompt-len", "8", "--batch", "2"]
                    + extra)
    out = capsys.readouterr().out
    if extra:
        assert rc in (0, 1)
        assert out.startswith("continuous batching: 4 requests over 4 slots "
                              "(slot_len=20, prefill_chunk=16)")
        assert "decode steps: " in out and "block pool" not in out
    else:
        assert rc == 0
        assert re.search(r"^prefill: 2×8 in ", out, re.M)
        assert re.search(r"^decode: 3 steps × 2 seqs in ", out, re.M)
        assert re.search(r"^sample token ids: \[(\d+, ){3}\d+\]$", out, re.M)
