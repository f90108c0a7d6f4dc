"""The port's model and serving path against the JAX package, on the CPU.

Module by module — ``paged_cache_write``, ``attention_apply``'s paged branch,
``transformer.forward``, the engine's paged prefill and decode — with the
reference's weights carried across by ``models.convert.params_from_numpy``;
then the slice as a whole: the README's workload served by the port's
``Engine`` must give, request by request, the token stream of the
reference's solo run of that request under the same Gumbel noise, and the
block pool's sharing counters must equal the reference's paged run.

The port also pins its own invariants: batched streams equal solo streams,
and a decode tick never writes into an in-flight prefill's blocks.

Tolerances: float32 everywhere (smoke config); the packages compute the same
math with other matmul kernels and summation orders, so float results agree
to ~1e-5 and sampled token streams exactly.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.serving import engine_api as RA  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs.clock import VirtualClock  # noqa: E402
from repro_torch.serving import engine, paged, scheduler  # noqa: E402
from repro_torch.serving.engine_api import Engine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TOP_K = 5
BASE_KEY = jax.random.PRNGKey(0)
# the README's doctest workload
README_ARGS = ["--smoke", "--continuous", "--paged", "--device", "cpu",
               "--requests", "5", "--tokens", "8", "--prompt-len", "10",
               "--slots", "2", "--rate", "3.0", "--prefill-chunk", "8",
               "--block-size", "8", "--shared-prefix", "8"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """(reference params, reference cfg, port params, port cfg): the same
    weights, from the reference's ``transformer.init``."""
    cfg_ref = ref_configs.get_smoke("smollm_360m")
    params_ref, _ = RL.split_params(RT.init(jax.random.PRNGKey(0), cfg_ref))
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), \
        configs.get_smoke("smollm_360m")


def _ref_key(rid, i):
    return jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)


def ref_noise(rid, i, k):
    """The reference scheduler's per-(request, token) Gumbel draw
    (``scheduler.py:579`` key, ``engine.sample_per_slot`` draw)."""
    return np.asarray(jax.random.gumbel(_ref_key(rid, i), (k,), jnp.float32))


# ---------------------------------------------------------------------------
# Module by module.
# ---------------------------------------------------------------------------
def test_params_from_numpy_carries_every_weight(model):
    params_ref, cfg_ref, params, _ = model
    assert len(params["layers"]) == cfg_ref.num_layers
    seg = params_ref["segments"][0]
    for i, lp in enumerate(params["layers"]):
        np.testing.assert_array_equal(lp["attn"]["wq"].numpy(),
                                      np.asarray(seg["attn"]["wq"][i]))
        np.testing.assert_array_equal(lp["mlp"]["w_gate"].numpy(),
                                      np.asarray(seg["mlp"]["w_gate"][i]))
        np.testing.assert_array_equal(lp["ln2"].numpy(),
                                      np.asarray(seg["ln2"]["scale"][i]))
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(params_ref["embedding"]["embed"]))


def test_init_shapes_match_reference(model):
    params_ref, _, params, cfg = model
    mine = transformer.init(cfg, seed=3, device="cpu")
    assert mine["embed"].shape == params["embed"].shape
    for a, b in zip(mine["layers"], params["layers"]):
        for k in ("wq", "wk", "wv", "wo"):
            assert a["attn"][k].shape == b["attn"][k].shape
        assert {k: v.shape for k, v in a["mlp"].items()} == \
            {k: v.shape for k, v in b["mlp"].items()}
    again = transformer.init(cfg, seed=3, device="cpu")
    assert torch.equal(mine["layers"][1]["attn"]["wo"],
                       again["layers"][1]["attn"]["wo"])


def test_paged_cache_write_matches_reference():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((7, 2, 4, 6)).astype(np.float32)
    new = rng.standard_normal((3, 3, 2, 6)).astype(np.float32)
    lens = np.array([2, 5, 0], np.int32)
    tables = np.array([[3, 1, 0], [6, 2, 4], [5, 0, 0]], np.int32)
    ref = RL.paged_cache_write(jnp.asarray(pool), jnp.asarray(new),
                               jnp.asarray(lens), jnp.asarray(tables))
    got = L.paged_cache_write(_t(pool), _t(new), _t(lens), _t(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_forward_matches_reference(model):
    params_ref, cfg_ref, params, cfg = model
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 7))
    ref, _, _ = RT.forward(params_ref, jnp.asarray(tokens), cfg_ref)
    got, _ = transformer.forward(params, _t(tokens), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        transformer.logits_last(params, got, cfg).numpy(),
        np.asarray(RT.logits_last(params_ref, ref, cfg_ref)), rtol=1e-5,
        atol=1e-4)


@pytest.mark.parametrize("t,cache_len", [(5, [3, 0]), (1, [6, 9])])
def test_attention_apply_paged_matches_reference(model, t, cache_len):
    """The paged branch: K/V written through the table, then prefill
    (t > 1, causal, absolute coordinates) or decode (t == 1)."""
    params_ref, cfg_ref, params, cfg = model
    rng = np.random.default_rng(2)
    hkv, hd, bs = cfg.num_kv_heads, cfg.resolved_head_dim, 4
    pool_k = rng.standard_normal((9, hkv, bs, hd)).astype(np.float32)
    pool_v = rng.standard_normal((9, hkv, bs, hd)).astype(np.float32)
    tables = np.array([[2, 5, 7, 0], [1, 3, 4, 8]], np.int32)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    lens = np.asarray(cache_len, np.int32)
    positions = lens[:, None] + np.arange(t, dtype=np.int32)
    p_ref = jax.tree.map(lambda a: a[0], params_ref["segments"][0]["attn"])
    out_ref, cache_ref = RL.attention_apply(
        p_ref, jnp.asarray(x), cfg_ref, positions=jnp.asarray(positions),
        cache={"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
        cache_len=jnp.asarray(lens), block_tables=jnp.asarray(tables))
    cache = {"k": _t(pool_k), "v": _t(pool_v)}
    out, cache = L.attention_apply(
        params["layers"][0]["attn"], _t(x), cfg, positions=_t(positions),
        cache=cache, cache_len=_t(lens), block_tables=_t(tables))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(cache_ref[name]), **TOL)


def test_engine_prefill_and_decode_match_reference(model):
    """``prefill_chunk_paged`` over two chunks, then one batched
    ``decode_step_paged`` sampling with the reference's noise."""
    params_ref, cfg_ref, params, cfg = model
    bs, m = 4, 5
    pools_ref = RE.init_paged_cache(cfg_ref, 11, bs)
    pools = engine.init_paged_cache(cfg, 11, bs, "cpu")
    tables = np.array([[1, 2, 3, 4, 0], [5, 6, 7, 8, 9]], np.int32)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 11))
    lasts = []
    for row in range(2):
        length_ref, length = jnp.int32(0), 0
        for lo, hi in ((0, 8), (8, 11)):
            last_ref, pools_ref, length_ref = RE.prefill_chunk_paged(
                params_ref, pools_ref, jnp.asarray(tables[row:row + 1]),
                length_ref, jnp.asarray(prompts[row:row + 1, lo:hi]), cfg_ref)
            last, pools, length = engine.prefill_chunk_paged(
                params, pools, _t(tables[row:row + 1]), length,
                _t(prompts[row:row + 1, lo:hi]), cfg)
        np.testing.assert_allclose(last.numpy(), np.asarray(last_ref), **TOL)
        lasts.append(last)
    np.testing.assert_allclose(pools["k"].numpy(),
                               np.asarray(pools_ref[0]["attn"]["k"]), **TOL)
    lens = np.array([11, 11], np.int32)
    toks = np.array([[4], [17]], np.int64)
    keys = jnp.stack([_ref_key(0, 1), _ref_key(1, 1)])
    tok_ref, _, _ = RE.decode_step_paged(
        params_ref, pools_ref, jnp.asarray(tables), jnp.asarray(lens),
        jnp.asarray(toks), cfg_ref, rngs=keys, top_k=TOP_K)
    noise = torch.stack([_t(ref_noise(0, 1, TOP_K)), _t(ref_noise(1, 1,
                                                                  TOP_K))])
    tok, _, new_lens = engine.decode_step_paged(
        params, pools, _t(tables), _t(lens), _t(toks), cfg, noise=noise,
        top_k=TOP_K)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_ref))
    assert new_lens.tolist() == [12, 12]
    logits_ref = RE.logits_from_hidden(params_ref, jnp.asarray(
        torch.cat(lasts).numpy()), cfg_ref)
    np.testing.assert_allclose(
        engine.logits_from_hidden(params, torch.cat(lasts), cfg).numpy(),
        np.asarray(logits_ref), rtol=1e-5, atol=1e-4)


def test_prefill_schedule_matches_reference():
    for t in (1, 7, 8, 29, 64, 100):
        for chunk in (1, 8, 32):
            assert engine.prefill_schedule(t, chunk) == \
                RE.prefill_schedule(t, chunk)


def test_poisson_workload_matches_reference():
    kw = dict(rate_per_tick=3.0, prompt_lens=(2, 10), decode_lens=(2, 8),
              vocab=512, seed=1, shared_prefix=8)
    for a, b in zip(scheduler.poisson_workload(6, **kw),
                    RS.poisson_workload(6, **kw)):
        assert (a.rid, a.max_new_tokens, a.arrival_tick) == \
            (b.rid, b.max_new_tokens, b.arrival_tick)
        np.testing.assert_array_equal(a.prompt, b.prompt)


# ---------------------------------------------------------------------------
# The slice as a whole.
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
    report, router, _, _ = serve.run(args, cfg, params, noise_fn=ref_noise)
    eng = router.engines[0]
    ref_requests = RS.poisson_workload(
        args.requests, rate_per_tick=args.rate, prompt_lens=(2, 10),
        decode_lens=(2, 8), vocab=cfg_ref.vocab_size, seed=1,
        shared_prefix=8)
    ref_report = RA.Engine(
        params_ref, cfg_ref, num_slots=args.slots, slot_len=slot_len,
        prefill_chunk=args.prefill_chunk, top_k=TOP_K, base_rng=BASE_KEY,
        paged=True, block_size=args.block_size).serve(ref_requests)
    solo = _ref_solo_streams(params_ref, cfg_ref, requests, slot_len,
                             args.prefill_chunk)
    return dict(args=args, requests=requests, slot_len=slot_len,
                report=report, engine=eng, ref_report=ref_report, solo=solo)


def test_slice_streams_equal_reference_solo_runs(readme_runs):
    report, solo = readme_runs["report"], readme_runs["solo"]
    got = {r.rid: r.tokens for r in report.results}
    assert got == solo
    assert sum(len(t) for t in got.values()) == report.total_tokens > 0


def test_slice_pool_accounting_equals_reference(readme_runs):
    """Same workload, same scheduling decisions: the pool's sharing counters
    and the scheduler's counts equal the reference's paged run."""
    mine, ref = readme_runs["report"], readme_runs["ref_report"]
    readme_runs["engine"].scheduler.pool.alloc.check_invariants()
    for key in ("blocks_shared", "tokens_reused", "cow_copies",
                "cached_blocks", "free_blocks", "min_free_blocks"):
        assert mine.paged[key] == ref.paged[key], key
    assert mine.paged["blocks_shared"] > 0          # the prefix really shares
    assert (mine.decode_steps, mine.prefill_chunks) == \
        (ref.decode_steps, ref.prefill_chunks)
    assert mine.occupancy == pytest.approx(ref.occupancy)
    assert {r.rid: r.tokens for r in mine.results} == \
        {r.rid: r.tokens for r in ref.results}


def test_batched_streams_equal_solo_streams(model):
    """The port against itself, with its own per-request generators: each
    request alone in a fresh engine gives the stream it gave batched."""
    _, _, params, cfg = model
    args = serve.parse_args(README_ARGS)
    requests, slot_len = serve.workload(args, cfg)
    kw = dict(num_slots=args.slots, slot_len=slot_len,
              prefill_chunk=args.prefill_chunk, top_k=TOP_K, seed=11,
              block_size=args.block_size, device="cpu")
    batched = Engine(params, cfg, **kw).serve(requests)
    got = {r.rid: r.tokens for r in batched.results}
    for req in requests:
        alone = scheduler.Request(rid=req.rid, prompt=req.prompt,
                                  max_new_tokens=req.max_new_tokens)
        solo = Engine(params, cfg, **kw).serve([alone])
        assert solo.results[0].tokens == got[req.rid], req.rid


def test_decode_tick_never_writes_inflight_prefill_blocks(model):
    """A decode step writes position ``lens`` through every row's table.  B
    is mid-prefill (length 0), so its real table row must be masked to the
    sentinel: (1) exactly — no block but A's own and the sentinel changes;
    (2) B's finished cache equals its solo prefill to float32 last-bit level
    (the same K projection can round differently at another batch shape)."""
    _, _, params, cfg = model
    pool = paged.PagedPool(cfg, num_slots=2, slot_len=24, block_size=8,
                           device="cpu")
    rng = np.random.default_rng(17)
    pa, pb = rng.integers(0, 512, 9), rng.integers(0, 512, 12)
    sa = pool.admit(pa)
    _, _, ln_a = engine.prefill_chunk_paged(
        params, pool.caches, pool.device_row(sa.slot), 0, _t(pa)[None], cfg)
    pool.finalize_prefill(sa)
    pool.lens[sa.slot] = ln_a
    sb = pool.admit(pb)
    _, _, ln_b = engine.prefill_chunk_paged(
        params, pool.caches, pool.device_row(sb.slot), 0, _t(pb[:7])[None],
        cfg)
    assert pool.prepare_write(sa.slot, ln_a)
    others = [b for b in range(pool.alloc.num_blocks)
              if b not in pool.seqs[sa.slot].blocks and b != 0]
    before = {n: p[:, others].clone() for n, p in pool.caches.items()}
    sensitive = {n: p.clone() for n, p in pool.caches.items()}
    args = (_t(pool.lens), torch.tensor([[3], [0]]), cfg)
    noise = torch.zeros(2, TOP_K)
    engine.decode_step_paged(params, pool.caches,
                             pool.device_tables(active_slots=[sa.slot]),
                             *args, noise=noise, top_k=TOP_K)
    for n, p in pool.caches.items():
        assert torch.equal(p[:, others], before[n]), n
    # without the mask the garbage write lands in B's first block
    engine.decode_step_paged(params, sensitive, pool.device_tables(None),
                             *args, noise=noise, top_k=TOP_K)
    assert not torch.equal(sensitive["k"][:, sb.blocks[0]],
                           pool.caches["k"][:, sb.blocks[0]])
    _, _, ln_b = engine.prefill_chunk_paged(
        params, pool.caches, pool.device_row(sb.slot), ln_b,
        _t(pb[7:])[None], cfg)
    solo = paged.PagedPool(cfg, num_slots=1, slot_len=24, block_size=8,
                           device="cpu")
    ss = solo.admit(pb)
    length = 0
    for lo, hi in ((0, 7), (7, 12)):
        _, _, length = engine.prefill_chunk_paged(
            params, solo.caches, solo.device_row(ss.slot), length,
            _t(pb[lo:hi])[None], cfg)
    for name in ("k", "v"):
        for j, (bid, sid) in enumerate(zip(sb.blocks, ss.blocks)):
            n = min(8, len(pb) - j * 8)
            if n <= 0:
                break
            want = solo.caches[name][:, sid, :, :n]
            scale = want.abs().max().item()
            # a few float32 ulps of the largest entry
            torch.testing.assert_close(
                pool.caches[name][:, bid, :, :n], want, rtol=0,
                atol=8 * np.finfo(np.float32).eps * scale)


# ---------------------------------------------------------------------------
# Engine surface and CLI.
# ---------------------------------------------------------------------------
def test_engine_rejects_bad_requests(model):
    _, _, params, cfg = model
    clock = VirtualClock(5.0)              # time moves only when advanced
    eng = Engine(params, cfg, num_slots=2, slot_len=16, block_size=8,
                 clock=clock, device="cpu")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(scheduler.Request(rid=0, prompt=np.array([], np.int64),
                                     max_new_tokens=2))
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(scheduler.Request(rid=1, prompt=np.arange(16),
                                     max_new_tokens=2))
    eng.submit(scheduler.Request(rid=2, prompt=np.arange(5),
                                 max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(scheduler.Request(rid=2, prompt=np.arange(5),
                                     max_new_tokens=2))
    report = eng.drain()
    assert len(report.results[0].tokens) == 2
    assert report.results[0].latencies == [0.0, 0.0]
    assert report.wall_time == 0.0
    pool = eng.scheduler.pool
    assert pool.probe(np.arange(5)) == 4            # the cached prompt prefix
    pool.alloc.check_invariants()
    assert eng.stats()["finished"] == 1


@pytest.mark.parametrize("extra", [None, ["--replicas", "2"],
                                   ["--priority-classes", "2"],
                                   ["--trace", "t.json"], ["--metrics"],
                                   ["--kv-cache-dtype", "int8",
                                    "--priority-classes", "2"]],
                         ids=["lockstep", "replicas", "priorities", "trace",
                              "metrics", "kv-int8"])
def test_cli_unported_options_say_so(extra):
    """Options whose slices are not ported yet (``--trace``, ``--metrics``)
    are refused in either mode, saying so; the lockstep case asks for
    metrics.  The router (``--replicas``), SLO scheduling
    (``--priority-classes``) and preempt-and-swap of int8 pools are ported
    and parse."""
    argv = (["--smoke", "--device", "cpu", "--metrics"]
            if extra is None
            else ["--smoke", "--continuous", "--paged"] + extra)
    if extra is None or extra[0] in ("--trace", "--metrics"):
        with pytest.raises(SystemExit, match="not ported yet"):
            serve.parse_args(argv)
        return
    args = serve.parse_args(argv)
    assert (args.replicas, args.priority_classes) == (
        2 if "--replicas" in extra else 1,
        2 if "--priority-classes" in extra else 1)
    if "int8" in extra:
        assert args.kv_cache_dtype == "int8"
