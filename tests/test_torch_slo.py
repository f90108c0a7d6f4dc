"""The port's SLO scheduling and preempt-and-swap against the JAX package,
on the CPU.

The same smoke-width fp32 model (the reference's weights carried across by
``models.convert.params_from_numpy``), the same requests and the
reference's Gumbel noise (``noise_fn``) go through the reference's
``ContinuousScheduler`` and the port's, each under its own ``VirtualClock``
advanced 10 ms a tick, so deadline slack reads the same times in both.
Held equal, case by case: the decisions (every admission, resume and
preemption, in order), ``preemptions``, the pool and swap counters, and
every request's token stream, which must also equal the reference's solo
run of that request (a preempted request resumes bit-identically).  Then
the swap mechanics at the pool level (shared blocks kept without a copy, a
bit-exact round trip of every leaf, fp32 and int8 with its scale pages,
freed blocks poisoned), the report's SLO views, the workload generator's
draws, the bounded latency ring and the CLI's counter lines.

Tolerances: none — decisions, counters and token ids are integers and must
be equal; cache contents after a swap round trip must be equal bit for bit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.configs as ref_configs  # noqa: E402
from repro.launch import serve as RSV  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.obs.clock import VirtualClock as RVirtualClock  # noqa: E402
from repro.serving import paged as RP  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs.clock import VirtualClock  # noqa: E402
from repro_torch.serving import engine, paged, scheduler  # noqa: E402
from test_torch_int8 import _ref_solo_streams as _ref_int8_solo  # noqa: E402
from test_torch_serving import _ref_solo_streams, ref_noise  # noqa: E402

SLOT_LEN, BLOCK, CHUNK, TOP_K = 48, 8, 8, 5
BASE_KEY = jax.random.PRNGKey(0)
TICK_S = 0.01


def _t(a):
    return torch.from_numpy(np.array(a))


def _model(kv_cache_dtype=""):
    cfg_ref = ref_configs.get_smoke("smollm_360m")
    cfg = configs.get_smoke("smollm_360m")
    if kv_cache_dtype:
        cfg_ref = cfg_ref.replace(kv_cache_dtype=kv_cache_dtype)
        cfg = cfg.replace(kv_cache_dtype=kv_cache_dtype)
    params_ref, _ = RL.split_params(RT.init(jax.random.PRNGKey(0), cfg_ref))
    if kv_cache_dtype:
        # as in test_torch_int8: a smaller embedding keeps the smoke
        # model's int8 streams from repeating their input token
        params_ref["embedding"]["embed"] = \
            params_ref["embedding"]["embed"] * 0.05
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), cfg


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def int8_model():
    return _model("int8")


def _kw(**kw):
    base = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
                top_k=TOP_K, paged=True, block_size=BLOCK)
    base.update(kw)
    return base


def _schedulers(model, **kw):
    """(reference scheduler, port scheduler) on the same geometry, each
    with its own virtual clock, advanced ``TICK_S`` before every tick, and
    a log of its decisions: ("admit" | "resume" | "preempt", rid)."""
    params_ref, cfg_ref, params, cfg = model
    ref = RS.ContinuousScheduler(params_ref, cfg_ref, base_rng=BASE_KEY,
                                 clock=RVirtualClock(), **_kw(**kw))
    mine = scheduler.ContinuousScheduler(params, cfg, noise_fn=ref_noise,
                                         clock=VirtualClock(), device="cpu",
                                         **_kw(**kw))
    for s in (ref, mine):
        _instrument(s)
    return ref, mine


def _instrument(s):
    s.log = []

    def logged(name, kind, rid_of):
        orig = getattr(s, name)

        def call(arg):
            ok = orig(arg)
            if ok is not False:
                s.log.append((kind, rid_of(arg)))
            return ok
        setattr(s, name, call)

    logged("_start_prefill", "admit", lambda req: req.rid)
    logged("_try_resume", "resume", lambda rid: rid)
    logged("_swap_out", "preempt", lambda flight: flight.req.rid)
    tick = s.tick

    def advancing_tick():
        s.clock.advance(TICK_S)
        tick()
    s.tick = advancing_tick


def _assert_same(rep_ref, rep, ref, mine):
    """Decisions, counters, pool stats and streams equal."""
    assert mine.log == ref.log
    assert rep.preemptions == rep_ref.preemptions
    assert (rep.decode_steps, rep.prefill_chunks) == \
        (rep_ref.decode_steps, rep_ref.prefill_chunks)
    assert rep.paged == rep_ref.paged
    assert [r.rid for r in rep.results] == [r.rid for r in rep_ref.results]
    for a, b in zip(rep.results, rep_ref.results):
        assert (a.tokens, a.preempted, a.evicted) == \
            (b.tokens, b.preempted, b.evicted), a.rid
    mine.pool.alloc.check_invariants()


def _solo(model, requests, slot_len=SLOT_LEN):
    params_ref, cfg_ref, _, _ = model
    return _ref_solo_streams(params_ref, cfg_ref, requests, slot_len, CHUNK)


# ---------------------------------------------------------------------------
# Admission order.
# ---------------------------------------------------------------------------
def test_priority_orders_admission(model):
    """One row, two requests waiting at the same tick: the urgent one is
    admitted (and finishes) first though submitted second."""
    def reqs(impl):
        rng = np.random.default_rng(0)
        return [impl.Request(rid=0, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=3, priority=5),
                impl.Request(rid=1, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=3, priority=0)]
    ref, mine = _schedulers(model, num_slots=1)
    rep_ref, rep = ref.run(reqs(RS)), mine.run(reqs(scheduler))
    _assert_same(rep_ref, rep, ref, mine)
    assert [r.rid for r in rep.results] == [1, 0]
    assert rep.preemptions == 0


@pytest.mark.parametrize("slots", [1, 2])
def test_single_class_degenerates_to_fifo(model, slots):
    def reqs(impl):
        rng = np.random.default_rng(1)
        return [impl.Request(rid=i, prompt=rng.integers(0, 512, 5),
                             max_new_tokens=2) for i in range(3)]
    ref, mine = _schedulers(model, num_slots=slots)
    rep_ref, rep = ref.run(reqs(RS)), mine.run(reqs(scheduler))
    _assert_same(rep_ref, rep, ref, mine)
    assert [rid for _, rid in mine.log] == [0, 1, 2]


@pytest.mark.parametrize("slots", [1, 2])
def test_deadline_orders_admission_within_class(model, slots):
    """Same class, all waiting at once: the tightest deadline first,
    deadline-bearing before deadline-free."""
    def reqs(impl):
        rng = np.random.default_rng(21)
        return [impl.Request(rid=0, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=2),
                impl.Request(rid=1, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=2, slo_ms=60_000.0),
                impl.Request(rid=2, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=2, slo_ms=500.0)]
    ref, mine = _schedulers(model, num_slots=slots)
    rep_ref, rep = ref.run(reqs(RS)), mine.run(reqs(scheduler))
    _assert_same(rep_ref, rep, ref, mine)
    assert [rid for _, rid in mine.log] == [2, 1, 0]


# ---------------------------------------------------------------------------
# Preempt and resume.
# ---------------------------------------------------------------------------
def _priority_workload(impl, pattern):
    """Low-priority long decodes first, an urgent request landing
    mid-flight (the reference's ``test_serving_slo._priority_workload``)."""
    rng = np.random.default_rng(11)
    lo = [impl.Request(rid=i, prompt=rng.integers(0, 512, 9 + 2 * i),
                       max_new_tokens=12, arrival_tick=0, priority=1)
          for i in range(2)]
    tick = {"early": 3, "mid": 5, "late": 8}[pattern]
    return lo + [impl.Request(rid=2, prompt=rng.integers(0, 512, 8),
                              max_new_tokens=4, arrival_tick=tick,
                              priority=0)]


@pytest.mark.parametrize("num_blocks", [None, 8])
@pytest.mark.parametrize("pattern", ["early", "mid", "late"])
def test_preempt_resume_equals_reference(model, pattern, num_blocks):
    """A low-priority decode swapped out for an urgent arrival (row
    pressure, and block pressure with 8 blocks) resumes with the stream of
    the reference's solo run; every decision and counter equals the
    reference scheduler's."""
    ref, mine = _schedulers(model, num_blocks=num_blocks)
    rep_ref = ref.run(_priority_workload(RS, pattern))
    rep = mine.run(_priority_workload(scheduler, pattern))
    _assert_same(rep_ref, rep, ref, mine)
    assert rep.preemptions >= 1 and any(r.preempted for r in rep.results)
    assert ("preempt", 0) in mine.log or ("preempt", 1) in mine.log
    solo = _solo(model, _priority_workload(scheduler, pattern))
    assert {r.rid: r.tokens for r in rep.results} == solo
    assert not any(r.evicted for r in rep.results)
    p = rep.paged
    assert p["swapped_blocks_out"] >= 1
    assert p["swapped_blocks_in"] == p["swapped_blocks_out"]
    assert p["swapped_bytes_out"] == \
        p["swapped_blocks_out"] * mine.pool.block_bytes
    assert p["free_blocks"] + p["cached_blocks"] == p["num_blocks"]


@pytest.mark.parametrize("case", ["preempt-off", "equal-priority"])
def test_no_swap_without_a_lower_priority_victim(model, case):
    """``preempt=False``, or one class only: nothing is swapped, every
    request completes with its solo stream, decisions as the reference's."""
    if case == "preempt-off":
        kw = dict(preempt=False)

        def reqs(impl):
            return _priority_workload(impl, "mid")
    else:
        kw = {}

        def reqs(impl):
            rng = np.random.default_rng(4)
            return [impl.Request(rid=i, prompt=rng.integers(0, 512, 8),
                                 max_new_tokens=6, arrival_tick=i, priority=3)
                    for i in range(4)]
    ref, mine = _schedulers(model, **kw)
    rep_ref, rep = ref.run(reqs(RS)), mine.run(reqs(scheduler))
    _assert_same(rep_ref, rep, ref, mine)
    assert rep.preemptions == 0 and rep.paged["swapped_blocks_out"] == 0
    assert {r.rid: r.tokens for r in rep.results} == \
        _solo(model, reqs(scheduler))


def test_preemption_prefers_deadline_free_victim(model):
    """Among equal-priority victims the deadline-free decode is swapped
    out, though the deadline-bearing one has more decode left."""
    def reqs(impl):
        rng = np.random.default_rng(11)
        return [impl.Request(rid=0, prompt=rng.integers(0, 512, 9),
                             max_new_tokens=14, priority=1, slo_ms=60_000.0),
                impl.Request(rid=1, prompt=rng.integers(0, 512, 11),
                             max_new_tokens=10, priority=1),
                impl.Request(rid=2, prompt=rng.integers(0, 512, 8),
                             max_new_tokens=4, arrival_tick=5, priority=0)]
    ref, mine = _schedulers(model)
    rep_ref, rep = ref.run(reqs(RS)), mine.run(reqs(scheduler))
    _assert_same(rep_ref, rep, ref, mine)
    by_rid = {r.rid: r for r in rep.results}
    assert by_rid[1].preempted >= 1 and by_rid[0].preempted == 0
    assert ("preempt", 1) in mine.log
    assert {r.rid: r.tokens for r in rep.results} == \
        _solo(model, reqs(scheduler))


def test_reclaim_runs_before_preemption(model):
    """Cold prefix-cache blocks satisfy an urgent admission before any
    live lower-priority decode is preempted."""
    ref, mine = _schedulers(model, num_blocks=5)
    for s, impl in ((ref, RS), (mine, scheduler)):
        rng = np.random.default_rng(6)
        s.run([impl.Request(rid=0, prompt=rng.integers(0, 512, 16),
                            max_new_tokens=2, priority=1)])
        assert s.pool.cached_blocks >= 2
        s.report2 = s.run([
            impl.Request(rid=1, prompt=rng.integers(0, 512, 9),
                         max_new_tokens=4, priority=1),
            impl.Request(rid=2, prompt=rng.integers(0, 512, 14),
                         max_new_tokens=2, arrival_tick=4, priority=0)])
    _assert_same(ref.report2, mine.report2, ref, mine)
    assert mine.report2.preemptions == 0
    assert mine.pool.reclaimed_blocks >= 1


def test_int8_preempt_swap_equals_reference(int8_model):
    """Int8 pools swap their scale pages with the payload: the preempted
    run's decisions, counters and streams equal the reference's, and each
    stream equals the reference's solo run (the reference's
    ``test_serving_families.py`` int8 swap workload)."""
    def reqs(impl):
        rng = np.random.default_rng(17)
        lo = [impl.Request(rid=i, prompt=rng.integers(0, 512, 9 + 2 * i),
                           max_new_tokens=12, arrival_tick=0, priority=1)
              for i in range(2)]
        return lo + [impl.Request(rid=2, prompt=rng.integers(0, 512, 8),
                                  max_new_tokens=4, arrival_tick=5,
                                  priority=0)]
    ref, mine = _schedulers(int8_model)
    rep_ref, rep = ref.run(reqs(RS)), mine.run(reqs(scheduler))
    _assert_same(rep_ref, rep, ref, mine)
    assert rep.preemptions >= 1
    p = rep.paged
    assert p["swapped_blocks_in"] == p["swapped_blocks_out"] >= 1
    params_ref, cfg_ref, _, cfg = int8_model
    # int8 K and V plus a bf16 scale per (layer, KV head, position)
    assert mine.pool.block_bytes == cfg.num_layers * cfg.num_kv_heads * \
        BLOCK * (2 * cfg.resolved_head_dim + 2 * 2)
    assert {r.rid: r.tokens for r in rep.results} == _ref_int8_solo(
        params_ref, cfg_ref, reqs(scheduler), SLOT_LEN)


# ---------------------------------------------------------------------------
# Swap mechanics at the pool level.
# ---------------------------------------------------------------------------
def _prefilled(pool, params, cfg, prompt):
    seq = pool.admit(prompt)
    _, _, ln = engine.prefill_chunk_paged(
        params, pool.caches, pool.device_row(seq.slot), 0,
        _t(prompt)[None], cfg)
    pool.finalize_prefill(seq)
    pool.lens[seq.slot] = ln
    return seq, ln


def test_swap_keeps_shared_blocks_without_copyout(model):
    """Two sequences share a 2-block prefix; swapping one out keeps the
    shared blocks by reference (no copy, no free) and copies the exclusive
    tail only — entry for entry as the reference pool."""
    params_ref, cfg_ref, params, cfg = model
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 512, 2 * BLOCK)
    pa = np.concatenate([prefix, rng.integers(0, 512, 3)])
    pb = np.concatenate([prefix, rng.integers(0, 512, 5)])
    ref = RP.PagedPool(cfg_ref, num_slots=2, slot_len=SLOT_LEN,
                       block_size=BLOCK)
    pool = paged.PagedPool(cfg, num_slots=2, slot_len=SLOT_LEN,
                           block_size=BLOCK, device="cpu")
    for p in (ref, pool):
        sa = p.admit(pa)
        p.finalize_prefill(sa)
        sb = p.admit(pb)
        p.rec = p.swap_out(sb.slot, rid=77)
        p.shared = list(sb.blocks[:2])
    kinds = [e[0] for e in pool.rec.entries]
    assert kinds == [e[0] for e in ref.rec.entries]
    assert kinds[:2] == ["shared", "shared"] and "host" in kinds[2:]
    assert [e[1] for e in pool.rec.entries[:2]] == pool.shared == ref.shared
    for bid in pool.shared:
        assert pool.alloc.refcount(bid) == 2
    assert pool.free_blocks == ref.free_blocks
    assert pool.stats() == ref.stats()
    assert pool.swap_in(77).blocks[:2] == pool.shared
    assert 77 not in pool.swapped
    pool.alloc.check_invariants()


def _poison(pool, bids):
    """Fill freed blocks: NaN in float leaves, ±127 in int8 payloads."""
    for name, x in pool.caches.items():
        fill = 127 if x.dtype == torch.int8 else float("nan")
        x[:, bids] = fill


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["host", "prefetched"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_swap_round_trip_is_bit_exact(model, int8_model, dtype, prefetch):
    """swap_out → (prefetch) → swap_in restores every leaf of every block
    bit for bit — int8 payload and bf16 scale pages too — though the freed
    blocks were poisoned and handed out again in between."""
    _, _, params, cfg = int8_model if dtype == "int8" else model
    # two blocks: the sequence's, handed to the next admission once freed
    pool = paged.PagedPool(cfg, num_slots=2, slot_len=24, block_size=8,
                           num_blocks=2, device="cpu")
    prompt = np.random.default_rng(17).integers(0, 512, 11)
    seq, ln = _prefilled(pool, params, cfg, prompt)
    want = {n: x[:, seq.blocks].clone() for n, x in pool.caches.items()}
    free_before = set(pool.alloc._free)
    rec = pool.swap_out(seq.slot, rid=5)
    freed = sorted(set(pool.alloc._free) - free_before)
    assert len(freed) == len(seq.blocks) == len(rec.entries)
    _poison(pool, freed)
    other = pool.admit(np.arange(9) % 512)       # reuses the freed blocks
    assert sorted(other.blocks) == freed
    if prefetch:
        assert pool.prefetch_swap_in(5) == len(freed)
        assert pool.prefetch_swap_in(5) == 0     # idempotent
    assert pool.prefetch_swap_in(404) == 0       # unknown rid
    pool.release(other.slot)
    s2 = pool.swap_in(5)
    assert int(pool.lens[s2.slot]) == ln
    for n, x in pool.caches.items():
        assert torch.equal(x[:, s2.blocks].view(torch.int8),
                           want[n].view(torch.int8)), n
    st = pool.stats()
    assert st["swapped_blocks_in"] == st["swapped_blocks_out"] == len(freed)
    assert st["swapped_bytes_in"] == len(freed) * pool.block_bytes
    assert st["swap_prefetched_blocks"] == (len(freed) if prefetch else 0)
    assert pool.block_bytes == sum(x[:, 0].numel() * x.element_size()
                                   for x in pool.caches.values())
    pool.alloc.check_invariants()


def test_scheduler_prefetches_next_resume(model):
    """While a preempted request waits, decode ticks stage its blocks —
    the same count as the reference's."""
    ref, mine = _schedulers(model)
    rep_ref = ref.run(_priority_workload(RS, "mid"))
    rep = mine.run(_priority_workload(scheduler, "mid"))
    _assert_same(rep_ref, rep, ref, mine)
    assert rep.paged["swap_prefetched_blocks"] >= 1


@pytest.mark.parametrize("persistent", [True, False])
def test_persistent_prefix_flag(model, persistent):
    """``persistent_prefix=False`` frees every block at release and the
    index entries die with them; the default parks indexed blocks.  The
    pool's state equals the reference's either way."""
    _, cfg_ref, _, cfg = model
    ref = RP.PagedPool(cfg_ref, num_slots=1, slot_len=16, block_size=4,
                       persistent_prefix=persistent)
    pool = paged.PagedPool(cfg, num_slots=1, slot_len=16, block_size=4,
                           persistent_prefix=persistent, device="cpu")
    for p in (ref, pool):
        seq = p.admit(np.arange(9) % 512)
        p.finalize_prefill(seq)
        p.release(seq.slot)
    assert (pool.cached_blocks, pool.free_blocks, len(pool.index)) == \
        (ref.cached_blocks, ref.free_blocks, len(ref.index))
    if not persistent:
        assert pool.cached_blocks == 0 and len(pool.index) == 0
        assert pool.free_blocks == pool.alloc.num_blocks - 1


# ---------------------------------------------------------------------------
# Reports and the workload.
# ---------------------------------------------------------------------------
def test_slo_attainment_and_by_class_percentiles(model):
    """One generous deadline met, one impossible missed; under the virtual
    clocks the attainment, each request's phases and the by-class
    percentiles equal the reference's exactly."""
    def reqs(impl):
        rng = np.random.default_rng(8)
        return [impl.Request(rid=0, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=3, priority=0, slo_ms=1e7),
                impl.Request(rid=1, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=3, priority=1),
                impl.Request(rid=2, prompt=rng.integers(0, 512, 6),
                             max_new_tokens=3, priority=0, slo_ms=1e-6)]
    ref, mine = _schedulers(model)
    rep_ref, rep = ref.run(reqs(RS)), mine.run(reqs(scheduler))
    _assert_same(rep_ref, rep, ref, mine)
    assert rep.slo_attainment() == rep_ref.slo_attainment() == 0.5
    assert rep.slo_counts_by_class() == rep_ref.slo_counts_by_class()
    assert rep.latency_percentiles_by_class() == \
        rep_ref.latency_percentiles_by_class()
    by_rid = {r.rid: r for r in rep.results}
    assert (by_rid[0].slo_met, by_rid[1].slo_met, by_rid[2].slo_met) == \
        (True, None, False)
    for a, b in zip(rep.results, rep_ref.results):
        assert a.latencies == b.latencies
        assert (a.queued_ms, a.prefill_ms, a.decode_ms) == \
            (b.queued_ms, b.prefill_ms, b.decode_ms)
    assert (rep.wall_time, rep.started_at, rep.ended_at) == \
        (rep_ref.wall_time, rep_ref.started_at, rep_ref.ended_at)


@pytest.mark.parametrize("classes,slo_ms,seed", [(1, None, 0), (2, 50.0, 1),
                                                 (3, 250.0, 2)])
def test_workload_generator_matches_reference(classes, slo_ms, seed):
    """The same numpy draws: classes only for more than one class, the
    deadline on class 0 only."""
    kw = dict(rate_per_tick=2.0, prompt_lens=(4, 20), decode_lens=(2, 9),
              vocab=512, seed=seed, shared_prefix=8,
              priority_classes=classes, slo_ms=slo_ms)
    mine, ref = (scheduler.poisson_workload(32, **kw),
                 RS.poisson_workload(32, **kw))
    for a, b in zip(mine, ref):
        assert (a.rid, a.max_new_tokens, a.arrival_tick, a.priority,
                a.slo_ms) == (b.rid, b.max_new_tokens, b.arrival_tick,
                              b.priority, b.slo_ms)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    if classes > 1:
        assert len({r.priority for r in mine}) > 1
        assert all((r.slo_ms == slo_ms) == (r.priority == 0) for r in mine)


@pytest.mark.parametrize("extra", [0, 5])
def test_latency_ring_matches_reference(extra):
    """``record_latency`` keeps 8192 samples and counts the rest: the port
    once appended without a bound."""
    n = scheduler.RequestResult.MAX_RECORDED_LATENCIES + extra
    assert n - extra == RS.RequestResult.MAX_RECORDED_LATENCIES == 8192
    vals = np.random.default_rng(3).random(n).tolist()
    mine = scheduler.RequestResult(rid=0, prompt_len=1)
    ref = RS.RequestResult(rid=0, prompt_len=1)
    for v in vals:
        mine.record_latency(v)
        ref.record_latency(v)
    assert mine.latencies == ref.latencies == vals[:8192]
    assert mine.dropped_latencies == ref.dropped_latencies == extra
    assert mine.dropped_sum == ref.dropped_sum == pytest.approx(
        sum(vals[8192:]))


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------
# the README's mixed-priority command (without its pool cut)
SLO_CLI = ["--smoke", "--continuous", "--paged", "--requests", "10",
           "--slots", "2", "--prompt-len", "10", "--tokens", "12",
           "--block-size", "8", "--prefill-chunk", "8", "--shared-prefix",
           "8", "--rate", "0.5", "--priority-classes", "2", "--slo-ms", "50"]
# every counter line of the report, none with a time
_COUNTERS = ("paged continuous batching:", "decode steps:", "batch occupancy:",
             "block pool:", "blocks saved", "prefix cache:", "router:",
             "backpressure:", "preemptions:", "evicted at capacity:")


def _counter_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(_COUNTERS)]


@pytest.mark.parametrize("extra", [["--blocks", "6"],
                                   ["--blocks", "6", "--replicas", "2"],
                                   ["--blocks", "6", "--no-preempt"],
                                   ["--blocks", "6", "--kv-cache-dtype",
                                    "int8"]],
                         ids=["slo", "replicas", "no-preempt", "int8"])
def test_cli_counters_equal_reference_cli(extra, capsys):
    """The port's CLI prints the reference CLI's counter lines on the same
    flags — preemptions and swapped blocks, the router's assignment line —
    with its own sampling noise (no line depends on the token ids)."""
    argv = SLO_CLI + extra
    rc = serve.main(argv + ["--device", "cpu"])
    mine = capsys.readouterr().out
    ref_rc = RSV.main(argv)
    theirs = capsys.readouterr().out
    assert rc == ref_rc
    assert _counter_lines(mine) == _counter_lines(theirs)
    assert any(ln.startswith("preemptions:") for ln in _counter_lines(mine))
    if "--no-preempt" not in extra:
        assert "preemptions: 0 " not in mine
    if "--replicas" in extra:
        assert any(ln.startswith("router:") for ln in _counter_lines(mine))
    for pr in (0, 1):
        assert f"class {pr}: n=" in mine
    assert "SLO attainment:" in mine
