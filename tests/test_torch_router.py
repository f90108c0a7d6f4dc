"""The port's engine surface and replica router against the JAX package, on
the CPU.

The reference's router workload (three system prompts, four requests each,
staggered so early members retire into the prefix cache before later ones
arrive) goes through the reference's ``ReplicaRouter`` and the port's with
1, 2 and 4 replicas, the reference's weights (``params_from_numpy``) and
its Gumbel noise (``noise_fn``).  Held equal: every request's token stream
(also equal to the reference's solo run: where a request lands never
changes what it generates), the assignments, affinity routes and
backpressure rejects, and the merged pool counters.  Then
``ServeReport.merge`` on hand-built reports of both packages, the engine
surface, and ``ContinuousScheduler.run`` delegating to ``Engine``.

Tolerances: none for integers (streams, assignments, counters); merged
percentiles and wall times are the same float arithmetic in both packages
and compare exactly.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.serving import engine_api as RA  # noqa: E402
from repro.serving import router as RR  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402
from repro_torch.serving.engine_api import Engine  # noqa: E402
from repro_torch.serving.router import ReplicaRouter  # noqa: E402
from test_torch_serving import _ref_solo_streams, ref_noise  # noqa: E402
from test_torch_slo import _model  # noqa: E402

SLOT_LEN, CHUNK, TOP_K, BLOCK = 48, 8, 5, 8
BASE_KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def model():
    return _model()


def _prefix_groups(impl, groups=3, members=4, prefix_len=16, seed=3):
    """The reference's ``test_serving_router._prefix_groups``."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 512, prefix_len) for _ in range(groups)]
    out = []
    for j in range(members):
        for g in range(groups):
            body = rng.integers(0, 512, 3 + g + j)
            out.append(impl.Request(
                rid=g * members + j,
                prompt=np.concatenate([prefixes[g], body]),
                max_new_tokens=3, arrival_tick=j * 8 + g * 2))
    return out


def _routers(model, replicas, **kw):
    params_ref, cfg_ref, params, cfg = model
    base = dict(replicas=replicas, num_slots=2, slot_len=SLOT_LEN,
                prefill_chunk=CHUNK, top_k=TOP_K, paged=True,
                block_size=BLOCK)
    base.update(kw)
    return (RR.ReplicaRouter(params_ref, cfg_ref, base_rng=BASE_KEY, **base),
            ReplicaRouter(params, cfg, noise_fn=ref_noise, device="cpu",
                          **base))


def _assert_routed_same(rep_ref, rep):
    assert rep.router == rep_ref.router
    assert rep.paged == rep_ref.paged
    assert (rep.decode_steps, rep.prefill_chunks, rep.preemptions) == \
        (rep_ref.decode_steps, rep_ref.prefill_chunks, rep_ref.preemptions)
    assert {r.rid: r.tokens for r in rep.results} == \
        {r.rid: r.tokens for r in rep_ref.results}


@pytest.fixture(scope="module")
def solo(model):
    params_ref, cfg_ref, _, _ = model
    return _ref_solo_streams(params_ref, cfg_ref, _prefix_groups(scheduler),
                             SLOT_LEN, CHUNK)


@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_routed_streams_equal_reference(model, solo, replicas):
    """Streams equal the reference's solo runs; assignments, affinity
    routes and rejects equal the reference router's."""
    ref, mine = _routers(model, replicas)
    rep_ref = ref.serve(_prefix_groups(RS))
    rep = mine.serve(_prefix_groups(scheduler))
    _assert_routed_same(rep_ref, rep)
    assert {r.rid: r.tokens for r in rep.results} == solo
    assert len(rep.results) == 12
    assert sum(rep.router["per_replica"]) == 12
    for e in mine.engines:
        e.scheduler.pool.alloc.check_invariants()


@pytest.mark.parametrize("affinity", [True, False],
                         ids=["affinity", "round-robin"])
def test_affinity_routing_equals_reference(model, affinity):
    """With 4 replicas, affinity keeps each prefix group on one replica and
    reuses its blocks more than round-robin does; both policies route as
    the reference's."""
    ref, mine = _routers(model, 4, affinity=affinity)
    rep_ref = ref.serve(_prefix_groups(RS))
    rep = mine.serve(_prefix_groups(scheduler))
    _assert_routed_same(rep_ref, rep)
    assign = rep.router["assignments"]
    if affinity:
        for g in range(3):
            assert len({assign[g * 4 + j] for j in range(4)}) == 1
        assert rep.router["affinity_routes"] > 0
        _, rr = _routers(model, 4, affinity=False)
        rep_rr = rr.serve(_prefix_groups(scheduler))
        assert rep.paged["tokens_reused"] > rep_rr.paged["tokens_reused"]
    else:
        assert rep.router["affinity"] is False
        assert rep.router["per_replica"] == [3, 3, 3, 3]


def test_backpressure_rejects_as_reference(model):
    """Every replica starved: the router rejects, as the reference's."""
    def reqs(impl):
        rng = np.random.default_rng(9)
        return [impl.Request(rid=i, prompt=rng.integers(0, 512, 8),
                             max_new_tokens=7,
                             arrival_tick=[1, 1, 2, 2, 4, 4][i])
                for i in range(6)]
    ref, mine = _routers(model, 2, num_slots=1, slot_len=16, num_blocks=2)
    rep_ref, rep = ref.serve(reqs(RS)), mine.serve(reqs(scheduler))
    _assert_routed_same(rep_ref, rep)
    assert rep.router["backpressure_rejects"] == 2
    assert rep.router["rejected"] == [4, 5]


# ---------------------------------------------------------------------------
# ServeReport.merge.
# ---------------------------------------------------------------------------
def _result(impl, rid, lats, *, priority=0, slo_ms=None, finish=None):
    r = impl.RequestResult(rid=rid, prompt_len=4, priority=priority,
                           slo_ms=slo_ms)
    t = 10.0
    r.arrival_time = t
    for lat in lats:
        t += lat
        r.record_latency(lat)
        r.tokens.append(0)
    r.finish_time = finish if finish is not None else t
    return r


def _reports(impl, case):
    """The reference's merge fixtures, built in package ``impl``."""
    R = impl.ServeReport
    if case == "union":
        return [R(results=[_result(impl, 0, [0.010] * 19 + [0.020])],
                  decode_steps=20, prefill_chunks=2, occupancy=1.0,
                  wall_time=1.0),
                R(results=[_result(impl, 1, [0.100] * 20)], decode_steps=60,
                  prefill_chunks=3, occupancy=0.5, wall_time=2.0,
                  paged={"block_size": 8, "num_blocks": 4,
                         "tokens_reused": 5})]
    if case == "overlap":
        return [R(results=[_result(impl, 0, [0.01] * 10)], decode_steps=10,
                  prefill_chunks=1, occupancy=1.0, wall_time=1.0,
                  started_at=100.0, ended_at=101.0),
                R(results=[_result(impl, 1, [0.01] * 10)], decode_steps=10,
                  prefill_chunks=1, occupancy=1.0, wall_time=1.5,
                  started_at=100.5, ended_at=102.0)]
    if case == "unstamped":
        return _reports(impl, "overlap")[:1] + [
            R(results=[_result(impl, 2, [0.01])], decode_steps=1,
              prefill_chunks=1, occupancy=1.0, wall_time=3.0)]
    met = _result(impl, 0, [0.001], priority=0, slo_ms=1000.0)
    missed = _result(impl, 1, [0.002], priority=0, slo_ms=1.0,
                     finish=15.0)
    free = _result(impl, 2, [0.003], priority=1)
    return [R(results=[met, free], decode_steps=1, prefill_chunks=1,
              occupancy=1.0, wall_time=1.0),
            R(results=[missed], decode_steps=1, prefill_chunks=1,
              occupancy=1.0, wall_time=1.0)]


def _view(rep):
    return (rep.decode_steps, rep.prefill_chunks, rep.occupancy,
            rep.wall_time, rep.started_at, rep.ended_at, rep.paged,
            rep.preemptions, rep.total_tokens, rep.tokens_per_s,
            rep.latency_percentiles((50, 95)),
            rep.latency_percentiles_by_class((50, 95)),
            rep.slo_attainment(), rep.slo_counts_by_class())


@pytest.mark.parametrize("case", ["union", "overlap", "unstamped", "slo"])
def test_merge_equals_reference(case):
    """Percentiles over the union of raw latencies (not an average of
    per-replica ones), summed counters, step-weighted occupancy, the
    overlapped wall time of stamped reports (else the longest), and
    per-class SLO counts — all as the reference's ``merge``."""
    mine = scheduler.ServeReport.merge(_reports(scheduler, case))
    ref = RS.ServeReport.merge(_reports(RS, case))
    assert _view(mine) == _view(ref)
    if case == "union":
        assert mine.latency_percentiles((95,))["p95"] == pytest.approx(
            float(np.percentile([0.010] * 19 + [0.020] + [0.100] * 20, 95)))
        assert mine.wall_time == 2.0
    elif case == "overlap":
        assert mine.wall_time == pytest.approx(2.0)
    elif case == "unstamped":
        assert mine.wall_time == pytest.approx(3.0)
    else:
        assert mine.slo_counts_by_class() == {0: (1, 2)}
    with pytest.raises(ValueError):
        scheduler.ServeReport.merge([])


# ---------------------------------------------------------------------------
# The engine surface.
# ---------------------------------------------------------------------------
def test_engine_surface_equals_reference(model):
    """``load``, ``busy``, ``cache_probe``, ``stats`` and ``starved`` read
    as the reference engine's through a run."""
    params_ref, cfg_ref, params, cfg = model
    kw = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
              top_k=TOP_K, paged=True, block_size=BLOCK)
    ref = RA.Engine(params_ref, cfg_ref, base_rng=BASE_KEY, **kw)
    mine = Engine(params, cfg, noise_fn=ref_noise, device="cpu", **kw)
    prompt = np.arange(2 * BLOCK) % 512
    views = {}
    for eng, impl in ((ref, RS), (mine, scheduler)):
        seen = [(eng.cache_probe(prompt), eng.load, eng.busy, eng.paged,
                 eng.num_slots, eng.starved(len(prompt)))]
        eng.submit(impl.Request(rid=0, prompt=prompt, max_new_tokens=3))
        eng.submit(impl.Request(rid=1, prompt=np.arange(5) % 512,
                                max_new_tokens=2))
        seen.append((eng.load, eng.busy))
        while eng.step():
            seen.append((eng.load, eng.stats()["active"]))
        report = eng.drain()
        st = eng.stats()
        seen.append((sorted(r.rid for r in report.results),
                     report.decode_steps, report.preemptions,
                     eng.cache_probe(prompt), eng.cache_probe(prompt)))
        views[impl] = (seen, {k: v for k, v in st.items()
                              if k != "metrics"})
    assert views[scheduler] == views[RS]
    assert views[scheduler][1]["suspended"] == 0
    assert views[scheduler][0][-1][3] >= BLOCK        # the cached prompt
    assert Engine.wrap(mine.scheduler).scheduler is mine.scheduler


def test_scheduler_run_delegates_to_engine(model):
    """``ContinuousScheduler.run`` serves through ``Engine.wrap(...).serve``
    and reports as ``Engine.serve`` does."""
    _, _, params, cfg = model
    kw = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
              top_k=TOP_K, paged=True, block_size=BLOCK, noise_fn=ref_noise,
              device="cpu")
    requests = _prefix_groups(scheduler, groups=1, members=2)
    report = scheduler.ContinuousScheduler(params, cfg, **kw).run(requests)
    report2 = Engine(params, cfg, **kw).serve(requests)
    assert {r.rid: r.tokens for r in report.results} == \
        {r.rid: r.tokens for r in report2.results}
    assert (report.decode_steps, report.occupancy, report.paged) == \
        (report2.decode_steps, report2.occupancy, report2.paged)
    assert report.started_at is not None and report.ended_at is not None
