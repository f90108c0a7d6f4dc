"""The port's observability stack against the JAX package's, on the CPU.

The smoke-width fp32 model of ``test_torch_slo`` (the reference's weights
carried across by ``params_from_numpy``) and the reference's Gumbel noise
(``noise_fn``) serve the same requests through both packages, each under
its own ``VirtualClock`` advanced 10 ms after every tick (as
``tests/test_obs.py::_serve_stepwise`` drives the reference), with a tracer
on that clock and the metrics registry on.  Held exactly, with no
tolerance: the trace events (name, ph, cat, pid, tid, ts, dur, args) on the
paged path, the slot pool, a preempt-and-swap SLO workload and a 2-replica
router (per-replica tracers, then ``merge_traces``); the report's text and
its ``--diff``; the registry's snapshot, histogram percentiles included
(the same float arithmetic on the same samples).  Then the kernel profile
on the CPU (``cpu`` paths counting the plain versions' calls, the analytic
cost pinned on a hand-counted config and shown beside the reference's XLA
count), and ports of ``tests/test_obs.py``'s own properties: tracing off
gives the same streams, ``flush_every`` bounds the buffer and needs a path,
the report CLI exits 1 on a broken trace and 2 on a usage error, and the
serve CLI's ``--trace DIR/`` writes per-replica and merged traces.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.launch import serve as RSV  # noqa: E402
from repro.obs import kernels as RK  # noqa: E402
from repro.obs import merge as RMerge  # noqa: E402
from repro.obs import metrics as RM  # noqa: E402
from repro.obs import report as RReport  # noqa: E402
from repro.obs import trace as RT  # noqa: E402
from repro.obs.clock import VirtualClock as RVirtualClock  # noqa: E402
from repro.serving import engine_api as RA  # noqa: E402
from repro.serving import router as RR  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.kernels import softmax_topk as STK  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import kernels as obs_kernels  # noqa: E402
from repro_torch.obs import merge as obs_merge  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.clock import VirtualClock  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402
from repro_torch.serving.engine_api import Engine  # noqa: E402
from repro_torch.serving.router import ReplicaRouter  # noqa: E402
from test_torch_serving import ref_noise  # noqa: E402
from test_torch_slo import _model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT_LEN, BLOCK, CHUNK, TOP_K = 48, 8, 8, 5
BASE_KEY = jax.random.PRNGKey(0)
DT = 0.010                   # virtual seconds a tick


@pytest.fixture(scope="module")
def model():
    return _model()


def _workload(impl, n=4, seed=2, max_new=4, prefix=0):
    """Staggered requests (one a tick), optionally with a shared prefix."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, 512, prefix)
    return [impl.Request(rid=i, prompt=np.concatenate(
                [head, rng.integers(0, 512, 5 + 2 * i)]).astype(np.int64),
                         max_new_tokens=max_new, arrival_tick=i)
            for i in range(n)]


def _priority_workload(impl):
    """``tests/test_obs.py``'s preempting recipe: two low-priority long
    decodes, then an urgent arrival, over an 8-block pool."""
    rng = np.random.default_rng(11)
    lo = [impl.Request(rid=i, prompt=rng.integers(0, 512, 9 + 2 * i),
                       max_new_tokens=12, arrival_tick=0, priority=1)
          for i in range(2)]
    hi = [impl.Request(rid=2, prompt=rng.integers(0, 512, 8),
                       max_new_tokens=4, arrival_tick=5, priority=0,
                       slo_ms=100.0)]
    return lo + hi


SCENARIOS = {
    "paged": dict(kw=dict(paged=True, block_size=BLOCK),
                  work=lambda impl: _workload(impl, prefix=BLOCK)),
    "slot-pool": dict(kw={}, work=lambda impl: _workload(impl)),
    "slo-preempt": dict(kw=dict(paged=True, block_size=BLOCK, num_blocks=8),
                        work=_priority_workload),
    "router": dict(kw=dict(paged=True, block_size=BLOCK, affinity=False),
                   replicas=2,
                   work=lambda impl: _workload(impl, n=6, prefix=BLOCK)),
}


def _serve_stepwise(eng, requests, clock):
    """``tests/test_obs.py``'s driver: tick k runs at k·DT."""
    eng.begin()
    for r in requests:
        eng.submit(r)
    while eng.step():
        clock.advance(DT)
    return eng.report()


def _route_stepwise(router, requests, clock):
    """``ReplicaRouter.serve`` with the clock advanced after every tick."""
    for e in router.engines:
        e.begin()
    pending = sorted(requests, key=lambda r: r.arrival_tick)
    while pending or any(e.busy for e in router.engines):
        while pending and pending[0].arrival_tick <= router.tick_count + 1:
            router.submit(pending.pop(0))
        router.step()
        clock.advance(DT)
    return router.report()


def _run(impl_ref: bool, model, name, tmp_path):
    """Serve one scenario traced under a virtual clock with the metrics
    registry on; returns (events, snapshot, report)."""
    sc = SCENARIOS[name]
    params_ref, cfg_ref, params, cfg = model
    mets, Tracer = (RM, RT.Tracer) if impl_ref else (obs_metrics,
                                                     obs_trace.Tracer)
    clock = RVirtualClock() if impl_ref else VirtualClock()
    base = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
                top_k=TOP_K, clock=clock, **sc["kw"])
    if impl_ref:
        base.update(base_rng=BASE_KEY)
        p, c, impl = params_ref, cfg_ref, RS
    else:
        base.update(noise_fn=ref_noise, device="cpu")
        p, c, impl = params, cfg, scheduler
    mets.reset()
    mets.enable()
    try:
        if sc.get("replicas"):
            tag = "ref" if impl_ref else "port"
            paths = [str(tmp_path / f"{name}-{tag}-r{i}.json")
                     for i in range(sc["replicas"])]
            tracers = [Tracer(pth, clock=clock) for pth in paths]
            cls = RR.ReplicaRouter if impl_ref else ReplicaRouter
            router = cls(p, c, replicas=sc["replicas"], tracers=tracers,
                         **base)
            report = _route_stepwise(router, sc["work"](impl), clock)
            for t in tracers:
                t.close()
            merge = RMerge if impl_ref else obs_merge
            events = {"replicas": [t.events for t in tracers],
                      "merged": merge.merge_traces(paths)}
        else:
            tracer = Tracer(None, clock=clock)
            cls = RA.Engine if impl_ref else Engine
            eng = cls(p, c, tracer=tracer, **base)
            report = _serve_stepwise(eng, sc["work"](impl), clock)
            events = tracer.close()
        snap = mets.snapshot()
    finally:
        mets.disable()
        mets.reset()
    return events, snap, report


@pytest.fixture(scope="module")
def runs(model, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traces")
    return {name: {side: _run(side == "ref", model, name, tmp)
                   for side in ("ref", "port")}
            for name in SCENARIOS}


def _flat(events):
    """The events of one trace: a single list, or a router's merged one."""
    return events["merged"] if isinstance(events, dict) else events


# ---------------------------------------------------------------------------
# Trace, report and metrics parity.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trace_events_equal_reference(runs, name):
    """Event for event, field for field: the same spans, instants, counters
    and track names at the same virtual times (per replica and merged for
    the router)."""
    (ref, _, rep_ref), (mine, _, rep) = runs[name]["ref"], runs[name]["port"]
    assert mine == ref
    assert {r.rid: r.tokens for r in rep.results} == \
        {r.rid: r.tokens for r in rep_ref.results}
    if name == "slo-preempt":
        assert rep.preemptions >= 1
    if name == "router":
        assert {e["pid"] for e in mine["merged"]} == {0, 1}
        assert all(mine["replicas"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_trace_closed_nested_and_counts_match_report(runs, name):
    """The port's trace validates, holds one ``token`` instant per token
    and one ``retire`` per request, and every ``decode`` section span lies
    inside a ``tick`` on track 0."""
    events, _, rep = runs[name]["port"]
    events = _flat(events)
    assert obs_report.validate(events) == []
    inst = [e for e in events if e["ph"] == "i"]
    assert sum(e["name"] == "token" for e in inst) == rep.total_tokens
    assert sum(e["name"] == "retire" for e in inst) == len(rep.results)
    assert sum(e["name"] == "preempt" for e in inst) == rep.preemptions
    ticks = [e for e in events if e["ph"] == "X" and e["name"] == "tick"]
    decodes = [e for e in events if e["ph"] == "X" and e["name"] == "decode"
               and e["tid"] == 0]
    assert decodes and len(decodes) == rep.decode_steps
    for d in decodes:
        assert any(t["pid"] == d["pid"] and t["ts"] <= d["ts"]
                   and d["ts"] + d["dur"] <= t["ts"] + t["dur"]
                   for t in ticks)
    for res in rep.results:
        toks = [e["args"]["token"] for e in events
                if e["ph"] == "i" and e["name"] == "token"
                and e["tid"] == res.rid + 1]
        assert toks == res.tokens


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_report_text_equals_reference(runs, name):
    ref, mine = (_flat(runs[name][s][0]) for s in ("ref", "port"))
    text = obs_report.summarize(mine)
    assert text == RReport.summarize(ref)
    assert "trace OK: all spans closed and nested" in text


def test_report_diff_equals_reference(runs):
    a, b = (_flat(runs[n]["port"][0]) for n in ("paged", "slo-preempt"))
    ra, rb = (_flat(runs[n]["ref"][0]) for n in ("paged", "slo-preempt"))
    text = obs_report.diff(a, b, label_a="paged.json", label_b="slo.json")
    assert text == RReport.diff(ra, rb, label_a="paged.json",
                                label_b="slo.json")
    assert "## Trace diff — paged.json → slo.json" in text
    assert "Aligned tick timeline" in text


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_metrics_snapshot_equals_reference(runs, name):
    (_, ref, _), (_, mine, rep) = runs[name]["ref"], runs[name]["port"]
    assert mine == ref
    # replica 0 reports under serving.*, replica i under serving.r{i}.*
    prefixes = ["serving"] + (["serving.r1"] if name == "router" else [])
    assert sum(mine[f"{p}.tokens"]["value"] for p in prefixes) == \
        rep.total_tokens
    assert sum(mine[f"{p}.occupancy"]["count"] for p in prefixes) == \
        rep.decode_steps
    if name == "router":
        assert "router.r1.load" in mine
    if name == "slo-preempt":
        assert mine["serving.preemptions"]["value"] == rep.preemptions
        assert mine["serving.swapped_bytes_out"]["max"] > 0


def test_engine_stats_attach_metrics_snapshot(model):
    _, _, params, cfg = model
    obs_metrics.reset()
    obs_metrics.enable()
    try:
        eng = Engine(params, cfg, num_slots=2, slot_len=SLOT_LEN,
                     prefill_chunk=CHUNK, top_k=TOP_K, paged=True,
                     block_size=BLOCK, noise_fn=ref_noise, device="cpu")
        rep = eng.serve(_workload(scheduler, n=2))
        m = eng.stats()["metrics"]
        assert m["serving.tokens"]["value"] == rep.total_tokens
        assert m["serving.occupancy"]["count"] == rep.decode_steps
        assert "serving.free_blocks" in m        # the low-water mark's gauge
        obs_metrics.disable()
        assert "metrics" not in eng.stats()
    finally:
        obs_metrics.disable()
        obs_metrics.reset()


def test_metrics_disabled_records_nothing():
    obs_metrics.reset()
    obs_metrics.disable()
    obs_metrics.counter("c").inc()
    obs_metrics.gauge("g").set(3.0)
    obs_metrics.histogram("h").observe(1.0)
    assert obs_metrics.snapshot() == {}


def test_histogram_percentiles_equal_reference():
    """The same samples give the same snapshot, percentiles included."""
    samples = (0.001, 0.002, 0.004, 0.008, 0.016, 0.512, 0.25, 3e-5)
    snaps = []
    for mets in (RM, obs_metrics):
        mets.reset()
        mets.enable()
        try:
            for v in samples:
                mets.histogram("h").observe(v)
            mets.counter("c").inc(4)
            mets.gauge("g").set(2.0)
            snaps.append(mets.snapshot())
            with pytest.raises(TypeError):
                mets.gauge("c")
        finally:
            mets.disable()
            mets.reset()
    assert snaps[0] == snaps[1]
    h = snaps[1]["h"]
    assert h["min"] <= h["p50"] <= h["p95"] <= h["max"]


# ---------------------------------------------------------------------------
# The kernel profile.
# ---------------------------------------------------------------------------
@pytest.fixture
def profiling():
    obs_kernels.reset()
    obs_kernels.enable_profiling()
    yield obs_kernels
    obs_kernels.disable_profiling()
    obs_kernels.reset()


def _count_calls(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot-pool"])
def test_kernel_profile_paths_count_plain_calls(model, profiling, paged,
                                                monkeypatch):
    """On the CPU every op resolves to ``cpu``, counted once per call of
    its plain version; the decode step's cost is recorded under the
    reference's label, without device figures; the plans of the CUDA
    wrappers are not taken on this path."""
    _, _, params, cfg = model
    calls = {}
    for mod, fn in ((FD, "flash_decode_paged_plain"),
                    (FA, "flash_attention_paged_plain"),
                    (STK, "softmax_topk_plain")):
        _count_calls(monkeypatch, mod, fn, calls)
    kw = dict(paged=True, block_size=BLOCK) if paged else {}
    eng = Engine(params, cfg, num_slots=2, slot_len=SLOT_LEN,
                 prefill_chunk=CHUNK, top_k=TOP_K, noise_fn=ref_noise,
                 device="cpu", **kw)
    eng.serve(_workload(scheduler, prefix=BLOCK if paged else 0))
    prof = eng.kernel_profile()
    assert prof["paths"] and {p["path"] for p in prof["paths"].values()} \
        == {"cpu"}
    assert prof["paths"]["softmax_topk"]["count"] == \
        calls["softmax_topk_plain"]
    if paged:
        assert prof["paths"]["flash_decode_paged"]["count"] == \
            calls["flash_decode_paged_plain"]
        assert prof["paths"]["flash_attention_paged"]["count"] == \
            calls["flash_attention_paged_plain"]
    else:
        assert "flash_decode_paged" not in prof["paths"]
        assert prof["paths"]["flash_decode"]["count"] > 0
    label = "decode_step_paged" if paged else "decode_step"
    cost = prof["costs"][label]
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert "device_ms" not in cost and prof["autotune"] == {}
    obs_kernels.reset()
    assert eng.kernel_profile() == {"paths": {}, "autotune": {}, "costs": {}}


def _tiny_cfg(layers=1):
    return ModelConfig(name="tiny", family="dense", num_layers=layers,
                       d_model=4, num_heads=2, num_kv_heads=1, head_dim=2,
                       d_ff=8, vocab_size=16, dtype="float32")


def test_decode_step_cost_hand_counted():
    """A config small enough to count by hand: L 2, d 4, Hq 2, Hkv 1,
    D 2, d_ff 8 (SwiGLU), V 16, fp32; 3 rows, two live over 5 and 2 keys.
    A layer's matmuls: q 4·4 + k, v 2·(4·2) + o 4·4 + MLP 3·4·8 = 144.
    flops = 2·144·2·3 + 4·2·2·7·2 + 2·4·16·3 = 1728 + 224 + 384 = 2336.
    bytes = (144·2 + 4·16)·4 + 7·2·2·1·2·4 + 3·16·4 = 1408 + 224 + 192
    = 1824; int8 K/V: 7·2·2·1·(2 + 2) = 112 in place of 224."""
    cfg = _tiny_cfg(layers=2)
    cost = obs_kernels.decode_step_cost(cfg, 3, [5, 2])
    assert (cost["flops"], cost["bytes_accessed"]) == (2336.0, 1824.0)
    q8 = obs_kernels.decode_step_cost(cfg.replace(kv_cache_dtype="int8"), 3,
                                      [5, 2])
    assert (q8["flops"], q8["bytes_accessed"]) == (2336.0, 1712.0)


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::decode_paged_split_kernel<__nv_bfloat16>"
     "(__nv_bfloat16 const*, int)", "decode_paged_split_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>(int, at::native::FillFunctor<float>)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("nvjet_tst_64x8_64x16_4x1_v_bz_TNN", "nvjet_tst_64x8_64x16_4x1_v_bz_TNN"),
    ("at::cuda::spin_kernel(long)", obs_kernels.WARMUP_KERNEL),
])
def test_kernel_name_of_profiler_keys(key, name):
    """Profiler event keys of the card's kernels, reduced to the names
    ``profile_step`` records them under."""
    assert obs_kernels.kernel_name(key) == name


class _Event:
    """A ``key_averages()`` entry as ``obs.kernels`` reads it."""

    def __init__(self, key, device_type, ms=0.0, count=1):
        self.key, self.device_type, self.count = key, device_type, count
        self.self_device_time_total = ms * 1e3


KERNEL = _Event("void (anonymous namespace)::decode_paged_split_kernel<"
                "float>(float const*)", "DeviceType.CUDA", ms=0.25, count=2)
SPIN = _Event("void at::cuda::(anonymous namespace)::spin_kernel(long)",
              "DeviceType.CUDA", ms=0.001)
WARMUP_LAUNCH = _Event("cudaLaunchKernel", "DeviceType.CPU")
LAUNCH = _Event("cudaLaunchKernel", "DeviceType.CPU", count=2)
HOST_OP = _Event("aten::add", "DeviceType.CPU")


@pytest.fixture
def fake_profiler(monkeypatch):
    """``torch.profiler.profile`` replaced by sessions that record the
    listed events, one list a session, in order."""
    import torch.profiler
    sessions = []

    class Session:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.events = sessions.pop(0)

        def key_averages(self):
            return self.events
    monkeypatch.setattr(torch.profiler, "profile", Session)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    return sessions


def test_profile_step_records_cost_and_queues_only_on_the_card(
        profiling, fake_profiler):
    """The analytic cost is recorded at once; on the CPU nothing more, and
    on a CUDA device the step is queued, untouched until ``run_pending``
    replays it in one session and adds its kernels, device time and
    bound."""
    cost = obs_kernels.decode_step_cost(_tiny_cfg(), 1, [3])
    ran = []
    plain = {k: v for k, v in cost.items() if k != "dtype"}
    assert obs_kernels.profile_step(lambda a, b=0: ran.append(a + b), "cpu",
                                    2, b=3, cost=cost, device="cpu") is None
    obs_kernels.profile_step(lambda a, b=0: ran.append(a + b), "card", 2,
                             b=4, cost=cost, device="cuda")
    assert ran == [] and profiling.snapshot()["costs"] == {
        "card": plain, "cpu": plain}
    fake_profiler.append([SPIN, HOST_OP, LAUNCH, KERNEL])
    obs_kernels.run_pending()
    obs_kernels.run_pending()           # the queue is empty now
    assert ran == [6] and fake_profiler == []
    card = profiling.snapshot()["costs"]["card"]
    assert card["kernels"] == {"decode_paged_split_kernel":
                               {"ms": 0.25, "calls": 2}}
    assert card["device_ms"] == 0.25
    assert card["bound_ms"] == 1e3 * max(
        cost["bytes_accessed"] / obs_kernels.HBM_BYTES_PER_S,
        cost["flops"] / obs_kernels.PEAK_OPS["float32"])
    assert profiling.snapshot()["costs"]["cpu"] == plain


@pytest.mark.parametrize("sessions,counted,runs,dropped,error", [
    ([[LAUNCH], [HOST_OP, KERNEL]], False, 2, 1, None),
    ([[SPIN, LAUNCH], [SPIN, KERNEL]], False, 2, 1, None),
    ([[SPIN, WARMUP_LAUNCH, HOST_OP]], False, 1, 0, "launched none"),
    ([[]] * 3 + [[SPIN, KERNEL]], True, 4, 3, None),
    ([[]] * 6, True, 6, 6, "in 6 sessions"),
], ids=["dropped-then-recorded", "warm-up-only-then-recorded",
        "nothing-launched", "dropped-thrice", "dropped-every-try"])
def test_profile_session_reruns_dropped_sessions_only(
        profiling, fake_profiler, sessions, counted, runs, dropped, error):
    """A session that launched (a CUDA launch call among its host events
    besides the warm-up's, or, with ``counted``, a launch the port's
    kernel modules counted) but recorded no device event besides its
    warm-up kernel was dropped and runs again, at most 6 times
    (``SESSION_TRIES``); one that launched nothing raises at once."""
    fake_profiler.extend(sessions)
    calls = []

    def step():
        calls.append(1)
        if counted:
            obs_kernels.record_path("flash_decode_paged", "cuda")
        return len(calls)
    if error is None:
        out, prof = obs_kernels.profile_session(step)
        assert out == runs and KERNEL in prof.key_averages()
    else:
        with pytest.raises(RuntimeError, match=error):
            obs_kernels.profile_session(step)
    assert len(calls) == runs and obs_kernels.dropped_sessions() == dropped


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot-pool"])
def test_profiled_step_replays_on_private_copies(model, profiling, paged,
                                                 monkeypatch):
    """The step handed to the profile is the first decode step on private
    copies of what it reads and writes: replayed, it samples the tokens
    the real step samples and leaves the live pool as it was; the paged
    copy holds only the blocks the step's tables name."""
    _, _, params, cfg = model
    kw = dict(paged=True, block_size=BLOCK) if paged else {}
    eng = Engine(params, cfg, num_slots=2, slot_len=SLOT_LEN,
                 prefill_chunk=CHUNK, top_k=TOP_K, noise_fn=ref_noise,
                 device="cpu", **kw)
    pool = eng.scheduler.pool
    name = "decode_step_paged" if paged else "decode_step_slots"
    step, tokens, seen = getattr(scheduler.engine, name), [], {}

    def recorded(*a, **k):
        out = step(*a, **k)
        tokens.append(out[0].clone())
        return out

    def spy(fn, label, *args, cost, device, **kwargs):
        live = {n: x.clone() for n, x in pool.caches.items()}
        fn(*args, **kwargs)             # the replay: tokens[0]
        seen["label"] = label
        seen["untouched"] = all(torch.equal(live[n], x)
                                for n, x in pool.caches.items())
        seen["blocks"] = next(iter(args[1].values())).shape[1]
    monkeypatch.setattr(scheduler.engine, name, recorded)
    monkeypatch.setattr(obs_kernels, "profile_step", spy)
    eng.serve(_workload(scheduler, prefix=BLOCK if paged else 0))
    assert seen["label"] == ("decode_step_paged" if paged else "decode_step")
    assert seen["untouched"] and torch.equal(tokens[0], tokens[1])
    total = next(iter(pool.caches.values())).shape[1]
    assert seen["blocks"] < total if paged else seen["blocks"] == total


def test_analytic_cost_beside_reference_xla_count(model, profiling,
                                                  monkeypatch):
    """The port's analytic count of the first paged decode step beside the
    reference's XLA cost analysis of the same step.  No equality: XLA
    counts what it compiles.  Found: the port's flops are ~1.4x XLA's,
    because the reference scans its layers (``lax.scan``) and XLA's cost
    analysis counts a loop body once — one layer of matmuls where the step
    runs two; the port's count with the layers cut to one lands within 10%
    of XLA's (the rest: elementwise ops XLA counts, the port leaves out)."""
    params_ref, cfg_ref, params, cfg = model
    kw = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
              top_k=TOP_K, paged=True, block_size=BLOCK)
    RK.reset()
    RK.enable_profiling()
    try:
        RA.Engine(params_ref, cfg_ref, base_rng=BASE_KEY, **kw).serve(
            _workload(RS, n=2, prefix=BLOCK))
        xla = RK.snapshot()["costs"]["decode_step_paged"]["flops"]
    finally:
        RK.disable_profiling()
        RK.reset()
    counted = []
    cost_fn = obs_kernels.decode_step_cost

    def spy(cfg_, batch, live_lens):
        counted.append((batch, list(live_lens)))
        return cost_fn(cfg_, batch, live_lens)
    monkeypatch.setattr(obs_kernels, "decode_step_cost", spy)
    eng = Engine(params, cfg, noise_fn=ref_noise, device="cpu", **kw)
    eng.serve(_workload(scheduler, n=2, prefix=BLOCK))
    mine = eng.kernel_profile()["costs"]["decode_step_paged"]["flops"]
    ratio = mine / xla
    print(f"analytic flops {mine:.4g}, XLA {xla:.4g}, ratio {ratio:.3f}")
    assert 1.2 < ratio < 1.6
    (batch, live), = counted
    one_layer = cost_fn(cfg.replace(num_layers=1), batch, live)["flops"]
    assert abs(one_layer / xla - 1) < 0.1


# ---------------------------------------------------------------------------
# Ports of tests/test_obs.py's properties.
# ---------------------------------------------------------------------------
def test_tracing_off_streams_bit_identical(model):
    _, _, params, cfg = model
    kw = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
              top_k=TOP_K, paged=True, block_size=BLOCK, num_blocks=8,
              noise_fn=ref_noise, device="cpu")
    off = Engine(params, cfg, **kw).serve(_priority_workload(scheduler))
    tracer = obs_trace.Tracer(None)
    on = Engine(params, cfg, tracer=tracer, **kw).serve(
        _priority_workload(scheduler))
    assert tracer.close()
    assert {r.rid: r.tokens for r in off.results} == \
        {r.rid: r.tokens for r in on.results}
    assert (off.decode_steps, off.prefill_chunks, off.preemptions) == \
        (on.decode_steps, on.prefill_chunks, on.preemptions)


def test_tracer_flush_every_bounds_buffer(model, tmp_path):
    """``flush_every=N`` holds at most N events while the file stays one
    valid JSON array, through a preempt-and-swap serve; a second close
    writes nothing."""
    _, _, params, cfg = model
    path = tmp_path / "flushed.json"
    n = 8
    tracer = obs_trace.Tracer(str(path), flush_every=n)
    peak = 0
    emit = tracer._emit

    def spying_emit(entry):
        nonlocal peak
        emit(entry)
        peak = max(peak, len(tracer._buf))
    tracer._emit = spying_emit
    rep = Engine(params, cfg, num_slots=2, slot_len=SLOT_LEN,
                 prefill_chunk=CHUNK, top_k=TOP_K, paged=True,
                 block_size=BLOCK, num_blocks=8, noise_fn=ref_noise,
                 device="cpu", tracer=tracer).serve(
        _priority_workload(scheduler))
    tail = tracer.close()
    assert peak <= n < tracer.total_events and len(tail) < n
    loaded = json.loads(path.read_text())
    assert len(loaded) == tracer.total_events
    assert obs_report.validate(loaded) == []
    assert sum(e["name"] == "preempt" for e in loaded) == rep.preemptions
    before = path.read_bytes()
    assert tracer.close() == [] and path.read_bytes() == before


def test_tracer_flush_every_needs_path():
    with pytest.raises(ValueError, match="path"):
        obs_trace.Tracer(None, flush_every=4)
    with pytest.raises(ValueError, match="flush_every"):
        obs_trace.Tracer("unused.json", flush_every=0)


def test_router_tracer_arguments_checked(model):
    _, _, params, cfg = model
    kw = dict(num_slots=2, slot_len=SLOT_LEN, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        ReplicaRouter(params, cfg, replicas=2, tracer=obs_trace.Tracer(None),
                      tracers=[obs_trace.Tracer(None)] * 2, **kw)
    with pytest.raises(ValueError, match="1 entries for 2"):
        ReplicaRouter(params, cfg, replicas=2,
                      tracers=[obs_trace.Tracer(None)], **kw)


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")
                + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_report_cli_exit_codes(runs, tmp_path):
    """0 on a clean trace, 1 naming the problem on a broken one, 2 on a
    usage error."""
    good = tmp_path / "good.json"
    good.write_text(json.dumps(runs["paged"]["port"][0]))
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps([
        {"name": "decode", "ph": "X", "ts": 0.0, "dur": 5.0, "pid": 0,
         "tid": 1, "args": {"unclosed": True}}]))
    cli = [sys.executable, "-m", "repro_torch.obs.report"]
    out = subprocess.run(cli + [str(good)], capture_output=True, text=True,
                         timeout=120, env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert "trace OK: all spans closed and nested" in out.stdout
    out = subprocess.run(cli + [str(broken)], capture_output=True, text=True,
                         timeout=120, env=_env())
    assert out.returncode == 1 and "TRACE PROBLEM" in out.stderr
    assert "unclosed" in out.stderr
    out = subprocess.run(cli, capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 2


SERVE_CLI = ["--smoke", "--continuous", "--paged", "--requests", "5",
             "--tokens", "8", "--prompt-len", "10", "--slots", "2", "--rate",
             "3.0", "--prefill-chunk", "8", "--block-size", "8",
             "--shared-prefix", "8"]


def _observed_lines(text):
    """The lines of a ``--metrics`` run that hold no time: the counters,
    the occupancy histogram and the instrument count."""
    keep = ("decode steps:", "batch occupancy:", "block pool:",
            "blocks saved", "prefix cache:", "router:",
            "metric serving.occupancy", "metric serving.r1.occupancy",
            "metrics:")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_serve_cli_trace_and_metrics_lines_equal_reference(tmp_path, capsys):
    """``--trace FILE --metrics`` on the CPU: the reference CLI's lines,
    counters and occupancy histogram equal on the same flags, each op's
    path ``cpu``, and a trace of the reference CLI's event count."""
    mine_path, ref_path = tmp_path / "mine.json", tmp_path / "ref.json"
    for mets, kern in ((obs_metrics, obs_kernels), (RM, RK)):
        mets.reset()            # what earlier tests of this process recorded
        kern.reset()
    try:
        rc = serve.main(SERVE_CLI + ["--device", "cpu", "--metrics",
                                     "--trace", str(mine_path)])
        mine = capsys.readouterr().out
        ref_rc = RSV.main(SERVE_CLI + ["--metrics", "--trace",
                                       str(ref_path)])
        theirs = capsys.readouterr().out
    finally:
        for mets, kern in ((obs_metrics, obs_kernels), (RM, RK)):
            mets.disable()
            mets.reset()
            kern.disable_profiling()
            kern.reset()
    assert rc == ref_rc == 0
    assert _observed_lines(mine) == _observed_lines(theirs)
    assert "metrics: 15 instruments recorded" in mine
    paths = [ln for ln in mine.splitlines() if ln.startswith("kernel path:")]
    assert sorted(p.split()[2] for p in paths) == [
        "flash_attention_paged", "flash_decode_paged", "softmax_topk"]
    assert all("→ cpu" in p for p in paths)
    assert "kernel cost: decode_step_paged flops=" in mine
    n_ref = len(RReport.load_trace(str(ref_path)))
    assert f"trace: {n_ref} events → {mine_path}" in mine
    assert obs_report.validate(obs_report.load_trace(str(mine_path))) == []


def test_serve_cli_trace_dir_writes_replicas_and_merged(tmp_path, capsys):
    """``--replicas 2 --trace DIR/``: one trace per replica and a merged
    view aligned on the first ticks, which validate, with pids 0 and 1; the
    merge CLI and the report's ``--diff`` run clean on the pair."""
    tdir = tmp_path / "traces"
    rc = serve.main(SERVE_CLI + ["--device", "cpu", "--replicas", "2",
                                 "--no-affinity", "--trace",
                                 str(tdir) + os.sep])
    out = capsys.readouterr().out
    assert rc in (0, 1)                     # 1: the occupancy warning
    paths = [tdir / f"replica{i}.json" for i in range(2)]
    merged_path = tdir / "merged.json"
    assert "merged view" in out and merged_path.exists()
    per = [obs_report.load_trace(str(p)) for p in paths]
    merged = obs_report.load_trace(str(merged_path))
    assert obs_report.validate(merged) == []
    assert {e.get("pid") for e in merged} == {0, 1}
    assert len(merged) == sum(len(t) for t in per)
    firsts = [min(e["ts"] for e in merged if e["ph"] == "X"
                  and e["name"] == "tick" and e["pid"] == pid)
              for pid in (0, 1)]
    # aligned on the first ticks, then lifted as one so no event (a queued
    # span opened before the first tick) has a negative time
    assert firsts[0] == firsts[1] >= 0.0
    assert min(e["ts"] for e in merged if "ts" in e) == 0.0
    for t in per:
        assert obs_report.validate(t) == []
    mrg = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.merge", *map(str, paths),
         "--out", str(tmp_path / "again.json")],
        capture_output=True, text=True, timeout=120, env=_env())
    assert mrg.returncode == 0 and "merged 2 traces" in mrg.stdout
    assert "## Trace diff" in obs_report.diff(*per)
