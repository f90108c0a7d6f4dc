"""The port's CUDA kernels on the card (marked ``cuda``; skipped where
``torch.cuda.is_available()`` is false).  Run them on a card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel against its plain version at small shapes (fp32 tightly, bf16
within bf16 rounding), the int8 forms with poisoned dead scales and scales
read through non-contiguous views, a small model served on the card
through the kernels against the same model served on the CPU through the
plain versions, the kernel profile and trace of a served run, one
full-width train step through the training kernels, and rows 6 / 7 at a
causal q offset (the model axis's sequence mode).  No JAX is needed.
``chip_smoke.py`` does the same at full width.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import build, dispatch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import softmax_topk as st
from repro_torch.launch import serve
from repro_torch.models import layers, transformer

pytestmark = pytest.mark.cuda
# the int8 forms' counters, zero on every fp path
NO_INT8 = dict.fromkeys(("flash_decode_paged_int8", "flash_decode_int8",
                         "flash_attention_paged_int8"), 0)
# the online-softmax library's counters, zero on every serving path
NO_LIBRARY = dict.fromkeys(("online_softmax", "online_softmax_bf16",
                            "online_softmax_exp2", "online_normalizer"), 0)
# the MoE router's launches of softmax_topk, zero for a dense model
NO_ROUTER = {"softmax_topk_router": 0}
# the MLA kernels' counters, zero for a model without latent attention
NO_MLA = {"flash_decode_mla": 0, "flash_attention_mla": 0}
# the lse forms of the contiguous decode, zero outside a sharded decode
NO_LSE = {"flash_decode_lse": 0, "flash_decode_int8_lse": 0}
# rows 6 and 7 at a causal q offset, zero outside sequence-parallel training
NO_QOFFSET = dict.fromkeys(("flash_attention_qoffset",
                            "flash_attention_bwd_dq_qoffset",
                            "flash_attention_bwd_dkv_qoffset"), 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and launch the "
                    "port's CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged(seed, *, vlens, tq, bs=16, hkv=5, g=3, d=64):
    gen = torch.Generator().manual_seed(seed)
    live = [max(1, -(-v // bs)) for v in vlens]
    p = 1 + sum(live)
    k_pool = torch.randn(p, hkv, bs, d, generator=gen)
    v_pool = torch.randn(p, hkv, bs, d, generator=gen)
    ids = (torch.randperm(p - 1, generator=gen) + 1).tolist()
    tables = torch.zeros((len(vlens), max(live) + 1), dtype=torch.int32)
    for row, n in enumerate(live):
        for j in range(n):
            tables[row, j] = ids.pop()
    q = torch.randn(len(vlens), tq, hkv * g, d, generator=gen)
    return q, k_pool, v_pool, tables, torch.tensor(vlens, dtype=torch.int32)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_kernels_match_plain(cuda, dtype, atol):
    dispatch.reset_launch_counts()
    q, kp, vp, tables, vlen = _paged(0, vlens=[70, 33, 1], tq=1)
    dev = dict(device=cuda, dtype=dtype)
    args = (q.to(**dev), kp.to(**dev), vp.to(**dev), tables.to(cuda),
            vlen.to(cuda))
    got = fd.flash_decode_paged(*args)
    want = fd.flash_decode_paged_plain(*args)
    assert (got.float() - want.float()).abs().max().item() <= atol

    q, kp, vp, tables, vlen = _paged(1, vlens=[40, 23, 0], tq=21)
    qoff = (vlen - 21).clamp(min=0)
    args = (q.to(**dev), kp.to(**dev), vp.to(**dev), qoff.to(cuda),
            vlen.to(cuda), tables.to(cuda))
    out, lse = fa.flash_attention_paged(*args)
    w_out, w_lse = fa.flash_attention_paged_plain(*args)
    assert (out.float() - w_out.float()).abs().max().item() <= atol
    assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
    assert torch.isneginf(lse[2]).all()                  # no valid key
    fin = torch.isfinite(w_lse)
    assert (lse[fin] - w_lse[fin]).abs().max().item() <= max(atol, 1e-4)

    x = torch.randn(4, 5000, generator=torch.Generator().manual_seed(2))
    x[0, [9, 4000, 77]] = x[0].max() + 1.0               # exact ties
    x = x.to(**dev)
    a, b = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    assert torch.equal(a.indices.long(), b.indices)
    assert a.indices[0, :3].tolist() == [9, 77, 4000]
    torch.testing.assert_close(a.logsumexp, b.logsumexp, rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    assert dispatch.launch_counts() == {"softmax_topk": 1,
                                        "flash_decode_paged": 1,
                                        "flash_decode": 0,
                                        "flash_attention_paged": 1,
                                        "flash_attention_offset": 0,
                                        "flash_attention": 0,
                                        "flash_attention_bwd_dq": 0,
                                        "flash_attention_bwd_dkv": 0,
                                        **NO_INT8, **NO_LIBRARY, **NO_ROUTER,
                                        **NO_MLA, **NO_LSE, **NO_QOFFSET}


def _contiguous(seed, *, b, s, tq, vlens, hkv=5, g=3, d=64):
    """q [B, Tq, Hq, D] and caches [B, S, Hkv, D] with every position at or
    past a row's valid length set to NaN, so a kernel that reads one fails;
    the plain version gets the same caches with those positions zeroed."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, hkv * g, d, generator=gen)
    k = torch.randn(b, s, hkv, d, generator=gen)
    v = torch.randn(b, s, hkv, d, generator=gen)
    dead = torch.arange(s)[None, :] >= torch.tensor(vlens)[:, None]
    k_nan = k.masked_fill(dead[..., None, None], float("nan"))
    v_nan = v.masked_fill(dead[..., None, None], float("nan"))
    k0 = k.masked_fill(dead[..., None, None], 0.0)
    v0 = v.masked_fill(dead[..., None, None], 0.0)
    return q, (k_nan, v_nan), (k0, v0), torch.tensor(vlens, dtype=torch.int32)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_contiguous_kernels_match_plain(cuda, dtype, atol):
    """The slot pool's kernels: decode over ragged valid lengths (0, 1 and
    S among them), and cached prefill at per-row offsets with a keyless row
    and Tq not a multiple of the 16-row tile."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    vlens = [0, 1, 70, 33, 96]
    q, kv_nan, kv0, vlen = _contiguous(5, b=5, s=96, tq=1, vlens=vlens)
    got = fd.flash_decode(q.to(**dev), *(t.to(**dev) for t in kv_nan),
                          vlen.to(cuda))
    want = fd.flash_decode_plain(q.to(**dev), *(t.to(**dev) for t in kv0),
                                 vlen.to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # vlen 0 → 0
    with pytest.raises(ValueError, match="D=32"):        # head_dim 64 only
        fd.flash_decode(q[..., :32].to(**dev), kv0[0][..., :32].to(**dev),
                        kv0[1][..., :32].to(**dev), vlen.to(cuda))

    vlens = [40, 23, 0]
    q, kv_nan, kv0, vlen = _contiguous(6, b=3, s=50, tq=21, vlens=vlens)
    qoff = (vlen - 21).clamp(min=0)
    args = (q.to(**dev),)
    out, lse = fa.flash_attention_offset(
        *args, *(t.to(**dev) for t in kv_nan), qoff.to(cuda), vlen.to(cuda))
    w_out, w_lse = fa.flash_attention_offset_plain(
        *args, *(t.to(**dev) for t in kv0), qoff.to(cuda), vlen.to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - w_out.float()).abs().max().item() <= atol
    assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
    assert torch.isneginf(lse[2]).all()                  # no valid key
    fin = torch.isfinite(w_lse)
    assert (lse[fin] - w_lse[fin]).abs().max().item() <= max(atol, 1e-4)
    with pytest.raises(ValueError, match="D=32"):
        fa.flash_attention_offset(
            q[..., :32].to(**dev), kv0[0][..., :32].to(**dev),
            kv0[1][..., :32].to(**dev), qoff.to(cuda), vlen.to(cuda))
    assert dispatch.launch_counts() == {"softmax_topk": 0,
                                        "flash_decode_paged": 0,
                                        "flash_decode": 1,
                                        "flash_attention_paged": 0,
                                        "flash_attention_offset": 1,
                                        "flash_attention": 0,
                                        "flash_attention_bwd_dq": 0,
                                        "flash_attention_bwd_dkv": 0,
                                        **NO_INT8, **NO_LIBRARY, **NO_ROUTER,
                                        **NO_MLA, **NO_LSE, **NO_QOFFSET}


def test_served_streams_equal_on_card_and_cpu(cuda):
    """A small model with head_dim 64 (the kernels' width) served through
    ``Engine`` on the card and on the CPU: identical token streams and pool
    accounting, and every kernel launch the scheduler's counters imply."""
    cfg = configs.get_smoke("smollm_360m").replace(
        num_heads=6, num_kv_heads=2, head_dim=64)
    params_cpu = transformer.init(cfg, seed=4, device="cpu")
    argv = ["--smoke", "--continuous", "--paged", "--requests", "5",
            "--tokens", "8", "--prompt-len", "20", "--slots", "2",
            "--prefill-chunk", "8", "--block-size", "8", "--shared-prefix",
            "8"]
    runs = {}
    for device, params in (("cuda", transformer.params_to(params_cpu, cuda)),
                           ("cpu", params_cpu)):
        args = serve.parse_args(argv + ["--device", device])
        dispatch.reset_launch_counts()
        report, router, _, _ = serve.run(args, cfg, params)
        eng = router.engines[0]
        runs[device] = (report, eng.scheduler, dispatch.launch_counts())
    (rep_g, sched, counts), (rep_c, _, cpu_counts) = runs["cuda"], runs["cpu"]
    assert {r.rid: r.tokens for r in rep_g.results} == \
        {r.rid: r.tokens for r in rep_c.results}
    assert rep_g.paged == rep_c.paged
    ones = sched.chunk_widths.get(1, 0)
    assert counts == {
        "softmax_topk": sched.decode_steps + sched.prefills_done,
        "flash_decode_paged": (sched.decode_steps + ones) * cfg.num_layers,
        "flash_decode": 0,
        "flash_attention_paged": (sched.prefill_chunks - ones)
        * cfg.num_layers,
        "flash_attention_offset": 0,
        "flash_attention": 0,
        "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0, **NO_INT8, **NO_LIBRARY, **NO_ROUTER,
        **NO_MLA, **NO_LSE, **NO_QOFFSET}
    assert set(cpu_counts.values()) == {0}
    assert all(0 <= t < cfg.vocab_size for r in rep_g.results
               for t in r.tokens)
    assert np.isfinite(rep_g.tokens_per_s)


def test_kernel_profile_and_trace_on_card(cuda, tmp_path):
    """``--trace FILE --metrics`` on the card: the trace validates, every
    op's path is ``cuda`` with its count equal to the launch counts (the
    profile's replay of the first decode step included), and the profiled
    step ran the split decode once per layer and the sampler once, within
    a device time above its bound."""
    from repro_torch.obs import kernels as obs_kernels
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import report as obs_report
    cfg = configs.get_smoke("smollm_360m").replace(
        num_heads=6, num_kv_heads=2, head_dim=64)
    params = transformer.init(cfg, seed=4, device=cuda)
    path = tmp_path / "t.json"
    args = serve.parse_args(
        ["--smoke", "--continuous", "--paged", "--requests", "4",
         "--tokens", "6", "--prompt-len", "20", "--slots", "2",
         "--prefill-chunk", "8", "--block-size", "8", "--device", "cuda",
         "--trace", str(path), "--metrics"])
    obs_kernels.reset()
    dispatch.reset_launch_counts()
    try:
        report, router, _, _ = serve.run(args, cfg, params)
        prof = router.engines[0].kernel_profile()
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
        obs_kernels.disable_profiling()
    counts = dispatch.launch_counts()
    assert {op: (p["path"], p["count"]) for op, p in prof["paths"].items()} \
        == {op: ("cuda", n) for op, n in counts.items() if n}
    cost = prof["costs"]["decode_step_paged"]
    assert cost["kernels"]["decode_paged_split_kernel"]["calls"] == \
        cfg.num_layers
    assert cost["kernels"]["softmax_topk_kernel"]["calls"] == 1
    assert cost["device_ms"] > cost["bound_ms"] > 0
    events = obs_report.load_trace(str(path))
    assert obs_report.validate(events) == []
    assert sum(e["name"] == "token" for e in events) == report.total_tokens


def test_profile_step_raises_without_a_kernel(cuda):
    """A queued step on the card that launches no kernel raises when it is
    profiled, rather than recording an empty profile: only the analytic
    cost stays."""
    from repro_torch.obs import kernels as obs_kernels
    cost = {"flops": 1.0, "bytes_accessed": 1.0, "dtype": "float32"}
    obs_kernels.reset()
    obs_kernels.profile_step(lambda: 0, "empty", cost=cost, device=cuda)
    with pytest.raises(RuntimeError, match="launched none"):
        obs_kernels.run_pending()
    assert obs_kernels.snapshot()["costs"]["empty"] == {
        "flops": 1.0, "bytes_accessed": 1.0}
    obs_kernels.reset()


def test_unpaged_streams_equal_on_card_and_cpu(cuda):
    """The slot pool and the lockstep loop of the same small model (head_dim
    64) on the card and on the CPU: identical token streams, and on the card
    the launches the scheduler's counters (or the loop's steps) imply."""
    cfg = configs.get_smoke("smollm_360m").replace(
        num_heads=6, num_kv_heads=2, head_dim=64)
    params_cpu = transformer.init(cfg, seed=4, device="cpu")
    pool_argv = ["--smoke", "--continuous", "--requests", "5", "--tokens",
                 "8", "--prompt-len", "20", "--slots", "2", "--prefill-chunk",
                 "8"]
    lock_argv = ["--smoke", "--batch", "3", "--prompt-len", "19",
                 "--tokens", "6"]
    runs = {}
    for device, params in (("cuda", transformer.params_to(params_cpu, cuda)),
                           ("cpu", params_cpu)):
        args = serve.parse_args(pool_argv + ["--device", device])
        dispatch.reset_launch_counts()
        report, router, _, _ = serve.run(args, cfg, params)
        eng = router.engines[0]
        pool_counts = dispatch.launch_counts()
        dispatch.reset_launch_counts()
        ids = serve.lockstep(serve.parse_args(lock_argv + ["--device",
                                                           device]),
                             cfg, params)
        runs[device] = (report, eng.scheduler, pool_counts, ids,
                        dispatch.launch_counts())
    (rep_g, sched, counts, ids_g, lock_counts) = runs["cuda"]
    rep_c, ids_c = runs["cpu"][0], runs["cpu"][3]
    assert rep_g.paged is None
    assert {r.rid: r.tokens for r in rep_g.results} == \
        {r.rid: r.tokens for r in rep_c.results}
    assert np.array_equal(ids_g, ids_c)
    ones = sched.chunk_widths.get(1, 0)
    n = cfg.num_layers
    assert counts == {
        "softmax_topk": sched.decode_steps + sched.prefills_done,
        "flash_decode_paged": 0,
        "flash_decode": (sched.decode_steps + ones) * n,
        "flash_attention_paged": 0,
        "flash_attention_offset": (sched.prefill_chunks - ones) * n,
        "flash_attention": 0,
        "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0, **NO_INT8, **NO_LIBRARY, **NO_ROUTER,
        **NO_MLA, **NO_LSE, **NO_QOFFSET}
    assert lock_counts == {"softmax_topk": 6, "flash_decode_paged": 0,
                           "flash_decode": 5 * n, "flash_attention_paged": 0,
                           "flash_attention_offset": n,
                           "flash_attention": 0,
                           "flash_attention_bwd_dq": 0,
                           "flash_attention_bwd_dkv": 0, **NO_INT8,
                           **NO_LIBRARY, **NO_ROUTER,
                           **NO_MLA, **NO_LSE, **NO_QOFFSET}


def _fresh(seed, *, b, t, hkv=5, g=3, d=64, spare=7, dv=None):
    """q [B, T, Hq, D], dout [B, T, Hq, Dv]; k [B, T, Hkv, D] and v
    [B, T, Hkv, Dv] cut from buffers of T + ``spare`` positions whose rows
    past T are NaN, so a kernel that reads past T fails.  Dv is D unless
    ``dv`` is given (MLA's 96 / 64), and then k and v are cut from buffers
    of their own, so their strides differ."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, hkv * g, d, generator=gen)
    dout = torch.randn(b, t, hkv * g, dv or d, generator=gen)
    if dv is not None:
        k = torch.randn(b, t + spare, hkv, d, generator=gen)
        v = torch.randn(b, t + spare, hkv, dv, generator=gen)
        k[:, t:] = v[:, t:] = float("nan")
        return q, k[:, :t], v[:, :t], dout
    kv = torch.randn(2, b, t + spare, hkv, d, generator=gen)
    kv[:, :, t:] = float("nan")
    return q, kv[0, :, :t], kv[1, :, :t], dout


def _check_fresh_kernels(cuda, dtype, atol, *, hkv=5, g=3, d=64, dv=None):
    """The training kernels at ``hkv`` KV heads of ``g`` query heads and
    head dims ``d`` (q, k) and ``dv`` (v; ``d`` if unset) against their
    plain versions: the fresh forward (out,
    lse), the dq and dk/dv backward kernels over ragged T (not a multiple
    of 16 or of 64), T = 1, one and several 64-row tiles, causal and not,
    K/V read through strides with NaN past T; then ``FlashAttention``'s
    gradients against autograd through the plain forward.  Returns that
    last case's (q, k, v)."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    n = 0
    for t, causal in ((37, True), (37, False), (1, True), (1, False),
                      (64, True), (130, True), (130, False)):
        q, k, v, dout = (x.to(**dev)
                         for x in _fresh(7, b=2, t=t, hkv=hkv, g=g, d=d,
                                         dv=dv))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        w_out, w_lse = fa.flash_attention_fwd_plain(
            q, torch.nan_to_num(k), torch.nan_to_num(v), causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        assert (out.float() - w_out.float()).abs().max().item() <= atol
        assert (lse - w_lse).abs().max().item() <= max(atol, 1e-4)
        grads = fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                        causal=causal)
        want = fab.flash_attention_bwd_plain(
            q, torch.nan_to_num(k), torch.nan_to_num(v), out, lse, dout,
            causal=causal)
        torch.cuda.synchronize()
        for name, a, b_ in zip(("dq", "dk", "dv"), grads, want):
            assert a.shape == b_.shape and a.dtype == b_.dtype, name
            assert torch.isfinite(a).all(), name
            scale = max(1.0, b_.float().abs().max().item())
            err = (a.float() - b_.float()).abs().max().item()
            assert err <= atol * scale, (name, t, causal, err)
        n += 1
    # FlashAttention.apply against autograd through the plain forward
    q, k, v, dout = (x.to(**dev)
                     for x in _fresh(8, b=2, t=37, hkv=hkv, g=g, d=d, dv=dv))
    k, v = torch.nan_to_num(k), torch.nan_to_num(v)
    got, want = [], []
    for fn, store in ((lambda a, b_, c: fa.FlashAttention.apply(a, b_, c,
                                                                 True), got),
                      (lambda a, b_, c: fa.flash_attention_fwd_plain(
                          a, b_, c, causal=True)[0], want)):
        args = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        fn(*args).backward(dout)
        store.extend(a.grad for a in args)
    for a, b_ in zip(got, want):
        scale = max(1.0, b_.float().abs().max().item())
        assert (a.float() - b_.float()).abs().max().item() <= atol * scale
    counts = dispatch.launch_counts()
    assert counts["flash_attention"] == n + 1
    assert counts["flash_attention_bwd_dq"] == n + 1
    assert counts["flash_attention_bwd_dkv"] == n + 1
    return q, k, v


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_fresh_attention_kernels_match_plain(cuda, dtype, atol):
    """The training kernels (bf16: the tensor-core forms; fp32: the
    CUDA-core forms) at head dim 64 (``_check_fresh_kernels``); a head dim
    without an instance raises."""
    q, k, v = _check_fresh_kernels(cuda, dtype, atol)
    with pytest.raises(ValueError, match="D=32"):      # head_dim 64 or 128
        fa.flash_attention_fwd(q[..., :32].contiguous(),
                               k[..., :32].contiguous(),
                               v[..., :32].contiguous())


def test_fresh_attention_is_deterministic(cuda):
    """Two launches of the bf16 forward and of the backward on the same
    input give bit-equal out, lse, dq, dk and dv (no atomics, no split that
    sums in a scheduling-dependent order), at the training shape cut to
    B = 2."""
    q, k, v, dout = (x.to(device=cuda, dtype=torch.bfloat16)
                     for x in _fresh(9, b=2, t=512))
    runs = []
    for _ in range(2):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        runs.append((out, lse) + fab.flash_attention_bwd(
            q, k, v, out, lse, dout, causal=True))
    torch.cuda.synchronize()
    for name, a, b_ in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.isfinite(a).all() and torch.equal(a, b_), name


def test_full_width_train_step(cuda):
    """One bf16 train step of smollm-360m at full width (cut to 4 layers)
    through the training kernels: finite loss and grad norm, and with remat
    "full" 2 forward launches per layer (forward, recomputed in the
    backward) and one dq and one dk/dv launch per layer."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.training.train_step import init_state, make_train_step
    cfg = configs.get("smollm_360m").replace(num_layers=4)
    run = RunConfig(model=cfg)
    params, opt = init_state(run, device=cuda)
    batch = SyntheticDataset(SyntheticConfig(cfg.vocab_size, 128, 2)).batch(0)
    batch = {k: torch.as_tensor(x, device=cuda) for k, x in batch.items()}
    dispatch.reset_launch_counts()
    params, opt, m = make_train_step(run)(params, opt, batch)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert counts["flash_attention"] == 2 * cfg.num_layers
    assert counts["flash_attention_bwd_dq"] == cfg.num_layers
    assert counts["flash_attention_bwd_dkv"] == cfg.num_layers
    assert counts["flash_decode"] == counts["softmax_topk"] == 0


def _int8_paged(seed, *, vlens, tq, bs=16, hkv=5, g=3, d=64):
    """int8 pools and scale pages (``_quantize_kv`` of random K/V) for rows
    of valid lengths ``vlens``, as two copies: the kernel's, whose dead
    table entries point at block 1 (payload ±127, scales NaN) and whose
    positions at or past a row's vlen have NaN scales, the scale pages
    being a non-contiguous per-layer view of a [2, P, Hkv, BS + 3] buffer;
    and the plain version's, dead entries at the sentinel, those scales 0.
    Row order keeps an idle row (vlen <= 1) on the sentinel block 0."""
    gen = torch.Generator().manual_seed(seed)
    live = [max(1, -(-v // bs)) for v in vlens]
    p = 2 + sum(live)
    k8, ks = layers._quantize_kv(torch.randn(p, bs, hkv, d, generator=gen))
    v8, vs = layers._quantize_kv(torch.randn(p, bs, hkv, d, generator=gen))
    pools = [x.transpose(1, 2).contiguous() for x in (k8, v8, ks, vs)]
    pools[2][0] = pools[3][0] = 0.0             # the sentinel's scales
    ids = (torch.randperm(p - 2, generator=gen) + 2).tolist()
    t_kernel = torch.ones((len(vlens), max(live) + 1), dtype=torch.int32)
    t_plain = torch.zeros_like(t_kernel)
    for row, n in enumerate(live):
        for j in range(n):
            t_kernel[row, j] = t_plain[row, j] = ids.pop()
        if vlens[row] <= 1:
            t_kernel[row, 0] = t_plain[row, 0] = 0
    plain = [x.clone() for x in pools]
    kern = [x.clone() for x in pools]
    kern[0][1], kern[1][1] = 127, -127
    kern[2][1] = kern[3][1] = float("nan")
    for row, n in enumerate(vlens):             # tails past vlen
        for pos in range(n, live[row] * bs):
            blk = int(t_kernel[row, pos // bs])
            if blk > 1:
                kern[2][blk, :, pos % bs] = kern[3][blk, :, pos % bs] = \
                    float("nan")
                plain[2][blk, :, pos % bs] = plain[3][blk, :, pos % bs] = 0.0
    for x in (kern, plain):
        for i in (2, 3):                        # a per-layer strided view
            buf = torch.full((2, p, hkv, bs + 3), float("nan"),
                             dtype=torch.bfloat16)
            buf[1, ..., :bs] = x[i]
            x[i] = buf[1, ..., :bs]
    q = torch.randn(len(vlens), tq, hkv * g, d, generator=gen)
    return q, kern, plain, t_kernel, t_plain, torch.tensor(vlens,
                                                          dtype=torch.int32)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_int8_kernels_match_plain(cuda, dtype, atol):
    """The int8 forms of the paged decode, the contiguous decode and the
    paged prefill kernels against their plain versions: dead table entries
    and positions past vlen carry NaN scales, idle rows read the sentinel
    block 0 (scales 0) and stay finite, and the scales are read through
    non-contiguous views (a per-layer slice of the paged scale pages,
    transposed contiguous scales)."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda)
    q, kern, plain, tk, tp, vlen = _int8_paged(9, vlens=[70, 33, 0, 1],
                                               tq=1)
    assert not kern[2].is_contiguous()
    q = q.to(dtype=dtype, **dev)
    kern = [x.to(**dev) for x in kern]
    plain = [x.to(**dev) for x in plain]
    got = fd.flash_decode_paged(q, kern[0], kern[1], tk.to(cuda),
                                vlen.to(cuda), k_scale_pool=kern[2],
                                v_scale_pool=kern[3])
    want = fd.flash_decode_paged_plain(q, plain[0], plain[1], tp.to(cuda),
                                       vlen.to(cuda), k_scale_pool=plain[2],
                                       v_scale_pool=plain[3])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= atol

    q, kern, plain, tk, tp, vlen = _int8_paged(10, vlens=[40, 23, 0],
                                               tq=21)
    qoff = (vlen - 21).clamp(min=0)
    args = (q.to(dtype=dtype, **dev),)
    out, lse = fa.flash_attention_paged(
        *args, *(x.to(**dev) for x in kern[:2]), qoff.to(cuda),
        vlen.to(cuda), tk.to(cuda), k_scale_pool=kern[2].to(cuda),
        v_scale_pool=kern[3].to(cuda))
    w_out, w_lse = fa.flash_attention_paged_plain(
        *args, *(x.to(**dev) for x in plain[:2]), qoff.to(cuda),
        vlen.to(cuda), tp.to(cuda), k_scale_pool=plain[2].to(cuda),
        v_scale_pool=plain[3].to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - w_out.float()).abs().max().item() <= atol
    assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
    fin = torch.isfinite(w_lse)
    assert (lse[fin] - w_lse[fin]).abs().max().item() <= max(atol, 1e-4)

    # contiguous int8 caches [B, S, Hkv, D], scales [B, S, Hkv] as a
    # transposed view; NaN scales and ±127 at or past each row's vlen
    gen = torch.Generator().manual_seed(11)
    b, s, hkv, d = 5, 96, 5, 64
    vlens = [0, 1, 70, 33, 96]
    k8, ks = layers._quantize_kv(torch.randn(b, s, hkv, d, generator=gen))
    v8, vs = layers._quantize_kv(torch.randn(b, s, hkv, d, generator=gen))
    dead = torch.arange(s)[None, :] >= torch.tensor(vlens)[:, None]
    caches = {}
    for name, fill in (("kernel", float("nan")), ("plain", 0.0)):
        kk, vv = k8.clone(), v8.clone()
        if name == "kernel":
            kk[dead], vv[dead] = 127, -127
        sc = []
        for x in (ks, vs):
            buf = x.masked_fill(dead[..., None], fill).transpose(1, 2)
            sc.append(buf.contiguous().transpose(1, 2))   # strides (.., 1, S)
        caches[name] = [t.to(cuda) for t in (kk, vv, *sc)]
    assert not caches["kernel"][2].is_contiguous()
    q = torch.randn(b, 1, hkv * 3, d, generator=gen).to(dtype=dtype, **dev)
    vl = torch.tensor(vlens, dtype=torch.int32, device=cuda)
    kc, pc = caches["kernel"], caches["plain"]
    got = fd.flash_decode(q, kc[0], kc[1], vl, k_scale=kc[2], v_scale=kc[3])
    want = fd.flash_decode_plain(q, pc[0], pc[1], vl, k_scale=pc[2],
                                 v_scale=pc[3])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # vlen 0 → 0
    with pytest.raises(ValueError, match="bf16 scales"):
        fd.flash_decode(q, kc[0], kc[1], vl, k_scale=kc[2].float(),
                        v_scale=kc[3].float())
    counts = dispatch.launch_counts()
    assert {k: counts[k] for k in NO_INT8} == {
        "flash_decode_paged_int8": 1, "flash_decode_int8": 1,
        "flash_attention_paged_int8": 1}
    assert sum(counts.values()) == 3


def _library_input(seed, r, v, dtype, cuda):
    """Rows of x [R, V] with the edge cases the online kernels must keep:
    row 0 dead over its leading half (its first slice when V > 8192), row
    1 all -inf, row 2 a dead tail; V with and without a 128 or 4096 tail."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(r, v, generator=gen) * 4.0
    x[0, :v // 2] = float("-inf")
    x[1] = float("-inf")
    x[2, v - v // 3:] = float("-inf")
    return x.to(device=cuda, dtype=dtype)


@pytest.mark.parametrize("form", ["exact", "bf16", "exp2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_online_softmax_kernels_match_plain(cuda, form, dtype):
    """Each form of the online softmax kernel and the normalizer kernel
    against the plain versions on the CPU: m equal, y within the form's
    bound of the fp32 reference (``kernel_error_bound``), the exact
    normalizer's d within ``exact_error_bound``; -inf rows give (-inf, 0)
    and y = 0; one counted launch per call.  The bounds count relative
    roundings, so each entry is held within the bound times itself."""
    from repro_torch.core import softmax_forms as sf
    from repro_torch.kernels import online_softmax as osk
    dispatch.reset_launch_counts()
    shapes = ((5, 1000), (3, 9000), (4, 4097), (6, 130), (3, 8320))
    for i, (r, v) in enumerate(shapes):
        x = _library_input(20 + i, r, v, dtype, cuda)
        y = osk.online_softmax(x, form)
        m, d = osk.online_normalizer(x)
        torch.cuda.synchronize()
        xc = x.cpu()
        ref = osk.online_softmax_plain(xc.float())
        pm, pd = osk.online_normalizer_plain(xc)
        assert y.dtype == dtype and y.shape == x.shape
        err = (y.cpu().float() - ref).abs()
        bound = osk.kernel_error_bound(xc, form)     # relative to each y
        assert (err <= bound * ref + 1e-30).all(), (r, v, err.max())
        assert torch.equal(m.cpu(), pm)
        live = pd > 0
        rel = ((d.cpu() - pd).abs()[live] / pd[live]).max().item()
        assert rel <= sf.exact_error_bound(xc), (r, v, rel)
        assert d[1].item() == 0.0 and torch.isneginf(m[1])
        assert torch.equal(y[1], torch.zeros_like(y[1]))
        assert (y[torch.isneginf(x)] == 0).all()
        assert torch.isfinite(y).all()
    counts = dispatch.launch_counts()
    assert counts[osk.KERNEL_NAMES[form]] == len(shapes)
    assert counts["online_normalizer"] == len(shapes)
    assert sum(counts.values()) == 2 * len(shapes)


def test_library_entry_points_on_card(cuda):
    """``dispatch.online_softmax`` under each form preference,
    ``ops.online_normalizer`` and ``ops.softmax_topk``'s gradient on the
    card against the same calls on the CPU."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import online_softmax as osk
    dispatch.reset_launch_counts()
    x = _library_input(30, 4, 5000, torch.float32, cuda)
    for form in dispatch.SOFTMAX_FORMS:
        prev = dispatch.set_softmax_form(form)
        try:
            got, want = dispatch.online_softmax(x), dispatch.online_softmax(
                x.cpu())
        finally:
            dispatch.set_softmax_form(prev)
        err = (got.cpu() - osk.online_softmax_plain(x.cpu())).abs().max()
        assert err.item() <= osk.kernel_error_bound(x.cpu(), form)
        assert want.device.type == "cpu"
    m, _ = ops.online_normalizer(x)
    assert torch.equal(m.cpu(), ops.online_normalizer(x.cpu())[0])
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xg = torch.randn(3, 2000, generator=torch.Generator().manual_seed(
            31)).mul(4.0).to(dev).requires_grad_(True)
        out = ops.softmax_topk(xg, 5)
        ((out.values ** 2).sum() + 0.1 * (out.logsumexp ** 2).sum()
         ).backward()
        grads.append(xg.grad.cpu())
    scale = grads[1].abs().max().item()
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4 * scale
    counts = dispatch.launch_counts()
    assert counts["online_softmax"] == counts["online_softmax_bf16"] == 1
    assert counts["online_softmax_exp2"] == 1
    assert counts["online_normalizer"] == 1 and counts["softmax_topk"] == 1


def test_entry_point_gradients_on_card(cuda):
    """On CUDA the unflagged ``dispatch.softmax_topk`` and
    ``dispatch.online_softmax`` on a requires-grad input come back with a
    graph (one counted launch each) and their gradients equal the CPU's;
    ``dispatch.online_normalizer`` raises for such an input rather than
    returning a detached result, and runs under ``torch.no_grad()``."""
    dispatch.reset_launch_counts()
    x0 = torch.randn(3, 2000, generator=torch.Generator().manual_seed(32))
    w = torch.randn(3, 2000, generator=torch.Generator().manual_seed(33))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        xg = (x0 * 4.0).to(dev).requires_grad_(True)
        out = dispatch.softmax_topk(xg, 5)
        y = dispatch.online_softmax(xg, form="exact")
        assert out.values.grad_fn is not None and y.grad_fn is not None
        ((out.values ** 2).sum() + 0.1 * (out.logsumexp ** 2).sum()
         + (y * w.to(dev)).sum()).backward()
        grads[dev.type] = xg.grad.cpu()
    scale = grads["cpu"].abs().max().item()
    assert (grads["cuda"] - grads["cpu"]).abs().max().item() <= 1e-4 * scale
    xg = x0.to(cuda).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        dispatch.online_normalizer(xg)
    with torch.no_grad():
        m, _ = dispatch.online_normalizer(xg)
    assert torch.equal(m.cpu(), dispatch.online_normalizer(x0)[0])
    counts = dispatch.launch_counts()
    assert counts["softmax_topk"] == counts["online_softmax"] == 1
    assert counts["online_normalizer"] == 1 and sum(counts.values()) == 3


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_offset_kernel_at_new_shapes(cuda, dtype, atol):
    """The contiguous cached prefill in its dtype's form (bf16: the
    tensor-core form; fp32: the CUDA-core form) at an int8 run's
    single-shot widths (Tq = Tk = 80, 272), offsets off the 64-row tile,
    Tq 65 and 130, and a keyless row, K/V NaN at and past each vlen; one
    counted launch a call."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    cases = [([0], [80], 80, 80), ([0], [272], 272, 272),
             ([100], [164], 64, 328), ([37, 100], [102, 165], 65, 300),
             ([3, 150], [133, 280], 130, 300), ([0, 5, 13], [37, 42, 0], 37,
                                                 64)]
    for i, (qoff, vlens, tq, s) in enumerate(cases):
        q, kv_nan, kv0, vlen = _contiguous(40 + i, b=len(vlens), s=s, tq=tq,
                                           vlens=vlens)
        qo = torch.tensor(qoff, dtype=torch.int32, device=cuda)
        out, lse = fa.flash_attention_offset(
            q.to(**dev), *(t.to(**dev) for t in kv_nan), qo, vlen.to(cuda))
        w_out, w_lse = fa.flash_attention_offset_plain(
            q.to(**dev), *(t.to(**dev) for t in kv0), qo, vlen.to(cuda))
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), (qoff, vlens, tq)
        assert (out.float() - w_out.float()).abs().max().item() <= atol
        assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
        fin = torch.isfinite(w_lse)
        assert (lse[fin] - w_lse[fin]).abs().max().item() <= max(atol, 1e-4)
        if 0 in vlens:
            assert torch.isneginf(lse[vlens.index(0)]).all()
    assert dispatch.launch_counts()["flash_attention_offset"] == len(cases)


def test_online_softmax_designs_match_plain(cuda):
    """The online softmax in every form and the normalizer at V on both
    sides of the row-resident limit, a row streaming in three slices, V =
    1001 and 4097, rows starting off a
    16-byte boundary (fp32 and bf16) and 70000 rows, against the plain
    versions on the CPU; then ``dispatch.softmax_topk`` over 70000 rows
    against its plain version."""
    from repro_torch.core import softmax_forms as sf
    from repro_torch.kernels import online_softmax as osk
    limit = osk.RESIDENT_ROW_BYTES // 4
    # [3, 140000] streams in 3 slices, the first wholly -inf in row 0
    shapes = ((3, limit, torch.float32, 0), (3, limit + 1, torch.float32, 0),
              (3, 140000, torch.float32, 0),
              (5, 1001, torch.float32, 1), (5, 4097, torch.float32, 3),
              (5, 1001, torch.bfloat16, 1), (70000, 1000, torch.float32, 0))
    for i, (r, v, dtype, start) in enumerate(shapes):
        x0 = _library_input(50 + i, r, v, dtype, cuda)
        buf = torch.empty(r * v + start, dtype=dtype, device=cuda)
        x = buf[start:].view(r, v).copy_(x0)
        assert (x.data_ptr() % 16 != 0) == (start != 0)
        rows = list(range(3)) + list(range(3, r, max(1, r // 20)))
        xc = x[rows].cpu()
        ref = osk.online_softmax_plain(xc.float())
        for form in ("exact", "bf16", "exp2"):
            y = osk.online_softmax(x, form)
            torch.cuda.synchronize()
            err = (y[rows].cpu().float() - ref).abs()
            bound = osk.kernel_error_bound(xc, form)
            assert (err <= bound * ref + 1e-30).all(), (r, v, form)
            assert (y[torch.isneginf(x)] == 0).all()
        m, d = osk.online_normalizer(x)
        pm, pd = osk.online_normalizer_plain(xc)
        assert torch.equal(m[rows].cpu(), pm)
        live = pd > 0
        rel = ((d[rows].cpu() - pd).abs()[live] / pd[live]).max().item()
        assert rel <= sf.exact_error_bound(xc)
        assert d[1].item() == 0.0 and torch.isneginf(m[1])
    x = torch.randn(70000, 1000, generator=torch.Generator().manual_seed(
        59)).mul(4.0).to(cuda)
    got, want = dispatch.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    torch.cuda.synchronize()
    assert torch.equal(got.indices.long(), want.indices)
    assert torch.allclose(got.values, want.values, rtol=1e-5, atol=0.0)


def _split_rows(cuda, max_len, unit, kv_dtype, seed):
    """The smallest batch (from 8) whose plan's split edges fit a row each,
    and its valid lengths: 0, 1, every split edge ± 1 and ``max_len`` (one
    row for every count of live splits), the rest drawn at random."""
    for b in range(8, 256):
        plan = fd.decode_plan(b, 5, 3, 64, max_len, unit, kv_dtype,
                              build.sm_count(cuda))
        if 3 * plan.splits <= b:
            break
    edges = [0, 1, max_len] + [k * plan.split + o
                               for k in range(1, plan.splits)
                               for o in (-1, 0, 1)]
    rest = np.random.default_rng(seed).integers(2, max_len + 1,
                                                b - len(edges))
    return plan, edges + rest.tolist()


def _poison_paged(kp, vp, tables, vlens, bs):
    """The kernel's pools and table: one NaN block appended, every dead
    table entry pointed at it, every position at or past vlen in a row's
    last live block NaN; the plain version's: those positions 0."""
    nan = torch.full_like(kp[:1], float("nan"))
    kern = [torch.cat([x, nan]) for x in (kp, vp)]
    plain = [kp.clone(), vp.clone()]
    tk = tables.clone()
    for row, n in enumerate(vlens):
        live = -(-n // bs)
        tk[row, live:] = kp.shape[0]
        for pos in range(n, live * bs):
            blk = int(tables[row, pos // bs])
            for x in kern:
                x[blk, :, pos % bs] = float("nan")
            for x in plain:
                x[blk, :, pos % bs] = 0.0
    return kern, plain, tk


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_decode_split_edges(cuda, dtype, atol):
    """The split decode in its four forms (paged and contiguous, fp and
    int8 K/V) at valid lengths 0, 1, every split edge ± 1 and the full
    M·BS / S of the plan the wrapper makes on this card, every dead table
    entry and every position at or past vlen poisoned (NaN; int8 ±127 with
    NaN scales): finite, within ``atol`` of the plain version, exactly 0
    where vlen is 0, and a second call bit-equal to the first."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda)
    m, bs, s = 10, 16, 150
    results = {}

    def check(name, call, want):
        got, again = call(), call()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), name
        assert torch.equal(got, again), name             # bit-identical
        assert (got.float() - want.float()).abs().max().item() <= atol, name
        results[name] = got

    plan, vlens = _split_rows(cuda, m * bs, bs, dtype, 70)
    q, kp, vp, tables, vlen = _paged(71, vlens=vlens, tq=1)
    kern, plain, tk = _poison_paged(kp, vp, tables[:, :m], vlens, bs)
    q, vlen = q.to(dtype=dtype, **dev), vlen.to(cuda)
    kern = [x.to(dtype=dtype, **dev) for x in kern]
    plain = [x.to(dtype=dtype, **dev) for x in plain]
    check("paged", lambda: fd.flash_decode_paged(q, *kern, tk.to(cuda), vlen),
          fd.flash_decode_paged_plain(q, *plain, tables[:, :m].to(cuda),
                                      vlen))
    assert results["paged"][vlens.index(0)].abs().max().item() == 0.0

    plan, vlens = _split_rows(cuda, m * bs, bs, torch.int8, 72)
    q, k8, p8, tk8, tp8, vlen = _int8_paged(73, vlens=vlens, tq=1)
    q, vlen = q.to(dtype=dtype, **dev), vlen.to(cuda)
    k8, p8 = [x.to(**dev) for x in k8], [x.to(**dev) for x in p8]
    tk8, tp8 = (t[:, :m].contiguous().to(cuda) for t in (tk8, tp8))
    check("paged int8",
          lambda: fd.flash_decode_paged(q, k8[0], k8[1], tk8, vlen,
                                        k_scale_pool=k8[2],
                                        v_scale_pool=k8[3]),
          fd.flash_decode_paged_plain(q, p8[0], p8[1], tp8, vlen,
                                      k_scale_pool=p8[2], v_scale_pool=p8[3]))

    plan, vlens = _split_rows(cuda, s, fd.CONTIGUOUS_TILE, dtype, 74)
    q, kv_nan, kv0, vlen = _contiguous(75, b=len(vlens), s=s, tq=1,
                                       vlens=vlens)
    q, vlen = q.to(dtype=dtype, **dev), vlen.to(cuda)
    kv_nan = [x.to(dtype=dtype, **dev) for x in kv_nan]
    kv0 = [x.to(dtype=dtype, **dev) for x in kv0]
    check("contiguous", lambda: fd.flash_decode(q, *kv_nan, vlen),
          fd.flash_decode_plain(q, *kv0, vlen))
    assert results["contiguous"][vlens.index(0)].abs().max().item() == 0.0

    plan, vlens = _split_rows(cuda, s, fd.CONTIGUOUS_TILE, torch.int8, 76)
    gen = torch.Generator().manual_seed(77)
    b = len(vlens)
    k8, ks = layers._quantize_kv(torch.randn(b, s, 5, 64, generator=gen))
    v8, vs = layers._quantize_kv(torch.randn(b, s, 5, 64, generator=gen))
    dead = torch.arange(s)[None, :] >= torch.tensor(vlens)[:, None]
    kk, vv = k8.clone(), v8.clone()
    kk[dead], vv[dead] = 127, -127
    kern = [x.to(cuda) for x in (kk, vv, ks.masked_fill(dead[..., None],
                                                        float("nan")),
                                 vs.masked_fill(dead[..., None],
                                                float("nan")))]
    plain = [x.to(cuda) for x in (k8, v8, ks.masked_fill(dead[..., None], 0),
                                  vs.masked_fill(dead[..., None], 0))]
    q = torch.randn(b, 1, 15, 64, generator=gen).to(dtype=dtype, **dev)
    vlen = torch.tensor(vlens, dtype=torch.int32, device=cuda)
    check("contiguous int8",
          lambda: fd.flash_decode(q, kern[0], kern[1], vlen,
                                  k_scale=kern[2], v_scale=kern[3]),
          fd.flash_decode_plain(q, plain[0], plain[1], vlen,
                                k_scale=plain[2], v_scale=plain[3]))
    assert results["contiguous int8"][0].abs().max().item() == 0.0
    counts = dispatch.launch_counts()
    assert {k: counts[k] for k in ("flash_decode_paged", "flash_decode",
                                   *NO_INT8)} == {
        "flash_decode_paged": 2, "flash_decode": 2,
        "flash_decode_paged_int8": 2, "flash_decode_int8": 2,
        "flash_attention_paged_int8": 0}


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_paged_prefill_at_tile_edges(cuda, dtype, atol):
    """The paged cached prefill in its dtype's form (bf16: the tensor-core
    form through the block table; fp32: the CUDA-core form) at Tq 65 and
    130, q_offsets off the 64-key tile, a vlen ending mid-page inside the
    second key tile and a keyless row, pages of 8, 16 and 32 positions,
    shuffled tables, every dead entry and every position past vlen NaN:
    finite, within ``atol`` of the plain version, a repeat bit-equal, one
    counted launch a call."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    cases = [([37, 100], [102, 165], 65), ([3, 150], [133, 280], 130),
             ([64, 0], [100, 0], 36)]
    calls = 0
    for bs in (8, 16, 32):
        for i, (qoff, vlens, tq) in enumerate(cases):
            q, kp, vp, tables, vlen = _paged(80 + i, vlens=vlens, tq=tq,
                                             bs=bs)
            kern, plain, tk = _poison_paged(kp, vp, tables, vlens, bs)
            q = q.to(**dev)
            qo = torch.tensor(qoff, dtype=torch.int32, device=cuda)
            args = (qo, vlen.to(cuda))
            out, lse = fa.flash_attention_paged(
                q, *(x.to(**dev) for x in kern), *args, tk.to(cuda))
            again = fa.flash_attention_paged(
                q, *(x.to(**dev) for x in kern), *args, tk.to(cuda))
            w_out, w_lse = fa.flash_attention_paged_plain(
                q, *(x.to(**dev) for x in plain), *args, tables.to(cuda))
            torch.cuda.synchronize()
            calls += 2
            assert torch.isfinite(out).all(), (bs, qoff, vlens, tq)
            assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
            assert (out.float() - w_out.float()).abs().max().item() <= atol
            assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
            fin = torch.isfinite(w_lse)
            assert (lse[fin] - w_lse[fin]).abs().max().item() <= \
                max(atol, 1e-4)
            if 0 in vlens:
                assert torch.isneginf(lse[vlens.index(0)]).all()
    assert dispatch.launch_counts()["flash_attention_paged"] == calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_topk_one_launch_across_slices(cuda, dtype):
    """The fused softmax+top-k at the decode batch's [8, 49152], which the
    plan splits over 33 slices: exact ties planted across slice edges, a
    slice all -inf, a padded vocabulary, at k 1, 5 and 32; indices equal to
    the plain version's (the ties in index order), lse within rtol 1e-5 and
    values within rtol 1e-5 (bf16: one bf16 ulp), a repeat bit-equal, one
    counted launch a call and the ticket counters left zero."""
    from repro_torch.kernels import softmax_topk as topk
    dispatch.reset_launch_counts()
    gen = torch.Generator().manual_seed(90)
    calls = 0
    for k in (1, 5, 32):
        p = topk.plan(8, 49152, k, dtype, build.sm_count(cuda))
        assert 8 * p.slices >= 2 * build.sm_count(cuda)
        e = p.slice
        x = torch.randn(8, 49152, generator=gen) * 4.0
        ties = [5, e - 1, e, 2 * e - 1, 2 * e]
        x[1, ties] = float(x[1].max()) + 1.0
        x[2, 40000:] = float("-inf")
        x[4, e:2 * e] = float("-inf")
        x[5, :e] = float("-inf")
        x = x.to(device=cuda, dtype=dtype)
        got, again = topk.softmax_topk(x, k), topk.softmax_topk(x, k)
        want = topk.softmax_topk_plain(x, k)
        torch.cuda.synchronize()
        calls += 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert torch.equal(got.indices.long(), want.indices)
        assert got.indices[1].tolist()[:min(k, 5)] == ties[:min(k, 5)]
        vrtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(got.values.float(), want.values.float(),
                                   rtol=vrtol, atol=0)
        torch.testing.assert_close(got.logsumexp, want.logsumexp, rtol=1e-5,
                                   atol=0)
        assert not build.tickets(x.device, 8)[:8].any()
    assert dispatch.launch_counts()["softmax_topk"] == calls


@pytest.mark.parametrize("prefetch", [False, True], ids=["host", "prefetched"])
@pytest.mark.parametrize("kv", ["", "int8"], ids=["bf16", "int8"])
def test_swap_round_trip_on_card(cuda, kv, prefetch):
    """A full-width pool's swap-out → (prefetch) → swap-in restores every
    leaf bit for bit (the int8 scale pages too), though the freed blocks
    are poisoned and rewritten by their next owner at once, a device sleep
    keeps the current stream busy, and nothing synchronizes the host
    between the swap-out, the prefetch and the swap-in."""
    from repro_torch.serving import paged
    cfg = configs.get("smollm_360m")
    if kv:
        cfg = cfg.replace(kv_cache_dtype=kv)
    pool = paged.PagedPool(cfg, num_slots=2, slot_len=64, block_size=16,
                           num_blocks=3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)

    def fill(bids, poison=False):
        for x in pool.caches.values():
            part = x[:, bids]
            if poison:
                part.fill_(127 if x.dtype == torch.int8 else float("nan"))
            elif x.dtype == torch.int8:
                part.copy_(torch.randint(-127, 128, part.shape, device=cuda,
                                         generator=gen))
            else:
                part.copy_(torch.randn(part.shape, device=cuda,
                                       generator=gen))
            x[:, bids] = part

    seq = pool.admit(np.arange(40))
    fill(seq.blocks)
    pool.lens[seq.slot] = 40
    want = {n: x[:, seq.blocks].clone() for n, x in pool.caches.items()}
    free_before = set(pool.alloc._free)
    pool.swap_out(seq.slot, rid=7)
    freed = sorted(set(pool.alloc._free) - free_before)
    assert len(freed) == 3
    fill(freed, poison=True)
    other = pool.admit(np.arange(100, 140))
    assert sorted(other.blocks) == freed
    fill(other.blocks)                      # the next owner's writes
    torch.cuda._sleep(50_000_000)           # the current stream stays busy
    if prefetch:
        assert pool.prefetch_swap_in(7) == 3
    pool.release(other.slot)
    s2 = pool.swap_in(7)
    got = {n: x[:, s2.blocks].clone() for n, x in pool.caches.items()}
    torch.cuda.synchronize()
    for n in want:
        assert torch.equal(got[n].view(torch.int8), want[n].view(torch.int8)), n
    st = pool.stats()
    assert st["swapped_blocks_out"] == st["swapped_blocks_in"] == 3
    assert st["swapped_bytes_out"] == 3 * pool.block_bytes == 3 * (
        337920 if kv else 655360)
    assert st["swap_prefetched_blocks"] == (3 if prefetch else 0)


# ---- head_dim 128: the serving kernels' second instance ---------------------
# mistral-nemo-12b (32/8 heads, G 4) and deepseek-coder-33b (56/8, G 7)
HEAD_DIM_128 = [(4, 8), (7, 8)]           # (G, Hkv)


@pytest.mark.parametrize("g,hkv", HEAD_DIM_128)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_head_dim_128_decode_matches_plain(cuda, g, hkv, dtype, atol):
    """The four one-token decode forms at D 128 against their plain
    versions: paged (BS 16) and contiguous, fp and int8 K/V (int8 with NaN
    scales in every dead entry and tail), ragged valid lengths 0, 1, 65,
    64 + 1 (a split edge at D 128's bf16 split), 200 and 328; a repeat is
    bit-equal."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    vlens = [0, 1, 65, 129, 200, 328]
    q, kp, vp, tables, vlen = _paged(20, vlens=vlens, tq=1, hkv=hkv, g=g,
                                     d=128)
    kern, plain, tk = _poison_paged(kp, vp, tables, vlens, 16)
    q, vlen = q.to(**dev), vlen.to(cuda)
    args = (q, *(x.to(**dev) for x in kern), tk.to(cuda), vlen)
    got = fd.flash_decode_paged(*args)
    again = fd.flash_decode_paged(*args)
    want = fd.flash_decode_paged_plain(q, *(x.to(**dev) for x in plain),
                                       tables.to(cuda), vlen)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= atol

    q, kern, plain, tk, tp, vl = _int8_paged(21, vlens=vlens, tq=1, hkv=hkv,
                                             g=g, d=128)
    q = q.to(**dev)
    kern = [x.to(cuda) for x in kern]
    plain = [x.to(cuda) for x in plain]
    got = fd.flash_decode_paged(q, kern[0], kern[1], tk.to(cuda),
                                vl.to(cuda), k_scale_pool=kern[2],
                                v_scale_pool=kern[3])
    want = fd.flash_decode_paged_plain(q, plain[0], plain[1], tp.to(cuda),
                                       vl.to(cuda), k_scale_pool=plain[2],
                                       v_scale_pool=plain[3])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= atol

    q, kv_nan, kv0, vl = _contiguous(22, b=len(vlens), s=328, tq=1,
                                     vlens=vlens, hkv=hkv, g=g, d=128)
    got = fd.flash_decode(q.to(**dev), *(t.to(**dev) for t in kv_nan),
                          vl.to(cuda))
    want = fd.flash_decode_plain(q.to(**dev), *(t.to(**dev) for t in kv0),
                                 vl.to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= atol
    assert torch.equal(got[0], torch.zeros_like(got[0]))     # vlen 0 → 0

    gen = torch.Generator().manual_seed(23)
    b, s = len(vlens), 328
    k8, ks = layers._quantize_kv(torch.randn(b, s, hkv, 128, generator=gen))
    v8, vs = layers._quantize_kv(torch.randn(b, s, hkv, 128, generator=gen))
    dead = torch.arange(s)[None, :] >= torch.tensor(vlens)[:, None]
    kk, vv = k8.clone(), v8.clone()
    kk[dead], vv[dead] = 127, -127
    kern = [t.to(cuda) for t in (kk, vv, ks.masked_fill(
        dead[..., None], float("nan")), vs.masked_fill(dead[..., None],
                                                       float("nan")))]
    plain = [t.to(cuda) for t in (k8, v8, ks.masked_fill(dead[..., None], 0.0),
                                  vs.masked_fill(dead[..., None], 0.0))]
    q = torch.randn(b, 1, hkv * g, 128, generator=gen).to(**dev)
    got = fd.flash_decode(q, kern[0], kern[1], vl.to(cuda), k_scale=kern[2],
                          v_scale=kern[3])
    want = fd.flash_decode_plain(q, plain[0], plain[1], vl.to(cuda),
                                 k_scale=plain[2], v_scale=plain[3])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= atol
    counts = dispatch.launch_counts()
    assert {k: counts[k] for k in ("flash_decode_paged", "flash_decode",
                                   *NO_INT8)} == {
        "flash_decode_paged": 2, "flash_decode": 1,
        "flash_decode_paged_int8": 1, "flash_decode_int8": 1,
        "flash_attention_paged_int8": 0}


@pytest.mark.parametrize("g,hkv", HEAD_DIM_128)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_head_dim_128_prefill_matches_plain(cuda, g, hkv, dtype, atol):
    """The cached prefills at D 128 against their plain versions (bf16 on
    the tensor cores through two atom columns a row, fp32 on the CUDA
    cores): paged (BS 16) and contiguous, the serving chunk of 64 at offset
    64, Tq 65 and 130 at offsets off the 64-key tile, a keyless row; the
    int8 paged form (kernel check only)."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    for tq, qoff, vlens in ((64, [64], [128]), (65, [37, 100], [102, 165]),
                            (130, [3, 150], [133, 280]), (37, [0, 5], [0, 42])):
        q, kp, vp, tables, vlen = _paged(30 + tq, vlens=vlens, tq=tq,
                                         hkv=hkv, g=g, d=128)
        qo = torch.tensor(qoff, dtype=torch.int32)
        args = (q.to(**dev), kp.to(**dev), vp.to(**dev), qo.to(cuda),
                vlen.to(cuda), tables.to(cuda))
        out, lse = fa.flash_attention_paged(*args)
        w_out, w_lse = fa.flash_attention_paged_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out.float() - w_out.float()).abs().max().item() <= atol
        assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
        fin = torch.isfinite(w_lse)
        assert (lse[fin] - w_lse[fin]).abs().max().item() <= max(atol, 1e-4)

        q, kv_nan, kv0, vl = _contiguous(40 + tq, b=len(vlens), s=300, tq=tq,
                                         vlens=vlens, hkv=hkv, g=g, d=128)
        qo = qo.to(cuda)
        out, lse = fa.flash_attention_offset(
            q.to(**dev), *(t.to(**dev) for t in kv_nan), qo, vl.to(cuda))
        w_out, w_lse = fa.flash_attention_offset_plain(
            q.to(**dev), *(t.to(**dev) for t in kv0), qo, vl.to(cuda))
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert (out.float() - w_out.float()).abs().max().item() <= atol
        assert torch.equal(torch.isneginf(lse), torch.isneginf(w_lse))
        fin = torch.isfinite(w_lse)
        assert (lse[fin] - w_lse[fin]).abs().max().item() <= max(atol, 1e-4)

    q, kern, plain, tk, tp, vlen = _int8_paged(50, vlens=[128, 23, 0], tq=64,
                                               hkv=hkv, g=g, d=128)
    qoff = (vlen - 64).clamp(min=0).to(cuda)
    q = q.to(**dev)
    out, lse = fa.flash_attention_paged(
        q, *(x.to(cuda) for x in kern[:2]), qoff, vlen.to(cuda), tk.to(cuda),
        k_scale_pool=kern[2].to(cuda), v_scale_pool=kern[3].to(cuda))
    w_out, w_lse = fa.flash_attention_paged_plain(
        q, *(x.to(cuda) for x in plain[:2]), qoff, vlen.to(cuda), tp.to(cuda),
        k_scale_pool=plain[2].to(cuda), v_scale_pool=plain[3].to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out.float() - w_out.float()).abs().max().item() <= atol
    counts = dispatch.launch_counts()
    assert (counts["flash_attention_paged"], counts["flash_attention_offset"],
            counts["flash_attention_paged_int8"]) == (4, 4, 1)


@pytest.mark.parametrize("g,hkv", [(4, 8), (1, 16)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_head_dim_128_fresh_kernels_match_plain(cuda, g, hkv, dtype, atol):
    """The training kernels' D-128 instances (bf16: two 128-byte atom
    columns a row on the tensor cores; fp32: the CUDA-core forms) at
    mistral-nemo-12b's group (G 4) and qwen2-moe-a2.7b's (G 1), as
    ``_check_fresh_kernels``; a head dim without an instance (96) raises
    in the forward and the backward, with no fallback."""
    q, k, v = _check_fresh_kernels(cuda, dtype, atol, hkv=hkv, g=g, d=128)
    q, k = q[..., :96].contiguous(), k[..., :96].contiguous()
    with pytest.raises(ValueError, match="D=96"):
        fa.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="D=96"):
        fab.flash_attention_bwd(q, k, k, q, torch.zeros(
            q.shape[0], q.shape[2], q.shape[1], device=cuda), q)


@pytest.mark.parametrize("arch,changes", [
    ("mistral_nemo_12b", dict(d_model=256, num_heads=4, num_kv_heads=2,
                              head_dim=128)),
    ("qwen2_moe_a2p7b", dict(d_model=256, num_heads=16, num_kv_heads=16,
                             head_dim=128))], ids=["mistral", "qwen2_moe"])
def test_head_dim_128_train_steps(cuda, arch, changes):
    """Two bf16 train steps of a narrow head_dim-128 model (the smoke
    config at 4/2 or 16/16 heads of 128) through the training kernels'
    D-128 instances, under remat "full" and "block": finite losses, 2
    forward, 1 dq and 1 dk/dv launch per layer and step (and 2 router
    launches for the MoE model) under both, and the same parameters bit
    for bit."""
    from repro_torch import tree
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.training.train_step import init_state, make_train_step
    base = configs.get_smoke(arch).replace(dtype="bfloat16", **changes)
    ds = SyntheticDataset(SyntheticConfig(base.vocab_size, 128, 2))
    out = {}
    for remat in ("full", "block"):
        run = RunConfig(model=base.replace(remat=remat))
        params, opt = init_state(run, device=cuda)
        step = make_train_step(run)
        dispatch.reset_launch_counts()
        for i in range(2):
            batch = {k: torch.as_tensor(x, device=cuda)
                     for k, x in ds.batch(i).items()}
            params, opt, m = step(params, opt, batch)
            assert np.isfinite(float(m["loss"]))
        torch.cuda.synchronize()
        n, counts = 2 * base.num_layers, dispatch.launch_counts()
        assert counts["flash_attention"] == 2 * n
        assert counts["flash_attention_bwd_dq"] == n
        assert counts["flash_attention_bwd_dkv"] == n
        assert counts["softmax_topk_router"] == (2 * n if base.moe else 0)
        out[remat] = tree.leaves(params)
    assert all(torch.equal(a, b) for a, b in zip(out["full"], out["block"]))


@pytest.mark.parametrize("v", [131072, 32256])
def test_softmax_topk_at_head_dim_128_vocabularies(cuda, v):
    """The sampler at mistral-nemo-12b's and deepseek-coder-33b's
    vocabularies (32256 is no multiple of 1024), fp32 logits of 8 rows:
    indices equal to the plain version's, values and lse within rtol
    1e-5."""
    gen = torch.Generator().manual_seed(60)
    x = (torch.randn(8, v, generator=gen) * 4.0).to(cuda)
    x[1, [3, v - 1]] = x[1].max() + 1.0                  # ties across slices
    got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    torch.cuda.synchronize()
    assert torch.equal(got.indices.long(), want.indices)
    assert got.indices[1, :2].tolist() == [3, v - 1]
    torch.testing.assert_close(got.values, want.values, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.logsumexp, want.logsumexp, rtol=1e-5,
                               atol=0)


# ---- the MoE decoders: the router's shapes, query groups 1 and 5 ----------
# qwen2-moe-a2.7b (16/16 heads, G 1) and llama4-scout-17b-a16e (40/8, G 5)
MOE_GROUPS = [(1, 16), (5, 8)]            # (G, Hkv)


@pytest.mark.parametrize("g,hkv", MOE_GROUPS)
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_moe_groups_match_plain(cuda, g, hkv, dtype, atol):
    """The D-128 decode and prefill checks above at the MoE decoders'
    query groups."""
    test_head_dim_128_decode_matches_plain(cuda, g, hkv, dtype, atol)
    test_head_dim_128_prefill_matches_plain(cuda, g, hkv, dtype, atol)


@pytest.mark.parametrize("r,e,k", [(8, 60, 4), (64, 60, 4), (256, 16, 1),
                                   (64, 6, 2), (64, 61, 4)])
def test_softmax_topk_as_the_moe_router(cuda, r, e, k):
    """The fused softmax+top-k through ``dispatch.softmax_topk`` on [G, S,
    E] router logits (E 6 and 61: rows off a 16-byte boundary): indices
    equal to the plain version's in order, a tie in index order, values
    and lse within rtol 1e-5."""
    gen = torch.Generator().manual_seed(61)
    x = torch.randn(r, e, generator=gen) * 2.0
    x[0, [e // 3, e - 1]] = x[0].max() + 1.0
    x = x.reshape(1, r, e).to(cuda)
    got, want = dispatch.softmax_topk(x, k), st.softmax_topk_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got.indices.long(), want.indices)
    assert got.indices[0, 0, :2].tolist() == [e // 3, e - 1][:k]
    torch.testing.assert_close(got.values, want.values, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.logsumexp, want.logsumexp, rtol=1e-5,
                               atol=0)


def test_moe_streams_equal_on_card_and_cpu(cuda):
    """A small MoE model (qwen2-moe's smoke experts, 16/16 heads of 128)
    served paged on the card and on the CPU: identical streams and pool
    accounting, the sampler's launches, and the router's (counted apart)
    one a layer for every forward."""
    cfg = configs.get_smoke("qwen2_moe_a2p7b").replace(
        d_model=256, num_heads=16, num_kv_heads=16, head_dim=128)
    params_cpu = transformer.init(cfg, seed=4, device="cpu")
    argv = ["--arch", "qwen2_moe_a2p7b", "--smoke", "--continuous",
            "--paged", "--requests", "5", "--tokens", "8", "--prompt-len",
            "20", "--slots", "2", "--prefill-chunk", "8", "--block-size",
            "8", "--shared-prefix", "8"]
    runs = {}
    for device, params in (("cuda", transformer.params_to(params_cpu, cuda)),
                           ("cpu", params_cpu)):
        args = serve.parse_args(argv + ["--device", device])
        dispatch.reset_launch_counts()
        report, router, _, _ = serve.run(args, cfg, params)
        runs[device] = (report, router.engines[0].scheduler,
                        dispatch.launch_counts())
    (rep_g, sched, counts), (rep_c, _, _) = runs["cuda"], runs["cpu"]
    assert {r.rid: r.tokens for r in rep_g.results} == \
        {r.rid: r.tokens for r in rep_c.results}
    assert rep_g.paged == rep_c.paged
    assert counts["softmax_topk"] == sched.decode_steps + sched.prefills_done
    assert counts["softmax_topk_router"] == cfg.num_layers * (
        sched.decode_steps + sched.prefill_chunks)


# ---------------------------------------------------------------------------
# MLA: the latent attention kernels (minicpm3-4b's R 256 / Dr 32).
# ---------------------------------------------------------------------------
MLA_SCALE = 96 ** -0.5


def _mla(seed, *, b, tq, h, s, vlens, dtype):
    """q_eff, q_rope and latent caches (layer 1 of a [2, B, S, ...] tensor)
    with every row at or past its vlen NaN, on the card."""
    from repro_torch.kernels import flash_mla as fm
    r, dr = fm.LATENT_DIMS
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, h, r, generator=gen)
    qr = torch.randn(b, tq, h, dr, generator=gen)
    c = torch.randn(2, b, s, r, generator=gen)
    rr = torch.randn(2, b, s, dr, generator=gen)
    for row, n in enumerate(vlens):
        c[1, row, n:] = float("nan")
        rr[1, row, n:] = float("nan")
    dev = dict(device="cuda", dtype=dtype)
    return (q.to(**dev), qr.to(**dev), c.to(**dev)[1], rr.to(**dev)[1],
            torch.tensor(vlens, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("h", [40, 7])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_mla_decode_matches_plain(cuda, h, dtype, atol):
    """The MLA decode at 40 heads (and 7, a partial last warp and a Q tile
    of 7 rows) over rows of vlen 0, 1, the 32- and 64-key tile edges ± 1
    (the split edges of both forms' plans) and the full cache, NaN past
    vlen: finite, vlen 0 exactly 0, a repeat bit-equal, within ``atol`` of
    the plain version; one launch counted a call."""
    from repro_torch.kernels import flash_mla as fm
    s = 200
    vlens = [0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 191, 192, 193,
             200]
    q, qr, c, rr, vl = _mla(0, b=len(vlens), tq=1, h=h, s=s, vlens=vlens,
                            dtype=dtype)
    dispatch.reset_launch_counts()
    got = fm.flash_decode_mla(q, qr, c, rr, vl, scale=MLA_SCALE)
    again = fm.flash_decode_mla(q, qr, c, rr, vl, scale=MLA_SCALE)
    want = fm.flash_decode_mla_plain(q, qr, c, rr, vl, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["flash_decode_mla"] == 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert got[0].abs().max().item() == 0.0
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_mla_prefill_matches_plain(cuda, dtype, atol):
    """The MLA cached prefill at Tq 65 (T·H 2600: a last 64-row tile of
    40 rows) over offsets off the 32- and 64-row tiles and vlens ending
    mid-tile, NaN past vlen, causal in absolute coordinates, and a
    non-causal call: within ``atol`` of the plain version, a repeat
    bit-equal."""
    from repro_torch.kernels import flash_mla as fm
    offs = [0, 7, 40, 70]
    vlens = [o + 65 for o in offs]
    q, qr, c, rr, vl = _mla(1, b=4, tq=65, h=40, s=160, vlens=vlens,
                            dtype=dtype)
    qo = torch.tensor(offs, dtype=torch.int32, device="cuda")
    for causal in (True, False):
        got = fm.flash_attention_mla(q, qr, c, rr, qo, vl, scale=MLA_SCALE,
                                     causal=causal)
        again = fm.flash_attention_mla(q, qr, c, rr, qo, vl,
                                       scale=MLA_SCALE, causal=causal)
        want = fm.flash_attention_mla_plain(q, qr, c, rr, qo, vl,
                                            scale=MLA_SCALE, causal=causal)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_mla_lockstep_shapes_match_plain(cuda, dtype, atol):
    """Both MLA kernels at the lockstep loop's shapes, minicpm3-4b's 40
    heads: the prefill of B 4 x Tq 256 at offset 0 into caches of 288
    (vlen 256), then the first decode step over vlen 257, NaN past vlen:
    within ``atol`` of the plain versions, a repeat bit-equal, one launch
    of each counted a call."""
    from repro_torch.kernels import flash_mla as fm
    q, qr, c, rr, vl = _mla(3, b=4, tq=256, h=40, s=288, vlens=[257] * 4,
                            dtype=dtype)
    qo = torch.zeros(4, dtype=torch.int32, device="cuda")
    dispatch.reset_launch_counts()
    for got, again, want in (
            (fm.flash_attention_mla(q, qr, c, rr, qo, vl - 1,
                                    scale=MLA_SCALE),
             fm.flash_attention_mla(q, qr, c, rr, qo, vl - 1,
                                    scale=MLA_SCALE),
             fm.flash_attention_mla_plain(q, qr, c, rr, qo, vl - 1,
                                          scale=MLA_SCALE)),
            (fm.flash_decode_mla(q[:, :1], qr[:, :1], c, rr, vl,
                                 scale=MLA_SCALE),
             fm.flash_decode_mla(q[:, :1], qr[:, :1], c, rr, vl,
                                 scale=MLA_SCALE),
             fm.flash_decode_mla_plain(q[:, :1], qr[:, :1], c, rr, vl,
                                       scale=MLA_SCALE))):
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        assert (got.float() - want.float()).abs().max().item() <= atol
    counts = dispatch.launch_counts()
    assert counts["flash_attention_mla"] == counts["flash_decode_mla"] == 2


def test_mla_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import flash_mla as fm
    q, qr, c, rr, vl = _mla(2, b=2, tq=1, h=41, s=64, vlens=[3, 9],
                            dtype=torch.float32)
    with pytest.raises(ValueError, match="H=41"):
        fm.flash_decode_mla(q, qr, c, rr, vl, scale=MLA_SCALE)
    with pytest.raises(ValueError, match="R=256"):
        fm.flash_decode_mla(q[..., :128].contiguous(), qr, c[..., :128], rr,
                            vl, scale=MLA_SCALE)
    with pytest.raises(ValueError, match="dtypes"):
        fm.flash_attention_mla(q[:, :, :40].half(), qr[:, :, :40].half(),
                               c.half(), rr.half(), 0, vl, scale=MLA_SCALE)
    # the bf16 (tensor-core) form copies 16-byte chunks of q: a q_eff two
    # bytes off a 16-byte boundary raises, as does a scale <= 0
    qb, qrb = q[:, :, :40].bfloat16(), qr[:, :, :40].bfloat16()
    cb, rb = c.bfloat16(), rr.bfloat16()
    flat = torch.empty(qb.numel() + 1, dtype=torch.bfloat16, device="cuda")
    off = flat[1:].view(qb.shape).copy_(qb)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fm.flash_decode_mla(off, qrb, cb, rb, vl, scale=MLA_SCALE)
    with pytest.raises(ValueError, match="scale positive"):
        fm.flash_attention_mla(qb, qrb, cb, rb, 0, vl, scale=-MLA_SCALE)


def test_mla_streams_equal_on_card_and_cpu(cuda):
    """A small MLA model (minicpm3's latent widths R 256 / Dr 32, 8 heads,
    2 layers) served through the slot pool on the card and on the CPU:
    identical streams, one latent attention launch a layer and forward;
    training this model on the card raises ``NotImplementedError``: its
    decompressed attention is (Dqk 64, Dv 32), a pair with no instance
    (the kernels have (96, 64), minicpm3-4b's)."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    base = configs.get_smoke("minicpm3_4b")
    cfg = base.replace(d_model=128, num_heads=8, num_kv_heads=8, mla=(
        configs.MLAConfig(q_lora_rank=64, kv_lora_rank=256,
                          qk_nope_head_dim=32, qk_rope_head_dim=32,
                          v_head_dim=32)))
    params_cpu = transformer.init(cfg, seed=4, device="cpu")
    argv = ["--arch", "minicpm3_4b", "--smoke", "--continuous", "--requests",
            "5", "--tokens", "8", "--prompt-len", "20", "--slots", "2",
            "--prefill-chunk", "8"]
    runs = {}
    for device, params in (("cuda", transformer.params_to(params_cpu, cuda)),
                           ("cpu", params_cpu)):
        args = serve.parse_args(argv + ["--device", device])
        dispatch.reset_launch_counts()
        report, router, _, _ = serve.run(args, cfg, params)
        runs[device] = (report, router.engines[0].scheduler,
                        dispatch.launch_counts())
    (rep_g, sched, counts), (rep_c, _, _) = runs["cuda"], runs["cpu"]
    assert {r.rid: r.tokens for r in rep_g.results} == \
        {r.rid: r.tokens for r in rep_c.results}
    ones = sched.chunk_widths.get(1, 0)
    assert counts["flash_decode_mla"] == cfg.num_layers * (
        sched.decode_steps + ones)
    assert counts["flash_attention_mla"] == cfg.num_layers * (
        sched.prefill_chunks - ones)
    batch = SyntheticDataset(SyntheticConfig(cfg.vocab_size, 16, 2)).batch(0)
    batch = {k: torch.as_tensor(x, device=cuda) for k, x in batch.items()}
    with pytest.raises(NotImplementedError, match=r"\(64, 32\) has no kernel"):
        transformer.loss_fn(transformer.params_to(params_cpu, cuda), batch,
                            cfg)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_mla_train_kernels_match_plain(cuda, dtype, atol):
    """The training kernels' (96, 64) instances, MLA's decompressed form
    (bf16: the tensor-core forms, S over six k-steps, dQ and dK 96 wide;
    fp32: the CUDA-core forms), at minicpm3-4b's G 1, k and v read through
    strides of their own, as ``_check_fresh_kernels``; a pair without an
    instance (64, 32) raises in the forward and the backward."""
    q, k, v = _check_fresh_kernels(cuda, dtype, atol, hkv=8, g=1, d=96,
                                   dv=64)
    q, k, v = q[..., :64], k[..., :64], v[..., :32]
    with pytest.raises(ValueError, match="D=64, Dv=32"):
        fa.flash_attention_fwd(q, k, v)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], device=cuda)
    with pytest.raises(ValueError, match="D=64, Dv=32"):
        fab.flash_attention_bwd(q, k, v, v, lse, v)


def test_mla_train_attention_through_dispatch(cuda):
    """``dispatch.sdpa``'s fresh route on MLA's training layout (q and k a
    concatenation of 64 nope and 32 rope values, v a 64-wide view of a
    product, 8 heads, bf16) launches the forward once and each backward
    kernel once, and matches the CPU's chunked online form within bf16
    rounding (output and the gradients of q, k and v); the cached-prefill
    route at the same pair, and a pair without an instance, raise
    ``NotImplementedError``."""
    cfg = configs.get("minicpm3_4b")
    gen = torch.Generator().manual_seed(11)
    b, t, h = 2, 70, 8
    # bf16 values, so both devices start from the same inputs
    parts = [torch.randn(b, t, h, n, generator=gen).bfloat16().float()
             for n in (64, 32, 64, 32)]
    kv = torch.randn(b, t, h * 64 + 8, generator=gen).bfloat16().float()
    dout = torch.randn(b, t, h, 64, generator=gen).bfloat16().float()
    got = {}
    for dev in ("cuda", "cpu"):
        dt = torch.bfloat16 if dev == "cuda" else torch.float32
        leaves = [x.to(dev, dt).requires_grad_(True)
                  for x in (*parts, kv)]
        q = torch.cat(leaves[:2], dim=-1)
        k = torch.cat(leaves[2:4], dim=-1)
        v = leaves[4][..., :h * 64].reshape(b, t, h, 64)
        dispatch.reset_launch_counts()
        out = dispatch.sdpa(cfg, q, k, v, causal=True, q_offset=0,
                            kv_valid_len=None, scale=96 ** -0.5)
        out.backward(dout.to(dev, dt))
        got[dev] = [out.detach()] + [x.grad for x in leaves]
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = dispatch.launch_counts()
            assert (counts["flash_attention"], counts["flash_attention_bwd_dq"],
                    counts["flash_attention_bwd_dkv"]) == (1, 1, 1)
            with pytest.raises(NotImplementedError, match="has no kernel"):
                dispatch.sdpa(cfg, q, k, v, causal=True, q_offset=0,
                              kv_valid_len=torch.full((b,), t, device=cuda),
                              scale=96 ** -0.5)
            with pytest.raises(NotImplementedError, match="has no kernel"):
                dispatch.sdpa(cfg, q[..., :64], k[..., :64], v[..., :32],
                              causal=True, q_offset=0, kv_valid_len=None,
                              scale=None)
    for a, b_ in zip(got["cuda"], got["cpu"]):
        scale = max(1.0, b_.abs().max().item())
        assert (a.float().cpu() - b_).abs().max().item() <= 2e-2 * scale


def test_mla_train_steps(cuda):
    """Two bf16 train steps of a narrow MLA model at minicpm3-4b's head
    dims (d_model 256, 4 heads, q_lora 64, kv_lora 32, 64 nope + 32 rope,
    v 64, 2 layers) through the (96, 64) instances, under remat "full" and
    "block": finite losses, 2 forward, 1 dq and 1 dk/dv launch per layer
    and step under both, and the same parameters bit for bit."""
    from repro_torch import tree
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.training.train_step import init_state, make_train_step
    base = configs.get_smoke("minicpm3_4b").replace(
        dtype="bfloat16", d_model=256, num_heads=4, num_kv_heads=4,
        mla=configs.MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                              qk_nope_head_dim=64, qk_rope_head_dim=32,
                              v_head_dim=64))
    ds = SyntheticDataset(SyntheticConfig(base.vocab_size, 128, 2))
    out = {}
    for remat in ("full", "block"):
        run = RunConfig(model=base.replace(remat=remat))
        params, opt = init_state(run, device=cuda)
        step = make_train_step(run)
        dispatch.reset_launch_counts()
        for i in range(2):
            batch = {k: torch.as_tensor(x, device=cuda)
                     for k, x in ds.batch(i).items()}
            params, opt, m = step(params, opt, batch)
            assert np.isfinite(float(m["loss"]))
        torch.cuda.synchronize()
        n, counts = 2 * base.num_layers, dispatch.launch_counts()
        assert counts["flash_attention"] == 2 * n
        assert counts["flash_attention_bwd_dq"] == n
        assert counts["flash_attention_bwd_dkv"] == n
        assert counts["flash_attention_mla"] == counts["flash_decode_mla"] == 0
        out[remat] = tree.leaves(params)
    assert all(torch.equal(a, b) for a, b in zip(out["full"], out["block"]))


# ---------------------------------------------------------------------------
# The recurrent decoders: zamba2's shared attention block (rows 4 and 5 at
# D 64, G 1) and xlstm's sampler.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_125m"])
@pytest.mark.parametrize("paged", [False, True], ids=["slot_pool", "paged"])
def test_state_streams_equal_on_card_and_cpu(cuda, arch, paged):
    """A small recurrent model (zamba2's smoke stack with 2/2 heads of 64 in
    its shared block; xlstm's smoke stack) served through the slot pool and
    the paged state pool on the card and on the CPU: identical streams and
    pool accounting; on the card one row-4 launch a shared-block call and
    decode step, one row-5 launch a call and single-shot prefill, and the
    sampler's launches."""
    cfg = configs.get_smoke(arch)
    if arch == "zamba2_1p2b":
        cfg = cfg.replace(d_model=128, num_heads=2, num_kv_heads=2,
                          head_dim=64)
    params_cpu = transformer.init(cfg, seed=4, device="cpu")
    argv = ["--arch", arch, "--smoke", "--continuous", "--requests", "5",
            "--tokens", "8", "--prompt-len", "40", "--slots", "2",
            "--prefill-chunk", "8"] + (["--paged"] if paged else [])
    runs = {}
    for device, params in (("cuda", transformer.params_to(params_cpu, cuda)),
                           ("cpu", params_cpu)):
        args = serve.parse_args(argv + ["--device", device])
        dispatch.reset_launch_counts()
        report, router, _, _ = serve.run(args, cfg, params)
        runs[device] = (report, router.engines[0].scheduler,
                        dispatch.launch_counts())
    (rep_g, sched, counts), (rep_c, _, _) = runs["cuda"], runs["cpu"]
    assert {r.rid: r.tokens for r in rep_g.results} == \
        {r.rid: r.tokens for r in rep_c.results}
    assert rep_g.paged == rep_c.paged
    calls = transformer.layer_counts(cfg).get("attn", 0)
    assert calls == (3 if arch == "zamba2_1p2b" else 0)
    assert counts["flash_decode"] == calls * sched.decode_steps
    assert counts["flash_attention_offset"] == calls * sched.prefill_chunks
    assert counts["flash_decode_paged"] == counts["flash_attention_paged"] \
        == 0
    assert counts["softmax_topk"] == sched.decode_steps + sched.prefills_done


# ---------------------------------------------------------------------------
# Training the recurrent decoders; serving the encoder-decoder.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_125m"])
def test_state_train_steps(cuda, arch):
    """Two bf16 train steps of a small recurrent model (zamba2's smoke
    stack with 2/2 heads of 64 in its shared block, 3 calls; xlstm's smoke
    stack) under remat "full" and "block": finite losses, per step 2
    forward, 1 dq and 1 dk/dv launch a shared-block call (none for
    xlstm), and the same parameters bit for bit."""
    from repro_torch import tree
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.training.train_step import init_state, make_train_step
    base = configs.get_smoke(arch).replace(dtype="bfloat16")
    if arch == "zamba2_1p2b":
        base = base.replace(d_model=128, num_heads=2, num_kv_heads=2,
                            head_dim=64)
    calls = transformer.layer_counts(base).get("attn", 0)
    ds = SyntheticDataset(SyntheticConfig(base.vocab_size, 64, 2))
    out = {}
    for remat in ("full", "block"):
        run = RunConfig(model=base.replace(remat=remat))
        params, opt = init_state(run, device=cuda)
        step = make_train_step(run)
        dispatch.reset_launch_counts()
        for i in range(2):
            batch = {k: torch.as_tensor(x, device=cuda)
                     for k, x in ds.batch(i).items()}
            params, opt, m = step(params, opt, batch)
            assert np.isfinite(float(m["loss"]))
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
        assert counts["flash_attention"] == 2 * 2 * calls
        assert counts["flash_attention_bwd_dq"] == 2 * calls
        assert counts["flash_attention_bwd_dkv"] == 2 * calls
        out[remat] = tree.leaves(params)
    assert calls == (3 if arch == "zamba2_1p2b" else 0)
    assert all(torch.equal(a, b) for a, b in zip(out["full"], out["block"]))


def test_encdec_streams_equal_on_card_and_cpu(cuda):
    """whisper's smoke stack with 2/2 heads of 64 served through the paged
    pool on the card and on the CPU (fp32, 5 requests over 2 audios):
    identical streams and pool accounting, repeats sharing their audio's
    cross blocks; on the card the encoder's row-6 launches one a layer
    and fresh encode, row 4 two a decoder layer (self and cross) for every
    decode step and prefill, and the sampler's."""
    from repro_torch.models import encdec
    cfg = configs.get_smoke("whisper_small").replace(
        d_model=128, num_heads=2, num_kv_heads=2, head_dim=64)
    params_cpu = encdec.init(cfg, seed=4, device="cpu")
    argv = ["--arch", "whisper_small", "--smoke", "--continuous", "--paged",
            "--requests", "5", "--tokens", "8", "--slots", "2", "--audios",
            "2", "--blocks", "60"]
    runs = {}
    for device, params in (("cuda", transformer.params_to(params_cpu, cuda)),
                           ("cpu", params_cpu)):
        args = serve.parse_args(argv + ["--device", device])
        dispatch.reset_launch_counts()
        report, router, _, _ = serve.run(args, cfg, params)
        runs[device] = (report, router.engines[0].scheduler,
                        dispatch.launch_counts())
    (rep_g, sched, counts), (rep_c, _, _) = runs["cuda"], runs["cpu"]
    assert {r.rid: r.tokens for r in rep_g.results} == \
        {r.rid: r.tokens for r in rep_c.results}
    assert rep_g.paged == rep_c.paged and rep_g.paged["blocks_shared"] > 0
    fresh = sched.prefill_chunks - rep_g.paged["tokens_reused"] \
        // cfg.encoder_seq_len
    assert counts["flash_attention"] == cfg.encoder_layers * fresh
    assert counts["flash_decode"] == 2 * cfg.num_layers * (
        sched.decode_steps + sched.prefill_chunks)
    assert counts["flash_attention_offset"] == 0
    assert counts["softmax_topk"] == sched.decode_steps + sched.prefills_done


# ---------------------------------------------------------------------------
# Training the encoder-decoder; serving and training the VLM.
# ---------------------------------------------------------------------------
def _row_err(got, want, *, by_row=True, absolute=False):
    """bf16: the largest error of a row (the last axis) over that row's
    largest plain entry, floored at 1e-2 of the tensor's largest (at the
    long-key shapes a row's entries lie far below 1, so a scale of 1, or
    of the whole tensor, would let a wrong row pass); without ``by_row``
    over the tensor's largest entry (``FlashAttention`` against autograd
    through the plain forward: its bf16 backward takes delta from the
    rounded output, autograd's softmax exact); with ``absolute`` (the
    decode and prefill checks, which held the max abs error) a row's scale
    is at most 1.  fp32, and a bf16 tensor whose largest entry is below
    1e-3 (rounding noise around a zero the maths gives): the max abs error
    over the larger of 1 and that entry, or with ``absolute`` itself
    (fp32's noise rows, ~1e-6, would fail a row scale at 1e-5).  NaN
    reads as inf."""
    g, w = got.float(), want.float()
    peak = w.abs().max().item()
    diff = (g - w).abs()
    if want.dtype != torch.bfloat16 or peak < 1e-3:
        err = diff.max().item() / (1.0 if absolute else max(1.0, peak))
    elif not by_row:
        err = diff.max().item() / peak
    else:
        rows = w.abs().amax(-1, keepdim=True).clamp_min(1e-2 * peak)
        if absolute:
            rows = rows.clamp_max(1.0)
        err = (diff / rows).max().item()
    return err if err == err else float("inf")


def _fresh_errs_scaled(q, k, v, dout, causal):
    """The fresh forward and both backward kernels against their plain
    versions (K/V NaN past Tk for the kernels, zeroed for the plain
    versions): the largest ``_row_err`` (lse's max abs error), and whether
    every output is finite."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    grads = fab.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    k0, v0 = torch.nan_to_num(k), torch.nan_to_num(v)
    w_out, w_lse = fa.flash_attention_fwd_plain(q, k0, v0, causal=causal)
    want = fab.flash_attention_bwd_plain(q, k0, v0, out, lse, dout,
                                         causal=causal)
    torch.cuda.synchronize()
    finite = all(torch.isfinite(x).all() for x in (out, lse, *grads))
    worst = (lse - w_lse).abs().max().item()
    for a, b_ in zip((out, *grads), (w_out, *want)):
        worst = max(worst, _row_err(a, b_))
    return worst, finite


def _cross(seed, *, b, tq, tk, hkv, g, d, spare=7):
    """q and dout [B, Tq, Hq, D]; k, v [B, Tk, Hkv, D] cut from buffers
    whose rows past Tk are NaN (the cross-attention's shapes)."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, hkv * g, d, generator=gen)
    dout = torch.randn(b, tq, hkv * g, d, generator=gen)
    kv = torch.randn(2, b, tk + spare, hkv, d, generator=gen)
    kv[:, :, tk:] = float("nan")
    return q, kv[0, :, :tk], kv[1, :, :tk], dout


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_encdec_train_kernels_match_plain(cuda, dtype, atol):
    """whisper-small's training instances of rows 6 and 7 (12/12 heads of
    64): non-causal over its encoder's 1536 frames, and non-causal at the
    cross-attention's Tq 256 over Tk 1536 (and a ragged Tq 37 over Tk 100),
    forward, dq and dk/dv against their plain versions; then
    ``FlashAttention``'s gradients at Tq ≠ Tk against autograd through the
    plain forward."""
    dev = dict(device=cuda, dtype=dtype)
    for seed, (b, tq, tk) in enumerate(((1, 1536, 1536), (2, 256, 1536),
                                        (2, 37, 100))):
        q, k, v, dout = (x.to(**dev) for x in _cross(
            30 + seed, b=b, tq=tq, tk=tk, hkv=12, g=1, d=64))
        err, finite = _fresh_errs_scaled(q, k, v, dout, False)
        assert finite and err <= atol, (tq, tk, err)
    q, k, v, dout = (x.to(**dev) for x in _cross(33, b=2, tq=37, tk=100,
                                                  hkv=12, g=1, d=64))
    k, v = torch.nan_to_num(k), torch.nan_to_num(v)
    got, want = [], []
    for fn, store in ((lambda a, b_, c: fa.FlashAttention.apply(a, b_, c,
                                                                 False), got),
                      (lambda a, b_, c: fa.flash_attention_fwd_plain(
                          a, b_, c, causal=False)[0], want)):
        args = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        fn(*args).backward(dout)
        store.extend(a.grad for a in args)
    for a, b_ in zip(got, want):
        assert _row_err(a, b_, by_row=False) <= atol


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_vlm_kernels_match_plain(cuda, dtype, atol):
    """llava-next-34b's instances (56/8 heads of 128, G 7): rows 6 and 7
    causal at its training sequence of 2880 patches + 256 tokens; row 5 at
    its lockstep prefill (B 2, Tq 2944 at offset 0 over caches of 2960, NaN
    past 2944); row 4 over 2945 and 2960 keys of 2960, a repeat bit-equal;
    and the sampler at [2, 64000]."""
    dev = dict(device=cuda, dtype=dtype)
    q, k, v, dout = (x.to(**dev) for x in _fresh(40, b=1, t=3136, hkv=8,
                                                  g=7, d=128))
    err, finite = _fresh_errs_scaled(q, k, v, dout, True)
    assert finite and err <= atol, err
    del q, k, v, dout
    q, kv_nan, kv0, vl = _contiguous(41, b=2, s=2960, tq=2944,
                                     vlens=[2944, 2944], hkv=8, g=7, d=128)
    q, vl = q.to(**dev), vl.to(cuda)
    qo = torch.zeros(2, dtype=torch.int32, device=cuda)
    out, _ = fa.flash_attention_offset(q, *(t.to(**dev) for t in kv_nan), qo,
                                       vl)
    want, _ = fa.flash_attention_offset_plain(q, *(t.to(**dev) for t in kv0),
                                              qo, vl)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _row_err(out, want, absolute=True) <= atol
    for vlens in ([2945, 2945], [2960, 2960]):
        q, kv_nan, kv0, vl = _contiguous(42, b=2, s=2960, tq=1, vlens=vlens,
                                         hkv=8, g=7, d=128)
        q, vl = q.to(**dev), vl.to(cuda)
        got = fd.flash_decode(q, *(t.to(**dev) for t in kv_nan), vl)
        again = fd.flash_decode(q, *(t.to(**dev) for t in kv_nan), vl)
        want = fd.flash_decode_plain(q, *(t.to(**dev) for t in kv0), vl)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and torch.equal(got, again)
        assert _row_err(got, want, absolute=True) <= atol
    x = torch.randn(2, 64000, generator=torch.Generator().manual_seed(43),
                    ).to(cuda) * 4.0
    got, want = st.softmax_topk(x, 5), st.softmax_topk_plain(x, 5)
    assert torch.equal(got.indices.long(), want.indices)
    assert torch.allclose(got.logsumexp, want.logsumexp, rtol=1e-5, atol=0)


def _card_vs_cpu_train_steps(cuda, cfg, batches, seed):
    """Two fp32 train steps of ``cfg`` from the same weights on the card
    (the kernels) and on the CPU (the plain versions), gradients reduced
    in fp32 as the CPU tests run them (the default bf16 cast rounds an
    entry whose fp32 values straddle a bf16 boundary to values one bf16
    step, ~0.4-0.8 %, apart), at the tolerances of the CPU tests' train
    steps (``tests/test_torch_training.py``): each step's loss within rtol
    1e-5 and grad norm within rtol 1e-4, the first moments after the
    first step (a tenth of its gradients) at ``_grad_close``'s rtol 1e-4
    and atol 1e-5 of each leaf's largest entry, then every parameter
    within 2·lr per step taken, at most 1 % of
    any leaf's entries past 1e-5 (an entry whose gradient is ~0 may take
    Adam's ±lr step the other way).  Returns the card's launch counts over
    the two steps and the parameters' paths."""
    from repro_torch import tree
    from repro_torch.configs.base import ParallelConfig, RunConfig
    from repro_torch.optim import adamw
    from repro_torch.training.train_step import init_state, make_train_step
    run = RunConfig(model=cfg, seed=seed,
                    parallel=ParallelConfig(grad_reduce_dtype="float32"))
    params_cpu, _ = init_state(run, device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        params = tree.map(lambda p: p.detach().clone().to(device)
                          .requires_grad_(True), params_cpu)
        opt, step = adamw.init(params), make_train_step(run)
        dispatch.reset_launch_counts()
        metrics = []
        for i, batch in enumerate(batches):
            params, opt, m = step(params, opt, {
                k: torch.as_tensor(x, device=device)
                for k, x in batch.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                first = [(path, x.detach().cpu().clone()) for path, x in
                         tree.leaves_with_path(opt.mu)]
        torch.cuda.synchronize()
        out[device] = (metrics, [p.detach().cpu() for p in
                                 tree.leaves(params)],
                       dispatch.launch_counts(), first)
    (got, p_card, counts, mu_card), (want, p_cpu, _, mu_cpu) = (
        out["cuda"], out["cpu"])
    for (loss, norm), (w_loss, w_norm) in zip(got, want):
        np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
        np.testing.assert_allclose(norm, w_norm, rtol=1e-4)
    for (path, a), (_, b_) in zip(mu_card, mu_cpu):
        np.testing.assert_allclose(
            a.numpy(), b_.numpy(), rtol=1e-4,
            atol=1e-5 * max(b_.abs().max().item(), 1e-30), err_msg=path)
    bound = 2 * run.optimizer.lr * len(batches) + 1e-6
    for a, b_ in zip(p_card, p_cpu):
        diff = (a - b_).abs()
        assert diff.max().item() <= bound
        assert (diff > 1e-5).float().mean().item() <= 0.01
    return counts, [p for p, _ in tree.leaves_with_path(params_cpu)]


def test_encdec_train_steps(cuda):
    """whisper's smoke stack with 2/2 heads of 64 trained through
    ``training.train_step`` on a frames batch, fp32, two steps on the card
    against the CPU; on the card each step launches, per encoder layer and
    per decoder layer's self- and cross-attention, 2 forwards (the
    forward and its recomputation under the layer's checkpoint), a dq and
    a dk/dv."""
    cfg = configs.get_smoke("whisper_small").replace(
        d_model=128, num_heads=2, num_kv_heads=2, head_dim=64)
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    ds = SyntheticDataset(SyntheticConfig(cfg.vocab_size, 48, 2))
    gen = torch.Generator().manual_seed(44)
    batches = [{**ds.batch(i), "frames": torch.randn(
        2, cfg.encoder_seq_len, cfg.d_model, generator=gen)}
        for i in range(2)]
    counts, _ = _card_vs_cpu_train_steps(cuda, cfg, batches, seed=5)
    n = cfg.encoder_layers + 2 * cfg.num_layers
    assert (counts["flash_attention"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkv"]) == (4 * n, 2 * n, 2 * n)
    assert counts["flash_decode"] == counts["flash_attention_offset"] == 0


def test_vlm_train_steps(cuda):
    """llava's smoke stack at 7/1 heads of 128 (G 7) trained through
    ``training.train_step`` on a batch with 16 patch embeddings, fp32, two
    steps on the card against the CPU (``mm_proj`` among the leaves); 2
    forwards, a dq and a dk/dv a layer and step on the card."""
    cfg = configs.get_smoke("llava_next_34b").replace(
        d_model=256, num_heads=7, num_kv_heads=1, head_dim=128)
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    ds = SyntheticDataset(SyntheticConfig(cfg.vocab_size, 40, 2))
    gen = torch.Generator().manual_seed(45)
    batches = [{**ds.batch(i), "patch_embeds": torch.randn(
        2, cfg.num_patches, cfg.d_model, generator=gen)} for i in range(2)]
    counts, paths = _card_vs_cpu_train_steps(cuda, cfg, batches, seed=6)
    n = cfg.num_layers
    assert (counts["flash_attention"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkv"]) == (4 * n, 2 * n, 2 * n)
    assert "mm_proj" in paths


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_decode_lse_form_matches_plain(cuda, dtype, atol):
    """Rows 4 and 4q with their lse: out as the plain launch's, bit for
    bit, lse within 1e-5 of the plain version's (−inf at vlen 0), counted
    apart; and the ⊕ of 3 slices (one wholly past two rows) equals the
    whole cache."""
    from repro_torch.distributed.decode_attention import merge_partials
    from repro_torch.models.layers import _quantize_kv
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    vlens = [0, 1, 70, 33, 96]
    q, kv_nan, kv0, vlen = _contiguous(5, b=5, s=96, tq=1, vlens=vlens)
    q, vl = q.to(**dev), vlen.to(cuda)
    k, v = (t.to(**dev) for t in kv0)
    k8, ks = _quantize_kv(kv0[0])
    v8, vs = _quantize_kv(kv0[1])
    for name, ops in (("flash_decode_lse", (k, v, {})),
                      ("flash_decode_int8_lse", (
                          k8.to(cuda), v8.to(cuda),
                          dict(k_scale=ks.to(cuda), v_scale=vs.to(cuda))))):
        kk, vv, sc = ops
        out, lse = fd.flash_decode(q, kk, vv, vl, return_lse=True, **sc)
        plain = fd.flash_decode(q, kk, vv, vl, **sc)
        w_out, w_lse = fd.flash_decode_plain(q, kk, vv, vl, return_lse=True,
                                             **sc)
        torch.cuda.synchronize()
        assert torch.equal(out, plain), name
        assert lse.shape == (5, 15) and lse.dtype == torch.float32
        assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1:]).all()
        assert (lse[1:] - w_lse[1:]).abs().max().item() <= 1e-5 * max(
            1.0, w_lse[1:].abs().max().item())
        assert (out.float() - w_out.float()).abs().max().item() <= atol
        cuts = (slice(0, 32), slice(32, 64), slice(64, 96))
        parts = [fd.flash_decode(q, kk[:, c], vv[:, c],
                                 (vl - c.start).clamp(0, 32),
                                 return_lse=True,
                                 **{s: t[:, c] for s, t in sc.items()})
                 for c in cuts]
        got = merge_partials(torch.stack([p[0] for p in parts]),
                             torch.stack([p[1] for p in parts]))
        assert (got.float() - out.float()).abs().max().item() <= atol, name
    counts = dispatch.launch_counts()
    assert counts["flash_decode_lse"] == 4
    assert counts["flash_decode_int8_lse"] == 4
    assert counts["flash_decode"] == counts["flash_decode_int8"] == 1


def test_sharded_lockstep_world1_on_card(cuda, tmp_path):
    """The lockstep loop under a (1, 1) mesh's context over NCCL at world
    size 1 (a FileStore): tokens as the unsharded run's, the decode through
    the lse form of row 4."""
    import torch.distributed as dist
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import context
    from repro_torch.launch import mesh as mesh_mod
    cfg = configs.get_smoke("smollm_360m").replace(
        num_heads=6, num_kv_heads=2, head_dim=64)
    params = transformer.params_to(transformer.init(cfg, seed=4,
                                                    device="cpu"), cuda)
    args = serve.parse_args(["--smoke", "--device", "cuda", "--batch", "2",
                             "--prompt-len", "12", "--tokens", "6"])
    noise = np.random.default_rng(0).gumbel(size=(6, 2, 5))
    want = serve.lockstep(args, cfg, params, noise_fn=lambda i: noise[i])
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_debug_mesh(1, 1, device_type="cuda")
        dispatch.reset_launch_counts()
        with context.use(context.ShardContext(mesh=mesh,
                                              par=ParallelConfig())):
            got = serve.lockstep(args, cfg, params,
                                 noise_fn=lambda i: noise[i])
        counts = dispatch.launch_counts()
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)
    assert counts["flash_decode_lse"] == 5 * cfg.num_layers
    assert counts["flash_decode"] == 0 and counts["softmax_topk"] == 6


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_offset", [16, 48, 384])
def test_offset_kernels_match_plain(cuda, dtype, atol, q_offset):
    """Rows 6 and 7 at a causal offset (Tq 128 over Tk = offset + 128,
    15/5 heads of 64) against their plain versions in float64, each
    tensor within ``atol`` of its largest entry; the launches count under
    the offset names."""
    gen = torch.Generator().manual_seed(q_offset)
    tq, tk = 128, q_offset + 128
    q = torch.randn(2, tq, 15, 64, generator=gen)
    k = torch.randn(2, tk, 5, 64, generator=gen)
    v = torch.randn(2, tk, 5, 64, generator=gen)
    dout = torch.randn(2, tq, 15, 64, generator=gen)
    dev = [x.to(cuda, dtype) for x in (q, k, v, dout)]
    before = (fa.launches["flash_attention_qoffset"],
              fab.launches["flash_attention_bwd_dkv_qoffset"])
    out, lse = fa.flash_attention_fwd(*dev[:3], causal=True,
                                      q_offset=q_offset)
    grads = fab.flash_attention_bwd(*dev[:3], out, lse, dev[3], causal=True,
                                    q_offset=q_offset)
    torch.cuda.synchronize()
    assert (fa.launches["flash_attention_qoffset"],
            fab.launches["flash_attention_bwd_dkv_qoffset"]) == \
        (before[0] + 1, before[1] + 1)
    f = [x.to(cuda, dtype).double() for x in (q, k, v, dout)]
    w_out, w_lse = fa.flash_attention_fwd_plain(*f[:3], causal=True,
                                                q_offset=q_offset)
    want = fab.flash_attention_bwd_plain(*f[:3], w_out, w_lse, f[3],
                                         causal=True, q_offset=q_offset)
    for got, w in zip((out, *grads), (w_out, *want)):
        err = (got.double() - w).abs().max() / w.abs().max()
        assert err <= atol, err
    torch.testing.assert_close(lse.double(), w_lse, rtol=1e-5, atol=1e-5)
