"""The port's CUDA kernels on the card (marked ``cuda``; skipped where
``torch.cuda.is_available()`` is false).  Run them on a card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel against its plain version at small shapes (fp32 tightly, bf16
within bf16 rounding), the int8 forms with poisoned dead scales and scales
read through non-contiguous views, a small model served on the card
through the kernels against the same model served on the CPU through the
plain versions, and one full-width train step through the training
kernels.  No JAX is needed.  ``chip_smoke.py`` does the same at full width.
"""
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
                                        **NO_INT8, **NO_LIBRARY}


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
                                        **NO_INT8, **NO_LIBRARY}


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
        report, eng, _, _ = serve.run(args, cfg, params)
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
        "flash_attention_bwd_dkv": 0, **NO_INT8, **NO_LIBRARY}
    assert set(cpu_counts.values()) == {0}
    assert all(0 <= t < cfg.vocab_size for r in rep_g.results
               for t in r.tokens)
    assert np.isfinite(rep_g.tokens_per_s)


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
        report, eng, _, _ = serve.run(args, cfg, params)
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
        "flash_attention_bwd_dkv": 0, **NO_INT8, **NO_LIBRARY}
    assert lock_counts == {"softmax_topk": 6, "flash_decode_paged": 0,
                           "flash_decode": 5 * n, "flash_attention_paged": 0,
                           "flash_attention_offset": n,
                           "flash_attention": 0,
                           "flash_attention_bwd_dq": 0,
                           "flash_attention_bwd_dkv": 0, **NO_INT8,
                           **NO_LIBRARY}


def _fresh(seed, *, b, t, hkv=5, g=3, d=64, spare=7):
    """q, dout [B, T, Hq, D]; k, v [B, T, Hkv, D] cut from buffers of
    T + ``spare`` positions whose rows past T are NaN, so a kernel that
    reads past T fails."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, hkv * g, d, generator=gen)
    dout = torch.randn(b, t, hkv * g, d, generator=gen)
    kv = torch.randn(2, b, t + spare, hkv, d, generator=gen)
    kv[:, :, t:] = float("nan")
    return q, kv[0, :, :t], kv[1, :, :t], dout


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_fresh_attention_kernels_match_plain(cuda, dtype, atol):
    """The training kernels (bf16: the tensor-core forms; fp32: the
    CUDA-core forms): the fresh forward (out, lse), the dq and dk/dv
    backward kernels, and ``FlashAttention``'s gradients against autograd
    through the plain forward; ragged T (not a multiple of 16 or of 64),
    T = 1, one and several 64-row tiles, causal and not, K/V read through
    strides with NaN past T."""
    dispatch.reset_launch_counts()
    dev = dict(device=cuda, dtype=dtype)
    n = 0
    for t, causal in ((37, True), (37, False), (1, True), (1, False),
                      (64, True), (130, True), (130, False)):
        q, k, v, dout = (x.to(**dev) for x in _fresh(7, b=2, t=t))
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
    q, k, v, dout = (x.to(**dev) for x in _fresh(8, b=2, t=37))
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
    with pytest.raises(ValueError, match="D=32"):      # head_dim 64 only
        fa.flash_attention_fwd(q[..., :32].contiguous(),
                               k[..., :32].contiguous(),
                               v[..., :32].contiguous())
    counts = dispatch.launch_counts()
    assert counts["flash_attention"] == n + 1
    assert counts["flash_attention_bwd_dq"] == n + 1
    assert counts["flash_attention_bwd_dkv"] == n + 1


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
