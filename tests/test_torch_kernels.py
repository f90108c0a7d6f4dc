"""The port's kernel modules: plain versions against the Pallas kernels (in
interpret mode, as ``tests/kernels/`` runs them on the CPU), the device
routing of ``kernels.dispatch``, and the build's failure mode.

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
(marked ``cuda``) and ``python3 chip_smoke.py`` hold them against their plain
versions there.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_offset_pallas, flash_attention_paged_pallas)
from repro.kernels.flash_decode import (  # noqa: E402
    flash_decode_pallas, flash_decode_paged_pallas)
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build, dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import softmax_topk as st  # noqa: E402

# float32 on both sides; the plain version gathers pages and runs the chunked
# online form, the Pallas kernel walks one page per grid step — same masked
# (m, d, acc) recurrence, other summation order
TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_case(seed, *, vlens, bs=4, hkv=2, g=3, d=8, tq=1):
    """Pools [P, Hkv, BS, D], tables [B, M] (dead entries → sentinel 0,
    rows 0 and 1 share their first page), q [B, Tq, Hq, D]."""
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
    if b > 1 and min(live[:2]) > 1:
        tables[1, 0] = tables[0, 0]
    q = rng.standard_normal((b, tq, hkv * g, d)).astype(np.float32)
    return q, k_pool, v_pool, tables, np.asarray(vlens, np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("vlens,bs", [([1, 7, 13, 4], 4), ([16, 9, 1], 8),
                                      ([5, 5], 4)])
def test_plain_paged_decode_matches_pallas(vlens, bs):
    q, kp, vp, tables, vlen = _paged_case(0, vlens=vlens, bs=bs)
    ref = flash_decode_paged_pallas(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(tables),
                                    jnp.asarray(vlen), interpret=True)
    got = fd.flash_decode_paged_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(vlen), chunk_size=8)
    assert got.shape == q.shape
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("qoff,vlens,bs,bq", [
    ([0, 3, 9], [8, 11, 17], 4, 4),       # chunks crossing block edges
    ([2, 0], [10, 0], 8, 8),               # row 1: no valid key (lse = -inf)
    ([6, 1], [14, 9], 4, 8)])
def test_plain_paged_prefill_matches_pallas(qoff, vlens, bs, bq):
    tq = 8
    q, kp, vp, tables, vlen = _paged_case(1, vlens=vlens, bs=bs, tq=tq)
    qo = np.asarray(qoff, np.int32)
    ref_out, ref_lse = flash_attention_paged_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(qo), jnp.asarray(vlen),
        jnp.asarray(tables), causal=True, bq=bq, interpret=True)
    out, lse = fa.flash_attention_paged_plain(_t(q), _t(kp), _t(vp), _t(qo),
                                              _t(vlen), _t(tables),
                                              chunk_size=8)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    ref_lse = np.asarray(ref_lse)[..., 0]
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(ref_lse))
    fin = np.isfinite(ref_lse)
    np.testing.assert_allclose(lse.numpy()[fin], ref_lse[fin], **TOL)
    if 0 in vlens:
        assert np.isneginf(lse.numpy()[vlens.index(0)]).all()


def _contiguous_case(seed, *, b, s, tq, hkv=2, g=3, d=8):
    """q [B, Tq, Hq, D]; k, v [B, S, Hkv, D] (model layout)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("vlens,bk", [([0, 1, 16, 9], 4), ([16, 3, 11], 8),
                                      ([1, 0], 16)])
def test_plain_decode_matches_pallas(vlens, bk):
    """The contiguous decode's plain version against ``flash_decode_pallas``
    (caches transposed to its [B, Hkv, S, D]): ragged valid lengths with 0,
    1 and S among them, G = 3, fp32 within 1e-5."""
    q, k, v = _contiguous_case(4, b=len(vlens), s=16, tq=1)
    vlen = np.asarray(vlens, np.int32)
    ref = flash_decode_pallas(
        jnp.asarray(q[:, 0]), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(vlen), bk=bk,
        interpret=True)
    got = fd.flash_decode_plain(_t(q), _t(k), _t(v), _t(vlen), chunk_size=8)
    assert got.shape == q.shape
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)
    assert not got[np.asarray(vlens) == 0].any()       # no valid key → 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("qoff,vlens,tq,bq,bk", [
    ([0, 3, 9], [12, 15, 21], 12, 4, 8),   # ragged offsets, Tq not 16k
    ([2, 0], [10, 0], 8, 8, 8),            # row 1: no valid key (lse -inf)
    ([14, 1], [30, 9], 6, 2, 4)])          # vlen clamped to Tk = 24
def test_plain_offset_prefill_matches_pallas(qoff, vlens, tq, bq, bk, causal):
    """The contiguous cached prefill's plain version against
    ``flash_attention_offset_pallas``: per-row q_offset and vlen, causal on
    and off, a keyless row; out and lse in fp32 within 1e-5."""
    q, k, v = _contiguous_case(5, b=len(vlens), s=24, tq=tq)
    qo, vlen = np.asarray(qoff, np.int32), np.asarray(vlens, np.int32)
    ref_out, ref_lse = flash_attention_offset_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(qo),
        jnp.asarray(np.minimum(vlen, 24)), causal=causal, bq=bq, bk=bk,
        interpret=True)
    out, lse = fa.flash_attention_offset_plain(_t(q), _t(k), _t(v), _t(qo),
                                               _t(vlen), causal=causal,
                                               chunk_size=8)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    ref_lse = np.asarray(ref_lse)[..., 0]
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(ref_lse))
    fin = np.isfinite(ref_lse)
    np.testing.assert_allclose(lse.numpy()[fin], ref_lse[fin], **TOL)
    if 0 in vlens:
        assert np.isneginf(lse.numpy()[vlens.index(0)]).all()


def test_dispatch_routes_cpu_tensors_to_plain_versions():
    dispatch.reset_launch_counts()
    cfg = configs.get_smoke("smollm_360m")
    q, kp, vp, tables, vlen = _paged_case(2, vlens=[5, 9], bs=4)
    out = dispatch.sdpa(cfg, _t(q), _t(kp), _t(vp), causal=False,
                        q_offset=_t(vlen - 1), kv_valid_len=_t(vlen),
                        decode=True, block_tables=_t(tables))
    want = fd.flash_decode_paged_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                       _t(vlen), chunk_size=cfg.attn_chunk)
    assert torch.equal(out, want)
    x = torch.randn(3, 40, generator=torch.Generator().manual_seed(0))
    got = dispatch.softmax_topk(x, 4)
    assert torch.equal(got.indices, st.softmax_topk_plain(x, 4).indices)
    assert dispatch.launch_counts() == {"softmax_topk": 0,
                                        "softmax_topk_router": 0,
                                        "flash_decode_paged": 0,
                                        "flash_decode": 0,
                                        "flash_attention_paged": 0,
                                        "flash_attention_offset": 0,
                                        "flash_attention": 0,
                                        "flash_attention_bwd_dq": 0,
                                        "flash_attention_bwd_dkv": 0,
                                        "flash_decode_paged_int8": 0,
                                        "flash_decode_int8": 0,
                                        "flash_attention_paged_int8": 0,
                                        "flash_decode_lse": 0,
                                        "flash_decode_int8_lse": 0,
                                        "flash_decode_mla": 0,
                                        "flash_attention_mla": 0,
                                        "online_softmax": 0,
                                        "online_softmax_bf16": 0,
                                        "online_softmax_exp2": 0,
                                        "online_normalizer": 0}


def test_dispatch_raises_on_unported_routes():
    cfg = configs.get_smoke("smollm_360m")
    q, kp, vp, tables, vlen = _paged_case(3, vlens=[5, 9], bs=4)
    with pytest.raises(NotImplementedError, match="custom scale"):
        dispatch.sdpa(cfg, _t(q), _t(kp), _t(vp), causal=False,
                      q_offset=0, kv_valid_len=_t(vlen), scale=0.1,
                      decode=True, block_tables=_t(tables))
    meta = torch.empty(2, 3, device="meta")
    with pytest.raises(NotImplementedError, match="device meta"):
        dispatch.softmax_topk(meta, 2)


@pytest.mark.parametrize("call", [
    lambda: st.softmax_topk(torch.zeros(2, 8), 2),
    lambda: fd.flash_decode_paged(torch.zeros(1, 1, 2, 64),
                                  torch.zeros(2, 1, 4, 64),
                                  torch.zeros(2, 1, 4, 64),
                                  torch.zeros(1, 1, dtype=torch.int32),
                                  torch.ones(1, dtype=torch.int32)),
    lambda: fa.flash_attention_paged(torch.zeros(1, 3, 2, 64),
                                     torch.zeros(2, 1, 4, 64),
                                     torch.zeros(2, 1, 4, 64),
                                     torch.zeros(1, dtype=torch.int32),
                                     torch.ones(1, dtype=torch.int32),
                                     torch.zeros(1, 1, dtype=torch.int32)),
    lambda: fd.flash_decode(torch.zeros(2, 1, 3, 64),
                            torch.zeros(2, 8, 1, 64),
                            torch.zeros(2, 8, 1, 64),
                            torch.ones(2, dtype=torch.int32)),
    lambda: fa.flash_attention_offset(torch.zeros(1, 3, 2, 64),
                                      torch.zeros(1, 8, 1, 64),
                                      torch.zeros(1, 8, 1, 64),
                                      torch.zeros(1, dtype=torch.int32),
                                      torch.ones(1, dtype=torch.int32)),
    lambda: fa.flash_attention_fwd(torch.zeros(1, 8, 3, 64),
                                   torch.zeros(1, 8, 1, 64),
                                   torch.zeros(1, 8, 1, 64)),
    lambda: fab.flash_attention_bwd(torch.zeros(1, 8, 3, 64),
                                    torch.zeros(1, 8, 1, 64),
                                    torch.zeros(1, 8, 1, 64),
                                    torch.zeros(1, 8, 3, 64),
                                    torch.zeros(1, 3, 8),
                                    torch.zeros(1, 8, 3, 64))],
    ids=["softmax_topk", "flash_decode_paged", "flash_attention_paged",
         "flash_decode", "flash_attention_offset", "flash_attention",
         "flash_attention_bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches on CUDA tensors or raises: it never falls
    back to the plain version."""
    before = dispatch.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert dispatch.launch_counts() == before


def test_kernels_refuse_other_dtypes():
    """fp32 and bf16 only; the wrappers call this after the device check."""
    assert build.dtype_code(torch.zeros(1, dtype=torch.bfloat16)) == 1
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        build.dtype_code(torch.zeros(1, dtype=torch.float16))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "nowhere")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library("softmax_topk")


def test_build_key_covers_every_source():
    names = {p.name for p in build.CSRC.glob("*.cu*")}
    assert {f"{n}.cu" for n in build.SOURCES} <= names
    assert "common.cuh" in names
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
