"""The model axis's pieces on the CPU, in one process, against the JAX
package.

* Rows 6 and 7 at a causal q offset: ``flash_attention_fwd_plain`` and
  ``flash_attention_bwd_plain`` (and ``FlashAttention`` over them) at q
  offsets 0, 16 and 48 against ``jax.vjp`` of the reference's
  ``core.online_attention(..., causal=True, q_offset=)``
  (``src/repro/core/attention.py:80``), queries at the end of the keys as
  a sequence-parallel rank holds them;
* sequence mode's arithmetic: M row blocks, block r at offset r·T/M over
  keys [0, (r+1)·T/M), concatenated (out, dq) and summed (dk, dv) equal
  one causal launch over all T rows;
* the ⊕ of M vocabulary shards' cross-entropy statistics
  (``merge_vocab_partials``, and ``vocab_shard_grads`` for the backward)
  against the reference's unsharded ``chunked_cross_entropy``, loss and
  gradients, at M 1, 2 and 4, with labels in every shard and z-loss on and
  off;
* ``shard_tree`` / ``gather_tree`` round trips on the dense, MoE and MLA
  smoke placements over (1, 2), (1, 4) and (2, 2), M ranks simulated in
  turn; ``param_axes`` against the reference's ``split_params`` axes;
* the MoE block (expert and ffn mode) and MLA's attention (heads and
  sequence mode) on M ranks run as threads of this process, whose
  collectives meet at a barrier (``_Threads``), against ``jax.vjp`` of the
  reference's unsharded ``moe_apply`` / ``mla_apply``; rows 6m / 7m's
  plain versions at q offsets; the refusal of a dim that does not split;
* the recurrent blocks the same way: Mamba2 over its SSM heads (the gated
  norm's sum of squares summed both ways, which a forward-only sum gets
  wrong), the mLSTM's inner channels with its cell whole on every rank,
  the sLSTM's ffn, against the reference's ``mamba2_apply`` /
  ``mlstm_block_apply`` / ``slstm_block_apply``; ``param_axes`` and the
  packed halves of ``w_zx`` / ``w_up`` in ``shard_tree``; the refusal of a
  Mamba2 head cut across ranks.

Tolerances: float32 on both sides, forward and gradients within rtol 1e-5
/ atol 2e-5 (gradients sum over up to T keys); the block sums within 1e-5
of the whole launch (the same plain arithmetic, summed in another order);
the CE loss within rtol 1e-6 and its gradients within rtol 1e-5 / atol
1e-6, as ``tests/test_torch_train_kernels.py`` holds the unsharded CE; the
sharded blocks within 1e-5 of each tensor's largest entry, the MoE routing
equal exactly.  The CUDA kernels at an offset are held against these
plain versions in ``tests/test_torch_cuda.py`` (``-k offset_kernels``), a
file that imports no JAX, so that they run on the card.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.core import attention as RA  # noqa: E402
from repro.core import cross_entropy as RCE  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models import xlstm as RX  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core import cross_entropy as CE  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm, transformer, xlstm  # noqa: E402

TOL = dict(rtol=1e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, *, b, tq, tk, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, hq, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, tk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, tq, hq, d)).astype(np.float32))


@pytest.mark.parametrize("q_offset", [0, 16, 48])
@pytest.mark.parametrize("heads", [(4, 4), (6, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_offset_plain_versions_match_reference(q_offset, heads):
    """out, lse and dq / dk / dv of rows 6 and 7's plain versions at a q
    offset (Tq 32 over Tk = offset + 32) against ``jax.vjp`` of the
    reference's ``online_attention``; ``FlashAttention`` gives the same."""
    hq, hkv = heads
    tq = 32
    tk = q_offset + tq
    q, k, v, dout = _inputs(q_offset + hq, b=2, tq=tq, tk=tk, hq=hq,
                            hkv=hkv, d=16)
    ref_out, vjp = jax.vjp(lambda q_, k_, v_: RA.online_attention(
        q_, k_, v_, causal=True, q_offset=q_offset, chunk_size=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_dq, ref_dk, ref_dv = vjp(jnp.asarray(dout))
    out, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal=True,
                                            q_offset=q_offset, chunk_size=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    grads = fab.flash_attention_bwd_plain(_t(q), _t(k), _t(v), out, lse,
                                          _t(dout), causal=True,
                                          q_offset=q_offset)
    for got, want in zip(grads, (ref_dq, ref_dk, ref_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    qs, ks, vs = (_t(x).requires_grad_(True) for x in (q, k, v))
    o = fa.FlashAttention.apply(qs, ks, vs, True, q_offset)
    o.backward(_t(dout))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for x, want in zip((qs, ks, vs), (ref_dq, ref_dk, ref_dv)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("q_offset", [0, 16, 48])
def test_offset_plain_versions_match_reference_mla(q_offset):
    """Rows 6m / 7m's plain versions, MLA's decompressed form at (Dqk 96,
    Dv 64) and its scale 96^-0.5 (the instances sequence mode launches), at
    a q offset (Tq 32 over Tk = offset + 32, 5 heads) against ``jax.vjp``
    of the reference's ``online_attention``."""
    tq, tk, h = 32, q_offset + 32, 5
    rng = np.random.default_rng(96 + q_offset)
    q = rng.standard_normal((2, tq, h, 96)).astype(np.float32)
    k = rng.standard_normal((2, tk, h, 96)).astype(np.float32)
    v = rng.standard_normal((2, tk, h, 64)).astype(np.float32)
    dout = rng.standard_normal((2, tq, h, 64)).astype(np.float32)
    ref_out, vjp = jax.vjp(lambda q_, k_, v_: RA.online_attention(
        q_, k_, v_, causal=True, q_offset=q_offset, chunk_size=16,
        scale=96 ** -0.5), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(dout))
    out, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal=True,
                                            q_offset=q_offset, chunk_size=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    grads = fab.flash_attention_bwd_plain(_t(q), _t(k), _t(v), out, lse,
                                          _t(dout), causal=True,
                                          q_offset=q_offset)
    for got, want in zip(grads, ref_grads):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_scale_takes_the_fresh_route():
    """MLA's explicit scale, (Dn + Dr)^-0.5 as ``layers`` computes it, is
    the (96, 64) instances' own Dqk^-0.5, so ``dispatch.sdpa``'s fresh
    route takes it on the card (at any q offset) and raises on another."""
    from repro_torch.kernels import dispatch
    m = configs.get("minicpm3_4b").mla
    q, v = torch.zeros(1, 1, 1, 96), torch.zeros(1, 1, 1, 64)
    pairs = fa.HEAD_DIMS["flash_attention"]
    dispatch._require_kernel_form(
        q, v, (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5, "mla",
        pairs=pairs)
    with pytest.raises(NotImplementedError, match="custom scale"):
        dispatch._require_kernel_form(q, v, 0.1, "mla", pairs=pairs)


@pytest.mark.parametrize("m", [2, 4])
def test_offset_blocks_sum_to_the_whole(m):
    """Sequence mode's arithmetic: block r of T/M query rows at offset
    r·T/M over keys [0, (r+1)·T/M) (``FlashAttention`` with autograd), the
    blocks' out and dq concatenated and dk / dv summed, against one causal
    launch over all T rows."""
    q, k, v, dout = (_t(x) for x in _inputs(m, b=2, tq=64, tk=64, hq=6,
                                            hkv=2, d=16))
    whole = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.FlashAttention.apply(*whole, True)
    out.backward(dout)
    rows = 64 // m
    outs, dqs = [], []
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(m):
        lo, hi = r * rows, (r + 1) * rows
        qr = q[:, lo:hi].clone().requires_grad_(True)
        kr = k[:, :hi].clone().requires_grad_(True)
        vr = v[:, :hi].clone().requires_grad_(True)
        o = fa.FlashAttention.apply(qr, kr, vr, True, lo)
        o.backward(dout[:, lo:hi])
        outs.append(o.detach())
        dqs.append(qr.grad)
        dk[:, :hi] += kr.grad
        dv[:, :hi] += vr.grad
    for got, want in ((torch.cat(outs, 1), out.detach()),
                      (torch.cat(dqs, 1), whole[0].grad),
                      (dk, whole[1].grad), (dv, whole[2].grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_offset_refusals():
    """The fresh kernels' wrappers take one integer offset with the keys
    reaching the last row (checked before any device is touched)."""
    with pytest.raises(ValueError, match="Tk >= q_offset"):
        fab.check_q_offset("flash_attention", 40, 32, 64, True)
    with pytest.raises(ValueError, match="one q_offset"):
        fab.check_q_offset("flash_attention", torch.tensor([0, 1]), 32, 64,
                           True)
    assert fab.check_q_offset("flash_attention", torch.tensor(32), 32, 64,
                              True) == 32
    assert fab.check_q_offset("flash_attention", 40, 32, 64, False) == 40


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_vocab_shard_merge_matches_reference(m, z_loss):
    """M shards of a [D, V] head: each shard's ``vocab_shard_stats``,
    merged by ``merge_vocab_partials``, give the reference's unsharded
    ``chunked_cross_entropy`` loss; each shard's ``vocab_shard_grads``
    from the merged lse give dh (summed over shards) and dW (the shards'
    columns) equal to the reference's ``jax.grad``.  Labels fall in every
    shard; each shard streams its V/M columns in 2 chunks, the reference
    V in 8."""
    rng = np.random.default_rng(10 + m)
    t, d, v = 24, 32, 256
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(np.float32)
    labels = (np.arange(t) * (v // t) + rng.integers(0, v // t, t)) % v
    dloss = rng.standard_normal(t).astype(np.float32)
    assert len({int(x) // (v // m) for x in labels}) == m
    ref_loss, vjp = jax.vjp(
        lambda h_, w_: RCE.chunked_cross_entropy(
            h_, w_, jnp.asarray(labels), num_chunks=8, z_loss=z_loss),
        jnp.asarray(h), jnp.asarray(w))
    ref_dh, ref_dw = vjp(jnp.asarray(dloss))
    n = v // m
    stats = [CE.vocab_shard_stats(_t(h), _t(w[:, r * n:(r + 1) * n]),
                                  _t(labels) - r * n, 2) for r in range(m)]
    lse, label_logit = CE.merge_vocab_partials(
        *(torch.stack([s[i] for s in stats]) for i in range(3)))
    loss = lse - label_logit + z_loss * lse.square()
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss),
                               rtol=1e-6, atol=1e-6)
    parts = [CE.vocab_shard_grads(_t(h), _t(w[:, r * n:(r + 1) * n]),
                                  _t(labels) - r * n, lse, _t(dloss), 2,
                                  z_loss) for r in range(m)]
    dh = sum(p[0] for p in parts)
    dw = torch.cat([p[1] for p in parts], 1)
    np.testing.assert_allclose(dh.numpy(), np.asarray(ref_dh), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), rtol=1e-5,
                               atol=1e-6)


class _Mesh:
    """A (data, model) mesh's sizes and one rank's place on it: what
    ``shard_tree`` reads (``mesh_dim_names``, ``size``,
    ``get_local_rank``), and a group handle for ``gather_tree``."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, rank):
        self.shape, self.rank = shape, rank

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, dim):
        return self.rank[dim]

    def get_group(self, name):
        return name


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=str)
@pytest.mark.parametrize("arch", ["smollm_360m", "mistral_nemo_12b",
                                  "qwen2_moe_a2p7b", "llama4_scout_17b_a16e",
                                  "minicpm3_4b", "zamba2_1p2b",
                                  "xlstm_125m"])
def test_shard_and_gather_round_trip(arch, shape, monkeypatch):
    """Every model rank's ``shard_tree`` of a full smoke tree, gathered by
    ``gather_tree`` (its all-gather served from the M ranks' shards), is
    the full tree again; a sharded leaf's dim is 1/M of the full one and
    ``sharded_flags`` marks exactly those leaves; the placements are the
    reference's rules (``sharding.axis_rules``) for the mode
    ``derive_parallel`` picks.  A packed leaf (Mamba2's ``w_zx``, the
    mLSTM's ``w_up``) is sharded per half: rank r's shard is [z_r | x_r]
    (or [xm_r | z_r])."""
    cfg = configs.get_smoke(arch)
    sizes = dict(zip(("data", "model"), shape))
    par = sharding.derive_parallel(cfg, sizes, ParallelConfig())
    place = tp_mod.placements(cfg, par, sizes)
    full = transformer.init(cfg, seed=3, device="cpu")
    m = shape[1]
    shards = [tp_mod.shard_tree(full, place, _Mesh(shape, (0, r)))
              for r in range(m)]
    by_ptr = {}
    for leaves in zip(*(tree.leaves(s) for s in shards)):
        by_ptr[leaves[0].data_ptr()] = leaves
    flags = tree.leaves(tp_mod.sharded_flags(place))
    assert len(flags) == len(tree.leaves(full))
    for f, a, b in zip(flags, tree.leaves(full), tree.leaves(shards[0])):
        assert f == (a.shape != b.shape)
        if f:
            assert a.numel() == b.numel() * m

    def gather(x, dim, group):
        assert group == "model"
        return torch.cat(by_ptr[x.data_ptr()], dim)
    monkeypatch.setattr(tp_mod, "all_gather", gather)
    back = tp_mod.gather_tree(shards[0], place, _Mesh(shape, (0, 0)))
    for (path, a), b in zip(tree.leaves_with_path(full), tree.leaves(back)):
        assert torch.equal(a, b), path
    mode = "heads" if cfg.num_heads % m == 0 else "sequence"
    assert par.attn_mode == mode
    flags = tp_mod.sharded_flags(place)
    attn = (flags.get("shared_attn") or flags["layers"][0]).get("attn")
    if attn and (mode == "heads"
                 or (cfg.num_heads * cfg.resolved_head_dim) % m == 0):
        assert attn["wq" if "wq" in attn else "wuq"]
    assert tp_mod.param_shapes(cfg) == tree.map(lambda a: tuple(a.shape),
                                                full)
    halves = tree.leaves(sharding._map_leaves(
        lambda p: isinstance(p, tp_mod.Halves), place,
        is_leaf=sharding._is_leaf))
    packed = [i for i, h in enumerate(halves) if h]
    names = [tree.leaves_with_path(full)[i][0].rsplit("/", 1)[1]
             for i in packed]
    assert names == {"zamba2_1p2b": ["w_zx"] * cfg.num_layers,
                     "xlstm_125m": ["w_up"] * (cfg.num_layers // 2)}.get(
                         arch, [])
    for i in packed:
        a = tree.leaves(full)[i]
        half = a.shape[1] // 2
        n = half // m
        for r, sh in enumerate(shards):
            assert torch.equal(tree.leaves(sh)[i], torch.cat(
                [a[:, r * n:(r + 1) * n],
                 a[:, half + r * n:half + (r + 1) * n]], 1)), (names, r)


def test_model_axis_is_off_without_a_mesh_axis():
    """No context, or a context whose mesh has no model axis: the layers
    run their unsharded code."""
    from repro_torch.distributed import context
    cfg = configs.get_smoke("smollm_360m")
    assert tp_mod.model_axis(cfg) is None
    ctx = context.ShardContext(mesh=None, par=ParallelConfig())
    with context.use(ctx):
        assert tp_mod.model_axis(cfg) is None


# ---------------------------------------------------------------------------
# the MoE and MLA blocks on the model axis
# ---------------------------------------------------------------------------
MODEL_ARCHS = ("qwen2_moe_a2p7b", "llama4_scout_17b_a16e", "minicpm3_4b")


def _ref_axes(tree_, cfg_ref):
    """The reference's ``split_params`` axes → the port's layout: each
    segment's stacked layers one dict each in stack order (zamba2's
    ``shared_attn`` placeholders skipped), ``"layers"`` dropped, a
    ``{"scale"}`` norm dict its axes, zamba2's unstacked ``shared_attn``
    as it is."""
    def leaf(x, stacked=True):
        if isinstance(x, dict):
            if set(x) == {"scale"}:
                return leaf(x["scale"], stacked)
            return {k: leaf(v, stacked) for k, v in x.items()}
        if not stacked:
            return tuple(x)
        assert x[0] == "layers", x
        return tuple(x[1:])
    out = {"embed": tree_["embedding"]["embed"]}
    if "head" in tree_["embedding"]:
        out["head"] = tree_["embedding"]["head"]
    out["final_norm"] = tree_["final_norm"]["scale"]
    if "shared_attn" in tree_:
        out["shared_attn"] = leaf(tree_["shared_attn"], stacked=False)
    out["layers"] = [leaf(seg) for (kind, count), seg in zip(
        RT.block_pattern(cfg_ref), tree_["segments"])
        if kind != "shared_attn" for _ in range(count)]
    return out


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_param_axes_match_reference(arch):
    """``param_axes`` of the MoE and MLA smoke configs equals the
    reference's ``split_params`` axes without the stacked ``"layers"``
    axis, leaf for leaf, and ``param_shapes`` the reference's shapes."""
    cfg = configs.get_smoke(arch)
    seen = {}

    def values(key):
        params, seen["axes"] = RL.split_params(
            RT.init(key, ref_configs.get_smoke(arch)))
        return params
    shapes = jax.eval_shape(values, jax.random.PRNGKey(0))
    assert len(seen["axes"]["segments"]) == 1
    cfg_ref = ref_configs.get_smoke(arch)
    want = _ref_axes(seen["axes"], cfg_ref)
    got = tp_mod.param_axes(cfg)
    assert got == want
    want_shapes = _ref_axes(jax.tree.map(
        lambda a: ("layers",) + tuple(a.shape[1:]) if a.ndim > 1
        or a.shape[0] == cfg.num_layers else tuple(a.shape), shapes),
        cfg_ref)
    want_shapes["embed"] = tuple(shapes["embedding"]["embed"].shape)
    if "head" in want_shapes:
        want_shapes["head"] = tuple(shapes["embedding"]["head"].shape)
    want_shapes["final_norm"] = tuple(shapes["final_norm"]["scale"].shape)
    assert tp_mod.param_shapes(cfg) == want_shapes


def test_sharded_flags_of_moe_and_mla():
    """What the clipping norm sums over the model group (``sharded_flags``)
    at M 4: the experts, the shared expert's ffn, MLA's up-projections and
    wo; not the router, wdq, wdkv, the norms (counted once)."""
    sizes = {"data": 1, "model": 4}
    flags = {}
    for arch in MODEL_ARCHS:
        cfg = configs.get_smoke(arch)
        par = sharding.derive_parallel(cfg, sizes, ParallelConfig())
        flags[arch] = tp_mod.sharded_flags(tp_mod.placements(cfg, par,
                                                             sizes))
    for arch in MODEL_ARCHS[:2]:
        layer = flags[arch]["layers"][1]
        assert layer["moe"] == {"router": False, "w_gate": True,
                                "w_up": True, "w_down": True,
                                "shared": {"w_up": True, "w_down": True,
                                           "w_gate": True}}
        assert not layer["ln1"] and not layer["ln2"]
    attn = flags["minicpm3_4b"]["layers"][1]["attn"]
    assert attn == {"wdq": False, "q_norm": False, "wuq": True,
                    "wdkv": False, "kv_norm": False, "wuk": True,
                    "wuv": True, "wo": True}
    assert not flags["minicpm3_4b"]["final_norm"]


class _Threads:
    """M model ranks as M threads of this process: ``tensor_parallel``'s
    ``all_reduce`` and ``all_gather`` (patched) meet at a barrier and
    combine the ranks' tensors in rank order, forward and backward (each
    thread runs its own autograd backward)."""

    def __init__(self, m, monkeypatch):
        self.m, self.slots = m, [None] * m
        self.barrier = threading.Barrier(m, timeout=120)
        self.local = threading.local()
        monkeypatch.setattr(tp_mod, "all_reduce", self.all_reduce)
        monkeypatch.setattr(tp_mod, "all_gather", self.all_gather)

    def _meet(self, x):
        self.slots[self.local.rank] = x
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts

    def all_reduce(self, x, group, op="sum"):
        parts = self._meet(x.detach().clone())
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p) if op == "max" else out + p
        return x.copy_(out)

    def all_gather(self, x, dim, group):
        return torch.cat(self._meet(x.contiguous()), dim)

    def run(self, fn):
        """``fn(rank)`` on every rank's thread; their results in rank
        order (the first error raised)."""
        out, errors = [None] * self.m, []

        def target(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except Exception as e:          # raised below, in the caller
                errors.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=target, args=(r,), daemon=True)
                   for r in range(self.m)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        if errors:
            raise errors[0]
        return out


def _axis(cfg, m, r):
    sizes = {"data": 1, "model": m}
    par = sharding.derive_parallel(cfg, sizes, ParallelConfig())
    return (tp_mod.ModelAxis(None, r, m, "model", par.attn_mode,
                             sharding.axis_rules(cfg, par, sizes)),
            tp_mod.placements(cfg, par, sizes))


def _shard(leaves, place, m, r):
    """Rank r's slices of a {name: tensor or dict} block, by placement."""
    def cut(x, p):
        d = tp_mod._dim(p, "model")
        if d is None:
            return x.clone()
        n = x.shape[d] // m
        return x.narrow(d, r * n, n).clone()
    return {k: ({a: cut(b, place[k][a]) for a, b in v.items()}
                if isinstance(v, dict) else cut(v, place[k]))
            for k, v in leaves.items()}


def _flat_leaves(block):
    return [(k + "/" + a, b) if isinstance(v, dict) else (k, v)
            for k, v in block.items()
            for a, b in (v.items() if isinstance(v, dict) else [(None, v)])]


def _close(got, want, what, tol=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _ref_keep(idx, cfg, s):
    """The reference's kept assignments [G, S, K] from its own lines
    (``moe_apply`` at ``src/repro/models/layers.py:510-514``) on the
    router's indices."""
    mc = cfg.moe
    e_pad = mc.pad_experts_to or mc.num_experts
    g, _, k = idx.shape
    cap = max(int(np.ceil(s * k * mc.capacity_factor / mc.num_experts)), 4)
    em = jax.nn.one_hot(jnp.asarray(idx, jnp.int32), e_pad,
                        dtype=jnp.float32).reshape(g, s * k, e_pad)
    pos = jnp.cumsum(em, axis=1) * em - 1.0
    return np.asarray(((pos >= 0) & (pos < cap)).any(-1)).reshape(g, s, k)


@functools.partial(jax.jit, static_argnums=3)
def _ref_moe_vjp(p, x, dy, cfg):
    """The reference's ``moe_apply`` and the gradients of y · dy plus both
    aux losses (jitted: op by op it compiled for most of a minute)."""
    (y, aux), vjp = jax.vjp(lambda p_, x_: RL.moe_apply(p_, x_, cfg), p, x)
    g, dx = vjp((dy, {k: jnp.ones(()) for k in aux}))
    return y, aux, g, dx


@functools.partial(jax.jit, static_argnums=3)
def _ref_mla_vjp(p, x, dy, cfg):
    """The reference's training-form ``mla_apply`` and the gradients of
    its output · dy."""
    y, vjp = jax.vjp(lambda p_, x_: RL.mla_apply(
        p_, x_, cfg, positions=jnp.arange(x.shape[1]))[0], p, x)
    return (y,) + vjp(dy)


#: (arch, config changes, M, how the experts split, whether "ffn" shards
#: the shared expert): qwen2-moe's 8 padded experts over 2 and 4 ranks
#: (the pads on the last), in ffn mode (48 / 24 columns an expert), with a
#: d_ff that does not split 4 ways (the shared expert replicated, added
#: after the sum), and llama4-scout's 4 experts top 1
MOE_SHARDS = {
    "qwen2_expert_m2": ("qwen2_moe_a2p7b", {}, 2, "expert", True),
    "qwen2_expert_m4": ("qwen2_moe_a2p7b", {}, 4, "expert", True),
    "qwen2_ffn_m2": ("qwen2_moe_a2p7b", {"shard_mode": "ffn"}, 2, "ffn",
                     True),
    "qwen2_ffn_m4": ("qwen2_moe_a2p7b", {"shard_mode": "ffn"}, 4, "ffn",
                     True),
    "qwen2_shared_replicated_m4": ("qwen2_moe_a2p7b", {"d_ff": 90}, 4,
                                   "expert", False),
    "llama4_expert_m4": ("llama4_scout_17b_a16e", {}, 4, "expert", True),
}


@pytest.mark.parametrize("case", list(MOE_SHARDS))
def test_moe_shards_match_reference(case, monkeypatch):
    """``moe_apply`` on M model ranks (threads, each with its shards)
    against the reference's unsharded ``moe_apply`` and ``jax.vjp`` of y ·
    dy plus both aux losses: every rank's y (the ranks' partials summed by
    ``reduce_from_model``) and aux losses within 1e-5 of the largest
    entry, every rank's chosen experts and kept assignments equal to the
    reference's exactly; dx and the router's gradient whole on every rank,
    each rank's expert (and sharded shared-expert) gradients its slice of
    the reference's, a replicated leaf's gradient the reference's, all
    within 1e-5 of each leaf's largest entry.  Padded experts get zero
    gradients.  Top 1 (llama4-scout) renormalizes p / p = 1, so the y part
    of the router's gradient is rounding (g/p − g·p/p², ~1e-2 of the aux
    part here, in the reference as in the port): its router is held to
    the port's unsharded ``moe_apply`` instead, which rounds alike."""
    arch, changes, m, experts, shared_sharded = MOE_SHARDS[case]
    cfg = configs.get_smoke(arch)
    cfg_ref = ref_configs.get_smoke(arch)
    moe_changes = {k: v for k, v in changes.items() if k != "d_ff"}
    top = {k: v for k, v in changes.items() if k == "d_ff"}
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_changes), **top)
    cfg_ref = cfg_ref.replace(moe=dataclasses.replace(cfg_ref.moe,
                                                      **moe_changes), **top)
    p_ref, _ = RL.split_params(RL.moe_init(jax.random.PRNGKey(7), cfg_ref))
    p_ref = jax.tree.map(np.asarray, p_ref)
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    y_ref, aux_ref, g_ref, dx_ref = jax.tree.map(np.asarray, _ref_moe_vjp(
        p_ref, jnp.asarray(x), jnp.asarray(dy), cfg_ref))
    full = {k: ({a: _t(b) for a, b in v.items()} if isinstance(v, dict)
                else _t(v)) for k, v in p_ref.items()}
    full_r = full["router"].clone().requires_grad_(True)
    y1, aux1 = L.moe_apply({**full, "router": full_r}, _t(x), cfg)
    router_one, = torch.autograd.grad(
        (y1 * _t(dy)).sum() + sum(aux1.values()), [full_r])
    if cfg.moe.experts_per_token == 1:
        g_ref["router"] = router_one.numpy()
    threads = _Threads(m, monkeypatch)
    route = L.moe_route
    seen = {}

    def spy(*a, **kw):
        r = route(*a, **kw)
        seen[threads.local.rank] = r
        return r
    monkeypatch.setattr(L, "moe_route", spy)

    def rank(r):
        tp, place = _axis(cfg, m, r)
        assert tp.shards("expert" if experts == "expert" else "expert_ffn")
        assert tp.shards("ffn") == shared_sharded
        block = _shard(full, place["layers"][0]["moe"], m, r)
        leaves = [v.requires_grad_(True) for _, v in _flat_leaves(block)]
        xr = _t(x).requires_grad_(True)
        y, aux = L.moe_apply(block, xr, cfg, tp=tp)
        loss = (y * _t(dy)).sum() + sum(aux.values())
        grads = torch.autograd.grad(loss, [xr] + leaves)
        return y, aux, grads, block
    results = threads.run(rank)
    _, place = _axis(cfg, m, 0)
    place = place["layers"][0]["moe"]
    s = min(cfg.moe.group_size, x.shape[1])
    keep_ref = _ref_keep(np.asarray(seen[0].idx), cfg_ref, s)
    for r, (y, aux, grads, block) in enumerate(results):
        _close(y, y_ref, f"rank {r} y")
        for k, v in aux_ref.items():
            np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5,
                                       err_msg=k)
        assert torch.equal(seen[r].idx, seen[0].idx)
        np.testing.assert_array_equal(seen[r].keep.numpy(), keep_ref)
        _close(grads[0], dx_ref, f"rank {r} dx")
        for (path, leaf), g in zip(_flat_leaves(block), grads[1:]):
            keys = path.split("/")
            want = g_ref[keys[0]] if len(keys) == 1 else \
                g_ref[keys[0]][keys[1]]
            p = place[keys[0]] if len(keys) == 1 else place[keys[0]][keys[1]]
            d = tp_mod._dim(p, "model")
            if d is not None:
                n = want.shape[d] // m
                want = np.take(want, range(r * n, (r + 1) * n), axis=d)
            assert g.shape == want.shape, path
            _close(g, want, f"rank {r} d{path}")
    e_pad = cfg.moe.pad_experts_to
    if e_pad and experts == "expert":      # the pads: the last rank's
        last = results[-1]
        pads = e_pad - cfg.moe.num_experts
        for (path, _), g in zip(_flat_leaves(last[3]), last[2][1:]):
            if path in ("w_gate", "w_up", "w_down"):
                assert not g[-pads:].any(), path


#: (config changes, M, attention mode): minicpm3's 4 MLA heads over 2 and
#: 4 ranks, and 3 heads (sequence mode: rows 6m / 7m at offsets)
MLA_SHARDS = {"heads_m2": ({}, 2, "heads"), "heads_m4": ({}, 4, "heads"),
              "sequence_m4": ({"num_heads": 3, "num_kv_heads": 3}, 4,
                              "sequence"),
              "sequence_m2": ({"num_heads": 3, "num_kv_heads": 3}, 2,
                              "sequence")}


@pytest.mark.parametrize("case", list(MLA_SHARDS))
def test_mla_shards_match_reference(case, monkeypatch):
    """MLA's training form on M model ranks (threads) against ``jax.vjp``
    of the reference's unsharded ``mla_apply``: every rank's output and
    dx, the replicated leaves' gradients (wdq, wdkv and both norms, whole
    on every rank) and each rank's wuq / wuk / wuv / wo gradients (its
    slice of the reference's) within 1e-5 of each tensor's largest
    entry."""
    changes, m, mode = MLA_SHARDS[case]
    cfg = configs.get_smoke("minicpm3_4b").replace(**changes)
    cfg_ref = ref_configs.get_smoke("minicpm3_4b").replace(**changes)
    p_ref, _ = RL.split_params(RL.mla_init(jax.random.PRNGKey(5), cfg_ref))
    p_ref = jax.tree.map(np.asarray, p_ref)
    t = 32
    rng = np.random.default_rng(m)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    y_ref, g_ref, dx_ref = _ref_mla_vjp(p_ref, jnp.asarray(x),
                                        jnp.asarray(dy), cfg_ref)
    flat = {k: (v["scale"] if isinstance(v, dict) else v)
            for k, v in p_ref.items()}
    g_flat = {k: np.asarray(v["scale"] if isinstance(v, dict) else v)
              for k, v in g_ref.items()}
    threads = _Threads(m, monkeypatch)

    def rank(r):
        tp, place = _axis(cfg, m, r)
        assert tp.mode == mode
        block = _shard({k: _t(v) for k, v in flat.items()},
                       place["layers"][0]["attn"], m, r)
        for v in block.values():
            v.requires_grad_(True)
        xr = _t(x).requires_grad_(True)
        y, _ = L.mla_apply(block, xr, cfg, positions=torch.arange(t), tp=tp)
        grads = torch.autograd.grad((y * _t(dy)).sum(),
                                    [xr] + list(block.values()))
        return y, grads, block, place["layers"][0]["attn"]
    for r, (y, grads, block, place) in enumerate(threads.run(rank)):
        _close(y, y_ref, f"rank {r} y")
        _close(grads[0], dx_ref, f"rank {r} dx")
        for (name, _), g in zip(block.items(), grads[1:]):
            want = g_flat[name]
            d = tp_mod._dim(place[name], "model")
            if d is not None:
                n = want.shape[d] // m
                want = np.take(want, range(r * n, (r + 1) * n), axis=d)
            _close(g, want, f"rank {r} d{name}")


def test_placements_refuse_dims_that_do_not_split():
    """A sharded dim that the model axis does not split is refused with a
    ``ValueError`` naming the leaf, before any state is built: qwen2-moe at
    M 3 (ffn mode, d_ff_expert 1408), the shared expert's d_ff_shared under
    ``"ffn"`` (placed by d_ff, 96, not by its own 90), and MLA's H·(Dn+Dr)
    query columns under ``qkv_out`` (placed by H·hd: 3 · 16 splits 16
    ways, 3 · 24 does not)."""
    with pytest.raises(ValueError, match=r"layers/0/moe/w_gate dim 2 of "
                                         r"\(64, 2048, 1408\).*3 ranks"):
        train_cli.parse_args(["--arch", "qwen2_moe_a2p7b", "--mesh", "1x3"])
    cfg = configs.get_smoke("qwen2_moe_a2p7b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, d_ff_shared=90))
    sizes = {"data": 1, "model": 4}
    par = sharding.derive_parallel(cfg, sizes, ParallelConfig())
    with pytest.raises(ValueError, match="layers/0/moe/shared/w_up dim 1"):
        tp_mod.placements(cfg, par, sizes)
    cfg = configs.get_smoke("minicpm3_4b").replace(num_heads=3,
                                                   num_kv_heads=3)
    sizes = {"data": 1, "model": 16}
    par = sharding.derive_parallel(cfg, sizes, ParallelConfig())
    with pytest.raises(ValueError, match="layers/0/attn/wuq dim 1"):
        tp_mod.placements(cfg, par, sizes)
    assert train_cli.parse_args(["--arch", "qwen2_moe_a2p7b", "--mesh",
                                 "1x4"]).mesh == "1x4"


# ---------------------------------------------------------------------------
# the recurrent decoders on the model axis
# ---------------------------------------------------------------------------
RECURRENT_ARCHS = ("zamba2_1p2b", "xlstm_125m")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_param_axes_match_reference_recurrent(arch):
    """``param_axes`` of the zamba2 and xlstm smoke configs equals the
    reference's ``split_params`` axes without the stacked ``"layers"``
    axis, leaf for leaf (zamba2's shared block unstacked in both), and
    ``param_shapes`` the shapes of the port's ``transformer.init``."""
    cfg, cfg_ref = configs.get_smoke(arch), ref_configs.get_smoke(arch)
    seen = {}

    def values(key):
        params, seen["axes"] = RL.split_params(RT.init(key, cfg_ref))
        return params
    jax.eval_shape(values, jax.random.PRNGKey(0))
    assert tp_mod.param_axes(cfg) == _ref_axes(seen["axes"], cfg_ref)
    full = transformer.init(cfg, seed=0, device="cpu")
    assert tp_mod.param_shapes(cfg) == tree.map(lambda a: tuple(a.shape),
                                                full)


def _block_ref(init, cfg_ref, seed):
    """A reference block's weights as numpy, a ``{"scale"}`` norm dict its
    scale (the port's layout)."""
    p, _ = RL.split_params(init(jax.random.PRNGKey(seed), cfg_ref))
    return {k: np.asarray(v["scale"] if isinstance(v, dict) else v)
            for k, v in p.items()}


@functools.partial(jax.jit, static_argnums=(3, 4))
def _ref_block_vjp(p, x, dy, cfg, kind):
    """The reference's training-form recurrent block (``kind``: mamba,
    mlstm or slstm) and the gradients of its output · dy."""
    fn = {"mamba": RS.mamba2_apply, "mlstm": RX.mlstm_block_apply,
          "slstm": RX.slstm_block_apply}[kind]
    box = {"norm", "hnorm"}

    def apply(p_, x_):
        p_ = {k: ({"scale": v} if k in box else v) for k, v in p_.items()}
        return fn(p_, x_, cfg)[0]
    y, vjp = jax.vjp(apply, p, x)
    return (y,) + vjp(dy)


#: (arch, block kind, the block's key in a layer's placements, layer
#: index of that kind, the reference's init)
RECURRENT_BLOCKS = {"mamba": ("zamba2_1p2b", "mamba", 0, RS.mamba2_init),
                    "mlstm": ("xlstm_125m", None, 0, RX.mlstm_block_init),
                    "slstm": ("xlstm_125m", None, 1, RX.slstm_block_init)}


def _recurrent_shards(kind, m, monkeypatch):
    """The block ``kind`` on m model ranks (threads) from the reference's
    weights: (the reference's y, {leaf: gradient}, dx; each rank's (y, dx,
    {leaf: gradient}, its block, its placements))."""
    arch, key, layer, init = RECURRENT_BLOCKS[kind]
    cfg, cfg_ref = configs.get_smoke(arch), ref_configs.get_smoke(arch)
    p_ref = _block_ref(init, cfg_ref, 11)
    rng = np.random.default_rng(m + len(kind))
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    y_ref, g_ref, dx_ref = _ref_block_vjp(
        {k: jnp.asarray(v) for k, v in p_ref.items()}, jnp.asarray(x),
        jnp.asarray(dy), cfg_ref, kind)
    threads = _Threads(m, monkeypatch)
    apply = {"mamba": lambda b, x_, tp: ssm.mamba2_apply(
                 b, x_, cfg, tp=tp)[0],
             "mlstm": lambda b, x_, tp: xlstm.mlstm_block_apply(
                 b, x_, cfg, tp=tp)[0],
             "slstm": lambda b, x_, tp: xlstm.slstm_block_apply(
                 b, x_, cfg, tp=tp)[0]}[kind]

    def rank(r):
        tp, place = _axis(cfg, m, r)
        place = place["layers"][layer]
        place = place[key] if key else place
        block = tp_mod.shard_tree({k: _t(v) for k, v in p_ref.items()},
                                  place, _Mesh((1, m), (0, r)))
        for v in block.values():
            v.requires_grad_(True)
        xr = _t(x).requires_grad_(True)
        y = apply(block, xr, tp)
        grads = torch.autograd.grad((y * _t(dy)).sum(),
                                    [xr] + list(block.values()))
        return y, grads[0], dict(zip(block, grads[1:])), block, place
    return (np.asarray(y_ref), jax.tree.map(np.asarray, g_ref),
            np.asarray(dx_ref), threads.run(rank))


def _rank_slice(want, p, m, r):
    """Rank r's part of a whole leaf ``want`` under placement ``p``."""
    d = tp_mod._dim(p, "model")
    if d is None:
        return want
    parts = np.split(want, 2, axis=d) if isinstance(p, tp_mod.Halves) \
        else [want]
    n = parts[0].shape[d] // m
    return np.concatenate([np.take(x, range(r * n, (r + 1) * n), axis=d)
                           for x in parts], axis=d)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", list(RECURRENT_BLOCKS))
def test_recurrent_shards_match_reference(kind, m, monkeypatch):
    """A recurrent block's training form on M model ranks (threads, each
    with its ``shard_tree`` shards) against ``jax.vjp`` of the reference's
    unsharded block: every rank's y and dx, each sharded leaf's gradient
    its slice of the reference's (``w_zx`` / ``w_up``: the rank's block of
    each half), each replicated leaf's gradient the reference's whole
    (Mamba2's ``w_bc`` / ``conv_b`` / ``conv_c``, the mLSTM's norm and
    ``if_bias``, the sLSTM's gates, recurrent weights and norms), all
    within 1e-5 of each tensor's largest entry.  Mamba2: zamba2's smoke
    block (8 SSM heads of 16: 4 or 2 a rank); mLSTM and sLSTM: xlstm's
    (inner 128 over the ranks with the cell whole on each; the sLSTM's
    ffn of 64)."""
    y_ref, g_ref, dx_ref, results = _recurrent_shards(kind, m, monkeypatch)
    for r, (y, dx, grads, block, place) in enumerate(results):
        _close(y, y_ref, f"rank {r} y")
        _close(dx, dx_ref, f"rank {r} dx")
        assert any(tp_mod._dim(place[k], "model") is not None
                   for k in block)
        for name, g in grads.items():
            want = _rank_slice(g_ref[name], place[name], m, r)
            assert g.shape == want.shape, name
            _close(g, want, f"rank {r} d{name}")


def test_mamba_norm_sum_needs_its_backward_all_reduce(monkeypatch):
    """The gated norm's sum of squares feeds every rank's columns, so its
    gradient is rank-partial and ``sum_over_model`` all-reduces it in the
    backward too.  With a forward-only sum ("g" alone) in its place the
    sharded block's forward still matches the reference but its
    gradients do not: the check above would fail."""
    monkeypatch.setattr(tp_mod, "sum_over_model", tp_mod.reduce_from_model)
    y_ref, g_ref, dx_ref, results = _recurrent_shards("mamba", 2,
                                                      monkeypatch)
    y, dx, grads, _, place = results[0]
    _close(y, y_ref, "y")
    with pytest.raises(AssertionError):
        _close(dx, dx_ref, "dx")
    with pytest.raises(AssertionError):
        _close(grads["w_zx"], _rank_slice(g_ref["w_zx"], place["w_zx"], 2,
                                          0), "dw_zx")


def test_recurrent_placements_refuse_dims_that_do_not_split():
    """xlstm-125m at M 3: its inner 1536 splits, the sLSTM's ffn of 1024
    (sharded under ``"ffn"`` since its d_ff is 0) does not, and the
    refusal names the first sLSTM layer's leaf (layer 5), before any
    state is built; zamba2's smoke config at M 16: its 128 inner channels
    split 16 ways but its 8 SSM heads do not, which would cut a head's 16
    channels across ranks."""
    with pytest.raises(ValueError, match=r"layers/5/w_up1 dim 1 of "
                                         r"\(768, 1024\).*3 ranks"):
        train_cli.parse_args(["--arch", "xlstm_125m", "--mesh", "1x3"])
    cfg = configs.get_smoke("zamba2_1p2b")
    sizes = {"data": 1, "model": 16}
    par = sharding.derive_parallel(cfg, sizes, ParallelConfig())
    with pytest.raises(ValueError, match=r"layers/0/mamba/w_zx.*16 ranks.*"
                                         r"8 SSM heads.*cut across ranks"):
        tp_mod.placements(cfg, par, sizes)
    for arch in RECURRENT_ARCHS:
        assert train_cli.parse_args(["--arch", arch, "--mesh",
                                     "2x4"]).mesh == "2x4"
