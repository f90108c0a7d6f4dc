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
* ``shard_tree`` / ``gather_tree`` round trips on smollm's and
  mistral-nemo's smoke placements over (1, 2), (1, 4) and (2, 2), M ranks
  simulated in turn.

Tolerances: float32 on both sides, forward and gradients within rtol 1e-5
/ atol 2e-5 (gradients sum over up to T keys); the block sums within 1e-5
of the whole launch (the same plain arithmetic, summed in another order);
the CE loss within rtol 1e-6 and its gradients within rtol 1e-5 / atol
1e-6, as ``tests/test_torch_train_kernels.py`` holds the unsharded CE.  The
CUDA kernels at an offset are held against these plain versions in
``tests/test_torch_cuda.py`` (``-k offset_kernels``), a file that imports
no JAX, so that they run on the card.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import attention as RA  # noqa: E402
from repro.core import cross_entropy as RCE  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core import cross_entropy as CE  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

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
@pytest.mark.parametrize("arch", ["smollm_360m", "mistral_nemo_12b"])
def test_shard_and_gather_round_trip(arch, shape, monkeypatch):
    """Every model rank's ``shard_tree`` of a full smoke tree, gathered by
    ``gather_tree`` (its all-gather served from the M ranks' shards), is
    the full tree again; a sharded leaf's dim is 1/M of the full one and
    ``sharded_flags`` marks exactly those leaves; the placements are the
    reference's rules (``sharding.axis_rules``) for the mode
    ``derive_parallel`` picks."""
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
    if mode == "heads" or (cfg.num_heads * cfg.resolved_head_dim) % m == 0:
        assert tp_mod.sharded_flags(place)["layers"][0]["attn"]["wq"]


def test_model_axis_is_off_without_a_mesh_axis():
    """No context, or a context whose mesh has no model axis: the layers
    run their unsharded code."""
    from repro_torch.distributed import context
    cfg = configs.get_smoke("smollm_360m")
    assert tp_mod.model_axis(cfg) is None
    ctx = context.ShardContext(mesh=None, par=ParallelConfig())
    with context.use(ctx):
        assert tp_mod.model_axis(cfg) is None
