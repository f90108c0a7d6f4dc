"""The port's distributed layer on the CPU, against the JAX package.

Two processes do the work once per session, side by side, and every test
here reads what they wrote: one subprocess runs the reference with 4
forced host devices (``XLA_FLAGS``, as ``tests/test_distributed.py``
does), its side jitted; one ``torch.multiprocessing`` spawn runs the port
in a gloo world of 4 ranks (``tests/torch_distributed_world.py``) over the
meshes (2, 2), (1, 4) and (4, 1) built from the same 4 ranks.  The inputs
come from numpy seeds (the weights from the reference's ``init_state``).
Under pytest-xdist the first worker to ask computes, under a file lock in
the session's shared temporary directory, and the others read.

Tolerances: sharded decode (fp and int8) rtol / atol 2e-5, the reference
test's own; the lse of the plain decode against ``_chunked_fwd_impl``'s
1e-5; ``merge_partials`` against the whole-cache decode 1e-5; the sharded
sampler's probabilities rtol 1e-5 / atol 1e-6, its tokens equal; the int8
all-reduce's int8 values and scales exact, its mean 1e-6; the EF forms'
int8 values exact and fp32 1e-7; placements equal; the data-parallel step
1e-6 relative to the single-process step (the parameters after AdamW, and
the loss), and the reference's step within the lr-scaled bound of
``tests/test_torch_training.py``; the model axis's step 1e-5 of each
leaf's largest against the unsharded port step, and the reference's
within the data-parallel bound.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import fcntl
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as RD  # noqa: E402
from repro.distributed import compression as RC  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data.synthetic import (HostShardedLoader,  # noqa: E402
                                        SyntheticConfig, SyntheticDataset)
from repro_torch.distributed import compression, context  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.decode_attention import \
    merge_partials  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from torch_distributed_world import _unflat  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_SCRIPT = os.path.join(REPO, "tests", "torch_distributed_world.py")
MESHES = ((2, 2), (1, 4), (4, 1))
TOP_K = 5
B, S, HQ, HKV, D = 4, 64, 8, 2, 16
VLENS = [64, 40, 17, 1]
V = 512
PLACEMENT_ARCHS = ("smollm_360m", "qwen2_moe_a2p7b", "zamba2_1p2b")
DP_CASES = ("equal", "unequal", "bf16")

# The reference side: 4 host devices, everything under jit, results to
# REF.npz / REF.json.
REFERENCE = textwrap.dedent('''
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    import repro.configs as configs
    from repro.configs.base import OptimizerConfig, ParallelConfig, RunConfig
    from repro.core.attention import _chunked_fwd_impl
    from repro.distributed import sharding
    from repro.distributed.compression import int8_allreduce
    from repro.distributed.decode_attention import (sharded_decode_attention,
                                                    sharded_topk_sample)
    from repro.training.train_step import make_train_step

    inp = dict(np.load(sys.argv[1]))
    out, meta = {}, {}
    q, vlen = jnp.asarray(inp["dec_q"]), jnp.asarray(inp["dec_vlen"])
    kv = {"fp": (inp["dec_k"], inp["dec_v"], {}),
          "int8": (inp["dec_k8"], inp["dec_v8"],
                   dict(k_scale=jnp.asarray(inp["dec_ks"], jnp.bfloat16),
                        v_scale=jnp.asarray(inp["dec_vs"], jnp.bfloat16)))}
    for shape in [(2, 2), (1, 4)]:
        mesh = jax.make_mesh(shape, ("data", "model"))
        for name, (k, v, sc) in kv.items():
            fn = jax.jit(lambda q, k, v, vl, sc: sharded_decode_attention(
                q, k, v, vl, mesh=mesh, seq_axes=("model",),
                batch_axes=("data",), chunk_size=16,
                scale=q.shape[-1] ** -0.5, **sc))
            with mesh:
                out[f"decode_{name}_{shape}"] = np.asarray(
                    fn(q, jnp.asarray(k), jnp.asarray(v), vlen, sc))
        fn = jax.jit(lambda key, x: sharded_topk_sample(
            key, x, 5, mesh=mesh, batch_axes=("data",)))
        with mesh:
            tok, probs = fn(jax.random.PRNGKey(7),
                            jnp.asarray(inp["smp_logits"]))
        out[f"sample_tok_{shape}"] = np.asarray(tok)
        out[f"sample_probs_{shape}"] = np.asarray(probs)
    for name, (k, v, sc) in kv.items():
        _, lse = jax.jit(lambda q, k, v, vl, sc: _chunked_fwd_impl(
            q, k, v, jnp.asarray(0, jnp.int32), vl, False, 16,
            q.shape[-1] ** -0.5, **sc))(q, jnp.asarray(k), jnp.asarray(v),
                                        vlen, sc)
        out[f"lse_{name}"] = np.asarray(lse)
    mesh = jax.make_mesh((4,), ("data",))
    with mesh:
        out["int8_replicated"] = np.asarray(jax.jit(
            lambda x: int8_allreduce(x, mesh, "data"))(
                jnp.asarray(inp["i8_x"][0])))
    # placements, every leaf of the smoke configs on every mesh (shapes
    # from a trace of the init, which computes nothing)
    from repro.models import layers as L
    from repro.models import transformer
    for arch in %(archs)r:
        cfg = configs.get_smoke(arch)
        seen = {}
        def values(key):
            params, seen["axes"] = L.split_params(transformer.init(key, cfg))
            return params
        params = jax.eval_shape(values, jax.random.PRNGKey(0))
        axes = seen["axes"]
        for shape in %(meshes)r:
            mesh = jax.make_mesh(shape, ("data", "model"))
            par = sharding.derive_parallel(cfg, mesh)
            p_sh = sharding.param_sharding(axes, cfg, par, mesh)
            o_sh = sharding.optimizer_sharding(p_sh, params, mesh, par)
            f_sh = sharding.fsdp_param_sharding(p_sh, params, mesh, par)
            leaves = {}
            for (path, ax), (_, p), (_, s1), (_, s2), (_, s3) in zip(
                    *(jax.tree_util.tree_leaves_with_path(
                        t, is_leaf=lambda x: isinstance(x, tuple))
                      for t in (axes, params, p_sh, o_sh, f_sh))):
                key = jax.tree_util.keystr(path)
                leaves[key] = dict(
                    axes=list(ax), shape=list(p.shape), param=tuple(s1.spec),
                    opt=tuple(s2.spec), fsdp=tuple(s3.spec),
                    data=tuple(sharding.add_data_axis(
                        s1.spec, p.shape, mesh, par, min_bytes=0)))
            meta[f"{arch} {shape}"] = dict(
                leaves=leaves, batch=tuple(sharding.batch_spec(par)),
                par=dict(data_axes=par.data_axes, model_axis=par.model_axis,
                         attn_mode=par.attn_mode))
    # the reference's train step from the same weights, one step a case
    flat = {k[2:]: v for k, v in inp.items() if k.startswith("w/")}
    def unflat(flat):
        root = {}
        for path, v in flat.items():
            node, keys = root, path.split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = jnp.asarray(v)
        def lists(n):
            if not isinstance(n, dict):
                return n
            if n and all(k.isdigit() for k in n):
                return [lists(n[str(i)]) for i in range(len(n))]
            return {k: lists(v) for k, v in n.items()}
        return lists(root)
    cfg = configs.get_smoke("smollm_360m").replace(num_layers=2)
    from repro.optim import adamw
    # mistral-nemo's smoke config from its own weights: the model axis's
    # heads-mode cases are held to it
    mcfg = configs.get_smoke("mistral_nemo_12b").replace(num_layers=2)
    mflat = {k[3:]: v for k, v in inp.items() if k.startswith("wm/")}
    params = unflat(mflat)
    batch = {k: jnp.asarray(inp[f"dp_equal_{k}"]) for k in ("tokens", "labels")}
    params, _, m = jax.jit(make_train_step(RunConfig(
        model=mcfg, optimizer=OptimizerConfig(
            lr=1e-3, warmup_steps=0, schedule="constant"),
        parallel=ParallelConfig(grad_reduce_dtype="float32"))))(
            params, adamw.init(params), batch)
    out["train_loss_mistral"] = np.asarray(m["loss"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        out["train_mistral:" + jax.tree_util.keystr(path)] = \\
            np.asarray(leaf)
    steps = {}
    for case in %(cases)r:
        dtype = "bfloat16" if case == "bf16" else "float32"
        if dtype not in steps:       # one compile a reduce dtype
            steps[dtype] = jax.jit(make_train_step(RunConfig(
                model=cfg, optimizer=OptimizerConfig(
                    lr=1e-3, warmup_steps=0, schedule="constant"),
                parallel=ParallelConfig(grad_reduce_dtype=dtype))))
        params = unflat(flat)
        batch = {k: jnp.asarray(inp[f"dp_{case}_{k}"])
                 for k in ("tokens", "labels")}
        params, _, m = steps[dtype](params, adamw.init(params), batch)
        out[f"train_loss_{case}"] = np.asarray(m["loss"])
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            out[f"train_{case}:" + jax.tree_util.keystr(path)] = \\
                np.asarray(leaf)
    np.savez(sys.argv[2], **out)
    with open(sys.argv[3], "w") as f:
        json.dump(meta, f)
''') % dict(archs=PLACEMENT_ARCHS, meshes=MESHES, cases=DP_CASES)


def _flat_numpy(t, prefix=""):
    """A reference tree of dicts and lists → {"a/0/b": array}."""
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_flat_numpy(v, f"{prefix}{k}/"))
        return out
    if isinstance(t, (list, tuple)):
        out = {}
        for i, v in enumerate(t):
            out.update(_flat_numpy(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(t)}


def _inputs() -> dict:
    """Every input, from numpy seeds (and the reference's initial weights
    and Gumbel draws)."""
    from repro.configs.base import RunConfig as RRun
    import repro.configs as ref_configs
    from repro.training.train_step import init_state as ref_init
    rng = np.random.default_rng(0)
    inp = {"dec_q": rng.standard_normal((B, 1, HQ, D), np.float32),
           "dec_k": rng.standard_normal((B, S, HKV, D), np.float32),
           "dec_v": rng.standard_normal((B, S, HKV, D), np.float32),
           "dec_vlen": np.asarray(VLENS, np.int32)}
    for name in ("k", "v"):
        x = inp[f"dec_{name}"]
        scale = torch.from_numpy(np.abs(x).max(-1) / 127.0).to(
            torch.bfloat16).float().numpy()             # bf16-exact scales
        inp[f"dec_{name}8"] = np.clip(np.round(x / scale[..., None]),
                                      -127, 127).astype(np.int8)
        inp[f"dec_{name}s"] = scale
    inp["smp_logits"] = rng.standard_normal((B, V)).astype(np.float32) * 4
    for n_data in (1, 2):
        inp[f"smp_noise_{n_data}"] = np.asarray(jax.random.gumbel(
            jax.random.PRNGKey(7), (B // n_data, TOP_K), jnp.float32))
    inp["i8_x"] = (rng.standard_normal((4, 1024)) *
                   np.asarray([1.0, 0.5, 3.0, 1e-3])[:, None]
                   ).astype(np.float32)
    cfg = ref_configs.get_smoke("smollm_360m").replace(num_layers=2)
    params, _, _ = ref_init(RRun(model=cfg), jax.random.PRNGKey(0))
    inp.update({"w/" + k: v for k, v in _flat_numpy(params).items()})
    cfg = ref_configs.get_smoke("mistral_nemo_12b").replace(num_layers=2)
    params, _, _ = ref_init(RRun(model=cfg), jax.random.PRNGKey(1))
    inp.update({"wm/" + k: v for k, v in _flat_numpy(params).items()})
    ds = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=8,
                                          seed=3))
    for case in DP_CASES:
        b = ds.batch(0)
        labels = b["labels"].copy()
        if case == "unequal":       # every rank masks another count
            for row, n in ((0, 3), (2, 9), (3, 32), (5, 17), (6, 1)):
                labels[row, :n] = -1
        inp[f"dp_{case}_tokens"] = b["tokens"]
        inp[f"dp_{case}_labels"] = labels
    inp["ls_prompts"] = np.random.default_rng(1).integers(
        0, configs.get_smoke("smollm_360m").vocab_size, (4, 10))
    inp["ls_noise"] = np.random.default_rng(2).gumbel(
        size=(8, 4, TOP_K)).astype(np.float32)
    return inp


def _compute(d: str) -> None:
    inp_path = os.path.join(d, "inputs.npz")
    np.savez(inp_path, **_inputs())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, inp_path,
         os.path.join(d, "ref.npz"), os.path.join(d, "ref.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    world = subprocess.run([sys.executable, WORLD_SCRIPT, inp_path,
                            os.path.join(d, "world")], env=env,
                           capture_output=True, text=True, timeout=600)
    ref_out, ref_err = ref.communicate(timeout=600)
    assert world.returncode == 0, f"world:\n{world.stdout}\n{world.stderr}"
    assert ref.returncode == 0, f"reference:\n{ref_out}\n{ref_err}"


@pytest.fixture(scope="session")
def run(tmp_path_factory):
    """(inputs, reference npz, reference json, [rank outputs])."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):   # the workers' shared parent
        base = base.parent
    d = str(base / "torch_distributed")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            done = os.path.join(d, "done")
            if os.path.exists(os.path.join(d, "failed")):
                pytest.fail(open(os.path.join(d, "failed")).read())
            if not os.path.exists(done):
                try:
                    _compute(d)
                except Exception as e:
                    with open(os.path.join(d, "failed"), "w") as f:
                        f.write(str(e))
                    raise
                open(done, "w").close()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    ranks = [torch.load(os.path.join(d, "world", f"rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    with open(os.path.join(d, "ref.json")) as f:
        meta = json.load(f)
    return (dict(np.load(os.path.join(d, "inputs.npz"))),
            dict(np.load(os.path.join(d, "ref.npz"))), meta, ranks)


# ---------------------------------------------------------------------------
# sequence-sharded decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES[:2], ids=str)
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_sharded_decode_matches_reference(run, shape, kind):
    """Every rank's rows after the ⊕ over its sequence group, against the
    reference's shard_map (rows 1 and 3 have shards with no valid key)."""
    _, ref, _, ranks = run
    want = ref[f"decode_{kind}_{shape}"]
    for rank, out in enumerate(ranks):
        rows, got = out[f"decode_{kind}_{shape}"]
        np.testing.assert_allclose(got.numpy(), want[rows], rtol=2e-5,
                                   atol=2e-5, err_msg=f"rank {rank}")


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_plain_lse_matches_reference(run, kind):
    """The lse of the kernel's plain version, the local step of every
    shard, against the reference's ``_chunked_fwd_impl`` over the whole
    cache and over one shard of it."""
    inp, ref, _, _ = run
    q = torch.from_numpy(inp["dec_q"])
    k, v, sc = _caches(inp, kind)
    vlen = torch.from_numpy(inp["dec_vlen"])
    _, lse = fd.flash_decode_plain(q, k, v, vlen, chunk_size=16,
                                   return_lse=True, **sc)
    want = ref[f"lse_{kind}"].reshape(B, HQ)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.isinf(lse.numpy()).sum() == 0
    # a shard [48, 64): rows of length 40, 17 and 1 hold no valid key
    vl = (vlen - 48).clamp(0, 16).to(torch.int32)
    _, lse_s = dispatch.decode_attention_lse(
        q, k[:, 48:], v[:, 48:], vl, chunk_size=16, scale=D ** -0.5,
        **{n: t[:, 48:] for n, t in sc.items()})
    assert torch.isneginf(lse_s[1:]).all() and torch.isfinite(lse_s[0]).all()


def _caches(inp, kind):
    if kind == "fp":
        return (torch.from_numpy(inp["dec_k"]), torch.from_numpy(inp["dec_v"]),
                {})
    return (torch.from_numpy(inp["dec_k8"]), torch.from_numpy(inp["dec_v8"]),
            dict(k_scale=torch.from_numpy(inp["dec_ks"]).to(torch.bfloat16),
                 v_scale=torch.from_numpy(inp["dec_vs"]).to(torch.bfloat16)))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_merge_partials_matches_whole_cache(n, kind):
    """The ⊕ of n cache slices, each decoded with its lse, equals the
    decode over the whole cache (the slices past a row's length give
    −inf and weigh nothing)."""
    rng = np.random.default_rng(n)
    inp = {"dec_q": rng.standard_normal((B, 1, HQ, D), np.float32),
           "dec_k": rng.standard_normal((B, S, HKV, D), np.float32),
           "dec_v": rng.standard_normal((B, S, HKV, D), np.float32)}
    for name in ("k", "v"):
        x = inp[f"dec_{name}"]
        s = np.abs(x).max(-1) / 127.0
        inp[f"dec_{name}8"] = np.round(x / s[..., None]).astype(np.int8)
        inp[f"dec_{name}s"] = s.astype(np.float32)
    q = torch.from_numpy(inp["dec_q"])
    k, v, sc = _caches(inp, kind)
    vlen = torch.tensor(VLENS, dtype=torch.int32)
    want = fd.flash_decode_plain(q, k, v, vlen, chunk_size=16, **sc)
    step = S // n
    outs, lses = [], []
    for i in range(n):
        cut = slice(i * step, (i + 1) * step)
        o, lse = dispatch.decode_attention_lse(
            q, k[:, cut], v[:, cut], (vlen - i * step).clamp(0, step),
            chunk_size=16, scale=D ** -0.5,
            **{name: t[:, cut] for name, t in sc.items()})
        outs.append(o)
        lses.append(lse)
    got = merge_partials(torch.stack(outs), torch.stack(lses))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# vocabulary-sharded sampling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESHES[:2], ids=str)
def test_sharded_sample_matches_reference(run, shape):
    """Probabilities against the reference's with its Gumbels injected;
    tokens equal, and the same on every rank of a vocabulary group."""
    _, ref, _, ranks = run
    for rank, out in enumerate(ranks):
        rows, tok, probs, every = out[f"sample_{shape}"]
        np.testing.assert_allclose(probs.numpy(),
                                   ref[f"sample_probs_{shape}"][rows],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tok.numpy(),
                                      ref[f"sample_tok_{shape}"][rows])
        n_model = shape[1]
        group = (rank // n_model) * n_model
        for other in range(group, group + n_model):
            assert torch.equal(every[other], tok), (rank, other)


def test_sharded_sample_generator_draws_the_whole_batch(run):
    """With a generator seeded alike on every rank, the rows' tokens are
    one process's, sampling the whole batch with that generator."""
    from repro_torch.core.topk_fusion import topk_sample
    inp, _, _, ranks = run
    want, _ = topk_sample(torch.from_numpy(inp["smp_logits"]), TOP_K,
                          generator=torch.Generator().manual_seed(5))
    for out in ranks:
        rows, tok = out["sample_generator"]
        assert torch.equal(tok, want[rows])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def test_int8_allreduce_matches_reference(run):
    """Each rank's int8 values and scale equal the reference's
    ``_quantize`` exactly; the mean within 1e-6 of the reference's
    dequantized mean; a replicated input against the reference's
    ``int8_allreduce`` over 4 devices."""
    inp, ref, _, ranks = run
    xs = inp["i8_x"]
    quant = [RC._quantize(jnp.asarray(x)) for x in xs]
    mean = np.asarray(jnp.mean(jnp.stack(
        [RC._dequantize(q, s) for q, s in quant]), axis=0))
    for rank, out in enumerate(ranks):
        q, scale, got = out["int8_own"]
        np.testing.assert_array_equal(q.numpy(), np.asarray(quant[rank][0]))
        assert float(scale) == float(quant[rank][1])
        np.testing.assert_allclose(got.numpy(), mean, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["int8_replicated"].numpy(),
                                   ref["int8_replicated"], rtol=1e-6,
                                   atol=1e-6)


def test_error_feedback_forms_match_reference():
    """ef_compress / ef_decompress / ef_roundtrip over two steps against
    the reference's: int8 values exact, fp32 within 1e-7."""
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((16, 8)).astype(np.float32),
             "b": [rng.standard_normal(33).astype(np.float32) * 1e-3,
                   np.zeros(5, np.float32)]}
    port_g = tree.map(torch.from_numpy, grads)
    ref_g = jax.tree.map(jnp.asarray, grads)
    err, ref_err = compression.ef_init(port_g), RC.ef_init(ref_g)
    for step in range(2):
        qs, scales, new_err = compression.ef_compress(port_g, err)
        rq, rs, rerr = RC.ef_compress(ref_g, ref_err)
        for got, want in zip(tree.leaves(qs), jax.tree.leaves(rq)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tree.leaves(scales) + tree.leaves(new_err),
                             jax.tree.leaves(rs) + jax.tree.leaves(rerr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-7, atol=1e-7)
        deq = compression.ef_decompress(qs, scales)
        for got, want in zip(tree.leaves(deq),
                             jax.tree.leaves(RC.ef_decompress(rq, rs))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-7, atol=1e-7)
        rt, rt_err = compression.ef_roundtrip(port_g, err)
        ref_rt, ref_rt_err = RC.ef_roundtrip(ref_g, ref_err)
        for got, want in zip(tree.leaves(rt) + tree.leaves(rt_err),
                             jax.tree.leaves(ref_rt)
                             + jax.tree.leaves(ref_rt_err)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-7, atol=1e-7)
        err, ref_err = new_err, rerr


# ---------------------------------------------------------------------------
# placements and the loader
# ---------------------------------------------------------------------------
def _jsonable(p):
    return json.loads(json.dumps(p))


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", PLACEMENT_ARCHS)
def test_placements_match_reference(run, arch, shape):
    """Every leaf's parameter, optimizer and FSDP placement, its data-axis
    placement at any size, and the batch placement equal the reference's
    ``PartitionSpec``s as tuples, and ``derive_parallel``'s fields equal
    the reference's."""
    _, _, meta, _ = run
    want = meta[f"{arch} {shape}"]
    cfg = configs.get_smoke(arch)
    sizes = dict(zip(("data", "model"), shape))
    par = sharding.derive_parallel(cfg, sizes)
    assert _jsonable(dict(data_axes=par.data_axes,
                          model_axis=par.model_axis,
                          attn_mode=par.attn_mode)) == want["par"]
    leaves = want["leaves"]
    axes = {k: tuple(v["axes"]) for k, v in leaves.items()}
    like = {k: torch.empty(v["shape"], device="meta")
            for k, v in leaves.items()}
    p_sh = sharding.param_sharding(axes, cfg, par, sizes)
    o_sh = sharding.optimizer_sharding(p_sh, like, sizes, par)
    f_sh = sharding.fsdp_param_sharding(p_sh, like, sizes, par)
    for key, w in leaves.items():
        assert _jsonable(p_sh[key]) == w["param"], key
        assert _jsonable(o_sh[key]) == w["opt"], key
        assert _jsonable(f_sh[key]) == w["fsdp"], key
        # the smoke leaves are under the ZeRO threshold: place the data
        # axis on every one, as a full-size leaf would take it
        assert _jsonable(sharding.add_data_axis(
            p_sh[key], tuple(w["shape"]), sizes, par,
            min_bytes=0)) == w["data"], key
    assert _jsonable(sharding.batch_spec(par)) == want["batch"]


def test_host_sharded_loader_matches_reference():
    cfg = dict(vocab_size=512, seq_len=16, global_batch=8, seed=3)
    for hosts in (1, 2, 4):
        for host in range(hosts):
            ours = HostShardedLoader(SyntheticDataset(SyntheticConfig(**cfg)),
                                     host, hosts)
            ref = RD.HostShardedLoader(RD.SyntheticDataset(
                RD.SyntheticConfig(**cfg)), host, hosts)
            for step in (0, 5):
                got, want = ours.local_batch(step), ref.local_batch(step)
                assert sorted(got) == sorted(want)
                for k in got:
                    np.testing.assert_array_equal(got[k], want[k])
                assert ours.batch(step)["tokens"].shape == (8 // hosts, 16)


# ---------------------------------------------------------------------------
# the data-parallel train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", DP_CASES)
def test_data_parallel_step_matches_single_process(run, case):
    """One step of 4 ranks on quarter batches (mesh (4, 1)) against the
    single-process step on the whole batch, every rank ending identical.
    "unequal" masks another number of labels on every rank, which a plain
    average of per-rank means would get wrong.

    fp32 ("equal", "unequal"): the loss within 1e-6 relative; the gradients
    AdamW takes within 1e-6 of each leaf's largest; the parameters within
    1e-6 relative wherever |g| > 1e-3.  Adam's first step moves an entry by
    lr·g / (|g| + eps) whatever |g| is, so an entry whose gradient is within
    a few eps (1e-8) of 0 moves by an amount its last bits decide (the
    ranks sum in another order than one process); there the bound is 2·lr.
    "bf16" all-reduces bf16 gradients (gloo takes them): each of the three
    bf16 additions rounds, where one process casts its fp32 sum once, so the
    gradients agree within 2⁻⁵ of each leaf's largest and the parameters
    within the lr-scaled bound of ``tests/test_torch_training.py``."""
    _, _, _, ranks = run
    want, want_loss, want_g = ranks[0][f"single_{case}"]
    for rank, out in enumerate(ranks):
        got, loss, same, _ = out[f"dp_{case}"]
        assert same, f"rank {rank}: the ranks' parameters differ"
        np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    got, _, _, got_g = ranks[0][f"dp_{case}"]
    assert sorted(got) == sorted(want) == sorted(got_g) == sorted(want_g)
    lr = 1e-3
    for path in got:
        g, w = got[path].numpy(), want[path].numpy()
        dg = got_g[path].float().numpy()
        wg = want_g[path].float().numpy()
        scale = max(float(np.abs(wg).max()), 1e-30)
        diff = np.abs(g - w)
        if case == "bf16":
            assert np.abs(dg - wg).max() <= 2 ** -5 * scale, path
            assert diff.max() <= 2 * lr + 1e-6, (path, diff.max())
            assert (diff > 1e-5).mean() <= 0.01, path
            continue
        np.testing.assert_allclose(dg, wg, rtol=0, atol=1e-6 * scale,
                                   err_msg=path)
        big = np.abs(wg) > 1e-3
        np.testing.assert_allclose(g[big], w[big], rtol=1e-6, atol=1e-9,
                                   err_msg=path)
        assert diff.max() <= 2 * lr, (path, diff.max())


@pytest.mark.parametrize("case", DP_CASES)
def test_data_parallel_step_matches_reference(run, case):
    """The same step against the reference's ``make_train_step`` on the
    whole batch, from the same weights: the loss within 1e-5, the
    parameters within the lr-scaled bound of the single-process tests."""
    _, ref, _, ranks = run
    got, loss, _, _ = ranks[0][f"dp_{case}"]
    np.testing.assert_allclose(loss, float(ref[f"train_loss_{case}"]),
                               rtol=1e-5)
    ref_flat = {}
    for key, v in ref.items():
        if key.startswith(f"train_{case}:"):
            path = key.split(":", 1)[1]
            ref_flat["/".join(p.strip("[]'") for p in path.split("]["))] = v
    want = dict(tree.leaves_with_path(params_from_numpy(
        _unflat(ref_flat), device="cpu")))
    assert sorted(got) == sorted(want)
    for path in got:
        diff = np.abs(got[path].numpy() - want[path].numpy())
        assert diff.max() <= 2 * 1e-3 + 1e-6, (path, diff.max())
        assert (diff > 1e-5).mean() <= 0.01, (path, (diff > 1e-5).mean())


# ---------------------------------------------------------------------------
# serving under a context, the CLI, refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("what", ["fp_(1, 4)", "fp_(2, 2)", "int8_(1, 4)"])
def test_lockstep_under_context_equals_unsharded(run, what):
    """The lockstep loop of the smoke smollm (B 4, 8 tokens, caches of 20
    split 4 ways or 2) under a context gives each rank the rows of the
    unsharded port run under the same injected noise."""
    _, _, _, ranks = run
    kind = what.split("_")[0]
    want = ranks[1 if kind == "fp" else 2][f"lockstep_single_{kind}"]
    for rank, out in enumerate(ranks):
        rows, ids = out[f"lockstep_{what}"]
        np.testing.assert_array_equal(ids, want[rows],
                                      err_msg=f"rank {rank}")


def test_train_cli_mesh_in_a_gloo_world(run):
    """``launch.train --mesh 4x1 --device cpu``: 2 steps on every rank, the
    same losses, and rank 0 alone saves (its final checkpoint)."""
    _, _, _, ranks = run
    saves = [out["cli"][0] for out in ranks]
    assert saves == [[2], [], [], []]
    losses = [out["cli"][1] for out in ranks]
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert all(l == losses[0] for l in losses)


def test_process_group_and_mesh_refusals(run):
    """In a gloo world: ``--device cpu`` takes gloo; a CUDA run neither
    falls back to gloo nor to the CPU (here: no card, so it raises); a mesh
    that does not match the world size raises."""
    _, _, _, ranks = run
    for out in ranks:
        r = out["refusals"]
        assert tuple(r["cpu"]) == ("gloo", "cpu", False)   # the world's
        assert r["cuda"].startswith("RuntimeError") and "CUDA" in r["cuda"]
        assert r["mesh 2x4"].startswith("ValueError") and "8 ranks" in \
            r["mesh 2x4"]


def test_routes_refused_under_a_context():
    """Under a ShardContext the paged routes and MLA's latent decode raise
    (the reference's words for the paged one); a CUDA run of the launcher
    with no card raises before it initialises anything."""
    from repro_torch.launch import train
    cfg = configs.get_smoke("smollm_360m")
    q = torch.zeros(1, 1, 4, 16)
    pool = torch.zeros(2, 2, 4, 16)
    ctx = context.ShardContext(mesh=None, par=ParallelConfig())
    with context.use(ctx):
        for decode in (True, False):
            with pytest.raises(NotImplementedError,
                               match="paged KV attention has no sharded"):
                dispatch.sdpa(cfg, q, pool, pool, causal=False, q_offset=0,
                              kv_valid_len=torch.tensor([3]), decode=decode,
                              block_tables=torch.zeros(1, 1, dtype=torch.int32))
        with pytest.raises(NotImplementedError, match="MLA"):
            dispatch.mla_attention(cfg, q, q, pool[0], pool[0], causal=False,
                                   q_offset=0, kv_valid_len=torch.tensor([3]),
                                   scale=1.0, decode=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.process_group("cuda")
    with pytest.raises(NotImplementedError, match="model axis"):
        train.parse_args(["--arch", "qwen2_moe_a2p7b", "--mesh", "1x2"])
    assert train.parse_args(["--arch", "smollm_360m", "--mesh", "1x2"]).mesh \
        == "1x2"


# ---------------------------------------------------------------------------
# the model axis: tensor-parallel training of the dense decoders
# ---------------------------------------------------------------------------
MODEL_AXIS_CASES = ("smollm_1x4", "smollm_2x2", "mistral_2x2", "mistral_1x4",
                    "smollm_block_1x4")
MODEL_AXIS_MODES = {"smollm": "sequence", "mistral": "heads"}


def _model_axis_single(ranks, name):
    return (ranks[1]["single_mistral"] if name.startswith("mistral")
            else ranks[0]["single_equal"])


@pytest.mark.parametrize("name", MODEL_AXIS_CASES)
def test_model_axis_step_matches_unsharded(run, name):
    """One step on the model axis from the full fp32 weights, every rank
    holding its shards (smollm's 3 heads in sequence mode at (1, 4) and
    (2, 2), mistral-nemo's 4 heads in heads mode with its kv heads sharded
    at (2, 2) and expanded at (1, 4), remat "block" at (1, 4)), against
    the port's unsharded step on the whole batch: the loss on every rank
    within 1e-5 relative; the gathered gradients AdamW took, and the
    gathered parameters after it, within 1e-5 of each leaf's largest
    entry.  Adam's first step moves an entry by lr·g / (|g| + eps): where
    |g| is within a few hundred eps (1e-8) of 0 the last bits of g, which
    the ranks sum in another order, decide the move, so there the
    parameters are held to Adam's bound of 2·lr instead (as the
    data-parallel step's test does)."""
    _, _, _, ranks = run
    want, want_loss, want_g = _model_axis_single(ranks, name)
    got, _, got_g, mode, counts = ranks[0][f"ma_{name}"]
    assert mode == MODEL_AXIS_MODES[name.split("_")[0]]
    assert counts["all_reduce"] > 0
    assert (counts["all_gather"] > 0) == (mode == "sequence")
    for rank, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"ma_{name}"][1], want_loss,
                                   rtol=1e-5, err_msg=f"rank {rank}")
    assert sorted(got) == sorted(want) == sorted(got_g) == sorted(want_g)
    for path in want:
        wg = want_g[path].float().numpy()
        scale = float(np.abs(wg).max())
        np.testing.assert_allclose(got_g[path].float().numpy(), wg, rtol=0,
                                   atol=1e-5 * scale, err_msg=path)
        g, w = got[path].numpy(), want[path].numpy()
        big = np.abs(wg) > 1e-6
        np.testing.assert_allclose(g[big], w[big], rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=path)
        assert np.abs(g - w).max() <= 2 * 1e-3, path


@pytest.mark.parametrize("name", MODEL_AXIS_CASES)
def test_model_axis_step_matches_reference(run, name):
    """The same step against the reference's unsharded ``make_train_step``
    on the whole batch from the same weights (the reference's own sharded
    step cannot run on this jax; ROADMAP queue 3): the loss within 1e-5,
    the parameters within the bound the data-parallel step's test holds
    them to."""
    _, ref, _, ranks = run
    got, loss, _, _, _ = ranks[0][f"ma_{name}"]
    case = "mistral" if name.startswith("mistral") else "equal"
    np.testing.assert_allclose(
        loss, float(ref["train_loss_" + case]), rtol=1e-5)
    ref_flat = {}
    for key, v in ref.items():
        if key.startswith(f"train_{case}:"):
            path = key.split(":", 1)[1]
            ref_flat["/".join(p.strip("[]'") for p in path.split("]["))] = v
    want = dict(tree.leaves_with_path(params_from_numpy(
        _unflat(ref_flat), device="cpu")))
    assert sorted(got) == sorted(want)
    for path in got:
        diff = np.abs(got[path].numpy() - want[path].numpy())
        assert diff.max() <= 2 * 1e-3 + 1e-6, (path, diff.max())
        assert (diff > 1e-5).mean() <= 0.01, (path, (diff > 1e-5).mean())


def test_model_axis_cli_mesh_2x2(run):
    """``launch.train --mesh 2x2 --device cpu`` (smollm smoke, sequence
    mode): 3 steps, the same losses on every rank, each within 1e-5
    relative of the unsharded run's on the same flags."""
    _, _, _, ranks = run
    want = ranks[0]["ma_cli_single"]
    got = [out["ma_cli"] for out in ranks]
    assert len(want) == 3 and all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


def test_model_axis_crash_restart_is_exact(run):
    """``--mesh 2x2``: killed at step 3 after the step-2 checkpoint (the
    full state gathered and written by rank 0) and restarted, every rank's
    final shards equal an uninterrupted 4-step run's bit for bit."""
    _, _, _, ranks = run
    for rank, out in enumerate(ranks):
        crashed, steps, same = out["ma_restart"]
        assert crashed and steps == [2, 3] and same, rank


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "minicpm3_4b",
                                  "zamba2_1p2b", "whisper_small",
                                  "llava_next_34b"])
def test_model_axis_refuses_other_families(run, arch):
    """``--mesh 1x2`` on an MoE, MLA, recurrent, encoder-decoder or VLM
    config raises ``NotImplementedError`` naming what it lacks."""
    _, _, _, ranks = run
    msg = ranks[0]["ma_refusals"][arch]
    assert msg.startswith("NotImplementedError") and "lacks" in msg, msg
