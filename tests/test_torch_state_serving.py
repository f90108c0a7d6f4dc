"""The recurrent decoders (zamba2-1.2b's Mamba2 stack with its shared
attention block, xlstm-125m's mLSTM / sLSTM stack) in the port against the
JAX package, on the CPU, at their smoke configs.

* ``configs.get`` / ``get_smoke`` field for field (``SSMConfig`` /
  ``XLSTMConfig`` included) under both names, ``block_pattern`` at both
  sizes, and ``layer_plan``'s map from layers to cache leaves.
* ``init``'s leaves in the reference's shapes and dtypes, the fp32 leaves
  kept by ``params_to``, and ``params_from_numpy`` of the reference's
  stacked segments and shared block.
* The whole model: hidden states and last-position logits of
  ``transformer.forward`` / ``logits_last`` against the reference's; the
  caches after ``engine.prefill``, mapped from the reference's segment
  list onto the port's flat leaves.
* Serving: the token streams of the lockstep batch, the slot pool and the
  paged state pool, under the reference's noise, each equal to the
  reference's solo run of that request (chunked prefill, then batch-1
  decode steps); a paged run shares and copies no block and returns every
  block; the prompt-quantum ``ValueError``; a state row swapped out and back
  bit for bit, and a preempting run whose streams equal the reference
  scheduler's; ``decode_step_cost`` against a hand count.

Tolerances: float32 everywhere (TF32 does not exist on the CPU); the
packages compute the same math with other contraction orders, so float
results agree to rtol 1e-5 and atol 1e-5 · max|reference| (``_close``, the
whole-model values through 5 and 4 layers to 1e-4), and token streams
exactly.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import dataclasses
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
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer, xlstm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs import kernels as obs_kernels  # noqa: E402
from repro_torch.serving import cache_family, engine, scheduler  # noqa: E402
from repro_torch.serving.paged import PagedPool  # noqa: E402

ARCHS = ("zamba2_1p2b", "xlstm_125m")
SLOT_LEN, BLOCK, CHUNK, TOP_K = 48, 8, 8, 5
BASE_KEY = jax.random.PRNGKey(7)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()),
                                               1e-30))


def _key(rid, i):
    return jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)


def ref_noise(rid, i, k):
    """The reference's per-(request, token) Gumbel draw."""
    return np.array(jax.random.gumbel(_key(rid, i), (k,), jnp.float32))


@functools.partial(jax.jit, static_argnums=1)
def _ref_init(key, cfg_ref):
    return RL.split_params(RT.init(key, cfg_ref))[0]


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference params, reference cfg, port params, port cfg) of the
    smoke config: the same weights, from the reference's ``init``.  The
    SSD's ``a_log`` is set off zero, so its heads decay apart."""
    cfg_ref, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    params_ref = _ref_init(jax.random.PRNGKey(0), cfg_ref)
    for seg in params_ref["segments"]:
        if "mamba" in seg:
            a = seg["mamba"]["a_log"]
            seg["mamba"]["a_log"] = jnp.broadcast_to(
                jnp.linspace(-1.0, 1.0, a.shape[-1]), a.shape)
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), cfg


@functools.lru_cache(maxsize=None)
def _ref_steps(arch):
    """The reference's jitted solo-run pieces: a single-shot prefill of one
    prompt (``chunked_prefill``, compiled per length) and a batch-1
    ``decode_step_slots``."""
    params_ref, cfg_ref, _, _ = _models(arch)
    prefill = jax.jit(lambda p, toks: RE.chunked_prefill(
        p, toks, cfg_ref, max_len=SLOT_LEN, chunk=CHUNK))
    decode = jax.jit(lambda p, c, ln, tok, keys: RE.decode_step_slots(
        p, c, ln, tok, cfg_ref, rngs=keys, top_k=TOP_K))
    logits = jax.jit(lambda p, h: RE.logits_from_hidden(p, h, cfg_ref))
    return prefill, decode, logits


def _ref_solo(arch, prompt, rid, n_tokens):
    """The reference's solo run of one request: its prompt prefilled alone,
    then batch-1 decode steps, each token sampled with key (rid, i)."""
    params_ref = _models(arch)[0]
    prefill, decode, logits = _ref_steps(arch)
    last, caches, ln = prefill(params_ref, jnp.asarray(prompt)[None])
    tok = RE.sample_per_slot(_key(rid, 0)[None],
                             logits(params_ref, last), TOP_K)
    out = [int(tok[0])]
    lens = jnp.asarray([int(ln)], jnp.int32)
    for i in range(1, n_tokens):
        tok, caches, lens = decode(params_ref, caches, lens, tok[:, None],
                                   _key(rid, i)[None])
        out.append(int(tok[0]))
    return out


# ---------------------------------------------------------------------------
# Configs, patterns, init and convert.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_patterns_match_reference(arch, which):
    """Both names give the reference's numbers field for field, the
    sub-config included, and the reference's segment pattern: zamba2's 7
    shared-block calls after 6+6+6+6+6+6+2 mamba layers, xlstm's sLSTM at
    layers 5 and 11."""
    ref = getattr(ref_configs, which)(arch)
    for name in (arch, ref.name.replace("-smoke", "")):
        mine = getattr(configs, which)(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    sub = mine.ssm if arch == "zamba2_1p2b" else mine.xlstm
    assert isinstance(sub, (configs.SSMConfig, configs.XLSTMConfig))
    assert transformer.block_pattern(mine) == RT.block_pattern(ref)
    plan = transformer.layer_plan(mine)
    if which == "get" and arch == "zamba2_1p2b":
        assert [c for k, c in RT.block_pattern(ref) if k == "mamba"] == \
            [6, 6, 6, 6, 6, 6, 2]
        assert transformer.layer_counts(mine) == {"mamba": 38, "attn": 7}
        assert [j for k, i, j in plan if k == "shared_attn"] == \
            list(range(7))
    if which == "get" and arch == "xlstm_125m":
        assert [n for n, (k, _, _) in enumerate(plan) if k == "slstm"] == \
            [5, 11]
        assert transformer.layer_counts(mine) == {"mlstm": 10, "slstm": 2}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_convert_match_reference(arch):
    """``init`` draws every leaf of the reference's tree in its shape and
    dtype (zamba2's shared block once), ``params_to`` keeps the reference's
    fp32 leaves fp32 in a bf16 copy, and ``params_from_numpy`` carries the
    reference's values into the same layout."""
    params_ref, _, params, cfg = _models(arch)
    mine = transformer.init(cfg, seed=0, device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda x: tuple(x.shape), tree)
    assert shapes(mine) == shapes(params)
    big = transformer.params_to(mine, "cpu", torch.bfloat16)
    ref16 = jax.eval_shape(lambda k: RL.split_params(RT.init(
        k, ref_configs.get_smoke(arch).replace(dtype="bfloat16")))[0],
        jax.random.PRNGKey(0))
    port16 = params_from_numpy(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32 if s.dtype == jnp.float32
                           else np.float16), ref16), device="cpu")
    want = jax.tree.map(lambda x: x.dtype == torch.float32, port16)
    assert jax.tree.map(lambda x: x.dtype == torch.float32, big) == want
    assert any(jax.tree.leaves(want)) and not all(jax.tree.leaves(want))
    seg = params_ref["segments"][0]
    first = params["layers"][0]
    if arch == "zamba2_1p2b":
        np.testing.assert_array_equal(first["mamba"]["w_zx"].numpy(),
                                      np.asarray(seg["mamba"]["w_zx"])[0])
        np.testing.assert_array_equal(
            params["shared_attn"]["attn"]["wq"].numpy(),
            np.asarray(params_ref["shared_attn"]["attn"]["wq"]))
        assert len(params["layers"]) == cfg.num_layers
    else:
        np.testing.assert_array_equal(first["wq"].numpy(),
                                      np.asarray(seg["wq"])[0])


# ---------------------------------------------------------------------------
# The whole model.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits_match_reference(arch):
    """Hidden states of a 2 x 32 batch (two scan chunks) and the last
    position's logits against the reference's."""
    params_ref, cfg_ref, params, cfg = _models(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    h_ref, _, _ = jax.jit(lambda p, t: RT.forward(p, t, cfg_ref))(
        params_ref, jnp.asarray(toks))
    h, _ = transformer.forward(params, _t(toks), cfg)
    _close(h.numpy(), h_ref, rtol=1e-4)
    _close(transformer.logits_last(params, h, cfg).numpy(),
           RT.logits_last(params_ref, h_ref, cfg_ref), rtol=1e-4)


def _flat_ref_caches(cfg_ref, segs) -> dict:
    """The reference's per-segment cache list as the port's flat leaves:
    each recurrent kind's stacked leaves joined along the layer axis, the
    shared block's unstacked K/V stacked call by call."""
    out: dict = {}
    for (kind, _), c in zip(RT.block_pattern(cfg_ref), segs):
        if kind == "shared_attn":
            leaves = {k: np.asarray(v)[None] for k, v in c["attn"].items()}
        elif kind == "mamba":
            leaves = {k: np.asarray(v) for k, v in c.items()}
        elif kind == "mlstm":
            leaves = {**dict(zip(("m", "C", "n"),
                                 map(np.asarray, c["mlstm"]))),
                      "conv": np.asarray(c["conv"])}
        else:
            leaves = dict(zip(xlstm.SLSTM_LEAVES,
                              map(np.asarray, c["slstm"])))
        for k, v in leaves.items():
            out[k] = v if k not in out else np.concatenate([out[k], v])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_reference(arch):
    """``engine.prefill`` of a 2 x 16 batch into fresh caches of 24: the
    last hidden state, and every leaf of the port's flat cache against the
    reference's segment caches mapped onto it (zamba2: ``ssm`` [5, ...],
    the conv tails, the 3 shared calls' K/V; xlstm: m, C, n, conv [2, ...]
    and the sLSTM's four vectors [2, ...])."""
    params_ref, cfg_ref, params, cfg = _models(arch)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    last_ref, caches_ref, _ = jax.jit(lambda p, t: RE.prefill(
        p, t, cfg_ref, max_len=24))(params_ref, jnp.asarray(toks))
    last, caches, n = engine.prefill(params, _t(toks), cfg, max_len=24)
    assert n == 16
    _close(last.numpy(), last_ref, rtol=1e-4)
    want = _flat_ref_caches(cfg_ref, caches_ref)
    assert set(caches) == set(want)
    for k, w in want.items():
        assert tuple(caches[k].shape) == w.shape, k
        if np.isinf(w).any():
            np.testing.assert_array_equal(np.isinf(caches[k].numpy()),
                                          np.isinf(w))
            w = np.where(np.isinf(w), 0.0, w)
            _close(np.where(np.isinf(caches[k].numpy()), 0.0,
                            caches[k].numpy()), w, rtol=1e-4)
        else:
            _close(caches[k].numpy(), w, rtol=1e-4)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
def _requests(mod, cfg, quantum):
    """Three quantum-compliant prompts (q/2, q, 3q/4 tokens) arriving a
    tick apart, the reference test's workload."""
    rng = np.random.default_rng(11)
    lens = (quantum // 2, quantum, quantum // 4 * 3)
    return [mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                        max_new_tokens=d, arrival_tick=i)
            for i, (n, d) in enumerate(zip(lens, (5, 4, 6)))]


@pytest.mark.parametrize("path", ["slot_pool", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streams_equal_reference_solo(arch, path):
    """The slot pool and the paged state pool (2 slots, 3 requests): every
    stream equals the reference's solo run of that request under its noise;
    each prompt prefills in one chunk; paged, no block is shared or copied
    and every block comes back."""
    _, _, params, cfg = _models(arch)
    fam = cache_family.resolve(cfg)
    assert fam.kind == "state" and fam.single_shot_prefill
    assert not fam.shareable and engine.paged_supported(cfg)
    requests = _requests(scheduler, cfg, fam.prompt_quantum())
    kw = dict(paged=True, block_size=BLOCK) if path == "paged" else {}
    sched = scheduler.ContinuousScheduler(
        params, cfg, num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
        top_k=TOP_K, noise_fn=ref_noise, device="cpu", **kw)
    report = sched.run(requests)
    got = {r.rid: r.tokens for r in report.results}
    for req in requests:
        assert got[req.rid] == _ref_solo(arch, req.prompt, req.rid,
                                         req.max_new_tokens), req.rid
    assert len({t for s in got.values() for t in s}) > 1
    assert sched.prefill_chunks == len(requests)
    if path == "paged":
        p = report.paged
        assert p["blocks_shared"] == 0 and p["cow_copies"] == 0
        assert p["free_blocks"] == p["num_blocks"] == 2
        assert p["cached_blocks"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_streams_equal_reference_solo(arch):
    """The lockstep loop over two 16-token prompts, row b sampled with the
    reference's noise of request b: each row's ids equal the reference's
    solo run of that prompt."""
    _, _, params, cfg = _models(arch)
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "16",
                             "--tokens", "5", "--max-len", str(SLOT_LEN)])
    prompts = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 16))
    ids = serve.lockstep(args, cfg, params, prompts=prompts,
                         noise_fn=lambda i: np.stack(
                             [ref_noise(b, i, TOP_K) for b in range(2)]))
    for b in range(2):
        assert ids[b].tolist() == _ref_solo(arch, prompts[b], b, 5), b


def test_prompt_quantum_enforced():
    """A prompt longer than the scan's quantum and no multiple of it is
    refused with the reference's ``ValueError``, paged or not; the CLI's
    workload snaps its prompts to the quantum."""
    _, _, params, cfg = _models("zamba2_1p2b")
    q = cache_family.resolve(cfg).prompt_quantum()
    assert q == 16
    for kw in ({}, dict(paged=True, block_size=BLOCK)):
        sched = scheduler.ContinuousScheduler(
            params, cfg, num_slots=2, slot_len=SLOT_LEN, top_k=TOP_K,
            device="cpu", **kw)
        with pytest.raises(ValueError, match=f"multiple of {q}"):
            sched.submit(scheduler.Request(
                rid=0, prompt=np.zeros(q + 1, np.int64), max_new_tokens=2))
    args = serve.parse_args(["--arch", "zamba2_1p2b", "--smoke",
                             "--continuous", "--prompt-len", "60"])
    requests, _ = serve.workload(args, cfg)
    lens = [len(r.prompt) for r in requests]
    assert all(n <= q or n % q == 0 for n in lens) and max(lens) > q


@pytest.mark.parametrize("arch", ARCHS)
def test_state_row_swaps_out_and_back_bit_exact(arch):
    """A paged state row installed from a prefill, swapped out to the host
    and back into another block: every leaf of the row equals what was
    installed, bit for bit, and the freed block is reused."""
    _, _, params, cfg = _models(arch)
    pool = PagedPool(cfg, 2, SLOT_LEN, BLOCK, num_blocks=2, device="cpu")
    seq = pool.admit(np.arange(8))
    _, caches, n = engine.prefill(params, _t(np.arange(8)[None]), cfg,
                                  max_len=SLOT_LEN)
    pool.install_state(seq, caches)
    pool.lens[seq.slot] = n
    row = {k: v[:, seq.blocks[0]].clone() for k, v in pool.caches.items()}
    for k, v in row.items():
        assert torch.equal(v, caches[k][:, 0]), k
    pool.swap_out(seq.slot, rid=0)
    other = pool.admit(np.arange(4))          # takes the freed block
    for v in pool.caches.values():
        v[:, other.blocks[0]] = 0
    back = pool.swap_in(0)
    assert back is not None and pool.lens[back.slot] == n
    for k, v in row.items():
        assert torch.equal(pool.caches[k][:, back.blocks[0]], v), k
    assert pool.stats()["swapped_blocks_in"] == 1


def test_preempting_run_equals_reference_scheduler():
    """Two priority classes over a pool of 2 state rows: the reference
    scheduler preempts, and the port's streams, preemption count and pool
    stats (swapped blocks out and in) equal the reference's."""
    params_ref, cfg_ref, params, cfg = _models("xlstm_125m")
    rng = np.random.default_rng(5)
    spec = [(8, 12, 0, 1), (16, 12, 0, 1), (4, 3, 4, 0), (12, 3, 5, 0)]

    def reqs(mod):
        return [mod.Request(rid=i, prompt=rng_prompts[i], max_new_tokens=d,
                            arrival_tick=t, priority=pr)
                for i, (_, d, t, pr) in enumerate(spec)]
    rng_prompts = [rng.integers(0, cfg.vocab_size, n) for n, *_ in spec]
    geom = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
                top_k=TOP_K, paged=True, block_size=BLOCK, num_blocks=2)
    ref = RS.ContinuousScheduler(params_ref, cfg_ref, base_rng=BASE_KEY,
                                 **geom)
    want = ref.run(reqs(RS))
    mine = scheduler.ContinuousScheduler(params, cfg, noise_fn=ref_noise,
                                         device="cpu", **geom)
    got = mine.run(reqs(scheduler))
    assert want.preemptions >= 1
    assert got.preemptions == want.preemptions
    assert {r.rid: r.tokens for r in got.results} == \
        {r.rid: r.tokens for r in want.results}
    for k in ("swapped_blocks_out", "swapped_blocks_in", "free_blocks",
              "blocks_shared", "cow_copies"):
        assert got.paged[k] == want.paged[k], k


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_cost_hand_counted(arch):
    """``decode_step_cost`` of a smoke config at B 3 over live lengths
    [5, 2] against a hand count: zamba2's 5 mamba layers (projections, the
    SSD state's 5·H·N·P flops and fp32 read and write, the conv tails) and
    its 3 shared-block calls (the dense layer's weights each call, the
    attention over its own live K/V); xlstm's 2 mLSTM layers (projections,
    C and n) and 2 sLSTM layers (gate and recurrent products, the gated
    MLP, four state vectors); the LM head and the fp32 logits."""
    cfg = configs.get_smoke(arch)
    b, live = 3, 7
    d, v = cfg.d_model, cfg.vocab_size
    head_f, head_b = 2 * d * v * b, d * v * 4 + b * v * 4
    if arch == "zamba2_1p2b":
        # inner 128, H 8, N 8, P 16, conv width 4, d_ff 128, 4 heads of 16
        proj = d * 256 + d * 16 + d * 8 + 128 * d
        state = 8 * 8 * 16
        tails = 3 * (128 + 16)
        mamba_f = 5 * (2 * proj * b + 5 * state * b + 2 * 4 * 144 * b)
        mamba_b = 5 * (proj * 4 + 2 * b * (state * 4 + tails * 4))
        dense = 4 * d * 64 + 3 * d * 128
        attn_f = 3 * (2 * dense * b + 4 * 4 * 16 * live)
        attn_b = 3 * dense * 4 + 3 * live * 2 * 4 * 16 * 4
        flops, nbytes = mamba_f + attn_f, mamba_b + attn_b
    else:
        # inner 128, 2 heads of 64, conv width 4; sLSTM heads of 32, f_up 64
        proj = d * 256 + 3 * 128 * 128 + 128 * d
        w_if = 128 * 4
        state = 2 * 64 * 64 + 2 * 64
        m_f = 2 * (2 * (proj + w_if) * b + 2 * 4 * 128 * b
                   + 6 * 2 * 64 * 64 * b + 6 * 2 * 64 * b)
        m_b = 2 * (proj * 4 + w_if * 4
                   + 2 * b * (state * 4 + 2 * 4 + 3 * 128 * 4))
        gates, rec, mlp = d * 4 * d, 4 * 2 * 32 * 32, 3 * d * 64
        s_f = 2 * (2 * (gates + rec + mlp) * b)
        s_b = 2 * ((gates + rec) * 4 + mlp * 4 + 2 * b * 4 * d * 4)
        flops, nbytes = m_f + s_f, m_b + s_b
    cost = obs_kernels.decode_step_cost(cfg, b, [5, 2])
    assert cost["flops"] == flops + head_f
    assert cost["bytes_accessed"] == nbytes + head_b
