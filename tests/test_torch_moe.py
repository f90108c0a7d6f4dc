"""The MoE decoders (qwen2-moe-a2.7b, llama4-scout-17b-a16e) in the port
against the JAX package, on the CPU.

* ``configs.get`` / ``get_smoke`` for both architectures, field for field,
  the ``MoEConfig`` included.
* ``layers.moe_apply`` against ``repro.models.layers.moe_apply`` on the
  same weights and inputs: outputs and both aux losses within 1e-5, the
  router's top-k indices and the kept / dropped assignments exactly, at
  the smoke configs' own capacity and at a capacity factor of 0.5, where
  assignments drop.
* ``init`` and ``convert`` of the ``moe`` leaves (router, experts, shared
  expert), and ``loss_fn`` with its aux terms and the router's gradient.
* Both smoke configs end to end: the paged, slot-pool and lockstep streams
  and their int8 forms equal the reference's under the reference's noise,
  and the port's own streams do not depend on batching or prefill chunking
  once nothing can drop.
* The plain attention versions at head_dim 128 with G 1 (qwen2-moe's 16/16
  heads) and G 5 (llama4-scout's 40/8) against the Pallas kernels
  (interpret mode), the planners at the router's and the samplers' shapes
  (pure functions), and ``decode_step_cost`` of the qwen2-moe config
  against a hand count.

Tolerances: float32 everywhere; the packages compute the same math with
other matmul kernels and summation orders, so float results agree to ~1e-5
and indices, masks and sampled token streams exactly.
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
from repro.core import topk_sample as ref_topk_sample  # noqa: E402
from repro.kernels import dispatch as ref_dispatch  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_offset_pallas, flash_attention_paged_pallas)
from repro.kernels.flash_decode import (  # noqa: E402
    flash_decode_pallas, flash_decode_paged_pallas)
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import engine as RE  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import softmax_topk as st  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs import kernels as obs_kernels  # noqa: E402
from repro_torch.serving import cache_family, scheduler  # noqa: E402
from repro_torch.serving.engine_api import Engine  # noqa: E402

ARCHS = ("qwen2_moe_a2p7b", "llama4_scout_17b_a16e")
TOL = dict(rtol=1e-5, atol=1e-5)
TOP_K = 5
BASE_KEY = jax.random.PRNGKey(0)
SLOT_LEN, CHUNK, BLOCK = 40, 8, 8
H100_SMS = 132


def _t(a):
    return torch.from_numpy(np.array(a))


def _with_capacity(cfg, factor):
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=factor))


def ref_noise(rid, i, k):
    """The reference scheduler's per-(request, token) Gumbel draw."""
    key = jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)
    return np.asarray(jax.random.gumbel(key, (k,), jnp.float32))


# The reference's functions are jitted here (its own serving path jits
# them too): an eager call compiles op by op and took most of this file's
# time.
_ref_moe_apply = jax.jit(RL.moe_apply, static_argnums=2)


@functools.partial(jax.jit, static_argnums=1)
def _ref_init(key, cfg_ref):
    return RL.split_params(RT.init(key, cfg_ref))[0]


def _models(arch, **override):
    """(reference params, reference cfg, port params, port cfg) of the
    smoke config (with ``override``): the same weights, from the
    reference's ``transformer.init``, the embedding scaled down so the
    smoke model's streams do not repeat their input token."""
    cfg_ref = ref_configs.get_smoke(arch).replace(**override)
    cfg = configs.get_smoke(arch).replace(**override)
    params_ref = _ref_init(jax.random.PRNGKey(0), cfg_ref)
    params_ref["embedding"]["embed"] = params_ref["embedding"]["embed"] * 0.05
    tree = jax.tree.map(np.asarray, params_ref)
    return params_ref, cfg_ref, params_from_numpy(tree, device="cpu"), cfg


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _models(request.param)


def _moe_leaves(arch, factor=None):
    """One MoE layer's weights from the reference's ``moe_init`` (reference
    and port forms) and the two configs, at capacity ``factor``."""
    cfg_ref, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    if factor is not None:
        cfg_ref, cfg = _with_capacity(cfg_ref, factor), _with_capacity(
            cfg, factor)
    p_ref, _ = RL.split_params(RL.moe_init(jax.random.PRNGKey(3), cfg_ref))

    def port(tree):
        return {k: port(v) if isinstance(v, dict) else _t(v)
                for k, v in tree.items()}
    return p_ref, cfg_ref, port(jax.tree.map(np.asarray, p_ref)), cfg


def _ref_keep(idx, cfg_ref, s):
    """The reference's kept assignments [G, S, K], from its own lines
    (``moe_apply`` at ``src/repro/models/layers.py:510-514``) on its
    router's indices."""
    mc = cfg_ref.moe
    e_pad = mc.pad_experts_to or mc.num_experts
    g, _, k = idx.shape
    cap = max(int(np.ceil(s * k * mc.capacity_factor / mc.num_experts)), 4)
    em = jax.nn.one_hot(idx, e_pad, dtype=jnp.float32).reshape(g, s * k,
                                                               e_pad)
    pos = jnp.cumsum(em, axis=1) * em - 1.0
    keep = ((pos >= 0) & (pos < cap)).any(-1)
    return np.asarray(keep).reshape(g, s, k)


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["get", "get_smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, which):
    """Both names (module and alias) give the reference's numbers, field
    for field, the ``MoEConfig`` too."""
    ref = getattr(ref_configs, which)(arch)
    alias = {"qwen2_moe_a2p7b": "qwen2-moe-a2.7b",
             "llama4_scout_17b_a16e": "llama4-scout-17b-a16e"}[arch]
    for name in (arch, alias):
        mine = getattr(configs, which)(name)
        for f in dataclasses.fields(mine):
            if f.name == "moe":
                assert dataclasses.asdict(mine.moe) == \
                    dataclasses.asdict(ref.moe)
            else:
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.family == "moe"
    assert transformer.block_pattern(mine) == [("moe", mine.num_layers)]
    assert ref.resolved_head_dim == (16 if which == "get_smoke" else 128)


@pytest.mark.parametrize("kv", ["", "int8"])
def test_cache_family_serves_moe_blocks(kv):
    cfg = configs.get_smoke("qwen2_moe_a2p7b").replace(kv_cache_dtype=kv)
    fam = cache_family.resolve(cfg)
    assert fam.name == ("dense_int8" if kv else "dense")


# ---------------------------------------------------------------------------
# moe_apply against the reference.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("factor", [None, 0.5], ids=["own", "cf0.5"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, factor):
    """Outputs and both aux losses within 1e-5, the router's top-k indices
    and the kept / dropped assignments exactly; at a capacity factor of
    0.5 some assignments drop (and the output shows it)."""
    p_ref, cfg_ref, p, cfg = _moe_leaves(arch, factor)
    b, t = 2, 24
    x = np.random.default_rng(0).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    y_ref, aux_ref = _ref_moe_apply(p_ref, jnp.asarray(x), cfg_ref)
    y, aux = L.moe_apply(p, _t(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    assert set(aux) == set(aux_ref) == {"moe_lb_loss", "moe_z_loss"}
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(aux_ref[name]),
                                   **TOL)
    s = min(cfg.moe.group_size, t)
    logits_ref = jnp.asarray(x).reshape(-1, s, cfg.d_model) @ p_ref["router"]
    _, idx_ref, lse_ref = ref_dispatch.softmax_topk(logits_ref,
                                                    cfg.moe.experts_per_token)
    route = L.moe_route(p, _t(x).reshape(-1, s, cfg.d_model), cfg)
    np.testing.assert_array_equal(route.idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(route.lse.numpy(), np.asarray(lse_ref), **TOL)
    keep_ref = _ref_keep(np.asarray(idx_ref), cfg_ref, s)
    np.testing.assert_array_equal(route.keep.numpy(), keep_ref)
    if factor == 0.5:
        assert route.cap == 4 and not keep_ref.all()
        _, _, p_own, cfg_own = _moe_leaves(arch)
        y_own, _ = L.moe_apply(p_own, _t(x), cfg_own)
        assert not torch.allclose(y, y_own)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_decode_shape_and_serving_form(arch):
    """A decode step's B tokens are B groups of one (capacity 4 >= k: no
    drop) and match the reference; ``aux=False`` (serving) gives the same
    output and no aux losses; the router's softmax+top-k is counted as
    ``softmax_topk_router``, apart from the sampler's ``softmax_topk``."""
    p_ref, cfg_ref, p, cfg = _moe_leaves(arch)
    x = np.random.default_rng(1).standard_normal(
        (5, 1, cfg.d_model)).astype(np.float32)
    y_ref, _ = _ref_moe_apply(p_ref, jnp.asarray(x), cfg_ref)
    y, aux = L.moe_apply(p, _t(x), cfg, aux=False)
    assert aux == {}
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    before = obs_kernels.snapshot()["paths"]
    route = L.moe_route(p, _t(x), cfg)
    after = obs_kernels.snapshot()["paths"]
    assert after["softmax_topk_router"] == {"path": "cpu", "count": before.get(
        "softmax_topk_router", {"count": 0})["count"] + 1}
    assert after.get("softmax_topk") == before.get("softmax_topk")
    assert route.cap == 4 and route.keep.all()
    assert route.idx.shape == (5, 1, cfg.moe.experts_per_token)


def test_router_order_within_a_token_decides_the_drops():
    """Two tokens routed to the same experts in the same order: the
    second token's assignment past capacity is the one dropped, and the
    k indices of a token come best first, ties to the lower index."""
    cfg = _with_capacity(configs.get_smoke("qwen2_moe_a2p7b"), 0.01)
    e = cfg.moe.num_experts
    router = torch.zeros(cfg.d_model, e)
    router[0, 2] = router[0, 4] = 3.0     # experts 2 and 4 tie, above the rest
    x = torch.zeros(1, 6, cfg.d_model)
    x[..., 0] = 1.0
    route = L.moe_route({"router": router}, x, cfg)
    assert route.idx[0, 0].tolist() == [2, 4]
    assert route.cap == 4
    # six tokens, each to experts 2 and 4: places 0..5 in each; 4 and 5 drop
    assert route.keep[0].tolist() == [[True, True]] * 4 + [[False, False]] * 2


# ---------------------------------------------------------------------------
# init, convert and the training loss.
# ---------------------------------------------------------------------------
def test_init_and_convert_carry_the_moe_leaves(model):
    """``init`` draws the reference's shapes and dtypes (the router fp32,
    experts padded), and ``params_from_numpy`` carries the reference's
    ``moe`` leaves, the shared expert's MLP included, bit for bit."""
    params_ref, cfg_ref, params, cfg = model
    mine = transformer.init(cfg, seed=0, device="cpu")
    seg = params_ref["segments"][0]
    for p in (mine, params):
        assert len(p["layers"]) == cfg.num_layers
        for i, lp in enumerate(p["layers"]):
            assert set(lp) == {"ln1", "attn", "ln2", "moe"}
            assert set(lp["moe"]) == set(seg["moe"])
            for name, w in lp["moe"].items():
                ref = seg["moe"][name]
                if isinstance(w, dict):
                    assert set(w) == set(ref)
                    for k, v in w.items():
                        assert tuple(v.shape) == ref[k].shape[1:]
                        if p is params:
                            np.testing.assert_array_equal(
                                v.numpy(), np.asarray(ref[k][i]))
                    continue
                assert tuple(w.shape) == ref.shape[1:], name
                assert str(w.dtype).endswith(str(ref.dtype)), name
                if p is params:
                    np.testing.assert_array_equal(w.numpy(),
                                                  np.asarray(ref[i]))
    e_pad = cfg.moe.pad_experts_to or cfg.moe.num_experts
    moe = mine["layers"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_down"].shape == (e_pad, cfg.moe.d_ff_expert, cfg.d_model)
    assert transformer.params_to(mine, dtype=torch.bfloat16)[
        "layers"][0]["moe"]["router"].dtype == torch.float32


def test_loss_fn_adds_the_aux_losses_like_the_reference(model):
    """The training loss: CE plus each aux loss over ``num_layers``, every
    metric and the router's gradient (through the differentiable fused
    softmax+top-k) within 1e-5 of the reference's."""
    params_ref, cfg_ref, params, cfg = model
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch_ref = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (loss_ref, m_ref), g_ref = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, batch_ref, cfg_ref), has_aux=True))(params_ref)
    for lp in params["layers"]:
        lp["moe"]["router"].requires_grad_(True)
    loss, metrics = transformer.loss_fn(
        params, {"tokens": _t(tokens), "labels": _t(labels)}, cfg)
    loss.backward()
    assert set(metrics) == set(m_ref)
    for name, val in metrics.items():
        np.testing.assert_allclose(float(val), float(m_ref[name]), **TOL)
    assert float(metrics["moe_lb_loss"]) > 0 and float(
        metrics["moe_z_loss"]) > 0
    assert float(loss) > float(metrics["ce_loss"])
    g = np.stack([lp["moe"]["router"].grad.numpy()
                  for lp in params["layers"]])
    want = np.asarray(g_ref["segments"][0]["moe"]["router"])
    np.testing.assert_allclose(g, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The smoke configs end to end.
# ---------------------------------------------------------------------------
def _prompts():
    rng = np.random.default_rng(13)
    return [rng.integers(0, 512, n) for n in (11, 19, 7, 16)]


def _requests(mod, *, decode=(6, 5, 7, 4), ticks=(0, 1, 2, 4)):
    return [mod.Request(rid=i, prompt=p, max_new_tokens=d, arrival_tick=t)
            for i, (p, d, t) in enumerate(zip(_prompts(), decode, ticks))]


def _tick_run(sched, requests):
    for req in requests:
        sched.submit(req)
    ticks = 0
    while sched.busy:
        sched.tick()
        ticks += 1
        assert ticks < 500
    return {r.rid: list(r.tokens) for r in sched.finished}


def _geom(paged):
    return dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
                top_k=TOP_K, paged=paged, block_size=BLOCK)


_REF_STREAMS = {}


def _ref_streams(params_ref, cfg_ref):
    """The reference's paged scheduler's streams of the ``model`` fixture's
    weights, run once a config (its slot pool gives the same streams: both
    run one prefill chunking and one noise, and a second reference run's
    compiles took most of this file's time)."""
    key = (cfg_ref.name, cfg_ref.kv_cache_dtype)
    if key not in _REF_STREAMS:
        ref = RS.ContinuousScheduler(params_ref, cfg_ref, base_rng=BASE_KEY,
                                     **_geom(True))
        _REF_STREAMS[key] = _tick_run(ref, _requests(RS))
    return _REF_STREAMS[key]


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_streams_equal_reference(model, paged, kv):
    """Paged and slot-pool serving, fp and int8 K/V, at the config's own
    capacity: the port's streams equal the reference scheduler's, token for
    token, under the same prefill chunking (which decides the groups and
    so the drops)."""
    params_ref, cfg_ref, params, cfg = model
    cfg = cfg.replace(kv_cache_dtype=kv)
    mine = scheduler.ContinuousScheduler(params, cfg, noise_fn=ref_noise,
                                         device="cpu", **_geom(paged))
    want = _ref_streams(params_ref, cfg_ref.replace(kv_cache_dtype=kv))
    got = _tick_run(mine, _requests(scheduler))
    assert got == want
    assert len({t for s in got.values() for t in s}) > 1
    if paged:
        mine.pool.alloc.check_invariants()


@pytest.mark.parametrize("kv", ["", "int8"], ids=["fp", "int8"])
def test_lockstep_ids_equal_reference(model, kv):
    """The lockstep loop from the reference's prompts and noise gives the
    reference's prefill / decode_step tokens."""
    params_ref, cfg_ref, params, cfg = model
    cfg_ref = cfg_ref.replace(kv_cache_dtype=kv)
    cfg = cfg.replace(kv_cache_dtype=kv)
    arch = {"qwen2-moe-smoke": "qwen2_moe_a2p7b",
            "llama4-scout-smoke": "llama4_scout_17b_a16e"}[cfg.name]
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                             "--batch", "3", "--prompt-len", "12",
                             "--tokens", "6"])
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (3, 12), 0, cfg.vocab_size))

    def noise(step):
        key = (jax.random.PRNGKey(3) if step == 0
               else jax.random.fold_in(BASE_KEY, step - 1))
        return np.asarray(jax.random.gumbel(key, (3, TOP_K), jnp.float32))

    ids = serve.lockstep(args, cfg, params, prompts=prompts, noise_fn=noise)
    last, caches, length = jax.jit(functools.partial(
        RE.prefill, cfg=cfg_ref, max_len=18))(params_ref, jnp.asarray(prompts))
    logits = RT.logits_last(params_ref, last[:, None], cfg_ref)
    tok, _ = ref_topk_sample(jax.random.PRNGKey(3), logits, TOP_K)
    want = [np.asarray(tok)]
    step = jax.jit(functools.partial(RE.decode_step, cfg=cfg_ref, top_k=TOP_K))
    for i in range(5):
        tok, caches, length = step(params_ref, caches, length, tok[:, None],
                                   rng=jax.random.fold_in(BASE_KEY, i))
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(ids, np.stack(want, axis=1))
    assert len(set(ids.ravel().tolist())) > 1


@pytest.mark.parametrize("arch", ARCHS)
def test_port_streams_do_not_depend_on_batching_or_chunking(arch):
    """The port against itself at a capacity factor of 8.0: each request
    alone, prefilled in chunks of 4, gives the stream it gave batched with
    chunks of 8.  At the configs' own capacity a prefill chunk is one
    capacity group, so the drops, and with them a stream, depend on the
    chunking in both packages; 8.0 leaves room for every assignment, as
    the reference's own prefill/decode consistency test raises it
    (``tests/test_models.py``)."""
    _, _, params, cfg = _models(arch)
    cfg = _with_capacity(cfg, 8.0)
    kw = dict(num_slots=2, slot_len=SLOT_LEN, top_k=TOP_K, seed=11,
              paged=True, block_size=BLOCK, device="cpu")
    reqs = _requests(scheduler)
    batched = Engine(params, cfg, prefill_chunk=CHUNK, **kw).serve(reqs)
    got = {r.rid: r.tokens for r in batched.results}
    assert len({t for s in got.values() for t in s}) > 1
    for req in reqs:
        alone = scheduler.Request(rid=req.rid, prompt=req.prompt,
                                  max_new_tokens=req.max_new_tokens)
        solo = Engine(params, cfg, prefill_chunk=4, **kw).serve([alone])
        assert solo.results[0].tokens == got[req.rid], req.rid


# ---------------------------------------------------------------------------
# The plain attention versions at head_dim 128, G 1 and G 5.
# ---------------------------------------------------------------------------
GROUPS = [(1, 4), (5, 2)]       # (G, Hkv): qwen2-moe's and llama4-scout's


def _paged_case(seed, *, vlens, bs=8, hkv=2, g=4, d=128, tq=1):
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
    q = rng.standard_normal((b, tq, hkv * g, d)).astype(np.float32)
    return q, k_pool, v_pool, tables, np.asarray(vlens, np.int32)


@pytest.mark.parametrize("g,hkv", GROUPS)
def test_plain_paged_decode_at_new_groups_matches_pallas(g, hkv):
    q, kp, vp, tables, vlen = _paged_case(0, vlens=[1, 13, 20], g=g, hkv=hkv)
    ref = flash_decode_paged_pallas(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(tables),
                                    jnp.asarray(vlen), interpret=True)
    got = fd.flash_decode_paged_plain(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(vlen), chunk_size=8)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("g,hkv", GROUPS)
def test_plain_paged_prefill_at_new_groups_matches_pallas(g, hkv):
    qoff, vlens, tq = [0, 9], [8, 17], 8
    q, kp, vp, tables, vlen = _paged_case(1, vlens=vlens, g=g, hkv=hkv,
                                          tq=tq)
    qo = np.asarray(qoff, np.int32)
    ref_out, ref_lse = flash_attention_paged_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(qo), jnp.asarray(vlen),
        jnp.asarray(tables), causal=True, bq=8, interpret=True)
    out, lse = fa.flash_attention_paged_plain(_t(q), _t(kp), _t(vp), _t(qo),
                                              _t(vlen), _t(tables),
                                              chunk_size=8)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **TOL)


@pytest.mark.parametrize("g,hkv", GROUPS)
def test_plain_contiguous_at_new_groups_matches_pallas(g, hkv):
    """The contiguous decode and cached prefill at D 128 against
    ``flash_decode_pallas`` and ``flash_attention_offset_pallas``."""
    rng = np.random.default_rng(3)
    b, s, tq = 2, 16, 8
    q = rng.standard_normal((b, tq, hkv * g, 128)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, 128)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, 128)).astype(np.float32)
    vlen = np.asarray([9, 16], np.int32)
    ref = flash_decode_pallas(
        jnp.asarray(q[:, 0]), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(vlen), bk=8,
        interpret=True)
    got = fd.flash_decode_plain(_t(q[:, :1]), _t(k), _t(v), _t(vlen),
                                chunk_size=8)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(ref), **TOL)
    qo = np.asarray([1, 8], np.int32)
    ref_out, ref_lse = flash_attention_offset_pallas(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(qo),
        jnp.asarray(vlen), causal=True, bq=8, bk=8, interpret=True)
    out, lse = fa.flash_attention_offset_plain(_t(q), _t(k), _t(v), _t(qo),
                                               _t(vlen), chunk_size=8)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(ref_out).transpose(0, 2, 1, 3),
                               **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0],
                               **TOL)


# ---------------------------------------------------------------------------
# The planners at the new shapes, and the decode step's cost.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r,v,k,want", [
    # the router: a row of 60 (qwen2-moe) or 16 (llama4-scout) experts is
    # one CTA of 64 threads, S 1, whatever the rows (decode B 8, a 64-token
    # chunk, a 256-token prefill)
    (8, 60, 4, st.Plan(60, 1, 64, 4, 0, 4)),
    (64, 60, 4, st.Plan(60, 1, 64, 4, 0, 4)),
    (256, 16, 1, st.Plan(16, 1, 64, 4, 0, 4)),
    # the smoke config's 6 experts: two vectors' worth (rows start 24
    # bytes apart, so most take the scalar head and tail)
    (64, 6, 2, st.Plan(8, 1, 64, 4, 0, 4)),
    # the samplers at 151936 (qwen2-moe) and 202048 (llama4-scout): 64
    # slices, the most the merge holds
    (8, 151936, 5, st.Plan(2376, 64, 256, 4, 2560, 4)),
    (8, 202048, 5, st.Plan(3160, 64, 256, 4, 2560, 4)),
])
def test_softmax_topk_plan_at_router_and_vocabulary_shapes(r, v, k, want):
    assert st.plan(r, v, k, torch.float32, H100_SMS) == want


@pytest.mark.parametrize("g,hkv,dtype,want", [
    # qwen2-moe (G 1, 16 KV heads), the paged bf16 pool of 21 blocks of 16:
    # 6 splits of 64 positions, 8 · 16 · 6 partials of one head
    (1, 16, torch.bfloat16, (64, 6, 128, 35136, 8 * 16 * 6 * 1 * 130)),
    # its int8 pool: 128 positions a split (the 16 KV heads fill the card)
    (1, 16, torch.int8, (128, 3, 128, 36416, 8 * 16 * 3 * 1 * 130)),
    # llama4-scout (G 5, 8 KV heads)
    (5, 8, torch.bfloat16, (64, 6, 128, 44352, 8 * 8 * 6 * 5 * 130)),
    (5, 8, torch.int8, (80, 5, 128, 33024, 8 * 8 * 5 * 5 * 130)),
])
def test_decode_plan_at_new_groups(g, hkv, dtype, want):
    plan = fd.decode_plan(8, hkv, g, 128, 336, 16, dtype, H100_SMS)
    assert tuple(plan) == want
    assert plan.smem == fd.split_smem(g, 128, dtype.itemsize, plan.split,
                                      dtype == torch.int8)


def test_decode_step_cost_qwen2_moe_hand_counted():
    """qwen2-moe-a2.7b (bf16, 24 layers, d 2048, 16/16 heads of 128,
    vocab 151936; 60 experts padded to 64, top 4, F 1408, shared 5632), a
    B 8 decode step over 800 live keys.  A decode row is a group of one
    token: capacity max(ceil(4·1.25/60), 4) = 4 places an expert, 64·4·8
    = 2048 places.  Per layer: attention 4·2048·2048 = 16777216 weights;
    MoE flops 2·2048·60·8 (router) + 2·2·2048·2048 (dispatch, combine) +
    3·2·2048·2048·1408 (experts) + 2·3·2048·5632·8 (shared) =
    36005871616; MoE bytes 2048·60·4 + 3·64·2048·1408·2 +
    3·2048·5632·2 = 1176993792.  flops = (2·16777216·8 + 36005871616)·24 +
    4·16·128·800·24 + 2·2048·151936·8 = 875719294976; bytes =
    (16777216·2 + 1176993792)·24 + 2048·151936·2 + 800·24·2·16·128·2 +
    8·151936·4 = 29837635584 (8.907 ms at 3.35 TB/s); int8 K/V:
    800·24·2·16·130 in place of 800·24·2·16·128·2."""
    cfg = configs.get("qwen2_moe_a2p7b")
    cost = obs_kernels.decode_step_cost(cfg, 8, [100] * 8)
    assert (cost["flops"], cost["bytes_accessed"]) == (875719294976.0,
                                                       29837635584.0)
    q8 = obs_kernels.decode_step_cost(cfg.replace(kv_cache_dtype="int8"), 8,
                                      [100] * 8)
    assert q8["bytes_accessed"] == 29760221184.0
