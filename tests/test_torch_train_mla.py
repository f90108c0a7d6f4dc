"""Training the MLA decoder (minicpm3-4b) in the port, on the CPU, against
the JAX package and against itself.

The decompressed attention first: q and k 96 wide (64 nope + 32 rope), v
64, the shapes the fresh kernels' (96, 64) instances take on the card.  On
the same numpy inputs, at G 1 and at a GQA grouping, causal and not, at a T
that is no multiple of the chunk:

* the fresh kernel's plain forward and the backward's plain version
  (``flash_attention_bwd_plain``, which reshaped dO with q's width before
  it took v's) against the reference's ``core.online_attention`` and its
  ``jax.vjp``;
* ``FlashAttention.apply`` on the CPU, forward and backward, the same.

Then two configs: a narrow minicpm3 at the real head dims (d_model 256, 4
heads, q_lora 64, kv_lora 32, 64 nope + 32 rope, v 64, 2 layers, fp32) and
the reference's smoke config.  For each, from the reference's weights
(carried across by ``models.convert``):

* ``loss_fn`` and every gradient (the MLA leaves included) against the
  reference's ``value_and_grad``, under remat "full" and "block";
* two AdamW steps through ``make_train_step`` against the reference's
  ``train_step``: each step's loss and grad norm, then the parameters and
  the first moments;
* AdamW's weight-decay mask against the reference's ``p.ndim >= 2`` on its
  stacked leaves, the MLA leaves included.

Against itself: the train CLI on the smoke config, run to 6 steps with
checkpoints every 3 and resumed to 8, against an uninterrupted 8-step run,
bit for bit.

Tolerances are ``tests/test_torch_training.py``'s (float32; the packages
sum in other orders): attention outputs, losses and the attention's
gradients within rtol 1e-5 / 1e-4 and an absolute 1e-5 of the largest
entry, model gradients and first moments within rtol 1e-4 and an absolute
1e-5 of each leaf's largest entry, parameters after n steps within
2·lr·n, at most 1 % of entries past 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.core import attention as RA  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ParallelConfig, RunConfig)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import (adamw_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

from test_torch_training import (_batch, _grad_close, _lr_close,  # noqa: E402
                                 _np, _port, _trees_close)

ARCH = "minicpm3_4b"
# the narrow config at minicpm3-4b's head dims: Dqk 64 + 32, Dv 64
NARROW = dict(d_model=256, num_heads=4, num_kv_heads=4, num_layers=2,
              mla=dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=64,
                       qk_rope_head_dim=32, v_head_dim=64))
MODELS = {"narrow": NARROW, "smoke": {}}
LR = 1e-3
CHUNK = 16          # the online form's chunk: T below is no multiple of it


def _configs(model, **override):
    changes = {**MODELS[model], **override}
    mla = changes.pop("mla", None)
    ref = ref_configs.get_smoke(ARCH).replace(**changes)
    mine = configs.get_smoke(ARCH).replace(**changes)
    if mla is not None:
        ref = ref.replace(mla=RB.MLAConfig(**mla))
        mine = mine.replace(mla=configs.MLAConfig(**mla))
    return ref, mine


@functools.lru_cache(maxsize=None)
def _ref_state(model):
    """The reference's (params, opt_state) from its ``init_state`` (seed 0),
    jitted, once per model: the weights do not depend on the remat
    policy."""
    ref_cfg, _ = _configs(model)
    return jax.jit(lambda key: RTS.init_state(RB.RunConfig(model=ref_cfg),
                                              key)[:2])(
        jax.random.PRNGKey(0))


def _runs(ref_cfg, cfg):
    opt = dict(lr=LR, warmup_steps=2, total_steps=10)
    par = dict(grad_reduce_dtype="float32")
    return (RB.RunConfig(model=ref_cfg, optimizer=RB.OptimizerConfig(**opt),
                         parallel=RB.ParallelConfig(**par)),
            RunConfig(model=cfg, optimizer=OptimizerConfig(**opt),
                      parallel=ParallelConfig(**par)))


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=rtol,
        atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# The decompressed attention at Dqk 96 / Dv 64
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnums=(4,))
def _ref_attention(q, k, v, dout, causal):
    """The reference's online attention and its VJP at ``dout``."""
    out, vjp = jax.vjp(lambda a, b, c: RA.online_attention(
        a, b, c, causal=causal, chunk_size=CHUNK), q, k, v)
    return (out,) + vjp(dout)


def _attention_inputs(seed, *, t, hq, hkv):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((2, t, hq, 96), (2, t, hkv, 96),
                               (2, t, hkv, 64), (2, t, hq, 64)))


CASES = [(1, 4, 4, True), (1, 4, 4, False), (2, 4, 2, True), (3, 6, 2, False)]


@pytest.mark.parametrize("form", ["plain", "autograd"])
@pytest.mark.parametrize("seed,hq,hkv,causal", CASES,
                         ids=["g1-causal", "g1", "gqa2-causal", "gqa3"])
def test_attention_at_dqk96_dv64_matches_reference(form, seed, hq, hkv,
                                                   causal):
    """The fresh kernel's plain forward and the backward's plain version
    ("plain"), and ``FlashAttention.apply`` on the CPU ("autograd"), at q
    and k 96 wide and v 64, T 37 (no multiple of the 16-key chunk), against
    the reference's ``online_attention`` and ``jax.vjp``: the output [B, T,
    Hq, 64], dq and dk 96 wide, dv 64 wide and summed over each KV head's
    query heads."""
    arrays = _attention_inputs(seed, t=37, hq=hq, hkv=hkv)
    want = _ref_attention(*map(jnp.asarray, arrays), causal)
    q, k, v, dout = (torch.from_numpy(a) for a in arrays)
    if form == "plain":
        out, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                chunk_size=CHUNK)
        got = (out,) + fab.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                     causal=causal)
    else:
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.FlashAttention.apply(*leaves, causal)
        out.backward(dout)
        got = (out,) + tuple(x.grad for x in leaves)
    assert [tuple(g.shape) for g in got] == [
        (2, 37, hq, 64), (2, 37, hq, 96), (2, 37, hkv, 96), (2, 37, hkv, 64)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _close(g, w, rtol=1e-5 if name == "out" else 1e-4)


# ---------------------------------------------------------------------------
# The model: loss, gradients, AdamW steps, decay mask
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model,remat", [("narrow", "full"),
                                         ("narrow", "block"),
                                         ("smoke", "full"),
                                         ("smoke", "block")])
def test_loss_and_grads_match_reference(model, remat):
    """``loss_fn``, its metrics and every gradient leaf (the low-rank q,
    the latent and rope-key projections, W_uk, W_uv, the two norms and
    W_o of every layer) against the reference's ``value_and_grad`` under
    the same remat policy."""
    ref_cfg, cfg = _configs(model, remat=remat)
    if model == "narrow":
        m = cfg.mla
        assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == \
            (96, 64)
    ref_params, _ = _ref_state(model)
    batch = _batch(cfg, seq=32, gb=2)
    (ref_loss, ref_m), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: RT.loss_fn(p, jax.tree.map(jnp.asarray, batch), ref_cfg),
        has_aux=True))(ref_params)
    params = _port(ref_params)
    loss, metrics = transformer.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, tree.leaves(params))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert set(metrics) == set(ref_m)
    for name, val in metrics.items():
        np.testing.assert_allclose(float(val), float(ref_m[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    _trees_close(tree.unflatten(params, grads), ref_grads,
                 lambda got, want, path: _grad_close(got, want, path))
    mla = [g for (path, _), g in zip(tree.leaves_with_path(params), grads)
           if path.rsplit("/", 1)[-1] in ("wdq", "wuq", "wdkv", "wuk", "wuv")]
    assert len(mla) == 5 * cfg.num_layers
    assert all(g.abs().max() > 0 for g in mla)


@pytest.mark.parametrize("model", list(MODELS))
def test_train_steps_match_reference(model):
    """Two train steps from the same weights and optimizer state: each
    step's loss and grad norm, then the parameters and the first moments
    (the MLA leaves among them) against the reference's."""
    ref_run, run = _runs(*_configs(model))
    ref_params, ref_opt = _ref_state(model)
    params = _port(ref_params)
    opt = adamw_state_from_numpy(_np(ref_opt), device="cpu")
    ref_step = jax.jit(RTS.make_train_step(ref_run))
    step = make_train_step(run)
    for i in range(2):
        batch = _batch(run.model, seq=32, gb=2, step=i, masked=False)
        ref_params, ref_opt, rm = ref_step(
            ref_params, ref_opt, jax.tree.map(jnp.asarray, batch))
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    assert int(opt.step) == int(ref_opt.step) == 2
    _trees_close(params, ref_params, _lr_close(LR, 2))
    _trees_close(opt.mu, ref_opt.mu,
                 lambda got, want, path: _grad_close(got, want, path))
    assert opt.mu["layers"][0]["attn"]["kv_norm"].dtype == torch.float32


@pytest.mark.parametrize("model", list(MODELS))
def test_weight_decay_mask_matches_reference(model):
    """``adamw.decays`` marks a port leaf exactly where the reference's
    AdamW decays its leaf (``p.ndim >= 2`` in the stacked layout, so every
    per-layer leaf, the MLA norms and projections included, and only
    ``final_norm`` exempt)."""
    _, cfg = _configs(model)
    ref_params, _ = _ref_state(model)
    marks = jax.tree.map(
        lambda a: np.full(a.shape, float(np.ndim(a) >= 2), np.float32),
        ref_params)
    got = dict(tree.leaves_with_path(params_from_numpy(marks,
                                                       device="cpu")))
    mine = transformer.init(cfg, seed=0, device="cpu")
    paths = [path for path, _ in tree.leaves_with_path(mine)]
    assert sorted(paths) == sorted(got)
    for path, p in tree.leaves_with_path(mine):
        want = bool(got[path].all())
        assert got[path].all() == got[path].any(), path
        assert adamw.decays(path, p) == want, path
    assert not adamw.decays("final_norm", mine["final_norm"])
    mla_paths = [p for p in paths if "/attn/" in p]
    assert {p.rsplit("/", 1)[1] for p in mla_paths} == {
        "wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wuk", "wuv", "wo"}
    assert all(adamw.decays(p, got[p]) for p in mla_paths)


def test_mla_train_cli_restart_is_exact(tmp_path):
    """The train CLI on minicpm3's smoke config: 6 steps checkpointed
    every 3, then a rerun to 8 that resumes at 6, ends with the parameters
    and optimizer state of an uninterrupted 8-step run bit for bit (the
    fp32 MLA norms stay fp32 through the checkpoint)."""
    flags = ["--arch", ARCH, "--smoke", "--device", "cpu", "--seq-len", "32",
             "--global-batch", "4"]

    def run(steps, ckpt, every="3"):
        args = train_cli.parse_args(flags + [
            "--steps", str(steps), "--checkpoint-every", every,
            "--checkpoint-dir", str(tmp_path / ckpt)])
        return train_cli.train(args, log=lambda *_: None)

    run(6, "a")
    p_re, o_re, h_re, _ = run(8, "a")
    p_ref, o_ref, h_ref, _ = run(8, "b", every="8")
    assert [h["step"] for h in h_re] == [6, 7] and int(o_re.step) == 8
    assert [h["loss"] for h in h_re] == [h["loss"] for h in h_ref[6:]]
    for (path, a), b in zip(tree.leaves_with_path((p_re, o_re)),
                            tree.leaves((p_ref, o_ref))):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert p_re["layers"][0]["attn"]["q_norm"].dtype == torch.float32
    assert all(np.isfinite(h["loss"]) for h in h_ref)
