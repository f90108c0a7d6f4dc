"""Training the head_dim-128 decoders in the port, on the CPU, against the
JAX package and against itself.

Two configs stand for the two families: a narrow mistral-nemo-12b (the
smoke config at d_model 256, 4/2 heads of 128, 2 layers: the training
kernels' D-128 shapes at G 2) and qwen2-moe-a2.7b's smoke config (the
router through the fused softmax+top-k, its aux losses, padded experts and
a shared expert).  For each, from the reference's weights (carried across
by ``models.convert``):

* ``loss_fn``, its metrics and every gradient (qwen2-moe's router
  included) against the reference's ``value_and_grad``, under remat
  "full", and for the dense config also "block" (the reference's
  ``dots_with_no_batch_dims_saveable``);
* two AdamW steps through ``make_train_step`` against the reference's
  ``train_step``: each step's loss and grad norm, then the parameters and
  the first moments;
* AdamW's weight-decay mask against the reference's ``p.ndim >= 2`` on its
  stacked leaves, the MoE leaves included.

Against itself: the train CLI on qwen2-moe's smoke config, run to 6 steps
with checkpoints every 3 and resumed to 8, against an uninterrupted 8-step
run, bit for bit (the fp32 router and the padded experts through the
checkpoint).

Tolerances are ``tests/test_torch_training.py``'s (float32; the packages
sum in other orders): losses within rtol 1e-5, gradients and first moments
within rtol 1e-4 and an absolute 1e-5 of each leaf's largest entry,
parameters after n steps within 2·lr·n, at most 1 % of entries past 1e-5.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ParallelConfig, RunConfig)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import (adamw_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

from test_torch_training import (_batch, _grad_close, _lr_close,  # noqa: E402
                                 _np, _port, _trees_close)

# the narrow head_dim-128 dense config: mistral-nemo-12b's smoke config
# (SwiGLU, untied head, rope 1e4) at d_model 256 and 4/2 heads of 128
MISTRAL_128 = dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=128,
                   num_layers=2)
MODELS = {"mistral_d128": ("mistral_nemo_12b", MISTRAL_128),
          "qwen2_moe": ("qwen2_moe_a2p7b", {})}
LR = 1e-3


def _configs(model, **override):
    arch, changes = MODELS[model]
    changes = {**changes, **override}
    return (ref_configs.get_smoke(arch).replace(**changes),
            configs.get_smoke(arch).replace(**changes))


@functools.lru_cache(maxsize=None)
def _ref_state(model):
    """The reference's (params, opt_state) from its ``init_state`` (seed 0),
    jitted (an eager call compiles op by op), once per model: the weights
    do not depend on the remat policy."""
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


@pytest.mark.parametrize("model,remat", [("mistral_d128", "full"),
                                         ("mistral_d128", "block"),
                                         ("qwen2_moe", "full")])
def test_loss_and_grads_match_reference(model, remat):
    """``loss_fn`` (CE plus the MoE aux terms over ``num_layers``), each of
    its metrics and every gradient leaf against the reference's
    ``value_and_grad`` under the same remat policy ("block" once: the
    policy does not depend on the block kind)."""
    ref_cfg, cfg = _configs(model, remat=remat)
    if model == "mistral_d128":
        assert cfg.resolved_head_dim == ref_cfg.resolved_head_dim == 128
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
    if cfg.moe is not None:
        assert float(metrics["moe_lb_loss"]) > 0
        router = [g for (path, _), g in zip(tree.leaves_with_path(params),
                                            grads) if path.endswith("router")]
        assert len(router) == cfg.num_layers
        assert all(g.dtype == torch.float32 and g.abs().max() > 0
                   for g in router)


@pytest.mark.parametrize("model", list(MODELS))
def test_train_steps_match_reference(model):
    """Two train steps from the same weights and optimizer state: each
    step's loss and grad norm, then the parameters and the first moments
    against the reference's (the MoE leaves: the fp32 router, the padded
    experts, the shared expert)."""
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
    if run.model.moe is not None:
        assert params["layers"][0]["moe"]["router"].dtype == torch.float32
        assert opt.mu["layers"][0]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("model", list(MODELS))
def test_weight_decay_mask_matches_reference(model):
    """``adamw.decays`` marks a port leaf exactly where the reference's
    AdamW decays its leaf (``p.ndim >= 2`` in the stacked layout, so every
    per-layer leaf, norm scales and the MoE router included, and only
    ``final_norm`` exempt): the reference's tree with each leaf filled with
    its own decision, carried into the port's layout, against ``decays``
    on the port's leaves."""
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
    if cfg.moe is not None:
        moe_paths = [p for p in paths if "/moe/" in p]
        assert {p.rsplit("/", 1)[1] for p in moe_paths} >= {
            "router", "w_gate", "w_up", "w_down"}
        assert all(adamw.decays(p, got[p]) for p in moe_paths)


def test_moe_train_cli_restart_is_exact(tmp_path):
    """The train CLI on qwen2-moe's smoke config: 6 steps checkpointed
    every 3, then a rerun to 8 that resumes at 6, ends with the parameters
    and optimizer state of an uninterrupted 8-step run bit for bit; the
    fp32 router stays fp32 through the checkpoint."""
    flags = ["--arch", "qwen2_moe_a2p7b", "--smoke", "--device", "cpu",
             "--seq-len", "32", "--global-batch", "4"]

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
    assert p_re["layers"][0]["moe"]["router"].dtype == torch.float32
    assert all(np.isfinite(h["moe_lb_loss"]) for h in h_ref)
