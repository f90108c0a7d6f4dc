"""Training the recurrent decoders (zamba2-1.2b's Mamba2 stack with its
shared attention block, xlstm-125m's mLSTM and sLSTM stack) in the port,
on the CPU, against the JAX package and against itself.

Two configs of each model: the reference's smoke config, and a narrow one
at the real head dims.  zamba2's narrow config has the Mamba2 heads of 64
with a state of 64, the shared block's attention heads of 64, two
shared-block calls and two scan chunks a sequence; xlstm's has two mLSTM
chunks a sequence and an sLSTM layer.  For each, from the reference's
weights (carried across by ``models.convert``):

* ``loss_fn`` and every gradient leaf (the recurrent blocks' fp32 leaves
  and zamba2's ``shared_attn`` among them) against the reference's
  ``value_and_grad``, under remat "full" and "block";
* two AdamW steps through ``make_train_step`` against the reference's
  ``train_step``: each step's loss and grad norm, the first moments after
  the first step, then the parameters;
* AdamW's weight-decay mask against the reference's ``p.ndim >= 2`` on its
  stacked leaves: every per-layer leaf is decayed, the fp32 recurrent
  leaves included, and the unstacked ``shared_attn`` block's norms are
  not, in either package.

Against itself: the train CLI on each smoke config, run to 2 steps with
a checkpoint and resumed to 4, against an uninterrupted 4-step run, bit
for bit.

Tolerances are ``tests/test_torch_training.py``'s (float32; the packages
sum in other orders): losses within rtol 1e-5, gradients and first
moments within rtol 1e-4 and an absolute 1e-5 of each leaf's largest
entry, parameters after n steps within 2·lr·n, at most 1 % of entries
past 1e-5.
"""
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

# the narrow configs at the real head dims; seq 32 below spans two chunks
NARROW = {
    "zamba2_1p2b": dict(d_model=128, num_heads=2, num_kv_heads=2,
                        head_dim=64, d_ff=256, num_layers=4,
                        hybrid_attn_every=2,
                        ssm=dict(d_state=64, d_conv=4, expand=2, head_dim=64,
                                 chunk=16)),
    "xlstm_125m": dict(d_model=128, num_heads=2, num_kv_heads=2,
                       num_layers=3,
                       xlstm=dict(num_heads=2, expand=2, chunk=16,
                                  slstm_every=3, conv_width=4)),
}
CASES = [(arch, model) for arch in NARROW for model in ("narrow", "smoke")]
IDS = [f"{arch.split('_')[0]}-{model}" for arch, model in CASES]
LR = 1e-3
SEQ = 32


def _configs(arch, model, **override):
    changes = {**(NARROW[arch] if model == "narrow" else {}), **override}
    ref = ref_configs.get_smoke(arch)
    mine = configs.get_smoke(arch)
    for key, ref_cls, cls in (("ssm", RB.SSMConfig, configs.SSMConfig),
                              ("xlstm", RB.XLSTMConfig,
                               configs.XLSTMConfig)):
        sub = changes.pop(key, None)
        if sub is not None:
            ref = ref.replace(**{key: ref_cls(**sub)})
            mine = mine.replace(**{key: cls(**sub)})
    return ref.replace(**changes), mine.replace(**changes)


@functools.lru_cache(maxsize=None)
def _ref_state(arch, model):
    """The reference's (params, opt_state) from ``init_state`` (seed 0),
    jitted, once per config: the weights do not depend on the remat
    policy."""
    ref_cfg, _ = _configs(arch, model)
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


def test_narrow_configs_have_the_real_head_dims():
    """The narrow zamba2 runs Mamba2 heads of 64 with a state of 64 and
    attention heads of 64, calls its shared block twice and scans two
    chunks of a 32-token sequence; the narrow xlstm scans two chunks and
    holds an sLSTM layer."""
    _, z = _configs("zamba2_1p2b", "narrow")
    assert (z.ssm.head_dim, z.ssm.d_state, z.resolved_head_dim) == (64, 64,
                                                                    64)
    assert transformer.layer_counts(z) == {"mamba": 4, "attn": 2}
    assert SEQ // z.ssm.chunk == 2
    _, x = _configs("xlstm_125m", "narrow")
    assert SEQ // x.xlstm.chunk == 2
    assert transformer.layer_counts(x) == {"mlstm": 2, "slstm": 1}
    _, xs = _configs("xlstm_125m", "smoke")
    assert xs.xlstm.chunk < SEQ and transformer.layer_counts(xs)["slstm"]


@pytest.mark.parametrize("remat", ["full", "block"])
@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_loss_and_grads_match_reference(arch, model, remat):
    """``loss_fn``, its metrics and every gradient leaf against the
    reference's ``value_and_grad`` under the same remat policy: zamba2's
    Mamba2 convs, SSD leaves and the shared block (its gradient summed
    over its calls), xlstm's mLSTM and sLSTM gates and recurrent
    weights; every recurrent leaf gets a nonzero, finite gradient."""
    ref_cfg, cfg = _configs(arch, model, remat=remat)
    ref_params, _ = _ref_state(arch, model)
    batch = _batch(cfg, seq=SEQ, gb=2)
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
    paths = [path for path, _ in tree.leaves_with_path(params)]
    assert all(torch.isfinite(g).all() for g in grads)
    recurrent = [g for path, g in zip(paths, grads)
                 if path.startswith("layers/")]
    assert all(g.abs().max() > 0 for g in recurrent)
    if arch == "zamba2_1p2b":
        shared = [g for path, g in zip(paths, grads)
                  if path.startswith("shared_attn/")]
        assert len(shared) == 2 + 4 + 3 and all(g.abs().max() > 0
                                                for g in shared)


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_train_steps_match_reference(arch, model):
    """Two train steps from the same weights and optimizer state: each
    step's loss and grad norm, the first moments after the first step (a
    tenth of the gradient at the same weights), then the parameters after
    both against the reference's; the fp32 recurrent leaves stay fp32.
    After the first step a gradient entry near zero may take the other
    sign in one package, which moves that weight by 2·lr; the second
    step's gradient, and so its moment, then comes from other weights
    (an xlstm conv's moment by 5e-5 of its largest entry)."""
    ref_run, run = _runs(*_configs(arch, model))
    ref_params, ref_opt = _ref_state(arch, model)
    params = _port(ref_params)
    opt = adamw_state_from_numpy(_np(ref_opt), device="cpu")
    ref_step = jax.jit(RTS.make_train_step(ref_run))
    step = make_train_step(run)
    for i in range(2):
        batch = _batch(run.model, seq=SEQ, gb=2, step=i, masked=False)
        ref_params, ref_opt, rm = ref_step(
            ref_params, ref_opt, jax.tree.map(jnp.asarray, batch))
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
        if i == 0:
            _trees_close(opt.mu, ref_opt.mu,
                         lambda got, want, path: _grad_close(got, want,
                                                             path))
    assert int(opt.step) == int(ref_opt.step) == 2
    _trees_close(params, ref_params, _lr_close(LR, 2))
    first = params["layers"][0]
    leaf = first["mamba"]["a_log"] if arch == "zamba2_1p2b" else \
        first["w_if"]
    assert leaf.dtype == torch.float32


@pytest.mark.parametrize("arch,model", CASES, ids=IDS)
def test_weight_decay_mask_matches_reference(arch, model):
    """``adamw.decays`` marks a port leaf exactly where the reference's
    AdamW decays its leaf (``p.ndim >= 2`` in the stacked layout): every
    per-layer leaf, the 1-D fp32 recurrent leaves (``a_log``, ``dt_bias``,
    ``d_skip``, the gate biases, the norms) among them, and of the
    unstacked ``shared_attn`` block only its matrices, so its ``ln1`` /
    ``ln2`` are not decayed in either package, nor is ``final_norm``."""
    _, cfg = _configs(arch, model)
    ref_params, _ = _ref_state(arch, model)
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
    one_d = [p for p in paths if p.startswith("layers/")
             and mine_leaf(mine, p).ndim == 1]
    assert one_d and all(adamw.decays(p, mine_leaf(mine, p)) for p in one_d)
    if arch == "zamba2_1p2b":
        for name in ("ln1", "ln2"):
            path = f"shared_attn/{name}"
            assert not adamw.decays(path, mine["shared_attn"][name])
            assert not got[path].any()
        assert adamw.decays("shared_attn/attn/wq",
                            mine["shared_attn"]["attn"]["wq"])


def mine_leaf(params, path):
    """The leaf of ``params`` at a ``tree.leaves_with_path`` path."""
    return dict(tree.leaves_with_path(params))[path]


@pytest.mark.parametrize("arch", list(NARROW))
def test_state_train_cli_restart_is_exact(arch, tmp_path):
    """The train CLI on the smoke config: 2 steps checkpointed at 2, then
    a rerun to 4 that resumes at 2, ends with the parameters and optimizer
    state of an uninterrupted 4-step run bit for bit (the fp32
    recurrent leaves stay fp32 through the checkpoint)."""
    flags = ["--arch", arch, "--smoke", "--device", "cpu", "--seq-len", "32",
             "--global-batch", "4"]

    def run(steps, ckpt, every="2"):
        args = train_cli.parse_args(flags + [
            "--steps", str(steps), "--checkpoint-every", every,
            "--checkpoint-dir", str(tmp_path / ckpt)])
        return train_cli.train(args, log=lambda *_: None)

    run(2, "a", every="2")
    p_re, o_re, h_re, _ = run(4, "a")
    p_ref, o_ref, h_ref, _ = run(4, "b", every="4")
    assert [h["step"] for h in h_re] == [2, 3] and int(o_re.step) == 4
    assert [h["loss"] for h in h_re] == [h["loss"] for h in h_ref[2:]]
    for (path, a), b in zip(tree.leaves_with_path((p_re, o_re)),
                            tree.leaves((p_ref, o_ref))):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    fp32 = [a for path, a in tree.leaves_with_path(p_re)
            if path.rsplit("/", 1)[-1] in transformer.FP32_LEAVES]
    assert fp32 and all(a.dtype == torch.float32 for a in fp32)
    assert all(np.isfinite(h["loss"]) for h in h_ref)
    if arch == "zamba2_1p2b":
        assert "shared_attn" in p_re and "shared_attn" in o_re.mu
