"""The port's training slice on the CPU: against the JAX package, then
against itself.

Against the reference (weights and optimizer state carried across by
``models.convert``, batches from both packages' synthetic pipelines):
synthetic batches bit-equal; AdamW over 3 steps for each schedule, with
clipping and decay on matrices only; ``loss_fn`` and every gradient of the
smoke model, with the reference's attention on XLA and on Pallas
(interpret); a 3-step train-step trajectory at both ``grad_reduce_dtype``
values; two microbatches against the reference's two and against the full
batch.

Against itself, mirroring ``tests/test_training.py``: the loss falls, a
crash at step 17 and a restart end bit-identical to an uninterrupted run,
the straggler watchdog, the checkpoint manager's commit, retention and bf16
round trip, layer recomputation under ``remat="full"`` and ``"block"``,
and the CLI with JAX made unimportable.

Tolerances (float32 smoke model; the packages sum in other orders):
losses within rtol 1e-5 on the same weights; gradients within rtol 1e-4 and
an absolute 1e-5 of each leaf's largest entry.  After an optimizer step the
parameters are compared with a tolerance scaled by the learning rate: Adam's
first steps move each entry by about ±lr whatever |g| is, so an entry whose
gradient is ~0 in fp32, or whose bf16-cast gradient rounds the other way,
can move up to 2·lr differently; the bound is 2·lr per step taken, and at
most 1 % of the entries may differ by more than 1e-5.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.configs import base as RB  # noqa: E402
from repro.data import synthetic as RD  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ParallelConfig, RunConfig)
from repro_torch.data.synthetic import (SyntheticConfig,  # noqa: E402
                                        SyntheticDataset)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import (adamw_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import loop  # noqa: E402
from repro_torch.training.train_step import (init_state,  # noqa: E402
                                             make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return jax.tree.map(np.asarray, t)


def _ref_init(cfg, seed=0):
    """The reference's (params, opt_state) from ``init_state``."""
    params, opt, _ = RTS.init_state(RB.RunConfig(model=cfg),
                                    jax.random.PRNGKey(seed))
    return params, opt


def _port(ref_params):
    """The reference's weights as the port's, with grad-requiring leaves."""
    p = params_from_numpy(_np(ref_params), device="cpu")
    return tree.map(lambda x: x.requires_grad_(True), p)


def _grad_close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol, err_msg=what)


def _trees_close(port_tree, ref_tree, check):
    """``check(port leaf, reference leaf, path)`` over the leaves of the
    port's tree and the reference's tree carried into the port's layout."""
    ref = dict(tree.leaves_with_path(params_from_numpy(_np(ref_tree),
                                                       device="cpu")))
    got = dict(tree.leaves_with_path(port_tree))
    assert sorted(got) == sorted(ref)
    for path in got:
        check(got[path], ref[path].numpy(), path)


def _lr_close(lr, steps):
    def check(got, want, path):
        got = got.detach().float().numpy()
        diff = np.abs(got - np.asarray(want, np.float32))
        assert diff.max() <= 2 * lr * steps + 1e-6, (path, diff.max())
        assert (diff > 1e-5).mean() <= 0.01, (path, (diff > 1e-5).mean())
    return check


def _batch(cfg, *, seq=32, gb=4, seed=3, step=0, masked=True):
    ds = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq, global_batch=gb,
                                          seed=seed))
    b = ds.batch(step)
    if masked:
        b["labels"] = b["labels"].copy()
        b["labels"][0, :5] = -1                     # masked labels
    return b


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,gb,seed", [(512, 64, 8, 3),
                                               (49152, 33, 2, 0)])
def test_synthetic_batches_equal_reference(vocab, seq, gb, seed):
    port = SyntheticDataset(SyntheticConfig(vocab, seq, gb, seed=seed))
    ref = RD.SyntheticDataset(RD.SyntheticConfig(vocab, seq, gb, seed=seed))
    for step in (0, 1, 7):
        a, b = port.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k]), (step, k)


@pytest.mark.parametrize("schedule,dtype", [("cosine", "float32"),
                                            ("linear", "float32"),
                                            ("constant", "float32"),
                                            ("cosine", "bfloat16")])
def test_adamw_matches_reference(schedule, dtype):
    """Three steps of ``update`` on a tree of matrices and vectors, with
    gradients large enough to be clipped: parameters, moments, grad norm
    and lr against the reference's.  bf16 parameters are written back with
    round-to-nearest-even in both frameworks (compared within one bf16 ulp,
    2⁻⁸ relative)."""
    rng = np.random.default_rng(6)
    shapes = {"w": (6, 5), "b": (5,), "m": (3, 4, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=5, schedule=schedule,
                grad_clip=1.0, weight_decay=0.1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    rs = RA.init(rp)
    pp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in rp.items()}
    ps = adamw.init(pp)
    for _ in range(3):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        rp, rs, rm = RA.update({k: jnp.asarray(v) for k, v in g.items()}, rs,
                               rp, RB.OptimizerConfig(**ocfg))
        pp, ps, pm = adamw.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, ps, pp,
                                  OptimizerConfig(**ocfg))
        assert float(rm["grad_norm"]) > 1.0              # clipping engaged
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        assert int(ps.step) == int(rs.step)
        for k in shapes:
            want = np.asarray(rp[k].astype(jnp.float32))
            tol = (dict(rtol=2 ** -8, atol=0) if dtype == "bfloat16"
                   else dict(rtol=1e-5, atol=1e-6))
            np.testing.assert_allclose(pp[k].float().numpy(), want,
                                       err_msg=k, **tol)
            for got_m, want_m in ((ps.mu[k], rs.mu[k]), (ps.nu[k], rs.nu[k])):
                np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                           rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["reference_xla", "reference_pallas"])
def test_loss_and_grads_match_reference(use_pallas):
    """``loss_fn`` of the smoke model (fp32, masked labels, tied embedding:
    the gather's and the head's gradients both land in ``embed``) and every
    gradient leaf against the reference's ``value_and_grad``."""
    ref_cfg = ref_configs.get_smoke("smollm_360m").replace(
        use_pallas=use_pallas)
    cfg = configs.get_smoke("smollm_360m")
    ref_params, _ = _ref_init(ref_cfg)
    batch = _batch(cfg)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: RT.loss_fn(p, jax.tree.map(jnp.asarray, batch), ref_cfg),
        has_aux=True)(ref_params)
    params = _port(ref_params)
    loss, metrics = transformer.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, tree.leaves(params))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert metrics["ce_loss"].item() == loss.item()
    _trees_close(tree.unflatten(params, grads), ref_grads,
                 lambda got, want, path: _grad_close(got, want, path))


def _ref_run(cfg, **kw):
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    par = kw.pop("parallel", {})
    return (RB.RunConfig(model=cfg, optimizer=RB.OptimizerConfig(**opt),
                         parallel=RB.ParallelConfig(**par), **kw),
            RunConfig(model=configs.get_smoke("smollm_360m"),
                      optimizer=OptimizerConfig(**opt),
                      parallel=ParallelConfig(**par), **kw))


@pytest.mark.parametrize("reduce_dtype", ["bfloat16", "float32"])
def test_train_steps_match_reference(reduce_dtype):
    """Three train steps from the same weights and optimizer state: each
    step's loss and grad norm, then the parameters and the optimizer state
    (carried in by ``adamw_state_from_numpy``) against the reference's."""
    ref_run, run = _ref_run(ref_configs.get_smoke("smollm_360m"),
                            parallel=dict(grad_reduce_dtype=reduce_dtype))
    ref_params, ref_opt = _ref_init(ref_run.model)
    params = _port(ref_params)
    opt = adamw_state_from_numpy(_np(ref_opt), device="cpu")
    ref_step = jax.jit(RTS.make_train_step(ref_run))
    step = make_train_step(run)
    for i in range(3):
        batch = _batch(run.model, step=i, masked=False)
        ref_params, ref_opt, rm = ref_step(
            ref_params, ref_opt, jax.tree.map(jnp.asarray, batch))
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    assert int(opt.step) == int(ref_opt.step) == 3
    _trees_close(params, ref_params, _lr_close(1e-3, 3))
    if reduce_dtype == "float32":
        _trees_close(opt.mu, ref_opt.mu, lambda got, want, path: _grad_close(
            got, want, path))
    else:
        # a gradient entry cast to bf16 may round the other way in one
        # package (its fp32 values differ in the last bits): one bf16 ulp
        # (2⁻⁷ of the entry) in one of the moment's terms, which may have
        # cancelled; so within 2⁻⁷ of the leaf's largest moment
        _trees_close(opt.mu, ref_opt.mu,
                     lambda got, want, path: np.testing.assert_allclose(
                         got.numpy(), want, rtol=2 ** -7,
                         atol=2 ** -7 * float(np.abs(want).max()),
                         err_msg=path))


def test_microbatches_match_reference_and_full_batch():
    """Two microbatches (each cast, accumulated in fp32, averaged) against
    the reference's two, and against the full batch (the reference test's
    own tolerance, rtol 2e-3 / atol 2e-4: fp32 sums in another order)."""
    par = dict(grad_reduce_dtype="float32")
    ref_run, run = _ref_run(ref_configs.get_smoke("smollm_360m"),
                            parallel=dict(microbatches=2, **par))
    _, full_run = _ref_run(ref_configs.get_smoke("smollm_360m"),
                           parallel=dict(microbatches=1, **par))
    ref_params, ref_opt = _ref_init(ref_run.model)
    batch = _batch(run.model, gb=4, masked=False)
    rp, _, rm = RTS.make_train_step(ref_run)(
        ref_params, ref_opt, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    p2, _, m2 = make_train_step(run)(_port(ref_params),
                                     adamw.init(_port(ref_params)), tb)
    p1, _, _ = make_train_step(full_run)(_port(ref_params),
                                         adamw.init(_port(ref_params)), tb)
    np.testing.assert_allclose(float(m2["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    _trees_close(p2, rp, _lr_close(1e-3, 1))
    for (path, a), b in zip(tree.leaves_with_path(p2), tree.leaves(p1)):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-4, msg=path)


# ---------------------------------------------------------------------------
# the port against itself (mirrors tests/test_training.py)
# ---------------------------------------------------------------------------
def _run_cfg(path, **opt_kw):
    return RunConfig(
        model=configs.get_smoke("smollm_360m"),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=100,
                                  schedule="constant", **opt_kw),
        checkpoint_dir=str(path), checkpoint_every=10, log_every=1000)


def _dataset(cfg, gb=8):
    return SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=gb, seed=3))


def _copy(t):
    return tree.map(lambda x: x.detach().clone().requires_grad_(
        x.requires_grad), t)


def test_loss_decreases(tmp_path):
    run = _run_cfg(tmp_path)
    params, opt = init_state(run, device="cpu")
    _, _, hist = loop.run(run, steps=30, train_step=make_train_step(run),
                          params=params, opt_state=opt,
                          dataset=_dataset(run.model), log=lambda *_: None)
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])
    assert all(np.isfinite(x) for x in losses)


def test_checkpoint_every_zero_saves_nothing(tmp_path):
    """``checkpoint_every=0`` (``--checkpoint-every 0``) trains without
    writing a checkpoint, the final one included; the default saves every
    N steps and after the last."""
    import dataclasses
    from repro_torch.checkpoint.manager import CheckpointManager
    run = dataclasses.replace(_run_cfg(tmp_path / "off"), checkpoint_every=0)
    params, opt = init_state(run, device="cpu")
    loop.run(run, steps=3, train_step=make_train_step(run), params=params,
             opt_state=opt, dataset=_dataset(run.model, gb=2),
             log=lambda *_: None)
    assert CheckpointManager(run.checkpoint_dir).latest_step() is None
    run = _run_cfg(tmp_path / "on")
    params, opt = init_state(run, device="cpu")
    loop.run(run, steps=3, train_step=make_train_step(run), params=params,
             opt_state=opt, dataset=_dataset(run.model, gb=2),
             log=lambda *_: None)
    assert CheckpointManager(run.checkpoint_dir).latest_step() == 3


def test_crash_restart_is_exact(tmp_path):
    """Kill the loop at step 17 (after the step-10 checkpoint), restart:
    the final parameters equal an uninterrupted 20-step run bit for bit."""
    run = _run_cfg(tmp_path / "a")
    params0, opt0 = init_state(run, device="cpu")
    step = make_train_step(run)
    p_ref, _, _ = loop.run(run, steps=20, train_step=step,
                           params=_copy(params0), opt_state=_copy(opt0),
                           dataset=_dataset(run.model), log=lambda *_: None)

    class Boom(RuntimeError):
        pass

    def bomb(i):
        if i == 17:
            raise Boom()

    run_b = _run_cfg(tmp_path / "b")
    with pytest.raises(Boom):
        loop.run(run_b, steps=20, train_step=step, params=_copy(params0),
                 opt_state=_copy(opt0), dataset=_dataset(run_b.model),
                 inject_failure=bomb, log=lambda *_: None)
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 10
    logs = []
    p_re, o_re, hist = loop.run(run_b, steps=20, train_step=step,
                                params=_copy(params0), opt_state=_copy(opt0),
                                dataset=_dataset(run_b.model), log=logs.append)
    assert logs[0] == "[restore] resuming from committed step 10"
    assert [h["step"] for h in hist] == list(range(10, 20))
    assert int(o_re.step) == 20
    for (path, a), b in zip(tree.leaves_with_path(p_ref), tree.leaves(p_re)):
        assert torch.equal(a, b), path
        assert b.requires_grad


def test_straggler_watchdog():
    w = loop.StragglerWatchdog(factor=3.0)
    for s in range(10):
        assert not w.observe(s, 0.1)
    assert w.observe(10, 1.0)            # 10× median
    assert w.events and w.events[0]["step"] == 10


def test_heartbeat_and_checkpoints_written(tmp_path):
    run = _run_cfg(tmp_path)
    params, opt = init_state(run, device="cpu")
    loop.run(run, steps=12, train_step=make_train_step(run), params=params,
             opt_state=opt, dataset=_dataset(run.model, gb=2),
             log=lambda *_: None)
    import json
    with open(tmp_path / "heartbeat") as f:
        assert json.load(f)["step"] == 11
    assert CheckpointManager(str(tmp_path)).committed_steps() == [10, 12]


def test_checkpoint_manager_commit_retention_and_bf16(tmp_path):
    """Uncommitted and staging directories are ignored, only the newest
    ``keep`` committed steps stay, and bf16, fp32 and int32 leaves come back
    bit-exact with their dtype (bf16 through its raw 16-bit words)."""
    gen = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(4, 3, generator=gen).bfloat16(),
                        "layers": [{"s": torch.randn(3, generator=gen)}]},
             "opt": adamw.AdamWState(torch.tensor(7, dtype=torch.int32),
                                     {"w": torch.randn(2, generator=gen)},
                                     {"w": torch.rand(2, generator=gen)})}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.save(4, state, blocking=True)
    os.makedirs(tmp_path / "step_9")                 # no COMMITTED marker
    os.makedirs(tmp_path / "step_8.tmp")             # a torn write
    assert mgr.committed_steps() == [3, 4]
    assert mgr.latest_step() == 4
    like = tree.map(torch.zeros_like, state)
    back = mgr.restore(4, like)
    assert isinstance(back["opt"], adamw.AdamWState)
    for (path, a), b in zip(tree.leaves_with_path(state), tree.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    with np.load(tmp_path / "step_4" / "arrays.npz") as z:
        assert "__bf16__:params/w" in z.files
        assert z["__bf16__:params/w"].dtype == np.uint16


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] = self.n.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_each_layer_in_backward(monkeypatch):
    """remat "full": each layer's attention runs twice per step (forward,
    then recomputed in the backward), "none": once; "block" (the
    reference's ``dots_with_no_batch_dims_saveable``) recomputes attention
    as "full" does but no product without batch dims: its backward runs
    as many ``aten.mm`` as "none"'s, "full"'s more.  Loss and gradients
    are bit-identical under the three."""
    cfg = configs.get_smoke("smollm_360m")
    calls = []
    real = dispatch.sdpa
    monkeypatch.setattr(dispatch, "sdpa",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, masked=False).items()}
    out = {}
    for remat, want in (("full", 2), ("none", 1), ("block", 2)):
        c = cfg.replace(remat=remat)
        params, _ = init_state(RunConfig(model=c), device="cpu")
        calls.clear()
        loss, _ = transformer.loss_fn(params, batch, c)
        ops = _CountOps()
        with ops:
            grads = torch.autograd.grad(loss, tree.leaves(params))
        assert len(calls) == want * c.num_layers, remat
        out[remat] = (loss, grads, ops.n.get("aten.mm.default", 0))
    # "full" recomputes q, k, v, o and the MLP's gate and up products, 6 a
    # layer; the recomputation stops before the down projection, whose
    # output the backward never reads
    assert out["block"][2] == out["none"][2]
    assert out["full"][2] == out["none"][2] + 6 * cfg.num_layers
    for remat in ("full", "block"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out["none"][1])), remat


def test_train_cli_without_jax(tmp_path):
    """``python -m repro_torch.launch.train`` at smoke size on the CPU with
    JAX and the reference made unimportable; a rerun resumes at the end."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "from repro_torch.launch import train; "
            "sys.exit(train.main(sys.argv[1:]))")
    argv = ["--arch", "smollm_360m", "--smoke", "--device", "cpu", "--steps",
            "3", "--seq-len", "32", "--global-batch", "4",
            "--checkpoint-dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code, *argv], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[step 0] loss=" in out.stdout
    assert "first loss" in out.stdout and "→ last loss" in out.stdout
    assert CheckpointManager(str(tmp_path)).committed_steps() == [3]


def test_train_cli_refuses_unported_options():
    # the model axis runs the dense, MoE, MLA and recurrent decoders
    # (smollm trains at 2x2), not yet the encoder-decoder
    with pytest.raises(NotImplementedError, match="model axis"):
        train_cli.parse_args(["--arch", "whisper_small", "--mesh", "2x2"])
    assert train_cli.parse_args(["--arch", "smollm_360m", "--mesh",
                                 "2x2"]).mesh == "2x2"
    args = train_cli.parse_args(["--arch", "smollm_360m", "--layers", "2"])
    assert args.device == "cuda"
    run = train_cli.run_config(args)
    assert run.model.num_layers == 2 and run.model.d_model == 960
    assert run.optimizer.warmup_steps == 20
    assert run.parallel.grad_reduce_dtype == "bfloat16"
