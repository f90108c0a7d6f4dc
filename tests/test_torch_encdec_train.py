"""Training the encoder-decoder (whisper-small's backbone) through the
port's ``training.train_step``, on the CPU, against the JAX package's
``repro.training.train_step`` and against itself, at the smoke config.

* ``loss_for`` picks ``encdec.loss_fn`` for an encoder-decoder and
  ``transformer.loss_fn`` for the rest, as the reference's does;
  ``init_for`` / ``init_state`` build with ``encdec.init`` (the
  reference's layout, fresh AdamW moments).
* Two ``make_train_step`` AdamW steps from the reference's weights and
  optimizer state on a batch in the dry-run's shape ``{frames [B, S_enc,
  D], tokens, labels}`` (one microbatch, and two): each step's loss and
  grad norm, the first moments after the first step, then the parameters
  and both moments after both.
* ``training.loop.run`` over a frames batch: two steps equal to calling
  the train step twice, and a run checkpointed at step 1 and resumed to 2
  bit-identical to an uninterrupted one.
* ``launch.train --arch whisper_small`` (and its smoke config) refuses
  before it initialises anything, naming the missing frames; the
  reference's loss on the CLI's frame-less batch raises ``KeyError``.

Tolerances are ``tests/test_torch_training.py``'s (float32; the packages
sum in other orders): losses within rtol 1e-5, grad norms within rtol
1e-4, gradients and moments within rtol 1e-4 and an absolute 1e-5 of each
leaf's largest entry, parameters after n steps within 2·lr·n with at most
1 % of entries past 1e-5.  Second moments, which square the gradients,
within rtol 2e-4 and 1e-5 of their largest entry.
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
from repro.models import encdec as RED  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import train_step as RTS  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.configs.base import (OptimizerConfig,  # noqa: E402
                                      ParallelConfig, RunConfig)
from repro_torch.data.synthetic import (SyntheticConfig,  # noqa: E402
                                        SyntheticDataset)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import encdec, transformer  # noqa: E402
from repro_torch.models.convert import (adamw_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.training import loop, train_step  # noqa: E402

from test_torch_training import (_grad_close, _lr_close, _np,  # noqa: E402
                                 _port, _trees_close)

ARCH = "whisper_small"
LR = 1e-3
GB, SEQ = 2, 12


@functools.lru_cache(maxsize=None)
def _ref_state():
    """The reference's (params, opt_state) of the smoke config from its
    ``init_state`` (seed 0), jitted."""
    cfg = ref_configs.get_smoke(ARCH)
    return jax.jit(lambda key: RTS.init_state(RB.RunConfig(model=cfg),
                                              key)[:2])(
        jax.random.PRNGKey(0))


def _runs(microbatches=1):
    opt = dict(lr=LR, warmup_steps=2, total_steps=10)
    par = dict(grad_reduce_dtype="float32", microbatches=microbatches)
    return (RB.RunConfig(model=ref_configs.get_smoke(ARCH),
                         optimizer=RB.OptimizerConfig(**opt),
                         parallel=RB.ParallelConfig(**par)),
            RunConfig(model=configs.get_smoke(ARCH),
                      optimizer=OptimizerConfig(**opt),
                      parallel=ParallelConfig(**par)))


class FramesDataset:
    """The synthetic token stream with stub frames [GB, S_enc, D] beside
    it, both a pure function of the step (the dry-run's batch shape)."""

    def __init__(self, cfg, gb=GB, seq=SEQ, seed=3):
        self.cfg = cfg
        self.tokens = SyntheticDataset(SyntheticConfig(
            vocab_size=cfg.real_vocab_size or cfg.vocab_size, seq_len=seq,
            global_batch=gb, seed=seed))

    def batch(self, step: int) -> dict:
        b = self.tokens.batch(step)
        rng = np.random.default_rng(100 + step)
        frames = rng.standard_normal(
            (b["tokens"].shape[0], self.cfg.encoder_seq_len,
             self.cfg.d_model)).astype(np.float32)
        return {"frames": frames, **b}


def test_loss_for_and_init_state_pick_the_encdec_model():
    """Both packages pick the same loss per family; the port's
    ``init_state`` draws ``encdec.init``'s tree, in the layout of the
    reference's ``init_state`` carried across, with zero moments and
    every leaf requiring grad."""
    whisper, smollm = (configs.get_smoke(a) for a in (ARCH, "smollm_360m"))
    assert train_step.loss_for(whisper) is encdec.loss_fn
    assert train_step.loss_for(smollm) is transformer.loss_fn
    assert train_step.init_for(whisper) is encdec.init
    assert train_step.init_for(smollm) is transformer.init
    assert RTS.loss_for(ref_configs.get_smoke(ARCH)) is RED.loss_fn
    assert RTS.loss_for(ref_configs.get_smoke("smollm_360m")) is RT.loss_fn
    _, run = _runs()
    params, opt = train_step.init_state(run, device="cpu")
    ref_params, ref_opt = _ref_state()
    want = {p: (tuple(x.shape), x.dtype) for p, x in tree.leaves_with_path(
        params_from_numpy(_np(ref_params), device="cpu"))}
    got = {p: (tuple(x.shape), x.dtype)
           for p, x in tree.leaves_with_path(params)}
    assert got == want
    assert len(params["encoder"]) == run.model.encoder_layers
    assert all(x.requires_grad for x in tree.leaves(params))
    assert int(opt.step) == 0 and all(
        not m.any() for m in tree.leaves(opt.mu) + tree.leaves(opt.nu))
    moments = {p: tuple(x.shape) for p, x in tree.leaves_with_path(opt.mu)}
    assert moments == {p: s for p, (s, _) in want.items()}
    assert int(ref_opt.step) == 0


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(microbatches):
    """Two AdamW steps of the smoke model from the reference's weights and
    state, frames [2, 64, 64] beside the tokens: loss, grad norm and the
    first moments step by step, then the parameters and both moments;
    every gradient reaches the adapter, the encoder and the
    cross-attention (nonzero first moments)."""
    ref_run, run = _runs(microbatches)
    ref_params, ref_opt = _ref_state()
    params = _port(ref_params)
    opt = adamw_state_from_numpy(_np(ref_opt), device="cpu")
    ref_step = jax.jit(RTS.make_train_step(ref_run))
    step = train_step.make_train_step(run)
    data = FramesDataset(run.model)
    for i in range(2):
        batch = data.batch(i)
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

    def second(got, want, path):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=2e-4,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30), err_msg=path)
    _trees_close(opt.nu, ref_opt.nu, second)
    by_path = dict(tree.leaves_with_path(opt.mu))
    for path in ("adapter", "encoder/0/attn/wq", "decoder/1/cross_attn/wk",
                 "decoder/0/self_attn/wv", "pos_embed"):
        assert by_path[path].abs().max() > 0, path


def test_loop_runs_a_frames_batch_and_resumes_exactly(tmp_path):
    """``training.loop.run`` over the frames stream: two steps equal two
    direct ``make_train_step`` calls bit for bit, and a run saved at step
    1 and resumed to step 2 ends with the same parameters and moments."""
    _, run = _runs()
    data = FramesDataset(run.model)

    def fresh():
        params, opt = train_step.init_state(run, device="cpu")
        return params, opt

    def run_to(steps, ckpt, every):
        r = RunConfig(model=run.model, optimizer=run.optimizer,
                      parallel=run.parallel, checkpoint_dir=str(ckpt),
                      checkpoint_every=every)
        params, opt = fresh()
        params, opt, hist = loop.run(
            r, steps=steps, train_step=train_step.make_train_step(r),
            params=params, opt_state=opt, dataset=data,
            log=lambda *_: None)
        return params, opt, hist

    p_loop, o_loop, hist = run_to(2, tmp_path / "a", 0)
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    params, opt = fresh()
    step = train_step.make_train_step(run)
    for i in range(2):
        params, opt, _ = step(params, opt, {
            k: torch.as_tensor(v) for k, v in data.batch(i).items()})
    pairs = list(zip(tree.leaves((p_loop, o_loop)), tree.leaves((params,
                                                                 opt))))
    assert all(torch.equal(a, b) for a, b in pairs)
    run_to(1, tmp_path / "b", 1)
    p_re, o_re, h_re = run_to(2, tmp_path / "b", 1)
    assert [h["step"] for h in h_re] == [1]
    assert all(torch.equal(a, b) for a, b in zip(
        tree.leaves((p_re, o_re)), tree.leaves((p_loop, o_loop))))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_train_cli_refuses_whisper_before_init(smoke, monkeypatch):
    """The CLI's synthetic stream has no frames: ``--arch whisper_small``
    exits with a message that says so and where the model trains, before
    any weight is drawn; the reference's loss on that stream's batch
    (tokens and labels only) raises ``KeyError: 'frames'``, which is what
    the reference's CLI runs into."""
    def no_init(*a, **kw):
        raise AssertionError("init_state ran before the refusal")
    monkeypatch.setattr(train_cli, "init_state", no_init)
    argv = ["--arch", ARCH, "--device", "cpu", "--steps", "1"]
    with pytest.raises(SystemExit) as info:
        train_cli.train(train_cli.parse_args(argv + (["--smoke"] if smoke
                                                      else [])))
    msg = str(info.value)
    for word in ("no frames", "training.train_step", "frames [B, S_enc, D]"):
        assert word in msg, msg
    cfg_ref = ref_configs.get_smoke(ARCH)
    ref_params, _ = _ref_state()
    batch = SyntheticDataset(SyntheticConfig(cfg_ref.vocab_size, SEQ,
                                             GB)).batch(0)
    with pytest.raises(KeyError, match="frames"):
        jax.eval_shape(lambda p, b: RED.loss_fn(p, b, cfg_ref), ref_params,
                       jax.tree.map(jnp.asarray, batch))
