"""Serving the encoder-decoder (whisper-small) through the port's paged
pool against the JAX package, on the CPU, at the smoke config.

* The cache family: ``EncDecFamily``'s layout, geometry and policy
  (single shot, paged only, the prompt the whole audio).
* A same-audio hit: ``encdec_prefill_cached`` over the cross blocks the
  fresh encode installed gives the decoder caches and the last hidden
  state of ``encdec_prefill`` bit for bit, without the encoder.
* The reference's whole-audio sharing scenario (its
  ``tests/test_serving_families.py``): four requests over two audios, two
  of them together (live sharing), one long after (a prefix-cache revival);
  the port's streams under the reference's noise equal the reference
  scheduler's, the encoder runs twice and the cached path twice, the live
  pair holds the same cross blocks at refcount 2, and ``blocks_shared``,
  ``tokens_reused`` and the rest of the pool's stats equal the
  reference's.
* The refusals: an unpaged scheduler, a prompt that is not the whole
  audio, the serve CLI without ``--paged``.
* The serve CLI's counter lines against the reference CLI's on the same
  flags, with a pool large enough to share; ``decode_step_cost`` of a
  decode step against a hand count.

Token streams compare exactly; the caches of the two prefill paths
bitwise.
"""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import functools
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.launch import serve as RSV  # noqa: E402
from repro.models import encdec as RED  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.obs import kernels as obs_kernels  # noqa: E402
from repro_torch.serving import cache_family, engine, scheduler  # noqa: E402

ARCH = "whisper_small"
SLOT_LEN, BLOCK, CHUNK, TOP_K = 48, 8, 8, 5
BASE_KEY = jax.random.PRNGKey(7)


def ref_noise(rid, i, k):
    """The reference's per-(request, token) Gumbel draw."""
    key = jax.random.fold_in(jax.random.fold_in(BASE_KEY, rid), i)
    return np.array(jax.random.gumbel(key, (k,), jnp.float32))


@functools.lru_cache(maxsize=None)
def _models():
    cfg_ref, cfg = ref_configs.get_smoke(ARCH), configs.get_smoke(ARCH)
    params_ref = jax.jit(lambda key: RL.split_params(
        RED.init(key, cfg_ref))[0])(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, params_ref),
                               device="cpu")
    return params_ref, cfg_ref, params, cfg


def _audio_requests(mod, cfg):
    """The reference test's four requests over two audios: 0 and 1 share
    audio A and arrive together, 3 repeats audio B long after 2 ended."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, cfg.vocab_size, cfg.encoder_seq_len)
    b = rng.integers(0, cfg.vocab_size, cfg.encoder_seq_len)
    spec = [(0, a, 5, 0), (1, a, 4, 0), (2, b, 6, 1), (3, b, 3, 40)]
    return [mod.Request(rid=r, prompt=audio.copy(), max_new_tokens=n,
                        arrival_tick=t) for r, audio, n, t in spec]


def test_family_layout_and_policy():
    """The pools hold a self row of ``slot_len`` and ``block_size`` cross
    positions a block; a table row is the S_enc / BS cross blocks and one
    self row; prefill is single shot, the decoder does not hold the
    prompt, the family serves paged only and pages the encoder output in
    whole blocks."""
    cfg = configs.get_smoke(ARCH)
    fam = cache_family.resolve(cfg)
    assert isinstance(fam, cache_family.EncDecFamily)
    assert fam.kind == "encdec" and fam.requires_paged
    assert fam.single_shot_prefill and not fam.prompt_in_decoder
    assert fam.shareable and engine.paged_supported(cfg)
    pools = fam.init_paged_cache(5, BLOCK, "cpu", slot_len=SLOT_LEN)
    assert {k: tuple(v.shape) for k, v in pools.items()} == {
        "self_k": (2, 5, SLOT_LEN, 4, 16), "self_v": (2, 5, SLOT_LEN, 4, 16),
        "cross_k": (2, 5, BLOCK, 4, 16), "cross_v": (2, 5, BLOCK, 4, 16)}
    assert fam.max_blocks(SLOT_LEN, BLOCK) == 64 // BLOCK + 1
    assert fam.blocks_for_prompt(64, BLOCK) == 64 // BLOCK + 1
    with pytest.raises(ValueError, match="multiple of block_size"):
        fam.validate_geometry(SLOT_LEN, 48)
    with pytest.raises(TypeError, match="slot_len"):
        fam.init_paged_cache(5, BLOCK, "cpu")
    caches = fam.init_cache(2, SLOT_LEN, "cpu")
    assert caches["cross_k"].shape == (2, 2, 64, 4, 16)
    assert set(fam.self_cache(2, SLOT_LEN, "cpu")) == {"self_k", "self_v"}


def test_cached_prefill_is_bit_identical_to_fresh():
    """A fresh prefill installed into a pool, then the cached path over
    the cross blocks it wrote: the last hidden state and every cache leaf
    are bitwise the fresh path's; the install of a hit writes no cross
    block and the decode step's gather reassembles the fresh cross K/V."""
    _, _, params, cfg = _models()
    fam = cache_family.resolve(cfg)
    pools = fam.init_paged_cache(20, BLOCK, "cpu", slot_len=SLOT_LEN)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, 64)
    bos = torch.full((1, 1), engine.ENCDEC_BOS)
    frames = engine.encdec_frames_from_ids(ids, cfg, "cpu")
    nc = 64 // BLOCK
    cross = torch.arange(3, 3 + nc)
    with torch.no_grad():
        h_fresh, c_fresh, n = engine.encdec_prefill(params, frames, bos, cfg,
                                                    max_len=SLOT_LEN)
        engine.install_encdec_row(pools, c_fresh, cross, torch.tensor([1]))
        before = {k: v.clone() for k, v in pools.items()}
        got = engine.gather_encdec_cross(pools, cross)
        h_hit, c_hit, n_hit = engine.encdec_prefill_cached(
            params, got, bos, cfg, max_len=SLOT_LEN)
        engine.install_encdec_row(pools, c_hit, torch.full((nc,), 20),
                                  torch.tensor([2]))
    assert n == n_hit == 1 and torch.equal(h_fresh, h_hit)
    for name in c_fresh:
        assert torch.equal(c_fresh[name], c_hit[name]), name
    for name in ("cross_k", "cross_v"):
        assert torch.equal(pools[name], before[name]), name
    assert torch.equal(pools["self_k"][:, 2], c_fresh["self_k"][:, 0])
    rows = engine.gather_encdec_rows(pools, torch.stack([cross, cross]),
                                     torch.tensor([1, 2]))
    assert torch.equal(rows["cross_v"][:, 1], c_fresh["cross_v"][:, 0])


def test_sharing_scenario_equals_reference_scheduler(monkeypatch):
    """The reference's whole-audio sharing scenario through both
    schedulers: the streams, the encoder runs (2 fresh, 2 cached), the
    live sharing at refcount 2, and the pool's stats."""
    params_ref, cfg_ref, params, cfg = _models()
    geom = dict(num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
                top_k=TOP_K, paged=True, block_size=BLOCK,
                num_blocks=4 * (cfg.encoder_seq_len // BLOCK + 1))
    want = RS.ContinuousScheduler(params_ref, cfg_ref, base_rng=BASE_KEY,
                                  **geom).run(_audio_requests(RS, cfg_ref))
    calls = {"fresh": 0, "cached": 0}
    for name, key in (("encdec_prefill", "fresh"),
                      ("encdec_prefill_cached", "cached")):
        real = getattr(engine, name)
        monkeypatch.setattr(engine, name, functools.partial(
            lambda real, key, *a, **kw: calls.__setitem__(
                key, calls[key] + 1) or real(*a, **kw), real, key))
    sched = scheduler.ContinuousScheduler(params, cfg, noise_fn=ref_noise,
                                          device="cpu", **geom)
    for r in _audio_requests(scheduler, cfg):
        sched.submit(r)
    nc = cfg.encoder_seq_len // BLOCK
    saw_live_sharing = False
    while sched.busy:
        sched.tick()
        live = list(sched.pool.seqs.values())
        if len(live) == 2 and live[0].blocks[:nc] == live[1].blocks[:nc]:
            assert all(sched.pool.alloc.refcount(bid) == 2
                       for bid in live[0].blocks[:nc])
            assert live[0].blocks[nc] != live[1].blocks[nc]
            saw_live_sharing = True
    assert saw_live_sharing
    got = {r.rid: r.tokens for r in sched.finished}
    assert got == {r.rid: r.tokens for r in want.results}
    assert len({t for s in got.values() for t in s}) > 1
    assert calls == {"fresh": 2, "cached": 2}
    st = sched.pool.stats()
    assert st["blocks_shared"] == 2 * nc
    assert st["tokens_reused"] == 2 * cfg.encoder_seq_len
    assert st["prefix_cache_hits"] >= nc
    for k in ("blocks_shared", "tokens_reused", "prefix_cache_hits",
              "cached_blocks", "free_blocks", "min_free_blocks",
              "reclaimed_blocks", "cow_copies"):
        assert st[k] == want.paged[k], k
    assert sched.decode_steps == want.decode_steps
    assert sched.prefill_chunks == want.prefill_chunks == 4
    sched.pool.alloc.check_invariants()


def test_refuses_unpaged_and_partial_audio():
    """An unpaged scheduler raises the reference's ``ValueError``, and so
    does a prompt one frame short of the encoder window; the serve CLI
    refuses whisper without ``--continuous --paged``."""
    _, _, params, cfg = _models()
    with pytest.raises(ValueError, match="paged"):
        scheduler.ContinuousScheduler(params, cfg, num_slots=2,
                                      slot_len=SLOT_LEN, device="cpu")
    sched = scheduler.ContinuousScheduler(
        params, cfg, num_slots=2, slot_len=SLOT_LEN, prefill_chunk=CHUNK,
        top_k=TOP_K, paged=True, block_size=BLOCK, device="cpu")
    with pytest.raises(ValueError, match=str(cfg.encoder_seq_len)):
        sched.submit(scheduler.Request(
            rid=0, prompt=np.zeros(cfg.encoder_seq_len - 1, np.int64),
            max_new_tokens=2))
    for flags in ([], ["--continuous"]):
        with pytest.raises(SystemExit, match="--continuous --paged"):
            serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"]
                       + flags)


_COUNTER_LINES = re.compile(
    r"^(paged continuous batching|decode steps|batch occupancy|block "
    r"pool|blocks saved by sharing|prefix cache):.*$", re.M)


def test_cli_counters_equal_reference_cli(capsys):
    """``--arch whisper_small --smoke --continuous --paged`` with the
    default 3 audios over 7 requests and a pool of 60 blocks: the counter
    lines equal the reference CLI's, and the repeats of an audio shared
    its 8 cross blocks (tokens reused = hits × 64)."""
    argv = ["--arch", ARCH, "--smoke", "--continuous", "--paged",
            "--device", "cpu", "--requests", "7", "--tokens", "6",
            "--slots", "2", "--rate", "3.0", "--blocks", "60"]
    assert serve.main(argv) == 0
    mine = capsys.readouterr().out
    assert RSV.main([a for a in argv if a not in ("--device", "cpu")]) == 0
    theirs = capsys.readouterr().out
    lines = [m.group(0) for m in _COUNTER_LINES.finditer(mine)]
    assert len(lines) == 6
    assert lines == [m.group(0) for m in _COUNTER_LINES.finditer(theirs)]
    assert "prefill chunks: 7" in mine
    shared = int(re.search(r"blocks saved by sharing: (\d+) \(prefill "
                           r"tokens reused: (\d+)", mine).group(1))
    reused = int(re.search(r"prefill tokens reused: (\d+)", mine).group(1))
    assert shared > 0 and reused == shared // 8 * 64


def test_decode_step_cost_hand_counted():
    """``decode_step_cost`` of the smoke config at B 3 over live self
    lengths [5, 2]: each of the 2 decoder layers' self q, k, v, o, the
    cross q and o, the GELU MLP's two matrices, the attention over the 7
    live self keys and 2 × 64 cross keys, their K/V read once, and the
    tied head with its fp32 logits."""
    cfg = configs.get_smoke(ARCH)
    d, v, b = cfg.d_model, cfg.vocab_size, 3
    layer = 4 * d * 64 + 2 * 64 * d + 2 * d * 128
    keys = 7 + 2 * 64
    flops = 2 * (2 * layer * b + 4 * 4 * 16 * keys) + 2 * d * v * b
    nbytes = 2 * (layer * 4 + keys * 2 * 4 * 16 * 4) + d * v * 4 + b * v * 4
    cost = obs_kernels.decode_step_cost(cfg, b, [5, 2])
    assert cost == {"flops": float(flops), "bytes_accessed": float(nbytes),
                    "dtype": "float32"}
