"""Decoder-only LM for the dense, MoE, MLA and recurrent block kinds (a
VLM is a dense stack that takes patch embeddings): init, forward,
training loss, decode logits.

Port of ``src/repro/models/transformer.py``: ``block_pattern`` (line 41,
the xLSTM and hybrid patterns at 48-73), ``block_apply`` (114; dense
takes the MLP, moe ``layers.moe_apply``, at 150-154; mla
``layers.mla_apply`` and the MLP, rejecting block tables as at 133-135, as
do the recurrent kinds; mamba ``ssm.mamba2_apply`` after a norm, mlstm and
slstm their ``xlstm`` blocks, 155-164), ``init`` (176; the port's own
seeded initialiser with the reference's shapes and scales, a VLM's
``mm_proj`` as at 186-188), ``forward`` (217; a VLM's patch embeddings
projected and prepended as at 230-232; a Python loop over layers in place
of ``lax.scan``, each layer under ``torch.utils.checkpoint`` where the
reference's ``_maybe_remat`` put it under ``jax.checkpoint``, with its two
policies, the MoE aux losses summed over layers as at 270-272; zamba2's
one shared block called at every ``shared_attn`` segment), ``loss_fn``
(280, which drops a VLM batch's patch positions as at 284-285 and adds
the aux losses over ``num_layers``) and ``logits_last`` (306, which casts
to fp32 before the head product as at line 309).

Parameters are a plain dict::

    {"embed": [V, D], ("head": [D, V] when untied,) ("mm_proj": [D, D]
     for a VLM,) "final_norm": [D],
     "layers": [{"ln1": [D], "attn": {"wq", "wk", "wv", "wo"},
                 "ln2": [D], "mlp": {"w_gate", "w_up", "w_down"}}, ...]}

An MoE layer holds ``"moe": {"router": [D, E] float32, "w_gate", "w_up":
[E_pad, D, F], "w_down": [E_pad, F, D], ("shared": {"w_gate", "w_up",
"w_down"}, an MLP of d_ff_shared)}`` in place of ``"mlp"``.  An MLA layer's
``"attn"`` is ``{"wdq": [D, Rq], "q_norm": [Rq], "wuq": [Rq, H·(Dn+Dr)],
"wdkv": [D, R+Dr], "kv_norm": [R], "wuk": [R, H·Dn], "wuv": [R, H·Dv],
"wo": [H·Dv, D]}`` (``layers.mla_apply``).  The recurrent families
(``ssm``: xLSTM, ``hybrid``: zamba2) list their blocks in ``"layers"`` in
stack order: a mamba layer ``{"ln": [D], "mamba": {...}}``
(``ssm.mamba2_init``), an mlstm or slstm layer the block's own dict
(``xlstm.mlstm_block_init`` / ``slstm_block_init``); a hybrid model adds
``"shared_attn"``, one dense layer's dict, whose weights every
``shared_attn`` segment calls.  Norm scales, the router and the leaves
the reference creates in fp32 (``FP32_LEAVES``) stay float32; the rest
takes ``cfg.dtype``.

Caches are a flat dict of leaves whose axis 0 is the layer and axis 1 the
batch (or the pool's block): attention leaves (``"k"``, ``"v"``, ...) one
entry per attention layer (zamba2: per shared-block call), and the state
leaves of each recurrent kind (``STATE_LEAVES``) one entry per layer of
that kind.  ``layer_plan`` maps each layer to its kind and to its index
among the layers of that kind.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import core
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tp_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm, xlstm

Tensor = torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


#: Leaves that keep float32 whatever ``cfg.dtype`` is: the norm scales
#: (an encoder-decoder's LayerNorm dicts among them), the router, and what
#: the reference's recurrent blocks create in fp32 (the convs, the SSD's
#: ``dt_bias`` / ``a_log`` / ``d_skip``, the mLSTM's gate weights and bias,
#: the sLSTM's gate and recurrent weights).
FP32_LEAVES = ("ln1", "ln2", "ln", "final_norm", "router", "q_norm",
               "kv_norm", "norm", "hnorm", "conv_x", "conv_b", "conv_c",
               "conv", "dt_bias", "a_log", "d_skip", "w_if", "if_bias",
               "w_gates", "r_weights", "lnx", "enc_norm", "dec_norm")

#: The recurrent kinds' cache leaves (the attention kinds take the rest).
STATE_LEAVES = {"mamba": ssm.CACHE_LEAVES, "mlstm": xlstm.MLSTM_LEAVES,
                "slstm": xlstm.SLSTM_LEAVES}


def block_pattern(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The segments (kind, count) of ``cfg``'s stack, the reference's: an
    xLSTM stack puts an sLSTM at every i with i % slstm_every ==
    slstm_every - 1; a hybrid one calls its shared block after every
    ``hybrid_attn_every`` mamba layers and once more to close the stack."""
    if cfg.family in ("dense", "vlm"):
        return [("dense", cfg.num_layers)]
    if cfg.family == "mla":
        return [("mla", cfg.num_layers)]
    if cfg.family == "moe":
        return [("moe", cfg.num_layers)]
    if cfg.family == "ssm":
        segs: list[tuple[str, int]] = []
        run = 0
        for i in range(cfg.num_layers):
            if xlstm.is_slstm(cfg, i):
                if run:
                    segs.append(("mlstm", run))
                    run = 0
                segs.append(("slstm", 1))
            else:
                run += 1
        if run:
            segs.append(("mlstm", run))
        return segs
    if cfg.family == "hybrid":
        segs = []
        remaining = cfg.num_layers
        while remaining > 0:
            n = min(cfg.hybrid_attn_every, remaining)
            segs += [("mamba", n), ("shared_attn", 1)]
            remaining -= n
        return segs
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1)")


@functools.lru_cache(maxsize=None)
def layer_plan(cfg: ModelConfig) -> tuple:
    """The forward's walk: one (kind, index into ``params["layers"]`` or
    None for the shared block, index among the layers of the same cache
    group) a layer, in stack order.  The attention kinds (dense, moe, mla,
    shared_attn) share one group: zamba2's shared-block calls are its
    attention layers 0, 1, ...; each recurrent kind is a group of its
    own."""
    plan, layer, seen = [], 0, {}
    for kind, count in block_pattern(cfg):
        group = kind if kind in STATE_LEAVES else "attn"
        for _ in range(count):
            j = seen.get(group, 0)
            seen[group] = j + 1
            if kind == "shared_attn":
                plan.append((kind, None, j))
            else:
                plan.append((kind, layer, j))
                layer += 1
    return tuple(plan)


def layer_counts(cfg: ModelConfig) -> dict:
    """How many layers each cache group holds: {"attn": attention layers
    (shared-block calls included), "mamba" | "mlstm" | "slstm": ...}."""
    out: dict = {}
    for kind, _, _ in layer_plan(cfg):
        group = kind if kind in STATE_LEAVES else "attn"
        out[group] = out.get(group, 0) + 1
    return out


def init(cfg: ModelConfig, *, seed: int = 0,
         device: Union[str, torch.device] = "cuda",
         draw_device: Union[str, torch.device] = "cpu") -> dict:
    """Random weights from ``seed``: normal with scale 1/sqrt(fan_in) for
    projections and 1 for the embedding, ones for norm scales — the
    reference's ``_dense_init`` shapes and scales, the untied ``head``,
    the MoE leaves (the fp32 router [D, E]; the experts [E_pad, D, F] /
    [E_pad, F, D] at 1/sqrt(E_pad), the reference's fan-in of a stacked
    leaf; the shared expert's MLP) and the MLA leaves (``mla_init``'s
    shapes, each at 1/sqrt(its first axis), the fp32 ``q_norm`` /
    ``kv_norm`` ones) and a VLM's ``mm_proj`` [D, D] at 1/sqrt(D)
    included.  Each tensor is drawn in
    fp32 on ``draw_device`` from one seeded ``torch.Generator`` there, then
    cast to ``cfg.dtype`` (the router: kept fp32) on ``device``.  The
    default draws on the CPU, so a seed gives the same weights on every
    device (what the CPU-vs-card parity runs need);
    ``draw_device="cuda"`` draws on the card, with other numbers from the
    same seed, for full-width card runs: a 12B model's ~1.2e10 CPU draws
    take over a minute, the card's well under a second
    (``tools/init_times.py``)."""
    kind = block_pattern(cfg)[0][0]
    gen = torch.Generator(device=draw_device).manual_seed(seed)
    dt = DTYPES[cfg.dtype]
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def dense(shape, scale=None, dtype=dt):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, device=draw_device)
        return w.mul_(scale).to(device=device, dtype=dtype)

    def ones():
        return torch.ones(d, device=device)

    def mlp(ff):
        p = {"w_up": dense((d, ff)), "w_down": dense((ff, d))}
        if cfg.act == "silu":
            p["w_gate"] = dense((d, ff))
        return p

    def attention():
        if kind != "mla":
            return {"wq": dense((d, hq * hd)), "wk": dense((d, hkv * hd)),
                    "wv": dense((d, hkv * hd)), "wo": dense((hq * hd, d))}
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {"wdq": dense((d, m.q_lora_rank)),
                "q_norm": torch.ones(m.q_lora_rank, device=device),
                "wuq": dense((m.q_lora_rank, hq * qk)),
                "wdkv": dense((d, m.kv_lora_rank + m.qk_rope_head_dim)),
                "kv_norm": torch.ones(m.kv_lora_rank, device=device),
                "wuk": dense((m.kv_lora_rank, hq * m.qk_nope_head_dim)),
                "wuv": dense((m.kv_lora_rank, hq * m.v_head_dim)),
                "wo": dense((hq * m.v_head_dim, d))}

    def moe():
        mc = cfg.moe
        e, ff = mc.pad_experts_to or mc.num_experts, mc.d_ff_expert
        p = {"router": dense((d, mc.num_experts), dtype=torch.float32),
             "w_gate": dense((e, d, ff)), "w_up": dense((e, d, ff)),
             "w_down": dense((e, ff, d))}
        if mc.d_ff_shared:
            p["shared"] = mlp(mc.d_ff_shared)
        return p

    def dense_layer():
        # the feed-forward leaves are drawn before the attention's
        ffn = {"moe": moe()} if kind == "moe" else {"mlp": mlp(f)}
        return {"ln1": ones(), "attn": attention(), "ln2": ones(), **ffn}

    def ones_n(n):
        return torch.ones(n, device=device)

    def draw(shape, scale=None, dtype=None):
        return dense(shape, scale, dt if dtype is None else dtype)

    recurrent = {
        "mamba": lambda: {"ln": ones(),
                          "mamba": ssm.mamba2_init(cfg, draw, ones_n,
                                                   device)},
        "mlstm": lambda: xlstm.mlstm_block_init(cfg, draw, ones_n, device),
        "slstm": lambda: xlstm.slstm_block_init(cfg, draw, ones_n, device)}

    params = {"embed": dense((v, d), scale=1.0)}
    if not cfg.tie_embeddings:
        params["head"] = dense((d, v))
    if cfg.num_patches:
        params["mm_proj"] = dense((d, d))
    params["final_norm"] = ones()
    layers = []
    for kind_i, idx, _ in layer_plan(cfg):
        if idx is None:
            if "shared_attn" not in params:
                params["shared_attn"] = dense_layer()
        elif kind_i in recurrent:
            layers.append(recurrent[kind_i]())
        else:
            layers.append(dense_layer())
    params["layers"] = layers
    return params


def params_to(params, device=None, dtype=None):
    """Copy a parameter tree to ``device``; ``dtype`` recasts the projection
    and embedding weights (norm scales and the router stay float32)."""
    if isinstance(params, dict):
        return {k: (params_to(v, device, None) if k in FP32_LEAVES
                    else params_to(v, device, dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device, dtype) for v in params]
    return params.to(device=device, dtype=dtype)


def forward(params: dict, tokens: Tensor, cfg: ModelConfig, *,
            patch_embeds: Optional[Tensor] = None,
            caches: Optional[dict] = None,
            cache_len: Optional[Union[int, Tensor]] = None,
            block_tables: Optional[Tensor] = None, return_aux: bool = False):
    """tokens [B, T] → (hidden [B, T', D], caches), and with ``return_aux``
    a third item: the MoE aux losses (``moe_lb_loss``, ``moe_z_loss``)
    summed over layers, ``{}`` for a dense model.

    VLM (``cfg.num_patches``): ``patch_embeds`` [B, P, D] are cast to the
    model dtype, projected by ``mm_proj`` and prepended to the token
    embeddings, so T' = P + T and the positions run over all T'; without
    them (or for another family) T' = T.

    ``block_tables`` [B, M]: paged KV serving — ``caches`` holds the block
    pools ``{"k", "v": [L, P, Hkv, BS, D]}`` (no batch axis; see
    ``serving.engine.init_paged_cache``) and every attention layer writes and
    reads through the table, in place.  ``cache_len`` is an int (one
    sequence) or a [B] tensor (per-slot offsets).  Layer i sees leaf ``[i]``
    of every cache leaf, so an int8 cache's scales travel with its K/V.

    Without caches, under a context whose mesh has the model axis, a
    dense, MoE, MLA or recurrent model's ``params`` are this rank's shards
    and the layers run tensor-parallel (``tensor_parallel.model_axis``;
    zamba2's shared block as a dense layer); the hidden state and the aux
    losses come back whole on every rank."""
    tp = tp_mod.model_axis(cfg) if caches is None else None
    x = L.embed_tokens(params, tokens, tp)
    if cfg.num_patches and patch_embeds is not None:
        pe = patch_embeds.to(x.dtype) @ params["mm_proj"]
        x = torch.cat([pe, x], dim=1)
    t = x.shape[1]
    base = torch.as_tensor(cache_len if cache_len is not None else 0,
                           dtype=torch.int64, device=x.device)
    # scalar base → positions [T]; per-slot base [B] → positions [B, T]
    positions = base[..., None] + torch.arange(t, device=x.device)
    remat = _remat(cfg, training=caches is None and torch.is_grad_enabled())
    aux_total: dict = {}
    for kind, idx, j in layer_plan(cfg):
        lp = params["shared_attn"] if idx is None else params["layers"][idx]
        cache = None
        if caches is not None:
            own = STATE_LEAVES.get(kind)
            cache = {name: leaf[j] for name, leaf in caches.items()
                     if (name in own if own else
                         name not in _ALL_STATE_LEAVES)}
        layer = functools.partial(_block_apply, kind=kind, cfg=cfg,
                                  positions=positions, cache=cache,
                                  cache_len=cache_len,
                                  block_tables=block_tables, aux=return_aux,
                                  tp=tp)
        x, aux = remat(layer, lp, x)
        for name, val in aux.items():
            aux_total[name] = aux_total.get(name, 0.0) + val
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return (x, caches, aux_total) if return_aux else (x, caches)


_ALL_STATE_LEAVES = frozenset(n for leaves in STATE_LEAVES.values()
                              for n in leaves)


def _block_apply(lp: dict, x: Tensor, *, kind: str, cfg: ModelConfig,
                 positions, cache, cache_len, block_tables, aux: bool,
                 tp=None):
    """One block: [norm → GQA attention] + [norm → SwiGLU MLP] (dense, and
    zamba2's shared block), [norm → mixture of experts] (moe), or [norm →
    latent attention] + [norm → SwiGLU MLP] (mla, which takes no block
    tables: its latent cache is contiguous only, as the reference's); x +
    [norm → Mamba2] (mamba); the xLSTM blocks, which hold their own norms
    and residuals (mlstm, slstm).  The recurrent kinds take no block tables
    either, and ignore ``positions`` and ``cache_len``.  ``tp``: the model
    axis a block runs on (``tensor_parallel.model_axis``; the norms act on
    the replicated activations, each sublayer on the rank's shards: a
    Mamba2 block's SSM heads, an mLSTM's inner channels, an sLSTM's ffn).
    Returns (x, the MoE aux losses when ``aux``, else {})."""
    if kind in STATE_LEAVES:
        if block_tables is not None:
            raise ValueError("paged KV cache serves standard attention "
                             f"blocks only (got {kind!r})")
        if kind == "mamba":
            y, _ = ssm.mamba2_apply(lp["mamba"],
                                    L.rms_norm(lp["ln"], x, cfg.norm_eps),
                                    cfg, cache=cache, tp=tp)
            return x + y, {}
        block = (xlstm.mlstm_block_apply if kind == "mlstm"
                 else xlstm.slstm_block_apply)
        return block(lp, x, cfg, cache=cache, tp=tp)[0], {}
    h = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
    if "wdkv" in lp["attn"]:
        if block_tables is not None:
            raise ValueError("paged KV cache serves standard attention "
                             "blocks only (got 'mla')")
        a, _ = L.mla_apply(lp["attn"], h, cfg, positions=positions,
                           cache=cache, cache_len=cache_len, tp=tp)
    else:
        a, _ = L.attention_apply(lp["attn"], h, cfg, positions=positions,
                                 cache=cache, cache_len=cache_len,
                                 block_tables=block_tables, tp=tp)
    x = x + a
    h = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        m, losses = L.moe_apply(lp["moe"], h, cfg, aux=aux, tp=tp)
        return x + m, losses
    return x + L.mlp_apply(lp["mlp"], h, cfg, tp), {}


#: What remat "block" keeps of a layer's forward: the outputs of products
#: without batch dims (the projections, the MLP, the MoE router), as the
#: reference's ``dots_with_no_batch_dims_saveable``; a 3-D activation times
#: a weight matrix reaches autograd as one of these.  Everything else is
#: recomputed: batched products (attention's, the experts' and the one-hot
#: dispatch and combine), norms, RoPE, the attention kernels.
UNBATCHED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat(cfg: ModelConfig, *, training: bool):
    """How a layer runs on a training forward, as the reference's
    ``_maybe_remat`` (``src/repro/models/transformer.py:207``): directly for
    ``remat="none"``; under ``torch.utils.checkpoint`` for ``"full"`` (the
    whole layer recomputed in the backward, ``nothing_saveable``) and for
    any other value, such as ``"block"``, with the selective policy that
    saves ``UNBATCHED_PRODUCTS``.  Serving forwards (with caches) never
    recompute (``_maybe_remat(inference=True)``)."""
    if not training or cfg.remat == "none":
        return lambda fn, *args: fn(*args)
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, list(UNBATCHED_PRODUCTS))}
    return functools.partial(checkpoint, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """batch: tokens [B, T], labels [B, T] (−1 = masked) → (mean CE over the
    unmasked labels plus each MoE aux loss over ``num_layers``, {"ce_loss",
    the aux losses, "loss"}).  The tied head's gradient reaches ``embed``
    through both the token gather and the head product.  A VLM batch may
    carry ``patch_embeds`` [B, P, D]: they are prepended (``forward``) and
    the P patch positions dropped before the CE, so the labels cover the
    text alone.

    On the model axis (``tensor_parallel.model_axis``) the head is this
    rank's [D, V/M] columns, tied or untied, and the CE is
    ``core.vocab_parallel_cross_entropy`` (chunked over V/M in
    gcd(``vocab_chunks``, V/M) chunks; the loss does not depend on it): the
    loss and metrics come out the same on every model rank.
    ``use_chunked_ce=False`` raises there."""
    hidden, _, aux = forward(params, batch["tokens"], cfg,
                             patch_embeds=batch.get("patch_embeds"),
                             return_aux=True)
    if cfg.num_patches and "patch_embeds" in batch:
        hidden = hidden[:, cfg.num_patches:]        # the text positions
    d = hidden.shape[-1]
    labels = batch["labels"].reshape(-1).long()
    w = L.head_matrix(params, cfg)
    h2 = hidden.reshape(-1, d)
    valid = labels >= 0
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    tp = tp_mod.model_axis(cfg)
    if tp is not None and not cfg.use_chunked_ce:
        raise NotImplementedError("the model axis takes the chunked CE only "
                                  "(use_chunked_ce=False materializes the "
                                  "whole vocabulary's logits)")
    if tp is not None and tp.shards("vocab"):
        n = w.shape[1]
        tok_loss = core.vocab_parallel_cross_entropy(
            h2, w, safe_labels, vocab_start=tp.index * n, group=tp.group,
            num_chunks=math.gcd(cfg.vocab_chunks, n))
    elif cfg.use_chunked_ce:
        tok_loss = core.chunked_cross_entropy(h2, w, safe_labels,
                                              num_chunks=cfg.vocab_chunks)
    else:
        tok_loss = core.full_cross_entropy(h2, w, safe_labels)
    denom = valid.sum().clamp(min=1)
    ce = (tok_loss * valid).sum() / denom
    loss = ce
    for val in aux.values():
        loss = loss + val / max(cfg.num_layers, 1)
    return loss, {"ce_loss": ce, **aux, "loss": loss}


def logits_last(params: dict, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    """LM-head logits for the last position only (decode path), in fp32."""
    w = L.head_matrix(params, cfg)
    return hidden[:, -1].float() @ w.float()
