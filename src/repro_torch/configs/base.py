"""Configuration dataclasses: the port's own copies of ``ModelConfig``
(reference: ``src/repro/configs/base.py:62-113``) and of the training run's
``ParallelConfig``, ``OptimizerConfig`` and ``RunConfig`` (135-170).

The family sub-configs (MLA, MoE, SSM, xLSTM) are typed loosely here: the
dense slice never reads them, and they are ported with their families.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | mla | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int               # padded to a multiple of 256 (TP-friendly)
    real_vocab_size: int = 0      # 0 -> vocab_size (set when padding applied)
    head_dim: int = 0             # 0 -> d_model // num_heads
    max_seq_len: int = 8192
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"             # silu (SwiGLU) | gelu (plain MLP)
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    pos_embedding: str = "rope"   # rope | learned | sinusoidal
    dtype: str = "bfloat16"
    # family-specific sub-configs
    mla: Optional[Any] = None
    ssm: Optional[Any] = None
    xlstm: Optional[Any] = None
    moe: Optional[Any] = None
    # hybrid: attention block inserted every N ssm blocks (shared weights)
    hybrid_attn_every: int = 0
    # enc-dec
    encoder_layers: int = 0
    encoder_seq_len: int = 1536
    # vlm
    num_patches: int = 0
    # --- paper-technique switches ------------------------------------------
    attn_chunk: int = 1024        # KV chunk for online attention
    vocab_chunks: int = 16        # chunked online cross-entropy factor
    use_chunked_ce: bool = True
    use_online_attention: bool = True
    attn_causal_blocks: int = 0
    kv_cache_dtype: str = ""      # "" = model dtype; "int8" = quantized cache
    # The reference's TPU kernel switch.  The port ignores it: its kernels
    # are chosen by the tensor's device (see ``kernels.dispatch``).
    use_pallas: bool = False
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the mesh.  The port runs on one device: only
    ``grad_reduce_dtype`` and ``microbatches`` are read; the other fields
    keep the reference's names for the distributed slice."""
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    attn_mode: str = "heads"
    seq_sharded_norms: bool = True
    grad_reduce_dtype: str = "bfloat16"
    microbatches: int = 1
    fsdp: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | constant


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0
    checkpoint_dir: str = "/tmp/repro_ckpt"
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
