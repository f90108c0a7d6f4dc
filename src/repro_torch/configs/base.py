"""Configuration dataclasses: the port's own copies of ``MLAConfig``
(reference: ``src/repro/configs/base.py:15-21``), ``SSMConfig`` (24-34),
``XLSTMConfig`` (37-44), ``MoEConfig`` (47-60), ``ModelConfig`` (62-113)
and of the training run's ``ParallelConfig``, ``OptimizerConfig`` and
``RunConfig`` (135-170).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block configuration."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    # dt (timestep) softplus bias init range
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block configuration (mLSTM + sLSTM mix)."""
    num_heads: int = 4
    expand: int = 2          # mLSTM up-projection factor
    chunk: int = 256         # mLSTM chunked-parallel block length
    slstm_every: int = 6     # sLSTM where i % slstm_every == slstm_every - 1
    conv_width: int = 4


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    experts_per_token: int = 2
    d_ff_expert: int = 0          # per-expert hidden dim
    d_ff_shared: int = 0          # shared-expert hidden dim (0 = none)
    capacity_factor: float = 1.25
    group_size: int = 512         # dispatch group (tokens) for one-hot einsum
    router_z_loss: float = 1e-3
    # "expert": shard expert axis over model (pad experts up if needed)
    # "ffn":    shard each expert's hidden dim over model
    shard_mode: str = "expert"
    pad_experts_to: int = 0       # 0 = no padding


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
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    moe: Optional[MoEConfig] = None
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
    """How the model maps onto the mesh.  The port reads
    ``grad_reduce_dtype`` and ``microbatches`` (the train step),
    ``data_axes`` (the data-parallel all-reduce and ``HostShardedLoader``'s
    rows), ``model_axis`` (the vocabulary-sharded sampler) and
    ``attn_mode`` (``distributed.sharding``'s placements).
    ``seq_sharded_norms`` and ``fsdp`` keep the reference's names for the
    model axis's execution, not ported yet."""
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
