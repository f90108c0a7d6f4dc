"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8)
vocab=202048, MoE 16 experts top-1 (d_ff_expert=8192) + one shared expert
(8192), all layers MoE.  Text backbone only. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Same numbers as ``src/repro/configs/llama4_scout_17b_a16e.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        rope_theta=5e5, max_seq_len=131072, vocab_chunks=16,
        moe=MoEConfig(num_experts=16, experts_per_token=1,
                      d_ff_expert=8192, d_ff_shared=8192,
                      capacity_factor=1.25, group_size=512,
                      shard_mode="expert"),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, max_seq_len=256,
        vocab_chunks=4, attn_chunk=32, dtype="float32",
        moe=MoEConfig(num_experts=4, experts_per_token=1,
                      d_ff_expert=96, d_ff_shared=96,
                      capacity_factor=1.25, group_size=32,
                      shard_mode="expert"),
    )
