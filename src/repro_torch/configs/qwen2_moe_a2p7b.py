"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H vocab=151936, 60 routed
experts top-4 (d_ff_expert=1408) + shared expert (5632 = 4x1408, matching the
"4 shared" description). Experts padded 60->64 (the router never selects
the pads). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Same numbers as ``src/repro/configs/qwen2_moe_a2p7b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=151936,
        rope_theta=1e6, max_seq_len=32768, vocab_chunks=16,
        moe=MoEConfig(num_experts=60, experts_per_token=4,
                      d_ff_expert=1408, d_ff_shared=5632,
                      capacity_factor=1.25, group_size=512,
                      shard_mode="expert", pad_experts_to=64),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=96, vocab_size=512, max_seq_len=256,
        vocab_chunks=4, attn_chunk=32, dtype="float32",
        moe=MoEConfig(num_experts=6, experts_per_token=2,
                      d_ff_expert=96, d_ff_shared=96,
                      capacity_factor=1.25, group_size=32,
                      shard_mode="expert", pad_experts_to=8),
    )
