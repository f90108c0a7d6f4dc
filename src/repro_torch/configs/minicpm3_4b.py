"""minicpm3-4b [dense/MLA] — 62L d_model=2560 40H d_ff=6400 vocab=73448 (padded
to 73728 = 288*256 for 16-way TP).  MLA dims per hf:openbmb/MiniCPM3-4B:
q_lora_rank=768, kv_lora_rank=256, qk_nope=64, qk_rope=32, v_head_dim=64.

Same numbers as ``src/repro/configs/minicpm3_4b.py``."""
from repro_torch.configs.base import MLAConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b", family="mla",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=6400, vocab_size=73728, real_vocab_size=73448,
        rope_theta=1e4, max_seq_len=32768, vocab_chunks=16,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke", family="mla",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512,
        max_seq_len=256, vocab_chunks=4, attn_chunk=32, dtype="float32",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
    )
