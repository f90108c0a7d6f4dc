"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256, llama-arch. [arXiv:2401.14196; hf]. rope_theta=1e5 (code ctx),
head_dim 128 (7168 / 56), untied head.

Same numbers as ``src/repro/configs/deepseek_coder_33b.py``."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=19200, vocab_size=32256,
        rope_theta=1e5, max_seq_len=16384, vocab_chunks=16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=160, vocab_size=512,
        max_seq_len=256, vocab_chunks=4, attn_chunk=32, dtype="float32",
    )
