"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152,
llama-arch small, tied embeddings. [hf:HuggingFaceTB/SmolLM-360M; hf].

Same numbers as ``src/repro/configs/smollm_360m.py``."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
        head_dim=64, d_ff=2560, vocab_size=49152,
        rope_theta=1e4, max_seq_len=8192, tie_embeddings=True,
        vocab_chunks=16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke", family="dense",
        num_layers=2, d_model=60, num_heads=3, num_kv_heads=1,
        head_dim=20, d_ff=128, vocab_size=512, tie_embeddings=True,
        max_seq_len=256, vocab_chunks=4, attn_chunk=32, dtype="float32",
    )
