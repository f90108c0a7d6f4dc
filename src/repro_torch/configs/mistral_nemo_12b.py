"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf].
head_dim=128 (explicit in the HF config; 32*128=4096 != d_model), untied
head.

Same numbers as ``src/repro/configs/mistral_nemo_12b.py``."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=131072,
        rope_theta=1e6, max_seq_len=131072, vocab_chunks=16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        rope_theta=1e4, max_seq_len=256, vocab_chunks=4,
        attn_chunk=32, dtype="float32",
    )
