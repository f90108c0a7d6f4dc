"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 (Yi-34B-class backbone), head_dim 128 (7168 / 56), untied
head.  The vision tower is a stub, as in the reference: the model takes
precomputed patch embeddings, 5 anyres tiles x 576 = 2880 patches
prepended to the text through ``mm_proj``.

Same numbers as ``src/repro/configs/llava_next_34b.py``."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=20480, vocab_size=64000,
        rope_theta=5e6, max_seq_len=32768, vocab_chunks=16,
        num_patches=2880,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, max_seq_len=256,
        vocab_chunks=4, attn_chunk=32, dtype="float32", num_patches=16,
    )
