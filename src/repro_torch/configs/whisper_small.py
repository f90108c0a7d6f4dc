"""whisper-small [audio] — enc-dec, 12 encoder + 12 decoder layers,
d_model=768 12H d_ff=3072 vocab=51865 (padded to 51968).  The conv
frontend is a stub: the frames are precomputed embeddings [B, 1500->1536,
768].  LayerNorm + GELU, learned decoder positions, tied embeddings.
[arXiv:2212.04356; unverified].

Same numbers as ``src/repro/configs/whisper_small.py``."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        num_layers=12, encoder_layers=12, encoder_seq_len=1536,
        d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=51968, real_vocab_size=51865,
        act="gelu", norm_type="layernorm", pos_embedding="learned",
        tie_embeddings=True, max_seq_len=32768, vocab_chunks=16,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", family="encdec",
        num_layers=2, encoder_layers=2, encoder_seq_len=64,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, act="gelu", norm_type="layernorm",
        pos_embedding="learned", tie_embeddings=True, max_seq_len=256,
        vocab_chunks=4, attn_chunk=32, dtype="float32",
    )
