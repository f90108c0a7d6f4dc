"""zamba2-1.2b [hybrid] — 38L d_model=2048, Mamba2 backbone (ssm_state=64)
with a SHARED transformer block (32H kv=32, d_ff=8192) invoked every 6 mamba
blocks (and once more to close the stack: 7 calls).  Zamba2's
per-invocation LoRA deltas on the shared block are omitted (weight sharing
kept). [arXiv:2411.15242; hf].

Same numbers as ``src/repro/configs/zamba2_1p2b.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        head_dim=64, d_ff=8192, vocab_size=32000, max_seq_len=1 << 20,
        vocab_chunks=16, hybrid_attn_every=6,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, max_seq_len=512,
        vocab_chunks=4, hybrid_attn_every=2, dtype="float32",
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=16),
    )
