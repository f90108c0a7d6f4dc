"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304, d_ff=0 (blocks carry
their own projections).  sLSTM + mLSTM mix: sLSTM at every 6th block
(indices 5, 11), the rest mLSTM. [arXiv:2405.04517].

Same numbers as ``src/repro/configs/xlstm_125m.py``."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304, max_seq_len=1 << 20,
        vocab_chunks=16, tie_embeddings=False,
        xlstm=XLSTMConfig(num_heads=4, expand=2, chunk=256, slstm_every=6,
                          conv_width=4),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=512, max_seq_len=512,
        vocab_chunks=4, dtype="float32",
        xlstm=XLSTMConfig(num_heads=2, expand=2, chunk=16, slstm_every=2,
                          conv_width=4),
    )
