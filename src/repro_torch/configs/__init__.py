"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Only the architectures the port serves are listed: the dense decoders
smollm-360m (head_dim 64, tied head), mistral-nemo-12b and
deepseek-coder-33b (head_dim 128, untied heads), the MoE decoders
qwen2-moe-a2.7b and llama4-scout-17b-a16e (head_dim 128), the MLA
decoder minicpm3-4b (latent attention), the recurrent decoders
zamba2-1.2b (Mamba2 with a shared attention block) and xlstm-125m (mLSTM
and sLSTM), the encoder-decoder whisper-small and the VLM llava-next-34b
(a dense decoder that takes patch embeddings): every architecture of
the reference's registry.  Asking for another one raises.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (MLAConfig, ModelConfig,  # noqa: F401
                                     MoEConfig, SSMConfig, XLSTMConfig)

ARCHS = ("smollm_360m", "mistral_nemo_12b", "deepseek_coder_33b",
         "qwen2_moe_a2p7b", "llama4_scout_17b_a16e", "minicpm3_4b",
         "zamba2_1p2b", "xlstm_125m", "whisper_small", "llava_next_34b")

_ALIASES = {"smollm-360m": "smollm_360m",
            "mistral-nemo-12b": "mistral_nemo_12b",
            "deepseek-coder-33b": "deepseek_coder_33b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
            "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
            "minicpm3-4b": "minicpm3_4b",
            "zamba2-1.2b": "zamba2_1p2b",
            "xlstm-125m": "xlstm_125m",
            "whisper-small": "whisper_small",
            "llava-next-34b": "llava_next_34b"}


def _module(name: str):
    name = _ALIASES.get(name, name).replace("-", "_")
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported: the port serves {ARCHS}, every "
            "architecture of the reference's registry")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    """Full (assigned) config for ``--arch <name>``."""
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke()
