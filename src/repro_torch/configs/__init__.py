"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Only the architectures the port serves are listed: the dense decoders
smollm-360m (head_dim 64, tied head), mistral-nemo-12b and
deepseek-coder-33b (head_dim 128, untied heads).  Asking for another one
raises and names the reference module it still lives in.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCHS = ("smollm_360m", "mistral_nemo_12b", "deepseek_coder_33b")

_ALIASES = {"smollm-360m": "smollm_360m",
            "mistral-nemo-12b": "mistral_nemo_12b",
            "deepseek-coder-33b": "deepseek_coder_33b"}


def _module(name: str):
    name = _ALIASES.get(name, name).replace("-", "_")
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (the port serves {ARCHS}; the "
            f"reference config is repro.configs.{name})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    """Full (assigned) config for ``--arch <name>``."""
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke()
