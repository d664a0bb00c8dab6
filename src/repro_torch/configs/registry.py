"""Config registry: ``get_config("<arch-id>")`` + per-shape input specs.

Counterpart of ``repro.configs.registry``.  The port carries every
architecture's config file, copied field for field (``PORTED`` is all of
``ARCHS``); an unknown name raises ``ValueError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "llava_next_mistral_7b",
    "mistral_nemo_12b",
    "gemma3_1b",
    "nemotron_4_15b",
    "gemma2_27b",
    "deepseek_v2_lite_16b",
    "qwen3_moe_235b_a22b",
    "mamba2_1p3b",
    "recurrentgemma_2b",
    "musicgen_large",
]

PORTED = tuple(ARCHS)

_ALIASES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "gemma3-1b": "gemma3_1b",
    "nemotron-4-15b": "nemotron_4_15b",
    "gemma2-27b": "gemma2_27b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-1.3b": "mamba2_1p3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
}


# (seq_len, global_batch, mode)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k runs only for sub-quadratic archs (constant-size state)
LONG_CONTEXT_ARCHS = {"mamba2_1p3b", "recurrentgemma_2b"}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))


def _module(arch: str):
    name = canonical(arch)
    if name not in PORTED:
        raise ValueError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


def cells(include_skipped: bool = False):
    """All (arch, shape, runnable) dry-run cells; long_500k is runnable
    only for ``LONG_CONTEXT_ARCHS``."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            runnable = s != "long_500k" or a in LONG_CONTEXT_ARCHS
            if runnable or include_skipped:
                out.append((a, s, runnable))
    return out
