"""Config registry: ``get_config("<arch-id>")``.

Counterpart of ``repro.configs.registry`` (its dry-run cells and shapes
wait with ``launch/dryrun.py``).  The port carries the config
files of the architectures it runs (``PORTED``: the dense GQA ones and the
MoE family, deepseek-v2-lite's MLA among them); asking for another one
raises ``NotImplementedError`` (``ROADMAP.md`` Queue 1 item 2).
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

PORTED = ("gemma3_1b", "gemma2_27b", "mistral_nemo_12b",
          "deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")

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


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))


def _module(arch: str):
    name = canonical(arch)
    if name not in PORTED:
        if name in ARCHS:
            raise NotImplementedError(
                f"{arch}: not ported yet (ROADMAP.md Queue 1 item 2); the "
                f"port runs {', '.join(PORTED)}")
        raise ValueError(f"unknown architecture {arch!r}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG
