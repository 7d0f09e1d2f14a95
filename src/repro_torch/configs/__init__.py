"""Architecture registry.

Every assigned architecture is a ``src/repro_torch/configs/<id>.py`` module
exporting ``CONFIG``; the registry maps ``--arch`` ids to them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

ARCH_IDS = [
    "recurrentgemma_9b",
    "stablelm_12b",
    "minicpm3_4b",
    "grok_1_314b",
    "whisper_tiny",
    "minicpm_2b",
    "qwen1_5_32b",
    "falcon_mamba_7b",
    "deepseek_v2_236b",
    "internvl2_26b",
    # paper's own evaluation models (Qwen2.5 series)
    "qwen2_5_7b",
    "qwen2_5_32b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
