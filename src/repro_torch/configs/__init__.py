"""Config registry: the 10 assigned architectures + the paper's own CV nets.

``get_config(name)`` returns the full production ArchConfig;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
smoke tests (small width/depth/vocab — same code paths).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "mistral_nemo_12b",
    "minitron_8b",
    "smollm_135m",
    "glm4_9b",
    "recurrentgemma_2b",
    "qwen3_moe_235b",
    "deepseek_v2_236b",
    "llama32_vision_90b",
    "whisper_tiny",
    "xlstm_125m",
]

# brief ids -> module ids
ALIASES = {
    "mistral-nemo-12b": "mistral_nemo_12b",
    "minitron-8b": "minitron_8b",
    "smollm-135m": "smollm_135m",
    "glm4-9b": "glm4_9b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-125m": "xlstm_125m",
}


def get_config(name: str) -> ArchConfig:
    name = ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    name = ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke_config()


def list_configs() -> List[str]:
    return list(ARCH_IDS)
