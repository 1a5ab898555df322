"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Registered: the dense llama-style decoder of the main path and the
routed-expert MoE decoder (qwen3-moe). The other architectures of the
JAX package come with the slices that port their layers (shared-expert
MoE, SSM, hybrid, VLM, audio)."""
from __future__ import annotations

import importlib

from repro_torch.models.specs import ModelConfig, scaled_down

ARCHS = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    # the paper's own model family
    "llama3-8b": "repro_torch.configs.llama3_8b",
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).config()


def get_smoke_config(name: str, **kw) -> ModelConfig:
    return scaled_down(get_config(name), **kw)


def list_archs() -> list:
    return sorted(ARCHS)
