"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Registered: the dense llama-style decoder of the main path, the
routed-expert MoE decoder (qwen3-moe), the attention-free SSM (mamba2)
and the attention + Mamba + MoE hybrid (jamba). The other architectures
of the JAX package come with the slices that port their layers
(shared-expert MoE, VLM, audio)."""
from __future__ import annotations

import importlib

from repro_torch.models.specs import ModelConfig, scaled_down

ARCHS = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
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
