"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The JAX package's eleven ids: dense llama-style decoders (llama3-8b,
gemma-2b, phi3-medium-14b, qwen2-72b, nemotron-4-340b), routed-expert
MoE decoders (qwen3-moe; llama4-scout with a shared expert beside the
routed ones), the attention-free SSM (mamba2), the attention + Mamba +
MoE hybrid (jamba), and the two decoders whose first positions come
from a stubbed frontend (``frontend_embeds``: qwen2-vl's patch
embeddings, musicgen's codec frames)."""
from __future__ import annotations

import importlib

from repro_torch.models.specs import ModelConfig, scaled_down

ARCHS = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "llama4-scout-17b-16e": "repro_torch.configs.llama4_scout_17b_16e",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
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
