"""qwen2-vl-2b [vlm]: 28L d=1536 12H (GQA kv=2) d_ff=8960 v=151936 — M-RoPE,
dynamic resolution; vision frontend stubbed as precomputed patch embeddings
[arXiv:2409.12191]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=12, n_kv=2, head_dim=128, qkv_bias=True,
                         rope_theta=1e6)
    mlp = MLPSpec(d_ff=8960, act="silu", gated=True)
    return ModelConfig(
        name="qwen2-vl-2b", d_model=1536, vocab=151936,
        pattern=(LayerSpec(attn, mlp),), n_periods=28,
        norm="rmsnorm", scan_layers=True, remat=True,
        frontend="vision", frontend_frac=0.25,
        arch_class="vlm", max_seq=32768)
