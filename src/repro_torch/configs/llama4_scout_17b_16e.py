"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) expert d_ff=8192
v=202048, MoE 16e top-1 + 1 shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, ModelConfig,
                                      MoESpec)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=40, n_kv=8, head_dim=128, rope_theta=5e5)
    moe = MoESpec(n_experts=16, top_k=1, d_ff=8192, act="silu", gated=True,
                  n_shared=1)
    return ModelConfig(
        name="llama4-scout-17b-16e", d_model=5120, vocab=202048,
        pattern=(LayerSpec(attn, moe),), n_periods=48,
        norm="rmsnorm", scan_layers=True, remat=True,
        arch_class="moe", max_seq=131072)
