"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) expert d_ff=768
v=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, ModelConfig,
                                      MoESpec)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=32, n_kv=4, head_dim=128, rope_theta=1e6)
    moe = MoESpec(n_experts=128, top_k=8, d_ff=768, act="silu", gated=True)
    return ModelConfig(
        name="qwen3-moe-30b-a3b", d_model=2048, vocab=151936,
        pattern=(LayerSpec(attn, moe),), n_periods=48,
        norm="rmsnorm", scan_layers=True, remat=True,
        arch_class="moe", max_seq=32768)
