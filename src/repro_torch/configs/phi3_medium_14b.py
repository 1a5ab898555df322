"""phi3-medium-14b [dense]: 40L d=5120 40H (GQA kv=10) d_ff=17920 v=100352 —
RoPE, SwiGLU, GQA [arXiv:2404.14219; unverified]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=40, n_kv=10, head_dim=128)
    mlp = MLPSpec(d_ff=17920, act="silu", gated=True)
    return ModelConfig(
        name="phi3-medium-14b", d_model=5120, vocab=100352,
        pattern=(LayerSpec(attn, mlp),), n_periods=40,
        norm="rmsnorm", scan_layers=True, remat=True,
        arch_class="dense", max_seq=131072)
