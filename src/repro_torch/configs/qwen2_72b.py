"""qwen2-72b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=29568 v=152064 — GQA,
QKV bias [arXiv:2407.10671]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=64, n_kv=8, head_dim=128, qkv_bias=True,
                         rope_theta=1e6)
    mlp = MLPSpec(d_ff=29568, act="silu", gated=True)
    return ModelConfig(
        name="qwen2-72b", d_model=8192, vocab=152064,
        pattern=(LayerSpec(attn, mlp),), n_periods=80,
        norm="rmsnorm", scan_layers=True, remat=True,
        arch_class="dense", max_seq=32768)
