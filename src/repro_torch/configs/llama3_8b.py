"""llama-3-8b — the paper's own primary model (Table II): 32L d=4096 32H
(GQA kv=8) d_ff=14336 v=128256 [arXiv:2407.21783]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=32, n_kv=8, head_dim=128, rope_theta=5e5)
    mlp = MLPSpec(d_ff=14336, act="silu", gated=True)
    return ModelConfig(
        name="llama3-8b", d_model=4096, vocab=128256,
        pattern=(LayerSpec(attn, mlp),), n_periods=32,
        norm="rmsnorm", scan_layers=True, remat=True,
        arch_class="dense", max_seq=8192)
