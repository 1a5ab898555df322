"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 v=256000 — GeGLU,
head_dim=256, tied embeddings, sqrt(d) embed scale [arXiv:2403.08295]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=8, n_kv=1, head_dim=256)
    mlp = MLPSpec(d_ff=16384, act="gelu", gated=True)   # GeGLU
    return ModelConfig(
        name="gemma-2b", d_model=2048, vocab=256000,
        pattern=(LayerSpec(attn, mlp),), n_periods=18,
        norm="rmsnorm", tie_embeddings=True, embed_scale=True,
        scan_layers=True, remat=True, arch_class="dense", max_seq=8192)
