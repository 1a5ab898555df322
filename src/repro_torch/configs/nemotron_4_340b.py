"""nemotron-4-340b [dense]: 96L d=18432 96H (GQA kv=8) d_ff=73728 v=256000 —
squared-ReLU (no gate), LayerNorm, head_dim=192 [arXiv:2402.16819;
unverified]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=96, n_kv=8, head_dim=192)
    mlp = MLPSpec(d_ff=73728, act="relu2", gated=False)
    return ModelConfig(
        name="nemotron-4-340b", d_model=18432, vocab=256000,
        pattern=(LayerSpec(attn, mlp),), n_periods=96,
        norm="layernorm", scan_layers=True, remat=True,
        arch_class="dense", max_seq=4096)
