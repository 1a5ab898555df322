"""musicgen-large [audio]: 48L d=2048 32H (MHA kv=32) d_ff=8192 v=2048 —
decoder-only over EnCodec tokens; codec frontend stubbed as precomputed
frame embeddings [arXiv:2306.05284]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)


def config() -> ModelConfig:
    attn = AttentionSpec(n_q=32, n_kv=32, head_dim=64)
    mlp = MLPSpec(d_ff=8192, act="gelu", gated=False)
    return ModelConfig(
        name="musicgen-large", d_model=2048, vocab=2048,
        pattern=(LayerSpec(attn, mlp),), n_periods=48,
        norm="layernorm", scan_layers=True, remat=True,
        frontend="audio", frontend_frac=0.25,
        arch_class="audio", max_seq=8192, vocab_pad_multiple=16)
