"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 v=65536,
MoE 16e top-2, Mamba:attn 7:1 interleave, MoE every other layer
[arXiv:2403.19887]."""
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MambaSpec,
                                      MLPSpec, ModelConfig, MoESpec)

D = 4096


def _pattern():
    attn = AttentionSpec(n_q=32, n_kv=8, head_dim=128)
    mamba = MambaSpec(d_inner=2 * D, d_state=128, head_dim=64)
    mlp = MLPSpec(d_ff=14336, act="silu", gated=True)
    moe = MoESpec(n_experts=16, top_k=2, d_ff=14336, act="silu", gated=True)
    layers = []
    for j in range(8):                     # 1 attn per 8; MoE on odd layers
        mixer = attn if j == 4 else mamba
        ffn = moe if j % 2 == 1 else mlp
        layers.append(LayerSpec(mixer=mixer, ffn=ffn))
    return tuple(layers)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", d_model=D, vocab=65536,
        pattern=_pattern(), n_periods=4, norm="rmsnorm",
        scan_layers=True, remat=True, arch_class="hybrid",
        subquadratic=True, max_seq=262144)
