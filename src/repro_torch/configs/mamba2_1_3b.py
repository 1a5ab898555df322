"""mamba2-1.3b [ssm]: 48L d=2048 attn-free, d_inner=4096 (64 SSD heads x
headdim 64), ssm_state=128, v=50280 — SSD (state-space duality)
[arXiv:2405.21060; unverified]."""
from repro_torch.models.specs import LayerSpec, MambaSpec, ModelConfig


def config() -> ModelConfig:
    mamba = MambaSpec(d_inner=4096, d_state=128, head_dim=64)
    return ModelConfig(
        name="mamba2-1.3b", d_model=2048, vocab=50280,
        pattern=(LayerSpec(mamba, None),), n_periods=48,
        norm="rmsnorm", tie_embeddings=True,
        scan_layers=True, remat=True, arch_class="ssm",
        subquadratic=True, max_seq=1048576)
