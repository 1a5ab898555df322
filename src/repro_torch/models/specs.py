"""Model configuration dataclasses.

A model is a stack of :class:`LayerSpec`, each combining a *mixer*
(attention or Mamba-2 SSD) and an optional *ffn* (dense MLP or MoE). Large
configs express the stack as a repeating ``pattern`` repeated
``n_periods`` times; small / pruned models unroll with per-layer specs.
The port keeps the JAX package's fields and JSON form unchanged, so a
``config.json`` written by either package loads in the other; the port
runs layers in a Python loop, so ``scan_layers`` and ``remat`` are kept
only for that round trip.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union


@dataclass(frozen=True)
class AttentionSpec:
    n_q: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    # Sliding window (tokens); None = full attention.
    window: Optional[int] = None

    @property
    def q_dim(self) -> int:
        return self.n_q * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.head_dim


@dataclass(frozen=True)
class MambaSpec:
    """Mamba-2 (SSD) mixer."""
    d_inner: int
    d_state: int = 128
    head_dim: int = 64
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        # conv runs over (x, B, C) channels
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_dim(self) -> int:
        # in_proj emits [z, x, B, C, dt]
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


@dataclass(frozen=True)
class MLPSpec:
    d_ff: int
    act: str = "silu"       # silu | gelu | relu2
    gated: bool = True


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int
    act: str = "silu"
    gated: bool = True
    n_shared: int = 0            # shared (always-on) experts, e.g. Llama-4
    capacity_factor: float = 1.25


MixerSpec = Union[AttentionSpec, MambaSpec]
FFNSpec = Union[MLPSpec, MoESpec]


@dataclass(frozen=True)
class LayerSpec:
    mixer: MixerSpec
    ffn: Optional[FFNSpec]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    pattern: tuple            # tuple[LayerSpec, ...] — the repeating unit
    n_periods: int
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = False
    scan_layers: bool = True  # scanned stack in the JAX package
    remat: bool = True
    frontend: Optional[str] = None      # None | 'vision' | 'audio'
    frontend_frac: float = 0.25         # fraction of positions fed by frontend
    vocab_pad_multiple: int = 256
    embed_scale: bool = False           # gemma-style sqrt(d) embedding scale
    max_seq: int = 8192                 # informational (configs override shapes)
    arch_class: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio
    subquadratic: bool = False          # eligible for long_500k

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.n_periods

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    def layer(self, i: int) -> LayerSpec:
        return self.pattern[i % len(self.pattern)]

    def layers(self):
        return [self.layer(i) for i in range(self.n_layers)]

    def unrolled(self) -> "ModelConfig":
        """Per-layer (non-scanned) variant: pattern = full layer list."""
        return dataclasses.replace(
            self, pattern=tuple(self.layers()), n_periods=1, scan_layers=False)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ------------------------------------------------------- (de)serialization

_SPEC_KINDS = {
    "AttentionSpec": AttentionSpec,
    "MambaSpec": MambaSpec,
    "MLPSpec": MLPSpec,
    "MoESpec": MoESpec,
}


def _spec_to_dict(spec) -> Optional[dict]:
    if spec is None:
        return None
    d = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    d["kind"] = type(spec).__name__
    return d


def _spec_from_dict(d: Optional[dict]):
    if d is None:
        return None
    d = dict(d)
    kind = d.pop("kind")
    if kind not in _SPEC_KINDS:
        raise ValueError(f"unknown spec kind {kind!r}")
    return _SPEC_KINDS[kind](**d)


def config_to_dict(cfg: ModelConfig) -> dict:
    """JSON-safe dict; exact inverse of :func:`config_from_dict`."""
    d = {f.name: getattr(cfg, f.name)
         for f in dataclasses.fields(ModelConfig) if f.name != "pattern"}
    d["pattern"] = [{"mixer": _spec_to_dict(l.mixer),
                     "ffn": _spec_to_dict(l.ffn)} for l in cfg.pattern]
    return d


def config_from_dict(d: dict) -> ModelConfig:
    d = dict(d)
    pattern = tuple(
        LayerSpec(mixer=_spec_from_dict(l["mixer"]),
                  ffn=_spec_from_dict(l["ffn"])) for l in d.pop("pattern"))
    return ModelConfig(pattern=pattern, **d)


def scaled_down(cfg: ModelConfig, *, d_model: int = 64, head_dim: int = 16,
                d_ff: int = 128, vocab: int = 512, n_periods: int = 1,
                n_experts: Optional[int] = None, top_k: Optional[int] = None,
                d_state: int = 16, max_q: int = 4) -> ModelConfig:
    """Reduced config of the same family, for CPU smoke tests."""
    def shrink_mixer(m: MixerSpec) -> MixerSpec:
        if isinstance(m, AttentionSpec):
            n_q = min(m.n_q, max_q)
            n_kv = max(1, min(m.n_kv, n_q))
            while n_q % n_kv:
                n_kv -= 1
            return dataclasses.replace(m, n_q=n_q, n_kv=n_kv, head_dim=head_dim)
        return dataclasses.replace(
            m, d_inner=2 * d_model, d_state=d_state, head_dim=head_dim,
            chunk=8)

    def shrink_ffn(f):
        if f is None:
            return None
        if isinstance(f, MoESpec):
            ne = n_experts or min(f.n_experts, 4)
            # keep top_k < n_experts so smoke configs can exercise
            # empty-expert paths (full-size configs have top_k << E;
            # top_k == E would make every expert always occupied)
            tk = top_k or min(f.top_k, max(1, ne // 2))
            return dataclasses.replace(
                f, n_experts=ne, top_k=min(tk, ne), d_ff=d_ff)
        return dataclasses.replace(f, d_ff=d_ff)

    pattern = tuple(
        LayerSpec(mixer=shrink_mixer(l.mixer), ffn=shrink_ffn(l.ffn))
        for l in cfg.pattern)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", d_model=d_model, vocab=vocab,
        pattern=pattern, n_periods=n_periods, vocab_pad_multiple=16,
        scan_layers=cfg.scan_layers, remat=False)
