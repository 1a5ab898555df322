"""Serving: prefill and decode steps, per-request seeded sampling, and a
static-batch generation engine over the dense forward.

``Engine`` prefills the prompts into a contiguous KV cache, then decodes
one token per step for every sequence. With block plans (``packed``,
from ``sparse.pack_model``) the FFN projections run through the
block-sparse kernel via the forward's ``mlp_apply`` hook. The weights
are cast to the compute dtype once, at construction. The
continuous-batching engine lives in ``repro_torch.serve.batching``.

``sample_tokens`` / ``request_key`` are the port's counterpart of the
JAX package's per-request sampling streams. ``jax.random`` streams
cannot be reproduced in torch, so the port draws from its own
counter-based stream: the Gumbel noise of vocabulary entry ``v`` for a
request's ``c``-th token is a hash of (request key, c, v), in 32-bit
integer arithmetic. A request's draws depend on nothing else — not on
the batch it shares, its slot, the other rows' temperatures, or the
device — and greedy rows (temperature <= 0) are an exact argmax.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.tree import tree_device
from repro_torch.models import transformer as T
from repro_torch.models.specs import ModelConfig
from repro_torch.serve.config import ServeConfig

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def make_prefill_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                      mlp_apply=None):
    """A prompt batch into a contiguous cache from position 0; returns
    ``(logits, cache)``. ``frontend_embeds`` (B, F, d) take the place of
    the first F positions' token embeddings (``transformer.forward``)."""
    def prefill_step(params, tokens, cache, frontend_embeds=None):
        logits, cache, _ = T.forward(
            params, cfg, tokens, frontend_embeds=frontend_embeds,
            cache=cache, cache_index=0,
            compute_dtype=compute_dtype, mlp_apply=mlp_apply)
        return logits, cache
    return prefill_step


def make_serve_step(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                    mlp_apply=None):
    """One decode step; returns ``(last-position logits, cache)``."""
    def serve_step(params, cache, tokens, cache_index):
        """tokens: (B, 1). cache_index: an int, or (B,) per-slot lengths
        (continuous batching)."""
        logits, cache, _ = T.forward(
            params, cfg, tokens, cache=cache, cache_index=cache_index,
            compute_dtype=compute_dtype, mlp_apply=mlp_apply)
        return logits[:, -1, :], cache
    return serve_step


def _mix32(h):
    """murmur3's 32-bit finaliser, on Python ints or int64 tensors that
    hold values in [0, 2**32): every product is masked back to 32 bits,
    so the tensor version (which wraps at 64 bits) equals the int one."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def _fold32(x: int) -> int:
    """A non-negative int of any size folded to 32 bits."""
    x = int(x)
    h = 0
    while True:
        h = _mix32(h ^ (x & _M32))
        x >>= 32
        if not x:
            return h


def request_key(seed: Optional[int], uid: int, run_seed: int) -> int:
    """The request's 32-bit stream key: its own ``seed`` when set (the
    stream is then independent of batch composition and of the run),
    else a per-uid fold of the engine-run seed."""
    if seed is not None:
        return _mix32(_fold32(seed) ^ 0x5EED5EED)
    return _mix32(_fold32(run_seed) ^ _mix32(_fold32(uid) ^ 0x9E3779B9))


def gumbel_noise(keys: torch.Tensor, counts: torch.Tensor,
                 width: int) -> torch.Tensor:
    """(B, width) f32 Gumbel noise of the counter-based stream: row b is
    the noise of token ``counts[b]`` of the request keyed ``keys[b]``.
    keys, counts: (B,) int64 tensors."""
    dev = keys.device
    step = _mix32(keys[:, None] ^ _mix32(counts[:, None] & _M32))
    v = torch.arange(width, device=dev, dtype=torch.int64)[None, :]
    bits = _mix32(step ^ _mix32((v + 0x9E3779B9) & _M32))
    # the top 24 bits, centred: an f32 in (0, 1) with no rounding
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  counts: torch.Tensor, temps, vocab: Optional[int] = None
                  ) -> torch.Tensor:
    """Per-row sampling. logits: (B, V); keys, counts: (B,) int64 on the
    logits' device; temps: (B,) host floats. Rows with ``temps <= 0``
    are greedy (argmax, first index on ties); the others take the
    Gumbel-max draw of their own stream, a categorical sample at their
    temperature. Padded-vocab columns (``>= vocab``) are never picked."""
    logits = logits.float()
    if vocab is not None and vocab < logits.shape[-1]:
        logits = logits.clone()
        logits[..., vocab:] = NEG_INF
    greedy = torch.argmax(logits, dim=-1)
    temps = torch.as_tensor(temps, dtype=torch.float32)
    if not bool((temps > 0).any()):            # host values: no sync
        return greedy
    t = temps.to(logits.device)
    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    noisy = logits / safe_t[:, None] + gumbel_noise(keys, counts,
                                                    logits.shape[-1])
    return torch.where(t > 0, torch.argmax(noisy, dim=-1), greedy)


def make_sparse_mlp_apply(packed: dict,
                          group_experts: Optional[bool] = None,
                          ragged_moe: Optional[bool] = None,
                          quant: Optional[str] = None):
    """``mlp_apply`` hook routing FFN layers through the block-sparse
    kernels wherever ``packed`` has a plan: dense MLPs per projection,
    MoE layers through their expert plan stacks — one grouped launch for
    all experts by default (``group_experts=None`` follows each plan's
    ``group`` flag), E per-expert launches with ``group_experts=False``,
    and the ragged dispatch at decode batch sizes with ``ragged_moe``
    (None follows each plan's ``ragged`` flag).

    ``quant`` (from ``ServeConfig.quant``) picks the weight storage the
    kernels stream: None follows each plan's own flag, "int8" requires
    int8 kept-tile storage in the plans (raises here when none carries
    it), "none" forces the dense-weight (dequantised reference) path."""
    from repro_torch.serve.sparse import sparse_apply_ffn

    if quant == "int8" and not any(
            p.quant == "int8" and p.tiles is not None
            for p in packed.values()):
        raise ValueError(
            "ServeConfig.quant='int8' but no plan carries int8 kept-tile "
            "storage; pack with PruneRecipe.quant='int8' first")

    def mlp_apply(block_params, spec, x, layer):
        return sparse_apply_ffn(block_params, spec, x, packed, layer,
                                group_experts=group_experts,
                                ragged_moe=ragged_moe, quant=quant)
    return mlp_apply


def sample_token(logits: torch.Tensor, temperature: float = 0.0,
                 vocab: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """(B, V) logits -> (B,) tokens. Greedy (argmax, first index on ties,
    as ``jnp.argmax``) at ``temperature <= 0``; else a categorical draw
    from ``generator`` — the port's own stream, which does not reproduce
    ``jax.random``'s. Padded-vocab columns (``>= vocab``) are never
    picked."""
    if vocab is not None and vocab < logits.shape[-1]:
        logits = logits.clone()
        logits[..., vocab:] = NEG_INF
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class Engine:
    """Minimal static-batch generation engine.

    ``packed`` (from ``sparse.pack_model``) routes the FFN projections
    through the block-sparse kernels — the Mosaic fast path; the MoE
    paths follow ``serve.group_experts`` / ``serve.ragged_moe`` and the
    weight storage ``serve.quant``. The engine runs on the params'
    device.
    """

    def __init__(self, params, cfg: ModelConfig,
                 serve: Optional[ServeConfig] = None,
                 packed: Optional[dict] = None):
        self.serve = serve if serve is not None else ServeConfig()
        self.cfg = cfg
        self.params = T.cast_params(params, self.serve.compute_dtype)
        self.device = tree_device(self.params)
        self.max_seq = self.serve.max_seq
        self.mlp_apply = (make_sparse_mlp_apply(
            packed, self.serve.group_experts, self.serve.ragged_moe,
            self.serve.quant) if packed else None)
        self._serve_step = make_serve_step(cfg, self.serve.compute_dtype,
                                           self.mlp_apply)

    @classmethod
    def from_artifact(cls, artifact, serve: Optional[ServeConfig] = None,
                      *, sparse: bool = True) -> "Engine":
        """Serve a :class:`~repro_torch.core.artifact.PrunedArtifact`:
        params, pruned config and (with ``sparse=True``) its block plans,
        with no ``pack_model`` at startup."""
        packed = artifact.packed if sparse else None
        return cls(artifact.params, artifact.cfg, serve,
                   packed=packed or None)

    def _step(self, tokens, cache, cache_index):
        """Last-position logits of ``tokens`` (a prompt or one decode
        token per sequence) written into ``cache`` at ``cache_index``."""
        return self._serve_step(self.params, cache, tokens, cache_index)

    @torch.no_grad()
    def generate(self, prompt_tokens, n_new: int, temperature: float = 0.0,
                 seed: int = 0, return_logits: bool = False):
        """prompt_tokens: (B, S0) -> (B, S0 + n_new) tokens on the
        engine's device; with ``return_logits`` also the (n_new, B, V)
        f32 logits each new token was picked from."""
        prompt = torch.as_tensor(prompt_tokens, device=self.device).long()
        B, S0 = prompt.shape
        if S0 + n_new > self.max_seq:
            raise ValueError(f"prompt {S0} + {n_new} new tokens exceed "
                             f"max_seq {self.max_seq}")
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        cache = T.init_cache(self.cfg, B, self.max_seq,
                             self.serve.cache_dtype, self.device)
        logits, cache = self._step(prompt, cache, 0)
        steps = [logits.float()] if return_logits else None
        tok = sample_token(logits, temperature, self.cfg.vocab, gen)
        out = [prompt, tok[:, None]]
        for i in range(n_new - 1):
            logits, cache = self._step(tok[:, None], cache, S0 + i)
            if return_logits:
                steps.append(logits.float())
            tok = sample_token(logits, temperature, self.cfg.vocab, gen)
            out.append(tok[:, None])
        tokens = torch.cat(out, dim=1)
        if return_logits:
            return tokens, torch.stack(steps)
        return tokens
