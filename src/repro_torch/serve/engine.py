"""Serving: a static-batch generation engine over the dense forward.

``Engine`` prefills the prompts into a contiguous KV cache, then decodes
one token per step for every sequence. With block plans (``packed``,
from ``sparse.pack_model``) the FFN projections run through the
block-sparse kernel via the forward's ``mlp_apply`` hook. The weights
are cast to the compute dtype once, at construction.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.tree import cast_tree, tree_device
from repro_torch.models import transformer as T
from repro_torch.models.specs import ModelConfig
from repro_torch.serve.config import ServeConfig

NEG_INF = -1e30


def make_sparse_mlp_apply(packed: dict):
    """``mlp_apply`` hook routing FFN layers through the block-sparse
    kernel wherever ``packed`` has a plan."""
    from repro_torch.serve.sparse import sparse_apply_ffn

    def mlp_apply(block_params, spec, x, layer):
        return sparse_apply_ffn(block_params, spec, x, packed, layer)
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

    ``packed`` (from ``sparse.pack_model``) routes the MLP projections
    through the block-sparse kernel — the Mosaic fast path. The engine
    runs on the params' device.
    """

    def __init__(self, params, cfg: ModelConfig,
                 serve: Optional[ServeConfig] = None,
                 packed: Optional[dict] = None):
        self.serve = serve if serve is not None else ServeConfig()
        self.cfg = cfg
        self.params = cast_tree(params, self.serve.compute_dtype)
        self.device = tree_device(self.params)
        self.max_seq = self.serve.max_seq
        self.mlp_apply = make_sparse_mlp_apply(packed) if packed else None

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
        logits, cache, _ = T.forward(
            self.params, self.cfg, tokens, cache=cache,
            cache_index=cache_index, compute_dtype=self.serve.compute_dtype,
            mlp_apply=self.mlp_apply)
        return logits[:, -1, :], cache

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
