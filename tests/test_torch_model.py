"""The port's dense decoder against the JAX package, at f32.

Params are made by JAX ``init_model`` and handed to the port through
numpy (``params_from_numpy``); tokens are made with numpy. Logits of a
prefill and of decode steps on the contiguous cache are held to JAX's
``forward`` within ``ATOL``.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.common.tree import param_bytes, param_count, tree_get
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.specs import config_from_dict, config_to_dict

ATOL = 1e-4          # f32 logits: matmul and softmax summation order
CPU = torch.device("cpu")
jax_forward = jax.jit(jax_T.forward, static_argnames=("cfg", "compute_dtype"))


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax params, port params)."""
    jcfg = small_config()
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    return jcfg, cfg, jparams, params


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def test_config_json_round_trip_matches_jax():
    for jcfg, cfg in ((jax_get_config("llama3-8b"), get_config("llama3-8b")),
                      (small_config(), config_from_dict(
                          jax_config_to_dict(small_config())))):
        assert json.dumps(config_to_dict(cfg), sort_keys=True) == \
            json.dumps(jax_config_to_dict(jcfg), sort_keys=True)
        assert config_from_dict(config_to_dict(cfg)) == cfg
    smoke = get_smoke_config("llama3-8b")
    assert smoke.d_model == 64 and smoke.name == "llama3-8b-smoke"


def test_params_round_trip(model):
    _, cfg, jparams, params = model
    back = params_to_numpy(params)
    jnp_params = jax.tree_util.tree_map(np.asarray, jparams)
    flat_a = jax.tree_util.tree_leaves(back)
    flat_b = jax.tree_util.tree_leaves(jnp_params)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert tree_get(params, ("blocks", 1, "attn", "q")).shape == (64, 4, 16)
    assert tree_get(params, ("blocks", 0, "attn", "o")).shape == (4, 16, 64)
    assert tree_get(params, ("blocks", 0, "mlp", "up")).shape == (64, 128)
    n = sum(int(x.size) for x in flat_b)
    assert param_count(params) == n and param_bytes(params) == 4 * n


def test_params_round_trip_bf16():
    a = np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3)
    t = params_from_numpy({"w": a}, CPU)["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy({"w": t})["w"],
                                  a.astype(np.float32))


def test_init_model_matches_jax_structure():
    jcfg = small_config()
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                    params_to_numpy(params))
    jshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams)
    assert shapes == jshapes
    again = T.init_model(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(params["blocks"][1]["mlp"]["down"],
                       again["blocks"][1]["mlp"]["down"])


def test_norm_rope_and_mlp_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1)) + 3
    np.testing.assert_allclose(
        L.rope_embed(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jax_layers.rope_embed(jnp.asarray(x), jnp.asarray(pos),
                                         1e4)), atol=1e-5)
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        p = {"scale": scale, "bias": scale[::-1].copy()}
        got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                           kind, torch.from_numpy(h))
        want = jax_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                     kind, jnp.asarray(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for act in ("silu", "gelu", "relu2"):
        np.testing.assert_allclose(
            L.activation(act, torch.from_numpy(h)).numpy(),
            np.asarray(jax_layers.activation(act, jnp.asarray(h))), atol=1e-6)


def test_prefill_logits_match_jax(model):
    jcfg, cfg, jparams, params = model
    toks = _tokens(2, 2, 12, cfg.vocab)
    logits, cache, _ = T.forward(params, cfg, torch.from_numpy(toks),
                                 compute_dtype=torch.float32)
    jlogits, _, _ = jax_forward(jparams, jcfg, jnp.asarray(toks),
                                compute_dtype=jnp.float32)
    assert cache is None and logits.shape == (2, 12, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL)


def _decode(forward, params, cfg, prompt, steps, cache, index_of):
    """Prefill ``prompt`` into ``cache``, then decode ``steps`` (B, n)
    one column at a time; returns every step's logits."""
    outs = []
    logits, cache, _ = forward(params, cfg, prompt, cache=cache,
                               cache_index=index_of(0))
    outs.append(logits)
    S0 = prompt.shape[1]
    for i in range(steps.shape[1]):
        logits, cache, _ = forward(params, cfg, steps[:, i:i + 1],
                                   cache=cache, cache_index=index_of(S0 + i))
        outs.append(logits)
    return outs


def test_decode_logits_match_jax(model):
    jcfg, cfg, jparams, params = model
    B, S0, n, S_max = 2, 8, 3, 16
    prompt = _tokens(3, B, S0, cfg.vocab)
    steps = _tokens(4, B, n, cfg.vocab)
    got = _decode(lambda *a, **k: T.forward(*a, compute_dtype=torch.float32,
                                            **k),
                  params, cfg, torch.from_numpy(prompt),
                  torch.from_numpy(steps),
                  T.init_cache(cfg, B, S_max, torch.float32, CPU), int)
    want = _decode(lambda *a, **k: jax_forward(*a, compute_dtype=jnp.float32,
                                               **k),
                   jparams, jcfg, jnp.asarray(prompt), jnp.asarray(steps),
                   jax_T.init_cache(jcfg, B, S_max, jnp.float32),
                   lambda i: jnp.int32(i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_vector_cache_index_matches_jax_scalar_path(model):
    """Per-sequence (B,) offsets, all equal here, held to the JAX scalar
    path within tolerance (not bitwise)."""
    jcfg, cfg, jparams, params = model
    B, S0, n, S_max = 2, 6, 2, 12
    prompt = _tokens(5, B, S0, cfg.vocab)
    steps = _tokens(6, B, n, cfg.vocab)
    got = _decode(lambda *a, **k: T.forward(*a, compute_dtype=torch.float32,
                                            **k),
                  params, cfg, torch.from_numpy(prompt),
                  torch.from_numpy(steps),
                  T.init_cache(cfg, B, S_max, torch.float32, CPU),
                  lambda i: torch.full((B,), i, dtype=torch.int32))
    want = _decode(lambda *a, **k: jax_forward(*a, compute_dtype=jnp.float32,
                                               **k),
                   jparams, jcfg, jnp.asarray(prompt), jnp.asarray(steps),
                   jax_T.init_cache(jcfg, B, S_max, jnp.float32),
                   lambda i: jnp.int32(i))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_vector_cache_index_decodes_ragged_offsets(model):
    """Sequences at different lengths in one decode step: each row's
    logits equal a batch-1 decode of that row at its own offset."""
    _, cfg, _, params = model
    S_max = 12
    rows = [(_tokens(7, 1, 5, cfg.vocab), 5), (_tokens(8, 1, 8, cfg.vocab), 8)]
    cache = T.init_cache(cfg, 2, S_max, torch.float32, CPU)
    singles = []
    for b, (prompt, s0) in enumerate(rows):
        one = T.init_cache(cfg, 1, S_max, torch.float32, CPU)
        T.forward(params, cfg, torch.from_numpy(prompt), cache=one,
                  cache_index=0, compute_dtype=torch.float32)
        for li in range(cfg.n_layers):
            for kv in ("k", "v"):
                cache[li]["attn"][kv][b] = one[li]["attn"][kv][0]
        step = torch.tensor([[3]])
        logits, _, _ = T.forward(params, cfg, step, cache=one,
                                 cache_index=s0, compute_dtype=torch.float32)
        singles.append(logits[0, -1])
    logits, _, _ = T.forward(params, cfg, torch.tensor([[3], [3]]),
                             cache=cache, cache_index=torch.tensor([5, 8]),
                             compute_dtype=torch.float32)
    for b in range(2):
        np.testing.assert_allclose(logits[b, -1].numpy(),
                                   singles[b].numpy(), atol=ATOL)


def test_scan_and_moe_raise_not_implemented():
    """Scanned stacks raise (a scanned checkpoint is unstacked at load).
    MoE feed-forwards, Mamba mixers and frontend embeddings came with
    their slices and no longer raise (their parity with JAX is in
    ``tests/test_torch_moe.py``, ``tests/test_torch_ssm.py`` and
    ``tests/test_torch_archs.py``): frontend embeddings replace the
    first positions' token embeddings."""
    cfg = config_from_dict(jax_config_to_dict(small_config(moe=True)))
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    assert "moe" in params["blocks"][1] and "mlp" in params["blocks"][0]
    hybrid = config_from_dict(jax_config_to_dict(
        small_config(moe=True, mamba=True)))
    params = T.init_model(torch.Generator().manual_seed(0), hybrid)
    assert "mamba" in params["blocks"][2] and "attn" not in params[
        "blocks"][2]
    with pytest.raises(NotImplementedError):
        T.init_model(torch.Generator().manual_seed(0),
                     get_config("llama3-8b"))
    toks = torch.arange(1, 5)[None]
    fe = torch.ones((1, 1, hybrid.d_model))
    with_fe, _, _ = T.forward(params, hybrid, toks, frontend_embeds=fe,
                              compute_dtype=torch.float32)
    alone, _, _ = T.forward(params, hybrid, toks,
                            compute_dtype=torch.float32)
    assert not torch.allclose(with_fe[:, 0], alone[:, 0])
    swapped = toks.clone()
    swapped[0, 0] = 7                 # the token under the frontend slot
    again, _, _ = T.forward(params, hybrid, swapped, frontend_embeds=fe,
                            compute_dtype=torch.float32)
    assert torch.equal(again, with_fe)
