"""The paged step's prologue on the CPU: RoPE of q and k and the K/V
write into the paged arenas as one op (``kernels/rope_kv_write``) on
tables a paged forward builds once (``layers.paged_step``).

- The op's plain version on the step tables is bitwise ``_rope`` of q
  and k plus two ``paged_write``s, in q and in both arenas.
- A paged forward gives the same logits and pool, bitwise, whether its
  layers share the step tables, build them each, or take the path a
  mesh takes (eager RoPE, then the op's plain scatter).

The kernel itself is held to the eager ops on the card in
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rope_kv_write.ops import rope_kv_write
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)

F32, BF16 = torch.float32, torch.bfloat16


def _t(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _step_case(rng, chunk: bool, block: int, max_blocks=6, n_blocks=30):
    """(block_tables, start, n_valid, positions) for a decode step of 4
    rows (one inactive, on the scratch block at length 0) or a chunk of
    2 rows x 24 positions from later starts, right-padded by n_valid."""
    tables = torch.from_numpy(rng.permutation(n_blocks)[:4 * max_blocks]
                              .reshape(4, max_blocks).astype(np.int32))
    if chunk:
        tables, S = tables[:2], 24
        start = torch.tensor([5, block + 3])
        n_valid = torch.tensor([17, 24])
    else:
        tables[3] = n_blocks
        S, n_valid = 1, None
        start = torch.tensor([0, block - 1, 2 * block + 5, 0])
    positions = start[:, None] + torch.arange(S)[None, :]
    return tables, start, n_valid, positions


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("chunk", [False, True])
@pytest.mark.parametrize("dtype,arena_dtype", [(F32, F32), (BF16, BF16),
                                               (F32, BF16)])
def test_plain_op_on_step_tables_is_rope_and_two_paged_writes(
        block, group, rope, chunk, dtype, arena_dtype):
    rng = np.random.default_rng(block + 10 * group + 100 * chunk)
    n_kv, D, n_blocks = 2, 32, 30
    spec = AttentionSpec(n_q=n_kv * group, n_kv=n_kv, head_dim=D, rope=rope,
                         rope_theta=5e5)
    tables, start, n_valid, positions = _step_case(rng, chunk, block,
                                                   n_blocks=n_blocks)
    B, S = positions.shape
    q = _t(rng, (B, S, spec.n_q, D), dtype)
    k, v = (_t(rng, (B, S, n_kv, D), dtype) for _ in range(2))
    ka, va = (_t(rng, (n_blocks + 1, block, n_kv, D), arena_dtype)
              for _ in range(2))

    want_q, want_k = q, k
    if rope:
        want_q = L._rope(q, positions, spec.rope_theta)
        want_k = L._rope(k, positions, spec.rope_theta)
    want_ka = L.paged_write(ka.clone(), want_k, tables, start, n_valid)
    want_va = L.paged_write(va.clone(), v, tables, start, n_valid)

    step = L.paged_step([spec], positions, ka, tables, start, n_valid)
    assert list(step.rope) == ([(spec.rope_theta, D // 2)] if rope else [])
    got_q, got_ka, got_va = q.clone(), ka.clone(), va.clone()
    cos_sin = step.rope[(spec.rope_theta, D // 2)] if rope else ()
    out = rope_kv_write(got_q, k, v, got_ka, got_va, step.rows, *cos_sin)
    assert out is got_q, "q is rotated in place"
    assert torch.equal(got_q, want_q)
    assert torch.equal(got_ka, want_ka)
    assert torch.equal(got_va, want_va)
    if chunk:     # the padding went to the scratch block's last row only
        live = got_ka[:-1] != ka[:-1]
        assert live.any() and torch.equal(got_ka[-1, :-1], ka[-1, :-1])
    nv = n_valid if n_valid is not None else torch.full((B,), S)
    assert step.lengths.dtype == step.tables.dtype == torch.int32
    assert torch.equal(step.lengths, (start + nv).int())
    assert torch.equal(step.tables, tables)


def _model(dtype):
    """Three layers: two RoPE thetas and one layer without RoPE."""
    attn = [AttentionSpec(n_q=6, n_kv=2, head_dim=16, rope_theta=1e4),
            AttentionSpec(n_q=6, n_kv=2, head_dim=16, rope_theta=5e5),
            AttentionSpec(n_q=6, n_kv=2, head_dim=16, rope=False)]
    cfg = ModelConfig(name="rope-kv", d_model=64, vocab=256,
                      pattern=tuple(LayerSpec(a, MLPSpec(d_ff=64))
                                    for a in attn),
                      n_periods=1, scan_layers=False)
    params = T.cast_params(T.init_model(torch.Generator().manual_seed(3),
                                        cfg), dtype)
    return cfg, params


def _by_layer(params, cfg, tokens, pool, ci, tables, n_valid, dtype,
              tables_per_layer: bool):
    """``T.forward``'s paged step with each layer's tables built for that
    layer alone, or (``tables_per_layer`` False) the path a mesh takes:
    no step given, so eager RoPE and the plain scatter."""
    B, S = tokens.shape
    positions = (ci.reshape(-1, 1) + torch.arange(S)[None, :]).expand(B, S)
    x = params["embed"]["table"][tokens].to(dtype)
    for i, blk in enumerate(params["blocks"]):
        spec = cfg.layer(i)
        step = (L.paged_step([spec.mixer], positions, pool[i]["attn"]["k"],
                             tables, ci, n_valid)
                if tables_per_layer else None)
        x, _, _ = T.apply_block(blk, cfg, spec, x, positions, pool[i], ci,
                                layer=i, block_tables=tables,
                                n_valid=n_valid, paged_kernel=True, step=step)
    x = L.apply_norm(params["final_norm"], cfg.norm, x)
    return x @ params["lm_head"]["w"].to(dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("chunk", [False, True])
def test_paged_forward_same_with_shared_or_per_layer_tables(dtype, chunk):
    rng = np.random.default_rng(7 + chunk)
    cfg, params = _model(dtype)
    block, n_blocks = 16, 30
    tables, ci, n_valid, positions = _step_case(rng, chunk, block,
                                                n_blocks=n_blocks)
    B, S = positions.shape
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    pool = T.init_paged_pool(cfg, n_blocks, block, dtype)
    for layer in pool:
        for arena in layer["attn"].values():
            arena.copy_(_t(rng, arena.shape, dtype))
    pools = [[{"attn": {n: a.clone() for n, a in layer["attn"].items()}}
              for layer in pool] for _ in range(3)]
    with torch.no_grad():
        shared, _, _ = T.forward(params, cfg, tokens, cache=pools[0],
                                 cache_index=ci, block_tables=tables,
                                 n_valid=n_valid, compute_dtype=dtype,
                                 paged_kernel=True)
        per_layer = _by_layer(params, cfg, tokens, pools[1], ci, tables,
                              n_valid, dtype, tables_per_layer=True)
        eager = _by_layer(params, cfg, tokens, pools[2], ci, tables,
                          n_valid, dtype, tables_per_layer=False)
    assert torch.isfinite(shared.float()).all()
    assert torch.equal(shared, per_layer)
    assert torch.equal(shared, eager)
    for other in pools[1:]:
        for got, want in zip(pools[0], other):
            for name in ("k", "v"):
                assert torch.equal(got["attn"][name], want["attn"][name])
    assert not torch.equal(pools[0][0]["attn"]["k"], pool[0]["attn"]["k"])
