"""The port's MoE layer and its grouped / ragged block-sparse matmuls
against the JAX package, at f32 on the CPU.

The same inputs, made from numpy seeds, go through both packages:
capacity, the ragged row budget and the ragged dispatch layout are equal;
the dense ``apply_moe`` agrees within 1e-5 relative; the plain versions
of the grouped and ragged kernels agree with the JAX ``ref.py`` and the
Pallas kernels in interpret mode. Within the port, the ragged, grouped
and per-expert loop paths give bitwise-equal rows (the JAX package's own
invariant, ``tests/test_moe_ragged.py``), dropped assignments contribute
exact zeros, and decode-sized batches switch to the ragged kernel only up
to ``RAGGED_TOKENS_MAX`` tokens.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.kernels.grouped_block_sparse import ops as jax_gops
from repro.kernels.grouped_block_sparse import ref as jax_gref
from repro.models import moe as jax_moe
from repro.models.specs import MoESpec as JaxMoESpec
from repro.serve import sparse as jax_sparse
from tests._hypothesis_compat import given, settings, st

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import counters
from repro_torch.kernels.block_sparse.ops import plan_blocks
from repro_torch.kernels.grouped_block_sparse import kernel as gkernel
from repro_torch.kernels.grouped_block_sparse import ops as gops
from repro_torch.kernels.grouped_block_sparse import ref as gref
from repro_torch.models import moe
from repro_torch.models.specs import MoESpec, config_to_dict
from repro_torch.serve import sparse

BLOCK = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_params(rng, E, d, d_ff, gated=True):
    p = {"router": rng.normal(size=(d, E)) / np.sqrt(d),
         "up": rng.normal(size=(E, d, d_ff)) / np.sqrt(d),
         "down": rng.normal(size=(E, d_ff, d)) / np.sqrt(d_ff)}
    if gated:
        p["gate"] = rng.normal(size=(E, d, d_ff)) / np.sqrt(d)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(params_np):
    return ({k: _t(v) for k, v in params_np.items()},
            {k: jnp.asarray(v) for k, v in params_np.items()})


def test_constants_and_smoke_config_match_jax():
    from repro.models.specs import config_to_dict as jax_config_to_dict
    assert moe.RAGGED_BLOCK_ROWS == gops.RAGGED_BLOCK_ROWS \
        == jax_moe.RAGGED_BLOCK_ROWS == jax_gops.RAGGED_BLOCK_ROWS
    assert gops.PANEL_ROWS_MAX == jax_gops.PANEL_ROWS_MAX
    assert sparse.RAGGED_TOKENS_MAX == jax_sparse.RAGGED_TOKENS_MAX
    name = "qwen3-moe-30b-a3b"
    assert config_to_dict(get_smoke_config(name)) == jax_config_to_dict(
        jax_get_smoke_config(name))
    from repro.configs.registry import get_config as jax_get_config
    from repro_torch.configs.registry import get_config
    assert config_to_dict(get_config(name)) == jax_config_to_dict(
        jax_get_config(name))


# ------------------------------------------- capacity and ragged layout

@pytest.mark.parametrize("E,top_k,cf,n_tokens", [
    (64, 1, 0.1, 1), (8, 1, 1.0, 1), (128, 2, 0.5, 2), (4, 2, 1.25, 1),
    (128, 8, 1.25, 32), (128, 8, 1.25, 1), (4, 2, 1.25, 80)])
def test_capacity_and_rows_bound_match_jax(E, top_k, cf, n_tokens):
    spec = MoESpec(n_experts=E, top_k=top_k, d_ff=32, capacity_factor=cf)
    jspec = JaxMoESpec(n_experts=E, top_k=top_k, d_ff=32,
                       capacity_factor=cf)
    c = moe.capacity(spec, n_tokens)
    assert c == jax_moe.capacity(jspec, n_tokens) and c >= 1
    assert c >= top_k * n_tokens / E
    n_assign = n_tokens * top_k
    assert moe.ragged_rows_bound(E, n_assign) == jax_moe.ragged_rows_bound(
        E, n_assign)
    assert moe.n_groups(3, n_tokens) == jax_moe.n_groups(3, n_tokens)


def _routing(rng, E, top_k, cf, G, s):
    """apply_moe-shaped router assignments: top_k distinct experts per
    token, with capacity keep/pos per (group, expert), as numpy."""
    spec = MoESpec(n_experts=E, top_k=top_k, d_ff=32, capacity_factor=cf)
    C = moe.capacity(spec, s)
    ids = np.stack([np.stack([rng.permutation(E)[:top_k]
                              for _ in range(s)]) for _ in range(G)])
    flat = ids.reshape(G, s * top_k)
    onehot = np.eye(E, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    return flat, pos < C, pos


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=1, max_value=8),      # n_experts
       st.integers(min_value=1, max_value=4),      # top_k (clamped to E)
       st.floats(min_value=0.25, max_value=2.0),   # capacity_factor
       st.integers(min_value=1, max_value=4),      # groups
       st.integers(min_value=1, max_value=9),      # tokens per group
       st.integers(min_value=0, max_value=10**6))  # seed
def test_build_ragged_dispatch_matches_jax(E, top_k, cf, G, s, seed):
    top_k = min(top_k, E)
    flat, keep, pos = _routing(np.random.default_rng(seed), E, top_k, cf,
                               G, s)
    m_max = moe.ragged_rows_bound(E, G * s * top_k)
    got = moe.build_ragged_dispatch(_t(flat), _t(keep), _t(pos), E, m_max)
    want = jax_moe.build_ragged_dispatch(jnp.asarray(flat),
                                         jnp.asarray(keep),
                                         jnp.asarray(pos), E, m_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32
    assert (got[0][~_t(keep)] == m_max).all()


# ----------------------------------------------------- the dense layer

@pytest.mark.parametrize("B,S,gated,cf", [(1, 1, True, 1.25),
                                         (3, 1, True, 1.25),
                                         (2, 9, True, 1.25),
                                         (2, 16, False, 0.5),
                                         (4, 32, True, 1.25)])
def test_apply_moe_dense_matches_jax(B, S, gated, cf):
    E, K, d, d_ff = 8, 2, 32, 48
    rng = np.random.default_rng(B * 100 + S)
    spec = MoESpec(n_experts=E, top_k=K, d_ff=d_ff, gated=gated,
                   capacity_factor=cf)
    jspec = JaxMoESpec(n_experts=E, top_k=K, d_ff=d_ff, gated=gated,
                       capacity_factor=cf)
    params, jparams = _both(_moe_params(rng, E, d, d_ff, gated))
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    y, aux = moe.apply_moe(params, spec, _t(x))
    jy, jaux = jax_moe.apply_moe(jparams, jspec, jnp.asarray(x))
    scale = float(np.abs(np.asarray(jy)).max())
    assert float((y.numpy() - np.asarray(jy)).__abs__().max()) \
        <= 1e-5 * scale
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_init_moe_shapes_and_meta():
    spec = MoESpec(n_experts=4, top_k=2, d_ff=24, n_shared=1)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, 16, spec)
    assert {k: tuple(v.shape) for k, v in p.items() if k != "shared"} == {
        "router": (16, 4), "up": (4, 16, 24), "down": (4, 24, 16),
        "gate": (4, 16, 24)}
    assert tuple(p["shared"]["up"].shape) == (16, 24)
    meta = moe.init_moe(None, 16, spec)
    assert all(v.device.type == "meta" for k, v in meta.items()
               if k != "shared")
    x = torch.randn((2, 3, 16), generator=gen)
    y, _ = moe.apply_moe(p, spec, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_single_token_decode_drops_nothing():
    spec = MoESpec(n_experts=16, top_k=2, d_ff=32, capacity_factor=0.25)
    rng = np.random.default_rng(0)
    params, _ = _both(_moe_params(rng, 16, 32, 32))
    y, _ = moe.apply_moe(params, spec, _t(rng.normal(size=(1, 1, 32))
                                          .astype(np.float32)))
    assert float(y.abs().max()) > 0.0


def _one_sided(E=2, d=32):
    """Every token routes to the last expert, whose last capacity slot is
    occupied: the row a wrapped -1 index would leak."""
    rng = np.random.default_rng(7)
    p = {"router": np.stack([np.zeros(d), np.full(d, 10.0)], axis=1),
         "up": rng.normal(size=(E, d, 32)),
         "gate": rng.normal(size=(E, d, 32)),
         "down": rng.normal(size=(E, 32, d))}
    x = rng.uniform(0.1, 1.0, size=(1, 9, d))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def test_capacity_dropped_assignments_contribute_zero():
    """C = 4: tokens 0-3 keep their slot and 4-8 drop. Every path must
    combine the drops as exact zeros, with no wrap of the dump index."""
    params_np, x = _one_sided()
    spec = MoESpec(n_experts=2, top_k=1, d_ff=32, capacity_factor=0.5)
    jspec = JaxMoESpec(n_experts=2, top_k=1, d_ff=32, capacity_factor=0.5)
    params, jparams = _both(params_np)
    y, _ = moe.apply_moe(params, spec, _t(x))
    jy, _ = jax_moe.apply_moe(jparams, jspec, jnp.asarray(x))
    assert float(y[0, :4].abs().min(dim=-1).values.max()) > 0.0
    assert float(y[0, 4:].abs().max()) == 0.0
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    packed = {(0, nm): sparse.pack_expert_projection(params[nm], block=16,
                                                     ragged=True)
              for nm in ("gate", "up", "down")}
    bp = {"moe": params}
    for kw in ({"ragged_moe": True}, {"ragged_moe": False},
               {"ragged_moe": False, "group_experts": False}):
        ys = sparse.sparse_apply_moe(bp, spec, _t(x), packed, 0, **kw)
        assert float(ys[0, 4:].abs().max()) == 0.0, kw
        assert torch.equal(ys[0, :4] != 0, y[0, :4] != 0), kw


# -------------------------------------------- the three dispatch paths

def _pruned_moe_layer(E, top_k, cf, seed, d=32, d_ff=32, block=BLOCK):
    spec = MoESpec(n_experts=E, top_k=top_k, d_ff=d_ff, capacity_factor=cf)
    rng = np.random.default_rng(seed)
    p = _moe_params(rng, E, d, d_ff)
    for nm in ("gate", "up", "down"):
        w = p[nm]
        for e in range(E):
            bm = rng.random((w.shape[1] // block, w.shape[2] // block)) < 0.6
            bm[0, 0] = True
            w[e] *= np.repeat(np.repeat(bm, block, 0), block, 1)
    params = {k: _t(v) for k, v in p.items()}
    packed = {(0, nm): sparse.pack_expert_projection(params[nm], block=block,
                                                     group=True, ragged=True)
              for nm in ("gate", "up", "down")}
    return spec, p, params, packed


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=2, max_value=6),      # n_experts
       st.integers(min_value=1, max_value=3),      # top_k (clamped)
       st.floats(min_value=0.5, max_value=1.5),    # capacity_factor
       st.integers(min_value=1, max_value=3),      # batch
       st.integers(min_value=1, max_value=3),      # tokens per sequence
       st.integers(min_value=0, max_value=10**6))  # seed
def test_ragged_grouped_loop_identical_and_match_jax(E, top_k, cf, B, S,
                                                     seed):
    """ragged == grouped == loop bitwise, all within 1e-5 relative of the
    dense einsum, and equal to the JAX package's sparse path within
    tolerance, on arbitrary valid MoE shapes."""
    top_k = min(top_k, E)
    spec, p_np, params, packed = _pruned_moe_layer(E, top_k, cf, seed)
    bp = {"moe": params}
    x = np.random.default_rng(seed + 1).normal(size=(B, S, 32)).astype(
        np.float32)
    xt = _t(x)
    y_dense, _ = moe.apply_moe(params, spec, xt)
    y_rag = sparse.sparse_apply_moe(bp, spec, xt, packed, 0, ragged_moe=True)
    y_grp = sparse.sparse_apply_moe(bp, spec, xt, packed, 0,
                                    group_experts=True, ragged_moe=False)
    y_loop = sparse.sparse_apply_moe(bp, spec, xt, packed, 0,
                                     group_experts=False, ragged_moe=False)
    assert torch.equal(y_rag, y_grp)
    assert torch.equal(y_rag, y_loop)
    scale = float(y_dense.abs().max()) + 1e-9
    assert float((y_rag - y_dense).abs().max()) / scale < 1e-5
    jspec = JaxMoESpec(n_experts=E, top_k=top_k, d_ff=32,
                       capacity_factor=cf)
    jparams = {k: jnp.asarray(v) for k, v in p_np.items()}
    jpacked = {(0, nm): jax_sparse.pack_expert_projection(
        jparams[nm], block=BLOCK, group=True, ragged=True)
        for nm in ("gate", "up", "down")}
    jy = jax_sparse.sparse_apply_moe({"moe": jparams}, jspec,
                                     jnp.asarray(x), jpacked, 0,
                                     interpret=True, ragged_moe=True)
    assert float(np.abs(y_rag.numpy() - np.asarray(jy)).max()) / scale \
        < 1e-5


def test_ragged_falls_back_to_grouped_above_the_token_limit(monkeypatch):
    """Up to RAGGED_TOKENS_MAX tokens the ragged op runs; one more and
    the grouped op takes over, with the same output."""
    spec, _, params, packed = _pruned_moe_layer(4, 2, 1.25, 3)
    bp = {"moe": params}
    calls = []
    for name in ("ragged_blocksparse_matmul", "grouped_blocksparse_matmul"):
        orig = getattr(gops, name)
        monkeypatch.setattr(gops, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    rng = np.random.default_rng(9)
    for S, want in ((sparse.RAGGED_TOKENS_MAX, "ragged_blocksparse_matmul"),
                    (sparse.RAGGED_TOKENS_MAX + 1,
                     "grouped_blocksparse_matmul")):
        x = _t(rng.normal(size=(1, S, 32)).astype(np.float32))
        calls.clear()
        y_rag = sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                        ragged_moe=True)
        assert calls == [want] * 3
        y_grp = sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                        ragged_moe=False)
        assert torch.equal(y_rag, y_grp)


def test_plans_follow_their_flags_and_no_plan_falls_back():
    spec, _, params, packed = _pruned_moe_layer(4, 2, 1.25, 5)
    bp = {"moe": params}
    x = _t(np.random.default_rng(2).normal(size=(2, 1, 32)).astype(
        np.float32))
    y_dense, _ = moe.apply_moe(params, spec, x)
    y = sparse.sparse_apply_moe(bp, spec, x, packed, 0)     # ragged plans
    assert float((y - y_dense).abs().max()) < 1e-5
    # a layer without expert plans runs the dense layer
    assert torch.equal(sparse.sparse_apply_moe(bp, spec, x, {}, 0), y_dense)
    # a projection without a plan takes the plain product in each path
    part = {k: v for k, v in packed.items() if k[1] != "down"}
    for kw in ({"ragged_moe": True}, {"ragged_moe": False},
               {"ragged_moe": False, "group_experts": False}):
        ys = sparse.sparse_apply_moe(bp, spec, x, part, 0, **kw)
        assert float((ys - y_dense).abs().max()) < 1e-5, kw


# ------------------------------------- plain kernels vs ref and Pallas

def _grouped_case(E, M, K, N, seed, block=BLOCK):
    rng = np.random.default_rng(seed)
    masks = rng.random((E, K // block, N // block)) < 0.5
    masks[:, :, 0] = False                       # an empty column
    masks[0] = False                             # an empty expert
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    w *= np.repeat(np.repeat(masks, block, 1), block, 2)
    counts, indices = gops.stack_expert_plans(
        *zip(*[plan_blocks(m) for m in masks]))
    return x, w, masks, counts, indices


@pytest.mark.parametrize("with_work", [False, True])
def test_grouped_plain_matches_jax_ref_and_pallas(with_work):
    E, M, K, N = 4, 32, 64, 48
    x, w, masks, counts, indices = _grouped_case(E, M, K, N, 11)
    row_live = None
    if with_work:
        live = np.zeros((E, M), bool)
        live[1, :5] = True                       # expert 1: one row block
        live[2, 20:] = True                      # expert 2: the other one
        live[3] = True
        row_live = live
    y = gops.grouped_blocksparse_matmul(
        _t(x), _t(w), _t(counts), _t(indices), BLOCK, block_m=BLOCK,
        row_live=None if row_live is None else _t(row_live))
    want = jax_gops.grouped_blocksparse_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(counts),
        jnp.asarray(indices), block_m=BLOCK, block_k=BLOCK, block_n=BLOCK,
        interpret=True,
        row_live=None if row_live is None else jnp.asarray(row_live))
    ref = np.asarray(jax_gref.grouped_block_sparse_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(masks), BLOCK, BLOCK))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if row_live is None:
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        dead = ~np.repeat(row_live.reshape(E, 2, BLOCK).any(-1), BLOCK, 1)
        assert not y.numpy()[dead].any()
        np.testing.assert_allclose(y.numpy()[~dead], ref[~dead], rtol=1e-5,
                                   atol=1e-5)
    assert not y[:, :, :BLOCK].any()             # the empty column


def test_ragged_plain_matches_jax_ref_and_pallas():
    E, K, N = 4, 64, 48
    _, w, masks, counts, indices = _grouped_case(E, 16, K, N, 12)
    tile_expert = np.array([1, 1, 3, 0, 2, -1, -1], np.int32)
    M = 16 * len(tile_expert)
    x = np.random.default_rng(13).normal(size=(M, K)).astype(np.float32)
    y = gops.ragged_blocksparse_matmul(_t(x), _t(w), _t(counts),
                                       _t(indices), _t(tile_expert), BLOCK)
    want = jax_gops.ragged_blocksparse_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(counts),
        jnp.asarray(indices), jnp.asarray(tile_expert), block_k=BLOCK,
        block_n=BLOCK, interpret=True)
    ref = jax_gref.ragged_block_sparse_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), tile_expert, 16, jnp.asarray(masks),
        BLOCK, BLOCK)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert not y[80:].any() and not y[48:64].any()  # dead tiles, expert 0


def test_occupancy_counts_what_jax_counts():
    """work per panel and experts computed, as the JAX ops reduce them."""
    rng = np.random.default_rng(4)
    live = rng.random((6, 48)) < 0.05
    live[2] = False
    for block_m in (16, 48):
        work, n = gops.occupancy(_t(live), 6, 48, block_m, "cpu")
        want = live.reshape(6, 48 // block_m, block_m).any(-1)
        np.testing.assert_array_equal(work.numpy(), want.astype(np.int32))
        assert int(n) == int(want.any(-1).sum())
    te = np.array([3, 3, 0, -1, 5, -1], np.int32)
    assert int(gops.ragged_occupancy(_t(te), 6)) == 3


def test_stack_and_pack_expert_plans_match_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 64, 64)).astype(np.float32)
    w[0, :48, :] = 0.0                           # expert 0 much sparser
    w[2, :, 16:32] = 0.0
    p = sparse.pack_expert_projection(_t(w), block=BLOCK, ragged=True)
    jp = jax_sparse.pack_expert_projection(jnp.asarray(w), block=BLOCK,
                                           ragged=True)
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(jp.counts))
    np.testing.assert_array_equal(p.indices.numpy(), np.asarray(jp.indices))
    assert p.densities == jp.densities and p.density == jp.density
    assert (p.group, p.ragged, p.n_experts) == (True, True, 3)
    assert p.counts.dtype == torch.int32
    for e in range(3):
        solo = sparse.pack_projection(_t(w[e]), block=BLOCK)
        assert torch.equal(p.expert(e).counts, solo.counts)
        assert p.expert(e).indices.is_contiguous()
    assert sparse.pack_expert_projection(torch.ones((4, 100, 60)),
                                         block=BLOCK) is None


def test_expert_plans_host_round_trip_and_flop_savings():
    _, p_np, params, packed = _pruned_moe_layer(4, 2, 1.25, 8)
    arrays, meta = sparse.plans_to_host(packed)
    assert all(m["expert"] and m["ragged"] and m["group"]
               for m in meta.values())
    back = sparse.plans_from_host(arrays, meta)
    for k, p in packed.items():
        b = back[k]
        assert isinstance(b, sparse.PackedExpertProjection)
        assert torch.equal(b.counts, p.counts)
        assert torch.equal(b.indices, p.indices)
        assert (b.densities, b.group, b.ragged) == (p.densities, p.group,
                                                    p.ragged)
    jback = jax_sparse.plans_from_host(arrays, meta)
    assert {k: v.densities for k, v in jback.items()} == {
        k: v.densities for k, v in packed.items()}
    assert sparse.flop_savings(packed) == pytest.approx(
        jax_sparse.flop_savings(jback))
    lop = {(0, "up"): sparse.PackedExpertProjection(
        counts=torch.zeros((2, 1), dtype=torch.int32),
        indices=torch.zeros((2, 1, 1), dtype=torch.int32), block=16,
        density=0.5, densities=(0.0, 1.0))}
    assert sparse.flop_savings(lop) == pytest.approx(0.5)
    # int8 stacks ride through with their storage, in JAX's keys
    qpacked = {k: sparse.pack_expert_projection(params[k[1]], block=BLOCK,
                                                ragged=True, quant="int8")
               for k in packed}
    arrays, meta = sparse.plans_to_host(qpacked)
    assert all(m["quant"] == "int8" for m in meta.values())
    back = sparse.plans_from_host(arrays, meta)
    jback = jax_sparse.plans_from_host(arrays, meta)
    for k, p in qpacked.items():
        jp = jax_sparse.pack_expert_projection(p_np[k[1]], BLOCK,
                                               ragged=True, quant="int8")
        for name in ("tiles", "scales", "slots"):
            assert torch.equal(getattr(back[k], name), getattr(p, name))
            np.testing.assert_array_equal(np.asarray(getattr(jback[k], name)),
                                          np.asarray(getattr(jp, name)))
    bad = dict(arrays)
    bad["0:up:slots"] = bad["0:up:slots"] + len(bad["0:up:tiles"])
    with pytest.raises(ValueError, match="past"):
        sparse.plans_from_host(bad, meta)


def test_cpu_runs_record_no_launch_and_kernels_refuse_cpu():
    spec, _, params, packed = _pruned_moe_layer(4, 2, 1.25, 6)
    counters.reset()
    x = _t(np.ones((2, 1, 32), np.float32))
    for kw in ({"ragged_moe": True}, {"ragged_moe": False},
               {"group_experts": False, "ragged_moe": False}):
        sparse.sparse_apply_moe({"moe": params}, spec, x, packed, 0, **kw)
    assert counters.snapshot() == {}
    p = packed[(0, "up")]
    w = params["up"]
    with pytest.raises(ValueError, match="CUDA"):
        gkernel.grouped_block_sparse_matmul(
            torch.zeros((4, 16, 32)), w, p.counts, p.indices,
            torch.ones((4, 1), dtype=torch.int32), BLOCK, 16)
    with pytest.raises(ValueError, match="CUDA"):
        gkernel.ragged_block_sparse_matmul(
            torch.zeros((16, 32)), w, p.counts, p.indices,
            torch.zeros((1,), dtype=torch.int32), BLOCK)


def test_counters_accumulate_device_quantities():
    counters.reset()
    counters.record("grouped_block_sparse")
    counters.record_device("x_experts_computed", torch.tensor(3))
    counters.record_device("x_experts_computed",
                           torch.tensor(4, dtype=torch.int32))
    assert counters.snapshot() == {"grouped_block_sparse": 1,
                                   "x_experts_computed": 7}
    counters.reset()
    assert counters.snapshot() == {}


def test_grouped_ref_masks_dead_panels_and_shares_kernel_1():
    """The grouped plain version runs each live expert through kernel 1's
    plain version, so its rows equal that routine's bitwise."""
    from repro_torch.kernels.block_sparse import ref as bs_ref
    x, w, masks, counts, indices = _grouped_case(3, 32, 32, 32, 14)
    work = torch.tensor([[1, 0], [0, 0], [0, 1]], dtype=torch.int32)
    y = gref.grouped_block_sparse_matmul_ref(_t(x), _t(w), _t(masks), BLOCK,
                                             BLOCK, work=work, block_m=16)
    for e, (lo, hi) in ((0, (0, 16)), (2, (16, 32))):
        full = bs_ref.block_sparse_matmul_ref(_t(x[e]), _t(w[e]),
                                              _t(masks[e]), BLOCK, BLOCK)
        assert torch.equal(y[e, lo:hi], full[lo:hi])
    assert not y[1].any() and not y[0, 16:].any() and not y[2, :16].any()


# ------------------------------------------------------- the whole model

@pytest.mark.parametrize("which", ["hybrid-ffn", "qwen3-moe-smoke"])
def test_moe_model_forward_matches_jax(which):
    """Prefill and one cached decode step of a model with MoE layers, on
    the JAX package's params: logits within 1e-4, aux loss within 1e-5
    relative."""
    from repro.models import transformer as jax_T
    from repro.models.specs import config_to_dict as jax_config_to_dict
    from tests.conftest import small_config
    from repro_torch.common.interop import params_from_numpy
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import config_from_dict
    jcfg = (small_config(moe=True) if which == "hybrid-ffn"
            else jax_get_smoke_config("qwen3-moe-30b-a3b").replace(
                n_periods=2, scan_layers=False))
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax_T.init_model(jax.random.PRNGKey(3), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    meta = T.init_model(None, cfg)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, meta)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda t: 0,
                                                            params))
    tokens = np.random.default_rng(4).integers(1, cfg.vocab, (2, 9))
    jl, _, jaux = jax_T.forward(jparams, jcfg, jnp.asarray(tokens),
                                compute_dtype=jnp.float32)
    pl, _, paux = T.forward(params, cfg, torch.from_numpy(tokens),
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    assert abs(float(paux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    # a cached decode step after the prompt
    jcache = jax_T.init_cache(jcfg, 2, 16, jnp.float32)
    _, jcache, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tokens),
                                 cache=jcache, cache_index=0,
                                 compute_dtype=jnp.float32)
    jl, _, _ = jax_T.forward(jparams, jcfg, jnp.asarray([[5], [7]]),
                             cache=jcache, cache_index=9,
                             compute_dtype=jnp.float32)
    cache = T.init_cache(cfg, 2, 16, torch.float32, "cpu")
    T.forward(params, cfg, torch.from_numpy(tokens), cache=cache,
              cache_index=0, compute_dtype=torch.float32)
    pl, _, _ = T.forward(params, cfg, torch.tensor([[5], [7]]), cache=cache,
                         cache_index=9, compute_dtype=torch.float32)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
