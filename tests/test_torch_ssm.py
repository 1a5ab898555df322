"""The port's Mamba-2 mixer and its SSD chunked scan against the JAX
package, at f32 on the CPU.

The same inputs, made from numpy seeds, go through both packages. The
SSD scan's plain version (``kernels/ssd_scan/ref.py``, and the ``ops``
entry point, which takes it for CPU tensors) agrees with JAX's
``ssd_chunked`` (output and final state) and with the Pallas kernel in
interpret mode (``ssd_apply``) within 1e-5 relative, including a nonzero
initial state, ``L < chunk`` and a ragged tail. The conv, the mixer with
and without a cache, the hybrid forward and decode, and the head pruning
are held to JAX on params made by JAX ``init_model``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import structured as jax_S
from repro.kernels.ssd_scan.ops import ssd_apply
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_T
from repro.models.specs import MambaSpec as JaxMambaSpec
from repro.models.specs import config_to_dict as jax_config_to_dict
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.core import structured as S
from repro_torch.kernels import counters
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.specs import MambaSpec, config_from_dict

RTOL = 1e-5          # relative to max|JAX|: f32 einsum and cumsum order
ATOL = 1e-4          # f32 logits
CPU = torch.device("cpu")
jax_forward = jax.jit(jax_T.forward, static_argnames=("cfg", "compute_dtype"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(seed, B, L, H, P, N, h0=False):
    """The JAX kernel test's distributions: da = -|normal| * 0.1."""
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((B, L, H, P)).astype(np.float32)
    da = (-np.abs(rng.standard_normal((B, L, H))) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    h = (rng.standard_normal((B, H, P, N)).astype(np.float32)
         if h0 else None)
    return xt, da, Bm, Cm, h


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-9
    assert float(np.abs(np.asarray(got) - want).max()) / scale < rtol


# (B, L, H, P, N, chunk, h0): the JAX kernel test's three dims, then a
# nonzero initial state, L < chunk and a ragged tail (L % chunk != 0)
SSD_CASES = [(2, 64, 3, 16, 8, 16, False), (1, 128, 2, 32, 16, 32, False),
             (2, 96, 1, 16, 8, 32, False), (2, 64, 3, 16, 8, 16, True),
             (2, 12, 2, 16, 8, 32, False), (1, 50, 2, 16, 16, 16, True)]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_jax(case):
    B, L, H, P, N, chunk, with_h0 = case
    xt, da, Bm, Cm, h0 = _ssd_inputs(sum(case[:6]), B, L, H, P, N, with_h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    y_j, h_j = jax_ssm.ssd_chunked(jnp.asarray(xt), jnp.asarray(da),
                                   jnp.asarray(Bm), jnp.asarray(Cm), chunk,
                                   jh0)
    th0 = None if h0 is None else _t(h0)
    counters.reset()
    for fn in (ssd_ref.ssd_chunked, ssd_ops.ssd_scan):
        y, h = fn(_t(xt), _t(da), _t(Bm), _t(Cm), chunk, th0)
        assert tuple(y.shape) == (B, L, H, P) and y.dtype == torch.float32
        assert tuple(h.shape) == (B, H, P, N) and h.dtype == torch.float32
        _close(y.numpy(), y_j)
        _close(h.numpy(), h_j)
    assert counters.snapshot() == {}, "CPU tensors launch no kernel"
    if h0 is None and L % chunk == 0:
        y_k = ssd_apply(jnp.asarray(xt), jnp.asarray(da), jnp.asarray(Bm),
                        jnp.asarray(Cm), chunk=chunk, interpret=True)
        _close(y.numpy(), y_k)


def test_ssd_state_carries_across_calls():
    """Two calls, the second from the first's final state, give one
    call's output and state: what a chunked prefill into a cache relies
    on."""
    xt, da, Bm, Cm, _ = _ssd_inputs(3, 2, 40, 2, 16, 8)
    y, h = ssd_ref.ssd_chunked(_t(xt), _t(da), _t(Bm), _t(Cm), 16)
    y1, h1 = ssd_ref.ssd_chunked(_t(xt[:, :24]), _t(da[:, :24]),
                                 _t(Bm[:, :24]), _t(Cm[:, :24]), 16)
    y2, h2 = ssd_ref.ssd_chunked(_t(xt[:, 24:]), _t(da[:, 24:]),
                                 _t(Bm[:, 24:]), _t(Cm[:, 24:]), 16, h1)
    _close(torch.cat([y1, y2], 1).numpy(), y.numpy())
    _close(h2.numpy(), h.numpy())


def test_causal_conv_with_carry_matches_jax():
    rng = np.random.default_rng(4)
    B, L, C, K = 2, 7, 24, 4
    xbc = rng.standard_normal((B, L, C)).astype(np.float32)
    w = rng.standard_normal((C, K)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    carry = rng.standard_normal((B, K - 1, C)).astype(np.float32)
    for c in (None, carry):
        out_j, nc_j = jax_ssm._causal_conv(
            jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b),
            None if c is None else jnp.asarray(c))
        out, nc = ssm._causal_conv(_t(xbc), _t(w), _t(b),
                                   None if c is None else _t(c))
        np.testing.assert_allclose(out.numpy(), out_j, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(nc.numpy(), np.asarray(nc_j))


def _mamba_layer(seed=5):
    spec = MambaSpec(d_inner=64, d_state=16, head_dim=16, chunk=8)
    jspec = JaxMambaSpec(d_inner=64, d_state=16, head_dim=16, chunk=8)
    jp = jax_ssm.init_mamba(jax.random.PRNGKey(seed), 32, jspec)
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CPU)
    return spec, jspec, p, jp


def test_init_mamba_shapes_and_distribution_match_jax():
    spec, jspec, _, jp = _mamba_layer()
    p = ssm.init_mamba(torch.Generator().manual_seed(0), 32, spec)
    assert set(p) == set(jp)
    for k, v in jp.items():
        assert tuple(p[k].shape) == v.shape and str(p[k].dtype).replace(
            "torch.", "") == str(v.dtype), k
    for k in ssm.F32_LEAVES:
        assert p[k].dtype == torch.float32
    # one uniform draw u: dt = softplus(dt_bias) in [1e-3, 0.1] and
    # A = -exp(A_log) = -(1 + 15 u), so both order the heads alike
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert bool(((dt > 1e-3 - 1e-7) & (dt < 0.1 + 1e-7)).all())
    u_dt = (torch.log(dt) - math.log(1e-3)) / (math.log(0.1) - math.log(1e-3))
    u_a = (torch.exp(p["A_log"]) - 1.0) / 15.0
    np.testing.assert_allclose(u_dt.numpy(), u_a.numpy(), atol=1e-5)
    meta = ssm.init_mamba(None, 32, spec)
    assert all(t.device.type == "meta" for t in meta.values())


def test_apply_mamba_without_cache_matches_jax():
    spec, jspec, p, jp = _mamba_layer()
    x = np.random.default_rng(6).standard_normal((2, 19, 32)).astype(
        np.float32)
    out_j, _ = jax_ssm.apply_mamba(jp, jspec, jnp.asarray(x))
    out, nc = ssm.apply_mamba(p, spec, _t(x))
    assert nc is None
    _close(out.numpy(), out_j)


@pytest.mark.parametrize("L", [1, 11])
def test_apply_mamba_with_cache_matches_jax(L):
    """A prefill (L > 1, the SSD scan from the cache's state) and a
    decode step (L == 1, the recurrence), both from a nonzero cache: the
    output and the cache, updated in place, equal JAX's."""
    spec, jspec, p, jp = _mamba_layer()
    rng = np.random.default_rng(7 + L)
    x = rng.standard_normal((2, L, 32)).astype(np.float32)
    conv = rng.standard_normal((2, 3, spec.conv_dim)).astype(np.float32)
    state = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    out_j, c_j = jax_ssm.apply_mamba(
        jp, jspec, jnp.asarray(x),
        {"conv": jnp.asarray(conv), "state": jnp.asarray(state)})
    cache = ssm.init_mamba_cache(2, spec, torch.float32)
    assert cache["state"].dtype == torch.float32
    cache["conv"].copy_(_t(conv))
    cache["state"].copy_(_t(state))
    ids = {k: id(v) for k, v in cache.items()}
    out, nc = ssm.apply_mamba(p, spec, _t(x), cache)
    assert {k: id(v) for k, v in nc.items()} == ids, "updated in place"
    _close(out.numpy(), out_j)
    np.testing.assert_allclose(nc["conv"].numpy(), c_j["conv"], rtol=1e-6)
    _close(nc["state"].numpy(), c_j["state"])


def _model(cfg_kw, seed=0):
    jcfg = small_config(**cfg_kw)
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax_T.init_model(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    return jcfg, cfg, jparams, params


HYBRIDS = {"mamba": dict(mamba=True), "moe+mamba": dict(moe=True,
                                                        mamba=True)}


@pytest.mark.parametrize("name", sorted(HYBRIDS))
def test_hybrid_forward_logits_match_jax(name):
    jcfg, cfg, jparams, params = _model(HYBRIDS[name])
    assert "mamba" in params["blocks"][len(cfg.pattern) - 1]
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 21),
                                             dtype=np.int32)
    want, _, jaux = jax_forward(jparams, jcfg, jnp.asarray(toks),
                                compute_dtype=jnp.float32)
    got, _, aux = T.forward(params, cfg, torch.from_numpy(toks).long(),
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_mamba_state_decode_matches_scan():
    """The port of the JAX test of the same name: stepping a Mamba-only
    stack token by token through the cache gives the full forward's
    logits."""
    jcfg, cfg, _, _ = _model(dict(mamba=True))
    cfg = cfg.replace(pattern=cfg.pattern[1:], n_periods=2)
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 12)))
    full, _, _ = T.forward(params, cfg, toks, compute_dtype=torch.float32)
    cache = T.init_cache(cfg, 2, 12, torch.float32)
    outs = []
    for i in range(12):
        li, cache, _ = T.forward(params, cfg, toks[:, i:i + 1], cache=cache,
                                 cache_index=i, compute_dtype=torch.float32)
        outs.append(li)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(HYBRIDS))
def test_prefill_then_decode_matches_jax(name):
    """A prefill into the cache (the SSD scan with its final state) and
    decode steps (the recurrence; attention layers at their cache index)
    give JAX's logits step by step."""
    jcfg, cfg, jparams, params = _model(HYBRIDS[name])
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (2, 17),
                                              dtype=np.int32)
    S0, S_max = 11, 24
    jcache = jax_T.init_cache(jcfg, 2, S_max, dtype=jnp.float32)
    cache = T.init_cache(cfg, 2, S_max, torch.float32)
    assert set(cache[len(cfg.pattern) - 1]) == {"mamba"}
    want, jcache, _ = jax_forward(jparams, jcfg, jnp.asarray(toks[:, :S0]),
                                  cache=jcache, cache_index=0,
                                  compute_dtype=jnp.float32)
    got, cache, _ = T.forward(params, cfg, torch.from_numpy(toks[:, :S0]),
                              cache=cache, cache_index=0,
                              compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for i in range(S0, toks.shape[1]):
        want, jcache, _ = jax_forward(
            jparams, jcfg, jnp.asarray(toks[:, i:i + 1]), cache=jcache,
            cache_index=jnp.int32(i), compute_dtype=jnp.float32)
        got, cache, _ = T.forward(params, cfg,
                                  torch.from_numpy(toks[:, i:i + 1]),
                                  cache=cache, cache_index=i,
                                  compute_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    li = len(cfg.pattern) - 1
    _close(cache[li]["mamba"]["state"].numpy(), jcache[li]["mamba"]["state"])


def test_write_cache_slot_copies_mamba_rows():
    _, cfg, _, params = _model(dict(moe=True, mamba=True))
    pool = T.init_cache_pool(cfg, 3, 16, torch.float32)
    row = T.init_cache(cfg, 1, 16, torch.float32)
    T.forward(params, cfg, torch.arange(1, 8)[None], cache=row,
              cache_index=0, compute_dtype=torch.float32)
    T.write_cache_slot(pool, row, 2)
    for p_layer, r_layer in zip(pool, row):
        for kind, leaves in r_layer.items():
            for name, t in leaves.items():
                assert torch.equal(p_layer[kind][name][2], t[0])
                assert not p_layer[kind][name][:2].any()
    with pytest.raises(ValueError, match="attention mixers only"):
        T.init_paged_pool(cfg, 8, 4, torch.float32)


def test_prune_mamba_matches_jax():
    """Whole SSD heads out of ``in_proj`` [z, x, B, C, dt], the conv
    [x, B, C], the per-head leaves and ``out_proj``: the same heads and
    the same params as JAX."""
    spec, jspec, p, jp = _mamba_layer(11)
    for frac, align in ((0.5, 1), (0.3, 2), (0.0, 1)):
        jblock, jnew = jax_S.prune_mamba({"mamba": jp}, jspec, frac, align)
        block, new = S.prune_mamba({"mamba": p}, spec, frac, align)
        assert new.d_inner == jnew.d_inner and new.in_dim == jnew.in_dim
        for k, v in jblock["mamba"].items():
            np.testing.assert_array_equal(
                params_to_numpy(block["mamba"][k]), np.asarray(v), err_msg=k)


def test_ssd_kernel_rejects_cpu_tensors_and_is_built_with_the_rest():
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel
    xt, da, Bm, Cm, _ = _ssd_inputs(12, 1, 8, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_scan(_t(xt), _t(da), _t(Bm), _t(Cm), 8)
    assert sorted(build.SOURCES) == sorted(
        p.name for p in build.CSRC.glob("*.cu"))
    assert kernel.SOURCE in build.SOURCES


@pytest.mark.parametrize("P,want", [(64, 64), (128, 64), (32, 32),
                                    (16, 16), (48, 16)])
def test_ssd_kernel_p_slice_is_the_widest_that_divides_p(P, want):
    """The widest P slice the kernel is built for that divides P."""
    from repro_torch.kernels.ssd_scan.kernel import p_slice
    assert p_slice(P) == want
