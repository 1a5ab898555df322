"""The port's paged KV cache and serving bookkeeping against the JAX
package, and the attention kernels' plain versions.

- The host-side modules (block allocator with copy-on-write and the
  reserve block, prefix cache, scheduler, admission policies, metrics)
  take the same event sequences in both packages and end in the same
  state.
- ``paged_write`` / ``paged_gather`` equal the JAX functions exactly.
- Paged decode attention: the port's plain version is held to JAX's
  ``paged_attention_ref`` and to the Pallas kernel in interpret mode,
  including a row masked to the scratch block and rows reading shared
  blocks.
- Causal attention: the port's flash plain version and its
  ``_chunked_causal_attention`` are held to the Pallas flash kernel in
  interpret mode at S = 512, and to the chunked path at S = 3072, which
  also runs the model's long-prefill branch against JAX.

Inputs are made with numpy from fixed seeds; f32 throughout, with each
tolerance stated beside it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.flash_attention.kernel import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.kernels.paged_attention.ops import \
    paged_attention_decode as jax_paged_decode
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_paged_ref
from repro.models import layers as jax_L
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve import metrics as jax_M
from repro.serve import paging as jax_paging
from repro.serve import policies as jax_policies
from repro.serve import scheduler as jax_sched
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy
from repro_torch.kernels import counters
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.specs import config_from_dict
from repro_torch.serve import metrics as M
from repro_torch.serve import paging
from repro_torch.serve import policies
from repro_torch.serve import scheduler as sched_mod

CPU = torch.device("cpu")
ATOL = 2e-5          # f32 attention outputs of O(1): softmax/sum order


def _np(t):
    return np.asarray(t)


# ----------------------------------------------- allocator / COW / prefix

def _pools(n_blocks, block_size):
    """The same paged pool, filled with distinct values, in both
    packages (2 layers, 2 kv heads of width 16)."""
    jcfg = small_config()
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jpool = jax_T.init_paged_pool(jcfg, n_blocks, block_size, jnp.float32)
    fill = lambda a: np.arange(a.size, dtype=np.float32).reshape(a.shape)  # noqa: E731
    jpool = jax.tree_util.tree_map(lambda a: jnp.asarray(fill(a)), jpool)
    pool = T.init_paged_pool(cfg, n_blocks, block_size, torch.float32)
    for layer in pool:
        for arena in layer["attn"].values():
            arena.copy_(torch.from_numpy(fill(arena.numpy())))
    return jpool, pool


def _pool_equal(jpool, pool):
    for jl, l in zip(jpool, pool):
        for name in ("k", "v"):
            np.testing.assert_array_equal(_np(jl["attn"][name]),
                                          l["attn"][name].numpy())


def _allocator_script(mod, pool):
    """One event sequence: alloc, share, release, copy-on-write with and
    without the reserve, out-of-blocks. Returns its observable trace."""
    a = mod.BlockAllocator(n_blocks=5, block_size=4)
    trace = [a.n_free, a.scratch]
    b = a.alloc(3)
    a.retain(b[:2])
    trace += [list(b), [a.refcount(x) for x in b], a.n_free]
    a.release(b[1:])
    trace += [[a.refcount(x) for x in b], a.n_free]
    table = [b[0], b[1], a.scratch]
    pool = a.ensure_writable(table, 0, pool)          # shared: copy
    trace += [list(table), a.refcount(b[0]), a.n_free]
    pool = a.ensure_writable(table, 1, pool)          # exclusive: no-op
    (reserve,) = a.alloc(1)
    a.retain([table[1]])
    pool = a.ensure_writable(table, 1, pool, reserve=reserve)
    trace += [list(table), a.n_free]
    a.alloc(a.n_free)
    a.retain([table[0]])
    with pytest.raises(mod.OutOfBlocks):
        a.ensure_writable(table, 0, pool)               # full arena
    trace.append(list(table))
    for bad in (a.release, a.retain):
        with pytest.raises(ValueError):
            bad([a.scratch])
    return trace, pool


def test_allocator_and_copy_on_write_match_jax():
    jpool, pool = _pools(5, 4)
    jtrace, jpool = _allocator_script(jax_paging, jpool)
    trace, pool = _allocator_script(paging, pool)
    assert trace == jtrace
    _pool_equal(jpool, pool)


def _prefix_script(mod):
    a = mod.BlockAllocator(n_blocks=8, block_size=4)
    pc = mod.PrefixCache(a)
    prompt = list(range(100, 110))
    owned = a.alloc(3)
    out = [pc.shareable_tokens(range(n)) for n in (4, 8, 9)]
    pc.register("sys", prompt, owned)
    out += [len(pc), a.refcount(owned[0])]
    for pid, p in (("sys", prompt), ("sys", prompt[:9] + [999]),
                   ("sys", prompt[:6] + [777, 778, 779, 780]),
                   ("sys", [999] + prompt[1:]), ("other", prompt),
                   (None, prompt)):
        out.append(pc.match(pid, p))
    pc.register("sys", [1, 2, 3, 4, 5], owned)      # first writer wins
    out.append(pc.match("sys", prompt))
    a.release(owned)
    pc.drop_all()
    out += [a.n_free, len(pc)]
    return out


def test_prefix_cache_matches_jax():
    assert _prefix_script(paging) == _prefix_script(jax_paging)


# ------------------------------------------- scheduler / policies / metrics

def _requests(mod, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=[1] * int(rng.integers(1, 12)),
                        max_new_tokens=int(rng.integers(1, 6)),
                        eos_id=int(rng.integers(0, 4)) if i % 3 == 0
                        else None,
                        arrival=float(rng.integers(0, 3)),
                        priority=int(rng.integers(0, 4)),
                        deadline_ms=(float(rng.integers(1, 4000))
                                     if i % 2 else None))
            for i in range(14)]


def _scheduler_script(mod, policy, seed):
    """Random submissions, gated admissions, prefills and decode ticks
    over a clock; returns every observable step."""
    rng = np.random.default_rng(seed + 100)
    events = []
    s = mod.Scheduler(max_slots=3, max_seq=10, policy=policy,
                      on_token=lambda sl, t, now: events.append(
                          ("tok", sl.request.uid, t)),
                      on_finish=lambda f: events.append(
                          ("fin", f.request.uid, f.reason, list(f.tokens))),
                      on_reject=lambda r: events.append(
                          ("rej", r.request.uid, r.reason)))
    for r in _requests(mod, seed):
        s.submit(r)
    for now in range(40):
        gate = int(rng.integers(0, 4))
        admitted = s.admissions(float(now), lambda r: r.uid % 4 != gate)
        events.append(("adm", [sl.request.uid for sl in admitted],
                       [sl.index for sl in admitted]))
        for sl in list(s.prefilling.values())[
                :s.policy.prefill_budget(len(s.slots)) or None]:
            s.started(sl, int(rng.integers(0, 4)), float(now))
        s.decoded({sl.index: int(rng.integers(0, 4)) for sl in s.active()},
                  float(now))
        events.append(("state", s.concurrency(), s.utilization(),
                       len(s.queue), s.next_arrival(), s.has_work()))
        if not s.has_work():
            break
    return events, [(f.request.uid, f.reason, f.tokens) for f in s.finished]


@pytest.mark.parametrize("policy", ["fifo", "priority", "slo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_and_policies_match_jax(policy, seed):
    assert policies.SCHEDULERS.names() == jax_policies.SCHEDULERS.names()
    got = _scheduler_script(sched_mod, policy, seed)
    want = _scheduler_script(jax_sched, policy, seed)
    assert got == want
    assert got[1], "the script finished some requests"


def test_metrics_match_jax():
    def script(mod):
        reg = mod.MetricsRegistry(capacity=8)
        for i in range(20):
            reg.observe("tick.active_slots", i % 5)
            reg.gauge("tick.free_blocks", 30 - i)
            reg.count("decode.ticks", 2)
        Req, Fin = jax_sched.Request, jax_sched.Finished
        fins = [Fin(request=Req(uid=i, prompt=[1], max_new_tokens=2,
                                arrival=0.1 * i,
                                deadline_ms=None if i % 2 else 400.0),
                    tokens=[1, 2], reason="length", admitted_at=0.2 * i,
                    first_token_at=0.3 * i, finished_at=0.5 * i)
                for i in range(6)]
        for f in fins:
            mod.observe_finished(reg, f)
        return (reg.summary(), reg.percentiles("request.total_ms"),
                mod.latency_percentiles(fins), mod.queue_percentiles(fins),
                mod.slo_attainment(fins), mod.stage_latencies_ms(fins[3]))
    assert script(M) == script(jax_M)


# ------------------------------------------------- paged write / gather

def test_paged_write_and_gather_match_jax():
    rng = np.random.default_rng(3)
    nb, bs, nkv, D, B, S, M_ = 13, 4, 2, 8, 3, 6, 3
    arena = rng.standard_normal((nb, bs, nkv, D)).astype(np.float32)
    new = rng.standard_normal((B, S, nkv, D)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * M_].reshape(B, M_).astype(np.int32)
    start = np.array([0, 3, 6], np.int32)
    for n_valid in (None, np.array([6, 2, 5], np.int32)):
        want = jax_L.paged_write(jnp.asarray(arena), jnp.asarray(new),
                                 jnp.asarray(tables), jnp.asarray(start),
                                 None if n_valid is None
                                 else jnp.asarray(n_valid))
        got = L.paged_write(torch.from_numpy(arena.copy()),
                            torch.from_numpy(new), torch.from_numpy(tables),
                            torch.from_numpy(start),
                            None if n_valid is None
                            else torch.from_numpy(n_valid))
        if n_valid is not None:      # padding lands in the scratch block
            np.testing.assert_array_equal(got[:-1].numpy(), _np(want)[:-1])
        else:
            np.testing.assert_array_equal(got.numpy(), _np(want))
        np.testing.assert_array_equal(
            L.paged_gather(got, torch.from_numpy(tables)).numpy(),
            _np(jax_L.paged_gather(want, jnp.asarray(tables))))


# ---------------------------------------------- paged decode attention

def _paged_case(hq, hkv, bs, seed, B=5, M_=4, D=16):
    """A shuffled arena, ragged lengths; row 1 masked to the scratch
    block at length 1 (a slot mid-prefill during a decode burst), row 3
    reading row 0's blocks with row 0's query and length, row 4 sharing
    row 2's first two blocks."""
    rng = np.random.default_rng(seed)
    nb = B * M_
    ka = rng.standard_normal((nb + 1, bs, hkv, D)).astype(np.float32)
    va = rng.standard_normal((nb + 1, bs, hkv, D)).astype(np.float32)
    tables = rng.permutation(nb).reshape(B, M_).astype(np.int32)
    lengths = rng.integers(1, M_ * bs + 1, (B,)).astype(np.int32)
    q = rng.standard_normal((B, 1, hq, D)).astype(np.float32)
    tables[1], lengths[1] = nb, 1
    tables[3], lengths[3], q[3] = tables[0], lengths[0], q[0]
    tables[4, :2] = tables[2, :2]
    return q, ka, va, tables, lengths


@pytest.mark.parametrize("hq,hkv,bs", [(4, 2, 8), (6, 2, 4), (4, 4, 8),
                                       (8, 1, 16)])
def test_paged_attention_plain_matches_jax(hq, hkv, bs):
    case = _paged_case(hq, hkv, bs, seed=hq + bs)
    q, ka, va, tables, lengths = case
    want_ref = _np(jax_paged_ref(*(jnp.asarray(a) for a in
                                   (q[:, 0], ka, va, tables, lengths))))
    want_kernel = _np(jax_paged_decode(*(jnp.asarray(a) for a in case),
                                       interpret=True))
    counters.reset()
    got = pa_ops.paged_attention_decode(*(torch.from_numpy(a)
                                          for a in case))
    assert counters.snapshot() == {}, "the plain version launches nothing"
    assert got.shape == q.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got[:, 0].numpy(), want_ref, atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[3].numpy(), got[0].numpy())


# ------------------------------------------------------ causal attention

def _qkv(B, S, hq, hkv, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, D)).astype(np.float32)
                 for h in (hq, hkv, hkv))


def _flat(a):
    """(B, S, H, D) -> the Pallas kernel's (B*H, S, D)."""
    B, S, H, D = a.shape
    return jnp.asarray(np.moveaxis(a, 2, 1).reshape(B * H, S, D))


def test_flash_plain_and_chunked_match_jax_flash_at_512():
    q, k, v = _qkv(2, 512, 6, 2, 16, seed=5)
    want = jax_flash_attention(_flat(q), _flat(k), _flat(v), n_q_heads=6,
                               n_kv_heads=2, block_q=256, block_k=256,
                               interpret=True)
    want = np.moveaxis(_np(want).reshape(2, 6, 512, 16), 1, 2)
    want_ref = np.moveaxis(_np(jax_flash_ref(
        _flat(q), _flat(k), _flat(v), n_q_heads=6,
        n_kv_heads=2)).reshape(2, 6, 512, 16), 1, 2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = fa_ops.flash_attention_bshd(tq, tk, tv)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(plain.numpy(), want_ref, atol=ATOL, rtol=0)
    pos = torch.arange(512)[None, :].expand(2, 512)
    old_chunk = L.Q_CHUNK
    try:            # the chunked path at a chunk that divides 512
        L.Q_CHUNK = 128
        chunked = L._chunked_causal_attention(tq, tk, tv, pos)
    finally:
        L.Q_CHUNK = old_chunk
    np.testing.assert_allclose(chunked.numpy(), want, atol=ATOL, rtol=0)


def test_flash_plain_matches_chunked_at_3072():
    q, k, v = _qkv(1, 3072, 4, 2, 16, seed=6)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.arange(3072)[None, :]
    chunked = L._chunked_causal_attention(tq, tk, tv, pos)
    want = _np(jax_L._chunked_causal_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(pos.numpy())))
    np.testing.assert_allclose(chunked.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(fa_ref.flash_attention_ref(tq, tk, tv).numpy(),
                               chunked.numpy(), atol=ATOL, rtol=0)
    # the model's long branch runs the chunked path on CPU tensors
    np.testing.assert_array_equal(
        L._long_causal_attention(tq, tk, tv, pos).numpy(), chunked.numpy())
    with pytest.raises(ValueError, match="multiple of"):
        L._long_causal_attention(tq[:, :3000], tk[:, :3000], tv[:, :3000],
                                 pos[:, :3000])


def test_long_prefill_branch_matches_jax_forward():
    """S = 3072 > DENSE_ATTN_MAX: the forward with no cache and the
    prefill into a cache both take the long branch, in both packages."""
    jcfg = small_config()
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax_T.init_model(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    S = 3072
    tokens = np.random.default_rng(7).integers(0, 256, (1, S),
                                               dtype=np.int32)
    want, _, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tokens),
                               compute_dtype=jnp.float32)
    got, _, _ = T.forward(params, cfg, torch.from_numpy(tokens),
                          compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=0)
    jcache = jax_T.init_cache(jcfg, 1, S + 64, jnp.float32)
    want_c, _, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tokens),
                                 cache=jcache, cache_index=jnp.int32(0),
                                 compute_dtype=jnp.float32)
    cache = T.init_cache(cfg, 1, S + 64, torch.float32)
    got_c, _, _ = T.forward(params, cfg, torch.from_numpy(tokens),
                            cache=cache, cache_index=0,
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(got_c.numpy(), _np(want_c), atol=1e-4,
                               rtol=0)
