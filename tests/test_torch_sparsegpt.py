"""The port's Hessian taps, Hessian profiles and SparseGPT against the
JAX package, at small size on the CPU (f32).

Both packages get the same numpy-seeded inputs, or the same params
through the numpy carrier (JAX ``init_model`` -> ``params_from_numpy``).
Tolerances:
- Gram matrices (taps ``hessian`` / ``both``, dense and per-expert):
  within 1e-5 x max|H| of JAX's (the sums run in another order);
- ``_hinv_chol``: within 1e-4 x max|U| (f32 ``inv`` and Cholesky);
- ``_prune_block`` given JAX's own ``U``: the mask identical and W and
  the errors within 1e-5 x max(1, max|W|);
- ``sparsegpt_dense`` / ``sparsegpt_prune`` end to end (the port's own
  ``U``; a mask can flip where a score sits on the threshold within an
  ulp of ``inv``): masks agree on >= 99.5% of the weights and the
  reconstruction error ||XW' - XW|| is within 1% of JAX's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import calibrate as jax_C
from repro.core import sparsegpt as jax_SG
from repro.core import unstructured as jax_U
from repro.core.rank_controller import RankArtifact as JaxRankArtifact
from repro.core.rank_controller import profile_model as jax_profile_model
from repro.core.registry import Projection as JaxProjection
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy
from repro_torch.common.tree import iter_paths
from repro_torch.core import calibrate as C
from repro_torch.core import sparsegpt as SG
from repro_torch.core import unstructured as U
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import (RankArtifact, ensure_hessians,
                                              profile_model,
                                              run_ranking_controller)
from repro_torch.core.recipe import CalibrationSpec, PruneRecipe
from repro_torch.core.registry import Projection, projections
from repro_torch.models.specs import config_from_dict

CPU = torch.device("cpu")
GRAM_RTOL = 1e-5
CHOL_RTOL = 1e-4
BLOCK_ATOL = 1e-5
MASK_AGREE = 0.995
RECON_RTOL = 0.01


def _calib(vocab, n=2, batch=2, seq=16):
    return [np.random.default_rng(100 + i).integers(
        0, vocab, (batch, seq)).astype(np.int32) for i in range(n)]


def _model(moe: bool):
    jcfg = small_config(moe=moe)
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def dense():
    return _model(moe=False)


@pytest.fixture(scope="module")
def moe():
    return _model(moe=True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------- Hessian taps

@pytest.mark.parametrize("mode", ["hessian", "both"])
@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_gram_taps_match_jax(request, arch, mode):
    """Dense Grams (d, d) and the MoE taps' per-expert (E, d, d) ones."""
    jcfg, cfg, jparams, params = request.getfixturevalue(arch)
    batches = _calib(cfg.vocab)
    stats, n = C.calibrate(params, cfg, batches, CPU, mode=mode)
    jstats, jn = jax_C.calibrate(jparams, jcfg, batches, mode=mode)
    assert n == jn and set(stats) == set(jstats)
    if mode == "both":
        (ssq, stats), (jssq, jstats) = (C.split_stats(stats),
                                        jax_C.split_stats(jstats))
        for k in jssq:
            np.testing.assert_allclose(_np(ssq[k]), np.asarray(jssq[k]),
                                       rtol=1e-5, atol=1e-6)
    for k, jh in jstats.items():
        jh = np.asarray(jh)
        h = _np(stats[k])
        assert h.dtype == np.float32 and h.shape == jh.shape
        if k[1].startswith("moe"):
            assert h.ndim == 3 and h.shape[0] == 4       # (E, d, d)
        assert np.abs(h - jh).max() <= GRAM_RTOL * np.abs(jh).max()


def test_both_mode_equals_separate_modes(dense):
    """Tap mode 'both' == ssq-mode stats + hessian-mode stats exactly."""
    _, cfg, _, params = dense
    batches = _calib(cfg.vocab)
    both, _ = C.calibrate(params, cfg, batches, CPU, mode="both")
    ssq, _ = C.calibrate(params, cfg, batches, CPU, mode="ssq")
    hess, _ = C.calibrate(params, cfg, batches, CPU, mode="hessian")
    s2, h2 = C.split_stats(both)
    for k in ssq:
        assert torch.equal(s2[k], ssq[k]) and torch.equal(h2[k], hess[k])


# ------------------------------------------------------ Hessian profiles

def test_rank_artifact_roundtrip_with_hessians(dense, tmp_path):
    _, cfg, _, params = dense
    ra = profile_model(params, cfg, _calib(cfg.vocab), want_hessians=True)
    d = str(tmp_path / "profile")
    ra.save(d)
    assert RankArtifact.is_artifact(d)
    lr = RankArtifact.load(d, CPU)
    assert lr.n_tokens == ra.n_tokens
    assert lr.weights == ra.weights
    assert lr.profile_seconds == pytest.approx(ra.profile_seconds)
    assert set(lr.rank) == set(ra.rank)
    for k, v in ra.rank.items():
        assert isinstance(lr.rank[k], float) == isinstance(v, float)
        np.testing.assert_array_equal(np.asarray(lr.rank[k]),
                                      np.asarray(v))
    assert set(lr.anorms) == set(ra.anorms)
    for k in ra.anorms:
        assert torch.equal(lr.anorms[k], ra.anorms[k])
    assert lr.hessians is not None and set(lr.hessians) == set(ra.hessians)
    for k in ra.hessians:
        assert torch.equal(lr.hessians[k], ra.hessians[k])


def test_rank_artifact_roundtrip_without_hessians(dense, tmp_path):
    _, cfg, _, params = dense
    ra = profile_model(params, cfg, _calib(cfg.vocab))
    d = str(tmp_path / "nohess")
    ra.save(d)
    lr = RankArtifact.load(d, CPU)
    assert lr.hessians is None
    assert lr.rank == pytest.approx(ra.rank)


def test_rank_artifact_load_rejects_non_bundle(tmp_path):
    with pytest.raises(FileNotFoundError):
        RankArtifact.load(str(tmp_path / "missing"), CPU)


@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_hessian_profile_cross_loads_both_ways(request, arch, tmp_path):
    """A Hessian profile saved by either package loads in the other with
    the same arrays, bit for bit, and the two profiles' Hessians agree."""
    jcfg, cfg, jparams, params = request.getfixturevalue(arch)
    batches = _calib(cfg.vocab)
    ra = profile_model(params, cfg, batches, want_hessians=True)
    jra = jax_profile_model(jparams, jcfg, batches, want_hessians=True)
    ra.save(str(tmp_path / "port"))
    jra.save(str(tmp_path / "jax"))
    in_jax = JaxRankArtifact.load(str(tmp_path / "port"))
    in_port = RankArtifact.load(str(tmp_path / "jax"), CPU)
    assert in_jax.hessians is not None and in_port.hessians is not None
    assert set(in_jax.hessians) == set(ra.hessians) == set(jra.hessians)
    for k in ra.hessians:
        np.testing.assert_array_equal(np.asarray(in_jax.hessians[k]),
                                      ra.hessians[k].numpy())
        np.testing.assert_array_equal(in_port.hessians[k].numpy(),
                                      np.asarray(jra.hessians[k]))
        jh = np.asarray(jra.hessians[k])
        assert (np.abs(ra.hessians[k].numpy() - jh).max()
                <= GRAM_RTOL * np.abs(jh).max())
    assert in_port.weights == ra.weights == in_jax.weights
    assert in_port.n_tokens == ra.n_tokens


def test_profile_single_calibration_pass(dense, monkeypatch):
    """want_hessians must NOT trigger a second calibration pass."""
    _, cfg, _, params = dense
    calls = []
    real = C.calibrate

    def counting(params, cfg, batches, device, mode="ssq"):
        calls.append(mode)
        return real(params, cfg, batches, device, mode=mode)

    monkeypatch.setattr(C, "calibrate", counting)
    ra = profile_model(params, cfg, _calib(cfg.vocab), want_hessians=True)
    assert calls == ["both"]
    assert ra.hessians is not None
    run_ranking_controller(params, cfg, _calib(cfg.vocab),
                           want_hessians=True)
    assert calls == ["both", "both"]


def test_profile_consumes_generator_once(dense):
    """The calibration iterable is consumed once — a generator works."""
    _, cfg, _, params = dense
    batches = _calib(cfg.vocab)
    ra_gen = profile_model(params, cfg, iter(batches), want_hessians=True)
    ra_list = profile_model(params, cfg, batches, want_hessians=True)
    assert ra_gen.n_tokens == ra_list.n_tokens
    assert ra_gen.rank == pytest.approx(ra_list.rank)
    for k in ra_list.hessians:
        assert torch.equal(ra_gen.hessians[k], ra_list.hessians[k])


def test_single_pass_matches_separate_passes(dense):
    """A 'both' profile == an ssq profile + lazily attached Hessians;
    ensure_hessians does not mutate its input, adds its seconds, and is
    a no-op (the same object) when Hessians are present."""
    _, cfg, _, params = dense
    batches = _calib(cfg.vocab)
    ra_ssq = profile_model(params, cfg, batches)
    ra_both = profile_model(params, cfg, batches, want_hessians=True)
    assert ra_ssq.rank == pytest.approx(ra_both.rank)
    for k in ra_ssq.anorms:
        assert torch.equal(ra_ssq.anorms[k], ra_both.anorms[k])
    lazy = ensure_hessians(ra_ssq, params, cfg, iter(batches))
    assert ra_ssq.hessians is None
    assert lazy.profile_seconds > ra_ssq.profile_seconds
    for k in ra_both.hessians:
        assert torch.equal(lazy.hessians[k], ra_both.hessians[k])
    assert ensure_hessians(ra_both, params, cfg, batches) is ra_both


# ---------------------------------------------------------------- SparseGPT

def _gram_case(cin: int, n: int = 512, seed: int = 0, dead=()):
    """X (n, cin) with channel scales spread 0.2-3, H = X^T X (f32)."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, cin))
         * np.linspace(0.2, 3.0, cin)).astype(np.float32)
    X[:, list(dead)] = 0.0
    return X, (X.T @ X).astype(np.float32)


def test_hinv_chol_matches_jax():
    _, H = _gram_case(160, dead=(3, 77))            # dead diagonal entries
    U = SG._hinv_chol(torch.from_numpy(H)).numpy()
    jU = np.asarray(jax_SG._hinv_chol(jnp.asarray(H)))
    assert np.abs(U - jU).max() <= CHOL_RTOL * np.abs(jU).max()
    assert np.allclose(np.tril(U, -1), 0.0)          # upper factor
    batched = SG._hinv_chol(torch.from_numpy(np.stack([H, 2 * H]))).numpy()
    jU2 = np.asarray(jax_SG._hinv_chol(jnp.asarray(2 * H)))
    assert np.abs(batched[0] - U).max() <= CHOL_RTOL * np.abs(jU).max()
    assert np.abs(batched[1] - jU2).max() <= CHOL_RTOL * np.abs(jU2).max()


@pytest.mark.parametrize("target", [0.0, 0.3, 0.6])
def test_prune_block_matches_jax_given_jax_u(target):
    rng = np.random.default_rng(1)
    _, H = _gram_case(64)
    jU = np.array(jax_SG._hinv_chol(jnp.asarray(H)))
    Wb = rng.standard_normal((24, 64)).astype(np.float32)
    jW, jE, jm = (np.asarray(a) for a in jax_SG._prune_block(
        jnp.asarray(Wb), jnp.asarray(jU), target))
    W, E, m = (a.numpy() for a in SG._prune_block(
        torch.from_numpy(Wb), torch.from_numpy(jU), target))
    np.testing.assert_array_equal(m, jm)
    tol = BLOCK_ATOL * max(1.0, np.abs(jW).max())
    assert np.abs(W - jW).max() <= tol
    assert np.abs(E - jE).max() <= BLOCK_ATOL * max(1.0, np.abs(jE).max())
    # the threshold is the k-th smallest score and '>' keeps, so k + 1
    # weights go (no ties among random scores)
    k = int(target * Wb.size)
    assert int((~m).sum()) == (k + 1 if k > 0 else 0)


def _recon(X2, w2, new_w2) -> float:
    return float(np.linalg.norm(X2 @ new_w2 - X2 @ w2))


def _check_against_jax(X2, w2, new_w2, mask2, jnew_w2, jmask2):
    """X2 (n, cin); the rest (cin, out) views (expert: (E, cin, out))."""
    agree = float((mask2 == jmask2).mean())
    assert agree >= MASK_AGREE, agree
    err, jerr = _recon(X2, w2, new_w2), _recon(X2, w2, jnew_w2)
    assert abs(err - jerr) <= RECON_RTOL * jerr, (err, jerr)


@pytest.mark.parametrize("target", [0.5, 0.7])
def test_sparsegpt_dense_matches_jax(target):
    """Two column blocks, the second a partial one (192 = 128 + 64)."""
    rng = np.random.default_rng(2)
    X, H = _gram_case(192, dead=(5,))
    W = rng.standard_normal((192, 48)).astype(np.float32)
    new_w, mask = (a.numpy() for a in SG.sparsegpt_dense(
        torch.from_numpy(W), torch.from_numpy(H), target))
    jnew_w, jmask = (np.asarray(a) for a in jax_SG.sparsegpt_dense(
        jnp.asarray(W), jnp.asarray(H), target))
    assert new_w.shape == W.shape and mask.dtype == np.bool_
    assert np.all(new_w[~mask] == 0.0) and np.all(new_w[5] == 0.0)
    _check_against_jax(X, W, new_w, mask, jnew_w, jmask)


# (in, out), (in, H, D) and (H, D, out) layouts, and an expert stack
LAYOUTS = {
    "in_out": ((160, 48), (0,), None),
    "in_h_d": ((160, 4, 16), (0,), None),
    "h_d_out": ((10, 16, 48), (0, 1), None),
    "experts": ((3, 160, 32), (1,), 0),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sparsegpt_prune_layouts_match_jax(layout):
    shape, in_axes, expert_axis = LAYOUTS[layout]
    rng = np.random.default_rng(3)
    w = rng.standard_normal(shape).astype(np.float32)
    if expert_axis is None:
        X, H = _gram_case(160, seed=4)
    else:
        cases = [_gram_case(160, seed=4 + e) for e in range(shape[0])]
        X, H = np.stack([c[0] for c in cases]), np.stack([c[1] for c in cases])
    kw = dict(layer=0, name="w", path=("w",), tap="t", in_axes=in_axes,
              expert_axis=expert_axis)
    new_w, mask = (a.numpy() for a in SG.sparsegpt_prune(
        torch.from_numpy(w), torch.from_numpy(H), 0.5, Projection(**kw)))
    jnew_w, jmask = (np.asarray(a) for a in jax_SG.sparsegpt_prune(
        jnp.asarray(w), jnp.asarray(H), 0.5, JaxProjection(**kw)))
    assert new_w.shape == jnew_w.shape == shape
    assert mask.shape == shape and new_w.dtype == jnew_w.dtype
    if expert_axis is None:
        as2 = (lambda a: a.reshape(160, -1))
        _check_against_jax(X, as2(w), as2(new_w), as2(mask), as2(jnew_w),
                           as2(jmask))
    else:
        for e in range(shape[0]):
            _check_against_jax(X[e], w[e], new_w[e], mask[e], jnew_w[e],
                               jmask[e])


def test_sparsegpt_identity_hessian_equals_magnitude_blockwise():
    W = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (32, 64)).astype(np.float32))
    H = torch.eye(32) * 2.0
    _, mask = SG.sparsegpt_dense(W, H, 0.5)
    # with isotropic H there is no error propagation between blocks:
    # selection is pure magnitude within each column block
    assert float((~mask).float().mean()) == pytest.approx(0.5, abs=0.02)
    kept = W.abs()[mask]
    dropped = W.abs()[~mask]
    assert float(kept.min()) >= float(dropped.max()) - 1e-6


def test_sparsegpt_beats_magnitude_on_reconstruction():
    X, H = _gram_case(64, n=512, seed=4)
    W = np.random.default_rng(5).standard_normal((64, 32)).astype(np.float32)
    Wsp, _ = SG.sparsegpt_dense(torch.from_numpy(W), torch.from_numpy(H),
                                0.6)
    flat = np.sort(np.abs(W).reshape(-1))
    Wmag = np.where(np.abs(W) > flat[int(0.6 * flat.size)], W, 0.0)
    assert _recon(X, W, Wsp.numpy()) < _recon(X, W, Wmag)


def test_sparsegpt_selector_needs_hessians(dense):
    jcfg, cfg, jparams, params = dense
    targets = {p.key: 0.5 for p in projections(cfg)}
    with pytest.raises(ValueError, match="needs calibration hessians"):
        U.prune_unstructured(params, cfg, targets, selector="sparsegpt")
    with pytest.raises(ValueError, match="needs calibration hessians"):
        jax_U.prune_unstructured(jparams, jcfg, targets,
                                 selector="sparsegpt")


def test_sparsegpt_selector_matches_jax_given_jax_hessians(dense):
    """The registered selector over every projection of the model, with
    JAX's Hessians fed to both packages."""
    jcfg, cfg, jparams, params = dense
    jra = jax_profile_model(jparams, jcfg, _calib(cfg.vocab),
                            want_hessians=True)
    hess = {k: torch.from_numpy(np.array(v))
            for k, v in jra.hessians.items()}
    targets = {p.key: 0.5 for p in projections(cfg)}
    new_p, masks = U.prune_unstructured(params, cfg, targets,
                                        selector="sparsegpt", hessians=hess)
    jnew_p, jmasks = jax_U.prune_unstructured(
        jparams, jcfg, targets, selector="sparsegpt", hessians=jra.hessians)
    assert U.achieved_sparsity(masks) == pytest.approx(
        jax_U.achieved_sparsity(jmasks))
    for k, m in masks.items():
        agree = float((m.numpy() == np.asarray(jmasks[k])).mean())
        assert agree >= MASK_AGREE, (k, agree)


def test_loaded_profile_drives_sparsegpt_identically(dense, tmp_path):
    _, cfg, _, params = dense
    ra = profile_model(params, cfg, _calib(cfg.vocab), want_hessians=True)
    d = str(tmp_path / "sg")
    ra.save(d)
    loaded = RankArtifact.load(d, CPU)
    recipe = PruneRecipe(arch=cfg.name, p=0.5, category="unstructured",
                         selector="sparsegpt", align_channels=16, block=16,
                         calibration=CalibrationSpec(4, 2, 16),
                         stages=("plan", "prune", "report"))
    a1 = MosaicPipeline(recipe).run(params, cfg, rank_artifact=ra)
    a2 = MosaicPipeline(recipe).run(params, cfg, rank_artifact=loaded)
    for (p1, l1), (p2, l2) in zip(iter_paths(a1.params),
                                  iter_paths(a2.params)):
        assert p1 == p2
        assert torch.equal(l1, l2)
    assert a1.report["info"]["unstructured_sparsity"] > 0.3

