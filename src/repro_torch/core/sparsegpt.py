"""SparseGPT (Frantar & Alistarh) one-shot OBS pruning.

Given a projection W (in -> out) and the input Gram matrix H = X^T X from
calibration, prune to a target sparsity while updating the surviving
weights to minimise the reconstruction error ||XW - XW'||_2. Column-
blocked as in the reference implementation: per block, scores
w²/diag(U)² with a block-global threshold, then the OBS rank-1 update
sweeps each column's error into the later columns.

The arithmetic is the JAX package's (``repro.core.sparsegpt``), step for
step: the dead-diagonal fix, damping, ``inv``, symmetrise, an upper
Cholesky; the threshold ``sort(scores)[min(k, R·bs − 1)]`` with a strict
``>``; the full-row masked update of every column. Every op works on a
leading batch axis, so an expert stack (E, in, out) is pruned as one
tensor op per step over all experts, as ``jax.vmap`` does.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import Projection

BLOCK = 128
PERCDAMP = 0.01


def _hinv_chol(H: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor U of H^{-1} (so H^{-1} = U^T U); H may carry
    leading batch axes."""
    C = H.shape[-1]
    eye = torch.eye(C, dtype=H.dtype, device=H.device)
    dead = H.diagonal(dim1=-2, dim2=-1) <= 0
    H = H + torch.diag_embed(dead.to(H.dtype))
    damp = PERCDAMP * H.diagonal(dim1=-2, dim2=-1).mean(-1)
    H = H + damp[..., None, None] * eye
    Hinv = torch.linalg.inv(H)
    Hinv = 0.5 * (Hinv + Hinv.mT)         # force symmetry before Cholesky
    return torch.linalg.cholesky(Hinv, upper=True)


def _prune_block(Wb: torch.Tensor, Ub: torch.Tensor, target: float):
    """Prune one column block. Wb: (..., R, bs), Ub: (..., bs, bs) upper.
    Returns (Wb_new, Eb, maskb). Each column step is a few tensor ops on
    Wb's device, with no host sync."""
    R, bs = Wb.shape[-2:]
    d = Ub.diagonal(dim1=-2, dim2=-1)                        # (..., bs)
    scores = Wb.square() / d.square()[..., None, :]
    k = int(target * R * bs)
    if k <= 0:
        maskb = torch.ones(Wb.shape, dtype=torch.bool, device=Wb.device)
    else:
        flat = torch.sort(scores.reshape(*scores.shape[:-2], -1),
                          dim=-1).values
        thresh = flat[..., min(k, R * bs - 1)]
        maskb = scores > thresh[..., None, None]
    idx = torch.arange(bs, device=Wb.device)
    later = idx[None, :] > idx[:, None]                      # [j]: cols > j
    W = Wb.clone()
    E = torch.zeros_like(Wb)
    for j in range(bs):
        w_j = W[..., :, j]
        q = w_j * maskb[..., :, j]
        err = (w_j - q) / Ub[..., j, j, None]
        upd = err[..., :, None] * Ub[..., j, None, :]
        W = W - torch.where(later[j], upd, 0.0)
        W[..., :, j] = q
        E[..., :, j] = err
    return W, E, maskb


def sparsegpt_dense(W_io: torch.Tensor, H: torch.Tensor, target: float):
    """W_io: (..., in, out); H: (..., in, in). Returns (new_W_io, mask_io)
    in f32 (the mask bool)."""
    Cin = W_io.shape[-2]
    W = W_io.float().mT                                      # (..., R, Cin)
    diag = H.diagonal(dim1=-2, dim2=-1)
    W = W * (diag > 0)[..., None, :]                         # dead inputs
    U = _hinv_chol(H.float())
    masks = []
    for j1 in range(0, Cin, BLOCK):
        j2 = min(j1 + BLOCK, Cin)
        Wb, Eb, mb = _prune_block(W[..., j1:j2], U[..., j1:j2, j1:j2],
                                  target)
        W[..., j1:j2] = Wb
        if j2 < Cin:
            W[..., j2:] += -(Eb @ U[..., j1:j2, j2:])
        masks.append(mb)
    mask = torch.cat(masks, dim=-1)                          # (..., R, Cin)
    W = W * mask
    return W.mT, mask.mT


def sparsegpt_prune(w: torch.Tensor, H: torch.Tensor, target: float,
                    proj: Projection):
    """Shape-polymorphic wrapper over the layouts (in, out), (in, H, D),
    (H, D, out) and the expert-batched (E, in, out). Dense layouts come
    back in ``w``'s dtype; the expert stack in f32, as in the JAX package
    (the selector casts it)."""
    orig_shape = w.shape
    if proj.expert_axis is not None:
        new_w, mask = sparsegpt_dense(w, H, target)
        return new_w.reshape(orig_shape), mask.reshape(orig_shape)
    if proj.in_axes == (0,):
        w2 = w.reshape(orig_shape[0], -1)
    elif proj.in_axes == (0, 1):
        w2 = w.reshape(orig_shape[0] * orig_shape[1], -1)
    else:
        raise ValueError(proj.in_axes)
    new_w, mask = sparsegpt_dense(w2, H, target)
    return (new_w.reshape(orig_shape).to(w.dtype),
            mask.reshape(orig_shape))
