"""Plain PyTorch versions of the Wanda-metric reduction."""
from __future__ import annotations

from typing import Optional

import torch


def metric_ref(w: torch.Tensor, anorm: torch.Tensor) -> torch.Tensor:
    return w.float().abs() * anorm.float()[:, None]


def wanda_partials_ref(w: torch.Tensor, anorm: torch.Tensor,
                       threshold: Optional[torch.Tensor] = None, *,
                       block_k: int, block_n: int) -> torch.Tensor:
    """Per-(K-block, N-block) sums of ω, or counts of ω > threshold; the
    ragged edge tiles cover what is left."""
    m = metric_ref(w, anorm)
    if threshold is not None:
        m = (m > threshold.reshape(())).float()
    K, N = m.shape
    gk, gn = -(-K // block_k), -(-N // block_n)
    m = torch.nn.functional.pad(m, (0, gn * block_n - N, 0, gk * block_k - K))
    return m.reshape(gk, block_k, gn, block_n).sum(dim=(1, 3))


def outlier_ratio_ref(w: torch.Tensor, anorm: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Eq. 6 outlier percentage: 100 · mean(ω > α · mean(ω))."""
    m = metric_ref(w, anorm)
    return 100.0 * (m > alpha * m.mean()).float().mean()
