"""Two-pass outlier ratio (Eq. 6) on the Wanda-metric partial kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.no_backward import check_inputs
from repro_torch.kernels.wanda_metric import kernel, ref


def outlier_ratio(w: torch.Tensor, anorm: torch.Tensor,
                  alpha: float = 5.0) -> torch.Tensor:
    """Eq. 6 outlier percentage for one projection folded to w (K, N)
    with input-channel norms anorm (K,); a 0-d f32 tensor on w's device.

    CUDA: pass 1 sums ω tile by tile, ``thresh = max(α·mean, 1e-30)`` is
    formed on the device, pass 2 counts ω > thresh. CPU: the plain
    version, exactly ``pod.outlier_ratio(weight_metric(...))``."""
    check_inputs("outlier_ratio", w, anorm)
    if w.device.type == "cpu":
        return ref.outlier_ratio_ref(w, anorm, alpha)
    anorm = anorm.float().contiguous()
    total = kernel.wanda_partials(w, anorm).double().sum().float()
    thresh = torch.clamp(alpha * total / w.numel(), min=1e-30).reshape(1)
    count = kernel.wanda_partials(w, anorm, thresh).double().sum().float()
    return 100.0 * count / w.numel()
