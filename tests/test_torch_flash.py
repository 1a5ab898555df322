"""Kernel 4 (causal flash attention) in bf16: the port's plain version
against the JAX package's Pallas kernel (``interpret=True``) and its
``ref.py``, all three run in bf16 on the same inputs.

The plain version, like the CUDA kernel's bf16 routine, rounds the
softmax probabilities P to bf16 before P.V (the tensor cores take bf16
operands); the Pallas kernel keeps P in f32 and ``ref.py`` rounds it to
bf16 as the plain version does. The gap is bounded by one bf16 ulp of
the output scale: 2^-7 x max|JAX| (``KERNEL_RTOL["bfloat16"]`` of
``chip_smoke.py``), and the Frobenius norm of the gap by 2^-7 of the
JAX output's. Inputs are made with numpy from fixed seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention.kernel import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

BF16_RTOL = 2 ** -7      # one bf16 ulp of the output's scale


def _flat(a):
    """(B, S, H, D) -> the Pallas kernel's (B*H, S, D), in bf16."""
    B, S, H, D = a.shape
    return jnp.asarray(np.moveaxis(a, 2, 1).reshape(B * H, S, D),
                       dtype=jnp.bfloat16)


def _unflat(x, B, H):
    BH, S, D = x.shape
    return np.moveaxis(np.asarray(x).astype(np.float32).reshape(B, H, S, D),
                       1, 2)


@pytest.mark.parametrize("B,n_q,n_kv,D,seed", [
    (2, 6, 2, 64, 5),       # group 3, as the pruned llama3-8b's heads
    (1, 4, 1, 128, 7),      # one kv head, llama's head width
    (1, 2, 2, 32, 9),       # group 1, a narrow head
])
def test_flash_plain_bf16_matches_jax_flash_bf16_at_512(B, n_q, n_kv, D,
                                                        seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, 512, h, D)).astype(np.float32)
               for h in (n_q, n_kv, n_kv))
    # both packages see the same bf16 values
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    q, k, v = (t.float().numpy() for t in (tq, tk, tv))
    want = _unflat(jax_flash_attention(
        _flat(q), _flat(k), _flat(v), n_q_heads=n_q, n_kv_heads=n_kv,
        block_q=256, block_k=256, interpret=True), B, n_q)
    want_ref = _unflat(jax_flash_ref(_flat(q), _flat(k), _flat(v),
                                     n_q_heads=n_q, n_kv_heads=n_kv), B, n_q)
    plain = fa_ops.flash_attention_bshd(tq, tk, tv)
    assert plain.dtype == torch.bfloat16 and plain.shape == tq.shape
    got = plain.float().numpy()
    for ref in (want, want_ref):
        tol = BF16_RTOL * np.abs(ref).max()
        assert np.abs(got - ref).max() <= tol
        # the bulk, whose values are far below max|ref|, at its own scale
        assert np.linalg.norm(got - ref) <= BF16_RTOL * np.linalg.norm(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_rejects_cpu_tensors(dtype):
    """The kernel's entry launches on CUDA tensors or raises: it never
    takes the plain version itself (``ops`` chooses that for CPU
    tensors)."""
    q, k, v = (torch.zeros((1, 128, h, 64), dtype=dtype) for h in (2, 1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
