"""Mosaic composite projection pruning on PyTorch and CUDA (Hopper).

The port of the ``repro`` package: the same params layout, pruning
pipeline and serving path, with the block-sparse FFN matmul and the POD
scoring reduction as hand-written GPU kernels (``repro_torch.kernels``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
