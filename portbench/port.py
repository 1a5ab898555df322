"""The system under test: ``repro_torch``'s continuous engine over the
benchmark's model.

The only module of the benchmark that imports the port. It turns the
benchmark's model description into the port's ``ModelConfig``, packs
the block plans with the port's own ``pack_model_with_report`` (the
port's derived state) and builds the ``ContinuousEngine`` on the paged
pool with the configuration's serving settings.
"""
from __future__ import annotations

import concurrent.futures

import torch

from repro_torch.kernels import build, counters
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig, MoESpec)
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.sparse import pack_model_with_report

# the CUDA sources the serving path launches
SOURCES = ("block_sparse.cu", "paged_attention.cu", "grouped_block_sparse.cu")


def model_config(desc: dict, max_seq: int) -> ModelConfig:
    moe = desc["moe"]
    pattern = []
    for L in desc["layers"]:
        mixer = AttentionSpec(n_q=L["n_q"], n_kv=desc["n_kv"],
                              head_dim=desc["head_dim"],
                              rope_theta=desc["rope_theta"])
        if moe is None:
            ffn = MLPSpec(d_ff=L["d_ff"], act=desc["act"], gated=True)
        else:
            ffn = MoESpec(n_experts=moe["n_experts"], top_k=moe["top_k"],
                          d_ff=L["d_ff"], act=desc["act"], gated=True,
                          capacity_factor=moe["capacity_factor"])
        pattern.append(LayerSpec(mixer=mixer, ffn=ffn))
    return ModelConfig(
        name=desc["name"], d_model=desc["d_model"], vocab=desc["vocab"],
        pattern=tuple(pattern), n_periods=1, norm="rmsnorm",
        tie_embeddings=False, scan_layers=False, remat=False,
        vocab_pad_multiple=desc["vocab_pad_multiple"], max_seq=max_seq,
        arch_class="moe" if moe else "dense")


def prebuild() -> None:
    """Build the serving path's CUDA libraries in parallel (a no-op once
    they are in the build directory)."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build.build, SOURCES))


def make_engine(desc: dict, params: dict, serving: dict, traffic: dict,
                quant: str = "none"):
    """``(engine, report)``: plans packed from ``params`` and the engine
    over them. ``quant="int8"`` packs the plans' kept tiles as int8 (the
    port's own lower-precision path)."""
    moe = desc["moe"] is not None
    cfg = model_config(desc, traffic["max_seq"])
    packed, report = pack_model_with_report(
        params, cfg, block=serving["block"],
        group_experts=serving.get("group_experts", True),
        ragged_moe=serving.get("ragged_moe", False) if moe else False,
        quant=quant)
    dtype = getattr(torch, serving["dtype"])
    serve = ServeConfig(
        max_slots=traffic["max_slots"], max_seq=traffic["max_seq"],
        compute_dtype=dtype, cache_dtype=dtype,
        block_size=serving["block_size"],
        prefill_multiple=serving["prefill_multiple"],
        prefill_chunk=serving["prefill_chunk"],
        paged_kernel=serving["paged_kernel"],
        scheduler=serving["scheduler"],
        group_experts=serving.get("group_experts") if moe else None,
        ragged_moe=serving.get("ragged_moe") if moe else None)
    return ContinuousEngine(params, cfg, serve, packed=packed), report


def counter_snapshot() -> dict:
    """The port's kernel launch counts and device-side quantities."""
    return counters.snapshot()
