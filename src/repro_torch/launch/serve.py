"""Serving launcher: static or continuous batching, dense / pruned /
bundle-driven.

  # the README's main path, on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --prune 0.5 --category composite --sparse

  # a recipe at smoke size, on the CPU (kernels run their plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --recipe recipes/golden-smoke.json --sparse --device cpu

  # an MoE bundle: grouped prefill, ragged decode
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --artifact results/moe --sparse --ragged-moe --device cpu

  # a bundle pruned with recipes/quant-smoke.json: int8 kept tiles
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --artifact results/q --sparse --quant int8 --device cpu

  # serve a saved PrunedArtifact (from launch.prune, or the JAX
  # package's) on the paged pool, decode through the paged kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --artifact results/pruned --sparse --engine continuous \
      --block-size 16 --prefill-chunk 16 --paged-kernel --shared-prefix

  # the streaming HTTP front door over the paged pool, on an ephemeral
  # port it prints; pools sized from the bundle for a memory budget
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --artifact results/pruned --sparse --engine continuous \
      --block-size 16 --gateway --port 0 --memory-budget 100000000 \
      --device cpu

``--engine static`` runs the fixed-batch ``Engine``; ``--engine
continuous`` runs the slot-pool ``ContinuousEngine`` (``--block-size``
switches it to the paged KV pool). MoE expert plans run through the
grouped kernel unless ``--no-group-experts`` (one kernel-1 launch per
expert); ``--ragged-moe`` sends decode-sized batches through the ragged
kernel. ``--quant int8`` streams the plans' int8 kept tiles (kernels 5,
8 and 9), ``--quant none`` forces the dequantised reference path over
the same fake-quant weights; with ``--prune`` it also sets the recipe's
``quant``. ``--gateway`` serves ``POST /generate`` (ndjson stream or
buffered), ``GET /metrics`` and ``GET /healthz`` on ``--host`` /
``--port`` over a continuous engine until interrupted; with
``--artifact``, ``--memory-budget`` sizes its slot and block pools from
the bundle's report. Runs on ``--device cuda`` (the default) and raises
when CUDA is missing, unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.recipe import CalibrationSpec, PruneRecipe
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models import transformer as T
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.metrics import latency_percentiles
from repro_torch.serve.scheduler import Request


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_or_prune(args, device: torch.device) -> tuple:
    """Returns (params, cfg, packed, label)."""
    if args.artifact:
        art = PrunedArtifact.load(args.artifact, device)
        print(f"loaded artifact {args.artifact}: arch={art.recipe.arch} "
              f"category={art.report.get('category')} "
              f"{len(art.packed)} saved plans")
        return art.params, art.cfg, (art.packed if args.sparse else None), \
            "artifact"

    if args.recipe or args.prune > 0:
        if args.recipe:
            recipe = PruneRecipe.load(args.recipe)
        else:
            recipe = PruneRecipe(
                arch=args.arch, p=args.prune, category=args.category,
                align_channels=8, block=args.sparse_block,
                quant=("int8" if args.quant == "int8" else "none"),
                calibration=CalibrationSpec(n_samples=8, batch_size=4,
                                            seq_len=args.prompt_len))
        if not (args.sparse or args.save_artifact):
            # plans would be discarded — skip the pack stage entirely
            recipe = recipe.replace(stages=tuple(
                s for s in recipe.stages if s != "pack"))
        elif args.sparse and "pack" not in recipe.stages:
            stages = list(recipe.stages)
            at = stages.index("report") if "report" in stages else len(stages)
            recipe = recipe.replace(stages=tuple(
                stages[:at] + ["pack"] + stages[at:]))
        cfg = (get_smoke_config(recipe.arch) if args.smoke
               else get_config(recipe.arch))
        cfg = cfg.replace(scan_layers=False)
        params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
        art = MosaicPipeline(recipe).run(params, cfg)
        if args.save_artifact:
            art.save(args.save_artifact)
            print(f"saved PrunedArtifact to {args.save_artifact}")
        print(f"pruned p={recipe.p:.0%} via "
              f"{art.report.get('category') or recipe.category or 'auto'} "
              f"in {art.report.get('pipeline_seconds', 0.0):.1f}s")
        return art.params, art.cfg, (art.packed if args.sparse else None), \
            "recipe"

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(scan_layers=False)
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    packed = None
    if args.sparse:
        # unpruned weights have no zero tiles, but the kernel path is
        # still exercised (plans at 100% density)
        from repro_torch.serve.sparse import pack_model
        packed = pack_model(params, cfg, block=args.sparse_block) or None
    return params, cfg, packed, "dense"


def _path_knobs(args) -> dict:
    """``ServeConfig``'s MoE and weight-storage fields from the flags
    (None follows the flags the plans carry)."""
    return {"group_experts": False if args.no_group_experts else None,
            "ragged_moe": True if args.ragged_moe else None,
            "quant": args.quant}


def _run_continuous(args, params, cfg, packed, corpus, device) -> None:
    """Mixed-length requests through the slot / block pool."""
    rng = np.random.default_rng(0)
    shared = (corpus.batch(99, 1, args.prompt_len)[0].tolist()
              if args.shared_prefix else [])
    reqs = []
    for i in range(args.batch):
        s0 = int(rng.integers(max(args.prompt_len // 2, 1),
                              args.prompt_len + 1))
        prompt = shared + corpus.batch(i, 1, s0)[0, :s0].tolist()
        reqs.append(Request(uid=i, prompt=prompt,
                            max_new_tokens=args.new_tokens,
                            prefix_id="system" if shared else None))
    max_seq = max(len(r.prompt) for r in reqs) + args.new_tokens
    if args.block_size:
        max_seq = -(-max_seq // args.block_size) * args.block_size
    serve_cfg = ServeConfig(max_slots=args.max_slots, max_seq=max_seq,
                            block_size=args.block_size,
                            n_blocks=args.n_blocks,
                            prefill_chunk=args.prefill_chunk,
                            compute_dtype=torch.float32,
                            cache_dtype=torch.float32,
                            paged_kernel=args.paged_kernel,
                            scheduler=args.scheduler, **_path_knobs(args))
    eng = ContinuousEngine(params, cfg, serve_cfg, packed=packed)
    finished, stats = eng.run(reqs, temperature=args.temperature)
    _sync(device)
    lat = latency_percentiles(finished)
    print(f"served {len(finished)} requests, {stats.generated_tokens} tokens "
          f"on {device} in {stats.wall_s:.2f}s ({stats.tokens_per_s:.1f} "
          f"tok/s incl. first-call set-up), slot util "
          f"{stats.slot_utilization:.0%}, p50 {lat['p50']:.0f}ms p99 "
          f"{lat['p99']:.0f}ms")
    if serve_cfg.paged:
        print(f"paged: block_size={serve_cfg.block_size} "
              f"arena={serve_cfg.arena_blocks} blocks, "
              f"peak concurrency {stats.peak_concurrency}, "
              f"{stats.prefill_chunks} prefill chunks, "
              f"{stats.prompt_blocks_shared} prompt blocks shared "
              f"(hit rate {stats.prefix_hit_rate:.0%})")
    print("sample:", finished[0].tokens[:16], "...")


def _gateway_config(args) -> ServeConfig:
    """The gateway engine's ``ServeConfig``: from the flags, or with
    ``--memory-budget`` its pools sized from the bundle's report."""
    import dataclasses

    from repro_torch.serve.gateway import plan_placement

    max_seq = args.prompt_len + args.new_tokens
    if args.block_size:
        max_seq = -(-max_seq // args.block_size) * args.block_size
    if not args.memory_budget:
        return ServeConfig(max_slots=args.max_slots, max_seq=max_seq,
                           block_size=args.block_size,
                           n_blocks=args.n_blocks,
                           prefill_chunk=args.prefill_chunk,
                           compute_dtype=torch.float32,
                           cache_dtype=torch.float32,
                           paged_kernel=args.paged_kernel,
                           scheduler=args.scheduler, **_path_knobs(args))
    if not args.artifact:
        raise SystemExit("--memory-budget sizes pools from a saved "
                         "bundle's report.json; pass --artifact")
    place = plan_placement(args.artifact, args.memory_budget,
                           max_seq=max_seq, block_size=args.block_size,
                           cache_dtype=torch.float32,
                           scheduler=args.scheduler,
                           prefill_chunk=args.prefill_chunk)
    serve_cfg = dataclasses.replace(place.serve,
                                    compute_dtype=torch.float32,
                                    paged_kernel=args.paged_kernel,
                                    **_path_knobs(args))
    print(f"placement: weights {place.weights_bytes} B "
          f"(density {place.density:.0%}), KV "
          f"{place.kv_token_bytes} B/token -> {place.kv_tokens} "
          f"tokens, max_slots={serve_cfg.max_slots}"
          + (f", n_blocks={serve_cfg.n_blocks}" if serve_cfg.paged else ""))
    return serve_cfg


def _run_gateway(args, params, cfg, packed) -> None:
    """Serve the HTTP front door until interrupted."""
    import asyncio

    from repro_torch.serve.gateway import Gateway

    serve_cfg = _gateway_config(args)
    eng = ContinuousEngine(params, cfg, serve_cfg, packed=packed)

    async def _serve():
        gw = await Gateway(eng, host=args.host, port=args.port,
                           temperature=args.temperature).start()
        print(f"gateway listening on http://{args.host}:{gw.port} "
              f"(scheduler={serve_cfg.scheduler}, "
              f"{'paged' if serve_cfg.paged else 'contiguous'} pool)",
              flush=True)
        try:
            await gw.serve_forever()
        finally:
            _, stats = await gw.close()
            print(f"gateway stopped: {stats.generated_tokens} tokens, "
                  f"{stats.rejected} rejected {stats.reject_reasons}",
                  flush=True)

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recipe", default=None, metavar="JSON",
                    help="run a PruneRecipe end-to-end, then serve it")
    ap.add_argument("--engine", choices=["static", "continuous"],
                    default="static")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="serve a saved PrunedArtifact bundle")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="with --recipe/--prune: save the bundle here")
    ap.add_argument("--gateway", action="store_true",
                    help="start the streaming HTTP front door instead "
                         "of running a canned workload")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="gateway port (0 = ephemeral, printed at start)")
    ap.add_argument("--memory-budget", type=int, default=None,
                    metavar="BYTES",
                    help="with --artifact: size max_slots/n_blocks from "
                         "the bundle's report.json for this budget "
                         "(overrides --max-slots/--n-blocks)")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size / number of requests")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--prune", type=float, default=0.0)
    ap.add_argument("--category", default="composite",
                    choices=["unstructured", "structured", "composite"])
    ap.add_argument("--sparse", action="store_true",
                    help="serve pruned MLPs through the block-sparse kernel")
    ap.add_argument("--sparse-block", type=int, default=16)
    ap.add_argument("--no-group-experts", action="store_true",
                    help="fall back to one block-sparse launch per MoE "
                         "expert instead of the grouped one-launch kernel")
    ap.add_argument("--ragged-moe", action="store_true",
                    help="MoE decode ticks: pack only routed tokens into "
                         "ragged expert batches (skips empty experts) "
                         "instead of full capacity-slot batches")
    ap.add_argument("--quant", choices=["int8", "none"], default=None,
                    help="projection weight storage: int8 streams the "
                         "plans' kept-tile int8 storage (needs a bundle "
                         "packed with quant), none forces the "
                         "dequantised reference path (default: follow "
                         "plan flags)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=None, metavar="N",
                    help="continuous engine: page the KV cache into "
                         "N-token blocks (default: contiguous slots)")
    ap.add_argument("--n-blocks", type=int, default=None, metavar="K",
                    help="paged: arena size in blocks (default: enough "
                         "for max_slots full sequences)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="C",
                    help="paged: split prompt prefill into C-token "
                         "chunks interleaved with decode ticks")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="paged: decode through the paged-attention "
                         "kernel instead of gathering each slot's "
                         "logical KV view")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="paged demo: prepend one shared system prompt "
                         "to every request under a common prefix_id")
    ap.add_argument("--scheduler", default="fifo",
                    help="admission policy: fifo | priority | slo")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when CUDA is missing) or "
                         "cpu")
    return ap


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    params, cfg, packed, source = _load_or_prune(args, device)
    if packed:
        from repro_torch.serve.sparse import flop_savings
        print(f"sparse fast path: {len(packed)} plans "
              f"({source}), {flop_savings(packed):.0%} projection "
              f"FLOPs skipped")

    if args.gateway:
        _run_gateway(args, params, cfg, packed)
        return
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    if args.engine == "continuous":
        _run_continuous(args, params, cfg, packed, corpus, device)
        return
    if args.block_size:
        print("note: --block-size is a continuous-engine flag; the static "
              "engine always uses a contiguous cache")
    serve_cfg = ServeConfig(max_seq=args.prompt_len + args.new_tokens,
                            compute_dtype=torch.float32,
                            cache_dtype=torch.float32, **_path_knobs(args))
    eng = Engine(params, cfg, serve_cfg, packed=packed)
    prompt = corpus.batch(0, args.batch, args.prompt_len)[:, :args.prompt_len]
    _sync(device)
    t0 = time.perf_counter()
    out = eng.generate(prompt, args.new_tokens, temperature=args.temperature)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"generated {tuple(out.shape)} on {device} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. first-call set-up)")
    print("sample:", out[0, -args.new_tokens:].tolist()[:16], "...")


if __name__ == "__main__":
    main()
