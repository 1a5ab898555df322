#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing one line of its own:

1. device     — asserts CUDA, prints the card's name and power limit;
2. build      — builds every kernel from this checkout's sources: one
                ``nvcc`` per CUDA source (block-sparse, paged attention,
                flash attention, grouped/ragged block-sparse, SSD scan,
                Wanda reduction), all started together;
3. main       — the port's main path at the full width of llama3-8b
                (depth cut to 4 layers, random weights from seed 0):
                ``MosaicPipeline`` on ``recipes/golden-smoke.json``
                (profile, POD rank, plan, composite prune, pack), then the
                static ``Engine`` serves 4 prompts x 32 greedy tokens
                through the block-sparse kernel. The launch counters are
                reset just before and read just after; the same pruned
                params served dense are the reference for logits and
                tokens;
   prune side — the rest of the prune side on the same dense llama3-8b
                params: ``run_sweep`` of ``recipes/sweep-grid.json`` (six
                points: p 0.3/0.5/0.7 x composite/unstructured) over
                golden-smoke with the ``evaluate`` stage, profiling once
                (exact kernel-2 count) and saving its profile and six
                bundles; the same points timed with a profile at every
                point (the model-production ratio, recorded); a
                ``sparsegpt`` composite point swept on the saved profile,
                which gains its Hessians lazily (no kernel-2 launch), and
                whose mask stage beats wanda_block's reconstruction error
                on each of layer 0's seven projections; the p 0.5
                composite point's bundle served sparse (kernel 1) and
                dense, held to the main phase's gates;
4. continuous — the pruned bundle saved with ``PrunedArtifact.save``,
                loaded back and checked equal, then served by the
                ``ContinuousEngine`` on 12 requests (one 3072-token
                prompt, four sharing a 64-token prefix) three times: the
                contiguous pool (the long prompt prefills through the
                flash-attention kernel), the paged pool on the gather
                path, and the paged pool through the paged-attention
                kernel. Counters are reset before and read after each
                run; tokens must agree across the three runs;
   gateway    — the HTTP front door (``serve.gateway.Gateway`` on
                127.0.0.1, an ephemeral port) over the continuous
                engine's paged pool through the paged-attention kernel,
                on the same pruned llama3-8b: the 12 requests over HTTP
                (eight streamed, four buffered, four sampled with their
                own seed), every request's tokens equal to the same
                requests through ``ContinuousEngine.run``, /healthz and
                /metrics checked, exact launch counts; time to first
                token and tokens/s over HTTP beside ``run``'s;
5. trace      — ``torch.profiler`` over a warm window of decode steps:
                the static engine sparse and dense, and the paged pool
                with and without the paged-attention kernel; device time
                by kernel and by op, device idle share;
6. kernels    — each kernel against its plain PyTorch version at the
                shapes of the paths above, with times, bounds and a
                library yardstick, in max-abs and in the Frobenius norm
                of the error, with its host time a call; kernel 2 also
                twice bitwise;
                kernel 1 also at a 512-row prefill,
                and in f32 held bitwise to kernel 6 with one expert
                (one warp routine, which kernels 5-9 run too);
                kernel 3 also at the
                paged trace's 8 rows of 256, the longest row alone and
                gemma-2b's and nemotron-4-340b's heads, each case run
                again with a twin of its longest row that must give that
                row's bits (and every other row the first run's);
                kernel 4 at S 3072 at the pruned llama's, gemma-2b's and
                nemotron-4-340b's heads, with its host time a call and
                its first design's time; both attention kernels also in
                the Frobenius norm of the error; the paged step's
                prologue (``rope_kv_write``) at the phi3 cells' heads, a
                64-row decode step and a padded 512-token chunk, f32 and
                bf16, RoPE on and off, bitwise to its plain version, with
                its plain version's device and host time a call;
   bf16 prefill — one 3072-token prompt, batch 1, through the static
                ``Engine`` in bf16 (compute and cache) on the pruned
                llama3-8b: one kernel-4 launch a layer, finite logits,
                the prefill's wall time and kernel 4's share of its
                device time (``torch.profiler``);
7. moe        — qwen3-moe-30b-a3b at full width (depth cut to 4 layers,
                random weights from seed 0), after the llama3-8b phases'
                tensors are freed: ``MosaicPipeline`` on
                ``recipes/moe-smoke.json`` (expert channels pruned,
                per-expert plan stacks packed), the bundle saved, reloaded
                and checked exact, then 4 prompts x 32 greedy tokens on
                the static engine four ways — default (grouped prefill,
                ragged decode), grouped only, the per-expert loop through
                kernel 1, dense — with exact launch counts per run and
                tokens held to dense; layer 0's MoE output bitwise equal
                across ragged, grouped and loop (f32, and the decode
                batch in bf16); 8 requests on the
                continuous engine's paged pool through the paged kernel,
                held to a dense contiguous run; a decode trace, sparse
                and dense; kernels 6 and 7 against their plain versions
                at layer 0's gate and down stacks (kernel 6 at the 4 x 32
                prefill's 16 slot rows and at a 3072-token prompt's 240,
                with its host time a call and its first design's time;
                kernel 7 at the 4-token decode tick and at a 64-token
                one, the most the ragged route takes, likewise timed;
                kernel 6 with one expert held bitwise to kernel 1 in both
                types at both heights); then a quarter of the experts
                removed (``expert_frac``, 128 -> 96, top-8 kept), the
                stacks re-packed, the bundle round trip, and 4 x 32
                tokens default (kernels 6 and 7) and dense with exact
                launch counts and tokens held to dense;
   moe bf16 prefill — one 3072-token prompt, batch 1, through the static
                ``Engine`` in bf16 on the pruned qwen3-moe: kernel 6
                three times a layer (240 capacity rows an expert), kernel
                4 once, finite logits, the prefill's wall time and kernel
                6's share of its device time;
8. quant      — llama3-8b again, pruned with ``recipes/quant-smoke.json``
                (golden-smoke plus int8 kept tiles): the plans' host round
                trip checked exact, then 4 prompts x 32 greedy tokens on
                the static engine three ways — int8 (kernel 5), "none"
                (kernel 1 over the fake-quant weights) and dense — with
                int8 and "none" logits bitwise equal and exact launch
                counts; warm tok/s of each way twice in mirrored order;
                decode traces int8 and "none"; kernel 5 at the layer-0
                gate and down, 16 and 128 rows;
9. moe quant  — qwen3-moe-30b-a3b pruned with the MoE recipe and
                ``quant="int8"``: the bundle round trip (tiles, absolute
                slots, stacked scales exact), 4 x 32 tokens on the static
                engine four ways — int8 default (kernel 8 prefill, kernel
                9 decode), int8 grouped only, "none", dense — with int8
                and "none" logits bitwise equal; layer 0's MoE rows
                bitwise equal across the int8 ragged, grouped and loop
                (kernel 5 on absolute slots) paths and the "none" ones; 8
                requests on the paged pool with int8 and "none", tokens
                equal; mirrored tok/s and decode traces as for llama;
                kernels 8 and 9 at layer 0's gate and down stacks
                (kernel 8 at 16 and 240 slot rows, as kernel 6; kernel 9
                at 4 and 64 tokens, as kernel 7);
10. ssm       — mamba2-1.3b at full width and depth (48 layers, random
                weights from seed 0), after the MoE tensors are freed:
                ``MosaicPipeline`` on ``recipes/golden-smoke.json`` with
                its arch set to mamba2 (SSD heads pruned, Mamba
                projections planned), the bundle round trip, 4 x 32
                greedy tokens on the static engine (each prefill one
                kernel-10 launch per layer, decode the plain recurrence),
                one 600-token prefill held to stepping the same tokens
                through the recurrence, 8 requests (prompts of 4096, 3000
                and 17-300 tokens) on the continuous engine's contiguous
                pool held request by request to the static engine, exact
                launch counts, a decode trace, the 4096-token prefill's
                wall time and kernel 10's share of its device time, and
                kernel 10 against its plain version at layer 0's inputs
                of three prompts in both types (max-abs and Frobenius,
                two launches bitwise equal, each sub-kernel's device
                time, host time a call);
11. hybrid    — jamba-v0.1-52b at the JAX package's smoke size (attention,
                Mamba, MLP and MoE layers in one cache pool) pruned with
                the MoE recipe and served static and continuous to equal
                tokens, through kernels 10, 1, 6 and 7;
12. train     — the training path (plain PyTorch with autograd, as the
                reference trains in plain JAX): llama3-8b at full width
                and 2 layers, 12 ``Trainer`` steps on one batch of 4 x
                1024 tokens, bf16 over f32 masters with remat and AdamW
                (the loss on those tokens falls,
                finite, no kernel launch; warm step ms, tokens/s, peak
                memory, model FLOP/s share), then 2 steps each of
                qwen3-moe-30b-a3b (2 layers) and mamba2-1.3b (4 layers);
                then the first trained model: ``launch/train.py`` on
                tests/test_system.py's small llama-style model, 120
                steps, preempted at step 60 and resumed (losses within
                1e-3 of an uninterrupted run), its base ppl, the three
                categories at p 0.3 (kernel 2; unstructured <= 1.5 x
                composite <= 1.5^2 x structured), LoRA recovery at p 0.5,
                and the composite model served sparse (kernel 1) and
                dense to equal tokens outside near ties;
13. archs     — the registry's other seven architectures at their
                published widths (``ARCH_PHASES``: gemma-2b 3 layers,
                phi3-medium-14b 1, qwen2-72b 1, nemotron-4-340b 1 with
                bf16 params, qwen2-vl-2b 7, musicgen-large 8,
                llama4-scout-17b-16e 1; random weights from seed 0), one
                phase each, its tensors freed before the next: pruned
                with golden-smoke's recipe, its arch replaced (llama4-
                scout: no calibration, which the reference cannot run
                either; plans packed from the unpruned params), the
                bundle saved and loaded back with every leaf held to its
                checksum, 4 x 32 tokens on the static engine sparse and
                dense (llama4-scout: the four MoE ways) under the main
                phase's gates, the dense run's prefill and decode held
                to one full forward (dense archs); continuous runs on
                the contiguous pool (a 3072-token prompt through kernel
                4) and the paged pool through kernel 3 (gemma-2b,
                musicgen-large, whose paged run is repeated dense;
                llama4-scout's 8 MoE requests); a 3072-token prompt with
                768 positions of frontend embeddings through
                ``make_prefill_step`` and 15 decode steps held to one
                full forward (qwen2-vl-2b, musicgen-large); kernel 1 at
                nemotron's layer-0 up and down; kernels 6 and 7 at
                llama4-scout's gate and down stacks. Each logs its
                seconds and peak memory;
14. distributed — (run after the train phase) the distribution layer on
                one card: NCCL at world
                size 1 (127.0.0.1, a free port) and ``make_host_mesh``
                (1 x 1); params, caches and inputs as DTensors laid out by
                the JAX package's specs. llama3-8b (full width, 2 layers,
                f32, seed 0): a 3072-token forward whose attention runs
                kernel 4 on each rank's local shards (``local_map``),
                held to the unsharded forward (logits within
                ``LOGIT_ATOL``, equal argmax, equal kernel-4 count), and
                a prefill plus one decode step on a sharded contiguous
                cache held the same way; mamba2-1.3b (full width, 4
                layers): a 600-token prefill through kernel 10 on local
                shards, held the same way; 3 sharded ``Trainer`` steps of
                llama3-8b (2 layers, bf16 over f32 masters) within
                ``DIST_LOSS_RTOL`` of the unsharded Trainer in loss, and
                the sharded params' checkpoint round trip held bitwise;
                the same pair with a factored second moment and bf16
                momentum (the dry-run's nemotron-4-340b train cell's
                optimizer), its whole sharded state (params, m, v's row,
                col and full) round-tripping a checkpoint bitwise, no
                kernel launched by either pair;
                ``compressed_all_reduce`` over the one-rank NCCL group
                (NCCL's all-reduce launched) bitwise equal to
                ``compress_tree``. The process group is destroyed at the
                end; the phase logs its seconds, peak memory and the
                sharded and unsharded ms (recorded, no claim).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result. It imports nothing of JAX or
of the JAX package. A full record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,      # FFMA, outside the tensor cores
            "bfloat16": 989e12}    # dense tensor-core rate
LOGIT_ATOL = 1e-3                  # f32 sparse vs dense logits, see check
KERNEL_RTOL = {"float32": 1e-4,    # x max|plain|: f32 sum-order noise
               "bfloat16": 2 ** -7}  # one bf16 ulp: both round the output
N_PERIODS = 4                      # llama3-8b's 32 layers cut to 4
BATCH, PROMPT_LEN, NEW_TOKENS = 4, 32, 32
TRACE_STEPS = 8                    # decode steps under the profiler
L2_FLUSH_BYTES = 256 << 20         # > the H100's 50 MB L2
BLOCK_SPARSE_TPU = "src/repro/kernels/block_sparse/kernel.py:111"
# Kernels 1 and 5 of the first design (one 256-thread block per 16-row
# tile, scalar loads, FFMA in both types), ms at each case of
# phase_kernels / phase_quant: this script's own earlier run on an NVIDIA
# H100 80GB HBM3 at 700.00 W. Keys (case, M, block, dtype).
FIRST_DESIGN_MS = {
    ("layer0.gate", 16, 16, "float32"): 0.2087,
    ("layer0.gate", 16, 16, "bfloat16"): 0.1798,
    ("layer0.gate", 128, 16, "float32"): 1.2343,
    ("layer0.gate", 128, 16, "bfloat16"): 1.1477,
    ("layer0.up", 16, 16, "float32"): 0.2142,
    ("layer0.up", 16, 16, "bfloat16"): 0.1830,
    ("layer0.up", 128, 16, "float32"): 1.2379,
    ("layer0.up", 128, 16, "bfloat16"): 1.1508,
    ("layer0.down", 16, 16, "float32"): 0.5434,
    ("layer0.down", 16, 16, "bfloat16"): 0.4867,
    ("layer0.down", 128, 16, "float32"): 2.0567,
    ("layer0.down", 128, 16, "bfloat16"): 1.9108,
    ("layer0.gate/crop", 16, 128, "float32"): 0.3180,
    ("layer0.gate/crop", 16, 128, "bfloat16"): 0.3188,
    ("layer0.gate/crop", 128, 128, "float32"): 0.5874,
    ("layer0.gate/crop", 128, 128, "bfloat16"): 0.5839,
    ("layer0.up/crop", 16, 128, "float32"): 0.3580,
    ("layer0.up/crop", 16, 128, "bfloat16"): 0.3554,
    ("layer0.up/crop", 128, 128, "float32"): 0.5920,
    ("layer0.up/crop", 128, 128, "bfloat16"): 0.5848,
    ("layer0.down/crop", 16, 128, "float32"): 0.6420,
    ("layer0.down/crop", 16, 128, "bfloat16"): 0.6189,
    ("layer0.down/crop", 128, 128, "float32"): 0.6196,
    ("layer0.down/crop", 128, 128, "bfloat16"): 0.6085,
}
FIRST_DESIGN_QUANT_MS = {
    ("layer0.gate", 16, 16, "float32"): 0.2026,
    ("layer0.gate", 16, 16, "bfloat16"): 0.2016,
}
# Kernels 6 and 8 of the first design (one 256-thread block per 16-row
# tile through a shared tile routine, scalar loads, FFMA in both types),
# ms at each grouped case of phase_moe_kernels: M 16 from this script's
# proof run at commit 67e32a9, M 240 from its _grouped_case driving
# commit 67e32a9's package; both on an NVIDIA H100 80GB HBM3 at 700.00 W.
# Keys (case, M, dtype).
FIRST_DESIGN_GROUPED_MS = {
    ("layer0.gate", 16, "float32"): 0.3144,
    ("layer0.gate", 16, "bfloat16"): 0.2884,
    ("layer0.down", 16, "float32"): 0.6493,
    ("layer0.down", 16, "bfloat16"): 0.5966,
    ("layer0.gate", 240, "float32"): 3.2615,
    ("layer0.gate", 240, "bfloat16"): 3.1644,
    ("layer0.down", 240, "float32"): 7.5186,
    ("layer0.down", 240, "bfloat16"): 7.4048,
}
FIRST_DESIGN_QUANT_GROUPED_MS = {
    ("layer0.gate", 16, "float32"): 0.3307,
    ("layer0.gate", 16, "bfloat16"): 0.3281,
    ("layer0.down", 16, "float32"): 0.6978,
    ("layer0.down", 16, "bfloat16"): 0.6964,
    ("layer0.gate", 240, "float32"): 3.6077,
    ("layer0.gate", 240, "bfloat16"): 3.5766,
    ("layer0.down", 240, "float32"): 8.2296,
    ("layer0.down", 240, "bfloat16"): 8.1873,
}
# Kernels 7 and 9 of the first design (one 256-thread block per 16-row
# tile through a shared tile routine, scalar loads, FFMA in both types),
# ms at each ragged case of phase_moe_kernels: this script's
# _ragged_case driving commit 409a6c3's package, the later of its two
# runs in one call (parent, change, change, parent; the earlier within
# 0.7% but for its first case, 0.1596), on an NVIDIA H100 80GB HBM3 at
# 700.00 W. Keys (case, tokens, dtype).
FIRST_DESIGN_RAGGED_MS = {
    ("layer0.gate", 4, "float32"): 0.1168,
    ("layer0.gate", 64, "float32"): 0.3107,
    ("layer0.gate", 4, "bfloat16"): 0.1048,
    ("layer0.gate", 64, "bfloat16"): 0.2879,
    ("layer0.down", 4, "float32"): 0.1646,
    ("layer0.down", 64, "float32"): 0.6478,
    ("layer0.down", 4, "bfloat16"): 0.1449,
    ("layer0.down", 64, "bfloat16"): 0.5881,
}
FIRST_DESIGN_QUANT_RAGGED_MS = {
    ("layer0.gate", 4, "float32"): 0.1020,
    ("layer0.gate", 64, "float32"): 0.2727,
    ("layer0.gate", 4, "bfloat16"): 0.1014,
    ("layer0.gate", 64, "bfloat16"): 0.2743,
    ("layer0.down", 4, "float32"): 0.1426,
    ("layer0.down", 64, "float32"): 0.5693,
    ("layer0.down", 4, "bfloat16"): 0.1372,
    ("layer0.down", 64, "bfloat16"): 0.5620,
}
# Kernel 3 of the first design (one thread block per (row, kv head)
# walking the whole row, scalar loads, one thread a head's softmax), ms at
# each case of phase_attention_kernels: this script's
# _paged_attention_case driving commit 3eda3e2's package, the first of
# its two runs in one call (parent, change, change, parent; the other
# within 0.7%), on an NVIDIA H100 80GB HBM3 at 700.00 W. Keys (case,
# dtype).
FIRST_DESIGN_PAGED_MS = {
    ("continuous", "float32"): 1.5531,
    ("continuous", "bfloat16"): 1.5576,
    ("paged-trace", "float32"): 0.1377,
    ("paged-trace", "bfloat16"): 0.1360,
    ("long-alone", "float32"): 1.5467,
    ("long-alone", "bfloat16"): 1.5502,
    ("gemma-2b", "float32"): 4.0096,
    ("gemma-2b", "bfloat16"): 3.9988,
    ("nemotron-4-340b", "float32"): 5.1753,
    ("nemotron-4-340b", "bfloat16"): 5.1702,
}
# Kernel 4 of the first design (one 64-row tile a block, FFMA in both
# types, bf16 widened to f32 in shared memory), ms at S 3072 after the
# 256 MB flush: this script's proof run at commit 9dc64f3 on an NVIDIA
# H100 80GB HBM3 at 700.00 W. Keys (heads, dtype).
FIRST_DESIGN_FLASH_MS = {
    ("llama3-8b", "float32"): 2.4228,
    ("llama3-8b", "bfloat16"): 2.4414,
    ("gemma-2b", "float32"): 2.4211,
    ("gemma-2b", "bfloat16"): 2.4102,
    ("nemotron-4-340b", "float32"): 15.2057,
    ("nemotron-4-340b", "bfloat16"): 15.3069,
}
PREFILL_ROWS = 512                 # 4 x 128 tokens, the continuous chunk
# kernel 4 at head dims 192 and 256: (model, n_q, n_kv, head_dim) of the
# JAX package's gemma-2b and nemotron-4-340b configurations
WIDE_HEADS = (("gemma-2b", 8, 1, 256), ("nemotron-4-340b", 96, 8, 192),
              ("musicgen-large", 32, 32, 64),
              ("llama4-scout-17b-16e", 40, 8, 128))
WANDA_TPU = "src/repro/kernels/wanda_metric/kernel.py:29"
# Kernel 2 of the first design (a Triton reduction, one program a 64 x
# 256 tile), ms at each case of phase_kernels: this script's wanda_case
# driving commit 7ae19a9's package, the later of its two runs in one call
# (parent, change, change, parent; the earlier within 4%, 8% at (4096,
# 1024), where Triton's launch host time outlasts the L2 flush: 0.0140
# in an earlier call), on an NVIDIA H100 80GB HBM3 at 700.00 W. Keys
# (K, N).
FIRST_DESIGN_WANDA_MS = {
    (4096, 14336): 0.0927,
    (14336, 4096): 0.0902,
    (4096, 1024): 0.0454,
}
PAGED_TPU = "src/repro/kernels/paged_attention/kernel.py:73"
FLASH_TPU = "src/repro/kernels/flash_attention/kernel.py:61"
# the continuous phase: one fixed set of requests from seed 0
N_REQUESTS = 12
LONG_PROMPT = 3072                 # > DENSE_ATTN_MAX, a multiple of 1024
PREFIX_LEN = 64                    # shared by the PREFIX_UIDS requests
PREFIX_UIDS = (1, 9, 10, 11)       # the later three admit after the first
#                                    has registered its blocks
PROMPT_RANGE = (17, 300)
NEW_RANGE = (16, 48)
MAX_SLOTS, MAX_SEQ, BLOCK_SIZE, PREFILL_CHUNK = 8, 3584, 16, 128
# the paged step's prologue at the phi3 cells' pruned heads (n_q, n_kv,
# D) and table entries a row (2048 positions of 16-token blocks): a
# decode tick's 64 rows, and one 512-token chunk from position 700 with
# 300 valid
ROPE_KV_HEADS, ROPE_KV_TABLE = (30, 10, 128), 128
ROPE_KV_SHAPES = (("decode", 64, 1), ("chunk", 1, 512))
PAGED_TRACE_PROMPT = 256           # the paged trace's 8 prompts
# the MoE phase: qwen3-moe-30b-a3b's 48 layers cut to 4, its own recipe
MOE_ARCH, MOE_N_PERIODS, MOE_RECIPE = "qwen3-moe-30b-a3b", 4, "moe-smoke.json"
EXPERT_FRAC = 0.25                 # qwen3-moe's 128 experts -> 96
SWEEP_GRID = "sweep-grid.json"     # p 0.3/0.5/0.7 x composite/unstructured
SERVED_POINT = "p0.5-composite-wanda_block"
SPARSEGPT_GRID = {"p": [0.5], "category": ["composite"],
                  "selector": ["sparsegpt"]}
MOE_REQUESTS = 8
MOE_PROMPT_RANGE = (65, 200)       # every prefill pads past 64 tokens
MOE_NEW_RANGE = (16, 32)
# static-engine ways: (name, sparse, ServeConfig fields)
MOE_WAYS = (("default", True, {}),                 # grouped + ragged
            ("grouped", True, {"ragged_moe": False}),
            ("loop", True, {"group_experts": False, "ragged_moe": False}),
            ("dense", False, {}))
GROUPED_TPU = "src/repro/kernels/grouped_block_sparse/kernel.py:75"
RAGGED_TPU = "src/repro/kernels/grouped_block_sparse/kernel.py:304"
# the int8 phases: the recipes' kept tiles as int8 (kernels 5, 8 and 9)
QUANT_RECIPE = "quant-smoke.json"
QUANT_BS_TPU = "src/repro/kernels/block_sparse/kernel.py:63"
QUANT_GROUPED_TPU = "src/repro/kernels/grouped_block_sparse/kernel.py:156"
QUANT_RAGGED_TPU = "src/repro/kernels/grouped_block_sparse/kernel.py:235"
# static-engine ways of the int8 MoE run: (name, sparse, ServeConfig fields)
MOE_QUANT_WAYS = (("int8", True, {}),             # grouped + ragged, int8
                  ("int8-grouped", True, {"ragged_moe": False}),
                  ("none", True, {"quant": "none"}),
                  ("dense", False, {}))
# the ssm phase: mamba2-1.3b at full width and depth, golden-smoke's recipe
SSM_ARCH, SSM_RECIPE = "mamba2-1.3b", "golden-smoke.json"
SSD_TPU = "src/repro/kernels/ssd_scan/kernel.py:52"
# Kernel 10 of the first design (FFMA in both types, no register tiles,
# loads not overlapped with math, one output block a (chunk, head)), ms
# at each case of phase_ssm: this script's _ssd_case driving commit
# 7ae19a9's package on random inputs of layer 0's shapes, the later of
# its two runs in one call (parent, change, change, parent; the earlier
# within 2.5%), on an NVIDIA H100 80GB HBM3 at 700.00 W. Keys (case,
# dtype).
FIRST_DESIGN_SSD_MS = {
    ("layer0 prefill 4096", "float32"): 0.8990,
    ("layer0 prefill 4096", "bfloat16"): 0.9492,
    ("layer0 static prefill 4x32", "float32"): 0.1137,
    ("layer0 static prefill 4x32", "bfloat16"): 0.1163,
    ("layer0 prefill 3000 from a carried state", "float32"): 0.7480,
    ("layer0 prefill 3000 from a carried state", "bfloat16"): 0.7895,
}
SSM_PREFILL_REPEATS = 3            # warm 4096-token prefills timed
SSM_CHECK_PROMPT = 600             # two full 256-row chunks, a padded third
SSM_LONG_PROMPTS = (4096, 3000)    # 16 full chunks; a padded last chunk
SSM_REQUESTS = 8                   # the long two, then PROMPT_RANGE prompts
SSM_MAX_SEQ = SSM_LONG_PROMPTS[0] + NEW_RANGE[1]
STATE_RTOL = 1e-4                  # x max|state|: f32 sum-order noise
# static-engine ways: the plans exist, but Mamba projections serve dense
SSM_WAYS = (("sparse", True, {}), ("dense", False, {}))

# the train phase: full width at a cut depth, bf16 over f32 masters
TRAIN_FULL = (("llama3-8b", 2, 12), ("qwen3-moe-30b-a3b", 2, 2),
              ("mamba2-1.3b", 4, 2))    # (arch, layers, steps)
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
# the first trained model: tests/test_system.py's recipe through
# launch/train.py, preempted at TRAIN_STOP and resumed
SMALL_TRAIN_ARGV = ["--smoke", "--steps", "120", "--batch", "16", "--seq",
                    "64", "--lr", "2e-3", "--ckpt-every", "50"]
TRAIN_STOP = 60
RESUME_RTOL = 1e-3                 # embedding backward: atomics, not bitwise
TRAINED_PPL_MAX = 150              # well below the vocabulary of 256
ORDER_SLACK = 1.5                  # tests/test_system.py's slack
HYBRID_ARCH, HYBRID_REQUESTS = "jamba-v0.1-52b", 6
# the distributed phase: NCCL at world size 1 on a (1, 1) host mesh
DIST_LLAMA_LAYERS, DIST_SSM_LAYERS = 2, 4
DIST_TRAIN_STEPS, DIST_TRAIN_BATCH, DIST_TRAIN_SEQ = 3, 2, 512
DIST_LOSS_RTOL = 1e-3             # bf16 compute: reduction order only


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=str), flush=True)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_FLUSH = []


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed with
    its own CUDA events after a write of 256 MB has flushed the L2: the
    main path finds its weights cold, since a decode step reads more
    than the L2 holds."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def stage_ms(fn, pattern: str, expect: int, iters: int = 10,
             attempts: int = 4) -> dict:
    """Mean device ms of each kernel whose name matches ``pattern``, over
    its launches in ``iters`` calls of ``fn`` (``torch.profiler``; each
    call after the L2 flush, as in ``time_ms``), keyed by the matched
    name: the sub-kernels of one launch of a kernel that runs several.
    The profiler can drop a short window's device records, so the mean
    is over the launches it recorded, and the window is profiled again,
    up to ``attempts`` times, until all ``expect`` names are seen; a name
    still unseen is not in the result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not _FLUSH:
        _FLUSH.append(torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    fn()
    torch.cuda.synchronize()
    spans: dict = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                _FLUSH[0].zero_()
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            m = re.search(pattern, e.name)
            if e.device_type == DeviceType.CUDA and m:
                spans.setdefault(m.group(0), []).append(
                    (e.time_range.end - e.time_range.start) / 1e3)
        if len(spans) >= expect:
            break
    return {name: sum(t) / len(t) for name, t in spans.items()}


def host_us(fn, iters: int = 50) -> float:
    """Median host time of one call of ``fn`` (its checks, allocations
    and launches), each call made on an idle card so no launch waits for
    a full queue. ``time_ms`` times the card; when a call's host time
    outlasts the L2 flush before it, part of it shows there too."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2]


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ------------------------------------------------------------ phases

def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 references stay
    torch.backends.cudnn.allow_tf32 = False         # full f32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "allow_tf32": False}
    log("device", **info)
    return info


def phase_build() -> dict:
    """Build every kernel: one nvcc per CUDA source, all started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.block_sparse import kernel as bs_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.grouped_block_sparse import kernel as g_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.wanda_metric import kernel as wm_kernel
    sources = build.SOURCES

    def one(source):
        t = time.perf_counter()
        path, report = build.build(source)
        return source, path, report, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(one, sources))
    for source in sources:
        build.load(source)
    t1 = time.perf_counter()
    out = {"nvcc_s": t1 - t0,
           "per_source": {src: {"s": dt, "lib": str(path),
                                "registers": ptxas_registers(report),
                                "spill_bytes": ptxas_spills(report)}
                          for src, path, report, dt in built},
           "build_s": t1 - t0}
    regs = out["per_source"][bs_kernel.SOURCE]["registers"]
    out["kernel1_f32_b16_registers"] = next(
        (n for name, n in regs.items()
         if "19block_sparse_kernelIfLi16ELi16E" in name), None)
    # kernels 1 and 5: registers and spills a (dtype, block, M-tile), and
    # the dynamic shared memory a block takes at decode and prefill rows
    report = built[sources.index(bs_kernel.SOURCE)][2]
    spills = ptxas_spills(report)
    out["block_sparse_kernels"] = {}
    for name, n in regs.items():
        m = re.search(r"\d((?:quant_)?block_sparse_kernel)I(f|13__nv_bfloat16)"
                      r"Li(\d+)ELi(\d+)E", name)
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            out["block_sparse_kernels"][
                f"{m.group(1)}<{dt},{m.group(3)},{m.group(4)}>"] = {
                "registers": n, "spill_bytes": spills.get(name, 0)}
    out["block_sparse_smem_bytes"] = {
        f"{w}/{str(dt)[6:]}/M{M}": bs_kernel.tile_config(
            M, 16, dt, w)["smem_bytes"]
        for w in ("dense", "int8") for dt in bs_kernel.DTYPES
        for M in (16, 128)}
    if report and (out["kernel1_f32_b16_registers"] is None
                   or len(out["block_sparse_kernels"]) != 32):
        raise AssertionError("the ptxas report names no kernel-1/5 "
                             "instantiations as expected")
    # kernels 6 and 8: one warp a slice (f32; bf16 at 16-row tiles) or a
    # block of four slices sharing its x stage (bf16 at 64-row tiles)
    report = built[sources.index(g_kernel.SOURCE)][2]
    spills = ptxas_spills(report)
    out["grouped_kernels"] = {}
    for name, n in out["per_source"][g_kernel.SOURCE]["registers"].items():
        m = re.search(r"\d((?:quant_)?grouped_kernel)I(f|13__nv_bfloat16)"
                      r"Li(\d+)ELi(\d+)E", name)
        key = None
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            key = f"{m.group(1)}<{dt},{m.group(3)},{m.group(4)}>"
        m = re.search(r"grouped_shared_x_kernelILi(\d+)ELb([01])E", name)
        if m:
            key = (f"{'quant_' if m.group(2) == '1' else ''}"
                   f"grouped_shared_x_kernel<bf16,{m.group(1)},64>")
        if key:
            out["grouped_kernels"][key] = {
                "registers": n, "spill_bytes": spills.get(name, 0)}
    if report and len(out["grouped_kernels"]) != 32:
        raise AssertionError(f"kernel 6/8 instantiations: "
                             f"{sorted(out['grouped_kernels'])}")
    # kernels 7 and 9: one warp a (tile, slice) at 16-row tiles
    out["ragged_kernels"] = {}
    for name, n in out["per_source"][g_kernel.SOURCE]["registers"].items():
        m = re.search(r"\d((?:quant_)?ragged_kernel)I(f|13__nv_bfloat16)"
                      r"Li(\d+)EE", name)
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            out["ragged_kernels"][f"{m.group(1)}<{dt},{m.group(3)}>"] = {
                "registers": n, "spill_bytes": spills.get(name, 0)}
    if report and len(out["ragged_kernels"]) != 16:
        raise AssertionError(f"kernel 7/9 instantiations: "
                             f"{sorted(out['ragged_kernels'])}")
    # mangled names: ...<len>ssd_<stage>_kernelI<dtype>[Li<PS>E]E...
    out["kernel10_registers"] = {}
    for name, n in out["per_source"][ssd_kernel.SOURCE]["registers"].items():
        m = re.search(r"\d(ssd_[a-z]+_kernel)(?:I(f|13__nv_bfloat16))?"
                      r"(?:Li(\d+))?", name)
        if m:
            key = f"{m.group(1)}<{m.group(2) or ''},{m.group(3) or ''}>"
            out["kernel10_registers"][key] = n
    # kernel 2: one block a (64 x 256) tile, sums and counts
    out["kernel2_registers"] = {}
    for name, n in out["per_source"][wm_kernel.SOURCE]["registers"].items():
        m = re.search(r"wanda_partials_kernelI(f|13__nv_bfloat16)Lb([01])E",
                      name)
        if m:
            out["kernel2_registers"][
                f"{'f32' if m.group(1) == 'f' else 'bf16'}/"
                f"{'count' if m.group(2) == '1' else 'sum'}"] = n
    if built[sources.index(wm_kernel.SOURCE)][2] and len(
            out["kernel2_registers"]) != 4:
        raise AssertionError(f"kernel 2 instantiations: "
                             f"{sorted(out['kernel2_registers'])}")
    out.update(flash_build_record(
        built[sources.index(fa_kernel.SOURCE)][1:3]))
    log("build", **out)
    return out


def flash_build_record(built: tuple) -> dict:
    """Kernel 4's instantiations: registers and spill bytes (``ptxas
    -v``), the wgmma serialisations ptxas reports, and the tensor-core
    instructions of each bf16 instantiation (``cuobjdump -sass``). Raises
    if a bf16 instantiation spills or issues no HGMMA."""
    path, report = built
    regs, spills = ptxas_registers(report), ptxas_spills(report)

    def key(name: str):
        m = re.search(r"\d(flash_attention_kernel)If(Li(\d+))", name)
        if m:
            return f"f32<D {m.group(3)}>"
        m = re.search(r"flash_bf16_kernelILi(\d+)E", name)
        if m:
            return f"bf16<D {m.group(1)}>"
        return None

    # registers and spills only when this run compiled the library
    kernels = {key(n): {"registers": r, "spill_bytes": spills.get(n, 0)}
               for n, r in regs.items() if key(n)}
    serialized = sorted({key(ln.split("'")[1]) for ln in report.splitlines()
                         if "wgmma.mma_async instructions are serialized"
                         in ln and "'" in ln} - {None})
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True,
                          check=True).stdout
    fn = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = key(ln.split("Function :")[1].strip())
            if fn is not None:
                kernels.setdefault(fn, {}).update(hgmma=0)
        elif fn in kernels:
            kernels[fn]["hgmma"] += "HGMMA" in ln
    for name, k in kernels.items():
        if not name.startswith("bf16"):
            continue
        if k.get("spill_bytes") or not k.get("hgmma"):
            raise AssertionError(f"kernel 4 {name}: {k} (spills, or no "
                                 f"HGMMA in its SASS)")
    if len(kernels) != 12:
        raise AssertionError(f"kernel 4 instantiations: {sorted(kernels)}")
    return {"flash_attention_kernels": kernels,
            "flash_wgmma_serialized": serialized}


def ptxas_registers(report: str) -> dict:
    """{mangled kernel name: registers} from ``nvcc -Xptxas -v``."""
    out, entry = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "registers" in ln and entry is not None:
            out[entry] = int(ln.split("Used")[1].split()[0])
            entry = None
    return out


def ptxas_spills(report: str) -> dict:
    """{mangled kernel name: spill store bytes} from ``nvcc -Xptxas -v``."""
    out, entry = {}, None
    for ln in report.splitlines():
        if "Function properties for" in ln:
            entry = ln.split("for", 1)[1].strip()
        elif "spill stores" in ln and entry is not None:
            out[entry] = int(ln.split("bytes spill stores")[0].split(",")[-1])
            entry = None
    return out


def compare_generation(tok_s, logits_s, tok_d, logits_d, s0: int,
                       atol: float) -> dict:
    """Hold the sparse run to the dense one. Per sequence, step by step
    while both have emitted the same tokens: logits within ``atol``, and
    equal tokens wherever the dense top-2 margin exceeds ``atol``. A
    sequence whose tokens part at a step whose margin is within ``atol``
    (a near-tie) is compared up to that step only."""
    import torch
    n_steps, B, _ = logits_s.shape
    max_err = 0.0
    compared = 0
    parted = []
    for b in range(B):
        for t in range(n_steps):
            err = float((logits_s[t, b] - logits_d[t, b]).abs().max())
            if err > atol:
                raise AssertionError(f"seq {b} step {t}: logits differ by "
                                     f"{err} > {atol}")
            max_err = max(max_err, err)
            compared += 1
            if int(tok_s[b, s0 + t]) != int(tok_d[b, s0 + t]):
                top2 = torch.topk(logits_d[t, b], 2).values
                margin = float(top2[0] - top2[1])
                if margin > atol:
                    raise AssertionError(
                        f"seq {b} step {t}: tokens differ with dense top-2 "
                        f"margin {margin} > {atol}")
                parted.append({"seq": b, "step": t, "margin": margin})
                break
    return {"logits_max_abs_err": max_err, "steps_compared": compared,
            "parted_at_near_ties": parted}


def serve_config():
    import torch
    from repro_torch.serve.config import ServeConfig
    return ServeConfig(max_seq=PROMPT_LEN + NEW_TOKENS,
                       compute_dtype=torch.float32,
                       cache_dtype=torch.float32)


def prompts(vocab: int, batch_index: int):
    """(BATCH, PROMPT_LEN) numpy tokens of the synthetic corpus."""
    from repro_torch.data.pipeline import SyntheticCorpus
    return SyntheticCorpus(vocab, seed=0).batch(
        batch_index, BATCH, PROMPT_LEN)[:, :PROMPT_LEN]


def run_main_path(cfg, recipe, device) -> dict:
    """The port's main path: prune with ``recipe``, then serve sparse and
    dense. Returns timings, the artifact and both generations."""
    import torch
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.sparse import flop_savings

    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    sync(device)
    init_s = time.perf_counter() - t0
    art = MosaicPipeline(recipe).run(params, cfg)
    prompt = prompts(cfg.vocab, 0)
    runs = {}
    for name, sparse in (("sparse", True), ("dense", False)):
        eng = Engine.from_artifact(art, serve_config(), sparse=sparse)
        sync(device)
        t0 = time.perf_counter()
        toks, logits = eng.generate(prompt, NEW_TOKENS, return_logits=True)
        sync(device)
        runs[name] = {"tokens": toks, "logits": logits,
                      "generate_s": time.perf_counter() - t0}
    st = art.report["stage_seconds"]
    return {
        "art": art, "params": params, "runs": runs, "init_s": init_s,
        "profile_s": st.get("rank"), "plan_s": st.get("plan"),
        "prune_s": st.get("prune"), "pack_s": st.get("pack"),
        "flop_savings": flop_savings(art.packed),
        "pack": {k: v for k, v in art.report["pack"].items()
                 if k != "skipped"},
        "category": art.report["category"],
        "params_before": art.report["params_before"],
        "params_after": art.report["params_after"],
    }


def steady_tokens_per_s(art, device, sparse: bool, **serve_kw) -> float:
    """A second, warm generation (launches here are not counted: the
    counters are read before it)."""
    import dataclasses
    from repro_torch.serve.engine import Engine
    eng = Engine.from_artifact(art, dataclasses.replace(serve_config(),
                                                        **serve_kw),
                               sparse=sparse)
    prompt = prompts(art.cfg.vocab, 1)
    sync(device)
    t0 = time.perf_counter()
    eng.generate(prompt, NEW_TOKENS)
    sync(device)
    return BATCH * NEW_TOKENS / (time.perf_counter() - t0)


def paired_tokens_per_s(art, device, ways) -> dict:
    """Warm static tok/s of each way, measured twice in mirrored order
    (ways, then the ways reversed), so a drift of the host's speed over
    the window weighs on every way alike: {name: [first, second]}."""
    out: dict = {}
    for name, sparse, kw in (*ways, *reversed(ways)):
        out.setdefault(name, []).append(
            steady_tokens_per_s(art, device, sparse, **kw))
    return out


def phase_main(device, gpu: str) -> dict:
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.kernels import counters

    full = get_config("llama3-8b")
    cfg = full.replace(n_periods=N_PERIODS, scan_layers=False)
    log("main", arch=cfg.name, d_model=cfg.d_model, vocab=cfg.vocab,
        layer=str(cfg.layer(0)),
        depth_cut=f"n_periods {full.n_periods} -> {cfg.n_periods}",
        recipe="recipes/golden-smoke.json")
    recipe = PruneRecipe.load(os.path.join(HERE, "recipes",
                                           "golden-smoke.json"))
    n_projs = len(projections(cfg))

    counters.reset()
    res = run_main_path(cfg, recipe, device)
    launches = counters.snapshot()

    art = res["art"]
    ffn_packed = sum(1 for (_, name) in art.packed
                     if name in ("gate", "up", "down"))
    forwards = NEW_TOKENS                # one prefill + NEW_TOKENS - 1 steps
    want = {"block_sparse": ffn_packed * forwards,
            "wanda_partials": 2 * n_projs}
    for k, v in want.items():
        if launches.get(k, 0) != v or v == 0:
            raise AssertionError(f"{k}: {launches.get(k, 0)} launches on "
                                 f"the main path, expected {v}")

    sp, dn = res["runs"]["sparse"], res["runs"]["dense"]
    V = art.cfg.vocab
    for r in (sp, dn):
        toks, logits = r["tokens"], r["logits"]
        if tuple(toks.shape) != (BATCH, PROMPT_LEN + NEW_TOKENS):
            raise AssertionError(f"tokens shape {tuple(toks.shape)}")
        if int(toks.min()) < 0 or int(toks.max()) >= V:
            raise AssertionError("token outside the vocabulary")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits")
    cmp = compare_generation(sp["tokens"], sp["logits"], dn["tokens"],
                             dn["logits"], PROMPT_LEN, LOGIT_ATOL)
    gen_tokens = BATCH * NEW_TOKENS
    out = {
        "gpu": gpu, "launches": launches, "expected_launches": want,
        "ffn_packed": ffn_packed, "forwards": forwards,
        "n_packed": len(art.packed),
        "init_s": res["init_s"], "profile_s": res["profile_s"],
        "plan_s": res["plan_s"], "prune_s": res["prune_s"],
        "pack_s": res["pack_s"], "flop_savings": res["flop_savings"],
        "category": res["category"], "pack": res["pack"],
        "params_before": res["params_before"],
        "params_after": res["params_after"],
        "pruned_layer0": str(art.cfg.layer(0)),
        "generate_sparse_s": sp["generate_s"],
        "generate_dense_s": dn["generate_s"],
        "tokens_per_s_sparse_first": gen_tokens / sp["generate_s"],
        "tokens_per_s_dense_first": gen_tokens / dn["generate_s"],
        "logit_atol": LOGIT_ATOL, **cmp,
    }
    out["tokens_per_s_sparse"] = steady_tokens_per_s(art, device, True)
    out["tokens_per_s_dense"] = steady_tokens_per_s(art, device, False)
    log("main", **out)
    out["art"] = art
    out["params"], out["cfg"] = res["params"], cfg   # the prune side's
    return out


def _recon_error(w, new_w, gram) -> float:
    """||X W' - X W||_F from the Gram matrix ``gram`` = X^T X of the
    projection's inputs: sqrt(tr(dW^T gram dW)), dW over the input rows."""
    import torch
    dw = (new_w.float() - w.float()).reshape(gram.shape[-1], -1)
    return float(torch.sqrt((dw * (gram @ dw)).sum().clamp(min=0.0)))


def sparsegpt_vs_wanda_block(params, cfg, profile, hessians, point, calib,
                             device) -> dict:
    """Layer 0's seven projections pruned at ``point``'s targets by the
    composite's mask stage with each selector — sparsegpt over the
    calibration Hessians, wanda_block over the profile's norms — and
    each pruned weight's reconstruction error on the first calibration
    batch (its Gram from the ``hessian`` taps). SparseGPT must be below
    wanda_block on every projection."""
    from repro_torch.common.tree import tree_get
    from repro_torch.core import calibrate as C
    from repro_torch.core import planner as PL
    from repro_torch.core.registry import SELECTORS, projections
    from repro_torch.core.unstructured import SelectorContext
    targets = PL.plan_from_recipe(profile.rank, point,
                                  weights=profile.weights)
    grams, _ = C.calibrate(params, cfg, calib[:1], device, mode="hessian")
    ctxs = {"sparsegpt": SelectorContext(hessians=hessians,
                                         block=point.block),
            "wanda_block": SelectorContext(anorms=profile.anorms,
                                           block=point.block)}
    out = {}
    for proj in projections(cfg):
        if proj.layer != 0:
            continue
        w = tree_get(params, proj.path)
        err = {name: _recon_error(w, SELECTORS.get(name)(
                   w, proj, targets[proj.key], ctx)[0],
                   grams[(0, proj.tap)])
               for name, ctx in ctxs.items()}
        if not err["sparsegpt"] < err["wanda_block"]:
            raise AssertionError(f"sparsegpt {proj.name}: reconstruction "
                                 f"error {err['sparsegpt']} is not below "
                                 f"wanda_block's {err['wanda_block']}")
        out[proj.name] = {"target": targets[proj.key], **err,
                          "ratio": err["sparsegpt"] / err["wanda_block"]}
    if len(out) != 7:
        raise AssertionError(f"layer 0 has {sorted(out)}, expected seven "
                             f"projections")
    return out


def phase_prune_side(main: dict, device, gpu: str) -> dict:
    """The rest of the prune side on the main phase's dense llama3-8b
    (4 layers, seed 0): a sweep of ``recipes/sweep-grid.json`` over
    golden-smoke that profiles once (exact kernel-2 count), saves its
    profile and six bundles and evaluates each point; the same points
    timed twice with a profile at every point and once more with one
    profile (no bundles); a sparsegpt point swept on the
    saved profile, which gains its Hessians lazily with no second rank,
    and beats wanda_block's reconstruction error on layer 0; the p 0.5
    composite point's bundle served sparse (kernel 1) and dense."""
    import shutil
    import tempfile

    import torch
    from repro_torch.common.tree import iter_paths
    from repro_torch.core.artifact import PrunedArtifact
    from repro_torch.core.evaluate import default_eval_batches
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.rank_controller import RankArtifact
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.core.sweep import (GridSpec, _point_stages,
                                        point_label, run_sweep)
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import counters

    t_phase = time.perf_counter()
    params, cfg = main.pop("params"), main["cfg"]
    base = PruneRecipe.load(os.path.join(HERE, "recipes",
                                         "golden-smoke.json"))
    grid = GridSpec.load(os.path.join(HERE, "recipes", SWEEP_GRID))
    c = base.calibration
    calib = SyntheticCorpus(cfg.vocab, seed=c.seed).calibration_batches(
        c.n_samples, c.batch_size, c.seq_len)
    eval_batches = default_eval_batches(cfg, base)
    n_projs = len(projections(cfg))
    n_points = grid.n_points()
    log("prune_side", gpu=gpu, arch=cfg.name, layers=cfg.n_layers,
        recipe="recipes/golden-smoke.json", grid=f"recipes/{SWEEP_GRID}",
        points=n_points, calibration_tokens=int(sum(b.size for b in calib)),
        eval_tokens={k: int(sum(t.size for t, _ in v))
                     for k, v in eval_batches.items()})
    out = {"gpu": gpu, "points": n_points}
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sweep-", dir=out_dir)
    try:
        # -- profile once, prune many (the bundles written to disk)
        counters.reset()
        sync(device)
        t0 = time.perf_counter()
        res = run_sweep(base, grid, params, cfg, out_dir=tmp,
                        calibration=calib, eval_batches=eval_batches)
        sync(device)
        sweep_wall = time.perf_counter() - t0
        launches = counters.snapshot()
        want = {"wanda_partials": 2 * n_projs}
        if launches != want or not res.profiled \
                or len(res.rows) != n_points:
            raise AssertionError(f"sweep: launches {launches} (expected "
                                 f"{want}), profiled {res.profiled}, "
                                 f"{len(res.rows)} rows")
        for r in res.rows:
            if not (r["ppl"] > 1.0 and 0.0 <= r["acc"] <= 100.0
                    and r["bytes_after"] > 0
                    and PrunedArtifact.is_artifact(r["artifact_dir"])):
                raise AssertionError(f"sweep point {r['label']}: {r}")
        profile_dir = os.path.join(tmp, "profile")
        if not RankArtifact.is_artifact(profile_dir) \
                or not os.path.exists(res.csv_path) \
                or not any(r["pareto"] for r in res.rows):
            raise AssertionError("sweep: no profile, pareto.csv or front")
        once_s = res.rank_artifact.profile_seconds + sum(
            r["point_seconds"] for r in res.rows)
        out["sweep"] = {
            "wall_s": sweep_wall, "compute_s": once_s,
            "save_s": sweep_wall - once_s,
            "profile_s": res.rank_artifact.profile_seconds,
            "launches": launches,
            "disk_bytes": sum(os.path.getsize(os.path.join(root, f))
                              for root, _, files in os.walk(tmp)
                              for f in files),
            "rows": [{k: r[k] for k in (
                "label", "ppl", "acc", "bytes_after", "params_after",
                "prune_seconds", "point_seconds", "flop_savings",
                "quality_per_byte", "pareto")} for r in res.rows]}
        log("prune_side", sweep={k: v for k, v in out["sweep"].items()
                                 if k != "rows"})
        for r in out["sweep"]["rows"]:
            log("prune_side", point=r)

        # -- the same points with a profile at every point, then with one
        # profile again, neither saving bundles: every, every, once, so
        # both sides run warm after the saving sweep above
        def profile_every_point() -> tuple:
            counters.reset()
            points = {}
            t0 = time.perf_counter()
            for point in grid.points(base):
                recipe = point.replace(
                    stages=("rank",) + _point_stages(point.stages))
                t1 = time.perf_counter()
                art = MosaicPipeline(recipe).run(
                    params, cfg, calibration=calib,
                    eval_batches=eval_batches)
                sync(device)
                points[point_label(point)] = {
                    "seconds": time.perf_counter() - t1,
                    "stage_seconds": art.report["stage_seconds"],
                    "ppl": art.report["ppl"], "acc": art.report["acc"]}
                del art
            return time.perf_counter() - t0, counters.snapshot(), points

        every = [profile_every_point() for _ in range(2)]
        want = {"wanda_partials": 2 * n_projs * n_points}
        if any(launches != want for _, launches, _ in every):
            raise AssertionError(f"profile at every point: launches "
                                 f"{[e[1] for e in every]}, expected "
                                 f"{want}")
        sync(device)
        t0 = time.perf_counter()
        again = run_sweep(base, grid, params, cfg, calibration=calib,
                          eval_batches=eval_batches)
        sync(device)
        once_again_s = time.perf_counter() - t0
        ppl = {r["label"]: r["ppl"] for r in res.rows}
        every_s = [e[0] for e in every]
        out["every_point"] = {
            "wall_s": every_s, "launches": every[0][1],
            "points": every[-1][2],
            "ppl_max_rel_diff_vs_sweep": max(
                abs(v["ppl"] - ppl[k]) / ppl[k]
                for e in every for k, v in e[2].items())}
        out["profile_once_again_s"] = once_again_s
        out["production_ratio"] = (sum(every_s) / len(every_s)
                                   / once_again_s)
        log("prune_side", every_point_wall_s=every_s,
            profile_once_s=[once_s, once_again_s],
            production_ratio=out["production_ratio"],
            ppl_max_rel_diff_vs_sweep=out["every_point"][
                "ppl_max_rel_diff_vs_sweep"],
            every_point_stage_s=every[-1][2])
        del again

        # -- sparsegpt on the saved profile: Hessians attached lazily
        loaded = RankArtifact.load(profile_dir, device)
        if loaded.hessians is not None:
            raise AssertionError("the sweep's profile has Hessians")
        sg_grid = GridSpec.from_dict(SPARSEGPT_GRID)
        counters.reset()
        sync(device)
        t0 = time.perf_counter()
        sg = run_sweep(base, sg_grid, params, cfg, rank_artifact=loaded,
                       calibration=calib, eval_batches=eval_batches)
        sync(device)
        sg_wall = time.perf_counter() - t0
        launches = counters.snapshot()
        hess = sg.rank_artifact.hessians
        if sg.profiled or launches or hess is None \
                or loaded.hessians is not None:
            raise AssertionError(f"sparsegpt sweep: profiled {sg.profiled}"
                                 f", launches {launches} (a rank runs "
                                 f"kernel 2), Hessians {hess is not None}")
        row = sg.rows[0]
        if not (row["ppl"] > 1.0 and 0.0 <= row["acc"] <= 100.0):
            raise AssertionError(f"sparsegpt point: {row}")
        t0 = time.perf_counter()
        recon = sparsegpt_vs_wanda_block(params, cfg, loaded, hess,
                                         sg_grid.points(base)[0], calib,
                                         device)
        out["sparsegpt"] = {
            "wall_s": sg_wall,
            "hessian_s": sg.rank_artifact.profile_seconds
            - loaded.profile_seconds,
            "hessian_bytes": sum(h.numel() * h.element_size()
                                 for h in hess.values()),
            "prune_s": row["prune_seconds"], "point_s": row["point_seconds"],
            "ppl": row["ppl"], "acc": row["acc"],
            "bytes_after": row["bytes_after"], "launches": launches,
            "reconstruction_layer0": recon,
            "reconstruction_s": time.perf_counter() - t0}
        del sg, hess, loaded
        torch.cuda.empty_cache()
        log("prune_side", sparsegpt=out["sparsegpt"])

        # -- serve the p 0.5 composite point's bundle
        t0 = time.perf_counter()
        pt = PrunedArtifact.load(os.path.join(tmp, "points", SERVED_POINT),
                                 device)
        sync(device)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    torch.cuda.empty_cache()
    ffn_packed = sum(1 for (_, name) in pt.packed
                     if name in ("gate", "up", "down"))
    runs = moe_static_runs(pt, device, ways=(("sparse", True, {}),
                                             ("dense", False, {})))
    check_static_runs(runs, {"sparse": {"block_sparse":
                                        ffn_packed * NEW_TOKENS},
                             "dense": {}})
    sp, dn = runs["sparse"], runs["dense"]
    out["serve"] = {
        "point": SERVED_POINT, "load_s": load_s,
        "launches": sp["launches"], "ffn_packed": ffn_packed,
        "generate_s": {k: r["generate_s"] for k, r in runs.items()},
        **compare_generation(sp["tokens"], sp["logits"], dn["tokens"],
                             dn["logits"], PROMPT_LEN, LOGIT_ATOL),
        "params_equal_main_bundle": all(
            pa == pb and torch.equal(a, b) for (pa, a), (pb, b) in zip(
                iter_paths(pt.params), iter_paths(main["art"].params)))}
    del pt
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("prune_side", serve=out["serve"], phase_s=out["phase_s"])
    return out


def continuous_requests(vocab: int) -> list:
    """The continuous phase's traffic, one fixed set from seed 0: uid 0
    has the long prompt, the PREFIX_UIDS share a 64-token prefix under
    one ``prefix_id``, every other prompt is 17-300 tokens."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, vocab, PREFIX_LEN).tolist()
    lo, hi = PROMPT_RANGE
    reqs = []
    for uid in range(N_REQUESTS):
        if uid == 0:
            prompt = rng.integers(1, vocab, LONG_PROMPT).tolist()
        elif uid in PREFIX_UIDS:
            tail = int(rng.integers(lo, hi - PREFIX_LEN + 1))
            prompt = prefix + rng.integers(1, vocab, tail).tolist()
        else:
            prompt = rng.integers(1, vocab, int(rng.integers(lo, hi + 1))
                                  ).tolist()
        reqs.append(Request(
            uid=uid, prompt=prompt,
            max_new_tokens=int(rng.integers(NEW_RANGE[0], NEW_RANGE[1] + 1)),
            prefix_id="system" if uid in PREFIX_UIDS else None))
    return reqs


def continuous_config(**kw):
    import torch
    from repro_torch.serve.config import ServeConfig
    return ServeConfig(max_slots=MAX_SLOTS, max_seq=MAX_SEQ,
                       compute_dtype=torch.float32,
                       cache_dtype=torch.float32, **kw)


def bundle_round_trip(art, device, directory: str) -> tuple:
    """Save ``art`` into ``directory``, load it back onto the card and
    hold the loaded params, config, targets and plans (expert plan stacks
    with their densities and path flags, int8 tiles, slots and scales)
    equal to ``art``."""
    import torch
    from repro_torch.common.tree import iter_paths
    from repro_torch.core.artifact import PrunedArtifact
    t0 = time.perf_counter()
    art.save(directory)
    t1 = time.perf_counter()
    n_bytes = sum(os.path.getsize(os.path.join(root, f))
                  for root, _, files in os.walk(directory) for f in files)
    loaded = PrunedArtifact.load(directory, device)
    sync(device)
    t2 = time.perf_counter()
    pairs = list(zip(iter_paths(art.params), iter_paths(loaded.params)))
    if len(pairs) != len(list(iter_paths(art.params))) or any(
            pa != pb or a.device != b.device or not torch.equal(a, b)
            for (pa, a), (pb, b) in pairs):
        raise AssertionError("the loaded bundle's params differ")
    check_bundle_documents(art, loaded)
    return loaded, {"save_s": t1 - t0, "load_s": t2 - t1,
                    "bundle_bytes": n_bytes, "leaves": len(pairs),
                    "plans": len(art.packed)}


def check_bundle_documents(art, loaded) -> None:
    """The loaded bundle's config, targets and plans equal ``art``'s."""
    if loaded.cfg != art.cfg or loaded.targets != art.targets \
            or set(loaded.packed) != set(art.packed):
        raise AssertionError("the loaded bundle's config, targets or plan "
                             "keys differ")
    for key, p in art.packed.items():
        if not plans_equal(p, loaded.packed[key]):
            raise AssertionError(f"the loaded plan {key} differs")


def plans_equal(p, q) -> bool:
    """Two plans equal in class, block, densities, path flags and every
    array, the int8 storage included (tiles, slots, scales)."""
    import torch
    flags = ("densities", "group", "ragged", "quant")
    if type(p) is not type(q) or (p.block, p.density) != (q.block,
                                                          q.density) \
            or any(getattr(p, f, None) != getattr(q, f, None)
                   for f in flags):
        return False
    for name in ("counts", "indices", "tiles", "slots", "scales"):
        a, b = getattr(p, name), getattr(q, name)
        if (a is None) != (b is None) or (a is not None and (
                a.dtype != b.dtype or a.device != b.device
                or not torch.equal(a, b))):
            return False
    return True


def serve_continuous(art, device, label: str, reqs=None, serve=None,
                     sparse: bool = True, **serve_kw) -> dict:
    """One run of the continuous engine on ``reqs`` (default: the
    continuous phase's requests) under ``serve`` (default:
    ``continuous_config(**serve_kw)``), counters reset just before and
    read just after."""
    from repro_torch.kernels import counters
    from repro_torch.serve.batching import ContinuousEngine
    serve = serve if serve is not None else continuous_config(**serve_kw)
    eng = ContinuousEngine.from_artifact(art, serve, sparse=sparse)
    reqs = reqs if reqs is not None else continuous_requests(art.cfg.vocab)
    n_requests = len(reqs)
    sync(device)
    counters.reset()
    finished, stats = eng.run(reqs)
    sync(device)
    launches = counters.snapshot()
    V = art.cfg.vocab
    by_uid = {f.request.uid: f for f in finished}
    if sorted(by_uid) != list(range(n_requests)) or stats.rejected:
        raise AssertionError(f"{label}: finished {sorted(by_uid)}, "
                             f"rejected {stats.reject_reasons}")
    for r in reqs:
        toks = by_uid[r.uid].tokens
        if len(toks) != r.max_new_tokens or min(toks) < 0 \
                or max(toks) >= V:
            raise AssertionError(f"{label}: uid {r.uid} gave "
                                 f"{len(toks)} tokens, range "
                                 f"[{min(toks)}, {max(toks)}]")
    out = {"label": label, "launches": launches,
           "tokens": {uid: f.tokens for uid, f in by_uid.items()},
           "prompts": {r.uid: r.prompt for r in reqs},
           **stats.to_dict()}
    if serve.paged:
        alloc = eng.last_allocator
        out["free_blocks_after"] = alloc.n_free
        if alloc.n_free != alloc.n_blocks:
            raise AssertionError(f"{label}: {alloc.n_blocks - alloc.n_free}"
                                 f" blocks not returned")
        if any(r.prefix_id for r in reqs) \
                and stats.prompt_blocks_shared <= 0:
            raise AssertionError(f"{label}: no prefix-cache hit")
    return out


def reference_margin(art, device, prompt: list, tokens: list,
                     t: int) -> float:
    """Top-2 logit margin of the reference at generated step ``t``: the
    static engine, teacher-forced on the reference's own tokens."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    eng = Engine.from_artifact(art, continuous_config())
    cache = T.init_cache(eng.cfg, 1, MAX_SEQ, torch.float32, device)
    with torch.no_grad():
        logits, cache = eng._step(torch.tensor([prompt], device=device),
                                  cache, 0)
        for i in range(t):
            logits, cache = eng._step(
                torch.tensor([[tokens[i]]], device=device), cache,
                len(prompt) + i)
    top2 = torch.topk(logits[0, :art.cfg.vocab].float(), 2).values
    return float(top2[0] - top2[1])


def compare_runs(art, device, ref: dict, other: dict) -> dict:
    """Greedy tokens of ``other`` equal ``ref``'s, request by request, up
    to a step where the reference's top-2 margin is within LOGIT_ATOL."""
    parted = []
    for uid, want in sorted(ref["tokens"].items()):
        got = other["tokens"][uid]
        t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if t is None:
            continue
        margin = reference_margin(art, device, ref["prompts"][uid], want, t)
        if margin > LOGIT_ATOL:
            raise AssertionError(
                f"{other['label']} vs {ref['label']}: uid {uid} parts at "
                f"step {t} with reference top-2 margin {margin} > "
                f"{LOGIT_ATOL}")
        parted.append({"uid": uid, "step": t, "margin": margin})
    return {"compared": len(ref["tokens"]), "parted_at_near_ties": parted}


def phase_continuous(main: dict, device) -> dict:
    import shutil
    import tempfile
    art = main["art"]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="bundle-", dir=out_dir)
    try:
        loaded, bundle = bundle_round_trip(art, device, tmp)
        log("continuous", bundle=bundle)
        runs = [serve_continuous(loaded, device, "contiguous"),
                serve_continuous(loaded, device, "paged-gather",
                                 block_size=BLOCK_SIZE,
                                 prefill_chunk=PREFILL_CHUNK),
                serve_continuous(loaded, device, "paged-kernel",
                                 block_size=BLOCK_SIZE,
                                 prefill_chunk=PREFILL_CHUNK,
                                 paged_kernel=True)]
        n_layers = loaded.cfg.n_layers
        ffn_packed = sum(1 for (_, name) in loaded.packed
                         if name in ("gate", "up", "down"))
        for r in runs:
            forwards = r["prefill_chunks"] + r["ticks"]
            want = {"block_sparse": ffn_packed * forwards}
            if r["label"] == "contiguous":
                want["flash_attention"] = n_layers * 1   # one long prompt
            if r["label"] != "contiguous":     # RoPE + K/V write a layer
                want["rope_kv_write"] = n_layers * forwards
            if r["label"] == "paged-kernel":
                want["paged_attention"] = n_layers * r["ticks"]
            r["expected_launches"] = want
            if r["launches"] != want:
                raise AssertionError(f"{r['label']}: launches "
                                     f"{r['launches']}, expected {want}")
        cmp = {r["label"]: compare_runs(loaded, device, runs[0], r)
               for r in runs[1:]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = [{k: v for k, v in r.items() if k not in ("tokens", "prompts")}
               for r in runs]
    for r in summary:
        log("continuous", gpu=main["gpu"], **r)
    log("continuous", gpu=main["gpu"], agreement=cmp)
    first8 = sorted(runs[0]["tokens"])[:MAX_SLOTS]
    return {"bundle": bundle, "runs": summary, "agreement": cmp,
            "decode_lengths": [len(runs[0]["prompts"][u])
                               + len(runs[0]["tokens"][u]) - 1
                               for u in first8]}


GEMM_MARKS = ("gemm", "gemv", "cutlass", "xmma", "cublas", "splitk")


def kernel_class(name: str) -> str:
    n = name.lower()
    for k, c in (("grouped_kernel", "grouped_block_sparse"),
                 ("grouped_shared_x", "grouped_block_sparse"),
                 ("ragged_kernel", "ragged_block_sparse"),
                 ("ssd_", "ssd_scan")):
        if k in n:
            return c
    for k in ("block_sparse", "paged_attention", "flash_attention"):
        if k in n:
            return k
    if "flash_bf16" in n:
        return "flash_attention"
    if any(m in n for m in GEMM_MARKS):
        return "gemm"
    if "softmax" in n:
        return "softmax"
    if "reduce" in n:
        return "reduce"
    return "other"


def _busy_us(spans: list) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_window(prepare, step, device, label: str) -> dict:
    """``TRACE_STEPS`` warm decode steps after ``prepare()`` (a prefill),
    once under ``torch.profiler`` (CPU and CUDA) and once without it.
    Device time is summed by kernel class, by kernel name and by aten op
    with its input shapes; the idle share is 1 - device busy / the
    unprofiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(prof=None) -> float:
        with torch.no_grad():
            state = prepare()
            sync(device)
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            for _ in range(TRACE_STEPS):
                step(state)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3 / TRACE_STEPS
            if prof is not None:
                prof.stop()
        return ms

    window()
    step_ms = window()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)
    step_ms_profiled = window(prof)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"engine": label, "steps": TRACE_STEPS, "step_ms": step_ms,
           "step_ms_profiled": step_ms_profiled, "device_events": len(dev)}
    if not dev:
        out["note"] = "the profiler saw no device time: not measured"
        return out
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3 / TRACE_STEPS
    by_class: dict = {}
    by_name: dict = {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        c = kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + us
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    per_step = 1e3 * TRACE_STEPS
    ops = []
    for a in prof.key_averages(group_by_input_shape=True):
        self_us = getattr(a, "self_device_time_total",
                          getattr(a, "self_cuda_time_total", 0.0))
        if a.key.startswith("aten::") and self_us > 0:
            ops.append((self_us, a.key, str(a.input_shapes), a.count))
    ops.sort(reverse=True)
    out.update({
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
        "by_class_ms": {c: t / per_step for c, t in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels": [
            {"name": n[:120], "per_step": k / TRACE_STEPS,
             "ms": t / per_step}
            for n, (k, t) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:10]],
        "top_ops": [{"op": key, "shapes": shapes[:160],
                     "per_step": k / TRACE_STEPS, "ms": us / per_step}
                    for us, key, shapes, k in ops[:10]],
    })
    return out


def trace_decode(art, device, sparse: bool, label=None, **serve_kw) -> dict:
    """The static engine: BATCH sequences decoding after a prompt
    (``serve_kw``: ServeConfig fields, such as ``quant``)."""
    import dataclasses

    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, sample_token
    eng = Engine.from_artifact(
        art, dataclasses.replace(serve_config(), **serve_kw), sparse=sparse)
    prompt = torch.as_tensor(prompts(art.cfg.vocab, 2), device=device)

    def prepare() -> dict:
        cache = T.init_cache(eng.cfg, BATCH, eng.max_seq,
                             eng.serve.cache_dtype, device)
        logits, cache = eng._step(prompt, cache, 0)
        return {"cache": cache, "i": 0,
                "tok": sample_token(logits, 0.0, eng.cfg.vocab)}

    def step(st: dict) -> None:
        logits, st["cache"] = eng._step(st["tok"][:, None], st["cache"],
                                        PROMPT_LEN + st["i"])
        st["tok"] = sample_token(logits, 0.0, eng.cfg.vocab)
        st["i"] += 1

    return profile_window(prepare, step, device,
                          label or ("sparse" if sparse else "dense"))


def trace_paged(art, device, paged_kernel: bool) -> dict:
    """The paged pool of the continuous engine: MAX_SLOTS sequences of
    PAGED_TRACE_PROMPT tokens decoding together, each owning
    blocks_per_seq arena blocks, through the engine's own steps."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serve.batching import ContinuousEngine
    serve = continuous_config(block_size=BLOCK_SIZE,
                              paged_kernel=paged_kernel)
    eng = ContinuousEngine.from_artifact(art, serve)
    B, P = MAX_SLOTS, PAGED_TRACE_PROMPT
    tables = torch.arange(B * serve.blocks_per_seq, dtype=torch.int32,
                          device=device).reshape(B, serve.blocks_per_seq)
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(1, art.cfg.vocab, (B, P)),
                             device=device)

    def prepare() -> dict:
        pool = T.init_paged_pool(eng.cfg, serve.arena_blocks, BLOCK_SIZE,
                                 serve.cache_dtype, device)
        last = []
        for b in range(B):
            logits, pool = eng._prefill(
                eng.params, pool, tokens[b:b + 1], tables[b:b + 1],
                torch.tensor([0], device=device),
                torch.tensor([P], device=device))
            last.append(logits[0, -1])
        return {"pool": pool, "tok": torch.stack(last).argmax(-1)[:, None],
                "lens": torch.full((B,), P, device=device)}

    def step(st: dict) -> None:
        logits, st["pool"] = eng._decode(eng.params, st["pool"], st["tok"],
                                         st["lens"], tables)
        st["tok"] = logits.argmax(-1)[:, None]
        st["lens"] = st["lens"] + 1

    return profile_window(prepare, step, device,
                          "paged-kernel" if paged_kernel else "paged-gather")


def phase_trace(main: dict, device) -> list:
    art = main["art"]
    out = [trace_decode(art, device, sparse) for sparse in (True, False)]
    out += [trace_paged(art, device, k) for k in (True, False)]
    for t in out:
        log("trace", gpu=main["gpu"], **t)
    return out


def _check_close(name: str, got, plain, dtype: str) -> tuple:
    err = float((got.float() - plain.float()).abs().max())
    tol = KERNEL_RTOL[dtype] * max(float(plain.float().abs().max()), 1.0)
    if not err <= tol:
        raise AssertionError(f"{name} {dtype}: err {err} > {tol}")
    return err, tol


def _check_rel(name: str, got, plain, dtype: str) -> float:
    """||got - plain||_F / ||plain||_F within KERNEL_RTOL[dtype]. An
    attention output's largest values sit in its first rows, so the
    max-abs limit of ``_check_close`` can be as large as a typical value
    of the bulk; this limit holds the bulk to the rounding of its own
    scale."""
    diff = float((got.float() - plain.float()).norm())
    rel = diff / max(float(plain.float().norm()), 1e-30)
    if not rel <= KERNEL_RTOL[dtype]:
        raise AssertionError(f"{name} {dtype}: relative error {rel} > "
                             f"{KERNEL_RTOL[dtype]}")
    return rel


def _tile_record(M: int, block: int, dtype, weight: str) -> dict:
    """The tile the launch takes (the Python rule, held to the library's
    own choice)."""
    from repro_torch.kernels.block_sparse import kernel
    cfg = kernel.tile_config(M, block, dtype, weight)
    lib = kernel.library_tile_config(M, block, dtype, weight)
    if lib != {k: cfg[k] for k in lib}:
        raise AssertionError(f"tile rule {cfg} differs from the "
                             f"library's {lib}")
    return cfg


def _rates(rec: dict, n_bytes: float, n_ops: float) -> None:
    """Achieved TB/s and TFLOP/s of the work the function needs."""
    rec["tb_per_s"] = n_bytes / (rec["ms"] * 1e-3) / 1e12
    rec["tflop_per_s"] = n_ops / (rec["ms"] * 1e-3) / 1e12


def _block_sparse_case(w, plan_mask, M: int, block: int, dtype, gen,
                       label: str) -> dict:
    import torch
    from repro_torch.kernels.block_sparse import kernel, ref
    from repro_torch.kernels.block_sparse.ops import plan_blocks
    from repro_torch.kernels.grouped_block_sparse import kernel as g_kernel
    dev = w.device
    counts, indices = plan_blocks(plan_mask.cpu().numpy())
    counts = torch.as_tensor(counts, device=dev)
    indices = torch.as_tensor(indices, device=dev)
    full = plan_mask.repeat_interleave(block, 0).repeat_interleave(block, 1)
    w = torch.where(full, w, torch.zeros_like(w)).to(dtype).contiguous()
    K, N = w.shape
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    y = kernel.block_sparse_matmul(x, w, counts, indices, block)
    plain = ref.block_sparse_matmul_ref(x, w, plan_mask, block, block)
    dname = str(dtype).replace("torch.", "")
    order = None
    if dtype == torch.float32 and block == 16:
        # one warp routine, whose fmaf order kernels 7 and 9 keep too:
        # kernel 6 with one expert over the same plan gives the same bits
        y6 = g_kernel.grouped_block_sparse_matmul(
            x[None], w[None], counts[None], indices[None],
            torch.ones((1, M // 16), dtype=torch.int32, device=dev), block,
            16)
        order = bool(torch.equal(y, y6[0]))
        if not order:
            raise AssertionError(
                f"block_sparse {label} M={M}: f32 kernel 1 differs from "
                f"kernel 6 by {float((y - y6[0]).abs().max())}")
    torch.cuda.synchronize()
    err, tol = _check_close(f"block_sparse {label} M={M} b={block}", y,
                            plain, dname)
    rel = _check_rel(f"block_sparse {label} M={M} b={block}", y, plain,
                     dname)
    if int(counts[0]) != 0 or float(y[:, :block].abs().max()) != 0.0:
        raise AssertionError("the empty column did not come out zero")
    live = int(counts.sum())
    s = w.element_size()
    n_bytes = (M * K + live * block * block + M * N) * s \
        + 4 * (counts.numel() + indices.numel())
    n_ops = 2.0 * M * live * block * block
    b_ms, b_by = bound_ms(n_bytes, n_ops, dname)
    rec = {
        "case": label, "M": M, "K": K, "N": N, "block": block,
        "dtype": dname, "density": live / (counts.numel() * K // block),
        "max_abs_err": err, "tol": tol, "rel_err": rel,
        "bitwise_kernel6": order,
        "tile": _tile_record(M, block, dtype, "dense"),
        "ms": time_ms(lambda: kernel.block_sparse_matmul(
            x, w, counts, indices, block)),
        "host_us": host_us(lambda: kernel.block_sparse_matmul(
            x, w, counts, indices, block)),
        "ms_first_design": FIRST_DESIGN_MS.get((label, M, block, dname)),
        "plain_ms": time_ms(lambda: ref.block_sparse_matmul_ref(
            x, w, plan_mask, block, block)),
        "library_ms": time_ms(lambda: torch.matmul(x, w)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    _rates(rec, n_bytes, n_ops)
    return rec


def phase_kernels(main: dict, device) -> tuple:
    import torch
    from repro_torch.kernels.block_sparse.ops import (
        block_mask_from_weight_mask)
    art = main["art"]
    gen = torch.Generator(device=device).manual_seed(1)
    bs_cases = []
    for name in ("gate", "up", "down"):
        w = art.params["blocks"][0]["mlp"][name]
        plan = art.packed[(0, name)]
        b = plan.block
        m16 = block_mask_from_weight_mask(w != 0, b, b)
        m16[:, 0] = False                        # an empty column
        # block 128: the pruned weight cropped to whole 128-tiles, under a
        # random half-density 128-tile map with an empty column
        K128 = w.shape[0] // 128 * 128
        N128 = w.shape[1] // 128 * 128
        w128 = w[:K128, :N128].contiguous()
        m128 = torch.rand((K128 // 128, N128 // 128), generator=gen,
                          device=device) < 0.5
        m128[:, 0] = False
        for M in (16, 128):
            for dtype in (torch.float32, torch.bfloat16):
                bs_cases.append(_block_sparse_case(
                    w, m16, M, b, dtype, gen, f"layer0.{name}"))
                bs_cases.append(_block_sparse_case(
                    w128, m128, M, 128, dtype, gen, f"layer0.{name}/crop"))
        if name != "up":                         # the 64-row tiles' path
            for dtype in (torch.float32, torch.bfloat16):
                bs_cases.append(_block_sparse_case(
                    w, m16, PREFILL_ROWS, b, dtype, gen, f"layer0.{name}"))
    for c in bs_cases:
        log("kernels", kernel="block_sparse", **c)

    wm_cases = [wanda_case(K, N, gen, device)
                for K, N in ((4096, 14336), (14336, 4096), (4096, 1024))]
    for case in wm_cases:
        log("kernels", kernel="wanda_partials", **case)

    rkv_cases = [_rope_kv_write_case(label, B, S, rope, dtype, gen, device)
                 for label, B, S in ROPE_KV_SHAPES
                 for dtype in (torch.float32, torch.bfloat16)
                 for rope in (True, False)]
    for case in rkv_cases:
        log("kernels", kernel="rope_kv_write", **case)
    return bs_cases, wm_cases, rkv_cases


def _rope_kv_write_case(label: str, B: int, S: int, rope: bool, dtype, gen,
                        device) -> dict:
    """The paged step's prologue at ``ROPE_KV_HEADS``: B rows of S tokens
    over ``ROPE_KV_TABLE``-entry tables of BLOCK_SIZE blocks, q/k/v and
    the arenas in ``dtype``, on the step tables ``layers.paged_step``
    builds. The kernel against its plain version on the same inputs: q
    and the arenas bitwise, the scratch block aside (a chunk's padded
    positions all write its last row, in any order)."""
    import torch
    from repro_torch.kernels.rope_kv_write import kernel, ref
    from repro_torch.models.layers import paged_step
    from repro_torch.models.specs import AttentionSpec
    n_q, n_kv, D = ROPE_KV_HEADS
    bs, n_blocks = BLOCK_SIZE, B * ROPE_KV_TABLE
    spec = AttentionSpec(n_q=n_q, n_kv=n_kv, head_dim=D, rope=rope)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    q, k, v = randn(B, S, n_q, D), randn(B, S, n_kv, D), randn(B, S, n_kv, D)
    ka, va = randn(n_blocks + 1, bs, n_kv, D), randn(n_blocks + 1, bs, n_kv,
                                                     D)
    tables = torch.randperm(n_blocks, generator=gen, device=device).to(
        torch.int32).reshape(B, ROPE_KV_TABLE)
    if S == 1:
        start = torch.randint(0, ROPE_KV_TABLE * bs, (B,), generator=gen,
                              device=device)
        n_valid = None
    else:
        start = torch.full((B,), 700, device=device)
        n_valid = torch.full((B,), 300, device=device)
    positions = start[:, None] + torch.arange(S, device=device)[None, :]
    step = paged_step([spec], positions, ka, tables, start, n_valid)
    cos, sin = (step.rope[(spec.rope_theta, D // 2)] if rope
                else (None, None))
    got = [t.clone() for t in (q, ka, va)]
    plain = [t.clone() for t in (q, ka, va)]
    kernel.rope_kv_write(got[0], k, v, got[1], got[2], step.rows, cos, sin)
    ref.rope_kv_write_ref(plain[0], k, v, plain[1], plain[2], step.rows,
                          cos, sin)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    for name, g, p in zip(("q", "k_arena", "v_arena"), got, plain):
        if name != "q":
            g, p = g[:-1], p[:-1]
        if not torch.equal(g, p):
            raise AssertionError(
                f"rope_kv_write {label} {dname} rope={rope}: {name} differs "
                f"from the plain version by "
                f"{float((g.float() - p.float()).abs().max())}")
    n_tok, s = B * S, q.element_size()
    n_bytes = (4 * n_tok * n_kv * D * s + 8 * n_tok  # k, v in; arenas; rows
               + (2 * n_tok * n_q * D * s + 2 * n_tok * (D // 2) * 4 if rope
                  else 0))                           # q in and out; cos, sin
    n_ops = 6.0 * n_tok * (n_q + n_kv) * (D // 2) if rope else 0.0
    b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")   # f32 arithmetic

    def run():
        kernel.rope_kv_write(got[0], k, v, got[1], got[2], step.rows, cos,
                             sin)

    def run_plain():
        ref.rope_kv_write_ref(plain[0], k, v, plain[1], plain[2], step.rows,
                              cos, sin)
    rec = {
        "case": label, "B": B, "S": S,
        "n_valid": None if n_valid is None else int(n_valid[0]),
        "n_q": n_q, "n_kv": n_kv, "D": D, "block": bs,
        "table_entries": ROPE_KV_TABLE, "rope": rope, "dtype": dname,
        "arena_dtype": dname, "bitwise": True, "max_abs_err": 0.0,
        "ms": time_ms(run), "host_us": host_us(run),
        "plain_ms": time_ms(run_plain), "plain_host_us": host_us(run_plain),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
    }
    _rates(rec, n_bytes, n_ops)
    return rec


def wanda_case(K: int, N: int, gen, device) -> dict:
    """Kernel 2 on a random f32 (K, N) weight against its plain version:
    the partials within 1e-5 x max|plain| and in the Frobenius norm, two
    launches bitwise equal, the outlier ratio within one threshold flip;
    its times, host time a call and first design's time."""
    import torch
    from repro_torch.kernels.wanda_metric import kernel as wm_kernel
    from repro_torch.kernels.wanda_metric import ops as wm_ops
    from repro_torch.kernels.wanda_metric import ref as wm_ref
    w = torch.randn((K, N), generator=gen, device=device)
    a = torch.rand((K,), generator=gen, device=device) + 0.5
    part = wm_kernel.wanda_partials(w, a)
    again = wm_kernel.wanda_partials(w, a)
    plain = wm_ref.wanda_partials_ref(w, a, block_k=wm_kernel.BLOCK_K,
                                      block_n=wm_kernel.BLOCK_N)
    err = float((part - plain).abs().max())
    tol = 1e-5 * float(plain.abs().max())
    rel = _check_rel(f"wanda ({K},{N}) partials", part, plain, "float32")
    ratio = float(wm_ops.outlier_ratio(w, a, 5.0))
    ratio_plain = float(wm_ref.outlier_ratio_ref(w, a, 5.0))
    ratio_tol = 2 * 100.0 / (K * N)          # one threshold flip
    if not (err <= tol and abs(ratio - ratio_plain) <= ratio_tol):
        raise AssertionError(f"wanda ({K},{N}): partials err {err} > "
                             f"{tol} or ratio {ratio} vs {ratio_plain}")
    if not torch.equal(part, again):
        raise AssertionError(f"wanda ({K},{N}): two launches differ")
    metric = wm_ref.metric_ref(w, a)
    n_bytes = (K * N + K) * 4 + part.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 3.0 * K * N, "float32")
    rec = {
        "K": K, "N": N, "dtype": "float32", "max_abs_err": err,
        "tol": tol, "rel_err": rel, "bitwise_repeat": True,
        "ratio": ratio, "ratio_plain": ratio_plain,
        "ms": time_ms(lambda: wm_kernel.wanda_partials(w, a)),
        "ms_first_design": FIRST_DESIGN_WANDA_MS.get((K, N)),
        "host_us": host_us(lambda: wm_kernel.wanda_partials(w, a)),
        "plain_ms": time_ms(lambda: wm_ref.wanda_partials_ref(
            w, a, block_k=wm_kernel.BLOCK_K, block_n=wm_kernel.BLOCK_N)),
        "library_ms": time_ms(lambda: torch.sum(metric)),
        "bound_ms": b_ms, "bound_by": b_by,
        "outlier_ratio_ms": time_ms(
            lambda: wm_ops.outlier_ratio(w, a, 5.0)),
        "outlier_ratio_plain_ms": time_ms(
            lambda: wm_ref.outlier_ratio_ref(w, a, 5.0)),
        "library_count_ms": time_ms(
            lambda: torch.count_nonzero(metric > 1.0)),
    }
    first = rec["ms_first_design"]
    rec["speedup_vs_first_design"] = first / rec["ms"] if first else None
    return rec


def _sdpa(q, k, v, **kw):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    on (B, H, S, D) views, the GQA grouping done by the call itself."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def _paged_attention_case(spec, lengths: list, dtype, gen, device,
                          label: str = "continuous") -> dict:
    """Decode attention for B = len(lengths) rows of ``spec``'s heads, K/V
    in a shuffled arena of BLOCK_SIZE blocks. A second launch with one
    more row, the longest row's twin (its table, query and length), must
    give that row's bits, and every other row the first launch's."""
    import torch
    from repro_torch.kernels.paged_attention import kernel, ref
    from repro_torch.models.layers import paged_gather
    n_q, n_kv, D = spec.n_q, spec.n_kv, spec.head_dim
    B, bs = len(lengths), BLOCK_SIZE
    max_blocks = MAX_SEQ // bs
    n_blocks = B * max_blocks
    k = torch.randn((n_blocks + 1, bs, n_kv, D), generator=gen,
                    device=device).to(dtype)
    v = torch.randn((n_blocks + 1, bs, n_kv, D), generator=gen,
                    device=device).to(dtype)
    q = torch.randn((B, n_q, D), generator=gen, device=device).to(dtype)
    tables = torch.randperm(n_blocks, generator=gen, device=device).to(
        torch.int32).reshape(B, max_blocks)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    out = kernel.paged_attention(q, k, v, tables, lens)
    plain = ref.paged_attention_ref(q, k, v, tables, lens)
    long = max(range(B), key=lambda b: lengths[b])
    twin = kernel.paged_attention(
        torch.cat([q, q[long:long + 1]]), k, v,
        torch.cat([tables, tables[long:long + 1]]),
        torch.cat([lens, lens[long:long + 1]]))
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    err, tol = _check_close(f"paged_attention {label}", out, plain, dname)
    rel = _check_rel(f"paged_attention {label}", out, plain, dname)
    if not (torch.equal(twin[B], twin[long]) and torch.equal(twin[:B], out)):
        raise AssertionError(f"paged_attention {label} {dname}: the twin "
                             f"of row {long} or the batch's rows differ")
    kview = paged_gather(k, tables).transpose(1, 2)
    vview = paged_gather(v, tables).transpose(1, 2)
    mask = (torch.arange(kview.shape[2], device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    live = int(lens.sum())
    s = q.element_size()
    n_bytes = (2 * live * n_kv * D + 2 * B * n_q * D) * s \
        + 4 * (tables.numel() + B)
    b_ms, b_by = bound_ms(n_bytes, 4.0 * live * n_q * D, dname)
    rec = {
        "case": label, "B": B, "n_q": n_q, "n_kv": n_kv, "D": D,
        "block": bs, "lengths": lengths, "dtype": dname,
        "max_abs_err": err, "tol": tol, "rel_err": rel,
        "ms": time_ms(lambda: kernel.paged_attention(q, k, v, tables, lens)),
        "host_us": host_us(lambda: kernel.paged_attention(q, k, v, tables,
                                                          lens)),
        "ms_first_design": FIRST_DESIGN_PAGED_MS.get((label, dname)),
        "plain_ms": time_ms(lambda: ref.paged_attention_ref(
            q, k, v, tables, lens)),
        "library_ms": time_ms(lambda: _sdpa(q4, kview, vview,
                                            attn_mask=mask)),
        "library": "scaled_dot_product_attention over the pre-gathered "
                   "view (gather not timed)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    _rates(rec, n_bytes, 4.0 * live * n_q * D)
    return rec


def _flash_attention_case(spec, S: int, dtype, gen, device,
                          label: str) -> dict:
    """Causal prefill attention of one S-token sequence at ``spec``'s
    heads; a second launch must give the same bits."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ref
    n_q, n_kv, D = spec.n_q, spec.n_kv, spec.head_dim
    q, k, v = (torch.randn((1, S, h, D), generator=gen,
                           device=device).to(dtype)
               for h in (n_q, n_kv, n_kv))
    out = kernel.flash_attention(q, k, v)
    again = kernel.flash_attention(q, k, v)
    plain = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    err, tol = _check_close(f"flash_attention {label}", out, plain, dname)
    rel = _check_rel(f"flash_attention {label}", out, plain, dname)
    if not torch.equal(out, again):
        raise AssertionError(f"flash_attention {label} {dname}: two "
                             f"launches differ")
    del plain, again
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    n_bytes = (2 * S * n_q * D + 2 * S * n_kv * D) * q.element_size()
    b_ms, b_by = bound_ms(n_bytes, 4.0 * D * n_q * S * (S + 1) / 2, dname)
    rec = {
        "model": label, "B": 1, "S": S, "n_q": n_q, "n_kv": n_kv, "D": D,
        "dtype": dname, "max_abs_err": err, "tol": tol, "rel_err": rel,
        "ms": time_ms(lambda: kernel.flash_attention(q, k, v), iters=10),
        "host_us": host_us(lambda: kernel.flash_attention(q, k, v)),
        "ms_first_design": FIRST_DESIGN_FLASH_MS.get((label, dname)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v),
                            iters=5),
        "library_ms": time_ms(lambda: _sdpa(q4, k4, v4, is_causal=True),
                              iters=10),
        "library": "scaled_dot_product_attention(is_causal=True)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    if rec["ms_first_design"]:
        rec["speedup_vs_first_design"] = rec["ms_first_design"] / rec["ms"]
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    _rates(rec, n_bytes, 4.0 * D * n_q * S * (S + 1) / 2)
    return rec


def paged_cases(spec, lengths: list, device) -> list:
    """Kernel 3 in f32 and bf16 at the paged trace's MAX_SLOTS rows of
    PAGED_TRACE_PROMPT tokens and the longest of ``lengths`` alone
    (``spec``'s heads), and at the WIDE_HEADS models' heads at
    ``lengths``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(3)
    cases = [("paged-trace", spec, [PAGED_TRACE_PROMPT] * MAX_SLOTS),
             ("long-alone", spec, [max(lengths)])]
    cases += [(model, SimpleNamespace(n_q=n_q, n_kv=n_kv, head_dim=D),
               lengths) for model, n_q, n_kv, D in WIDE_HEADS]
    return [_paged_attention_case(heads, lens, dtype, gen, device, label)
            for label, heads, lens in cases
            for dtype in (torch.float32, torch.bfloat16)]


def phase_attention_kernels(main: dict, cont: dict, device) -> tuple:
    import torch
    t0 = time.perf_counter()
    spec = main["art"].cfg.layer(0).mixer
    gen = torch.Generator(device=device).manual_seed(2)
    pa, fa = [], []
    for dtype in (torch.float32, torch.bfloat16):
        pa.append(_paged_attention_case(spec, cont["decode_lengths"], dtype,
                                        gen, device))
        fa.append(_flash_attention_case(spec, LONG_PROMPT, dtype, gen,
                                        device, "llama3-8b"))
    # the widest heads the kernel takes, at their models' head counts
    for model, n_q, n_kv, D in WIDE_HEADS:
        for dtype in (torch.float32, torch.bfloat16):
            fa.append(_flash_attention_case(
                SimpleNamespace(n_q=n_q, n_kv=n_kv, head_dim=D),
                LONG_PROMPT, dtype, gen, device, model))
    pa += paged_cases(spec, cont["decode_lengths"], device)
    for c in pa:
        log("kernels", kernel="paged_attention", **c)
    for c in fa:
        log("kernels", kernel="flash_attention", **c)
    return pa, fa, time.perf_counter() - t0


BF16_PREFILL_REPEATS = 5           # warm prefills timed on the host clock


def bf16_prefill(art, device) -> dict:
    """One LONG_PROMPT-token prompt, batch 1, through the static
    ``Engine`` in bf16 (compute and cache; a dense FFN through kernel 1's
    bf16 routine, an MoE one through kernel 6's, attention through
    kernel 4's): the kernel launches of the first prefill, its
    last-position logits (finite), the median wall time of
    BF16_PREFILL_REPEATS warm prefills, and one more under
    ``torch.profiler`` for device time by kernel class and each class's
    share of it."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import counters
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import Engine
    eng = Engine.from_artifact(art, ServeConfig(
        max_seq=LONG_PROMPT + 16, compute_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16), sparse=True)
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        1, art.cfg.vocab, (1, LONG_PROMPT)), device=device)
    counters.reset()
    _, logits = eng.generate(prompt, 1, return_logits=True)
    sync(device)
    launches = counters.snapshot()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("bf16 prefill: non-finite logits")
    times = []
    for _ in range(BF16_PREFILL_REPEATS):
        sync(device)
        t0 = time.perf_counter()
        eng.generate(prompt, 1)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompt, 1)
        sync(device)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_class: dict = {}
    by_name: dict = {}
    for e in dev:
        c = kernel_class(e.name)
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_class[c] = by_class.get(c, 0.0) + ms
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + ms)
    total = sum(by_class.values())
    return {"prompt": LONG_PROMPT, "launches": launches,
            "prefill_ms": sorted(times)[len(times) // 2],
            "prefill_ms_all": times,
            "device_ms": total or None,
            "device_busy_ms": _busy_us([(e.time_range.start,
                                         e.time_range.end)
                                        for e in dev]) / 1e3 or None,
            "by_class_ms": dict(sorted(by_class.items(),
                                       key=lambda kv: -kv[1])),
            "share": {c: t / total for c, t in by_class.items()}
            if total else None,
            "top_kernels": [
                {"name": n[:120], "launches": k, "ms": t}
                for n, (k, t) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][1])[:12]],
            "flash_share": (by_class.get("flash_attention", 0.0) / total
                            if total else None)}


def phase_bf16_prefill(main: dict, device) -> dict:
    """bf16_prefill on the pruned llama3-8b: one kernel-4 launch a
    layer, and kernel 1 once a packed FFN projection."""
    art = main["art"]
    t0 = time.perf_counter()
    out = bf16_prefill(art, device)
    ffn_packed = sum(1 for (_, name) in art.packed
                     if name in ("gate", "up", "down"))
    want = {"flash_attention": art.cfg.n_layers,
            "block_sparse": ffn_packed}
    if out["launches"] != want:
        raise AssertionError(f"bf16 prefill: launches {out['launches']}, "
                             f"expected {want}")
    out.update(expected_launches=want, gpu=main["gpu"],
               phase_s=time.perf_counter() - t0)
    log("bf16_prefill", **out)
    return out


# ------------------------------------------------------------ MoE phase

def moe_config():
    from repro_torch.configs.registry import get_config
    full = get_config(MOE_ARCH)
    return full, full.replace(n_periods=MOE_N_PERIODS, scan_layers=False)


def moe_requests(vocab: int) -> list:
    """The MoE continuous run's traffic from seed 0: every prompt pads to
    more than RAGGED_TOKENS_MAX tokens, so every prefill runs the grouped
    kernel and every decode tick (MAX_SLOTS rows) the ragged one."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(0)
    lo, hi = MOE_PROMPT_RANGE
    return [Request(uid=uid,
                    prompt=rng.integers(1, vocab,
                                        int(rng.integers(lo, hi + 1))
                                        ).tolist(),
                    max_new_tokens=int(rng.integers(MOE_NEW_RANGE[0],
                                                    MOE_NEW_RANGE[1] + 1)))
            for uid in range(MOE_REQUESTS)]


def moe_static_runs(art, device, ways=MOE_WAYS) -> dict:
    """4 prompts x NEW_TOKENS greedy tokens on the static engine, one run
    per way, the counters reset just before and read just after each."""
    import dataclasses
    from repro_torch.kernels import counters
    from repro_torch.serve.engine import Engine
    prompt = prompts(art.cfg.vocab, 0)
    runs = {}
    for name, sparse, kw in ways:
        serve = dataclasses.replace(serve_config(), **kw)
        eng = Engine.from_artifact(art, serve, sparse=sparse)
        sync(device)
        counters.reset()
        t0 = time.perf_counter()
        toks, logits = eng.generate(prompt, NEW_TOKENS, return_logits=True)
        sync(device)
        dt = time.perf_counter() - t0
        runs[name] = {"tokens": toks, "logits": logits, "generate_s": dt,
                      "launches": counters.snapshot(),
                      "tokens_per_s_first": BATCH * NEW_TOKENS / dt}
        del eng             # its cast params, before the next way's
    return runs


def moe_layer_bitwise(art, device, quants=(None,)) -> dict:
    """Layer 0's MoE feed-forward on one decode batch and one prefill
    batch of random hidden states in f32, and the decode batch again in
    bf16: ragged, grouped and loop rows must be bitwise equal (one warp
    routine: one fmaf order in f32, the same mma.sync items in bf16),
    under each serve-time ``quant`` of ``quants`` (int8 plans: "int8" and
    "none" too). These launches are checks, not part of a counted run.
    The f32 rows are held to the dense layer; the bf16 rows' distance
    from the dense bf16 layer (which rounds at other places) is
    recorded."""
    import torch
    from repro_torch.models.moe import apply_moe
    from repro_torch.serve.sparse import sparse_apply_moe
    spec = art.cfg.layer(0).ffn
    bp = art.params["blocks"][0]
    gen = torch.Generator(device=device).manual_seed(5)
    out = {}
    for label, S, dtype in (("decode", 1, torch.float32),
                            ("prefill", PROMPT_LEN, torch.float32),
                            ("decode/bf16", 1, torch.bfloat16)):
        x = torch.randn((BATCH, S, art.cfg.d_model), generator=gen,
                        device=device).to(dtype)
        ys = {f"{name}/{q}" if q else name:
              sparse_apply_moe(bp, spec, x, art.packed, 0, quant=q, **kw)
              for q in quants
              for name, kw in (("ragged", {"ragged_moe": True}),
                               ("grouped", {"ragged_moe": False}),
                               ("loop", {"ragged_moe": False,
                                         "group_experts": False}))}
        dense, _ = apply_moe(bp["moe"], spec, x)
        first, y0 = next(iter(ys.items()))
        for name, y in ys.items():
            if y.dtype != dtype or not torch.equal(y0, y):
                raise AssertionError(
                    f"MoE layer {label}: {first} and {name} rows differ by "
                    f"{float((y0.float() - y.float()).abs().max())}")
        err = float((y0.float() - dense.float()).abs().max())
        tol = KERNEL_RTOL["float32"] * max(float(dense.abs().max()), 1.0)
        if dtype == torch.float32 and not err <= tol:
            raise AssertionError(f"MoE layer {label}: sparse vs dense "
                                 f"{err}")
        out[label] = {"bitwise_equal": sorted(ys),
                      "vs_dense_max_abs_err": err}
    return out


def phase_moe(device, gpu: str) -> dict:
    """qwen3-moe-30b-a3b at full width, 4 layers: prune with the MoE
    recipe, save and reload the bundle, serve it on the static engine
    four ways and on the continuous engine's paged pool."""
    import shutil
    import tempfile

    import torch
    from repro_torch.common.tree import param_count
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.sparse import (RAGGED_TOKENS_MAX,
                                          PackedExpertProjection,
                                          flop_savings)

    full, cfg = moe_config()
    recipe = PruneRecipe.load(os.path.join(HERE, "recipes", MOE_RECIPE))
    log("moe", arch=cfg.name, d_model=cfg.d_model, vocab=cfg.vocab,
        layer=str(cfg.layer(0)),
        depth_cut=f"n_periods {full.n_periods} -> {cfg.n_periods}",
        recipe=f"recipes/{MOE_RECIPE}")
    n_projs = len(projections(cfg))
    counters.reset()
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = param_count(params)
    sync(device)
    init_s = time.perf_counter() - t0
    art = MosaicPipeline(recipe).run(params, cfg)
    del params
    torch.cuda.empty_cache()
    prune_launches = counters.snapshot()
    want = {"wanda_partials": 2 * n_projs}
    if prune_launches != want:
        raise AssertionError(f"moe prune launches {prune_launches}, "
                             f"expected {want}")
    stacks = {k: p for k, p in art.packed.items()
              if isinstance(p, PackedExpertProjection)}
    if len(stacks) != 3 * cfg.n_layers or not all(
            p.group and p.ragged for p in stacks.values()):
        raise AssertionError(f"expected grouped+ragged expert stacks for "
                             f"gate/up/down of every layer, got "
                             f"{sorted(stacks)}")
    st = art.report["stage_seconds"]
    out = {"gpu": gpu, "init_s": init_s, "params": n_params,
           "profile_s": st.get("rank"), "plan_s": st.get("plan"),
           "prune_s": st.get("prune"), "pack_s": st.get("pack"),
           "prune_launches": prune_launches,
           "params_before": art.report["params_before"],
           "params_after": art.report["params_after"],
           "pruned_layer0": str(art.cfg.layer(0)),
           "flop_savings": flop_savings(art.packed),
           "pack": {k: v for k, v in art.report["pack"].items()
                    if k != "skipped"},
           "expert_densities_layer0": {
               k[1]: [min(p.densities), max(p.densities)]
               for k, p in stacks.items() if k[0] == 0}}
    log("moe", **out)

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="moe-bundle-", dir=out_dir)
    try:
        loaded, bundle = bundle_round_trip(art, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del art
    torch.cuda.empty_cache()
    out["bundle"] = bundle
    log("moe", bundle=bundle)

    runs = moe_static_runs(loaded, device)
    L = loaded.cfg.n_layers
    n_exp = loaded.cfg.layer(0).ffn.n_experts
    prefill = 1 if BATCH * PROMPT_LEN > RAGGED_TOKENS_MAX else 0
    decode = NEW_TOKENS - 1                # B * 1 tokens <= the limit
    expected = {
        "default": {"grouped_block_sparse": 3 * L * prefill,
                    "grouped_block_sparse_ragged": 3 * L * decode},
        "grouped": {"grouped_block_sparse": 3 * L * NEW_TOKENS},
        "loop": {"block_sparse": 3 * L * n_exp * NEW_TOKENS},
        "dense": {}}
    dn = runs["dense"]
    for name, r in runs.items():
        got = {k: v for k, v in r["launches"].items()
               if not k.endswith("_experts_computed")}
        if got != expected[name] or (name != "dense" and not all(
                expected[name].values())):
            raise AssertionError(f"moe {name}: launches {r['launches']}, "
                                 f"expected {expected[name]}")
        for kname, n in expected[name].items():
            computed = r["launches"].get(kname + "_experts_computed")
            if kname != "block_sparse" and not 0 < computed <= n_exp * n:
                raise AssertionError(f"moe {name}: {computed} experts "
                                     f"computed over {n} launches")
        toks, logits = r["tokens"], r["logits"]
        if tuple(toks.shape) != (BATCH, PROMPT_LEN + NEW_TOKENS) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"moe {name}: bad output")
        if name != "dense":
            r["vs_dense"] = compare_generation(toks, logits, dn["tokens"],
                                               dn["logits"], PROMPT_LEN,
                                               LOGIT_ATOL)
    for name in ("grouped", "loop"):
        if not torch.equal(runs[name]["tokens"], runs["default"]["tokens"]):
            raise AssertionError(f"moe: {name} tokens differ from the "
                                 f"default path's")
        runs[name]["logits_max_diff_vs_default"] = float(
            (runs[name]["logits"] - runs["default"]["logits"]).abs().max())
    out["static"] = {name: {k: v for k, v in r.items()
                            if k not in ("tokens", "logits")}
                     for name, r in runs.items()}
    out["expected_launches"] = expected
    for name, r in out["static"].items():
        log("moe", run=name, **r)
    out["layer_bitwise"] = moe_layer_bitwise(loaded, device)
    log("moe", layer_bitwise=out["layer_bitwise"])

    ref_run = serve_continuous(
        loaded, device, "moe-dense-contiguous", moe_requests(loaded.cfg.vocab),
        continuous_config(), sparse=False)
    run = serve_continuous(
        loaded, device, "moe-paged-kernel", moe_requests(loaded.cfg.vocab),
        continuous_config(block_size=BLOCK_SIZE, paged_kernel=True))
    want = {"grouped_block_sparse": 3 * L * run["prefill_chunks"],
            "grouped_block_sparse_ragged": 3 * L * run["ticks"],
            "paged_attention": L * run["ticks"],
            "rope_kv_write": L * (run["prefill_chunks"] + run["ticks"])}
    got = {k: v for k, v in run["launches"].items()
           if not k.endswith("_experts_computed")}
    if got != want or ref_run["launches"]:
        raise AssertionError(f"moe continuous: launches {run['launches']} "
                             f"(dense {ref_run['launches']}), expected "
                             f"{want}")
    run["expected_launches"] = want
    cmp = compare_runs(loaded, device, ref_run, run)
    out["continuous"] = [{k: v for k, v in r.items()
                          if k not in ("tokens", "prompts")}
                         for r in (ref_run, run)]
    out["continuous_agreement"] = cmp
    for r in out["continuous"]:
        log("moe", **r)
    log("moe", continuous_agreement=cmp)
    t0 = time.perf_counter()
    out["expert_removal"] = moe_expert_removal(loaded, device)
    out["expert_removal"]["phase_s"] = time.perf_counter() - t0
    log("moe", expert_removal=out["expert_removal"])
    out["art"] = loaded
    out["tokens_per_s"] = {
        name: steady_tokens_per_s(loaded, device, sparse, **kw)
        for name, sparse, kw in MOE_WAYS}
    log("moe", tokens_per_s=out["tokens_per_s"])
    return out


def moe_expert_removal(art, device) -> dict:
    """Whole-expert removal on the pruned qwen3-moe: ``prune_structured``
    with ``expert_frac`` EXPERT_FRAC (128 -> 96 experts a layer, top-8
    kept), the expert stacks re-packed, the bundle round trip, then 4 x
    32 tokens on the static engine default (kernels 6 and 7) and dense,
    with exact launch counts and tokens held to dense."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.artifact import PrunedArtifact
    from repro_torch.core.structured import prune_structured
    from repro_torch.models.specs import MoESpec
    from repro_torch.serve.sparse import (RAGGED_TOKENS_MAX,
                                          pack_model_with_report)
    r = art.recipe
    before = art.cfg.layer(0).ffn
    n_exp = max(before.top_k,
                before.n_experts - int(round(EXPERT_FRAC * before.n_experts)))
    t0 = time.perf_counter()
    params, cfg = prune_structured(art.params, art.cfg, {},
                                   expert_frac=EXPERT_FRAC)
    sync(device)
    remove_s = time.perf_counter() - t0
    if any(not isinstance(cfg.layer(i).ffn, MoESpec)
           or cfg.layer(i).ffn.n_experts != n_exp
           or cfg.layer(i).ffn.top_k != before.top_k
           or params["blocks"][i]["moe"]["router"].shape[1] != n_exp
           for i in range(cfg.n_layers)):
        raise AssertionError(f"expert removal: {cfg.layer(0)}")
    t0 = time.perf_counter()
    packed, pack = pack_model_with_report(
        params, cfg, block=r.block, group_experts=r.group_experts,
        ragged_moe=r.ragged_moe, quant=r.quant)
    sync(device)
    pack_s = time.perf_counter() - t0
    reduced = PrunedArtifact(params=params, cfg=cfg, recipe=r,
                             targets=art.targets, packed=packed,
                             report={"category": art.report["category"],
                                     "expert_frac": EXPERT_FRAC,
                                     "pack": pack})
    del params
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="moe-experts-", dir=out_dir)
    try:
        loaded, bundle = bundle_round_trip(reduced, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del reduced
    torch.cuda.empty_cache()
    runs = moe_static_runs(loaded, device, ways=(MOE_WAYS[0],
                                                 MOE_WAYS[-1]))
    L = cfg.n_layers
    prefill = 1 if BATCH * PROMPT_LEN > RAGGED_TOKENS_MAX else 0
    expected = {
        "default": {"grouped_block_sparse": 3 * L * prefill,
                    "grouped_block_sparse_ragged": 3 * L * (NEW_TOKENS - 1)},
        "dense": {}}
    check_static_runs(runs, expected, n_experts=n_exp)
    d, dn = runs["default"], runs["dense"]
    out = {"experts": [before.n_experts, n_exp], "top_k": before.top_k,
           "remove_s": remove_s, "pack_s": pack_s, "bundle": bundle,
           "flop_savings": pack.get("flop_savings"),
           "launches": d["launches"], "expected_launches": expected,
           "generate_s": {k: v["generate_s"] for k, v in runs.items()},
           **compare_generation(d["tokens"], d["logits"], dn["tokens"],
                                dn["logits"], PROMPT_LEN, LOGIT_ATOL)}
    del loaded, runs
    torch.cuda.empty_cache()
    return out


def _moe_routing(E: int, K: int, G: int, s: int, C: int, gen, device):
    """Router-shaped assignments: K distinct experts per token from
    ``gen``, with the capacity ``C`` keep mask and positions."""
    import torch
    import torch.nn.functional as F
    ids = torch.rand((G, s, E), generator=gen, device=device).argsort(
        dim=-1)[..., :K].reshape(G, s * K)
    onehot = F.one_hot(ids, E)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    return ids, onehot, pos < C, pos


def _grouped_case(w, plan, spec, dtype, gen, label: str,
                  quant: bool = False, groups: int = BATCH,
                  tokens: int = PROMPT_LEN) -> dict:
    """Kernel 6 at an MoE prefill: ``groups`` groups of ``tokens`` tokens
    routed top-k over the experts, capacity slots (E, G*C, K) with the
    router's occupancy, through the pruned stack ``w``, as one panel of
    G*C rows (the serving path's choice up to 1024 rows). With ``quant``,
    kernel 8 over the int8 plan, held bitwise to kernel 6 over ``w``
    (the fake-quant stack the plan encodes)."""
    import torch
    from repro_torch.kernels.grouped_block_sparse import kernel, ops, ref
    from repro_torch.models.moe import capacity
    dev = w.device
    E, K, N = w.shape
    b = plan.block
    C = capacity(spec, tokens)
    ids, onehot, keep, _ = _moe_routing(E, spec.top_k, groups, tokens, C,
                                        gen, dev)
    count_ge = (onehot * keep[..., None]).sum(dim=1)        # (G, E)
    row_live = (torch.arange(C, device=dev)[None, None, :]
                < count_ge.T[:, :, None]).reshape(E, groups * C)
    M = groups * C
    pad = (-M) % 16
    xs = torch.randn((E, M, K), generator=gen, device=dev)
    xs = (xs * row_live[..., None]).to(dtype)
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        row_live = torch.nn.functional.pad(row_live, (0, pad))
    M = xs.shape[1]
    w = w.to(dtype).contiguous()
    work, experts = ops.occupancy(row_live, E, M, M, dev)
    masks = ref.block_masks_from_plans(plan.counts, plan.indices, K // b)
    y = ops.grouped_blocksparse_matmul(xs, w, plan.counts, plan.indices, b,
                                       row_live=row_live)
    if quant:
        q_args = (plan.tiles, plan.counts, plan.indices, plan.slots,
                  plan.scales)
        y6, y = y, ops.quant_grouped_blocksparse_matmul(
            xs, *q_args, b, row_live=row_live)

        def launch():
            return kernel.quant_grouped_block_sparse_matmul(
                xs, *q_args, work, b, M)
    else:
        def launch():
            return kernel.grouped_block_sparse_matmul(
                xs, w, plan.counts, plan.indices, work, b, M)
    plain = ref.grouped_block_sparse_matmul_ref(xs, w, masks, b, b,
                                                work=work, block_m=M)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    name = "quant_grouped" if quant else "grouped"
    err, tol = _check_close(f"{name}_block_sparse {label}", y, plain, dname)
    rel = _check_rel(f"{name}_block_sparse {label}", y, plain, dname)
    if quant and not torch.equal(y, y6):
        raise AssertionError(f"kernel 8 {label} {dname} differs from "
                             f"kernel 6 over the dequantised stack")
    live_e = work[:, 0] > 0
    live_tiles = int(plan.counts[live_e].sum())
    s_ = xs.element_size()
    n_bytes = (int(live_e.sum()) * M * K + E * M * N) * s_ + 4 * (
        int(live_e.sum()) * plan.counts.shape[1] + E)
    if quant:       # int8 tiles; an index, a slot and a scale a step
        n_bytes += live_tiles * (b * b + 12)
    else:
        n_bytes += live_tiles * b * b * s_ \
            + 4 * int(live_e.sum()) * plan.indices[0].numel()
    b_ms, b_by = bound_ms(n_bytes, 2.0 * M * live_tiles * b * b, dname)
    first = (FIRST_DESIGN_QUANT_GROUPED_MS if quant
             else FIRST_DESIGN_GROUPED_MS).get((label, M, dname))
    rec = {
        "case": label, "E": E, "M": M, "K": K, "N": N, "block": b,
        "groups": groups, "tokens": tokens, "capacity": C, "dtype": dname,
        "quant": quant, "experts_computed": int(experts),
        "live_rows": int(row_live.sum()), "live_tiles": live_tiles,
        "max_abs_err": err, "tol": tol, "rel_err": rel,
        "ms": time_ms(launch), "host_us": host_us(launch),
        "ms_first_design": first,
        "plain_ms": time_ms(lambda: ref.grouped_block_sparse_matmul_ref(
            xs, w, masks, b, b, work=work, block_m=M), iters=5),
        "library_ms": time_ms(lambda: torch.bmm(xs, w)),
        "library": "torch.bmm over the block-masked dense stack",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    rec["speedup_vs_first_design"] = first / rec["ms"] if first else None
    _rates(rec, n_bytes, 2.0 * M * live_tiles * b * b)
    return rec


def _grouped_tile_record(c: dict, dtype) -> dict:
    """The tile kernel 6 or 8 takes for a case of ``_grouped_case`` (one
    panel of M rows): the Python rule, held to the library's."""
    from repro_torch.kernels.grouped_block_sparse import kernel
    weight = "int8" if c["quant"] else "dense"
    cfg = kernel.tile_config(c["M"], c["M"], c["block"], dtype, weight)
    lib = kernel.library_tile_config(c["M"], c["M"], c["block"], dtype,
                                     weight)
    if lib != {k: cfg[k] for k in lib}:
        raise AssertionError(f"grouped tile rule {cfg} differs from the "
                             f"library's {lib}")
    return cfg


def _one_expert_bitwise(w, plan, dtype, M: int, gen) -> dict:
    """Kernel 6 with one expert (the stack's expert with the most live
    tiles) against kernel 1 on that expert's plan: the same items in the
    same order, so the same bits, f32 and bf16, at 16- and 64-row
    M-tiles."""
    import torch
    from repro_torch.kernels.block_sparse import kernel as bs_kernel
    from repro_torch.kernels.grouped_block_sparse import kernel
    dev = w.device
    e = int(plan.counts.sum(dim=1).argmax())
    we = w[e].to(dtype).contiguous()
    counts = plan.counts[e].contiguous()
    indices = plan.indices[e].contiguous()
    x = torch.randn((M, we.shape[0]), generator=gen, device=dev).to(dtype)
    y1 = bs_kernel.block_sparse_matmul(x, we, counts, indices, plan.block)
    y6 = kernel.grouped_block_sparse_matmul(
        x[None], we[None], counts[None], indices[None],
        torch.ones((1, 1), dtype=torch.int32, device=dev), plan.block, M)[0]
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    if not torch.equal(y1, y6):
        raise AssertionError(f"kernel 6 with one expert differs from kernel "
                             f"1 at M {M} {dname} by "
                             f"{float((y1.float() - y6.float()).abs().max())}")
    return {"expert": e, "M": M, "dtype": dname, "bitwise_equal": True,
            "live_tiles": int(counts.sum())}


def _ragged_case(w, plan, spec, dtype, gen, label: str,
                 quant: bool = False, tokens: int = BATCH) -> dict:
    """Kernel 7 at an MoE decode tick of ``tokens`` one-token sequences
    (the engine's BATCH, or RAGGED_TOKENS_MAX, the most the ragged route
    takes) routed top-k, packed into 16-row per-expert tiles by the
    model's own ``build_ragged_dispatch``. With ``quant``, kernel 9 over
    the int8 plan, held bitwise to kernel 7 over ``w``."""
    import torch
    from repro_torch.kernels.grouped_block_sparse import kernel, ops, ref
    from repro_torch.models.moe import (build_ragged_dispatch, capacity,
                                        ragged_rows_bound)
    dev = w.device
    E, K, N = w.shape
    b = plan.block
    C = capacity(spec, 1)
    ids, _, keep, pos = _moe_routing(E, spec.top_k, tokens, 1, C, gen, dev)
    m_max = ragged_rows_bound(E, tokens * spec.top_k)
    dest, tile_expert, _ = build_ragged_dispatch(ids, keep, pos, E, m_max)
    src = torch.randn((tokens * spec.top_k, K), generator=gen, device=dev)
    xp = torch.zeros((m_max + 1, K), device=dev).index_add_(
        0, dest.reshape(-1), src)[:m_max].to(dtype).contiguous()
    w = w.to(dtype).contiguous()
    masks = ref.block_masks_from_plans(plan.counts, plan.indices, K // b)
    y = ops.ragged_blocksparse_matmul(xp, w, plan.counts, plan.indices,
                                      tile_expert, b)
    if quant:
        q_args = (plan.tiles, plan.counts, plan.indices, plan.slots,
                  plan.scales)
        y7, y = y, ops.quant_ragged_blocksparse_matmul(xp, *q_args,
                                                       tile_expert, b)

        def launch():
            return kernel.quant_ragged_block_sparse_matmul(
                xp, *q_args, tile_expert, b)
    else:
        def launch():
            return kernel.ragged_block_sparse_matmul(
                xp, w, plan.counts, plan.indices, tile_expert, b)
    plain = ref.ragged_block_sparse_matmul_ref(xp, w, tile_expert, 16,
                                               masks, b, b)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    name = "quant_ragged" if quant else "ragged"
    err, tol = _check_close(f"{name}_block_sparse {label}", y, plain, dname)
    rel = _check_rel(f"{name}_block_sparse {label}", y, plain, dname)
    if quant and not torch.equal(y, y7):
        raise AssertionError(f"kernel 9 {label} {dname} differs from "
                             f"kernel 7 over the dequantised stack")
    te = tile_expert.long()
    live = te >= 0
    experts = torch.unique(te[live])
    live_tiles_w = int(plan.counts[experts].sum())
    tile_tiles = int(plan.counts[te[live]].sum())     # per 16-row tile
    s_ = xp.element_size()
    n_bytes = (int(live.sum()) * 16 * K + m_max * N) * s_ + 4 * (
        te.numel() + experts.numel() * plan.counts.shape[1])
    if quant:       # int8 tiles; an index, a slot and a scale a step
        n_bytes += live_tiles_w * (b * b + 12)
    else:
        n_bytes += live_tiles_w * b * b * s_ \
            + 4 * experts.numel() * plan.indices[0].numel()
    b_ms, b_by = bound_ms(n_bytes, 2.0 * 16 * tile_tiles * b * b, dname)
    x_tiles = xp.reshape(-1, 16, K)
    w_tiles = w[te.clamp(min=0)]
    first = (FIRST_DESIGN_QUANT_RAGGED_MS if quant
             else FIRST_DESIGN_RAGGED_MS).get((label, tokens, dname))
    rec = {
        "case": label, "E": E, "M": m_max, "K": K, "N": N, "block": b,
        "tokens": tokens, "assignments": tokens * spec.top_k,
        "tiles": te.numel(), "live_tiles": int(live.sum()),
        "experts_computed": int(experts.numel()), "dtype": dname,
        "quant": quant, "max_abs_err": err, "tol": tol, "rel_err": rel,
        "ms": time_ms(launch), "host_us": host_us(launch),
        "ms_first_design": first,
        "plain_ms": time_ms(lambda: ref.ragged_block_sparse_matmul_ref(
            xp, w, tile_expert, 16, masks, b, b), iters=5),
        "library_ms": time_ms(lambda: torch.bmm(x_tiles, w_tiles)),
        "library": "torch.bmm over each tile's gathered expert weight "
                   "(gather not timed)",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    rec["speedup_vs_first_design"] = first / rec["ms"] if first else None
    return rec


def phase_moe_kernels(moe: dict, device, quant: bool = False,
                      prefix: str = "") -> tuple:
    """Kernels 6 and 7 (with ``quant``: 8 and 9) against their plain
    versions at the MoE path's shapes: layer 0's pruned gate and down
    stacks, f32 and bf16; the grouped kernel at the 4 x 32 prefill (M 16)
    and at a LONG_PROMPT-token prompt (one panel of M 240 rows, 64-row
    M-tiles); the ragged kernel at the BATCH-token decode tick and at a
    tick of RAGGED_TOKENS_MAX tokens. Without ``quant``, also kernel 6
    with one expert held bitwise to kernel 1 at both M, in both types
    (logged under ``one_expert``). The phase's seconds go to ``moe``
    (``kernels_s``). ``prefix`` starts each case's label (another
    model's stacks)."""
    import torch
    from repro_torch.serve.sparse import RAGGED_TOKENS_MAX
    t0 = time.perf_counter()
    art = moe["art"]
    spec = art.cfg.layer(0).ffn
    gen = torch.Generator(device=device).manual_seed(6)
    grouped, ragged = [], []
    for name in ("gate", "down"):
        w = art.params["blocks"][0]["moe"][name]
        plan = art.packed[(0, name)]
        for dtype in (torch.float32, torch.bfloat16):
            for groups, tokens in ((BATCH, PROMPT_LEN), (1, LONG_PROMPT)):
                c = _grouped_case(w, plan, spec, dtype, gen,
                                  f"{prefix}layer0.{name}", quant, groups,
                                  tokens)
                c["tile"] = _grouped_tile_record(c, dtype)
                grouped.append(c)
            for tokens in (BATCH, RAGGED_TOKENS_MAX):
                ragged.append(_ragged_case(w, plan, spec, dtype, gen,
                                           f"{prefix}layer0.{name}", quant,
                                           tokens))
    q = "quant_" if quant else ""
    for c in grouped:
        log("kernels", kernel=f"{q}grouped_block_sparse_matmul", **c)
    for c in ragged:
        log("kernels", kernel=f"{q}ragged_block_sparse_matmul", **c)
    if not quant:
        w = art.params["blocks"][0]["moe"]["gate"]
        moe["one_expert"] = [
            _one_expert_bitwise(w, art.packed[(0, "gate")], dtype, M, gen)
            for dtype in (torch.float32, torch.bfloat16)
            for M in sorted({c["M"] for c in grouped})]
        log("kernels", kernel="grouped_block_sparse_matmul",
            one_expert=moe["one_expert"])
    moe["kernels_s"] = time.perf_counter() - t0
    return grouped, ragged


def phase_moe_bf16_prefill(moe: dict, device) -> dict:
    """bf16_prefill on the pruned qwen3-moe-30b-a3b: every MoE projection
    of the 3072-token prompt through kernel 6 (one capacity-slot panel of
    240 rows an expert), attention through kernel 4; kernel 6's share of
    the prefill's device time."""
    art = moe["art"]
    t0 = time.perf_counter()
    out = bf16_prefill(art, device)
    L = art.cfg.n_layers
    want = {"grouped_block_sparse": 3 * L, "flash_attention": L}
    got = {k: v for k, v in out["launches"].items()
           if not k.endswith("_experts_computed")}
    if got != want:
        raise AssertionError(f"moe bf16 prefill: launches {out['launches']}, "
                             f"expected {want}")
    out.update(expected_launches=want, gpu=moe["gpu"],
               grouped_share=(out["share"] or {}).get("grouped_block_sparse"),
               phase_s=time.perf_counter() - t0)
    log("moe_bf16_prefill", **out)
    return out


# ------------------------------------------------------------ int8 phases

# static-engine ways of the int8 llama run: (name, sparse, ServeConfig)
QUANT_WAYS = (("int8", True, {}),                 # the plans' int8 flag
              ("none", True, {"quant": "none"}),  # kernel 1, fake-quant w
              ("dense", False, {}))


def check_static_runs(runs: dict, expected: dict, n_experts=None) -> None:
    """Exact launch counts per run (experts-computed counters bounded by
    experts x launches), finite logits and tokens of the right shape."""
    import torch
    for name, r in runs.items():
        got = {k: v for k, v in r["launches"].items()
               if not k.endswith("_experts_computed")}
        if got != expected[name] or not all(
                v for v in expected[name].values()):
            raise AssertionError(f"{name}: launches {r['launches']}, "
                                 f"expected {expected[name]}")
        for kname, n in expected[name].items():
            computed = r["launches"].get(kname + "_experts_computed")
            if computed is not None and not 0 < computed <= n_experts * n:
                raise AssertionError(f"{name}: {computed} experts "
                                     f"computed over {n} launches")
        toks, logits = r["tokens"], r["logits"]
        if tuple(toks.shape) != (BATCH, PROMPT_LEN + NEW_TOKENS) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: bad output")


def int8_equals_none(runs: dict, a: str, b: str = "none") -> float:
    """The int8 run ``a`` and the dequantised reference run ``b`` must
    give the same logits bit for bit (and so the same tokens)."""
    import torch
    diff = float((runs[a]["logits"] - runs[b]["logits"]).abs().max())
    if not torch.equal(runs[a]["logits"], runs[b]["logits"]) \
            or not torch.equal(runs[a]["tokens"], runs[b]["tokens"]):
        raise AssertionError(f"{a} and {b} logits differ by {diff}")
    return diff


def quant_summary(qb: dict) -> dict:
    """The pack report's ``quant_bytes`` without its per-projection rows,
    plus the int8 storage over bf16 bytes per projection name."""
    by_name: dict = {}
    for key, row in qb["per_projection"].items():
        name = key.split(":")[1]
        b, d = by_name.get(name, (0, 0))
        by_name[name] = (b + row["bytes"], d + row.get("bf16_bytes", 0))
    out = {k: v for k, v in qb.items() if k != "per_projection"}
    out["ratio_vs_bf16_by_name"] = {n: b / d for n, (b, d) in
                                    sorted(by_name.items()) if d}
    return out


def _quant_block_sparse_case(w, plan, M: int, dtype, gen,
                             label: str) -> dict:
    """Kernel 5 on the int8 plan of a pruned projection, held bitwise to
    kernel 1 over ``w`` (the fake-quant weight the plan encodes) and to
    its plain version within tolerance."""
    import torch
    from repro_torch.kernels.block_sparse import kernel, ref
    dev = w.device
    K, N = w.shape
    b = plan.block
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    wd = w.to(dtype).contiguous()
    args = (plan.tiles, plan.counts, plan.indices, plan.slots, plan.scales,
            b)
    y = kernel.quant_block_sparse_matmul(x, *args)
    y1 = kernel.block_sparse_matmul(x, wd, plan.counts, plan.indices, b)
    plain = ref.quant_block_sparse_matmul_ref(x, *args)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    if not torch.equal(y, y1):
        raise AssertionError(f"kernel 5 {label} {dname} differs from "
                             f"kernel 1 over the dequantised weight by "
                             f"{float((y - y1).abs().max())}")
    err, tol = _check_close(f"quant_block_sparse {label} M={M}", y, plain,
                            dname)
    rel = _check_rel(f"quant_block_sparse {label} M={M}", y, plain, dname)
    live = int(plan.counts.sum())
    n_bytes = (M * K + M * N) * x.element_size() + live * (b * b + 12) \
        + 4 * plan.counts.numel()
    n_ops = 2.0 * M * live * b * b
    b_ms, b_by = bound_ms(n_bytes, n_ops, dname)
    rec = {
        "case": label, "M": M, "K": K, "N": N, "block": b, "dtype": dname,
        "density": live / (plan.counts.numel() * K // b),
        "tiles": int(plan.tiles.shape[0]),
        "max_abs_err": err, "tol": tol, "rel_err": rel,
        "tile": _tile_record(M, b, dtype, "int8"),
        "ms": time_ms(lambda: kernel.quant_block_sparse_matmul(x, *args)),
        "host_us": host_us(lambda: kernel.quant_block_sparse_matmul(
            x, *args)),
        "ms_first_design": FIRST_DESIGN_QUANT_MS.get((label, M, b, dname)),
        "kernel1_ms": time_ms(lambda: kernel.block_sparse_matmul(
            x, wd, plan.counts, plan.indices, b)),
        "plain_ms": time_ms(lambda: ref.quant_block_sparse_matmul_ref(
            x, *args)),
        "library_ms": time_ms(lambda: torch.matmul(x, wd)),
        "library": "torch.matmul over the dequantised block-masked weight",
        "bound_ms": b_ms, "bound_by": b_by,
    }
    _rates(rec, n_bytes, n_ops)
    return rec


def phase_quant(main: dict, device, gpu: str) -> dict:
    """llama3-8b at full width, 4 layers, pruned with the int8 recipe and
    served three ways on the static engine; kernel 5 at the layer-0
    gate and down."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.sparse import plans_from_host, plans_to_host

    cfg = get_config("llama3-8b").replace(n_periods=N_PERIODS,
                                          scan_layers=False)
    recipe = PruneRecipe.load(os.path.join(HERE, "recipes", QUANT_RECIPE))
    counters.reset()
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    art = MosaicPipeline(recipe).run(params, cfg)
    del params
    prune_launches = counters.snapshot()
    if prune_launches != {"wanda_partials": 2 * len(projections(cfg))}:
        raise AssertionError(f"quant prune launches {prune_launches}")
    if not art.packed or not all(p.quant == "int8" and p.tiles is not None
                                 for p in art.packed.values()):
        raise AssertionError("the int8 recipe packed plans without int8 "
                             "storage")
    t0 = time.perf_counter()
    back = plans_from_host(*plans_to_host(art.packed), device)
    round_trip_s = time.perf_counter() - t0
    if set(back) != set(art.packed) or not all(
            plans_equal(p, back[k]) for k, p in art.packed.items()):
        raise AssertionError("int8 plans differ after the host round trip")
    del back
    ffn = sum(1 for (_, name) in art.packed
              if name in ("gate", "up", "down"))
    runs = moe_static_runs(art, device, QUANT_WAYS)
    expected = {"int8": {"block_sparse_quant": ffn * NEW_TOKENS},
                "none": {"block_sparse": ffn * NEW_TOKENS}, "dense": {}}
    check_static_runs(runs, expected)
    qb = art.report["pack"]["quant_bytes"]
    st = art.report["stage_seconds"]
    out = {"gpu": gpu, "recipe": f"recipes/{QUANT_RECIPE}",
           "prune_launches": prune_launches, "expected_launches": expected,
           "profile_s": st.get("rank"), "prune_s": st.get("prune"),
           "pack_s": st.get("pack"), "pack_s_golden_smoke": main["pack_s"],
           "plans_round_trip_s": round_trip_s,
           "quant_bytes": quant_summary(qb),
           "bytes_before": art.report["bytes_before"],
           "bytes_after": art.report["bytes_after"],
           "int8_vs_none_logits_max_abs_diff": int8_equals_none(runs,
                                                                "int8"),
           "vs_dense": compare_generation(
               runs["int8"]["tokens"], runs["int8"]["logits"],
               runs["dense"]["tokens"], runs["dense"]["logits"],
               PROMPT_LEN, LOGIT_ATOL),
           "static": {name: {k: v for k, v in r.items()
                             if k not in ("tokens", "logits")}
                      for name, r in runs.items()}}
    print(f"int8 kept tiles: {qb['total_bytes']} bytes, "
          f"ratio_vs_bf16 {qb['ratio_vs_bf16']}", flush=True)
    out["tokens_per_s"] = paired_tokens_per_s(art, device, QUANT_WAYS)
    log("quant", **out)
    out["trace"] = [trace_decode(art, device, True, "int8"),
                    trace_decode(art, device, True, "none", quant="none")]
    for t in out["trace"]:
        log("trace", gpu=gpu, model="llama3-8b quant-smoke", **t)
    gen = torch.Generator(device=device).manual_seed(7)
    mlp = art.params["blocks"][0]["mlp"]
    out["cases"] = [_quant_block_sparse_case(
        mlp[name], art.packed[(0, name)], M, dtype, gen, f"layer0.{name}")
        for name in ("gate", "down") for M in (16, 128)
        for dtype in (torch.float32, torch.bfloat16)]
    for c in out["cases"]:
        log("kernels", kernel="quant_block_sparse_matmul", **c)
    out["art"] = art
    return out


def phase_moe_quant(device, gpu: str) -> dict:
    """qwen3-moe-30b-a3b at full width, 4 layers, pruned with the MoE
    recipe and ``quant="int8"``: bundle round trip, the static engine four
    ways, layer 0's rows across every path, the paged pool int8 and
    "none"."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.sparse import (RAGGED_TOKENS_MAX,
                                          PackedExpertProjection)

    _, cfg = moe_config()
    recipe = PruneRecipe.load(os.path.join(HERE, "recipes", MOE_RECIPE)
                              ).replace(quant="int8")
    counters.reset()
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    art = MosaicPipeline(recipe).run(params, cfg)
    del params
    torch.cuda.empty_cache()
    prune_launches = counters.snapshot()
    if prune_launches != {"wanda_partials": 2 * len(projections(cfg))}:
        raise AssertionError(f"moe quant prune launches {prune_launches}")
    stacks = [p for p in art.packed.values()
              if isinstance(p, PackedExpertProjection)]
    if len(stacks) != 3 * cfg.n_layers or not all(
            p.quant == "int8" and p.tiles is not None for p in stacks):
        raise AssertionError("expected int8 expert stacks for gate/up/down "
                             "of every layer")
    qb = art.report["pack"]["quant_bytes"]
    st = art.report["stage_seconds"]
    out = {"gpu": gpu, "recipe": f"recipes/{MOE_RECIPE} + quant int8",
           "profile_s": st.get("rank"), "prune_s": st.get("prune"),
           "pack_s": st.get("pack"), "prune_launches": prune_launches,
           "quant_bytes": quant_summary(qb),
           "bytes_before": art.report["bytes_before"],
           "bytes_after": art.report["bytes_after"],
           "tiles_layer0_gate": int(art.packed[(0, "gate")].tiles.shape[0])}
    log("moe_quant", **out)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="moe-quant-bundle-", dir=out_dir)
    try:
        loaded, out["bundle"] = bundle_round_trip(art, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del art
    torch.cuda.empty_cache()
    log("moe_quant", bundle=out["bundle"])

    runs = moe_static_runs(loaded, device, MOE_QUANT_WAYS)
    L = loaded.cfg.n_layers
    prefill = 1 if BATCH * PROMPT_LEN > RAGGED_TOKENS_MAX else 0
    decode = NEW_TOKENS - 1
    expected = {
        "int8": {"grouped_block_sparse_quant": 3 * L * prefill,
                 "grouped_block_sparse_ragged_quant": 3 * L * decode},
        "int8-grouped": {"grouped_block_sparse_quant": 3 * L * NEW_TOKENS},
        "none": {"grouped_block_sparse": 3 * L * prefill,
                 "grouped_block_sparse_ragged": 3 * L * decode},
        "dense": {}}
    check_static_runs(runs, expected, loaded.cfg.layer(0).ffn.n_experts)
    out["expected_launches"] = expected
    out["int8_vs_none_logits_max_abs_diff"] = int8_equals_none(runs, "int8")
    if not torch.equal(runs["int8-grouped"]["tokens"],
                       runs["int8"]["tokens"]):
        raise AssertionError("moe int8: grouped-only tokens differ from the "
                             "default path's")
    for name in ("int8", "int8-grouped"):
        runs[name]["vs_dense"] = compare_generation(
            runs[name]["tokens"], runs[name]["logits"],
            runs["dense"]["tokens"], runs["dense"]["logits"], PROMPT_LEN,
            LOGIT_ATOL)
    out["static"] = {name: {k: v for k, v in r.items()
                            if k not in ("tokens", "logits")}
                     for name, r in runs.items()}
    for name, r in out["static"].items():
        log("moe_quant", run=name, **r)
    out["layer_bitwise"] = moe_layer_bitwise(loaded, device,
                                             quants=("int8", "none"))
    log("moe_quant", layer_bitwise=out["layer_bitwise"])

    reqs = moe_requests(loaded.cfg.vocab)
    pool = continuous_config(block_size=BLOCK_SIZE, paged_kernel=True)
    run = serve_continuous(loaded, device, "moe-int8-paged-kernel", reqs,
                           pool)
    ref_run = serve_continuous(
        loaded, device, "moe-none-paged-kernel", moe_requests(
            loaded.cfg.vocab),
        continuous_config(block_size=BLOCK_SIZE, paged_kernel=True,
                          quant="none"))
    want = {"grouped_block_sparse_quant": 3 * L * run["prefill_chunks"],
            "grouped_block_sparse_ragged_quant": 3 * L * run["ticks"],
            "paged_attention": L * run["ticks"],
            "rope_kv_write": L * (run["prefill_chunks"] + run["ticks"])}
    got = {k: v for k, v in run["launches"].items()
           if not k.endswith("_experts_computed")}
    if got != want:
        raise AssertionError(f"moe int8 continuous: launches "
                             f"{run['launches']}, expected {want}")
    if run["tokens"] != ref_run["tokens"]:
        raise AssertionError("moe int8 continuous: tokens differ from the "
                             "dequantised reference run's")
    run["expected_launches"] = want
    out["continuous"] = [{k: v for k, v in r.items()
                          if k not in ("tokens", "prompts")}
                         for r in (run, ref_run)]
    for r in out["continuous"]:
        log("moe_quant", **r)
    out["tokens_per_s"] = paired_tokens_per_s(loaded, device,
                                              MOE_QUANT_WAYS)
    log("moe_quant", tokens_per_s=out["tokens_per_s"])
    out["trace"] = [trace_decode(loaded, device, True, "int8"),
                    trace_decode(loaded, device, True, "none", quant="none")]
    for t in out["trace"]:
        log("trace", gpu=gpu, model=f"{MOE_ARCH} int8", **t)
    out["art"] = loaded
    return out


# ------------------------------------------------------------ SSM phases

def ssm_requests(vocab: int) -> list:
    """The ssm continuous run's traffic from seed 0: a 4096-token prompt
    (16 full chunks through a carried state), a 3000-token one (a padded
    last chunk), and PROMPT_RANGE prompts; NEW_RANGE new tokens each."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(0)
    lo, hi = PROMPT_RANGE
    lens = list(SSM_LONG_PROMPTS) + [
        int(rng.integers(lo, hi + 1))
        for _ in range(SSM_REQUESTS - len(SSM_LONG_PROMPTS))]
    return [Request(uid=uid, prompt=rng.integers(1, vocab, n).tolist(),
                    max_new_tokens=int(rng.integers(NEW_RANGE[0],
                                                    NEW_RANGE[1] + 1)))
            for uid, n in enumerate(lens)]


def ssm_serve_config(max_seq: int = SSM_MAX_SEQ, **kw):
    import torch
    from repro_torch.serve.config import ServeConfig
    return ServeConfig(max_seq=max_seq, compute_dtype=torch.float32,
                       cache_dtype=torch.float32, **kw)


def prefill_vs_recurrence(art, device) -> dict:
    """One SSM_CHECK_PROMPT-token prefill (kernel 10 in every Mamba
    layer) against stepping the same tokens one by one through the
    recurrence, which launches no kernel: last logits within LOGIT_ATOL,
    every layer's final state within STATE_RTOL x max|state|, the next
    greedy token equal."""
    import numpy as np
    import torch
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    eng = Engine.from_artifact(art, ssm_serve_config())
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, art.cfg.vocab, (1, SSM_CHECK_PROMPT)), device=device)
    V = art.cfg.vocab
    with torch.no_grad():
        counters.reset()
        pre = T.init_cache(eng.cfg, 1, SSM_CHECK_PROMPT, torch.float32,
                           device)
        lp, pre = eng._step(toks, pre, 0)
        sync(device)
        launches = counters.snapshot()
        step = T.init_cache(eng.cfg, 1, SSM_CHECK_PROMPT, torch.float32,
                            device)
        t0 = time.perf_counter()
        for i in range(SSM_CHECK_PROMPT):
            ls, step = eng._step(toks[:, i:i + 1], step, i)
        sync(device)
        step_s = time.perf_counter() - t0
    if launches != {"ssd_scan": art.cfg.n_layers} \
            or counters.snapshot() != launches:
        raise AssertionError(f"prefill launches {launches}, after the "
                             f"recurrence {counters.snapshot()}")
    logit_err = float((lp - ls).abs().max())
    state_err = max(
        float((a["mamba"]["state"] - b["mamba"]["state"]).abs().max())
        / max(float(b["mamba"]["state"].abs().max()), 1e-30)
        for a, b in zip(pre, step))
    tok_p, tok_s = int(lp[0, :V].argmax()), int(ls[0, :V].argmax())
    if not (logit_err <= LOGIT_ATOL and state_err <= STATE_RTOL
            and tok_p == tok_s):
        raise AssertionError(f"prefill vs recurrence: logits {logit_err}, "
                             f"states {state_err} x max, tokens {tok_p} vs "
                             f"{tok_s}")
    return {"prompt": SSM_CHECK_PROMPT, "launches": launches,
            "logits_max_abs_err": logit_err, "logit_atol": LOGIT_ATOL,
            "state_max_rel_err": state_err, "state_rtol": STATE_RTOL,
            "next_token": tok_p, "recurrence_s": step_s}


def compare_alone(art, device, run: dict) -> dict:
    """Each request's continuous tokens equal that request served alone
    by the static engine, up to a step where the static engine's top-2
    margin is within LOGIT_ATOL."""
    import torch
    from repro_torch.serve.engine import Engine
    eng = Engine.from_artifact(art, ssm_serve_config())
    parted = []
    for uid, got in sorted(run["tokens"].items()):
        prompt = run["prompts"][uid]
        toks, logits = eng.generate([prompt], len(got), return_logits=True)
        want = toks[0, len(prompt):].tolist()
        t = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if t is None:
            continue
        top2 = torch.topk(logits[t, 0, :art.cfg.vocab], 2).values
        margin = float(top2[0] - top2[1])
        if margin > LOGIT_ATOL:
            raise AssertionError(f"{run['label']}: uid {uid} parts from "
                                 f"the static engine at step {t} with "
                                 f"top-2 margin {margin}")
        parted.append({"uid": uid, "step": t, "margin": margin})
    return {"compared": len(run["tokens"]), "parted_at_near_ties": parted}


def hybrid_refusals(art) -> list:
    """The continuous engine refuses a paged pool and padded prefills
    for a model with Mamba layers."""
    from repro_torch.serve.batching import ContinuousEngine
    out = []
    for kw in ({"block_size": BLOCK_SIZE, "prefill_multiple": 1},
               {"prefill_multiple": 16}):
        serve = ssm_serve_config(-(-SSM_MAX_SEQ // BLOCK_SIZE) * BLOCK_SIZE,
                                 max_slots=MAX_SLOTS, **kw)
        try:
            ContinuousEngine.from_artifact(art, serve)
        except ValueError as e:
            out.append({"serve": kw, "raised": str(e)})
            continue
        raise AssertionError(f"the continuous engine took {kw} for an SSM "
                             f"model")
    return out


def capture_ssd_inputs(art, tokens, device) -> dict:
    """Layer 0's SSD scan inputs for ``tokens`` (B, L), as the mixer
    builds them: the scan entry point is wrapped for one call of layer 0
    alone (outside every counted run)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import layers as L
    from repro_torch.models import ssm
    caught = {}
    real = ops.ssd_scan

    def catch(xt, da, Bm, Cm, chunk, h0=None):
        caught.update(xt=xt, da=da, Bm=Bm, Cm=Cm, chunk=chunk)
        return real(xt, da, Bm, Cm, chunk, h0)

    bp = art.params["blocks"][0]
    ops.ssd_scan = catch
    try:
        with torch.no_grad():
            x = art.params["embed"]["table"][
                torch.as_tensor(tokens, device=device).long()]
            ssm.apply_mamba(bp["mamba"], art.cfg.layer(0).mixer,
                            L.apply_norm(bp["norm1"], art.cfg.norm, x))
    finally:
        ops.ssd_scan = real
    return caught


def _ssd_case(inp: dict, h0, dtype, label: str) -> dict:
    """Kernel 10 on layer 0's inputs (cast to ``dtype``; da stays f32)
    against its plain version: output and final state."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ref
    da, chunk = inp["da"], inp["chunk"]
    xt, Bm, Cm = (inp[k] if inp[k].dtype == dtype else inp[k].to(dtype)
                  for k in ("xt", "Bm", "Cm"))
    y, h = kernel.ssd_scan(xt, da, Bm, Cm, chunk, h0)
    y2, h2 = kernel.ssd_scan(xt, da, Bm, Cm, chunk, h0)
    y_p, h_p = ref.ssd_chunked(xt, da, Bm, Cm, chunk, h0)
    torch.cuda.synchronize()
    dname = str(dtype).replace("torch.", "")
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise AssertionError(f"ssd_scan {label} {dname}: two launches "
                             f"differ")
    err, tol = _check_close(f"ssd_scan {label}", y, y_p, dname)
    state_err, state_tol = _check_close(f"ssd_scan {label} state", h, h_p,
                                        dname)
    rel = _check_rel(f"ssd_scan {label}", y, y_p, dname)
    state_rel = _check_rel(f"ssd_scan {label} state", h, h_p, dname)
    del y_p, h_p, y2, h2
    B, L, H, P = xt.shape
    N = Bm.shape[2]
    Q = min(chunk, L)
    n_chunks = -(-L // Q)
    # what the function needs, over each chunk's real rows q: C Bᵀ once
    # per (sequence, chunk) (one group), then per head the masked scores
    # @ xt, the chunk's state and C @ state, and carrying the (P, N) state
    # into the next chunk; the two (i, j) products over i >= j only
    rows = [min(Q, L - c * Q) for c in range(n_chunks)]
    macs = sum(q * (q + 1) // 2 * (N + H * P) + H * (2 * q + 1) * N * P
               for q in rows)
    flops = 2.0 * B * macs
    n_bytes = (2 * B * L * H * P + 2 * B * L * N) * xt.element_size() \
        + 4 * B * L * H + 4 * B * H * P * N * (1 if h0 is None else 2)
    b_ms, b_by = bound_ms(n_bytes, flops, dname)

    def launch():
        return kernel.ssd_scan(xt, da, Bm, Cm, chunk, h0)

    rec = {
        "case": label, "B": B, "L": L, "H": H, "P": P, "N": N, "chunk": Q,
        "dtype": dname, "h0": h0 is not None, "max_abs_err": err,
        "tol": tol, "state_max_abs_err": state_err, "state_tol": state_tol,
        "rel_err": rel, "state_rel_err": state_rel, "bitwise_repeat": True,
        "ms": time_ms(launch, iters=10),
        "ms_first_design": FIRST_DESIGN_SSD_MS.get((label, dname)),
        "host_us": host_us(launch),
        "stage_ms": stage_ms(launch, r"ssd_[a-z]+_kernel", 4),
        "plain_ms": time_ms(lambda: ref.ssd_chunked(xt, da, Bm, Cm, chunk,
                                                    h0), iters=5),
        "library_ms": None,
        "library": "none: no one PyTorch call computes the chunked scan",
        "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
        "mbytes": n_bytes / 1e6,
    }
    first = rec["ms_first_design"]
    rec["speedup_vs_first_design"] = first / rec["ms"] if first else None
    return rec


def recurrence_ms(art, device) -> dict:
    """Device time of one decode step's recurrences (``ssm.ssd_step``) at
    the static trace's batch: every Mamba layer with its own state at its
    own head count, so the states stream from memory as in a step, and
    with the mixer's operand layouts (B and C strided slices of the conv
    output), under ``torch.profiler`` (kernel time only: CUDA events
    would also count the host's launch gaps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm
    gen = torch.Generator(device=device).manual_seed(9)
    layers = []
    for spec in art.cfg.layers():
        m = spec.mixer
        H, P, N, di = m.n_heads, m.head_dim, m.d_state, m.d_inner
        xbc = torch.randn((BATCH, 1, m.conv_dim), generator=gen,
                          device=device)
        layers.append((
            torch.randn((BATCH, H, P, N), generator=gen, device=device),
            -torch.rand((BATCH, 1, H), generator=gen, device=device)[:, 0],
            xbc[:, 0, di:di + N], xbc[:, 0, di + N:di + 2 * N],
            torch.randn((BATCH, 1, H, P), generator=gen, device=device)[:, 0]))

    def step() -> None:
        for args in layers:
            ssm.ssd_step(*args)

    step()
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_STEPS):
            step()
        sync(device)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in dev]) / 1e3 / TRACE_STEPS
    return {"device_ms_per_step": busy if dev else None,
            "layers": len(layers), "batch": BATCH}


def phase_ssm(device, gpu: str) -> dict:
    """mamba2-1.3b at full width and depth: prune with golden-smoke's
    recipe, bundle round trip, static and continuous serving through
    kernel 10, the prefill held to the recurrence, a decode trace and
    kernel 10 against its plain version."""
    import shutil
    import tempfile

    import torch
    from repro_torch.common.tree import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import counters
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import transformer as T
    from repro_torch.serve.sparse import flop_savings

    cfg = get_config(SSM_ARCH).replace(scan_layers=False)
    recipe = PruneRecipe.load(os.path.join(HERE, "recipes", SSM_RECIPE)
                              ).replace(arch=SSM_ARCH)
    L = cfg.n_layers
    log("ssm", arch=cfg.name, d_model=cfg.d_model, vocab=cfg.vocab,
        layer=str(cfg.layer(0)), depth=L, depth_cut="none",
        recipe=f"recipes/{SSM_RECIPE} with arch {SSM_ARCH}")
    c = recipe.calibration
    n_calib = len(SyntheticCorpus(cfg.vocab, seed=c.seed).calibration_batches(
        c.n_samples, c.batch_size, c.seq_len))
    counters.reset()
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    n_params = param_count(params)
    sync(device)
    init_s = time.perf_counter() - t0
    art = MosaicPipeline(recipe).run(params, cfg)
    del params
    torch.cuda.empty_cache()
    prune_launches = counters.snapshot()
    want = {"wanda_partials": 2 * len(projections(cfg)),
            "ssd_scan": L * n_calib}
    if prune_launches != want:
        raise AssertionError(f"ssm prune launches {prune_launches}, "
                             f"expected {want}")
    st = art.report["stage_seconds"]
    pk = art.report["pack"]
    out = {"gpu": gpu, "params": n_params, "init_s": init_s,
           "profile_s": st.get("rank"), "plan_s": st.get("plan"),
           "prune_s": st.get("prune"), "pack_s": st.get("pack"),
           "prune_launches": prune_launches, "expected_prune_launches": want,
           "params_before": art.report["params_before"],
           "params_after": art.report["params_after"],
           "heads_kept": [s.mixer.n_heads for s in art.cfg.layers()],
           "packed": sorted(f"{i}:{n}" for i, n in art.packed),
           "skipped": [f"{s['layer']}:{s['name']}" for s in pk["skipped"]],
           "n_packed": pk["n_packed"], "n_skipped": pk["n_skipped"],
           "flop_savings": flop_savings(art.packed)}
    log("ssm", **out)

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ssm-bundle-", dir=out_dir)
    try:
        loaded, out["bundle"] = bundle_round_trip(art, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del art
    torch.cuda.empty_cache()
    log("ssm", bundle=out["bundle"])

    runs = moe_static_runs(loaded, device, SSM_WAYS)
    expected = {name: {"ssd_scan": L} for name, _, _ in SSM_WAYS}
    check_static_runs(runs, expected)
    if not torch.equal(runs["sparse"]["logits"], runs["dense"]["logits"]):
        raise AssertionError("ssm: the sparse engine's logits differ from "
                             "the dense engine's (Mamba serves dense)")
    out["static"] = {name: {k: v for k, v in r.items()
                            if k not in ("tokens", "logits")}
                     for name, r in runs.items()}
    out["expected_launches"] = expected
    for name, r in out["static"].items():
        log("ssm", run=name, **r)
    out["prefill_vs_recurrence"] = prefill_vs_recurrence(loaded, device)
    log("ssm", prefill_vs_recurrence=out["prefill_vs_recurrence"])
    out["tokens_per_s"] = paired_tokens_per_s(loaded, device, SSM_WAYS)
    log("ssm", tokens_per_s=out["tokens_per_s"])

    reqs = ssm_requests(loaded.cfg.vocab)
    run = serve_continuous(loaded, device, "ssm-contiguous", reqs,
                           ssm_serve_config(max_slots=MAX_SLOTS,
                                            prefill_multiple=1))
    want = {"ssd_scan": L * len(reqs)}
    if run["launches"] != want or run["prefills"] != len(reqs):
        raise AssertionError(f"ssm continuous: launches {run['launches']}, "
                             f"expected {want}")
    run["expected_launches"] = want
    out["continuous_vs_static"] = compare_alone(loaded, device, run)
    out["continuous"] = {k: v for k, v in run.items()
                         if k not in ("tokens", "prompts")}
    out["refusals"] = hybrid_refusals(loaded)
    log("ssm", **out["continuous"])
    log("ssm", continuous_vs_static=out["continuous_vs_static"],
        refusals=out["refusals"])

    out["trace"] = trace_decode(loaded, device, True, "mamba2")
    out["recurrence"] = rec = recurrence_ms(loaded, device)
    busy = out["trace"].get("device_busy_ms")
    rec["share_of_device_busy"] = (
        rec["device_ms_per_step"] / busy
        if busy and rec["device_ms_per_step"] else None)
    log("trace", gpu=gpu, model=SSM_ARCH, recurrence=out["recurrence"],
        **out["trace"])

    t0 = time.perf_counter()
    out["prefill"] = ssm_prefill(loaded, device, reqs[0].prompt)
    out["prefill"]["phase_s"] = time.perf_counter() - t0
    log("ssm", prefill=out["prefill"])

    t0 = time.perf_counter()
    dtypes = (torch.float32, torch.bfloat16)
    long_in = capture_ssd_inputs(loaded, [reqs[0].prompt], device)
    cases = [_ssd_case(long_in, None, dtype,
                       f"layer0 prefill {SSM_LONG_PROMPTS[0]}")
             for dtype in dtypes]
    # the 4096-token prompt's final state carries into the 3000-token one
    _, h_long = ssd_kernel.ssd_scan(long_in["xt"], long_in["da"],
                                    long_in["Bm"], long_in["Cm"],
                                    long_in["chunk"])
    del long_in
    static_in = capture_ssd_inputs(loaded, prompts(loaded.cfg.vocab, 0),
                                   device)
    cases += [_ssd_case(static_in, None, dtype,
                        f"layer0 static prefill {BATCH}x{PROMPT_LEN}")
              for dtype in dtypes]
    carried_in = capture_ssd_inputs(loaded, [reqs[1].prompt], device)
    cases += [_ssd_case(carried_in, h_long, dtype, f"layer0 prefill "
                        f"{SSM_LONG_PROMPTS[1]} from a carried state")
              for dtype in dtypes]
    for case in cases:
        log("kernels", kernel="ssd_scan", **case)
    out["cases"] = cases
    out["cases_s"] = time.perf_counter() - t0
    return out


def ssm_prefill(art, device, prompt: list) -> dict:
    """One prompt (the 4096-token request), batch 1, through the static
    ``Engine`` in f32 on the pruned mamba2: one kernel-10 launch a layer,
    finite logits, the median wall time of SSM_PREFILL_REPEATS warm
    prefills, and one more under ``torch.profiler`` for device time by
    kernel class and kernel 10's share of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import counters
    from repro_torch.serve.engine import Engine
    eng = Engine.from_artifact(art, ssm_serve_config(
        max_seq=len(prompt) + 16), sparse=True)
    tokens = torch.as_tensor([prompt], device=device)
    counters.reset()
    _, logits = eng.generate(tokens, 1, return_logits=True)
    sync(device)
    launches = counters.snapshot()
    if launches != {"ssd_scan": art.cfg.n_layers}:
        raise AssertionError(f"ssm prefill launches {launches}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("ssm prefill: non-finite logits")
    times = []
    for _ in range(SSM_PREFILL_REPEATS):
        sync(device)
        t0 = time.perf_counter()
        eng.generate(tokens, 1)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(tokens, 1)
        sync(device)
    by_class: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = kernel_class(e.name)
            by_class[c] = by_class.get(c, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    total = sum(by_class.values())
    return {"prompt": len(prompt), "launches": launches,
            "prefill_ms": sorted(times)[len(times) // 2],
            "prefill_ms_all": times, "device_ms": total or None,
            "by_class_ms": dict(sorted(by_class.items(),
                                       key=lambda kv: -kv[1])),
            "ssd_scan_share": (by_class.get("ssd_scan", 0.0) / total
                               if total else None)}


def phase_hybrid(device, gpu: str) -> dict:
    """jamba-v0.1-52b at the JAX package's smoke size: attention, Mamba,
    MLP and MoE layers in one stack, pruned with the MoE recipe, served
    static and continuous (unpadded prefills) to equal tokens through
    kernels 10, 1, 6 and 7."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import MambaSpec, MLPSpec
    from repro_torch.serve.scheduler import Request
    from repro_torch.serve.sparse import (RAGGED_TOKENS_MAX,
                                          PackedExpertProjection)

    cfg = get_smoke_config(HYBRID_ARCH).replace(scan_layers=False)
    recipe = PruneRecipe.load(os.path.join(HERE, "recipes", MOE_RECIPE)
                              ).replace(arch=HYBRID_ARCH)
    c = recipe.calibration
    n_calib = len(SyntheticCorpus(cfg.vocab, seed=c.seed).calibration_batches(
        c.n_samples, c.batch_size, c.seq_len))
    n_mamba = sum(isinstance(s.mixer, MambaSpec) for s in cfg.layers())
    counters.reset()
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    art = MosaicPipeline(recipe).run(params, cfg)
    prune_launches = counters.snapshot()
    want = {"wanda_partials": 2 * len(projections(cfg)),
            "ssd_scan": n_mamba * n_calib}
    if prune_launches != want:
        raise AssertionError(f"hybrid prune launches {prune_launches}, "
                             f"expected {want}")
    n_stacks = sum(isinstance(p, PackedExpertProjection)
                   for p in art.packed.values())
    n_mlp = sum(1 for (i, name) in art.packed
                if isinstance(art.cfg.layer(i).ffn, MLPSpec)
                and name in ("gate", "up", "down"))
    runs = moe_static_runs(art, device, (("static", True, {}),))
    prefill_big = BATCH * PROMPT_LEN > RAGGED_TOKENS_MAX
    expected = {"static": {
        "ssd_scan": n_mamba, "block_sparse": n_mlp * NEW_TOKENS,
        "grouped_block_sparse": n_stacks * prefill_big,
        "grouped_block_sparse_ragged": n_stacks * (
            NEW_TOKENS - 1 + (not prefill_big))}}
    check_static_runs(runs, expected, art.cfg.layer(1).ffn.n_experts)

    import numpy as np
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u, prompt=rng.integers(
        1, cfg.vocab, int(rng.integers(17, 2 * RAGGED_TOKENS_MAX))).tolist(),
        max_new_tokens=int(rng.integers(8, 17)))
        for u in range(HYBRID_REQUESTS)]
    run = serve_continuous(art, device, "hybrid-contiguous", reqs,
                           ssm_serve_config(max_slots=MAX_SLOTS // 2,
                                            prefill_multiple=1))
    big = sum(len(r.prompt) > RAGGED_TOKENS_MAX for r in reqs)
    want = {"ssd_scan": n_mamba * len(reqs),
            "block_sparse": n_mlp * (len(reqs) + run["ticks"]),
            "grouped_block_sparse": n_stacks * big,
            "grouped_block_sparse_ragged": n_stacks * (
                len(reqs) - big + run["ticks"])}
    got = {k: v for k, v in run["launches"].items()
           if not k.endswith("_experts_computed")}
    if got != want:
        raise AssertionError(f"hybrid continuous: launches "
                             f"{run['launches']}, expected {want}")
    run["expected_launches"] = want
    out = {"gpu": gpu, "arch": cfg.name,
           "layers": [f"{type(s.mixer).__name__}+{type(s.ffn).__name__}"
                      for s in cfg.layers()],
           "prune_launches": prune_launches,
           "static": {k: v for k, v in runs["static"].items()
                      if k not in ("tokens", "logits")},
           "expected_launches": expected["static"],
           "continuous": {k: v for k, v in run.items()
                          if k not in ("tokens", "prompts")},
           "continuous_vs_static": compare_alone(art, device, run)}
    log("hybrid", **out)
    return out


# ------------------------------------------------------------ training

def train_full_width(arch: str, n_layers: int, steps: int, device) -> dict:
    """``steps`` Trainer steps of ``arch`` at full width and ``n_layers``
    layers: bf16 compute over f32 masters, remat, AdamW, on one batch of
    TRAIN_BATCH x TRAIN_SEQ tokens of the synthetic corpus, repeated. At
    a vocabulary of 128256 the corpus's tokens are close to uniform
    (every token has 20 random successors), so fresh batches cannot
    lower the loss in a few steps; on one batch the loss is measured on
    the same tokens at every step, and falls as the model fits them.
    Every loss and gradient norm finite and no kernel launched; the warm
    step ms (median of the steps after the first two, or the second of
    two), tokens/s, peak memory and, for a dense model, 6 * params *
    tokens a step over the bf16 peak."""
    import torch
    from repro_torch.common.tree import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import counters
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer

    full = get_config(arch)
    cfg = full.replace(n_periods=n_layers // len(full.pattern), remat=True)
    grad_norms, auxes = [], []

    def record(step, m):
        grad_norms.append(float(m["grad_norm"]))
        auxes.append(float(m["aux"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(
        cfg, OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=steps),
        itertools.repeat(next(SyntheticCorpus(cfg.vocab, seed=0).batches(
            TRAIN_BATCH, TRAIN_SEQ)), steps),
        compute_dtype=torch.bfloat16, log_fn=record, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = param_count(trainer.state["params"])
    counters.reset()
    try:
        rep = trainer.run(steps)
    finally:
        trainer.preemption.uninstall()
    launches = counters.snapshot()
    peak = torch.cuda.max_memory_allocated(device)
    del trainer
    torch.cuda.empty_cache()
    losses = rep.losses
    if rep.steps_run != steps or not all(
            math.isfinite(x) for x in losses + grad_norms + auxes):
        raise AssertionError(f"{arch}: {rep.steps_run} steps, losses "
                             f"{losses}, grad norms {grad_norms}")
    if launches:
        raise AssertionError(f"{arch}: train steps launched {launches}")
    warm = sorted(rep.step_seconds[min(2, steps - 1):])
    step_s = warm[len(warm) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"arch": arch, "layers": cfg.n_layers,
           "depth_cut": f"n_periods {full.n_periods} -> {cfg.n_periods}",
           "params": n_params, "steps": steps, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "losses": losses, "grad_norms": grad_norms,
           "aux": auxes, "launches": launches, "init_s": init_s,
           "step_s": rep.step_seconds, "warm_step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "max_memory_allocated": peak,
           "loss_fell": losses[-1] < losses[0]}
    if full.arch_class == "dense":
        flops = 6 * n_params * tokens
        out["model_flops_per_s"] = flops / step_s
        out["bf16_peak_share"] = flops / step_s / PEAK_OPS["bfloat16"]
    return out


def _timed_ms(fn, device) -> tuple:
    """(fn's result, host ms of a second call ending in a sync); the
    first call warms caches (and DTensor's sharding propagation)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _held(label: str, got, want, launches: dict, plain: dict,
          kernel: str) -> dict:
    """Sharded logits ``got`` (a DTensor) against the unsharded ``want``:
    within LOGIT_ATOL, the same argmax, the same non-zero launch count
    of ``kernel``."""
    import torch
    got = got.full_tensor()
    err = (got.float() - want.float()).abs().max().item()
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if not (err <= LOGIT_ATOL and same and plain.get(kernel, 0) > 0
            and launches == plain):
        raise AssertionError(f"distributed {label}: max err {err}, argmax "
                             f"equal {same}, launches {launches} vs "
                             f"{plain}")
    return {"max_abs_err": err, "argmax_equal": same, "launches": launches}


def _dist_llama(mesh, device) -> dict:
    """Full-width llama3-8b at DIST_LLAMA_LAYERS layers, f32: a
    LONG_PROMPT forward, then a prefill and one decode step on a
    contiguous cache, each sharded and unsharded."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import axes as AX
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    f32 = torch.float32
    cfg = get_config("llama3-8b").replace(n_periods=DIST_LLAMA_LAYERS,
                                          scan_layers=False)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_model(gen, cfg)
    prompt = torch.randint(0, cfg.vocab, (1, LONG_PROMPT), generator=gen,
                           device=device)
    sp = SH.shard_params(params, mesh, cfg)
    stoks = SH.shard_inputs(prompt, mesh)
    out = {"layers": cfg.n_layers, "prompt": LONG_PROMPT}
    with torch.no_grad():
        counters.reset()
        ref = T.forward(params, cfg, prompt, compute_dtype=f32)[0]
        plain = counters.snapshot()

        def sharded():
            with AX.use_mesh(mesh):
                return T.forward(sp, cfg, stoks, compute_dtype=f32)[0]
        counters.reset()
        lo = sharded()
        launches = counters.snapshot()
        out["forward"] = _held("llama forward", lo, ref, launches, plain,
                               "flash_attention")
        del lo
        _, out["plain_forward_ms"] = _timed_ms(
            lambda: T.forward(params, cfg, prompt, compute_dtype=f32)[0],
            device)
        _, out["sharded_forward_ms"] = _timed_ms(sharded, device)
        del ref
        torch.cuda.empty_cache()

        s_max = LONG_PROMPT + 8
        nxt = prompt[:, -1:]
        counters.reset()
        cache = T.init_cache(cfg, 1, s_max, f32, device)
        make_prefill_step(cfg, f32)(params, prompt, cache)
        ref = make_serve_step(cfg, f32)(params, cache, nxt, LONG_PROMPT)[0]
        plain = counters.snapshot()
        del cache
        counters.reset()
        scache = SH.shard_cache(T.init_cache(cfg, 1, s_max, f32, device),
                                mesh, cfg, 1)
        with AX.use_mesh(mesh):
            make_prefill_step(cfg, f32)(sp, stoks, scache)
            lo = make_serve_step(cfg, f32)(
                sp, scache, SH.shard_inputs(nxt, mesh), LONG_PROMPT)[0]
        launches = counters.snapshot()
        out["decode"] = _held("llama decode", lo, ref, launches, plain,
                              "flash_attention")
        out["cache_placements"] = str(scache[0]["attn"]["k"].placements)
    return out


def _dist_mamba(mesh, device) -> dict:
    """Full-width mamba2-1.3b at DIST_SSM_LAYERS layers, f32: a
    SSM_CHECK_PROMPT-token prefill (kernel 10), sharded and unsharded."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import axes as AX
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_prefill_step
    f32 = torch.float32
    cfg = get_config("mamba2-1.3b").replace(n_periods=DIST_SSM_LAYERS,
                                            scan_layers=False)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_model(gen, cfg)
    prompt = torch.randint(0, cfg.vocab, (1, SSM_CHECK_PROMPT),
                           generator=gen, device=device)
    step = make_prefill_step(cfg, f32)
    with torch.no_grad():
        counters.reset()
        ref, _ = step(params, prompt,
                      T.init_cache(cfg, 1, SSM_CHECK_PROMPT, f32, device))
        plain = counters.snapshot()
        sp = SH.shard_params(params, mesh, cfg)

        def sharded():
            cache = SH.shard_cache(
                T.init_cache(cfg, 1, SSM_CHECK_PROMPT, f32, device), mesh,
                cfg, 1)
            with AX.use_mesh(mesh):
                return step(sp, SH.shard_inputs(prompt, mesh), cache)[0]
        counters.reset()
        lo = sharded()
        launches = counters.snapshot()
        out = {"layers": cfg.n_layers, "prompt": SSM_CHECK_PROMPT,
               "prefill": _held("mamba prefill", lo, ref, launches, plain,
                                "ssd_scan")}
        _, out["plain_prefill_ms"] = _timed_ms(
            lambda: step(params, prompt, T.init_cache(
                cfg, 1, SSM_CHECK_PROMPT, f32, device))[0], device)
        _, out["sharded_prefill_ms"] = _timed_ms(sharded, device)
    return out


def _dist_train(mesh, device, directory: str) -> dict:
    """DIST_TRAIN_STEPS Trainer steps of llama3-8b (DIST_LLAMA_LAYERS
    layers, bf16 over f32 masters) unsharded, then sharded on ``mesh``:
    losses within DIST_LOSS_RTOL; the sharded params' checkpoint round
    trip bitwise. Then the same pair with a factored second moment and
    bf16 momentum (the dry-run's nemotron-4-340b train cell's optimizer):
    losses within DIST_LOSS_RTOL, and the sharded run's whole state
    (params, m, v's row, col and full) round-tripping a checkpoint
    bitwise. No kernel launches in either pair."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.tree import iter_paths, tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.distributed.axes import full
    from repro_torch.kernels import counters
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer
    cfg = get_config("llama3-8b").replace(n_periods=DIST_LLAMA_LAYERS,
                                          scan_layers=False, remat=True)
    batch = next(SyntheticCorpus(cfg.vocab, seed=0).batches(
        DIST_TRAIN_BATCH, DIST_TRAIN_SEQ))

    def pair(opt_cfg):
        """The Trainer unsharded, then on ``mesh``: (reports, the sharded
        Trainer, seconds)."""
        t0 = time.perf_counter()
        reports = {}
        for name, m in (("plain", None), ("sharded", mesh)):
            tr = Trainer(cfg, opt_cfg,
                         itertools.repeat(batch, DIST_TRAIN_STEPS),
                         compute_dtype=torch.bfloat16, device=device,
                         mesh=m, prefetch=False)
            try:
                reports[name] = tr.run(DIST_TRAIN_STEPS)
            finally:
                tr.preemption.uninstall()
            if m is None:
                del tr
                torch.cuda.empty_cache()
        lp, ls = reports["plain"].losses, reports["sharded"].losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lp))
        if len(ls) != DIST_TRAIN_STEPS or not rel <= DIST_LOSS_RTOL:
            raise AssertionError(f"sharded losses {ls} vs {lp} "
                                 f"({opt_cfg})")
        return reports, tr, rel, time.perf_counter() - t0

    def round_trip(tree, where):
        """(seconds, bytes) of ``tree`` saved and restored; raises unless
        every leaf comes back bitwise."""
        t0 = time.perf_counter()
        mgr = CheckpointManager(where)
        mgr.save(DIST_TRAIN_STEPS, tree, blocking=True)
        like = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), tree)
        back = mgr.restore(like, device=device)
        got = dict(iter_paths(back))
        if not all(got[p].dtype == x.dtype and torch.equal(got[p], full(x))
                   for p, x in iter_paths(tree)):
            raise AssertionError(f"sharded checkpoint round trip of "
                                 f"{where} not bitwise")
        nbytes = sum(x.numel() * x.element_size() for x in got.values())
        shutil.rmtree(where, ignore_errors=True)
        return time.perf_counter() - t0, nbytes

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for _, x in iter_paths(tree))
    base = dict(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                total_steps=DIST_TRAIN_STEPS)
    out = {"layers": cfg.n_layers, "steps": DIST_TRAIN_STEPS,
           "batch": DIST_TRAIN_BATCH, "seq": DIST_TRAIN_SEQ}
    counters.reset()
    reports, tr, rel, out["pair_s"] = pair(OptConfig(**base))
    out.update(plain_losses=reports["plain"].losses,
               sharded_losses=reports["sharded"].losses, loss_rel_err=rel,
               plain_step_ms=[t * 1e3 for t in reports["plain"].step_seconds],
               sharded_step_ms=[t * 1e3
                                for t in reports["sharded"].step_seconds],
               v_bytes=nbytes(tr.state["opt"]["v"]))
    out["checkpoint_s"], out["checkpoint_bytes"] = round_trip(
        tr.state["params"], directory)
    del tr
    torch.cuda.empty_cache()
    factored = OptConfig(**base, factored=True, m_dtype="bfloat16")
    reports, tr, rel, out["factored_pair_s"] = pair(factored)
    if counters.snapshot():
        raise AssertionError(f"train steps launched {counters.snapshot()}")
    v = tr.state["opt"]["v"]
    kinds = {p[-1] for p, _ in iter_paths(v)}
    if kinds != {"row", "col", "full"}:
        raise AssertionError(f"factored v holds {kinds}")
    out.update(factored_plain_losses=reports["plain"].losses,
               factored_sharded_losses=reports["sharded"].losses,
               factored_loss_rel_err=rel,
               factored_sharded_step_ms=[
                   t * 1e3 for t in reports["sharded"].step_seconds],
               factored_v_bytes=nbytes(v),
               factored_m_bytes=nbytes(tr.state["opt"]["m"]))
    out["factored_checkpoint_s"], out["factored_checkpoint_bytes"] = \
        round_trip(tr.state, directory + "_factored")
    return out


def _dist_compression(mesh, device) -> dict:
    """``compressed_all_reduce`` over the mesh's one-rank 'data' group on
    NCCL, two steps with error feedback, bitwise equal to
    ``compress_tree``'s dequantised payload and residual."""
    import torch
    from repro_torch.distributed.compression import (compress_tree,
                                                     compressed_all_reduce,
                                                     dequantize_int8)
    gen = torch.Generator(device=device).manual_seed(0)
    grads = [{"w": torch.randn(4096, 4096, generator=gen, device=device),
              "b": torch.randn(14336, generator=gen, device=device)}
             for _ in range(2)]
    e_red = e_ref = None
    for g in grads:
        red, e_red = compressed_all_reduce(g, mesh, "data", e_red)
        q, s, e_ref = compress_tree(g, e_ref)
        for k in g:
            if not (torch.equal(red[k], dequantize_int8(q[k], s[k]))
                    and torch.equal(e_red[k], e_ref[k])):
                raise AssertionError(f"compressed all-reduce {k} differs "
                                     f"from compress_tree")
    return {"bitwise": True, "leaves": 2, "steps": 2}


def phase_distributed(device, gpu: str) -> dict:
    """The distribution layer on one card (NCCL at world size 1)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_distributed(device)
    try:
        mesh = make_host_mesh()
        out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        out["llama"] = _dist_llama(mesh, device)
        torch.cuda.empty_cache()
        out["mamba"] = _dist_mamba(mesh, device)
        torch.cuda.empty_cache()
        out["train"] = _dist_train(mesh, device, os.path.join(
            HERE, "chiprun_out", "dist_ckpt"))
        torch.cuda.empty_cache()
        out["compression"] = _dist_compression(mesh, device)
    finally:
        dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    log("distributed", gpu=gpu, phase_s=out["phase_s"],
        max_memory_allocated=out["max_memory_allocated"],
        mesh=out["mesh"], backend=out["backend"],
        llama_forward=out["llama"]["forward"],
        llama_decode=out["llama"]["decode"],
        plain_forward_ms=out["llama"]["plain_forward_ms"],
        sharded_forward_ms=out["llama"]["sharded_forward_ms"],
        mamba_prefill=out["mamba"]["prefill"],
        plain_prefill_ms=out["mamba"]["plain_prefill_ms"],
        sharded_prefill_ms=out["mamba"]["sharded_prefill_ms"],
        train_losses=[out["train"]["plain_losses"],
                      out["train"]["sharded_losses"]],
        plain_step_ms=out["train"]["plain_step_ms"],
        sharded_step_ms=out["train"]["sharded_step_ms"],
        checkpoint_s=out["train"]["checkpoint_s"],
        train_pair_s=out["train"]["pair_s"],
        factored_losses=[out["train"]["factored_plain_losses"],
                         out["train"]["factored_sharded_losses"]],
        v_bytes=out["train"]["v_bytes"],
        factored_v_bytes=out["train"]["factored_v_bytes"],
        factored_pair_s=out["train"]["factored_pair_s"],
        factored_checkpoint_s=out["train"]["factored_checkpoint_s"],
        compression=out["compression"])
    return out


def small_train_config():
    """tests/conftest.py::small_config(vocab=256), rebuilt here: two
    llama-style layers, d 64, 4 q / 2 kv heads of 16, d_ff 128."""
    from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                          ModelConfig)
    return ModelConfig(
        name="test", d_model=64, vocab=256, vocab_pad_multiple=16,
        pattern=(LayerSpec(AttentionSpec(n_q=4, n_kv=2, head_dim=16),
                           MLPSpec(d_ff=128)),),
        n_periods=2, scan_layers=False, remat=False)


def train_with_resume(cfg, device, directory: str) -> dict:
    """``launch/train.py`` on ``cfg`` three ways: uninterrupted; stopped at
    TRAIN_STOP through ``PreemptionHandler.trigger()``; resumed from that
    run's checkpoint. The resumed steps' losses are held to the
    uninterrupted run's within RESUME_RTOL. Returns the losses, the
    seconds and the uninterrupted run's final params (read back from
    its last checkpoint)."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import counters
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as T

    shutil.rmtree(directory, ignore_errors=True)    # start from step 0
    full_dir = os.path.join(directory, "uninterrupted")
    stop_dir = os.path.join(directory, "preempted")
    argv = SMALL_TRAIN_ARGV + ["--device", str(device)]
    counters.reset()
    t0 = time.perf_counter()
    full = train_launch.main(argv + ["--ckpt-dir", full_dir], cfg=cfg)
    full_s = time.perf_counter() - t0
    args = train_launch.build_parser().parse_args(
        argv + ["--ckpt-dir", stop_dir])
    trainer, n_steps = train_launch.make_trainer(args, cfg)
    log_step = trainer.log_fn

    def stop_at(step, metrics):
        log_step(step, metrics)
        if step == TRAIN_STOP:
            trainer.preemption.trigger()
    trainer.log_fn = stop_at
    try:
        first = trainer.run(n_steps)
    finally:
        trainer.preemption.uninstall()
    del trainer
    saved = CheckpointManager(stop_dir).latest_step()
    resumed = train_launch.main(argv + ["--ckpt-dir", stop_dir], cfg=cfg)
    launches = counters.snapshot()
    if not (first.preempted and first.final_step == TRAIN_STOP
            and saved == TRAIN_STOP and resumed.final_step == full.final_step
            and resumed.steps_run == full.final_step - TRAIN_STOP):
        raise AssertionError(f"preempted at {first.final_step} "
                             f"({first.preempted}), resumed "
                             f"{resumed.steps_run} steps to "
                             f"{resumed.final_step}")
    if launches:
        raise AssertionError(f"training launched {launches}")
    pairs = list(zip(first.losses + resumed.losses, full.losses))
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    if len(pairs) != full.final_step or rel > RESUME_RTOL:
        raise AssertionError(f"resumed losses part from the uninterrupted "
                             f"run's by {rel} > {RESUME_RTOL}")
    if not full.losses[-1] < full.losses[0]:
        raise AssertionError(f"loss did not fall: {full.losses}")
    params = CheckpointManager(full_dir).restore(
        {"params": T.init_model(None, cfg)}, device=device)["params"]
    shutil.rmtree(directory, ignore_errors=True)
    return {"params": params, "losses": full.losses,
            "resumed_losses": resumed.losses,
            "resume_max_rel_diff": rel, "uninterrupted_s": full_s,
            "step_s": full.step_seconds,
            "stragglers": len(full.stragglers)}


def trained_model_quality(params, cfg, device) -> dict:
    """tests/test_system.py on the card: base ppl; ranking (kernel 2) and
    the three categories at p 0.3 with its ordering and slack; the
    composite model served sparse (kernel 1) and dense; LoRA recovery of
    an unstructured p 0.5 model."""
    import torch
    from repro_torch.core import lora as LO
    from repro_torch.core.evaluate import perplexity
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.rank_controller import profile_model
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine
    from repro_torch.train import optimizer as OPT
    from repro_torch.train.train_step import value_and_grad

    corpus = SyntheticCorpus(cfg.vocab, seed=0)

    def ppl(p, c) -> float:
        return perplexity(p, c, corpus.batches(8, 64, start=500, n=4))

    out = {"ppl": {"base": ppl(params, cfg)}}
    if not out["ppl"]["base"] < TRAINED_PPL_MAX:
        raise AssertionError(f"base ppl {out['ppl']['base']}")
    counters.reset()
    art = profile_model(params, cfg, corpus.calibration_batches(8, 4, 64))
    out["rank_launches"] = counters.snapshot()
    want = {"wanda_partials": 2 * len(projections(cfg))}
    if out["rank_launches"] != want:
        raise AssertionError(f"ranking launched {out['rank_launches']}, "
                             f"expected {want}")
    served = None
    for cat in ("unstructured", "composite", "structured"):
        recipe = PruneRecipe(arch=cfg.name, p=0.3, category=cat,
                             align_channels=16, block=16,
                             stages=("plan", "prune", "pack", "report"))
        res = MosaicPipeline(recipe).run(params, cfg, rank_artifact=art)
        out["ppl"][cat] = ppl(res.params, res.cfg)
        if cat == "composite":
            served = res
    p = out["ppl"]
    if not (p["unstructured"] <= ORDER_SLACK * p["composite"]
            and p["composite"] <= ORDER_SLACK * p["structured"]
            and all(math.isfinite(v) for v in p.values())):
        raise AssertionError(f"ppl ordering broken: {p}")

    from repro_torch.serve.config import ServeConfig
    serve = ServeConfig(max_seq=64, compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    prompt = corpus.batch(900, BATCH, PROMPT_LEN)[:, :PROMPT_LEN]
    gens = {}
    for name, sparse in (("sparse", True), ("dense", False)):
        counters.reset()
        toks, logits = Engine.from_artifact(served, serve, sparse=sparse
                                            ).generate(prompt, PROMPT_LEN,
                                                       return_logits=True)
        gens[name] = (toks, logits, counters.snapshot())
    n_plans = sum(1 for (_, name) in served.packed
                  if name in ("gate", "up", "down"))
    if gens["sparse"][2] != {"block_sparse": n_plans * PROMPT_LEN} \
            or gens["dense"][2] or n_plans == 0:
        raise AssertionError(f"serve launches {gens['sparse'][2]} / "
                             f"{gens['dense'][2]}, {n_plans} plans")
    out["served"] = {"plans": n_plans, "launches": gens["sparse"][2],
                     **compare_generation(
                         gens["sparse"][0], gens["sparse"][1],
                         gens["dense"][0], gens["dense"][1], PROMPT_LEN,
                         LOGIT_ATOL)}

    art = profile_model(params, cfg, corpus.calibration_batches(4, 4, 32))
    res = MosaicPipeline(PruneRecipe(
        arch=cfg.name, p=0.5, category="unstructured", block=16,
        stages=("plan", "prune", "report"))).run(params, cfg,
                                                 rank_artifact=art)
    out["ppl"]["unstructured_p0.5"] = ppl(res.params, res.cfg)
    adapters = LO.init_lora(torch.Generator(device=device).manual_seed(1),
                            res.params, res.cfg, rank=4)
    grad = value_and_grad(lambda ad, t, lb: T.loss_fn(
        LO.merge_lora(res.params, res.cfg, ad, rank=4), res.cfg, t, lb,
        compute_dtype=torch.float32))
    ocfg = OPT.OptConfig(lr=5e-3, warmup_steps=5, total_steps=60,
                         weight_decay=0.0)
    ostate = OPT.init_opt(adapters, ocfg)
    counters.reset()
    for tokens, labels in corpus.batches(16, 64, start=200, n=40):
        _, g = grad(adapters, torch.from_numpy(tokens).to(device),
                    torch.from_numpy(labels).to(device))
        adapters, ostate, _ = OPT.apply_updates(adapters, g, ostate, ocfg)
    if counters.snapshot():
        raise AssertionError(f"LoRA steps launched {counters.snapshot()}")
    out["ppl"]["lora_recovered_p0.5"] = ppl(
        LO.merge_lora(res.params, res.cfg, adapters, rank=4), res.cfg)
    if not out["ppl"]["lora_recovered_p0.5"] < out["ppl"][
            "unstructured_p0.5"]:
        raise AssertionError(f"LoRA did not recover: {out['ppl']}")
    return out


def phase_train(device, gpu: str) -> dict:
    """The training path at full width, then the first trained model."""
    import torch
    t0 = time.perf_counter()
    full = []
    for arch, n_layers, steps in TRAIN_FULL:
        rec = train_full_width(arch, n_layers, steps, device)
        log("train", gpu=gpu, **rec)
        full.append(rec)
    if not full[0]["loss_fell"]:
        raise AssertionError(f"{full[0]['arch']}: loss did not fall: "
                             f"{full[0]['losses']}")
    full_s = time.perf_counter() - t0
    cfg = small_train_config()
    t1 = time.perf_counter()
    run = train_with_resume(cfg, device, os.path.join(
        HERE, "chiprun_out", "train_ckpt"))
    quality = trained_model_quality(run.pop("params"), cfg, device)
    small = {"arch": "small llama-style (tests/conftest.py::small_config)",
             "steps": len(run["losses"]), "stop_at": TRAIN_STOP, **run,
             **quality, "phase_s": time.perf_counter() - t1}
    log("train", gpu=gpu, trained_model={
        k: v for k, v in small.items()
        if k not in ("losses", "resumed_losses", "step_s")},
        first_losses=small["losses"][:3], last_losses=small["losses"][-3:],
        median_step_ms=1e3 * sorted(small["step_s"])[len(small["step_s"])
                                                     // 2])
    print("[train] ppl " + json.dumps(small["ppl"]), flush=True)
    torch.cuda.empty_cache()
    return {"gpu": gpu, "full_width": full, "full_width_s": full_s,
            "trained": small, "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------- gateway phase

GATEWAY_SAMPLED = (2, 3, 4, 5)     # uids sent with a temperature and a seed
GATEWAY_BUFFERED = (3, 6, 7, 8)    # uids sent with "stream": false
GATEWAY_TEMPERATURE = 0.8
GATEWAY_SEND_GAP_S = 0.02          # sends in uid order, so uids match


def gateway_requests(vocab: int) -> list:
    """The continuous phase's 12 requests, four of them sampled at
    GATEWAY_TEMPERATURE with their own seed."""
    import dataclasses
    return [dataclasses.replace(r, temperature=GATEWAY_TEMPERATURE,
                                seed=1000 + r.uid)
            if r.uid in GATEWAY_SAMPLED else r
            for r in continuous_requests(vocab)]


async def _http(port: int, request: bytes, on_line=None) -> tuple:
    """One request to the gateway on 127.0.0.1; returns (status, body
    lines). ``on_line(line)`` sees each body line as it arrives."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(request)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    lines = []
    while True:
        line = await reader.readline()
        if not line:
            break
        if line.strip():
            lines.append(line)
            if on_line is not None:
                on_line(line)
    writer.close()
    await writer.wait_closed()
    return int(head.split(b" ", 2)[1]), lines


def _post_generate(body: dict) -> bytes:
    payload = json.dumps(body).encode()
    return (b"POST /generate HTTP/1.1\r\nHost: chip-smoke\r\n"
            b"Content-Length: %d\r\n\r\n" % len(payload) + payload)


def serve_gateway(art, device, reqs: list, serve) -> dict:
    """``reqs`` over HTTP through a ``Gateway`` on 127.0.0.1 (an
    ephemeral port) over a ``ContinuousEngine`` on ``serve``: sent in uid
    order GATEWAY_SEND_GAP_S apart, the GATEWAY_BUFFERED ones with
    ``"stream": false``. Checks /healthz and /metrics; returns each
    request's tokens, time to first token (streamed ones), the launches
    while serving and the engine's stats."""
    import asyncio
    from repro_torch.kernels import counters
    from repro_torch.serve.batching import ContinuousEngine
    from repro_torch.serve.gateway import Gateway

    engine = ContinuousEngine.from_artifact(art, serve)

    async def go():
        gw = await Gateway(engine, host="127.0.0.1", port=0).start()
        status, lines = await _http(gw.port, b"GET /healthz HTTP/1.1\r\n\r\n")
        if status != 200 or json.loads(lines[0]) != {"status": "ok"}:
            raise AssertionError(f"gateway /healthz: {status} {lines}")
        first: dict = {}
        sent: dict = {}

        async def one(r):
            body = {"tokens": r.prompt, "max_new_tokens": r.max_new_tokens}
            if r.prefix_id is not None:
                body["prefix_id"] = r.prefix_id
            if r.temperature is not None:
                body.update(temperature=r.temperature, seed=r.seed)
            if r.uid in GATEWAY_BUFFERED:
                body["stream"] = False
            await asyncio.sleep(r.uid * GATEWAY_SEND_GAP_S)
            sent[r.uid] = time.perf_counter()

            def on_line(line):
                first.setdefault(r.uid, time.perf_counter())
            return await _http(gw.port, _post_generate(body), on_line)

        t0 = time.perf_counter()
        results = await asyncio.gather(*[one(r) for r in reqs])
        wall = time.perf_counter() - t0
        status, lines = await _http(gw.port, b"GET /metrics HTTP/1.1\r\n\r\n")
        metrics = json.loads(lines[0])
        fin, stats = await gw.close()
        return results, wall, metrics, fin, stats, first, sent

    sync(device)
    counters.reset()
    results, wall, metrics, fin, stats, first, sent = asyncio.run(go())
    sync(device)
    launches = counters.snapshot()
    out = {"tokens": {}, "ttft_ms": {}, "stage_ms": {}, "shared": {}}
    for r, (status, lines) in zip(reqs, results):
        events = [json.loads(ln) for ln in lines]
        done = events[-1]
        if status != 200 or done["event"] != "done":
            raise AssertionError(f"gateway uid {r.uid}: HTTP {status}, "
                                 f"last event {done}")
        if done["uid"] != r.uid:
            raise AssertionError(f"gateway: request {r.uid} got uid "
                                 f"{done['uid']} (sent out of order)")
        toks = done["tokens"]
        if r.uid not in GATEWAY_BUFFERED:
            streamed = [e["token"] for e in events if e["event"] == "token"]
            if streamed != toks:
                raise AssertionError(f"gateway uid {r.uid}: the stream "
                                     f"disagrees with its done event")
            out["ttft_ms"][r.uid] = (first[r.uid] - sent[r.uid]) * 1e3
        elif len(events) != 1:
            raise AssertionError(f"gateway uid {r.uid}: a buffered reply "
                                 f"of {len(events)} events")
        out["tokens"][r.uid] = toks
        out["stage_ms"][r.uid] = done["metrics"]
        out["shared"][r.uid] = done["prompt_blocks_shared"]
    counts = metrics["metrics"]["counters"]
    if counts.get("requests.finished") != len(reqs) \
            or metrics["stats"].get("finished") != len(reqs) \
            or metrics["stats"].get("in_flight") != 0:
        raise AssertionError(f"gateway /metrics: {metrics['stats']}, "
                             f"{counts}")
    if len(fin) != len(reqs) or stats.rejected:
        raise AssertionError(f"gateway: {len(fin)} finished, "
                             f"{stats.reject_reasons} rejected")
    n_tok = sum(len(t) for t in out["tokens"].values())
    out.update(launches=launches, wall_s=wall, generated_tokens=n_tok,
               tokens_per_s=n_tok / wall, stats=stats.to_dict(),
               metrics_counters=counts)
    return out


def phase_gateway(main: dict, device) -> dict:
    """The HTTP front door over the continuous engine's paged pool (the
    paged-attention kernel at decode) on the main phase's pruned llama3-8b
    (4 layers, full width): the 12 continuous requests over HTTP, eight
    streamed and four buffered, four sampled with their own seed; every
    request's tokens equal the same requests through
    ``ContinuousEngine.run`` on the same configuration (greedy and the
    seeded counter-based sampler alike). Time to first token and
    tokens/s over HTTP beside ``run``'s: recorded, not gated."""
    import torch
    from repro_torch.serve.batching import ContinuousEngine
    from repro_torch.serve.metrics import stage_latencies_ms
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    art = main["art"]
    serve = continuous_config(block_size=BLOCK_SIZE,
                              prefill_chunk=PREFILL_CHUNK, paged_kernel=True)
    reqs = gateway_requests(art.cfg.vocab)
    fin, stats = ContinuousEngine.from_artifact(art, serve).run(reqs)
    sync(device)
    direct = {f.request.uid: f for f in fin}
    if sorted(direct) != [r.uid for r in reqs] or stats.rejected:
        raise AssertionError(f"gateway's direct run: {stats.to_dict()}")
    gw = serve_gateway(art, device, reqs, serve)
    bad = [u for u, f in direct.items() if gw["tokens"][u] != f.tokens]
    if bad:
        raise AssertionError(f"gateway tokens differ from run's for uids "
                             f"{bad} (prompt blocks shared: http "
                             f"{gw['shared']}, run "
                             f"{ {u: f.prompt_blocks_shared for u, f in direct.items()} })")
    L = art.cfg.n_layers
    ffn_packed = sum(1 for (_, name) in art.packed
                     if name in ("gate", "up", "down"))
    st = gw["stats"]
    want = {"block_sparse": ffn_packed * (st["prefill_chunks"]
                                          + st["ticks"]),
            "paged_attention": L * st["ticks"],
            "rope_kv_write": L * (st["prefill_chunks"] + st["ticks"])}
    expect_launches("gateway", gw["launches"], want)
    run_ttft = {}
    for u, f in direct.items():
        ms = stage_latencies_ms(f)
        run_ttft[u] = ms["queue_ms"] + ms["prefill_ms"]
    out = {"requests": len(reqs), "streamed": len(reqs) - len(
               GATEWAY_BUFFERED), "buffered": len(GATEWAY_BUFFERED),
           "sampled": len(GATEWAY_SAMPLED), "tokens_equal_run": True,
           "launches": gw["launches"], "expected_launches": want,
           "http_wall_s": gw["wall_s"],
           "http_tokens_per_s": gw["tokens_per_s"],
           "run_wall_s": stats.wall_s,
           "run_tokens_per_s": stats.tokens_per_s,
           "http_ttft_ms": gw["ttft_ms"], "run_ttft_ms": run_ttft,
           "http_stage_ms": gw["stage_ms"],
           "prompt_blocks_shared": gw["shared"],
           "run_prompt_blocks_shared": {
               u: f.prompt_blocks_shared for u, f in direct.items()},
           "http_stats": st,
           "max_memory_allocated": torch.cuda.max_memory_allocated(device),
           "phase_s": time.perf_counter() - t0}
    log("gateway", **out)
    return out


# ------------------------------------------- the registry's other archs

# The seven architectures of the registry beside the main path's, the MoE
# phase's and the SSM phases': (arch, layers on the card). Widths as
# published; depth cut to fit one card and the run's time (the bundle
# round trip, 3-5 s a GB, takes most of a phase); random weights from
# seed 0, f32 but where ARCH_PARAMS_DTYPE says otherwise.
ARCH_PHASES = (("gemma-2b", 3), ("phi3-medium-14b", 1), ("qwen2-72b", 1),
               ("nemotron-4-340b", 1), ("qwen2-vl-2b", 7),
               ("musicgen-large", 8), ("llama4-scout-17b-16e", 1))
# nemotron-4-340b's f32 prune peaks above the card's 80 GB (its 37.7 GB
# embedding and head among 51.6 GB of f32 params): its params are bf16,
# served at f32 compute as every other phase (the engines cast them once)
ARCH_PARAMS_DTYPE = {"nemotron-4-340b": "bfloat16"}
ARCH_CONTINUOUS = ("gemma-2b", "musicgen-large")  # + llama4-scout's paged
ARCH_REQUESTS = 6                  # one LONG_PROMPT prompt, five others
ARCH_SLOTS = 4
FRONTEND_NEW = 16                  # tokens decoded after a frontend prefill
DIGEST_CHUNK = 1 << 26             # elements a checksum step reads


def arch_config(arch: str, layers: int):
    from repro_torch.configs.registry import get_config
    full = get_config(arch)
    return full, full.replace(n_periods=layers // len(full.pattern),
                              scan_layers=False)


def leaf_digest(t) -> tuple:
    """A leaf's shape and two sums over the bits of its values as f32
    (the dtype a bundle's params load into, in both packages), the
    second weighted by position: a Fletcher-style checksum, taken on the
    card in DIGEST_CHUNK steps, so a leaf is checked without a second
    copy of it in memory."""
    import torch
    flat = t.detach().reshape(-1)
    s1 = s2 = 0
    for o in range(0, flat.numel(), DIGEST_CHUNK):
        c = flat[o:o + DIGEST_CHUNK].float().view(torch.int32).long()
        pos = torch.arange(o + 1, o + 1 + c.numel(), device=c.device)
        s1 += int(c.sum())
        s2 += int((c * pos).sum())
    return tuple(t.shape), s1, s2


def bundle_round_trip_digests(art, device, directory: str) -> tuple:
    """Save ``art`` into ``directory``, drop its params from the card,
    load the bundle back onto the card, and hold every loaded leaf to the
    saved leaf's ``leaf_digest`` (its values; a bf16 leaf loads as f32,
    as the reference restores into its config's f32 shapes) and the
    config, targets and plans to ``art``'s exactly. Returns (loaded
    artifact, record)."""
    import torch
    from repro_torch.common.tree import iter_paths
    from repro_torch.core.artifact import PrunedArtifact
    want = [(p, leaf_digest(t)) for p, t in iter_paths(art.params)]
    t0 = time.perf_counter()
    art.save(directory)
    t1 = time.perf_counter()
    n_bytes = sum(os.path.getsize(os.path.join(root, f))
                  for root, _, files in os.walk(directory) for f in files)
    art.params = None
    torch.cuda.empty_cache()
    loaded = PrunedArtifact.load(directory, device)
    sync(device)
    t2 = time.perf_counter()
    got = [(p, leaf_digest(t)) for p, t in iter_paths(loaded.params)]
    if got != want or any(t.device != device or t.dtype != torch.float32
                          for _, t in iter_paths(loaded.params)):
        raise AssertionError("the loaded bundle's params differ")
    check_bundle_documents(art, loaded)
    return loaded, {"save_s": t1 - t0, "load_s": t2 - t1,
                    "bundle_bytes": n_bytes, "leaves": len(got),
                    "plans": len(art.packed)}


def expect_launches(label: str, got: dict, want: dict) -> None:
    """Exact launch counts (experts-computed counters aside), none zero."""
    got = {k: v for k, v in got.items()
           if not k.endswith("_experts_computed")}
    if got != want or not all(want.values()):
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def full_forward_check(art, device, run: dict) -> dict:
    """The dense static run's prefill and decode logits through the cache
    against one full forward (no cache) of the prompt plus the generated
    tokens: within LOGIT_ATOL at f32."""
    import torch
    from repro_torch.models import transformer as T
    toks, logits = run["tokens"], run["logits"]
    with torch.no_grad():
        full, _, _ = T.forward(art.params, art.cfg, toks[:, :-1],
                               compute_dtype=torch.float32)
    rows = full[:, PROMPT_LEN - 1:].transpose(0, 1)     # (N, B, V)
    err = float((rows - logits).abs().max())
    if not err <= LOGIT_ATOL:
        raise AssertionError(f"prefill + decode vs one full forward: "
                             f"{err} > {LOGIT_ATOL}")
    return {"max_abs_err": err, "positions": int(rows.shape[0])}


def arch_requests(vocab: int) -> list:
    """A continuous run's traffic from seed 0: uid 0 a LONG_PROMPT-token
    prompt (the contiguous pool prefills it through kernel 4), the others
    PROMPT_RANGE prompts; NEW_RANGE new tokens each."""
    import numpy as np
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(0)
    lo, hi = PROMPT_RANGE
    lens = [LONG_PROMPT] + [int(rng.integers(lo, hi + 1))
                            for _ in range(ARCH_REQUESTS - 1)]
    return [Request(uid=uid, prompt=rng.integers(1, vocab, n).tolist(),
                    max_new_tokens=int(rng.integers(NEW_RANGE[0],
                                                    NEW_RANGE[1] + 1)))
            for uid, n in enumerate(lens)]


def arch_serve_config(**kw):
    import torch
    from repro_torch.serve.config import ServeConfig
    return ServeConfig(max_slots=ARCH_SLOTS, max_seq=MAX_SEQ,
                       compute_dtype=torch.float32,
                       cache_dtype=torch.float32, **kw)


def arch_continuous(art, device, dense_too: bool) -> dict:
    """ARCH_REQUESTS requests three ways: the contiguous pool (the long
    prompt's prefill through kernel 4), the paged pool through kernel 3,
    and (``dense_too``) the paged pool with dense FFNs; exact launch
    counts, tokens held to the contiguous run's outside near ties."""
    L = art.cfg.n_layers
    ffn_packed = sum(1 for (_, name) in art.packed
                     if name in ("gate", "up", "down"))
    reqs = arch_requests(art.cfg.vocab)
    ways = [("contiguous", True, {}),
            ("paged-kernel", True, {"block_size": BLOCK_SIZE,
                                    "prefill_chunk": PREFILL_CHUNK,
                                    "paged_kernel": True})]
    if dense_too:
        ways.append(("paged-kernel-dense", False, ways[1][2]))
    runs = []
    for label, sparse, kw in ways:
        r = serve_continuous(art, device, label, reqs,
                             arch_serve_config(**kw), sparse=sparse)
        want = {}
        if sparse:
            want["block_sparse"] = ffn_packed * (r["prefill_chunks"]
                                                 + r["ticks"])
        if label == "contiguous":
            want["flash_attention"] = L            # the one long prompt
        else:
            want["paged_attention"] = L * r["ticks"]
            want["rope_kv_write"] = L * (r["prefill_chunks"] + r["ticks"])
        expect_launches(f"{art.cfg.name} {label}", r["launches"], want)
        r["expected_launches"] = want
        runs.append(r)
    agreement = {r["label"]: compare_runs(art, device, runs[0], r)
                 for r in runs[1:]}
    return {"runs": [{k: v for k, v in r.items()
                      if k not in ("tokens", "prompts")} for r in runs],
            "agreement": agreement}


def frontend_prefill_check(art, device) -> dict:
    """A LONG_PROMPT-token prompt whose first frontend_frac x LONG_PROMPT
    positions are frontend embeddings (random, seed 0): ``make_prefill_
    step`` with them (kernel 4 in every layer, kernel 1 for the packed
    FFNs), FRONTEND_NEW - 1 greedy decode steps, held to one full
    ``forward`` with the same embeddings over the prompt and the
    generated tokens (right-padded to a multiple of 1024): every step's
    logits within LOGIT_ATOL."""
    import numpy as np
    import torch
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import (make_prefill_step,
                                          make_serve_step,
                                          make_sparse_mlp_apply)
    cfg, params = art.cfg, art.params
    F = int(cfg.frontend_frac * LONG_PROMPT)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab, (1, LONG_PROMPT)),
                             device=device)
    fe = torch.as_tensor(rng.standard_normal((1, F, cfg.d_model)),
                         dtype=torch.float32, device=device)
    mlp = make_sparse_mlp_apply(art.packed)
    prefill = make_prefill_step(cfg, torch.float32, mlp)
    step = make_serve_step(cfg, torch.float32, mlp)
    V = cfg.vocab
    sync(device)
    counters.reset()
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = T.init_cache(cfg, 1, LONG_PROMPT + FRONTEND_NEW,
                             torch.float32, device)
        logits, cache = prefill(params, prompt, cache, fe)
        rows = [logits[:, -1].float()]
        toks = [int(rows[-1][0, :V].argmax())]
        for i in range(FRONTEND_NEW - 1):
            last, cache = step(params, cache,
                               torch.tensor([[toks[-1]]], device=device),
                               LONG_PROMPT + i)
            rows.append(last.float())
            toks.append(int(last[0, :V].argmax()))
        sync(device)
        cached_s = time.perf_counter() - t0
        # right-padded to a multiple of 1024, as a causal prefill longer
        # than DENSE_ATTN_MAX takes it: the padding cannot reach back
        seq = torch.cat([prompt, torch.tensor([toks[:-1]], device=device)],
                        dim=1)
        seq = torch.nn.functional.pad(seq, (0, -seq.shape[1] % 1024),
                                      value=1)
        full, _, _ = T.forward(params, cfg, seq, frontend_embeds=fe,
                               compute_dtype=torch.float32, mlp_apply=mlp)
    sync(device)
    launches = counters.snapshot()
    ffn_packed = sum(1 for (_, name) in art.packed
                     if name in ("gate", "up", "down"))
    want = {"flash_attention": 2 * cfg.n_layers,   # the prefill, the full
            "block_sparse": ffn_packed * (FRONTEND_NEW + 1)}
    expect_launches(f"{cfg.name} frontend", launches, want)
    err = float((full[0, LONG_PROMPT - 1:LONG_PROMPT - 1 + FRONTEND_NEW]
                 - torch.cat(rows)).abs().max())
    if not err <= LOGIT_ATOL or not bool(torch.isfinite(full).all()):
        raise AssertionError(f"{cfg.name}: frontend prefill + decode vs "
                             f"one full forward: {err} > {LOGIT_ATOL}")
    return {"prompt": LONG_PROMPT, "frontend_positions": F,
            "decoded": FRONTEND_NEW, "launches": launches,
            "max_abs_err": err, "prefill_and_decode_s": cached_s}


def phase_arch(arch: str, layers: int, device, gpu: str,
               cases: dict) -> dict:
    """One architecture at its published widths and ``layers`` layers:
    pruned with golden-smoke's recipe (its arch replaced; llama4-scout,
    whose calibration the reference cannot run either, gets plans packed
    from its unpruned params instead), the bundle saved and loaded back
    (every leaf held to its checksum), 4 prompts x NEW_TOKENS greedy
    tokens on the static engine sparse and dense (MoE: the four ways),
    the dense run's prefill and decode held to one full forward (but for
    MoE); then what the arch adds: continuous runs (gemma-2b,
    musicgen-large, llama4-scout), the frontend prefill (qwen2-vl-2b,
    musicgen-large), kernel 1 at
    nemotron-4-340b's layer-0 up and down, kernels 6 and 7 at
    llama4-scout's layer-0 gate and down stacks (appended to ``cases``).
    Logs its seconds and peak memory."""
    import shutil
    import tempfile

    import torch
    from repro_torch.common.tree import param_count
    from repro_torch.core.pipeline import MosaicPipeline
    from repro_torch.core.recipe import PruneRecipe
    from repro_torch.core.registry import projections
    from repro_torch.kernels import counters
    from repro_torch.models import transformer as T
    from repro_torch.serve.sparse import RAGGED_TOKENS_MAX, flop_savings

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full, cfg = arch_config(arch, layers)
    moe = arch == "llama4-scout-17b-16e"
    recipe = PruneRecipe.load(os.path.join(HERE, "recipes",
                                           "golden-smoke.json")).replace(
        arch=arch)
    stages = None
    if moe:          # no calibration: plans from the unpruned params
        recipe = recipe.replace(ragged_moe=True)
        stages = ("pack", "report")
    log(arch, d_model=cfg.d_model, vocab=cfg.vocab,
        layer=str(cfg.layer(0)),
        depth_cut=f"n_periods {full.n_periods} -> {cfg.n_periods}",
        recipe="recipes/golden-smoke.json" + (
            " (pack and report only)" if moe else ""))
    dtype = ARCH_PARAMS_DTYPE.get(arch, "float32")
    t0 = time.perf_counter()
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg,
                          dtype=getattr(torch, dtype))
    n_params = param_count(params)
    sync(device)
    init_s = time.perf_counter() - t0
    counters.reset()
    art = MosaicPipeline(recipe, stages).run(params, cfg)
    del params
    torch.cuda.empty_cache()
    prune_launches = counters.snapshot()
    want = {} if moe else {"wanda_partials": 2 * len(projections(cfg))}
    expect_launches(f"{arch} prune", prune_launches, want)
    st = art.report["stage_seconds"]
    out = {"gpu": gpu, "layers": cfg.n_layers, "params": n_params,
           "params_dtype": dtype, "init_s": init_s,
           "profile_s": st.get("rank"), "prune_s": st.get("prune"),
           "pack_s": st.get("pack"), "prune_launches": prune_launches,
           "category": art.report.get("category"),
           "params_after": art.report["params_after"],
           "pruned_layer0": str(art.cfg.layer(0)),
           "n_packed": len(art.packed),
           "flop_savings": flop_savings(art.packed),
           "prune_peak_bytes": torch.cuda.max_memory_allocated(device)}
    log(arch, **out)

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"{arch}-bundle-", dir=out_dir)
    try:
        loaded, out["bundle"] = bundle_round_trip_digests(art, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del art
    torch.cuda.empty_cache()
    log(arch, bundle=out["bundle"])

    L = loaded.cfg.n_layers
    ways = (MOE_WAYS if moe else
            (("sparse", True, {}), ("dense", False, {})))
    runs = moe_static_runs(loaded, device, ways)
    if moe:
        n_exp = loaded.cfg.layer(0).ffn.n_experts
        prefill = 1 if BATCH * PROMPT_LEN > RAGGED_TOKENS_MAX else 0
        expected = {
            "default": {"grouped_block_sparse": 3 * L * prefill,
                        "grouped_block_sparse_ragged":
                            3 * L * (NEW_TOKENS - 1)},
            "grouped": {"grouped_block_sparse": 3 * L * NEW_TOKENS},
            "loop": {"block_sparse": 3 * L * n_exp * NEW_TOKENS},
            "dense": {}}
    else:
        n_exp = None
        ffn_packed = sum(1 for (_, name) in loaded.packed
                         if name in ("gate", "up", "down"))
        expected = {"sparse": {"block_sparse": ffn_packed * NEW_TOKENS},
                    "dense": {}}
    check_static_runs(runs, expected, n_exp)
    dn = runs["dense"]
    for name, r in runs.items():
        if name != "dense":
            r["vs_dense"] = compare_generation(
                r["tokens"], r["logits"], dn["tokens"], dn["logits"],
                PROMPT_LEN, LOGIT_ATOL)
    if moe:
        for name in ("grouped", "loop"):
            if not torch.equal(runs[name]["tokens"],
                               runs["default"]["tokens"]):
                raise AssertionError(f"{arch}: {name} tokens differ from "
                                     f"the ragged path's")
    if not moe:
        # an MoE layer drops the routed assignments past each expert's
        # capacity, which grows with the tokens of the call: one forward
        # over 63 tokens drops others than a 32-token prefill and 1-token
        # steps do, in the reference as well, so the two are not the
        # same function there
        out["full_forward"] = full_forward_check(loaded, device, dn)
    out["static"] = {name: {k: v for k, v in r.items()
                            if k not in ("tokens", "logits")}
                     for name, r in runs.items()}
    out["expected_launches"] = expected
    del runs, dn
    log(arch, static=out["static"], full_forward=out.get("full_forward"))

    if arch in ARCH_CONTINUOUS:
        out["continuous"] = arch_continuous(
            loaded, device, dense_too=arch == "musicgen-large")
        log(arch, continuous=out["continuous"])
    if moe:
        ref_run = serve_continuous(
            loaded, device, "dense-contiguous",
            moe_requests(loaded.cfg.vocab), continuous_config(),
            sparse=False)
        run = serve_continuous(
            loaded, device, "paged-kernel", moe_requests(loaded.cfg.vocab),
            continuous_config(block_size=BLOCK_SIZE, paged_kernel=True))
        want = {"grouped_block_sparse": 3 * L * run["prefill_chunks"],
                "grouped_block_sparse_ragged": 3 * L * run["ticks"],
                "paged_attention": L * run["ticks"],
                "rope_kv_write": L * (run["prefill_chunks"] + run["ticks"])}
        expect_launches(f"{arch} paged-kernel", run["launches"], want)
        if ref_run["launches"]:
            raise AssertionError(f"{arch} dense run launched "
                                 f"{ref_run['launches']}")
        out["continuous"] = {
            "runs": [{k: v for k, v in r.items()
                      if k not in ("tokens", "prompts")}
                     for r in (ref_run, run)],
            "agreement": compare_runs(loaded, device, ref_run, run)}
        log(arch, continuous=out["continuous"])
        kinfo = {"art": loaded}
        grouped, ragged = phase_moe_kernels(kinfo, device,
                                            prefix="llama4-scout.")
        out["one_expert"] = kinfo["one_expert"]
        out["kernels_s"] = kinfo["kernels_s"]
        cases["grouped"] += grouped
        cases["ragged"] += ragged
    if loaded.cfg.frontend:
        out["frontend"] = frontend_prefill_check(loaded, device)
        log(arch, frontend=out["frontend"])
    if arch == "nemotron-4-340b":
        out["kernel_cases"] = nemotron_kernel_cases(loaded, device)
        cases["block_sparse"] += out["kernel_cases"]
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    out["phase_s"] = time.perf_counter() - t_phase
    log(arch, phase_s=out["phase_s"],
        max_memory_allocated=out["max_memory_allocated"])
    del loaded
    torch.cuda.empty_cache()
    return out


def nemotron_kernel_cases(art, device) -> list:
    """Kernel 1 at nemotron-4-340b's pruned layer-0 up and down (the
    squared-ReLU MLP, ungated), M 16, f32 and bf16, under the plans the
    path serves."""
    import torch
    from repro_torch.kernels.block_sparse.ops import (
        block_mask_from_weight_mask)
    gen = torch.Generator(device=device).manual_seed(7)
    out = []
    for name in ("up", "down"):
        w = art.params["blocks"][0]["mlp"][name]
        b = art.packed[(0, name)].block
        mask = block_mask_from_weight_mask(w != 0, b, b)
        mask[:, 0] = False                       # an empty column
        for dtype in (torch.float32, torch.bfloat16):
            c = _block_sparse_case(w, mask, 16, b, dtype, gen,
                                   f"nemotron-4-340b.layer0.{name}")
            log("kernels", kernel="block_sparse", **c)
            out.append(c)
            torch.cuda.empty_cache()
    return out


def kernel_table(main: dict, cont: dict, moe: dict, quant: dict,
                 moe_quant: dict, ssm: dict, cases: dict) -> dict:
    """The contract's kernel line: one representative case per kernel, at
    f32 — kernels 1 and 5 at the main path's decode shape (M=16, the
    plan's block, the gate projection), the Wanda reduction on (4096,
    14336), paged attention at the continuous run's 8 decode lengths,
    flash attention on the 3072-token prompt, the grouped kernels (6, 8)
    at an MoE prefill and the ragged kernels (7, 9) at an MoE decode tick
    (layer 0's gate stack), the SSD scan (10) at layer 0 of mamba2's
    4096-token prefill, the paged step's prologue at the phi3 cells'
    64-row decode step with RoPE. The MoE kernels' launches are the default static
    runs'; kernel 5's the int8 llama run's; kernel 10's the mamba2 static
    run's."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    bs = next(c for c in cases["block_sparse"] if c["case"] == "layer0.gate"
              and c["M"] == 16 and c["dtype"] == "float32")
    wm = cases["wanda"][0]
    pa = next(c for c in cases["paged"] if c["dtype"] == "float32")
    fa = next(c for c in cases["flash"] if c["dtype"] == "float32")

    def gate_case(kind: str, key: str, value: int) -> dict:
        return next(c for c in cases[kind] if c["case"] == "layer0.gate"
                    and c["dtype"] == "float32" and c[key] == value)

    gb, qgb = (gate_case(k, "M", 16) for k in ("grouped", "quant_grouped"))
    rg, qrg = (gate_case(k, "tokens", BATCH)
               for k in ("ragged", "quant_ragged"))
    qbs = next(c for c in quant["cases"] if c["dtype"] == "float32")
    moe_launches = moe["static"]["default"]["launches"]
    q_launches = quant["static"]["int8"]["launches"]
    mq_launches = moe_quant["static"]["int8"]["launches"]
    ssd = next(c for c in ssm["cases"] if c["dtype"] == "float32")
    rkv = next(c for c in cases["rope_kv_write"] if c["dtype"] == "float32"
               and c["case"] == "decode" and c["rope"])
    runs = {r["label"]: r["launches"] for r in cont["runs"]}
    return {"kernels": [
        {"name": "block_sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/block_sparse.cu",
         "replaces": BLOCK_SPARSE_TPU,
         "launches": main["launches"].get("block_sparse", 0),
         **{k: bs[k] for k in keys}},
        {"name": "wanda_partials", "route": "cuda",
         "source": "src/repro_torch/csrc/wanda_metric.cu",
         "replaces": WANDA_TPU,
         "launches": main["launches"].get("wanda_partials", 0),
         **{k: wm[k] for k in keys}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": PAGED_TPU,
         "launches": runs["paged-kernel"].get("paged_attention", 0),
         **{k: pa[k] for k in keys}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": FLASH_TPU,
         "launches": runs["contiguous"].get("flash_attention", 0),
         **{k: fa[k] for k in keys}},
        {"name": "grouped_block_sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/grouped_block_sparse.cu",
         "replaces": GROUPED_TPU,
         "launches": moe_launches.get("grouped_block_sparse", 0),
         **{k: gb[k] for k in keys}},
        {"name": "ragged_block_sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/grouped_block_sparse.cu",
         "replaces": RAGGED_TPU,
         "launches": moe_launches.get("grouped_block_sparse_ragged", 0),
         **{k: rg[k] for k in keys}},
        {"name": "quant_block_sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/block_sparse.cu",
         "replaces": QUANT_BS_TPU,
         "launches": q_launches.get("block_sparse_quant", 0),
         **{k: qbs[k] for k in keys}},
        {"name": "quant_grouped_block_sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/grouped_block_sparse.cu",
         "replaces": QUANT_GROUPED_TPU,
         "launches": mq_launches.get("grouped_block_sparse_quant", 0),
         **{k: qgb[k] for k in keys}},
        {"name": "quant_ragged_block_sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/grouped_block_sparse.cu",
         "replaces": QUANT_RAGGED_TPU,
         "launches": mq_launches.get("grouped_block_sparse_ragged_quant", 0),
         **{k: qrg[k] for k in keys}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": SSD_TPU,
         "launches": ssm["static"]["sparse"]["launches"].get("ssd_scan", 0),
         **{k: ssd[k] for k in keys}},
        {"name": "rope_kv_write", "route": "cuda",
         "source": "src/repro_torch/csrc/rope_kv_write.cu",
         "replaces": None,
         "launches": runs["paged-kernel"].get("rope_kv_write", 0),
         **{k: rkv[k] for k in keys}},
    ]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "chip_smoke.json"),
                    help="where the full JSON record is written")
    args = ap.parse_args()

    t_start = time.perf_counter()
    dev_info = phase_device()
    import torch
    device = torch.device("cuda", 0)
    gpu = dev_info["nvidia_smi"]
    build_info = phase_build()
    main_info = phase_main(device, gpu)
    prune_side_info = phase_prune_side(main_info, device, gpu)
    cont_info = phase_continuous(main_info, device)
    gateway_info = phase_gateway(main_info, device)
    trace = phase_trace(main_info, device)
    t_kernels = time.perf_counter()
    bs_cases, wm_cases, rkv_cases = phase_kernels(main_info, device)
    kernels_s = time.perf_counter() - t_kernels
    pa_cases, fa_cases, attention_s = phase_attention_kernels(
        main_info, cont_info, device)
    bf16_info = phase_bf16_prefill(main_info, device)
    quant_info = phase_quant(main_info, device, gpu)
    del main_info["art"], quant_info["art"]   # free the llama3-8b models
    torch.cuda.empty_cache()
    moe_info = phase_moe(device, gpu)
    moe_trace = [trace_decode(moe_info["art"], device, sparse)
                 for sparse in (True, False)]
    for t in moe_trace:
        log("trace", gpu=gpu, model=MOE_ARCH, **t)
    gb_cases, rg_cases = phase_moe_kernels(moe_info, device)
    moe_bf16_info = phase_moe_bf16_prefill(moe_info, device)
    del moe_info["art"]
    torch.cuda.empty_cache()
    moe_quant_info = phase_moe_quant(device, gpu)
    qgb_cases, qrg_cases = phase_moe_kernels(moe_quant_info, device,
                                             quant=True)
    del moe_quant_info["art"]
    torch.cuda.empty_cache()              # free the MoE tensors
    t_ssm = time.perf_counter()
    ssm_info = phase_ssm(device, gpu)
    ssm_info["phase_s"] = time.perf_counter() - t_ssm
    torch.cuda.empty_cache()
    t_hybrid = time.perf_counter()
    hybrid_info = phase_hybrid(device, gpu)
    hybrid_info["phase_s"] = time.perf_counter() - t_hybrid
    torch.cuda.empty_cache()
    train_info = phase_train(device, gpu)
    torch.cuda.empty_cache()
    dist_info = phase_distributed(device, gpu)
    torch.cuda.empty_cache()
    arch_cases = {"block_sparse": [], "grouped": [], "ragged": []}
    arch_info = {}
    t_archs = time.perf_counter()
    for arch, layers in ARCH_PHASES:
        arch_info[arch] = phase_arch(arch, layers, device, gpu, arch_cases)
        torch.cuda.empty_cache()
    log("phases", train_s=train_info["phase_s"],
        distributed_s=dist_info["phase_s"],
        gateway_s=gateway_info["phase_s"],
        archs_s=time.perf_counter() - t_archs,
        **{f"{arch}_s": info["phase_s"] for arch, info in arch_info.items()},
        train_full_width_s=train_info["full_width_s"],
        train_small_s=train_info["trained"]["phase_s"], prune_side_s=prune_side_info["phase_s"],
        moe_expert_removal_s=moe_info["expert_removal"]["phase_s"],
        ssm_s=ssm_info["phase_s"],
        ssm_prefill_s=ssm_info["prefill"]["phase_s"],
        ssm_kernel10_cases_s=ssm_info["cases_s"],
        kernels_s=kernels_s,
        moe_kernels_s=moe_info["kernels_s"],
        moe_quant_kernels_s=moe_quant_info["kernels_s"],
        moe_bf16_prefill_s=moe_bf16_info["phase_s"],
        hybrid_s=hybrid_info["phase_s"], attention_kernels_s=attention_s,
        before_ssm_s=t_ssm - t_start)
    table = kernel_table(main_info, cont_info, moe_info, quant_info,
                         moe_quant_info, ssm_info, {
                             "block_sparse": bs_cases, "wanda": wm_cases,
                             "paged": pa_cases, "flash": fa_cases,
                             "grouped": gb_cases, "ragged": rg_cases,
                             "quant_grouped": qgb_cases,
                             "quant_ragged": qrg_cases,
                             "rope_kv_write": rkv_cases})

    record = {"device": dev_info, "build": build_info,
              "main": main_info, "prune_side": prune_side_info,
              "continuous": cont_info, "trace": trace,
              "block_sparse_cases": bs_cases, "wanda_cases": wm_cases,
              "rope_kv_write_cases": rkv_cases,
              "paged_attention_cases": pa_cases,
              "flash_attention_cases": fa_cases,
              "bf16_prefill": bf16_info,
              "moe": moe_info, "moe_trace": moe_trace,
              "moe_bf16_prefill": moe_bf16_info,
              "grouped_block_sparse_cases": gb_cases,
              "ragged_block_sparse_cases": rg_cases,
              "quant": quant_info, "moe_quant": moe_quant_info,
              "quant_grouped_block_sparse_cases": qgb_cases,
              "quant_ragged_block_sparse_cases": qrg_cases,
              "ssm": ssm_info, "hybrid": hybrid_info, "train": train_info,
              "distributed": dist_info,
              "gateway": gateway_info, "archs": arch_info,
              "arch_block_sparse_cases": arch_cases["block_sparse"],
              "arch_grouped_block_sparse_cases": arch_cases["grouped"],
              "arch_ragged_block_sparse_cases": arch_cases["ragged"],
              "table": table, "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
