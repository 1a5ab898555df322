#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing one line of its own:

1. device  — asserts CUDA, prints the card's name and power limit;
2. build   — builds both kernels from this checkout's sources (nvcc for
             ``csrc/block_sparse.cu``, Triton for the Wanda reduction);
3. main    — the port's main path at the full width of llama3-8b (depth
             cut to 4 layers, random weights from seed 0):
             ``MosaicPipeline`` on ``recipes/golden-smoke.json`` (profile,
             POD rank, plan, composite prune, pack), then the static
             ``Engine`` serves 4 prompts x 32 greedy tokens through the
             block-sparse kernel. The launch counters are reset just
             before and read just after; the same pruned params served
             dense are the reference for logits and tokens;
4. trace   — ``torch.profiler`` over a warm window of decode steps, sparse
             and dense: device time by kernel and by op, device idle share;
5. kernels — each kernel against its plain PyTorch version at the main
             path's shapes, with times, bounds and a library yardstick.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the
script exits non-zero and prints no result. It imports nothing of JAX or
of the JAX package. A full record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
WANDA_TPU = "src/repro/kernels/wanda_metric/kernel.py:29"


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


def phase_build(device) -> dict:
    """Build both kernels: nvcc for the CUDA library, then the Triton JIT
    (one tiny launch per mode)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.block_sparse import kernel as bs_kernel
    from repro_torch.kernels.wanda_metric import kernel as wm_kernel
    t0 = time.perf_counter()
    path, report = build.build(bs_kernel.SOURCE)
    build.load(bs_kernel.SOURCE)
    t1 = time.perf_counter()
    w = torch.ones((64, 256), device=device)
    a = torch.ones((64,), device=device)
    wm_kernel.wanda_partials(w, a)
    wm_kernel.wanda_partials(w, a, torch.ones((1,), device=device))
    sync(device)
    t2 = time.perf_counter()
    out = {"block_sparse_s": t1 - t0, "block_sparse_lib": str(path),
           "ptxas": [ln for ln in report.splitlines() if "registers" in ln],
           "wanda_partials_s": t2 - t1, "build_s": t2 - t0}
    log("build", **out)
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
    del params
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
        "art": art, "runs": runs, "init_s": init_s,
        "profile_s": st.get("rank"), "plan_s": st.get("plan"),
        "prune_s": st.get("prune"), "pack_s": st.get("pack"),
        "flop_savings": flop_savings(art.packed),
        "pack": {k: v for k, v in art.report["pack"].items()
                 if k != "skipped"},
        "category": art.report["category"],
        "params_before": art.report["params_before"],
        "params_after": art.report["params_after"],
    }


def steady_tokens_per_s(art, device, sparse: bool) -> float:
    """A second, warm generation (launches here are not counted: the
    counters are read before it)."""
    from repro_torch.serve.engine import Engine
    eng = Engine.from_artifact(art, serve_config(), sparse=sparse)
    prompt = prompts(art.cfg.vocab, 1)
    sync(device)
    t0 = time.perf_counter()
    eng.generate(prompt, NEW_TOKENS)
    sync(device)
    return BATCH * NEW_TOKENS / (time.perf_counter() - t0)


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
    return out


GEMM_MARKS = ("gemm", "gemv", "cutlass", "xmma", "cublas", "splitk")


def kernel_class(name: str) -> str:
    n = name.lower()
    if "block_sparse" in n:
        return "block_sparse"
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


def trace_decode(art, device, sparse: bool) -> dict:
    """``TRACE_STEPS`` warm decode steps after a prefill, once under
    ``torch.profiler`` (CPU and CUDA) and once without it. Device time is
    summed by kernel class, by kernel name and by aten op with its input
    shapes; the idle share is 1 - device busy / the unprofiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Engine, sample_token
    eng = Engine.from_artifact(art, serve_config(), sparse=sparse)
    prompt = torch.as_tensor(prompts(art.cfg.vocab, 2), device=device)

    def window(prof=None) -> float:
        cache = T.init_cache(eng.cfg, BATCH, eng.max_seq,
                             eng.serve.cache_dtype, device)
        logits, cache = eng._step(prompt, cache, 0)
        tok = sample_token(logits, 0.0, eng.cfg.vocab)
        sync(device)
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for i in range(TRACE_STEPS):
            logits, cache = eng._step(tok[:, None], cache, PROMPT_LEN + i)
            tok = sample_token(logits, 0.0, eng.cfg.vocab)
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
    out = {"engine": "sparse" if sparse else "dense", "steps": TRACE_STEPS,
           "step_ms": step_ms, "step_ms_profiled": step_ms_profiled,
           "device_events": len(dev)}
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


def phase_trace(main: dict, device) -> list:
    out = [trace_decode(main["art"], device, sparse)
           for sparse in (True, False)]
    for t in out:
        log("trace", gpu=main["gpu"], **t)
    return out


def _block_sparse_case(w, plan_mask, M: int, block: int, dtype, gen,
                       label: str) -> dict:
    import torch
    from repro_torch.kernels.block_sparse import kernel, ref
    from repro_torch.kernels.block_sparse.ops import plan_blocks
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
    torch.cuda.synchronize()
    err = float((y.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    dname = str(dtype).replace("torch.", "")
    tol = KERNEL_RTOL[dname] * max(scale, 1.0)
    if not err <= tol:
        raise AssertionError(f"block_sparse {label} M={M} b={block} "
                             f"{dname}: err {err} > {tol}")
    if int(counts[0]) != 0 or float(y[:, :block].abs().max()) != 0.0:
        raise AssertionError("the empty column did not come out zero")
    live = int(counts.sum())
    s = w.element_size()
    n_bytes = (M * K + live * block * block + M * N) * s \
        + 4 * (counts.numel() + indices.numel())
    b_ms, b_by = bound_ms(n_bytes, 2.0 * M * live * block * block, dname)
    return {
        "case": label, "M": M, "K": K, "N": N, "block": block,
        "dtype": dname, "density": live / (counts.numel() * K // block),
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(lambda: kernel.block_sparse_matmul(
            x, w, counts, indices, block)),
        "plain_ms": time_ms(lambda: ref.block_sparse_matmul_ref(
            x, w, plan_mask, block, block)),
        "library_ms": time_ms(lambda: torch.matmul(x, w)),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def phase_kernels(main: dict, device) -> tuple:
    import torch
    from repro_torch.kernels.block_sparse.ops import (
        block_mask_from_weight_mask)
    from repro_torch.kernels.wanda_metric import kernel as wm_kernel
    from repro_torch.kernels.wanda_metric import ops as wm_ops
    from repro_torch.kernels.wanda_metric import ref as wm_ref
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
    for c in bs_cases:
        log("kernels", kernel="block_sparse", **c)

    wm_cases = []
    for K, N in ((4096, 14336), (14336, 4096), (4096, 1024)):
        w = torch.randn((K, N), generator=gen, device=device)
        a = torch.rand((K,), generator=gen, device=device) + 0.5
        part = wm_kernel.wanda_partials(w, a)
        plain = wm_ref.wanda_partials_ref(w, a, block_k=wm_kernel.BLOCK_K,
                                          block_n=wm_kernel.BLOCK_N)
        err = float((part - plain).abs().max())
        tol = 1e-5 * float(plain.abs().max())
        ratio = float(wm_ops.outlier_ratio(w, a, 5.0))
        ratio_plain = float(wm_ref.outlier_ratio_ref(w, a, 5.0))
        ratio_tol = 2 * 100.0 / (K * N)          # one threshold flip
        if not (err <= tol and abs(ratio - ratio_plain) <= ratio_tol):
            raise AssertionError(f"wanda ({K},{N}): partials err {err} > "
                                 f"{tol} or ratio {ratio} vs "
                                 f"{ratio_plain}")
        metric = wm_ref.metric_ref(w, a)
        n_bytes = (K * N + K) * 4 + part.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, 3.0 * K * N, "float32")
        case = {
            "K": K, "N": N, "dtype": "float32", "max_abs_err": err,
            "tol": tol, "ratio": ratio, "ratio_plain": ratio_plain,
            "ms": time_ms(lambda: wm_kernel.wanda_partials(w, a)),
            "plain_ms": time_ms(lambda: wm_ref.wanda_partials_ref(
                w, a, block_k=wm_kernel.BLOCK_K,
                block_n=wm_kernel.BLOCK_N)),
            "library_ms": time_ms(lambda: torch.sum(metric)),
            "bound_ms": b_ms, "bound_by": b_by,
            "outlier_ratio_ms": time_ms(
                lambda: wm_ops.outlier_ratio(w, a, 5.0)),
            "outlier_ratio_plain_ms": time_ms(
                lambda: wm_ref.outlier_ratio_ref(w, a, 5.0)),
            "library_count_ms": time_ms(
                lambda: torch.count_nonzero(metric > 1.0)),
        }
        wm_cases.append(case)
        log("kernels", kernel="wanda_partials", **case)
    return bs_cases, wm_cases


def kernel_table(main: dict, bs_cases: list, wm_cases: list) -> dict:
    """The contract's kernel line: one representative case per kernel
    (the decode shape of the main path: M=16, f32, the plan's block, the
    gate projection; the Wanda reduction on (4096, 14336))."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    bs = next(c for c in bs_cases if c["case"] == "layer0.gate"
              and c["M"] == 16 and c["dtype"] == "float32")
    wm = wm_cases[0]
    return {"kernels": [
        {"name": "block_sparse_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/block_sparse.cu",
         "replaces": BLOCK_SPARSE_TPU,
         "launches": main["launches"].get("block_sparse", 0),
         **{k: bs[k] for k in keys}},
        {"name": "wanda_partials", "route": "triton",
         "source": "src/repro_torch/kernels/wanda_metric/kernel.py",
         "replaces": WANDA_TPU,
         "launches": main["launches"].get("wanda_partials", 0),
         **{k: wm[k] for k in keys}},
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
    build_info = phase_build(device)
    main_info = phase_main(device, gpu)
    trace = phase_trace(main_info, device)
    bs_cases, wm_cases = phase_kernels(main_info, device)
    table = kernel_table(main_info, bs_cases, wm_cases)

    record = {"device": dev_info, "build": build_info,
              "main": {k: v for k, v in main_info.items() if k != "art"},
              "trace": trace,
              "block_sparse_cases": bs_cases, "wanda_cases": wm_cases,
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
