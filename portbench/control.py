"""The check's readings on the chip, seed by seed, at a cell's own size
and load: the sound program's, and the controls' through the same
``harness.check`` with the cell's own limits.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 50 [--quants none,int8] [--fp8 1] [--alt-eps 1e-6] \\
        [--dump DIR]

For each seed and each program in ``--quants`` it runs the cell's set-up
and one window (no trace), then judges one seeded sample of the requests
finished in the window:

- ``sound``: the served tokens of the program as the configuration
  states it (bf16); has to come out correct;
- ``fp8`` (on the first program's sample): in the program's place, at
  each position the token that the reference computed with float8 e4m3
  operands puts first (the reference in the next precision below the
  stated bf16); has to come out not correct;
- ``int8``: a second set-up and window on the same seed with the port's
  own int8 kept-tile storage switched on
  (``pack_model_with_report(quant="int8")``), its served tokens judged
  as the program's are; has to come out not correct;
- with ``--alt-eps``, the sound tokens judged once more by a reference
  whose RMSNorm adds that eps (a reading only, not a verdict).

Prints one JSON line per seed and reading, with each number compared,
and exits 1 if any verdict was not the expected one. With ``--dump``,
writes per-token gaps and reference margins (top logit less the second)
to ``DIR/<cell>-<seed>-<reading>.pt`` for study. The benchmark's runs do
not run this; the limits in ``checks/<cell>.json`` are set from its
readings (PERF.md gives them).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from run import ROOT, environment  # noqa: E402


def margins(ref: list):
    import torch
    top = torch.cat([lg.topk(2, dim=-1).values for lg in ref])
    return (top[:, 0] - top[:, 1]).double().cpu()


def seed_readings(manifest, cell, seed, seconds, quants, fp8, alt_eps,
                  dump):
    import torch

    from portbench import harness
    _, (conf, tfc, limits) = harness.cell_files(manifest, cell)
    lines, failed = [], 0

    def report(name, checks, expect, picked, gaps=None, ref=None):
        nonlocal failed
        ok = harness.verdict(checks)
        if expect is not None and ok != expect:
            failed += 1
        lines.append({"cell": cell, "seed": seed, "reading": name,
                      "correct": ok, "expected": expect,
                      "requests": len(picked),
                      **{k: c["value"] for k, c in checks.items()}})
        if dump and gaps is not None:
            torch.save({"gap": gaps, "margin": margins(ref),
                        "lens": [len(r.fin.tokens) for r in picked]},
                       Path(dump) / f"{cell}-{seed}-{name}.pt")

    for i, quant in enumerate(quants):
        state = harness.setup(conf, tfc, seed, "cuda", quant=quant)
        ctx = harness.window(state, seconds, False)
        harness.free_program(state)
        picked = harness.sample_finished(ctx["checked"], seed, tfc["check"])
        args = (state["desc"], state["params"], conf["serving"], picked)
        ref = harness.reference_logits(*args)
        gaps = harness.token_gaps(ref, picked)
        judge = lambda **k: harness.check(  # noqa: E731
            state, ctx, conf, limits, seed, **k)
        sound = quant == "none"
        report("sound" if sound else quant, judge(ref=ref), sound, picked,
               gaps, ref)
        if fp8 and i == 0:
            report("fp8", judge(control="fp8", ref=ref), False, picked)
        if sound and alt_eps is not None:
            desc = dict(state["desc"], norm_eps=alt_eps)
            alt = harness.reference_logits(desc, *args[1:])
            report(f"eps{alt_eps:g}", judge(ref=alt), None, picked,
                   harness.token_gaps(alt, picked), alt)
            del alt
        del ref, state, ctx
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return lines, failed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--quants", default="none,int8")
    ap.add_argument("--fp8", type=int, default=1)
    ap.add_argument("--alt-eps", type=float, default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    environment()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    failed = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        lines, bad = seed_readings(manifest, args.workload, seed,
                                   args.seconds, args.quants.split(","),
                                   bool(args.fp8), args.alt_eps, args.dump)
        failed += bad
        for line in lines:
            print(json.dumps(line), flush=True)
    print(f"verdicts not as expected: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
