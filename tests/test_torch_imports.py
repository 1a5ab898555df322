"""The port's import boundary and its device rule.

``repro_torch`` and ``chip_smoke.py`` run on a machine with PyTorch and
no JAX: no file may import ``jax`` or the JAX package ``repro``, which
an AST scan checks and a subprocess with both poisoned in
``sys.modules`` confirms. Entry points run on CUDA unless asked for the
CPU, and raise when CUDA is missing.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    out = [SMOKE]
    for root, _, files in os.walk(PKG):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_import_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 30
    rel = {os.path.relpath(f, PKG) for f in files}
    assert {"checkpoint/manager.py", "launch/prune.py", "serve/batching.py",
            "serve/paging.py", "serve/scheduler.py", "serve/policies.py",
            "serve/metrics.py", "kernels/paged_attention/kernel.py",
            "kernels/paged_attention/ops.py", "kernels/paged_attention/ref.py",
            "kernels/flash_attention/kernel.py",
            "kernels/flash_attention/ops.py",
            "kernels/flash_attention/ref.py", "models/moe.py",
            "configs/qwen3_moe_30b_a3b.py",
            "kernels/grouped_block_sparse/kernel.py",
            "kernels/grouped_block_sparse/ops.py",
            "kernels/grouped_block_sparse/ref.py", "core/quant.py",
            "models/ssm.py", "configs/mamba2_1_3b.py",
            "configs/jamba_v01_52b.py", "kernels/ssd_scan/kernel.py",
            "kernels/ssd_scan/ops.py", "kernels/ssd_scan/ref.py",
            "train/optimizer.py", "train/train_step.py", "train/trainer.py",
            "distributed/fault.py", "core/lora.py", "launch/train.py",
            "kernels/no_backward.py", "serve/gateway/__init__.py",
            "serve/gateway/protocol.py", "serve/gateway/server.py",
            "serve/gateway/placement.py", "configs/gemma_2b.py",
            "configs/phi3_medium_14b.py", "configs/qwen2_72b.py",
            "configs/nemotron_4_340b.py", "configs/qwen2_vl_2b.py",
            "configs/musicgen_large.py",
            "configs/llama4_scout_17b_16e.py", "configs/shapes.py",
            "distributed/axes.py", "distributed/sharding.py",
            "distributed/pipeline.py", "distributed/compression.py",
            "distributed/elastic.py", "launch/mesh.py", "launch/specs.py",
            "launch/analysis.py", "launch/dryrun.py"} <= rel
    bad = {os.path.relpath(f, REPO): sorted(set(r for r in _imported_roots(f)
                                                if r in FORBIDDEN))
           for f in files}
    assert not {f: r for f, r in bad.items() if r}


POISONED = """
import importlib, pkgutil, runpy, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
# the dry-run imports torch's fake process group only when it runs
assert "torch.testing._internal.distributed.fake_pg" not in sys.modules
sys.argv = ["chip_smoke.py", "--help"]
try:
    runpy.run_path(sys.argv_path, run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
print("imported", len(mods))
"""


def test_port_imports_with_jax_poisoned():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = POISONED.replace("sys.argv_path", repr(SMOKE))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage: chip_smoke.py" in proc.stdout
    n = int(proc.stdout.strip().splitlines()[-1].split()[-1])
    assert n > 30


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Without a card it exits non-zero; and alone in a directory,
    without the program beside it, it fails too."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(SMOKE).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((SMOKE, REPO), (str(alone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_serve_entry_raises_without_cuda_unless_cpu(monkeypatch, capsys):
    from repro_torch.common.device import resolve_device
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    serve.main(["--smoke", "--device", "cpu", "--new-tokens", "2",
                "--prompt-len", "4", "--batch", "2"])
    assert "generated (2, 6) on cpu" in capsys.readouterr().out
    serve.main(["--smoke", "--device", "cpu", "--new-tokens", "2",
                "--prompt-len", "4", "--batch", "2", "--engine",
                "continuous", "--block-size", "8", "--paged-kernel"])
    assert "served 2 requests, 4 tokens on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="pass --artifact"):
        serve.main(["--smoke", "--device", "cpu", "--gateway",
                    "--memory-budget", "1000000"])
    from repro_torch.launch import prune
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prune.main(["--smoke", "--p", "0.5"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--mesh", "host", "--steps", "2"])
    train.build_parser().print_help()
    assert "torchrun --nproc-per-node N -m repro_torch.launch.train " \
        "--mesh host" in " ".join(capsys.readouterr().out.split())
