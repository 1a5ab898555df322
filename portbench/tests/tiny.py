"""Tiny stand-ins for the cells' configuration and traffic files, for
runs on the CPU."""
import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def conf(kind: str) -> dict:
    """A configuration of the cells' shape at a size a CPU runs in
    seconds: the phi3 file (``dense``) or the qwen3 file (``moe``) with
    its widths and depth cut."""
    name = ("phi3-medium-14b-p50" if kind == "dense"
            else "qwen3-moe-30b-a3b-p60")
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c.update({"hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16,
              "num_hidden_layers": 2, "vocab_size": 500})
    if kind == "dense":
        c["intermediate_size"] = 128
    else:
        c.update({"num_experts": 8, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 64})
    c["serving"] = dict(c["serving"], prefill_chunk=32)
    return c


def traffic(**kw) -> dict:
    t = {"loop": "closed", "clients": 3, "max_slots": 3, "max_seq": 128,
         "prompt": {"dist": "loguniform", "min": 20, "max": 70},
         "output": {"dist": "uniform", "min": 4, "max": 12}, "rounds": 400,
         "check": {"min_tokens": 30, "max_requests": 4, "least_tokens": 4}}
    t.update(kw)
    return copy.deepcopy(t)
