"""The generator: determinism by seed, the recipe's shapes, densities,
and the same count of live blocks in every column of blocks."""
import numpy as np
import pytest
import torch

from portbench import modelgen
from portbench.tests import tiny


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_same_seed_same_model_other_seed_other(kind):
    conf = tiny.conf(kind)
    a = modelgen.generate(modelgen.describe(conf, 3), 3, "cpu")
    b = modelgen.generate(modelgen.describe(conf, 3), 3, "cpu")
    c = modelgen.generate(modelgen.describe(conf, 4), 4, "cpu")
    for x, y in ((a, b),):
        assert torch.equal(x["blocks"][1]["attn"]["q"],
                           y["blocks"][1]["attn"]["q"])
        assert torch.equal(x["lm_head"]["w"], y["lm_head"]["w"])
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])


def test_large_seeds_are_accepted():
    conf = tiny.conf("dense")
    seed = 2 ** 31 + 12345
    modelgen.generate(modelgen.describe(conf, seed), seed, "cpu")


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_equal_live_blocks_per_column_at_the_stated_count(kind):
    conf = tiny.conf(kind)
    desc = modelgen.describe(conf, 8)
    params = modelgen.generate(desc, 8, "cpu")
    b = desc["block"]
    group = "mlp" if desc["moe"] is None else "moe"
    for i, L in enumerate(desc["layers"]):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            K, N = L["fold"][name]
            w = params["blocks"][i]["attn" if name in "qkvo" else group][name]
            w3 = w.reshape(-1, K, N)
            live = (w3.reshape(-1, K // b, b, N // b, b) != 0).any(4).any(2)
            per_col = live.sum(1)                       # (E, N/b)
            assert bool((per_col == L["live_per_col"][name]).all()), name


def test_structured_shapes_and_densities_follow_the_recipe():
    conf = tiny.conf("dense")
    conf.update({"hidden_size": 256, "intermediate_size": 512,
                 "num_attention_heads": 8, "num_key_value_heads": 2,
                 "num_hidden_layers": 6})
    desc = modelgen.describe(conf, 1)
    pr = conf["pruning"]
    targets = [t for L in desc["layers"] for t in L["targets"].values()]
    assert abs(np.mean(targets) - pr["p"]) < 1e-9
    for L in desc["layers"]:
        assert L["n_q"] % desc["n_kv"] == 0 and L["n_q"] < 8
        assert L["d_ff"] % pr["align_channels"] == 0 and L["d_ff"] < 512
        t = L["targets"]
        kept = L["d_ff"] / 512
        nK = 256 // desc["block"]
        want = (1 - t["gate"]) / kept * nK
        assert abs(L["live_per_col"]["gate"] - want) <= 0.5 + 1e-9
        assert L["live_per_col"]["k"] == round((1 - t["k"]) * nK)
