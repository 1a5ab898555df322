"""Dry-run analysis: per-device cost terms, collective bytes, memory.

``CostMode`` is a dispatch mode that records what one rank computes.
It returns ``NotImplemented`` for DTensor ops, so DTensor first lowers
each into the rank's local ops and the collectives its redistributions
need, and those come back to the mode on plain (local, usually fake)
tensors. So the counts are per device, as the JAX package's
``cost_analysis`` numbers are under SPMD, and not the global shapes'.
The run DTensor makes of each new op on global-shaped fake tensors, to
infer its output's shape, is not counted.

- flops: ``torch.utils.flop_counter``'s formulas (matmuls, attention,
  convolutions) on the local shapes;
- bytes accessed: every non-view op's tensor inputs and outputs;
- transcendentals: the output elements of exp/log/tanh/... ops;
- collective bytes: the result bytes of each ``_c10d_functional``
  collective, per kind, the JAX package's "result-shape bytes" rule
  (``wait_tensor`` is not counted, so async pairs count once);
- peak live bytes: the most bytes held at once by the tensors the step
  made (each new op output counted until it is freed; views and
  in-place results add nothing): this port's own activation measure,
  not XLA's liveness-aware peak.

Layers run in a Python loop, so counts are exact at any depth; the
two-point depth extrapolation (``extrapolate``) is kept for speed.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "softplus", "silu", "gelu", "_softmax",
                   "_log_softmax", "logsumexp"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CostMode(TorchDispatchMode):
    """Counts one rank's flops, bytes, transcendentals and collective
    bytes while active (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.collective = {k: 0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self._shadow = 0
        self._patched = None
        self.live_bytes = 0
        self.peak_bytes = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, func, args, out) -> None:
        if func.is_view or func._overloadpacket.__name__ == "wait_tensor":
            return          # aliases (``wait_tensor`` returns its input's data)
        inputs = {id(a) for a in tree_leaves(args)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and id(t) not in inputs:
                n = _nbytes(t)
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(t, self._free, n)

    def __enter__(self):
        # DTensor infers an op's output shape by running it once on fake
        # tensors of the global shapes: that run is not this rank's work
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name)
        mode = self

        def shadowed(prop, *args, **kwargs):
            mode._shadow += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                mode._shadow -= 1
        setattr(ShardingPropagator, name, shadowed)
        self._patched = (ShardingPropagator, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name, orig = self._patched
        setattr(cls, name, orig)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor lower it to local ops
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        self._track(func, (args, kwargs), out)
        packet = func._overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
        kind = (_COLLECTIVE_OPS.get(name)
                if func.namespace == "_c10d_functional" else None)
        if kind is not None:
            self.collective[kind] += _nbytes(out)
            self.counts[kind] += 1
        elif not func.is_view:
            self.bytes_accessed += _nbytes(out) + sum(
                _nbytes(a) for a in args)
        if name in _TRANSCENDENTAL and isinstance(out, torch.Tensor):
            self.transcendentals += out.numel()
        return out


def collective_bytes(mode: CostMode) -> dict:
    """Result bytes per collective kind, their total and their counts."""
    out = dict(mode.collective)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = dict(mode.counts)
    return out


def cost_summary(mode: CostMode) -> dict:
    """Per-device flops, bytes accessed and transcendentals."""
    return {"flops": float(mode.flops),
            "bytes_accessed": float(mode.bytes_accessed),
            "transcendentals": float(mode.transcendentals)}


def local_bytes(tree) -> int:
    """Bytes of the leaves this rank holds: a DTensor's local shard, a
    plain tensor whole."""
    from repro_torch.common.tree import leaves
    total = 0
    for x in leaves(tree):
        local = x.to_local() if hasattr(x, "to_local") else x
        total += local.numel() * local.element_size()
    return total


def memory_summary(state: dict, mode: CostMode = None) -> dict:
    """Per-device bytes: ``state`` maps a name (params, opt, cache) to a
    tree, each counted by its local shards; ``peak_activation_bytes`` is
    ``mode``'s peak live bytes of the tensors the step made (None when no
    mode traced the step: not measured)."""
    out = {f"{k}_bytes": local_bytes(v) for k, v in state.items()}
    out["state_bytes"] = sum(out.values())
    out["peak_activation_bytes"] = None if mode is None else mode.peak_bytes
    return out


def extrapolate(c1: dict, c2: dict, n_periods: int) -> dict:
    """Two-point extrapolation over pattern periods: per-period cost =
    c2 - c1; total = c1 + (P - 1)(c2 - c1)."""
    out = {}
    for k in c1:
        if isinstance(c1[k], dict):
            out[k] = extrapolate(c1[k], c2[k], n_periods)
        else:
            per = c2[k] - c1[k]
            out[k] = c1[k] + (n_periods - 1) * per
    return out


# ------------------------------------------------------------ hardware

# NVIDIA's data-sheet peaks of one H100 SXM (80 GB HBM3, 700 W), dense
# rates: not measurements. NVLink 4 carries 900 GB/s per card, 450 GB/s
# a direction.
H100_SXM = {
    "name": "NVIDIA H100 80GB HBM3, 700.00 W (data sheet)",
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
    "hbm_bytes": 80 * 10 ** 9,
}


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, n_chips: int,
                   hw: dict = H100_SXM) -> dict:
    """The three roofline terms, in seconds, from per-device counts (so
    the chip count divides nothing here; it is kept for the JAX
    package's signature)."""
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = bytes_accessed / hw["hbm_bw"]
    collective_s = coll_bytes / hw["link_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    return terms
