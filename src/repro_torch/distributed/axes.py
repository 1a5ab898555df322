"""Logical-axis sharding rules (MaxText-style) and divisibility-aware
hints, on ``torch.distributed`` device meshes.

Model code names tensor dimensions logically ('batch', 'heads', 'ffn',
...); the active rule set maps them to mesh axes. A *spec* is a tuple
with one entry per tensor dim: a mesh-axis name, a tuple of names (one
dim sharded over several mesh dims, major to minor), or None; it is the
port's counterpart of a ``PartitionSpec``. ``resolve_spec`` drops any
mapping whose mesh axis is absent or does not divide the dimension, so
the same model code runs unsharded, on a host mesh and on awkward head
counts (falling back to replication instead of failing).

A mesh is a ``DeviceMesh`` with named dims (``pod``, ``data``,
``model``, ``stage``); the pure spec functions also take a plain
``{axis name: size}`` dict. ``spec_placements`` turns a spec into one
DTensor placement per mesh dim: ``Shard(d)`` where that mesh axis names
dim ``d``, otherwise ``Replicate()``.

``hint`` is a no-op with no active mesh, so the single-device paths are
unchanged. With a mesh (``use_mesh``) it redistributes a DTensor to the
resolved placements; ``use_mesh`` also enters DTensor's
``implicit_replication``, so plain tensors made inside the forward (rope
tables, masks, ``arange``) count as replicated.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "head_dim": None,
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": "data",
    "inner": "model",       # mamba d_inner / ssd heads
    "state": None,
    "fsdp": "data",         # parameter sharding axis
    # residual stream seq sharding (Megatron-style sequence parallelism);
    # enabled per cell by the dry-run for activation memory
    "residual_seq": None,
}

_MESH = None
_RULES: dict = dict(DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    """Make ``mesh`` (a ``DeviceMesh``, or None for no sharding) and
    ``rules`` the active ones for the hints, inside DTensor's
    ``implicit_replication`` when a mesh is given."""
    global _MESH, _RULES
    prev = (_MESH, _RULES)
    _MESH = mesh
    _RULES = dict(DEFAULT_RULES) if rules is None else dict(rules)
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield
    finally:
        _MESH, _RULES = prev


def active_mesh():
    return _MESH


def axis_sizes(mesh) -> dict:
    """{mesh axis name: size} of a ``DeviceMesh`` (or of a dict, as is)."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(axis, 1)


def resolve_spec(mesh, shape, logical, rules: Optional[dict] = None) -> tuple:
    """Logical names -> spec, dropping absent and non-dividing axes."""
    rules = rules if rules is not None else _RULES
    sizes = axis_sizes(mesh)
    parts = []
    for dim, name in zip(shape, logical):
        axis = rules.get(name) if name else None
        if isinstance(axis, (tuple, list)):
            axis = tuple(a for a in axis if a in sizes)
            # no axis left: None; one: its name, as P() normalises it
            axis = (axis[0] if len(axis) == 1 else axis) if axis else None
        elif axis is not None and axis not in sizes:
            axis = None
        if axis is not None and dim % mesh_size(mesh, axis) != 0:
            axis = None
        parts.append(axis)
    return tuple(parts)


def spec_placements(mesh, spec) -> list:
    """One placement per mesh dim for ``spec``: ``Shard(d)`` where the
    mesh axis names tensor dim ``d``, else ``Replicate()`` (also on a
    mesh dim of size 1, where the two are the same layout). A dim sharded
    over a tuple of axes is split major to minor in the tuple's order,
    which must be the axes' order in the mesh (DTensor splits a dim over
    several mesh dims in mesh order, as JAX does for a tuple)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = list(mesh.shape)
    out = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return out


def placements_spec(x) -> tuple:
    """The spec of a DTensor's layout (``spec_placements`` inverted)."""
    parts = [[] for _ in range(x.dim())]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            parts[p.dim].append(name)
        elif not p.is_replicate():
            raise ValueError(f"a {p} layout has no spec")
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in parts)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a collective: every rank
    must call it); a plain tensor as is."""
    return x.full_tensor() if is_dtensor(x) else x


def to_placements(x, mesh, spec):
    """``x`` as a DTensor on ``mesh`` laid out by ``spec``. A plain
    tensor is taken as replicated (the same on every rank), as
    ``implicit_replication`` takes it."""
    from torch.distributed.tensor import DTensor, Replicate
    placements = spec_placements(mesh, spec)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def hint(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by ``logical`` if a mesh is active; no-op otherwise."""
    if _MESH is None:
        return x
    return to_placements(x, _MESH, resolve_spec(_MESH, x.shape, logical))


def sharded_axes(shape, logical) -> tuple:
    """The mesh axes ``logical`` resolves to on ``shape`` under the active
    mesh (none without one): what a contraction over those dims leaves
    partial sums over."""
    if _MESH is None:
        return ()
    out = []
    for axis in resolve_spec(_MESH, shape, logical):
        if axis is not None:
            out.extend(axis if isinstance(axis, tuple) else (axis,))
    return tuple(out)


def model_axis_size() -> int:
    if _MESH is None:
        return 1
    axis = _RULES.get("heads")
    return mesh_size(_MESH, axis) if axis else 1


def heads_spec(mesh, shape, kv: bool = False) -> tuple:
    """(B, S, H, D) attention tensors: heads over 'model' when the head
    count divides, else head_dim (contraction-dim sharding keeps awkward
    head counts model-parallel instead of padding heads)."""
    name = "kv_heads" if kv else "heads"
    spec = resolve_spec(mesh, shape, ("batch", "seq", name, None))
    if spec[2] is None:
        spec = resolve_spec(mesh, shape, ("batch", "seq", None, name))
    return spec


def hint_heads(x: torch.Tensor, kv: bool = False) -> torch.Tensor:
    if _MESH is None:
        return x
    return to_placements(x, _MESH, heads_spec(_MESH, x.shape, kv))


def local_map(fn, out_specs, in_specs, partial: tuple = ()):
    """``fn`` run on each rank's local shards of the active mesh: the
    tensor arguments are laid out by ``in_specs`` (one spec per
    argument, None for a non-tensor one) and ``fn``'s outputs are
    wrapped as DTensors laid out by ``out_specs`` (one spec, or a list
    of specs for a tuple of outputs, None for a non-tensor output). A
    plain tensor argument is taken as replicated. The outputs are
    partial sums over the mesh axes in ``partial`` (``fn`` contracted a
    dim sharded over them). Through DTensor's ``local_map``, so
    gradients flow through it."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map as _lm
    mesh = _MESH
    names = list(mesh.mesh_dim_names)

    def placements(spec, out=False):
        if spec is None:
            return None
        pl = spec_placements(mesh, spec)
        if out:
            for a in partial:
                pl[names.index(a)] = Partial()
        return pl
    if isinstance(out_specs, list):
        out_pl = tuple(placements(s, True) for s in out_specs)
        outs = [p for p in out_pl if p is not None]
    else:
        out_pl = placements(out_specs, True)
        outs = [out_pl]
    in_pl = tuple(placements(s) for s in in_specs)
    # an input whole on a mesh dim that splits the computation (some
    # output is not replicated over it) gets a partial-sum gradient there
    split = [any(not o[i].is_replicate() for o in outs)
             for i in range(len(names))]
    grad_pl = tuple(None if pl is None else
                    [Partial() if split[i] and p.is_replicate() else p
                     for i, p in enumerate(pl)] for pl in in_pl)
    mapped = _lm(fn, out_placements=out_pl, in_placements=in_pl,
                 in_grad_placements=grad_pl, device_mesh=mesh)

    def call(*args):        # laid out here: local_map only checks
        args = tuple(to_placements(a, mesh, s)
                     if s is not None and isinstance(a, torch.Tensor) else a
                     for a, s in zip(args, in_specs))
        return mapped(*args)
    return call


def on_shards(fn, specs: dict, out: list, *args, partial: tuple = ()):
    """``fn(*args)`` on each rank's local shards when a mesh is active
    (``local_map``). ``specs`` maps argument positions to logical names;
    the other tensor arguments are replicated, and non-tensor ones (None
    among them) pass as they are. ``out`` is the output's ``(logical
    names, global shape)``, or a list of them for a tuple of outputs;
    ``partial``: mesh axes the outputs are partial sums over. With no
    mesh, ``fn(*args)`` as is."""
    mesh = _MESH
    if mesh is None:
        return fn(*args)
    in_specs = tuple(resolve_spec(mesh, a.shape,
                                  specs.get(i, (None,) * a.dim()))
                     if isinstance(a, torch.Tensor) else None
                     for i, a in enumerate(args))
    if isinstance(out, list):
        out_specs = [resolve_spec(mesh, shape, names) for names, shape in out]
    else:
        out_specs = resolve_spec(mesh, out[1], out[0])
    return local_map(fn, out_specs, in_specs, partial)(*args)
