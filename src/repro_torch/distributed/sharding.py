"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) on DTensor.

A port of the JAX package's ``distributed/sharding.py``. Model code
annotates tensors with *logical* axis names ("batch", "seq", "d_model",
"heads", "d_ff", "vocab", "experts", ...). A ``ShardingRules`` table maps
logical names onto mesh axes; ``shard(x, *logical)`` redistributes a
DTensor to the placements the rules give when a rules context is active,
and is the identity otherwise (and on a plain tensor).

A ``PartitionSpec`` is a tuple with one entry per tensor dim: a mesh-axis
name, a tuple of them (the dim is split over several mesh axes, major to
minor), or ``None`` (not split). ``placements(spec, mesh)`` turns it into
one DTensor placement per mesh dim: ``Shard(d)`` on each mesh dim that
splits tensor dim ``d``, ``Replicate()`` on the others.

Default production mapping:
  batch   -> ("pod", "data")      # DP over pods and the data axis
  embed_in/d_ff/heads/vocab -> "model"   # TP
  stacked-layer param leading axis -> None (scan axis)
  fsdp    -> "data"               # FSDP: weight matrices additionally
                                  # sharded over the data axis on d_model
  experts -> "model"              # EP: experts live on the TP axis
  seq     -> None for train; "data" for long-context decode (B=1)
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

Axis = str | tuple[str, ...] | None


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names, or
    None. A tuple of one name is that name, as JAX spells it."""

    def __new__(cls, *dims: Axis) -> "PartitionSpec":
        return super().__new__(cls, (d[0] if isinstance(d, tuple) and len(d) == 1 else d for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _names(axis: Axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(frozen=True)
class ShardingRules:
    rules: dict[str, Axis] = field(default_factory=dict)
    axis_sizes: dict[str, int] = field(default_factory=dict)

    def axis(self, logical: str | None) -> Axis:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, *logical: str | None) -> PartitionSpec:
        return P(*(self.axis(name) for name in logical))

    def with_overrides(self, **kw: Axis) -> "ShardingRules":
        return ShardingRules({**self.rules, **kw}, self.axis_sizes)

    def axis_size(self, axis: Axis) -> int:
        if axis is None:
            return 1
        n = 1
        for a in _names(axis):
            n *= self.axis_sizes.get(a, 1)
        return n

    def guard_spec(self, spec: PartitionSpec, shape: tuple[int, ...]) -> PartitionSpec:
        """Drop mesh axes that do not divide the corresponding dim, and drop
        duplicate uses of a mesh axis (each axis may shard one dim only)."""
        out = []
        used: set[str] = set()
        for i, axis in enumerate(spec):
            if axis is None or i >= len(shape):
                out.append(None)
                continue
            if shape[i] % self.axis_size(axis) != 0:
                out.append(None)
                continue
            names = _names(axis)
            if any(n in used for n in names):
                out.append(None)
                continue
            used.update(names)
            out.append(axis)
        return P(*out)


def make_rules(
    *,
    data_axes: Axis = ("pod", "data"),
    model_axis: Axis = "model",
    fsdp_axis: Axis = "data",
    seq_axis: Axis = None,
    kv_seq_axis: Axis = None,
    expert_axis: Axis = "model",
) -> ShardingRules:
    return ShardingRules(
        {
            # activations
            "batch": data_axes,
            "seq": seq_axis,
            "kv_seq": kv_seq_axis,
            # residual stream between block groups; sharding this over
            # "model" = sequence parallelism for the remat-saved buffers
            "residual_seq": None,
            "d_model": None,
            "act_d_ff": model_axis,
            "act_heads": model_axis,
            "act_vocab": model_axis,
            "act_experts": expert_axis,
            "act_state": None,
            # params
            "embed_vocab": model_axis,
            "embed_d": fsdp_axis,
            "w_in": fsdp_axis,        # d_model fan-in dim of matrices
            "w_out": model_axis,      # sharded output dim (heads*hd / d_ff)
            "w_in2": model_axis,      # fan-in that is already TP-sharded
            "w_out2": fsdp_axis,      # projection back to d_model
            "experts": expert_axis,   # leading experts dim of MoE params
            "layers": None,           # stacked leading axis
            "heads": model_axis,
            "state": None,
            "norm": None,
        }
    )


_ctx = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_ctx, "rules", None)


@contextlib.contextmanager
def use_sharding_rules(rules: ShardingRules | None):
    prev = current_rules()
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def placements(spec: PartitionSpec, mesh) -> tuple:
    """One placement per dim of ``mesh`` for ``spec``. A tensor dim split
    over several mesh axes is ``Shard(d)`` on each of them; their order in
    the spec must be the mesh's (major to minor), which is the order DTensor
    splits in. A mesh axis the mesh lacks, or one used twice, raises."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        idx = []
        for a in _names(axis):
            if a not in names:
                raise ValueError(f"mesh axes {names} have no {a!r} (spec {spec})")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {d} against the mesh's axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Annotate activation ``x`` with logical axes: a DTensor is
    redistributed to the placements the active rules give; without a rules
    context, or on a plain tensor, ``x`` is returned as it is. Axes that do
    not divide the dimension are dropped (e.g. 6 whisper heads on a 16-way
    model axis)."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = rules.guard_spec(rules.spec(*logical), tuple(x.shape))
    if all(a is None for a in spec):
        return x
    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def param_sharding(logical: tuple[str | None, ...]) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return P()
    return rules.spec(*logical)


def activation_sharding(*logical: str | None) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return P()
    return rules.spec(*logical)


# -------------------------------------------------------------------------
# Parameter-spec inference: path heuristics + divisibility guard. Covers the
# whole model zoo (dense/MLA/MoE/SSM/RG-LRU/enc-dec) and the optimizer state
# mirrors (mu/nu/master share leaf paths with params).
# -------------------------------------------------------------------------

_DOWN_PROJ_PARENTS = {"down", "wo", "out_proj"}


def infer_param_spec(path: tuple[str, ...], shape: tuple[int, ...], rules: ShardingRules) -> PartitionSpec:
    keys = [k for k in path if not k.isdigit()]
    last = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) >= 2 else ""

    def base() -> tuple[Axis, ...]:
        r = rules.rules
        if last == "table":                       # embedding (V, D)
            return (r.get("embed_vocab"), r.get("embed_d"))
        if last in ("gate", "up") and parent == "experts":   # (E, D, F)
            return (r.get("experts"), r.get("w_in"), None)
        if last == "down" and parent == "experts":           # (E, F, D)
            return (r.get("experts"), None, r.get("w_out2"))
        if last == "conv_w":                      # (K, C)
            return (None, r.get("w_out"))
        if last == "w" and parent in _DOWN_PROJ_PARENTS:     # (f, D)
            return (r.get("w_in2"), r.get("w_out2"))
        if last == "w":                           # generic up-proj (D, f)
            return (r.get("w_in"), r.get("w_out"))
        if last == "b" and parent not in _DOWN_PROJ_PARENTS:
            return (r.get("w_out"),)
        return tuple(None for _ in shape)

    spec = list(base())
    # stacked leading axes (layer stacks): pad on the left
    while len(spec) < len(shape):
        spec.insert(0, rules.rules.get("layers"))
    spec = spec[: len(shape)]
    return rules.guard_spec(P(*spec), shape)


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, PartitionSpec)) or (hasattr(x, "shape") and hasattr(x, "dtype"))


def map_with_path(fn: Callable[[tuple[str, ...], Any], Any], tree: Any, path: tuple[str, ...] = ()) -> Any:
    """``fn(keys, leaf)`` over a tree of dicts, lists and tuples whose
    leaves are tensors, ``TensorSpec``s or ``PartitionSpec``s, keyed as the
    JAX package keys them (dict keys, sequence indices as strings); the
    containers are rebuilt. ``None`` holds no leaf."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return type(tree)((k, map_with_path(fn, v, (*path, str(k)))) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, (*path, str(i))) for i, v in enumerate(tree))
    return tree


def param_specs_for_tree(tree: Any, rules: ShardingRules) -> Any:
    """Map a tree of tensors / ``TensorSpec``s -> a tree of PartitionSpec."""
    return map_with_path(lambda keys, leaf: infer_param_spec(keys, tuple(leaf.shape), rules), tree)


def place_module(module: torch.nn.Module, mesh, rules: ShardingRules, wrap: Callable) -> dict:
    """Replace every parameter and buffer of ``module`` by ``wrap(tensor,
    placements)``, at the placements of the spec its JAX path gets (a
    dotted name is that path: ``infer_param_spec`` drops the layer
    indices). Returns the tensors replaced, keyed (module name, name), for
    ``unplace_module``."""
    replaced = {}
    for mname, mod in module.named_modules():
        named = [*mod.named_parameters(recurse=False), *mod.named_buffers(recurse=False)]
        for name, t in named:
            if t is None:
                continue
            keys = tuple(f"{mname}.{name}".split(".")) if mname else (name,)
            placed = wrap(t.detach(), placements(infer_param_spec(keys, tuple(t.shape), rules), mesh))
            replaced[(mname, name)] = t
            if isinstance(t, torch.nn.Parameter):
                setattr(mod, name, torch.nn.Parameter(placed, requires_grad=t.requires_grad))
            else:
                mod.register_buffer(name, placed)
    return replaced


def unplace_module(module: torch.nn.Module, replaced: dict) -> None:
    """Put back the tensors ``place_module`` replaced."""
    mods = dict(module.named_modules())
    for (mname, name), t in replaced.items():
        if isinstance(t, torch.nn.Parameter):
            setattr(mods[mname], name, t)
        else:
            mods[mname].register_buffer(name, t)


# -------------------------------------------------------------------------
# DTensor helpers for the model code. Each is the plain operation on a plain
# tensor, so code without a mesh runs exactly as before.
# -------------------------------------------------------------------------

_DATA_AXES = ("pod", "data")


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight with its data-axis (FSDP) shards gathered, as FSDP gathers a
    layer's weights before using them; its tensor-parallel shards stay.
    The backward of the gather reduce-scatters the gradient."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in _DATA_AXES and p.is_shard() else p
                 for i, p in enumerate(w.placements))
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


def fold_leading(x: torch.Tensor) -> torch.Tensor:
    """``x.flatten(0, -2)``. A DTensor split on a leading dim of size 1 (a
    batch of 1 on a mesh axis of 1) is first made whole there: DTensor
    flattens no split dim of size 1."""
    if isinstance(x, DTensor):
        want = tuple(Replicate() if p.is_shard() and x.shape[p.dim] == 1 else p for p in x.placements)
        if want != tuple(x.placements):
            x = x.redistribute(x.device_mesh, want)
    return x.flatten(0, -2)


def flatten(x: torch.Tensor, start: int) -> torch.Tensor:
    """``x.flatten(start)``. A DTensor split on a dim being merged, other
    than the first, or split there unevenly (DTensor's einsum may split 40
    heads over 16), is first made whole on it."""
    if isinstance(x, DTensor):
        start = start % x.ndim
        mesh = x.device_mesh
        want = tuple(Replicate() if p.is_shard() and p.dim >= start and
                     (p.dim > start or x.shape[p.dim] % mesh.size(i)) else p
                     for i, p in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(mesh, want)
    return x.flatten(start)


def unflatten(x: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. A DTensor sharded on ``dim`` over mesh
    axes that do not divide ``sizes[0]`` (8 kv heads on a 16-way model axis)
    is first gathered on those axes: the split dim cannot be cut there."""
    dim = dim % x.ndim
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        want = tuple(Replicate() if p == Shard(dim) and sizes[0] % mesh.size(i) else p
                     for i, p in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(mesh, want)
    return x.unflatten(dim, sizes)


def replicated_like(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t``, a constant made in the model (positions, rope tables, masks),
    as a replicated DTensor on ``x``'s mesh when ``x`` is a DTensor, as
    GSPMD replicates a constant; otherwise ``t`` as it is. (A plain tensor
    saved for the backward pass cannot meet a DTensor gradient there.)"""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending sums (``Partial`` placements) reduced to
    ``Replicate``; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` gathered on tensor dim ``dim`` (a plain tensor as it is)."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    want = tuple(Replicate() if p == Shard(dim) else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def whole_on(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``, which must not be split on ``dim``: raises for a DTensor that
    is (work on each rank's shard along ``dim`` would be wrong there)."""
    if isinstance(x, DTensor) and any(p == Shard(dim % x.ndim) for p in x.placements):
        raise ValueError(f"dim {dim} is split over the mesh ({x.placements}); this op needs it whole")
    return x


def local_region(fn: Callable, *tensors: torch.Tensor):
    """``fn(*tensors)``; with DTensor inputs, ``fn`` runs on each rank's
    local shards (``local_map``) and its one output is placed as the first
    input is. For work that is independent along every split dim (the
    attention of a batch row and head group, the experts of a token
    group: a local shard is a whole problem for it), and for a kernel,
    which takes no DTensor. An input whole on a mesh axis that splits the
    work gets its gradient summed over that axis (``Partial``): each rank
    saw only its part of the work."""
    if not any(isinstance(t, DTensor) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = tensors[0].device_mesh
    in_pl = tuple(tuple(t.placements) for t in tensors)
    split = [any(pl[m].is_shard() for pl in in_pl) for m in range(mesh.ndim)]
    grad_pl = tuple(tuple(Partial() if split[m] and p.is_replicate() else p for m, p in enumerate(pl))
                    for pl in in_pl)
    return local_map(fn, out_placements=list(in_pl[0]), in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh)(*tensors)


def match_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int = 2):
    """q, k and v with their heads split alike over the mesh, so that each
    rank's q heads are the groups of its k/v heads (GQA). Where k/v are not
    split on a mesh axis that splits q (8 kv heads on 16), q is gathered on
    it; and the reverse."""
    if not isinstance(q, DTensor):
        return q, k, v
    mesh = q.device_mesh
    pls = [list(t.placements) for t in (q, k, v)]
    for i in range(mesh.ndim):
        split = [pl[i] == Shard(head_dim) for pl in pls]
        if any(split) and not all(split):
            for pl in pls:
                if pl[i] == Shard(head_dim):
                    pl[i] = Replicate()
    return tuple(t if pl == list(t.placements) else t.redistribute(mesh, pl) for t, pl in zip((q, k, v), pls))


def place_as(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t`` placed as ``ref`` (a tensor of the same rank), but left whole
    on a dim the mesh axis does not divide (a size-1 head dim broadcast
    against ``ref``'s heads)."""
    if not isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    want = tuple(Replicate() if p.is_shard() and t.shape[p.dim] % mesh.size(i) else p
                 for i, p in enumerate(ref.placements))
    return t if want == tuple(t.placements) else t.redistribute(mesh, want)


def write_slice(dst: torch.Tensor, dim: int, start: int, src: torch.Tensor) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` in place (``n`` is
    ``src``'s size on ``dim``). On a DTensor each rank writes the part of
    the slice that falls in its local shard, with ``src`` placed as ``dst``
    on every other dim (a KV cache split on its sequence: only the rank
    holding ``start`` writes)."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    mesh = dst.device_mesh
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = [Replicate() if p == Shard(dim) else p for p in dst.placements]
    src = src.redistribute(mesh, want).to_local()
    # This rank's part of ``dim``: the mesh axes that split it, major to
    # minor, cut it into equal parts (the rules' guard keeps them equal).
    size, part = dst.shape[dim], 0
    coord = mesh.get_coordinate()
    for i, p in enumerate(dst.placements):
        if p == Shard(dim):
            size //= mesh.size(i)
            part = part * mesh.size(i) + coord[i]
    lo, hi = max(start, part * size), min(start + n, (part + 1) * size)
    if lo < hi:
        dst.to_local().narrow(dim, lo - part * size, hi - lo).copy_(src.narrow(dim, lo - start, hi - lo))


def empty_stacked(n: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised ``(n, *like.shape)`` tensor in ``like``'s dtype and
    device; a DTensor ``like`` gives a DTensor split as ``like`` is, on the
    dims after the new one."""
    if not isinstance(like, DTensor):
        return torch.empty((n, *like.shape), dtype=like.dtype, device=like.device)
    local = like.to_local()
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in like.placements]
    out = torch.empty((n, *local.shape), dtype=local.dtype, device=local.device)
    glob = (n, *like.shape)
    return DTensor.from_local(out, like.device_mesh, pl, run_check=False, shape=glob,
                              stride=torch.empty(glob, device="meta").stride())
