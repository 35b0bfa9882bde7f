"""Logical-axis sharding rules for a device mesh.

The counterpart of ``repro.distributed.sharding`` on ``torch.distributed``.
Every parameter and key activation carries a tuple of *logical* axis names;
``ShardingRules`` maps those to mesh axes. The production mesh is
``("data", "model")`` single-pod or ``("pod", "data", "model")`` multi-pod
(``launch/mesh.py``); "pod" acts as an extra pure-DP axis by default.

Conventions (as in the JAX package):
  * batch                  -> ("pod", "data")   (DP)
  * heads / kv_heads / ffn / vocab -> "model"   (TP, Megatron col->row)
  * experts                -> "data"            (EP; a2a stays intra-pod)
  * embed / model dims     -> replicated
  * optimizer states       -> additionally sharded over "data" (ZeRO-1)

A spec (``P``) is a tuple with one entry per dimension: ``None``, a mesh
axis, or a tuple of axes (major first), what ``PartitionSpec`` holds in
the JAX package. ``NamedSharding(mesh, spec)`` turns it into DTensor placements
(``Shard(dim)`` on each mesh dimension the spec names, ``Replicate()``
elsewhere) and cuts a full tensor into this rank's block (``shard``) or
gathers the blocks back (``gather``). A mesh here is a ``DeviceMesh``, or,
for the spec functions alone, any mapping of axis names to sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A spec: the counterpart of ``jax.sharding.PartitionSpec``, a tuple
    with one entry per dimension (``None``, a mesh axis, or a tuple of
    axes, major first). ``P("model", None)``."""

    def __new__(cls, *parts: MeshAxes):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P%s" % tuple.__repr__(self)


Spec = P


def mesh_shape(mesh) -> Dict[str, int]:
    """The mesh's axis sizes by name, in mesh order (an empty dict for no
    mesh)."""
    if mesh is None:
        return {}
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    shape = mesh.shape if hasattr(mesh, "shape") else mesh
    return dict(shape.items())


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 off the mesh)."""
    if mesh is None or name not in mesh_shape(mesh):
        return 0
    return mesh.get_local_rank(name)


def _axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over."""
    return tuple(a for entry in spec for a in _axes_of(entry))


def shard_map_compat(fn, *, mesh, in_specs, out_specs, check_vma: bool = True):
    """The counterpart of ``jax.shard_map``: ``fn`` on each rank's blocks,
    through ``torch.distributed.tensor.experimental.local_map``. DTensor
    arguments enter as their local tensors (checked against ``in_specs``)
    and outputs leave as DTensors placed by ``out_specs``; plain tensors,
    which the port's sharded code holds, pass through as they are. Specs
    are ``P``s, or tuples of them for several arguments or outputs.
    ``check_vma`` is accepted for the reference's signature."""
    del check_vma
    from torch.distributed.tensor.experimental import local_map

    def placements(spec):
        if isinstance(spec, P):
            return NamedSharding(mesh, spec).placements
        return tuple(placements(s) for s in spec)

    return local_map(fn, out_placements=placements(out_specs),
                     in_placements=tuple(placements(s) for s in in_specs),
                     device_mesh=mesh)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the placement of one array."""

    mesh: Any
    spec: Spec

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in mesh_shape(self.mesh):
            dims = [d for d, entry in enumerate(self.spec) if name in _axes_of(entry)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def layer(self, depth: int) -> "NamedSharding":
        """The sharding of one layer's tensor of a leaf stacked ``depth``
        deep (the port holds a stacked leaf per layer)."""
        return NamedSharding(self.mesh, P(*self.spec[depth:]))

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec):
            for a in _axes_of(entry):
                assert out[d] % sizes[a] == 0, (tuple(shape), self.spec, sizes)
                out[d] //= sizes[a]
        return tuple(out)

    def _block(self, d: int) -> Tuple[int, int]:
        """(index, count) of this rank's block along dimension ``d``: the
        axes of the spec entry major first."""
        sizes = mesh_shape(self.mesh)
        index, count = 0, 1
        for a in _axes_of(self.spec[d] if d < len(self.spec) else None):
            index = index * sizes[a] + axis_index(self.mesh, a)
            count *= sizes[a]
        return index, count

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view)."""
        out = full
        for d in range(min(len(self.spec), full.dim())):
            index, count = self._block(d)
            if count > 1:
                size = full.shape[d] // count
                out = out.narrow(d, index * size, size)
        return out

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (a collective over the
        spec's axes; every rank gets it)."""
        from . import collectives

        out = local
        for d, entry in enumerate(self.spec):
            for a in reversed(_axes_of(entry)):  # minor first
                out = collectives.all_gather(out, self.mesh, a, dim=d)
        return out


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, MeshAxes]

    def spec(self, logical_axes: Optional[Sequence[Optional[str]]]) -> Spec:
        if logical_axes is None:
            return P()
        parts = []
        used: set = set()
        for ax in logical_axes:
            mesh_axes = self.rules.get(ax) if ax is not None else None
            if mesh_axes is None:
                parts.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            # A mesh axis may appear at most once in a spec.
            free = tuple(m for m in mesh_axes if m not in used)
            used.update(free)
            parts.append(free if len(free) > 1 else (free[0] if free else None))
        return P(*parts)

    def sharding(self, mesh, logical_axes) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical_axes))

    def placements(self, mesh, logical_axes):
        """The DTensor placements of ``logical_axes`` on ``mesh``."""
        return self.sharding(mesh, logical_axes).placements

    def with_overrides(self, **overrides: MeshAxes) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(merged)


def default_rules(mesh) -> ShardingRules:
    """Rules for both single-pod and multi-pod meshes."""
    has_pod = "pod" in mesh_shape(mesh)
    batch_axes: MeshAxes = ("pod", "data") if has_pod else ("data",)
    return ShardingRules(
        {
            # activations
            "batch": batch_axes,
            "seq": None,
            "seq_shard": ("data",),  # sequence parallelism (long-context)
            "embed": None,
            # attention
            "heads": ("model",),
            "kv_heads": ("model",),
            "head_dim": None,
            "qk_lora": None,
            # mlp
            "ffn": ("model",),
            # embeddings / output
            "vocab": ("model",),
            # MoE
            "experts": ("data",),
            "expert_ffn": ("model",),
            # recurrent / ssm
            "ssm_inner": ("model",),
            "ssm_state": None,
            # conv frontends
            "conv_k": None,
        }
    )


def logical_sharding_tree(abstract_tree, logical_tree, mesh, rules: ShardingRules):
    """Map a tree (nested dicts) of logical-axis tuples to NamedShardings."""
    if isinstance(abstract_tree, dict):
        return {k: logical_sharding_tree(abstract_tree[k], logical_tree[k], mesh, rules)
                for k in abstract_tree}
    return rules.sharding(mesh, logical_tree)


def constrain(x, rules: ShardingRules, *logical_axes: Optional[str]):
    """Redistribute a DTensor to the spec of ``logical_axes`` on its mesh.
    A plain tensor (the port's sharded code holds each rank's block as
    one) is returned as it is, as the JAX package's is a no-op outside a
    mesh."""
    from torch.distributed.tensor import DTensor

    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, rules.placements(x.device_mesh, logical_axes))


def fit_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop mesh axes whose size does not divide the dimension they shard.

    Dims that cannot shard evenly fall back to replication (e.g. qwen2.5's
    40 heads on a 16-wide model axis). Axis *prefixes* that divide are
    kept: ('pod','data') on a batch divisible by pod but not pod*data keeps
    'pod'.
    """
    sizes = mesh_shape(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, p in zip(shape, parts):
        if p is None:
            out.append(None)
            continue
        kept = []
        size = 1
        for a in _axes_of(p):
            nxt = size * sizes[a]
            if dim % nxt == 0:
                kept.append(a)
                size = nxt
            else:
                break
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def batch_partition(mesh, n: int) -> Spec:
    """Largest prefix of DP axes that divides a batch of size n."""
    sizes = mesh_shape(mesh)
    chosen = []
    size = 1
    for a in (a for a in ("pod", "data") if a in sizes):
        if n % (size * sizes[a]) == 0:
            chosen.append(a)
            size *= sizes[a]
    if not chosen:
        return P()
    return P(tuple(chosen) if len(chosen) > 1 else chosen[0])


def zero1_spec(param_spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO-1: extend a parameter spec with 'data' sharding on the first
    free dimension divisible by the data-axis size (optimizer states only).

    Falls back to the unmodified spec when nothing divides.
    """
    sizes = mesh_shape(mesh)
    if "data" not in sizes:
        return param_spec
    data_size = sizes["data"]
    parts = list(param_spec) + [None] * (len(shape) - len(param_spec))
    if "data" in spec_axes(parts):
        return param_spec
    for i, (dim, p) in enumerate(zip(shape, parts)):
        denom = 1
        for a in _axes_of(p):
            denom *= sizes[a]
        if p is None and dim % data_size == 0:
            parts[i] = "data"
            return P(*parts)
        if p is not None and dim % (denom * data_size) == 0:
            parts[i] = _axes_of(p) + ("data",)
            return P(*parts)
    return param_spec


def mesh_device_count(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n
