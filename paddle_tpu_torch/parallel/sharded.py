"""Sharded persistable state: a tensor laid out over a mesh.

``ShardedTensor`` stands for a ``jax.Array`` with a
``NamedSharding(mesh, spec)``: the value of a variable whose
``dist_attr`` (a ``PartitionSpec``) lays it out over the axes of a mesh
(``mesh.py``). It knows its spec (one entry a dimension), its mesh, its
global shape, and holds one contiguous tensor, a *part*, for each held
coordinate along its sharded axes: every coordinate on a local mesh (in
row-major order over those axes, in the mesh's axis order), this
process's own in a ``torch.distributed`` world. A part is the block
``tensor_parallel._cut`` gives that coordinate, so the parts equal JAX's
``addressable_shards`` data position for position.

``full()`` is the global value outside autograd (a fetch, a save; in a
world an all-gather); ``gather()`` is the differentiable one an op reads
(``Mesh.all_concat`` along each sharded dimension, counted once in the
mesh's ``reductions``; in a world its backward is a reduce-scatter, so each
rank's part takes the whole gradient of its rows).

Two placement rules, as in the JAX package:

- ``placement_spec`` is ``core/compiler.py``'s ``_var_sharding``: the
  data-parallel walk keeps only the spec's axes that the mesh has, and
  leaves a dimension replicated where those axes' size does not divide
  it (or is 1);
- ``device_put_spec`` is ``jax.device_put``'s with a ``NamedSharding``,
  which ``load_checkpoint_sharded(mesh=)`` follows: an axis the mesh lacks
  or a dimension its axes do not divide raises ``ValueError``.
"""

import itertools

import numpy as np
import torch

from .tensor_parallel import PartitionSpec, _cut

__all__ = ["ShardedTensor", "placement_spec", "device_put_spec",
           "is_replicated"]


def _entry_axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def is_replicated(spec):
    return all(e is None for e in spec)


def placement_spec(spec, shape, mesh):
    """The spec the data-parallel walk lays a persistable out by (JAX's
    ``_var_sharding``): `spec`'s axes that `mesh` has, a dimension left
    replicated where those axes' size is 1 or does not divide it. Padded
    to len(shape) entries; all None when nothing is laid out."""
    entries = []
    spec = tuple(spec) if spec is not None else ()
    for i in range(len(shape)):
        axes = tuple(a for a in _entry_axes(spec[i] if i < len(spec)
                                            else None)
                     if a in mesh.shape)
        size = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if not axes or size <= 1 or shape[i] % size:
            entries.append(None)
        else:
            entries.append(axes[0] if len(axes) == 1 else axes)
    return PartitionSpec(*entries)


def device_put_spec(spec, shape, mesh, name="value"):
    """`spec` padded to len(shape) entries, checked as ``jax.device_put``
    checks a ``NamedSharding``: every axis must be the mesh's and divide
    its dimension, else ``ValueError``."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than the "
                         f"rank-{len(shape)} value")
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        missing = [a for a in axes if a not in mesh.shape]
        if missing:
            raise ValueError(f"{name}: spec {spec} names axes {missing} "
                             f"that the mesh {mesh} lacks")
        size = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        if shape[i] % size:
            raise ValueError(
                f"{name}: the sharding {spec} implies that the global size "
                f"of its dimension {i} should be divisible by {size}, but "
                f"it is equal to {shape[i]}")
    return PartitionSpec(*spec).normalized(len(shape))


class ShardedTensor:
    """A value laid out over a mesh: the port's ``jax.Array`` with a
    ``NamedSharding(mesh, spec)`` (see the module's docstring). `parts`
    are the held coordinates' blocks, `spec` one entry a dimension,
    `shape` the global shape."""

    __slots__ = ("parts", "spec", "mesh", "shape")

    def __init__(self, parts, spec, mesh, shape):
        self.parts = list(parts)
        self.shape = tuple(int(s) for s in shape)
        self.spec = PartitionSpec(*spec).normalized(len(self.shape))
        self.mesh = mesh

    # -- layout ---------------------------------------------------------
    @property
    def axes(self):
        """The sharded axes, in the mesh's axis order."""
        named = {a for e in self.spec for a in _entry_axes(e)}
        return [a for a in self.mesh.axis_names if a in named]

    def positions(self):
        """{axis: coordinate} of each part, over the sharded axes (the
        others 0), in the parts' order."""
        axes = self.axes
        held = [self.mesh.held(a) for a in axes]
        return [dict({a: 0 for a in self.mesh.axis_names},
                     **dict(zip(axes, c)))
                for c in itertools.product(*held)]

    def block_index(self, coords):
        """The global index (one slice a dimension) of the block at mesh
        coordinates `coords`."""
        index = []
        for dim, entry in enumerate(self.spec):
            size, pos = 1, 0
            for a in _entry_axes(entry):
                size, pos = size * self.mesh.shape[a], \
                    pos * self.mesh.shape[a] + coords[a]
            n = self.shape[dim] // size
            index.append(slice(pos * n, (pos + 1) * n))
        return tuple(index)

    def blocks(self):
        """The global index of each part, in the parts' order."""
        return [self.block_index(c) for c in self.positions()]

    def same_layout(self, spec, mesh):
        return self.spec == PartitionSpec(*spec).normalized(
            len(self.shape)) and same_mesh(self.mesh, mesh)

    def like(self, parts):
        """The same layout over new parts."""
        return ShardedTensor(parts, self.spec, self.mesh, self.shape)

    # -- the cut -------------------------------------------------------------
    @classmethod
    def cut(cls, value, spec, mesh):
        """`value` (the global tensor) cut by `spec` over `mesh`: one
        contiguous copy a held coordinate (``tensor_parallel._cut``)."""
        shape = tuple(value.shape)
        out = cls([], spec, mesh, shape)
        with torch.no_grad():
            parts = [_cut(value, out.spec, mesh, c) for c in out.positions()]
        out.parts = [p.clone() if p is value else p for p in parts]
        return out

    # -- sizes -----------------------------------------------------------
    def numel(self):
        """The elements this process holds (summed over its parts)."""
        return sum(p.numel() for p in self.parts)

    def global_numel(self):
        return int(np.prod(self.shape))

    # -- the global value --------------------------------------------------
    def _assemble(self, parts):
        """The global value from `parts` (this value's or their
        detached aliases): ``Mesh.all_concat`` of the blocks along one
        sharded dimension at a time (on a local mesh a concatenation, in
        a world an all-gather over each of the dimension's axes, a value
        laid out over several axes gathering one line after another),
        uncounted."""
        concat = self.mesh._concat
        if self.mesh.world:
            # this rank's block grows one axis at a time, the innermost
            # axis of each dimension's entry first (a dimension laid out
            # over ("dp", "tp") orders its blocks dp-major): each gather
            # runs over this process's line of that axis, whose ranks
            # hold the same blocks along the axes gathered before
            (value,) = parts
            for dim, entry in enumerate(self.spec):
                for axis in reversed(_entry_axes(entry)):
                    value = concat([value], axis, dim)
            return value
        blocks = {tuple(ix[d].start for d in range(len(self.shape))): p
                  for ix, p in zip(self.blocks(), parts)}
        # one sharded dimension at a time, the last first
        for dim in reversed([d for d, e in enumerate(self.spec)
                             if e is not None]):
            groups = {}
            for start, p in sorted(blocks.items()):
                key = start[:dim] + (0,) + start[dim + 1:]
                groups.setdefault(key, []).append(p)
            axis = _entry_axes(self.spec[dim])[0]
            blocks = {k: concat(v, axis, dim)
                      for k, v in groups.items()}
        (value,) = blocks.values()
        return value

    def gather(self):
        """The global value as an op reads it: differentiable, counted
        once in the mesh's ``reductions``."""
        self.mesh.reductions += 1
        return self._assemble(self.parts)

    def over(self, axes):
        """This value laid out over `axes` alone: gathered along every
        dimension whose entry names another axis (differentiable, counted
        once in the mesh's ``reductions``); the value itself when it is
        laid out so already."""
        spec = PartitionSpec(*(e if all(a in axes for a in _entry_axes(e))
                               else None for e in self.spec))
        if spec == self.spec:
            return self
        self.mesh.reductions += 1
        out = ShardedTensor([], spec, self.mesh, self.shape)
        if self.mesh.world:
            (value,) = self.parts
            for dim, (old, new) in enumerate(zip(self.spec, spec)):
                if old is not None and new is None:
                    for axis in reversed(_entry_axes(old)):
                        value = self.mesh._concat([value], axis, dim)
            out.parts = [value]
            return out
        whole = self._assemble(self.parts)
        out.parts = [_cut(whole, spec, self.mesh, c)
                     for c in out.positions()]
        return out

    def full(self):
        """The global value outside autograd, a tensor of its own (a
        fetch, a save, a plain Executor run; in a world all-gathered, so
        every rank of the sharded axis must call it). Not counted."""
        with torch.no_grad():
            out = self._assemble([p.detach() for p in self.parts])
        if out.untyped_storage().data_ptr() in {
                p.untyped_storage().data_ptr() for p in self.parts}:
            out = out.clone()
        return out

    def write(self, value):
        """Copy the global `value` into the parts, in place (each its
        block)."""
        with torch.no_grad():
            for p, ix in zip(self.parts, self.blocks()):
                p.copy_(value[ix])

    def __repr__(self):
        return (f"ShardedTensor({list(self.shape)}, {self.spec}, "
                f"{self.mesh}, parts={[list(p.shape) for p in self.parts]})")


def same_mesh(a, b):
    """Two meshes lay values out alike: the same axes and sizes, the same
    form and the same positions."""
    if a is b:
        return True
    return (a.axis_names == b.axis_names and a.shape == b.shape
            and a.world == b.world
            and [str(d) for d in a.devices.flat]
            == [str(d) for d in b.devices.flat])
