"""Tensor (megatron-style) parallelism: sharding rules for transformer
parameters.

The counterpart of ``paddle_tpu/parallel/tensor_parallel.py``: ordered
(regex, PartitionSpec) rules over parameter names (the regexes copied),
oriented by a 2-D weight's shape, and ``apply_shard_rules``, which
annotates ``Parameter.dist_attr``. Where JAX ``device_put``s a state dict
by the rules, ``shard_state`` cuts each held mesh position its slice, in
the layout of ``models/gpt.py``'s ``shard_params``: a sharded leaf a
contiguous copy of its own, a replicated leaf the one object in every
position's dict. The Program path consumes ``dist_attr``:
``CompiledProgram(main).with_mesh(make_mesh(tp=2, ...))`` lays each
annotated parameter out over the mesh (``sharded.ShardedTensor``, cut by
``_cut``) and the ops' tp rules split the heads and products
(``core/compiler.py``, ``ops/__init__.py``).

    embedding        (vocab, d)    -> P('tp', None)
    attn qkv proj    (d, 3d)       -> P(None, 'tp')   column-parallel
    attn out proj    (d, d)        -> P('tp', None)   row-parallel
    mlp up           (d, 4d)       -> P(None, 'tp')
    mlp down         (4d, d)       -> P('tp', None)
    layernorm scales                -> replicated
"""

import re

import numpy as np
import torch

__all__ = ["PartitionSpec", "ShardRules", "column_parallel_spec",
           "row_parallel_spec", "shard_params_spec", "apply_shard_rules",
           "shard_state"]


def _canonical(entry):
    """JAX's canonical partition entry: a 1-tuple of axes is its axis."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """A tuple of per-dimension entries (None, an axis name, or a tuple of
    names) with ``jax.sharding.PartitionSpec``'s equality: entry by
    entry, a 1-tuple equal to its axis, and trailing Nones significant
    (``P('tp', None) != P('tp')``; ``normalized`` pads or strips them, as
    a sharding of an array of some rank does)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return False
        return tuple(self) == tuple(_canonical(e) for e in other)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(tuple(self))

    def __repr__(self):
        return "PartitionSpec" + (repr(tuple(self)) if len(self) != 1
                                  else f"({self[0]!r})")

    def normalized(self, ndim=None):
        """Padded with None to `ndim` entries, or with the trailing
        Nones stripped when `ndim` is None."""
        entries = list(self)
        if ndim is None:
            while entries and entries[-1] is None:
                entries.pop()
        else:
            entries += [None] * (ndim - len(entries))
        return PartitionSpec(*entries)


P = PartitionSpec


def column_parallel_spec():
    return P(None, "tp")


def row_parallel_spec():
    return P("tp", None)


class ShardRules:
    """Ordered (regex, PartitionSpec) rules applied to param names."""

    DEFAULT = [
        # norms / biases / position & sentence tables: replicated.
        (r".*norm.*", P()),
        (r".*(pos_embedding|sent_embedding).*", P()),
        (r".*(_b|\.b_).*", P()),
        # embeddings: shard the vocab dim.
        (r".*(word_embedding|embedding|emb_table).*", P("tp", None)),
        # attention q/k/v projections (models/bert.py enc{i}_attn_{q,k,v}):
        # column-parallel, heads split over tp.
        (r".*(qkv|query_key_value).*", P(None, "tp")),
        (r".*attn_(q|k|v)($|_w.*)", P(None, "tp")),
        (r".*(q_proj|k_proj|v_proj|query|key|value).*w.*", P(None, "tp")),
        # attention output projection: row-parallel (one psum after).
        (r".*attn_o($|ut.*|_w.*)", P("tp", None)),
        (r".*(out_proj|proj_out).*w.*", P("tp", None)),
        # mlp up (d -> 4d, models/bert.py enc{i}_ffn0_w): column-parallel.
        (r".*(ffn0|fc1|mlp_up|h_to_4h|inner).*w.*", P(None, "tp")),
        # mlp down (4d -> d, enc{i}_ffn1_w): row-parallel.
        (r".*(ffn1|ffn2|fc2|mlp_down|4h_to_h).*w.*", P("tp", None)),
    ]

    def __init__(self, rules=None, default=P()):
        self.rules = rules if rules is not None else list(self.DEFAULT)
        self.default = default

    def spec_for(self, name, shape=None):
        for pat, spec in self.rules:
            if re.match(pat, name):
                if shape is not None and not _spec_fits(spec, shape):
                    continue
                return _orient(spec, shape)
        return self.default


def _spec_fits(spec, shape):
    return len([s for s in spec if s is not None]) <= len(shape)


def _orient(spec, shape):
    """For rectangular 2-D weights matched by a single-'tp' rule, orient by
    the actual in/out dims: a fan-out (d_in < d_out, e.g. mlp up d->4d)
    weight is column-parallel, a fan-in weight row-parallel. Square
    weights keep the rule's orientation."""
    if shape is None or len(shape) != 2 or tuple(spec) not in (
            (None, "tp"), ("tp", None), ("tp",)):
        return spec
    d0, d1 = shape
    if not d0 or not d1 or d0 in (-1,) or d1 in (-1,) or d0 == d1:
        return spec
    return P(None, "tp") if d1 > d0 else P("tp", None)


def shard_params_spec(param_names_shapes, rules=None):
    """name -> PartitionSpec for a whole param dict."""
    rules = rules or ShardRules()
    return {name: rules.spec_for(name, shape)
            for name, shape in param_names_shapes.items()}


def apply_shard_rules(program, rules=None):
    """Static-graph path: annotate Parameter.dist_attr."""
    rules = rules or ShardRules()
    for p in program.all_parameters():
        p.dist_attr = rules.spec_for(p.name, p.shape)
    return program


def _cut(value, spec, mesh, coords):
    """`value`'s block at mesh position `coords` under `spec`, or None
    when the spec does not lay it out over this mesh (an axis it lacks, a
    dimension the axes' size does not divide: JAX's device_put raises
    there, and shard_state keeps the value replicated)."""
    shape = tuple(value.shape)
    if len(spec) > len(shape):
        return None
    index, cut = [], False
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if any(a not in mesh.shape for a in axes):
            return None
        size, pos = 1, 0
        for a in axes:
            size, pos = size * mesh.shape[a], pos * mesh.shape[a] + coords[a]
        if shape[dim] % size:
            return None
        n = shape[dim] // size
        index.append(slice(pos * n, (pos + 1) * n))
        cut = cut or size > 1
    if not cut:
        return value
    piece = value[tuple(index)]
    if isinstance(piece, torch.Tensor):
        return piece.clone(memory_format=torch.contiguous_format)
    return np.array(piece, order="C", copy=True)


def shard_state(state, mesh, rules=None):
    """A state dict ({name: tensor or array}) cut by the rules: one dict
    a held mesh position (every position of a local mesh in the mesh's
    row-major order, this process's own in a world), each holding its
    slice of every sharded value and the value itself where it stays
    replicated."""
    rules = rules or ShardRules()
    if mesh.world:
        positions = [mesh.coords()]
    else:
        positions = [dict(zip(mesh.axis_names, idx))
                     for idx in np.ndindex(*mesh.devices.shape)]
    specs = {name: rules.spec_for(name, tuple(getattr(val, "shape", ())))
             for name, val in state.items()}
    out = []
    for coords in positions:
        tree = {}
        for name, val in state.items():
            piece = _cut(val, specs[name], mesh, coords)
            tree[name] = val if piece is None else piece
        out.append(tree)
    return out
