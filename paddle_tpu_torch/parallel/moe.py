"""Mixture-of-Experts with expert parallelism.

The counterpart of ``paddle_tpu/parallel/moe.py``: Switch-style top-1
gating with a capacity, the dispatch of tokens into an (E, C, d) slot
buffer, an all-to-all over the mesh's "ep" axis to the positions that
hold each expert, and back.

JAX runs the dispatch inside ``shard_map`` and takes the dense path when
no "ep" axis is bound (it catches the ``NameError``). The port picks the
path explicitly: ``moe_apply`` runs expert-parallel over a mesh whose ep
axis is larger than 1 and divides both the token count and the expert
count (``_active_ep_mesh``), and dense otherwise, as JAX's
``_active_ep_mesh`` does; that is the op's semantics, not a kernel
fallback. Over the mesh's two forms (``mesh.py``):

- a *local* mesh holds every position in this process: the tokens are
  cut into ep blocks, each position's dispatch is computed in turn, and
  the all-to-all is a regrouping of their buffers;
- over a ``torch.distributed`` world this rank takes its block of the
  (replicated) tokens, and the all-to-all is ``Mesh.all_to_all`` over
  the ep line inside an autograd function whose backward is the inverse
  all-to-all.

The capacity is per shard (``int(cf * t_local / E) + 1``), a token keeps
its slot when its 0-based rank within its expert is below it, and the
aux loss is the mean of the shards'. Dropped tokens add exact zeros into
slot 0 of their expert's buffer (a sum that is exact in any order) and
leave a zero output. Gating keeps JAX's arithmetic, where the dense path
keeps every token (``top1_gating``'s keep mask is true for every row).
The products (``ecd,edf->ecf``) are ``torch.bmm``: JAX computes them
outside Pallas too.
"""

import torch
import torch.nn.functional as F

from .mesh import active_mesh

__all__ = ["top1_gating", "expert_parallel_dispatch",
           "expert_parallel_combine", "moe_apply", "MoELayer"]


def top1_gating(logits, capacity):
    """Switch-style top-1 gating. logits: (tokens, experts). Returns
    (expert index, gate, the load-balance aux loss)."""
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.amax(probs, dim=-1)
    e = logits.shape[-1]
    onehot = F.one_hot(expert, e).to(probs.dtype)
    pos = torch.cumsum(onehot, dim=0) * onehot     # rank within expert
    keep = (pos <= capacity).amax(dim=-1)
    gate = gate * keep.to(gate.dtype)
    # Switch's load-balance term: e * sum(mean_prob * mean_assign)
    aux = e * torch.sum(probs.mean(dim=0) * onehot.mean(dim=0))
    return expert, gate, aux


def _slots(expert_idx, num_experts, capacity):
    onehot = F.one_hot(expert_idx, num_experts)
    pos = (torch.cumsum(onehot, dim=0) * onehot).amax(dim=-1) - 1
    slot = torch.where(pos < capacity, pos, torch.full_like(pos, -1))
    return slot, slot >= 0


def _scatter(x, expert_idx, num_experts, capacity):
    """One shard's tokens into its (E, C, d) buffer: kept tokens into
    their slots, dropped ones as exact zeros into slot 0."""
    slot, ok = _slots(expert_idx, num_experts, capacity)
    buf = x.new_zeros((num_experts, capacity, x.shape[-1]))
    buf = buf.index_put((expert_idx, torch.where(ok, slot,
                                                 torch.zeros_like(slot))),
                        x * ok[:, None].to(x.dtype), accumulate=True)
    return buf, (expert_idx, slot, ok)


class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all`` over a world's line, differentiable: the
    backward is the inverse exchange (split and concat swapped)."""

    @staticmethod
    def forward(ctx, mesh, axis, x, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.dims = (split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (None, None,
                ctx.mesh.all_to_all(g.contiguous(), ctx.axis, concat_dim,
                                    split_dim), None, None)


def _all_to_all(parts, mesh, axis, split_dim, concat_dim):
    """The held positions' parts exchanged over `axis`: position i gets
    every position's i-th block along `split_dim`, concatenated in
    position order along `concat_dim` (a list in, a list out, on a local
    mesh; this rank's tensor in a world)."""
    if mesh.world:
        return _AllToAll.apply(mesh, axis, parts, split_dim, concat_dim)
    n = len(parts)
    blocks = [p.chunk(n, split_dim) for p in parts]
    return [torch.cat([blocks[j][i] for j in range(n)], concat_dim)
            for i in range(n)]


def expert_parallel_dispatch(x, expert_idx, num_experts, capacity,
                             axis_name="ep", mesh=None):
    """Scatter each shard's tokens into (experts, capacity) slots and
    all-to-all them over `axis_name`: each position gets the slabs of the
    experts it holds, (E / ep, ep * C, d). `x` and `expert_idx` are the
    held positions' (tokens_local, d) and (tokens_local,) tensors: lists
    on a local mesh, this rank's tensors in a world. Returns (the
    dispatched slabs, the dispatch info)."""
    mesh = mesh or active_mesh()
    if mesh.world:
        buf, info = _scatter(x, expert_idx, num_experts, capacity)
        return _all_to_all(buf, mesh, axis_name, 0, 1), info
    made = [_scatter(xi, ei, num_experts, capacity)
            for xi, ei in zip(x, expert_idx)]
    return (_all_to_all([b for b, _ in made], mesh, axis_name, 0, 1),
            [info for _, info in made])


def _pick(back, info, gate):
    expert_idx, slot, ok = info
    picked = back[expert_idx, torch.where(ok, slot, torch.zeros_like(slot))]
    return picked * (gate * ok.to(gate.dtype))[:, None]


def expert_parallel_combine(y, dispatch_info, gate, num_experts, capacity,
                            token_count, axis_name="ep", mesh=None):
    """The inverse all-to-all of the experts' outputs, each token's slot
    read back and scaled by its gate (0 where it was dropped). The forms
    of ``expert_parallel_dispatch``."""
    mesh = mesh or active_mesh()
    back = _all_to_all(y, mesh, axis_name, 1, 0)
    if mesh.world:
        return _pick(back, dispatch_info, gate)
    return [_pick(b, info, g) for b, info, g in
            zip(back, dispatch_info, gate)]


def _active_ep_mesh(tokens, num_experts, mesh=None):
    """`mesh` (the active mesh by default) when expert parallelism
    applies: an "ep" axis larger than 1 that divides both the token count
    and the expert count; else None (dense)."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or "ep" not in mesh.shape:
        return None
    ep = mesh.shape["ep"]
    if ep <= 1 or tokens % ep or num_experts % ep:
        return None
    return mesh


def _held_parts(w, mesh, axis_name):
    """The held positions' blocks of expert weights over `axis_name`: a
    ShardedTensor's parts, else the global tensor's chunks."""
    from .sharded import ShardedTensor
    if isinstance(w, ShardedTensor):
        return list(w.parts)
    n = mesh.shape[axis_name]
    blocks = w.chunk(n, 0)
    return [blocks[i] for i in mesh.held(axis_name)]


def moe_apply(x, gate_w, w_up, w_down, capacity_factor=1.25,
              axis_name="ep", mesh=None):
    """The framework's MoE FFN: x (..., d); gate_w (d, e); expert weights
    w_up (e, d, f), w_down (e, f, d), global tensors or laid out over ep
    (``ShardedTensor``). Over `mesh` (the active one by default) when its
    ep axis applies (``_active_ep_mesh``) the tokens are cut over ep and
    dispatched by all-to-all; else every expert runs on every token.
    Returns (out of x's shape, the scalar aux loss)."""
    from .sharded import ShardedTensor
    orig_shape = x.shape
    d = orig_shape[-1]
    x2 = x.reshape(-1, d)
    e, _, f = w_up.shape
    layer = MoELayer(d_model=d, d_ff=f, num_experts=e,
                     capacity_factor=capacity_factor, axis_name=axis_name)
    mesh = _active_ep_mesh(x2.shape[0], e, mesh)
    if mesh is None:
        params = {"gate_w": gate_w,
                  "w_up": w_up.gather() if isinstance(w_up, ShardedTensor)
                  else w_up,
                  "w_down": w_down.gather()
                  if isinstance(w_down, ShardedTensor) else w_down}
        out, aux = layer(params, x2)
        return out.reshape(orig_shape), aux
    ups = _held_parts(w_up, mesh, axis_name)
    downs = _held_parts(w_down, mesh, axis_name)
    held = mesh.held(axis_name)
    blocks = x2.chunk(mesh.shape[axis_name], 0)
    if mesh.world:
        params = {"gate_w": gate_w, "w_up": ups[0], "w_down": downs[0]}
        o, a = layer(params, blocks[held[0]], mesh=mesh)
        out = mesh.all_concat([o], axis_name)
        aux = mesh.all_sum([a], axis_name) / mesh.shape[axis_name]
    else:
        params = {"gate_w": gate_w, "w_up": ups, "w_down": downs}
        outs, auxes = layer(params, [blocks[i] for i in held], mesh=mesh)
        out = torch.cat(outs, 0)
        aux = torch.stack(auxes).mean()
    return out.reshape(orig_shape), aux


class MoELayer:
    """Functional MoE FFN block over a dict of stacked expert weights
    ("gate_w" (d, e), "w_up" (e, d, f), "w_down" (e, f, d))."""

    def __init__(self, d_model, d_ff, num_experts, capacity_factor=1.25,
                 axis_name="ep"):
        self.d_model = d_model
        self.d_ff = d_ff
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.axis_name = axis_name

    def init_params(self, generator=None, device=None):
        """JAX's initializers' scales (the gate N(0, 0.02), the experts
        N(0, 2 / fan-in)), drawn from a torch generator."""
        e, d, f = self.num_experts, self.d_model, self.d_ff

        def normal(shape, std):
            return torch.randn(shape, generator=generator,
                               device=device) * std
        return {"gate_w": normal((d, e), 0.02),
                "w_up": normal((e, d, f), (2.0 / d) ** 0.5),
                "w_down": normal((e, f, d), (2.0 / f) ** 0.5)}

    def _capacity(self, tokens):
        return int(self.capacity_factor * tokens / self.num_experts) + 1

    def __call__(self, params, x, mesh=None):
        """Without `mesh`: x (tokens, d), every expert local (dense).
        With one (its ep axis): x and params' "w_up" / "w_down" are the
        held positions' token blocks and expert blocks, lists on a local
        mesh and this rank's tensors in a world; returns their outputs
        and aux losses in the same form."""
        if mesh is None:
            return self._dense(params, x)
        # the held positions' lists, and back to the mesh's form
        held = (lambda v: [v]) if mesh.world else list
        form = (lambda v: v[0]) if mesh.world else (lambda v: v)
        xs = held(x)
        capacity = self._capacity(xs[0].shape[0])
        experts, gates, auxes = zip(*[
            top1_gating(xi @ params["gate_w"], capacity) for xi in xs])
        disp, info = expert_parallel_dispatch(
            form(xs), form(list(experts)), self.num_experts, capacity,
            self.axis_name, mesh)
        ys = [torch.bmm(torch.relu(torch.bmm(di, up)), down)
              for di, up, down in zip(held(disp), held(params["w_up"]),
                                      held(params["w_down"]))]
        out = expert_parallel_combine(
            form(ys), info, form(list(gates)), self.num_experts, capacity,
            None, self.axis_name, mesh)
        return out, form(list(auxes))

    def _dense(self, params, x):
        t, d = x.shape
        logits = x @ params["gate_w"]
        expert, gate, aux = top1_gating(logits, self._capacity(t))
        onehot = F.one_hot(expert, self.num_experts).to(x.dtype)
        h = torch.relu(torch.einsum("td,edf->tef", x, params["w_up"]))
        y = torch.einsum("tef,efd->ted", h, params["w_down"])
        out = torch.einsum("ted,te->td", y, onehot) * gate[:, None]
        return out, aux
