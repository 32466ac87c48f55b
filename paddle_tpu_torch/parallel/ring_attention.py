"""Sequence/context parallelism: blockwise and ring attention.

The counterpart of ``paddle_tpu/parallel/ring_attention.py``. Each rank
of the mesh's ``sp`` axis holds one sequence shard of q, k and v; K/V
(and a key-side padding bias) rotate around the ring while each rank's
online-softmax accumulator stays local, so attention memory is O(T/sp)
a rank.

The ring body is JAX's ``fori_loop`` body: at step i a rank holds the
K/V shard of rank ``(idx - i) % sp``, runs the port's
``flash_attention_with_lse`` on it (``_ring_step_flash``: CUDA tensors
launch the flash forward kernel, and its backward the dQ and dK/dV
kernels; CPU tensors take their plain versions) and merges the step's
normalized output by its lse. The causal structure is block-level: a
past owner is attended in full, the own chunk with in-chunk causal, and a
future owner launches nothing, so a causal ring of sp ranks makes
sp(sp+1)/2 forward launches, not sp**2.

JAX's ``ppermute`` becomes one differentiable rotation, ``_Rotate`` (a
``torch.autograd.Function``): its forward sends each rank's K/V (and
bias) to rank + 1 and receives rank - 1's, its backward is the inverse
rotation, as JAX transposes ``ppermute``. Over a ``torch.distributed``
world mesh the rotation is ``dist.batch_isend_irecv`` within the sp
group; over a local mesh, whose ranks all live in this process, it is a
rotation of the list of the ranks' shards. Both forms run the same body,
and autograd gives the ring's gradients as ``jax.grad`` does.

``ring_attention_sharded`` is JAX's ``shard_map`` wrapper: it takes the
global (B, H, T, D) tensors and returns the global output. Over a world
mesh every process passes the same global tensors, takes its block (batch
over dp, heads over tp, time over sp) and gathers the output blocks, both
differentiable (``_Scatter`` / ``_Gather``: each one's backward is the
other's forward). A local mesh splits time only: attention is independent
over batch and heads, so ranks that differ only in dp or tp would compute
disjoint parts of one function, which a local mesh computes as one.
"""

import torch
import torch.distributed as dist

from ..ops.flash import flash_attention_with_lse
from .mesh import active_mesh, get_mesh

__all__ = ["blockwise_attention", "ring_attention",
           "ring_attention_sharded"]


def _online_block(q, k, v, m, l, o, mask, scale, bias=None):
    """One flash-attention block update. q:(...,Tq,d) k,v:(...,Tk,d)."""
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if bias is not None:
        s = s + bias                      # additive (padding) bias
    ninf = torch.tensor(-float("inf"), dtype=s.dtype, device=s.device)
    if mask is not None:
        s = torch.where(mask, s, ninf)
    m_blk = s.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    # guard fully-masked rows (m_new == -inf)
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - safe_m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(torch.isfinite(m), m - safe_m, ninf))
    corr = torch.where(torch.isfinite(m), corr, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("...qk,...kd->...qd", p, v)
    return m_new, l_new, o_new


def blockwise_attention(q, k, v, block_size=512, causal=False, scale=None):
    """Single-device flash-style attention, a loop over KV blocks (JAX's
    ``lax.scan``). q,k,v: (B, H, T, d). O(T*block) memory instead of
    O(T^2)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    block = min(block_size, tk)
    nblk = (tk + block - 1) // block
    pad = nblk * block - tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    q_pos = torch.arange(tq, device=q.device)
    m = torch.full((b, h, tq), -float("inf"), dtype=q.dtype,
                   device=q.device)
    l = torch.zeros((b, h, tq), dtype=q.dtype, device=q.device)
    o = torch.zeros((b, h, tq, d), dtype=q.dtype, device=q.device)
    for i in range(nblk):
        kblk = k[:, :, i * block:(i + 1) * block]
        vblk = v[:, :, i * block:(i + 1) * block]
        k_pos = i * block + torch.arange(block, device=q.device)
        mask = (k_pos[None, :] < tk)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        mask = mask.expand(b, h, tq, block)
        m, l, o = _online_block(q, kblk, vblk, m, l, o, mask, scale)
    return o / l.clamp_min(1e-20)[..., None]


def _ring_step_flash(q, kk, vv, kv_owner, idx, causal, scale, bias=None):
    """One ring step through the flash kernels: the chunk's normalized
    output and logsumexp for the cross-step online combine, or None for a
    future owner under causal (nothing is launched). Past owner: full;
    self: in-chunk causal. `bias` is this step's key-side (padding) bias
    chunk (B, hb, 1, T_local), rotated by the caller with kk/vv."""
    if causal and kv_owner > idx:
        return None
    return flash_attention_with_lse(q, kk, vv, bias=bias, scale=scale,
                                    causal=causal and kv_owner == idx)


class _Ring:
    """The sp ring as this process holds it: the sp coordinates of its
    ranks (all of them on a local mesh, its own on a world mesh) and the
    rotation's transport."""

    def __init__(self, mesh, axis_name):
        self.sp = mesh.shape[axis_name]
        self.world = mesh.world
        if self.world:
            self.ranks, self.group = mesh.sp_line()
            self.indices = [self.ranks.index(mesh.rank)]
        else:
            self.indices = list(range(self.sp))

    def send(self, ts, shift):
        """Each field's shard moves `shift` ranks along the ring: rank j
        receives rank j - shift's. `ts` is field-major, one tensor per
        held rank a field."""
        n = len(self.indices)
        if not self.world:
            return [ts[f + (j - shift) % n]
                    for f in range(0, len(ts), n) for j in range(n)]
        me = self.indices[0]
        dst = self.ranks[(me + shift) % self.sp]
        src = self.ranks[(me - shift) % self.sp]
        outs = [torch.empty_like(t) for t in ts]
        ops = []
        for tag, (t, buf) in enumerate(zip(ts, outs)):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dst,
                                  self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, src, self.group, tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return outs


class _Rotate(torch.autograd.Function):
    """JAX's ppermute [(j, j + 1)] over the ring: forward sends to rank + 1
    and receives from rank - 1, backward the inverse rotation."""

    @staticmethod
    def forward(ctx, ring, *ts):
        ctx.ring = ring
        # a local rotation returns its inputs: as views, new outputs
        return tuple(t.view_as(t) for t in ring.send(list(ts), 1))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(ctx.ring.send(list(gs), -1))


class _Keep(torch.autograd.Function):
    """`out`, unchanged; its backward also hands `ts` a zero gradient.
    Over a world mesh every rank must run the backward of every rotation
    (each is a collective), also where its causal steps skipped the K/V
    that a rotation brought; tying the last-held shards to the output
    makes every rotation part of every rank's graph. Autograd runs a
    graph's nodes latest-made first, so the ranks then meet in their
    collectives in one order."""

    @staticmethod
    def forward(ctx, out, *ts):
        ctx.meta = [(t.shape, t.dtype, t.device) for t in ts]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=dt, device=dev)
                            for s, dt, dev in ctx.meta)


def ring_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                   bias=None, mesh=None):
    """Ring attention over a sequence-sharded axis of `mesh` (the active
    mesh by default). q,k,v are this process's shards (B, H, T_local, d):
    one tensor each over a world mesh, a list of the sp ranks' shards in
    ring order over a local mesh; the result has the same form. K/V
    rotate around the ring; each step's partial softmax is merged online
    by its lse.

    `bias`: optional KEY-side additive bias (padding mask) shards
    (B, 1|H, 1, T_local), in the form of q; they rotate with K/V.
    Per-query biases (Tq > 1) are not ring-decomposable."""
    mesh = mesh or active_mesh() or get_mesh()
    ring = _Ring(mesh, axis_name)
    single = torch.is_tensor(q)
    qs, ks, vs = ([q], [k], [v]) if single else (list(q), list(k), list(v))
    bs = None if bias is None else ([bias] if single else list(bias))
    n = len(ring.indices)
    if not (len(qs) == len(ks) == len(vs) == n) or (
            bs is not None and len(bs) != n):
        raise ValueError(f"ring_attention: {n} shard(s) a tensor on this "
                         f"{'world' if ring.world else 'local'} mesh, got "
                         f"{len(qs)}")
    d = qs[0].shape[-1]
    scale = scale if scale is not None else d ** -0.5
    m, l, o = [None] * n, [None] * n, [None] * n
    kk, vv, bb = ks, vs, bs
    for i in range(ring.sp):
        for j, idx in enumerate(ring.indices):
            kv_owner = (idx - i) % ring.sp
            step = _ring_step_flash(qs[j], kk[j], vv[j], kv_owner, idx,
                                    causal, scale,
                                    bias=None if bb is None else bb[j])
            if step is None:
                continue
            o_s, lse_s = step
            o_s = o_s.float()
            if m[j] is None:
                m[j], l[j], o[j] = lse_s, torch.ones_like(lse_s), o_s
                continue
            # combine normalized chunk outputs via lse weights
            m_new = torch.maximum(m[j], lse_s)
            alpha = torch.exp(m[j] - m_new)
            beta = torch.exp(lse_s - m_new)
            o[j] = o[j] * alpha[..., None] + o_s * beta[..., None]
            l[j] = l[j] * alpha + beta
            m[j] = m_new
        if i + 1 < ring.sp:
            fields = kk + vv + (bb or [])
            moved = _Rotate.apply(ring, *fields)
            kk, vv = list(moved[:n]), list(moved[n:2 * n])
            bb = None if bb is None else list(moved[2 * n:])
    outs = [(o_j / l_j.clamp_min(1e-20)[..., None]).to(q_j.dtype)
            for o_j, l_j, q_j in zip(o, l, qs)]
    if ring.world and ring.sp > 1:
        outs = [_Keep.apply(outs[0], *(kk + vv + (bb or [])))]
    return outs[0] if single else outs


def _block_index(mesh, rank, shape, dims):
    """The index of world rank `rank`'s block of a global tensor of
    `shape` whose dimensions `dims` ({axis: dim}) are sharded."""
    c = mesh.coords(rank)
    idx = [slice(None)] * len(shape)
    for axis, dim in dims.items():
        size = shape[dim] // mesh.shape[axis]
        idx[dim] = slice(c[axis] * size, (c[axis] + 1) * size)
    return tuple(idx)


def _assemble(mesh, local, shape, dims):
    """Every rank's block, gathered over the world, in a global tensor."""
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local)
    out = local.new_empty(shape)
    for rank, part in enumerate(parts):
        out[_block_index(mesh, rank, shape, dims)] = part
    return out


class _Scatter(torch.autograd.Function):
    """A global tensor (the same on every rank) -> this rank's block;
    backward gathers every rank's block gradient into the global one."""

    @staticmethod
    def forward(ctx, mesh, dims, x):
        ctx.mesh, ctx.dims, ctx.shape = mesh, dims, tuple(x.shape)
        return x[_block_index(mesh, mesh.rank, x.shape, dims)].contiguous()

    @staticmethod
    def backward(ctx, g):
        return None, None, _assemble(ctx.mesh, g.contiguous(), ctx.shape,
                                     ctx.dims)


class _Gather(torch.autograd.Function):
    """This rank's block -> the global tensor on every rank; backward
    takes this rank's block of the (replicated) global gradient."""

    @staticmethod
    def forward(ctx, mesh, dims, shape, x):
        ctx.mesh, ctx.dims, ctx.shape = mesh, dims, tuple(shape)
        return _assemble(mesh, x.contiguous(), shape, dims)

    @staticmethod
    def backward(ctx, g):
        block = _block_index(ctx.mesh, ctx.mesh.rank, ctx.shape, ctx.dims)
        return None, None, None, g[block].contiguous()


def ring_attention_sharded(q, k, v, mesh, causal=False, scale=None,
                           bias=None, batch_axis="dp", seq_axis="sp",
                           head_axis="tp"):
    """q,k,v are global (B, H, T, d) tensors; returns the globally-correct
    attention output (B, H, T, d), computed by the ring over `seq_axis`.
    `bias` must be a key-side (B, 1|H, 1, Tk) padding bias (it rotates
    with K/V)."""
    if bias is not None and bias.shape[2] != 1:
        raise ValueError(
            "ring attention takes a key-side bias (B, 1|H, 1, Tk); "
            f"got Tq={bias.shape[2]}")
    sp = mesh.shape[seq_axis]
    if q.shape[2] % sp or k.shape[2] % sp:
        raise ValueError(f"time axes {q.shape[2]}/{k.shape[2]} do not "
                         f"divide over {seq_axis}={sp}")
    if mesh.world:
        dims = {batch_axis: 0, head_axis: 1, seq_axis: 2}
        args = [_Scatter.apply(mesh, dims, t) for t in (q, k, v)]
        bb = None
        if bias is not None:
            bdims = {batch_axis: 0, seq_axis: 3}
            if bias.shape[1] != 1:
                bdims[head_axis] = 1
            bb = _Scatter.apply(mesh, bdims, bias)
        out = ring_attention(*args, axis_name=seq_axis, causal=causal,
                             scale=scale, bias=bb, mesh=mesh)
        return _Gather.apply(mesh, dims, q.shape, out)
    qs, ks, vs = (list(torch.split(t, t.shape[2] // sp, dim=2))
                  for t in (q, k, v))
    bs = None if bias is None else list(
        torch.split(bias, bias.shape[3] // sp, dim=3))
    outs = ring_attention(qs, ks, vs, axis_name=seq_axis, causal=causal,
                          scale=scale, bias=bs, mesh=mesh)
    return torch.cat(outs, dim=2)
