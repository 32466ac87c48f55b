"""Text-matching and tree ops: match_matrix_tensor, var_conv_2d,
sequence_scatter, sequence_topk_avg_pooling, tree_conv.

Parity: paddle/fluid/operators/match_matrix_tensor_op.*,
var_conv_2d_op.*, sequence_scatter_op.*, sequence_topk_avg_pooling_op.*,
tree_conv_op.*; the counterpart of ``paddle_tpu/ops/match_ops.py``, every
op of it, over the padded (B, L, ...) batches with length masks the JAX
package uses. Under data parallelism each works a rank's rows with the
weights replicated, its row-aligned inputs (lengths, ids, edges) sharded
with the data (``sequence_ops.rows_with``: a replicated one beside
sharded data refuses at dp > 1).
"""

import torch
import torch.nn.functional as F

from . import register
from .nn_ops import _Conv2d
from .sequence_ops import _mask, rows_with
from .tensor_ops import clamped, dropped


def _length_mask(lengths, width):
    """(B, width) bool: j < lengths[b]."""
    return _mask(lengths, width, torch.bool)


@register("match_matrix_tensor",
          dp=rows_with("X", "Y", "XLength", "YLength"))
def match_matrix_tensor(ctx):
    """X (B, Lx, D), Y (B, Ly, Dy), W (D, C, Dy): Out[b, c, i, j] =
    x_bi . W_c . y_bj (B, C, Lx, Ly), multiplied by the length masks
    (a NaN stays NaN), and Tmp = x . W (B, Lx, C, Dy)."""
    x = ctx.in_("X").float()
    y = ctx.in_("Y").float()
    w = ctx.in_("W").float()
    tmp = torch.einsum("bid,dce->bice", x, w)
    out = torch.einsum("bice,bje->bcij", tmp, y)
    x_len, y_len = ctx.in_("XLength"), ctx.in_("YLength")
    if x_len is not None:
        mask = _length_mask(x_len, x.shape[1])
        out = out * mask[:, None, :, None]
    if y_len is not None:
        mask = _length_mask(y_len, y.shape[1])
        out = out * mask[:, None, None, :]
    return {"Out": out, "Tmp": tmp}


def _same_pads(size, k, s):
    """XLA's "SAME" padding of one dim: total max((ceil(size / s) - 1) s
    + k - size, 0), the smaller half before."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@register("var_conv_2d", dp=rows_with("X", "Row", "Col"))
def var_conv_2d(ctx):
    """A convolution over the padded (B, C, H, W) batch at "SAME"
    padding (explicit: torch's "same" takes no stride), the outputs past
    each row's ceil(Row / stride) x ceil(Col / stride) valid extent
    zeroed."""
    x, w = ctx.in_("X"), ctx.in_("W")
    stride = [int(s) for s in ctx.attr("strides", [1, 1])]
    (top, bottom), (left, right) = (
        _same_pads(x.shape[2 + i], w.shape[2 + i], stride[i])
        for i in range(2))
    out = _Conv2d.apply(F.pad(x, (left, right, top, bottom)), w,
                        tuple(stride), (0, 0), (1, 1), 1)
    _, _, h, wd = out.shape
    row, col = ctx.in_("Row"), ctx.in_("Col")
    if row is not None:
        oh = (row.reshape(-1) + stride[0] - 1) // stride[0]
        out = out * _length_mask(oh, h)[:, None, :, None]
    if col is not None:
        ow = (col.reshape(-1) + stride[1] - 1) // stride[1]
        out = out * _length_mask(ow, wd)[:, None, None, :]
    return {"Out": out}


@register("sequence_scatter",
          dp=rows_with("X", "Ids", "Updates", "Length"))
def sequence_scatter(ctx):
    """X (B, D); X[b, ids[b, k]] += updates[b, k] for each row's valid k
    (Length), duplicates summed; an id out of range after one wrap is
    dropped, as XLA's scatter drops it (a dump column, cut off after)."""
    x = ctx.in_("X")
    ids = ctx.in_("Ids").long()
    upd = ctx.in_("Updates")
    if ids.dim() == 3:
        ids = ids[..., 0]
    lengths = ctx.in_("Length")
    if lengths is not None:
        upd = torch.where(_length_mask(lengths, ids.shape[1]),
                          upd, torch.zeros((), dtype=upd.dtype,
                                           device=upd.device))
    b, d = x.shape
    flat = dropped(ids, d) + (d + 1) * torch.arange(
        b, device=ids.device)[:, None]
    padded = torch.cat([x, x.new_zeros((b, 1))], dim=1).reshape(-1)
    out = padded.index_add(0, flat.reshape(-1), upd.reshape(-1).to(x.dtype))
    return {"Out": out.reshape(b, d + 1)[:, :d]}


@register("sequence_topk_avg_pooling", dp=rows_with("X", "Row", "Col"))
def sequence_topk_avg_pooling(ctx):
    """X (B, C, L1, L2): for each (b, c, i) and each k of `topks` the sum
    of the top min(k, L2) entries over the row's valid j, non-finite
    ones (the masked -inf) as 0, over k. Out (B, L1, C x len(topks)),
    C major, zero past the row length."""
    x = ctx.in_("X").float()
    topks = list(ctx.attr("topks"))
    b, c, l1, l2 = x.shape
    row, col = ctx.in_("Row"), ctx.in_("Col")
    if col is not None:
        jmask = _length_mask(col, l2)
        x = torch.where(jmask[:, None, None, :], x,
                        torch.full((), float("-inf"), device=x.device))
    kmax = min(max(topks), l2)
    top = torch.topk(x, kmax, dim=-1).values
    top = torch.where(torch.isfinite(top), top,
                      torch.zeros((), device=x.device))
    csum = torch.cumsum(top, dim=-1)
    out = torch.stack([csum[..., min(k, kmax) - 1] / float(k)
                       for k in topks], dim=-1)
    out = out.transpose(1, 2).reshape(b, l1, c * len(topks))
    if row is not None:
        out = out * _length_mask(row, l1)[:, :, None]
    return {"Out": out}


def _tree_stats(edges, n):
    """Per tree of EdgeSet (B, E, 2) (1-based (parent, child) pairs,
    the list ending at the first pair with a 0): the adjacency (B, N, N)
    (the edges added, then capped at 1), each node's sibling weight
    temp ((index - 1) / (pclen - 1) by its position among its parent's
    children in edge order, 0.5 for an only child) and the rows past
    node_count = valid edges + 1 (B, N). An index past N is dropped, as
    XLA's scatters drop it."""
    bsz, e = edges.shape[:2]
    dev = edges.device
    parent, child = edges[..., 0].long(), edges[..., 1].long()
    valid = torch.cumprod(((parent > 0) & (child > 0)).long(), dim=1) == 1
    vf = valid.float()
    p = torch.where(valid, parent - 1, 0)
    ch = torch.where(valid, child - 1, 0)
    base = torch.arange(bsz, device=dev)[:, None]
    # the adjacency: a scatter-add into a dump slot past the end for an
    # out-of-range pair
    ok = (p < n) & (ch < n)
    cell = torch.where(ok, base * n * n + p * n + ch, bsz * n * n)
    adj = torch.zeros(bsz * n * n + 1, device=dev).index_add(
        0, cell.reshape(-1), vf.reshape(-1))
    adj = torch.clamp_max(adj[:-1].reshape(bsz, n, n), 1.0)
    # index: the earlier edges of the same parent; pclen: the parent's
    # child count (segment sums by index_add)
    order = torch.arange(e, device=dev)
    earlier = (p[:, :, None] == p[:, None, :]) & \
        (order[None, :] < order[:, None])[None]
    idx0 = (earlier * vf[:, None, :]).sum(-1)
    seg = dropped(p, n) + (n + 1) * base
    cnt = torch.zeros(bsz * (n + 1), device=dev).index_add(
        0, seg.reshape(-1), vf.reshape(-1)).reshape(bsz, n + 1)
    cnt = torch.gather(cnt, 1, clamped(p, n))
    temp_e = torch.where(cnt > 1, idx0 / torch.clamp_min(cnt - 1.0, 1.0),
                         torch.full((), 0.5, device=dev))
    tseg = dropped(ch, n) + (n + 1) * base
    temp = torch.zeros(bsz * (n + 1), device=dev).index_add(
        0, tseg.reshape(-1), (temp_e * vf).reshape(-1))
    temp = temp.reshape(bsz, n + 1)[:, :n]
    node_count = vf.sum(-1) + 1.0
    row_ok = (torch.arange(n, device=dev)[None] < node_count[:, None])
    return adj, temp, row_ok.float()


@register("tree_conv", dp=rows_with("NodesVector", "EdgeSet"))
def tree_conv(ctx):
    """TBCNN's tree convolution (the continuous binary tree, any
    max_depth), as the JAX op computes it: NodesVector (B, N, D),
    EdgeSet (B, E, 2), Filter (D, 3, H, F) in the slot order [W_left,
    W_right, W_top]. For each root the window is every descendant at
    depth k < max_depth, weighted eta_t = 1 - s, eta_l = s temp, eta_r =
    s (1 - s temp) with s = k / max_depth; the depth-k reach is the
    batched product of the adjacency's powers (``bmm``, where JAX maps
    one tree at a time). Out (B, N, H, F), rows past node_count zero,
    plus Bias: its last two dims as (H, F), or a 1-D Bias as (H, 1)."""
    nodes = ctx.in_("NodesVector").float()
    filt = ctx.in_("Filter").float()
    max_depth = int(ctx.attr("max_depth", 2))
    bsz, n, _ = nodes.shape
    adj, temp, row_ok = _tree_stats(ctx.in_("EdgeSet"), n)
    w_left, w_right, w_top = filt[:, 0], filt[:, 1], filt[:, 2]
    dd = float(max_depth)
    nvl = nodes * temp[:, :, None]
    reach = torch.eye(n, device=nodes.device).expand(bsz, n, n)
    ft = torch.zeros_like(nodes)
    fl = torch.zeros_like(nodes)
    fr = torch.zeros_like(nodes)
    for k in range(max_depth):
        s = k / dd
        rn, rnl = torch.bmm(reach, nodes), torch.bmm(reach, nvl)
        ft = ft + (1.0 - s) * rn
        fl = fl + s * rnl
        fr = fr + s * rn - s * s * rnl
        if k + 1 < max_depth:
            reach = torch.clamp_max(torch.bmm(reach, adj), 1.0)
    out = (torch.einsum("bnd,dhf->bnhf", ft, w_top)
           + torch.einsum("bnd,dhf->bnhf", fl, w_left)
           + torch.einsum("bnd,dhf->bnhf", fr, w_right))
    out = out * row_ok[:, :, None, None]
    bias = ctx.in_("Bias")
    if bias is not None:
        out = out + (bias.reshape(1, 1, *bias.shape[-2:]) if bias.dim() >= 2
                     else bias.reshape(1, 1, -1, 1))
    return {"Out": out}
