"""Neural-network ops.

Parity: paddle/fluid/operators/{conv,pool,batch_norm,layer_norm,dropout}_op.*;
the counterpart of ``paddle_tpu/ops/nn_ops.py`` with the ops the ported
slices run: ``conv2d`` / ``depthwise_conv2d``, ``pool2d``,
``adaptive_pool2d``, ``batch_norm`` / ``sync_batch_norm``,
``layer_norm`` and ``dropout``.

The convolution is torch's (cuDNN on the card), as the JAX package's is
XLA's ``lax.conv_general_dilated``: no Pallas kernel stands behind it.
Its f32 precision is explicit: the forward and its backward run with
cuDNN's TF32 off (``_cudnn_f32``), so an f32 convolution is a full f32
product whatever ``torch.backends.cudnn.allow_tf32`` the caller's
process holds, as the port's f32 matmuls are (and the JAX package's under
``jax_default_matmul_precision="highest"``). The flag is set around each
call and restored after it; nothing is flipped at import. Under amp a
white-listed convolution reads bf16 input and filter
(``OpContext._maybe_amp``) and TF32 does not apply.

Under data parallelism the convolution, the pools, ``layer_norm`` (where
it normalizes from an axis >= 1) and ``dropout`` (with the rank folded
into its generator's seed, ``OpContext.rng``) run a rank's rows.
``batch_norm`` and ``sync_batch_norm`` share one rule of their own: the
batch statistics are the global batch's, summed over dp, as the JAX
package's plain ``batch_norm`` takes them under GSPMD.
"""

import contextlib

import torch
import torch.nn.functional as F

from . import Sharded, register, rows, rows_if



def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        t = tuple(int(x) for x in v)
        return t * n if len(t) == 1 else t
    return (int(v),) * n


@contextlib.contextmanager
def _cudnn_f32():
    """cuDNN's TF32 off for the calls inside; the caller's setting is
    restored after."""
    cudnn = torch.backends.cudnn
    was = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = was


class _Conv2d(torch.autograd.Function):
    """F.conv2d, and its backward (``aten.convolution_backward``), each
    under _cudnn_f32: autograd runs a backward after the forward's
    context has closed, so a plain F.conv2d's backward would read the
    process's flag."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with _cudnn_f32():
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _cudnn_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, False, (0, 0),
                groups, (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False))
        return gx, gw, None, None, None, None


def _filter_replicated(ctx, walk):
    if ctx.is_sharded("Filter"):
        return "the filter is dp-sharded"
    return None


@register("conv2d", "depthwise_conv2d", dp=rows_if(_filter_replicated))
def conv2d(ctx):
    """NCHW input, OIHW filter, with strides, paddings (each side),
    dilations and groups; the Bias, where given, added per output
    channel. In f32 a full f32 product (_Conv2d)."""
    out = _Conv2d.apply(ctx.in_("Input"), ctx.in_("Filter"),
                        _pair(ctx.attr("strides", [1, 1])),
                        _pair(ctx.attr("paddings", [0, 0])),
                        _pair(ctx.attr("dilations", [1, 1])),
                        ctx.attr("groups", 1) or 1)
    bias = ctx.in_("Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return {"Output": out, "Out": out}


def _pool2d(x, pool_type, ksize, strides, pads, exclusive, global_pool):
    """Max pooling pads with -inf; average pooling divides by the count
    of real cells where `exclusive` and there is padding, else by the
    window's size."""
    if global_pool:
        return (x.amax((2, 3), keepdim=True) if pool_type == "max"
                else x.mean((2, 3), keepdim=True))
    if all(2 * p <= k for p, k in zip(pads, ksize)):  # torch's own padding
        if pool_type == "max":
            return F.max_pool2d(x, ksize, strides, pads)
        return F.avg_pool2d(x, ksize, strides, pads,
                            count_include_pad=not exclusive)
    pad4 = (pads[1], pads[1], pads[0], pads[0])
    if pool_type == "max":
        return F.max_pool2d(F.pad(x, pad4, value=float("-inf")), ksize,
                            strides)
    out = F.avg_pool2d(F.pad(x, pad4), ksize, strides)
    if exclusive:
        cells = F.pad(torch.ones_like(x[:1, :1]), pad4)
        out = out / F.avg_pool2d(cells, ksize, strides)
    return out


@register("pool2d", dp=rows)
def pool2d(ctx):
    return {"Out": _pool2d(ctx.in_("X"), ctx.attr("pooling_type", "max"),
                           _pair(ctx.attr("ksize", [2, 2])),
                           _pair(ctx.attr("strides", [1, 1])),
                           _pair(ctx.attr("paddings", [0, 0])),
                           ctx.attr("exclusive", True),
                           ctx.attr("global_pooling", False))}


@register("adaptive_pool2d", dp=rows)
def adaptive_pool2d(ctx):
    """The reference's floor/ceil windows (torch's adaptive pools take
    the same); require_index adds the argmax Mask, a flat index into the
    input's H x W plane, int32."""
    x = ctx.in_("X")
    size = _pair(ctx.attr("pool_size"))
    if ctx.attr("pooling_type", "avg") == "avg":
        return {"Out": F.adaptive_avg_pool2d(x, size)}
    out, idx = F.adaptive_max_pool2d(x, size, return_indices=True)
    res = {"Out": out}
    if ctx.attr("require_index", False):
        res["Mask"] = idx.to(torch.int32)
    return res


def _bn_channel(ctx, x):
    return 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1


def _uses_running(ctx):
    return ctx.is_test or ctx.attr("use_global_stats", False)


def _bn_stats_out(ctx, mean, var):
    """MeanOut / VarianceOut and SavedMean / SavedVariance: the running
    statistics moved towards the batch's (`mean`, `var`; None: the op
    normalized with the running ones, which come out unchanged, and the
    saved statistics are zeros), outside autograd."""
    run_mean, run_var = ctx.in_("Mean"), ctx.in_("Variance")
    if mean is None:
        return {"MeanOut": run_mean, "VarianceOut": run_var,
                "SavedMean": torch.zeros_like(run_mean),
                "SavedVariance": torch.zeros_like(run_var)}
    m = ctx.attr("momentum", 0.9)
    with torch.no_grad():
        return {"MeanOut": m * run_mean + (1 - m) * mean,
                "VarianceOut": m * run_var + (1 - m) * var,
                "SavedMean": mean.detach(), "SavedVariance": var.detach()}


def _dp_batch_norm(impl, ctxs, walk):
    """The global batch's statistics: the ranks' channel sums, one dp sum
    for the mean; their squared deviations from it, a second for the
    biased variance (two passes, as jnp.var); each rank's rows
    normalized with them; the running statistics replicated, once. With
    the running statistics (test mode) each rank normalizes its rows."""
    ctx = ctxs[0]
    if _uses_running(ctx):
        outs = [impl(c) for c in ctxs]
        return dict(outs[0], Y=Sharded([o["Y"] for o in outs]))
    xs = [c.in_("X") for c in ctxs]
    ch = _bn_channel(ctx, xs[0])
    axes = [d for d in range(xs[0].dim()) if d != ch]
    shape = [1] * xs[0].dim()
    shape[ch] = -1
    count = xs[0].numel() // xs[0].shape[ch] * walk.size
    mean = walk.sum([x.float().sum(axes) for x in xs]) / count
    cent = [x.float() - mean.reshape(shape) for x in xs]
    var = walk.sum([(c * c).sum(axes) for c in cent]) / count
    inv = torch.rsqrt(var + ctx.attr("epsilon", 1e-5)).reshape(shape)
    scale = ctx.in_("Scale").reshape(shape)
    bias = ctx.in_("Bias").reshape(shape)
    ys = [(c * inv * scale + bias).to(x.dtype) for c, x in zip(cent, xs)]
    return dict(_bn_stats_out(ctx, mean, var), Y=Sharded(ys))


@register("batch_norm", "sync_batch_norm", dp=_dp_batch_norm)
def batch_norm(ctx):
    """Training: the batch's statistics in f32 with the biased variance
    (Y from torch's batch norm, the statistics for MeanOut from
    var_mean); is_test / use_global_stats: the running statistics. Y in
    x's dtype."""
    x = ctx.in_("X")
    ch = _bn_channel(ctx, x)
    xc = x.float().movedim(ch, 1)
    stats = None
    if not _uses_running(ctx):
        with torch.no_grad():
            var, mean = torch.var_mean(
                xc, dim=[d for d in range(xc.dim()) if d != 1],
                correction=0)
        stats = (mean, var)
    y = F.batch_norm(xc, None if stats else ctx.in_("Mean"),
                     None if stats else ctx.in_("Variance"),
                     ctx.in_("Scale"), ctx.in_("Bias"),
                     training=stats is not None,
                     eps=ctx.attr("epsilon", 1e-5))
    out = _bn_stats_out(ctx, *(stats or (None, None)))
    out["Y"] = y.movedim(1, ch).to(x.dtype)
    return out

def _norms_rows(ctx, walk):
    if ctx.attr("begin_norm_axis", 1) % ctx.in_("X").dim() == 0:
        return "it normalizes over dim 0"
    return None


@register("layer_norm", dp=rows_if(_norms_rows))
def layer_norm(ctx):
    """Normalize over the axes from begin_norm_axis on, in f32 with the
    biased variance; Y in x's dtype, Mean/Variance (f32, x's leading
    shape) only where something reads them."""
    x = ctx.in_("X")
    begin = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    norm_shape = tuple(x.shape[begin:])
    scale = ctx.in_("Scale")
    bias = ctx.in_("Bias")
    y = F.layer_norm(x.float(), norm_shape,
                     None if scale is None else scale.reshape(norm_shape),
                     None if bias is None else bias.reshape(norm_shape),
                     eps)
    out = {"Y": y.to(x.dtype)}
    if ctx.wants("Mean") or ctx.wants("Variance"):
        axes = tuple(range(begin, x.dim()))
        var, mean = torch.var_mean(x.float(), dim=axes, correction=0)
        out["Mean"] = mean.reshape(x.shape[:begin])
        out["Variance"] = var.reshape(x.shape[:begin])
    return out


@register("dropout", dp=rows)
def dropout(ctx):
    """Fluid dropout; the default ``downgrade_in_infer`` keeps x in
    training and scales by (1 - p) in test. The mask draws from the op's
    generator (OpContext.rng)."""
    x = ctx.in_("X")
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.is_test:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out}
    if p == 0.0:
        return {"Out": x}
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=ctx.rng(), device=x.device) < keep
    kept = x / keep if impl == "upscale_in_train" else x
    out = {"Out": torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))}
    if ctx.wants("Mask"):
        out["Mask"] = mask.to(x.dtype)
    return out


@register("im2sequence", dp=rows)
def im2sequence(ctx):
    """Scan the image with a filter and emit one sequence step per window
    position, each step the (C, kh, kw)-flattened patch: Out (N * oh *
    ow, C * kh * kw), batch-major then row-major windows, and Length
    (N,) int64, every image's oh * ow (one static size a batch makes the
    LoD uniform). paddings are (up, left, down, right). The reference's
    input_image_size mode needs per-sample window counts, which static
    shapes cannot give; it raises, as in the JAX package."""
    if ctx.in_("Y") is not None:
        raise NotImplementedError(
            "im2sequence(input_image_size=...) needs per-sample dynamic "
            "window counts; pad images to one static size instead")
    x = ctx.in_("X")
    n, c = x.shape[:2]
    k = _pair(ctx.attr("kernels"))
    s = _pair(ctx.attr("strides", [1, 1]))
    p = ctx.attr("paddings", [0, 0, 0, 0])
    ph = (p[0], p[2] if len(p) > 2 else p[0])
    pw = (p[1], p[3] if len(p) > 3 else p[1])
    xp = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    patches = F.unfold(xp, k, stride=s)            # (N, C*kh*kw, L)
    steps = patches.shape[2]
    out = patches.transpose(1, 2).reshape(n * steps, c * k[0] * k[1])
    return {"Out": out,
            "Length": torch.full((n,), steps, dtype=torch.int64,
                                 device=x.device)}
