"""Neural-network ops.

Parity: paddle/fluid/operators/{conv,conv_transpose,pool,pool_with_index,
unpool,spp,batch_norm,layer_norm,group_norm,instance_norm,data_norm,
spectral_norm,lrn,interpolate,temporal_shift,grid_sampler,affine_grid,
unfold,deformable_conv,...}_op.*; the counterpart of
``paddle_tpu/ops/nn_ops.py``, every op of it under the same names and
attributes.

The convolutions (2-D, 3-D, and their transposes) are torch's (cuDNN on
the card), as the JAX package's are XLA's ``lax.conv_general_dilated``:
no Pallas kernel stands behind them.
Their f32 precision is explicit: the forward and its backward run with
cuDNN's TF32 off (``_cudnn_f32``), so an f32 convolution is a full f32
product whatever ``torch.backends.cudnn.allow_tf32`` the caller's
process holds, as the port's f32 matmuls are (and the JAX package's under
``jax_default_matmul_precision="highest"``). The flag is set around each
call and restored after it; nothing is flipped at import. Under amp a
white-listed convolution reads bf16 input and filter
(``OpContext._maybe_amp``) and TF32 does not apply.

Under data parallelism the per-sample ops run a rank's rows: the
convolutions (against a replicated filter), the pools (their indices
address a sample's own plane), the resizes, ``group_norm``,
``instance_norm``, ``layer_norm`` (where it normalizes from an axis >=
1), ``dropout`` (with the rank folded into its generator's seed,
``OpContext.rng``), ``lrn``, ``grid_sampler`` and the rest;
``temporal_shift`` where a rank holds whole videos; ``spectral_norm``
takes a replicated weight only. ``data_norm`` has a rule of its own (its
summaries count the global batch).
``batch_norm`` and ``sync_batch_norm`` share one rule of their own: the
batch statistics are the global batch's, summed over dp, as the JAX
package's plain ``batch_norm`` takes them under GSPMD.
"""

import contextlib

import torch
import torch.nn.functional as F

from . import Sharded, refuses, register, replicated, rows, rows_if



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
    """A convolution (F.conv2d / conv3d, or with `transposed` F.conv_
    transpose2d / 3d), and its backward
    (``aten.convolution_backward``), each under _cudnn_f32: autograd
    runs a backward after the forward's context has closed, so a plain
    F.conv2d's backward would read the process's flag."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups,
                transposed=False, output_padding=None):
        ctx.save_for_backward(x, w)
        output_padding = output_padding or (0,) * len(stride)
        ctx.conf = (stride, padding, dilation, transposed, output_padding,
                    groups)
        with _cudnn_f32():
            if transposed:
                fn = (F.conv_transpose2d if x.dim() == 4
                      else F.conv_transpose3d)
                return fn(x, w, None, stride, padding, output_padding,
                          groups, dilation)
            fn = F.conv2d if x.dim() == 4 else F.conv3d
            return fn(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _cudnn_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, *ctx.conf,
                (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return gx, gw, None, None, None, None, None, None


def _filter_replicated(ctx, walk):
    if ctx.is_sharded("Filter"):
        return "the filter is dp-sharded"
    return None


@register("conv2d", "depthwise_conv2d", dp=rows_if(_filter_replicated))
def conv2d(ctx):
    """NCHW input, OIHW filter, with strides, paddings (each side),
    dilations and groups; the Bias, where given, added per output
    channel. In f32 a full f32 product (_Conv2d)."""
    return _with_bias(ctx, _Conv2d.apply(
        ctx.in_("Input"), ctx.in_("Filter"),
        _pair(ctx.attr("strides", [1, 1])),
        _pair(ctx.attr("paddings", [0, 0])),
        _pair(ctx.attr("dilations", [1, 1])), ctx.attr("groups", 1) or 1))


def _with_bias(ctx, out):
    """{"Output", "Out"}: out plus the Bias, where given, a channel."""
    bias = ctx.in_("Bias")
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))
    return {"Output": out, "Out": out}


_POOLS = {2: (F.max_pool2d, F.avg_pool2d), 3: (F.max_pool3d, F.avg_pool3d)}


def _pool(x, pool_type, ksize, strides, pads, exclusive, global_pool):
    """2-D or 3-D pooling (NC + spatial). Max pooling pads with -inf;
    average pooling divides by the count of real cells where `exclusive`
    and there is padding, else by the window's size."""
    nd = x.dim() - 2
    spatial = tuple(range(2, x.dim()))
    if global_pool:
        return (x.amax(spatial, keepdim=True) if pool_type == "max"
                else x.mean(spatial, keepdim=True))
    max_pool, avg_pool = _POOLS[nd]
    if all(2 * p <= k for p, k in zip(pads, ksize)):  # torch's own padding
        if pool_type == "max":
            return max_pool(x, ksize, strides, pads)
        return avg_pool(x, ksize, strides, pads,
                        count_include_pad=not exclusive)
    padn = tuple(q for p in reversed(pads) for q in (p, p))
    if pool_type == "max":
        return max_pool(F.pad(x, padn, value=float("-inf")), ksize, strides)
    out = avg_pool(F.pad(x, padn), ksize, strides)
    if exclusive:
        cells = F.pad(torch.ones_like(x[:1, :1]), padn)
        out = out / avg_pool(cells, ksize, strides)
    return out


def _pool_op(nd):
    def impl(ctx):
        return {"Out": _pool(ctx.in_("X"), ctx.attr("pooling_type", "max"),
                             _pair(ctx.attr("ksize", [2] * nd), nd),
                             _pair(ctx.attr("strides", [1] * nd), nd),
                             _pair(ctx.attr("paddings", [0] * nd), nd),
                             ctx.attr("exclusive", True),
                             ctx.attr("global_pooling", False))}
    return impl


register("pool2d", dp=rows)(_pool_op(2))
register("pool3d", dp=rows)(_pool_op(3))


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
    shape) only where something reads them. Scale and bias apply in f32
    whatever their dtype, as JAX's f32 y promotes a bf16 scale."""
    x = ctx.in_("X")
    begin = ctx.attr("begin_norm_axis", 1)
    eps = ctx.attr("epsilon", 1e-5)
    norm_shape = tuple(x.shape[begin:])
    scale = ctx.in_("Scale")
    bias = ctx.in_("Bias")
    y = F.layer_norm(x.float(), norm_shape,
                     None if scale is None
                     else scale.reshape(norm_shape).float(),
                     None if bias is None
                     else bias.reshape(norm_shape).float(),
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


# -- the other convolutions ---------------------------------------------------

@register("conv3d", dp=rows_if(_filter_replicated))
def conv3d(ctx):
    """NCDHW input, OIDHW filter; no Bias, as the JAX op."""
    out = _Conv2d.apply(ctx.in_("Input"), ctx.in_("Filter"),
                        _pair(ctx.attr("strides", [1, 1, 1]), 3),
                        _pair(ctx.attr("paddings", [0, 0, 0]), 3),
                        _pair(ctx.attr("dilations", [1, 1, 1]), 3),
                        ctx.attr("groups", 1) or 1)
    return {"Output": out, "Out": out}


def _conv_transpose(nd):
    """The transposed convolution of any groups: Fluid's filter layout
    (C_in, C_out / g, *k) is torch's. out = (in - 1) s - 2 p + d (k - 1)
    + 1 (conv_transpose_op.cc; the JAX package's explicit padding
    (k - 1) d - p a side): the output padding is 0, and a layer's
    output_size only picks the filter size."""
    def impl(ctx):
        out = _Conv2d.apply(ctx.in_("Input"), ctx.in_("Filter"),
                            _pair(ctx.attr("strides", [1] * nd), nd),
                            _pair(ctx.attr("paddings", [0] * nd), nd),
                            _pair(ctx.attr("dilations", [1] * nd), nd),
                            ctx.attr("groups", 1) or 1, True, (0,) * nd)
        return _with_bias(ctx, out)
    return impl


# depthwise is the grouped path with groups == C_in
register("conv2d_transpose", "depthwise_conv2d_transpose",
         dp=rows_if(_filter_replicated))(_conv_transpose(2))
register("conv3d_transpose", dp=rows_if(_filter_replicated))(
    _conv_transpose(3))


# -- pools with an index, unpool, spp -----------------------------------------

@register("adaptive_pool3d", dp=rows)
def adaptive_pool3d(ctx):
    """adaptive_pool2d in 3-D (NCDHW): the floor/ceil windows, and with
    require_index the argmax Mask as a flat index into the input's
    D x H x W volume, int32 as adaptive_pool2d's."""
    x = ctx.in_("X")
    size = tuple(int(s) for s in ctx.attr("pool_size"))
    if ctx.attr("pooling_type", "avg") == "avg":
        return {"Out": F.adaptive_avg_pool3d(x, size)}
    out, idx = F.adaptive_max_pool3d(x, size, return_indices=True)
    res = {"Out": out}
    if ctx.attr("require_index", False):
        res["Mask"] = idx.to(torch.int32)
    return res


def _max_pool_with_index(nd):
    """pool_with_index_op: max pooling and its argmax Mask, a flat index
    into the unpadded input's plane (volume), int64 (C12's policy; JAX's
    is int32). The padding reads finfo.min / 2, as the JAX op's (not
    -inf); on ties the window's first cell wins. The windows are views
    (Tensor.unfold a spatial dim); Out is their amax (a tie's gradient
    split evenly, as jnp.max's). adaptive=True takes the adaptive
    windows (torch's, the reference's floor/ceil). Under dp each rank
    pools its rows: Mask indexes a sample's own plane."""
    adaptive_fn = (F.adaptive_max_pool2d if nd == 2
                   else F.adaptive_max_pool3d)

    def impl(ctx):
        x = ctx.in_("X")
        spatial = tuple(x.shape[2:])
        ksize = _pair(ctx.attr("ksize"), nd)
        if ctx.attr("adaptive", False):
            out, idx = adaptive_fn(x, ksize, return_indices=True)
            return {"Out": out, "Mask": idx}
        strides = _pair(ctx.attr("strides", ksize), nd)
        pads = _pair(ctx.attr("paddings", [0] * nd), nd)
        if ctx.attr("global_pooling", False):
            ksize, strides, pads = spatial, spatial, (0,) * nd
        padn = tuple(q for p in reversed(pads) for q in (p, p))
        win = F.pad(x, padn, value=torch.finfo(x.dtype).min / 2)
        for i in range(nd):
            win = win.unfold(2 + i, ksize[i], strides[i])
        outs = tuple(win.shape[2:2 + nd])
        win = win.reshape(tuple(x.shape[:2]) + outs + (-1,))
        am = win.argmax(-1)
        offs = []
        for k in reversed(ksize):
            offs.insert(0, am % k)
            am = am // k
        idx = 0
        for i in range(nd):
            origin = torch.arange(outs[i], device=x.device) * strides[i] \
                - pads[i]
            shape = [outs[i] if j == i else 1 for j in range(nd)]
            idx = idx * spatial[i] + origin.reshape(shape) + offs[i]
        return {"Out": win.amax(-1), "Mask": idx}
    return impl


register("max_pool2d_with_index", dp=rows)(_max_pool_with_index(2))
register("max_pool3d_with_index", dp=rows)(_max_pool_with_index(3))


@register("unpool", dp=rows)
def unpool(ctx):
    """unpool_op (max unpooling): each pooled value scattered to its
    Indices' flat position in a zero plane of (in - 1) stride - 2 pad +
    ksize (or the output_size attr). Under dp each rank scatters its
    rows (Indices index a sample's own plane)."""
    x, idx = ctx.in_("X"), ctx.in_("Indices")
    n, c, ph, pw = x.shape
    ksize = _pair(ctx.attr("ksize"))
    strides = _pair(ctx.attr("strides", ksize))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    osize = ctx.attr("output_size", None)
    if osize:
        oh, ow = osize[-2], osize[-1]
    else:
        oh = (ph - 1) * strides[0] - 2 * pads[0] + ksize[0]
        ow = (pw - 1) * strides[1] - 2 * pads[1] + ksize[1]
    flat = x.new_zeros((n, c, oh * ow)).scatter(
        2, idx.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return {"Out": flat.reshape(n, c, oh, ow)}


@register("spp", dp=rows)
def spp(ctx):
    """spp_op (spatial pyramid pooling): level i pools adaptively into
    2^i x 2^i bins; the flattened bins of every level concatenated,
    (N, C sum 4^i). Under dp each rank pools its rows."""
    x = ctx.in_("X")
    fn = (F.adaptive_max_pool2d if ctx.attr("pooling_type", "max") == "max"
          else F.adaptive_avg_pool2d)
    n = x.shape[0]
    return {"Out": torch.cat(
        [fn(x, 2 ** i).reshape(n, -1)
         for i in range(int(ctx.attr("pyramid_height", 1)))], 1)}


# -- resizes ------------------------------------------------------------------

def _interp_src(out_size, in_size, align_corners, align_mode, device):
    """The source coordinate of each output index (bilinear_interp_op.h):
    align_corners -> d (in - 1) / (out - 1); else d in / out with
    align_mode 0 the half-pixel (d + 0.5) r - 0.5 and align_mode 1 the
    Fluid legacy d r, which no mode of F.interpolate computes; clamped
    to [0, in - 1]. A size-1 output samples pixel 0 in every mode (the
    reference computes the ratio only for out > 1)."""
    if out_size <= 1:
        return torch.zeros(out_size, dtype=torch.float32, device=device)
    d = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners:
        src = d * ((in_size - 1) / (out_size - 1))
    else:
        ratio = in_size / out_size
        src = (d + 0.5) * ratio - 0.5 if align_mode == 0 else d * ratio
    return src.clamp(0.0, in_size - 1)


def _lerp_axis(x, axis, out_size, align_corners, align_mode):
    """Linear interpolation along `axis`: two gathers and a lerp.
    Integer inputs interpolate in f32 (the caller rounds back)."""
    if not x.is_floating_point():
        x = x.float()
    in_size = x.shape[axis]
    src = _interp_src(out_size, in_size, align_corners, align_mode,
                      x.device)
    i0 = torch.floor(src)
    lo = i0.long()
    hi = (lo + 1).clamp_max(in_size - 1)
    a = x.index_select(axis, lo)
    b = x.index_select(axis, hi)
    shape = [1] * x.dim()
    shape[axis] = -1
    return a + (b - a) * (src - i0).reshape(shape).to(x.dtype)


def _cast_like(out, dtype):
    if out.dtype == dtype:
        return out
    if not dtype.is_floating_point:
        out = torch.round(out)
    return out.to(dtype)


def _resize_sizes(ctx, x, nd):
    scale = ctx.attr("scale", 0.0)
    if scale and scale > 0:
        return [int(s * scale) for s in x.shape[2:]]
    return [ctx.attr(n, -1) for n in ("out_d", "out_h", "out_w")[3 - nd:]]


def _linear_interp(nd):
    """bilinear_interp (nd 2) / trilinear_interp (nd 3): separable
    lerps along each spatial axis, align_corners defaulting to True and
    align_mode to 1, as Fluid's."""
    def impl(ctx):
        x = ctx.in_("X")
        ac = bool(ctx.attr("align_corners", True))
        am = ctx.attr("align_mode", 1)
        out = x
        for axis, size in enumerate(_resize_sizes(ctx, x, nd), 2):
            out = _lerp_axis(out, axis, size, ac, am)
        return {"Out": _cast_like(out, x.dtype)}
    return impl


register("bilinear_interp", dp=rows)(_linear_interp(2))
register("trilinear_interp", dp=rows)(_linear_interp(3))


@register("nearest_interp", dp=rows)
def nearest_interp(ctx):
    """nearest_interp_op: align_corners rounds the corner-aligned source
    (floor(src + 0.5)); otherwise it floors the legacy d in / out
    (torch's "nearest" always floors)."""
    x = ctx.in_("X")
    ac = bool(ctx.attr("align_corners", True))
    out = x
    for axis, size in enumerate(_resize_sizes(ctx, x, 2), 2):
        in_size = out.shape[axis]
        src = _interp_src(size, in_size, ac, 1, x.device)
        idx = torch.floor(src + 0.5) if ac else torch.floor(src)
        out = out.index_select(axis, idx.clamp(0, in_size - 1).long())
    return {"Out": out}


# -- normalizations -----------------------------------------------------------

def _affine(y, ctx, c):
    shape = [1, c] + [1] * (y.dim() - 2)
    scale, bias = ctx.in_("Scale"), ctx.in_("Bias")
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


@register("group_norm", dp=rows)
def group_norm(ctx):
    """Each sample's channels in `groups` groups, normalized over a
    group's channels and positions in f32 (biased variance); Y in x's
    dtype, Mean / Variance (N, groups)."""
    x = ctx.in_("X")
    g = ctx.attr("groups")
    n, c = x.shape[:2]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:])).float()
    var, mean = torch.var_mean(xg, dim=tuple(range(2, xg.dim())),
                               keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + ctx.attr("epsilon", 1e-5))) \
        .reshape(x.shape)
    return {"Y": _affine(y, ctx, c).to(x.dtype), "Mean": mean.reshape(n, g),
            "Variance": var.reshape(n, g)}


@register("instance_norm", dp=rows)
def instance_norm(ctx):
    """Each (sample, channel) normalized over its positions, in x's
    dtype (biased variance), as the JAX op."""
    x = ctx.in_("X")
    var, mean = torch.var_mean(x, dim=tuple(range(2, x.dim())),
                               keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + ctx.attr("epsilon", 1e-5))
    return {"Y": _affine(y, ctx, x.shape[1])}


def _data_norm_y(ctx):
    x = ctx.in_("X")
    mean = ctx.in_("BatchSum") / ctx.in_("BatchSize")
    # data_norm_op.cc:36: the square sum is already centered (+ N eps)
    scale = torch.sqrt(ctx.in_("BatchSize") / ctx.in_("BatchSquareSum"))
    return x, mean, scale, (x - mean) * scale


def _data_norm_summaries(ctx, n, xsum, sqsum):
    """The summaries moved by a batch of n rows, outside autograd:
    stat' = decay stat + the batch's contribution (the reference's
    pseudo-gradients, data_norm_op.cc's grad kernel)."""
    decay = ctx.attr("summary_decay_rate", 0.9999999)
    with torch.no_grad():
        return {"BatchSizeOut": decay * ctx.in_("BatchSize") + n,
                "BatchSumOut": decay * ctx.in_("BatchSum") + xsum,
                "BatchSquareSumOut": decay * ctx.in_("BatchSquareSum")
                + sqsum + n * ctx.attr("epsilon", 1e-4)}


def _dp_data_norm(impl, ctxs, walk):
    """Each rank normalizes its rows by the replicated summaries; in
    training the summaries count the global batch: its size (rows x dp)
    and one dp sum each for the column sums and the centered squares,
    as _dp_batch_norm takes the batch statistics."""
    outs = [_data_norm_y(c) for c in ctxs]
    x0, mean, scale, _ = outs[0]
    res = {"Y": Sharded([o[3] for o in outs]), "Means": mean,
           "Scales": scale}
    if not ctxs[0].is_test:
        res.update(_data_norm_summaries(
            ctxs[0], x0.shape[0] * walk.size,
            walk.sum([o[0].detach().sum(0) for o in outs]),
            walk.sum([((o[0].detach() - mean) ** 2).sum(0) for o in outs])))
    return res


@register("data_norm", dp=_dp_data_norm)
def data_norm(ctx):
    """data_norm_op (CTR feature normalization by batch summaries): Y =
    (x - sum / size) sqrt(size / square_sum). In training the update of
    the summaries is folded into the forward, as the JAX package does;
    test mode skips it."""
    x, mean, scale, y = _data_norm_y(ctx)
    out = {"Y": y, "Means": mean, "Scales": scale}
    if not ctx.is_test:
        xd = x.detach()
        out.update(_data_norm_summaries(ctx, x.shape[0], xd.sum(0),
                                        ((xd - mean) ** 2).sum(0)))
    return out


@register("spectral_norm", dp=replicated)
def spectral_norm(ctx):
    """Weight / sigma, sigma = u W v after `power_iters` power
    iterations from U and V on W moved to (W.shape[dim], -1). U and V
    are constants to the gradient (the reference's buffers, the JAX
    op's stop_gradient) and come out as UOut / VOut, which the layer
    writes back, so one iteration a step converges across steps."""
    w = ctx.in_("Weight")
    dim = ctx.attr("dim", 0)
    eps = ctx.attr("eps", 1e-12)
    wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    with torch.no_grad():
        u, v = ctx.in_("U").reshape(-1), ctx.in_("V").reshape(-1)
        wd = wm.detach()
        for _ in range(ctx.attr("power_iters", 1)):
            v = wd.t() @ u
            v = v / torch.linalg.vector_norm(v).clamp_min(eps)
            u = wd @ v
            u = u / torch.linalg.vector_norm(u).clamp_min(eps)
    return {"Out": w / (u @ wm @ v), "UOut": u, "VOut": v}


@register("lrn", dp=rows)
def lrn(ctx):
    """Out = x / (k + alpha acc)^beta, acc the sum of squares over the n
    channels around each one (zero-padded): alpha is not divided by n,
    where F.local_response_norm divides it. MidOut is acc, as the JAX
    op's."""
    x = ctx.in_("X")  # NCHW
    n = ctx.attr("n", 5)
    half = n // 2
    pad = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = pad[:, 0:c]
    for i in range(1, n):
        acc = acc + pad[:, i:i + c]
    return {"Out": x / torch.pow(ctx.attr("k", 1.0)
                                 + ctx.attr("alpha", 1e-4) * acc,
                                 ctx.attr("beta", 0.75)),
            "MidOut": acc}


@register("affine_channel", dp=rows)
def affine_channel(ctx):
    """x scale + bias a channel (axis 1 in NCHW, the last in NHWC)."""
    x = ctx.in_("X")
    shape = [1] * x.dim()
    shape[1 if ctx.attr("data_layout", "NCHW") == "NCHW" else -1] = -1
    return {"Out": x * ctx.in_("Scale").reshape(shape)
            + ctx.in_("Bias").reshape(shape)}


# -- the rest -----------------------------------------------------------------

def _dp_temporal_shift(impl, ctxs, walk):
    """Each rank shifts its rows, which must be whole videos: where a
    rank's rows are not a multiple of seg_num it refuses at dp > 1."""
    nt, t = ctxs[0].in_("X").shape[0], ctxs[0].attr("seg_num")
    if nt % t:
        return refuses(f"a rank's {nt} rows are not whole videos of "
                       f"seg_num {t} frames")(impl, ctxs, walk)
    return rows(impl, ctxs, walk)


@register("temporal_shift", dp=_dp_temporal_shift)
def temporal_shift(ctx):
    """temporal_shift_op.h:52-72 on (N T, C, H, W): the first
    int(C shift_ratio) channels read frame t - 1, the next as many frame
    t + 1, the clip's edges zero; the rest unshifted."""
    x = ctx.in_("X")
    t = ctx.attr("seg_num")
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // t, t, c, h, w)
    c1 = int(c * ctx.attr("shift_ratio", 0.25))
    zero = x5.new_zeros((nt // t, 1, c1, h, w))
    fwd = torch.cat([zero, x5[:, :-1, :c1]], 1)
    bwd = torch.cat([x5[:, 1:, c1:2 * c1], zero], 1)
    return {"Out": torch.cat([fwd, bwd, x5[:, :, 2 * c1:]], 2)
            .reshape(x.shape)}


@register("grid_sampler", dp=rows)
def grid_sampler(ctx):
    """Bilinear sampling of X (NCHW) at Grid (N, Hg, Wg, 2) in [-1, 1]
    (corners aligned). The four corner indices are clamped into the
    image and weighted by the unclamped coordinates, as the JAX op does:
    not F.grid_sample with zero padding off the image."""
    x, grid = ctx.in_("X"), ctx.in_("Grid")
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    bidx = torch.arange(n, device=x.device).reshape(n, 1, 1)

    def sample(yy, xx):  # (N, Hg, Wg, C)
        return x[bidx, :, yy.clamp(0, h - 1).long(),
                 xx.clamp(0, w - 1).long()]

    out = (sample(y0, x0) * ((x1 - gx) * (y1 - gy))[..., None]
           + sample(y1, x0) * ((x1 - gx) * (gy - y0))[..., None]
           + sample(y0, x1) * ((gx - x0) * (y1 - gy))[..., None]
           + sample(y1, x1) * ((gx - x0) * (gy - y0))[..., None])
    return {"Output": out.movedim(-1, 1)}


@register("affine_grid", dp=rows)
def affine_grid(ctx):
    """Theta (N, 2, 3) -> the sampling grid (N, H, W, 2) over corner-
    aligned coordinates in [-1, 1]. A tensor OutputShape is read on the
    host (one sync); the attr output_shape needs none."""
    theta = ctx.in_("Theta")
    shape = ctx.attr("output_shape")
    if ctx.in_("OutputShape") is not None:
        shape = ctx.in_("OutputShape").tolist()
    _n, _c, h, w = (int(s) for s in shape)
    kw = {"dtype": theta.dtype, "device": theta.device}
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, **kw),
                            torch.linspace(-1.0, 1.0, w, **kw),
                            indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)   # (H, W, 3)
    grid = torch.einsum("hwk,nak->nhwa", base, theta)
    return {"Output": grid, "Out": grid}


@register("unfold", dp=rows)
def unfold(ctx):
    """im2col: (N, C, H, W) -> (N, C kh kw, L), paddings [top, left,
    bottom, right] (or 2 / 1 ints)."""
    x = ctx.in_("X")
    p = ctx.attr("paddings", [0, 0, 0, 0])
    ph = (p[0], p[2] if len(p) > 2 else p[0])
    pw = (p[1], p[3] if len(p) > 3 else p[1])
    return {"Y": F.unfold(F.pad(x, (pw[0], pw[1], ph[0], ph[1])),
                          _pair(ctx.attr("kernel_sizes")),
                          dilation=_pair(ctx.attr("dilations", [1, 1])),
                          stride=_pair(ctx.attr("strides", [1, 1])))}


@register("deformable_conv", "deformable_conv_v1",
          dp=rows_if(_filter_replicated))
def deformable_conv(ctx):
    """Deformable convolution (v1; v2 with a Mask): each output position
    and tap samples X bilinearly at its base position plus the learned
    Offset (zero off the image), the Mask scales the samples, and one
    einsum contracts them with the filter. Plain torch: no finished
    deformable kernel exists on the card."""
    x, offset, w = ctx.in_("Input"), ctx.in_("Offset"), ctx.in_("Filter")
    mask = ctx.in_("Mask")
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    dils = _pair(ctx.attr("dilations", [1, 1]))
    n, c, h, wd = x.shape
    kh, kw = w.shape[2:]
    ho = (h + 2 * pads[0] - dils[0] * (kh - 1) - 1) // strides[0] + 1
    wo = (wd + 2 * pads[1] - dils[1] * (kw - 1) - 1) // strides[1] + 1
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * strides[0] - pads[0])[
        :, None, None, None] + (torch.arange(kh, device=dev) * dils[0])[
        None, None, :, None]                             # (Ho, 1, kh, 1)
    base_x = (torch.arange(wo, device=dev) * strides[1] - pads[1])[
        None, :, None, None] + (torch.arange(kw, device=dev) * dils[1])[
        None, None, None, :]                             # (1, Wo, 1, kw)
    off = offset.reshape(n, kh, kw, 2, ho, wo)
    py = base_y[None] + off[:, :, :, 0].permute(0, 3, 4, 1, 2)
    px = base_x[None] + off[:, :, :, 1].permute(0, 3, 4, 1, 2)
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    flat = x.reshape(n, c, h * wd)

    def sample(yy, xx):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= wd - 1)
        idx = (yy.clamp(0, h - 1).long() * wd
               + xx.clamp(0, wd - 1).long()).reshape(n, 1, -1)
        g = torch.gather(flat, 2, idx.expand(n, c, idx.shape[2]))
        return g.reshape(n, c, ho, wo, kh, kw) * valid[:, None].to(x.dtype)

    v = (sample(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
         + sample(y0, x0 + 1) * ((1 - wy) * wx)[:, None]
         + sample(y0 + 1, x0) * (wy * (1 - wx))[:, None]
         + sample(y0 + 1, x0 + 1) * (wy * wx)[:, None])
    if mask is not None:
        v = v * mask.reshape(n, kh, kw, ho, wo).permute(0, 3, 4, 1, 2)[
            :, None]
    out = torch.einsum("nchwyx,ocyx->nohw", v, w)
    return {"Output": out, "Out": out}


@register("fsp", dp=rows)
def fsp(ctx):
    """The FSP (Gram) matrix of two feature maps: (N, Ca, Cb), the
    positions' mean of their products."""
    a, b = ctx.in_("X"), ctx.in_("Y")
    n, ca, h, w = a.shape
    return {"Out": torch.einsum("nax,nbx->nab", a.reshape(n, ca, h * w),
                                b.reshape(n, b.shape[1], h * w))
            / float(h * w)}


@register("similarity_focus", dp=rows)
def similarity_focus(ctx):
    """similarity_focus_op.h:76-105: for each index along `axis`, pick
    greedily min(D2, D3) of the slice's largest cells, no two in one
    row or column (a masked argmax a step, first index on ties, as
    jnp.argmax), and mark them across the axis. A 0/1 mask: no
    gradient, as the JAX op's."""
    x = ctx.in_("X")
    axis = ctx.attr("axis", 1)
    xm = x.detach().movedim(axis, 1)                 # (N, A, D2, D3)
    n, _a, d2, d3 = xm.shape
    rows_ = torch.arange(n, device=x.device)
    out = torch.zeros_like(xm)
    for index in ctx.attr("indexes", [0]):
        sl = xm[:, index]
        used_r = torch.zeros((n, d2), dtype=torch.bool, device=x.device)
        used_c = torch.zeros((n, d3), dtype=torch.bool, device=x.device)
        mask = torch.zeros_like(sl)
        for _ in range(min(d2, d3)):
            vals = sl.masked_fill(used_r[:, :, None] | used_c[:, None, :],
                                  float("-inf"))
            flat = vals.reshape(n, -1).argmax(1)
            r, c = flat // d3, flat % d3
            used_r[rows_, r] = True
            used_c[rows_, c] = True
            mask[rows_, r, c] = 1.0
        out = out + mask[:, None]
    return {"Out": torch.clamp(out, max=1.0).movedim(1, axis)}


def _weight_replicated(ctx, walk):
    if ctx.is_sharded("Weight"):
        return "the weight is dp-sharded"
    return None


@register("bilinear_tensor_product", dp=rows_if(_weight_replicated))
def bilinear_tensor_product(ctx):
    """out[:, i] = x W_i y^T (+ b)."""
    out = torch.einsum("nd,sde,ne->ns", ctx.in_("X"), ctx.in_("Weight"),
                       ctx.in_("Y"))
    bias = ctx.in_("Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": out}
