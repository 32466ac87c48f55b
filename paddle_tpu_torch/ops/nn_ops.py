"""Neural-network ops.

Parity: paddle/fluid/operators/{layer_norm,dropout}_op.*; the counterpart
of ``paddle_tpu/ops/nn_ops.py`` with the ops the ported slice runs.
"""

import torch
import torch.nn.functional as F

from . import register


@register("layer_norm")
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


@register("dropout")
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
