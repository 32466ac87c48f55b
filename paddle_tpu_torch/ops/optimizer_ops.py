"""Optimizer update ops.

Parity: paddle/fluid/operators/optimizers/{sgd,adam}_op.*; the counterpart
of ``paddle_tpu/ops/optimizer_ops.py`` with ``sgd`` and ``adam``. Each op
consumes Param, Grad (the ``param@GRAD`` env entry the Executor's autograd
pass produced) and its accumulators, and writes the new values back under
the *same* names. Where JAX returns new arrays, the port updates the
scope's tensors in place, as fluid's device kernels do: the Executor runs
these ops under ``torch.no_grad()``, and each returns the tensors it
updated. The arithmetic follows the JAX ops term by term (f32 moments,
beta-pow accumulators multiplied once a step), so the two agree to
rounding.
"""

from . import register


def _lr(ctx):
    return ctx.in_("LearningRate").reshape(())


@register("sgd")
def sgd(ctx):
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    p.sub_((_lr(ctx) * g).to(p.dtype))
    return {"ParamOut": p}


@register("adam")
def adam(ctx):
    """m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps), with the
    epsilon outside the bias correction (fluid's adam_op.h)."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    m, v = ctx.in_("Moment1"), ctx.in_("Moment2")
    b1p, b2p = ctx.in_("Beta1Pow"), ctx.in_("Beta2Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    g = g.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    lr_t = _lr(ctx) * (1 - b2p.reshape(())).sqrt() / (1 - b1p.reshape(()))
    p.sub_((lr_t * m / (v.sqrt() + eps)).to(p.dtype))
    b1p.mul_(b1)
    b2p.mul_(b2)
    return {"ParamOut": p, "Moment1Out": m, "Moment2Out": v,
            "Beta1PowOut": b1p, "Beta2PowOut": b2p}
