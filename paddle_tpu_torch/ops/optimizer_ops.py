"""Optimizer update ops.

Parity: paddle/fluid/operators/optimizers/*_op.*; the counterpart of
``paddle_tpu/ops/optimizer_ops.py`` with ``sgd``, ``momentum`` (Nesterov
too), ``lars_momentum``, ``adam``, ``adamax``, ``adagrad``,
``decayed_adagrad``, ``adadelta``, ``rmsprop`` (centered too), ``ftrl``,
``lamb``, ``adamw``, ``dpsgd``, ``proximal_gd``, ``proximal_adagrad`` and
``decoupled_weight_decay`` (DGC's ops live in ``optimizer/dgc.py``). Each op
consumes Param, Grad (the ``param@GRAD`` env entry the Executor's autograd
pass produced) and its accumulators, and writes the new values back under
the *same* names. Where JAX returns new arrays, the port updates the
scope's tensors in place, as fluid's device kernels do: the Executor runs
these ops under ``torch.no_grad()``, and each returns the tensors it
updated. The arithmetic follows the JAX ops term by term (f32 moments,
beta-pow accumulators multiplied once a step), so the two agree to
rounding. Under data parallelism they take replicated inputs only: the
dp walk reduces the gradients before the ops after the marker run.

On sharded state (ZeRO-1's accumulators, FSDP's parameters and
gradients, the tp rules' parameters: ``ShardedTensor``s) every op has
one shard rule, ``blockwise_update``: the op runs once a held block of
the first sharded input's layout. A slot laid out so gives its part; a
replicated slot of the same global shape is cut to the same block (a
view, updated in place); any other (a ``[1]`` beta power, the learning
rate) is read whole, and the blocks after the first update copies of
it. Each output goes back in its own variable's layout: a sharded one
keeps its parts, a replicated one of the layout's shape is whole again
(in a world each rank's block all-gathered), a whole one is the first
block's. ``lars_momentum``, ``lamb`` and ``dpsgd`` take whole-parameter
norms: their steps yield the squares they sum, and the rule sums them
over the blocks (one reduction) before the square root; ``dpsgd``'s noise
is the global draw, sliced to the block.
"""

import torch

from . import part_context, register, replicated, shard_rule
from ..parallel.sharded import ShardedTensor


def _lr(ctx):
    return ctx.in_("LearningRate").reshape(())


# op type -> its steps: a generator function of the op's context that
# yields the sums of squares its norms need (one tuple) and is sent
# their sums over the whole parameter, then returns the outputs
_NORM_STEPS = {}


def _norm_op(name):
    """Register steps(ctx) as `name`: on a whole parameter its own sums
    answer the yield."""
    def deco(steps):
        _NORM_STEPS[name] = steps

        def impl(ctx):
            gen = steps(ctx)
            try:
                gen.send(next(gen))
            except StopIteration as done:
                return done.value
            raise RuntimeError(f"{name}'s steps yielded twice")
        register(name, dp=replicated)(impl)
        return steps
    return deco


@register("sgd", dp=replicated)
def sgd(ctx):
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    p.sub_((_lr(ctx) * g).to(p.dtype))
    return {"ParamOut": p}


@register("adam", dp=replicated)
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


@register("momentum", dp=replicated)
def momentum(ctx):
    """v = mu v + g; p -= lr v, or lr (g + mu v) with Nesterov."""
    p, g, v = ctx.in_("Param"), ctx.in_("Grad"), ctx.in_("Velocity")
    mu = ctx.attr("mu")
    lr = _lr(ctx)
    v.mul_(mu).add_(g)
    if ctx.attr("use_nesterov", False):
        p.sub_((lr * (g + mu * v)).to(p.dtype))
    else:
        p.sub_((lr * v).to(p.dtype))
    return {"ParamOut": p, "VelocityOut": v}


@_norm_op("lars_momentum")
def lars_momentum(ctx):
    """Layer-wise rate lr coeff |p| / (|g| + wd |p| + 1e-12);
    v = mu v + local_lr (g + wd p); p -= v."""
    p, g, v = ctx.in_("Param"), ctx.in_("Grad"), ctx.in_("Velocity")
    mu = ctx.attr("mu")
    coeff = ctx.attr("lars_coeff", 0.001)
    wd = ctx.attr("lars_weight_decay", 0.0005)
    p_sq, g_sq = yield (p * p).sum(), (g * g).sum()
    pn = p_sq.sqrt()
    gn = g_sq.sqrt()
    local_lr = _lr(ctx) * coeff * pn / (gn + wd * pn + 1e-12)
    v.mul_(mu).add_(local_lr * (g + wd * p))
    p.sub_(v.to(p.dtype))
    return {"ParamOut": p, "VelocityOut": v}


@register("adamax", dp=replicated)
def adamax(ctx):
    """m = b1 m + (1 - b1) g; u = max(b2 u, |g|);
    p -= lr / (1 - b1^t) m / (u + eps)."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    m, inf = ctx.in_("Moment"), ctx.in_("InfNorm")
    b1p = ctx.in_("Beta1Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m.mul_(b1).add_((1 - b1) * g)
    torch.maximum(b2 * inf, g.abs(), out=inf)
    p.sub_(((_lr(ctx) / (1 - b1p.reshape(()))) * (m / (inf + eps)))
           .to(p.dtype))
    b1p.mul_(b1)
    return {"ParamOut": p, "MomentOut": m, "InfNormOut": inf,
            "Beta1PowOut": b1p}


@register("adagrad", dp=replicated)
def adagrad(ctx):
    p, g, mom = ctx.in_("Param"), ctx.in_("Grad"), ctx.in_("Moment")
    eps = ctx.attr("epsilon", 1e-6)
    mom.add_(g * g)
    p.sub_((_lr(ctx) * g / (mom.sqrt() + eps)).to(p.dtype))
    return {"ParamOut": p, "MomentOut": mom}


@register("decayed_adagrad", dp=replicated)
def decayed_adagrad(ctx):
    p, g, mom = ctx.in_("Param"), ctx.in_("Grad"), ctx.in_("Moment")
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    mom.mul_(decay).add_((1 - decay) * g * g)
    p.sub_((_lr(ctx) * g / (mom.sqrt() + eps)).to(p.dtype))
    return {"ParamOut": p, "MomentOut": mom}


@register("adadelta", dp=replicated)
def adadelta(ctx):
    """E[g^2] = rho E[g^2] + (1 - rho) g^2;
    u = -sqrt((E[u^2] + eps) / (E[g^2] + eps)) g;
    E[u^2] = rho E[u^2] + (1 - rho) u^2; p += u."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    asg, asu = ctx.in_("AvgSquaredGrad"), ctx.in_("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    asg.mul_(rho).add_((1 - rho) * g * g)
    upd = -((asu + eps) / (asg + eps)).sqrt() * g
    asu.mul_(rho).add_((1 - rho) * upd * upd)
    p.add_(upd.to(p.dtype))
    return {"ParamOut": p, "AvgSquaredGradOut": asg,
            "AvgSquaredUpdateOut": asu}


@register("rmsprop", dp=replicated)
def rmsprop(ctx):
    """ms = rho ms + (1 - rho) g^2; centered: mg = rho mg + (1 - rho) g,
    the denominator sqrt(ms - mg^2 + eps), else sqrt(ms + eps);
    mom = momentum mom + lr g / denominator; p -= mom."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    ms, mom = ctx.in_("MeanSquare"), ctx.in_("Moment")
    rho = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    momentum_ = ctx.attr("momentum", 0.0)
    lr = _lr(ctx)
    ms.mul_(rho).add_((1 - rho) * g * g)
    outs = {"ParamOut": p, "MeanSquareOut": ms, "MomentOut": mom}
    if ctx.attr("centered", False):
        mg = ctx.in_("MeanGrad")
        mg.mul_(rho).add_((1 - rho) * g)
        denom = (ms - mg * mg + eps).sqrt()
        outs["MeanGradOut"] = mg
    else:
        denom = (ms + eps).sqrt()
    mom.mul_(momentum_).add_(lr * g / denom)
    p.sub_(mom.to(p.dtype))
    return outs


@register("ftrl", dp=replicated)
def ftrl(ctx):
    """FTRL-proximal: n' = n + g^2; sigma = (n'^-lrp - n^-lrp) / lr;
    z' = z + g - sigma p; p = (clip(z', -l1, l1) - z') /
    (n'^-lrp / lr + 2 l2)."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    sq, lin = ctx.in_("SquaredAccumulator"), ctx.in_("LinearAccumulator")
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx)
    new_sq = sq + g * g
    sigma = (new_sq.pow(-lr_power) - sq.pow(-lr_power)) / lr
    lin.add_(g - sigma * p)
    pre = lin.clamp(-l1, l1) - lin
    p.copy_(pre / (new_sq.pow(-lr_power) / lr + 2 * l2))
    sq.copy_(new_sq)
    return {"ParamOut": p, "SquaredAccumOut": sq, "LinearAccumOut": lin}


@_norm_op("lamb")
def lamb(ctx):
    """Adam's moments with bias correction, r = m^ / (sqrt(v^) + eps) +
    wd p, and the trust ratio |p| / |r| (1 where either norm is 0):
    p -= lr trust r."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    m, v = ctx.in_("Moment1"), ctx.in_("Moment2")
    b1p, b2p = ctx.in_("Beta1Pow"), ctx.in_("Beta2Pow")
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-6)
    wd = ctx.attr("weight_decay", 0.01)
    g = g.float()
    pf = p.float()
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    m_hat = m / (1 - b1p.reshape(()))
    v_hat = v / (1 - b2p.reshape(()))
    r = m_hat / (v_hat.sqrt() + eps) + wd * pf
    p_sq, r_sq = yield (pf * pf).sum(), (r * r).sum()
    p_norm = p_sq.sqrt()
    r_norm = r_sq.sqrt()
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones((), dtype=r.dtype, device=r.device))
    p.sub_((_lr(ctx) * trust * r).to(p.dtype))
    b1p.mul_(b1)
    b2p.mul_(b2)
    return {"ParamOut": p, "Moment1Out": m, "Moment2Out": v,
            "Beta1PowOut": b1p, "Beta2PowOut": b2p}


@register("adamw", dp=replicated)
def adamw(ctx):
    """Adam, then p -= lr wd p_old: the decay of the parameter as it was
    before the step (taken before adam updates it in place)."""
    p = ctx.in_("Param")
    decay = _lr(ctx) * ctx.attr("weight_decay", 0.01) * p
    outs = adam(ctx)
    p.sub_(decay.to(p.dtype))
    return outs


@_norm_op("dpsgd")
def dpsgd(ctx):
    """Differentially private SGD: g clipped to norm `clip`, plus Gaussian
    noise of `sigma` from the op's generator (``OpContext.rng``), then
    p -= lr g. The noise is torch's, not JAX's (the streams cannot match);
    under data parallelism the op runs once on the reduced gradient, so
    every rank draws rank 0's noise and the replicas stay equal. On a
    block of a sharded parameter the noise is the global draw's block."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    clip = ctx.attr("clip", 10.0)
    sigma = ctx.attr("sigma", 1.0)
    (g_sq,) = yield ((g * g).sum(),)
    gn = g_sq.sqrt()
    g = g * torch.clamp(clip / gn.clamp_min(1e-12), max=1.0)
    block = getattr(ctx, "block", None)   # None: the whole parameter
    shape, index = block if block is not None else (g.shape, ...)
    noise = torch.randn(shape, generator=ctx.rng(), dtype=g.dtype,
                        device=g.device)[index]
    g = g + sigma * noise
    p.sub_((_lr(ctx) * g).to(p.dtype))
    return {"ParamOut": p}


def _prox(z, lr, l1, l2):
    """sign(z) max(|z| - lr l1, 0) / (1 + lr l2)."""
    return torch.sign(z) * (z.abs() - lr * l1).clamp_min(0.0) \
        / (1.0 + lr * l2)


@register("proximal_gd", dp=replicated)
def proximal_gd(ctx):
    """The proximal step on z = p - lr g (proximal_gd_op)."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    lr = _lr(ctx)
    z = p - lr * g
    p.copy_(_prox(z, lr, ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)))
    return {"ParamOut": p}


@register("proximal_adagrad", dp=replicated)
def proximal_adagrad(ctx):
    """m += g^2; the proximal step at the rate lr / sqrt(m + 1e-10)
    (proximal_adagrad_op)."""
    p, g, m = ctx.in_("Param"), ctx.in_("Grad"), ctx.in_("Moment")
    m.add_(g * g)
    eff = _lr(ctx) / (m + 1e-10).sqrt()
    z = p - eff * g
    p.copy_(_prox(z, eff, ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)))
    return {"ParamOut": p, "MomentOut": m}


@register("decoupled_weight_decay", dp=replicated)
def decoupled_weight_decay(ctx):
    """After the base optimizer's ops: p -= coeff PrevParam, the snapshot
    an ``assign`` took before them (contrib's decoupled weight decay)."""
    p, pre = ctx.in_("Param"), ctx.in_("PrevParam")
    p.sub_((ctx.attr("coeff", 0.0) * pre).to(p.dtype))
    return {"ParamOut": p}


def blockwise_update(impl, ctx, walk):
    """The shard rule of every optimizer op (see the module's docstring).
    Inputs laid out over another layout than the first sharded one's
    leave the op to the global values (None)."""
    op, env = ctx.op, ctx.env
    names = list(dict.fromkeys(op.input_names))
    laid = [env[n] for n in names if isinstance(env[n], ShardedTensor)]
    lay = laid[0]
    if any(v.shape != lay.shape or not v.same_layout(lay.spec, lay.mesh)
           for v in laid[1:]):
        return None
    blocks = lay.blocks()
    outputs = set(op.output_names)
    picks = [{} for _ in blocks]
    # what each input name holds: its part of the layout ("part"), a
    # replicated tensor of the layout's shape ("cut" to each block, a
    # view) or a whole value, which the blocks after the first read as
    # copies where the op updates it in place
    kinds = {}
    for n in names:
        v = env[n]
        if isinstance(v, ShardedTensor):
            kinds[n] = "part"
            for j, part in enumerate(v.parts):
                picks[j][n] = part
        elif isinstance(v, torch.Tensor) and tuple(v.shape) == lay.shape:
            kinds[n] = "cut"
            for j, ix in enumerate(blocks):
                picks[j][n] = v[ix]
        else:
            for j in range(len(blocks)):
                picks[j][n] = v.clone() if j and n in outputs and \
                    isinstance(v, torch.Tensor) else v
    ctxs = [part_context(ctx, pick, (lay.shape, ix))
            for pick, ix in zip(picks, blocks)]
    steps = _NORM_STEPS.get(op.type)
    if steps is None:
        outs = [impl(c) for c in ctxs]
    else:
        gens = [steps(c) for c in ctxs]
        sums = [torch.stack(next(gen)) for gen in gens]
        total = torch.stack(sums).sum(0) if not walk.world else \
            walk.mesh.all_sum(sums, lay.axes[0])
        outs = []
        for gen in gens:
            try:
                gen.send(tuple(total))
            except StopIteration as done:
                outs.append(done.value)
    result = {}
    for slot, first in outs[0].items():
        name = op.output(slot)[0]
        vals = [o[slot] for o in outs]
        if kinds.get(name) == "part":
            result[slot] = lay.like(vals)
        elif kinds.get(name) == "cut":
            full = env[name]
            with torch.no_grad():
                for val, ix in zip(vals, blocks):
                    if val.data_ptr() != full[ix].data_ptr():
                        full[ix].copy_(val)
                if walk.world:      # the other ranks' blocks
                    full.copy_(walk.mesh.all_concat(
                        [full[blocks[0]]], lay.axes[0], _sharded_dim(lay)))
            result[slot] = full
        else:
            result[slot] = first
    return result


def _sharded_dim(lay):
    (dim,) = [d for d, e in enumerate(lay.spec) if e is not None]
    return dim


shard_rule("sgd", "adam", "momentum", "lars_momentum", "adamax", "adagrad",
           "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb", "adamw",
           "dpsgd", "proximal_gd", "proximal_adagrad",
           "decoupled_weight_decay")(blockwise_update)
