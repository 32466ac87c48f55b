"""Deep Gradient Compression momentum (DGC).

Parity: fluid.optimizer.DGCMomentumOptimizer; the counterpart of
``paddle_tpu/optimizer/dgc.py``: top-k sparsification of the velocity
with local residual accumulation and momentum correction (Lin et al.).
Only the entries of |v| above its `ratio` quantile update the parameter;
the rest stay in the residual V until they grow. Before
`rampup_begin_step` the op is plain Momentum. Under data parallelism the
ops run once on the reduced gradient (``dp=replicated``), so every rank
computes the same mask and the replicas stay equal. The ops update the
scope's tensors in place, as the other optimizer ops do.
"""

import torch

from .optimizers import Optimizer
from ..ops import register, replicated


def _quantile_linear(x, q):
    """jnp.quantile(x, q) with its default "linear" interpolation, for a
    1-D tensor `x` and a 0-d tensor `q` on x's device, without a host
    sync: a sort, then the two neighbours of q (n - 1) in float64.
    ``torch.quantile`` cannot serve: it raises for inputs of more than
    2**24 elements, and BERT-base's word embedding has 23.4 M."""
    n = x.numel()
    s = torch.sort(x).values
    pos = q.double() * (n - 1)
    lo = pos.floor()
    w = pos - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=n - 1)
    return (s[lo].double() * (1.0 - w) + s[hi].double() * w).to(x.dtype)


@register("dgc_momentum", dp=replicated)
def dgc_momentum(ctx):
    """u' = mu u + g, v' = v + u'; keep = |v'| > the `SparsityRatio`
    quantile of |v'|; p -= lr v' keep, and the kept entries leave u and
    v. A ratio of 0 (before the ramp) is Momentum: p -= lr u', u = u',
    v = 0."""
    p, g = ctx.in_("Param"), ctx.in_("Grad")
    u, v = ctx.in_("U"), ctx.in_("V")
    mu = ctx.attr("mu", 0.9)
    ratio = ctx.in_("SparsityRatio").reshape(())
    lr = ctx.in_("LearningRate").reshape(())
    u_new = mu * u + g
    v_new = v + u_new
    mag = v_new.abs()
    thresh = _quantile_linear(mag.reshape(-1),
                              torch.clamp(ratio, 0.0, 1.0 - 1e-6))
    keep = mag > thresh
    dense = ratio <= 0.0
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    p.copy_(torch.where(dense, p - lr * u_new,
                        p - lr * torch.where(keep, v_new, zero)).to(p.dtype))
    u.copy_(torch.where(dense | ~keep, u_new, zero))
    v.copy_(torch.where(dense | keep, zero, v_new))
    return {"ParamOut": p, "UOut": u, "VOut": v}


@register("dgc_sparsity_ramp", dp=replicated)
def dgc_sparsity_ramp(ctx):
    """The drop ratio at step `Step`: 0 before `rampup_begin`, then the
    `sparsity` levels in turn, each for rampup_step / len(levels) steps,
    the last one held. Selected on the device (no host read of the step,
    no upload of the levels)."""
    step = ctx.in_("Step")
    begin = ctx.attr("rampup_begin", 0.0)
    ramp = float(ctx.attr("rampup_step", 1))
    levels = [float(x) for x in ctx.attr("sparsity")]
    n = len(levels)
    phase = torch.clamp((step - begin) / ramp * n, 0, n - 1).floor()
    ratio = torch.full_like(step, levels[0], dtype=torch.float32)
    for i, lv in enumerate(levels[1:], 1):
        ratio = torch.where(phase >= i, lv, ratio)
    return {"Out": torch.where(step < begin, 0.0, ratio)}


class DGCMomentumOptimizer(Optimizer):
    """Momentum with DGC sparsification from `rampup_begin_step` on.

    sparsity: the drop ratios ramped over rampup_step steps (the
    reference's default warms 0.75 -> 0.9375 -> 0.984375 -> 0.996 ->
    0.999). use_nesterov, local_grad_clip_norm and num_trainers are
    accepted and unused, as in the JAX package."""

    type = "dgc_momentum"

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._rampup_begin_step = float(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = [float(s) for s in sparsity]

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        # one step counter for all parameters
        self._step_var = self._add_accumulator(
            "dgc_step", parameters[0], fill_value=0.0, shape=())

    def _sparsity_var(self, block):
        from ..core.layer_helper import LayerHelper
        helper = LayerHelper("dgc_sparsity")
        out = helper.create_variable_for_type_inference("float32", ())
        helper.append_op(
            "dgc_sparsity_ramp", {"Step": self._step_var}, {"Out": out},
            {"rampup_begin": self._rampup_begin_step,
             "rampup_step": self._rampup_step,
             "sparsity": self._sparsity})
        return out

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        u = self._get_accumulator("dgc_u", p)
        v = self._get_accumulator("dgc_v", p)
        return block.append_op(
            "dgc_momentum",
            {"Param": p, "Grad": g, "U": u, "V": v,
             "SparsityRatio": self._sparsity_var(block),
             "LearningRate": self._param_lr(param_and_grad)},
            {"ParamOut": p, "UOut": u, "VOut": v},
            {"mu": self._momentum})

    def _finish_update(self, block, params_grads):
        # one step-counter bump per training step
        block.append_op("increment", {"X": self._step_var},
                        {"Out": self._step_var}, {"step": 1.0})
